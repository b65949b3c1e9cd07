"""Lagrangian particle clouds: tracking and kinematic parcels (port of
openfoam-2.2.x_tpu/lagrangian/__init__.py: `Cloud`, `CloudConfig`,
`face_boundary_types`, `locate_cells`, `make_cloud`, `_track`,
`_drag_update`, `_thermo_update`, `evolve`, `momentum_source`,
`InjectionConfig`, `patch_injection`, `cone_injection`, `inject`;
reference src/lagrangian/{basic,intermediate}/ and
applications/solvers/lagrangian/icoUncoupledKinematicParcelFoam/).

The cloud is a fixed-size struct of tensors ([Np] slots with an `active`
mask; dead and unused slots keep the shapes fixed). One transport step is
a Python loop of `max_hops` face-hop rounds over the whole cloud: every
active parcel finds its exit face in its current cell from the mesh's
padded per-cell face tables (cface, csign, cnbr, cnbr_valid: [nC, K]),
advances to the nearer of that face and the end of its remaining time,
and crosses into the neighbour cell, rebounds off a wall (specular, with
restitution e_wall) or leaves through any other patch. Convex cells are
assumed, as in the reference. A round gathers [Np, K, 3] face normals and
centres; nothing in a round reads the host.

Forces: sphere drag with the Schiller-Naumann correction plus buoyant
gravity, semi-implicit (SphereDragForce); thermo parcels add Ranz-Marshall
heating. `momentum_source` sums each parcel's drag momentum into its cell
by `index_add_`, an atomic sum on the card (no fixed order).
`locate_cells` is host code (scipy's cKDTree), copied as is.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

# boundary interaction codes per face (flat [nF])
BND_INTERNAL = 0
BND_WALL = 1       # specular rebound
BND_ESCAPE = 2     # leave the domain (patch/inlet/outlet)


class Cloud(NamedTuple):
    """Struct-of-tensors particle cloud ([Np] fixed slots)."""
    x: Any          # [Np, 3] position
    u: Any          # [Np, 3] velocity
    d: Any          # [Np] diameter
    rho: Any        # [Np] particle density
    cell: Any       # [Np] int64 current cell
    active: Any     # [Np] bool
    T: Any = None   # [Np] parcel temperature (thermo parcels)

    @property
    def n_active(self):
        return torch.sum(self.active.to(torch.int64))


class CloudConfig(NamedTuple):
    rho_f: float = 1.0          # carrier density
    mu_f: float = 1.8e-5        # carrier dynamic viscosity
    g: Tuple[float, float, float] = (0.0, -9.81, 0.0)
    max_hops: int = 8           # face crossings per transport step
    drag: bool = True
    e_wall: float = 1.0         # wall restitution (1 = specular elastic)
    # thermo parcels (ThermoParcel + RanzMarshall)
    solve_T: bool = False
    cp_p: float = 4186.0        # parcel specific heat
    k_f: float = 0.026          # carrier conductivity
    pr_f: float = 0.7           # carrier Prandtl number


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def face_boundary_types(mesh) -> np.ndarray:
    """Flat [nF] interaction code from the patch types (host)."""
    bt = np.zeros(mesh.n_faces, dtype=np.int64)
    for p in mesh.patches:
        sl = p.slice
        if p.type in ("wall", "empty", "symmetry", "symmetryPlane",
                      "wedge"):
            bt[sl] = BND_WALL
        else:
            bt[sl] = BND_ESCAPE
    return bt


def locate_cells(mesh, x: np.ndarray) -> np.ndarray:
    """Host initial cell location: the nearest cell centre (exact for
    points inside their nearest cell on reasonable meshes; the walk
    corrects itself across faces afterwards)."""
    from scipy.spatial import cKDTree

    tree = cKDTree(_host(mesh.c))
    return tree.query(np.asarray(x))[1].astype(np.int64)


def make_cloud(mesh, x, u, d, rho, n_slots: Optional[int] = None,
               T0=300.0) -> Cloud:
    """A cloud of the parcels at x (host arrays), padded to n_slots, on
    the mesh's device in its dtype."""
    x = np.atleast_2d(np.asarray(x, dtype=float))
    n = x.shape[0]
    ns = n_slots or n
    dt = _host(mesh.v).dtype
    dev = mesh.v.device

    def pad(a, shape, fill=0.0):
        out = np.full(shape, fill, dtype=float)
        out[:n] = a
        return torch.tensor(out.astype(dt), device=dev)

    cells = np.zeros(ns, dtype=np.int64)
    cells[:n] = locate_cells(mesh, x)
    active = np.zeros(ns, dtype=bool)
    active[:n] = True
    return Cloud(
        x=pad(x, (ns, 3)),
        u=pad(np.broadcast_to(np.atleast_2d(u), (n, 3)), (ns, 3)),
        d=pad(np.broadcast_to(d, (n,)), (ns,), fill=1e-6),
        rho=pad(np.broadcast_to(rho, (n,)), (ns,), fill=1e3),
        cell=torch.tensor(cells, device=dev),
        active=torch.tensor(active, device=dev),
        T=pad(np.broadcast_to(T0, (n,)), (ns,), fill=300.0))


def _pick(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """a[p, k[p]] of a [Np, K] (or [Np, K, 3]) tensor."""
    if a.dim() == 2:
        return torch.gather(a, 1, k[:, None])[:, 0]
    return torch.gather(a, 1, k[:, None, None].expand(-1, 1, a.shape[2])
                        )[:, 0, :]


def _track(mesh, cloud: Cloud, dt, bt, cfg: CloudConfig) -> Cloud:
    """Geometric face-walk transport over one dt (all parcels)."""
    x, u, cell, active = cloud.x, cloud.u, cloud.cell, cloud.active
    big = _scalar(1e30, x)
    zero = _scalar(0.0, x)
    trem = torch.where(active, _scalar(dt, x), zero)
    for _ in range(cfg.max_hops):
        faces = mesh.cface[cell]                       # [Np, K]
        sgn = mesh.csign[cell]                         # [Np, K]
        n = mesh.sf[faces] * sgn[..., None]            # outward
        cfc = mesh.cf[faces]
        un = torch.einsum("pkd,pd->pk", n, u)
        dist = torch.einsum("pkd,pkd->pk", cfc - x[:, None, :], n)
        valid = (sgn != 0) & (un > 1e-30)
        lam = torch.where(valid, dist / torch.where(un == 0, 1.0, un), big)
        # lam == 0 (a parcel ON the face, moving outward) must cross: one
        # seeded exactly on a face would otherwise tunnel with a stale
        # cell index; un > 0 prevents re-crossing back
        lam = torch.where(lam >= 0, lam, big)
        kmin = torch.argmin(lam, dim=1)                # the first minimum
        lam_min = _pick(lam, kmin)
        moving = active & (trem > 0)
        t_adv = torch.where(moving, torch.minimum(lam_min, trem), zero)
        x = x + u * t_adv[:, None]
        crossed = moving & (lam_min < trem)
        f = _pick(faces, kmin)
        nb_valid = _pick(mesh.cnbr_valid[cell], kmin) > 0
        nb = _pick(mesh.cnbr[cell], kmin)
        code = bt[f]
        # internal crossing
        cell = torch.where(crossed & nb_valid, nb, cell)
        # wall rebound: reflect u about the face normal
        nhat_k = _pick(n, kmin)
        nn = nhat_k / torch.clamp(torch.linalg.norm(nhat_k, dim=1,
                                                    keepdim=True), min=1e-30)
        wall = crossed & (~nb_valid) & (code == BND_WALL)
        un_p = torch.einsum("pd,pd->p", u, nn)
        u = torch.where(wall[:, None],
                        u - (1.0 + cfg.e_wall) * un_p[:, None] * nn, u)
        # escape
        esc = crossed & (~nb_valid) & (code == BND_ESCAPE)
        active = active & (~esc)
        trem = torch.clamp(trem - t_adv, min=0.0)
    # any remaining time: advance freely (deep inside a large cell)
    x = x + u * trem[:, None]
    return cloud._replace(x=x, u=u, cell=cell, active=active)


def _drag_update(cloud: Cloud, u_f, dt, cfg: CloudConfig) -> Cloud:
    """Semi-implicit velocity update with Schiller-Naumann sphere drag
    and buoyant gravity (SphereDragForce::CdRe)."""
    g = torch.tensor(cfg.g, dtype=cloud.u.dtype, device=cloud.u.device)
    if not cfg.drag:
        return cloud._replace(u=cloud.u + dt * g[None, :])
    urel = u_f - cloud.u
    mag = torch.linalg.norm(urel, dim=1)
    Re = torch.clamp(cfg.rho_f * mag * cloud.d / cfg.mu_f, min=1e-10)
    CdRe = torch.where(Re > 1000.0, 0.424 * Re,
                       24.0 * (1.0 + 0.15 * Re ** 0.687))
    # tau^-1 = (18 mu / (rho_p d^2)) CdRe/24
    tau_inv = 18.0 * cfg.mu_f / (cloud.rho * cloud.d ** 2) * CdRe / 24.0
    geff = (1.0 - cfg.rho_f / cloud.rho)[:, None] * g[None, :]
    u_new = ((cloud.u + dt * (tau_inv[:, None] * u_f + geff))
             / (1.0 + dt * tau_inv)[:, None])
    return cloud._replace(u=torch.where(cloud.active[:, None], u_new,
                                        cloud.u))


def _thermo_update(cloud: Cloud, u_f, T_f, dt, cfg: CloudConfig) -> Cloud:
    """Ranz-Marshall convective heating, semi-implicit (HeatTransferModel/
    RanzMarshall): Nu = 2 + 0.6 Re^1/2 Pr^1/3,
    dT/dt = 6 Nu k_f / (rho_p cp_p d^2) (T_f - T_p)."""
    urel = torch.linalg.norm(u_f - cloud.u, dim=1)
    Re = torch.clamp(cfg.rho_f * urel * cloud.d / cfg.mu_f, min=1e-10)
    Nu = 2.0 + 0.6 * torch.sqrt(Re) * cfg.pr_f ** (1.0 / 3.0)
    tau_inv = 6.0 * Nu * cfg.k_f / (cloud.rho * cfg.cp_p * cloud.d ** 2)
    T_new = (cloud.T + dt * tau_inv * T_f) / (1.0 + dt * tau_inv)
    return cloud._replace(T=torch.where(cloud.active, T_new, cloud.T))


def evolve(mesh, cloud: Cloud, U_cell, dt, bt, cfg: CloudConfig,
           T_cell=None) -> Cloud:
    """One cloud step: the drag and gravity velocity update at the
    parcel's cell (and the Ranz-Marshall heating), then the face walk
    (KinematicCloud::evolve)."""
    u_f = U_cell[cloud.cell]
    if cfg.solve_T and T_cell is not None and cloud.T is not None:
        cloud = _thermo_update(cloud, u_f, T_cell[cloud.cell], dt, cfg)
    cloud = _drag_update(cloud, u_f, dt, cfg)
    return _track(mesh, cloud, dt, bt, cfg)


def momentum_source(mesh, cloud_before: Cloud, cloud_after: Cloud,
                    n_parcels, dt, cfg: Optional[CloudConfig] = None):
    """Per-cell DRAG momentum given to the carrier [nC, 3] (two-way
    coupling, KinematicParcel UTrans): the buoyant-gravity part of the
    parcel acceleration is not exchanged with the fluid, so it is taken
    off the observed m dU/dt."""
    m = cloud_after.rho * torch.pi / 6.0 * cloud_after.d ** 3 * n_parcels
    dU = (cloud_after.u - cloud_before.u) / dt
    if cfg is not None:
        g = torch.tensor(cfg.g, dtype=dU.dtype, device=dU.device)
        geff = (1.0 - cfg.rho_f / cloud_after.rho)[:, None] * g[None, :]
        dU = dU - geff
    src = -(m[:, None] * dU)
    w = cloud_after.active.to(src.dtype)[:, None]
    out = src.new_zeros((mesh.n_cells, 3))
    return out.index_add_(0, cloud_after.cell, src * w)


# ---------------------------------------------------------------------------
# Injection models (src/lagrangian/intermediate/submodels/Kinematic/
# InjectionModel/: patchInjection, coneNozzleInjection)
# ---------------------------------------------------------------------------


class InjectionConfig(NamedTuple):
    """Candidate positions and cells, made on the host once (patch face
    centres or cone nozzle points) and cycled; floor(rate dt + carry)
    dead slots activate per step."""
    positions: Any     # [nPos, 3]
    cells: Any         # [nPos] int64
    u0: Any            # [3] or [nPos, 3] initial velocity
    d0: float = 1e-4
    rho0: float = 1000.0
    T0: float = 300.0
    rate: float = 0.0  # parcels per second


def patch_injection(mesh, patch_name: str, u0, d0=1e-4, rho0=1000.0,
                    rate=0.0, T0=300.0, offset=1e-6) -> InjectionConfig:
    """Inject at the face centres of a patch, nudged inward along the
    face normal (patchInjection)."""
    p = mesh.patch(patch_name)
    cf = _host(mesh.cf)[p.slice]
    sf = _host(mesh.sf)[p.slice]
    n = sf / np.maximum(np.linalg.norm(sf, axis=1, keepdims=True), 1e-30)
    pos = cf - offset * n
    cells = _host(mesh.owner)[p.slice]
    dt, dev = mesh.v.dtype, mesh.v.device
    return InjectionConfig(
        positions=torch.tensor(pos, dtype=dt, device=dev),
        cells=torch.tensor(cells.astype(np.int64), device=dev),
        u0=torch.tensor(np.asarray(u0, float), dtype=dt, device=dev),
        d0=d0, rho0=rho0, T0=T0, rate=rate)


def cone_injection(mesh, apex, direction, half_angle_deg, n_rays=16,
                   u_mag=1.0, d0=1e-4, rho0=1000.0, rate=0.0,
                   T0=300.0) -> InjectionConfig:
    """coneNozzleInjection: rays on the cone surface around `direction`,
    all from the apex."""
    d = np.asarray(direction, float)
    d /= max(np.linalg.norm(d), 1e-30)
    a = np.array([1.0, 0.0, 0.0])
    if abs(d @ a) > 0.9:
        a = np.array([0.0, 1.0, 0.0])
    e1 = np.cross(d, a)
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(d, e1)
    th = np.deg2rad(half_angle_deg)
    phis = np.linspace(0, 2 * np.pi, n_rays, endpoint=False)
    dirs = (np.cos(th) * d[None, :]
            + np.sin(th) * (np.cos(phis)[:, None] * e1[None, :]
                            + np.sin(phis)[:, None] * e2[None, :]))
    pos = np.broadcast_to(np.asarray(apex, float), (n_rays, 3)).copy()
    cells = locate_cells(mesh, pos)
    dt, dev = mesh.v.dtype, mesh.v.device
    return InjectionConfig(
        positions=torch.tensor(pos, dtype=dt, device=dev),
        cells=torch.tensor(cells, device=dev),
        u0=torch.tensor(u_mag * dirs, dtype=dt, device=dev),
        d0=d0, rho0=rho0, T0=T0, rate=rate)


def inject(cloud: Cloud, inj: InjectionConfig, carry, counter, dt):
    """Activate floor(rate dt + carry) dead slots, the count kept as a
    device mask (no host read). Returns (cloud, new_carry, new_counter)."""
    want = inj.rate * dt + carry
    n_new = torch.floor(want).to(torch.int64)
    new_carry = want - n_new
    npos = inj.positions.shape[0]
    ns = cloud.active.shape[0]
    dev = cloud.active.device
    # the first n dead slots: a stable argsort puts active=False first
    order = torch.argsort(cloud.active.to(torch.int32), stable=True)
    rank_of_slot = torch.zeros(ns, dtype=torch.int64, device=dev)
    rank_of_slot[order] = torch.arange(ns, dtype=torch.int64, device=dev)
    take = (~cloud.active) & (rank_of_slot < n_new)
    src = torch.remainder(counter + rank_of_slot, npos)
    u0 = (inj.u0 if inj.u0.dim() == 2
          else inj.u0[None, :].expand(npos, 3))
    tk = take[:, None]
    new = cloud._replace(
        x=torch.where(tk, inj.positions[src], cloud.x),
        u=torch.where(tk, u0[torch.remainder(src, u0.shape[0])], cloud.u),
        d=torch.where(take, _scalar(inj.d0, cloud.d), cloud.d),
        rho=torch.where(take, _scalar(inj.rho0, cloud.rho), cloud.rho),
        cell=torch.where(take, inj.cells[src], cloud.cell),
        active=cloud.active | take,
        T=None if cloud.T is None else torch.where(
            take, _scalar(inj.T0, cloud.T), cloud.T))
    n_inj = torch.sum(take.to(torch.int64))
    return new, new_carry, counter + n_inj
