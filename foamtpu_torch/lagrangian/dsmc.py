"""Direct simulation Monte Carlo, variable hard sphere (port of
openfoam-2.2.x_tpu/lagrangian/dsmc.py: `DsmcCloud`, `Species`,
`DsmcConfig`, `maxwellian`, `initialise`, `_sigma_T`, `_free_flight`,
`_collide`, `evolve`, `sample_fields`; reference src/lagrangian/dsmc/
and applications/solvers/discreteMethods/dsmc/dsmcFoam/).

- The cloud is the kinematic cloud's fixed-slot layout; free flight is
  the kinematic face walk (`lagrangian._track`) with specular walls, and
  optionally a thermal resample of the parcels a wall turned
  (MaxwellianThermal, as the reference approximates it).
- Collisions, Bird's no-time-counter scheme: the parcels are ranked
  within their cell by one stable sort over cell ids; per-cell counts by
  `index_add_` (integers: exact in any order) and offsets by `cumsum`.
  The per-cell candidate count
      n_cand = 0.5 nP (nP-1) F_N (sigma_T c_r)_max dt / V_c
  is spread over a fixed number of rounds K; each round draws one pair
  per cell and accepts it with P = (n_cand/K) sigma_T c_r /
  (sigma_T c_r)_max, tracked as a running maximum per cell (sigmaTcRMax).
  The accepted pairs of a round are disjoint, so a round writes them
  with one scatter each for i and j into a copy of u with one extra dump
  row that every rejected cell writes to: only accepted pairs land, in
  any order, and no read of the host is needed.
- VHS cross-section sigma_T = pi d^2 [2kT_ref/(m_r c_r^2)]^(omega-1/2) /
  Gamma(5/2-omega), isotropic scattering; momentum and energy are
  conserved exactly per accepted pair.

Every random draw goes through the cloud's `draws` source, an object with
`uniform(shape, dtype)` and `normal(shape, dtype)`: by default a
`TorchDraws` over a `torch.Generator` on the cloud's device, seeded from
the case. Its stream differs from the reference's jax.random one; a
source that replays the reference's draws in its order (the tests make
one) reproduces the reference's run. `initialise` is host numpy, copied
as is.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from . import Cloud, CloudConfig, _host, _track

K_BOLTZ = 1.380649e-23


class TorchDraws:
    """Uniform and normal draws from a torch.Generator on `device`."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def uniform(self, shape, dtype):
        return torch.rand(shape, generator=self.gen, dtype=dtype,
                          device=self.device)

    def normal(self, shape, dtype):
        return torch.randn(shape, generator=self.gen, dtype=dtype,
                           device=self.device)


class DsmcCloud(NamedTuple):
    """Fixed-slot struct-of-tensors DSMC parcel cloud."""
    x: Any        # [Np, 3]
    u: Any        # [Np, 3]
    typ: Any      # [Np] int64 species index
    cell: Any     # [Np] int64
    active: Any   # [Np] bool
    sigma_cr_max: Any  # [nC] running max of sigma_T c_r per cell
    draws: Any    # the random source (TorchDraws or a replayer)

    @property
    def n_active(self):
        return torch.sum(self.active.to(torch.int64))


class Species(NamedTuple):
    """VHS species properties (dsmcParcel::constantProperties), tensors
    on the cloud's device."""
    mass: Any      # [nSp] kg
    d_ref: Any     # [nSp] m, VHS reference diameter
    omega: Any     # [nSp] viscosity-temperature exponent
    T_ref: float = 273.0


class DsmcConfig(NamedTuple):
    nEquivalentParticles: float = 1e12   # F_N
    n_rounds: int = 4                    # candidate rounds per step
    max_hops: int = 8
    wall_T: float = 300.0
    diffuse_walls: bool = False          # Maxwellian thermal walls


def maxwellian(draws, n, mass, T, U0=(0.0, 0.0, 0.0),
               dtype=torch.float32):
    """n velocities from a Maxwell-Boltzmann distribution."""
    sd = math.sqrt(K_BOLTZ * T / mass)
    nrm = draws.normal((n, 3), dtype)
    return (torch.tensor(U0, dtype=dtype, device=nrm.device)[None, :]
            + sd * nrm)


def initialise(mesh, species: Species, number_density, T, U0,
               fn, typ_fracs=None, seed=0, slack=1.25,
               draws=None) -> DsmcCloud:
    """Uniform fill: the equivalent-parcel count per cell from the target
    number density (dsmcInitialise / dsmcCloud::initialise), placed in
    each cell's bounding box on the host. `draws` defaults to a
    TorchDraws seeded with `seed` on the mesh's device."""
    rng = np.random.default_rng(seed)
    v = _host(mesh.v)
    n_per_cell = number_density * v / fn
    n_int = np.floor(n_per_cell + rng.random(v.shape)).astype(int)
    total = int(n_int.sum())
    ns = int(total * slack) + 8
    mass_h = _host(species.mass)
    nsp = int(mass_h.shape[0])
    fracs = (np.full(nsp, 1.0 / nsp) if typ_fracs is None
             else np.asarray(typ_fracs, float))
    fracs = fracs / fracs.sum()

    # place parcels in cell bounding boxes; resample toward centre to
    # stay inside non-box cells (the face walk corrects itself anyway)
    c = _host(mesh.c)
    cells = np.repeat(np.arange(mesh.n_cells), n_int)
    h = np.cbrt(v)[cells]
    pos = c[cells] + (rng.random((total, 3)) - 0.5) * 0.9 * h[:, None]
    typ = rng.choice(nsp, size=total, p=fracs)
    mass = mass_h[typ]
    sd = np.sqrt(K_BOLTZ * T / mass)
    vel = np.asarray(U0, float)[None, :] + sd[:, None] * rng.standard_normal(
        (total, 3))

    dt = v.dtype
    dev = mesh.v.device
    x = np.zeros((ns, 3))
    x[:total] = pos
    u = np.zeros((ns, 3))
    u[:total] = vel
    t = np.zeros(ns, np.int64)
    t[:total] = typ
    cl = np.zeros(ns, np.int64)
    cl[:total] = cells
    act = np.zeros(ns, bool)
    act[:total] = True
    # the initial sigma_cr_max estimate: sigma(T) x 4 most-probable speeds
    d0 = float(_host(species.d_ref).max())
    cr0 = 4.0 * float(np.sqrt(2.0 * K_BOLTZ * T / mass.min()))
    scm = np.full(mesh.n_cells, np.pi * d0 * d0 * cr0)
    return DsmcCloud(
        x=torch.tensor(x.astype(dt), device=dev),
        u=torch.tensor(u.astype(dt), device=dev),
        typ=torch.tensor(t, device=dev), cell=torch.tensor(cl, device=dev),
        active=torch.tensor(act, device=dev),
        sigma_cr_max=torch.tensor(scm.astype(dt), device=dev),
        draws=draws if draws is not None else TorchDraws(seed, dev))


def _sigma_T(species: Species, typ_i, typ_j, cr):
    """VHS total cross-section of a colliding pair
    (VariableHardSphere::sigmaTcR, Bird eq. 4.63)."""
    d = 0.5 * (species.d_ref[typ_i] + species.d_ref[typ_j])
    om = 0.5 * (species.omega[typ_i] + species.omega[typ_j])
    m_i, m_j = species.mass[typ_i], species.mass[typ_j]
    # the reduced mass as m_i times a fraction: m_i m_j (~1e-51)
    # underflows float32
    m_r = m_i * (m_j / (m_i + m_j))
    arg = (2.0 * K_BOLTZ * species.T_ref / m_r) / torch.clamp(
        cr * cr, min=1e-30)
    gam = torch.exp(torch.lgamma(2.5 - om))
    return torch.pi * d * d * arg ** (om - 0.5) / gam


def _free_flight(mesh, cloud: DsmcCloud, dt, bt, cfg: DsmcConfig,
                 species: Species) -> DsmcCloud:
    """Ballistic transport by the kinematic face walk; diffuse walls
    resample the outgoing speed from a wall-temperature Maxwellian
    (MaxwellianThermal, approximated as the reference does: specular
    geometry with a thermal speed)."""
    kc = Cloud(x=cloud.x, u=cloud.u, d=torch.zeros_like(cloud.x[:, 0]),
               rho=torch.ones_like(cloud.x[:, 0]), cell=cloud.cell,
               active=cloud.active, T=None)
    kcfg = CloudConfig(drag=False, g=(0.0, 0.0, 0.0),
                       max_hops=cfg.max_hops, e_wall=1.0)
    kc = _track(mesh, kc, dt, bt, kcfg)
    out = cloud._replace(x=kc.x, u=kc.u, cell=kc.cell, active=kc.active)
    if cfg.diffuse_walls:
        hit = torch.any(kc.u != cloud.u, dim=1) & kc.active
        m = species.mass[cloud.typ]
        sd = torch.sqrt(K_BOLTZ * cfg.wall_T / m)
        nrm = cloud.draws.normal(tuple(cloud.u.shape), cloud.u.dtype)
        dirn = kc.u / torch.clamp(torch.linalg.norm(kc.u, dim=1,
                                                    keepdim=True),
                                  min=1e-300)
        speed = torch.linalg.norm(sd[:, None] * nrm, dim=1, keepdim=True)
        out = out._replace(u=torch.where(hit[:, None], dirn * speed, kc.u))
    return out


def _collide(mesh, cloud: DsmcCloud, dt, cfg: DsmcConfig,
             species: Species) -> DsmcCloud:
    """NTC binary collisions, K fixed rounds of one pair per cell."""
    nC = mesh.n_cells
    ns = cloud.active.shape[0]
    dtype, dev = cloud.x.dtype, cloud.x.device

    # -- bin the parcels by cell (stable sort; inactive ones last) ---------
    cell_key = torch.where(cloud.active, cloud.cell,
                           torch.full_like(cloud.cell, nC))
    perm = torch.sort(cell_key, stable=True).indices        # [Np]
    counts = torch.zeros(nC, dtype=torch.int64, device=dev).index_add_(
        0, cloud.cell, cloud.active.to(torch.int64))
    offsets = torch.cumsum(counts, 0) - counts
    vc = mesh.v
    nP = counts.to(dtype)
    n_cand = (0.5 * nP * (nP - 1.0) * cfg.nEquivalentParticles
              * cloud.sigma_cr_max * dt / vc) / cfg.n_rounds
    ok = counts >= 2
    typ = cloud.typ
    dump = torch.full((nC,), ns, dtype=torch.int64, device=dev)

    u = cloud.u
    scm = cloud.sigma_cr_max
    for _ in range(cfg.n_rounds):
        r1 = cloud.draws.uniform((nC,), dtype)
        r2 = cloud.draws.uniform((nC,), dtype)
        r3 = cloud.draws.uniform((nC,), dtype)
        r4 = cloud.draws.uniform((nC,), dtype)
        r5 = cloud.draws.uniform((nC,), dtype)
        i_loc = torch.floor(r1 * nP).to(torch.int64)
        j_loc = torch.floor(r2 * (nP - 1.0)).to(torch.int64)
        j_loc = torch.where(j_loc >= i_loc, j_loc + 1, j_loc)  # j != i
        i_idx = perm[torch.clamp(offsets + i_loc, 0, ns - 1)]
        j_idx = perm[torch.clamp(offsets + j_loc, 0, ns - 1)]
        ui, uj = u[i_idx], u[j_idx]
        cr = torch.linalg.norm(ui - uj, dim=1)
        sig_cr = _sigma_T(species, typ[i_idx], typ[j_idx], cr) * cr
        scm = torch.where(ok, torch.maximum(scm, sig_cr), scm)
        p_acc = n_cand * sig_cr / torch.clamp(scm, min=1e-300)
        accept = ok & (r3 < p_acc)
        # isotropic VHS scattering
        m_i = species.mass[typ[i_idx]]
        m_j = species.mass[typ[j_idx]]
        msum = m_i + m_j
        ucm = (m_i[:, None] * ui + m_j[:, None] * uj) / msum[:, None]
        ct = 2.0 * r4 - 1.0
        st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
        phi = 2.0 * torch.pi * r5
        e = torch.stack([ct, st * torch.cos(phi), st * torch.sin(phi)],
                        dim=1)
        cr_new = cr[:, None] * e
        ui_new = ucm + (m_j / msum)[:, None] * cr_new
        uj_new = ucm - (m_i / msum)[:, None] * cr_new
        # the accepted pairs are disjoint; the rejected cells write to the
        # dump row ns
        ext = torch.cat([u, u.new_zeros((1, 3))])
        ext[torch.where(accept, i_idx, dump)] = ui_new
        ext[torch.where(accept, j_idx, dump)] = uj_new
        u = ext[:ns]
    return cloud._replace(u=u, sigma_cr_max=scm)


def evolve(mesh, cloud: DsmcCloud, dt, bt, cfg: DsmcConfig,
           species: Species) -> DsmcCloud:
    """One DSMC step: free flight, then collisions (dsmcCloud::evolve)."""
    cloud = _free_flight(mesh, cloud, dt, bt, cfg, species)
    return _collide(mesh, cloud, dt, cfg, species)


def sample_fields(mesh, cloud: DsmcCloud, species: Species, fn):
    """Instantaneous macroscopic fields (dsmcCloud::calculateFields):
    number density, mass-average velocity, translational temperature.
    The sums over parcels are `index_add_`s."""
    nC = mesh.n_cells
    w = cloud.active.to(cloud.x.dtype)
    m = species.mass[cloud.typ] * w
    cell = cloud.cell
    cnt = w.new_zeros(nC).index_add_(0, cell, w)
    msum = w.new_zeros(nC).index_add_(0, cell, m)
    mom = w.new_zeros((nC, 3)).index_add_(0, cell, m[:, None] * cloud.u)
    U = mom / torch.clamp(msum, min=1e-300)[:, None]
    ke = w.new_zeros(nC).index_add_(
        0, cell, m * torch.sum(cloud.u * cloud.u, dim=1))
    # T = (sum m c^2 - sum m |U|^2) / (3 k N)
    T = (ke - msum * torch.sum(U * U, dim=1)) / torch.clamp(
        3.0 * K_BOLTZ * cnt, min=1e-300)
    rhoN = fn * cnt / mesh.v
    return {"rhoN": rhoN, "U": U, "T": T, "N": cnt}
