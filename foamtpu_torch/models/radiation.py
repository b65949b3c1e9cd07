"""Radiation: the P1 and fvDOM models and viewFactor surface exchange
(port of openfoam-2.2.x_tpu/models/radiation.py: `P1Config`, `make_G`,
`solve_G`, `Sh`, `FvDOMConfig`, `fvdom_directions`, `_ray_field`,
`solve_fvdom`, `ViewFactorModel`, `make_viewfactor`,
`viewfactor_heat_flux`, `viewfactor_source`; reference
src/thermophysicalModels/radiationModels/{P1,fvDOM,viewFactor},
constantAbsorptionEmission, MarshakRadiation).

P1, for the incident radiation G [W/m^2]:

    div(Gamma grad G) - a G = -4 e sigma T^4,   Gamma = 1/(3(a+s))

with the Marshak mixed BC on walls of temperature Tw and emissivity eps:
refValue 4 sigma Tw^4, valueFraction f0/(f0 + Gamma deltaCoeffs),
f0 = eps/(2(2-eps)). The energy coupling is Sh = a G - 4 e sigma T^4.
Every G solve is one symmetric solve (PCG, polynomial, relTol 0.01,
maxIter 2000 unless the config names controls).

fvDOM splits the RTE into nTheta x 4 nPhi rays, each an upwind
advection solve div(I d.Sf) + a V I = a V sigma T^4/pi, with the
greyDiffusiveRadiation wall closure: an incoming ray (d.Sf < 0 on a face)
sees eps sigma Tw^4/pi (a mixed BC with a per-face valueFraction of 1 or
0). The ray fluxes d.Sf are masked by the mesh's face_active, so empty
faces carry none. G = sum_i w_i I_i; the solver performance returned is
the last ray's, as in the reference. In-scatter is omitted (s only
attenuates), as in the reference.

viewFactor: grey diffuse exchange between enclosure faces, F_ij from the
double-area formula, rows normalised, the radiosity system solved dense.
`make_viewfactor` is host numpy copied from the reference (float64, once);
`viewfactor_source` deposits each face's net flux into its owner cell by
`index_add_` (an atomic sum on the card).
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..bc import patchfields as pf
from ..core.dimensions import DimensionSet
from ..core.fields import VolField, vol_scalar
from ..ops import fvm
from ..ops import schemes as schemes_mod
from ..ops import slot as slot_mod
from ..solvers import linear

SIGMA = 5.670374419e-8   # Stefan-Boltzmann [W/m^2/K^4]
_G_DIMS = DimensionSet.of(1, 0, -3)


class P1Config(NamedTuple):
    a: float = 0.5            # absorption coefficient [1/m]
    s: float = 0.0            # scattering coefficient [1/m]
    e: float = 0.5            # emission coefficient (= a for grey gas)
    emissivity: float = 1.0   # wall emissivity (Marshak BC)
    g_controls: Dict = None

    @property
    def gamma(self) -> float:
        return 1.0 / (3.0 * (self.a + self.s) + 1e-30)


def _empty_bc():
    return pf.PatchField(kind="empty", vfrac=0.0)


def make_G(mesh, cfg, T_wall_bcs) -> VolField:
    """The initial G field: Marshak mixed BCs on the patches where T has
    a value BC, zero gradient elsewhere (an inletOutlet T patch too). For
    fvDOM G is derived: zero gradient everywhere."""
    if isinstance(cfg, FvDOMConfig):
        bcs = [_empty_bc() if p.type == "empty" else pf.zero_gradient()
               for p in mesh.patches]
        return vol_scalar(mesh, 0.0, name="G", dims=_G_DIMS,
                          bcs=tuple(bcs))
    bcs = []
    eps = cfg.emissivity
    marshak_f0 = eps / (2.0 * (2.0 - eps))
    for patch, tb in zip(mesh.patches, T_wall_bcs):
        if patch.type == "empty":
            bcs.append(_empty_bc())
        elif pf.is_value_bc(tb):
            tw = torch.as_tensor(tb.ref_value, dtype=mesh.v.dtype,
                                 device=mesh.device)
            gw = 4.0 * SIGMA * tw ** 4
            dc = mesh.delta_coeffs[patch.slice]
            frac = marshak_f0 / (marshak_f0 + cfg.gamma * dc)
            bcs.append(pf.mixed(torch.broadcast_to(gw, (patch.size,)),
                                0.0, frac))
        else:
            bcs.append(pf.zero_gradient())
    return vol_scalar(mesh, 0.0, name="G", dims=_G_DIMS, bcs=tuple(bcs))


def solve_G(mesh, G: VolField, T: Any, cfg, T_bcs=None
            ) -> Tuple[VolField, Any]:
    """One implicit P1 solve (P1::calculate), or for an FvDOMConfig the
    whole discrete-ordinates sweep."""
    if isinstance(cfg, FvDOMConfig):
        return solve_fvdom(mesh, G, T, cfg, T_bcs=T_bcs)
    ctl = cfg.g_controls or {"solver": "PCG",
                             "preconditioner": "polynomial",
                             "tolerance": 1e-8, "relTol": 0.01,
                             "maxIter": 2000}
    lap = fvm.laplacian(mesh, torch.tensor(cfg.gamma, dtype=mesh.v.dtype,
                                           device=mesh.device), G,
                        corrected=False,
                        gamma_dims=DimensionSet.of(0, 1, 0))
    # -lap is positive-definite; add the absorption sink a G and the
    # emission source 4 e sigma T^4
    neg = -lap
    eqn = neg.replace_fields(
        diag=neg.diag + mesh.v * cfg.a,
        source=neg.source + mesh.v * 4.0 * cfg.e * SIGMA * T ** 4)
    data, perf = linear.solve(mesh, eqn, G.data, ctl)
    return G.with_data(torch.clamp(data, min=0.0)), perf


def Sh(mesh, G: VolField, T: Any, cfg) -> Any:
    """Radiative source of the energy equation [W/m^3]
    (radiationModel::Sh = a G - 4 e sigma T^4)."""
    return cfg.a * G.data - 4.0 * cfg.e * SIGMA * T ** 4


# ---------------------------------------------------------------------------
# fvDOM: discrete ordinates
# ---------------------------------------------------------------------------


class FvDOMConfig(NamedTuple):
    """fvDOM (fvDOM.C + radiativeIntensityRay.C): nTheta x 4 nPhi rays."""

    a: float = 0.5
    s: float = 0.0
    e: float = 0.5
    emissivity: float = 1.0
    n_theta: int = 2           # polar divisions (0..pi)
    n_phi: int = 2             # azimuthal divisions PER OCTANT (x4 total)
    g_controls: Dict = None


def fvdom_directions(cfg: FvDOMConfig):
    """Ray mid-point directions [nRay, 3] and solid-angle weights [nRay]
    (sum 4 pi), host float64 (the fvDOM constructor's theta/phi loops)."""
    nT, nP = cfg.n_theta, 4 * cfg.n_phi
    dth = np.pi / nT
    dph = 2.0 * np.pi / nP
    dirs, wts = [], []
    for i in range(nT):
        th = (i + 0.5) * dth
        for j in range(nP):
            ph = (j + 0.5) * dph
            dirs.append((np.sin(th) * np.cos(ph),
                         np.sin(th) * np.sin(ph),
                         np.cos(th)))
            # exact integral of sin(theta) over the control angle
            wts.append((np.cos(i * dth) - np.cos((i + 1) * dth)) * dph)
    return np.asarray(dirs), np.asarray(wts)


def _ray_field(mesh, d, T_bcs, cfg: FvDOMConfig) -> VolField:
    """The intensity field template of ray direction d: a mixed wall BC
    with valueFraction 1 on incoming faces and 0 on outgoing ones where T
    has a value BC, zero gradient elsewhere
    (greyDiffusiveRadiationMixedFvPatchScalarField)."""
    bcs = []
    eps = cfg.emissivity
    dvec = torch.tensor(d, dtype=mesh.v.dtype, device=mesh.device)
    for patch, tb in zip(mesh.patches, T_bcs):
        if patch.type == "empty":
            bcs.append(_empty_bc())
            continue
        dn = mesh.sf[patch.slice] @ dvec
        incoming = (dn < 0.0).to(mesh.v.dtype)
        if pf.is_value_bc(tb):
            tw = torch.broadcast_to(
                torch.as_tensor(tb.ref_value, dtype=mesh.v.dtype,
                                device=mesh.device), (patch.size,))
            iw = eps * SIGMA * tw ** 4 / math.pi
            bcs.append(pf.mixed(iw, 0.0, incoming))
        else:
            bcs.append(pf.zero_gradient())
    return vol_scalar(mesh, 0.0, name="I", dims=_G_DIMS, bcs=tuple(bcs))


def solve_fvdom(mesh, G: VolField, T: Any, cfg: FvDOMConfig, T_bcs=None
                ) -> Tuple[VolField, Any]:
    """Solve every ray and return G = sum_i w_i I_i (fvDOM::calculate)
    with the last ray's solver performance. T_bcs supplies the wall
    temperatures of the greyDiffusive closure."""
    if T_bcs is None:
        raise ValueError("solve_fvdom needs the T field's BCs (T_bcs)")
    ctl = cfg.g_controls or {"solver": "PBiCGStab",
                             "tolerance": 1e-6, "relTol": 1e-3,
                             "maxIter": 200}
    dirs, wts = fvdom_directions(cfg)
    emission = cfg.a * SIGMA * T ** 4 / math.pi      # [nC] W/m^3/sr
    Gnew = torch.zeros_like(G.data)
    I0 = torch.clamp(G.data, min=0.0) / (4.0 * math.pi)
    beta = cfg.a + cfg.s
    perf = None
    for r in range(dirs.shape[0]):
        d = dirs[r]
        If = _ray_field(mesh, d, T_bcs, cfg).with_data(I0)
        dvec = torch.tensor(d, dtype=mesh.v.dtype, device=mesh.device)
        phi = (mesh.sf @ dvec) * mesh.face_active    # d . Sf per face
        phi_slot = slot_mod.from_flat(mesh, phi)
        w_slot = schemes_mod.weights_slot(mesh, phi_slot, "upwind", If)
        eqn = fvm.div(mesh, phi, If, phi_slot=phi_slot,
                      slot_weights=w_slot,
                      phi_dims=DimensionSet.of(0, 3, -1))
        eqn = eqn.replace_fields(
            diag=eqn.diag + mesh.v * beta,
            source=eqn.source + mesh.v * emission)
        data, perf = linear.solve(mesh, eqn, I0, ctl)
        Gnew = Gnew + float(wts[r]) * torch.clamp(data, min=0.0)
    return G.with_data(Gnew), perf


# ---------------------------------------------------------------------------
# viewFactor: surface-to-surface radiation in a transparent enclosure
# ---------------------------------------------------------------------------


class ViewFactorModel(NamedTuple):
    """Grey diffuse exchange between the enclosure patches' faces. F_ij =
    max(cos t_i, 0) max(cos t_j, 0) A_j / (pi r^2), rows normalised to
    the enclosure fraction; no occlusion test (convex enclosures are
    exact), as in the reference."""
    faces: Any          # [nF] flat face ids of the enclosure
    F: Any              # [nF, nF] view factors (row-normalised)
    emissivity: Any     # [nF]
    areas: Any          # [nF]
    owners: Any         # [nF] owner cells


SIGMA_SB = 5.670374419e-8


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def make_viewfactor(mesh, patch_names, emissivity=0.9) -> ViewFactorModel:
    """The view-factor matrix of the given enclosure patches (host numpy,
    float64, copied from the reference)."""
    fids = []
    for p in mesh.patches:
        if p.name in patch_names or p.type in patch_names:
            fids.extend(range(p.start, p.start + p.size))
    fids = np.asarray(fids, np.int64)
    cf = _host(mesh.cf).astype(np.float64)[fids]
    sf = _host(mesh.sf).astype(np.float64)[fids]
    areas = np.linalg.norm(sf, axis=1)
    # boundary Sf points OUT of the domain; the enclosure radiates inward
    n = -sf / np.maximum(areas, 1e-300)[:, None]
    r = cf[None, :, :] - cf[:, None, :]            # i -> j
    d2 = np.maximum((r ** 2).sum(axis=2), 1e-300)
    ct_i = np.einsum("ijd,id->ij", r, n) / np.sqrt(d2)
    ct_j = -np.einsum("ijd,jd->ij", r, n) / np.sqrt(d2)
    F = (np.maximum(ct_i, 0.0) * np.maximum(ct_j, 0.0)
         * areas[None, :] / (np.pi * d2))
    np.fill_diagonal(F, 0.0)
    s = F.sum(axis=1)
    F = np.where(s[:, None] > 1e-12, F / np.maximum(s, 1e-300)[:, None],
                 0.0)
    dt, dev = mesh.v.dtype, mesh.device
    eps = np.broadcast_to(np.asarray(emissivity, float),
                          fids.shape).astype(float)
    return ViewFactorModel(
        faces=torch.tensor(fids, device=dev),
        F=torch.tensor(F, dtype=dt, device=dev),
        emissivity=torch.tensor(eps, dtype=dt, device=dev),
        areas=torch.tensor(areas, dtype=dt, device=dev),
        owners=torch.tensor(_host(mesh.owner)[fids], device=dev))


def viewfactor_heat_flux(vf: ViewFactorModel, T_face):
    """Net radiative heat flux INTO each enclosure face [W/m^2]
    (viewFactor::calculate): J = eps sigma T^4 + (1-eps) F J, then
    q_net = eps (F J - sigma T^4)."""
    eb = SIGMA_SB * T_face ** 4
    eps = vf.emissivity
    n = eb.shape[0]
    A = (torch.eye(n, dtype=eb.dtype, device=eb.device)
         - (1.0 - eps)[:, None] * vf.F)
    J = torch.linalg.solve(A, eps * eb)
    H = vf.F @ J
    return eps * (H - eb)


def viewfactor_source(mesh, vf: ViewFactorModel, T_cells, T_face=None):
    """Per-cell radiative source [W/m^3]: each face's net flux deposited
    into its owner cell (the owner temperature is the face temperature
    unless given)."""
    Tf = T_cells[vf.owners] if T_face is None else T_face
    q = viewfactor_heat_flux(vf, Tf)
    src = torch.zeros(mesh.n_cells, dtype=q.dtype, device=q.device)
    src.index_add_(0, vf.owners, q * vf.areas)
    return src / mesh.v
