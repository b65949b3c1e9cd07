"""solidDisplacementFoam / solidEquilibriumDisplacementFoam — linear
elastic (small-strain) stress analysis (port of
openfoam-2.2.x_tpu/solvers/soliddisplacement.py: DEqn.H and the
tractionDisplacement BC). The segregated displacement formulation:

    DEqn: fvm::d2dt2(D) == fvm::laplacian(2*mu + lambda, D)
                          + fvc::div(sigmaExp)
    sigmaExp = mu*gradD.T + lambda*I*tr(gradD) - (mu+lambda)*gradD

iterated over nCorrectors inner corrections, the explicit cross-derivative
coupling converging by fixed point. Traction patches are fixedGradient
BCs whose gradient is recomputed every inner iteration:

    g = (traction - pressure*n - n.sigmaExp) / (2*mu + lambda)

The Lame constants come from mechanicalProperties (E, nu, rho; the
planeStress switch rescales lambda). thermalStress is refused by the
application, as in the reference. A step is eager torch; the D solves
go through the offset-stencil SpMV.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..core.dimensions import DimensionSet
from ..core.fields import VolField
from ..ops import fvc, fvm, surface
from . import linear
from .piso import _as_scalar


class SolidConfig(NamedTuple):
    rho: float                  # density [kg/m3]
    E: float                    # Young's modulus [Pa]
    nu: float                   # Poisson ratio
    plane_stress: bool = False
    steady: bool = False        # solidEquilibriumDisplacementFoam
    n_corr: int = 30            # inner iterations per step
    tolerance: float = 1e-6     # convergenceTolerance on the initial residual
    d_controls: Dict = None
    traction: Tuple = ()        # per patch (traction[3], pressure) or None


def lame(cfg: SolidConfig) -> Tuple[float, float]:
    """(mu, lambda) per unit density, as the D equation is solved
    (divided by rho)."""
    E, nu = cfg.E, cfg.nu
    mu = E / (2.0 * (1.0 + nu))
    lam = nu * E / ((1.0 + nu) * (1.0 - 2.0 * nu))
    if cfg.plane_stress:
        lam = nu * E / ((1.0 + nu) * (1.0 - nu))
    return mu / cfg.rho, lam / cfg.rho


def _trace(g):
    return g[:, 0, 0] + g[:, 1, 1] + g[:, 2, 2]


def _sigma_exp(gradD, mu, lam):
    """sigmaExp[c,i,j] = mu dD_i/dx_j + lam delta_ij tr - (mu+lam) dD_j/dx_i
    with gradD[c,i,j] = dD_j/dx_i (the fvc.grad convention)."""
    I3 = torch.eye(3, dtype=gradD.dtype, device=gradD.device)
    return (mu * gradD.transpose(1, 2)
            + lam * _trace(gradD)[:, None, None] * I3[None]
            - (mu + lam) * gradD)


def _div_tensor(mesh, T):
    """fvc::div of a [nC,3,3] tensor: the per-cell Gauss sum of Sf_i T_ij
    (zero-gradient boundary extrapolation)."""
    nC = T.shape[0]
    Tf_i = surface.interpolate_internal(mesh, T.reshape(nC, 9))
    Tf_b = surface.owner_to_b(mesh, T.reshape(nC, 9))
    Tf = torch.cat([Tf_i, Tf_b], dim=0).reshape(-1, 3, 3)
    Ff = torch.einsum("fi,fij->fj", mesh.sf, Tf)
    Ff = Ff * mesh.face_active[:, None]
    return fvc.surface_integrate(mesh, Ff)


def _update_traction_bcs(mesh, D: VolField, gradD, mu, lam,
                         cfg: SolidConfig) -> VolField:
    """Recompute the fixedGradient values of the traction patches
    (tractionDisplacementFvPatchVectorField::updateCoeffs)."""
    if not any(t is not None for t in cfg.traction):
        return D
    sig = _sigma_exp(gradD, mu, lam)
    bcs = list(D.bcs)
    for ip, (patch, trac) in enumerate(zip(mesh.patches, cfg.traction)):
        if trac is None:
            continue
        sl = patch.slice
        n = mesh.sf[sl] / torch.clamp(mesh.mag_sf[sl], min=1e-30)[:, None]
        tvec = torch.broadcast_to(
            torch.as_tensor(trac[0], dtype=mesh.v.dtype, device=mesh.device),
            n.shape)
        pres = torch.as_tensor(trac[1], dtype=mesh.v.dtype,
                               device=mesh.device)
        pres = pres[:, None] if pres.ndim == 1 else pres
        nsig = torch.einsum("fi,fij->fj", n, sig[mesh.owner[sl]])
        g = (tvec - pres * n - nsig) / (2.0 * mu + lam)
        bcs[ip] = bcs[ip].replace(ref_grad=g)
    return dataclasses.replace(D, bcs=tuple(bcs))


def solid_step(mesh, state: Dict, dt: Any, cfg: SolidConfig
               ) -> Tuple[Dict, Dict]:
    """One time step (transient) or one outer block (steady): the inner
    corrector iterations of the segregated D equation."""
    d_ctrl = cfg.d_controls or {"solver": "PCG",
                                "preconditioner": "polynomial",
                                "tolerance": 1e-9, "relTol": 0.01,
                                "maxIter": 1000}
    D: VolField = state["D"]
    rdt = 1.0 / _as_scalar(mesh, dt)
    mu, lam = lame(cfg)
    gamma = _as_scalar(mesh, 2.0 * mu + lam)
    diag: Dict[str, Any] = {}
    D0 = state.get("D0", D.data)
    D00 = state.get("D00", D0)
    traction = any(t is not None for t in cfg.traction)

    init_res = None
    for it in range(cfg.n_corr):
        gradD = fvc.grad(mesh, D)
        D = _update_traction_bcs(mesh, D, gradD, mu, lam, cfg)
        if traction:
            gradD = fvc.grad(mesh, D)  # with the updated BC gradients
        div_sig = _div_tensor(mesh, _sigma_exp(gradD, mu, lam))
        lap = fvm.laplacian(mesh, gamma, D, corrected=False,
                            gamma_dims=DimensionSet.of(0, 2, -2))
        if cfg.steady:
            DEqn = -lap
        else:
            DEqn = fvm.d2dt2(mesh, D, D0, D00, rdt) - lap
        DEqn = DEqn.add_source(div_sig, mesh)
        Ddata, perf = linear.solve(mesh, DEqn, D.data, d_ctrl)
        D = D.with_data(Ddata)
        if it == 0:
            init_res = perf
        diag["D"] = perf
    diag["D_initial"] = init_res.initial_residual

    new_state = dict(state)
    new_state.update(D=D)
    if not cfg.steady:
        new_state.update(D0=D.data, D00=D0)
    return new_state, diag


def sigma_of(mesh, D: VolField, cfg: SolidConfig):
    """The stress tensor sigma = mu(gradD + gradD.T) + lam I tr [nC,3,3],
    multiplied back by rho to physical units."""
    mu, lam = lame(cfg)
    g = fvc.grad(mesh, D)
    I3 = torch.eye(3, dtype=g.dtype, device=g.device)
    sig = (mu * (g + g.transpose(1, 2))
           + lam * _trace(g)[:, None, None] * I3)
    return sig * cfg.rho


def initial_state(mesh, D: VolField, steady: bool = False) -> Dict:
    st = {"D": D}
    if not steady:
        st.update(D0=D.data, D00=D.data)
    return st


def make_step(mesh, cfg: SolidConfig):
    """(state, dt) -> (state, diag) for one step of the solid solvers."""
    def step(state, dt):
        return solid_step(mesh, state, dt, cfg)

    return step
