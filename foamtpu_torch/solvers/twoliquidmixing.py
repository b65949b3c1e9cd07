"""twoLiquidMixingFoam — two miscible incompressible liquids (port of
openfoam-2.2.x_tpu/solvers/twoliquidmixing.py: alphaEqn.H with
fvm::laplacian(Dab) diffusion — the phases mix, so no MULES interface
compression — and interFoam's UEqn.H/pEqn.H on p_rgh).

The alpha equation is implicit (ddt, vanLeer div, laplacian): a
non-symmetric scalar operator, solved through the offset-stencil SpMV
like every other solve of the step.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..bc.patchfields import default_bcs
from ..core.dimensions import (DimensionSet, dimDensity, dimTime,
                               dimViscosity)
from ..core.fields import VolField
from ..ops import fvc, fvm, schemes, surface
from . import linear
from .piso import (_as_scalar, boundary_flux, face_interp_cell,
                   needs_reference)


class TwoLiquidConfig(NamedTuple):
    rho1: float = 1010.0
    rho2: float = 1000.0
    nu1: float = 1e-6
    nu2: float = 1e-6
    Dab: float = 1e-6            # molecular interdiffusion
    g: Tuple[float, float, float] = (0.0, -9.81, 0.0)
    n_correctors: int = 3
    n_non_orth: int = 0
    momentum_predictor: bool = True
    corrected: bool = False
    p_ref_cell: int = 0
    p_ref_value: float = 0.0
    p_controls: Dict = None
    u_controls: Dict = None
    a_controls: Dict = None


def twoliquid_step(mesh, state: Dict, dt: Any, cfg: TwoLiquidConfig
                   ) -> Tuple[Dict, Dict]:
    p_ctrl = cfg.p_controls or {"solver": "PCG",
                                "preconditioner": "polynomial",
                                "tolerance": 1e-7, "relTol": 0.05,
                                "maxIter": 1000}
    u_ctrl = cfg.u_controls or {"solver": "PBiCGStab", "tolerance": 1e-7,
                                "relTol": 0.0, "maxIter": 200}
    a_ctrl = cfg.a_controls or {"solver": "PBiCGStab", "tolerance": 1e-8,
                                "relTol": 0.0, "maxIter": 200}
    U: VolField = state["U"]
    p_rgh: VolField = state["p_rgh"]
    alpha: VolField = state["alpha"]
    phi = state["phi"]
    rho_old = state["rho"]
    rdt = 1.0 / dt
    nif = mesh.n_internal_faces
    diag: Dict[str, Any] = {}
    g = torch.tensor(cfg.g, dtype=mesh.v.dtype, device=mesh.device)
    ghf = mesh.cf @ g

    # ---- alpha: implicit advection-diffusion (miscible — no MULES) ---------
    w_up = schemes.weights(mesh, phi, "vanLeer", alpha)
    aEqn = (fvm.ddt(mesh, alpha, state["alpha0"], rdt)
            + fvm.div(mesh, phi, alpha, weights=w_up)
            - fvm.laplacian(mesh, _as_scalar(mesh, cfg.Dab), alpha,
                            corrected=cfg.corrected,
                            gamma_dims=dimViscosity))
    adata, aperf = linear.solve(mesh, aEqn, alpha.data, a_ctrl)
    alpha = alpha.with_data(torch.clamp(adata, 0.0, 1.0))
    alpha = alpha.correct_boundary_conditions(mesh, phi=phi)
    diag["alpha"] = aperf
    diag["alpha_min"] = torch.min(alpha.data)
    diag["alpha_max"] = torch.max(alpha.data)

    a = alpha.data
    rho = a * cfg.rho1 + (1.0 - a) * cfg.rho2
    mu = a * cfg.rho1 * cfg.nu1 + (1.0 - a) * cfg.rho2 * cfg.nu2
    rho_phi = phi * face_interp_cell(mesh, rho)

    # ---- momentum -----------------------------------------------------------
    mu_f = face_interp_cell(mesh, mu)
    w_div = schemes.weights(mesh, rho_phi, "vanLeer", U)
    ddt_mat = fvm.ddt(mesh, U, state["U0"], rdt)
    ddt_mat = ddt_mat.replace_fields(
        diag=ddt_mat.diag * rho,
        source=ddt_mat.source * rho_old[:, None],
        dims=ddt_mat.dims * dimDensity)
    UEqn = (ddt_mat
            + fvm.div(mesh, rho_phi, U, weights=w_div,
                      phi_dims=DimensionSet.of(1, 0, -1))
            - fvm.laplacian(mesh, mu_f, U, corrected=cfg.corrected,
                            gamma_dims=dimViscosity * dimDensity))
    sng_rho = fvc.sn_grad(mesh, VolField(
        data=rho, bcs=default_bcs(mesh, rank=0), name="rho",
        dims=dimDensity))
    buoy_flux = -ghf * sng_rho * mesh.mag_sf * mesh.face_active
    grad_prgh = fvc.grad(mesh, p_rgh)
    if cfg.momentum_predictor:
        rhs_cell = fvc.reconstruct(mesh, buoy_flux) - grad_prgh
        Umat = UEqn.add_source(rhs_cell, mesh)
        Udata, uperf = linear.solve(mesh, Umat, U.data, u_ctrl)
        U = U.with_data(Udata)
        diag["Ux"] = uperf

    # ---- PISO on p_rgh ------------------------------------------------------
    rA = 1.0 / UEqn.A(mesh)
    rAf = face_interp_cell(mesh, rA)
    for corr in range(cfg.n_correctors):
        HbyA = rA[:, None] * UEqn.H(mesh, U.data)
        hf = surface.interpolate_internal(mesh, HbyA)
        phiHbyA_i = (torch.sum(mesh.sf[:nif] * hf, dim=1)
                     * mesh.face_active[:nif])
        phiHbyA = torch.cat([phiHbyA_i, boundary_flux(mesh, U)], dim=0)
        phig = rAf * buoy_flux
        phiHbyA = phiHbyA + phig
        for nonorth in range(cfg.n_non_orth + 1):
            pEqn = fvm.laplacian(mesh, rAf, p_rgh,
                                 corrected=cfg.corrected,
                                 gamma_dims=dimTime)
            pEqn = pEqn.replace_fields(
                source=pEqn.source + surface.surface_sum(mesh, phiHbyA))
            pEqn, ctl_p = linear.prep_pressure(
                pEqn, needs_reference(p_rgh, mesh), p_ctrl,
                cfg.p_ref_cell, cfg.p_ref_value)
            pdata, pperf = linear.solve(mesh, pEqn, p_rgh.data, ctl_p)
            p_rgh = p_rgh.with_data(pdata)
            if corr == 0 and nonorth == 0:
                diag["p_initial"] = pperf.initial_residual
                diag["p_iters"] = pperf.n_iterations
            diag["p_final"] = pperf.final_residual
            if nonorth == cfg.n_non_orth:
                phi = phiHbyA - pEqn.flux(mesh, p_rgh.data)
        pflux = pEqn.flux(mesh, p_rgh.data)
        U = U.with_data(
            HbyA + rA[:, None] * fvc.reconstruct(
                mesh, (phig - pflux) / torch.clamp(rAf, min=1e-30)))
        U = U.correct_boundary_conditions(mesh, phi=phi)

    div_phi = surface.surface_sum(mesh, phi)
    diag["continuity"] = torch.sum(torch.abs(div_phi)) / torch.sum(mesh.v)
    sum_phi = torch.sum(torch.abs(phi)[mesh.cface] * torch.abs(mesh.csign),
                        dim=1)
    diag["courant_max"] = 0.5 * torch.max(sum_phi / mesh.v) * dt

    new_state = dict(state)
    new_state.update(U=U, p_rgh=p_rgh, alpha=alpha, phi=phi, rho=rho,
                     U0=U.data, alpha0=alpha.data)
    return new_state, diag


def initial_state(mesh, U: VolField, p_rgh: VolField,
                  alpha: VolField, cfg: TwoLiquidConfig) -> Dict:
    a = alpha.data
    rho = a * cfg.rho1 + (1.0 - a) * cfg.rho2
    return {"U": U, "p_rgh": p_rgh, "alpha": alpha,
            "phi": fvc.flux(mesh, U), "rho": rho, "U0": U.data,
            "alpha0": a}


def make_step(mesh, cfg: TwoLiquidConfig):
    """(state, dt) -> (state, diag) for one twoLiquidMixingFoam step."""
    def step(state, dt):
        return twoliquid_step(mesh, state, dt, cfg)

    return step
