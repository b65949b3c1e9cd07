"""interPhaseChangeFoam — VOF with cavitation phase change (port of
openfoam-2.2.x_tpu/solvers/interphasechange.py: alphaEqn.H with explicit
vDot sources, pEqn.H with the (vDotcP - vDotvP)(p_rgh - pSat + rho gh)
implicit sink, and the SchnerrSauer, Kunz and Merkle
phaseChangeTwoPhaseMixtures).

alpha1 = LIQUID fraction (reference convention). The phase-change
model returns volumetric rate coefficients per unit pressure
difference:
    mDot = vDotc * max(p - pSat, 0)   (condensation, vapour -> liquid)
         + vDotv * min(p - pSat, 0)   (vaporisation, liquid -> vapour)
so vaporisation destroys alpha1 where p < pSat. The alpha equation
carries the source explicitly (operator-split after MULES, bounded);
the pressure equation carries it implicitly as
    + (vDotc - vDotv)_P * (p_rgh - pSat + rho gh)
on its diagonal, so p_rgh's operator is the Laplacian plus a
cavitation sink, still one SpMV per Krylov iteration.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..bc.patchfields import default_bcs
from ..core.dimensions import DimensionSet, dimDensity, dimTime, dimViscosity
from ..core.fields import VolField
from ..models import interface as iface
from ..ops import fvc, fvm, schemes, surface
from . import linear
from .interfoam import InterConfig, alpha_step, mixture
from .piso import boundary_flux, face_interp_cell, needs_reference


class PhaseChangeConfig(NamedTuple):
    flow: InterConfig
    model: str = "SchnerrSauer"
    p_sat: float = 2300.0
    # SchnerrSauer (reference defaults)
    n_bubbles: float = 1.6e13     # bubble number density n
    d_nuc: float = 2.0e-6         # nucleation site diameter
    Cc: float = 1.0
    Cv: float = 1.0
    # Kunz
    U_inf: float = 20.0
    t_inf: float = 0.005
    kunz_Cc: float = 1000.0
    kunz_Cv: float = 1000.0
    # Merkle
    merkle_Cc: float = 80.0
    merkle_Cv: float = 1e-3


def _schnerr_sauer(cfg: PhaseChangeConfig, alpha1, p):
    """SchnerrSauer::mDotP (SchnerrSauer.C): (vDotcP, vDotvP), positive
    rate coefficients such that the volumetric vapour production is
    vDot*(p - pSat)."""
    f = cfg.flow
    a = torch.clamp(alpha1, 0.0, 1.0)
    # limited alpha with nucleation sites
    a_nuc = (math.pi * cfg.n_bubbles * cfg.d_nuc ** 3 / 6.0
             / (1.0 + math.pi * cfg.n_bubbles * cfg.d_nuc ** 3 / 6.0))
    # bubble radius from vapour fraction and n
    av = torch.clamp(1.0 - a + a_nuc, 1e-6, 1.0)
    rb = (3.0 * av / (4.0 * math.pi * cfg.n_bubbles
                      * torch.clamp(a, min=1e-6))) ** (1.0 / 3.0)
    rho_m = a * f.rho1 + (1.0 - a) * f.rho2
    coeff = (3.0 * f.rho1 * f.rho2 / torch.clamp(rho_m, min=1e-6)
             / torch.clamp(rb, min=1e-12)
             * torch.sqrt(2.0 / (3.0 * f.rho1
                                 * torch.clamp(torch.abs(p - cfg.p_sat),
                                               min=1e-2))))
    vDotc = cfg.Cc * a * (1.0 + a_nuc - a) * coeff / f.rho1
    vDotv = cfg.Cv * a * (1.0 - a + a_nuc) * coeff / f.rho1
    return vDotc, vDotv


def _kunz(cfg: PhaseChangeConfig, alpha1, p):
    """Kunz mDotAlphal (Kunz.C)."""
    f = cfg.flow
    a = torch.clamp(alpha1, 0.0, 1.0)
    q_inf = 0.5 * f.rho1 * cfg.U_inf ** 2
    mc = (cfg.kunz_Cc * f.rho2 / cfg.t_inf)
    mv = (cfg.kunz_Cv * f.rho2 / (q_inf * cfg.t_inf))
    vDotc = (mc * torch.clamp(1.0 - a, min=0.0) / f.rho1
             / torch.clamp(torch.abs(p - cfg.p_sat), min=1e-2))
    vDotv = mv * a / f.rho1
    return vDotc, vDotv


def _merkle(cfg: PhaseChangeConfig, alpha1, p):
    """Merkle mDotAlphal (Merkle.C)."""
    f = cfg.flow
    a = torch.clamp(alpha1, 0.0, 1.0)
    q_inf = 0.5 * f.rho1 * cfg.U_inf ** 2
    vDotc = (cfg.merkle_Cc * torch.clamp(1.0 - a, min=0.0)
             / (q_inf * cfg.t_inf * f.rho1) * f.rho2)
    vDotv = cfg.merkle_Cv * a / (q_inf * cfg.t_inf * f.rho1) * f.rho2
    return vDotc, vDotv


_MODELS = {"SchnerrSauer": _schnerr_sauer, "Kunz": _kunz,
           "Merkle": _merkle}


def phasechange_step(mesh, state: Dict, dt: Any,
                     cfg: PhaseChangeConfig) -> Tuple[Dict, Dict]:
    f = cfg.flow
    p_ctrl = f.p_controls or {"solver": "PCG", "tolerance": 1e-7,
                              "relTol": 0.05}
    u_ctrl = f.u_controls or {"solver": "PBiCGStab", "tolerance": 1e-7,
                              "relTol": 0.0, "maxIter": 200}
    U: VolField = state["U"]
    p_rgh: VolField = state["p_rgh"]
    alpha: VolField = state["alpha"]
    phi = state["phi"]
    rho_old = state["rho"]
    rdt = 1.0 / dt
    diag: Dict[str, Any] = {}

    g = torch.tensor(f.g, dtype=mesh.v.dtype, device=mesh.device)
    gh = mesh.c @ g
    ghf = mesh.cf @ g
    nif = mesh.n_internal_faces

    # ---- phase change rates at the OLD state --------------------------------
    p_abs = p_rgh.data + (rho_old * gh)
    vDotc, vDotv = _MODELS[cfg.model](cfg, alpha.data, p_abs)
    dp = p_abs - cfg.p_sat
    # volumetric vapour production rate [1/s] (liquid destruction)
    vdot = (vDotc * torch.clamp(dp, min=0.0)
            + vDotv * torch.clamp(dp, max=0.0))
    diag["vdot_min"] = torch.min(vdot)
    diag["vdot_max"] = torch.max(vdot)

    # ---- alpha (MULES + explicit phase-change source) ------------------------
    alpha, rho_phi = alpha_step(mesh, alpha, phi, dt, f)
    # vdot > 0 condenses (creates liquid alpha1); bounded update
    a_new = torch.clamp(alpha.data + dt * vdot, 0.0, 1.0)
    d_alpha = a_new - alpha.data
    alpha = alpha.with_data(a_new)
    rho, mu = mixture(f, alpha.data)
    diag["alpha_min"] = torch.min(alpha.data)
    diag["alpha_max"] = torch.max(alpha.data)

    # ---- momentum ------------------------------------------------------------
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
            - fvm.laplacian(mesh, mu_f, U, corrected=f.corrected,
                            gamma_dims=dimViscosity * dimDensity))
    st_flux = iface.surface_tension_flux(mesh, alpha, f.sigma)
    sng_rho = fvc.sn_grad(mesh, VolField(
        data=rho, bcs=default_bcs(mesh, rank=0), name="rho",
        dims=dimDensity))
    buoy_flux = -ghf * sng_rho * mesh.mag_sf * mesh.face_active
    grad_prgh = fvc.grad(mesh, p_rgh)
    if f.momentum_predictor:
        rhs_cell = fvc.reconstruct(mesh, st_flux + buoy_flux) - grad_prgh
        Udata, uperf = linear.solve(mesh, UEqn.add_source(rhs_cell, mesh),
                                    U.data, u_ctrl)
        U = U.with_data(Udata)
        diag["Ux"] = uperf

    # ---- PISO on p_rgh with the cavitation dilatation ------------------------
    rA = 1.0 / UEqn.A(mesh)
    rAf = face_interp_cell(mesh, rA)
    p_rgh = p_rgh.correct_boundary_conditions(mesh, phi=phi, U=U.data,
                                              rho_b=rho)
    # net specific-volume change per unit (p - pSat): the implicit
    # cavitation closure (pEqn.H: (vDotcP - vDotvP))
    vdot_p = vDotc - vDotv              # [1/(Pa s)]
    for corr in range(f.n_correctors):
        HbyA = rA[:, None] * UEqn.H(mesh, U.data)
        hf = surface.interpolate_internal(mesh, HbyA)
        phiHbyA_i = (torch.sum(mesh.sf[:nif] * hf, dim=1)
                     * mesh.face_active[:nif])
        phiHbyA = torch.cat([phiHbyA_i, boundary_flux(mesh, U)], dim=0)
        phig = rAf * (st_flux + buoy_flux)
        phiHbyA = phiHbyA + phig

        for nonorth in range(f.n_non_orth + 1):
            pEqn = fvm.laplacian(mesh, rAf, p_rgh,
                                 corrected=f.corrected,
                                 gamma_dims=dimTime)
            # implicit sink: + V vdot_p p_rgh on the diagonal, with the
            # explicit remainder V vdot_p (rho gh - pSat) in the source
            pEqn = pEqn.replace_fields(
                diag=pEqn.diag - mesh.v * vdot_p,
                source=(pEqn.source
                        + surface.surface_sum(mesh, phiHbyA)
                        + mesh.v * vdot_p * (rho * gh - cfg.p_sat)))
            pEqn, ctl_p = linear.prep_pressure(
                pEqn, needs_reference(p_rgh, mesh), p_ctrl,
                f.p_ref_cell, f.p_ref_value)
            pdata, pperf = linear.solve(mesh, pEqn, p_rgh.data, ctl_p)
            p_rgh = p_rgh.with_data(pdata)
            if corr == 0 and nonorth == 0:
                diag["p_initial"] = pperf.initial_residual
                diag["p_iters"] = pperf.n_iterations
            diag["p_final"] = pperf.final_residual
            if nonorth == f.n_non_orth:
                phi = phiHbyA - pEqn.flux(mesh, p_rgh.data)
        pflux = pEqn.flux(mesh, p_rgh.data)
        U = U.with_data(HbyA + rA[:, None] * fvc.reconstruct(
            mesh, (phig - pflux) / torch.clamp(rAf, min=1e-30)))
        U = U.correct_boundary_conditions(mesh, phi=phi)

    div_phi = surface.surface_sum(mesh, phi)
    diag["continuity"] = torch.sum(torch.abs(div_phi)) / torch.sum(mesh.v)
    diag["d_alpha_pc"] = torch.sum(torch.abs(d_alpha) * mesh.v)

    new_state = dict(state)
    new_state.update(U=U, p_rgh=p_rgh, alpha=alpha, phi=phi, rho=rho,
                     U0=U.data)
    return new_state, diag


def initial_state(mesh, U: VolField, p_rgh: VolField, alpha: VolField,
                  cfg: PhaseChangeConfig) -> Dict:
    rho, _ = mixture(cfg.flow, alpha.data)
    return {"U": U, "p_rgh": p_rgh, "alpha": alpha,
            "phi": fvc.flux(mesh, U), "rho": rho, "U0": U.data}


def make_step(mesh, cfg: PhaseChangeConfig):
    """(state, dt) -> (state, diag) for one interPhaseChangeFoam step."""
    def step(state, dt):
        return phasechange_step(mesh, state, dt, cfg)

    return step
