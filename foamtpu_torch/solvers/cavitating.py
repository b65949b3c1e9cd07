"""cavitatingFoam — barotropic cavitation, homogeneous equilibrium (port of
openfoam-2.2.x_tpu/solvers/cavitating.py: rhoEqn.H, pEqn.H with the
barotropic equation of state and the `linear`
barotropicCompressibilityModel):

    gamma = clip((rho - rholSat)/(rhovSat - rholSat), 0, 1)
    psi   = gamma psiv + (1-gamma) psil                (linear model)
    rho   = (1-gamma) rhol0 + psi p
    pEqn  : ddt(psi, p) + div(phiHbyA) - laplacian(rAUf, p)
            = -(drho_non-p terms)/dt                    (implicit in p)

Vapour appears wherever p falls to pSat; rho advances from its own
continuity equation. sonicLiquidFoam is this step with one liquid
phase that never cavitates (solvers/apps.py::cavitating_foam with
sonic_liquid=True).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..core.dimensions import DimensionSet, dimTime, dimViscosity
from ..core.fields import VolField
from ..ops import fvc, fvm, schemes, surface
from . import linear
from .piso import boundary_flux, face_interp_cell


class CavitatingConfig(NamedTuple):
    rhol0: float = 1000.0       # liquid density at pSat
    psil: float = 4.54e-7       # liquid compressibility [s^2/m^2]
    psiv: float = 2.5e-6        # vapour compressibility
    p_sat: float = 2300.0
    rho_min: float = 0.001
    nul: float = 1e-6
    nuv: float = 4.273e-7
    n_outer: int = 2
    n_correctors: int = 2
    n_non_orth: int = 0
    corrected: bool = False
    p_controls: Dict = None
    u_controls: Dict = None


def saturation_densities(cfg: CavitatingConfig):
    rhol_sat = cfg.rhol0 + cfg.psil * cfg.p_sat
    rhov_sat = cfg.psiv * cfg.p_sat
    return rhol_sat, rhov_sat


def gamma_of(cfg: CavitatingConfig, rho):
    rhol_sat, rhov_sat = saturation_densities(cfg)
    return torch.clamp((rho - rhol_sat) / (rhov_sat - rhol_sat), 0.0, 1.0)


def psi_of(cfg: CavitatingConfig, gamma):
    return gamma * cfg.psiv + (1.0 - gamma) * cfg.psil


def rho_of(cfg: CavitatingConfig, p, gamma):
    return torch.clamp(
        (1.0 - gamma) * cfg.rhol0 + psi_of(cfg, gamma) * p, min=cfg.rho_min)


def p_of(cfg: CavitatingConfig, rho, gamma):
    """EOS inversion p(rho, gamma) (pEqn.H: p ==
    (rho - (1-gamma) rhol0)/psi)."""
    return (rho - (1.0 - gamma) * cfg.rhol0) / torch.clamp(
        psi_of(cfg, gamma), min=1e-12)


def cavitating_step(mesh, state: Dict, dt: Any, cfg: CavitatingConfig
                    ) -> Tuple[Dict, Dict]:
    p_ctrl = cfg.p_controls or {"solver": "PCG",
                                "preconditioner": "polynomial",
                                "tolerance": 1e-8, "relTol": 0.01,
                                "maxIter": 1000}
    u_ctrl = cfg.u_controls or {"solver": "PBiCGStab", "tolerance": 1e-7,
                                "relTol": 0.0, "maxIter": 200}
    U: VolField = state["U"]
    p: VolField = state["p"]
    rho = state["rho"]
    phi = state["phi"]            # VOLUMETRIC flux
    rdt = 1.0 / dt
    nif = mesh.n_internal_faces
    diag: Dict[str, Any] = {}
    rho0 = rho

    for outer in range(cfg.n_outer):
        # ---- rhoEqn: explicit conservative update --------------------------
        rho_f = face_interp_cell(mesh, rho)
        rho = torch.clamp(
            rho0 - dt * surface.surface_sum(mesh, phi * rho_f) / mesh.v,
            min=cfg.rho_min)
        gamma = gamma_of(cfg, rho)
        psi = psi_of(cfg, gamma)
        diag["gamma_max"] = torch.max(gamma)
        diag["gamma_mean"] = torch.mean(gamma)

        # mixture viscosity
        mu = rho * (gamma * cfg.nuv + (1.0 - gamma) * cfg.nul)
        mu_f = face_interp_cell(mesh, mu)

        # ---- momentum (rho-weighted) ---------------------------------------
        rho_phi = phi * rho_f
        w = schemes.weights(mesh, rho_phi, "upwind", U)
        ddt_mat = fvm.ddt(mesh, U, state["U0"], rdt)
        ddt_mat = ddt_mat.replace_fields(
            diag=ddt_mat.diag * rho,
            source=ddt_mat.source * rho0[:, None],
            dims=ddt_mat.dims * DimensionSet.of(1, -3, 0))
        UEqn = (ddt_mat
                + fvm.div(mesh, rho_phi, U, weights=w,
                          phi_dims=DimensionSet.of(1, 0, -1))
                - fvm.laplacian(mesh, mu_f, U, corrected=cfg.corrected,
                                gamma_dims=dimViscosity
                                * DimensionSet.of(1, -3, 0)))
        grad_p = fvc.grad_of(mesh, p, "Gauss linear")
        Umat = UEqn.add_source(-grad_p, mesh)
        Udata, uperf = linear.solve(mesh, Umat, U.data, u_ctrl)
        U = U.with_data(Udata)
        diag["Ux"] = uperf

        # ---- pressure (barotropic compressible) ----------------------------
        rA = 1.0 / UEqn.A(mesh)
        rAf = face_interp_cell(mesh, rA)
        p_lin = p.data
        for corr in range(cfg.n_correctors):
            HbyA = rA[:, None] * UEqn.H(mesh, U.data)
            hf = surface.interpolate_internal(mesh, HbyA)
            phiHbyA_i = (torch.sum(mesh.sf[:nif] * hf, dim=1)
                         * mesh.face_active[:nif])
            phiHbyA = torch.cat([phiHbyA_i, boundary_flux(mesh, U)], dim=0)
            for nonorth in range(cfg.n_non_orth + 1):
                pEqn = fvm.laplacian(mesh, rAf, p,
                                     corrected=cfg.corrected,
                                     gamma_dims=dimTime)
                # continuity: V/dt (rho(p) - rho0) + div(rho phi) = 0,
                # linearised in p: rho(p) = rho* + psi (p - p*)
                ddt_diag = mesh.v * psi * rdt / torch.clamp(rho, min=1e-6)
                src = (pEqn.source
                       + surface.surface_sum(mesh, phiHbyA)
                       + mesh.v * rdt * (rho - rho0) / torch.clamp(
                           rho, min=1e-6)
                       - ddt_diag * p_lin)
                pEqn = pEqn.replace_fields(diag=pEqn.diag - ddt_diag,
                                           source=src)
                pdata, pperf = linear.solve(mesh, pEqn, p.data, p_ctrl)
                p = p.with_data(pdata)
                if outer == 0 and corr == 0 and nonorth == 0:
                    diag["p_initial"] = pperf.initial_residual
                    diag["p_iters"] = pperf.n_iterations
                diag["p_final"] = pperf.final_residual
                if nonorth == cfg.n_non_orth:
                    phi = phiHbyA - pEqn.flux(mesh, p.data)
            U = U.with_data(HbyA - rA[:, None]
                            * fvc.grad_of(mesh, p, "Gauss linear"))
            U = U.correct_boundary_conditions(mesh, phi=phi)
        # EOS update of rho from the new p (keeps rho/p/gamma
        # consistent; the mass error is re-absorbed by the next rhoEqn)
        rho = rho_of(cfg, p.data, gamma)
        gamma = gamma_of(cfg, rho)

    div_phi = surface.surface_sum(mesh, phi)
    diag["continuity"] = torch.sum(torch.abs(div_phi)) / torch.sum(mesh.v)
    diag["p_range"] = (torch.min(p.data), torch.max(p.data))
    sum_phi = torch.sum(torch.abs(phi)[mesh.cface] * torch.abs(mesh.csign),
                        dim=1)
    diag["courant_max"] = 0.5 * torch.max(sum_phi / mesh.v) * dt

    new_state = dict(state)
    new_state.update(U=U, p=p, rho=rho, phi=phi, U0=U.data)
    return new_state, diag


def initial_state(mesh, U: VolField, p: VolField,
                  cfg: CavitatingConfig) -> Dict:
    gamma = torch.zeros(mesh.n_cells, dtype=mesh.v.dtype,
                        device=mesh.device)
    # consistent start: assume liquid, then fix gamma from rho
    rho = rho_of(cfg, p.data, gamma)
    gamma = gamma_of(cfg, rho)
    rho = rho_of(cfg, p.data, gamma)
    return {"U": U, "p": p, "rho": rho, "phi": fvc.flux(mesh, U),
            "U0": U.data}


def make_step(mesh, cfg: CavitatingConfig):
    """(state, dt) -> (state, diag) for one cavitatingFoam step."""
    def step(state, dt):
        return cavitating_step(mesh, state, dt, cfg)

    return step
