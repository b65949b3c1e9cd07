"""multiphaseEulerFoam — N interpenetrating phases (Euler-Euler), each with
its own velocity and flux, pairwise blended drag and a shared pressure
(port of openfoam-2.2.x_tpu/solvers/multiphaseeuler.py:
multiphaseSystem::solveAlphas, UEqns.H's pairwise dragCoeffs, pEqn.H's
mixture continuity; blended Schiller-Naumann drag is the closure, as in
the reference).

  alphaEqn_i: MULES-bounded d(alpha_i)/dt + div(phi_i alpha_i) = 0,
              then renormalised so sum_i alpha_i = 1 (solveAlphas).
  UEqn_i:     d(U_i)/dt + div(phi_i, U_i) - laplacian(nu_i, U_i)
                = -grad(p)/rho_i + g
                  + sum_{j!=i} K_ij/(rho_i alpha_i') (U_j - U_i)
              drag implicit in the own phase (Sp), explicit in the
              partner.
  pEqn:       sum_i div(alphaf_i phi_i) = 0 -> laplacian(Df, p),
              Df = sum_i alphaf_i rAf_i / rho_i.

  Pair drag (blended by which phase is locally continuous):
    K_ij = w_j Kd(d_i; rho_j, nu_j) alpha_i + w_i Kd(d_j; rho_i, nu_i) alpha_j
    Kd(d; rho_c, nu_c) = 0.75 Cd(Re) rho_c |Ur| / d,
    w_i = alpha_i / (alpha_i + alpha_j).

The state keeps U{i}, U0_{i} per phase and the phase fluxes as one
[nF, nP] array `phis`; the fractions are one [nC, nP] field carrying the
first phase's scalar BCs.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..core.dimensions import DimensionSet, dimTime, dimViscosity
from ..core.fields import VolField
from ..ops import fvc, fvm, mules, schemes, surface
from . import linear
from .piso import (_as_scalar, boundary_flux, face_interp_cell,
                   needs_reference)
from .twophaseeuler import _mag


class MultiphaseEulerConfig(NamedTuple):
    rhos: Tuple[float, ...]            # [nP]
    nus: Tuple[float, ...]             # [nP]
    ds: Tuple[float, ...]              # [nP] phase diameters
    g: Tuple[float, float, float] = (0.0, -9.81, 0.0)
    n_correctors: int = 2
    n_non_orth: int = 0
    corrected: bool = False
    p_ref_cell: int = 0
    p_ref_value: float = 0.0
    p_controls: Dict = None
    u_controls: Dict = None


def pair_drag(cfg: MultiphaseEulerConfig, i: int, j: int,
              alphas: Any, Ui: Any, Uj: Any):
    """Blended Schiller-Naumann K_ij [kg/m^3/s]: the interphase force
    density on phase i is K_ij (U_j - U_i) (dragModels/{blended,
    SchillerNaumann})."""
    ai = torch.clamp(alphas[:, i], min=1e-4)
    aj = torch.clamp(alphas[:, j], min=1e-4)
    Ur = Ui - Uj
    magUr = _mag(Ur)

    def kd(d, rho_c, nu_c):
        Re = torch.clamp(magUr * d / nu_c, min=1e-3)
        Cd = torch.where(Re < 1000.0,
                         24.0 / Re * (1.0 + 0.15 * Re ** 0.687),
                         torch.full_like(Re, 0.44))
        return 0.75 * Cd * rho_c * magUr / d

    w_i = ai / (ai + aj)
    w_j = 1.0 - w_i
    return (w_j * kd(cfg.ds[i], cfg.rhos[j], cfg.nus[j]) * ai
            + w_i * kd(cfg.ds[j], cfg.rhos[i], cfg.nus[i]) * aj)


def multiphase_euler_step(mesh, state: Dict, dt: Any,
                          cfg: MultiphaseEulerConfig
                          ) -> Tuple[Dict, Dict]:
    p_ctrl = cfg.p_controls or {"solver": "PCG",
                                "preconditioner": "polynomial",
                                "tolerance": 1e-8, "relTol": 0.01,
                                "maxIter": 1000}
    u_ctrl = cfg.u_controls or {"solver": "PBiCGStab",
                                "tolerance": 1e-7, "relTol": 0.0,
                                "maxIter": 200}
    nP = len(cfg.rhos)
    Us = [state[f"U{i}"] for i in range(nP)]
    U0s = [state[f"U0_{i}"] for i in range(nP)]
    phis = state["phis"]               # [nF, nP]
    p: VolField = state["p"]
    alpha: VolField = state["alphas"]  # [nC, nP], shared bcs
    rdt = 1.0 / dt
    nif = mesh.n_internal_faces
    diag: Dict[str, Any] = {}
    g = torch.tensor(cfg.g, dtype=mesh.v.dtype, device=mesh.device)
    gcell = torch.broadcast_to(g, (mesh.n_cells, 3))

    # ---- solveAlphas: per-phase MULES by the OWN phase flux, then
    # renormalise ------------------------------------------------------------
    A = alpha.data
    new_cols = []
    for i in range(nP):
        a_i = A[:, i]
        phi_i = phis[:, i]
        ab = alpha.with_data(a_i).boundary_values(mesh)
        w_up = (phi_i[:nif] >= 0).to(A.dtype)
        af_up = torch.cat(
            [surface.interpolate_internal(mesh, a_i, w_up), ab], dim=0)
        phi_bd = phi_i * af_up * mesh.face_active
        af_lin = torch.cat(
            [surface.interpolate_internal(mesh, a_i), ab], dim=0)
        phi_ho = phi_i * af_lin * mesh.face_active
        a_new, _ = mules.explicit_solve(mesh, a_i, phi_bd,
                                        phi_ho - phi_bd, dt,
                                        psi_max=1.0, psi_min=0.0)
        new_cols.append(a_new)
    A = torch.stack(new_cols, dim=1)
    A = A / torch.clamp(torch.sum(A, dim=1, keepdim=True), min=1e-6)
    alpha = alpha.with_data(A)
    diag["alpha_min"] = torch.min(A)
    diag["alpha_max"] = torch.max(A)

    # ---- phase momentum with pairwise partially-implicit drag -------------
    K = {}
    for i in range(nP):
        for j in range(i + 1, nP):
            K[(i, j)] = pair_drag(cfg, i, j, A, Us[i].data, Us[j].data)
    grad_p = fvc.grad_of(mesh, p, "Gauss linear")

    eqns, new_U, perf = [], [], []
    for i in range(nP):
        Uf = Us[i]
        phi_i = phis[:, i]
        w = schemes.weights(mesh, phi_i, "upwind", Uf)
        eqn = (fvm.ddt(mesh, Uf, U0s[i], rdt)
               + fvm.div(mesh, phi_i, Uf, weights=w)
               - fvm.laplacian(mesh, _as_scalar(mesh, cfg.nus[i]),
                               Uf, corrected=cfg.corrected,
                               gamma_dims=dimViscosity))
        src = -grad_p / cfg.rhos[i] + gcell
        for j in range(nP):
            if j == i:
                continue
            Kij = K[(min(i, j), max(i, j))]
            kfac = Kij / (cfg.rhos[i] * torch.clamp(A[:, i], min=1e-4))
            eqn = eqn + fvm.Sp(mesh, kfac, Uf)
            src = src + kfac[:, None] * Us[j].data
        eqn = eqn.add_source(src, mesh)
        eqns.append(eqn)
    for i in range(nP):
        Udata, uperf = linear.solve(mesh, eqns[i], Us[i].data, u_ctrl)
        new_U.append(Us[i].with_data(Udata))
        perf.append(uperf)
    Us = new_U
    diag["Ux"] = perf[0]

    # ---- shared pressure ----------------------------------------------------
    rAs = [1.0 / eqns[i].A(mesh) for i in range(nP)]
    rAfs = [face_interp_cell(mesh, rAs[i]) for i in range(nP)]
    afs = [face_interp_cell(mesh, A[:, i]) for i in range(nP)]

    HbyAs, phiHbyAs = [], []
    for i in range(nP):
        H = rAs[i][:, None] * eqns[i].H(mesh, Us[i].data)
        # H holds the full source incl. -grad(p)/rho: add it back so the
        # pressure enters only through the new solve
        H = H + rAs[i][:, None] * grad_p / cfg.rhos[i]
        HbyAs.append(H)
        hf = surface.interpolate_internal(mesh, H)
        fi = torch.sum(mesh.sf[:nif] * hf, dim=1) * mesh.face_active[:nif]
        phiHbyAs.append(torch.cat(
            [fi, boundary_flux(mesh, Us[i])], dim=0))

    phiHbyA = sum(afs[i] * phiHbyAs[i] for i in range(nP))
    Df = sum(afs[i] * rAfs[i] / cfg.rhos[i] for i in range(nP))

    for nonorth in range(cfg.n_non_orth + 1):
        pEqn = fvm.laplacian(mesh, Df, p, corrected=cfg.corrected,
                             gamma_dims=dimTime *
                             DimensionSet.of(-1, 3, 0))
        pEqn = pEqn.replace_fields(
            source=pEqn.source + surface.surface_sum(mesh, phiHbyA))
        pEqn, ctl_p = linear.prep_pressure(
            pEqn, needs_reference(p, mesh), p_ctrl,
            cfg.p_ref_cell, cfg.p_ref_value)
        pdata, pperf = linear.solve(mesh, pEqn, p.data, ctl_p)
        p = p.with_data(pdata)
        if nonorth == 0:
            diag["p_initial"] = pperf.initial_residual
            diag["p_iters"] = pperf.n_iterations
        diag["p_final"] = pperf.final_residual

    pflux = pEqn.flux(mesh, p.data)
    phi_mix = phiHbyA - pflux
    # the correction goes to the phase fluxes by mobility (pEqn.H's
    # phase-flux corrections)
    corr_face = pflux / torch.clamp(Df, min=1e-30)
    gp_new = fvc.grad_of(mesh, p, "Gauss linear")
    new_phis = []
    for i in range(nP):
        new_phis.append(phiHbyAs[i]
                        - (rAfs[i] / cfg.rhos[i]) * corr_face)
        Ui = Us[i].with_data(HbyAs[i]
                             - rAs[i][:, None] * gp_new / cfg.rhos[i])
        Us[i] = Ui.correct_boundary_conditions(mesh, phi=new_phis[i])
    phis = torch.stack(new_phis, dim=1)

    div_mix = surface.surface_sum(mesh, phi_mix)
    diag["continuity"] = torch.sum(torch.abs(div_mix)) / torch.sum(mesh.v)
    sum_phi = torch.sum(torch.abs(phi_mix)[mesh.cface]
                        * torch.abs(mesh.csign), dim=1)
    diag["courant_max"] = 0.5 * torch.max(sum_phi / mesh.v) * dt

    new_state = dict(state)
    new_state.update(p=p, alphas=alpha, phis=phis)
    for i in range(nP):
        new_state[f"U{i}"] = Us[i]
        new_state[f"U0_{i}"] = Us[i].data
    return new_state, diag


def initial_state(mesh, Us, p: VolField, alphas: VolField) -> Dict:
    state = {"p": p, "alphas": alphas,
             "phis": torch.stack([fvc.flux(mesh, U) for U in Us], dim=1)}
    for i, U in enumerate(Us):
        state[f"U{i}"] = U
        state[f"U0_{i}"] = U.data
    return state


def make_step(mesh, cfg: MultiphaseEulerConfig):
    """(state, dt) -> (state, diag) for one multiphaseEulerFoam step."""
    def step(state, dt):
        return multiphase_euler_step(mesh, state, dt, cfg)

    return step
