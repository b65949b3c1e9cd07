"""interFoam — two-phase VOF solver with MULES-bounded alpha advection
(port of openfoam-2.2.x_tpu/solvers/interfoam.py: interFoam.C,
alphaEqn.H, alphaEqnSubCycle.H, UEqn.H, pEqn.H and the interface
properties).

Structure per step (eager torch):
  1. alpha sub-cycles: MULES FCT advection with interface compression
  2. mixture properties rho/mu from alpha
  3. momentum predictor on rho*U with gravity (gh formulation) and
     surface tension entering through face fluxes
  4. PISO pressure correction on p_rgh = p - rho g.x

The step assembles flat (upper/lower) matrices, not the slot form of the
PISO family: the linear solvers build their offset-stencil operator from
them (ops/stencil.py::mesh_stencil), so every Krylov iteration still
goes through the SpMV kernel. `lts=True` is LTSInterFoam's per-cell
pseudo-time stepping. Porous zones (fv_options), MRF zones and the
moving-mesh variant (interDyMFoam) are outside the ported slice and
raise NotImplementedError naming themselves.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..bc.patchfields import default_bcs
from ..core.dimensions import (DimensionSet, dimDensity, dimTime,
                               dimViscosity)
from ..core.fields import VolField
from ..models import interface as iface
from ..ops import fvc, fvm, mules, schemes, surface
from ..ops import slot as slot_mod
from . import linear
from .piso import boundary_flux, face_interp_cell, needs_reference


class InterConfig(NamedTuple):
    rho1: float
    rho2: float
    nu1: float
    nu2: float
    sigma: float
    g: Tuple[float, float, float] = (0.0, -9.81, 0.0)
    c_alpha: float = 1.0
    # LTSInterFoam mode (LTSInterFoam/setRDeltaT.H): per-cell pseudo-time
    # from the local Courant limit, smoothed and change-rate damped
    lts: bool = False
    lts_max_co: float = 0.5
    lts_max_dt: float = 1e6
    lts_smooth_sweeps: int = 3
    lts_damping: float = 1.2         # dt may grow <=20% per step
    n_alpha_subcycles: int = 1
    n_alpha_corr: int = 1
    n_correctors: int = 3
    n_non_orth: int = 0
    momentum_predictor: bool = True
    corrected: bool = False
    p_ref_cell: int = 0
    p_ref_value: float = 0.0
    p_controls: Dict = None
    u_controls: Dict = None
    fv_options: Any = None
    mrf: Any = None


def check_supported(state: Dict, cfg: InterConfig) -> None:
    """Raise NotImplementedError for any feature outside the slice."""
    def no(what):
        raise NotImplementedError(f"{what} is not ported to foamtpu_torch yet")

    for name in ("fv_options", "mrf"):
        if getattr(cfg, name):
            no(f"InterConfig.{name}")
    if "mesh_phi" in state:
        no("the moving-mesh flux of interDyMFoam (state['mesh_phi'])")


def mixture(cfg: InterConfig, alpha: Any) -> Tuple[Any, Any]:
    """rho, mu from the phase fraction (incompressibleTwoPhaseMixture)."""
    a = torch.clamp(alpha, 0.0, 1.0)
    rho = a * cfg.rho1 + (1.0 - a) * cfg.rho2
    mu = a * cfg.rho1 * cfg.nu1 + (1.0 - a) * cfg.rho2 * cfg.nu2
    return rho, mu


def alpha_step(mesh, alpha: VolField, phi: Any, dt: Any,
               cfg: InterConfig, U=None) -> Tuple[VolField, Any]:
    """One MULES-bounded alpha advection step; returns (alpha, rhoPhi)."""
    a = alpha.data
    nif = mesh.n_internal_faces
    sub_dt = dt / cfg.n_alpha_subcycles
    rho_phi_sum = torch.zeros_like(phi)

    for _ in range(cfg.n_alpha_subcycles):
        phir = iface.compression_flux(mesh, phi, alpha.with_data(a),
                                      cfg.c_alpha, U=U)
        # bounded (upwind) flux of alpha by phi
        w_up = (phi[:nif] >= 0).to(a.dtype)
        af_up_i = surface.interpolate_internal(mesh, a, w_up)
        ab = alpha.with_data(a).boundary_values(mesh)
        af_up = torch.cat([af_up_i, ab], dim=0)
        phi_bd = phi * af_up * mesh.face_active

        # high-order flux: linear alpha + compression phir*alpha*(1-alpha)
        af_lin_i = surface.interpolate_internal(mesh, a)
        af_lin = torch.cat([af_lin_i, ab], dim=0)
        a1f_i = surface.interpolate_internal(mesh, 1.0 - a)
        a1f = torch.cat([a1f_i, 1.0 - ab], dim=0)
        phi_ho = (phi * af_lin + phir * af_lin * a1f) * mesh.face_active
        phi_corr = phi_ho - phi_bd

        a, phi_alpha = mules.explicit_solve(
            mesh, a, phi_bd, phi_corr, sub_dt, psi_max=1.0, psi_min=0.0)
        rho_phi_sum = rho_phi_sum + (
            phi_alpha * (cfg.rho1 - cfg.rho2) + phi * cfg.rho2
        ) / cfg.n_alpha_subcycles

    return alpha.with_data(a), rho_phi_sum


def interfoam_step(mesh, state: Dict, dt: Any, cfg: InterConfig
                   ) -> Tuple[Dict, Dict]:
    """One interFoam time step. state: {"U", "p_rgh", "alpha": VolField,
    "phi": [nF], "rho": [nC], "U0"}. dt is a scalar, or per cell [nC]
    under local time stepping. Returns (new_state, diagnostics)."""
    check_supported(state, cfg)
    p_ctrl = cfg.p_controls or {"solver": "PCG", "tolerance": 1e-7,
                                "relTol": 0.05}
    u_ctrl = cfg.u_controls or {"solver": "PBiCGStab", "tolerance": 1e-7,
                                "relTol": 0.0, "maxIter": 200}
    U: VolField = state["U"]
    p_rgh: VolField = state["p_rgh"]
    alpha: VolField = state["alpha"]
    phi = state["phi"]
    rho_old = state["rho"]
    dt = torch.as_tensor(dt, dtype=mesh.v.dtype, device=mesh.device)
    rdt = 1.0 / dt
    diag: Dict[str, Any] = {}
    nif = mesh.n_internal_faces

    g = torch.tensor(cfg.g, dtype=mesh.v.dtype, device=mesh.device)
    ghf = mesh.cf @ g          # [nF]

    # ---- alpha advection (MULES) -------------------------------------------
    alpha, rho_phi = alpha_step(mesh, alpha, phi, dt, cfg, U=U)
    rho, mu = mixture(cfg, alpha.data)
    diag["alpha_min"] = torch.min(alpha.data)
    diag["alpha_max"] = torch.max(alpha.data)

    # ---- momentum ------------------------------------------------------------
    mu_f = face_interp_cell(mesh, mu)
    w_div = schemes.weights(mesh, rho_phi, "vanLeer", U)
    ddt_mat = fvm.ddt(mesh, U, state["U0"], rdt)
    # variable-density Euler ddt: diag rho^n+1 V/dt, source rho^n V/dt U^n
    ddt_mat = ddt_mat.replace_fields(
        diag=ddt_mat.diag * rho,
        source=ddt_mat.source * rho_old[:, None],
        dims=ddt_mat.dims * dimDensity,
    )
    UEqn = (
        ddt_mat
        + fvm.div(mesh, rho_phi, U, weights=w_div,
                  phi_dims=DimensionSet.of(1, 0, -1))
        - fvm.laplacian(mesh, mu_f, U, corrected=cfg.corrected,
                        gamma_dims=dimViscosity * dimDensity)
    )
    # surface tension + buoyancy face fluxes (UEqn.H rhs)
    st_flux = iface.surface_tension_flux(mesh, alpha, cfg.sigma, U=U)
    sng_rho = fvc.sn_grad(mesh, VolField(
        data=rho, bcs=default_bcs(mesh, rank=0), name="rho",
        dims=dimDensity))
    buoy_flux = -ghf * sng_rho * mesh.mag_sf * mesh.face_active
    grad_prgh = fvc.grad(mesh, p_rgh)
    if cfg.momentum_predictor:
        rhs_face = st_flux + buoy_flux
        rhs_cell = fvc.reconstruct(mesh, rhs_face) - grad_prgh
        Umat = UEqn.add_source(rhs_cell, mesh)
        Udata, uperf = linear.solve(mesh, Umat, U.data, u_ctrl)
        U = U.with_data(Udata)
        diag["Ux"] = uperf
    else:
        diag["Ux"] = None

    # ---- PISO on p_rgh ---------------------------------------------------------
    rA = 1.0 / UEqn.A(mesh)
    rAf = face_interp_cell(mesh, rA)
    p_rgh = p_rgh.correct_boundary_conditions(mesh, phi=phi, U=U.data,
                                              rho_b=rho)
    for corr in range(cfg.n_correctors):
        HbyA = rA[:, None] * UEqn.H(mesh, U.data)
        hf = surface.interpolate_internal(mesh, HbyA)
        phiHbyA_i = (torch.sum(mesh.sf[:nif] * hf, dim=1)
                     * mesh.face_active[:nif])
        phiHbyA = torch.cat([phiHbyA_i, boundary_flux(mesh, U)], dim=0)
        phig = rAf * (st_flux + buoy_flux)
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

        # U = HbyA + rAU*reconstruct((phig - pEqn.flux())/rAUf)
        # (interFoam/pEqn.H)
        pflux = pEqn.flux(mesh, p_rgh.data)
        U = U.with_data(
            HbyA + rA[:, None] * fvc.reconstruct(
                mesh, (phig - pflux) / torch.clamp(rAf, min=1e-30)))
        U = U.correct_boundary_conditions(mesh, phi=phi)

    div_phi = surface.surface_sum(mesh, phi)
    vol = torch.sum(mesh.v)
    diag["continuity"] = torch.sum(torch.abs(div_phi)) / vol
    diag["continuity_global"] = torch.sum(div_phi) / vol
    sum_phi = torch.sum(torch.abs(phi)[mesh.cface] * torch.abs(mesh.csign),
                        dim=1)
    # elementwise before the max so a per-cell LTS dt works too
    diag["courant_max"] = 0.5 * torch.max(sum_phi / mesh.v * dt)

    new_state = dict(state)
    new_state.update(U=U, p_rgh=p_rgh, alpha=alpha, phi=phi, rho=rho,
                     U0=U.data)
    return new_state, diag


def make_step(mesh, cfg: InterConfig):
    """(state, dt) -> (state, diag) for one interFoam step (the LTS step
    when cfg.lts)."""
    def step(state, dt):
        if cfg.lts:
            return lts_interfoam_step(mesh, state, dt, cfg)
        return interfoam_step(mesh, state, dt, cfg)

    return step


def initial_state(mesh, U: VolField, p_rgh: VolField, alpha: VolField,
                  cfg: InterConfig) -> Dict:
    rho, _ = mixture(cfg, alpha.data)
    st = {"U": U, "p_rgh": p_rgh, "alpha": alpha,
          "phi": fvc.flux(mesh, U), "rho": rho, "U0": U.data}
    if cfg.lts:
        st["lts_rdt"] = torch.full((mesh.n_cells,), 1.0 / cfg.lts_max_dt,
                                   dtype=mesh.v.dtype, device=mesh.device)
    return st


# ---------------------------------------------------------------------------
# LTSInterFoam: local (per-cell) pseudo-time stepping
# (LTSInterFoam/setRDeltaT.H + the fv::localEulerDdtScheme family)
# ---------------------------------------------------------------------------


def lts_rdelta_t(mesh, phi, rdt_old, cfg: InterConfig):
    """Per-cell 1/deltaT: local Courant limit, neighbour-max smoothing
    (the fvc::smooth analogue), and growth damping vs the previous
    field."""
    sum_phi = torch.sum(torch.abs(phi)[mesh.cface] * torch.abs(mesh.csign),
                        dim=1)
    rdt = torch.clamp(sum_phi / (2.0 * cfg.lts_max_co * mesh.v),
                      min=1.0 / cfg.lts_max_dt)
    for _ in range(cfg.lts_smooth_sweeps):
        nb = slot_mod.nbr_values(mesh, rdt)
        nb = torch.where(mesh.st_valid > 0, nb, torch.zeros_like(nb))
        rdt = torch.maximum(rdt, 0.7 * torch.amax(nb, dim=1))
    if rdt_old is not None:
        # dt must not grow faster than lts_damping per step
        rdt = torch.maximum(rdt, rdt_old / cfg.lts_damping)
    return rdt


def lts_interfoam_step(mesh, state, dt_unused, cfg: InterConfig):
    """One LTS pseudo-time step: each cell advances by its own local dt
    toward steady state; the `dt` argument is ignored (kept for the
    signature of the other steps)."""
    rdt = lts_rdelta_t(mesh, state["phi"], state.get("lts_rdt"), cfg)
    dt_cell = 1.0 / rdt
    new_state, diag = interfoam_step(mesh, state, dt_cell, cfg)
    # the local CFL is computed from the PREVIOUS step's flux; during
    # startup transients the lagged bound can transiently violate strict
    # FCT boundedness: clamp, as LTS practice does
    a = new_state["alpha"]
    new_state["alpha"] = a.with_data(torch.clamp(a.data, 0.0, 1.0))
    new_state["lts_rdt"] = rdt
    diag["lts_dt_min"] = torch.min(dt_cell)
    diag["lts_dt_max"] = torch.max(dt_cell)
    return new_state, diag


# ---------------------------------------------------------------------------
# interDyMFoam: interFoam on a (solid-body) moving mesh. It needs the
# reference's mesh/moving.py, which is outside the ported slice.
# ---------------------------------------------------------------------------


def _no_dym(name):
    raise NotImplementedError(
        f"{name} (interDyMFoam, mesh/moving.py) is not ported to "
        "foamtpu_torch yet")


def interdym_step(mesh, state, dt, cfg: InterConfig, pts_fn, umesh_fn):
    _no_dym("interdym_step")


def interdym_initial_state(pm, mesh, U, p_rgh, alpha, cfg: InterConfig,
                           umesh_fn=None):
    _no_dym("interdym_initial_state")


def make_dym_step(mesh, cfg: InterConfig, pts_fn, umesh_fn):
    _no_dym("make_dym_step")
