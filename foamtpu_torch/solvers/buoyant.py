"""buoyantBoussinesq{Simple,Pimple}Foam — buoyancy-driven incompressible
flow with the Boussinesq approximation (port of
openfoam-2.2.x_tpu/solvers/buoyant.py: heatTransfer/
buoyantBoussinesqSimpleFoam and buoyantBoussinesqPimpleFoam, UEqn.H,
TEqn.H, pEqn.H, createFields.H).

    rhok  = 1 - beta*(T - TRef)
    UEqn  : div(phi,U) + divDevReff(U)
            == reconstruct((-ghf*snGrad(rhok) - snGrad(p_rgh))*magSf)
    TEqn  : ddt(T) + div(phi,T) - laplacian(alphaEff,T) = 0,
            alphaEff = nu/Pr + nut/Prt
    pEqn  : phig = -rAUf*ghf*snGrad(rhok)*magSf
            phiHbyA = interp(HbyA).Sf + phig
            laplacian(rAUf, p_rgh) == div(phiHbyA)
            U += rAU*reconstruct((phig - pEqn.flux())/rAUf)

The step runs on the slot layout like the SIMPLE and PISO steps, so the
pressure and transport solves go through the offset-stencil SpMV kernel.
A step is eager torch; a chunk is a plain loop (the reference scans it).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..core.dimensions import dimTime, dimViscosity
from ..core.fields import VolField
from ..ops import fvc, fvm, schemes as schemes_mod, slot as slot_mod, surface
from . import linear
from .piso import (advance_time_state, boundary_flux, ddt_matrix,
                   needs_reference)
from .simple import adjust_phi


class BoussinesqConfig(NamedTuple):
    nu: float
    beta: float              # thermal expansion coefficient [1/K]
    t_ref: float             # TRef
    pr: float                # laminar Prandtl
    prt: float = 0.85        # turbulent Prandtl
    g: Tuple[float, float, float] = (0.0, -9.81, 0.0)
    steady: bool = True
    n_outer: int = 1         # PIMPLE outer correctors (transient)
    n_correctors: int = 2    # PISO correctors (transient)
    n_non_orth: int = 0
    corrected: bool = False
    corr_limit: float = 1.0
    div_scheme: str = "upwind"       # div(phi,U)
    div_scheme_t: str = "upwind"     # div(phi,T)
    ddt_scheme: str = "Euler"
    grad_scheme: str = "Gauss linear"
    p_ref_cell: int = 0
    p_ref_value: float = 0.0
    alpha_u: float = 0.3
    alpha_p: float = 0.7
    alpha_t: float = 0.5
    p_controls: Dict = None
    p_controls_final: Dict = None
    u_controls: Dict = None
    t_controls: Dict = None
    turb: Any = None
    turb_controls: Dict = None
    turb_relax: float = 0.7


def _sn_grad_slot(mesh, data, bv):
    """Face-normal gradient in slot form (orthogonal part), plus the
    boundary snGrad from the given boundary values."""
    d = slot_mod.delta(mesh, data)
    sv = mesh.st_sign * d.sv * mesh.st_dc
    fb = (mesh.fb_signs * d.fb * mesh.fb_dc
          if mesh.fb_cells.shape[0] else d.fb)
    nif = mesh.n_internal_faces
    vi = surface.owner_to_b(mesh, data)
    bvn = (bv - vi) * mesh.delta_coeffs[nif:]
    return slot_mod.SlotFace(sv, fb, bvn)


def _ghf(mesh, g):
    """g . Cf at faces, slot + boundary (ghf = g & mesh.Cf())."""
    gv = torch.tensor(g, dtype=mesh.v.dtype, device=mesh.device)
    return slot_mod.from_flat(mesh, mesh.cf @ gv)


def rhok_of(cfg: BoussinesqConfig, T: Any) -> Any:
    return 1.0 - cfg.beta * (T - cfg.t_ref)


def boussinesq_step(mesh, state: Dict, dt: Any, cfg: BoussinesqConfig
                    ) -> Tuple[Dict, Dict]:
    """One outer iteration (steady SIMPLE) or one time step (transient
    PIMPLE) of the Boussinesq buoyant solver."""
    p_ctrl = cfg.p_controls or {"solver": "PCG",
                                "preconditioner": "polynomial",
                                "tolerance": 1e-8, "relTol": 0.01,
                                "maxIter": 1000}
    u_ctrl = cfg.u_controls or {"solver": "smoothSolver",
                                "tolerance": 1e-6, "relTol": 0.1,
                                "maxIter": 300, "nSweeps": 2}
    t_ctrl = cfg.t_controls or u_ctrl

    U: VolField = state["U"]
    p_rgh: VolField = state["p_rgh"]
    T: VolField = state["T"]
    phi = state["phi"]
    nif = mesh.n_internal_faces
    dt = torch.as_tensor(dt, dtype=mesh.v.dtype, device=mesh.device)
    rdt = 1.0 / dt
    diag: Dict[str, Any] = {}
    new_turb = state.get("turb")
    has_fb = bool(mesh.fb_cells.shape[0])

    if "phi_slot" in state:
        phi_slot = slot_mod.SlotFace(*state["phi_slot"], bv=phi[nif:])
    else:
        phi_slot = slot_mod.from_flat(mesh, phi)
    use_corr = cfg.corrected and not getattr(mesh, "orthogonal", False)
    ghf = _ghf(mesh, cfg.g)
    closed = needs_reference(p_rgh, mesh)
    n_outer = 1 if cfg.steady else cfg.n_outer
    n_corr = 1 if cfg.steady else cfg.n_correctors
    magsf_b = mesh.mag_sf[nif:] * mesh.face_active[nif:]

    for outer in range(n_outer):
        final_outer = outer == n_outer - 1
        relax_now = cfg.steady or not final_outer

        rhok = rhok_of(cfg, T.data)
        rhok_b = surface.owner_to_b(mesh, rhok)  # zero-gradient extrapolation
        sng_rhok = _sn_grad_slot(mesh, rhok, rhok_b)

        # -- momentum --------------------------------------------------------
        w_slot = (None if cfg.div_scheme == "linear" else
                  schemes_mod.weights_slot(mesh, phi_slot, cfg.div_scheme, U))
        UEqn = fvm.div(mesh, phi, U, phi_slot=phi_slot, slot_weights=w_slot)
        if not cfg.steady:
            UEqn = (ddt_matrix(mesh, U, state, rdt, cfg.ddt_scheme)
                    + UEqn)
        if cfg.turb is not None:
            visc_mat, visc_expl = cfg.turb.div_dev_reff(mesh, new_turb, U)
            UEqn = UEqn + visc_mat
            UEqn = UEqn.add_source(-visc_expl, mesh)
        else:
            UEqn = UEqn - fvm.laplacian(
                mesh, torch.tensor(cfg.nu, dtype=mesh.v.dtype,
                                   device=mesh.device), U,
                corrected=cfg.corrected, gamma_dims=dimViscosity,
                limit=cfg.corr_limit)
        if relax_now and cfg.alpha_u < 1.0:
            UEqn = UEqn.relax(mesh, cfg.alpha_u, U.data)

        # buoyancy + pressure source: reconstruct((-ghf snGrad(rhok)
        # - snGrad(p_rgh)) * magSf)
        sng_p = _sn_grad_slot(mesh, p_rgh.data,
                              p_rgh.boundary_values(mesh))
        src_face = slot_mod.SlotFace(
            (-ghf.sv * sng_rhok.sv - sng_p.sv) * mesh.st_magsf,
            (-ghf.fb * sng_rhok.fb - sng_p.fb) * mesh.fb_magsf
            if has_fb else sng_p.fb,
            (-ghf.bv * sng_rhok.bv - sng_p.bv) * magsf_b,
        )
        buoy = fvc.reconstruct(mesh, slot_mod.to_flat(mesh, src_face))
        Umat = UEqn.add_source(buoy, mesh)
        Udata, uperf = linear.solve(mesh, Umat, U.data, u_ctrl)
        U = U.with_data(Udata)
        if outer == 0:
            diag["Ux"] = uperf

        # -- pressure correction ----------------------------------------------
        rA = 1.0 / UEqn.A(mesh)
        rA_b = surface.owner_to_b(mesh, rA)
        rAf_slot = slot_mod.interpolate(mesh, rA, bv=rA_b)
        rAf = slot_mod.to_flat(mesh, rAf_slot)
        pEqn0 = fvm.laplacian(
            mesh, rAf, p_rgh, corrected=cfg.corrected, gamma_dims=dimTime,
            limit=cfg.corr_limit, defer_correction=True,
            gamma_slot=rAf_slot)
        ctl_final0 = cfg.p_controls_final or p_ctrl
        p_ctrl_p, ctl_final_p = linear.prepare_controls(
            mesh, pEqn0, p_ctrl, ctl_final0)

        for corr in range(n_corr):
            HbyA = rA[:, None] * UEqn.H(mesh, U.data)
            phiHbyA_b0 = boundary_flux(mesh, U)
            # phig = -rAUf * ghf * snGrad(rhok) * magSf
            phig = slot_mod.SlotFace(
                -rAf_slot.sv * ghf.sv * sng_rhok.sv * mesh.st_magsf,
                (-rAf_slot.fb * ghf.fb * sng_rhok.fb * mesh.fb_magsf
                 if has_fb else sng_rhok.fb),
                -rAf_slot.bv * ghf.bv * sng_rhok.bv * magsf_b,
            )
            phiHbyA_b = phiHbyA_b0 + phig.bv
            if closed:
                phiHbyA_b = adjust_phi(mesh, phiHbyA_b, U)
            hba = slot_mod.flux_of(mesh, HbyA)
            phiHbyA = slot_mod.SlotFace(
                hba.sv + phig.sv, hba.fb + phig.fb, phiHbyA_b)

            p_before = p_rgh.data
            for nonorth in range(cfg.n_non_orth + 1):
                corr_face = None
                if use_corr:
                    corr_face, corr_cell = slot_mod.laplacian_correction(
                        mesh, rAf_slot, p_rgh.data,
                        p_rgh.boundary_values(mesh), limit=cfg.corr_limit)
                    src = (pEqn0.source - corr_cell
                           + slot_mod.surface_sum(mesh, phiHbyA))
                else:
                    src = pEqn0.source + slot_mod.surface_sum(mesh, phiHbyA)
                pEqn = pEqn0.replace_fields(source=src)
                final = (final_outer and corr == n_corr - 1
                         and nonorth == cfg.n_non_orth)
                ctl = ctl_final_p if final else p_ctrl_p
                pEqn, ctl = linear.prep_pressure(
                    pEqn, closed, ctl, cfg.p_ref_cell, cfg.p_ref_value)
                pdata, pperf = linear.solve(mesh, pEqn, p_rgh.data, ctl)
                p_rgh = p_rgh.with_data(pdata)
                if outer == 0 and corr == 0 and nonorth == 0:
                    diag["p_initial"] = pperf.initial_residual
                    diag["p_iters"] = pperf.n_iterations
                diag["p_final"] = pperf.final_residual
                if nonorth == cfg.n_non_orth:
                    F = slot_mod.laplacian_flux(
                        mesh, rAf_slot, p_rgh.data, corrected=use_corr,
                        corr=corr_face)
                    p_bc = surface.owner_to_b(mesh, p_rgh.data)
                    F_b = pEqn.ic * p_bc - pEqn.bc
                    phi_slot = slot_mod.SlotFace(
                        phiHbyA.sv - F.sv, phiHbyA.fb - F.fb,
                        phiHbyA_b - F_b)
                    # U correction: U += rA*reconstruct((phig - F)/rAUf)
                    du_face = slot_mod.SlotFace(
                        (phig.sv - F.sv) / torch.clamp(rAf_slot.sv,
                                                       min=1e-30),
                        (phig.fb - F.fb) / torch.clamp(rAf_slot.fb,
                                                       min=1e-30)
                        if has_fb else phig.fb,
                        (phig.bv - F_b) / torch.clamp(rAf_slot.bv,
                                                      min=1e-30),
                    )
                    dU = fvc.reconstruct(mesh, slot_mod.to_flat(mesh, du_face))
                    U = U.with_data(HbyA + rA[:, None] * dU)

            if relax_now and cfg.alpha_p < 1.0:
                p_rgh = p_rgh.with_data(
                    p_before + cfg.alpha_p * (p_rgh.data - p_before))
            phi_for_bc = torch.cat([phi.new_zeros(nif), phi_slot.bv], dim=0)
            U = U.correct_boundary_conditions(mesh, phi=phi_for_bc)
        phi = slot_mod.to_flat(mesh, phi_slot)

        # -- temperature ---------------------------------------------------
        nut = (cfg.turb.nut(mesh, new_turb) if cfg.turb is not None
               else torch.zeros_like(mesh.v))
        alpha_eff = cfg.nu / cfg.pr + nut / cfg.prt
        a_b = surface.owner_to_b(mesh, alpha_eff)
        a_slot = slot_mod.interpolate(mesh, alpha_eff, bv=a_b)
        wt_slot = (None if cfg.div_scheme_t == "linear" else
                   schemes_mod.weights_slot(mesh, phi_slot,
                                            cfg.div_scheme_t, T))
        if cfg.steady:
            TEqn = fvm.ddt_steady(mesh, T)
        else:
            TEqn = ddt_matrix(mesh, T, state, rdt, cfg.ddt_scheme, key="T")
        TEqn = (TEqn
                + fvm.div(mesh, phi, T, phi_slot=phi_slot,
                          slot_weights=wt_slot)
                - fvm.laplacian(mesh, slot_mod.to_flat(mesh, a_slot), T,
                                corrected=cfg.corrected,
                                gamma_dims=dimViscosity,
                                limit=cfg.corr_limit, gamma_slot=a_slot))
        if relax_now and cfg.alpha_t < 1.0:
            TEqn = TEqn.relax(mesh, cfg.alpha_t, T.data)
        Tdata, tperf = linear.solve(mesh, TEqn, T.data, t_ctrl)
        T = T.with_data(Tdata).correct_boundary_conditions(mesh)
        diag["T"] = tperf

        # -- turbulence ----------------------------------------------------
        if cfg.turb is not None and final_outer:
            new_turb, tdiag = cfg.turb.correct(
                mesh, new_turb, U, phi, dt, steady=cfg.steady,
                relax=cfg.turb_relax, controls=cfg.turb_controls,
                phi_slot=phi_slot)
            diag.update({f"turb_{k}": v for k, v in tdiag.items()})

    div_phi = slot_mod.surface_sum(mesh, phi_slot)
    vol = torch.sum(mesh.v)
    diag["continuity"] = torch.sum(torch.abs(div_phi)) / vol
    diag["continuity_global"] = torch.sum(div_phi) / vol

    new_state = dict(state)
    new_state.update(U=U, p_rgh=p_rgh, T=T, phi=phi,
                     phi_slot=(phi_slot.sv, phi_slot.fb))
    if not cfg.steady:
        advance_time_state(state, new_state, U, rdt, cfg.ddt_scheme)
        new_state["T0"] = T.data
    if new_turb is not None:
        new_state["turb"] = new_turb
    return new_state, diag


def initial_state(mesh, U: VolField, p_rgh: VolField, T: VolField,
                  turb_state: Optional[Dict] = None,
                  steady: bool = True) -> Dict:
    phi = fvc.flux(mesh, U)
    phi_sl = slot_mod.from_flat(mesh, phi)
    st = {"U": U, "p_rgh": p_rgh, "T": T, "phi": phi,
          "phi_slot": (phi_sl.sv, phi_sl.fb)}
    if not steady:
        st["U0"] = U.data
        st["T0"] = T.data
    if turb_state is not None:
        st["turb"] = turb_state
    return st


def make_step(mesh, cfg: BoussinesqConfig):
    """(state, dt) -> (state, diag) for one iteration or time step."""
    def step(state, dt):
        return boussinesq_step(mesh, state, dt, cfg)

    return step


def make_chunk(mesh, cfg: BoussinesqConfig, n: int):
    """(state, dt) -> (state, last diag) for n iterations (the
    reference's lax.scan chunk as a plain loop)."""
    def chunk(state, dt):
        diag = None
        for _ in range(n):
            state, diag = boussinesq_step(mesh, state, dt, cfg)
        return state, diag

    return chunk
