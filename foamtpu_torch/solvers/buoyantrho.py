"""buoyantSimpleFoam / buoyantPimpleFoam: compressible buoyancy-driven
flow (port of openfoam-2.2.x_tpu/solvers/buoyantrho.py:
`BuoyantRhoConfig`, `buoyantrho_step`, `initial_state`, `make_step`;
applications/solvers/heatTransfer/{buoyantSimpleFoam,buoyantPimpleFoam}/
{U,h,p}Eqn.H):

    p     = p_rgh + rho*gh,  gh = g.C,  ghf = g.Cf
    rho   = thermo.rho(p,T) = psi*p
    UEqn  : ddt(rho,U) + div(phi,U) - laplacian(muEff,U)
            == reconstruct((-ghf*snGrad(rho) - snGrad(p_rgh))*magSf)
    EEqn  : the T form of the h (= Cp T, hConst) equation with the
            dp/dt - (ddt(rho,K) + div(phi,K)) sources, as in rhopimple.py
            (the reference takes the buoyantPimpleFoam form for both)
    pEqn  : psi*ddt(p_rgh) [transient] + div(phiHbyA + phig)
            - laplacian(rhorAUf, p_rgh) = -ddt(rho)|explicit
            phig = -rhorAUf*ghf*snGrad(rho)*magSf
            phi  = phiHbyA - pEqn.flux();  p = p_rgh + rho*gh

p_rgh is solved shifted by the operating pressure (pRefValue, 1e5 Pa by
default), as rhopimple.py solves p: in float32 the absolute level would
drown the per-face differences. phi is the MASS flux. With a
`radiation` config (models/radiation.py: P1 or fvDOM) and a "G" in the
state, each outer iteration solves G at the current T and adds Sh/Cp to
the T equation (EEqn.H's `+ radiation->Sh(thermo)`, reference
buoyantrho.py:224-236).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..bc import patchfields as pf
from ..core.dimensions import DimensionSet, dimTime
from ..core.fields import VolField
from ..ops import fvc, fvm, schemes as schemes_mod, slot as slot_mod, surface
from . import linear
from .buoyant import _ghf, _sn_grad_slot
from .piso import boundary_flux, needs_reference
from .rhopimple import _rho_ddt
from .simple import adjust_phi

_MASS_FLUX = DimensionSet.of(1, 0, -1)
_DYN_VISC = DimensionSet.of(1, -1, -1)


class BuoyantRhoConfig(NamedTuple):
    thermo: Any               # models/thermo.PerfectGas (or a twin)
    g: Tuple[float, float, float] = (0.0, -9.81, 0.0)
    steady: bool = False
    n_outer: int = 1
    n_correctors: int = 2
    n_non_orth: int = 0
    corrected: bool = False
    corr_limit: float = 1.0
    div_scheme: str = "upwind"
    div_scheme_e: str = "upwind"
    grad_scheme: str = "Gauss linear"
    alpha_u: float = 1.0
    alpha_p: float = 1.0
    alpha_e: float = 1.0
    p_ref_cell: int = 0
    p_ref_value: float = 1e5   # operating pressure (pRefValue)
    p_min: float = 100.0
    rho_min: float = 0.01
    prt: float = 0.85
    p_controls: Dict = None
    p_controls_final: Dict = None
    u_controls: Dict = None
    e_controls: Dict = None
    turb: Any = None
    turb_controls: Dict = None
    turb_relax: float = 0.7
    radiation: Any = None     # the P1/fvDOM config of models/radiation.py


def _gh(mesh, g):
    return mesh.c @ torch.tensor(g, dtype=mesh.v.dtype, device=mesh.device)


def buoyantrho_step(mesh, state: Dict, dt: Any, cfg: BuoyantRhoConfig
                    ) -> Tuple[Dict, Dict]:
    th = cfg.thermo
    p_ctrl = cfg.p_controls or {"solver": "PCG",
                                "preconditioner": "polynomial",
                                "tolerance": 1e-8, "relTol": 0.01,
                                "maxIter": 1000}
    u_ctrl = cfg.u_controls or {"solver": "PBiCGStab", "tolerance": 1e-7,
                                "relTol": 0.1, "maxIter": 300}
    e_ctrl = cfg.e_controls or u_ctrl

    U: VolField = state["U"]
    p_rgh: VolField = state["p_rgh"]
    T: VolField = state["T"]
    phi = state["phi"]            # MASS flux
    nif = mesh.n_internal_faces
    rdt = 1.0 / dt
    diag: Dict[str, Any] = {}
    new_turb = state.get("turb")

    if "phi_slot" in state:
        phi_slot = slot_mod.SlotFace(*state["phi_slot"], bv=phi[nif:])
    else:
        phi_slot = slot_mod.from_flat(mesh, phi)
    ghf = _ghf(mesh, cfg.g)
    gh = _gh(mesh, cfg.g)
    closed = needs_reference(p_rgh, mesh)
    n_outer = 1 if cfg.steady else cfg.n_outer
    n_corr = 1 if cfg.steady else cfg.n_correctors
    use_corr = cfg.corrected and not getattr(mesh, "orthogonal", False)
    comp_turb = getattr(cfg.turb, "compressible_form", False)

    p_op = cfg.p_ref_value

    def p_abs(p_shifted, rho):
        """The absolute p from the shifted p_rgh' = p_rgh - p_op."""
        return p_shifted + p_op + rho * gh

    # the absolute pressure's fixed point at the current state
    p_sh = p_rgh.data - p_op
    rho0g = state.get("rho0")
    rho = th.rho(p_rgh.data, T.data) if rho0g is None else rho0g
    for _ in range(2):
        rho = torch.clamp(th.rho(p_abs(p_sh, rho), T.data),
                          min=cfg.rho_min)
    p_full = p_abs(p_sh, rho)
    rho0 = state.get("rho0", rho)
    U0 = state.get("U0", U.data)
    T0 = state.get("T0", T.data)
    p0 = state.get("p0", p_full)
    K0 = 0.5 * torch.sum(U0 * U0, dim=1)

    # the shifted working copy of p_rgh: the state carries the raw p_rgh,
    # the solve runs on p_rgh - p_op
    p_w = dataclasses.replace(p_rgh, data=p_rgh.data - p_op,
                              bcs=pf.shift_value_bcs(p_rgh.bcs, -p_op))

    for outer in range(n_outer):
        final_outer = outer == n_outer - 1
        relax_now = cfg.steady or not final_outer

        psi = th.psi(T.data)
        mu = (th.mu_T(T.data) if th.sutherland_As > 0 else
              torch.full((mesh.n_cells,), th.mu, dtype=mesh.v.dtype,
                         device=mesh.device))
        if cfg.turb is None:
            mut = mesh.v.new_zeros((mesh.n_cells,))
        elif comp_turb:
            mut = cfg.turb.mut_of(new_turb)
        else:
            mut = rho * cfg.turb.nut(mesh, new_turb)
        mu_eff = mu + mut
        rho_b = surface.owner_to_b(mesh, rho)
        rho_slot = slot_mod.interpolate(mesh, rho, bv=rho_b)
        sng_rho = _sn_grad_slot(mesh, rho, rho_b)

        # -- momentum ----------------------------------------------------------
        w_slot = (None if cfg.div_scheme == "linear" else
                  schemes_mod.weights_slot(mesh, phi_slot, cfg.div_scheme,
                                           U))
        mu_slot = slot_mod.interpolate(mesh, mu_eff,
                                       bv=surface.owner_to_b(mesh, mu_eff))
        conv_u = fvm.div(mesh, phi, U, phi_slot=phi_slot,
                         slot_weights=w_slot, phi_dims=_MASS_FLUX)
        UEqn = (conv_u if cfg.steady
                else _rho_ddt(mesh, U, rho, rho0, U0, rdt) + conv_u)
        UEqn = UEqn - fvm.laplacian(
            mesh, slot_mod.to_flat(mesh, mu_slot), U,
            corrected=cfg.corrected, gamma_dims=_DYN_VISC,
            limit=cfg.corr_limit, gamma_slot=mu_slot)
        if relax_now and cfg.alpha_u < 1.0:
            UEqn = UEqn.relax(mesh, cfg.alpha_u, U.data)
        # reconstruct((-ghf*snGrad(rho) - snGrad(p_rgh))*magSf)
        sng_p = _sn_grad_slot(mesh, p_w.data, p_w.boundary_values(mesh))
        src_face = slot_mod.SlotFace(
            (-ghf.sv * sng_rho.sv - sng_p.sv) * mesh.st_magsf,
            (-ghf.fb * sng_rho.fb - sng_p.fb) * mesh.fb_magsf
            if mesh.fb_cells.shape[0] else sng_p.fb,
            (-ghf.bv * sng_rho.bv - sng_p.bv)
            * mesh.mag_sf[nif:] * mesh.face_active[nif:],
        )
        buoy = fvc.reconstruct(mesh, slot_mod.to_flat(mesh, src_face))
        Umat = UEqn.add_source(buoy, mesh)
        Udata, uperf = linear.solve(mesh, Umat, U.data, u_ctrl)
        U = U.with_data(Udata)
        if outer == 0:
            diag["Ux"] = uperf

        # -- energy (the T form; see rhopimple.py) -----------------------------
        K = 0.5 * torch.sum(U.data * U.data, dim=1)
        alpha_lam = mu / th.Pr
        alphat = (cfg.turb.alphat_of(mesh, new_turb) if comp_turb
                  else mut / cfg.prt)
        alpha_eff = alpha_lam + alphat
        a_slot = slot_mod.interpolate(mesh, alpha_eff,
                                      bv=surface.owner_to_b(mesh, alpha_eff))
        we_slot = (None if cfg.div_scheme_e == "linear" else
                   schemes_mod.weights_slot(mesh, phi_slot,
                                            cfg.div_scheme_e, T))
        conv_t = fvm.div(mesh, phi, T, phi_slot=phi_slot,
                         slot_weights=we_slot, phi_dims=_MASS_FLUX)
        TEqn = (conv_t if cfg.steady
                else _rho_ddt(mesh, T, rho, rho0, T0, rdt) + conv_t)
        TEqn = TEqn - fvm.laplacian(
            mesh, slot_mod.to_flat(mesh, a_slot), T,
            corrected=cfg.corrected, gamma_dims=_DYN_VISC,
            limit=cfg.corr_limit, gamma_slot=a_slot)
        dKdt = (torch.zeros_like(K) if cfg.steady
                else (rho * K - rho0 * K0) * rdt)
        Kb = surface.owner_to_b(mesh, K)
        K_slot = slot_mod.interpolate(mesh, K, bv=Kb)
        div_phiK = slot_mod.surface_sum(
            mesh, slot_mod.SlotFace(phi_slot.sv * K_slot.sv,
                                    phi_slot.fb * K_slot.fb,
                                    phi_slot.bv * Kb)) / mesh.v
        dpdt = torch.zeros_like(K) if cfg.steady else (p_full - p0) * rdt
        TEqn = TEqn.add_source((dpdt - dKdt - div_phiK) / th.Cp, mesh)
        if cfg.radiation is not None and "G" in state:
            # incident radiation at the current T, its source Sh/Cp into
            # the rho-weighted T rows
            from ..models import radiation as rad_mod

            Gf, gperf = rad_mod.solve_G(mesh, state["G"], T.data,
                                        cfg.radiation, T_bcs=T.bcs)
            state = dict(state)
            state["G"] = Gf
            diag["G"] = gperf
            TEqn = TEqn.add_source(
                rad_mod.Sh(mesh, Gf, T.data, cfg.radiation) / th.Cp, mesh)
        if relax_now and cfg.alpha_e < 1.0:
            TEqn = TEqn.relax(mesh, cfg.alpha_e, T.data)
        Tdata, tperf = linear.solve(mesh, TEqn, T.data, e_ctrl)
        T = T.with_data(torch.clamp(Tdata, min=1.0))
        T = T.correct_boundary_conditions(mesh)
        diag["T"] = tperf
        psi = th.psi(T.data)
        rho = torch.clamp(th.rho(p_abs(p_w.data, rho), T.data),
                          min=cfg.rho_min)
        rho_b = surface.owner_to_b(mesh, rho)
        rho_slot = slot_mod.interpolate(mesh, rho, bv=rho_b)
        sng_rho = _sn_grad_slot(mesh, rho, rho_b)

        # -- pressure (p_rgh) --------------------------------------------------
        rA = 1.0 / UEqn.A(mesh)
        rhorA = rho * rA
        rra_slot = slot_mod.interpolate(mesh, rhorA,
                                        bv=surface.owner_to_b(mesh, rhorA))
        rra_flat = slot_mod.to_flat(mesh, rra_slot)
        pEqn0 = fvm.laplacian(
            mesh, rra_flat, p_w, corrected=cfg.corrected,
            gamma_dims=dimTime, limit=cfg.corr_limit,
            defer_correction=True, gamma_slot=rra_slot)
        ctl_final0 = cfg.p_controls_final or p_ctrl
        p_ctrl_p, ctl_final_p = linear.prepare_controls(
            mesh, pEqn0, p_ctrl, ctl_final0)
        # the linearisation point: rho was evaluated at this p' (the
        # explicit ddt(rho) refers to it, not to the corrector's iterate)
        p_lin = p_w.data

        for corr in range(n_corr):
            HbyA = rA[:, None] * UEqn.H(mesh, U.data)
            hba = slot_mod.flux_of(mesh, HbyA)  # volumetric
            # phig = -rhorAUf * ghf * snGrad(rho) * magSf
            phig = slot_mod.SlotFace(
                -rra_slot.sv * ghf.sv * sng_rho.sv * mesh.st_magsf,
                (-rra_slot.fb * ghf.fb * sng_rho.fb * mesh.fb_magsf
                 if mesh.fb_cells.shape[0] else sng_rho.fb),
                -rra_slot.bv * ghf.bv * sng_rho.bv
                * mesh.mag_sf[nif:] * mesh.face_active[nif:],
            )
            phiHbyA_b = rho_b * boundary_flux(mesh, U) + phig.bv
            if closed and cfg.steady:
                phiHbyA_b = adjust_phi(mesh, phiHbyA_b, U)
            phiHbyA = slot_mod.SlotFace(
                rho_slot.sv * hba.sv + phig.sv,
                rho_slot.fb * hba.fb + phig.fb, phiHbyA_b)
            p_before = p_w.data

            for nonorth in range(cfg.n_non_orth + 1):
                corr_face = None
                if use_corr:
                    corr_face, corr_cell = slot_mod.laplacian_correction(
                        mesh, rra_slot, p_w.data,
                        p_w.boundary_values(mesh), limit=cfg.corr_limit)
                else:
                    corr_cell = 0.0
                # transient: V/dt [(rho* - rho0) + psi (p_rgh' - p_rgh*')]
                # + div(phiHbyA) - L p_rgh' = 0, arranged for the
                # negative-definite assembled laplacian (see rhopimple.py)
                ddt_diag = (torch.zeros_like(psi) if cfg.steady
                            else mesh.v * psi * rdt)
                ddt_rho_expl = (0.0 if cfg.steady
                                else mesh.v * rdt * (rho - rho0
                                                     - psi * p_lin))
                src = (pEqn0.source - corr_cell
                       + slot_mod.surface_sum(mesh, phiHbyA)
                       + ddt_rho_expl)
                pEqn = pEqn0.replace_fields(
                    diag=pEqn0.diag - ddt_diag, source=src)
                fin = (final_outer and corr == n_corr - 1
                       and nonorth == cfg.n_non_orth)
                ctl = ctl_final_p if fin else p_ctrl_p
                closed_eff = closed and cfg.steady
                pEqn2, ctl = linear.prep_pressure(
                    pEqn, closed_eff, ctl, cfg.p_ref_cell, 0.0)
                pdata, pperf = linear.solve(mesh, pEqn2, p_w.data, ctl)
                p_w = p_w.with_data(torch.clamp(pdata, min=cfg.p_min - p_op))
                if outer == 0 and corr == 0 and nonorth == 0:
                    diag["p_initial"] = pperf.initial_residual
                    diag["p_iters"] = pperf.n_iterations
                diag["p_final"] = pperf.final_residual
                if nonorth == cfg.n_non_orth:
                    F = slot_mod.laplacian_flux(
                        mesh, rra_slot, p_w.data, corrected=use_corr,
                        corr=corr_face)
                    p_bcl = surface.owner_to_b(mesh, p_w.data)
                    F_b = pEqn0.ic * p_bcl - pEqn0.bc
                    phi_slot = slot_mod.SlotFace(
                        phiHbyA.sv - F.sv, phiHbyA.fb - F.fb,
                        phiHbyA_b - F_b)
                    # U += rA reconstruct((phig - F)/rhorAUf)
                    du_face = slot_mod.SlotFace(
                        (phig.sv - F.sv)
                        / torch.clamp(rra_slot.sv, min=1e-30),
                        (phig.fb - F.fb)
                        / torch.clamp(rra_slot.fb, min=1e-30)
                        if mesh.fb_cells.shape[0] else phig.fb,
                        (phig.bv - F_b)
                        / torch.clamp(rra_slot.bv, min=1e-30),
                    )
                    dU = fvc.reconstruct(
                        mesh, slot_mod.to_flat(mesh, du_face))
                    U = U.with_data(HbyA + rA[:, None] * dU)

            if relax_now and cfg.alpha_p < 1.0:
                p_w = p_w.with_data(p_before
                                    + cfg.alpha_p * (p_w.data - p_before))
            U = U.correct_boundary_conditions(mesh)
        phi = slot_mod.to_flat(mesh, phi_slot)
        rho = torch.clamp(th.rho(p_abs(p_w.data, rho), T.data),
                          min=cfg.rho_min)
        p_full = p_abs(p_w.data, rho)

        # -- turbulence ---------------------------------------------------------
        if cfg.turb is not None and final_outer:
            if comp_turb:
                new_turb, tdiag = cfg.turb.correct_rho(
                    mesh, new_turb, U, phi, rho, dt, rho0=rho0,
                    steady=cfg.steady, relax=cfg.turb_relax,
                    controls=cfg.turb_controls, phi_slot=phi_slot)
            else:
                rho_f_sv = torch.clamp(rho_slot.sv, min=cfg.rho_min)
                phiv_slot = slot_mod.SlotFace(
                    phi_slot.sv / rho_f_sv,
                    phi_slot.fb / torch.clamp(rho_slot.fb, min=cfg.rho_min)
                    if mesh.fb_cells.shape[0] else phi_slot.fb,
                    phi_slot.bv / torch.clamp(
                        surface.owner_to_b(mesh, rho), min=cfg.rho_min))
                phiv = slot_mod.to_flat(mesh, phiv_slot)
                new_turb, tdiag = cfg.turb.correct(
                    mesh, new_turb, U, phiv, dt, steady=cfg.steady,
                    relax=cfg.turb_relax, controls=cfg.turb_controls,
                    phi_slot=phiv_slot)
            diag.update({f"turb_{k}": v for k, v in tdiag.items()})

    # diagnostics
    div_phi = slot_mod.surface_sum(mesh, phi_slot)
    cont = ((torch.zeros_like(rho) if cfg.steady
             else (rho - rho0) * rdt) + div_phi / mesh.v)
    vsum = torch.sum(mesh.v)
    diag["continuity"] = torch.sum(torch.abs(cont) * mesh.v) / vsum
    diag["continuity_global"] = torch.sum(cont * mesh.v) / vsum
    sum_phi = slot_mod.weighted_cell_sum(mesh, phi_slot, absolute=True)
    diag["courant_max"] = 0.5 * torch.max(sum_phi / (rho * mesh.v)) * dt
    diag["T_range"] = (torch.min(T.data), torch.max(T.data))

    p_rgh_out = p_rgh.with_data(p_w.data + p_op)
    new_state = dict(state)
    new_state.update(U=U, p_rgh=p_rgh_out, T=T, phi=phi,
                     phi_slot=(phi_slot.sv, phi_slot.fb))
    if not cfg.steady:
        new_state.update(U0=U.data, T0=T.data, p0=p_full,
                         p_rgh0=p_rgh_out.data, rho0=rho)
    if new_turb is not None:
        new_state["turb"] = new_turb
    return new_state, diag


def initial_state(mesh, U: VolField, p_rgh: VolField, T: VolField,
                  thermo, g=(0.0, -9.81, 0.0),
                  turb_state: Optional[Dict] = None,
                  steady: bool = False) -> Dict:
    """The first state: rho from p = p_rgh + rho gh by two fixed-point
    passes, the mass flux, and for a transient run the old-time fields."""
    gh = _gh(mesh, g)
    rho = thermo.rho(p_rgh.data, T.data)
    for _ in range(2):
        rho = thermo.rho(p_rgh.data + rho * gh, T.data)
    rho_b = surface.owner_to_b(mesh, rho)
    rho_slot = slot_mod.interpolate(mesh, rho, bv=rho_b)
    uf = slot_mod.flux_of(mesh, U.data, bv=boundary_flux(mesh, U))
    phi_sl = slot_mod.SlotFace(rho_slot.sv * uf.sv, rho_slot.fb * uf.fb,
                               rho_b * uf.bv)
    phi = slot_mod.to_flat(mesh, phi_sl)
    st = {"U": U, "p_rgh": p_rgh, "T": T, "phi": phi,
          "phi_slot": (phi_sl.sv, phi_sl.fb)}
    if not steady:
        st.update(U0=U.data, T0=T.data, p0=p_rgh.data + rho * gh,
                  p_rgh0=p_rgh.data, rho0=rho)
    if turb_state is not None:
        st["turb"] = turb_state
    return st


def make_step(mesh, cfg: BuoyantRhoConfig):
    """(state, dt) -> (state, diag) for one iteration or time step."""
    def step(state, dt):
        return buoyantrho_step(mesh, state, dt, cfg)

    return step
