"""rhoPimpleFoam / rhoSimpleFoam / sonicFoam: the pressure-based
compressible solvers (port of openfoam-2.2.x_tpu/solvers/rhopimple.py:
`RhoPimpleConfig`, `_rho_ddt`, `rhopimple_step`, `initial_state`,
`make_step`; applications/solvers/compressible/{rhoPimpleFoam,
rhoSimpleFoam,sonicFoam}/{U,E,p}Eqn.H):

    rho  = thermo.rho(p,T) = psi*p,  psi = 1/(R T)
    UEqn : ddt(rho,U) + div(phi,U) - laplacian(muEff,U) == -grad(p)
    EEqn : ddt(rho,he) + div(phi,he) - laplacian(alphaEff,he)
           == dp/dt - (ddt(rho,K) + div(phi,K)),  he = Cp*T, solved as T
    pEqn : fvm.ddt(psi,p) + div(phiHbyA) - fvm.laplacian(rho*rAU, p) = 0
           (subsonic); the transonic form (sonicFoam) carries the mass
           flux implicitly as div(phid, p), a non-symmetric matrix.
           phi = phiHbyA - pEqn.flux().

phi is the MASS flux rho_f (U_f . Sf). The SIMPLEC form (`consistent`,
rhoSimplecFoam / rhoPimplecFoam) takes rAtU = 1/(A - H1) in the pressure
equation. MRF zones and fvOptions enter with rho. With an incompressible
turbulence model (a case without 0/mut) muEff = rho*(nu + nut) on the
volumetric flux phi/rho_f, the Favre correction neglected as in the
reference; the models of compressible.py take the mass flux and rho.

The pressure is solved shifted by pRefValue: absolute p ~ 1e5 Pa has a
float32 quantum of ~0.01 Pa, the size of the per-face differences at low
Mach. The state hooks `lts_rdt` (a per-cell 1/dt, local time stepping)
and `R_mix` / `cp_mix` (per-cell gas constant and heat capacity of a
reacting mixture) override the global step and the thermo where the state
carries them. Every solve goes through linear.solve, so the SpMV kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..bc import patchfields as pf
from ..core.dimensions import DimensionSet, dimTime
from ..core.fields import VolField
from ..ops import fvc, fvm, schemes as schemes_mod, slot as slot_mod, surface
from ..ops.matrix import FvMatrix, zero_matrix
from . import linear
from .piso import boundary_flux, needs_reference

_MASS_FLUX = DimensionSet.of(1, 0, -1)
_DYN_VISC = DimensionSet.of(1, -1, -1)


class RhoPimpleConfig(NamedTuple):
    thermo: Any               # models/thermo.PerfectGas (or a twin)
    steady: bool = False      # rhoSimpleFoam mode
    transonic: bool = False   # sonicFoam pressure equation
    # SIMPLEC consistency (rhoSimplecFoam / rhoPimplecFoam pEqn.H): the
    # pressure equation takes rAtU = 1/(A - H1) and HbyA is corrected by
    # (rAU - rAtU) grad(p)
    consistent: bool = False
    n_outer: int = 1
    n_correctors: int = 2
    n_non_orth: int = 0
    corrected: bool = False
    corr_limit: float = 1.0
    div_scheme: str = "upwind"
    div_scheme_e: str = "upwind"
    ddt_scheme: str = "Euler"
    grad_scheme: str = "Gauss linear"
    alpha_u: float = 1.0
    alpha_p: float = 1.0
    alpha_e: float = 1.0
    p_ref_cell: int = 0
    p_ref_value: float = 1e5
    p_min: float = 100.0
    rho_min: float = 0.01
    solve_energy: bool = True   # False: isothermal
    p_controls: Dict = None
    p_controls_final: Dict = None
    u_controls: Dict = None
    e_controls: Dict = None
    turb: Any = None
    turb_controls: Dict = None
    turb_relax: float = 0.7
    fv_options: Any = None    # models/fvoptions.OptionList (porous etc.)
    mrf: Any = None           # models/mrf.MRFZones


def _rho_ddt(mesh, field: VolField, rho, rho0, old, rdt) -> FvMatrix:
    """fvm::ddt(rho, psi), Euler: diag = V rho/dt, src = V rho0 old/dt."""
    n = 1 if field.data.ndim == 1 else field.data.shape[1]
    m = zero_matrix(mesh, n, dims=field.dims * _MASS_FLUX)
    vr = mesh.v * rho * rdt
    vr0 = mesh.v * rho0 * rdt
    src = (vr0[:, None] if field.data.ndim == 2 else vr0) * old
    return m.replace_fields(diag=vr, source=src)


def _b_only(phi, bvals):
    """A face field [nF] that is zero on internal faces and `bvals` on
    the boundary faces."""
    nif = phi.shape[0] - bvals.shape[0]
    return torch.cat([phi.new_zeros(nif), bvals])


def rhopimple_step(mesh, state: Dict, dt: Any, cfg: RhoPimpleConfig
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
    p: VolField = state["p"]
    T: VolField = state["T"]
    phi = state["phi"]            # MASS flux

    # localEuler pseudo-time: a per-cell 1/dt in the state overrides the
    # global step (fv::localEulerDdtScheme); every use of rdt below
    # broadcasts over cells
    lts_rdt = state.get("lts_rdt")
    # composition-dependent gas (hePsiThermo<reactingMixture>): the
    # mixture gas constant and heat capacity per cell, when the state
    # carries them; else the single-mixture thermo
    R_mix = state.get("R_mix")
    cp_mix = state.get("cp_mix")

    def _rho_of(pd, Td):
        return (pd / (R_mix * Td)) if R_mix is not None else th.rho(pd, Td)

    def _psi_of(Td):
        return (1.0 / (R_mix * Td)) if R_mix is not None else th.psi(Td)

    def _cp_of(Td):
        return cp_mix if cp_mix is not None else th.Cp_of(Td)

    nif = mesh.n_internal_faces
    rdt = lts_rdt if lts_rdt is not None else 1.0 / dt
    diag: Dict[str, Any] = {}
    new_turb = state.get("turb")
    fvopt_state = state.get("fvopt")

    if "phi_slot" in state:
        phi_slot = slot_mod.SlotFace(*state["phi_slot"], bv=phi[nif:])
    else:
        phi_slot = slot_mod.from_flat(mesh, phi)
    closed = needs_reference(p, mesh)
    n_outer = 1 if cfg.steady else cfg.n_outer
    n_corr = 1 if cfg.steady else cfg.n_correctors
    rho0 = state["rho0"] if "rho0" in state else _rho_of(p.data, T.data)
    U0 = state.get("U0", U.data)
    T0 = state.get("T0", T.data)
    p0 = state.get("p0", p.data)
    K0 = 0.5 * torch.sum(U0 * U0, dim=1)
    comp_turb = getattr(cfg.turb, "compressible_form", False)

    for outer in range(n_outer):
        final_outer = outer == n_outer - 1
        relax_now = cfg.steady or not final_outer

        rho = torch.clamp(_rho_of(p.data, T.data), min=cfg.rho_min)
        psi = _psi_of(T.data)
        mu = (th.mu_T(T.data) if th.sutherland_As > 0 else
              torch.full((mesh.n_cells,), th.mu, dtype=mesh.v.dtype,
                         device=mesh.device))
        if cfg.turb is None:
            mut = mesh.v.new_zeros((mesh.n_cells,))
        elif comp_turb:
            # the compressible model's own mut field
            mut = cfg.turb.mut_of(new_turb)
        else:
            mut = rho * cfg.turb.nut(mesh, new_turb)
        mu_eff = mu + mut
        rho_b = surface.owner_to_b(mesh, rho)
        rho_slot = slot_mod.interpolate(mesh, rho, bv=rho_b)

        # -- momentum ----------------------------------------------------------
        w_slot = (None if cfg.div_scheme == "linear" else
                  schemes_mod.weights_slot(mesh, phi_slot, cfg.div_scheme, U))
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
        if cfg.mrf:
            # mrfZones.addCoriolis(rho, UEqn()) before the relaxation
            UEqn = cfg.mrf.add_coriolis(mesh, UEqn, U, rho=rho)
        if cfg.fv_options:
            # rhoPorousSimpleFoam UEqn.H: the porous and explicit sources
            # enter the momentum equation before the relaxation
            UEqn = cfg.fv_options.add_to(mesh, UEqn, "U", U, U=U,
                                         fvopt_state=state.get("fvopt"),
                                         rho=rho, mu=mu)
        if relax_now and cfg.alpha_u < 1.0:
            UEqn = UEqn.relax(mesh, cfg.alpha_u, U.data)
        grad_p = fvc.grad_of(mesh, p, cfg.grad_scheme)
        Umat = UEqn.add_source(-grad_p, mesh)
        Udata, uperf = linear.solve(mesh, Umat, U.data, u_ctrl)
        U = U.with_data(Udata)
        if outer == 0:
            diag["Ux"] = uperf

        # -- energy (he = Cp T, solved as T with alphaEff carrying Cp) --------
        K = 0.5 * torch.sum(U.data * U.data, dim=1)
        alpha_lam = mu / th.Pr                     # kappa/Cp
        alphat = (cfg.turb.alphat_of(mesh, new_turb) if comp_turb
                  else mut / 0.85)                 # Prt = 0.85
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
            mesh, slot_mod.to_flat(mesh, a_slot), T, corrected=cfg.corrected,
            gamma_dims=_DYN_VISC, limit=cfg.corr_limit, gamma_slot=a_slot)
        # the right side over Cp: dp/dt and the kinetic-energy transport
        dKdt = (torch.zeros_like(K) if cfg.steady
                else (rho * K - rho0 * K0) * rdt)
        Kb = surface.owner_to_b(mesh, K)
        K_slot = slot_mod.interpolate(mesh, K, bv=Kb)
        div_phiK = slot_mod.surface_sum(
            mesh, slot_mod.SlotFace(phi_slot.sv * K_slot.sv,
                                    phi_slot.fb * K_slot.fb,
                                    phi_slot.bv * Kb)) / mesh.v
        dpdt = torch.zeros_like(K) if cfg.steady else (p.data - p0) * rdt
        cp_c = _cp_of(T.data)   # janaf: a Cp(T) field; hConst: a constant
        TEqn = TEqn.add_source((dpdt - dKdt - div_phiK) / cp_c, mesh)
        if cfg.fv_options:
            # the energy constraints and T-targeted sources
            TEqn = cfg.fv_options.add_to(mesh, TEqn, "T", T, U=U, rho=rho)
        if relax_now and cfg.alpha_e < 1.0:
            TEqn = TEqn.relax(mesh, cfg.alpha_e, T.data)
        if cfg.solve_energy:
            Tdata, tperf = linear.solve(mesh, TEqn, T.data, e_ctrl)
            T = T.with_data(torch.clamp(Tdata, min=1.0))
            T = T.correct_boundary_conditions(mesh)
        else:
            zero = mesh.v.new_zeros(())
            tperf = linear.SolverPerf(zero, zero, torch.zeros(
                (), dtype=torch.int32, device=mesh.device))
        diag["T"] = tperf
        psi = _psi_of(T.data)
        rho = torch.clamp(_rho_of(p.data, T.data), min=cfg.rho_min)
        rho_slot = slot_mod.interpolate(mesh, rho,
                                        bv=surface.owner_to_b(mesh, rho))

        # -- pressure ----------------------------------------------------------
        # solve for the shifted p' = p - pRef (float32: see the module
        # docstring); the shift drops out of the Laplacian exactly and the
        # value-fixing p BCs move with it
        p_op = cfg.p_ref_value
        p_w = dataclasses.replace(p, data=p.data - p_op,
                                  bcs=pf.shift_value_bcs(p.bcs, -p_op))
        rA = 1.0 / UEqn.A(mesh)
        if cfg.consistent:
            denom = UEqn.A(mesh) - UEqn.H1(mesh)
            rAtU = torch.where(denom > 1e-30,
                               1.0 / torch.clamp(denom, min=1e-30), rA)
        else:
            rAtU = rA
        rhorA = rho * rAtU
        rra_b = surface.owner_to_b(mesh, rhorA)
        rra_slot = slot_mod.interpolate(mesh, rhorA, bv=rra_b)
        rra_flat = slot_mod.to_flat(mesh, rra_slot)
        pEqn0 = fvm.laplacian(
            mesh, rra_flat, p_w, corrected=cfg.corrected,
            gamma_dims=dimTime,   # rho*rAU carries s: the rows are kg/s
            limit=cfg.corr_limit, defer_correction=True,
            gamma_slot=rra_slot)
        ctl_final0 = cfg.p_controls_final or p_ctrl
        p_ctrl_p, ctl_final_p = linear.prepare_controls(
            mesh, pEqn0, p_ctrl, ctl_final0)
        # the linearisation point: rho above was evaluated at this p', so
        # the explicit ddt(rho) part refers to the same state
        p_lin = p_w.data

        use_corr = cfg.corrected and not getattr(mesh, "orthogonal", False)
        for corr in range(n_corr):
            HbyA = rA[:, None] * UEqn.H(mesh, U.data)
            if cfg.consistent:
                # HbyA -= (rAU - rAtU) grad(p) (rhoSimplecFoam pEqn.H)
                HbyA = HbyA - ((rA - rAtU)[:, None]
                               * fvc.grad_of(mesh, p_w, cfg.grad_scheme))
            hba = slot_mod.flux_of(mesh, HbyA)  # volumetric
            rho_bv = surface.owner_to_b(mesh, rho)
            phiHbyA_b = rho_bv * boundary_flux(mesh, U)
            phiHbyA = slot_mod.SlotFace(rho_slot.sv * hba.sv,
                                        rho_slot.fb * hba.fb, phiHbyA_b)
            if cfg.mrf:
                # mrfZones.relativeFlux(fvc::interpolate(rho), phiHbyA)
                phiHbyA = cfg.mrf.make_relative(mesh, phiHbyA,
                                                rho_slot=rho_slot)
            p_before = p_w.data

            for nonorth in range(cfg.n_non_orth + 1):
                # the deferred non-orthogonal correction of
                # laplacian(rho rAU, p)
                corr_face = None
                corr_cell = 0.0
                if use_corr:
                    corr_face, corr_cell = slot_mod.laplacian_correction(
                        mesh, rra_slot, p_w.data,
                        p_w.boundary_values(mesh), limit=cfg.corr_limit)
                # continuity: V psi/dt (p'-p0') + div(phiHbyA) - (L p')
                # = 0 with L the assembled (negative-definite) laplacian,
                # rearranged to (L - D_ddt) p' = div(phiHbyA) - ...
                ddt_diag = (torch.zeros_like(psi) if cfg.steady
                            else mesh.v * psi * rdt)
                # the full ddt(rho): the explicit (rho* - rho0) and the
                # implicit psi correction (rhoPimpleFoam pEqn.H
                # `fvc::ddt(rho) + psi*correction(fvm::ddt(p))`)
                src = (pEqn0.source - corr_cell
                       + slot_mod.surface_sum(mesh, phiHbyA)
                       + (0.0 if cfg.steady
                          else mesh.v * rdt * (rho - rho0
                                               - psi * p_lin)))
                pEqn = pEqn0.replace_fields(
                    diag=pEqn0.diag - ddt_diag, source=src,
                    symmetric=not cfg.transonic)
                if cfg.transonic:
                    # sonicFoam pEqn.H: the convective mass flux implicit
                    # as div(phid, p), phid = psi_f (HbyA . Sf); phiHbyA
                    # leaves the source. Shifted: div(phid (p'+p_op)) is
                    # the implicit div(phid, p') plus p_op div(phid) on
                    # the right side.
                    psi_b = surface.owner_to_b(mesh, psi)
                    psi_slot = slot_mod.interpolate(mesh, psi, bv=psi_b)
                    phid = slot_mod.SlotFace(
                        psi_slot.sv * hba.sv, psi_slot.fb * hba.fb,
                        psi_b * boundary_flux(mesh, U))
                    wp = schemes_mod.weights_slot(mesh, phid, "upwind", p_w)
                    conv = fvm.div(mesh, slot_mod.to_flat(mesh, phid), p_w,
                                   phi_slot=phid, slot_weights=wp,
                                   phi_dims=pEqn0.dims / p.dims)
                    div_phid = slot_mod.surface_sum(mesh, phid)
                    pEqn = (pEqn - conv).replace_fields(
                        source=pEqn.source - conv.source
                        + p_op * div_phid
                        - slot_mod.surface_sum(mesh, phiHbyA))
                fin = (final_outer and corr == n_corr - 1
                       and nonorth == cfg.n_non_orth)
                ctl = ctl_final_p if fin else p_ctrl_p
                if cfg.transonic:
                    ctl = dict(ctl)
                    ctl.pop("_prep", None)  # the coefficients changed
                # the psi V/dt term regularises the transient matrix; only
                # the steady all-Neumann case needs a reference
                # (rhoSimpleFoam pEqn.H setReference)
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
                        mesh, rra_slot, p_w.data,
                        corrected=cfg.corrected and not mesh.orthogonal,
                        corr=corr_face)
                    p_bcl = surface.owner_to_b(mesh, p_w.data)
                    F_b = pEqn0.ic * p_bcl - pEqn0.bc
                    if cfg.transonic:
                        # the mass flux the implicit convection carries:
                        # phi = phid * p_up(absolute) - F
                        nb = slot_mod.nbr_values(mesh, p_w.data)
                        p_up = (wp[0] * p_w.data[:, None]
                                + (1.0 - wp[0]) * nb + p_op)
                        conv_sv = phid.sv * p_up
                        if mesh.fb_cells.shape[0]:
                            pfb = (wp[1] * p_w.data[mesh.fb_cells]
                                   + (1.0 - wp[1])
                                   * p_w.data[mesh.fb_nbrs] + p_op)
                            conv_fb = phid.fb * pfb
                        else:
                            conv_fb = phid.fb
                        conv_bv = phid.bv * (p_w.boundary_values(mesh)
                                             + p_op)
                        phi_slot = slot_mod.SlotFace(
                            conv_sv - F.sv, conv_fb - F.fb,
                            conv_bv - F_b)
                    else:
                        phi_slot = slot_mod.SlotFace(
                            phiHbyA.sv - F.sv, phiHbyA.fb - F.fb,
                            phiHbyA_b - F_b)

            # the explicit p relaxation after the conservative flux update
            # (rhoSimpleFoam pEqn.H p.relax())
            if relax_now and cfg.alpha_p < 1.0:
                p_w = p_w.with_data(p_before
                                    + cfg.alpha_p * (p_w.data - p_before))
            grad_p = fvc.grad_of(mesh, p_w, cfg.grad_scheme)
            U = U.with_data(HbyA - rAtU[:, None] * grad_p)
            if cfg.fv_options:
                U, fvopt_state = cfg.fv_options.correct_U(
                    mesh, U, rA, state.get("fvopt"))
            U = U.correct_boundary_conditions(mesh)
        p = p.with_data(p_w.data + p_op)
        phi = slot_mod.to_flat(mesh, phi_slot)
        rho = torch.clamp(_rho_of(p.data, T.data), min=cfg.rho_min)
        # the characteristic outlets (waveTransmissive/advective) update
        # from the VOLUMETRIC boundary flux, the sound speed and dt; the
        # other kinds take no notice
        rho_bf = torch.clamp(surface.owner_to_b(mesh, rho), min=cfg.rho_min)
        phiv_b = _b_only(phi, phi[nif:] / rho_bf)
        c_face = _b_only(phi, surface.owner_to_b(mesh, th.c(T.data)))
        p = p.correct_boundary_conditions(mesh, phi=phiv_b, dt=dt,
                                          c_sound=c_face)
        T = T.correct_boundary_conditions(mesh, phi=phiv_b, dt=dt,
                                          c_sound=c_face)

        # -- turbulence ---------------------------------------------------------
        if cfg.turb is not None and final_outer:
            if comp_turb:
                # the rho-weighted models: the mass flux and rho
                new_turb, tdiag = cfg.turb.correct_rho(
                    mesh, new_turb, U, phi, rho, dt, rho0=rho0,
                    steady=cfg.steady, relax=cfg.turb_relax,
                    controls=cfg.turb_controls, phi_slot=phi_slot)
            else:
                # an incompressible model on the volumetric flux
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
    rho_new = torch.clamp(_rho_of(p.data, T.data), min=cfg.rho_min)
    cont = ((torch.zeros_like(rho_new) if cfg.steady
             else (rho_new - rho0) * rdt) + div_phi / mesh.v)
    vsum = torch.sum(mesh.v)
    diag["continuity"] = torch.sum(torch.abs(cont) * mesh.v) / vsum
    diag["continuity_global"] = torch.sum(cont * mesh.v) / vsum
    sum_phi = slot_mod.weighted_cell_sum(mesh, phi_slot, absolute=True)
    diag["courant_max"] = 0.5 * torch.max(sum_phi / (rho_new * mesh.v)) * dt
    diag["mach_max"] = torch.max(
        torch.linalg.norm(U.data, dim=1) / th.c(T.data))
    diag["T_range"] = (torch.min(T.data), torch.max(T.data))

    new_state = dict(state)
    new_state.update(U=U, p=p, T=T, phi=phi,
                     phi_slot=(phi_slot.sv, phi_slot.fb))
    if cfg.fv_options and "fvopt" in state:
        new_state["fvopt"] = fvopt_state
    if not cfg.steady:
        new_state.update(U0=U.data, T0=T.data, p0=p.data, rho0=rho_new)
    if new_turb is not None:
        new_state["turb"] = new_turb
    return new_state, diag


def initial_state(mesh, U: VolField, p: VolField, T: VolField, thermo,
                  turb_state: Optional[Dict] = None,
                  steady: bool = False) -> Dict:
    """The first state: the mass flux rho_f (U_f . Sf), and for a
    transient run the old-time U, T, p and rho."""
    rho = thermo.rho(p.data, T.data)
    rho_b = surface.owner_to_b(mesh, rho)
    rho_slot = slot_mod.interpolate(mesh, rho, bv=rho_b)
    uf = slot_mod.flux_of(mesh, U.data, bv=boundary_flux(mesh, U))
    phi_sl = slot_mod.SlotFace(rho_slot.sv * uf.sv, rho_slot.fb * uf.fb,
                               rho_b * uf.bv)
    phi = slot_mod.to_flat(mesh, phi_sl)
    st = {"U": U, "p": p, "T": T, "phi": phi,
          "phi_slot": (phi_sl.sv, phi_sl.fb)}
    if not steady:
        st.update(U0=U.data, T0=T.data, p0=p.data, rho0=rho)
    if turb_state is not None:
        st["turb"] = turb_state
    return st


def make_step(mesh, cfg: RhoPimpleConfig):
    """(state, dt) -> (state, diag) for one iteration or time step."""
    def step(state, dt):
        return rhopimple_step(mesh, state, dt, cfg)

    return step
