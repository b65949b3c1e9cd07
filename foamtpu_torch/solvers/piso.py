"""icoFoam / pisoFoam — transient incompressible PISO solvers (port of
openfoam-2.2.x_tpu/solvers/piso.py).

    momentum:  UEqn = ddt(U) + div(phi,U) - laplacian(nu,U)
               (pisoFoam: + turbulence->divDevReff(U))
               solve(UEqn == -grad(p))
    corrector: rAU=1/A(U); HbyA=rAU*H(U); phiHbyA=Sf.interp(HbyA)
               pEqn: laplacian(rAU,p) == div(phiHbyA); solve
               phi = phiHbyA - pEqn.flux(); U = HbyA - rAU*grad(p)
    pisoFoam:  turbulence->correct()

The reference traces one step into one XLA program and scans a chunk of
steps; here a step is eager torch and a chunk is a plain loop. The
slice covers icoFoam, nonNewtonianIcoFoam (PisoConfig.nu_fn) and
pisoFoam (a turbulence model in PisoConfig.turb) with the Euler,
backward, CrankNicolson and steadyState ddt schemes, any ported
div(phi,U) scheme and the pressure laplacian orthogonal, uncorrected or
corrected: on a non-orthogonal mesh with `corrected` each of the
nNonOrthogonalCorrectors + 1 passes moves the explicit correction of
the latest p into the source (limited by corr_limit) and the last pass's
flux carries it. fvOptions enter the momentum equation (corrected after
the correctors), MRF zones the Coriolis source and the relative
phiHbyA.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..bc import patchfields as pf
from ..core.dimensions import dimless, dimTime, dimViscosity
from ..core.fields import VolField
from ..ops import fvc, fvm, schemes, surface
from ..ops import slot as slot_mod
from . import linear


class PisoConfig(NamedTuple):
    nu: float
    n_correctors: int = 2
    n_non_orth: int = 0
    momentum_predictor: bool = True
    corrected: bool = False
    corr_limit: float = 1.0
    div_scheme: str = "linear"
    ddt_scheme: str = "Euler"
    grad_scheme: str = "Gauss linear"
    p_ref_cell: int = 0
    p_ref_value: float = 0.0
    p_controls: Dict = None
    p_controls_final: Dict = None
    u_controls: Dict = None
    turb: Any = None
    turb_controls: Dict = None
    nu_fn: Any = None
    fv_options: Any = None   # models/fvoptions.OptionList
    mrf: Any = None          # models/mrf.MRFZones


def ddt_matrix(mesh, field, state: Dict, rdt, scheme: str,
               key: str = "U") -> Any:
    """fvm ddt dispatch on the fvSchemes keyword (fv::ddtScheme::New).
    State layout per scheme (set up by initial_state): Euler: {key}0;
    backward: {key}0, {key}00, rdt0; CrankNicolson <oc>: {key}0,
    ddt0_{key}, rdt0."""
    toks = scheme.split()
    old = state.get(f"{key}0", field.data)
    if toks[0] == "Euler":
        return fvm.ddt(mesh, field, old, rdt)
    if toks[0] == "backward":
        return fvm.ddt_backward(
            mesh, field, old, state.get(f"{key}00", old),
            rdt, state.get("rdt0", rdt))
    if toks[0] == "CrankNicolson":
        oc = float(toks[1]) if len(toks) > 1 else 1.0
        return fvm.ddt_crank_nicolson(
            mesh, field, old, state[f"ddt0_{key}"], rdt, oc,
            rdt0=state.get("rdt0"))
    if toks[0] == "steadyState":
        return fvm.ddt_steady(mesh, field)
    raise ValueError(f"unknown ddtScheme {scheme!r}")


def advance_time_state(state: Dict, new_state: Dict, U, rdt,
                       scheme: str) -> None:
    """Update the old-time entries in new_state after a completed step."""
    toks = scheme.split()
    new_state["U0"] = U.data
    if toks[0] == "backward":
        new_state["U00"] = state.get("U0", U.data)
        new_state["rdt0"] = rdt
    elif toks[0] == "CrankNicolson":
        oc = float(toks[1]) if len(toks) > 1 else 1.0
        new_state["ddt0_U"] = fvm.ddt_cn_update(
            U.data, state.get("U0", U.data), state["ddt0_U"], rdt, oc,
            rdt0=state.get("rdt0"))
        new_state["rdt0"] = rdt


def _default_controls():
    return (
        {"solver": "PCG", "preconditioner": "diagonal",
         "tolerance": 1e-6, "relTol": 0.0, "maxIter": 1000},
        {"solver": "smoothSolver", "tolerance": 1e-5, "relTol": 0.0,
         "maxIter": 1000, "nSweeps": 2},
    )


def needs_reference(p: VolField, mesh) -> bool:
    """Pressure needs a reference when no boundary fixes its value
    (setRefCell / findRefCell.C)."""
    for patch, bc in zip(mesh.patches, p.bcs):
        if pf.is_value_bc(bc) or bc.kind in ("mixed", "inletOutlet",
                                             "totalPressure"):
            return False
    return True


def boundary_flux(mesh, U: VolField) -> Any:
    """Sf . U_b on boundary faces (masked on empty patches)."""
    ub = U.boundary_values(mesh)
    nif = mesh.n_internal_faces
    return torch.sum(mesh.sf[nif:] * ub, dim=1) * mesh.face_active[nif:]


def face_interp_cell(mesh, data: Any) -> Any:
    """Interpolate per-cell scalar data to ALL faces with zero-gradient
    boundary extrapolation (for rAU etc.)."""
    vi = surface.interpolate_internal(mesh, data)
    vb = surface.owner_to_b(mesh, data)
    return torch.cat([vi, vb], dim=0)


def _as_scalar(mesh, x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=mesh.v.dtype, device=mesh.device)


def add_viscous(mesh, UEqn, U: VolField, turb_state, cfg):
    """UEqn plus the viscous term: the turbulence model's divDevReff, a
    non-Newtonian laplacian(nu(strain rate), U) with nu interpolated to
    the faces in slot form (nonNewtonianIcoFoam), or laplacian(nu, U)."""
    if cfg.turb is not None:
        visc_mat, visc_expl = cfg.turb.div_dev_reff(mesh, turb_state, U)
        return (UEqn + visc_mat).add_source(-visc_expl, mesh)
    if cfg.nu_fn is not None:
        nu_cell = cfg.nu_fn(mesh, U)
        nu_b = surface.owner_to_b(mesh, nu_cell)
        nu_slot = slot_mod.interpolate(mesh, nu_cell, bv=nu_b)
        return UEqn - fvm.laplacian(
            mesh, slot_mod.to_flat(mesh, nu_slot), U,
            corrected=cfg.corrected, gamma_dims=dimViscosity,
            limit=cfg.corr_limit, gamma_slot=nu_slot)
    return UEqn - fvm.laplacian(
        mesh, _as_scalar(mesh, cfg.nu), U, corrected=cfg.corrected,
        gamma_dims=dimViscosity, limit=cfg.corr_limit)


def add_sources(mesh, UEqn, U: VolField, fvopt_state, cfg, mom_src=None):
    """UEqn plus the fvOptions' sources (fvOptions(U)), a Lagrangian
    momentum source (KinematicCloud::SU(U): `mom_src`, [nC, 3] force over
    the carrier's density, m^4/s^2 per cell) and the MRF zones' Coriolis
    term (mrfZones.addCoriolis(UEqn)), in the reference's order."""
    if cfg.fv_options:
        UEqn = cfg.fv_options.add_to(mesh, UEqn, "U", U, U=U,
                                     fvopt_state=fvopt_state)
    if mom_src is not None:
        UEqn = UEqn.add_source(mom_src / mesh.v[:, None], mesh)
    if cfg.mrf:
        UEqn = cfg.mrf.add_coriolis(mesh, UEqn, U)
    return UEqn


def piso_step(mesh, state: Dict, dt: Any, cfg: PisoConfig
              ) -> Tuple[Dict, Dict]:
    """One PISO time step. state: {"U": VolField, "p": VolField,
    "phi": [nF], "U0", "phi_slot"}. Returns (new_state, diagnostics)."""
    p_ctrl = cfg.p_controls or _default_controls()[0]
    u_ctrl = cfg.u_controls or _default_controls()[1]

    U: VolField = state["U"]
    p: VolField = state["p"]
    phi = state["phi"]
    nif = mesh.n_internal_faces
    dt = _as_scalar(mesh, dt)
    rdt = 1.0 / dt
    diag: Dict[str, Any] = {}

    if "phi_slot" in state:
        phi_slot = slot_mod.SlotFace(*state["phi_slot"], bv=phi[nif:])
    else:
        phi_slot = slot_mod.from_flat(mesh, phi)

    # fan jump pairs re-evaluate their curve at the current flow rate
    # (fan updateCoeffs); nothing happens without fan BCs
    if any(bc.kind == "fan" for bc in p.bcs):
        p = p.correct_boundary_conditions(mesh, phi=phi)

    # -- momentum equation (laminar diffusion or turbulence divDevReff) ----
    w_slot = (None if cfg.div_scheme == "linear" else
              schemes.weights_slot(mesh, phi_slot, cfg.div_scheme, U))
    UEqn = (ddt_matrix(mesh, U, state, rdt, cfg.ddt_scheme)
            + fvm.div(mesh, phi, U, phi_slot=phi_slot, slot_weights=w_slot))
    UEqn = add_viscous(mesh, UEqn, U, state.get("turb"), cfg)
    UEqn = add_sources(mesh, UEqn, U, state.get("fvopt"), cfg,
                       mom_src=state.get("mom_src"))
    grad_p = fvc.grad_of(mesh, p, cfg.grad_scheme)
    if cfg.momentum_predictor:
        Umat = UEqn.add_source(-grad_p, mesh)
        Udata, uperf = linear.solve(mesh, Umat, U.data, u_ctrl)
        U = U.with_data(Udata)
        diag["Ux"] = uperf
    else:
        diag["Ux"] = None

    # -- PISO corrector loop ----------------------------------------------------
    rA = 1.0 / UEqn.A(mesh)
    rA_b = surface.owner_to_b(mesh, rA)
    rAf_slot = slot_mod.interpolate(mesh, rA, bv=rA_b)
    rAf = slot_mod.to_flat(mesh, rAf_slot)
    # the pressure-matrix coefficients are the same for every corrector
    # and non-orthogonal pass: assemble once, share one GAMG prep across
    # the solves; only the source and the deferred correction change
    use_corr = cfg.corrected and not getattr(mesh, "orthogonal", False)
    pEqn0 = fvm.laplacian(
        mesh, rAf, p, corrected=cfg.corrected, gamma_dims=dimTime,
        limit=cfg.corr_limit, defer_correction=True, gamma_slot=rAf_slot,
    )
    ctl_final0 = cfg.p_controls_final or p_ctrl
    p_ctrl_p, ctl_final_p = linear.prepare_controls(
        mesh, pEqn0, p_ctrl, ctl_final0)

    for corr in range(cfg.n_correctors):
        HbyA = rA[:, None] * UEqn.H(mesh, U.data)
        phiHbyA = slot_mod.flux_of(mesh, HbyA, bv=boundary_flux(mesh, U))
        if cfg.mrf:
            # mrfZones.relativeFlux(phiHbyA), before adjustPhi
            phiHbyA = cfg.mrf.make_relative(mesh, phiHbyA)
        phiHbyA_b = phiHbyA.bv
        if needs_reference(p, mesh):
            # global flux balance before the singular pressure solve
            # (adjustPhi in icoFoam's pEqn.H)
            from .simple import adjust_phi

            phiHbyA_b = adjust_phi(mesh, phiHbyA_b, U)
            phiHbyA = phiHbyA._replace(bv=phiHbyA_b)

        for nonorth in range(cfg.n_non_orth + 1):
            corr_face = None
            if use_corr:
                # the explicit non-orthogonal part from the latest p
                # (fvm::laplacian's deferred correction)
                corr_face, corr_cell = slot_mod.laplacian_correction(
                    mesh, rAf_slot, p.data, p.boundary_values(mesh),
                    limit=cfg.corr_limit)
                source = (pEqn0.source - corr_cell
                          + slot_mod.surface_sum(mesh, phiHbyA))
            else:
                source = pEqn0.source + slot_mod.surface_sum(mesh, phiHbyA)
            pEqn = pEqn0.replace_fields(source=source)
            final = (corr == cfg.n_correctors - 1
                     and nonorth == cfg.n_non_orth)
            ctl = ctl_final_p if final else p_ctrl_p
            pEqn, ctl = linear.prep_pressure(
                pEqn, needs_reference(p, mesh), ctl,
                cfg.p_ref_cell, cfg.p_ref_value)
            pdata, pperf = linear.solve(mesh, pEqn, p.data, ctl)
            p = p.with_data(pdata)
            if corr == 0 and nonorth == 0:
                diag["p_initial"] = pperf.initial_residual
                diag["p_iters"] = pperf.n_iterations
            diag["p_final"] = pperf.final_residual
            if nonorth == cfg.n_non_orth:
                # phi = phiHbyA - pEqn.flux (slot form; the boundary part
                # stays flat and small)
                F = slot_mod.laplacian_flux(mesh, rAf_slot, p.data,
                                            corrected=use_corr,
                                            corr=corr_face)
                p_bc = surface.owner_to_b(mesh, p.data)
                F_b = pEqn.ic * p_bc - pEqn.bc
                phi_slot = slot_mod.SlotFace(
                    phiHbyA.sv - F.sv, phiHbyA.fb - F.fb, phiHbyA_b - F_b)

        grad_p = fvc.grad_of(mesh, p, cfg.grad_scheme)
        U = U.with_data(HbyA - rA[:, None] * grad_p)
        phi_for_bc = torch.cat([phi.new_zeros(nif), phi_slot.bv], dim=0)
        U = U.correct_boundary_conditions(mesh, phi=phi_for_bc)
    phi = slot_mod.to_flat(mesh, phi_slot)
    fvopt_state = state.get("fvopt")
    if cfg.fv_options:
        # fvOptions.correct(U) after the corrector loop
        U, fvopt_state = cfg.fv_options.correct_U(mesh, U, rA, fvopt_state)

    # -- turbulence correction (pisoFoam: turbulence->correct()) ------------
    new_turb = state.get("turb")
    if cfg.turb is not None:
        new_turb, tdiag = cfg.turb.correct(
            mesh, state["turb"], U, phi, dt, controls=cfg.turb_controls,
            phi_slot=phi_slot)
        diag.update({f"turb_{k}": v for k, v in tdiag.items()})

    # -- diagnostics --------------------------------------------------------------
    div_phi = slot_mod.surface_sum(mesh, phi_slot)  # continuity error * V
    vol = torch.sum(mesh.v)
    diag["continuity"] = torch.sum(torch.abs(div_phi)) / vol
    diag["continuity_global"] = torch.sum(div_phi) / vol
    sum_phi = slot_mod.weighted_cell_sum(mesh, phi_slot, absolute=True)
    diag["courant_max"] = 0.5 * torch.max(sum_phi / mesh.v) * dt
    diag["courant_mean"] = 0.5 * (
        (torch.sum(torch.abs(phi_slot.sv) * mesh.st_valid)
         + torch.sum(torch.abs(phi_slot.fb))
         + 2.0 * torch.sum(torch.abs(phi_slot.bv)))
        / (2.0 * vol)) * dt

    new_state = dict(state)
    new_state.update(U=U, p=p, phi=phi,
                     phi_slot=(phi_slot.sv, phi_slot.fb))
    if fvopt_state is not None:
        new_state["fvopt"] = fvopt_state
    advance_time_state(state, new_state, U, rdt, cfg.ddt_scheme)
    if new_turb is not None:
        new_state["turb"] = new_turb
    return new_state, diag


def make_step(mesh, cfg: PisoConfig):
    """(state, dt) -> (state, diag) for one PISO step."""
    def step(state, dt):
        return piso_step(mesh, state, dt, cfg)

    return step


def make_chunk(mesh, cfg: PisoConfig, n: int):
    """(state, dt) -> (state, last diag) for n PISO steps at fixed dt
    (the reference's lax.scan chunk as a plain loop)."""
    def chunk(state, dt):
        diag = None
        for _ in range(n):
            state, diag = piso_step(mesh, state, dt, cfg)
        return state, diag

    return chunk


def project_initial_flux(mesh, p: VolField, phi: Any,
                         controls: Optional[Dict] = None) -> Any:
    """Make the initial flux divergence-free by one pressure-style
    projection (a one-shot potentialFoam)."""
    ctl = dict(controls or {})
    ctl.setdefault("solver", "PCG")
    ctl.setdefault("tolerance", 1e-7)
    ctl.setdefault("relTol", 0.0)
    ctl.setdefault("maxIter", 3000)
    ctl.pop("_gamg", None)

    pcorr = dataclasses.replace(p, data=torch.zeros_like(p.data),
                                name="pcorr")
    # scale the problem to O(1): an (almost-)balanced initial flux gives
    # a roundoff-level RHS on which f32 Krylov iteration degenerates
    div0 = surface.surface_sum(mesh, phi)
    scale = torch.clamp(torch.max(torch.abs(div0)), min=1e-30)

    eqn = fvm.laplacian(mesh, 1.0, pcorr, corrected=False, gamma_dims=dimless)
    eqn = eqn.replace_fields(source=eqn.source + div0 / scale)
    if needs_reference(pcorr, mesh):
        eqn = eqn.set_reference(0, 0.0)
    data, _ = linear.solve(mesh, eqn, pcorr.data, ctl)
    return phi - eqn.flux(mesh, data) * scale


def initial_state(mesh, U: VolField, p: VolField,
                  turb_state: Optional[Dict] = None, project: bool = True,
                  ddt_scheme: str = "Euler") -> Dict:
    """Initial solver state: the (projected) flux of U in flat and slot
    form, the old-time entries of the ddt scheme, plus the turbulence
    fields when a model is used."""
    phi = fvc.flux(mesh, U)
    if project:
        phi = project_initial_flux(mesh, p, phi)
    sl = slot_mod.from_flat(mesh, phi)
    st = {"U": U, "p": p, "phi": phi, "U0": U.data,
          "phi_slot": (sl.sv, sl.fb)}
    toks = ddt_scheme.split()
    if toks[0] == "backward":
        # deltaT0_ = GREAT until oldTime.oldTime exists: the first step
        # degenerates to Euler
        st["U00"] = U.data
        st["rdt0"] = _as_scalar(mesh, 1e-30)
    elif toks[0] == "CrankNicolson":
        st["ddt0_U"] = torch.zeros_like(U.data)
        st["rdt0"] = _as_scalar(mesh, 1e-30)
    if turb_state is not None:
        st["turb"] = turb_state
    return st
