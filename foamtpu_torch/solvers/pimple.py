"""pimpleFoam — transient incompressible merged PISO-SIMPLE solver (port
of openfoam-2.2.x_tpu/solvers/pimple.py: pimpleFoam.C, UEqn.H, pEqn.H
and pimpleControl).

Semantics:
- nOuterCorrectors outer (SIMPLE-like) iterations per time step; each
  rebuilds the momentum equation from the latest phi and re-enters the
  PISO corrector loop (nCorrectors).
- Under-relaxation applies on NON-final outer iterations only: UEqn is
  relaxed implicitly with alpha_u, p explicitly with alpha_p after the
  flux correction. The final outer iteration runs unrelaxed
  (relaxationFactors "<field>Final" defaulting to 1) and the last
  pressure solve of the step uses the "pFinal" solver controls.
- nOuterCorrectors=1 marks the single iteration final, so the step
  reduces EXACTLY to PISO (tests/test_torch_pimple.py).
- turbOnFinalIterOnly (default yes): turbulence corrected after the
  final outer iteration only.

A step is eager torch, like piso.piso_step, and corrects a
non-orthogonal mesh's pressure laplacian as it does (each
nNonOrthogonalCorrectors pass, every outer iteration); a non-Newtonian
viscosity (nu_fn) enters as in PISO (piso.add_viscous), and so do fvOptions and
MRF zones (piso.add_sources before the relaxation, the relative phiHbyA
before adjustPhi; fvOptions correct U after each outer iteration's
correctors: MRFPimpleFoam, SRFPimpleFoam). A fan pair's jump is
re-evaluated from the current flux at the start of every outer
iteration (fanDuct).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..core.dimensions import dimTime
from ..core.fields import VolField
from ..ops import fvc, fvm, schemes, surface
from ..ops import slot as slot_mod
from . import linear
from .piso import (_as_scalar, add_sources, add_viscous,
                   advance_time_state, boundary_flux,
                   ddt_matrix, needs_reference)
from .simple import adjust_phi


class PimpleConfig(NamedTuple):
    nu: float
    n_outer: int = 1             # nOuterCorrectors
    n_correctors: int = 2        # nCorrectors
    n_non_orth: int = 0
    momentum_predictor: bool = True
    corrected: bool = False
    corr_limit: float = 1.0
    div_scheme: str = "linear"
    ddt_scheme: str = "Euler"
    grad_scheme: str = "Gauss linear"
    p_ref_cell: int = 0
    p_ref_value: float = 0.0
    alpha_u: float = 1.0         # relaxationFactors on non-final outer iters
    alpha_p: float = 1.0
    p_controls: Dict = None
    p_controls_final: Dict = None
    u_controls: Dict = None
    turb: Any = None
    turb_controls: Dict = None
    turb_on_final_only: bool = True
    nu_fn: Any = None
    fv_options: Any = None   # models/fvoptions.OptionList
    mrf: Any = None          # models/mrf.MRFZones


def pimple_step(mesh, state: Dict, dt: Any, cfg: PimpleConfig
                ) -> Tuple[Dict, Dict]:
    """One PIMPLE time step. state: {"U","p","phi","U0"(,"turb")}."""
    if "mom_src" in state:
        # the reference's PIMPLE never reads mom_src and so would drop the
        # source silently (ROADMAP Queue 3: a departure kept on purpose)
        raise NotImplementedError(
            "a lagrangian momentum source (state['mom_src']) in PIMPLE: the "
            "reference's pimple_step ignores it; use PISO")
    p_ctrl = cfg.p_controls or {"solver": "PCG", "preconditioner": "diagonal",
                                "tolerance": 1e-6, "relTol": 0.0,
                                "maxIter": 1000}
    u_ctrl = cfg.u_controls or {"solver": "smoothSolver", "tolerance": 1e-5,
                                "relTol": 0.0, "maxIter": 1000, "nSweeps": 2}

    U: VolField = state["U"]
    p: VolField = state["p"]
    phi = state["phi"]
    nif = mesh.n_internal_faces
    dt = _as_scalar(mesh, dt)
    rdt = 1.0 / dt
    diag: Dict[str, Any] = {}
    new_turb = state.get("turb")
    fvopt_state = state.get("fvopt")

    if "phi_slot" in state:
        phi_slot = slot_mod.SlotFace(*state["phi_slot"], bv=phi[nif:])
    else:
        phi_slot = slot_mod.from_flat(mesh, phi)
    use_corr = cfg.corrected and not getattr(mesh, "orthogonal", False)

    # fan jump pairs re-evaluate their curve at the current flow rate
    # before the pressure assembly sees the BCs (fan updateCoeffs)
    has_fan = any(bc.kind == "fan" for bc in p.bcs)

    for outer in range(cfg.n_outer):
        final_outer = outer == cfg.n_outer - 1
        if has_fan:
            p = p.correct_boundary_conditions(
                mesh, phi=slot_mod.to_flat(mesh, phi_slot))

        # -- momentum predictor (rebuilt each outer iteration) -------------
        w_slot = (None if cfg.div_scheme == "linear" else
                  schemes.weights_slot(mesh, phi_slot, cfg.div_scheme, U))
        UEqn = (ddt_matrix(mesh, U, state, rdt, cfg.ddt_scheme)
                + fvm.div(mesh, phi, U, phi_slot=phi_slot,
                          slot_weights=w_slot))
        UEqn = add_viscous(mesh, UEqn, U, new_turb, cfg)
        UEqn = add_sources(mesh, UEqn, U, fvopt_state, cfg)
        if not final_outer and cfg.alpha_u < 1.0:
            UEqn = UEqn.relax(mesh, cfg.alpha_u, U.data)
        grad_p = fvc.grad_of(mesh, p, cfg.grad_scheme)
        if cfg.momentum_predictor:
            Umat = UEqn.add_source(-grad_p, mesh)
            Udata, uperf = linear.solve(mesh, Umat, U.data, u_ctrl)
            U = U.with_data(Udata)
            if outer == 0:
                diag["Ux"] = uperf
        elif outer == 0:
            diag["Ux"] = None

        # -- PISO corrector loop -------------------------------------------
        rA = 1.0 / UEqn.A(mesh)
        rA_b = surface.owner_to_b(mesh, rA)
        rAf_slot = slot_mod.interpolate(mesh, rA, bv=rA_b)
        rAf = slot_mod.to_flat(mesh, rAf_slot)
        pEqn0 = fvm.laplacian(
            mesh, rAf, p, corrected=cfg.corrected, gamma_dims=dimTime,
            limit=cfg.corr_limit, defer_correction=True,
            gamma_slot=rAf_slot)
        ctl_final0 = cfg.p_controls_final or p_ctrl
        p_ctrl_p, ctl_final_p = linear.prepare_controls(
            mesh, pEqn0, p_ctrl, ctl_final0)
        closed = needs_reference(p, mesh)

        for corr in range(cfg.n_correctors):
            HbyA = rA[:, None] * UEqn.H(mesh, U.data)
            phiHbyA = slot_mod.flux_of(mesh, HbyA,
                                       bv=boundary_flux(mesh, U))
            if cfg.mrf:
                # mrfZones.relativeFlux(phiHbyA), before adjustPhi
                phiHbyA = cfg.mrf.make_relative(mesh, phiHbyA)
            phiHbyA_b = phiHbyA.bv
            if closed:
                phiHbyA_b = adjust_phi(mesh, phiHbyA_b, U)
                phiHbyA = phiHbyA._replace(bv=phiHbyA_b)

            p_before = p.data
            for nonorth in range(cfg.n_non_orth + 1):
                corr_face = None
                if use_corr:
                    corr_face, corr_cell = slot_mod.laplacian_correction(
                        mesh, rAf_slot, p.data, p.boundary_values(mesh),
                        limit=cfg.corr_limit)
                    source = (pEqn0.source - corr_cell
                              + slot_mod.surface_sum(mesh, phiHbyA))
                else:
                    source = (pEqn0.source
                              + slot_mod.surface_sum(mesh, phiHbyA))
                pEqn = pEqn0.replace_fields(source=source)
                final = (final_outer and corr == cfg.n_correctors - 1
                         and nonorth == cfg.n_non_orth)
                ctl = ctl_final_p if final else p_ctrl_p
                pEqn, ctl = linear.prep_pressure(
                    pEqn, closed, ctl, cfg.p_ref_cell, cfg.p_ref_value)
                pdata, pperf = linear.solve(mesh, pEqn, p.data, ctl)
                p = p.with_data(pdata)
                if outer == 0 and corr == 0 and nonorth == 0:
                    diag["p_initial"] = pperf.initial_residual
                    diag["p_iters"] = pperf.n_iterations
                diag["p_final"] = pperf.final_residual
                if nonorth == cfg.n_non_orth:
                    F = slot_mod.laplacian_flux(
                        mesh, rAf_slot, p.data, corrected=use_corr,
                        corr=corr_face)
                    p_bc = surface.owner_to_b(mesh, p.data)
                    F_b = pEqn.ic * p_bc - pEqn.bc
                    phi_slot = slot_mod.SlotFace(
                        phiHbyA.sv - F.sv, phiHbyA.fb - F.fb,
                        phiHbyA_b - F_b)

            # explicit p relaxation on non-final outer iterations, AFTER
            # the conservative flux update (pEqn.H p.relax())
            if not final_outer and cfg.alpha_p < 1.0:
                p = p.with_data(
                    p_before + cfg.alpha_p * (p.data - p_before))
            grad_p = fvc.grad_of(mesh, p, cfg.grad_scheme)
            U = U.with_data(HbyA - rA[:, None] * grad_p)
            phi_for_bc = torch.cat([phi.new_zeros(nif), phi_slot.bv], dim=0)
            U = U.correct_boundary_conditions(mesh, phi=phi_for_bc)
        phi = slot_mod.to_flat(mesh, phi_slot)
        if cfg.fv_options:
            # fvOptions.correct(U) after the corrector loop
            U, fvopt_state = cfg.fv_options.correct_U(mesh, U, rA,
                                                      fvopt_state)

        # -- turbulence ------------------------------------------------------
        if cfg.turb is not None and (
                final_outer or not cfg.turb_on_final_only):
            new_turb, tdiag = cfg.turb.correct(
                mesh, new_turb, U, phi, dt, controls=cfg.turb_controls,
                phi_slot=phi_slot)
            if final_outer:
                diag.update({f"turb_{k}": v for k, v in tdiag.items()})

    # -- diagnostics ----------------------------------------------------------
    div_phi = slot_mod.surface_sum(mesh, phi_slot)
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


def make_step(mesh, cfg: PimpleConfig):
    """(state, dt) -> (state, diag) for one PIMPLE step."""
    def step(state, dt):
        return pimple_step(mesh, state, dt, cfg)

    return step


def make_chunk(mesh, cfg: PimpleConfig, n: int):
    """(state, dt) -> (state, last diag) for n PIMPLE steps at fixed dt."""
    def chunk(state, dt):
        diag = None
        for _ in range(n):
            state, diag = pimple_step(mesh, state, dt, cfg)
        return state, diag

    return chunk
