"""simpleFoam — steady incompressible SIMPLE solver (port of
openfoam-2.2.x_tpu/solvers/simple.py: `adjust_phi`, `SimpleConfig`,
`simple_step`, `make_step`, `make_chunk` and `converged`).

One SIMPLE outer iteration: momentum predictor with implicit
under-relaxation (FvMatrix.relax), one pressure equation per
non-orthogonal corrector with the deferred correction, explicit
pressure relaxation after the flux update, then the turbulence model's
correct(). The reference scans a chunk of iterations inside one XLA
program; here an iteration is eager torch and a chunk is a plain loop.
fvOptions (porousSimpleFoam's porous zones among them) enter the momentum
equation and correct U after the corrector, MRF zones add their Coriolis
term before the relaxation and make phiHbyA relative before adjustPhi
(MRFSimpleFoam, SRFSimpleFoam). The adjoint porosity sink is outside the
ported slice and raises NotImplementedError.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..bc import patchfields as pf
from ..core.dimensions import dimTime, dimViscosity
from ..core.fields import VolField
from ..ops import fvc, fvm, schemes, surface
from ..ops import slot as slot_mod
from . import linear
from .piso import add_sources, boundary_flux, needs_reference


class SimpleConfig(NamedTuple):
    nu: float
    n_non_orth: int = 0
    corrected: bool = False
    corr_limit: float = 1.0
    div_scheme: str = "linear"
    grad_scheme: str = "Gauss linear"  # for grad(p)
    p_ref_cell: int = 0
    p_ref_value: float = 0.0
    alpha_u: float = 0.7
    alpha_p: float = 0.3
    p_controls: Dict = None
    u_controls: Dict = None
    turb: Any = None
    turb_controls: Dict = None
    turb_relax: float = 0.7
    fv_options: Any = None   # models/fvoptions.OptionList
    mrf: Any = None          # models/mrf.MRFZones


def adjust_phi(mesh, phi_b: Any, U: VolField) -> Any:
    """Global flux balance over adjustable boundaries
    (cfdTools/general/adjustPhi): scale the outflow on non-fixed-value
    patches so the net boundary flux vanishes."""
    adjustable = []
    for patch, bc in zip(mesh.patches, U.bcs):
        fixed = pf.is_value_bc(bc) or bc.kind in ("empty", "symmetry",
                                                  "symmetryPlane", "slip")
        adjustable.append(torch.full((patch.size,), 0.0 if fixed else 1.0,
                                     dtype=mesh.v.dtype, device=mesh.device))
    adj = torch.cat(adjustable)
    fixed_flux = torch.sum(phi_b * (1.0 - adj))
    out = torch.sum(torch.clamp(phi_b, min=0.0) * adj)
    inn = torch.sum(torch.clamp(phi_b, max=0.0) * adj)
    mass_in = -(fixed_flux + inn)
    big = torch.abs(out) > 1e-30
    scale = mass_in / torch.where(big, out, torch.ones_like(out))
    scale = torch.where(big, scale, torch.ones_like(scale))
    return torch.where((phi_b > 0) & (adj > 0), phi_b * scale, phi_b)


def check_supported(state: Dict, cfg: SimpleConfig) -> None:
    """Raise NotImplementedError for any feature outside the slice."""
    if "alpha_sink" in state:
        raise NotImplementedError(
            "the adjoint porosity sink (state['alpha_sink']) is not "
            "ported to foamtpu_torch yet")


def simple_step(mesh, state: Dict, cfg: SimpleConfig) -> Tuple[Dict, Dict]:
    """One SIMPLE outer iteration."""
    check_supported(state, cfg)
    p_ctrl = cfg.p_controls or {"solver": "PCG", "tolerance": 1e-6,
                                "relTol": 0.01}
    u_ctrl = cfg.u_controls or {"solver": "smoothSolver", "tolerance": 1e-5,
                                "relTol": 0.1, "maxIter": 200, "nSweeps": 2}

    U: VolField = state["U"]
    p: VolField = state["p"]
    phi = state["phi"]
    nif = mesh.n_internal_faces
    diag: Dict[str, Any] = {}
    # pseudo-time of the turbulence ddt (unused by a steady correct)
    dt = torch.tensor(1.0, dtype=mesh.v.dtype, device=mesh.device)

    if "phi_slot" in state:
        phi_slot = slot_mod.SlotFace(*state["phi_slot"], bv=phi[nif:])
    else:
        phi_slot = slot_mod.from_flat(mesh, phi)

    # -- momentum predictor with under-relaxation ------------------------------
    w_slot = (None if cfg.div_scheme == "linear" else
              schemes.weights_slot(mesh, phi_slot, cfg.div_scheme, U))
    UEqn = fvm.div(mesh, phi, U, phi_slot=phi_slot, slot_weights=w_slot)
    if cfg.turb is not None:
        visc_mat, visc_expl = cfg.turb.div_dev_reff(mesh, state["turb"], U)
        UEqn = UEqn + visc_mat
        UEqn = UEqn.add_source(-visc_expl, mesh)
    else:
        UEqn = UEqn - fvm.laplacian(
            mesh, torch.tensor(cfg.nu, dtype=mesh.v.dtype,
                               device=mesh.device), U,
            corrected=cfg.corrected, gamma_dims=dimViscosity,
            limit=cfg.corr_limit)
    # fvOptions and the Coriolis term before relax, so that the H/A split
    # sees them
    UEqn = add_sources(mesh, UEqn, U, state.get("fvopt"), cfg)
    UEqn = UEqn.relax(mesh, cfg.alpha_u, U.data)
    grad_p = fvc.grad_of(mesh, p, cfg.grad_scheme)
    Umat = UEqn.add_source(-grad_p, mesh)
    Udata, uperf = linear.solve(mesh, Umat, U.data, u_ctrl)
    U = U.with_data(Udata)
    diag["Ux"] = uperf

    # -- pressure correction -------------------------------------------------------
    rA = 1.0 / UEqn.A(mesh)
    HbyA = rA[:, None] * UEqn.H(mesh, U.data)
    phiHbyA = slot_mod.flux_of(mesh, HbyA, bv=boundary_flux(mesh, U))
    if cfg.mrf:
        # mrfZones.relativeFlux(phiHbyA), before adjustPhi
        phiHbyA = cfg.mrf.make_relative(mesh, phiHbyA)
    phiHbyA_b = phiHbyA.bv
    closed = needs_reference(p, mesh)
    if closed:
        phiHbyA_b = adjust_phi(mesh, phiHbyA_b, U)
        phiHbyA = phiHbyA._replace(bv=phiHbyA_b)
    rA_b = surface.owner_to_b(mesh, rA)
    rAf_slot = slot_mod.interpolate(mesh, rA, bv=rA_b)
    rAf = slot_mod.to_flat(mesh, rAf_slot)

    p_old = p.data
    # the pressure-matrix coefficients are the same across the
    # non-orthogonal correctors: assemble once, share one GAMG prep
    use_corr = cfg.corrected and not getattr(mesh, "orthogonal", False)
    pEqn0 = fvm.laplacian(mesh, rAf, p, corrected=cfg.corrected,
                          gamma_dims=dimTime, limit=cfg.corr_limit,
                          defer_correction=True, gamma_slot=rAf_slot)
    p_ctrl_p = linear.prepare_controls(mesh, pEqn0, p_ctrl)
    for nonorth in range(cfg.n_non_orth + 1):
        corr_face = None
        src = pEqn0.source + slot_mod.surface_sum(mesh, phiHbyA)
        if use_corr:
            corr_face, corr_cell = slot_mod.laplacian_correction(
                mesh, rAf_slot, p.data, p.boundary_values(mesh),
                limit=cfg.corr_limit)
            src = (pEqn0.source - corr_cell
                   + slot_mod.surface_sum(mesh, phiHbyA))
        pEqn = pEqn0.replace_fields(source=src)
        pEqn, ctl_p = linear.prep_pressure(
            pEqn, closed, p_ctrl_p, cfg.p_ref_cell, cfg.p_ref_value)
        pdata, pperf = linear.solve(mesh, pEqn, p.data, ctl_p)
        p = p.with_data(pdata)
        if nonorth == 0:
            diag["p_initial"] = pperf.initial_residual
            diag["p_iters"] = pperf.n_iterations
        diag["p_final"] = pperf.final_residual
        if nonorth == cfg.n_non_orth:
            F = slot_mod.laplacian_flux(mesh, rAf_slot, p.data,
                                        corrected=use_corr, corr=corr_face)
            p_bc = surface.owner_to_b(mesh, p.data)
            F_b = pEqn.ic * p_bc - pEqn.bc
            phi_slot = slot_mod.SlotFace(
                phiHbyA.sv - F.sv, phiHbyA.fb - F.fb, phiHbyA_b - F_b)

    # explicit pressure relaxation AFTER the flux correction (pEqn.H:
    # p.relax() after the phi update keeps the flux conservative)
    p = p.with_data(p_old + cfg.alpha_p * (p.data - p_old))
    grad_p = fvc.grad_of(mesh, p, cfg.grad_scheme)
    U = U.with_data(HbyA - rA[:, None] * grad_p)
    phi = slot_mod.to_flat(mesh, phi_slot)
    phi_for_bc = torch.cat([phi.new_zeros(nif), phi_slot.bv], dim=0)
    U = U.correct_boundary_conditions(mesh, phi=phi_for_bc)
    fvopt_state = state.get("fvopt")
    if cfg.fv_options:
        # fvOptions.correct(U) after the corrector
        U, fvopt_state = cfg.fv_options.correct_U(mesh, U, rA, fvopt_state)

    # -- turbulence -------------------------------------------------------------
    new_turb = state.get("turb")
    if cfg.turb is not None:
        new_turb, tdiag = cfg.turb.correct(
            mesh, state["turb"], U, phi, dt, steady=True,
            relax=cfg.turb_relax, controls=cfg.turb_controls,
            phi_slot=phi_slot)
        diag.update({f"turb_{k}": v for k, v in tdiag.items()})

    div_phi = slot_mod.surface_sum(mesh, phi_slot)
    vol = torch.sum(mesh.v)
    diag["continuity"] = torch.sum(torch.abs(div_phi)) / vol
    diag["continuity_global"] = torch.sum(div_phi) / vol

    new_state = dict(state)
    new_state.update(U=U, p=p, phi=phi,
                     phi_slot=(phi_slot.sv, phi_slot.fb))
    if fvopt_state is not None:
        new_state["fvopt"] = fvopt_state
    if new_turb is not None:
        new_state["turb"] = new_turb
    return new_state, diag


def make_step(mesh, cfg: SimpleConfig):
    """state -> (state, diag) for one SIMPLE iteration."""
    def step(state):
        return simple_step(mesh, state, cfg)

    return step


def make_chunk(mesh, cfg: SimpleConfig, n: int):
    """state -> (state, last diag) for n SIMPLE iterations (the
    reference's lax.scan chunk as a plain loop)."""
    def chunk(state):
        diag = None
        for _ in range(n):
            state, diag = simple_step(mesh, state, cfg)
        return state, diag

    return chunk


def converged(diag: Dict, residual_control: Dict) -> bool:
    """simpleControl residualControl check on the initial residuals
    (solutionControl::criteriaSatisfied); one host sync per entry."""
    if not residual_control:
        return False

    def worst(x) -> float:
        return float(np.max(torch.as_tensor(x).detach().cpu().numpy()))

    for name, tol in residual_control.items():
        if name in ("p",):
            r = worst(diag.get("p_initial", 1.0))
        elif name in ("U", "Ux"):
            perf = diag.get("Ux")
            r = worst(perf.initial_residual) if perf else 1.0
        else:
            perf = diag.get(f"turb_{name}")
            r = worst(perf.initial_residual) if perf else 1.0
        if r > float(tol):
            return False
    return True
