"""adjointShapeOptimizationFoam — continuous-adjoint topology optimisation
for power dissipation (port of openfoam-2.2.x_tpu/solvers/adjoint.py).

Each sweep is a primal SIMPLE iteration with the porosity sink alpha*U
(simple_step's state['alpha_sink']), the adjoint momentum

    UaEqn: div(-phi, Ua) - (grad(Ua) . U) - laplacian(nu, Ua)
           + Sp(alpha, Ua) == -grad(pa)

with (grad Ua).U the adjointTransposeConvection term, the adjoint
continuity by the same SIMPLE pressure projection, and the porosity
update

    alpha <- alpha + relax * (lambda * max(Ua & U, 0) - alpha)

clipped to [0, alphaMax], alpha held at zero in the inlet cells
(zeroCells(alpha, inletCells)). The adjoint BCs are the reference's
simplified ones (its documented deviation): the case's Ua and pa fields
as given. A sweep is eager torch; its solves go through the
offset-stencil SpMV.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..core.dimensions import dimTime, dimViscosity
from ..core.fields import VolField
from ..ops import fvc, fvm, slot as slot_mod, surface
from . import linear
from .piso import _as_scalar, boundary_flux, needs_reference
from .simple import SimpleConfig, simple_step


class AdjointConfig(NamedTuple):
    flow: SimpleConfig
    lam: float = 1e5              # sensitivity scale lambda
    alpha_max: float = 200.0
    alpha_relax: float = 0.1
    zero_alpha_cells: Any = None  # cell ids kept at alpha = 0


def _primal_with_alpha(mesh, state, cfg: AdjointConfig):
    """One primal SIMPLE iteration with the alpha*U porosity sink (its
    UEqn.H's `fvm::Sp(alpha, U)`)."""
    st = dict(state)
    st["alpha_sink"] = state["alpha"]
    return simple_step(mesh, st, cfg.flow)


def adjoint_step(mesh, state: Dict, cfg: AdjointConfig
                 ) -> Tuple[Dict, Dict]:
    """One optimisation sweep: primal SIMPLE, adjoint SIMPLE, then the
    alpha update."""
    f = cfg.flow
    p_ctrl = f.p_controls or {"solver": "PCG", "tolerance": 1e-6,
                              "relTol": 0.01}
    u_ctrl = f.u_controls or {"solver": "PBiCGStab",
                              "tolerance": 1e-6, "relTol": 0.1,
                              "maxIter": 200}
    state, diag = _primal_with_alpha(mesh, state, cfg)
    U: VolField = state["U"]
    phi = state["phi"]
    alpha = state["alpha"]
    Ua: VolField = state["Ua"]
    pa: VolField = state["pa"]

    # -- adjoint momentum -------------------------------------------------------
    phi_slot = slot_mod.from_flat(mesh, phi)
    neg_slot = slot_mod.SlotFace(-phi_slot.sv, -phi_slot.fb, -phi_slot.bv)
    UaEqn = (fvm.div(mesh, -phi, Ua, phi_slot=neg_slot)
             - fvm.laplacian(mesh, _as_scalar(mesh, f.nu), Ua,
                             corrected=f.corrected,
                             gamma_dims=dimViscosity)
             + fvm.Sp(mesh, alpha, Ua))
    # adjointTransposeConvection: (grad(Ua) & U)_i = d_i Ua_j U_j
    gUa = fvc.grad(mesh, Ua)                      # [nC, i, j]
    atc = torch.einsum("cij,cj->ci", gUa, U.data)
    UaEqn = UaEqn.relax(mesh, f.alpha_u, Ua.data)
    grad_pa = fvc.grad_of(mesh, pa, f.grad_scheme)
    Uamat = UaEqn.add_source(-grad_pa - atc, mesh)
    Uadata, uaperf = linear.solve(mesh, Uamat, Ua.data, u_ctrl)
    Ua = Ua.with_data(Uadata)
    diag["Uax"] = uaperf

    # -- adjoint pressure projection ----------------------------------------------
    rA = 1.0 / UaEqn.A(mesh)
    HbyA = rA[:, None] * UaEqn.H(mesh, Ua.data)
    phiHbyA = slot_mod.flux_of(mesh, HbyA, bv=boundary_flux(mesh, Ua))
    rAf_slot = slot_mod.interpolate(mesh, rA,
                                    bv=surface.owner_to_b(mesh, rA))
    rAf = slot_mod.to_flat(mesh, rAf_slot)
    paEqn = fvm.laplacian(mesh, rAf, pa, corrected=f.corrected,
                          gamma_dims=dimTime, gamma_slot=rAf_slot)
    paEqn = paEqn.replace_fields(
        source=paEqn.source + slot_mod.surface_sum(mesh, phiHbyA))
    paEqn, ctl = linear.prep_pressure(paEqn, needs_reference(pa, mesh),
                                      p_ctrl, f.p_ref_cell, 0.0)
    padata, paperf = linear.solve(mesh, paEqn, pa.data, ctl)
    pa_old = pa.data
    pa = pa.with_data(pa_old + f.alpha_p * (padata - pa_old))
    diag["pa_initial"] = paperf.initial_residual
    grad_pa = fvc.grad_of(mesh, pa, f.grad_scheme)
    Ua = Ua.with_data(HbyA - rA[:, None] * grad_pa)
    Ua = Ua.correct_boundary_conditions(mesh)

    # -- porosity (design variable) update ------------------------------------------
    sens = torch.sum(Ua.data * U.data, dim=1)     # Ua & U
    target = cfg.lam * torch.clamp(sens, min=0.0)
    alpha_new = alpha + cfg.alpha_relax * (target - alpha)
    alpha_new = torch.clamp(alpha_new, 0.0, cfg.alpha_max)
    if cfg.zero_alpha_cells is not None:
        alpha_new = alpha_new.index_fill(0, cfg.zero_alpha_cells, 0.0)
    diag["alpha_max_val"] = torch.max(alpha_new)
    # objective: the total power dissipation ~ sum(alpha U^2 + nu |grad U|^2)
    gU = fvc.grad(mesh, U)
    diag["objective"] = torch.sum(
        (alpha_new * torch.sum(U.data ** 2, dim=1)
         + f.nu * torch.sum(gU ** 2, dim=(1, 2))) * mesh.v)

    new_state = dict(state)
    new_state.update(Ua=Ua, pa=pa, alpha=alpha_new)
    return new_state, diag


def initial_state(mesh, U: VolField, p: VolField, Ua: VolField,
                  pa: VolField, cfg: AdjointConfig) -> Dict:
    return {"U": U, "p": p, "phi": fvc.flux(mesh, U), "Ua": Ua,
            "pa": pa, "alpha": mesh.v.new_zeros(mesh.n_cells)}


def make_step(mesh, cfg: AdjointConfig):
    """state -> (state, diag) for one optimisation sweep."""
    def step(state):
        return adjoint_step(mesh, state, cfg)

    return step
