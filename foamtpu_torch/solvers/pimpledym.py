"""pimpleDyMFoam — transient incompressible PISO/PIMPLE on a moving
(solid-body motion) mesh (port of openfoam-2.2.x_tpu/solvers/pimpledym.py;
incompressible/pimpleFoam/pimpleDyMFoam: mesh.update(), correctPhi,
fvc::makeRelative).

Topology static, geometry recomputed on the device from the motion
function every step (mesh/moving.py). The stored face flux is the
RELATIVE flux phi_rel = phi_abs - meshPhi (meshPhi exact for rigid
motions), so continuity and convection use it directly and
makeRelative/makeAbsolute collapse to one subtraction at assembly.
Laminar, as the reference: no turbulence on the moving-mesh path.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..core.dimensions import dimTime, dimViscosity
from ..core.fields import VolField
from ..mesh import moving
from ..ops import fvc, fvm, schemes as schemes_mod, slot as slot_mod, surface
from . import linear
from .piso import boundary_flux, needs_reference


class DyMConfig(NamedTuple):
    nu: float
    pts_fn: Callable              # (points0, t) -> points
    umesh_fn: Callable            # (x, t) -> mesh velocity
    n_correctors: int = 2
    n_non_orth: int = 0
    corrected: bool = False
    corr_limit: float = 1.0
    div_scheme: str = "linear"
    p_ref_cell: int = 0
    p_ref_value: float = 0.0
    p_controls: Dict = None
    u_controls: Dict = None


def pimpledym_step(mesh: Any, state: Dict, dt: Any, cfg: DyMConfig
                   ) -> Tuple[Dict, Dict]:
    """One time step: move the mesh to t + dt, then PISO on the moved
    mesh with relative fluxes. `mesh` is the mesh at its load position;
    the moved one is rebuilt from it every step."""
    p_ctrl = cfg.p_controls or {"solver": "PCG",
                                "preconditioner": "polynomial",
                                "tolerance": 1e-7, "relTol": 0.01,
                                "maxIter": 1000}
    u_ctrl = cfg.u_controls or {"solver": "smoothSolver",
                                "tolerance": 1e-6, "relTol": 0.0,
                                "maxIter": 300, "nSweeps": 2}
    U: VolField = state["U"]
    p: VolField = state["p"]
    phi = state["phi"]            # RELATIVE flux
    topo = state["topo"]
    dt = torch.as_tensor(dt, dtype=mesh.v.dtype, device=mesh.device)
    t = state["t"] + dt
    rdt = 1.0 / dt
    diag: Dict[str, Any] = {}

    # -- mesh.update() ------------------------------------------------------
    points = cfg.pts_fn(state["points0"], t)
    mesh_t = moving.update_geometry(mesh, points, topo)
    mesh_phi = moving.mesh_flux(mesh_t, cfg.umesh_fn, t) * mesh_t.face_active

    phi_slot = slot_mod.from_flat(mesh_t, phi)

    # -- momentum -----------------------------------------------------------
    w_slot = (None if cfg.div_scheme == "linear" else
              schemes_mod.weights_slot(mesh_t, phi_slot, cfg.div_scheme, U))
    UEqn = (fvm.ddt(mesh_t, U, state["U0"], rdt)
            + fvm.div(mesh_t, phi, U, phi_slot=phi_slot,
                      slot_weights=w_slot)
            - fvm.laplacian(mesh_t, torch.tensor(cfg.nu, dtype=mesh.v.dtype,
                                                 device=mesh.device),
                            U, corrected=cfg.corrected,
                            gamma_dims=dimViscosity, limit=cfg.corr_limit))
    grad_p = fvc.grad_of(mesh_t, p, "Gauss linear")
    Umat = UEqn.add_source(-grad_p, mesh_t)
    Udata, uperf = linear.solve(mesh_t, Umat, U.data, u_ctrl)
    U = U.with_data(Udata)
    diag["Ux"] = uperf

    # -- PISO correctors (relative fluxes) ----------------------------------
    rA = 1.0 / UEqn.A(mesh_t)
    rAf_slot = slot_mod.interpolate(mesh_t, rA,
                                    bv=surface.owner_to_b(mesh_t, rA))
    rAf = slot_mod.to_flat(mesh_t, rAf_slot)
    pEqn0 = fvm.laplacian(mesh_t, rAf, p, corrected=cfg.corrected,
                          gamma_dims=dimTime, limit=cfg.corr_limit,
                          defer_correction=True, gamma_slot=rAf_slot)
    p_ctrl_p = linear.prepare_controls(mesh_t, pEqn0, p_ctrl)
    closed = needs_reference(p, mesh_t)
    mp_slot = slot_mod.from_flat(mesh_t, mesh_phi)

    for corr in range(cfg.n_correctors):
        HbyA = rA[:, None] * UEqn.H(mesh_t, U.data)
        # absolute flux of HbyA, then makeRelative
        # (phiHbyA = interp(HbyA)&Sf; fvc::makeRelative(phiHbyA, U))
        hba = slot_mod.flux_of(mesh_t, HbyA, bv=boundary_flux(mesh_t, U))
        phiHbyA = slot_mod.SlotFace(hba.sv - mp_slot.sv,
                                    hba.fb - mp_slot.fb,
                                    hba.bv - mp_slot.bv)
        phiHbyA_b = phiHbyA.bv
        for nonorth in range(cfg.n_non_orth + 1):
            pEqn = pEqn0.replace_fields(
                source=pEqn0.source + slot_mod.surface_sum(mesh_t, phiHbyA))
            pEqn, ctl = linear.prep_pressure(
                pEqn, closed, p_ctrl_p, cfg.p_ref_cell, cfg.p_ref_value)
            pdata, pperf = linear.solve(mesh_t, pEqn, p.data, ctl)
            p = p.with_data(pdata)
            if corr == 0 and nonorth == 0:
                diag["p_initial"] = pperf.initial_residual
                diag["p_iters"] = pperf.n_iterations
            diag["p_final"] = pperf.final_residual
            if nonorth == cfg.n_non_orth:
                F = slot_mod.laplacian_flux(mesh_t, rAf_slot, p.data,
                                            corrected=False, corr=None)
                p_bc = surface.owner_to_b(mesh_t, p.data)
                F_b = pEqn.ic * p_bc - pEqn.bc
                phi_slot = slot_mod.SlotFace(
                    phiHbyA.sv - F.sv, phiHbyA.fb - F.fb, phiHbyA_b - F_b)
        grad_p = fvc.grad_of(mesh_t, p, "Gauss linear")
        U = U.with_data(HbyA - rA[:, None] * grad_p)
        U = U.correct_boundary_conditions(mesh_t)
    phi = slot_mod.to_flat(mesh_t, phi_slot)

    div_phi = slot_mod.surface_sum(mesh_t, phi_slot)
    diag["continuity"] = torch.sum(torch.abs(div_phi)) / torch.sum(mesh_t.v)
    sum_phi = slot_mod.weighted_cell_sum(mesh_t, phi_slot, absolute=True)
    diag["courant_max"] = 0.5 * torch.max(sum_phi / mesh_t.v) * dt

    new_state = dict(state)
    new_state.update(U=U, p=p, phi=phi, U0=U.data, t=t, points=points)
    return new_state, diag


def initial_state(pm, mesh, U: VolField, p: VolField,
                  umesh_fn: Optional[Callable] = None) -> Dict:
    """pm: host PolyMesh (for the topology tables). The stored initial
    flux is made RELATIVE when the motion function is given."""
    dtype, dev = mesh.v.dtype, mesh.device
    topo = moving.topo_from_poly(pm, dtype, dev)
    phi = fvc.flux(mesh, U)
    zero = torch.zeros((), dtype=dtype, device=dev)
    if umesh_fn is not None:
        phi = phi - moving.mesh_flux(mesh, umesh_fn, zero) * mesh.face_active
    points0 = torch.tensor(pm.points, dtype=dtype, device=dev)
    return {"U": U, "p": p, "phi": phi, "U0": U.data,
            "points0": points0, "points": points0,
            "topo": topo, "t": zero}


def make_step(mesh, cfg: DyMConfig):
    """(state, dt) -> (state, diag) for one moving-mesh step."""
    def step(state, dt):
        return pimpledym_step(mesh, state, dt, cfg)

    return step
