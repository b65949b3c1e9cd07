"""floating: a sixDoF rigid body coupled to incompressible flow (port of
openfoam-2.2.x_tpu/solvers/floating.py; the sixDoFRigidBodyMotion motion
solver in pimpleDyMFoam, the floatingObject pattern).

Per step: the flow's pressure and viscous forces on the body patch drive
models/sixdof.py::update; the points follow the body's rigid motion,
blended to zero between r_inner and r_outer around the initial centre of
mass (an explicit smooth extension in place of the reference's
displacementLaplacian solve, as the JAX package does); the geometry is
rebuilt on the device (mesh/moving.py::update_geometry); and PISO runs on
the moved mesh with the relative flux, the mesh flux being the discrete
swept-face form (cf_new - cf_old)/dt . (Sf_new + Sf_old)/2 (the motion is
force-driven: there is no analytic mesh velocity). Every solve goes
through linear.solve, so the SpMV kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..core.dimensions import dimTime, dimViscosity
from ..core.fields import VolField
from ..mesh import moving
from ..models import sixdof
from ..ops import fvc, fvm, slot as slot_mod, surface
from . import linear
from .piso import boundary_flux, needs_reference


class FloatingConfig(NamedTuple):
    nu: float
    body: sixdof.RigidBodyConfig
    body_patch: int               # patch index of the rigid body
    x0: Tuple[float, float, float]   # initial centre of mass
    r_inner: float                # full-motion radius around the body
    r_outer: float                # zero-motion radius
    rho_ref: float = 1000.0       # flow density (kinematic p scaling)
    n_correctors: int = 2
    n_non_orth: int = 0
    p_ref_cell: int = 0
    p_ref_value: float = 0.0
    p_controls: Dict = None
    u_controls: Dict = None


def _blend_weight(r, r_inner, r_outer):
    t = torch.clamp((r - r_inner) / max(r_outer - r_inner, 1e-30),
                    0.0, 1.0)
    return 0.5 * (1.0 + torch.cos(math.pi * t))   # C1 falloff


def body_points(points0, x0, body: sixdof.RigidBodyState,
                r_inner, r_outer):
    """The initial points moved with the body's rigid motion, blended to
    zero at r_outer from the INITIAL centre of mass."""
    x0 = torch.as_tensor(x0, dtype=points0.dtype, device=points0.device)
    rel = points0 - x0[None, :]
    w = _blend_weight(torch.linalg.norm(rel, dim=1), r_inner, r_outer)
    moved = body.x[None, :] + sixdof.quat_rotate(body.q, rel)
    return points0 + w[:, None] * (moved - points0)


def patch_force_torque(mesh_t, p_data, U: VolField, nu, rho_ref,
                       patch, about):
    """Pressure and viscous force and torque on a patch (the forces
    function object; kinematic p times rho_ref)."""
    sl = patch.slice
    own = mesh_t.owner[sl]
    # pressure: the boundary p is the owner cell's (zeroGradient)
    fp = rho_ref * p_data[own][:, None] * mesh_t.sf[sl]
    # viscous: tau = -rho nu dU/dn (wall: U_wall - U_c) |Sf| / delta
    nif = mesh_t.n_internal_faces
    U_b = U.boundary_values(mesh_t)[sl.start - nif:sl.stop - nif]
    dU = (U_b - U.data[own]) * mesh_t.delta_coeffs[sl][:, None]
    f = fp - rho_ref * nu * dU * mesh_t.mag_sf[sl][:, None]
    r = mesh_t.cf[sl] - about[None, :]
    return (torch.sum(f, dim=0),
            torch.sum(torch.linalg.cross(r, f, dim=1), dim=0))


def floating_step(mesh, state: Dict, dt: Any, cfg: FloatingConfig
                  ) -> Tuple[Dict, Dict]:
    p_ctrl = cfg.p_controls or {"solver": "PCG",
                                "preconditioner": "polynomial",
                                "tolerance": 1e-7, "relTol": 0.01,
                                "maxIter": 1000}
    u_ctrl = cfg.u_controls or {"solver": "PBiCGStab",
                                "tolerance": 1e-6, "relTol": 0.1,
                                "maxIter": 200}
    U: VolField = state["U"]
    p: VolField = state["p"]
    phi = state["phi"]            # relative volumetric flux
    topo = state["topo"]
    body: sixdof.RigidBodyState = state["body"]
    dt = torch.as_tensor(dt, dtype=mesh.v.dtype, device=mesh.device)
    rdt = 1.0 / dt
    diag: Dict[str, Any] = {}

    # -- 1. the flow's forces on the body, the 6-DoF update ------------------
    patch = mesh.patches[cfg.body_patch]
    mesh_old = moving.update_geometry(mesh, state["points"], topo)
    F, tau = patch_force_torque(mesh_old, p.data, U, cfg.nu, cfg.rho_ref,
                                patch, body.x)
    body = sixdof.update(cfg.body, body, dt, f_ext=F, tau_ext=tau)
    diag["body_x"] = body.x
    diag["body_v"] = body.v
    diag["force"] = F

    # -- 2. mesh motion, the discrete swept mesh flux -------------------------
    points = body_points(state["points0"], cfg.x0, body, cfg.r_inner,
                         cfg.r_outer)
    mesh_t = moving.update_geometry(mesh, points, topo)
    mesh_phi = (torch.sum((mesh_t.cf - mesh_old.cf) * rdt
                          * (0.5 * (mesh_t.sf + mesh_old.sf)), dim=1)
                * mesh_t.face_active)
    nif = mesh_t.n_internal_faces
    phi_slot = slot_mod.from_flat(mesh_t, phi)
    mp_slot = slot_mod.from_flat(mesh_t, mesh_phi)

    # -- 3. PISO on the moving mesh (as pimpledym) ----------------------------
    nu = torch.tensor(cfg.nu, dtype=mesh.v.dtype, device=mesh.device)
    UEqn = (fvm.ddt(mesh_t, U, state["U0"], rdt)
            + fvm.div(mesh_t, phi, U, phi_slot=phi_slot)
            - fvm.laplacian(mesh_t, nu, U, corrected=False,
                            gamma_dims=dimViscosity))
    grad_p = fvc.grad_of(mesh_t, p, "Gauss linear")
    Udata, uperf = linear.solve(mesh_t, UEqn.add_source(-grad_p, mesh_t),
                                U.data, u_ctrl)
    U = U.with_data(Udata)
    diag["Ux"] = uperf

    rA = 1.0 / UEqn.A(mesh_t)
    rAf_slot = slot_mod.interpolate(mesh_t, rA,
                                    bv=surface.owner_to_b(mesh_t, rA))
    rAf = slot_mod.to_flat(mesh_t, rAf_slot)
    pEqn0 = fvm.laplacian(mesh_t, rAf, p, corrected=False,
                          gamma_dims=dimTime, gamma_slot=rAf_slot)
    p_ctrl_p = linear.prepare_controls(mesh_t, pEqn0, p_ctrl)
    closed = needs_reference(p, mesh_t)

    for corr in range(cfg.n_correctors):
        HbyA = rA[:, None] * UEqn.H(mesh_t, U.data)
        hba = slot_mod.flux_of(mesh_t, HbyA, bv=boundary_flux(mesh_t, U))
        # the body patch moves: its boundary flux is the body's swept flux
        phiHbyA = slot_mod.SlotFace(hba.sv - mp_slot.sv,
                                    hba.fb - mp_slot.fb,
                                    torch.zeros_like(hba.bv))
        pEqn = pEqn0.replace_fields(
            source=pEqn0.source + slot_mod.surface_sum(mesh_t, phiHbyA))
        pEqn, ctl = linear.prep_pressure(pEqn, closed, p_ctrl_p,
                                         cfg.p_ref_cell, cfg.p_ref_value)
        pdata, pperf = linear.solve(mesh_t, pEqn, p.data, ctl)
        p = p.with_data(pdata)
        if corr == 0:
            diag["p_initial"] = pperf.initial_residual
        diag["p_final"] = pperf.final_residual
        Fl = slot_mod.laplacian_flux(mesh_t, rAf_slot, p.data,
                                     corrected=False, corr=None)
        F_b = pEqn.ic * surface.owner_to_b(mesh_t, p.data) - pEqn.bc
        phi_slot = slot_mod.SlotFace(phiHbyA.sv - Fl.sv,
                                     phiHbyA.fb - Fl.fb,
                                     phiHbyA.bv - F_b)
        grad_p = fvc.grad_of(mesh_t, p, "Gauss linear")
        U = U.with_data(HbyA - rA[:, None] * grad_p)
        # no slip on the moving body: U = the body's velocity at each face
        r = mesh_t.cf[patch.slice] - body.x[None, :]
        I = torch.as_tensor(cfg.body.I_body, dtype=U.data.dtype,
                            device=U.data.device)
        om_b = sixdof.quat_rotate(sixdof._conj(body.q), body.L) / I
        om_g = sixdof.quat_rotate(body.q, om_b)
        u_body = body.v[None, :] + torch.linalg.cross(
            torch.broadcast_to(om_g, r.shape), r, dim=1)
        bcs = list(U.bcs)
        bcs[cfg.body_patch] = bcs[cfg.body_patch].replace(ref_value=u_body)
        U = dataclasses.replace(U, bcs=tuple(bcs))
        U = U.correct_boundary_conditions(mesh_t)
    phi = slot_mod.to_flat(mesh_t, phi_slot)

    div_phi = slot_mod.surface_sum(mesh_t, phi_slot)
    diag["continuity"] = torch.sum(torch.abs(div_phi)) / torch.sum(mesh_t.v)
    diag["v_min"] = torch.min(mesh_t.v)

    new_state = dict(state)
    new_state.update(U=U, p=p, phi=phi, U0=U.data, body=body,
                     points=points)
    return new_state, diag


def initial_state(pm, mesh, U: VolField, p: VolField,
                  cfg: FloatingConfig,
                  body: Optional[sixdof.RigidBodyState] = None) -> Dict:
    """pm: the host PolyMesh (its face tables and points)."""
    dtype, dev = mesh.v.dtype, mesh.device
    topo = moving.topo_from_poly(pm, dtype, dev)
    pts0 = torch.tensor(pm.points, dtype=dtype, device=dev)
    if body is None:
        body = sixdof.initial_state(x=cfg.x0, dtype=dtype, device=dev)
    return {"U": U, "p": p, "phi": fvc.flux(mesh, U), "U0": U.data,
            "points0": pts0, "points": pts0, "topo": topo, "body": body}


def make_step(mesh, cfg: FloatingConfig):
    """(state, dt) -> (state, diag) for one floating-body step."""
    def step(state, dt):
        return floating_step(mesh, state, dt, cfg)

    return step
