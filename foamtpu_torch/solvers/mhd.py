"""mhdFoam — incompressible laminar magnetohydrodynamics (port of
openfoam-2.2.x_tpu/solvers/mhd.py: mhdFoam.C's PISO on U/p with the
Lorentz force in conservative Maxwell-stress form, the induction
equation for B, and the magnetic "pressure" projection that keeps
div(B) = 0):

    UEqn: ddt(U) + div(phi,U) - laplacian(nu,U)
            == div(phiB, 2 DBU B) - grad(DBU |B|^2)    (+ -grad p)
    BEqn: ddt(B) + div(phi,B) - laplacian(DB,B) - div(phiB,U) = 0
    pBEqn: laplacian(pB) == div(phiB);  phiB -= flux   (cleaning)

with DBU = 1/(2 mu rho), DB = 1/(mu sigma) (createFields.H); B carries
Alfven-velocity units. The stretching term div(phiB, U) is explicit, as
in the reference. A step is eager torch; every solve goes through the
offset-stencil SpMV (the CUDA kernel on the card).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..core.dimensions import dimTime, dimViscosity
from ..core.fields import VolField
from ..ops import fvc, fvm, surface
from . import linear
from .piso import (_as_scalar, boundary_flux, face_interp_cell,
                   needs_reference)


class MhdConfig(NamedTuple):
    nu: float = 1e-6
    rho: float = 1.0
    mu_mag: float = 1.0       # magnetic permeability mu
    sigma_c: float = 1.0      # electrical conductivity
    n_correctors: int = 2
    n_non_orth: int = 0
    corrected: bool = False
    p_ref_cell: int = 0
    p_ref_value: float = 0.0
    p_controls: Dict = None
    u_controls: Dict = None
    pb_controls: Dict = None


def _face_flux(mesh, V: VolField) -> Any:
    """Sf . interp(V) on internal faces (masked), the boundary flux of V's
    BC values on the rest."""
    nif = mesh.n_internal_faces
    hf = surface.interpolate_internal(mesh, V.data)
    return torch.cat([torch.sum(mesh.sf[:nif] * hf, dim=1)
                      * mesh.face_active[:nif], boundary_flux(mesh, V)])


def mhd_step(mesh, state: Dict, dt: Any, cfg: MhdConfig
             ) -> Tuple[Dict, Dict]:
    p_ctrl = cfg.p_controls or {"solver": "PCG",
                                "preconditioner": "polynomial",
                                "tolerance": 1e-7, "relTol": 0.01,
                                "maxIter": 1000}
    u_ctrl = cfg.u_controls or {"solver": "PBiCGStab", "tolerance": 1e-7,
                                "relTol": 0.0, "maxIter": 300}
    pb_ctrl = cfg.pb_controls or p_ctrl
    U: VolField = state["U"]
    p: VolField = state["p"]
    B: VolField = state["B"]
    pB: VolField = state["pB"]
    phi = state["phi"]
    phiB = state["phiB"]
    dt = _as_scalar(mesh, dt)
    rdt = 1.0 / dt
    nif = mesh.n_internal_faces
    diag: Dict[str, Any] = {}
    DBU = 1.0 / (2.0 * cfg.mu_mag * cfg.rho)
    DB = 1.0 / (cfg.mu_mag * cfg.sigma_c)

    # -- momentum with the Maxwell-stress Lorentz force ----------------------
    UEqn = (fvm.ddt(mesh, U, state["U0"], rdt)
            + fvm.div(mesh, phi, U)
            - fvm.laplacian(mesh, _as_scalar(mesh, cfg.nu), U,
                            corrected=cfg.corrected,
                            gamma_dims=dimViscosity))
    lorentz = (fvc.div(mesh, phiB, B.with_data(2.0 * DBU * B.data))
               - fvc.grad_of(
                   mesh, p.with_data(DBU * torch.sum(B.data * B.data, dim=1)),
                   "Gauss linear"))
    grad_p = fvc.grad_of(mesh, p, "Gauss linear")
    Umat = UEqn.add_source(lorentz - grad_p, mesh)
    Udata, uperf = linear.solve(mesh, Umat, U.data, u_ctrl)
    U = U.with_data(Udata)
    diag["Ux"] = uperf

    # -- PISO pressure correctors ---------------------------------------------
    rA = 1.0 / UEqn.A(mesh)
    rAf = face_interp_cell(mesh, rA)
    for corr in range(cfg.n_correctors):
        HbyA = rA[:, None] * (UEqn.H(mesh, U.data) + lorentz)
        hf = surface.interpolate_internal(mesh, HbyA)
        phiHbyA = torch.cat([torch.sum(mesh.sf[:nif] * hf, dim=1)
                             * mesh.face_active[:nif],
                             boundary_flux(mesh, U)])
        for nonorth in range(cfg.n_non_orth + 1):
            pEqn = fvm.laplacian(mesh, rAf, p, corrected=cfg.corrected,
                                 gamma_dims=dimTime)
            pEqn = pEqn.replace_fields(
                source=pEqn.source + surface.surface_sum(mesh, phiHbyA))
            pEqn, ctl_p = linear.prep_pressure(
                pEqn, needs_reference(p, mesh), p_ctrl,
                cfg.p_ref_cell, cfg.p_ref_value)
            pdata, pperf = linear.solve(mesh, pEqn, p.data, ctl_p)
            p = p.with_data(pdata)
            if corr == 0 and nonorth == 0:
                diag["p_initial"] = pperf.initial_residual
                diag["p_iters"] = pperf.n_iterations
            diag["p_final"] = pperf.final_residual
            if nonorth == cfg.n_non_orth:
                phi = phiHbyA - pEqn.flux(mesh, p.data)
        U = U.with_data(HbyA - rA[:, None]
                        * fvc.grad_of(mesh, p, "Gauss linear"))
        U = U.correct_boundary_conditions(mesh, phi=phi)

    # -- induction equation -----------------------------------------------------
    BEqn = (fvm.ddt(mesh, B, state["B0"], rdt)
            + fvm.div(mesh, phi, B)
            - fvm.laplacian(mesh, _as_scalar(mesh, DB), B,
                            corrected=cfg.corrected,
                            gamma_dims=dimViscosity))
    # the stretching term div(phiB, U), explicit
    BEqn = BEqn.add_source(fvc.div(mesh, phiB, U), mesh)
    Bdata, bperf = linear.solve(mesh, BEqn, B.data, u_ctrl)
    B = B.with_data(Bdata)
    diag["Bx"] = bperf
    # div(B) cleaning projection (B in Alfven-velocity units: the
    # cleaning Poisson has the pressure equation's shape)
    phiB = _face_flux(mesh, B)
    pBEqn = fvm.laplacian(mesh, mesh.v.new_ones(mesh.n_faces), pB,
                          corrected=cfg.corrected, gamma_dims=dimTime)
    pBEqn = pBEqn.replace_fields(
        source=pBEqn.source + surface.surface_sum(mesh, phiB))
    pBEqn, ctl_pb = linear.prep_pressure(
        pBEqn, needs_reference(pB, mesh), pb_ctrl, 0, 0.0)
    pbdata, pbperf = linear.solve(mesh, pBEqn, pB.data, ctl_pb)
    pB = pB.with_data(pbdata)
    phiB = phiB - pBEqn.flux(mesh, pB.data)
    diag["pB"] = pbperf

    vol = torch.sum(mesh.v)
    diag["continuity"] = (torch.sum(torch.abs(surface.surface_sum(mesh, phi)))
                          / vol)
    diag["divB"] = (torch.sum(torch.abs(surface.surface_sum(mesh, phiB)))
                    / vol)
    sum_phi = torch.sum(torch.abs(phi)[mesh.cface] * torch.abs(mesh.csign),
                        dim=1)
    diag["courant_max"] = 0.5 * torch.max(sum_phi / mesh.v) * dt

    new_state = dict(state)
    new_state.update(U=U, p=p, B=B, pB=pB, phi=phi, phiB=phiB,
                     U0=U.data, B0=B.data)
    return new_state, diag


def initial_state(mesh, U: VolField, p: VolField, B: VolField,
                  pB: VolField) -> Dict:
    return {"U": U, "p": p, "B": B, "pB": pB,
            "phi": fvc.flux(mesh, U), "phiB": fvc.flux(mesh, B),
            "U0": U.data, "B0": B.data}


def make_step(mesh, cfg: MhdConfig):
    """(state, dt) -> (state, diag) for one mhdFoam step."""
    def step(state, dt):
        return mhd_step(mesh, state, dt, cfg)

    return step
