"""shallowWaterFoam — inviscid shallow-water equations with rotation
(port of openfoam-2.2.x_tpu/solvers/shallowwater.py: shallowWaterFoam.C
and CourantNo.H). The PIMPLE-style h-U coupling:

    hUEqn : ddt(hU) + div(phiv, hU) == -g h grad(h + h0) - (F x hU)
            (phiv = phi / interp(h), the velocity flux)
    hEqn  : ddt(h) + div(phiHbyA) - laplacian(g interp(h rAU), h) = 0
            phiHbyA = interp(HbyA).Sf - phih0 + interp(rAU) ddtCorr,
            phih0   = g interp(h rAU) magSf snGrad(h0)
    phi   = phiHbyA - hEqn.flux();  hU = HbyA - rAU g h grad(h + h0)
    U     = hU / h

h is the water depth, h0 the (static) bed elevation, F = 2 Omega the
Coriolis vector. The fluxes stay in slot form, as in the reference; a
step is eager torch and its solves go through the offset-stencil SpMV.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..core.dimensions import DimensionSet
from ..core.fields import VolField
from ..ops import fvc, fvm, schemes as schemes_mod, slot as slot_mod, surface
from . import linear
from .buoyant import _sn_grad_slot
from .piso import _as_scalar, boundary_flux


class ShallowWaterConfig(NamedTuple):
    g: float = 9.81
    rotating: bool = False
    omega: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    n_outer: int = 1
    n_correctors: int = 2
    n_non_orth: int = 0
    div_scheme: str = "upwind"
    h_min: float = 1e-4
    h_controls: Dict = None
    hu_controls: Dict = None


def _ddt_corr(po, fo, rdt):
    """Euler ddtCorr: coeff * rdt * (phi_old - interp(hU_old).Sf) with the
    consistency damping coeff = 1 - min(|corr|/(|phi_old|+eps), 1)."""
    c = po - fo
    coeff = 1.0 - torch.clamp(torch.abs(c) / (torch.abs(po) + 1e-30),
                              max=1.0)
    return coeff * rdt * c


def shallowwater_step(mesh, state: Dict, dt: Any,
                      cfg: ShallowWaterConfig) -> Tuple[Dict, Dict]:
    h_ctrl = cfg.h_controls or {"solver": "PCG",
                                "preconditioner": "polynomial",
                                "tolerance": 1e-9, "relTol": 0.01,
                                "maxIter": 1000}
    hu_ctrl = cfg.hu_controls or {"solver": "PBiCGStab",
                                  "tolerance": 1e-8, "relTol": 0.1,
                                  "maxIter": 300}
    h: VolField = state["h"]
    hU: VolField = state["hU"]
    h0 = state["h0"]              # bed elevation [nC] (static)
    phi = state["phi"]            # hU flux
    nif = mesh.n_internal_faces
    has_fb = bool(mesh.fb_cells.shape[0])
    dt = _as_scalar(mesh, dt)
    rdt = 1.0 / dt
    gmag = cfg.g
    diag: Dict[str, Any] = {}
    h_old = state.get("h_prev", h.data)
    hU_old = state.get("hU_prev", hU.data)

    phi_slot = (slot_mod.SlotFace(*state["phi_slot"], bv=phi[nif:])
                if "phi_slot" in state else slot_mod.from_flat(mesh, phi))

    # Euler ddtCorr(h, hU, phi) (the reference's phiHbyA
    # `fvc::interpolate(rAU)*fvc::ddtCorr(h, hU, phi)`); the boundary
    # part takes hU_old extrapolated from the owner cells
    hba_old = slot_mod.flux_of(
        mesh, hU_old,
        bv=torch.einsum("fd,fd->f", mesh.sf[nif:],
                        surface.owner_to_b(mesh, hU_old))
        * mesh.face_active[nif:])
    ddt_corr = slot_mod.SlotFace(
        _ddt_corr(phi_slot.sv, hba_old.sv, rdt),
        _ddt_corr(phi_slot.fb, hba_old.fb, rdt) if has_fb else phi_slot.fb,
        _ddt_corr(phi_slot.bv, hba_old.bv, rdt))

    for outer in range(cfg.n_outer):
        # velocity flux phiv = phi / interp(h)
        hf = slot_mod.interpolate(mesh, h.data,
                                  bv=surface.owner_to_b(mesh, h.data))
        phiv = slot_mod.SlotFace(
            phi_slot.sv / torch.clamp(hf.sv, min=cfg.h_min),
            phi_slot.fb / torch.clamp(hf.fb, min=cfg.h_min)
            if has_fb else phi_slot.fb,
            phi_slot.bv / torch.clamp(hf.bv, min=cfg.h_min))
        phiv_flat = slot_mod.to_flat(mesh, phiv)

        w_slot = (None if cfg.div_scheme == "linear" else
                  schemes_mod.weights_slot(mesh, phiv, cfg.div_scheme, hU))
        hUEqn = (fvm.ddt(mesh, hU, hU_old, rdt)
                 + fvm.div(mesh, phiv_flat, hU, phi_slot=phiv,
                           slot_weights=w_slot))
        eta = fvc.grad_component(
            mesh, h.data + h0, surface.owner_to_b(mesh, h.data + h0))
        src = -gmag * h.data[:, None] * eta
        if cfg.rotating:
            F = 2.0 * torch.tensor(cfg.omega, dtype=mesh.v.dtype,
                                   device=mesh.device)
            src = src - torch.cross(torch.broadcast_to(F, hU.data.shape),
                                    hU.data, dim=1)
        Umat = hUEqn.add_source(src, mesh)
        hUdata, uperf = linear.solve(mesh, Umat, hU.data, hu_ctrl)
        hU = hU.with_data(hUdata)
        if outer == 0:
            diag["Ux"] = uperf

        # -- depth corrector ---------------------------------------------------
        rAU = 1.0 / hUEqn.A(mesh)
        hrAU = h.data * rAU
        ghrAUf_slot = slot_mod.interpolate(
            mesh, gmag * hrAU, bv=surface.owner_to_b(mesh, gmag * hrAU))
        sng_h0 = _sn_grad_slot(mesh, h0, surface.owner_to_b(mesh, h0))
        phih0 = slot_mod.SlotFace(
            ghrAUf_slot.sv * sng_h0.sv * mesh.st_magsf,
            (ghrAUf_slot.fb * sng_h0.fb * mesh.fb_magsf
             if has_fb else sng_h0.fb),
            ghrAUf_slot.bv * sng_h0.bv
            * mesh.mag_sf[nif:] * mesh.face_active[nif:])

        rAU_slot = slot_mod.interpolate(mesh, rAU,
                                        bv=surface.owner_to_b(mesh, rAU))
        for corr in range(cfg.n_correctors):
            HbyA = rAU[:, None] * hUEqn.H(mesh, hU.data)
            hba = slot_mod.flux_of(mesh, HbyA)
            phiHbyA_b = (boundary_flux(mesh, hU) - phih0.bv
                         + rAU_slot.bv * ddt_corr.bv)
            phiHbyA = slot_mod.SlotFace(
                hba.sv - phih0.sv + rAU_slot.sv * ddt_corr.sv,
                (hba.fb - phih0.fb + rAU_slot.fb * ddt_corr.fb)
                if has_fb else hba.fb - phih0.fb,
                phiHbyA_b)
            hEqn0 = fvm.laplacian(
                mesh, slot_mod.to_flat(mesh, ghrAUf_slot), h,
                corrected=False,
                gamma_dims=DimensionSet.of(0, 3, -1) / h.dims,
                gamma_slot=ghrAUf_slot)
            for nonorth in range(cfg.n_non_orth + 1):
                src_h = (hEqn0.source
                         + slot_mod.surface_sum(mesh, phiHbyA)
                         - mesh.v * rdt * h_old)
                hEqn = hEqn0.replace_fields(
                    diag=hEqn0.diag - mesh.v * rdt, source=src_h)
                hdata, hperf = linear.solve(mesh, hEqn, h.data, h_ctrl)
                h = h.with_data(torch.clamp(hdata, min=cfg.h_min))
                if outer == 0 and corr == 0 and nonorth == 0:
                    diag["p_initial"] = hperf.initial_residual
                    diag["p_iters"] = hperf.n_iterations
                diag["p_final"] = hperf.final_residual
                if nonorth == cfg.n_non_orth:
                    F_h = slot_mod.laplacian_flux(
                        mesh, ghrAUf_slot, h.data, corrected=False,
                        corr=None)
                    h_bc = surface.owner_to_b(mesh, h.data)
                    F_b = hEqn0.ic * h_bc - hEqn0.bc
                    phi_slot = slot_mod.SlotFace(
                        phiHbyA.sv - F_h.sv, phiHbyA.fb - F_h.fb,
                        phiHbyA_b - F_b)
            # hU = HbyA - rAU g h grad(h + h0)
            eta = fvc.grad_component(
                mesh, h.data + h0, surface.owner_to_b(mesh, h.data + h0))
            hU = hU.with_data(HbyA - (rAU * gmag * h.data)[:, None] * eta)
            hU = hU.correct_boundary_conditions(mesh)
    phi = slot_mod.to_flat(mesh, phi_slot)

    div_phi = slot_mod.surface_sum(mesh, phi_slot)
    cont = (h.data - h_old) * rdt + div_phi / mesh.v
    diag["continuity"] = (torch.sum(torch.abs(cont) * mesh.v)
                          / torch.sum(mesh.v))
    diag["h_range"] = (torch.min(h.data), torch.max(h.data))
    sum_phi = slot_mod.weighted_cell_sum(mesh, phi_slot, absolute=True)
    hmean = torch.clamp(h.data, min=cfg.h_min)
    diag["courant_max"] = 0.5 * torch.max(sum_phi / (hmean * mesh.v)) * dt

    U = hU.with_data(hU.data / torch.clamp(h.data, min=cfg.h_min)[:, None])
    new_state = dict(state)
    new_state.update(h=h, hU=hU, U=U, phi=phi,
                     phi_slot=(phi_slot.sv, phi_slot.fb),
                     h_prev=h.data, hU_prev=hU.data)
    return new_state, diag


def initial_state(mesh, h: VolField, hU: VolField, h0) -> Dict:
    phi = fvc.flux(mesh, hU)
    sl = slot_mod.from_flat(mesh, phi)
    return {"h": h, "hU": hU,
            "h0": torch.as_tensor(h0, dtype=mesh.v.dtype,
                                  device=mesh.device),
            "phi": phi, "phi_slot": (sl.sv, sl.fb),
            "h_prev": h.data, "hU_prev": hU.data}


def make_step(mesh, cfg: ShallowWaterConfig):
    """(state, dt) -> (state, diag) for one shallowWaterFoam step."""
    def step(state, dt):
        return shallowwater_step(mesh, state, dt, cfg)

    return step
