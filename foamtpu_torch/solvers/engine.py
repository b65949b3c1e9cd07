"""engineFoam / coldEngineFoam / sonicDyMFoam: compressible flow on a
moving mesh (port of openfoam-2.2.x_tpu/solvers/engine.py: `EngineConfig`,
`_ale_ddt`, `engine_step`, `initial_state`, `make_step`;
applications/solvers/combustion/{engineFoam,coldEngineFoam}/ with
src/engine/, and compressible/sonicFoam/sonicDyMFoam/).

Times are crank-angle degrees (engineTime); the mesh moves by
mesh/engine.py's piston motion, or by a solid-body motion for
sonicDyMFoam, rebuilt on the device every step (mesh/moving.py).

Compressible PISO in ALE form. With V (new) and V0 (old) cell volumes and
phi the RELATIVE mass flux rho_f (U_f - U_mesh).Sf:

  mass  : (V rho - V0 rho0)/dt + div(phi) = 0
  UEqn  : (V rho U - V0 rho0 U0)/dt + div(phi,U) - laplacian(mu,U)
          == -V grad(p)
  TEqn  : (V rho T - V0 rho0 T0)/dt + div(phi,T) - laplacian(alpha,T)
          == V (dp/dt - dK/dt - div(phi K))/Cp
  pEqn  : V psi/dt p' + div(phiHbyA_rel) - laplacian(rho rAU, p')
          == -(V rho* - V0 rho0 - V psi p'_lin)/dt

on the pressure shifted by pRefValue (p' = p - pOp, as solvers/rhopimple.py
does for float32). The compression work enters through dp/dt, so a closed
adiabatic cylinder follows p V^gamma = const. `transonic` (sonicDyMFoam)
carries the convective mass flux implicitly as div(phid, p), a
non-symmetric pressure matrix. engineFoam adds the b-Xi heat release with
a fixed Xi after the flow step, ignited at a spark crank angle (by the
application, solvers/apps.py). sprayEngineFoam (`SprayConfig`) evolves
an injected evaporating cloud inside the step on the moved geometry; its
drag momentum and latent heat enter the NEXT step's UEqn and TEqn through
the state's `mom_src` and `q_src` (explicit, lagged), and its vapour is
carried explicitly as Yv. Every solve goes through linear.solve, so the
SpMV kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..bc import patchfields as pf
from ..core.dimensions import DimensionSet, dimTime
from ..core.fields import VolField
from ..mesh import moving
from ..ops import fvc, fvm, schemes as schemes_mod, slot as slot_mod, surface
from ..ops.matrix import FvMatrix, zero_matrix
from . import linear
from .piso import boundary_flux

_MASS_FLUX = DimensionSet.of(1, 0, -1)
_DYN_VISC = DimensionSet.of(1, -1, -1)
_SP = DimensionSet.of(1, -3, -1)
# the patch types whose relative flux is identically zero
_WALL_TYPES = ("wall", "empty", "symmetry", "symmetryPlane", "wedge")


class SprayConfig(NamedTuple):
    """sprayEngineFoam (applications/solvers/lagrangian/sprayFoam/
    sprayEngineFoam/): the spray cloud of lagrangian/ on the engine mesh."""
    lcfg: Any                    # lagrangian CloudConfig
    ecfg: Any                    # reactingcloud EvapConfig
    bcfg: Any                    # reactingcloud BreakupConfig
    inj: Any = None              # InjectionConfig or None
    bt: Any = None               # [nF] face boundary types (a tensor)


class EngineConfig(NamedTuple):
    thermo: Any
    pts_fn: Callable             # (points0, t_seconds) -> points
    umesh_fn: Callable           # (x, t_seconds) -> mesh velocity
    s_per_cad: float             # seconds per crank-angle degree
    n_correctors: int = 2
    n_non_orth: int = 0
    div_scheme: str = "upwind"
    p_ref_value: float = 1e5
    p_min: float = 1e3
    rho_min: float = 0.01
    # sonicDyMFoam: the implicit div(phid, p) convective mass flux
    transonic: bool = False
    spray: Optional[SprayConfig] = None
    # combustion (engineFoam; Su0 <= 0 disables it: coldEngineFoam)
    Su0: float = 0.0
    Xi: float = 2.0              # fixed wrinkling (no turbulence model)
    q_comb: float = 2.0e6
    Tu: float = 300.0
    p_controls: Dict = None
    u_controls: Dict = None


def _ale_ddt(mesh_t, field: VolField, v0, rho, rho0, old, rdt
             ) -> FvMatrix:
    """ALE Euler fvm::ddt(rho, psi): diag = V rho/dt, src = V0 rho0 old/dt
    (the space-conservation form)."""
    n = 1 if field.data.ndim == 1 else field.data.shape[1]
    m = zero_matrix(mesh_t, n, dims=field.dims * DimensionSet.of(1, 0, -1))
    vr = mesh_t.v * rho * rdt
    vr0 = v0 * rho0 * rdt
    src = (vr0[:, None] if field.data.ndim == 2 else vr0) * old
    return m.replace_fields(diag=vr, source=src)


def wall_mask(mesh) -> torch.Tensor:
    """[nBf] bool: the boundary faces of wall, empty and symmetry-type
    patches, whose relative flux is held at zero."""
    nif = mesh.n_internal_faces
    wall = torch.zeros(mesh.n_faces - nif, dtype=torch.bool,
                       device=mesh.device)
    for pch in mesh.patches:
        if pch.type in _WALL_TYPES:
            wall[pch.slice.start - nif:pch.slice.stop - nif] = True
    return wall


def engine_step(mesh, state: Dict, dt_cad: Any, cfg: EngineConfig,
                wall_b: Optional[torch.Tensor] = None
                ) -> Tuple[Dict, Dict]:
    """One step of dt_cad crank-angle degrees (seconds when s_per_cad is
    1). wall_b: wall_mask(mesh), made here when not given."""
    th = cfg.thermo
    p_ctrl = cfg.p_controls or {"solver": "PCG",
                                "preconditioner": "polynomial",
                                "tolerance": 1e-8, "relTol": 0.01,
                                "maxIter": 1000}
    if cfg.transonic:
        # the implicit div(phid, p) makes the matrix non-symmetric
        p_ctrl = dict(p_ctrl)
        if str(p_ctrl.get("solver", "PCG")) in ("PCG", "GAMG"):
            p_ctrl["solver"] = "PBiCGStab"
            p_ctrl.setdefault("preconditioner", "polynomial")
        p_ctrl.pop("_prep", None)
    u_ctrl = cfg.u_controls or {"solver": "PBiCGStab",
                                "tolerance": 1e-7, "relTol": 0.1,
                                "maxIter": 300}
    U: VolField = state["U"]
    p: VolField = state["p"]
    T: VolField = state["T"]
    diag: Dict[str, Any] = {}
    dtype, dev = mesh.v.dtype, mesh.device

    dt = torch.as_tensor(dt_cad, dtype=dtype, device=dev) * cfg.s_per_cad
    rdt = 1.0 / dt
    t = state["t"] + dt                  # seconds since the start

    # -- mesh.update() ------------------------------------------------------
    points = cfg.pts_fn(state["points0"], t)
    mesh_t = moving.update_geometry(mesh, points, state["topo"])
    mesh_phi = moving.mesh_flux(mesh_t, cfg.umesh_fn, t) * mesh_t.face_active
    v0 = state["v0"]
    # the relative flux through wall faces is zero (the fluid rides the
    # wall, movingWallVelocity's U_b == U_mesh, held on the flux itself so
    # that a plain fixedValue wall cannot leak mass through the piston)
    wall_b = wall_mask(mesh_t) if wall_b is None else wall_b

    rho0 = state["rho0"]
    U0, T0, p0 = state["U0"], state["T0"], state["p0"]
    K0 = 0.5 * torch.sum(U0 * U0, dim=1)
    phi = state["phi"]                   # the relative MASS flux
    phi_slot = slot_mod.from_flat(mesh_t, phi)

    rho = torch.clamp(th.rho(p.data, T.data), min=cfg.rho_min)
    psi = th.psi(T.data)
    mu = torch.full((mesh_t.n_cells,), th.mu, dtype=dtype, device=dev)
    rho_b = surface.owner_to_b(mesh_t, rho)
    rho_slot = slot_mod.interpolate(mesh_t, rho, bv=rho_b)
    mp_slot = slot_mod.from_flat(mesh_t, mesh_phi)

    # the mass-imbalance Sp correction (fvm::ddt(rho,Q) + fvm::div(phi,Q)
    # - fvm::Sp(fvc::ddt(rho) + fvc::div(phi), Q)): rho lags the in-step
    # volume change by one solve, and without it the transported
    # quantities gain the step's compression ratio every step
    mass_imb = ((mesh_t.v * rho - v0 * rho0) * rdt
                + slot_mod.surface_sum(mesh_t, phi_slot)) / mesh_t.v

    # -- momentum -----------------------------------------------------------
    w_slot = (None if cfg.div_scheme == "linear" else
              schemes_mod.weights_slot(mesh_t, phi_slot, cfg.div_scheme, U))
    mu_slot = slot_mod.interpolate(mesh_t, mu,
                                   bv=surface.owner_to_b(mesh_t, mu))
    UEqn = (_ale_ddt(mesh_t, U, v0, rho, rho0, U0, rdt)
            + fvm.div(mesh_t, phi, U, phi_slot=phi_slot,
                      slot_weights=w_slot, phi_dims=_MASS_FLUX)
            - fvm.laplacian(mesh_t, slot_mod.to_flat(mesh_t, mu_slot), U,
                            corrected=False, gamma_dims=_DYN_VISC,
                            gamma_slot=mu_slot)
            - fvm.Sp(mesh_t, mass_imb, U, sp_dims=_SP))
    # the spray's two-way coupling: its momentum source density [N/m^3]
    # lives inside UEqn, so it also enters H in the pressure corrector
    if "mom_src" in state:
        UEqn = UEqn.add_source(state["mom_src"], mesh_t)
    grad_p = fvc.grad_of(mesh_t, p, "Gauss linear")
    Udata, uperf = linear.solve(mesh_t, UEqn.add_source(-grad_p, mesh_t),
                                U.data, u_ctrl)
    U = U.with_data(Udata)
    diag["Ux"] = uperf

    # -- pressure (shifted p', see rhopimple.py) -----------------------------
    p_op = cfg.p_ref_value
    p_w = dataclasses.replace(p, data=p.data - p_op,
                              bcs=pf.shift_value_bcs(p.bcs, -p_op))
    rA = 1.0 / UEqn.A(mesh_t)
    rhorA = rho * rA
    rra_slot = slot_mod.interpolate(mesh_t, rhorA,
                                    bv=surface.owner_to_b(mesh_t, rhorA))
    pEqn0 = fvm.laplacian(mesh_t, slot_mod.to_flat(mesh_t, rra_slot), p_w,
                          corrected=False, gamma_dims=dimTime,
                          gamma_slot=rra_slot)
    p_ctrl_p = linear.prepare_controls(mesh_t, pEqn0, p_ctrl)
    p_lin = p_w.data

    for corr in range(cfg.n_correctors):
        HbyA = rA[:, None] * UEqn.H(mesh_t, U.data)
        hba = slot_mod.flux_of(mesh_t, HbyA, bv=boundary_flux(mesh_t, U))
        # makeRelative before the mass weighting (engineFoam's pEqn:
        # fvc::makeRelative(phiHbyA, rho, U))
        hba_rel = slot_mod.SlotFace(
            hba.sv - mp_slot.sv, hba.fb - mp_slot.fb,
            torch.where(wall_b, torch.zeros_like(hba.bv),
                        hba.bv - mp_slot.bv))
        phiHbyA = slot_mod.SlotFace(rho_slot.sv * hba_rel.sv,
                                    rho_slot.fb * hba_rel.fb,
                                    surface.owner_to_b(mesh_t, rho)
                                    * hba_rel.bv)
        ddt_diag = mesh_t.v * psi * rdt
        src = (pEqn0.source + slot_mod.surface_sum(mesh_t, phiHbyA)
               + rdt * (mesh_t.v * rho - v0 * rho0
                        - mesh_t.v * psi * p_lin))
        pEqn = pEqn0.replace_fields(diag=pEqn0.diag - ddt_diag, source=src)
        if cfg.transonic:
            # sonicDyMFoam: the convective mass flux implicit as
            # div(phid, p), phid = psi_f (HbyA_rel . Sf) (sonicDyMFoam's
            # pEqn.H transonic branch on the relative flux); the explicit
            # div(phiHbyA) leaves the source and the p_op shift moves to
            # the right-hand side
            psi_b = surface.owner_to_b(mesh_t, psi)
            psi_slot = slot_mod.interpolate(mesh_t, psi, bv=psi_b)
            phid = slot_mod.SlotFace(psi_slot.sv * hba_rel.sv,
                                     psi_slot.fb * hba_rel.fb,
                                     psi_b * hba_rel.bv)
            wp = schemes_mod.weights_slot(mesh_t, phid, "upwind", p_w)
            conv = fvm.div(mesh_t, slot_mod.to_flat(mesh_t, phid), p_w,
                           phi_slot=phid, slot_weights=wp,
                           phi_dims=pEqn0.dims / p_w.dims)
            pEqn = (pEqn - conv).replace_fields(
                source=pEqn.source - conv.source
                + cfg.p_ref_value * slot_mod.surface_sum(mesh_t, phid)
                - slot_mod.surface_sum(mesh_t, phiHbyA),
                symmetric=False)
        pdata, pperf = linear.solve(mesh_t, pEqn, p_w.data, p_ctrl_p)
        p_w = p_w.with_data(torch.clamp(pdata, min=cfg.p_min - p_op))
        if corr == 0:
            diag["p_initial"] = pperf.initial_residual
            diag["p_iters"] = pperf.n_iterations
        diag["p_final"] = pperf.final_residual
        F = slot_mod.laplacian_flux(mesh_t, rra_slot, p_w.data,
                                    corrected=False, corr=None)
        F_b = pEqn0.ic * surface.owner_to_b(mesh_t, p_w.data) - pEqn0.bc
        if cfg.transonic:
            # the mass flux the implicit convection carries
            nbp = slot_mod.nbr_values(mesh_t, p_w.data)
            p_up = (wp[0] * p_w.data[:, None] + (1.0 - wp[0]) * nbp
                    + cfg.p_ref_value)
            conv_sv = phid.sv * p_up
            if mesh_t.fb_cells.shape[0]:
                pfb = (wp[1] * p_w.data[mesh_t.fb_cells]
                       + (1.0 - wp[1]) * p_w.data[mesh_t.fb_nbrs]
                       + cfg.p_ref_value)
                conv_fb = phid.fb * pfb
            else:
                conv_fb = phid.fb
            conv_bv = phid.bv * (p_w.boundary_values(mesh_t)
                                 + cfg.p_ref_value)
            phi_slot = slot_mod.SlotFace(conv_sv - F.sv, conv_fb - F.fb,
                                         conv_bv - F_b)
        else:
            phi_slot = slot_mod.SlotFace(phiHbyA.sv - F.sv,
                                         phiHbyA.fb - F.fb,
                                         phiHbyA.bv - F_b)
        grad_p = fvc.grad_of(mesh_t, p_w, "Gauss linear")
        U = U.with_data(HbyA - rA[:, None] * grad_p)
        U = U.correct_boundary_conditions(mesh_t)
    p = p.with_data(p_w.data + p_op)
    phi = slot_mod.to_flat(mesh_t, phi_slot)
    rho_star = torch.clamp(th.rho(p.data, T.data), min=cfg.rho_min)

    # -- energy, after the pressure solve (dp/dt with the fresh p is the
    # compression work; solving T first would see dp/dt = 0 with one outer
    # iteration and lose the heating) -----------------------------------------
    K = 0.5 * torch.sum(U.data * U.data, dim=1)
    alpha = mu / th.Pr
    a_slot = slot_mod.interpolate(mesh_t, alpha,
                                  bv=surface.owner_to_b(mesh_t, alpha))
    imb_T = ((mesh_t.v * rho_star - v0 * rho0) * rdt
             + slot_mod.surface_sum(mesh_t, phi_slot)) / mesh_t.v
    wT_slot = (None if cfg.div_scheme == "linear" else
               schemes_mod.weights_slot(mesh_t, phi_slot, cfg.div_scheme,
                                        T))
    TEqn = (_ale_ddt(mesh_t, T, v0, rho_star, rho0, T0, rdt)
            + fvm.div(mesh_t, phi, T, phi_slot=phi_slot,
                      slot_weights=wT_slot, phi_dims=_MASS_FLUX)
            - fvm.laplacian(mesh_t, slot_mod.to_flat(mesh_t, a_slot), T,
                            corrected=False, gamma_dims=_DYN_VISC,
                            gamma_slot=a_slot)
            - fvm.Sp(mesh_t, imb_T, T, sp_dims=_SP))
    dKdt = (mesh_t.v * rho_star * K - v0 * rho0 * K0) * rdt / mesh_t.v
    Kb = surface.owner_to_b(mesh_t, K)
    K_slot = slot_mod.interpolate(mesh_t, K, bv=Kb)
    div_phiK = slot_mod.surface_sum(
        mesh_t, slot_mod.SlotFace(phi_slot.sv * K_slot.sv,
                                  phi_slot.fb * K_slot.fb,
                                  phi_slot.bv * Kb)) / mesh_t.v
    # dp/dt differences the SOLVED p sequence (p_solved0 is the last
    # step's pEqn solution before the re-equilibration), so that its
    # telescoped sum is the whole pressure rise, the rho R dT
    # re-equilibration included
    dpdt = (p.data - state.get("p_solved0", p0)) * rdt
    cp_c = th.Cp_of(T.data)
    TEqn = TEqn.add_source((dpdt - dKdt - div_phiK) / cp_c, mesh_t)
    if "q_src" in state:
        # the parcels' heat exchange [W/m^3] (the latent sink)
        TEqn = TEqn.add_source(state["q_src"] / cp_c, mesh_t)
    Tdata, tperf = linear.solve(mesh_t, TEqn, T.data, u_ctrl)
    T = T.with_data(torch.clamp(Tdata, min=1.0))
    T = T.correct_boundary_conditions(mesh_t)
    diag["T"] = tperf
    p_solved = p.data
    # constant-volume re-equilibration: the pressure solve conserved mass
    # with psi(T_old); keep that density and move p to the new temperature
    # (p = rho R T_new, as xifoam after its heat release)
    rho_cons = torch.clamp(psi * p.data, min=cfg.rho_min)
    p = p.with_data(rho_cons * th.R * T.data)
    rho_star = rho_cons

    # -- combustion (engineFoam: b-Xi with a fixed Xi) -----------------------
    if cfg.Su0 > 0.0:
        b: VolField = state["b"]
        b0 = state["b0"]
        rho_u = torch.clamp(p.data / (th.R * cfg.Tu), min=cfg.rho_min)
        mgb = torch.linalg.norm(fvc.grad(mesh_t, b), dim=1)
        Sb = rho_u * cfg.Su0 * cfg.Xi * mgb
        wb = schemes_mod.weights_slot(mesh_t, phi_slot, "upwind", b)
        bEqn = (_ale_ddt(mesh_t, b, v0, rho_star, rho0, b0, rdt)
                + fvm.div(mesh_t, phi, b, phi_slot=phi_slot,
                          slot_weights=wb, phi_dims=_MASS_FLUX)
                - fvm.laplacian(mesh_t, slot_mod.to_flat(mesh_t, mu_slot),
                                b, corrected=False, gamma_dims=_DYN_VISC,
                                gamma_slot=mu_slot)
                - fvm.Sp(mesh_t, mass_imb, b, sp_dims=_SP))
        bEqn = bEqn.add_source(-Sb, mesh_t)
        bdata, bperf = linear.solve(mesh_t, bEqn, b.data, u_ctrl)
        bdata = torch.clamp(bdata, 0.0, 1.0)
        db = torch.clamp(bdata - b.data, max=0.0)
        q = -rho_star * db * rdt * cfg.q_comb
        T = T.with_data(T.data + dt * q / (rho_star * th.Cp_of(T.data)))
        T = T.correct_boundary_conditions(mesh_t)
        state = dict(state)
        state["b"] = b.with_data(bdata).correct_boundary_conditions(mesh_t)
        state["b0"] = bdata
        diag["b_min"] = torch.min(bdata)
        rho_star = torch.clamp(th.rho(p.data, T.data), min=cfg.rho_min)

    # -- the spray cloud (sprayEngineFoam) -----------------------------------
    if cfg.spray is not None:
        state = _spray_step(mesh_t, state, cfg.spray, U, T, dt, v0,
                            phi_slot, rho_star, diag)

    # diagnostics: the ALE continuity
    div_phi = slot_mod.surface_sum(mesh_t, phi_slot)
    cont = ((mesh_t.v * rho_star - v0 * rho0) * rdt + div_phi) / mesh_t.v
    diag["continuity"] = (torch.sum(torch.abs(cont) * mesh_t.v)
                          / torch.sum(mesh_t.v))
    diag["mass"] = torch.sum(rho_star * mesh_t.v)
    diag["p_mean"] = torch.sum(p.data * mesh_t.v) / torch.sum(mesh_t.v)
    diag["T_mean"] = torch.sum(T.data * mesh_t.v) / torch.sum(mesh_t.v)
    diag["V_total"] = torch.sum(mesh_t.v)

    new_state = dict(state)
    new_state.update(U=U, p=p, T=T, phi=phi, t=t, v0=mesh_t.v,
                     U0=U.data, T0=T.data, p0=p.data,
                     p_solved0=p_solved, rho0=rho_star)
    return new_state, diag


def _spray_step(mesh_t, state, sp: SprayConfig, U, T, dt, v0, phi_slot,
                rho_star, diag) -> Dict:
    """Inject, evolve, break up and evaporate the cloud on the current
    (moved) geometry; the sources it leaves act in the next step."""
    from .. import lagrangian as lag
    from ..lagrangian import reactingcloud as rcloud

    carry, counter = state["inj_carry"], state["inj_counter"]
    c0 = state["cloud"]
    if sp.inj is not None:
        c0, carry, counter = lag.inject(c0, sp.inj, carry, counter, dt)
    c1 = lag.evolve(mesh_t, c0, U.data, dt, sp.bt, sp.lcfg, T_cell=T.data)
    c1 = rcloud.reitz_diwakar_breakup(c1, U.data, dt, sp.bcfg)
    mom = lag.momentum_source(mesh_t, c0, c1, 1.0, dt, sp.lcfg)
    c1, vap, hsink = rcloud.evaporate(c1, U.data, T.data, dt, sp.lcfg,
                                      sp.ecfg, mesh_t.n_cells)
    # the next step's sources (gravity does not react back:
    # momentum_source takes it off)
    mom_src = mom / mesh_t.v[:, None]          # N/m^3
    q_src = -hsink / mesh_t.v                  # W/m^3 (latent sink)
    # the fuel-vapour fraction: explicit upwind advection by the relative
    # mass flux and the evaporation source, conservative against the ALE
    # density update
    Yv = state["Yv"]
    nbY = slot_mod.nbr_values(mesh_t, Yv)
    up_sv = torch.where(phi_slot.sv >= 0.0, Yv[:, None], nbY)
    if mesh_t.fb_cells.shape[0]:
        up_fb = torch.where(phi_slot.fb >= 0.0, Yv[mesh_t.fb_cells],
                            Yv[mesh_t.fb_nbrs])
    else:
        up_fb = phi_slot.fb
    divY = slot_mod.surface_sum(
        mesh_t, slot_mod.SlotFace(phi_slot.sv * up_sv, phi_slot.fb * up_fb,
                                  phi_slot.bv
                                  * surface.owner_to_b(mesh_t, Yv)))
    Yv = torch.clamp((state["rho0"] * v0 * Yv - dt * divY + vap)
                     / torch.clamp(rho_star * mesh_t.v, min=1e-30),
                     0.0, 1.0)
    state = dict(state)
    state.update(cloud=c1, inj_carry=carry, inj_counter=counter,
                 mom_src=mom_src, q_src=q_src, Yv=Yv)
    diag["n_parcels"] = torch.sum(c1.active.to(torch.int64))
    diag["Yv_mean"] = (torch.sum(Yv * rho_star * mesh_t.v)
                       / torch.sum(rho_star * mesh_t.v))
    return state


def initial_state(pm, mesh, U: VolField, p: VolField, T: VolField,
                  thermo, cfg: EngineConfig,
                  b: Optional[VolField] = None, cloud: Any = None) -> Dict:
    """pm: the host PolyMesh. The initial relative flux from U and the
    mesh velocity at t = 0."""
    dtype, dev = mesh.v.dtype, mesh.device
    topo = moving.topo_from_poly(pm, dtype, dev)
    rho = thermo.rho(p.data, T.data)
    rho_b = surface.owner_to_b(mesh, rho)
    rho_slot = slot_mod.interpolate(mesh, rho, bv=rho_b)
    uf = slot_mod.flux_of(mesh, U.data, bv=boundary_flux(mesh, U))
    zero = torch.zeros((), dtype=dtype, device=dev)
    mp = moving.mesh_flux(mesh, cfg.umesh_fn, zero) * mesh.face_active
    mp_slot = slot_mod.from_flat(mesh, mp)
    phi_sl = slot_mod.SlotFace(rho_slot.sv * (uf.sv - mp_slot.sv),
                               rho_slot.fb * (uf.fb - mp_slot.fb),
                               rho_b * (uf.bv - mp_slot.bv))
    st = {"U": U, "p": p, "T": T, "phi": slot_mod.to_flat(mesh, phi_sl),
          "points0": torch.tensor(pm.points, dtype=dtype, device=dev),
          "topo": topo, "t": zero, "v0": mesh.v, "U0": U.data,
          "T0": T.data, "p0": p.data, "p_solved0": p.data, "rho0": rho}
    if b is not None:
        st["b"] = b
        st["b0"] = b.data
    if cfg.spray is not None:
        if cloud is None:
            raise ValueError("EngineConfig.spray set but no cloud passed "
                             "to initial_state")
        st.update(cloud=cloud, inj_carry=zero,
                  inj_counter=torch.zeros((), dtype=torch.int64, device=dev),
                  mom_src=torch.zeros((mesh.n_cells, 3), dtype=dtype,
                                      device=dev),
                  q_src=torch.zeros(mesh.n_cells, dtype=dtype, device=dev),
                  Yv=torch.zeros(mesh.n_cells, dtype=dtype, device=dev))
    return st


def make_step(mesh, cfg: EngineConfig):
    """(state, dt_cad) -> (state, diag) for one engine step."""
    wall_b = wall_mask(mesh)

    def step(state, dt):
        return engine_step(mesh, state, dt, cfg, wall_b)

    return step
