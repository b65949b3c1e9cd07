"""XiFoam / PDRFoam: premixed combustion with the Weller b-Xi
flame-wrinkling model (port of openfoam-2.2.x_tpu/solvers/xifoam.py:
`XiFoamConfig`, `xifoam_step`, `initial_state`, `make_step`; reference
applications/solvers/combustion/XiFoam/ bEqn.H, XiModels/algebraic,
SuModels/unstrained) on the rhoPimpleFoam step.

b is the regress variable (1 unburnt, 0 burnt):

  bEqn : ddt(rho, b) + div(phi, b) - laplacian(muEff, b)
         == -rho_u Su Xi |grad b|
  Xi   : the algebraic Gulder equilibrium wrinkling
         XiEq = 1 + (1 + 2 XiShapeCoef (0.5 - b)) XiEqCoef
                    sqrt(up/(Su + SuMin)) Reta,
         up = sqrt(2k/3), tauEta = sqrt(nu_u/eps), Reta = up/sqrt(eps tauEta)
  heat : the realised consumption rho db/dt releases q_comb [J/kg] into T
         at constant volume (p follows rho R T).

As in the reference, b is advanced after the pressure loop, the flame flux
rides the explicit |grad b| source, and ignition is an initial burnt
kernel (setFields). Su is the constant Su0 or a correlation of
models/flamespeed.py.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..core.dimensions import DimensionSet
from ..core.fields import VolField
from ..ops import fvc, fvm, schemes as schemes_mod, slot as slot_mod, surface
from . import linear
from .rhopimple import RhoPimpleConfig, _rho_ddt, rhopimple_step

_MASS_FLUX = DimensionSet.of(1, 0, -1)
_DYN_VISC = DimensionSet.of(1, -1, -1)


class XiFoamConfig(NamedTuple):
    flow: RhoPimpleConfig
    Su0: float = 0.4           # unstrained laminar flame speed [m/s]
    SuMin: float = 0.01
    XiEqCoef: float = 0.62     # Gulder coefficient (reference default)
    XiShapeCoef: float = 1.0
    q_comb: float = 2.0e6      # heat of combustion per kg mixture [J/kg]
    Tu: float = 300.0          # unburnt temperature (rho_u = p/(R Tu))
    b_controls: Dict = None
    su_fn: Optional[Callable[[Any, Any], Any]] = None   # Su(p, Tu)


def xifoam_step(mesh, state: Dict, dt: Any, cfg: XiFoamConfig
                ) -> Tuple[Dict, Dict]:
    th = cfg.flow.thermo
    b_ctrl = cfg.b_controls or {"solver": "PBiCGStab",
                                "tolerance": 1e-8, "relTol": 0.05,
                                "maxIter": 300}
    nif = mesh.n_internal_faces
    rdt = 1.0 / dt

    # -- 1. flow (rhoPimpleFoam step) ----------------------------------------
    state, diag = rhopimple_step(mesh, state, dt, cfg.flow)
    T: VolField = state["T"]
    p: VolField = state["p"]
    phi = state["phi"]
    rho = state["rho0"] if not cfg.flow.steady else torch.clamp(
        th.rho(p.data, T.data), min=cfg.flow.rho_min)
    rho0 = state.get("rho_prev", rho)

    # -- 2. wrinkling Xi (algebraic Gulder) ----------------------------------
    b: VolField = state["b"]
    b0 = state.get("b0", b.data)
    Su = cfg.su_fn(p.data, cfg.Tu) if cfg.su_fn is not None else cfg.Su0
    tstate = state.get("turb")
    if tstate and "k" in tstate:
        k = tstate["k"].data
        if "epsilon" in tstate:
            eps = tstate["epsilon"].data
        else:
            eps = 0.09 * k * tstate["omega"].data
        up = torch.sqrt(2.0 / 3.0 * torch.clamp(k, min=0.0))
        nu_u = th.mu / torch.clamp(rho, min=cfg.flow.rho_min)
        tau_eta = torch.sqrt(nu_u / torch.clamp(eps, min=1e-12))
        reta = up / torch.clamp(torch.sqrt(eps * tau_eta), min=1e-8)
        shape = 1.0 + 2.0 * cfg.XiShapeCoef * (0.5 - b.data)
        Xi = 1.0 + shape * cfg.XiEqCoef * torch.sqrt(
            up / (Su + cfg.SuMin)) * reta
        Xi = torch.clamp(Xi, 1.0, 100.0)
    else:
        Xi = torch.ones_like(b.data)

    # -- 3. bEqn -------------------------------------------------------------
    phi_slot = slot_mod.SlotFace(*state["phi_slot"], bv=phi[nif:])
    mu = (th.mu_T(T.data) if th.sutherland_As > 0 else
          torch.full((mesh.n_cells,), th.mu, dtype=mesh.v.dtype,
                     device=mesh.device))
    nut = (cfg.flow.turb.nut(mesh, tstate)
           if cfg.flow.turb is not None and tstate else
           torch.zeros_like(mu))
    mu_eff = mu + rho * nut
    m_slot = slot_mod.interpolate(mesh, mu_eff,
                                  bv=surface.owner_to_b(mesh, mu_eff))
    w_slot = schemes_mod.weights_slot(mesh, phi_slot, "upwind", b)
    # unburnt density at the CURRENT pressure (rhou())
    rho_u = torch.clamp(p.data / (th.R * cfg.Tu), min=cfg.flow.rho_min)
    mgb = torch.linalg.norm(fvc.grad(mesh, b), dim=1)     # |grad b|
    Sb = rho_u * Su * Xi * mgb                            # [kg/m^3/s]
    bEqn = (_rho_ddt(mesh, b, rho, rho0, b0, rdt)
            + fvm.div(mesh, phi, b, phi_slot=phi_slot,
                      slot_weights=w_slot, phi_dims=_MASS_FLUX)
            - fvm.laplacian(mesh, slot_mod.to_flat(mesh, m_slot), b,
                            corrected=False, gamma_dims=_DYN_VISC,
                            gamma_slot=m_slot))
    bEqn = bEqn.add_source(-Sb, mesh)
    bdata, bperf = linear.solve(mesh, bEqn, b.data, b_ctrl)
    bdata = torch.clamp(bdata, 0.0, 1.0)
    diag["b"] = bperf

    # -- 4. heat release (constant-volume split, as reactingFoam) ------------
    db = torch.clamp(bdata - b.data, max=0.0)
    q = -rho * db * rdt * cfg.q_comb                      # J/m^3/s
    cp = th.Cp_of(T.data)
    T = T.with_data(T.data + dt * q / (torch.clamp(rho, min=cfg.flow.rho_min)
                                       * cp))
    T = T.correct_boundary_conditions(mesh)
    b = b.with_data(bdata).correct_boundary_conditions(mesh)
    diag["Qdot_max"] = torch.max(q)
    diag["Xi_max"] = torch.max(Xi)
    diag["b_min"] = torch.min(bdata)

    new_state = dict(state)
    new_state.update(T=T, b=b, b0=bdata, Xi=Xi, rho_prev=rho)
    if not cfg.flow.steady:
        p_new = rho * th.R * T.data
        new_state["p"] = state["p"].with_data(p_new)
        new_state["p0"] = p_new
        new_state["T0"] = T.data
    return new_state, diag


def initial_state(mesh, U, p, T, b: VolField, thermo,
                  turb_state=None) -> Dict:
    from .rhopimple import initial_state as rp_init

    st = rp_init(mesh, U, p, T, thermo, turb_state=turb_state)
    st["b"] = b
    st["b0"] = b.data
    st["Xi"] = torch.ones_like(b.data)
    return st


def make_step(mesh, cfg: XiFoamConfig):
    """(state, dt) -> (state, diag) for one time step."""
    def step(state, dt):
        return xifoam_step(mesh, state, dt, cfg)

    return step
