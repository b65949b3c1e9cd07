"""reactingFoam / rhoReactingFoam: compressible reacting flow with
finite-rate chemistry (port of openfoam-2.2.x_tpu/solvers/reacting.py:
`ReactingConfig` with `mixture_RCp`, `reacting_step`, `initial_state`,
`seed_mixture_state`, `make_step`; reference applications/solvers/
combustion/reactingFoam/ YEqn.H, EEqn.H and chemistryModel::solve).

Operator split per time step:
  1. flow: the rhoPimpleFoam step (solvers/rhopimple.py);
  2. species: ddt(rho, Yi) + div(phi, Yi) - laplacian(mu/Sc, Yi) for all
     nS species at once, Y one [nC, nS] field solved multi-RHS (one
     Krylov loop, the SpMV's column instance);
  3. chemistry: the combustion closure (models/combustion.py) or the
     laminar batched Rosenbrock integration (models/chemistry.py), the
     heat release into T at constant volume (p follows rho R T).
Y is renormalised to sum 1 after the reaction. With the per-species janaf
tables (reactingMixture) the step carries per-cell R_mix and cp_mix,
which the flow step's EOS honours.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..core.dimensions import DimensionSet
from ..core.fields import VolField
from ..ops import fvm, schemes as schemes_mod, slot as slot_mod, surface
from . import linear
from .rhopimple import RhoPimpleConfig, _rho_ddt, rhopimple_step

R_UNIV = 8314.47
_MASS_FLUX = DimensionSet.of(1, 0, -1)
_DYN_VISC = DimensionSet.of(1, -1, -1)
Y_CONTROLS = {"solver": "PBiCGStab", "tolerance": 1e-8, "relTol": 0.05,
               "maxIter": 300}


class ReactingConfig(NamedTuple):
    flow: RhoPimpleConfig        # the underlying compressible config
    chem: Any                    # models/chemistry.ChemistryModel
    W: Any                       # [nS] molecular weights [kg/kmol]
    Sc: float = 0.7              # Schmidt number of species diffusion
    chem_rtol: float = 1e-4
    y_controls: Dict = None
    combustion: Any = None       # models/combustion.Combustion, or None:
                                 # laminar direct integration
    # reactingMixture thermo: per-species janaf tables -> R_mix(Y) and
    # cp_mix(Y, T) per cell
    cp_lo: Any = None            # [nS, 7] low-T janaf coefficients
    cp_hi: Any = None            # [nS, 7]
    t_common: Any = None         # [nS]

    def mixture_RCp(self, Y, T):
        """(R_mix [nC], cp_mix [nC] or None) from mass fractions
        (multiComponentMixture::cellMixture)."""
        Wv = torch.as_tensor(self.W, dtype=Y.dtype, device=Y.device)
        R_mix = R_UNIV * torch.sum(Y / Wv[None, :], dim=1)
        if self.cp_lo is None:
            return R_mix, None
        lo = torch.as_tensor(self.cp_lo, dtype=Y.dtype, device=Y.device)
        hi = torch.as_tensor(self.cp_hi, dtype=Y.dtype, device=Y.device)
        tc = torch.as_tensor(self.t_common, dtype=Y.dtype, device=Y.device)
        Tc = torch.clamp(T, 200.0, 5000.0)
        a = torch.where((Tc[:, None] < tc[None, :])[:, :, None],
                        lo[None, :, :], hi[None, :, :])   # [nC, nS, 7]
        t = Tc[:, None]
        poly = (a[..., 0] + t * (a[..., 1] + t * (a[..., 2] + t * (
            a[..., 3] + t * a[..., 4]))))                 # Cp_i/R
        cp_i = poly * R_UNIV / Wv[None, :]                # J/kg/K
        cp_mix = torch.sum(Y * cp_i, dim=1)
        return R_mix, cp_mix


def species_eqn(mesh, state, Y: VolField, rho, rho0, rdt, mu, Sc):
    """ddt(rho, Y) + div(phi, Y) - laplacian(mu/Sc, Y) on the [nC, nS]
    field, upwind: one matrix for every species."""
    nif = mesh.n_internal_faces
    phi = state["phi"]
    Y0 = state.get("Y0", Y.data)
    phi_slot = slot_mod.SlotFace(*state["phi_slot"], bv=phi[nif:])
    gamma = mu / Sc                   # rho D
    g_slot = slot_mod.interpolate(mesh, gamma,
                                  bv=surface.owner_to_b(mesh, gamma))
    w_slot = schemes_mod.weights_slot(mesh, phi_slot, "upwind", Y)
    return (_rho_ddt(mesh, Y, rho, rho0, Y0, rdt)
            + fvm.div(mesh, phi, Y, phi_slot=phi_slot,
                      slot_weights=w_slot, phi_dims=_MASS_FLUX)
            - fvm.laplacian(mesh, slot_mod.to_flat(mesh, g_slot), Y,
                            corrected=False, gamma_dims=_DYN_VISC,
                            gamma_slot=g_slot))


def laminar_mu(mesh, th, T):
    return (th.mu_T(T.data) if th.sutherland_As > 0 else
            torch.full((mesh.n_cells,), th.mu, dtype=mesh.v.dtype,
                       device=mesh.device))


def combust(mesh, cfg, state, c, T, rho, mu, dt, rtol=None):
    """c_new from the closure (PaSR's mixing time from the turbulence
    state) or the laminar integration; `rtol` where the caller sets one."""
    kw = {} if rtol is None else {"rtol": rtol}
    if cfg.combustion is None:
        return cfg.chem.solve(c, T.data, dt, **kw)
    from ..models import combustion as comb_mod

    eps_t = comb_mod.epsilon_of(state.get("turb"))
    nut = (cfg.flow.turb.nut(mesh, state["turb"])
           if cfg.flow.turb is not None and "turb" in state
           else torch.zeros_like(rho))
    nu_eff = mu / torch.clamp(rho, min=cfg.flow.rho_min) + nut
    return cfg.combustion.advance(c, T.data, dt, epsilon=eps_t,
                                  nu_eff=nu_eff, **kw)


def reacting_step(mesh, state: Dict, dt: Any, cfg: ReactingConfig
                  ) -> Tuple[Dict, Dict]:
    th = cfg.flow.thermo
    y_ctrl = cfg.y_controls or Y_CONTROLS
    rdt = 1.0 / dt

    # -- 1. flow ------------------------------------------------------------
    state, diag = rhopimple_step(mesh, state, dt, cfg.flow)
    T: VolField = state["T"]
    rho = state["rho0"] if not cfg.flow.steady else torch.clamp(
        th.rho(state["p"].data, T.data), min=cfg.flow.rho_min)
    rho0 = state.get("rho_prev", rho)

    # -- 2. species transport (multi-RHS) ------------------------------------
    Y: VolField = state["Y"]          # [nC, nS]
    mu = laminar_mu(mesh, th, T)
    YEqn = species_eqn(mesh, state, Y, rho, rho0, rdt, mu, cfg.Sc)
    Ydata, yperf = linear.solve(mesh, YEqn, Y.data, y_ctrl)
    Ydata = torch.clamp(Ydata, 0.0, 1.0)
    diag["Y"] = yperf

    # -- 3. chemistry (operator split) ---------------------------------------
    Wv = torch.as_tensor(cfg.W, dtype=mesh.v.dtype, device=mesh.device)
    c = rho[:, None] * Ydata / Wv[None, :]          # [kmol/m^3]
    c_new = combust(mesh, cfg, state, c, T, rho, mu, dt,
                    rtol=cfg.chem_rtol)
    # heat release -> temperature (explicit): dT = -sum hf dc / (rho cp)
    dc = c_new - c
    q = -(dc @ cfg.chem.hf) * rdt                   # J/m^3/s
    mixture_mode = cfg.cp_lo is not None
    if mixture_mode:
        R_mix, cp_mix = cfg.mixture_RCp(torch.clamp(
            c_new * Wv[None, :] / rho[:, None], 0.0, 1.0), T.data)
        cp = cp_mix
    else:
        R_mix, cp_mix = None, None
        cp = th.Cp_of(T.data)
    T = T.with_data(T.data + dt * q / (rho * cp))
    T = T.correct_boundary_conditions(mesh)
    Ydata = c_new * Wv[None, :] / rho[:, None]
    # normalise (inert-species closure)
    Ydata = Ydata / torch.clamp(torch.sum(Ydata, dim=1, keepdim=True),
                                min=1e-12)
    Y = Y.with_data(Ydata)
    diag["Qdot_max"] = torch.max(torch.abs(q))

    new_state = dict(state)
    new_state.update(T=T, Y=Y, Y0=Ydata, rho_prev=rho)
    if mixture_mode:
        new_state["R_mix"] = R_mix
        new_state["cp_mix"] = cp_mix
    if not cfg.flow.steady:
        # constant-volume heat release keeps rho and raises T and p = rho R
        # T together; the old-time levels move to the post-chemistry state
        p_new = rho * (R_mix if mixture_mode else th.R) * T.data
        new_state["p"] = state["p"].with_data(p_new)
        new_state["p0"] = p_new
        new_state["T0"] = T.data
    return new_state, diag


def initial_state(mesh, U, p, T, Y: VolField, thermo,
                  steady: bool = False) -> Dict:
    from .rhopimple import initial_state as rp_init

    st = rp_init(mesh, U, p, T, thermo, steady=steady)
    st["Y"] = Y
    st["Y0"] = Y.data
    return st


def seed_mixture_state(st, cfg: ReactingConfig):
    """The per-cell mixture R and Cp before the first flow step
    (reactingMixture mode only)."""
    if cfg.cp_lo is None:
        return st
    R_mix, cp_mix = cfg.mixture_RCp(st["Y"].data, st["T"].data)
    st["R_mix"] = R_mix
    st["cp_mix"] = cp_mix
    return st


def make_step(mesh, cfg: ReactingConfig):
    """(state, dt) -> (state, diag) for one time step."""
    def step(state, dt):
        return reacting_step(mesh, state, dt, cfg)

    return step
