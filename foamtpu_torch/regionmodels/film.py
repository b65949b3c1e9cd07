"""Surface film models: kinematicSingleLayer + thermoSingleLayer (port of
openfoam-2.2.x_tpu/regionmodels/film.py: `FilmConfig`, `film_init`,
`_edge_div`, `film_step`; reference src/regionModels/surfaceFilmModels/
{kinematicSingleLayer,thermoSingleLayer}/).

A depth-integrated laminar film with the Nusselt velocity profile:
    ddt(delta) + div(delta U) = S_mass/rho
    ddt(delta U) + div(delta U U) = delta g_t - tau_w + S_mom/rho
    tau_w = 3 nu U/delta,  g_t = g - n (n.g)
so a draining film reaches U_inf = g_t delta^2/(3 nu). The step is
explicit: upwind edge fluxes summed into the film cells by `index_add_`
(an atomic sum on the card). Evaporation is the reference's
simplification of its phaseChangeModel: m_evap = evap_coeff
max(T_film - T_sat, 0) [kg/m^2/s].
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from .filmmesh import FilmMesh


class FilmConfig(NamedTuple):
    nu: float = 1e-6            # film kinematic viscosity [m^2/s]
    rho: float = 1000.0         # film density [kg/m^3]
    g: Tuple[float, float, float] = (0.0, -9.81, 0.0)
    thermo: bool = False        # thermoSingleLayer mode
    cp: float = 4187.0
    T_sat: float = 373.15
    evap_coeff: float = 0.0     # [kg/m^2/s/K] above saturation
    h_conv: float = 0.0         # film<->primary convective coeff [W/m^2/K]
    L_vap: float = 2.26e6       # latent heat [J/kg]
    delta_min: float = 1e-8     # numerical film-height floor


def film_init(fm: FilmMesh, cfg: FilmConfig, delta0=0.0, T0=300.0
              ) -> Dict[str, Any]:
    like = fm.area
    st = {
        "delta": torch.full_like(like, float(delta0)),
        "Uf": like.new_zeros((fm.n_faces, 3)),
    }
    if cfg.thermo:
        st["Tf"] = torch.full_like(like, float(T0))
    return st


def _edge_div(fm: FilmMesh, flux: Any) -> Any:
    """Divergence of edge fluxes per film cell, divided by its area."""
    shape = ((fm.n_faces,) if flux.ndim == 1
             else (fm.n_faces, flux.shape[1]))
    out = flux.new_zeros(shape)
    out.index_add_(0, fm.e_own, flux)
    out.index_add_(0, fm.e_nbr, -flux)
    a = fm.area if flux.ndim == 1 else fm.area[:, None]
    return out / a


def film_step(fm: FilmMesh, state: Dict[str, Any], dt: Any,
              cfg: FilmConfig,
              S_mass: Any = 0.0,       # [nF] kg/m^2/s impingement
              S_mom: Any = 0.0,        # [nF, 3] N/m^2 surface shear
              q_wall: Any = 0.0,       # [nF] W/m^2 from the wall
              ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """One explicit film step (surfaceFilmModel::evolve)."""
    delta = state["delta"]
    Uf = state["Uf"]
    g = torch.tensor(cfg.g, dtype=delta.dtype, device=delta.device)

    # -- edge fluxes (upwind) ------------------------------------------------
    u_e = 0.5 * (Uf[fm.e_own] + Uf[fm.e_nbr])
    un = torch.sum(u_e * fm.e_m, dim=1)            # [nE]
    up = torch.where(un >= 0.0, fm.e_own, fm.e_nbr)
    phi = un * delta[up]                           # [nE] m^3/s

    # -- evaporation (thermo mode) -------------------------------------------
    if cfg.thermo and cfg.evap_coeff > 0.0:
        Tf = state["Tf"]
        m_ev = cfg.evap_coeff * torch.clamp(Tf - cfg.T_sat, min=0.0)
        # cannot evaporate more than the film holds
        m_ev = torch.minimum(m_ev, cfg.rho * delta / dt)
    else:
        m_ev = torch.zeros_like(delta)

    # -- continuity ----------------------------------------------------------
    ddelta = -_edge_div(fm, phi) + (S_mass - m_ev) / cfg.rho
    delta_new = torch.clamp(delta + dt * ddelta, min=0.0)

    # -- momentum ------------------------------------------------------------
    mom_flux = phi[:, None] * Uf[up]               # [nE, 3]
    g_t = g[None, :] - fm.n * torch.sum(fm.n * g[None, :], dim=1,
                                        keepdim=True)
    d_eff = torch.clamp(delta, min=cfg.delta_min)
    tau_w = 3.0 * cfg.nu * Uf / d_eff[:, None]
    dmU = (-_edge_div(fm, mom_flux)
           + delta[:, None] * g_t
           - tau_w
           + torch.as_tensor(S_mom, dtype=delta.dtype,
                             device=delta.device) / cfg.rho)
    mU_new = delta[:, None] * Uf + dt * dmU
    d_new_eff = torch.clamp(delta_new, min=cfg.delta_min)
    Uf_new = mU_new / d_new_eff[:, None]
    # keep U tangential
    Uf_new = Uf_new - fm.n * torch.sum(fm.n * Uf_new, dim=1, keepdim=True)
    Uf_new = torch.where(delta_new[:, None] > cfg.delta_min, Uf_new,
                         torch.zeros_like(Uf_new))

    new = dict(state)
    new["delta"] = delta_new
    new["Uf"] = Uf_new
    diag = {
        "mass": torch.sum(cfg.rho * delta_new * fm.area),
        "evap_rate": torch.sum(m_ev * fm.area),
        "delta_max": torch.max(delta_new),
    }

    # -- energy (thermo mode) ------------------------------------------------
    if cfg.thermo:
        Tf = state["Tf"]
        T_flux = phi * Tf[up]
        # d(delta T)/dt + div(delta U T) = (q_wall - m_ev L)/(rho cp)
        q_net = (torch.as_tensor(q_wall, dtype=delta.dtype,
                                 device=delta.device) - m_ev * cfg.L_vap)
        dTd = -_edge_div(fm, T_flux) + q_net / (cfg.rho * cfg.cp)
        Td_new = delta * Tf + dt * dTd
        Tf_new = torch.where(delta_new > cfg.delta_min,
                             Td_new / d_new_eff, Tf)
        new["Tf"] = Tf_new
        diag["T_max"] = torch.max(Tf_new)
    return new, diag
