"""Evaporating, devolatilising and breaking-up parcels (port of
openfoam-2.2.x_tpu/lagrangian/reactingcloud.py: `EvapConfig`,
`CoalConfig`, `BreakupConfig`, `evaporate`, `liquid_evaporate`,
`CoalCloud`, `devolatilise`, `reitz_diwakar_breakup`; reference
src/lagrangian/intermediate/submodels/{Reacting/PhaseChangeModel/
LiquidEvaporation, ReactingMultiphase/DevolatilisationModel/
SingleKineticRateDevolatilisation, spray/BreakupModel/ReitzDiwakar} and
applications/solvers/lagrangian/{reactingParcelFoam,coalChemistryFoam,
sprayFoam}).

Elementwise updates on the same fixed-slot cloud as the kinematic
parcels:

- evaporation by the d^2 law with the Ranz-Marshall Sherwood number,
      d(d^2)/dt = -K_evap Sh/2,   Sh = 2 + 0.6 Re^1/2 Sc^1/3,
  the parcel mass going to a per-cell vapour source and the latent heat
  drawn from the carrier;
- liquid evaporation through the vapour film from the liquid package's
  pv and hl (models/liquids.py). As in the reference, the latent heat is
  charged twice: the carrier's heat sink and the droplet's own dT both
  take dm hl, and `p_cell` is accepted and unused;
- single-kinetic-rate devolatilisation of the volatile fraction,
  dYv/dt = -A1 exp(-E/RT_p) Yv, then a diffusion-limited char burnout
  that shrinks the diameter and releases the char heating value;
- Reitz-Diwakar bag breakup: parcels above the critical Weber number
  relax toward the stable diameter with the bag time constant.

The per-cell sources are sums over parcels by `index_add_` (an atomic
sum on the card, no fixed order), as `momentum_source` makes them.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from . import Cloud, CloudConfig


class EvapConfig(NamedTuple):
    K_evap: float = 1e-7       # base d^2-law constant [m^2/s]
    Sc: float = 0.7            # carrier Schmidt number
    L_vap: float = 2.26e6      # latent heat [J/kg]
    T_boil: float = 373.0
    d_min: float = 1e-7


class CoalConfig(NamedTuple):
    A1: float = 2e5            # devolatilisation pre-exponential [1/s]
    E: float = 7.4e7           # activation energy [J/kmol]
    Yvol0: float = 0.4         # initial volatile mass fraction
    h_vol: float = 3.0e7       # volatile heating value [J/kg]
    h_char: float = 3.28e7     # char heating value [J/kg]
    char_rate: float = 5e-3    # diffusion-limited burnout d-rate [m/s]
    d_min: float = 1e-6


class BreakupConfig(NamedTuple):
    sigma: float = 0.026       # droplet surface tension [N/m]
    rho_f: float = 1.0
    we_crit: float = 6.0       # bag breakup threshold
    c_bag: float = 0.785       # bag time-constant coefficient (pi/4)


R_UNIV = 8314.47


def _cell_sum(values, cell, n_cells: int):
    return values.new_zeros(n_cells).index_add_(0, cell, values)


def evaporate(cloud: Cloud, U_cell, T_cell, dt, cfg: CloudConfig,
              ecfg: EvapConfig, n_cells: int, n_parcels=1.0):
    """d^2-law evaporation. U_cell and T_cell are the carrier's cell
    fields, gathered at each parcel's cell. Returns (cloud, vapour mass
    source [nC], heat sink [nC] in W), both weighted by the parcel
    count."""
    u_f = U_cell[cloud.cell]
    urel = torch.linalg.norm(u_f - cloud.u, dim=1)
    Re = torch.clamp(cfg.rho_f * urel * cloud.d / cfg.mu_f, min=1e-10)
    Sh = 2.0 + 0.6 * torch.sqrt(Re) * ecfg.Sc ** (1.0 / 3.0)
    d2 = cloud.d ** 2
    d2_new = torch.clamp(d2 - dt * ecfg.K_evap * Sh / 2.0,
                         min=ecfg.d_min ** 2)
    d_new = torch.sqrt(d2_new)
    dm = (cloud.rho * torch.pi / 6.0 * (cloud.d ** 3 - d_new ** 3)
          * n_parcels)
    dm = torch.where(cloud.active, torch.clamp(dm, min=0.0),
                     torch.zeros_like(dm))
    alive = cloud.active & (d_new > 1.5 * ecfg.d_min)
    cloud = cloud._replace(d=torch.where(cloud.active, d_new, cloud.d),
                           active=alive)
    vap = _cell_sum(dm, cloud.cell, n_cells)
    heat = vap * ecfg.L_vap / dt
    return cloud, vap, heat


def liquid_evaporate(cloud: Cloud, U_cell, T_cell, p_cell, dt,
                     cfg: CloudConfig, liquid, n_cells: int,
                     n_parcels=1.0):
    """Liquid-properties phase change (LiquidEvaporation.C): the molar
    evaporation flux through the vapour film,

        kc  = Sh D / d                     (Ranz-Marshall Sherwood)
        Cs  = pv(Ts) / (Ru Ts)             (surface molar concentration)
        dm  = pi d^2 kc Cs W dt            (Cinf = 0, dry carrier)

    with pv and hl from the liquid package. Returns (cloud, vapour mass
    source [nC] kg, heat sink [nC] W)."""
    u_f = U_cell[cloud.cell]
    urel = torch.linalg.norm(u_f - cloud.u, dim=1)
    Re = torch.clamp(cfg.rho_f * urel * cloud.d / cfg.mu_f, min=1e-10)
    Sc = cfg.mu_f / max(cfg.rho_f * liquid.D, 1e-30)
    Sh = 2.0 + 0.6 * torch.sqrt(Re) * Sc ** (1.0 / 3.0)
    Ts = liquid.Ts_clip(cloud.T if cloud.T is not None
                        else T_cell[cloud.cell])
    kc = Sh * liquid.D / torch.clamp(cloud.d, min=1e-9)
    Cs = liquid.pv(Ts) / (R_UNIV * Ts)
    mdot = torch.pi * cloud.d ** 2 * kc * Cs * liquid.W   # [kg/s] per drop
    m_p = cloud.rho * torch.pi / 6.0 * cloud.d ** 3
    dm1 = torch.minimum(mdot * dt, m_p)                   # per droplet
    d3_new = torch.clamp(cloud.d ** 3 - 6.0 / torch.pi * dm1
                         / torch.clamp(cloud.rho, min=1e-3), min=0.0)
    d_new = d3_new ** (1.0 / 3.0)
    dm = torch.where(cloud.active, dm1 * n_parcels, torch.zeros_like(dm1))
    alive = cloud.active & (d_new > 1e-7)
    upd = dict(d=torch.where(cloud.active, d_new, cloud.d), active=alive)
    if cloud.T is not None:
        # evaporative cooling of the droplet (the -hl dm term of the
        # parcel energy equation)
        cp_l = liquid.cp(Ts)
        dT = dm1 * liquid.hl(Ts) / torch.clamp(m_p * cp_l, min=1e-30)
        upd["T"] = torch.where(cloud.active,
                               torch.clamp(cloud.T - dT, min=200.0),
                               cloud.T)
    cloud = cloud._replace(**upd)
    vap = _cell_sum(dm, cloud.cell, n_cells)
    heat = _cell_sum(dm * liquid.hl(Ts), cloud.cell, n_cells) / dt
    return cloud, vap, heat


class CoalCloud(NamedTuple):
    """Kinematic cloud and the volatile mass fraction per parcel."""
    base: Cloud
    yvol: Any      # [Np] remaining volatile fraction of parcel mass


def devolatilise(coal: CoalCloud, T_cell, dt, ccfg: CoalConfig,
                 n_cells: int, n_parcels=1.0):
    """Single kinetic rate (SingleKineticRateDevolatilisation): releases
    volatile gas mass and its heating value, then the diffusion-limited
    char burnout shrinks d. Returns (coal, fuel gas source [nC] kg, heat
    source [nC] W)."""
    c = coal.base
    Tp = c.T if c.T is not None else T_cell[c.cell]
    kv = ccfg.A1 * torch.exp(-ccfg.E / (R_UNIV * torch.clamp(Tp, min=200.0)))
    yv_new = coal.yvol * torch.exp(-kv * dt)
    m_p = c.rho * torch.pi / 6.0 * c.d ** 3 * n_parcels
    zero = torch.zeros_like(m_p)
    dm_vol = torch.where(c.active, m_p * (coal.yvol - yv_new), zero)
    # char burnout after devolatilisation (shrinking sphere)
    burn = coal.yvol < 0.02 * ccfg.Yvol0
    d_new = torch.where(burn & c.active,
                        torch.clamp(c.d - dt * ccfg.char_rate,
                                    min=ccfg.d_min), c.d)
    dm_char = torch.where(c.active,
                          c.rho * torch.pi / 6.0 * (c.d ** 3 - d_new ** 3)
                          * n_parcels, zero)
    alive = c.active & (d_new > 1.5 * ccfg.d_min)
    base = c._replace(d=d_new, active=alive)
    fuel = _cell_sum(dm_vol, c.cell, n_cells)
    heat = _cell_sum(dm_vol * ccfg.h_vol + dm_char * ccfg.h_char, c.cell,
                     n_cells) / dt
    return CoalCloud(base=base, yvol=yv_new), fuel, heat


def reitz_diwakar_breakup(cloud: Cloud, U_cell, dt,
                          bcfg: BreakupConfig) -> Cloud:
    """Bag breakup (spray/BreakupModel/ReitzDiwakar): parcels above
    We_crit relax toward the critical-Weber stable diameter with the bag
    characteristic time."""
    u_f = U_cell[cloud.cell]
    urel2 = torch.sum((u_f - cloud.u) ** 2, dim=1)
    We = bcfg.rho_f * urel2 * cloud.d / bcfg.sigma
    d_stable = bcfg.we_crit * bcfg.sigma / torch.clamp(
        bcfg.rho_f * urel2, min=1e-30)
    # tau_bag = C sqrt(rho_p d^3 / (2 sigma))
    tau = bcfg.c_bag * torch.sqrt(cloud.rho * cloud.d ** 3
                                  / (2.0 * bcfg.sigma))
    f = torch.clamp(dt / torch.clamp(tau, min=1e-12), 0.0, 1.0)
    d_new = torch.where((We > bcfg.we_crit) & cloud.active,
                        cloud.d + f * (torch.minimum(d_stable, cloud.d)
                                       - cloud.d),
                        cloud.d)
    return cloud._replace(d=d_new)
