"""Pyrolysis region: 1D in-depth reacting solid columns (port of
openfoam-2.2.x_tpu/regionmodels/pyrolysis.py: `PyrolysisConfig`,
`pyro_init`, `pyro_step`; reference src/regionModels/pyrolysisModels/
reactingOneDim/).

Per wall face, a column of nL layers (z into the solid):
    rho cp dT/dt = d/dz (k dT/dz),  -k dT/dz|surf = q_in (exposed),
                                     dT/dz|back = 0 (insulated)
    d(rho_s)/dt = -A exp(-Ta/T) (rho_s - rho_char)
    m_gas [kg/m^2/s] = sum_layers -d(rho_s)/dt dz
The columns are one [nF, nL] array advanced by n_sub explicit substeps;
the endothermic pyrolysis sink enters through h_pyro.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..core.precision import DEFAULT_DEVICE


class PyrolysisConfig(NamedTuple):
    n_layers: int = 8
    thickness: float = 0.01     # [m]
    k_s: float = 0.2            # solid conductivity [W/m/K]
    rho_s0: float = 700.0       # virgin solid density [kg/m^3]
    rho_char: float = 100.0     # char (non-pyrolysable) density
    cp_s: float = 1500.0        # [J/kg/K]
    A: float = 1e8              # Arrhenius pre-exponential [1/s]
    Ta: float = 15000.0         # activation temperature [K]
    h_pyro: float = 1e5         # heat of pyrolysis [J/kg] (endothermic)
    n_sub: int = 4              # explicit subcycles per step


def pyro_init(n_faces: int, cfg: PyrolysisConfig, T0=300.0,
              dtype=torch.float32, device=DEFAULT_DEVICE) -> Dict[str, Any]:
    shape = (n_faces, cfg.n_layers)
    return {
        "Ts": torch.full(shape, T0, dtype=dtype, device=device),
        "rho_s": torch.full(shape, cfg.rho_s0, dtype=dtype, device=device),
    }


def pyro_step(state: Dict[str, Any], dt: Any, cfg: PyrolysisConfig,
              q_in: Any) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Advance all columns over dt under the surface heat flux q_in [nF]
    (W/m^2, positive into the solid)."""
    dz = cfg.thickness / cfg.n_layers
    sub_dt = dt / cfg.n_sub
    alpha = cfg.k_s / (cfg.rho_s0 * cfg.cp_s)
    Ts, rho_s = state["Ts"], state["rho_s"]
    q_in = torch.as_tensor(q_in, dtype=Ts.dtype, device=Ts.device)
    for _ in range(cfg.n_sub):
        # conduction: interior second difference, the surface flux at
        # layer 0, an insulated back
        flux_in = q_in / (cfg.rho_s0 * cfg.cp_s * dz)   # [nF] K/s
        lap = (torch.roll(Ts, -1, dims=1) - 2.0 * Ts
               + torch.roll(Ts, 1, dims=1)) / dz ** 2
        lap[:, 0] = (Ts[:, 1] - Ts[:, 0]) / dz ** 2
        lap[:, -1] = (Ts[:, -2] - Ts[:, -1]) / dz ** 2
        # pyrolysis mass loss (endothermic sink)
        rate = cfg.A * torch.exp(-cfg.Ta / torch.clamp(Ts, min=1.0)) \
            * torch.clamp(rho_s - cfg.rho_char, min=0.0)  # kg/m^3/s
        dT = alpha * lap - rate * cfg.h_pyro / (cfg.rho_s0 * cfg.cp_s)
        dT[:, 0] += flux_in
        Ts_n = Ts + sub_dt * dT
        rho_s = torch.clamp(rho_s - sub_dt * rate, min=cfg.rho_char)
        Ts = Ts_n
    m_gas = torch.sum(state["rho_s"] - rho_s, dim=1) * dz / dt  # [nF]
    new = {"Ts": Ts, "rho_s": rho_s}
    diag = {
        "T_surf_max": torch.max(Ts[:, 0]),
        "m_gas": m_gas,
        "solid_mass": torch.sum(rho_s, dim=1) * dz,
    }
    return new, diag
