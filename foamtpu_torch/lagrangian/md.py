"""Molecular dynamics: Lennard-Jones, velocity Verlet (port of
openfoam-2.2.x_tpu/lagrangian/md.py: `MdState`, `MdConfig`,
`_pair_forces`, `verlet_step`, `temperature`, `kinetic_energy`,
`equilibrate_step`, `lattice_fill`, `make_state`; reference
src/lagrangian/molecularDynamics/ and applications/solvers/
discreteMethods/molecularDynamics/{mdFoam,mdEquilibrationFoam}/).

The forces are all pairs, as in the reference: no interaction lists.
The reference builds one dense [N, N, 3] displacement tensor; at 32,768
molecules that is 12.9 GB of float32 per temporary, so here the rows go
in tiles of `ROW_TILE` molecules against all N (a [B, N, 3] temporary),
each tile's forces and potential summed before the next. Periodic
boundaries use the minimum image over the box (torch.round, like
jnp.round, rounds half to even); a cutoff with the shifted-force
correction keeps U and F continuous at r_c (Allen & Tildesley eq. 5.7).

mdEquilibrationFoam is mdFoam plus a Berendsen-style rescale of the
velocities toward targetTemperature. `lattice_fill` is host numpy,
copied as is.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from ..core.precision import DEFAULT_DEVICE, scalar_dtype

K_BOLTZ = 1.380649e-23
ROW_TILE = 1024


class MdState(NamedTuple):
    x: Any     # [N, 3] positions
    u: Any     # [N, 3] velocities
    f: Any     # [N, 3] forces (for the Verlet half-kick)


class MdConfig(NamedTuple):
    epsilon: float      # LJ well depth [J]
    sigma: float        # LJ length [m]
    mass: float         # molecule mass [kg]
    box: Tuple[float, float, float]   # periodic box lengths
    r_cut: float        # cutoff radius
    periodic: Tuple[bool, bool, bool] = (True, True, True)


def _pair_forces(x, cfg: MdConfig, tile: int = ROW_TILE):
    """All-pairs shifted-force LJ forces and potential energy, in row
    tiles. Returns (f [N, 3], pot [scalar]); self pairs and pairs beyond
    r_cut are masked."""
    n = x.shape[0]
    box = torch.tensor(cfg.box, dtype=x.dtype, device=x.device)
    per = torch.tensor(cfg.periodic, device=x.device)
    s_rc2 = cfg.sigma ** 2 / cfg.r_cut ** 2
    s_rc6 = s_rc2 ** 3
    f_rc = 24.0 * cfg.epsilon * s_rc6 * (2.0 * s_rc6 - 1.0) / cfg.r_cut
    u_rc = 4.0 * cfg.epsilon * s_rc6 * (s_rc6 - 1.0)
    cols = torch.arange(n, device=x.device)
    fs = []
    pot = x.new_zeros(())
    for lo in range(0, n, tile):
        hi = min(lo + tile, n)
        d = x[lo:hi, None, :] - x[None, :, :]              # [B, N, 3]
        d = torch.where(per[None, None, :],
                        d - box * torch.round(d / box), d)  # minimum image
        r2 = torch.sum(d * d, dim=-1)
        mask = ((torch.arange(lo, hi, device=x.device)[:, None]
                 != cols[None, :]) & (r2 < cfg.r_cut ** 2))
        r2s = torch.where(mask, r2, torch.ones_like(r2))
        inv_r2 = cfg.sigma ** 2 / r2s
        inv_r6 = inv_r2 ** 3
        r = torch.sqrt(r2s)
        # plain LJ: U = 4 eps (s^12/r^12 - s^6/r^6);
        # F(r)/r = 24 eps (2 s^12/r^14 - s^6/r^8); then F_sf = F(r) - F(rc)
        fmag_over_r = (24.0 * cfg.epsilon * inv_r6 * (2.0 * inv_r6 - 1.0)
                       / r2s - f_rc / r)
        u_pair = (4.0 * cfg.epsilon * inv_r6 * (inv_r6 - 1.0) - u_rc
                  + f_rc * (r - cfg.r_cut))
        w = mask.to(x.dtype)
        fs.append(torch.sum((fmag_over_r * w)[:, :, None] * d, dim=1))
        pot = pot + 0.5 * torch.sum(u_pair * w)
    return torch.cat(fs), pot


def verlet_step(state: MdState, dt, cfg: MdConfig):
    """One velocity-Verlet step; returns (state, potential energy)."""
    a = state.f / cfg.mass
    u_half = state.u + 0.5 * dt * a
    x_new = state.x + dt * u_half
    box = torch.tensor(cfg.box, dtype=state.x.dtype, device=state.x.device)
    per = torch.tensor(cfg.periodic, device=state.x.device)
    x_new = torch.where(per[None, :], torch.remainder(x_new, box), x_new)
    f_new, pot = _pair_forces(x_new, cfg)
    u_new = u_half + 0.5 * dt * f_new / cfg.mass
    return MdState(x=x_new, u=u_new, f=f_new), pot


def temperature(state: MdState, cfg: MdConfig):
    """Instantaneous kinetic temperature (3N dof, momentum-corrected)."""
    n = state.x.shape[0]
    c = state.u - torch.mean(state.u, dim=0)
    ke = 0.5 * cfg.mass * torch.sum(c * c)
    return 2.0 * ke / (3.0 * n * K_BOLTZ)


def kinetic_energy(state: MdState, cfg: MdConfig):
    return 0.5 * cfg.mass * torch.sum(state.u * state.u)


def equilibrate_step(state: MdState, dt, cfg: MdConfig, T_target,
                     relax=1.0):
    """mdEquilibrationFoam: a Verlet step and a velocity rescale toward
    T_target (mdEquilibrationFoam/temperatureEquilibration.H)."""
    state, pot = verlet_step(state, dt, cfg)
    T_now = temperature(state, cfg)
    lam = torch.sqrt(1.0 + relax * (T_target / torch.clamp(T_now, min=1e-30)
                                    - 1.0))
    u_mean = torch.mean(state.u, dim=0)
    return state._replace(u=u_mean + lam * (state.u - u_mean)), pot


def lattice_fill(box, n_side, mass, T0, seed=0, dtype=np.float64):
    """Simple-cubic lattice fill with Maxwellian velocities (mdInitialise's
    latticeStructure zoneFill)."""
    rng = np.random.default_rng(seed)
    b = np.asarray(box, float)
    ax = [np.linspace(0, b[i], n_side, endpoint=False) + b[i] / (2 * n_side)
          for i in range(3)]
    X, Y, Z = np.meshgrid(*ax, indexing="ij")
    x = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    n = x.shape[0]
    sd = np.sqrt(K_BOLTZ * T0 / mass)
    u = sd * rng.standard_normal((n, 3))
    u -= u.mean(axis=0)          # zero net momentum
    return x.astype(dtype), u.astype(dtype)


def make_state(x, u, cfg: MdConfig, dtype=None,
               device=DEFAULT_DEVICE) -> MdState:
    """The state on `device` (dtype: the scalar dtype unless given), with
    its initial forces."""
    dt = dtype or scalar_dtype()
    x = torch.tensor(np.asarray(x, np.float64), dtype=dt, device=device)
    u = torch.tensor(np.asarray(u, np.float64), dtype=dt, device=device)
    f, _ = _pair_forces(x, cfg)
    return MdState(x=x, u=u, f=f)
