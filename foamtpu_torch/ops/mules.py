"""MULES: explicit flux-corrected transport limiter for bounded
advection, the VOF alpha equation (port of
openfoam-2.2.x_tpu/ops/mules.py).

MULES::limiter (Zalesak FCT with a fixed number of limiter iterations)
and MULES::explicitSolve in gather form: the per-cell sums ride the
mesh's cface tables, and the per-face limiter is the min over the two
adjacent cells' allowables, gathered back to faces through
owner/neighbour.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from . import surface


def _cell_extrema(mesh, *fields):
    """Per-cell min/max over the cell and its face neighbours of the
    given cell fields."""
    lo = None
    hi = None
    valid = mesh.cnbr_valid > 0
    for f in fields:
        nbr_vals = f[mesh.cnbr]  # [nC,K]
        inf = torch.full_like(nbr_vals, float("inf"))
        nb_max = torch.amax(torch.where(valid, nbr_vals, -inf), dim=1)
        nb_min = torch.amin(torch.where(valid, nbr_vals, inf), dim=1)
        fmax = torch.maximum(f, torch.where(torch.isfinite(nb_max), nb_max, f))
        fmin = torch.minimum(f, torch.where(torch.isfinite(nb_min), nb_min, f))
        hi = fmax if hi is None else torch.maximum(hi, fmax)
        lo = fmin if lo is None else torch.minimum(lo, fmin)
    return lo, hi


def limiter(mesh, psi: Any, phi_bd: Any, phi_corr: Any, dt: Any,
            psi_max: float = 1.0, psi_min: float = 0.0,
            n_iter: int = 3) -> Any:
    """Zalesak limiter lambda [nF] in [0,1] for the correction flux.

    psi: cell field [nC] (alpha at time n)
    phi_bd: bounded (upwind) face flux of psi [nF]
    phi_corr: antidiffusive correction flux [nF]
    dt: the time step, a scalar or per cell [nC] (local time stepping)
    """
    nif = mesh.n_internal_faces
    v_dt = mesh.v / dt

    # low-order update
    div_bd = surface.surface_sum(mesh, phi_bd)
    psi_bd = psi - div_bd / v_dt

    lo, hi = _cell_extrema(mesh, psi, psi_bd)
    hi = torch.clamp(hi, max=psi_max)
    lo = torch.clamp(lo, min=psi_min)

    own = mesh.owner[:nif]
    nei = mesh.neighbour
    q_up = (hi - psi_bd) * v_dt
    q_dn = (psi_bd - lo) * v_dt
    lam = torch.ones_like(phi_corr)
    for _ in range(n_iter):
        corr = phi_corr * lam
        # signed per-cell: outgoing positive-corr sum P+ / incoming P-
        g = corr[mesh.cface] * mesh.csign  # [nC,K] outward corrections
        p_out = torch.sum(torch.clamp(g, min=0.0), dim=1)   # removes psi
        p_in = torch.sum(torch.clamp(-g, min=0.0), dim=1)   # adds psi
        r_in = torch.clamp(q_up / torch.clamp(p_in, min=1e-30), 0.0, 1.0)
        r_out = torch.clamp(q_dn / torch.clamp(p_out, min=1e-30), 0.0, 1.0)
        # face limiter: for a correction flux from owner to neighbour,
        # the owner loses (r_out[own]) and the neighbour gains
        # (r_in[nei]); reversed for negative corrections
        c_i = corr[:nif]
        lam_i = torch.where(
            c_i >= 0,
            torch.minimum(r_out[own], r_in[nei]),
            torch.minimum(r_in[own], r_out[nei]),
        )
        # boundary: limit by the owner cell only (empty faces carry
        # zero corr anyway)
        c_b = corr[nif:]
        lam_b = torch.where(c_b >= 0, surface.owner_to_b(mesh, r_out),
                            surface.owner_to_b(mesh, r_in))
        lam = lam * torch.cat([lam_i, lam_b], dim=0)
    return lam


def explicit_solve(mesh, psi: Any, phi_bd: Any, phi_corr: Any, dt: Any,
                   psi_max: float = 1.0, psi_min: float = 0.0,
                   n_iter: int = 3) -> Tuple[Any, Any]:
    """MULES::explicitSolve: bounded update of psi and the consistent
    limited face flux. Returns (psi_new, phi_psi)."""
    lam = limiter(mesh, psi, phi_bd, phi_corr, dt,
                  psi_max=psi_max, psi_min=psi_min, n_iter=n_iter)
    phi_psi = phi_bd + lam * phi_corr
    div_total = surface.surface_sum(mesh, phi_psi)
    psi_new = psi - div_total * dt / mesh.v
    return psi_new, phi_psi
