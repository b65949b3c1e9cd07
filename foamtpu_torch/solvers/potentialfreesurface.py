"""potentialFreeSurfaceFoam — single-phase flow with a wave-pressure free
surface, no mesh motion (port of
openfoam-2.2.x_tpu/solvers/potentialfreesurface.py: the solver and the
waveSurfacePressure BC).

The free-surface patch stays where it is; a surface elevation zeta lives
on its faces, integrated from the patch flux

    d zeta / dt = phi / |Sf|,

and the (kinematic) pressure on the patch carries the linearised
hydrostatic head of the displaced surface, p_patch = |g| zeta: a
raised surface pushes the flow away, the restoring force of a
small-amplitude gravity wave. Interior gravity is absorbed into the
pressure (constant density), so the solver is pisoFoam with one dynamic
BC, a `mixed` patch field whose value is rewritten before every step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..core.fields import VolField
from . import piso as piso_mod


class FreeSurfaceConfig(NamedTuple):
    flow: piso_mod.PisoConfig
    fs_patch: int                 # index of the freeSurface patch
    g_mag: float = 9.81


def pfs_step(mesh, state: Dict, dt: Any, cfg: FreeSurfaceConfig
             ) -> Tuple[Dict, Dict]:
    patch = mesh.patches[cfg.fs_patch]
    sl = patch.slice
    dt = piso_mod._as_scalar(mesh, dt)
    # 1. integrate the surface elevation from the patch flux
    zeta = state["zeta"] + dt * state["phi"][sl] / mesh.mag_sf[sl]
    # volume-neutral: remove any net elevation drift (closed basins)
    w = mesh.mag_sf[sl]
    zeta = zeta - torch.sum(zeta * w) / torch.sum(w)

    # 2. the free-surface pressure BC: a fixed value |g| zeta
    p: VolField = state["p"]
    bcs = list(p.bcs)
    bcs[cfg.fs_patch] = bcs[cfg.fs_patch].replace(
        ref_value=cfg.g_mag * zeta, vfrac=mesh.v.new_ones(patch.size))
    p = dataclasses.replace(p, bcs=tuple(bcs))

    # 3. a plain PISO step
    st = dict(state)
    st["p"] = p
    st, diag = piso_mod.piso_step(mesh, st, dt, cfg.flow)
    st["zeta"] = zeta
    diag["zeta_min"] = torch.min(zeta)
    diag["zeta_max"] = torch.max(zeta)
    return st, diag


def initial_state(mesh, U: VolField, p: VolField,
                  cfg: FreeSurfaceConfig, zeta0=None) -> Dict:
    n = mesh.patches[cfg.fs_patch].size
    zeta = (mesh.v.new_zeros(n) if zeta0 is None
            else torch.as_tensor(zeta0, dtype=mesh.v.dtype,
                                 device=mesh.device))
    # the free-surface patch becomes a mixed (value) BC, so that the
    # per-step ref_value rewrite reaches the pressure matrix
    bcs = list(p.bcs)
    bcs[cfg.fs_patch] = bcs[cfg.fs_patch].replace(
        kind="mixed", ref_value=cfg.g_mag * zeta,
        ref_grad=mesh.v.new_zeros(n), vfrac=mesh.v.new_ones(n))
    p = dataclasses.replace(p, bcs=tuple(bcs))
    st = piso_mod.initial_state(mesh, U, p)
    st["zeta"] = zeta
    return st


def make_step(mesh, cfg: FreeSurfaceConfig):
    """(state, dt) -> (state, diag) for one potentialFreeSurfaceFoam step."""
    def step(state, dt):
        return pfs_step(mesh, state, dt, cfg)

    return step
