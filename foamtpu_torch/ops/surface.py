"""Gather-based surface primitives (port of
openfoam-2.2.x_tpu/ops/surface.py): cell -> face interpolation and
face -> cell sums over the per-cell face tables."""

from __future__ import annotations

from typing import Any, Optional

import torch


def surface_sum(mesh, face_vals: Any, weight: Optional[Any] = None) -> Any:
    """sum_f sign_f * face_vals_f per cell. weight overrides the signed
    mask (e.g. mesh.cbnd to sum boundary-face contributions only)."""
    w = mesh.csign if weight is None else weight
    g = face_vals[mesh.cface]
    if g.ndim == 3:
        return torch.sum(g * w[:, :, None], dim=1)
    return torch.sum(g * w, dim=1)


def boundary_sum(mesh, bvals: Any) -> Any:
    """Sum per-boundary-face values [nBf,(3)] into their owner cells over
    the ACTIVE boundary faces only (empty-patch faces carry zero)."""
    shape = (mesh.n_cells,) + tuple(bvals.shape[1:])
    out = bvals.new_zeros(shape)
    return out.index_add(0, mesh.ab_owner, bvals[mesh.ab_rel])


def owner_to_b(mesh, x: Any) -> Any:
    """Owner-cell values extrapolated to the boundary, [nBf(,C)]: active
    faces get x[owner], empty-patch faces zero."""
    nbf = mesh.n_faces - mesh.n_internal_faces
    z = x.new_zeros((nbf,) + tuple(x.shape[1:]))
    return z.index_copy(0, mesh.ab_rel, x[mesh.ab_owner])


def interpolate_internal(mesh, data: Any, weights: Optional[Any] = None
                         ) -> Any:
    """Cell data -> internal-face values with owner-side weights w:
    vf = w*v_own + (1-w)*v_nei. Default: linear (central) weights."""
    nif = mesh.n_internal_faces
    w = mesh.weights[:nif] if weights is None else weights
    vo = data[mesh.owner[:nif]]
    vn = data[mesh.neighbour]
    w = w.reshape((-1,) + (1,) * (data.ndim - 1))
    return w * vo + (1.0 - w) * vn


def face_values(mesh, field, weights: Optional[Any] = None) -> Any:
    """Full-face interpolated values [nF,(3)]: internal faces blended,
    boundary faces from BC evaluation."""
    vi = interpolate_internal(mesh, field.data, weights)
    vb = field.boundary_values(mesh)
    return torch.cat([vi, vb], dim=0)


def delta(mesh, data: Any) -> Any:
    """Owner->neighbour difference on internal faces: v_nei - v_own."""
    nif = mesh.n_internal_faces
    return data[mesh.neighbour] - data[mesh.owner[:nif]]
