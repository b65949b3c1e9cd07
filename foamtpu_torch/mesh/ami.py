"""cyclicAMI: arbitrary mesh interface weights, built on the host at
load (a copy of openfoam-2.2.x_tpu/mesh/ami.py, unchanged in behaviour:
the reference module is numpy, but importing it loads the JAX package).

Each cyclicAMI patch receives the neighbour patch's owner-cell values
through face-overlap weights:

    psi_face(Ai) = sum_j w_ij psi_own(Bj),   sum_j w_ij = 1

Faces are projected into a common 2-D frame (the fitted patch plane for
planar interfaces, (theta, axial) around rotationAxis for rotational
ones) and the overlap of their bounding rectangles gives the weight:
exact for the rectangle-faced interfaces blockMesh produces (the
reference's documented simplification of the polygon intersection).

The entries reach the device as COO tables on the FvMesh (ami_entry_*),
read by the BC layer (explicit values) and by every matrix product of
a coupled matrix (implicit coupling).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .core import Patch, PolyMesh


def _face_corners(pm: PolyMesh, fid: int) -> np.ndarray:
    n = pm.face_npts[fid]
    return pm.points[pm.face_pts[fid, :n]]


def _patch_uv_frame(pm: PolyMesh, p: Patch):
    """(origin, u-axis, v-axis) of the fitted patch plane."""
    sl = p.slice
    n = pm.sf[sl].sum(axis=0)
    n = n / max(np.linalg.norm(n), 1e-300)
    a = np.array([1.0, 0.0, 0.0])
    if abs(n @ a) > 0.9:
        a = np.array([0.0, 1.0, 0.0])
    u = np.cross(n, a)
    u /= np.linalg.norm(u)
    v = np.cross(n, u)
    return pm.cf[sl].mean(axis=0), u, v


def _rect_bounds_planar(pm: PolyMesh, p: Patch, origin, u, v):
    lo = np.empty((p.size, 2))
    hi = np.empty((p.size, 2))
    for i, fid in enumerate(range(p.start, p.start + p.size)):
        c = _face_corners(pm, fid) - origin
        uv = np.stack([c @ u, c @ v], axis=1)
        lo[i] = uv.min(axis=0)
        hi[i] = uv.max(axis=0)
    return lo, hi


def _rect_bounds_rotational(pm: PolyMesh, p: Patch, centre, axis):
    """(theta, axial) rectangles; theta unwrapped per face."""
    ax = axis / max(np.linalg.norm(axis), 1e-300)
    a1 = np.array([1.0, 0.0, 0.0])
    if abs(ax @ a1) > 0.9:
        a1 = np.array([0.0, 1.0, 0.0])
    e1 = np.cross(ax, a1)
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(ax, e1)
    lo = np.empty((p.size, 2))
    hi = np.empty((p.size, 2))
    for i, fid in enumerate(range(p.start, p.start + p.size)):
        c = _face_corners(pm, fid) - centre
        th = np.arctan2(c @ e2, c @ e1)
        # unwrap across the -pi/pi seam within a face
        th = np.unwrap(np.sort(th)) if th.max() - th.min() > np.pi else th
        if th.max() - th.min() > np.pi:
            th = np.where(th < 0, th + 2 * np.pi, th)
        z = c @ ax
        lo[i] = (th.min(), z.min())
        hi[i] = (th.max(), z.max())
    return lo, hi


def _overlap_entries(lo_a, hi_a, lo_b, hi_b, wrap_theta=False):
    """COO (ia, ib, overlap_area) of rectangle overlaps."""
    def olap(la, ha, lb, hb):
        return np.maximum(
            0.0, np.minimum(ha[:, None], hb[None, :])
            - np.maximum(la[:, None], lb[None, :]))

    o0 = olap(lo_a[:, 0], hi_a[:, 0], lo_b[:, 0], hi_b[:, 0])
    if wrap_theta:
        for shift in (2 * np.pi, -2 * np.pi):
            o0 = np.maximum(o0, olap(lo_a[:, 0] + shift, hi_a[:, 0] + shift,
                                     lo_b[:, 0], hi_b[:, 0]))
    o1 = olap(lo_a[:, 1], hi_a[:, 1], lo_b[:, 1], hi_b[:, 1])
    area = o0 * o1
    ia, ib = np.nonzero(area > 1e-14 * max(area.max(), 1e-300))
    return ia, ib, area[ia, ib]


class AmiData:
    """Flattened COO interpolation entries over ALL cyclicAMI patches.

    entry_face: boundary-relative receiving face [nE]
    entry_row:  owner cell of the receiving face [nE]
    entry_cell: owner cell of the source face [nE]
    entry_w:    normalised weight [nE]
    face_mask:  [nBf] 1.0 on cyclicAMI faces
    """

    def __init__(self, entry_face, entry_row, entry_cell, entry_w,
                 face_mask, min_weight_sum, dc_eff, w_own):
        self.entry_face = entry_face
        self.entry_row = entry_row
        self.entry_cell = entry_cell
        self.entry_w = entry_w
        self.face_mask = face_mask
        self.min_weight_sum = min_weight_sum
        # effective cell-to-cell delta coefficient per boundary face
        # (1/(d_own + interp d_nbr) on AMI faces; untouched elsewhere)
        self.dc_eff = dc_eff
        # own-side blend weight for the coupled face VALUE
        self.w_own = w_own


def build(pm: PolyMesh) -> Optional[AmiData]:
    """Compute AMI interpolation entries for every cyclicAMI pair."""
    amis = [p for p in pm.patches if p.type == "cyclicAMI"]
    if not amis:
        return None
    by_name = {p.name: p for p in pm.patches}
    nif = pm.n_internal_faces
    nbf = pm.n_faces - nif
    e_face: List[np.ndarray] = []
    e_row: List[np.ndarray] = []
    e_cell: List[np.ndarray] = []
    e_w: List[np.ndarray] = []
    mask = np.zeros(nbf)
    dc_eff = pm.delta_coeffs[nif:].copy()
    w_own = np.ones(nbf)
    min_wsum = 1.0
    for pa in amis:
        pb = by_name.get(pa.neighbour_patch or "")
        if pb is None:
            raise ValueError(
                f"cyclicAMI patch {pa.name!r} has no neighbourPatch")
        transform = (pa.attr("transform") or "none").lower()
        if transform.startswith("rotational"):
            centre = np.fromstring(
                pa.attr("rotationCentre", "0 0 0"), sep=" ")
            axis = np.fromstring(pa.attr("rotationAxis", "0 0 1"), sep=" ")
            lo_a, hi_a = _rect_bounds_rotational(pm, pa, centre, axis)
            lo_b, hi_b = _rect_bounds_rotational(pm, pb, centre, axis)
            ia, ib, area = _overlap_entries(lo_a, hi_a, lo_b, hi_b,
                                            wrap_theta=True)
        else:
            origin, u, v = _patch_uv_frame(pm, pa)
            lo_a, hi_a = _rect_bounds_planar(pm, pa, origin, u, v)
            lo_b, hi_b = _rect_bounds_planar(pm, pb, origin, u, v)
            ia, ib, area = _overlap_entries(lo_a, hi_a, lo_b, hi_b)
        if ia.size == 0:
            raise ValueError(
                f"cyclicAMI {pa.name!r}/{pb.name!r}: no face overlaps")
        # normalise per receiving face
        wsum = np.zeros(pa.size)
        np.add.at(wsum, ia, area)
        covered = wsum > 1e-14 * wsum.max()
        min_wsum = min(min_wsum, float(
            (wsum / np.maximum(
                (hi_a - lo_a).prod(axis=1), 1e-300))[covered].min()))
        w = area / np.maximum(wsum[ia], 1e-300)
        e_face.append(pa.start - nif + ia)
        e_row.append(pm.owner[pa.start + ia])
        e_cell.append(pm.owner[pb.start + ib])
        e_w.append(w)
        mask[pa.start - nif:pa.start - nif + pa.size] = 1.0
        # two-sided delta: d_own(A) + AMI-interpolated d_own(B)
        # (reference: cyclicAMIFvPatch::makeDeltaCoeffs)
        d_a = 1.0 / np.maximum(pm.delta_coeffs[pa.slice], 1e-300)
        d_b_face = 1.0 / np.maximum(pm.delta_coeffs[pb.slice], 1e-300)
        d_b = np.zeros(pa.size)
        np.add.at(d_b, ia, w * d_b_face[ib])
        rel = pa.start - nif
        dc_eff[rel:rel + pa.size] = 1.0 / np.maximum(d_a + d_b, 1e-300)
        w_own[rel:rel + pa.size] = d_b / np.maximum(d_a + d_b, 1e-300)
    return AmiData(
        entry_face=np.concatenate(e_face).astype(np.int64),
        entry_row=np.concatenate(e_row).astype(np.int64),
        entry_cell=np.concatenate(e_cell).astype(np.int64),
        entry_w=np.concatenate(e_w),
        face_mask=mask,
        min_weight_sum=min_wsum,
        dc_eff=dc_eff,
        w_own=w_own,
    )
