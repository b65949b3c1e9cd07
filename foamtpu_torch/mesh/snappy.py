"""snappyHexMesh: STL-driven hex mesh carving (castellate, octree
refinement, snap; the layer stage is `mesh/layers.py`).

Host copy of openfoam-2.2.x_tpu/mesh/snappy.py, unchanged in behaviour:
STL reading and writing, the inside test by ray parity, castellation
against a tri-surface with locationInMesh side selection, the octree
refinement of a uniform box background with 2:1 balance and its
hanging-face mesh, and the snap of the castellated body patch onto the
surface. numpy throughout, on the port's own `mesh/core.py::PolyMesh`;
the reference module imports no jax either, but every `foamtpu.mesh`
import loads it, so the port carries the copy. Mesh generation is
offline, as in the reference binary: `to_device` takes the result.
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Tuple

import numpy as np

from .core import Patch, PolyMesh


# ---------------------------------------------------------------------------
# triSurface: STL reading (reference: src/triSurface/triSurface/
# interfaces/STL/)
# ---------------------------------------------------------------------------


def read_stl(path: str) -> np.ndarray:
    """STL (ascii or binary) -> triangles [nT, 3, 3]."""
    with open(path, "rb") as f:
        head = f.read(5)
    if head == b"solid":
        # could still be binary with a 'solid' header; try ascii first
        try:
            return _read_stl_ascii(path)
        except ValueError:
            pass
    return _read_stl_binary(path)


def _read_stl_ascii(path: str) -> np.ndarray:
    tris: List[List[List[float]]] = []
    cur: List[List[float]] = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "vertex":
                cur.append([float(t[1]), float(t[2]), float(t[3])])
                if len(cur) == 3:
                    tris.append(cur)
                    cur = []
    if not tris:
        raise ValueError("no ascii facets")
    return np.asarray(tris, dtype=float)


def _read_stl_binary(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        f.read(80)
        (n,) = struct.unpack("<I", f.read(4))
        data = np.frombuffer(f.read(n * 50), dtype=np.uint8)
    rec = data.reshape(n, 50)
    floats = rec[:, :48].copy().view("<f4").reshape(n, 4, 3)
    return floats[:, 1:4, :].astype(float)


def write_stl(path: str, tris: np.ndarray, name: str = "surface") -> None:
    with open(path, "w") as f:
        f.write(f"solid {name}\n")
        for t in tris:
            n = np.cross(t[1] - t[0], t[2] - t[0])
            n = n / max(np.linalg.norm(n), 1e-300)
            f.write(f" facet normal {n[0]} {n[1]} {n[2]}\n"
                    "  outer loop\n")
            for v in t:
                f.write(f"   vertex {v[0]} {v[1]} {v[2]}\n")
            f.write("  endloop\n endfacet\n")
        f.write(f"endsolid {name}\n")


# ---------------------------------------------------------------------------
# inside/outside classification (reference: meshRefinement uses the
# octree searchableSurface; here vectorised ray-parity casting)
# ---------------------------------------------------------------------------


def _ray_parity(tris: np.ndarray, pts: np.ndarray, d: np.ndarray,
                chunk: int) -> np.ndarray:
    v0 = tris[:, 0]
    e1 = tris[:, 1] - v0
    e2 = tris[:, 2] - v0
    d = d / np.linalg.norm(d)
    h = np.cross(d, e2)                     # [nT,3]
    a = np.einsum("td,td->t", e1, h)
    ok = np.abs(a) > 1e-14
    inv_a = np.where(ok, 1.0 / np.where(ok, a, 1.0), 0.0)
    out = np.zeros(pts.shape[0], dtype=bool)
    for s in range(0, pts.shape[0], chunk):
        p = pts[s:s + chunk]
        sv = p[:, None, :] - v0[None, :, :]          # [nP,nT,3]
        u = np.einsum("ptd,td->pt", sv, h) * inv_a
        q = np.cross(sv, e1[None, :, :])
        vpar = np.einsum("ptd,d->pt", q, d) * inv_a
        t_hit = np.einsum("ptd,td->pt", q, e2) * inv_a
        hit = (ok[None, :] & (u >= 0) & (vpar >= 0)
               & (u + vpar <= 1) & (t_hit > 1e-12))
        out[s:s + chunk] = (hit.sum(axis=1) % 2) == 1
    return out


def points_inside(tris: np.ndarray, pts: np.ndarray,
                  chunk: int = 2000) -> np.ndarray:
    """Generalised winding number inside test (van Oosterom-Strackee
    solid angles; Jacobson et al. 2013): w(p) = 1/4pi sum of signed
    solid angles, > 1/2 means inside. Exact for closed oriented
    surfaces and — unlike single-ray parity, which double-counts when
    a ray grazes shared edges/vertices (UV-sphere poles, dirty STL) —
    has no direction-dependent failure mode. Winding degrades
    gracefully on near-closed dirty surfaces."""
    out = np.zeros(pts.shape[0], dtype=bool)
    t0, t1, t2 = tris[:, 0], tris[:, 1], tris[:, 2]
    for s in range(0, pts.shape[0], chunk):
        p = pts[s:s + chunk][:, None, :]
        a = t0[None] - p
        b = t1[None] - p
        c = t2[None] - p
        la = np.linalg.norm(a, axis=2)
        lb = np.linalg.norm(b, axis=2)
        lc = np.linalg.norm(c, axis=2)
        num = np.einsum("ptd,ptd->pt", a, np.cross(b, c))
        den = (la * lb * lc + np.einsum("ptd,ptd->pt", a, b) * lc
               + np.einsum("ptd,ptd->pt", b, c) * la
               + np.einsum("ptd,ptd->pt", c, a) * lb)
        omega = 2.0 * np.arctan2(num, den)
        w = omega.sum(axis=1) / (4.0 * np.pi)
        out[s:s + chunk] = w > 0.5
    return out


# ---------------------------------------------------------------------------
# castellation: remove cells on the far side of the surface
# ---------------------------------------------------------------------------


def castellate(pm: PolyMesh, tris: np.ndarray,
               location_in_mesh, body_patch: str = "body") -> PolyMesh:
    """Keep the cells on `location_in_mesh`'s side of the surface; the
    exposed internal faces become the `body_patch` wall (reference:
    meshRefinement::splitMesh / the castellated stage)."""
    loc = np.asarray(location_in_mesh, dtype=float).reshape(1, 3)
    inside = points_inside(tris, pm.c)
    keep = inside == bool(points_inside(tris, loc)[0])
    if not keep.any():
        raise ValueError("castellate would remove every cell")
    nif = pm.n_internal_faces
    own, nei = pm.owner, pm.neighbour
    new_id = np.cumsum(keep) - 1

    # classify faces
    both = keep[own[:nif]] & keep[nei]
    o_only = keep[own[:nif]] & ~keep[nei]
    n_only = ~keep[own[:nif]] & keep[nei]

    def face_rows(idx, flip=False):
        fp = pm.face_pts[idx]
        npts = pm.face_npts[idx]
        if flip:
            fp = fp.copy()
            for r in range(fp.shape[0]):
                k = npts[r]
                fp[r, :k] = fp[r, :k][::-1]
        return fp, npts

    # internal faces kept: enforce owner < neighbour (flip if needed)
    int_idx = np.nonzero(both)[0]
    io = new_id[own[int_idx]]
    ineb = new_id[nei[int_idx]]
    swap = io > ineb
    fp_i, np_i = face_rows(int_idx)
    fp_sw, _ = face_rows(int_idx[swap], flip=True)
    fp_i[swap] = fp_sw
    io2 = np.where(swap, ineb, io)
    ine2 = np.where(swap, io, ineb)
    order = np.lexsort((ine2, io2))
    fp_i, np_i, io2, ine2 = fp_i[order], np_i[order], io2[order], ine2[order]

    # boundary faces: original patches (owner kept), then the body
    faces_b: List[np.ndarray] = []
    npts_b: List[np.ndarray] = []
    own_b: List[np.ndarray] = []
    patches: List[Patch] = []
    start = fp_i.shape[0]
    for p in pm.patches:
        idx = np.arange(p.start, p.start + p.size)
        idx = idx[keep[own[idx]]]
        fp, npts = face_rows(idx)
        faces_b.append(fp)
        npts_b.append(npts)
        own_b.append(new_id[own[idx]])
        patches.append(Patch(name=p.name, type=p.type, start=start,
                             size=idx.shape[0]))
        start += idx.shape[0]
    # body faces: owner-kept keep orientation; neighbour-kept flip
    bo_idx = np.nonzero(o_only)[0]
    bn_idx = np.nonzero(n_only)[0]
    fp_bo, np_bo = face_rows(bo_idx)
    fp_bn, np_bn = face_rows(bn_idx, flip=True)
    faces_b += [fp_bo, fp_bn]
    npts_b += [np_bo, np_bn]
    own_b += [new_id[own[bo_idx]], new_id[nei[bn_idx]]]
    n_body = bo_idx.shape[0] + bn_idx.shape[0]
    patches.append(Patch(name=body_patch, type="wall", start=start,
                         size=n_body))

    max_pts = pm.face_pts.shape[1]

    def pad_cat(lst):
        return (np.concatenate(lst, axis=0) if lst
                else np.zeros((0, max_pts), dtype=pm.face_pts.dtype))

    face_pts = np.concatenate([fp_i, pad_cat(faces_b)], axis=0)
    face_npts = np.concatenate([np_i] + npts_b, axis=0)
    owner = np.concatenate([io2] + own_b, axis=0)
    neighbour = ine2

    # compact points
    used = np.zeros(pm.n_points, dtype=bool)
    valid = (np.arange(max_pts)[None, :]
             < face_npts[:, None]) & (face_pts >= 0)
    used[face_pts[valid]] = True
    pmap = np.cumsum(used) - 1
    face_pts = np.where(valid, pmap[np.clip(face_pts, 0, None)], -1)
    points = pm.points[used]

    return PolyMesh(points=points, face_pts=face_pts,
                    face_npts=face_npts, owner=owner,
                    neighbour=neighbour, patches=patches)


# ---------------------------------------------------------------------------
# snappyHexMeshDict driver (castellated only)
# ---------------------------------------------------------------------------


def _background_box(pm: PolyMesh):
    """(bb_min, bb_max, (nx,ny,nz), side_patches, two_d) when the
    background is a uniform axis-aligned box mesh, else None."""
    pts = pm.points
    bb_min, bb_max = pts.min(axis=0), pts.max(axis=0)
    ns = []
    for ax in range(3):
        u = np.unique(np.round(pts[:, ax], 12))
        ns.append(len(u) - 1)
        if len(u) > 2:
            d = np.diff(u)
            if d.max() - d.min() > 1e-9 * max(d.max(), 1e-300):
                return None  # graded
    nx, ny, nz = ns
    if nx * ny * nz != pm.n_cells:
        return None
    side_patches = {}
    nif = pm.n_internal_faces
    axes = "xyz"
    for p in pm.patches:
        idx = np.arange(p.start, p.start + p.size)
        if idx.size == 0:
            continue
        n = pm.sf[idx].mean(axis=0)
        ax = int(np.argmax(np.abs(n)))
        sgn = "+" if n[ax] > 0 else "-"
        side_patches.setdefault(f"{axes[ax]}{sgn}", (p.name, p.type))
        # a patch can cover several sides: register each face's side
        for f in idx:
            nf = pm.sf[f]
            axf = int(np.argmax(np.abs(nf)))
            sgnf = "+" if nf[axf] > 0 else "-"
            side_patches.setdefault(f"{axes[axf]}{sgnf}",
                                    (p.name, p.type))
    two_d = nz == 1 and any(p.type == "empty" for p in pm.patches)
    return bb_min, bb_max, (nx, ny, nz), side_patches, two_d


def from_dict(case_dir: str, d, pm: PolyMesh) -> PolyMesh:
    """system/snappyHexMeshDict -> castellate (+ octree refinement on
    uniform box backgrounds) (+ snap when `snap true;`) (+ boundary
    layers when `addLayers true;` via addLayersControls). Reads the
    first triSurfaceMesh entry in geometry{} from
    constant/triSurface/."""
    geom = d.get("geometry")
    stl_file = None
    body = "body"
    if geom is not None:
        for name, spec in geom.items():
            if not hasattr(spec, "get"):
                continue
            if str(spec.get("type", "")) == "triSurfaceMesh":
                stl_file = str(spec.get("file", name)).strip('"')
                body = str(spec.get("name", os.path.splitext(
                    str(name))[0]))
                break
    if stl_file is None:
        raise ValueError("snappyHexMeshDict: no triSurfaceMesh geometry")
    cc = d.get("castellatedMeshControls", {})
    loc = cc.get("locationInMesh", (0.0, 0.0, 0.0))
    loc = np.asarray(loc, dtype=float).reshape(3)
    tris = read_stl(os.path.join(case_dir, "constant", "triSurface",
                                 stl_file))

    # refinement level from refinementSurfaces { <name> { level (a b) } }
    level = 0
    rs = cc.get("refinementSurfaces", {})
    if hasattr(rs, "items"):
        for name, spec in rs.items():
            if hasattr(spec, "get"):
                lv = np.asarray(spec.get("level", 0)).ravel()
                if lv.size:
                    level = max(level, int(lv.max()))
    work = pm
    if level > 0:
        box = _background_box(pm)
        if box is not None:
            bb_min, bb_max, base_n, side_patches, two_d = box
            leaves = octree_refine(bb_min, bb_max, base_n, tris, level,
                                   two_d=two_d)
            work = octree_mesh(bb_min, bb_max, base_n, leaves,
                               side_patches, two_d=two_d)

    out = castellate(work, tris, loc, body_patch=body)

    do_snap = str(d.get("snap", "false")).lower() in ("true", "yes",
                                                      "on", "1")
    if do_snap:
        sc = d.get("snapControls", {})
        n_iter = int(sc.get("nSolveIter", 5)) if hasattr(sc, "get") else 5
        out = snap(out, tris, body_patch=body, n_iter=min(n_iter, 10))

    # LAYER stage (reference: autoLayerDriver; mesh/layers.py)
    do_layers = str(d.get("addLayers", "false")).lower() in (
        "true", "yes", "on", "1")
    if do_layers:
        from . import layers as layers_mod

        lc = d.get("addLayersControls", {})
        n_l, exp, rel = 3, 1.2, 0.3
        if hasattr(lc, "get"):
            exp = float(lc.get("expansionRatio", 1.2))
            rel = float(lc.get("finalLayerThickness", 0.3))
            lay = lc.get("layers", {})
            if hasattr(lay, "items"):
                for lname, lspec in lay.items():
                    if hasattr(lspec, "get"):
                        n_l = int(lspec.get("nSurfaceLayers", 3))
        out = layers_mod.add_layers(out, body, n_layers=n_l,
                                    expansion=exp, rel_total=rel)
    return out


# ---------------------------------------------------------------------------
# SNAP stage: project castellated boundary points onto the surface
# (reference: src/mesh/autoMesh/autoHexMeshDriver/autoSnapDriver*)
# ---------------------------------------------------------------------------


def nearest_on_tris(tris: np.ndarray, pts: np.ndarray,
                    chunk: int = 4000) -> np.ndarray:
    """Closest point on the triangle soup for each query point
    (vectorised point-triangle projection; Ericson, Real-Time
    Collision Detection §5.1.5)."""
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    ab = b - a
    ac = c - a
    out = np.empty_like(pts)
    for s in range(0, pts.shape[0], chunk):
        p = pts[s:s + chunk]                       # [nP,3]
        ap = p[:, None, :] - a[None, :, :]          # [nP,nT,3]
        d1 = np.einsum("td,ptd->pt", ab, ap)
        d2 = np.einsum("td,ptd->pt", ac, ap)
        bp = p[:, None, :] - b[None, :, :]
        d3 = np.einsum("td,ptd->pt", ab, bp)
        d4 = np.einsum("td,ptd->pt", ac, bp)
        cp = p[:, None, :] - c[None, :, :]
        d5 = np.einsum("td,ptd->pt", ab, cp)
        d6 = np.einsum("td,ptd->pt", ac, cp)
        va = d3 * d6 - d5 * d4
        vb = d5 * d2 - d1 * d6
        vc = d1 * d4 - d3 * d2
        denom = np.maximum(va + vb + vc, 1e-300)
        v = np.clip(vb / denom, 0.0, 1.0)
        w = np.clip(vc / denom, 0.0, 1.0)
        # interior candidate
        cand = a[None] + v[..., None] * ab[None] + w[..., None] * ac[None]
        # vertex / edge regions
        with np.errstate(divide="ignore", invalid="ignore"):
            t_ab = np.clip(np.where(d1 - d3 != 0, d1 / np.maximum(
                d1 - d3, 1e-300), 0.0), 0.0, 1.0)
            t_ac = np.clip(np.where(d2 - d6 != 0, d2 / np.maximum(
                d2 - d6, 1e-300), 0.0), 0.0, 1.0)
            t_bc = np.clip((d4 - d3) / np.maximum(
                (d4 - d3) + (d5 - d6), 1e-300), 0.0, 1.0)
        cand_a = np.broadcast_to(a[None], cand.shape)
        cand_b = np.broadcast_to(b[None], cand.shape)
        cand_c = np.broadcast_to(c[None], cand.shape)
        cand_ab = a[None] + t_ab[..., None] * ab[None]
        cand_ac = a[None] + t_ac[..., None] * ac[None]
        cand_bc = b[None] + t_bc[..., None] * (c - b)[None]
        # region selection
        sel = cand.copy()
        sel = np.where(((vc <= 0) & (d1 >= 0) & (d3 <= 0))[..., None],
                       cand_ab, sel)
        sel = np.where(((vb <= 0) & (d2 >= 0) & (d6 <= 0))[..., None],
                       cand_ac, sel)
        sel = np.where(((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0))[
                           ..., None], cand_bc, sel)
        sel = np.where(((d1 <= 0) & (d2 <= 0))[..., None], cand_a, sel)
        sel = np.where(((d3 >= 0) & (d4 <= d3))[..., None], cand_b, sel)
        sel = np.where(((d6 >= 0) & (d5 <= d6))[..., None], cand_c, sel)
        d2_all = np.einsum("ptd,ptd->pt", p[:, None, :] - sel,
                           p[:, None, :] - sel)
        best = np.argmin(d2_all, axis=1)
        out[s:s + chunk] = sel[np.arange(p.shape[0]), best]
    return out


def snap(pm: PolyMesh, tris: np.ndarray, body_patch: str = "body",
         n_iter: int = 5, relax: float = 0.7) -> PolyMesh:
    """Snap the `body_patch` boundary points onto the tri-surface with
    under-relaxed projection and a cell-quality guard: any move that
    would produce a non-positive cell volume or crush a cell below 20%
    of its castellated volume is rolled back by bisection (reference:
    autoSnapDriver::scaleMesh quality-controlled relaxation)."""
    bp = None
    for p in pm.patches:
        if p.name == body_patch:
            bp = p
            break
    if bp is None or bp.size == 0:
        return pm
    fids = np.arange(bp.start, bp.start + bp.size)
    valid = (np.arange(pm.face_pts.shape[1])[None, :]
             < pm.face_npts[fids, None]) & (pm.face_pts[fids] >= 0)
    pids = np.unique(pm.face_pts[fids][valid])

    # freeze hanging nodes (octree level transitions): pre-snap they
    # sit exactly at edge midpoints / face centres of coarser faces —
    # moving them would open the coarse cells (the coarse face polygon
    # does not reference them). Identify by coordinate matching.
    def _rk(arr):
        return {tuple(x) for x in np.round(arr, 9)}

    maxp = pm.face_pts.shape[1]
    fpts = pm.face_pts
    fnp = pm.face_npts
    P = pm.points
    mids = []
    for r in range(maxp):
        rows = np.nonzero(fnp > r)[0]
        if rows.size == 0:
            continue
        a = fpts[rows, r]
        nxt_col = np.minimum(r + 1, maxp - 1)
        nxt = np.where(r + 1 < fnp[rows], fpts[rows, nxt_col],
                       fpts[rows, 0])
        ok = (a >= 0) & (nxt >= 0)
        mids.append((P[a[ok]] + P[nxt[ok]]) / 2.0)
    quad = np.nonzero(fnp == 4)[0]
    if quad.size:
        mids.append(P[fpts[quad, :4]].mean(axis=1))
    hang = _rk(np.concatenate(mids, axis=0)) if mids else set()
    keep = np.array([tuple(x) not in hang
                     for x in np.round(P[pids], 9)])
    pids = pids[keep]

    # additionally freeze points that touch any NON-finest cell: at
    # octree fringe zones a coarse cell can own body faces, and moving
    # points that its other (coarse-quad) faces reference only through
    # straight edges opens the cell. The surface band is refined to
    # the finest level, so this only pins the few fringe points.
    v_fine = pm.v[pm.owner[fids]].min()
    cell_big = pm.v > 1.5 * v_fine
    if cell_big.any():
        pt_big = np.zeros(pm.n_points, dtype=bool)
        nifm = pm.n_internal_faces
        vv = (np.arange(maxp)[None, :] < fnp[:, None]) & (fpts >= 0)
        face_big = cell_big[pm.owner].copy()
        face_big[:nifm] |= cell_big[pm.neighbour]
        rows = np.nonzero(face_big)[0]
        sel = vv[rows]
        pt_big[fpts[rows][sel]] = True
        pids = pids[~pt_big[pids]]

    points = pm.points.copy()
    v0 = pm.v.copy()

    def trial_mesh(pts):
        return PolyMesh(points=pts, face_pts=pm.face_pts,
                        face_npts=pm.face_npts, owner=pm.owner,
                        neighbour=pm.neighbour, patches=pm.patches,
                        face_shift=pm.face_shift)

    nifm = pm.n_internal_faces
    for _ in range(n_iter):
        target = nearest_on_tris(tris, points[pids])
        move = relax * (target - points[pids])
        scale = np.ones(pids.shape[0])
        for bisect in range(5):
            trial_pts = points.copy()
            trial_pts[pids] = points[pids] + scale[:, None] * move
            tm = trial_mesh(trial_pts)
            bad_cell = tm.v <= 0.2 * v0
            # boundary faces must stay outward-oriented and non-zero
            dots = np.einsum("fd,fd->f", tm.sf[nifm:],
                             tm.cf[nifm:] - tm.c[pm.owner[nifm:]])
            bad_bf = np.nonzero(
                (dots <= 0) | (tm.mag_sf[nifm:]
                               <= 1e-4 * pm.mag_sf[nifm:]))[0] + nifm
            if not bad_cell.any() and bad_bf.size == 0:
                break
            bad_faces = np.concatenate([
                fids[bad_cell[pm.owner[fids]]], bad_bf])
            bvl = (np.arange(pm.face_pts.shape[1])[None, :]
                   < pm.face_npts[bad_faces, None]) \
                & (pm.face_pts[bad_faces] >= 0)
            bad_pids = np.unique(pm.face_pts[bad_faces][bvl])
            factor = 0.0 if bisect >= 3 else 0.5
            scale[np.isin(pids, bad_pids)] *= factor
        # apply the final (possibly zeroed) scale
        trial_pts = points.copy()
        trial_pts[pids] = points[pids] + scale[:, None] * move
        points = trial_pts

    return PolyMesh(points=points, face_pts=pm.face_pts,
                    face_npts=pm.face_npts, owner=pm.owner,
                    neighbour=pm.neighbour, patches=pm.patches,
                    face_shift=pm.face_shift)


# ---------------------------------------------------------------------------
# Octree surface refinement (reference: src/mesh/autoMesh/
# meshRefinement/ — refinementSurfaces levels). Implemented as a
# 2:1-balanced octree over the (uniform box) background lattice,
# rebuilt into a polyMesh with split faces at level transitions — the
# same storage dynamicRefineFvMesh uses. Constraint (documented): the
# background must be a uniform box mesh (the motorBike/bluffBody
# pattern); graded backgrounds fall back to single-level castellation.
# ---------------------------------------------------------------------------


def _tris_aabb_overlap(tris: np.ndarray, lo: np.ndarray,
                       hi: np.ndarray) -> np.ndarray:
    """Conservative triangle/box overlap per (cell, any-tri): cells
    whose AABB intersects any triangle AABB, then distance-filtered by
    nearest point. lo/hi [nCand,3]."""
    tmin = tris.min(axis=1)       # [nT,3]
    tmax = tris.max(axis=1)
    out = np.zeros(lo.shape[0], dtype=bool)
    chunk = 2048
    for s in range(0, lo.shape[0], chunk):
        l, h = lo[s:s + chunk], hi[s:s + chunk]
        ov = np.all((l[:, None, :] <= tmax[None]) &
                    (h[:, None, :] >= tmin[None]), axis=2)
        out[s:s + chunk] = ov.any(axis=1)
    return out


def octree_refine(bb_min, bb_max, base_n, tris: np.ndarray,
                  max_level: int, two_d: bool = False):
    """Leaf set of a 2:1-balanced octree: cells within the base lattice
    refined to `max_level` where they intersect the surface. Returns
    {(level, i, j, k), ...}."""
    bb_min = np.asarray(bb_min, float)
    bb_max = np.asarray(bb_max, float)
    ext = bb_max - bb_min
    nx, ny, nz = base_n

    def cell_bounds(lvl, idx):
        f = 2 ** lvl
        n = np.array([nx * f, ny * f, nz if two_d else nz * f], float)
        lo = bb_min + idx / n * ext
        hi = bb_min + (idx + 1) / n * ext
        return lo, hi

    leaves = {}
    ii, jj, kk = np.meshgrid(np.arange(nx), np.arange(ny),
                             np.arange(nz), indexing="ij")
    for i, j, k in zip(ii.ravel(), jj.ravel(), kk.ravel()):
        leaves[(0, int(i), int(j), int(k))] = True

    for lvl in range(max_level):
        cand = [c for c in leaves if c[0] == lvl]
        if not cand:
            break
        idx = np.array([[c[1], c[2], c[3]] for c in cand], float)
        lo, hi = cell_bounds(lvl, idx)
        near = _tris_aabb_overlap(tris, lo, hi)
        for c, n in zip(cand, near):
            if not n:
                continue
            del leaves[c]
            _, i, j, k = c
            krange = (k,) if two_d else (2 * k, 2 * k + 1)
            for ci in (2 * i, 2 * i + 1):
                for cj in (2 * j, 2 * j + 1):
                    for ck in krange:
                        leaves[(lvl + 1, ci, cj, ck)] = True
        # 2:1 balance: refine any leaf with a neighbour 2 levels finer
        changed = True
        while changed:
            changed = False
            fine = {(c[1] // (2 ** (c[0] - l)), c[2] // (2 ** (c[0] - l)),
                     c[3] if two_d else c[3] // (2 ** (c[0] - l)), l)
                    for c in leaves for l in (c[0] - 2,) if c[0] - 2 >= 0}
            for (pi, pj, pk, l) in list(fine):
                # any leaf at level l touching a grandchild region must
                # not exist coarser than l+1: refine level-l leaves that
                # NEIGHBOUR a level-(l+2) leaf
                pass
            # direct check: for each leaf L at level l, look for leaves
            # at level >= l+2 sharing a face -> refine L
            by_level = {}
            for c in leaves:
                by_level.setdefault(c[0], set()).add(c[1:])
            max_l = max(by_level)
            for l in sorted(by_level):
                if l + 2 > max_l:
                    continue
                for cell in list(by_level.get(l, ())):
                    if (l, *cell) not in leaves:
                        continue
                    i, j, k = cell
                    needs = False
                    for fl in range(l + 2, max_l + 1):
                        f = 2 ** (fl - l)
                        kf = k if two_d else k * f
                        kspan = (kf,) if two_d else range(kf, kf + f)
                        for (di, dj, dk) in ((1, 0, 0), (-1, 0, 0),
                                             (0, 1, 0), (0, -1, 0),
                                             (0, 0, 1), (0, 0, -1)):
                            if two_d and dk:
                                continue
                            # fine cells adjacent across this face
                            if di == 1:
                                xs = ((i + 1) * f,)
                            elif di == -1:
                                xs = (i * f - 1,)
                            else:
                                xs = range(i * f, (i + 1) * f)
                            if dj == 1:
                                ys = ((j + 1) * f,)
                            elif dj == -1:
                                ys = (j * f - 1,)
                            else:
                                ys = range(j * f, (j + 1) * f)
                            if dk == 1:
                                zs = ((k + 1) * f,)
                            elif dk == -1:
                                zs = (k * f - 1,)
                            else:
                                zs = kspan
                            lv = by_level.get(fl, set())
                            if any((x, y, z) in lv for x in xs
                                   for y in ys for z in zs):
                                needs = True
                                break
                        if needs:
                            break
                    if needs:
                        del leaves[(l, i, j, k)]
                        by_level[l].discard(cell)
                        krange = (k,) if two_d else (2 * k, 2 * k + 1)
                        for ci in (2 * i, 2 * i + 1):
                            for cj in (2 * j, 2 * j + 1):
                                for ck in krange:
                                    leaves[(l + 1, ci, cj, ck)] = True
                                    by_level.setdefault(
                                        l + 1, set()).add((ci, cj, ck))
                        changed = True
    return set(leaves)


def octree_mesh(bb_min, bb_max, base_n, leaves, side_patches,
                two_d: bool = False) -> PolyMesh:
    """Build a polyMesh from an octree leaf set. Level transitions
    produce split faces (the coarse cell simply owns 4 — 2 in 2D —
    faces against the fine cells), exactly the face-addressed storage
    the FV layer consumes. side_patches: {side: (name, type)} for
    "x-","x+","y-","y+","z-","z+"."""
    bb_min = np.asarray(bb_min, float)
    bb_max = np.asarray(bb_max, float)
    ext = bb_max - bb_min
    nx, ny, nz = base_n
    L = max(c[0] for c in leaves) if leaves else 0
    F = 2 ** L
    NX, NY = nx * F, ny * F
    NZ = nz if two_d else nz * F

    cells = sorted(leaves)
    cid = {c: i for i, c in enumerate(cells)}

    def span(c):
        l, i, j, k = c
        f = 2 ** (L - l)
        if two_d:
            return (i * f, (i + 1) * f, j * f, (j + 1) * f, k, k + 1)
        return (i * f, (i + 1) * f, j * f, (j + 1) * f,
                k * f, (k + 1) * f)

    # index leaves by their fine-lattice lower corner for neighbour
    # lookup: for a query fine cell column, walk levels
    lookup = {}
    for c in cells:
        x0, x1, y0, y1, z0, z1 = span(c)
        lookup[(x0, y0, z0, x1 - x0)] = c
    by_corner = {}
    for c in cells:
        x0, x1, y0, y1, z0, z1 = span(c)
        by_corner[(x0, y0, z0)] = c

    def leaf_at(x, y, z):
        """Leaf containing fine-lattice cell (x,y,z), or None."""
        if not (0 <= x < NX and 0 <= y < NY and 0 <= z < NZ):
            return None
        for l in range(L, -1, -1):
            f = 2 ** (L - l)
            key = (l, x // f, y // f, (z if two_d else z // f))
            if key in cid:
                return key
        return None

    pts = {}

    def pid(x, y, z):
        key = (x, y, z)
        if key not in pts:
            pts[key] = len(pts)
        return pts[key]

    ifaces = []   # (own, nei, quad) normal own->nei
    bfaces = {s: [] for s in ("x-", "x+", "y-", "y+", "z-", "z+")}

    # z-point scale: in 2D the z lattice has nz(+1) points regardless
    def zpt(z):
        return z

    for c in cells:
        me = cid[c]
        x0, x1, y0, y1, z0, z1 = span(c)
        w = x1 - x0  # face width in fine units (z width differs in 2D)

        # +x / -x
        for sgn, xq in ((1, x1), (-1, x0 - 1)):
            face_x = x1 if sgn > 0 else x0
            # neighbour query at my refinement granularity
            sub = []
            zr = range(z0, z1) if not two_d else [z0]
            nb0 = leaf_at(xq if sgn > 0 else x0 - 1, y0, z0)
            if nb0 is None:
                # domain boundary
                quad = [(face_x, y0, z0), (face_x, y1, z0),
                        (face_x, y1, z1), (face_x, y0, z1)]
                if sgn < 0:
                    quad = quad[::-1]
                bfaces["x+" if sgn > 0 else "x-"].append((me, quad, sgn))
                continue
            l_nb = nb0[0]
            if l_nb < c[0] or (l_nb == c[0] and sgn > 0):
                # I am finer (or equal with +dir): I generate the face
                nb = nb0
                quad = [(face_x, y0, z0), (face_x, y1, z0),
                        (face_x, y1, z1), (face_x, y0, z1)]
                if sgn > 0:
                    ifaces.append((me, cid[nb], quad))
                else:
                    ifaces.append((me, cid[nb], quad[::-1]))
        # +y / -y
        for sgn in (1, -1):
            yq = y1 if sgn > 0 else y0 - 1
            face_y = y1 if sgn > 0 else y0
            nb0 = leaf_at(x0, yq, z0)
            if nb0 is None:
                quad = [(x0, face_y, z0), (x0, face_y, z1),
                        (x1, face_y, z1), (x1, face_y, z0)]
                if sgn < 0:
                    quad = quad[::-1]
                bfaces["y+" if sgn > 0 else "y-"].append((me, quad, sgn))
                continue
            l_nb = nb0[0]
            if l_nb < c[0] or (l_nb == c[0] and sgn > 0):
                quad = [(x0, face_y, z0), (x0, face_y, z1),
                        (x1, face_y, z1), (x1, face_y, z0)]
                if sgn > 0:
                    ifaces.append((me, cid[nb0], quad))
                else:
                    ifaces.append((me, cid[nb0], quad[::-1]))
        # +z / -z
        for sgn in (1, -1):
            zq = z1 if sgn > 0 else z0 - 1
            face_z = z1 if sgn > 0 else z0
            nb0 = leaf_at(x0, y0, zq)
            if nb0 is None:
                quad = [(x0, y0, face_z), (x1, y0, face_z),
                        (x1, y1, face_z), (x0, y1, face_z)]
                if sgn < 0:
                    quad = quad[::-1]
                bfaces["z+" if sgn > 0 else "z-"].append((me, quad, sgn))
                continue
            l_nb = nb0[0]
            if l_nb < c[0] or (l_nb == c[0] and sgn > 0):
                quad = [(x0, y0, face_z), (x1, y0, face_z),
                        (x1, y1, face_z), (x0, y1, face_z)]
                if sgn > 0:
                    ifaces.append((me, cid[nb0], quad))
                else:
                    ifaces.append((me, cid[nb0], quad[::-1]))

    # canonicalise internal faces: owner < neighbour, normal own->nei
    canon = []
    for own, nei, quad in ifaces:
        if own < nei:
            canon.append((own, nei, quad))
        else:
            canon.append((nei, own, quad[::-1]))
    canon.sort(key=lambda t: (t[0], t[1]))

    face_rows = []
    owners = []
    neighbours = []
    for own, nei, quad in canon:
        face_rows.append([pid(*q) for q in quad])
        owners.append(own)
        neighbours.append(nei)

    patches = []
    start = len(face_rows)
    for side in ("x-", "x+", "y-", "y+", "z-", "z+"):
        fl = bfaces[side]
        if not fl:
            continue
        name, ptype = side_patches.get(side, (side, "patch"))
        for me, quad, sgn in fl:
            face_rows.append([pid(*q) for q in quad])
            owners.append(me)
        patches.append(Patch(name=name, type=ptype, start=start,
                             size=len(fl)))
        start += len(fl)
    # merge patches with the same name (a background patch can span
    # multiple box sides)
    merged = {}
    order = []
    for p in patches:
        if p.name in merged:
            continue
        merged[p.name] = p
        order.append(p.name)
    if len(merged) != len(patches):
        # rebuild boundary grouping by name
        rows_b = face_rows[len(canon):]
        own_b = owners[len(canon):]
        groups = {}
        i = 0
        for p in patches:
            for _ in range(p.size):
                groups.setdefault(p.name, ([], [], p.type))
                groups[p.name][0].append(rows_b[i])
                groups[p.name][1].append(own_b[i])
                i += 1
        face_rows = face_rows[:len(canon)]
        owners = owners[:len(canon)]
        patches = []
        start = len(face_rows)
        for name in order:
            rws, ons, ptype = groups[name]
            face_rows += rws
            owners += ons
            patches.append(Patch(name=name, type=ptype, start=start,
                                 size=len(rws)))
            start += len(rws)

    # point coordinates
    npts = len(pts)
    pcoord = np.zeros((npts, 3))
    scale = np.array([NX, NY, NZ], float)
    for (x, y, z), i in pts.items():
        pcoord[i] = bb_min + np.array([x, y, z]) / scale * ext

    maxp = 4
    fp = np.full((len(face_rows), maxp), -1, dtype=np.int64)
    for i, row in enumerate(face_rows):
        fp[i, :len(row)] = row
    return PolyMesh(points=pcoord, face_pts=fp,
                    face_npts=np.full(len(face_rows), 4, dtype=np.int64),
                    owner=np.asarray(owners, dtype=np.int64),
                    neighbour=np.asarray(neighbours, dtype=np.int64),
                    patches=patches)
