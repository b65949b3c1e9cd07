"""mergeMeshes, subsetMesh, mirrorMesh, flattenMesh and autoPatch: host
numpy PolyMesh surgery, the commands writing the result through
io/polymesh (a host copy of openfoam-2.2.x_tpu/apps/meshutils2.py,
unchanged in behaviour; the reference module is loaded through the JAX
package). `_face_list`, `_pack_faces` and `_build` serve meshutils3.py
too.

mirrorMesh appends each mirrored internal face after its original and
fuses the boundary faces on the plane into internal faces after them, as
the reference does: the internal faces keep owner < neighbour but are
not in upper-triangular order.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..mesh.core import Patch, PolyMesh


def _face_list(pm: PolyMesh):
    """Faces as python lists of point ids."""
    return [list(pm.face_pts[f, :pm.face_npts[f]])
            for f in range(pm.n_faces)]


def _pack_faces(faces: List[List[int]]):
    mx = max(len(f) for f in faces)
    fp = np.full((len(faces), mx), -1, dtype=np.int64)
    fn = np.empty(len(faces), dtype=np.int64)
    for i, f in enumerate(faces):
        fp[i, :len(f)] = f
        fn[i] = len(f)
    return fp, fn


def _build(points, faces, owner, neighbour, patches) -> PolyMesh:
    fp, fn = _pack_faces(faces)
    return PolyMesh(points=np.asarray(points, float), face_pts=fp,
                    face_npts=fn, owner=np.asarray(owner, np.int64),
                    neighbour=np.asarray(neighbour, np.int64),
                    patches=patches)


# ---------------------------------------------------------------------------
# mergeMeshes (reference: .../mergeMeshes/): plain concatenation of two
# meshes — no stitching, exactly as the reference (stitchMesh connects)
# ---------------------------------------------------------------------------


def merge_meshes(pm1: PolyMesh, pm2: PolyMesh) -> PolyMesh:
    np1, nc1 = pm1.n_points, pm1.n_cells
    points = np.vstack([pm1.points, pm2.points])
    f1 = _face_list(pm1)
    f2 = [[p + np1 for p in f] for f in _face_list(pm2)]
    nif1, nif2 = pm1.n_internal_faces, pm2.n_internal_faces
    faces = ([f1[i] for i in range(nif1)]
             + [f2[i] for i in range(nif2)]
             + [f1[i] for i in range(nif1, pm1.n_faces)]
             + [f2[i] for i in range(nif2, pm2.n_faces)])
    owner = np.concatenate([
        pm1.owner[:nif1], pm2.owner[:nif2] + nc1,
        pm1.owner[nif1:], pm2.owner[nif2:] + nc1])
    neighbour = np.concatenate([pm1.neighbour, pm2.neighbour + nc1])
    patches = []
    start = nif1 + nif2
    for p in pm1.patches:
        patches.append(Patch(name=p.name, type=p.type, start=start,
                             size=p.size))
        start += p.size
    for p in pm2.patches:
        nm = p.name
        if any(q.name == nm for q in patches):
            nm = nm + "_1"
        patches.append(Patch(name=nm, type=p.type, start=start,
                             size=p.size))
        start += p.size
    return _build(points, faces, owner, neighbour, patches)


# ---------------------------------------------------------------------------
# subsetMesh (reference: .../subsetMesh/): extract a cellSet; exposed
# internal faces land on the `oldInternalFaces` patch
# ---------------------------------------------------------------------------


def subset_mesh(pm: PolyMesh, cells: np.ndarray,
                exposed_name: str = "oldInternalFaces") -> PolyMesh:
    keep = np.zeros(pm.n_cells, dtype=bool)
    keep[np.asarray(cells, int)] = True
    cell_map = -np.ones(pm.n_cells, dtype=np.int64)
    cell_map[keep] = np.arange(keep.sum())
    faces = _face_list(pm)
    nif = pm.n_internal_faces

    internal, int_own, int_nei = [], [], []
    by_patch: Dict[int, List] = {i: [] for i in range(len(pm.patches))}
    exposed = []
    for f in range(nif):
        o, n = pm.owner[f], pm.neighbour[f]
        if keep[o] and keep[n]:
            internal.append(faces[f])
            int_own.append(cell_map[o])
            int_nei.append(cell_map[n])
        elif keep[o]:
            exposed.append((faces[f], cell_map[o]))
        elif keep[n]:
            exposed.append((faces[f][::-1], cell_map[n]))
    for ip, p in enumerate(pm.patches):
        for f in range(p.start, p.start + p.size):
            if keep[pm.owner[f]]:
                by_patch[ip].append((faces[f], cell_map[pm.owner[f]]))

    all_faces = list(internal)
    owner = list(int_own)
    patches = []
    start = len(internal)
    for ip, p in enumerate(pm.patches):
        fs = by_patch[ip]
        patches.append(Patch(name=p.name, type=p.type, start=start,
                             size=len(fs)))
        for f, o in fs:
            all_faces.append(f)
            owner.append(o)
        start += len(fs)
    patches.append(Patch(name=exposed_name, type="patch", start=start,
                         size=len(exposed)))
    for f, o in exposed:
        all_faces.append(f)
        owner.append(o)

    # compact unused points
    used = np.zeros(pm.n_points, dtype=bool)
    for f in all_faces:
        used[f] = True
    pmap = -np.ones(pm.n_points, dtype=np.int64)
    pmap[used] = np.arange(used.sum())
    all_faces = [[int(pmap[p]) for p in f] for f in all_faces]
    return _build(pm.points[used], all_faces, owner, int_nei, patches)


# ---------------------------------------------------------------------------
# mirrorMesh (reference: .../mirrorMesh/): reflect about a plane and
# fuse faces lying on it
# ---------------------------------------------------------------------------


def mirror_mesh(pm: PolyMesh, point, normal, tol_frac=1e-6) -> PolyMesh:
    point = np.asarray(point, float)
    n = np.asarray(normal, float)
    n = n / np.linalg.norm(n)
    d = (pm.points - point) @ n
    scale = max(np.abs(d).max(), 1e-30)
    on_plane = np.abs(d) < tol_frac * scale

    npts, nc = pm.n_points, pm.n_cells
    refl = pm.points - 2.0 * d[:, None] * n[None, :]
    # mirrored point ids: on-plane points map to themselves
    mir_id = np.empty(npts, dtype=np.int64)
    new_pts = []
    nxt = npts
    for p in range(npts):
        if on_plane[p]:
            mir_id[p] = p
        else:
            mir_id[p] = nxt
            new_pts.append(refl[p])
            nxt += 1
    points = np.vstack([pm.points] + ([new_pts] if new_pts else []))

    faces = _face_list(pm)
    nif = pm.n_internal_faces
    internal, own, nei = [], [], []
    for f in range(nif):
        internal.append(faces[f])
        own.append(pm.owner[f])
        nei.append(pm.neighbour[f])
        # mirrored copy (reversed to keep owner->neighbour orientation)
        internal.append([int(mir_id[p]) for p in faces[f]][::-1])
        own.append(pm.owner[f] + nc)
        nei.append(pm.neighbour[f] + nc)
    # boundary faces ON the plane become internal: cell <-> mirror cell
    by_patch: Dict[int, List] = {i: [] for i in range(len(pm.patches))}
    for ip, p in enumerate(pm.patches):
        for f in range(p.start, p.start + p.size):
            pts = faces[f]
            if all(on_plane[q] for q in pts):
                internal.append(pts)
                own.append(pm.owner[f])
                nei.append(pm.owner[f] + nc)
            else:
                by_patch[ip].append((pts, pm.owner[f]))
                by_patch[ip].append((
                    [int(mir_id[q]) for q in pts][::-1],
                    pm.owner[f] + nc))
    # owner < neighbour canonicalisation
    for i in range(len(internal)):
        if own[i] > nei[i]:
            own[i], nei[i] = nei[i], own[i]
            internal[i] = internal[i][::-1]
    all_faces = list(internal)
    owner = list(own)
    patches = []
    start = len(internal)
    for ip, p in enumerate(pm.patches):
        fs = by_patch[ip]
        patches.append(Patch(name=p.name, type=p.type, start=start,
                             size=len(fs)))
        for fc, o in fs:
            all_faces.append(fc)
            owner.append(o)
        start += len(fs)
    return _build(points, all_faces, owner, nei, patches)


# ---------------------------------------------------------------------------
# flattenMesh (reference: .../flattenMesh/): snap the empty-direction
# coordinates of a 2D mesh onto two flat planes
# ---------------------------------------------------------------------------


def flatten_mesh(pm: PolyMesh) -> PolyMesh:
    # find the empty direction from an empty patch's normal
    axis = None
    for p in pm.patches:
        if p.type == "empty" and p.size:
            nvec = pm.sf[p.start]
            axis = int(np.argmax(np.abs(nvec)))
            break
    if axis is None:
        return pm
    z = pm.points[:, axis]
    zmin, zmax = z.min(), z.max()
    mid = 0.5 * (zmin + zmax)
    pts = pm.points.copy()
    pts[:, axis] = np.where(z < mid, zmin, zmax)
    out = PolyMesh(points=pts, face_pts=pm.face_pts,
                   face_npts=pm.face_npts, owner=pm.owner,
                   neighbour=pm.neighbour, patches=pm.patches,
                   face_shift=pm.face_shift,
                   cell_zones=pm.cell_zones)
    return out


# ---------------------------------------------------------------------------
# autoPatch (reference: .../autoPatch/): split the boundary into
# patches of connected faces bounded by a feature angle
# ---------------------------------------------------------------------------


def auto_patch(pm: PolyMesh, feature_angle_deg: float = 45.0
               ) -> PolyMesh:
    nif = pm.n_internal_faces
    nbf = pm.n_faces - nif
    nrm = pm.sf[nif:] / np.maximum(pm.mag_sf[nif:], 1e-300)[:, None]
    cos_t = np.cos(np.deg2rad(feature_angle_deg))
    # boundary-face adjacency via shared edges
    edge_faces: Dict[Tuple[int, int], List[int]] = {}
    faces = _face_list(pm)
    for bf in range(nbf):
        f = faces[nif + bf]
        for i in range(len(f)):
            e = tuple(sorted((f[i], f[(i + 1) % len(f)])))
            edge_faces.setdefault(e, []).append(bf)
    # flood fill with the angle constraint
    region = -np.ones(nbf, dtype=np.int64)
    nreg = 0
    for seed in range(nbf):
        if region[seed] >= 0:
            continue
        stack = [seed]
        region[seed] = nreg
        while stack:
            a = stack.pop()
            f = faces[nif + a]
            for i in range(len(f)):
                e = tuple(sorted((f[i], f[(i + 1) % len(f)])))
                for b in edge_faces.get(e, ()):
                    if region[b] < 0 and nrm[a] @ nrm[b] > cos_t:
                        region[b] = nreg
                        stack.append(b)
        nreg += 1
    order = np.argsort(region, kind="stable")
    all_faces = ([faces[i] for i in range(nif)]
                 + [faces[nif + int(i)] for i in order])
    owner = np.concatenate([pm.owner[:nif],
                            pm.owner[nif:][order]])
    patches = []
    start = nif
    for r in range(nreg):
        size = int((region == r).sum())
        patches.append(Patch(name=f"auto{r}", type="patch",
                             start=start, size=size))
        start += size
    return _build(pm.points, all_faces, owner, pm.neighbour, patches)
