"""polyTopoChange: layer addition/removal and attach/detach on layered
(extruded) meshes.

Host copy of openfoam-2.2.x_tpu/mesh/topo.py, unchanged in behaviour
(reference: src/dynamicMesh/polyTopoChange/, layerAdditionRemoval driven
by src/engine/engineMesh, and src/dynamicMesh/attachDetach/): numpy
throughout, on the port's own `mesh/core.py::PolyMesh`; the reference
module imports no jax either, but every `foamtpu.mesh` import loads it,
so the port carries the copy.

A topology event happens on the host between steps: the mesh is
re-extruded with one plane inserted or removed (or a plane's faces
detached into a wall pair), cell fields are remapped through the exact
conservative 1-D slab overlap matrix (the base grid is unchanged, so the
remap is per column), and the caller rebuilds the device mesh
(`to_device`). The port is eager: nothing is recompiled.

The mesh model: points lie on K+1 transverse planes along `axis`; every
cell spans exactly one slab (pair of adjacent planes); side walls are
parallel to the axis (prismatic). This is the mesh family the reference's
layerAdditionRemoval operates on (engine liners, valve gaps).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .core import Patch, PolyMesh


@dataclasses.dataclass
class LayerTopo:
    """Layered-mesh description, independent of the plane count."""

    axis: int
    planes: np.ndarray              # [K+1] ascending plane coords
    base_pts: np.ndarray            # [nB,3] transverse coords (axis col
    #                                 holds planes[0]; replaced on build)
    base_faces: List[List[int]]     # base polygons, CCW about +axis
    # per-base-cell patch of the bottom (planes[0]) / top (planes[-1])
    # boundary face
    bottom_patch: np.ndarray        # [nBase] patch index into patch_defs
    top_patch: np.ndarray           # [nBase]
    # boundary edges of the base mesh -> patch index
    edge_patch: Dict[Tuple[int, int], int]
    # (name, type) per patch, original mesh order
    patch_defs: List[Tuple[str, str]]
    # mapping of the ORIGINAL mesh's cells: cell -> (base, slab)
    cell_base: np.ndarray
    cell_slab: np.ndarray

    @property
    def n_base(self) -> int:
        return len(self.base_faces)

    @property
    def n_slabs(self) -> int:
        return self.planes.shape[0] - 1


def _cluster_planes(vals: np.ndarray, tol: float) -> np.ndarray:
    s = np.sort(np.unique(vals))
    planes = [s[0]]
    for v in s[1:]:
        if v - planes[-1] > tol:
            planes.append(v)
    return np.asarray(planes)


def analyze(pm: PolyMesh, axis: int, tol: Optional[float] = None
            ) -> LayerTopo:
    """Classify a prismatic layered mesh. Raises ValueError when the
    mesh is not a clean stack of layers along `axis` (the reference's
    layerAdditionRemoval likewise requires an extruded face zone)."""
    ax = pm.points[:, axis]
    span = float(ax.max() - ax.min())
    if tol is None:
        tol = max(span, 1e-30) * 1e-6
    planes = _cluster_planes(ax, tol)
    if planes.shape[0] < 3:
        raise ValueError("layered mesh needs >= 2 layers")
    point_plane = np.searchsorted(planes, ax - tol)
    if not np.all(np.abs(planes[point_plane] - ax) <= 2 * tol):
        raise ValueError("points do not lie on transverse planes "
                         "(mesh is not layered along this axis)")

    # transverse (base) identity of every point
    tr_cols = [i for i in range(3) if i != axis]
    tr = pm.points[:, tr_cols]
    p0_ids = np.nonzero(point_plane == 0)[0]
    base_xy = tr[p0_ids]
    try:
        from scipy.spatial import cKDTree
        tree = cKDTree(base_xy)
        dist, point_base = tree.query(tr)
    except Exception:  # pragma: no cover - scipy is baked in
        d2 = ((tr[:, None, :] - base_xy[None, :, :]) ** 2).sum(-1)
        point_base = d2.argmin(axis=1)
        dist = np.sqrt(d2[np.arange(tr.shape[0]), point_base])
    scale = max(float(np.abs(base_xy).max()), span, 1e-30)
    if float(dist.max()) > 1e-6 * scale:
        raise ValueError("side walls are not parallel to the axis "
                         "(non-prismatic layered mesh)")
    n_bp = base_xy.shape[0]

    # horizontal faces: every point on one plane
    nF = pm.n_faces
    maxp = pm.face_pts.shape[1]
    idx = np.arange(maxp)
    valid = idx[None, :] < pm.face_npts[:, None]
    fp = np.clip(pm.face_pts, 0, None)
    fpl = np.where(valid, point_plane[fp], -1)
    fpl_max = fpl.max(axis=1)
    fpl_min = np.where(valid, point_plane[fp], np.iinfo(np.int64).max
                       ).min(axis=1)
    horizontal = fpl_max == fpl_min
    face_plane = np.where(horizontal, fpl_max, -1)

    # slab of every cell: scatter "my bottom plane" from horizontal
    # faces (lower-centre cell of an internal horizontal face at plane
    # s has top plane s => slab s-1; upper cell has bottom plane s)
    nC = pm.n_cells
    cell_bot = np.full(nC, -1, dtype=np.int64)
    nif = pm.n_internal_faces
    c_ax = pm.c[:, axis]
    for f in np.nonzero(horizontal)[0]:
        s = int(face_plane[f])
        o = int(pm.owner[f])
        if f < nif:
            n = int(pm.neighbour[f])
            lo, hi = (o, n) if c_ax[o] < c_ax[n] else (n, o)
            cell_bot[hi] = s
            if s > 0:
                cell_bot[lo] = max(cell_bot[lo], s - 1) \
                    if cell_bot[lo] >= 0 else s - 1
        else:
            if s == 0:
                cell_bot[o] = 0
            elif s < planes.shape[0] - 1 and c_ax[o] > planes[s]:
                cell_bot[o] = s  # face below the cell
            # else: top face of the top slab — bottom set elsewhere
    if (cell_bot < 0).any():
        raise ValueError("cells without horizontal faces "
                         "(mesh is not layered)")
    cell_slab = cell_bot

    # base polygons from the plane-0 boundary faces (one per column)
    patch_of_face = np.full(nF, -1, dtype=np.int64)
    for pi, p in enumerate(pm.patches):
        patch_of_face[p.slice] = pi
    bot_faces = np.nonzero(horizontal & (face_plane == 0)
                           & (patch_of_face >= 0))[0]
    if bot_faces.size == 0:
        raise ValueError("no boundary faces on the bottom plane")
    g2b = np.full(pm.n_points, -1, dtype=np.int64)
    g2b[p0_ids] = point_base[p0_ids]
    base_faces: List[List[int]] = []
    bottom_patch = []
    base_centroid = []
    for f in bot_faces:
        k = int(pm.face_npts[f])
        row = [int(g2b[pt]) for pt in pm.face_pts[f, :k]]
        # stored boundary order has outward (-axis) normal; reverse for
        # a CCW-about-+axis base polygon
        base_faces.append(list(reversed(row)))
        bottom_patch.append(int(patch_of_face[f]))
        base_centroid.append(pm.cf[f][tr_cols])
    n_base = len(base_faces)
    base_centroid = np.asarray(base_centroid)

    # column id of every cell by transverse centre
    cc = pm.c[:, tr_cols]
    try:
        from scipy.spatial import cKDTree
        ctree = cKDTree(base_centroid)
        cdist, cell_base = ctree.query(cc)
    except Exception:  # pragma: no cover
        d2 = ((cc[:, None, :] - base_centroid[None, :, :]) ** 2).sum(-1)
        cell_base = d2.argmin(axis=1)
        cdist = np.sqrt(d2[np.arange(nC), cell_base])
    if float(cdist.max()) > 1e-5 * scale:
        raise ValueError("cell columns do not align with bottom faces")
    key = cell_slab * n_base + cell_base
    if np.unique(key).shape[0] != nC:
        raise ValueError("cell -> (base, slab) mapping is not a "
                         "bijection; mesh is not a clean stack")

    # top-face patch per column
    top_patch = np.full(n_base, -1, dtype=np.int64)
    top_faces = np.nonzero(horizontal
                           & (face_plane == planes.shape[0] - 1)
                           & (patch_of_face >= 0))[0]
    for f in top_faces:
        top_patch[cell_base[int(pm.owner[f])]] = int(patch_of_face[f])
    if (top_patch < 0).any():
        raise ValueError("missing top-plane boundary faces")

    # boundary side faces -> base-edge patch map
    edge_patch: Dict[Tuple[int, int], int] = {}
    side = np.nonzero((~horizontal) & (patch_of_face >= 0))[0]
    for f in side:
        k = int(pm.face_npts[f])
        pts = pm.face_pts[f, :k]
        pl = point_plane[pts]
        lo = pts[pl == pl.min()]
        if lo.shape[0] != 2:
            raise ValueError("side face without exactly 2 lower points")
        a, b = int(point_base[lo[0]]), int(point_base[lo[1]])
        kkey = (min(a, b), max(a, b))
        prev = edge_patch.get(kkey)
        pi = int(patch_of_face[f])
        if prev is not None and prev != pi:
            raise ValueError("base edge spans two patches across slabs")
        edge_patch[kkey] = pi

    base_pts = np.zeros((n_bp, 3))
    base_pts[:, tr_cols] = base_xy
    base_pts[:, axis] = planes[0]
    return LayerTopo(
        axis=axis, planes=planes, base_pts=base_pts,
        base_faces=base_faces,
        bottom_patch=np.asarray(bottom_patch, dtype=np.int64),
        top_patch=top_patch, edge_patch=edge_patch,
        patch_defs=[(p.name, p.type) for p in pm.patches],
        cell_base=cell_base, cell_slab=cell_slab)


def build(topo: LayerTopo, planes: np.ndarray,
          detach_planes: Tuple[int, ...] = ()) -> PolyMesh:
    """Re-extrude the base mesh over a new plane stack. Cell id =
    slab * n_base + base; patch names/types/order preserved.

    detach_planes: interior plane indices (1..K-1) whose horizontal
    faces become DETACHED — the attachDetach polyMesh modifier
    (reference: src/dynamicMesh/attachDetach/): instead of internal
    faces, each listed plane contributes a coincident wall-patch pair
    attach<l>Master (owner = lower cell, outward +axis) and
    attach<l>Slave (owner = upper cell, outward -axis). Cells and
    their ids are IDENTICAL with or without detachment — only the face
    list changes — so attach/detach events remap fields by identity
    and conserve everything exactly."""
    planes = np.asarray(planes, dtype=np.float64)
    K = planes.shape[0] - 1
    detach = set(int(d) for d in detach_planes)
    if any(d < 1 or d > K - 1 for d in detach):
        raise ValueError(f"detach plane out of range: {sorted(detach)}")
    nB = len(topo.base_faces)
    n_bp = topo.base_pts.shape[0]
    pts = np.tile(topo.base_pts, (K + 1, 1))
    for l in range(K + 1):
        pts[l * n_bp:(l + 1) * n_bp, topo.axis] = planes[l]

    def cell_id(b, l):
        return l * nB + b

    rows: List[List[int]] = []
    owner: List[int] = []
    neighbour: List[int] = []
    # internal horizontal faces (normal +axis, owner = lower cell)
    for l in range(1, K):
        if l in detach:
            continue
        for b, poly in enumerate(topo.base_faces):
            rows.append([pt + l * n_bp for pt in poly])
            owner.append(cell_id(b, l - 1))
            neighbour.append(cell_id(b, l))
    # vertical faces from base edges
    edge_users: Dict[Tuple[int, int], List[Tuple[int, Tuple[int, int]]]] \
        = {}
    for b, poly in enumerate(topo.base_faces):
        m = len(poly)
        for e in range(m):
            a, c = poly[e], poly[(e + 1) % m]
            edge_users.setdefault((min(a, c), max(a, c)), []).append(
                (b, (a, c)))
    side_rows: Dict[int, List[Tuple[List[int], int]]] = {}
    for kkey, users in edge_users.items():
        if len(users) == 2:
            (f0, (a, c)), (f1, _) = users
            ow, ne = (f0, f1) if f0 < f1 else (f1, f0)
            if ow != f0:
                a, c = users[1][1]
            for l in range(K):
                # (a, c) in the OWNER's CCW-about-+axis traversal =>
                # [a, c, c', a'] has the outward (owner->neighbour)
                # normal
                rows.append([a + l * n_bp, c + l * n_bp,
                             c + (l + 1) * n_bp, a + (l + 1) * n_bp])
                owner.append(cell_id(ow, l))
                neighbour.append(cell_id(ne, l))
        else:
            b, (a, c) = users[0]
            pi = topo.edge_patch.get(kkey)
            if pi is None:
                raise ValueError(f"boundary base edge {kkey} has no "
                                 "patch assignment")
            for l in range(K):
                side_rows.setdefault(pi, []).append((
                    [a + l * n_bp, c + l * n_bp,
                     c + (l + 1) * n_bp, a + (l + 1) * n_bp],
                    cell_id(b, l)))

    order = np.lexsort((np.asarray(neighbour), np.asarray(owner)))
    rows = [rows[i] for i in order]
    owner = [owner[i] for i in order]
    neighbour = [neighbour[i] for i in order]
    nif = len(rows)

    # boundary, original patch order
    patches: List[Patch] = []
    start = nif
    for pi, (name, ptype) in enumerate(topo.patch_defs):
        n0 = len(rows)
        for b in np.nonzero(topo.bottom_patch == pi)[0]:
            rows.append(list(reversed(topo.base_faces[int(b)])))
            owner.append(cell_id(int(b), 0))
        for b in np.nonzero(topo.top_patch == pi)[0]:
            rows.append([pt + K * n_bp
                         for pt in topo.base_faces[int(b)]])
            owner.append(cell_id(int(b), K - 1))
        for row, ow in side_rows.get(pi, ()):
            rows.append(row)
            owner.append(ow)
        size = len(rows) - n0
        if size:
            patches.append(Patch(name=name, type=ptype, start=start,
                                 size=size))
            start += size

    # detached-plane wall pairs (appended after the original patches so
    # patch indices of the attached topology are a prefix)
    for l in sorted(detach):
        for b, poly in enumerate(topo.base_faces):
            rows.append([pt + l * n_bp for pt in poly])
            owner.append(cell_id(b, l - 1))
        patches.append(Patch(name=f"attach{l}Master", type="wall",
                             start=start, size=nB))
        start += nB
        for b, poly in enumerate(topo.base_faces):
            rows.append([pt + l * n_bp for pt in reversed(poly)])
            owner.append(cell_id(b, l))
        patches.append(Patch(name=f"attach{l}Slave", type="wall",
                             start=start, size=nB))
        start += nB

    maxp = max(len(r) for r in rows)
    face_pts = np.full((len(rows), maxp), -1, dtype=np.int64)
    face_npts = np.zeros(len(rows), dtype=np.int64)
    for i, r in enumerate(rows):
        face_pts[i, :len(r)] = r
        face_npts[i] = len(r)
    return PolyMesh(points=pts, face_pts=face_pts, face_npts=face_npts,
                    owner=np.asarray(owner, dtype=np.int64),
                    neighbour=np.asarray(neighbour, dtype=np.int64),
                    patches=patches)


def slab_overlap_matrix(old_planes: np.ndarray, new_planes: np.ndarray
                        ) -> np.ndarray:
    """W[k_new, k_old] = overlap(new slab, old slab) / len(new slab):
    the exact conservative 1-D remap between two plane stacks covering
    the same interval (prismatic columns => conserves cell integrals
    exactly)."""
    op = np.asarray(old_planes, dtype=np.float64)
    np_ = np.asarray(new_planes, dtype=np.float64)
    lo = np.maximum(np_[:-1, None], op[None, :-1])
    hi = np.minimum(np_[1:, None], op[None, 1:])
    ov = np.clip(hi - lo, 0.0, None)
    wid = (np_[1:] - np_[:-1])[:, None]
    return ov / np.maximum(wid, 1e-300)


def remap_cells(W: np.ndarray, n_base: int, data: np.ndarray
                ) -> np.ndarray:
    """Apply the slab remap to a cell field ordered slab-major
    (cell = slab * n_base + base). data: [nC_old(,3)]."""
    d = np.asarray(data)
    Kold = W.shape[1]
    shaped = d.reshape((Kold, n_base) + d.shape[1:])
    out = np.tensordot(W, shaped, axes=(1, 0))
    return out.reshape((-1,) + d.shape[1:])


def reorder_to_layers(topo: LayerTopo, data: np.ndarray) -> np.ndarray:
    """Original-mesh cell field -> slab-major layered order."""
    d = np.asarray(data)
    out = np.empty_like(d)
    out[topo.cell_slab * topo.n_base + topo.cell_base] = d
    return out


def layer_ar(planes: np.ndarray, moving_pos: float, h0: float,
             min_frac: float = 0.5, max_frac: float = 1.5,
             side: int = 0) -> Tuple[np.ndarray, bool]:
    """layerAdditionRemoval decision (reference:
    polyTopoChange/polyTopoChanger/layerAdditionRemoval min/max layer
    thickness): move the boundary plane on `side` (0 = planes[0],
    -1 = planes[-1]) to moving_pos; split the adjacent layer when its
    thickness exceeds max_frac*h0, merge it into its neighbour below
    min_frac*h0. Returns (new_planes, topo_changed)."""
    p = np.asarray(planes, dtype=np.float64).copy()
    if side == 0:
        p[0] = moving_pos
        t = p[1] - p[0]
        if t > max_frac * h0:
            return np.concatenate([[p[0], p[0] + h0], p[1:]]), True
        if t < min_frac * h0 and p.shape[0] > 3:
            return np.concatenate([[p[0]], p[2:]]), True
        return p, False
    p[-1] = moving_pos
    t = p[-1] - p[-2]
    if t > max_frac * h0:
        return np.concatenate([p[:-1], [p[-1] - h0, p[-1]]]), True
    if t < min_frac * h0 and p.shape[0] > 3:
        return np.concatenate([p[:-2], [p[-1]]]), True
    return p, False
