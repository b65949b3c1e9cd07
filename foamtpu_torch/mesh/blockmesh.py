"""Copy of openfoam-2.2.x_tpu/mesh/blockmesh.py.

Host-side numpy. The JAX package cannot be imported without jax, so
the port carries its own copy.

blockMesh: structured hex block mesh generation from blockMeshDict.

TPU-native rebuild of the reference's block mesher (reference:
src/mesh/blockMesh/, applications/utilities/mesh/generation/blockMesh/).
Host-side NumPy; produces a PolyMesh in canonical OpenFOAM face order
(internal faces upper-triangular by owner/neighbour, then boundary faces
grouped per patch).

Supported: multi-block hex meshes, simpleGrading (per-axis expansion
ratios), edgeGrading lists, vertex merging between blocks,
boundary/patches declarations, arc edges (circular interpolation).
Not yet: spline/polyLine edges.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core.dictionary import FoamDict, Word, parse_file
from .core import Patch, PolyMesh

# OpenFOAM hex cellModel faces, outward-oriented
# (reference: src/OpenFOAM/meshes/meshShapes/cellModeller — "hex" model).
_HEX_FACES = (
    (0, 4, 7, 3),  # x-min
    (1, 2, 6, 5),  # x-max
    (0, 1, 5, 4),  # y-min
    (3, 7, 6, 2),  # y-max
    (0, 3, 2, 1),  # z-min
    (4, 5, 6, 7),  # z-max
)

# corner quads of each block side, in local vertex numbering (for patch lookup)
_SIDE_CORNERS = _HEX_FACES


def _grading_positions(n: int, ratio: float) -> np.ndarray:
    """Parametric node positions in [0,1] for n cells with expansion
    ratio = (last cell size)/(first cell size)."""
    if n <= 0:
        raise ValueError("block with zero cells")
    if abs(ratio - 1.0) < 1e-12 or n == 1:
        return np.linspace(0.0, 1.0, n + 1)
    g = ratio ** (1.0 / (n - 1))
    sizes = g ** np.arange(n)
    t = np.concatenate([[0.0], np.cumsum(sizes)])
    return t / t[-1]


class _Block:
    def __init__(self, verts: np.ndarray, corner_ids: Sequence[int],
                 n: Sequence[int], grading: Sequence[float],
                 edge_points: Dict[Tuple[int, int], np.ndarray] = None,
                 zone: str = None):
        self.zone = zone
        self.corner_ids = list(corner_ids)
        self.corners = verts[self.corner_ids]  # [8,3]
        self.n = tuple(int(x) for x in n)
        self.grading = tuple(float(g) for g in grading)
        self.edge_points = edge_points or {}

    def point_grid(self) -> np.ndarray:
        """[nx+1, ny+1, nz+1, 3] physical points via trilinear blending
        of the 8 corners with graded parameters (plus arc-edge warping
        when edge interpolators are present)."""
        nx, ny, nz = self.n
        tx = _grading_positions(nx, self.grading[0])
        ty = _grading_positions(ny, self.grading[1])
        tz = _grading_positions(nz, self.grading[2])
        X, Y, Z = np.meshgrid(tx, ty, tz, indexing="ij")
        c = self.corners

        def tri(u, v, w):
            return (
                c[0] * ((1 - u) * (1 - v) * (1 - w))[..., None]
                + c[1] * (u * (1 - v) * (1 - w))[..., None]
                + c[2] * (u * v * (1 - w))[..., None]
                + c[3] * ((1 - u) * v * (1 - w))[..., None]
                + c[4] * ((1 - u) * (1 - v) * w)[..., None]
                + c[5] * (u * (1 - v) * w)[..., None]
                + c[6] * (u * v * w)[..., None]
                + c[7] * ((1 - u) * v * w)[..., None]
            )

        pts = tri(X, Y, Z)

        if self.edge_points:
            # transfinite correction: add arc deviation blended across the block
            # local hex edges: (v0,v1,param-axis): 12 edges
            edges = [
                (0, 1, 0), (3, 2, 0), (7, 6, 0), (4, 5, 0),
                (0, 3, 1), (1, 2, 1), (5, 6, 1), (4, 7, 1),
                (0, 4, 2), (1, 5, 2), (2, 6, 2), (3, 7, 2),
            ]
            params = {0: X, 1: Y, 2: Z}
            for (a, b, axis) in edges:
                ga, gb = self.corner_ids[a], self.corner_ids[b]
                key = (min(ga, gb), max(ga, gb))
                if key not in self.edge_points:
                    continue
                interp = self.edge_points[key]  # callable t->point, t along ga->gb
                t = params[axis]
                if ga > gb:
                    t_edge = 1.0 - t
                else:
                    t_edge = t
                straight = (
                    self.corners[a][None, None, None, :] * (1 - t)[..., None]
                    + self.corners[b][None, None, None, :] * t[..., None]
                )
                curved = interp(t_edge.ravel()).reshape(t.shape + (3,))
                dev = curved - straight
                # blend: full weight on the edge, linear falloff across the
                # two transverse parameters
                corner_uvw = {
                    0: (0, 0, 0), 1: (1, 0, 0), 2: (1, 1, 0), 3: (0, 1, 0),
                    4: (0, 0, 1), 5: (1, 0, 1), 6: (1, 1, 1), 7: (0, 1, 1),
                }
                uvw_a = corner_uvw[a]
                w_blend = np.ones_like(t)
                for i_ax, pval in ((i, params[i]) for i in range(3) if i != axis):
                    at = uvw_a[i_ax]
                    w_blend = w_blend * (1.0 - pval if at == 0 else pval)
                pts = pts + dev * w_blend[..., None]
        return pts


def _arc_interpolator(p0: np.ndarray, pmid: np.ndarray, p1: np.ndarray):
    """Circular arc through three points; returns t->point on [0,1]."""
    # circle centre: solve in the plane of the three points
    v1, v2 = pmid - p0, p1 - p0
    n = np.cross(v1, v2)
    nn = np.linalg.norm(n)
    if nn < 1e-14:
        return lambda t: p0[None, :] * (1 - t)[:, None] + p1[None, :] * t[:, None]
    n = n / nn
    # perpendicular bisector intersection
    m1, m2 = 0.5 * (p0 + pmid), 0.5 * (pmid + p1)
    d1, d2 = np.cross(n, v1), np.cross(n, p1 - pmid)
    # solve m1 + s*d1 = m2 + u*d2
    A = np.stack([d1, -d2], axis=1)
    rhs = m2 - m1
    s = np.linalg.lstsq(A, rhs, rcond=None)[0][0]
    centre = m1 + s * d1
    r0, r1 = p0 - centre, p1 - centre
    radius = np.linalg.norm(r0)
    # signed angle from r0 to r1 about n, going through pmid
    def angle(v):
        va = v / np.linalg.norm(v)
        ra = r0 / np.linalg.norm(r0)
        return np.arctan2(np.dot(np.cross(ra, va), n), np.dot(ra, va))

    a1, am = angle(r1), angle(pmid - centre)
    if a1 * am < 0 or abs(am) > abs(a1):
        # go the other way around
        a1 = a1 - np.sign(a1) * 2 * np.pi if a1 != 0 else 2 * np.pi * np.sign(am)
    e1 = r0 / radius
    e2 = np.cross(n, e1)

    def interp(t: np.ndarray) -> np.ndarray:
        th = a1 * t
        return centre[None, :] + radius * (
            np.cos(th)[:, None] * e1[None, :] + np.sin(th)[:, None] * e2[None, :]
        )

    return interp


def _parse_blocks_entry(tokens: List, verts: np.ndarray, edge_interps) -> List[_Block]:
    blocks = []
    i = 0
    while i < len(tokens):
        t = tokens[i]
        if isinstance(t, Word) and t == "hex":
            corner_ids = np.asarray(tokens[i + 1], dtype=int)
            i += 2
            # optional cellZone name (reference: blockMesh `hex (...)
            # zoneName (nx ny nz) ...` tags the block's cells)
            zone = None
            if isinstance(tokens[i], (Word, str)) and not isinstance(tokens[i], np.ndarray):
                zone = str(tokens[i])
                i += 1
            n = np.asarray(tokens[i], dtype=int)
            i += 1
            grading = (1.0, 1.0, 1.0)
            if i < len(tokens) and isinstance(tokens[i], (Word, str)):
                kind = str(tokens[i])
                i += 1
                g = tokens[i]
                i += 1
                if kind == "simpleGrading":
                    grading = tuple(float(x) for x in np.asarray(g, dtype=float))
                elif kind == "edgeGrading":
                    ga = np.asarray(g, dtype=float)
                    grading = (float(ga[0]), float(ga[4]), float(ga[8]))
                else:
                    raise ValueError(f"unknown grading kind {kind!r}")
            eps = {
                k: v for k, v in edge_interps.items()
                if k[0] in corner_ids and k[1] in corner_ids
            }
            blocks.append(_Block(verts, corner_ids, n, grading, eps,
                                 zone=zone))
        else:
            i += 1
    return blocks


def _parse_edges(tokens, verts) -> Dict[Tuple[int, int], object]:
    interps: Dict[Tuple[int, int], object] = {}
    if tokens is None:
        return interps
    if isinstance(tokens, np.ndarray):
        return interps
    i = 0
    toks = list(tokens)
    while i < len(toks):
        t = toks[i]
        if isinstance(t, (Word, str)) and str(t) == "arc":
            a, b = int(toks[i + 1]), int(toks[i + 2])
            mid = np.asarray(toks[i + 3], dtype=float)
            key = (min(a, b), max(a, b))
            p0, p1 = verts[key[0]], verts[key[1]]
            interps[key] = _arc_interpolator(p0, mid, p1)
            i += 4
        else:
            i += 1
    return interps


def _parse_boundary(d: FoamDict) -> List[Tuple[str, str, List[np.ndarray]]]:
    """Returns [(name, type, [corner quads])]."""
    out = []
    if "boundary" in d:
        b = d["boundary"]
        # list alternating: name, dict
        i = 0
        items = b if isinstance(b, list) else [b]
        while i < len(items):
            name = str(items[i])
            spec = items[i + 1]
            quads = spec["faces"]
            if isinstance(quads, np.ndarray):
                quads = [q for q in quads]
            nbr = str(spec["neighbourPatch"]) if "neighbourPatch" in spec \
                else None
            out.append((name, str(spec["type"]),
                        [np.asarray(q, dtype=int) for q in quads], nbr))
            i += 2
    elif "patches" in d:
        # legacy: patches ( wall movingWall ((3 7 6 2)) ... )
        items = d["patches"]
        i = 0
        while i < len(items):
            ptype = str(items[i])
            name = str(items[i + 1])
            quads = items[i + 2]
            if isinstance(quads, np.ndarray) and quads.ndim == 2:
                quads = [q for q in quads]
            elif isinstance(quads, np.ndarray):
                quads = [quads]
            out.append((name, ptype,
                        [np.asarray(q, dtype=int) for q in quads], None))
            i += 3
    return out


def generate(dict_or_path) -> PolyMesh:
    """blockMeshDict -> PolyMesh."""
    d = parse_file(dict_or_path) if isinstance(dict_or_path, str) else dict_or_path
    scale = float(d.get("convertToMeters", d.get("scale", 1.0)))
    verts = np.asarray(d["vertices"], dtype=float) * scale

    edge_interps = _parse_edges(d.get("edges"), verts)
    blocks = _parse_blocks_entry(list(d["blocks"]), verts, edge_interps)
    patch_specs = _parse_boundary(d)

    # ---- generate points per block, merge duplicates ----------------------
    bbox = verts.max(0) - verts.min(0)
    # merge tolerance must be RELATIVE to the geometry scale — an
    # absolute floor collapses nanometre-scale domains (MD cases use
    # convertToMeters ~1e-9)
    tol = (float(np.linalg.norm(bbox)) or 1.0) * 1e-8

    grids = [blk.point_grid() for blk in blocks]
    all_flat = np.concatenate([g.reshape(-1, 3) for g in grids], axis=0)
    pkeys = np.round(all_flat / tol).astype(np.int64)
    _, first_idx, inverse = np.unique(pkeys, axis=0, return_index=True, return_inverse=True)
    # renumber unique points in order of first appearance (deterministic)
    order_first = np.argsort(first_idx, kind="stable")
    remap = np.empty_like(order_first)
    remap[order_first] = np.arange(order_first.shape[0])
    inverse = remap[inverse]
    points = all_flat[first_idx[order_first]]

    block_pid: List[np.ndarray] = []  # per block: [nx+1,ny+1,nz+1] global ids
    off = 0
    for g in grids:
        shape = g.shape[:3]
        size = shape[0] * shape[1] * shape[2]
        block_pid.append(inverse[off : off + size].reshape(shape))
        off += size

    # ---- cells and faces ---------------------------------------------------
    # global cell ids block by block
    cell_pts: List[np.ndarray] = []  # [nCells, 8]
    side_pointsets: List[List[set]] = []  # per block: 6 sets of point ids
    for blk, gids in zip(blocks, block_pid):
        nx, ny, nz = blk.n
        c = np.empty((nx, ny, nz, 8), dtype=np.int64)
        c[..., 0] = gids[:-1, :-1, :-1]
        c[..., 1] = gids[1:, :-1, :-1]
        c[..., 2] = gids[1:, 1:, :-1]
        c[..., 3] = gids[:-1, 1:, :-1]
        c[..., 4] = gids[:-1, :-1, 1:]
        c[..., 5] = gids[1:, :-1, 1:]
        c[..., 6] = gids[1:, 1:, 1:]
        c[..., 7] = gids[:-1, 1:, 1:]
        cell_pts.append(c.reshape(-1, 8, order="C"))
        side_pointsets.append([
            set(gids[0, :, :].ravel()),   # x-min
            set(gids[-1, :, :].ravel()),  # x-max
            set(gids[:, 0, :].ravel()),   # y-min
            set(gids[:, -1, :].ravel()),  # y-max
            set(gids[:, :, 0].ravel()),   # z-min
            set(gids[:, :, -1].ravel()),  # z-max
        ])
    cell_pts_arr = np.concatenate(cell_pts, axis=0)
    n_cells = cell_pts_arr.shape[0]

    # named cellZones from tagged blocks (cells are numbered block by
    # block, so each block contributes a contiguous id range)
    cell_zones: Dict[str, List[np.ndarray]] = {}
    coff = 0
    for blk in blocks:
        bn = blk.n[0] * blk.n[1] * blk.n[2]
        if blk.zone:
            cell_zones.setdefault(blk.zone, []).append(
                np.arange(coff, coff + bn, dtype=np.int64))
        coff += bn

    # all candidate faces: [nCells*6, 4]
    hf = np.asarray(_HEX_FACES)
    faces_all = cell_pts_arr[:, hf]  # [nC, 6, 4]
    faces_flat = faces_all.reshape(-1, 4)
    cells_flat = np.repeat(np.arange(n_cells), 6)

    keys = np.sort(faces_flat, axis=1)
    # group identical faces (each face key appears once: boundary,
    # or twice: internal shared by two cells)
    order = np.lexsort(keys.T[::-1])
    ks = keys[order]
    eq = np.all(ks[1:] == ks[:-1], axis=1)
    eq_prev = np.concatenate([[False], eq])   # row i equals row i-1
    eq_next = np.concatenate([eq, [False]])   # row i equals row i+1
    pair_first = np.nonzero(eq_next & ~eq_prev)[0]
    a_idx = order[pair_first]
    b_idx = order[pair_first + 1]
    ca, cb = cells_flat[a_idx], cells_flat[b_idx]
    swap = ca > cb
    internal_owner = np.where(swap, cb, ca)
    internal_neigh = np.where(swap, ca, cb)
    own_src = np.where(swap, b_idx, a_idx)
    internal_faces = faces_flat[own_src]
    boundary_idx = order[~eq_prev & ~eq_next]

    # sort internal faces upper-triangular: by owner, then neighbour
    so = np.lexsort((internal_neigh, internal_owner))
    internal_faces = internal_faces[so]
    internal_owner = internal_owner[so]
    internal_neigh = internal_neigh[so]

    # ---- assign boundary faces to patches ----------------------------------
    # patch side point sets: for each declared corner quad, find matching block side
    patch_pointsets: List[Tuple[str, str, set]] = []
    patch_nbrs = [nb for _, _, _, nb in patch_specs]
    for name, ptype, quads, _nb in patch_specs:
        pset: set = set()
        for quad in quads:
            qset = set(int(x) for x in quad)
            found = False
            for bi, blk in enumerate(blocks):
                for si, corners in enumerate(_SIDE_CORNERS):
                    side_glob = {blk.corner_ids[v] for v in corners}
                    if side_glob == qset:
                        pset |= side_pointsets[bi][si]
                        found = True
            if not found:
                raise ValueError(
                    f"patch {name!r}: face {quad} matches no block side"
                )
        patch_pointsets.append((name, ptype, pset))

    b_faces = faces_flat[boundary_idx]
    b_cells = cells_flat[boundary_idx]
    assigned = np.full(b_faces.shape[0], -1, dtype=np.int64)
    for pi, (_, _, pset) in enumerate(patch_pointsets):
        pset_arr = np.fromiter(pset, dtype=np.int64) if pset else np.empty(0, np.int64)
        in_pset = np.isin(b_faces, pset_arr).all(axis=1)
        assigned[(assigned < 0) & in_pset] = pi
    n_unassigned = int((assigned < 0).sum())
    patch_names = [n for n, _, _ in patch_pointsets]
    patch_types = [t for _, t, _ in patch_pointsets]
    if n_unassigned:
        # Unassigned faces usually mean block interfaces whose node
        # distributions don't match (e.g. inconsistent simpleGrading on
        # the two sides) — the blocks are then DISCONNECTED. Warn loudly.
        import sys

        print(
            f"blockMesh WARNING: {n_unassigned} boundary faces not in any "
            "declared patch -> defaultFaces. If these lie on block-block "
            "interfaces, the block gradings/counts do not match and the "
            "blocks are disconnected.",
            file=sys.stderr,
        )
        patch_names.append("defaultFaces")
        patch_types.append("empty")
        patch_nbrs.append(None)
        assigned[assigned < 0] = len(patch_pointsets)

    # boundary faces grouped per patch, ordered by owner cell within patch
    faces_out = [internal_faces]
    owner_out = [internal_owner]
    patches: List[Patch] = []
    start = internal_faces.shape[0]
    for pi, (name, ptype) in enumerate(zip(patch_names, patch_types)):
        sel = np.nonzero(assigned == pi)[0]
        sel = sel[np.argsort(b_cells[sel], kind="stable")]
        patches.append(Patch(name=name, type=ptype, start=start,
                             size=sel.shape[0],
                             neighbour_patch=patch_nbrs[pi]))
        faces_out.append(b_faces[sel])
        owner_out.append(b_cells[sel])
        start += sel.shape[0]

    face_pts = np.concatenate(faces_out, axis=0)
    owner = np.concatenate(owner_out, axis=0)
    face_npts = np.full(face_pts.shape[0], 4, dtype=np.int64)

    pm = PolyMesh(
        points=points,
        face_pts=face_pts,
        face_npts=face_npts,
        owner=owner,
        neighbour=internal_neigh,
        patches=patches,
        cell_zones={k: np.concatenate(v) for k, v in cell_zones.items()},
    )
    mpp = d.get("mergePatchPairs")
    if mpp:
        pairs = []
        flat = list(mpp)
        for ent in flat:
            if isinstance(ent, (list, tuple, np.ndarray))                     and len(ent) == 2:
                pairs.append((str(ent[0]), str(ent[1])))
        if not pairs and len(flat) >= 2:
            pairs = [(str(flat[0]), str(flat[1]))]
        if pairs:
            pm = merge_patch_pairs(pm, pairs)
    return pm


def merge_patch_pairs(pm: PolyMesh, pairs) -> PolyMesh:
    """mergePatchPairs ( (master slave) ... ): conformal face merging —
    coincident face pairs of the two patches become internal faces
    (reference: blockMesh's mergePatchPairs; the reference also handles
    non-conformal pairs by face splitting, out of scope — cyclicAMI
    covers non-conformal coupling)."""
    faces = [list(pm.face_pts[f, :pm.face_npts[f]])
             for f in range(pm.n_faces)]
    nif = pm.n_internal_faces
    drop = set()
    new_internal = []          # (face_pts, owner, neighbour)
    for master_name, slave_name in pairs:
        mp = pm.patch(str(master_name))
        sp = pm.patch(str(slave_name))
        key = {}
        for f in range(sp.start, sp.start + sp.size):
            key[tuple(np.round(pm.cf[f], 10))] = f
        for f in range(mp.start, mp.start + mp.size):
            g = key.get(tuple(np.round(pm.cf[f], 10)))
            if g is None:
                continue
            o, n = pm.owner[f], pm.owner[g]
            fc = faces[f] if o <= n else faces[f][::-1]
            new_internal.append((fc, min(o, n), max(o, n)))
            drop.add(f)
            drop.add(g)
    if not new_internal:
        return pm
    all_faces = [faces[f] for f in range(nif)]         + [t[0] for t in new_internal]
    owner = list(pm.owner[:nif]) + [t[1] for t in new_internal]
    nei = list(pm.neighbour) + [t[2] for t in new_internal]
    patches = []
    start = len(all_faces)
    for p in pm.patches:
        kept = [f for f in range(p.start, p.start + p.size)
                if f not in drop]
        patches.append(Patch(name=p.name, type=p.type, start=start,
                             size=len(kept),
                             neighbour_patch=p.neighbour_patch,
                             attrs=p.attrs))
        for f in kept:
            all_faces.append(faces[f])
            owner.append(pm.owner[f])
        start += len(kept)
    mx = max(len(f) for f in all_faces)
    fp = np.full((len(all_faces), mx), -1, dtype=np.int64)
    fn = np.empty(len(all_faces), dtype=np.int64)
    for i, f in enumerate(all_faces):
        fp[i, :len(f)] = f
        fn[i] = len(f)
    return PolyMesh(points=pm.points, face_pts=fp, face_npts=fn,
                    owner=np.asarray(owner, np.int64),
                    neighbour=np.asarray(nei, np.int64),
                    patches=patches, cell_zones=pm.cell_zones)
