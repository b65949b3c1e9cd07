"""layers: boundary-layer (prism) insertion on a boundary patch, the
LAYER stage of snappyHexMesh.

Host copy of openfoam-2.2.x_tpu/mesh/layers.py, unchanged in behaviour:
the bulk mesh is shrunk away from the wall along area-weighted point
normals and the gap filled with nLayers prism cells graded by
expansionRatio; one global thickness factor protects the squeezed first
bulk cells (the reference's per-point collapse is not performed, as in
the JAX package), and the side faces at the patch perimeter join the
adjacent patches. numpy PolyMesh surgery; `to_device` takes the result.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .core import Patch, PolyMesh


def _point_normals(pm: PolyMesh, patch: Patch) -> Dict[int, np.ndarray]:
    """Area-weighted outward (out of the fluid) normal per patch
    point."""
    acc: Dict[int, np.ndarray] = {}
    for f in range(patch.start, patch.start + patch.size):
        sf = pm.sf[f]
        for p in pm.face_pts[f, :pm.face_npts[f]]:
            acc[p] = acc.get(p, 0.0) + sf
    return {p: v / max(np.linalg.norm(v), 1e-300)
            for p, v in acc.items()}


def add_layers(pm: PolyMesh, patch_name: str, n_layers: int = 3,
               first_thickness: float = 0.0,
               expansion: float = 1.2,
               rel_total: float = 0.3) -> PolyMesh:
    """Insert n_layers prism layers under `patch_name`.

    first_thickness: absolute first-layer height (0 -> derived from
    rel_total * local bulk cell size). The squeezed first bulk cells
    are protected by scaling the total thickness so no bulk cell loses
    more than 60% of its height."""
    patch = pm.patch(patch_name)
    if patch.size == 0 or n_layers < 1:
        return pm
    nif = pm.n_internal_faces
    faces = [list(pm.face_pts[f, :pm.face_npts[f]])
             for f in range(pm.n_faces)]
    owner = pm.owner.copy()

    normals = _point_normals(pm, patch)
    pts_patch = sorted(normals)
    # local bulk size from the owner cells of the patch faces
    own_cells = pm.owner[patch.slice]
    h_bulk = (pm.v[own_cells] / np.maximum(pm.mag_sf[patch.slice],
                                           1e-300))
    h_ref = float(np.median(h_bulk))
    geo = sum(expansion ** i for i in range(n_layers))
    t1 = first_thickness or rel_total * h_ref / geo
    t_total = t1 * geo
    # protect the squeezed bulk cells: <= 60% of the local height
    t_total = min(t_total, 0.6 * float(h_bulk.min()))
    t1 = t_total / geo
    # level fractions measured FROM the wall: 0 = wall, 1 = bulk side
    levels = np.cumsum([t1 * expansion ** i for i in range(n_layers)])
    fracs = levels / t_total                     # [nL], fracs[-1] = 1

    # ---- new points ----------------------------------------------------------
    # original point id stays at the MOVED (bulk-side) position; new
    # ids hold levels 0..n_layers-1 (level 0 = the wall surface)
    points = pm.points.copy()
    n_pts0 = pm.n_points
    lvl_id = {}                                  # (p, lvl) -> point id
    new_pts: List[np.ndarray] = []
    for p in pts_patch:
        x_wall = pm.points[p]
        d = -normals[p]                          # into the fluid
        for lvl in range(n_layers):              # 0..nL-1
            xi = x_wall + (levels[lvl - 1] if lvl else 0.0) * d
            lvl_id[(p, lvl)] = n_pts0 + len(new_pts)
            new_pts.append(xi)
        points[p] = x_wall + t_total * d         # bulk side (level nL)
    points = np.vstack([points, np.asarray(new_pts)])

    def pid(p, lvl):
        return int(p) if lvl == n_layers else lvl_id[(int(p), lvl)]

    # ---- patch-face adjacency over edges --------------------------------------
    pface_ids = list(range(patch.start, patch.start + patch.size))
    edge_faces: Dict[Tuple[int, int], List[int]] = {}
    for k, f in enumerate(pface_ids):
        fp = faces[f]
        for i in range(len(fp)):
            e = tuple(sorted((fp[i], fp[(i + 1) % len(fp)])))
            edge_faces.setdefault(e, []).append(k)
    # boundary faces of OTHER patches sharing an edge (side-face homes)
    other_patch_of_edge: Dict[Tuple[int, int], int] = {}
    for ip, pch in enumerate(pm.patches):
        if pch.name == patch_name:
            continue
        for f in range(pch.start, pch.start + pch.size):
            fp = faces[f]
            for i in range(len(fp)):
                e = tuple(sorted((fp[i], fp[(i + 1) % len(fp)])))
                if e in edge_faces:
                    other_patch_of_edge[e] = ip

    # ---- build the new face/cell lists -----------------------------------------
    nc0 = pm.n_cells
    n_pf = len(pface_ids)

    def layer_cell(k, lvl):                      # lvl 0..nL-1
        return nc0 + lvl * n_pf + k

    internal: List[List[int]] = [faces[f] for f in range(nif)]
    int_own: List[int] = list(owner[:nif])
    int_nei: List[int] = list(pm.neighbour)

    # horizontal faces (oriented BY CONSTRUCTION: the original patch
    # face's point order gives the outward +n direction; faces whose
    # owner sits on the wall side need the reversed order. The generic
    # centroid test below must NOT touch these — for staircase corner
    # cells with several body faces it is geometrically ambiguous)
    fixed_orient = set()
    for k, f in enumerate(pface_ids):
        fp = faces[f]
        bulk = owner[f]
        top = layer_cell(k, n_layers - 1)
        # level-nL face: bulk owner (smaller id) -> top prism: normal
        # points toward the wall = +n = ORIGINAL order
        fixed_orient.add(len(internal))
        internal.append([pid(p, n_layers) for p in fp])
        int_own.append(bulk)
        int_nei.append(top)
        # faces between layers lvl-1 (wall side, owner) and lvl:
        # normal points wall -> bulk = -n = REVERSED order
        for lvl in range(1, n_layers):
            fixed_orient.add(len(internal))
            internal.append([pid(p, lvl) for p in fp][::-1])
            int_own.append(layer_cell(k, lvl - 1))
            int_nei.append(layer_cell(k, lvl))

    # vertical (side) faces per edge per layer. Manifold edges (shared
    # by exactly two patch faces) get ONE internal quad; perimeter
    # edges get a boundary quad on the adjacent patch; NON-MANIFOLD
    # staircase edges (>2 faces — octree castellation corners) get one
    # boundary quad PER prism, i.e. a zero-width crack between the
    # prisms — the same compromise as the reference's layer
    # termination at bad features (documented deviation)
    self_ip = [i for i, q in enumerate(pm.patches)
               if q.name == patch_name][0]
    side_by_patch: Dict[int, List[Tuple[List[int], int]]] = {}
    for e, ks in edge_faces.items():
        p0, p1 = e
        if len(ks) == 2:
            ka, kb = ks
            for lvl in range(n_layers):
                quad = [pid(p0, lvl), pid(p1, lvl),
                        pid(p1, lvl + 1), pid(p0, lvl + 1)]
                ca, cb = layer_cell(ka, lvl), layer_cell(kb, lvl)
                internal.append(quad)
                int_own.append(min(ca, cb))
                int_nei.append(max(ca, cb))
        else:
            ip = other_patch_of_edge.get(e, self_ip)
            for k in ks:
                for lvl in range(n_layers):
                    quad = [pid(p0, lvl), pid(p1, lvl),
                            pid(p1, lvl + 1), pid(p0, lvl + 1)]
                    side_by_patch.setdefault(ip, []).append(
                        (quad, layer_cell(k, lvl)))

    # boundary faces: old patches (with their side-face additions) +
    # the wall patch rewritten at level 0 owned by the bottom prisms
    b_faces: List[List[int]] = []
    b_owner: List[int] = []
    patches_out: List[Patch] = []
    start = len(internal)
    for ip, pch in enumerate(pm.patches):
        fs: List[Tuple[List[int], int]] = []
        if pch.name == patch_name:
            for k, f in enumerate(pface_ids):
                fs.append(([pid(p, 0) for p in faces[f]],
                           layer_cell(k, 0)))
        else:
            for f in range(pch.start, pch.start + pch.size):
                fs.append((faces[f], owner[f]))
        fs += side_by_patch.get(ip, [])
        patches_out.append(Patch(name=pch.name, type=pch.type,
                                 start=start, size=len(fs),
                                 neighbour_patch=pch.neighbour_patch,
                                 attrs=pch.attrs))
        for fc, o in fs:
            b_faces.append(fc)
            b_owner.append(o)
        start += len(fs)

    all_faces = internal + b_faces
    all_owner = np.asarray(int_own + b_owner, np.int64)
    all_nei = np.asarray(int_nei, np.int64)

    # ---- deterministic orientation BEFORE geometry ------------------------------
    # approximate cell centres: bulk cells keep their original centre;
    # prism(k,lvl) sits above wall face k at the mid-level height.
    # (the post-hoc centroid test cannot be used: mis-oriented faces
    # give degenerate volumes and garbage centroids)
    approx_c = np.zeros((nc0 + n_layers * n_pf, 3))
    approx_c[:nc0] = pm.c
    lev_mid = np.empty(n_layers)
    lo = 0.0
    for lvl in range(n_layers):
        lev_mid[lvl] = 0.5 * (lo + levels[lvl])
        lo = levels[lvl]
    for k, f in enumerate(pface_ids):
        nrm = pm.sf[f] / max(pm.mag_sf[f], 1e-300)
        d = -nrm
        for lvl in range(n_layers):
            approx_c[layer_cell(k, lvl)] = pm.cf[f] + lev_mid[lvl] * d

    def face_normal(fc):
        p = points[fc]
        c = p.mean(axis=0)
        n = np.zeros(3)
        for i in range(len(fc)):
            n += np.cross(p[i] - c, p[(i + 1) % len(fc)] - c)
        return n

    nif2 = len(internal)
    n_old_if = nif
    for f in range(len(all_faces)):
        if f < n_old_if or f in fixed_orient:
            continue                    # untouched / by-construction
        n = face_normal(all_faces[f])
        o = all_owner[f]
        if f < nif2:
            d = approx_c[all_nei[f]] - approx_c[o]
        else:
            p = points[all_faces[f]].mean(axis=0)
            d = p - approx_c[o]
        if n @ d < 0:
            all_faces[f] = all_faces[f][::-1]

    mx = max(len(f) for f in all_faces)
    fp_arr = np.full((len(all_faces), mx), -1, dtype=np.int64)
    fn_arr = np.empty(len(all_faces), dtype=np.int64)
    for i, f in enumerate(all_faces):
        fp_arr[i, :len(f)] = f
        fn_arr[i] = len(f)
    return PolyMesh(points=points, face_pts=fp_arr, face_npts=fn_arr,
                    owner=all_owner, neighbour=all_nei,
                    patches=patches_out, cell_zones=pm.cell_zones)
