"""Mesh and case manipulation on the host: topoSet, createPatch,
extrudeMesh, refineMesh, changeDictionary and splitMeshRegions (a host
copy of openfoam-2.2.x_tpu/apps/meshutils.py, unchanged in behaviour;
the reference module is loaded through the JAX package).

topoSet's cell sources: boxToCell, sphereToCell, cylinderToCell,
cellToCell; face sources: patchToFace, boxToFace; actions new, add,
subtract/delete, invert; a cellZoneSet (setToCellZone or any cell
source) becomes a cellZone of the mesh. Sets are written under
constant/polyMesh/sets/. refineMesh refines a cellSet of a uniform box
background one level through mesh/snappy.py's octree; the level
transitions carry hanging faces.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.dictionary import FoamDict, parse_file, write_file
from ..io import polymesh as mesh_io
from ..mesh.core import Patch, PolyMesh


def _source_cells(pm: PolyMesh, source: str, info: FoamDict) -> np.ndarray:
    c = pm.c
    if source in ("boxToCell", "box"):
        box = np.asarray(info["box"], float).reshape(2, 3)
        return np.nonzero(np.all((c >= box[0]) & (c <= box[1]),
                                 axis=1))[0]
    if source == "sphereToCell":
        o = np.asarray(info.get("centre", info.get("origin")),
                       float).reshape(3)
        r = float(info["radius"])
        return np.nonzero(np.linalg.norm(c - o, axis=1) <= r)[0]
    if source == "cylinderToCell":
        p1 = np.asarray(info["p1"], float).reshape(3)
        p2 = np.asarray(info["p2"], float).reshape(3)
        r = float(info["radius"])
        ax = p2 - p1
        L = np.linalg.norm(ax)
        ax = ax / max(L, 1e-300)
        d = c - p1
        t = d @ ax
        rad = np.linalg.norm(d - t[:, None] * ax[None], axis=1)
        return np.nonzero((rad <= r) & (t >= 0) & (t <= L))[0]
    if source == "cellToCell":
        return read_set(info["_case"], str(info["set"]))
    raise ValueError(f"topoSet: unsupported cell source {source!r}")


def _source_faces(pm: PolyMesh, source: str, info: FoamDict) -> np.ndarray:
    if source == "patchToFace":
        name = str(info.get("name", info.get("patch")))
        import re

        sel = []
        for p in pm.patches:
            if re.fullmatch(name.strip('"'), p.name):
                sel.append(np.arange(p.start, p.start + p.size))
        return (np.concatenate(sel) if sel
                else np.zeros(0, dtype=np.int64))
    if source in ("boxToFace", "box"):
        box = np.asarray(info["box"], float).reshape(2, 3)
        return np.nonzero(np.all((pm.cf >= box[0]) & (pm.cf <= box[1]),
                                 axis=1))[0]
    raise ValueError(f"topoSet: unsupported face source {source!r}")


def write_set(case: str, name: str, kind: str, ids: np.ndarray) -> None:
    d = os.path.join(case, "constant", "polyMesh", "sets")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, name), "w") as f:
        f.write("FoamFile { version 2.0; format ascii; "
                f"class {kind}; object {name}; }}\n".replace("}}", "}"))
        f.write(f"\n{len(ids)}\n(\n")
        f.write("\n".join(str(int(i)) for i in ids))
        f.write("\n)\n")


def read_set(case: str, name: str) -> np.ndarray:
    path = os.path.join(case, "constant", "polyMesh", "sets", name)
    d = parse_file(path)
    for v in d.values():
        arr = np.asarray(v).ravel()
        if arr.dtype.kind in "if" and arr.size:
            return arr.astype(np.int64)
    # empty set: `0 ( )` parses to no numeric payload
    import re as _re

    if _re.search(r"\b0\s*\(\s*\)", open(path).read()):
        return np.zeros(0, dtype=np.int64)
    raise ValueError(f"cannot read set {name!r}")


def topo_set(case: str) -> List[str]:
    """Execute system/topoSetDict actions; returns the set names."""
    pm = mesh_io.read(os.path.join(case, "constant", "polyMesh"))
    d = parse_file(os.path.join(case, "system", "topoSetDict"))
    actions = d.get("actions", [])
    items = list(actions) if isinstance(actions, list) else [actions]
    done = []
    current: Dict[str, np.ndarray] = {}
    for it in items:
        if not isinstance(it, FoamDict):
            continue
        name = str(it["name"])
        kind = str(it.get("type", "cellSet"))
        action = str(it.get("action", "new"))
        source = str(it.get("source", ""))
        info = it.get("sourceInfo", it)
        if isinstance(info, FoamDict):
            info["_case"] = case
        if kind == "cellZoneSet":
            # reference: topoSetSource setToCellZone — promote a cell
            # set (by name, or any cell source inline) to a cellZone
            if source == "setToCellZone":
                set_name = str(info.get("set", name))
                ids = current.get(set_name)
                if ids is None:
                    ids = read_set(case, set_name)
            else:
                ids = _source_cells(pm, source, info)
            pm.cell_zones[name] = np.asarray(ids, dtype=np.int64)
            mesh_io.write(pm, os.path.join(case, "constant", "polyMesh"))
            done.append(name)
            continue
        ids = (_source_cells(pm, source, info) if kind == "cellSet"
               else _source_faces(pm, source, info))
        prev = current.get(name, np.zeros(0, dtype=np.int64))
        if action == "new":
            cur = ids
        elif action == "add":
            cur = np.union1d(prev, ids)
        elif action in ("subtract", "delete"):
            cur = np.setdiff1d(prev, ids)
        elif action == "invert":
            n = pm.n_cells if kind == "cellSet" else pm.n_faces
            cur = np.setdiff1d(np.arange(n), prev)
        else:
            raise ValueError(f"topoSet: unsupported action {action!r}")
        current[name] = cur
        write_set(case, name, kind, cur)
        done.append(name)
    return done


# ---------------------------------------------------------------------------
# createPatch (reference: .../mesh/manipulation/createPatch/)
# ---------------------------------------------------------------------------


def create_patch(case: str) -> PolyMesh:
    """Move boundary faces (from a faceSet or matched patches) into new
    patches; drops emptied patches."""
    mdir = os.path.join(case, "constant", "polyMesh")
    pm = mesh_io.read(mdir)
    d = parse_file(os.path.join(case, "system", "createPatchDict"))
    specs = d.get("patches", [])
    items = [x for x in (specs if isinstance(specs, list) else [specs])
             if isinstance(x, FoamDict)]
    nif = pm.n_internal_faces
    assign = np.full(pm.n_faces, -1, dtype=np.int64)  # new patch id
    new_patches: List[Tuple[str, str]] = []
    for spec in items:
        name = str(spec["name"])
        info = spec.get("patchInfo", FoamDict())
        ptype = str(info.get("type", "patch"))
        pid = len(new_patches)
        new_patches.append((name, ptype))
        if str(spec.get("constructFrom", "set")) == "set":
            ids = read_set(case, str(spec["set"]))
        else:
            pats = [str(x) for x in spec.get("patches", [])]
            ids = np.concatenate([
                np.arange(p.start, p.start + p.size)
                for p in pm.patches if p.name in pats] or
                [np.zeros(0, dtype=np.int64)])
        ids = ids[ids >= nif]
        assign[ids] = pid

    # rebuild boundary: kept old patches (unassigned faces) then new
    rows, npts, own = [], [], []
    patches: List[Patch] = []
    start = nif

    def emit(idx, name, ptype):
        nonlocal start
        if idx.size == 0:
            return
        rows.append(pm.face_pts[idx])
        npts.append(pm.face_npts[idx])
        own.append(pm.owner[idx])
        patches.append(Patch(name=name, type=ptype, start=start,
                             size=idx.size))
        start += idx.size

    for p in pm.patches:
        idx = np.arange(p.start, p.start + p.size)
        emit(idx[assign[idx] < 0], p.name, p.type)
    for pid, (name, ptype) in enumerate(new_patches):
        emit(np.nonzero(assign == pid)[0], name, ptype)

    out = PolyMesh(
        points=pm.points,
        face_pts=np.concatenate([pm.face_pts[:nif]] + rows, axis=0),
        face_npts=np.concatenate([pm.face_npts[:nif]] + npts, axis=0),
        owner=np.concatenate([pm.owner[:nif]] + own, axis=0),
        neighbour=pm.neighbour,
        patches=patches)
    mesh_io.write(out, mdir)
    return out


# ---------------------------------------------------------------------------
# extrudeMesh (reference: .../mesh/generation/extrudeMesh/ linearNormal)
# ---------------------------------------------------------------------------


def extrude_mesh(case: str) -> PolyMesh:
    """linearNormal extrusion of a source patch into nLayers of prisms/
    hexes. Side faces land in one `sides` patch (documented
    simplification of the reference's per-edge patch mapping)."""
    mdir = os.path.join(case, "constant", "polyMesh")
    pm = mesh_io.read(mdir)
    d = parse_file(os.path.join(case, "system", "extrudeMeshDict"))
    patch_name = str(d.get("sourcePatch", d.get("sourcePatches")))
    n_layers = int(d.get("nLayers", 1))
    coeffs = d.get("linearNormalCoeffs", FoamDict())
    thickness = float(coeffs.get("thickness", d.get("thickness", 1.0)))
    p = pm.patch(patch_name)

    fids = np.arange(p.start, p.start + p.size)
    # local point compaction
    used: List[int] = []
    seen = {}
    loc_rows = []
    for f in fids:
        k = pm.face_npts[f]
        row = []
        for pt in pm.face_pts[f, :k]:
            if pt not in seen:
                seen[pt] = len(used)
                used.append(pt)
            row.append(seen[pt])
        loc_rows.append(row)
    base_pts = pm.points[np.asarray(used)]
    n_base = base_pts.shape[0]
    # extrusion direction: mean outward patch normal
    n = pm.sf[fids].sum(axis=0)
    n /= max(np.linalg.norm(n), 1e-300)

    pts = np.concatenate([
        base_pts + (thickness * l / n_layers) * n
        for l in range(n_layers + 1)], axis=0)

    nF = p.size
    rows, npts_l, owner, neighbour = [], [], [], []

    def cell_id(f, l):
        return l * nF + f

    # horizontal faces between layers (internal) — normal along +n:
    # owner = lower cell
    for l in range(1, n_layers):
        for fi, row in enumerate(loc_rows):
            rows.append([pt + l * n_base for pt in row])
            npts_l.append(len(row))
            owner.append(cell_id(fi, l - 1))
            neighbour.append(cell_id(fi, l))
    # vertical (side) faces: for each base-face edge shared by two
    # faces -> internal; boundary edge -> side patch
    edge_users: Dict[Tuple[int, int], List[Tuple[int, Tuple[int, int]]]] = {}
    for fi, row in enumerate(loc_rows):
        m = len(row)
        for e in range(m):
            a, b = row[e], row[(e + 1) % m]
            edge_users.setdefault((min(a, b), max(a, b)), []).append(
                (fi, (a, b)))
    side_rows = []
    for key, users in edge_users.items():
        if len(users) == 2:
            (f0, (a, b)), (f1, _) = users
            ow, ne = (f0, f1) if f0 < f1 else (f1, f0)
            if ow != f0:
                a, b = users[1][1]
            for l in range(n_layers):
                rows.append([b + l * n_base, a + l * n_base,
                             a + (l + 1) * n_base, b + (l + 1) * n_base])
                npts_l.append(4)
                owner.append(cell_id(ow, l))
                neighbour.append(cell_id(ne, l))
        else:
            fi, (a, b) = users[0]
            for l in range(n_layers):
                side_rows.append((
                    [b + l * n_base, a + l * n_base,
                     a + (l + 1) * n_base, b + (l + 1) * n_base],
                    cell_id(fi, l)))

    # canonical internal ordering
    order = np.lexsort((np.asarray(neighbour), np.asarray(owner)))
    rows = [rows[i] for i in order]
    npts_l = [npts_l[i] for i in order]
    owner = [owner[i] for i in order]
    neighbour = [neighbour[i] for i in order]
    nif = len(rows)

    patches: List[Patch] = []
    start = nif
    # bottom (original surface, outward = -n)
    for fi, row in enumerate(loc_rows):
        rows.append(list(reversed(row)))
        npts_l.append(len(row))
        owner.append(cell_id(fi, 0))
    patches.append(Patch(name="bottom", type="patch", start=start,
                         size=nF))
    start += nF
    for fi, row in enumerate(loc_rows):
        rows.append([pt + n_layers * n_base for pt in row])
        npts_l.append(len(row))
        owner.append(cell_id(fi, n_layers - 1))
    patches.append(Patch(name="top", type="patch", start=start, size=nF))
    start += nF
    for row, ow in side_rows:
        rows.append(row)
        npts_l.append(4)
        owner.append(ow)
    patches.append(Patch(name="sides", type="patch", start=start,
                         size=len(side_rows)))

    maxp = max(npts_l)
    fp = np.full((len(rows), maxp), -1, dtype=np.int64)
    for i, r in enumerate(rows):
        fp[i, :len(r)] = r
    out = PolyMesh(points=pts, face_pts=fp,
                   face_npts=np.asarray(npts_l, dtype=np.int64),
                   owner=np.asarray(owner, dtype=np.int64),
                   neighbour=np.asarray(neighbour, dtype=np.int64),
                   patches=patches)
    # orientation fix for side faces (edge winding depends on which
    # face owned the edge)
    dts = np.einsum("fi,fi->f", out.sf, out.cf - out.c[out.owner])
    flip = dts < 0
    if flip.any():
        for i in np.nonzero(flip)[0]:
            k = out.face_npts[i]
            out.face_pts[i, :k] = out.face_pts[i, :k][::-1]
        out.update_geometry()
    mesh_io.write(out, mdir)
    return out


# ---------------------------------------------------------------------------
# refineMesh (reference: .../mesh/manipulation/refineMesh/)
# ---------------------------------------------------------------------------


def refine_mesh(case: str, set_name: Optional[str] = None) -> PolyMesh:
    """One level of 2x2x2 (2x2 in 2D) refinement of a cellSet (or the
    whole mesh) on uniform box backgrounds, reusing the snappy octree
    machinery (split faces at level transitions)."""
    from ..mesh import snappy

    mdir = os.path.join(case, "constant", "polyMesh")
    pm = mesh_io.read(mdir)
    box = snappy._background_box(pm)
    if box is None:
        raise ValueError("refineMesh: only uniform box background "
                         "meshes are supported (octree storage)")
    bb_min, bb_max, base_n, side_patches, two_d = box
    nx, ny, nz = base_n
    if set_name is None:
        dpath = os.path.join(case, "system", "refineMeshDict")
        if os.path.exists(dpath):
            d = parse_file(dpath)
            set_name = str(d.get("set")) if "set" in d else None
    if set_name:
        ids = set(int(i) for i in read_set(case, set_name))
    else:
        ids = None

    ext = bb_max - bb_min
    leaves = {}
    # map each cell to its lattice coords via its centre
    ijk = np.floor((pm.c - bb_min) / ext
                   * np.array([nx, ny, nz])).astype(int)
    ijk = np.clip(ijk, 0, np.array([nx, ny, nz]) - 1)
    for ci in range(pm.n_cells):
        i, j, k = (int(x) for x in ijk[ci])
        if ids is None or ci in ids:
            kr = (k,) if two_d else (2 * k, 2 * k + 1)
            for a in (2 * i, 2 * i + 1):
                for b in (2 * j, 2 * j + 1):
                    for cc in kr:
                        leaves[(1, a, b, cc)] = True
        else:
            leaves[(0, i, j, k)] = True
    out = snappy.octree_mesh(bb_min, bb_max, base_n, set(leaves),
                             side_patches, two_d=two_d)
    mesh_io.write(out, mdir)
    return out


# ---------------------------------------------------------------------------
# changeDictionary (reference: .../preProcessing/changeDictionary/)
# ---------------------------------------------------------------------------


def _deep_merge(dst: FoamDict, src: FoamDict) -> None:
    for k, v in src.items():
        if isinstance(v, FoamDict) and isinstance(dst.get(k), FoamDict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = v


def change_dictionary(case: str, time: str = "0") -> List[str]:
    """Apply system/changeDictionaryDict replacements to field files
    (<time>/<name>) and constant dictionaries."""
    d = parse_file(os.path.join(case, "system", "changeDictionaryDict"))
    repl = d.get("dictionaryReplacement", d)
    changed = []
    for name, sub in repl.items():
        if not isinstance(sub, FoamDict):
            continue
        for cand in (os.path.join(case, time, str(name)),
                     os.path.join(case, "constant", str(name)),
                     os.path.join(case, "system", str(name))):
            if os.path.exists(cand):
                tgt = parse_file(cand)
                _deep_merge(tgt, sub)
                cls = ("volScalarField" if "internalField" in tgt
                       else "dictionary")
                write_file(cand, tgt,
                           foamfile={"class": cls, "object": str(name)})
                changed.append(cand)
                break
    return changed


# ---------------------------------------------------------------------------
# regionSplit / splitMeshRegions (reference: src/meshTools/regionSplit/
# — the FaceCellWave family's flood fill — and applications/utilities/
# mesh/manipulation/splitMeshRegions/)
# ---------------------------------------------------------------------------


def region_split(pm: PolyMesh) -> np.ndarray:
    """Connected-component label per cell across internal faces
    (union-find; the reference walks a FaceCellWave)."""
    parent = np.arange(pm.n_cells, dtype=np.int64)

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    nif = pm.n_internal_faces
    for o, n in zip(pm.owner[:nif], pm.neighbour):
        ro, rn = find(o), find(n)
        if ro != rn:
            parent[max(ro, rn)] = min(ro, rn)
    labels = np.array([find(i) for i in range(pm.n_cells)])
    _, out = np.unique(labels, return_inverse=True)
    return out


def split_mesh_regions(case: str, write_sets: bool = True) -> int:
    """Label the disconnected mesh regions; write one cellSet per
    region (region0, region1, ...). Returns the region count."""
    pm = mesh_io.read(os.path.join(case, "constant", "polyMesh"))
    labels = region_split(pm)
    n = int(labels.max()) + 1
    if write_sets and n > 1:
        for r in range(n):
            write_set(case, f"region{r}", "cellSet",
                      np.nonzero(labels == r)[0])
    return n
