"""sampledSurfaces: cutting planes, iso-surfaces and patch surfaces, with
the legacy-VTK surface writer (port of
openfoam-2.2.x_tpu/functionobjects/surfaces.py; src/sampling/
sampledSurface/{cuttingPlane,isoSurface,sampledPatch} and
surfaceWriters/vtk).

The extraction runs on the host, as in the reference: every cell is
fan-decomposed into tetrahedra (cell centre, face centre, two
consecutive face points), point and face values come from
inverse-distance cell averaging, and a vectorised marching-tetrahedra
pass emits the triangulated surface with linearly interpolated field
values at the iso crossings. `_build_tables`, `_vertex_values`,
`marching_tets` and `write_vtk_surface` are numpy copies of the
reference's; `_build_tables` is vectorised here (the reference loops over
faces in Python) and emits the tets in the reference's order. The tables
are built once per object from the host PolyMesh; each field the object
reads is fetched from the device once per execute.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from .base import FunctionObject, register


def _build_tables(pm):
    """(positions [nV,3], tets [nT,4], point<-cell weights) of a
    PolyMesh. Vertices are stacked [cells | faces | points]; each face
    gives its owner k tets and, if internal, its neighbour k more (the
    reversed edges), face by face. A point's weights are the inverse
    distances to the cells around it, normalised."""
    nC, nF = pm.n_cells, pm.n_faces
    nif = pm.n_internal_faces
    pos = np.concatenate([pm.c, pm.cf, pm.points], axis=0)
    k = np.asarray(pm.face_npts, np.int64)
    mp = pm.face_pts.shape[1]
    e = np.arange(mp)
    pts = np.clip(pm.face_pts, 0, None)
    a = nC + nF + pts                                     # [nF,mp]
    b = nC + nF + np.take_along_axis(
        pts, (e[None, :] + 1) % np.maximum(k[:, None], 1), axis=1)
    face = np.broadcast_to((nC + np.arange(nF))[:, None], (nF, mp))
    own = np.broadcast_to(pm.owner[:, None], (nF, mp))
    nei = np.zeros(nF, np.int64)
    nei[:nif] = pm.neighbour
    nei = np.broadcast_to(nei[:, None], (nF, mp))
    t_own = np.stack([own, face, a, b], axis=-1)          # [nF,mp,4]
    t_nei = np.stack([nei, face, b, a], axis=-1)
    allt = np.stack([t_own, t_nei], axis=1)               # [nF,2,mp,4]
    edge_ok = e[None, :] < k[:, None]                     # [nF,mp]
    side_ok = np.stack([np.ones(nF, bool), np.arange(nF) < nif], axis=1)
    valid = side_ok[:, :, None] & edge_ok[:, None, :]     # [nF,2,mp]
    tets = allt[valid].astype(np.int64)

    # point <- cell pairs (each face's points with its owner, and its
    # neighbour when internal), unique per point
    cell_pairs = np.concatenate([
        np.stack([pts[edge_ok], np.broadcast_to(
            pm.owner[:, None], (nF, mp))[edge_ok]], axis=1),
        np.stack([pts[:nif][edge_ok[:nif]], np.broadcast_to(
            pm.neighbour[:, None], (nif, mp))[edge_ok[:nif]]], axis=1)])
    key = np.unique(cell_pairs[:, 0] * nC + cell_pairs[:, 1])
    rows, cols = key // nC, key % nC
    d = np.linalg.norm(pm.c[cols] - pm.points[rows], axis=1)
    w = 1.0 / np.maximum(d, 1e-12)
    wsum = np.bincount(rows, weights=w, minlength=pm.n_points)
    return pos, tets, (rows, cols, w / wsum[rows])


def _vertex_values(pm, cell_vals: np.ndarray, pt_w) -> np.ndarray:
    """Stack [cells | faces | points] values for a per-cell field."""
    nF, nP = pm.n_faces, pm.n_points
    nif = pm.n_internal_faces
    tail = cell_vals.shape[1:]
    fvals = np.zeros((nF,) + tail)
    w = pm.weights[:nif]
    if tail:
        w = w[:, None]
    fvals[:nif] = (w * cell_vals[pm.owner[:nif]]
                   + (1.0 - w) * cell_vals[pm.neighbour])
    fvals[nif:] = cell_vals[pm.owner[nif:]]
    pvals = np.zeros((nP,) + tail)
    rows, cols, wts = pt_w
    wv = wts[:, None] if tail else wts
    np.add.at(pvals, rows, wv * cell_vals[cols])
    return np.concatenate([cell_vals, fvals, pvals], axis=0)


# marching-tetrahedra edge tables: for each of the 16 sign cases, the
# triangles as triples of tet-edge ids; edges: 0=01 1=02 2=03 3=12
# 4=13 5=23
_EDGE_V = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]])
_CASES: Dict[int, List[Tuple[int, int, int]]] = {
    0b0001: [(0, 1, 2)],
    0b0010: [(0, 4, 3)],
    0b0100: [(1, 3, 5)],
    0b1000: [(2, 5, 4)],
    0b0011: [(1, 2, 4), (1, 4, 3)],
    0b0101: [(0, 3, 5), (0, 5, 2)],
    0b1001: [(0, 1, 5), (0, 5, 4)],
    0b0110: [(0, 1, 5), (0, 5, 4)],
    0b1010: [(0, 3, 5), (0, 5, 2)],
    0b1100: [(1, 2, 4), (1, 4, 3)],
    0b0111: [(2, 5, 4)],
    0b1011: [(1, 3, 5)],
    0b1101: [(0, 4, 3)],
    0b1110: [(0, 1, 2)],
}


def marching_tets(pos, tets, psi, iso, fields: Dict[str, np.ndarray]):
    """Triangulate psi==iso over the tet set; returns (verts [nV,3],
    tris [nT,3], {name: vertex values})."""
    v = psi[tets]                                   # [nT,4]
    s = (v > iso).astype(np.int32)
    code = s[:, 0] | (s[:, 1] << 1) | (s[:, 2] << 2) | (s[:, 3] << 3)
    all_tris = []
    all_pts = []
    out_fields: Dict[str, List[np.ndarray]] = {k: [] for k in fields}
    base = 0
    for c_, tris in _CASES.items():
        sel = np.nonzero(code == c_)[0]
        if sel.size == 0:
            continue
        tsel = tets[sel]
        vsel = v[sel]
        # intersection point on each tet edge
        exyz = {}
        efld = {k: {} for k in fields}
        for e in range(6):
            a, b = _EDGE_V[e]
            va, vb = vsel[:, a], vsel[:, b]
            tpar = (iso - va) / np.where(np.abs(vb - va) < 1e-30, 1e-30,
                                         vb - va)
            tpar = np.clip(tpar, 0.0, 1.0)[:, None]
            pa = pos[tsel[:, a]]
            pb = pos[tsel[:, b]]
            exyz[e] = pa + tpar * (pb - pa)
            for k, fv in fields.items():
                fa = fv[tsel[:, a]]
                fb = fv[tsel[:, b]]
                tp = tpar if fa.ndim == 2 else tpar[:, 0]
                efld[k][e] = fa + tp * (fb - fa)
        for tri in tris:
            pts = np.stack([exyz[e] for e in tri], axis=1)  # [n,3,3]
            n = pts.shape[0]
            all_pts.append(pts.reshape(-1, 3))
            all_tris.append(base + np.arange(3 * n).reshape(n, 3))
            base += 3 * n
            for k in fields:
                fv = np.stack([efld[k][e] for e in tri], axis=1)
                out_fields[k].append(fv.reshape((-1,) + fv.shape[2:]))
    if not all_pts:
        return (np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64),
                {k: np.zeros((0,) + fields[k].shape[1:]) for k in fields})
    return (np.concatenate(all_pts, axis=0),
            np.concatenate(all_tris, axis=0),
            {k: np.concatenate(vs, axis=0) for k, vs in out_fields.items()})


def write_vtk_surface(path: str, verts, tris, fields) -> None:
    """Legacy-VTK polydata writer (vtkSurfaceWriter)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 2.0\nsampledSurface\nASCII\n")
        f.write("DATASET POLYDATA\n")
        f.write(f"POINTS {verts.shape[0]} float\n")
        for p in verts:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")
        f.write(f"POLYGONS {tris.shape[0]} {4 * tris.shape[0]}\n")
        for t in tris:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")
        if fields:
            f.write(f"POINT_DATA {verts.shape[0]}\n")
            for name, v in fields.items():
                if v.ndim == 1:
                    f.write(f"SCALARS {name} float 1\nLOOKUP_TABLE "
                            "default\n")
                    for x in v:
                        f.write(f"{x}\n")
                else:
                    f.write(f"VECTORS {name} float\n")
                    for x in v:
                        f.write(f"{x[0]} {x[1]} {x[2]}\n")


def _patch_surface(pm, names):
    """Fan-triangulated faces of the named patches: (verts, tris, the
    owner cell of each vertex); each face keeps its own vertices."""
    faces = np.concatenate(
        [np.arange(p.start, p.start + p.size) for p in pm.patches
         if p.name in names] or [np.zeros(0, np.int64)])
    verts_l, tris_l, own_v = [], [], []
    base = 0
    for fidx in faces:
        k = pm.face_npts[fidx]
        verts_l.append(pm.points[pm.face_pts[fidx, :k]])
        tris_l += [(base, base + j, base + j + 1) for j in range(1, k - 1)]
        own_v += [pm.owner[fidx]] * k
        base += k
    if not tris_l:
        return None
    return (np.concatenate(verts_l, axis=0), np.asarray(tris_l, np.int64),
            np.asarray(own_v, np.int64))


class SampledSurfaces(FunctionObject):
    """controlDict `surfaces` / `sampledSurfaces` functionObject
    (src/sampling/sampledSurfaces/): cuttingPlane, isoSurface and patch
    surfaces, surfaceFormat vtk, one file per surface under
    postProcessing/<name>/<time>/<surface>.vtk."""

    def __init__(self, name, spec, case):
        super().__init__(name, spec, case)
        self.fields = [str(x) for x in spec.get("fields", [])]
        self.surfaces = []
        surf = spec.get("surfaces", [])
        items = list(surf) if isinstance(surf, list) else [surf]
        i = 0
        while i < len(items):
            sname = str(items[i])
            sspec = items[i + 1] if i + 1 < len(items) else None
            i += 2
            if not hasattr(sspec, "get"):
                i -= 1
                continue
            self.surfaces.append((sname, sspec))
        self._tables = None
        self._patches = {}

    def _ensure_tables(self):
        if self._tables is None:
            self._tables = _build_tables(self.case.poly_mesh)
        return self._tables

    def execute(self, time_name, state):
        pm = self.case.poly_mesh
        pos, tets, pt_w = self._ensure_tables()
        fetched: Dict[str, np.ndarray] = {}

        def cellvals(fname):
            """The field's cell values on the host, fetched once per
            execute."""
            if fname not in fetched:
                src = state.get(fname)
                if src is not None and hasattr(src, "data"):
                    src = src.data
                fetched[fname] = (None if src is None
                                  else self.host(src)
                                  if hasattr(src, "detach")
                                  else np.asarray(src))
            return fetched[fname]

        fields = {}
        for fn in self.fields:
            cv = cellvals(fn)
            if cv is not None:
                fields[fn] = _vertex_values(pm, cv, pt_w)

        for sname, sspec in self.surfaces:
            out = os.path.join(self.out_dir, time_name, f"{sname}.vtk")
            stype = str(sspec.get("type", "cuttingPlane"))
            if stype in ("cuttingPlane", "plane"):
                pnd = sspec.get("pointAndNormalDict", sspec)
                p0 = np.asarray(pnd.get("basePoint",
                                        pnd.get("point", (0, 0, 0))),
                                float).reshape(3)
                nrm = np.asarray(pnd.get("normalVector",
                                         pnd.get("normal", (0, 0, 1))),
                                 float).reshape(3)
                nrm = nrm / max(np.linalg.norm(nrm), 1e-300)
                psi = (pos - p0) @ nrm
                iso = 0.0
            elif stype == "isoSurface":
                cv = cellvals(str(sspec.get("isoField")))
                if cv is None:
                    continue
                if cv.ndim == 2:
                    cv = np.linalg.norm(cv, axis=1)
                psi = _vertex_values(pm, cv, pt_w)
                iso = float(sspec.get("isoValue", 0.5))
            elif stype in ("patch", "patchSurface"):
                # sampledPatch: fan-triangulated patch faces carrying the
                # wall-adjacent cell values
                pnames = tuple(str(x) for x in
                               (sspec.get("patches")
                                or [sspec.get("patchName", "")]))
                if pnames not in self._patches:
                    self._patches[pnames] = _patch_surface(pm, pnames)
                surf = self._patches[pnames]
                if surf is None:
                    continue
                verts, tris, own_v = surf
                fvals = {}
                for fn in self.fields:
                    cv = cellvals(fn)
                    if cv is not None:
                        fvals[fn] = np.asarray(cv[own_v], dtype=np.float64)
                write_vtk_surface(out, verts, tris, fvals)
                continue
            else:
                continue
            verts, tris, fvals = marching_tets(pos, tets, psi, iso, fields)
            write_vtk_surface(out, verts, tris, fvals)


register("surfaces", SampledSurfaces)
register("sampledSurfaces", SampledSurfaces)
