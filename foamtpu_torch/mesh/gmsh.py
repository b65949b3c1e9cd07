"""gmshToFoam assembly: volume cells + boundary surface elements ->
PolyMesh (port of openfoam-2.2.x_tpu/mesh/gmsh.py: the local face tables
and `to_polymesh`).

Host numpy and Python dicts, copied unchanged in behaviour: internal
faces are matched by sorted point sets, oriented outward from the owner
with owner < neighbour upper-triangular ordering (the canonical polyMesh
face order). The MSH file reader (`read_msh`, `convert`) is outside the
ported slice; `mesh/tetmesh.py` feeds `to_polymesh` directly.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .core import Patch, PolyMesh

# local face definitions (gmsh node ordering), faces outward-oriented
_TET_FACES = ((1, 2, 3), (0, 3, 2), (0, 1, 3), (0, 2, 1))
_HEX_FACES = ((0, 3, 2, 1), (4, 5, 6, 7), (0, 1, 5, 4),
              (1, 2, 6, 5), (2, 3, 7, 6), (3, 0, 4, 7))
_PRISM_FACES = ((0, 2, 1), (3, 4, 5), (0, 1, 4, 3), (1, 2, 5, 4),
                (2, 0, 3, 5))
_PYR_FACES = ((0, 3, 2, 1), (0, 1, 4), (1, 2, 4), (2, 3, 4), (3, 0, 4))

_CELL_FACES = {4: _TET_FACES, 5: _HEX_FACES, 6: _PRISM_FACES,
               7: _PYR_FACES}


def to_polymesh(points, cells, surfs, phys) -> PolyMesh:
    """Assemble the face-addressed polyMesh from volume cells
    [(gmsh type, nodes)], boundary surface elements [(physical id,
    nodes)] and physical names {id: name}."""
    # every cell face as (sorted-key -> (cell, oriented nodes))
    face_of: Dict[Tuple[int, ...], List[Tuple[int, Tuple[int, ...]]]] = {}
    for ci, (etype, nodes) in enumerate(cells):
        for loc in _CELL_FACES[etype]:
            fn = tuple(nodes[j] for j in loc)
            key = tuple(sorted(fn))
            face_of.setdefault(key, []).append((ci, fn))

    # boundary classification from surface elements
    surf_patch: Dict[Tuple[int, ...], int] = {}
    for pid, nodes in surfs:
        surf_patch[tuple(sorted(nodes))] = pid

    int_faces = []   # (own, nei, nodes-owner-oriented)
    bnd: Dict[int, List[Tuple[int, Tuple[int, ...]]]] = {}
    for key, users in face_of.items():
        if len(users) == 2:
            (c0, f0), (c1, f1) = users
            own, nei = (c0, c1) if c0 < c1 else (c1, c0)
            fn = f0 if own == c0 else f1
            int_faces.append((own, nei, fn))
        elif len(users) == 1:
            ci, fn = users[0]
            pid = surf_patch.get(key, -1)
            bnd.setdefault(pid, []).append((ci, fn))
        else:
            raise ValueError("face shared by >2 cells — broken mesh")

    int_faces.sort(key=lambda t: (t[0], t[1]))
    rows: List[Tuple[int, ...]] = [f for _, _, f in int_faces]
    owner = [o for o, _, _ in int_faces]
    neighbour = [n for _, n, _ in int_faces]

    patches: List[Patch] = []
    start = len(rows)
    for pid in sorted(bnd):
        faces = bnd[pid]
        name = phys.get(pid, "defaultFaces" if pid < 0
                        else f"patch{pid}")
        ptype = "wall" if "wall" in name.lower() else (
            "empty" if "empty" in name.lower() or
            "frontandback" in name.lower() else "patch")
        for ci, fn in faces:
            rows.append(fn)
            owner.append(ci)
        patches.append(Patch(name=name, type=ptype, start=start,
                             size=len(faces)))
        start += len(faces)

    maxp = max(len(r) for r in rows)
    fp = np.full((len(rows), maxp), -1, dtype=np.int64)
    npts = np.empty(len(rows), dtype=np.int64)
    for i, r in enumerate(rows):
        fp[i, :len(r)] = r
        npts[i] = len(r)
    pm = PolyMesh(points=np.asarray(points, float), face_pts=fp,
                  face_npts=npts,
                  owner=np.asarray(owner, dtype=np.int64),
                  neighbour=np.asarray(neighbour, dtype=np.int64),
                  patches=patches)
    # fix face orientation: every face area vector must point away from
    # its owner (gmsh volume-element face tables are outward for the
    # canonical node order, but element files in the wild vary)
    d = np.einsum("fi,fi->f", pm.sf, pm.cf - pm.c[pm.owner])
    flip = d < 0
    if flip.any():
        for i in np.nonzero(flip)[0]:
            k = pm.face_npts[i]
            pm.face_pts[i, :k] = pm.face_pts[i, :k][::-1]
        pm.update_geometry()
    return pm
