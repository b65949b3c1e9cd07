"""gmshToFoam and netgenNeutralToFoam: Gmsh MSH 2.2 ASCII and Netgen
neutral files -> PolyMesh (port of openfoam-2.2.x_tpu/mesh/gmsh.py: the
local face tables, `read_msh`, `to_polymesh`, `convert`,
`read_netgen_neutral` and `convert_netgen`).

Host numpy and Python dicts, copied unchanged in behaviour. MSH 2.2:
$Nodes, $Elements with volume elements tet(4), hex(5), prism(6),
pyramid(7) and surface elements tri(2), quad(3); $PhysicalNames name the
boundary patches (surface elements without a physical name land in
`defaultFaces`). Internal faces are matched by sorted point sets,
oriented outward from the owner with owner < neighbour upper-triangular
ordering (the canonical polyMesh face order). `mesh/tetmesh.py` feeds
`to_polymesh` directly.
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


def read_msh(path: str):
    """Parse MSH 2.x ASCII: (points [nP,3], cells {type: [..nodes]},
    surf elements [(phys_id, nodes)], phys names {id: name})."""
    with open(path) as f:
        lines = f.read().split("\n")
    i = 0
    points = None
    cells: List[Tuple[int, List[int]]] = []
    surfs: List[Tuple[int, List[int]]] = []
    phys: Dict[int, str] = {}
    while i < len(lines):
        t = lines[i].strip()
        if t == "$PhysicalNames":
            n = int(lines[i + 1])
            for k in range(n):
                parts = lines[i + 2 + k].split()
                phys[int(parts[1])] = parts[2].strip('"')
            i += n + 3
        elif t == "$Nodes":
            n = int(lines[i + 1])
            points = np.empty((n, 3))
            idmap = {}
            for k in range(n):
                parts = lines[i + 2 + k].split()
                idmap[int(parts[0])] = k
                points[k] = [float(parts[1]), float(parts[2]),
                             float(parts[3])]
            i += n + 3
        elif t == "$Elements":
            n = int(lines[i + 1])
            for k in range(n):
                parts = lines[i + 2 + k].split()
                etype = int(parts[1])
                ntags = int(parts[2])
                tags = [int(x) for x in parts[3:3 + ntags]]
                nodes = [idmap[int(x)] for x in parts[3 + ntags:]]
                if etype in (4, 5, 6, 7):
                    cells.append((etype, nodes))
                elif etype in (2, 3):
                    surfs.append((tags[0] if tags else 0, nodes))
            i += n + 3
        else:
            i += 1
    if points is None:
        raise ValueError(f"{path}: no $Nodes section")
    return points, cells, surfs, phys


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


def convert(path: str) -> PolyMesh:
    return to_polymesh(*read_msh(path))


def read_netgen_neutral(path: str):
    """Parse the Netgen neutral volume format (reference:
    applications/utilities/mesh/conversion/netgenNeutralToFoam/):
    npoints / coords, nvolelems / 'mat n1..n4' tets, nsurf /
    'bc n1 n2 n3' boundary triangles (all 1-indexed). Returns the
    same (points, cells, surfs, phys) tuple as read_msh, so
    to_polymesh assembles it unchanged."""
    toks: List[str] = []
    with open(path) as f:
        for ln in f:
            ln = ln.split("#")[0]
            toks.extend(ln.split())
    it = iter(toks)

    def nxt():
        return next(it)

    npts = int(nxt())
    points = np.empty((npts, 3))
    for k in range(npts):
        points[k] = [float(nxt()), float(nxt()), float(nxt())]
    nvol = int(nxt())
    cells = []
    for _ in range(nvol):
        _mat = int(nxt())
        nodes = [int(nxt()) - 1 for _ in range(4)]
        # gmsh etype 4 = 4-node tetrahedron
        cells.append((4, nodes))
    nsurf = int(nxt())
    surfs = []
    phys: Dict[int, str] = {}
    for _ in range(nsurf):
        bc = int(nxt())
        nodes = [int(nxt()) - 1 for _ in range(3)]
        surfs.append((bc, nodes))
        phys.setdefault(bc, f"patch{bc}")
    return points, cells, surfs, phys


def convert_netgen(path: str) -> PolyMesh:
    return to_polymesh(*read_netgen_neutral(path))
