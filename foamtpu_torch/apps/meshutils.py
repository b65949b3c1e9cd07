"""topoSet: cell and face sets from system/topoSetDict (a host copy of
openfoam-2.2.x_tpu/apps/meshutils.py's `topo_set`, `read_set`,
`write_set` and their sources, unchanged in behaviour; importing the
reference module loads the JAX package).

Cell sources: boxToCell, sphereToCell, cylinderToCell, cellToCell; face
sources: patchToFace, boxToFace; actions new, add, subtract/delete,
invert; a cellZoneSet (setToCellZone or any cell source) becomes a
cellZone of the mesh. Sets are written under constant/polyMesh/sets/.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ..core.dictionary import FoamDict, parse_file
from ..io import polymesh as mesh_io
from ..mesh.core import PolyMesh


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
