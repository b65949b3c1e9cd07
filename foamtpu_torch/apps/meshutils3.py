"""createBaffles: internal faces of a faceSet become twin boundary
faces, the master keeping the owner side and the slave the reversed
neighbour side; a cyclic patch type crosslinks the pair through
neighbourPatch (the layout fan and fixedJump BCs sit on). A host copy of
openfoam-2.2.x_tpu/apps/meshutils3.py's `create_baffles` and
`create_baffles_cmd`, with the `_face_list` / `_build` helpers of
meshutils2.py, unchanged in behaviour (the reference module imports
jax.numpy further down).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from ..core.dictionary import FoamDict, parse_file
from ..io import polymesh as mesh_io
from ..mesh.core import Patch, PolyMesh
from .meshutils import read_set


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


def create_baffles(pm: PolyMesh, face_ids: np.ndarray,
                   patch_name: str,
                   patch_type: str = "wall") -> PolyMesh:
    nif = pm.n_internal_faces
    face_ids = np.asarray(sorted(set(int(f) for f in face_ids
                                     if f < nif)), np.int64)
    if face_ids.size == 0:
        raise ValueError("createBaffles: no internal faces in set")
    keep = np.ones(nif, bool)
    keep[face_ids] = False
    faces = _face_list(pm)
    new_faces = [faces[i] for i in range(nif) if keep[i]]
    new_owner = list(pm.owner[:nif][keep])
    new_neigh = list(pm.neighbour[keep])
    # existing boundary faces shift down by len(face_ids)
    patches: List[Patch] = []
    start = len(new_faces)
    for p in pm.patches:
        for f in range(p.start, p.start + p.size):
            new_faces.append(faces[f])
            new_owner.append(pm.owner[f])
        patches.append(Patch(name=p.name, type=p.type, start=start,
                             size=p.size))
        start += p.size
    # master: owner side, original orientation
    for f in face_ids:
        new_faces.append(faces[f])
        new_owner.append(pm.owner[f])
    # cyclic baffles (the fan/fixedJump layout) crosslink the pair
    # through neighbourPatch (reference: createBaffles with cyclic
    # patch pairs feeding jumpCyclic BCs)
    nbr_m = f"{patch_name}_slave" if patch_type == "cyclic" else None
    nbr_s = f"{patch_name}_master" if patch_type == "cyclic" else None
    patches.append(Patch(name=f"{patch_name}_master", type=patch_type,
                         start=start, size=len(face_ids),
                         neighbour_patch=nbr_m))
    start += len(face_ids)
    # slave: neighbour side, reversed so the normal points out of it
    for f in face_ids:
        new_faces.append(list(reversed(faces[f])))
        new_owner.append(pm.neighbour[f])
    patches.append(Patch(name=f"{patch_name}_slave", type=patch_type,
                         start=start, size=len(face_ids),
                         neighbour_patch=nbr_s))
    out = _build(pm.points, new_faces, new_owner, new_neigh, patches)
    if pm.cell_zones:
        out.cell_zones.update(pm.cell_zones)
    return out


def create_baffles_cmd(case: str) -> PolyMesh:
    """Driven by system/createBafflesDict:
    { internalFacesOnly true; baffles { b1 { type faceZone|faceSet;
    zoneName/set <name>; patches/patchName ...; } } } — the 2.2.x
    faceSet form is the one honoured here."""
    mdir = os.path.join(case, "constant", "polyMesh")
    pm = mesh_io.read(mdir)
    d = parse_file(os.path.join(case, "system", "createBafflesDict"))
    baffles = d.get("baffles", FoamDict())
    out = pm
    for name in baffles:
        spec = baffles[name]
        if not isinstance(spec, FoamDict):
            continue
        set_name = str(spec.get("set", spec.get("zoneName", name)))
        ids = read_set(case, set_name)
        pname = str(spec.get("patchName", name))
        ptype = str(spec.get("patchType", "wall"))
        out = create_baffles(out, ids, pname, ptype)
    mesh_io.write(out, mdir)
    return out
