"""Mesh and field utilities on the host and the case's device:
createBaffles, setsToZones, foamFormatConvert, deformedGeom,
postChannel, stitchMesh and temporalInterpolate (a copy of
openfoam-2.2.x_tpu/apps/meshutils3.py, unchanged in behaviour; the
reference module imports jax.numpy). The mesh surgery is host numpy
written back through io/polymesh, with meshutils2.py's `_face_list` and
`_build`. The commands that read fields open the case on `device`
(core/precision.py::DEFAULT_DEVICE, the card, unless the caller asks
for the CPU): deformedGeom and postChannel fetch U once to the host,
temporalInterpolate blends the two times' fields on the device.

createBaffles: internal faces of a faceSet become twin boundary faces,
the master keeping the owner side and the slave the reversed neighbour
side; a cyclic patch type crosslinks the pair through neighbourPatch
(the layout fan and fixedJump BCs sit on).
"""

from __future__ import annotations

import glob
import os
from typing import List

import numpy as np

from ..core.dictionary import FoamDict, parse_file
from ..core.precision import DEFAULT_DEVICE
from ..io import polymesh as mesh_io
from ..mesh.core import Patch, PolyMesh
from .meshutils import read_set
from .meshutils2 import _build, _face_list


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


# ---------------------------------------------------------------------------
# setsToZones (reference: .../mesh/manipulation/setsToZones/)
# ---------------------------------------------------------------------------

def sets_to_zones(case: str) -> List[str]:
    """Promote every saved cellSet to a cellZone (faceSets have no
    zone container in this mesh format — documented deviation)."""
    mdir = os.path.join(case, "constant", "polyMesh")
    pm = mesh_io.read(mdir)
    names = []
    for path in sorted(glob.glob(os.path.join(mdir, "sets", "*"))):
        name = os.path.basename(path)
        try:
            txt = open(path).read()
        except OSError:
            continue
        if "cellSet" not in txt.split("FoamFile")[1][:400]:
            continue
        ids = read_set(case, name)
        pm.cell_zones[name] = np.asarray(ids, np.int64)
        names.append(name)
    if names:
        mesh_io.write(pm, mdir)
    return names


# ---------------------------------------------------------------------------
# foamFormatConvert (reference: .../miscellaneous/foamFormatConvert/)
# ---------------------------------------------------------------------------

def foam_format_convert(case: str, fmt: str, time_name: str = None,
                        device=DEFAULT_DEVICE) -> List[str]:
    """Rewrite every field of a time directory in ascii|binary."""
    from ..core.case import Case
    from ..io import fields as field_io

    c = Case(case, device=device)
    t = time_name or c.latest_time_name()
    tdir = os.path.join(case, t)
    done = []
    for path in sorted(glob.glob(os.path.join(tdir, "*"))):
        nm = os.path.basename(path)
        if not os.path.isfile(path) or nm.endswith(".gz"):
            continue
        try:
            f = c.read_field(nm, time=t)
        except Exception:
            continue
        field_io.write_field(f, c.mesh, case, t, fmt=fmt)
        done.append(nm)
    return done


# ---------------------------------------------------------------------------
# deformedGeom (reference: .../mesh/manipulation/deformedGeom/):
# points displaced by the POINT-interpolated velocity * scale
# ---------------------------------------------------------------------------

def _vol_point_interpolate(pm: PolyMesh, cell_vals: np.ndarray
                           ) -> np.ndarray:
    """Inverse-distance point <- cell interpolation (reference:
    src/finiteVolume/interpolation/volPointInterpolation/)."""
    nP = pm.n_points
    acc = np.zeros((nP,) + cell_vals.shape[1:])
    wsum = np.zeros(nP)
    for f in range(pm.n_faces):
        cells = [pm.owner[f]]
        if f < pm.n_internal_faces:
            cells.append(pm.neighbour[f])
        for pt in pm.face_pts[f, :pm.face_npts[f]]:
            for cc in cells:
                d = np.linalg.norm(pm.c[cc] - pm.points[pt])
                w = 1.0 / max(d, 1e-12)
                acc[pt] += w * cell_vals[cc]
                wsum[pt] += w
    return acc / np.maximum(wsum, 1e-300)[:, None]


def deformed_geom(case: str, scale: float, time_name: str = None,
                  device=DEFAULT_DEVICE) -> PolyMesh:
    from ..core.case import Case

    c = Case(case, device=device)
    t = time_name or c.latest_time_name()
    U = c.read_field("U", time=t)
    pm = c.poly_mesh
    disp = _vol_point_interpolate(pm, U.data.detach().cpu().numpy())
    out = PolyMesh(points=pm.points + scale * disp,
                   face_pts=pm.face_pts, face_npts=pm.face_npts,
                   owner=pm.owner, neighbour=pm.neighbour,
                   patches=pm.patches)
    mesh_io.write(out, os.path.join(case, "constant", "polyMesh"))
    return out


# ---------------------------------------------------------------------------
# postChannel (reference: .../postProcessing/channel/postChannel/):
# collapse U (and optionally k) to wall-normal profiles by averaging
# over homogeneous x-z planes
# ---------------------------------------------------------------------------

def post_channel(case: str, time_name: str = None, normal: int = 1,
                 device=DEFAULT_DEVICE) -> str:
    from ..core.case import Case

    c = Case(case, device=device)
    t = time_name or c.latest_time_name()
    mesh = c.mesh
    y = np.round(mesh.c[:, normal].detach().cpu().numpy(), 10)
    U = c.read_field("U", time=t).data.detach().cpu().numpy()
    ys, inv = np.unique(y, return_inverse=True)
    cnt = np.bincount(inv).astype(float)
    Um = np.stack([np.bincount(inv, weights=U[:, i]) / cnt
                   for i in range(3)], axis=1)
    uprime = np.sqrt(np.maximum(
        np.stack([np.bincount(inv, weights=U[:, i] ** 2) / cnt
                  for i in range(3)], axis=1) - Um ** 2, 0.0))
    out_dir = os.path.join(case, "postProcessing", "channel", t)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "Uf.xy")
    with open(path, "w") as f:
        f.write("# y Umean_x Umean_y Umean_z u' v' w'\n")
        for i, yy in enumerate(ys):
            f.write(f"{yy:g} " + " ".join(f"{v:.8g}" for v in Um[i])
                    + " " + " ".join(f"{v:.8g}" for v in uprime[i])
                    + "\n")
    return path


# ---------------------------------------------------------------------------
# stitchMesh (reference: .../mesh/manipulation/stitchMesh/): merge two
# boundary patches whose faces coincide geometrically into internal
# faces — the perfect-match (integral) mode
# ---------------------------------------------------------------------------

def stitch_mesh(pm: PolyMesh, master: str, slave: str,
                tol: float = 1e-7) -> PolyMesh:
    mp = next(p for p in pm.patches if p.name == master)
    sp = next(p for p in pm.patches if p.name == slave)
    if mp.size != sp.size:
        raise ValueError(f"stitchMesh: patch sizes differ "
                         f"({mp.size} vs {sp.size})")
    scale = float(np.abs(pm.points).max()) or 1.0
    mc = pm.cf[mp.start:mp.start + mp.size]
    sc = pm.cf[sp.start:sp.start + sp.size]
    # match slave faces to master faces by centre
    from scipy.spatial import cKDTree

    tree = cKDTree(sc)
    d, j = tree.query(mc)
    if d.max() > tol * scale:
        raise ValueError(f"stitchMesh: faces do not coincide "
                         f"(max gap {d.max():.3g})")
    if len(set(j.tolist())) != mp.size:
        raise ValueError("stitchMesh: non-bijective face match")

    faces = _face_list(pm)
    nif = pm.n_internal_faces
    new_faces = [faces[i] for i in range(nif)]
    new_owner = list(pm.owner[:nif])
    new_neigh = list(pm.neighbour)
    # new internal faces: master geometry, owner = master owner,
    # neighbour = slave owner (flip if owner > neighbour to keep the
    # owner < neighbour convention)
    for k in range(mp.size):
        fm = mp.start + k
        fs = sp.start + int(j[k])
        o, n = int(pm.owner[fm]), int(pm.owner[fs])
        if o <= n:
            new_faces.append(faces[fm])
            new_owner.append(o)
            new_neigh.append(n)
        else:
            new_faces.append(list(reversed(faces[fm])))
            new_owner.append(n)
            new_neigh.append(o)
    patches: List[Patch] = []
    start = len(new_faces)
    drop = {master, slave}
    for p in pm.patches:
        if p.name in drop:
            continue
        for f in range(p.start, p.start + p.size):
            new_faces.append(faces[f])
            new_owner.append(pm.owner[f])
        patches.append(Patch(name=p.name, type=p.type, start=start,
                             size=p.size))
        start += p.size
    out = _build(pm.points, new_faces, new_owner, new_neigh, patches)
    if pm.cell_zones:
        out.cell_zones.update(pm.cell_zones)
    return out


# ---------------------------------------------------------------------------
# temporalInterpolate (reference: .../postProcessing/miscellaneous/
# temporalInterpolate/): linear interpolation of fields between two
# saved times
# ---------------------------------------------------------------------------

def temporal_interpolate(case: str, t_target: float, fields: List[str],
                         device=DEFAULT_DEVICE) -> List[str]:
    from ..core.case import Case
    from ..core import runtime
    from ..io import fields as field_io

    c = Case(case, device=device)
    times = []
    for dname in os.listdir(case):
        try:
            times.append((float(dname), dname))
        except ValueError:
            continue
    times.sort()
    lo = max((t for t in times if t[0] <= t_target),
             default=None)
    hi = min((t for t in times if t[0] >= t_target),
             default=None)
    if lo is None or hi is None:
        raise ValueError("temporalInterpolate: target outside the "
                         "saved time range")
    w = 0.0 if hi[0] == lo[0] else \
        (t_target - lo[0]) / (hi[0] - lo[0])
    tname = runtime.time_name(t_target, c.time.time_precision)
    done = []
    for name in fields:
        f0 = c.read_field(name, time=lo[1])
        f1 = c.read_field(name, time=hi[1])
        f = f0.with_data((1.0 - w) * f0.data + w * f1.data)
        field_io.write_field(f, c.mesh, case, tname)
        done.append(name)
    return done
