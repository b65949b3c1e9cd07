"""Command-line utilities (port of openfoam-2.2.x_tpu/apps/cli.py: the
solver and case-setup commands run, blockMesh, snappyHexMesh, setFields,
topoSet, createBaffles and boxTurb; the solver-side utilities checkMesh,
renumberMesh, transformPoints, foamListTimes, mapFields, patchAverage,
foamCalc, writeCellCentres, writeCellVolumes, postProcess and
execFlowFunctionObjects, sample and foamToVTK; the rest of the
reference's own table: the mesh manipulation commands (createPatch,
extrudeMesh, refineMesh, mirrorMesh, subsetMesh, mergeMeshes,
flattenMesh, autoPatch, splitMeshRegions, setSet, setsToZones,
stitchMesh, deformedGeom, writeMeshObj), the importers (gmshToFoam,
netgenNeutralToFoam, fluentMeshToFoam), changeDictionary,
foamFormatConvert, temporalInterpolate, postChannel, foamToEnsight,
particleTracks, the surface tools (surfaceCheck, surfaceConvert /
objToVTK, surfaceTransformPoints, surfaceSubset), the thermo tools
(adiabaticFlameT, mixtureAdiabaticFlameT, chemkinToFoam),
foamDebugSwitches and the tutorials harness; and the 22 commands of
apps/postutils.py, added through `COMMANDS.update` as in the reference).

    python -m foamtpu_torch <command> -case <dir> [-device cpu] ...

Commands that read fields put them on the card unless `-device cpu` is
given; the others work on the host's mesh, sets, dictionaries and files
alone. Every other command of the reference (`REFERENCE_ONLY`) raises
NotImplementedError naming it.
"""

from __future__ import annotations

import argparse
import os
import sys


def _case_arg(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("-case", default=".")
    ap.add_argument("-device", default=None)
    ap.add_argument("-steps", type=int, default=None)
    ap.add_argument("-time", default=None)
    ap.add_argument("-parallel", action="store_true")
    return ap.parse_args(argv)


def _device(args):
    from ..core.precision import DEFAULT_DEVICE

    return args.device or DEFAULT_DEVICE


def run(argv) -> int:
    """Run the case's controlDict application (the reference's `run`):
    on the card unless `-device cpu`, `-steps N` stopping after N
    steps."""
    args = _case_arg(argv)
    from ..core.case import run_case
    from ..core.precision import DEFAULT_DEVICE

    run_case(args.case, max_steps=args.steps,
             device=args.device or DEFAULT_DEVICE, parallel=args.parallel)
    return 0


def block_mesh(argv) -> int:
    args = _case_arg(argv)
    from ..io import polymesh as mesh_io
    from ..mesh import blockmesh

    for cand in ("constant/polyMesh/blockMeshDict", "system/blockMeshDict"):
        path = os.path.join(args.case, cand)
        if os.path.exists(path):
            break
    else:
        print("blockMesh: no blockMeshDict found", file=sys.stderr)
        return 1
    mesh = blockmesh.generate(path)
    out = os.path.join(args.case, "constant", "polyMesh")
    mesh_io.write(mesh, out)
    print(f"blockMesh: wrote {mesh.n_cells} cells, {mesh.n_faces} faces, "
          f"{len(mesh.patches)} patches -> {out}")
    return 0


def set_fields(argv) -> int:
    """setFields: initialise field regions from system/setFieldsDict.
    Supports boxToCell with volScalarFieldValue / volVectorFieldValue;
    any other cell source raises NotImplementedError naming it."""
    import numpy as np
    import torch

    from ..core import runtime
    from ..core.case import Case
    from ..core.dictionary import parse_file
    from ..core.precision import DEFAULT_DEVICE
    from ..io import fields as field_io

    args = _case_arg(argv)
    case = Case(args.case, device=args.device or DEFAULT_DEVICE)
    mesh = case.mesh
    d = parse_file(os.path.join(args.case, "system", "setFieldsDict"))

    def parse_values(lst):
        out = {}
        items = list(lst) if isinstance(lst, list) else [lst]
        i = 0
        while i < len(items) - 2:
            if str(items[i]).endswith("FieldValue"):
                out[str(items[i + 1])] = items[i + 2]
                i += 3
            else:
                i += 1
        return out

    def value(val):
        return torch.tensor(np.asarray(val, dtype=float),
                            dtype=mesh.v.dtype, device=mesh.device)

    fields = {}
    for name, val in parse_values(d.get("defaultFieldValues", [])).items():
        f = case.read_field(name)
        fields[name] = f.with_data(
            torch.broadcast_to(value(val), f.data.shape).clone())

    c = mesh.c.detach().cpu().numpy()
    regions = d.get("regions", [])
    items = list(regions) if isinstance(regions, list) else [regions]
    i = 0
    while i < len(items):
        kind = str(items[i])
        spec = items[i + 1] if i + 1 < len(items) else None
        i += 2
        if kind != "boxToCell" or spec is None:
            raise NotImplementedError(
                f"setFields source {kind!r} is not ported to foamtpu_torch "
                "yet")
        box = np.asarray(spec["box"], dtype=float).reshape(2, 3)
        mask = torch.as_tensor(
            np.all((c >= box[0]) & (c <= box[1]), axis=1),
            device=mesh.device)
        for name, val in parse_values(spec.get("fieldValues", [])).items():
            f = fields.get(name) or case.read_field(name)
            data = f.data.clone()
            data[mask] = value(val)
            fields[name] = f.with_data(data)

    tname = runtime.time_name(case.time.start_time)
    for f in fields.values():
        field_io.write_field(f, mesh, case.dir, tname)
    print(f"setFields: updated {sorted(fields)} at time {tname}")
    return 0


def topo_set_cmd(argv) -> int:
    """topoSet: create cell/face sets from system/topoSetDict
    (mesh/manipulation/topoSet)."""
    args = _case_arg(argv)
    from . import meshutils

    names = meshutils.topo_set(args.case)
    print(f"topoSet: wrote sets {names}")
    return 0


def create_baffles_cmd(argv) -> int:
    """createBaffles: faceSet internal faces -> twin baffle patches
    (mesh/manipulation/createBaffles)."""
    args = _case_arg(argv)
    from . import meshutils3

    out = meshutils3.create_baffles_cmd(args.case)
    print(f"createBaffles: patches now "
          f"{[(p.name, p.size) for p in out.patches]}")
    return 0


def box_turb(argv) -> int:
    """boxTurb: a divergence-free synthetic turbulence initial U
    (preProcessing/boxTurb, constant/boxTurbDict {Ea; k0; seed;}) on a
    uniform single-box mesh, its grid dimensions inferred from the cell
    centres; the spectrum is made on the host (models/randomprocesses)."""
    import numpy as np
    import torch

    from ..core import runtime
    from ..core.case import Case
    from ..core.dictionary import parse_file
    from ..core.precision import DEFAULT_DEVICE
    from ..io import fields as field_io
    from ..models import randomprocesses as rp

    args = _case_arg(argv)
    case = Case(args.case, device=args.device or DEFAULT_DEVICE)
    mesh = case.mesh
    d = parse_file(os.path.join(args.case, "constant", "boxTurbDict"))
    Ea = float(d.get("Ea", 1.0))
    k0 = float(d.get("k0", 5.0))
    seed = int(d.get("seed", 0))

    c = mesh.c.detach().cpu().numpy()
    lo, hi = c.min(axis=0), c.max(axis=0)
    dims = []
    for ax in range(3):
        u = np.unique(np.round((c[:, ax] - lo[ax]) /
                               max(hi[ax] - lo[ax], 1e-30) * 1e6))
        dims.append(len(u))
    nx, ny, nz = dims
    assert nx * ny * nz == mesh.n_cells, (
        f"boxTurb needs a uniform box mesh; inferred {dims} vs "
        f"{mesh.n_cells} cells")
    L = hi - lo + (hi - lo) / (np.maximum(np.asarray(dims), 2) - 1 + 1e-30)
    u = rp.box_turb((nx, ny, nz), L, Ea, k0, seed)
    # grid -> cell ordering by index lookup
    span = np.maximum(hi - lo, 1e-30)
    idx = np.round((c - lo) / span * (np.asarray(dims) - 1)).astype(int)
    flat = u[idx[:, 0], idx[:, 1], idx[:, 2], :]
    U = case.read_field("U")
    U = U.with_data(torch.tensor(flat, dtype=mesh.v.dtype,
                                 device=mesh.device))
    tname = runtime.time_name(case.time.start_time)
    field_io.write_field(U, mesh, case.dir, tname)
    tke = 0.5 * float(np.mean(np.sum(flat * flat, axis=1)))
    print(f"boxTurb: wrote U ({nx}x{ny}x{nz}), k = {tke:.4g} "
          f"(target {1.5 * Ea:.4g})")
    return 0


def snappy_hex_mesh(argv) -> int:
    """snappyHexMesh (castellate + refine + snap + addLayers: see
    mesh/snappy.py and mesh/layers.py): carve the existing
    constant/polyMesh against the STL geometry in
    system/snappyHexMeshDict and write the result over it."""
    args = _case_arg(argv)
    from ..core.dictionary import parse_file
    from ..io import polymesh as mesh_io
    from ..mesh import snappy

    mdir = os.path.join(args.case, "constant", "polyMesh")
    pm = mesh_io.read(mdir)
    d = parse_file(os.path.join(args.case, "system", "snappyHexMeshDict"))
    out = snappy.from_dict(args.case, d, pm)
    mesh_io.write(out, mdir)
    print(f"snappyHexMesh: {pm.n_cells} -> {out.n_cells} cells, patches "
          f"{[pt.name for pt in out.patches]}")
    return 0


def check_mesh(argv) -> int:
    """checkMesh: topology and geometry checks of constant/polyMesh on the
    host (mesh/check.py), its statistics printed."""
    args = _case_arg(argv)
    from ..io import polymesh as mesh_io
    from ..mesh.check import check

    mesh = mesh_io.read(os.path.join(args.case, "constant", "polyMesh"))
    check(mesh, verbose=True)
    print("Mesh OK.")
    return 0


def foam_to_vtk(argv) -> int:
    """foamToVTK [-time t]: the mesh and one time's fields as a legacy
    VTK file under <case>/VTK/ (io/vtk.py)."""
    args = _case_arg(argv)
    from ..io import vtk as vtk_io

    out = vtk_io.case_to_vtk(args.case, time_name=args.time,
                             device=_device(args))
    print(f"foamToVTK: wrote {out}")
    return 0


def renumber_mesh(argv) -> int:
    """renumberMesh: reverse Cuthill-McKee cell renumbering of
    constant/polyMesh on the host (mesh/renumber.py); prints the
    bandwidth before and after."""
    args = _case_arg(argv)
    from ..io import polymesh as mesh_io
    from ..mesh import renumber as rn

    mdir = os.path.join(args.case, "constant", "polyMesh")
    mesh = mesh_io.read(mdir)
    bw0 = rn.bandwidth(mesh)
    new, order = rn.renumber(mesh)
    mesh_io.write(new, mdir)
    print(f"renumberMesh: bandwidth {bw0} -> {rn.bandwidth(new)}")
    return 0


def foam_list_times(argv) -> int:
    """foamListTimes: the case's time directories after the start."""
    args = _case_arg(argv)
    out = []
    for d in os.listdir(args.case):
        try:
            t = float(d)
        except ValueError:
            continue
        if os.path.isdir(os.path.join(args.case, d)) and t > 0:
            out.append((t, d))
    for _, d in sorted(out):
        print(d)
    return 0


def transform_points(argv) -> int:
    """transformPoints -translate/-scale/-rollPitchYaw (degrees) of
    constant/polyMesh, on the host."""
    import numpy as np

    ap = argparse.ArgumentParser()
    ap.add_argument("-case", default=".")
    ap.add_argument("-translate", default=None)
    ap.add_argument("-scale", default=None)
    ap.add_argument("-rollPitchYaw", default=None)
    args = ap.parse_args(argv)

    def vec3(s):
        return np.asarray([float(x) for x in
                           s.replace("(", " ").replace(")", " ").split()],
                          dtype=float)

    from ..io import polymesh as mesh_io

    mdir = os.path.join(args.case, "constant", "polyMesh")
    mesh = mesh_io.read(mdir)
    pts = np.asarray(mesh.points, dtype=float)
    if args.rollPitchYaw:
        r, p, y = np.deg2rad(vec3(args.rollPitchYaw))

        def rot(ax, ang):
            c, s = np.cos(ang), np.sin(ang)
            i, j = [(1, 2), (0, 2), (0, 1)][ax]
            R = np.eye(3)
            R[i, i] = R[j, j] = c
            R[i, j], R[j, i] = (-s, s) if ax != 1 else (s, -s)
            return R
        R = rot(2, y) @ rot(1, p) @ rot(0, r)
        pts = pts @ R.T
    if args.scale:
        pts = pts * np.resize(vec3(args.scale), 3)
    if args.translate:
        pts = pts + vec3(args.translate)
    mesh.points = pts
    mesh.update_geometry()
    mesh_io.write(mesh, mdir)
    print(f"transformPoints: wrote {len(pts)} points")
    return 0


def map_fields(argv) -> int:
    """mapFields <sourceCase> -case <target>: the source's start-time
    fields mapped to the target's cells by the nearest source cell
    (scipy's cKDTree on the host), gathered on the target's device and
    written at its start time."""
    import numpy as np
    import torch
    from scipy.spatial import cKDTree

    from ..core import runtime
    from ..core.case import Case
    from ..io import fields as field_io

    ap = argparse.ArgumentParser()
    ap.add_argument("source")
    ap.add_argument("-case", default=".")
    ap.add_argument("-sourceTime", default=None)
    ap.add_argument("-device", default=None)
    args = ap.parse_args(argv)
    src = Case(args.source, device=_device(args))
    dst = Case(args.case, device=_device(args))
    stime = args.sourceTime or runtime.time_name(src.time.start_time)
    tree = cKDTree(src.mesh.c.detach().cpu().numpy())
    idx = tree.query(dst.mesh.c.detach().cpu().numpy())[1]
    idx = torch.as_tensor(np.asarray(idx, dtype=np.int64),
                          device=src.mesh.device)
    sdir = os.path.join(src.dir, stime)
    tname = runtime.time_name(dst.time.start_time)
    n = 0
    for fname in sorted(os.listdir(sdir)):
        if fname.endswith(".gz"):
            fname = fname[:-3]
        try:
            sf = src.read_field(fname, time=stime)
            df = dst.read_field(fname)
        except Exception:
            continue
        field_io.write_field(df.with_data(sf.data[idx].to(
            dst.mesh.v.dtype)), dst.mesh, dst.dir, tname)
        n += 1
    print(f"mapFields: mapped {n} fields {args.source}:{stime} -> "
          f"{args.case}:{tname}")
    return 0


def patch_average(argv) -> int:
    """patchAverage <field> <patch>: the area-weighted average of the
    patch cells' values at the latest time."""
    ap = argparse.ArgumentParser()
    ap.add_argument("field")
    ap.add_argument("patch")
    ap.add_argument("-case", default=".")
    ap.add_argument("-time", default=None)
    ap.add_argument("-device", default=None)
    args = ap.parse_args(argv)
    from ..core.case import Case

    case = Case(args.case, device=_device(args))
    t = args.time or case.latest_time_name()
    f = case.read_field(args.field, time=t)
    mesh = case.mesh
    for p in mesh.patches:
        if p.name == args.patch:
            vals = f.data[mesh.owner[p.slice]]
            w = mesh.mag_sf[p.slice]
            avg = (vals * (w[:, None] if vals.ndim == 2 else w)
                   ).sum(dim=0) / w.sum()
            print(f"Average of {args.field} over patch {args.patch} = "
                  f"{avg.detach().cpu().numpy()}")
            return 0
    print(f"patch {args.patch!r} not found", file=sys.stderr)
    return 1


def foam_calc(argv) -> int:
    """foamCalc mag|components <field> at the latest time."""
    ap = argparse.ArgumentParser()
    ap.add_argument("op", choices=["mag", "components"])
    ap.add_argument("field")
    ap.add_argument("-case", default=".")
    ap.add_argument("-time", default=None)
    ap.add_argument("-device", default=None)
    args = ap.parse_args(argv)
    import torch

    from ..core.case import Case
    from ..core.fields import vol_scalar
    from ..io import fields as field_io

    case = Case(args.case, device=_device(args))
    t = args.time or case.latest_time_name()
    f = case.read_field(args.field, time=t)
    data = f.data
    mesh = case.mesh
    if args.op == "mag":
        mag = torch.linalg.vector_norm(data, dim=-1) if data.ndim == 2 \
            else torch.abs(data)
        out = vol_scalar(mesh, 0.0, name=f"mag({args.field})",
                         dims=f.dims).with_data(mag)
        field_io.write_field(out, mesh, case.dir, t)
        print(f"foamCalc: wrote mag({args.field}) at {t}")
    else:
        for i, c in enumerate("xyz"[:data.shape[1]]):
            out = vol_scalar(mesh, 0.0, name=f"{args.field}{c}",
                             dims=f.dims).with_data(data[:, i].clone())
            field_io.write_field(out, mesh, case.dir, t)
        print(f"foamCalc: wrote {args.field}{{x,y,z}} at {t}")
    return 0


def write_cell_centres(argv) -> int:
    """writeCellCentres: ccx, ccy and ccz at the start time."""
    args = _case_arg(argv)
    from ..core import runtime
    from ..core.case import Case
    from ..core.fields import vol_scalar
    from ..io import fields as field_io

    case = Case(args.case, device=_device(args))
    mesh = case.mesh
    t = runtime.time_name(case.time.start_time)
    for i, name in enumerate(("ccx", "ccy", "ccz")):
        f = vol_scalar(mesh, 0.0, name=name).with_data(
            mesh.c[:, i].clone())
        field_io.write_field(f, mesh, case.dir, t)
    print(f"writeCellCentres: wrote ccx/ccy/ccz at {t}")
    return 0


def write_cell_volumes(argv) -> int:
    """writeCellVolumes: V at the latest time, and the total."""
    args = _case_arg(argv)
    from ..core.case import Case
    from ..core.dimensions import DimensionSet
    from ..core.fields import vol_scalar
    from ..io import fields as field_io

    case = Case(args.case, device=_device(args))
    mesh = case.mesh
    t = args.time or case.latest_time_name()
    out = vol_scalar(mesh, 0.0, name="V",
                     dims=DimensionSet.of(0, 3, 0)).with_data(mesh.v)
    field_io.write_field(out, mesh, case.dir, t)
    print(f"writeCellVolumes: wrote V at {t} "
          f"(total {float(mesh.v.sum()):.6g} m^3)")
    return 0


def _saved_times(case_dir, only=None):
    times = []
    for d in sorted(os.listdir(case_dir)):
        try:
            float(d)
        except ValueError:
            continue
        if os.path.isdir(os.path.join(case_dir, d)):
            times.append(d)
    return [t for t in times if only is None or t == only]


def _read_time(case, t):
    """Every field of time directory t that reads back, by name."""
    state = {}
    for fname in sorted(os.listdir(os.path.join(case.dir, t))):
        base = fname[:-3] if fname.endswith(".gz") else fname
        try:
            state[base] = case.read_field(base, time=t)
        except Exception:
            continue
    return state


def post_process(argv) -> int:
    """postProcess / execFlowFunctionObjects: the controlDict functions{}
    objects run over the SAVED time directories (the 2.2-era
    execFlowFunctionObjects utility, later `postProcess`), on the
    fields read onto the case's device."""
    args = _case_arg(argv)
    from ..core.case import Case
    from ..functionobjects import make_function_objects

    case = Case(args.case, device=_device(args))
    fol = make_function_objects(case)
    if not fol.objects:
        print("postProcess: no functions{} in controlDict")
        return 0
    n = 0
    for t in _saved_times(args.case, args.time):
        state = _read_time(case, t)
        if not state:
            continue
        fol.execute(t, state)
        n += 1
        print(f"Time = {t}: processed {sorted(state)}")
    print(f"postProcess: {n} times")
    return 0


def sample_cmd(argv) -> int:
    """sample: system/sampleDict's sets and surfaces over the saved times
    (postProcessing/sampling/sample), through the sets and
    sampledSurfaces function objects."""
    args = _case_arg(argv)
    from ..core.case import Case
    from ..core.dictionary import FoamDict, parse_file
    from ..functionobjects.sampling import SampledSets
    from ..functionobjects.surfaces import SampledSurfaces

    case = Case(args.case, device=_device(args))
    sd = parse_file(os.path.join(args.case, "system", "sampleDict"))

    def _entries(seq):
        # `sets ( name { ... } ... )` parses as alternating word/dict
        if seq is None or hasattr(seq, "items"):
            return seq
        out = FoamDict()
        lst = list(seq)
        i = 0
        while i < len(lst):
            if (i + 1 < len(lst) and hasattr(lst[i + 1], "get")
                    and not hasattr(lst[i], "get")):
                out[str(lst[i])] = lst[i + 1]
                i += 2
            else:
                out[f"set{i}"] = lst[i]
                i += 1
        return out

    fos = []
    if sd.get("sets") is not None:
        spec = FoamDict()
        spec["fields"] = sd.get("fields", ["U", "p"])
        spec["sets"] = _entries(sd["sets"])
        fos.append(SampledSets("sample", spec, case))
    if sd.get("surfaces") is not None:
        spec = FoamDict()
        spec["fields"] = sd.get("fields", ["U", "p"])
        spec["surfaces"] = _entries(sd["surfaces"])
        fos.append(SampledSurfaces("sampleSurfaces", spec, case))
    if not fos:
        print("sample: no sets/surfaces in sampleDict")
        return 1
    n = 0
    for t in _saved_times(args.case):
        state = _read_time(case, t)
        if not state:
            continue
        for fo in fos:
            fo.execute(t, state)
        n += 1
        print(f"Time = {t}: sampled {sorted(state)}")
    print(f"sample: {n} times")
    return 0


def create_patch_cmd(argv) -> int:
    """createPatch: re-group boundary faces into new patches from
    faceSets or patch lists (system/createPatchDict)."""
    args = _case_arg(argv)
    from . import meshutils

    out = meshutils.create_patch(args.case)
    print(f"createPatch: patches now "
          f"{[(p.name, p.size) for p in out.patches]}")
    return 0


def extrude_mesh_cmd(argv) -> int:
    """extrudeMesh: linearNormal extrusion of a patch
    (system/extrudeMeshDict)."""
    args = _case_arg(argv)
    from . import meshutils

    out = meshutils.extrude_mesh(args.case)
    print(f"extrudeMesh: {out.n_cells} cells, "
          f"{[p.name for p in out.patches]}")
    return 0


def refine_mesh_cmd(argv) -> int:
    """refineMesh [-set name]: one 2x2x2 (2x2 in 2D) refinement level of
    a cellSet (or system/refineMeshDict's `set`) or of the whole uniform
    box mesh."""
    ap = argparse.ArgumentParser()
    ap.add_argument("-case", default=".")
    ap.add_argument("-set", dest="set_name", default=None)
    args = ap.parse_args(argv)
    from . import meshutils

    out = meshutils.refine_mesh(args.case, args.set_name)
    print(f"refineMesh: {out.n_cells} cells")
    return 0


def change_dictionary_cmd(argv) -> int:
    """changeDictionary [-time t]: system/changeDictionaryDict's
    replacements merged into the time's fields (default 0) and the
    constant and system dictionaries."""
    args = _case_arg(argv)
    from . import meshutils

    changed = meshutils.change_dictionary(args.case,
                                          time=args.time or "0")
    print(f"changeDictionary: updated {changed}")
    return 0


def gmsh_to_foam_cmd(argv) -> int:
    """gmshToFoam <mshFile>: a Gmsh MSH 2.2 ASCII mesh written as
    constant/polyMesh."""
    ap = argparse.ArgumentParser()
    ap.add_argument("mshFile")
    ap.add_argument("-case", default=".")
    args = ap.parse_args(argv)
    from ..io import polymesh as mesh_io
    from ..mesh import gmsh

    pm = gmsh.convert(args.mshFile)
    out = os.path.join(args.case, "constant", "polyMesh")
    mesh_io.write(pm, out)
    print(f"gmshToFoam: {pm.n_cells} cells, {pm.n_faces} faces, "
          f"patches {[p.name for p in pm.patches]} -> {out}")
    return 0


def split_mesh_regions_cmd(argv) -> int:
    """splitMeshRegions: label the disconnected regions of the mesh and
    write one cellSet per region."""
    args = _case_arg(argv)
    from . import meshutils

    n = meshutils.split_mesh_regions(args.case)
    print(f"splitMeshRegions: {n} region(s)")
    return 0


def mirror_mesh_cmd(argv) -> int:
    """mirrorMesh: the mesh and its reflection about
    system/mirrorMeshDict's plane, the faces on the plane fused."""
    args = _case_arg(argv)
    import numpy as np

    from ..core.dictionary import parse_file
    from ..io import polymesh as mesh_io
    from . import meshutils2

    mdir = os.path.join(args.case, "constant", "polyMesh")
    pm = mesh_io.read(mdir)
    d = parse_file(os.path.join(args.case, "system", "mirrorMeshDict"))
    pd = d.get("pointAndNormalDict", d)
    point = [float(x) for x in np.asarray(
        pd.get("basePoint", pd.get("point", [0, 0, 0])),
        float).reshape(-1)[-3:]]
    normal = [float(x) for x in np.asarray(
        pd.get("normalVector", pd.get("normal", [1, 0, 0])),
        float).reshape(-1)[-3:]]
    out = meshutils2.mirror_mesh(pm, point, normal)
    mesh_io.write(out, mdir)
    print(f"mirrorMesh: {out.n_cells} cells")
    return 0


def subset_mesh_cmd(argv) -> int:
    """subsetMesh <cellSet> [-patch name]: the cellSet's cells as the new
    mesh, the exposed faces on `oldInternalFaces`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("set_name")
    ap.add_argument("-case", default=".")
    ap.add_argument("-patch", default="oldInternalFaces")
    args = ap.parse_args(argv)
    from ..io import polymesh as mesh_io
    from . import meshutils, meshutils2

    mdir = os.path.join(args.case, "constant", "polyMesh")
    pm = mesh_io.read(mdir)
    ids = meshutils.read_set(args.case, args.set_name)
    out = meshutils2.subset_mesh(pm, ids, exposed_name=args.patch)
    mesh_io.write(out, mdir)
    print(f"subsetMesh: {out.n_cells} cells from set {args.set_name}")
    return 0


def merge_meshes_cmd(argv) -> int:
    """mergeMeshes <masterCase> <addCase>: the added case's mesh
    concatenated into the master's, unstitched."""
    ap = argparse.ArgumentParser()
    ap.add_argument("master")
    ap.add_argument("add")
    args = ap.parse_args(argv)
    from ..io import polymesh as mesh_io
    from . import meshutils2

    m1 = mesh_io.read(os.path.join(args.master, "constant", "polyMesh"))
    m2 = mesh_io.read(os.path.join(args.add, "constant", "polyMesh"))
    out = meshutils2.merge_meshes(m1, m2)
    mesh_io.write(out, os.path.join(args.master, "constant", "polyMesh"))
    print(f"mergeMeshes: {out.n_cells} cells")
    return 0


def flatten_mesh_cmd(argv) -> int:
    """flattenMesh: the empty direction's coordinates of a 2D mesh
    snapped onto its two planes."""
    args = _case_arg(argv)
    from ..io import polymesh as mesh_io
    from . import meshutils2

    mdir = os.path.join(args.case, "constant", "polyMesh")
    out = meshutils2.flatten_mesh(mesh_io.read(mdir))
    mesh_io.write(out, mdir)
    print("flattenMesh: done")
    return 0


def auto_patch_cmd(argv) -> int:
    """autoPatch <featureAngle>: the boundary split into patches of
    connected faces bounded by the feature angle."""
    ap = argparse.ArgumentParser()
    ap.add_argument("angle", type=float)
    ap.add_argument("-case", default=".")
    args = ap.parse_args(argv)
    from ..io import polymesh as mesh_io
    from . import meshutils2

    mdir = os.path.join(args.case, "constant", "polyMesh")
    out = meshutils2.auto_patch(mesh_io.read(mdir), args.angle)
    mesh_io.write(out, mdir)
    print(f"autoPatch: {len(out.patches)} patches")
    return 0


def _flame_t(argv, by_mole) -> int:
    """adiabaticFlameT / mixtureAdiabaticFlameT <controlFile>: the
    control file's reactants and products (mole or mass fractions), T0
    and the path of the species thermo dictionary."""
    ap = argparse.ArgumentParser()
    ap.add_argument("control")
    ap.add_argument("-case", default=".")
    args = ap.parse_args(argv)
    from ..core.dictionary import parse_file
    from . import thermoutils

    d = parse_file(args.control if os.path.exists(args.control)
                   else os.path.join(args.case, args.control))
    tpath = str(d.get("thermo", "constant/thermo.compressibleGas"))
    if not os.path.isabs(tpath):
        tpath = os.path.join(args.case, tpath)
    thermo = parse_file(tpath)
    reac = {str(k): float(v) for k, v in d["reactants"].items()}
    prod = {str(k): float(v) for k, v in d["products"].items()}
    T = thermoutils.adiabatic_flame_T(
        thermo, reac, prod, float(d.get("T0", 300.0)), by_mole=by_mole)
    print(f"Adiabatic flame temperature = {T:.2f} K")
    return 0


def adiabatic_flame_t_cmd(argv) -> int:
    """adiabaticFlameT <controlFile>: mole-fraction compositions."""
    return _flame_t(argv, by_mole=True)


def mixture_adiabatic_flame_t_cmd(argv) -> int:
    """mixtureAdiabaticFlameT <controlFile>: mass-fraction
    compositions."""
    return _flame_t(argv, by_mole=False)


def chemkin_to_foam_cmd(argv) -> int:
    """chemkinToFoam <CHEMKINFile> <thermoFile> <reactionsOut>
    <thermoOut>."""
    ap = argparse.ArgumentParser()
    ap.add_argument("chem")
    ap.add_argument("thermo")
    ap.add_argument("reactions_out")
    ap.add_argument("thermo_out")
    args = ap.parse_args(argv)
    from . import thermoutils

    n = thermoutils.chemkin_to_foam(args.chem, args.thermo,
                                    args.reactions_out, args.thermo_out)
    print(f"chemkinToFoam: {n} reactions")
    return 0


def foam_to_ensight(argv) -> int:
    """foamToEnsight: EnSight Gold ASCII of the mesh (cells as `nfaced`
    polyhedra) and of every saved time's fields, each read onto the
    case's device and fetched once, under <case>/EnSight/."""
    args = _case_arg(argv)
    from ..core.case import Case

    case = Case(args.case, device=_device(args))
    pm = case.poly_mesh
    out = os.path.join(args.case, "EnSight")
    os.makedirs(out, exist_ok=True)

    cell_faces = [[] for _ in range(pm.n_cells)]
    nif = pm.n_internal_faces
    for f in range(pm.n_faces):
        cell_faces[pm.owner[f]].append((f, False))
        if f < nif:
            cell_faces[pm.neighbour[f]].append((f, True))
    with open(os.path.join(out, "geometry"), "w") as g:
        g.write("EnSight Geometry File\nwritten by foamtpu\n"
                "node id assign\nelement id assign\n"
                "part\n1\ninternalMesh\ncoordinates\n")
        g.write(f"{pm.n_points:10d}\n")
        for ax in range(3):
            g.write("\n".join(f"{x:12.5e}" for x in pm.points[:, ax])
                    + "\n")
        g.write(f"nfaced\n{pm.n_cells:10d}\n")
        for cf in cell_faces:
            g.write(f"{len(cf):10d}\n")
        for cf in cell_faces:
            for f, flip in cf:
                g.write(f"{int(pm.face_npts[f]):10d}\n")
        for cf in cell_faces:
            for f, flip in cf:
                pts = list(pm.face_pts[f, :pm.face_npts[f]])
                if flip:
                    pts = pts[::-1]
                g.write(" ".join(str(p + 1) for p in pts) + "\n")

    times = sorted(_saved_times(args.case), key=float)
    var_names = {}
    for ti, t in enumerate(times):
        for base, f in _read_time(case, t).items():
            data = f.data.detach().cpu().numpy()
            kind = "vector" if data.ndim == 2 else "scalar"
            var_names[base] = kind
            with open(os.path.join(out, f"{base}.{ti:04d}"), "w") as vf:
                vf.write(f"{base}\npart\n1\nnfaced\n")
                if data.ndim == 1:
                    vf.write("\n".join(f"{x:12.5e}" for x in data) + "\n")
                else:
                    for ax in range(3):
                        vf.write("\n".join(f"{x:12.5e}"
                                           for x in data[:, ax]) + "\n")
    with open(os.path.join(out, "case.case"), "w") as cf:
        cf.write("FORMAT\ntype: ensight gold\n\nGEOMETRY\n"
                 "model: geometry\n\nVARIABLE\n")
        for name, kind in var_names.items():
            cf.write(f"{kind} per element: {name} {name}.****\n")
        cf.write(f"\nTIME\ntime set: 1\nnumber of steps: "
                 f"{len(times)}\nfilename start number: 0\n"
                 f"filename increment: 1\ntime values:\n")
        cf.write("\n".join(t for t in times) + "\n")
    print(f"foamToEnsight: {len(times)} times, "
          f"{len(var_names)} fields -> {out}")
    return 0


def surface_check(argv) -> int:
    """surfaceCheck <surface.stl>: triangle count, bounding box, area,
    degenerate triangles and open edges."""
    import numpy as np

    ap = argparse.ArgumentParser()
    ap.add_argument("surf")
    args = ap.parse_args(argv)
    from ..mesh.snappy import read_stl

    tris = read_stl(args.surf)
    n = tris.shape[0]
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    degenerate = int((areas < 1e-30).sum())
    # closed: every edge shared by exactly two triangles
    pts = tris.reshape(-1, 3)
    _, inv = np.unique(np.round(pts, 10), axis=0, return_inverse=True)
    tri_pts = inv.reshape(-1, 3)
    edges = {}
    for t in tri_pts:
        for i in range(3):
            e = tuple(sorted((int(t[i]), int(t[(i + 1) % 3]))))
            edges[e] = edges.get(e, 0) + 1
    open_edges = sum(1 for v in edges.values() if v != 2)
    bb = (tris.reshape(-1, 3).min(axis=0), tris.reshape(-1, 3).max(axis=0))
    print(f"Triangles      : {n}")
    print(f"Bounding box   : ({bb[0][0]:g} {bb[0][1]:g} {bb[0][2]:g}) "
          f"({bb[1][0]:g} {bb[1][1]:g} {bb[1][2]:g})")
    print(f"Total area     : {areas.sum():g}")
    print(f"Degenerate tris: {degenerate}")
    print(f"Open edges     : {open_edges} "
          f"({'closed' if open_edges == 0 else 'OPEN'} surface)")
    return 0


def _write_polydata(path, upts, tri, header):
    """Triangles on unique points as a legacy-VTK POLYDATA file."""
    with open(path, "w") as f:
        f.write(f"# vtk DataFile Version 2.0\n{header}\nASCII\n"
                "DATASET POLYDATA\n")
        f.write(f"POINTS {len(upts)} float\n")
        for p in upts:
            f.write(f"{p[0]:g} {p[1]:g} {p[2]:g}\n")
        f.write(f"POLYGONS {len(tri)} {4 * len(tri)}\n")
        for a3 in tri:
            f.write(f"3 {a3[0]} {a3[1]} {a3[2]}\n")


def surface_convert(argv) -> int:
    """surfaceConvert / objToVTK <in> <out>: STL or OBJ in; OBJ, STL or
    legacy VTK out."""
    import numpy as np

    ap = argparse.ArgumentParser()
    ap.add_argument("infile")
    ap.add_argument("outfile")
    args = ap.parse_args(argv)
    from ..mesh.snappy import read_stl, write_stl

    ext_in = os.path.splitext(args.infile)[1].lower()
    if ext_in in (".stl", ".stlb"):
        tris = read_stl(args.infile)
    elif ext_in == ".obj":
        vs, fs = [], []
        for ln in open(args.infile):
            t = ln.split()
            if not t:
                continue
            if t[0] == "v":
                vs.append([float(x) for x in t[1:4]])
            elif t[0] == "f":
                fs.append([int(x.split("/")[0]) - 1 for x in t[1:4]])
        tris = np.asarray(vs)[np.asarray(fs)]
    else:
        print(f"surfaceConvert: unsupported input {ext_in}")
        return 1
    ext = os.path.splitext(args.outfile)[1].lower()
    if ext in (".stl", ".stlb"):
        write_stl(args.outfile, tris)
    elif ext in (".obj", ".vtk"):
        upts, inv = np.unique(np.round(tris.reshape(-1, 3), 10), axis=0,
                              return_inverse=True)
        tri = inv.reshape(-1, 3)
        if ext == ".vtk":
            _write_polydata(args.outfile, upts, tri, "surface")
        else:
            with open(args.outfile, "w") as f:
                f.write("# written by foamtpu surfaceConvert\n")
                for p in upts:
                    f.write(f"v {p[0]:g} {p[1]:g} {p[2]:g}\n")
                for t in tri:
                    f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")
    else:
        print(f"surfaceConvert: unsupported output {ext}")
        return 1
    print(f"surfaceConvert: {tris.shape[0]} triangles -> {args.outfile}")
    return 0


def surface_transform_points(argv) -> int:
    """surfaceTransformPoints <in> <out> -scale/-rollPitchYaw (degrees)
    /-translate, applied in that order."""
    import numpy as np

    ap = argparse.ArgumentParser()
    ap.add_argument("infile")
    ap.add_argument("outfile")
    ap.add_argument("-translate", default=None)
    ap.add_argument("-scale", default=None)
    ap.add_argument("-rollPitchYaw", default=None)
    args = ap.parse_args(argv)
    from ..mesh.snappy import read_stl, write_stl

    tris = read_stl(args.infile)

    def vec(s):
        return np.asarray([float(x) for x in s.strip("() ").split()], float)

    if args.scale:
        tris = tris * vec(args.scale)[None, None, :]
    if args.rollPitchYaw:
        r, p, y = np.deg2rad(vec(args.rollPitchYaw))
        cx, sx = np.cos(r), np.sin(r)
        cy, sy = np.cos(p), np.sin(p)
        cz, sz = np.cos(y), np.sin(y)
        Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        tris = tris @ (Rz @ Ry @ Rx).T
    if args.translate:
        tris = tris + vec(args.translate)[None, None, :]
    write_stl(args.outfile, tris)
    print(f"surfaceTransformPoints: {tris.shape[0]} triangles")
    return 0


def surface_subset(argv) -> int:
    """surfaceSubset <in> <out> -box 'x0 y0 z0 x1 y1 z1': the triangles
    whose centroid lies in the box."""
    import numpy as np

    ap = argparse.ArgumentParser()
    ap.add_argument("infile")
    ap.add_argument("outfile")
    ap.add_argument("-box", required=True)
    args = ap.parse_args(argv)
    from ..mesh.snappy import read_stl, write_stl

    vals = [float(x) for x in
            args.box.replace("(", " ").replace(")", " ").split()]
    lo, hi = np.asarray(vals[:3]), np.asarray(vals[3:6])
    tris = read_stl(args.infile)
    c = tris.mean(axis=1)
    keep = np.all((c >= lo) & (c <= hi), axis=1)
    write_stl(args.outfile, tris[keep])
    print(f"surfaceSubset: kept {int(keep.sum())}/{len(tris)} "
          f"triangles -> {args.outfile}")
    return 0


# the pipeline steps of `tutorials` that read fields: they take its -device
_TUTORIAL_DEVICE_STEPS = ("run", "setFields", "boxTurb")


def tutorials_cmd(argv) -> int:
    """tutorials [-test] [-filter substr] [-steps N] [-root dir]
    [-device cpu]: the Alltest harness. Each case under the root (a
    directory whose system/ holds a controlDict) is copied to a scratch
    directory and driven through its Allrun's runApplication lines, or
    else blockMesh, then topoSet, snappyHexMesh and setFields where
    their dictionaries exist, then run; -test stops every run after
    -steps steps (default 3). The runs, setFields and boxTurb go to the
    card unless -device cpu is given."""
    import shutil
    import tempfile
    import time as _time
    import traceback

    ap = argparse.ArgumentParser()
    ap.add_argument("-test", action="store_true")
    ap.add_argument("-filter", default="")
    ap.add_argument("-steps", type=int, default=3)
    ap.add_argument("-root", default="tutorials")
    ap.add_argument("-device", default=None)
    args = ap.parse_args(argv)
    device = _device(args)

    cases = []
    for root, dirs, files in os.walk(args.root):
        if os.path.basename(root) == "system" and "controlDict" in files:
            cases.append(os.path.dirname(root))
    cases.sort()
    if args.filter:
        cases = [c for c in cases if args.filter in c]
    if not cases:
        print("tutorials: no cases found")
        return 1

    results = []
    for src in cases:
        name = os.path.relpath(src, args.root)
        t0 = _time.time()
        tmp = tempfile.mkdtemp(prefix="foamtpu-tut-")
        case = os.path.join(tmp, os.path.basename(src))
        shutil.copytree(src, case)
        ok, msg = True, ""
        try:
            allrun = os.path.join(case, "Allrun")
            steps = ["blockMesh"]
            if os.path.exists(allrun):
                steps = []
                for ln in open(allrun):
                    ln = ln.strip()
                    if ln.startswith(("runApplication", "runParallel")):
                        steps.append(" ".join(ln.split()[1:]))
            else:
                sysd = os.path.join(case, "system")
                for dname, step in (("topoSetDict", "topoSet"),
                                    ("snappyHexMeshDict", "snappyHexMesh"),
                                    ("setFieldsDict", "setFields")):
                    if os.path.exists(os.path.join(sysd, dname)):
                        steps.append(step)
                steps.append("run")
            for st in steps:
                cmd0, *rest = st.split()
                if cmd0 not in COMMANDS:
                    # a solver name: route through run
                    cmd0, rest = "run", []
                args2 = rest + ["-case", case]
                if args.test and cmd0 == "run":
                    args2 += ["-steps", str(args.steps)]
                if cmd0 in _TUTORIAL_DEVICE_STEPS:
                    args2 += ["-device", device]
                rc = COMMANDS[cmd0](args2)
                if rc != 0:
                    ok, msg = False, f"{cmd0} rc={rc}"
                    break
        except Exception as e:      # noqa: BLE001 - the harness reports it
            ok = False
            msg = f"{type(e).__name__}: {e}"
            if os.environ.get("FOAMTPU_DEBUG"):
                traceback.print_exc()
        dt = _time.time() - t0
        results.append((name, ok, dt, msg))
        print(f"{'PASS' if ok else 'FAIL'}  {name}  ({dt:.1f}s)"
              + (f"  {msg}" if msg else ""))
        shutil.rmtree(tmp, ignore_errors=True)
    n_fail = sum(1 for _, ok, _, _ in results if not ok)
    print(f"\ntutorials: {len(results) - n_fail}/{len(results)} passed")
    return 1 if n_fail else 0


def fluent_mesh_to_foam(argv) -> int:
    """fluentMeshToFoam <mesh.msh>: an ASCII Fluent mesh written as
    constant/polyMesh."""
    ap = argparse.ArgumentParser()
    ap.add_argument("mshfile")
    ap.add_argument("-case", default=".")
    args = ap.parse_args(argv)
    from ..io import polymesh as mesh_io
    from .fluent import read_fluent

    pm = read_fluent(args.mshfile)
    mdir = os.path.join(args.case, "constant", "polyMesh")
    os.makedirs(mdir, exist_ok=True)
    mesh_io.write(pm, mdir)
    print(f"fluentMeshToFoam: {pm.n_cells} cells, {pm.n_faces} faces, "
          f"{len(pm.patches)} patches")
    return 0


def sets_to_zones_cmd(argv) -> int:
    """setsToZones: every saved cellSet becomes a cellZone."""
    args = _case_arg(argv)
    from . import meshutils3

    names = meshutils3.sets_to_zones(args.case)
    print(f"setsToZones: promoted {names}")
    return 0


def foam_format_convert_cmd(argv) -> int:
    """foamFormatConvert [-format ascii|binary] [-time t]: a time
    directory's fields read onto the case's device and written again in
    the format."""
    ap = argparse.ArgumentParser()
    ap.add_argument("-case", default=".")
    ap.add_argument("-format", dest="fmt", default="binary",
                    choices=["ascii", "binary"])
    ap.add_argument("-time", default=None)
    ap.add_argument("-device", default=None)
    args = ap.parse_args(argv)
    from . import meshutils3

    done = meshutils3.foam_format_convert(args.case, args.fmt, args.time,
                                          device=_device(args))
    print(f"foamFormatConvert: rewrote {done} as {args.fmt}")
    return 0


def deformed_geom_cmd(argv) -> int:
    """deformedGeom <scale> [-time t]: the points displaced by scale
    times U interpolated to them."""
    ap = argparse.ArgumentParser()
    ap.add_argument("scale", type=float)
    ap.add_argument("-case", default=".")
    ap.add_argument("-time", default=None)
    ap.add_argument("-device", default=None)
    args = ap.parse_args(argv)
    from . import meshutils3

    meshutils3.deformed_geom(args.case, args.scale, args.time,
                             device=_device(args))
    print(f"deformedGeom: points displaced by {args.scale} * U")
    return 0


def post_channel_cmd(argv) -> int:
    """postChannel [-time t] [-normal axis]: U's mean and rms profiles
    across the homogeneous planes, in postProcessing/channel/<t>/Uf.xy."""
    ap = argparse.ArgumentParser()
    ap.add_argument("-case", default=".")
    ap.add_argument("-time", default=None)
    ap.add_argument("-normal", type=int, default=1)
    ap.add_argument("-device", default=None)
    args = ap.parse_args(argv)
    from . import meshutils3

    path = meshutils3.post_channel(args.case, args.time, args.normal,
                                   device=_device(args))
    print(f"postChannel: wrote {path}")
    return 0


def netgen_to_foam_cmd(argv) -> int:
    """netgenNeutralToFoam <file>: a Netgen neutral tet mesh written as
    constant/polyMesh."""
    ap = argparse.ArgumentParser()
    ap.add_argument("neuFile")
    ap.add_argument("-case", default=".")
    args = ap.parse_args(argv)
    from ..io import polymesh as mesh_io
    from ..mesh import gmsh

    pm = gmsh.convert_netgen(args.neuFile)
    out = os.path.join(args.case, "constant", "polyMesh")
    mesh_io.write(pm, out)
    print(f"netgenNeutralToFoam: {pm.n_cells} cells, {pm.n_faces} "
          f"faces, patches {[p.name for p in pm.patches]}")
    return 0


def write_mesh_obj_cmd(argv) -> int:
    """writeMeshObj: the points and boundary faces as a Wavefront OBJ,
    <case>/meshBoundary.obj."""
    args = _case_arg(argv)
    from ..io import polymesh as mesh_io

    pm = mesh_io.read(os.path.join(args.case, "constant", "polyMesh"))
    out = os.path.join(args.case, "meshBoundary.obj")
    with open(out, "w") as f:
        f.write("# foamtpu writeMeshObj\n")
        for p in pm.points:
            f.write(f"v {p[0]:.8g} {p[1]:.8g} {p[2]:.8g}\n")
        for fi in range(pm.n_internal_faces, pm.n_faces):
            k = pm.face_npts[fi]
            idx = " ".join(str(int(x) + 1) for x in pm.face_pts[fi, :k])
            f.write(f"f {idx}\n")
    print(f"writeMeshObj: wrote {pm.n_faces - pm.n_internal_faces} "
          f"boundary faces -> {out}")
    return 0


# the DebugSwitches the reference's foamDebugSwitches lists
DEBUG_SWITCHES = ("GAMG", "blockMesh", "fvSchemes", "lduMatrix", "polyMesh",
                  "time")


def foam_debug_switches_cmd(argv) -> int:
    """foamDebugSwitches: the DebugSwitches and whether each is on
    (controlDict DebugSwitches {} or FOAMTPU_DEBUG=<name,...>)."""
    from ..utils import logging as log_mod

    print("DebugSwitches honoured (set via controlDict DebugSwitches"
          " {} or FOAMTPU_DEBUG=<name,...>):")
    for k in DEBUG_SWITCHES:
        print(f"    {k:16s} {'ON' if log_mod.debug(k) else 'off'}")
    return 0


def particle_tracks_cmd(argv) -> int:
    """particleTracks [-cloud name]: each parcel's positions over the
    saved times (<time>/lagrangian/<cloud>/{positions,origId}) joined
    into polylines, postProcessing/particleTracks/tracks.vtk."""
    import re

    ap = argparse.ArgumentParser()
    ap.add_argument("-case", default=".")
    ap.add_argument("-cloud", default="kinematicCloud")
    args = ap.parse_args(argv)
    times = []
    for dname in os.listdir(args.case):
        try:
            tval = float(dname)
        except ValueError:
            continue
        if os.path.isdir(os.path.join(args.case, dname)):
            times.append((tval, dname))
    tracks = {}
    for _, t in sorted(times):
        d = os.path.join(args.case, t, "lagrangian", args.cloud)
        ppath = os.path.join(d, "positions")
        if not os.path.exists(ppath):
            continue
        pts = [[float(x) for x in m.groups()] for m in re.finditer(
            r"\(([-\d.eE+]+)\s+([-\d.eE+]+)\s+([-\d.eE+]+)\)",
            open(ppath).read())]
        idpath = os.path.join(d, "origId")
        if os.path.exists(idpath):
            ids = [int(x) for x in re.findall(
                r"^\s*(\d+)\s*$", open(idpath).read(), re.M)]
            if len(ids) == len(pts) + 1:   # the first match is the count
                ids = ids[1:]
        else:
            ids = list(range(len(pts)))
        for i, p in zip(ids, pts):
            tracks.setdefault(i, []).append(p)
    tracks = {i: p for i, p in tracks.items() if len(p) >= 2}
    if not tracks:
        print("particleTracks: no parcel positions found", file=sys.stderr)
        return 1
    out_dir = os.path.join(args.case, "postProcessing", "particleTracks")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "tracks.vtk")
    pts_all, lines = [], []
    for i in sorted(tracks):
        start = len(pts_all)
        pts_all.extend(tracks[i])
        lines.append(list(range(start, len(pts_all))))
    with open(out, "w") as f:
        f.write("# vtk DataFile Version 2.0\nparticleTracks\nASCII\n"
                "DATASET POLYDATA\n")
        f.write(f"POINTS {len(pts_all)} float\n")
        for p in pts_all:
            f.write(f"{p[0]:g} {p[1]:g} {p[2]:g}\n")
        f.write(f"LINES {len(lines)} {sum(len(ln) + 1 for ln in lines)}\n")
        for ln in lines:
            f.write(str(len(ln)) + " " + " ".join(map(str, ln)) + "\n")
    print(f"particleTracks: {len(lines)} tracks, {len(pts_all)} "
          f"points -> {out}")
    return 0


def set_set_cmd(argv) -> int:
    """setSet -batch <file>: scripted cell and face sets, a command a
    line:
      cellSet <name> new|add|delete|subtract boxToCell (x0 y0 z0) (x1 y1 z1)
      faceSet <name> new boxToFace (..) (..)
      cellSet <name> invert
    (sphereToCell takes (cx cy cz) r)."""
    import re

    import numpy as np

    ap = argparse.ArgumentParser()
    ap.add_argument("-case", default=".")
    ap.add_argument("-batch", required=True)
    args = ap.parse_args(argv)
    from ..core.dictionary import FoamDict
    from ..io import polymesh as mesh_io
    from . import meshutils

    pm = mesh_io.read(os.path.join(args.case, "constant", "polyMesh"))
    current = {}
    count = 0
    for ln in open(args.batch):
        ln = ln.split("//")[0].strip()
        if not ln or ln in ("quit", "q"):
            continue
        toks = ln.split()
        if len(toks) < 3:
            continue
        kind, name, action = toks[0], toks[1], toks[2]
        prev = current.get(name, np.zeros(0, np.int64))
        if action == "invert":
            n = pm.n_cells if kind == "cellSet" else pm.n_faces
            current[name] = np.setdiff1d(np.arange(n), prev)
        else:
            source = toks[3] if len(toks) > 3 else ""
            nums = [float(x) for x in re.findall(r"[-+0-9.eE]+",
                                                 " ".join(toks[4:]))]
            info = FoamDict()
            if "box" in source.lower():
                info["box"] = np.asarray(nums[:6]).reshape(2, 3)
            elif "sphere" in source.lower():
                info["centre"] = np.asarray(nums[:3])
                info["radius"] = nums[3]
            ids = (meshutils._source_cells(pm, source, info)
                   if kind == "cellSet"
                   else meshutils._source_faces(pm, source, info))
            if action == "new":
                current[name] = ids
            elif action == "add":
                current[name] = np.union1d(prev, ids)
            elif action in ("delete", "subtract"):
                current[name] = np.setdiff1d(prev, ids)
        meshutils.write_set(args.case, name, kind, current[name])
        count += 1
        print(f"setSet: {kind} {name} -> {current[name].size} entries")
    print(f"setSet: executed {count} commands")
    return 0


def stitch_mesh_cmd(argv) -> int:
    """stitchMesh <master> <slave> [-tol t]: two coincident boundary
    patches merged into internal faces (perfect match)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("master")
    ap.add_argument("slave")
    ap.add_argument("-case", default=".")
    ap.add_argument("-tol", type=float, default=1e-7)
    args = ap.parse_args(argv)
    from ..io import polymesh as mesh_io
    from . import meshutils3

    mdir = os.path.join(args.case, "constant", "polyMesh")
    pm = mesh_io.read(mdir)
    out = meshutils3.stitch_mesh(pm, args.master, args.slave, args.tol)
    mesh_io.write(out, mdir)
    print(f"stitchMesh: merged {args.master}/{args.slave}; "
          f"{out.n_internal_faces} internal faces, patches "
          f"{[p.name for p in out.patches]}")
    return 0


def temporal_interpolate_cmd(argv) -> int:
    """temporalInterpolate -time t -fields '(U p)': the fields blended
    linearly on the case's device between the saved times around t and
    written at t."""
    ap = argparse.ArgumentParser()
    ap.add_argument("-case", default=".")
    ap.add_argument("-time", type=float, required=True)
    ap.add_argument("-fields", default="U p")
    ap.add_argument("-device", default=None)
    args = ap.parse_args(argv)
    from . import meshutils3

    names = args.fields.replace("(", " ").replace(")", " ").split()
    done = meshutils3.temporal_interpolate(args.case, args.time, names,
                                           device=_device(args))
    print(f"temporalInterpolate: wrote {done} at t={args.time:g}")
    return 0


COMMANDS = {"run": run, "blockMesh": block_mesh,
            "snappyHexMesh": snappy_hex_mesh, "setFields": set_fields,
            "topoSet": topo_set_cmd, "createBaffles": create_baffles_cmd,
            "boxTurb": box_turb, "checkMesh": check_mesh,
            "foamToVTK": foam_to_vtk, "renumberMesh": renumber_mesh,
            "foamListTimes": foam_list_times,
            "transformPoints": transform_points, "mapFields": map_fields,
            "patchAverage": patch_average, "foamCalc": foam_calc,
            "writeCellCentres": write_cell_centres,
            "writeCellVolumes": write_cell_volumes,
            "postProcess": post_process,
            "execFlowFunctionObjects": post_process, "sample": sample_cmd,
            "createPatch": create_patch_cmd,
            "extrudeMesh": extrude_mesh_cmd, "refineMesh": refine_mesh_cmd,
            "changeDictionary": change_dictionary_cmd,
            "gmshToFoam": gmsh_to_foam_cmd,
            "splitMeshRegions": split_mesh_regions_cmd,
            "mirrorMesh": mirror_mesh_cmd, "subsetMesh": subset_mesh_cmd,
            "mergeMeshes": merge_meshes_cmd,
            "flattenMesh": flatten_mesh_cmd, "autoPatch": auto_patch_cmd,
            "adiabaticFlameT": adiabatic_flame_t_cmd,
            "mixtureAdiabaticFlameT": mixture_adiabatic_flame_t_cmd,
            "chemkinToFoam": chemkin_to_foam_cmd,
            "foamToEnsight": foam_to_ensight, "surfaceCheck": surface_check,
            "surfaceConvert": surface_convert, "objToVTK": surface_convert,
            "surfaceTransformPoints": surface_transform_points,
            "surfaceSubset": surface_subset, "tutorials": tutorials_cmd,
            "fluentMeshToFoam": fluent_mesh_to_foam,
            "setsToZones": sets_to_zones_cmd,
            "foamFormatConvert": foam_format_convert_cmd,
            "deformedGeom": deformed_geom_cmd,
            "postChannel": post_channel_cmd,
            "netgenNeutralToFoam": netgen_to_foam_cmd,
            "writeMeshObj": write_mesh_obj_cmd,
            "foamDebugSwitches": foam_debug_switches_cmd,
            "particleTracks": particle_tracks_cmd, "setSet": set_set_cmd,
            "stitchMesh": stitch_mesh_cmd,
            "temporalInterpolate": temporal_interpolate_cmd}

from . import postutils as _postutils  # noqa: E402

COMMANDS.update(_postutils.COMMANDS)

# the reference's commands not ported yet (its COMMANDS, with the
# updates from postutils, meshutils4, meshutils5 and preputils)
REFERENCE_ONLY = (
    "ansysToFoam", "applyWallFunctionBoundaryConditions", "attachMesh",
    "autoRefineMesh", "createTurbulenceFields", "datToFoam", "decomposePar",
    "dsmcInitialise", "engineSwirl", "equilibriumCO", "equilibriumFlameT",
    "expandDictionary", "faceAgglomerate", "foamInfoExec", "foamMeshToFluent",
    "foamToGMV", "foamToStarMesh", "foamToSurface", "foamToTecplot360",
    "foamUpgradeFvSolution", "gambitToFoam", "ideasUnvToFoam", "insideCells",
    "mdInitialise", "moveMesh", "mshToFoam", "patchSummary", "plot3dToFoam",
    "refineHexMesh", "removeFaces", "rotateMesh", "sammToFoam", "selectCells",
    "singleCellMesh", "splitMesh", "star4ToFoam", "starToFoam",
    "steadyParticleTracks", "surfaceAdd", "surfaceClean", "surfaceInertia",
    "surfaceMeshTriangulate", "surfaceOrient", "surfacePointMerge",
    "surfaceSplitByPatch", "tetgenToFoam", "viewFactorsGen",
    "vtkUnstructuredToFoam", "wallFunctionTable", "zipUpMesh")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(f"usage: cli <{'|'.join(COMMANDS)}> -case <dir>",
              file=sys.stderr)
        return 2
    cmd = COMMANDS.get(argv[0])
    if cmd is None:
        what = ("is a reference command not ported to foamtpu_torch yet"
                if argv[0] in REFERENCE_ONLY else
                "is not a command of foamtpu_torch")
        raise NotImplementedError(f"command {argv[0]!r} {what}")
    return cmd(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
