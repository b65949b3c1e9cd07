"""Command-line utilities (port of openfoam-2.2.x_tpu/apps/cli.py: the
solver and case-setup commands run, blockMesh, snappyHexMesh, setFields,
topoSet, createBaffles and boxTurb; the solver-side utilities checkMesh,
renumberMesh, transformPoints, foamListTimes, mapFields, patchAverage,
foamCalc, writeCellCentres, writeCellVolumes, postProcess and
execFlowFunctionObjects, sample and foamToVTK; and the 22 commands of
apps/postutils.py, added through `COMMANDS.update` as in the reference).

    python -m foamtpu_torch <command> -case <dir> [-device cpu] ...

Commands that read fields put them on the card unless `-device cpu` is
given; checkMesh, renumberMesh, transformPoints and foamListTimes work
on the host's mesh and time directories alone. Every other command of
the reference (`REFERENCE_ONLY`) raises NotImplementedError naming it.
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
            "execFlowFunctionObjects": post_process, "sample": sample_cmd}

from . import postutils as _postutils  # noqa: E402

COMMANDS.update(_postutils.COMMANDS)

# the reference's commands not ported yet (its COMMANDS, with the
# updates from postutils, meshutils4, meshutils5 and preputils)
REFERENCE_ONLY = (
    "adiabaticFlameT", "ansysToFoam", "applyWallFunctionBoundaryConditions",
    "attachMesh", "autoPatch", "autoRefineMesh", "changeDictionary",
    "chemkinToFoam", "createPatch", "createTurbulenceFields", "datToFoam",
    "decomposePar", "deformedGeom", "dsmcInitialise", "engineSwirl",
    "equilibriumCO", "equilibriumFlameT", "expandDictionary", "extrudeMesh",
    "faceAgglomerate", "flattenMesh", "fluentMeshToFoam",
    "foamDebugSwitches", "foamFormatConvert", "foamInfoExec",
    "foamMeshToFluent", "foamToEnsight", "foamToGMV", "foamToStarMesh",
    "foamToSurface", "foamToTecplot360", "foamUpgradeFvSolution",
    "gambitToFoam", "gmshToFoam", "ideasUnvToFoam", "insideCells",
    "mdInitialise", "mergeMeshes", "mirrorMesh", "mixtureAdiabaticFlameT",
    "moveMesh", "mshToFoam", "netgenNeutralToFoam", "objToVTK",
    "particleTracks", "patchSummary", "plot3dToFoam", "postChannel",
    "refineHexMesh", "refineMesh", "removeFaces", "rotateMesh", "sammToFoam",
    "selectCells", "setSet", "setsToZones", "singleCellMesh", "splitMesh",
    "splitMeshRegions", "star4ToFoam", "starToFoam", "steadyParticleTracks",
    "stitchMesh", "subsetMesh", "surfaceAdd", "surfaceCheck", "surfaceClean",
    "surfaceConvert", "surfaceInertia", "surfaceMeshTriangulate",
    "surfaceOrient", "surfacePointMerge", "surfaceSplitByPatch",
    "surfaceSubset", "surfaceTransformPoints", "temporalInterpolate",
    "tetgenToFoam", "tutorials", "viewFactorsGen", "vtkUnstructuredToFoam",
    "wallFunctionTable", "writeMeshObj", "zipUpMesh")


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
