"""Command-line utilities (port of openfoam-2.2.x_tpu/apps/cli.py: `run`,
`blockMesh`, `snappyHexMesh`, `setFields`, `topoSet`, `createBaffles` and
`boxTurb`).

    python -m foamtpu_torch run -case <dir> [-steps N] [-device cpu]
    python -m foamtpu_torch.apps.cli blockMesh -case <dir>
    python -m foamtpu_torch.apps.cli snappyHexMesh -case <dir>
    python -m foamtpu_torch.apps.cli setFields -case <dir> [-device cpu]
    python -m foamtpu_torch.apps.cli topoSet -case <dir>
    python -m foamtpu_torch.apps.cli createBaffles -case <dir>
    python -m foamtpu_torch.apps.cli boxTurb -case <dir> [-device cpu]

Every other command of the reference CLI is outside the ported slice
and raises NotImplementedError naming it.
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
    ap.add_argument("-parallel", action="store_true")
    return ap.parse_args(argv)


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


COMMANDS = {"run": run, "blockMesh": block_mesh, "snappyHexMesh": snappy_hex_mesh,
            "setFields": set_fields,
            "topoSet": topo_set_cmd, "createBaffles": create_baffles_cmd,
            "boxTurb": box_turb}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(f"usage: cli <{'|'.join(COMMANDS)}> -case <dir>",
              file=sys.stderr)
        return 2
    cmd = COMMANDS.get(argv[0])
    if cmd is None:
        raise NotImplementedError(
            f"command {argv[0]!r} is not ported to foamtpu_torch yet")
    return cmd(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
