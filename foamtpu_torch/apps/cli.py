"""Command-line utilities (port of openfoam-2.2.x_tpu/apps/cli.py:
`blockMesh` and `setFields`).

    python -m foamtpu_torch.apps.cli blockMesh -case <dir>
    python -m foamtpu_torch.apps.cli setFields -case <dir> [-device cpu]

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
    return ap.parse_args(argv)


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


COMMANDS = {"blockMesh": block_mesh, "setFields": set_fields}


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
