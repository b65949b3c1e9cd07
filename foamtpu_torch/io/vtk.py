"""foamToVTK: the mesh and the fields of one time as a legacy VTK
unstructured grid (host copy of openfoam-2.2.x_tpu/io/vtk.py;
applications/utilities/postProcessing/dataConversion/foamToVTK/). The
fields are read onto the case's device and fetched once each to be
written; the file is the reference's, byte for byte."""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..core.precision import DEFAULT_DEVICE


def _cell_point_ids(poly) -> List[np.ndarray]:
    """Unordered point sets per cell (VTK_POLYHEDRON-lite: we emit
    hexahedra when a cell has 8 points, else VTK_CONVEX_POINT_SET)."""
    n_cells = poly.n_cells
    sets = [set() for _ in range(n_cells)]
    nif = poly.n_internal_faces
    for f in range(poly.n_faces):
        pts = poly.face_pts[f, : poly.face_npts[f]]
        sets[poly.owner[f]].update(int(p) for p in pts)
        if f < nif:
            sets[poly.neighbour[f]].update(int(p) for p in pts)
    return [np.fromiter(s, dtype=np.int64) for s in sets]


def case_to_vtk(case_dir: str, time_name: Optional[str] = None,
                device=DEFAULT_DEVICE) -> str:
    from ..core import runtime
    from ..core.case import Case

    case = Case(case_dir, device=device)
    poly = case.poly_mesh
    mesh = case.mesh
    t = time_name or (runtime.time_name(case.time.latest_time() or 0.0))

    out_dir = os.path.join(case_dir, "VTK")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"{os.path.basename(case.dir)}_{t}.vtk")

    cells = _cell_point_ids(poly)
    with open(out, "w") as f:
        f.write("# vtk DataFile Version 2.0\nfoamtpu case export\nASCII\n")
        f.write("DATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {poly.n_points} float\n")
        for p in poly.points:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")
        total = sum(len(c) + 1 for c in cells)
        f.write(f"CELLS {len(cells)} {total}\n")
        for c in cells:
            f.write(str(len(c)) + " " + " ".join(map(str, c)) + "\n")
        f.write(f"CELL_TYPES {len(cells)}\n")
        for c in cells:
            f.write("11\n" if len(c) == 8 else "41\n")  # voxel-ish / convex
        # fields at the chosen time
        tdir = os.path.join(case_dir, t)
        names = []
        if os.path.isdir(tdir):
            names = [n for n in os.listdir(tdir)
                     if os.path.isfile(os.path.join(tdir, n))]
        if names:
            f.write(f"CELL_DATA {len(cells)}\n")
            from . import fields as field_io

            for name in sorted(names):
                try:
                    fld = field_io.read_field(os.path.join(tdir, name), mesh,
                                              name=name)
                except Exception:
                    continue
                data = fld.data.detach().cpu().numpy()
                if data.ndim == 1:
                    f.write(f"SCALARS {name} float 1\nLOOKUP_TABLE default\n")
                    for v in data:
                        f.write(f"{float(v)}\n")
                else:
                    f.write(f"VECTORS {name} float\n")
                    for v in data:
                        f.write(f"{float(v[0])} {float(v[1])} {float(v[2])}\n")
    return out
