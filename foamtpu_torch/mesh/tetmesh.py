"""Structured-box tetrahedral mesher (port of
openfoam-2.2.x_tpu/mesh/tetmesh.py: `tet_box` and `coo_fraction`).

Each hex of an nx x ny x nz grid splits into SIX tets around its main
diagonal (v0-v6). With the same local diagonal in every hex the split
is conforming: every shared quad face receives the same triangle
diagonal from both sides. The tets' irregular neighbour offsets defeat
the structured offset stencil: a third of the cell-face incidences fall
to the COO remainder of the SpMV. (GAMG's 'auto' rule still pairs cells
c, c+1 by index: the six tets of a hex are consecutive and share
faces.) Assembly goes through mesh/gmsh.py::to_polymesh, as in the
reference.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .core import PolyMesh
from .gmsh import to_polymesh

# 6-tet split of the hex (blockMesh vertex order: bottom 0-3 ccw,
# top 4-7 above), all tets share edge v0-v6
_TETS = ((0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6),
         (0, 7, 4, 6), (0, 4, 5, 6), (0, 5, 1, 6))

# boundary-quad triangulation consistent with the incident hex's split
_BND_TRIS = {
    "-x": ((0, 3, 7), (0, 7, 4)),
    "+x": ((1, 2, 6), (1, 6, 5)),
    "-y": ((0, 1, 5), (0, 5, 4)),
    "+y": ((2, 3, 6), (3, 7, 6)),
    "-z": ((0, 1, 2), (0, 2, 3)),
    "+z": ((4, 5, 6), (4, 6, 7)),
}


def tet_box(nx: int, ny: int, nz: int,
            size: Tuple[float, float, float] = (1.0, 1.0, 1.0),
            patch_names=("inlet", "outlet", "walls")) -> PolyMesh:
    """6-tet split of an nx*ny*nz hex box -> PolyMesh with 6*nx*ny*nz
    tets. x- face = patch_names[0], x+ = patch_names[1], the rest =
    patch_names[2] (type wall when the name contains 'wall')."""
    lx, ly, lz = size
    px = np.linspace(0.0, lx, nx + 1)
    py = np.linspace(0.0, ly, ny + 1)
    pz = np.linspace(0.0, lz, nz + 1)
    X, Y, Z = np.meshgrid(px, py, pz, indexing="ij")
    points = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def pid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    i, j, k = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    i, j, k = i.ravel(), j.ravel(), k.ravel()
    # hex corner ids in blockMesh order (z the 'up' axis)
    corners = np.stack([
        pid(i, j, k), pid(i + 1, j, k), pid(i + 1, j + 1, k),
        pid(i, j + 1, k),
        pid(i, j, k + 1), pid(i + 1, j, k + 1), pid(i + 1, j + 1, k + 1),
        pid(i, j + 1, k + 1)], axis=1)              # [nHex, 8]

    cells = np.stack([corners[:, list(t)] for t in _TETS],
                     axis=1).reshape(-1, 4)         # [nHex*6, 4]
    cell_list = [(4, tuple(row)) for row in cells]

    surfs = []

    def add_side(mask, side, phys_id):
        for tri in _BND_TRIS[side]:
            tv = corners[mask][:, list(tri)]
            surfs.extend((phys_id, tuple(r)) for r in tv)

    add_side(i == 0, "-x", 1)
    add_side(i == nx - 1, "+x", 2)
    add_side(j == 0, "-y", 3)
    add_side(j == ny - 1, "+y", 3)
    add_side(k == 0, "-z", 3)
    add_side(k == nz - 1, "+z", 3)

    phys = {1: patch_names[0], 2: patch_names[1], 3: patch_names[2]}
    return to_polymesh(points, cell_list, surfs, phys)


def coo_fraction(mesh) -> float:
    """Fraction of cell-face incidences served by the COO fallback
    instead of the offset stencil (0 on a structured mesh)."""
    n_fb = int(mesh.fb_cells.shape[0])
    n_slot = int((mesh.st_valid > 0).sum())
    return n_fb / max(n_fb + n_slot, 1)
