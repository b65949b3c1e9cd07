"""Wall distance (port of openfoam-2.2.x_tpu/mesh/walldist.py:
`wall_distance`, `wall_adjacency` and `refresh_wall_distance`).

The geometric distance from every cell centre to the nearest wall-face
centre, host-side with scipy's KD-tree (exact for the near-wall cells
that matter to the turbulence models; the reference's MeshWave is a
topological approximation). Host numpy, float64.
"""

from __future__ import annotations

import numpy as np

from ..core.precision import DEFAULT_DEVICE


def wall_distance(poly, wall_types=("wall",)) -> np.ndarray:
    """[nC] distance to the nearest wall face centre (inf if no walls)."""
    wall_faces = []
    for p in poly.patches:
        if p.type in wall_types:
            wall_faces.append(np.arange(p.start, p.start + p.size))
    if not wall_faces:
        return np.full(poly.n_cells, np.inf)
    wf = np.concatenate(wall_faces)
    try:
        from scipy.spatial import cKDTree

        tree = cKDTree(poly.cf[wf])
        d, _ = tree.query(poly.c, k=1)
        return d
    except ImportError:  # chunked brute force fallback
        d = np.full(poly.n_cells, np.inf)
        centres = poly.cf[wf]
        for i in range(0, poly.n_cells, 4096):
            sl = slice(i, min(i + 4096, poly.n_cells))
            diff = poly.c[sl, None, :] - centres[None, :, :]
            d[sl] = np.sqrt((diff ** 2).sum(-1)).min(axis=1)
        return d


def wall_adjacency(poly, wall_types=("wall",)):
    """Static per-cell wall-adjacency data for wall functions.

    Returns (is_wall_cell [nC] f64 0/1, y_wall [nC] distance to the
    adjacent wall face along the patch delta, n_wall_faces [nC])."""
    n_cells = poly.n_cells
    isw = np.zeros(n_cells)
    yw = np.zeros(n_cells)
    cnt = np.zeros(n_cells)
    for p in poly.patches:
        if p.type not in wall_types:
            continue
        cells = poly.owner[p.slice]
        y = 1.0 / np.maximum(poly.delta_coeffs[p.slice], 1e-300)
        np.add.at(yw, cells, y)
        np.add.at(cnt, cells, 1.0)
        isw[cells] = 1.0
    yw = np.where(cnt > 0, yw / np.maximum(cnt, 1.0), 1.0)
    return isw, yw, cnt


def refresh_wall_distance(models, poly, dtype,
                          device=DEFAULT_DEVICE) -> int:
    """Recompute the KD-tree wall distance on every model that carries
    one (`init_wall_distance`), after the mesh changed. models: a model
    or an iterable of models (None entries skipped); dtype and device:
    the mesh's, where the models put y_wall. Returns the number of
    models refreshed."""
    if models is None:
        return 0
    if not isinstance(models, (list, tuple)):
        models = (models,)
    n = 0
    for m in models:
        if m is not None and hasattr(m, "init_wall_distance"):
            m.init_wall_distance(poly, dtype, device=device)
            n += 1
    return n
