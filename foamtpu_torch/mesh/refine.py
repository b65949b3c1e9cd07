"""refine: adaptive mesh refinement (dynamicRefineFvMesh).

Host copy of openfoam-2.2.x_tpu/mesh/refine.py, unchanged in behaviour
(reference: src/dynamicFvMesh/dynamicRefineFvMesh/: hex 2:1 refinement
driven by a field band, buffer layers, unrefinement of quiescent sibling
groups, conservative field mapping), on top of the port's
`mesh/snappy.py::octree_mesh` and `_background_box`: numpy throughout;
the reference module imports no jax either, but every `foamtpu.mesh`
import loads it, so the port carries the copy.

Adaptation happens on the host between steps: the octree leaf set is
adapted to the field band, the PolyMesh is rebuilt (split faces at level
transitions, the face-addressed storage dynamicRefineFvMesh produces, so
the hanging faces land in the SpMV's COO remainder), fields are remapped
volume-conservatively through a dense finest-level lattice, and the
caller rebuilds the device mesh (`to_device`). The port is eager: the
step is not recompiled, only the device mesh is rebuilt.

Constraint (as the reference): a uniform box background (the
damBreakWithObstacle pattern); levels differ by <= 1 across faces (2:1
balance).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

from .core import PolyMesh
from . import snappy


@dataclasses.dataclass
class AMRMesh:
    """Octree state whose sorted leaf list matches the PolyMesh cell
    order produced by octree_mesh."""
    bb_min: np.ndarray
    bb_max: np.ndarray
    base_n: Tuple[int, int, int]
    side_patches: Dict
    two_d: bool
    cells: List[Tuple[int, int, int, int]]   # sorted leaves == cell order

    @property
    def leaves(self) -> Set:
        return set(self.cells)


def balance_2to1(leaves: Set, two_d: bool) -> Set:
    """Enforce the 2:1 level jump across faces (extracted from
    snappy.octree_refine's balance sweep)."""
    leaves = dict.fromkeys(leaves, True)
    changed = True
    while changed:
        changed = False
        by_level: Dict[int, Set] = {}
        for c in leaves:
            by_level.setdefault(c[0], set()).add(c[1:])
        if not by_level:
            break
        max_l = max(by_level)
        for l in sorted(by_level):
            if l + 2 > max_l:
                continue
            for cell in list(by_level.get(l, ())):
                if (l, *cell) not in leaves:
                    continue
                i, j, k = cell
                needs = False
                for fl in range(l + 2, max_l + 1):
                    f = 2 ** (fl - l)
                    kf = k if two_d else k * f
                    kspan = (kf,) if two_d else range(kf, kf + f)
                    for (di, dj, dk) in ((1, 0, 0), (-1, 0, 0),
                                         (0, 1, 0), (0, -1, 0),
                                         (0, 0, 1), (0, 0, -1)):
                        if two_d and dk:
                            continue
                        if di == 1:
                            xs = ((i + 1) * f,)
                        elif di == -1:
                            xs = (i * f - 1,)
                        else:
                            xs = range(i * f, (i + 1) * f)
                        if dj == 1:
                            ys = ((j + 1) * f,)
                        elif dj == -1:
                            ys = (j * f - 1,)
                        else:
                            ys = range(j * f, (j + 1) * f)
                        if dk == 1:
                            zs = ((k + 1) * f,)
                        elif dk == -1:
                            zs = (k * f - 1,)
                        else:
                            zs = kspan
                        lv = by_level.get(fl, set())
                        if any((x, y, z) in lv for x in xs
                               for y in ys for z in zs):
                            needs = True
                            break
                    if needs:
                        break
                if needs:
                    del leaves[(l, i, j, k)]
                    by_level[l].discard(cell)
                    krange = (k,) if two_d else (2 * k, 2 * k + 1)
                    for ci in (2 * i, 2 * i + 1):
                        for cj in (2 * j, 2 * j + 1):
                            for ck in krange:
                                leaves[(l + 1, ci, cj, ck)] = True
                                by_level.setdefault(
                                    l + 1, set()).add((ci, cj, ck))
                    changed = True
    return set(leaves)


def amr_init(pm: PolyMesh) -> Tuple[AMRMesh, PolyMesh]:
    """Initialise AMR from a uniform box background mesh. Returns the
    AMR state AND the canonical rebuilt PolyMesh (octree cell order);
    fields read on the original mesh must be remapped with
    `build_maps` if the orders differ (identical geometry)."""
    box = snappy._background_box(pm)
    if box is None:
        raise ValueError("dynamicRefineFvMesh: uniform box background "
                         "required")
    bb_min, bb_max, base_n, side_patches, two_d = box
    nx, ny, nz = base_n
    cells = sorted((0, i, j, k) for i in range(nx) for j in range(ny)
                   for k in range(nz))
    amr = AMRMesh(bb_min=np.asarray(bb_min, float),
                  bb_max=np.asarray(bb_max, float), base_n=base_n,
                  side_patches=side_patches, two_d=two_d, cells=cells)
    pm_new = snappy.octree_mesh(bb_min, bb_max, base_n, set(cells),
                                side_patches, two_d)
    return amr, pm_new


def _dense_lattice(amr: AMRMesh, cells, L: int) -> np.ndarray:
    """Dense finest-level lattice holding each fine voxel's owning
    cell index."""
    nx, ny, nz = amr.base_n
    F = 2 ** L
    NX, NY = nx * F, ny * F
    NZ = nz if amr.two_d else nz * F
    dense = np.full((NX, NY, NZ), -1, dtype=np.int64)
    for idx, (l, i, j, k) in enumerate(cells):
        f = 2 ** (L - l)
        if amr.two_d:
            dense[i * f:(i + 1) * f, j * f:(j + 1) * f, k:k + 1] = idx
        else:
            dense[i * f:(i + 1) * f, j * f:(j + 1) * f,
                  k * f:(k + 1) * f] = idx
    return dense


def build_maps(amr_old: AMRMesh, amr_new: AMRMesh
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(vox_old, vox_new): for every voxel of the COMMON finest
    lattice, the owning old / new cell index. Refinement is
    one-to-many and unrefinement many-to-one, so conservative remap
    must integrate per voxel, not per representative point."""
    L = max(max(c[0] for c in amr_old.cells),
            max(c[0] for c in amr_new.cells))
    d_old = _dense_lattice(amr_old, amr_old.cells, L)
    d_new = _dense_lattice(amr_new, amr_new.cells, L)
    return d_old.ravel(), d_new.ravel()


def remap_field(vals_old: np.ndarray, vox_old: np.ndarray,
                vox_new: np.ndarray, n_new: int) -> np.ndarray:
    """Volume-conservative cell-field transfer through the common
    finest lattice (uniform voxels): children inherit the parent value
    on refinement; unrefinement volume-averages the sibling group
    (reference: dynamicRefineFvMesh's mapFields)."""
    w = np.zeros(n_new)
    np.add.at(w, vox_new, 1.0)
    src = vals_old[vox_old]
    if vals_old.ndim == 2:
        out = np.zeros((n_new, vals_old.shape[1]))
        np.add.at(out, vox_new, src)
        return out / np.maximum(w, 1e-300)[:, None]
    out = np.zeros(n_new)
    np.add.at(out, vox_new, src)
    return out / np.maximum(w, 1e-300)


def adapt(amr: AMRMesh, pm: PolyMesh, field: np.ndarray,
          lower: float, upper: float, max_level: int,
          n_buffer: int = 1, max_cells: int = 500000
          ) -> Optional[Tuple[AMRMesh, PolyMesh]]:
    """One adaptation event: refine leaves whose field value lies in
    (lower, upper) — plus n_buffer face-adjacency layers — up to
    max_level; unrefine sibling groups entirely OUTSIDE the band.
    Returns (amr_new, pm_new) or None when the mesh is unchanged."""
    mark = (field > lower) & (field < upper)
    # buffer layers by face adjacency on the CURRENT mesh
    own = pm.owner[:pm.n_internal_faces]
    nbr = pm.neighbour
    for _ in range(n_buffer):
        m2 = mark.copy()
        sel = mark[own] | mark[nbr]
        m2[own[sel]] = True
        m2[nbr[sel]] = True
        mark = m2

    cells = amr.cells
    leaves = dict.fromkeys(cells, True)
    # refinement
    n_est = len(cells)
    for idx, c in enumerate(cells):
        l, i, j, k = c
        if mark[idx] and l < max_level and n_est < max_cells:
            del leaves[c]
            krange = (k,) if amr.two_d else (2 * k, 2 * k + 1)
            for ci in (2 * i, 2 * i + 1):
                for cj in (2 * j, 2 * j + 1):
                    for ck in krange:
                        leaves[(l + 1, ci, cj, ck)] = True
            n_est += (3 if amr.two_d else 7)
    # unrefinement: whole sibling groups (not refined this round, all
    # unmarked) merge back to the parent
    idx_of = {c: n for n, c in enumerate(cells)}
    groups: Dict[Tuple, List] = {}
    for c in cells:
        l, i, j, k = c
        if l == 0 or c not in leaves:
            continue
        parent = (l - 1, i // 2, j // 2, k if amr.two_d else k // 2)
        groups.setdefault(parent, []).append(c)
    full = 4 if amr.two_d else 8
    for parent, kids in groups.items():
        if len(kids) != full:
            continue
        if any(mark[idx_of[c]] for c in kids):
            continue
        for c in kids:
            del leaves[c]
        leaves[parent] = True

    new_leaves = balance_2to1(set(leaves), amr.two_d)
    if new_leaves == set(cells):
        return None
    cells_new = sorted(new_leaves)
    pm_new = snappy.octree_mesh(amr.bb_min, amr.bb_max, amr.base_n,
                                new_leaves, amr.side_patches,
                                amr.two_d)
    amr_new = dataclasses.replace(amr, cells=cells_new)
    return amr_new, pm_new
