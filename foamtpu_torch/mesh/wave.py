"""wave: FaceCellWave-style propagating fronts (port of
openfoam-2.2.x_tpu/mesh/wave.py: `cell_wave`, `wall_distance`;
src/meshTools/algorithms/MeshWave/, src/OpenFOAM/algorithms/
FaceCellWave/ with wallPoint data: squared distance and origin point,
carried cell to face to cell until no cell changes). It is the engine
of `distanceMethod meshWave` wall distance.

As in the reference, the wave advances as a Jacobi sweep: in one sweep
every cell reads all its neighbours' (origin, dist^2) through the slot
tables (and the COO remainder's pairs) and keeps the closest origin, so
each sweep moves the front one cell layer. The reference repeats the
sweep in a `lax.while_loop` on the device until no cell improves; here
it is a torch loop on the mesh's device that looks at the host only
every CHECK_EVERY sweeps, with one read of the flags of those sweeps.
A sweep after the front has stopped changes nothing (no cell improves,
so the state is its own fixed point), so the extra sweeps leave the
result as it was, and the flags give the reference's sweep count. With
8 the reads fall eightfold while at most 7 idle sweeps (each ~10
launches, microseconds) are spent: the sweep count is the mesh's
eccentric diameter in cells, tens to hundreds on the cases run here.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

CHECK_EVERY = 8


def cell_wave(mesh, dist2_0, origin_0, max_iters: int = 0):
    """Propagate (dist^2 to origin, origin point) across cells until
    stationary. dist2_0 [nC] (inf = unset), origin_0 [nC,3]. Returns
    (dist2, origin, sweeps), sweeps counted as the reference counts
    them (the last one being the sweep that changed nothing)."""
    from ..ops import slot as slot_mod

    max_iters = max_iters or mesh.n_cells  # eccentricity upper bound
    c = mesh.c
    valid = mesh.st_valid > 0
    has_fb = mesh.fb_cells.shape[0] > 0

    def sweep(d2, org):
        nb_org = slot_mod.nbr_values(mesh, org)      # [nC,M,3]
        # candidate distance via the NEIGHBOUR'S origin
        cand = torch.sum((c[:, None, :] - nb_org) ** 2, dim=2)
        nb_d2 = slot_mod.nbr_values(mesh, d2)
        # only neighbours that are themselves set propagate
        cand = torch.where((nb_d2 < 1e30) & valid, cand,
                           torch.full_like(cand, float("inf")))
        k = torch.argmin(cand, dim=1)
        best = torch.gather(cand, 1, k[:, None])[:, 0]
        best_org = torch.gather(
            nb_org, 1, k[:, None, None].expand(-1, 1, 3))[:, 0]
        if has_fb:
            # fold the remainder's neighbours in; a cell with several
            # takes one of their origins, as the reference's scatter
            # leaves the order of duplicate writes undefined
            org_n = org[mesh.fb_nbrs]
            d_fb = torch.sum((c[mesh.fb_cells] - org_n) ** 2, dim=1)
            d_fb = torch.where(d2[mesh.fb_nbrs] < 1e30, d_fb,
                               torch.full_like(d_fb, float("inf")))
            better_fb = d_fb < best[mesh.fb_cells]
            best = best.scatter_reduce(0, mesh.fb_cells, d_fb,
                                       reduce="amin")
            cur = best_org[mesh.fb_cells]
            best_org = best_org.index_put(
                (mesh.fb_cells,), torch.where(better_fb[:, None], org_n,
                                              cur))
        improved = best < d2 * (1.0 - 1e-7)
        return (torch.where(improved, best, d2),
                torch.where(improved[:, None], best_org, org),
                torch.any(improved))

    d2, org = dist2_0, origin_0
    it = 0
    while it < max_iters:
        n = min(CHECK_EVERY, max_iters - it)
        flags = []
        for _ in range(n):
            d2, org, changed = sweep(d2, org)
            flags.append(changed)
        got = torch.stack(flags).cpu().numpy()    # one read per check
        if not got.all():
            it += int(np.argmin(got)) + 1
            break
        it += n
    return d2, org, it


def wall_distance(mesh, wall_types=("wall",)) -> Any:
    """meshWave wall distance [nC] (wallDistData + wallPoint): the
    Euclidean distance to the nearest wall-face centre seen through the
    cell-connectivity wave. The seeds are found on the host, the wave
    runs on the mesh's device."""
    nC = mesh.n_cells
    owner = mesh.owner.cpu().numpy()
    cf = mesh.cf.cpu().numpy()
    c = mesh.c.cpu().numpy()
    seed_d2 = np.full(nC, np.inf)
    seed_org = np.zeros((nC, 3))
    for p in mesh.patches:
        if p.type not in wall_types:
            continue
        sl = p.slice
        cells = owner[sl]
        dd = ((c[cells] - cf[sl]) ** 2).sum(axis=1)
        order = np.argsort(-dd)      # the closest written LAST wins
        np.minimum.at(seed_d2, cells, dd)
        take = dd[order] <= seed_d2[cells[order]]
        seed_org[cells[order][take]] = cf[sl][order][take]
    kw = dict(dtype=mesh.v.dtype, device=mesh.device)
    d2, _, _ = cell_wave(mesh, torch.tensor(seed_d2, **kw),
                         torch.tensor(seed_org, **kw))
    return torch.sqrt(d2)
