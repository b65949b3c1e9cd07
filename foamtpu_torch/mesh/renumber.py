"""Mesh renumbering for bandwidth and locality (host copy of
openfoam-2.2.x_tpu/mesh/renumber.py: `cuthill_mckee`, `apply_ordering`,
`bandwidth`, `renumber`; src/renumber/ CuthillMcKeeRenumber and
applications/utilities/mesh/manipulation/renumberMesh/).

A low-bandwidth ordering turns most neighbour hops into a few constant
index offsets (mesh/core.py::offset_stencil), so more of the operator's
incidences land in the SpMV's stencil and fewer in its COO remainder.
blockMesh output is already well ordered; the pass matters for
imported and unstructured meshes. The ordering is the reference's,
bit for bit: the same breadth-first walk in numpy on the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def cuthill_mckee(poly, reverse: bool = True) -> np.ndarray:
    """(R)CM ordering from the cell-cell graph. Returns `order`:
    order[new_id] = old_id."""
    n = poly.n_cells
    nif = poly.n_internal_faces
    own = poly.owner[:nif]
    nei = poly.neighbour
    # adjacency in CSR-ish form
    ends = np.concatenate([own, nei])
    others = np.concatenate([nei, own])
    perm = np.argsort(ends, kind="stable")
    ends_s, others_s = ends[perm], others[perm]
    starts = np.searchsorted(ends_s, np.arange(n + 1))
    degree = starts[1:] - starts[:-1]

    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    while pos < n:
        # next component: unvisited cell of minimum degree
        unvisited = np.nonzero(~visited)[0]
        seed = unvisited[np.argmin(degree[unvisited])]
        # BFS with degree-sorted neighbours
        queue = [int(seed)]
        visited[seed] = True
        qi = 0
        while qi < len(queue):
            c = queue[qi]
            qi += 1
            order[pos] = c
            pos += 1
            nbrs = others_s[starts[c]:starts[c + 1]]
            nbrs = nbrs[~visited[nbrs]]
            if nbrs.size:
                nbrs = np.unique(nbrs)
                nbrs = nbrs[np.argsort(degree[nbrs], kind="stable")]
                visited[nbrs] = True
                queue.extend(int(x) for x in nbrs)
    if reverse:
        order = order[::-1].copy()
    return order


def apply_ordering(poly, order: np.ndarray):
    """Relabel cells by `order` (order[new]=old), preserving the
    upper-triangular face convention. Returns a new PolyMesh."""
    from .core import PolyMesh

    n = poly.n_cells
    new_of_old = np.empty(n, dtype=np.int64)
    new_of_old[order] = np.arange(n)

    nif = poly.n_internal_faces
    own = new_of_old[poly.owner[:nif]]
    nei = new_of_old[poly.neighbour]
    # keep owner < neighbour: flip faces where violated
    flip = own > nei
    own2 = np.where(flip, nei, own)
    nei2 = np.where(flip, own, nei)
    face_pts = poly.face_pts.copy()
    npts = poly.face_npts
    for f in np.nonzero(flip)[0]:
        k = npts[f]
        face_pts[f, :k] = face_pts[f, :k][::-1]
    # re-sort internal faces upper-triangular
    fsort = np.lexsort((nei2, own2))
    b_owner = new_of_old[poly.owner[nif:]]

    return PolyMesh(
        points=poly.points,
        face_pts=np.concatenate([face_pts[:nif][fsort], face_pts[nif:]]),
        face_npts=np.concatenate([npts[:nif][fsort], npts[nif:]]),
        owner=np.concatenate([own2[fsort], b_owner]),
        neighbour=nei2[fsort],
        patches=list(poly.patches),
        cell_zones={k: np.sort(new_of_old[np.asarray(v, dtype=np.int64)])
                    for k, v in (poly.cell_zones or {}).items()},
    )


def bandwidth(poly) -> int:
    nif = poly.n_internal_faces
    if nif == 0:
        return 0
    return int(np.max(poly.neighbour - poly.owner[:nif]))


def renumber(poly, method: str = "CuthillMcKee"):
    """renumberMesh equivalent: returns (new_poly, order)."""
    if method in ("CuthillMcKee", "RCM"):
        order = cuthill_mckee(poly, reverse=True)
    elif method == "CM":
        order = cuthill_mckee(poly, reverse=False)
    else:
        raise ValueError(f"unknown renumber method {method!r}")
    return apply_ordering(poly, order), order
