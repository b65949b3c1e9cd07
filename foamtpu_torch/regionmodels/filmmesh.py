"""Film-region surface mesh: a 2D FV mesh over primary-patch faces (port
of openfoam-2.2.x_tpu/regionmodels/filmmesh.py: `FilmMesh`,
`build_film_mesh`; reference src/regionModels/regionModel/ and the
extrudeToRegionMesh utility).

The reference extrudes the patch into a one-cell-thick region mesh; here
the film mesh IS the patch: faces become film cells, shared face edges
become film faces. `build_film_mesh` is host numpy copied from the
reference (float64, once); its arrays go to the device as tensors of the
precision's dtype (or stay numpy with `to_device=False`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence

import numpy as np
import torch

from ..core.precision import DEFAULT_DEVICE, scalar_dtype


@dataclasses.dataclass(frozen=True)
class FilmMesh:
    """Surface FV mesh over nF patch faces with nE internal edges. A film
    'cell' is a primary patch face; a film 'face' is an edge shared by two
    patch faces. Boundary edges (owned by one face) are closed."""

    cf: Any            # [nF, 3] face centres
    area: Any          # [nF] face areas
    n: Any             # [nF, 3] unit normals pointing INTO the fluid
    e_own: Any         # [nE]
    e_nbr: Any         # [nE]
    e_m: Any           # [nE, 3] in-plane edge normal * edge length, own->nbr
    e_dc: Any          # [nE] delta coefficients 1/|d|
    face_ids: Any      # [nF] global face indices in the primary mesh
    owner_cells: Any   # [nF] primary cells adjacent to each film cell
    b_rel: Any         # [nF] boundary-relative indices (into [nBf])

    @property
    def n_faces(self) -> int:
        return int(self.area.shape[0])

    @property
    def n_edges(self) -> int:
        return int(self.e_own.shape[0])


def build_film_mesh(poly, patch_names: Sequence[str], to_device: bool = True,
                    device=DEFAULT_DEVICE, dtype=None) -> FilmMesh:
    """Host-side construction from the primary PolyMesh."""
    names = set(patch_names)
    fids: List[int] = []
    for p in poly.patches:
        if p.name in names:
            fids.extend(range(p.start, p.start + p.size))
    if not fids:
        raise ValueError(f"no faces found for film patches {patch_names}")
    fids_a = np.asarray(fids, dtype=np.int64)

    cf = poly.cf[fids_a]
    sf = poly.sf[fids_a]
    mag = poly.mag_sf[fids_a]
    n_out = sf / np.maximum(mag, 1e-300)[:, None]
    n_in = -n_out                          # into the fluid domain

    edges = {}
    for i, g in enumerate(fids):
        npts = int(poly.face_npts[g])
        pts = poly.face_pts[g, :npts]
        for k in range(npts):
            a, b = int(pts[k]), int(pts[(k + 1) % npts])
            key = (a, b) if a < b else (b, a)
            edges.setdefault(key, []).append(i)

    e_own, e_nbr, e_m, e_dc = [], [], [], []
    for (a, b), cells in edges.items():
        if len(cells) != 2:
            continue                       # boundary edge: closed
        o, nb = cells
        pa, pb = poly.points[a], poly.points[b]
        t = pb - pa
        L = np.linalg.norm(t)
        if L < 1e-300:
            continue
        m = np.cross(n_in[o], t / L)       # in-plane, perpendicular to edge
        d = cf[nb] - cf[o]
        if np.dot(m, d) < 0:
            m = -m
        dist = abs(np.dot(d, m))
        e_own.append(o)
        e_nbr.append(nb)
        e_m.append(m * L)
        e_dc.append(1.0 / max(dist, 1e-12))

    e_own_a = np.asarray(e_own, dtype=np.int64)
    e_nbr_a = np.asarray(e_nbr, dtype=np.int64)
    e_m_a = np.asarray(e_m) if e_m else np.zeros((0, 3))
    e_dc_a = np.asarray(e_dc, dtype=np.float64)

    nif = poly.n_internal_faces
    owner_cells = poly.owner[fids_a].astype(np.int64)
    b_rel = (fids_a - nif).astype(np.int64)

    if to_device:
        dt = dtype or scalar_dtype()

        def real(x):
            return torch.tensor(np.asarray(x, np.float64), dtype=dt,
                                device=device)

        def idx(x):
            return torch.tensor(x, dtype=torch.int64, device=device)
    else:
        real = idx = np.asarray
    return FilmMesh(
        cf=real(cf), area=real(mag), n=real(n_in),
        e_own=idx(e_own_a), e_nbr=idx(e_nbr_a),
        e_m=real(e_m_a), e_dc=real(e_dc_a),
        face_ids=idx(fids_a), owner_cells=idx(owner_cells),
        b_rel=idx(b_rel))
