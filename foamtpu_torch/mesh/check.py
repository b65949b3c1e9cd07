"""Mesh quality / validity checks, the checkMesh equivalent (host copy
of openfoam-2.2.x_tpu/mesh/check.py; applications/utilities/mesh/
manipulation/checkMesh/, src/OpenFOAM/meshes/primitiveMesh/
primitiveMeshCheck/): numpy on the host PolyMesh, as the reference's.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .core import PolyMesh


def check(mesh: PolyMesh, verbose: bool = False) -> Dict[str, float]:
    """Run topology/geometry checks; raises on fatal errors, returns
    quality statistics."""
    nif = mesh.n_internal_faces
    own, nei = mesh.owner[:nif], mesh.neighbour

    # --- topology -----------------------------------------------------------
    assert mesh.owner.min() >= 0 and mesh.owner.max() < mesh.n_cells
    if nif:
        assert (own != nei).all(), "face with owner == neighbour"
        assert (own < nei).all(), "internal faces not upper-triangular"
    # patches tile the boundary exactly
    covered = np.zeros(mesh.n_faces - nif, dtype=bool)
    for p in mesh.patches:
        assert p.start >= nif, f"patch {p.name} overlaps internal faces"
        covered[p.start - nif : p.start - nif + p.size] = True
    assert covered.all(), "boundary faces not covered by patches"

    # --- geometry -----------------------------------------------------------
    stats: Dict[str, float] = {}
    stats["nCells"] = mesh.n_cells
    stats["nFaces"] = mesh.n_faces
    stats["nInternalFaces"] = nif
    stats["nPoints"] = mesh.n_points

    assert (mesh.v > 0).all(), "negative or zero cell volumes"
    stats["minVolume"] = float(mesh.v.min())
    stats["totalVolume"] = float(mesh.v.sum())

    # closedness: each cell's face area vectors sum to ~0
    cell_sum = np.zeros((mesh.n_cells, 3))
    np.add.at(cell_sum, mesh.owner, mesh.sf)
    np.add.at(cell_sum, nei, -mesh.sf[:nif])
    open_frac = np.linalg.norm(cell_sum, axis=1) / np.maximum(
        mesh.mag_sf.mean(), 1e-300
    )
    stats["maxCellOpenness"] = float(open_frac.max())
    assert stats["maxCellOpenness"] < 1e-8, "mesh has open cells"

    # orientation: Sf points owner -> neighbour
    if nif:
        d = mesh.c[nei] - mesh.c[own]
        dots = np.einsum("fi,fi->f", mesh.sf[:nif], d)
        assert (dots > 0).all(), "internal face area vector misoriented"
        # non-orthogonality
        cos = dots / np.maximum(
            mesh.mag_sf[:nif] * np.linalg.norm(d, axis=1), 1e-300
        )
        non_orth = np.degrees(np.arccos(np.clip(cos, -1, 1)))
        stats["maxNonOrtho"] = float(non_orth.max())
        stats["avgNonOrtho"] = float(non_orth.mean())
        # skewness: distance of face intersection point from face centre
        # (simplified metric: |Cf - midpoint of the delta line| / |delta|)
        fi = mesh.c[own] + (
            np.einsum("fi,fi->f", mesh.cf[:nif] - mesh.c[own], mesh.sf[:nif])
            / np.maximum(dots, 1e-300)
        )[:, None] * d
        skew = np.linalg.norm(mesh.cf[:nif] - fi, axis=1) / np.maximum(
            np.linalg.norm(d, axis=1), 1e-300
        )
        stats["maxSkewness"] = float(skew.max())

    # boundary faces point outward
    bsl = slice(nif, mesh.n_faces)
    d_b = mesh.cf[bsl] - mesh.c[mesh.owner[bsl]]
    assert (
        np.einsum("fi,fi->f", mesh.sf[bsl], d_b) > 0
    ).all(), "boundary face area vector points inward"

    if verbose:
        for k, v in stats.items():
            print(f"    {k}: {v}")
    return stats
