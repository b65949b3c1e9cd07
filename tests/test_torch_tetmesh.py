"""foamtpu_torch tet mesher, gmsh assembly and wall distance against the
JAX package.

The port copies the reference's host numpy code (mesh/gmsh.py,
mesh/tetmesh.py, mesh/walldist.py), so every array must equal the
reference's exactly: integers equal, floats to 0 ulp.

- `tet_box(4,3,3)` and `tet_box(8,4,4)`: the PolyMesh arrays, the
  to_device FvMesh arrays and `coo_fraction`.
- `to_polymesh` on a small gmsh cell list holding a hex and a prism that
  share a quad face, with named and unnamed boundary elements.
- `wall_distance` and `wall_adjacency` on the tet box.
- The GAMG hierarchy of the tet box (n_coarsest=64), with the 'auto'
  pairing rule and with the face-weight pairwise matching forced.
- The entry points default to the card and do not fall back to the CPU.
"""

import inspect

import numpy as np
import pytest
import torch

from foamtpu.mesh import gmsh as jgmsh
from foamtpu.mesh import tetmesh as jtet
from foamtpu.mesh import to_device as jto_device
from foamtpu.mesh import walldist as jwd
from foamtpu.solvers.linear import gamg as jgamg

from foamtpu_torch.apps.cases import make_cavity
from foamtpu_torch.core.case import Case
from foamtpu_torch.core.precision import DEFAULT_DEVICE
from foamtpu_torch.mesh import gmsh, tetmesh, to_device, walldist
from foamtpu_torch.mesh.core import ARRAY_FIELDS
from foamtpu_torch.solvers.linear import gamg

from test_torch_mesh import _compare_levels, _same

torch.set_num_threads(2)

POLY_FIELDS = ("points", "face_pts", "face_npts", "owner", "neighbour",
               "cf", "sf", "mag_sf", "c", "v", "weights", "delta_coeffs",
               "non_orth_delta_coeffs", "correction_vecs")
SIZES = [(4, 3, 3), (8, 4, 4)]


def _same_poly(got, ref):
    for name in POLY_FIELDS:
        _same(getattr(got, name), getattr(ref, name), name)
    assert [(p.name, p.type, p.start, p.size) for p in got.patches] == \
        [(p.name, p.type, p.start, p.size) for p in ref.patches]


@pytest.mark.parametrize("size", SIZES)
def test_tet_box_polymesh_equals_reference(size):
    got = tetmesh.tet_box(*size, size=(4.0, 1.0, 1.0))
    ref = jtet.tet_box(*size, size=(4.0, 1.0, 1.0))
    _same_poly(got, ref)
    assert got.n_cells == 6 * size[0] * size[1] * size[2]
    assert [p.type for p in got.patches] == ["patch", "patch", "wall"]


@pytest.mark.parametrize("size", SIZES)
def test_tet_box_fvmesh_equals_reference(size):
    ref = jto_device(jtet.tet_box(*size))
    got = to_device(tetmesh.tet_box(*size), "cpu")
    for name in ARRAY_FIELDS:
        _same(getattr(got, name), getattr(ref, name), name)
    assert got.st_deltas == tuple(int(d) for d in ref.st_deltas)
    assert not got.orthogonal and got.max_faces == ref.max_faces == 4
    frac = tetmesh.coo_fraction(got)
    assert frac == jtet.coo_fraction(ref)
    assert 0.2 < frac < 0.4          # a third of the incidences fall back


def _hex_prism():
    """A unit hex and a prism on its +x face (the prism's third quad is
    the shared face), as gmsh element lists. The prism's node order is
    mirrored, so its faces come out inward and the orientation fix runs."""
    points = np.array([
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
        [2, 0, 0], [2, 1, 0]], dtype=float)
    cells = [(5, [0, 1, 2, 3, 4, 5, 6, 7]), (6, [1, 8, 5, 2, 9, 6])]
    surfs = [(1, [0, 3, 7, 4]),            # inlet
             (2, [8, 9, 6, 5]),            # outlet
             (3, [0, 1, 5, 4]), (3, [1, 8, 5]),
             (3, [3, 2, 6, 7]), (3, [2, 9, 6])]   # walls; the rest unnamed
    phys = {1: "inlet", 2: "outlet", 3: "sideWalls"}
    return points, cells, surfs, phys


def test_to_polymesh_hex_and_prism():
    args = _hex_prism()
    got, ref = gmsh.to_polymesh(*args), jgmsh.to_polymesh(*args)
    _same_poly(got, ref)
    assert got.n_cells == 2 and got.n_internal_faces == 1
    assert sorted(p.name for p in got.patches) == \
        ["defaultFaces", "inlet", "outlet", "sideWalls"]
    assert np.isclose(got.v.sum(), 1.5)
    # every face area vector points out of its owner
    d = np.einsum("fi,fi->f", got.sf, got.cf - got.c[got.owner])
    assert (d > 0).all()
    for name in ARRAY_FIELDS:
        _same(getattr(to_device(got, "cpu"), name),
              getattr(jto_device(ref), name), name)


def test_wall_distance_and_adjacency_equal_reference():
    pm = tetmesh.tet_box(6, 3, 3)
    jpm = jtet.tet_box(6, 3, 3)
    y = walldist.wall_distance(pm)
    _same(y, jwd.wall_distance(jpm), "wall_distance")
    assert (y > 0).all() and y.max() < 0.5
    for g, r, what in zip(walldist.wall_adjacency(pm),
                          jwd.wall_adjacency(jpm),
                          ("is_wall_cell", "y_wall", "n_wall_faces")):
        _same(g, r, what)
    # no walls: infinite distance
    assert np.isinf(walldist.wall_distance(
        tetmesh.tet_box(2, 1, 1, patch_names=("a", "b", "c")))).all()


def test_refresh_wall_distance():
    from foamtpu_torch.models.turbulence.ras import KOmegaSST

    pm = tetmesh.tet_box(4, 3, 3)
    models = [KOmegaSST(1e-5), None, KOmegaSST(1e-5)]
    n = walldist.refresh_wall_distance(models, pm, torch.float64,
                                       device="cpu")
    assert n == 2
    ref = np.maximum(jwd.wall_distance(jtet.tet_box(4, 3, 3)), 1e-10)
    for m in (models[0], models[2]):
        assert m.y_wall.dtype == torch.float64
        _same(m.y_wall, ref, "y_wall")
    assert walldist.refresh_wall_distance(None, pm, torch.float64) == 0


@pytest.mark.parametrize("pairwise", ["auto", "1"])
def test_gamg_levels_of_the_tet_box_equal_reference(monkeypatch, pairwise):
    """'auto' is what bench.py's duct gets: the six tets of a hex are
    consecutive cells, so the index-offset pairing (c, c+1) shares a
    face for every cluster and wins at every level. '1' forces the
    face-weight pairwise matching on the same mesh."""
    monkeypatch.setenv("FOAMTPU_GAMG_NC", "64")
    monkeypatch.setenv("FOAMTPU_GAMG_PAIRWISE", pairwise)
    ref = jgamg.hierarchy_for_mesh(jto_device(jtet.tet_box(8, 4, 4)))
    got = gamg.hierarchy_for_mesh(to_device(tetmesh.tet_box(8, 4, 4), "cpu"))
    assert len(ref) >= 3
    assert all((lv.cluster_of_fine is not None) == (pairwise == "1")
               for lv in got)
    _compare_levels(got, ref)


def test_entry_points_default_to_the_card():
    assert DEFAULT_DEVICE == "cuda"
    for fn in (make_cavity, Case.__init__, to_device,
               gamg.build_hierarchy):
        assert inspect.signature(fn).parameters["device"].default \
            == DEFAULT_DEVICE, fn
    if not torch.cuda.is_available():
        # no silent CPU fallback: the default fails as torch does
        with pytest.raises((AssertionError, RuntimeError)):
            to_device(tetmesh.tet_box(1, 1, 1))
