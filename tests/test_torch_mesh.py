"""foamtpu_torch device mesh and GAMG hierarchy against the JAX package.

The port copies the reference's host numpy code and builds its torch
FvMesh from it, so every array must equal the reference's exactly:
integers equal, floats to 0 ulp (both round the same float64 host values
to the scalar dtype once). Meshes: the 20^2 and 32^2 cavities and a small
tet box (non-orthogonal, with a COO fallback). The GAMG level tables are
compared on the 32^2 cavity with n_coarsest=64 (4 levels, the strided
V-cycle's shape).
"""

import dataclasses

import numpy as np
import pytest
import torch

from foamtpu.core.dictionary import parse_string as jparse
from foamtpu.apps.cases import CAVITY_BLOCKMESH
from foamtpu.mesh import blockmesh as jblockmesh
from foamtpu.mesh import to_device as jto_device
from foamtpu.mesh.tetmesh import tet_box
from foamtpu.solvers.linear import gamg as jgamg

from foamtpu_torch.apps.cases import cavity_polymesh
from foamtpu_torch.convert import levels_from_numpy, mesh_from_numpy
from foamtpu_torch.mesh import to_device
from foamtpu_torch.mesh.core import ARRAY_FIELDS, Patch, PolyMesh
from foamtpu_torch.solvers.linear import gamg

torch.set_num_threads(2)


def _ref_mesh(n):
    pm = jblockmesh.generate(jparse(CAVITY_BLOCKMESH.replace("{n}", str(n))))
    return jto_device(pm)


def _same(got, ref, what):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert got.dtype.kind == ref.dtype.kind, (what, got.dtype, ref.dtype)
    np.testing.assert_array_equal(got, ref, err_msg=what)


def _meshes(kind):
    """(reference FvMesh, port FvMesh) built from the same host input."""
    if kind.startswith("cavity"):
        n = int(kind[len("cavity"):])
        return _ref_mesh(n), to_device(cavity_polymesh(n), "cpu")
    jpm = tet_box(4, 3, 3)
    pm = PolyMesh(points=jpm.points, face_pts=jpm.face_pts,
                  face_npts=jpm.face_npts, owner=jpm.owner,
                  neighbour=jpm.neighbour,
                  patches=[Patch(p.name, p.type, p.start, p.size)
                           for p in jpm.patches])
    return jto_device(jpm), to_device(pm, "cpu")


@pytest.mark.parametrize("kind", ["cavity20", "cavity32", "tet"])
def test_fvmesh_arrays_equal_reference(kind):
    ref, got = _meshes(kind)
    for name in ARRAY_FIELDS:
        _same(getattr(got, name), getattr(ref, name), name)
    assert got.st_deltas == tuple(ref.st_deltas)
    for name in ("n_cells", "n_faces", "n_internal_faces", "max_faces",
                 "orthogonal", "has_ami"):
        assert getattr(got, name) == getattr(ref, name), name
    assert [(p.name, p.type, p.start, p.size) for p in got.patches] == \
        [(p.name, p.type, p.start, p.size) for p in ref.patches]
    assert set(got.cell_zone_masks) == set(ref.cell_zone_masks)


def test_mesh_from_numpy_roundtrip():
    ref = _ref_mesh(20)
    got = mesh_from_numpy(ref)
    for name in ARRAY_FIELDS:
        _same(getattr(got, name), getattr(ref, name), name)
    assert got.st_deltas == tuple(ref.st_deltas)


def _compare_levels(got, ref):
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        for f in dataclasses.fields(gamg.Level):
            gv, rv = getattr(g, f.name), getattr(r, f.name)
            what = f"level {i} {f.name}"
            if f.name in gamg.LEVEL_META:
                assert gv == rv, what
            elif f.name == "st":
                assert set(gv) == set(rv), what
                for k in rv:
                    _same(gv[k], rv[k], f"{what}[{k}]")
            elif f.name == "rule_masks":
                assert len(gv) == len(rv), what
                for a, b in zip(gv, rv):
                    assert (a is None) == (b is None), what
                    if a is not None:
                        _same(a, b, what)
            elif rv is None:
                assert gv is None, what
            else:
                _same(gv, rv, what)


def test_gamg_levels_equal_reference(monkeypatch):
    monkeypatch.setenv("FOAMTPU_GAMG_NC", "64")
    ref_mesh = _ref_mesh(32)
    ref = jgamg.hierarchy_for_mesh(ref_mesh)
    got = gamg.hierarchy_for_mesh(to_device(cavity_polymesh(32), "cpu"))
    assert len(ref) == 4
    assert all(lv.plane_ok for lv in got)
    _compare_levels(got, ref)
    _compare_levels(levels_from_numpy(ref), ref)
