"""foamtpu_torch face geometry over 20,000 faces against the JAX package.

Over 20,000 faces the reference computes face centres and areas in its
native helper (openfoam-2.2.x_tpu/mesh/core.py:90-91,
native/libfoamtpu_io.so), while the port's copy always takes the numpy
path (foamtpu_torch/mesh/core.py::face_centres_areas). A one-cell-thick
71^2 cavity has 4*71^2 + 2*71 = 20,306 faces, just over the threshold.
In float64 (a subprocess with FOAMTPU_X64=1 JAX_ENABLE_X64=1), from the
same host PolyMesh, every FvMesh array of the port must equal the
reference's: integers exactly (of the same kind), floats within 4 ulp
of the array's largest magnitude. Two meshes: the cavity as blockMesh
makes it, and the same cavity with its interior points moved by a
seeded 10% of a cell (warped, non-planar faces, where a different
summation order in the native helper would show). The test first checks
that the reference did take its native path. Measured: 0 ulp in every
array of both meshes (the native helper and numpy round alike).
"""

import json
import os
import subprocess
import sys

import pytest

from test_torch_simple import REPO

ULP_BOUND = 4

F64_BODY = r"""
import json, sys
import numpy as np
import torch

from foamtpu.apps.cases import CAVITY_BLOCKMESH
from foamtpu.core.dictionary import parse_string as jparse
from foamtpu.io import native
from foamtpu.mesh import blockmesh as jblockmesh
from foamtpu.mesh import to_device as jto_device
from foamtpu.mesh.core import PolyMesh as JPolyMesh

from foamtpu_torch.mesh import to_device
from foamtpu_torch.mesh.core import ARRAY_FIELDS, Patch, PolyMesh

kind = sys.argv[1]
pm = jblockmesh.generate(jparse(CAVITY_BLOCKMESH.replace("{n}", "71")))
points = np.array(pm.points, dtype=np.float64)
if kind == "warped":
    rng = np.random.default_rng(5)
    lo, hi = points.min(axis=0), points.max(axis=0)
    inner = np.all((points > lo + 1e-12) & (points < hi - 1e-12)
                   | (np.arange(3) == 2), axis=1)
    h = (hi[0] - lo[0]) / 71
    points[inner] += 0.1 * h * (rng.random((int(inner.sum()), 3)) - 0.5)
    pm = JPolyMesh(points=points, face_pts=pm.face_pts,
                   face_npts=pm.face_npts, owner=pm.owner,
                   neighbour=pm.neighbour, patches=pm.patches)
native_used = native.face_geometry(pm.points, pm.face_pts,
                                   pm.face_npts) is not None
ref = jto_device(pm)
got = to_device(PolyMesh(points=points, face_pts=pm.face_pts,
                         face_npts=pm.face_npts, owner=pm.owner,
                         neighbour=pm.neighbour,
                         patches=[Patch(p.name, p.type, p.start, p.size)
                                  for p in pm.patches]), "cpu")
out = {"n_faces": int(pm.n_faces), "native": native_used, "arrays": {}}
for name in ARRAY_FIELDS:
    r = np.asarray(getattr(ref, name))
    g = getattr(got, name)
    g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
    rec = {"shape_ok": g.shape == r.shape, "dtype": [str(g.dtype),
                                                     str(r.dtype)]}
    if r.dtype.kind == "f" and r.size:
        scale = float(np.abs(r).max()) or 1.0
        rec["ulp"] = float(np.abs(g - r).max() / np.spacing(scale))
    else:
        rec["equal"] = bool(g.shape == r.shape and np.array_equal(g, r))
    out["arrays"][name] = rec
print(json.dumps(out))
"""


@pytest.mark.parametrize("kind", ["cavity", "warped"])
def test_large_mesh_geometry_matches_native_reference(kind):
    env = dict(os.environ)
    env.update(FOAMTPU_X64="1", JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", F64_BODY, kind], env=env,
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["n_faces"] == 20306 and res["native"]
    for name, rec in res["arrays"].items():
        assert rec["shape_ok"], name
        # the same kind, as tests/test_torch_mesh.py holds it (index
        # arrays may be int32 on one side)
        assert rec["dtype"][0][:3] == rec["dtype"][1][:3], (name, rec)
        if "ulp" in rec:
            assert rec["dtype"][0] == "float64", name
            assert rec["ulp"] <= ULP_BOUND, (name, rec)
        else:
            assert rec["equal"], name
