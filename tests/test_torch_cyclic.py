"""foamtpu_torch on a cyclic mesh: channel395's FvMesh and GAMG hierarchy
against the JAX package.

The channelFoam tutorial channel395 is cyclic in x (inlet/outlet) and in
z (front/back). `to_device` internalises each cyclic face pair into one
internal face with a translation (mesh/core.py::internalize_cyclics), so
the wrap-around faces give the offset stencil offsets beyond the six of
a hex mesh; the stencil keeps at most 8 offsets, and the faces beyond
them go to the SpMV's COO remainder (`fb_*`). Each package meshes its
own copy of the tutorial with its own blockMesh command and reads it
back with its own polyMesh reader. In float64 (a subprocess with
FOAMTPU_X64=1 JAX_ENABLE_X64=1) every FvMesh array of the port must equal
the reference's: integers exactly (of the same kind), floats within 4 ulp
of the array's largest magnitude, as tests/test_torch_mesh_large.py holds
them. The arrays include `st_deltas`, the slot coefficients, the COO
remainder and the internalised faces' translation (`face_shift` of the
host mesh that `internalize_cyclics` returns). The GAMG
hierarchy built on the channel (FOAMTPU_GAMG_NC=64, so it has levels) is
held to the reference's the same way, level by level and table by table.
Measured: 0 ulp in every array and every level table; the remainder holds
256 incidences of the channel (the 128 faces of the x wrap).
"""

import json
import os
import subprocess
import sys

import pytest

from test_torch_simple import REPO

ULP_BOUND = 4
CHANNEL395 = os.path.join(REPO, "tutorials", "incompressible", "channelFoam",
                          "channel395")

F64_BODY = r"""
import contextlib, dataclasses, io, json, os, shutil, sys, tempfile
import numpy as np
import torch

from foamtpu.apps.cli import main as jcli
from foamtpu.io import polymesh as jpolymesh
from foamtpu.mesh import to_device as jto_device
from foamtpu.mesh.core import internalize_cyclics as jinternalize
from foamtpu.solvers.linear import gamg as jgamg

from foamtpu_torch.apps.cli import main as tcli
from foamtpu_torch.io import polymesh as tpolymesh
from foamtpu_torch.mesh import to_device
from foamtpu_torch.mesh.core import ARRAY_FIELDS, internalize_cyclics
from foamtpu_torch.solvers.linear import gamg

root = tempfile.mkdtemp()
dirs = {}
for tag, cli in (("ref", jcli), ("port", tcli)):
    dirs[tag] = os.path.join(root, tag)
    shutil.copytree(sys.argv[1], dirs[tag])
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli(["blockMesh", "-case", dirs[tag]]) == 0
mesh_dir = lambda tag: os.path.join(dirs[tag], "constant", "polyMesh")
ref = jto_device(jpolymesh.read(mesh_dir("ref")))
got = to_device(tpolymesh.read(mesh_dir("port")), "cpu")


def compare(g, r):
    g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
    r = np.asarray(r)
    rec = {"shape_ok": g.shape == r.shape,
           "dtype": [str(g.dtype), str(r.dtype)]}
    if r.dtype.kind == "f" and r.size and g.shape == r.shape:
        scale = float(np.abs(r).max()) or 1.0
        rec["ulp"] = float(np.abs(g - r).max() / np.spacing(scale))
    else:
        rec["equal"] = bool(g.shape == r.shape and np.array_equal(g, r))
    return rec


out = {"n_cells": int(got.n_cells), "arrays": {},
       "st_deltas": [list(got.st_deltas), [int(x) for x in ref.st_deltas]],
       "patches": [[(p.name, p.type, p.start, p.size) for p in got.patches],
                   [(p.name, p.type, p.start, p.size) for p in ref.patches]],
       "meta": {n: [getattr(got, n), getattr(ref, n)]
                for n in ("n_cells", "n_faces", "n_internal_faces",
                          "max_faces", "orthogonal", "has_ami")}}
for name in ARRAY_FIELDS:
    out["arrays"][name] = compare(getattr(got, name), getattr(ref, name))
# the internalised faces' translation and their new owner/neighbour
gpm = internalize_cyclics(tpolymesh.read(mesh_dir("port")))
rpm = jinternalize(jpolymesh.read(mesh_dir("ref")))
for name in ("face_shift", "owner", "neighbour", "face_pts"):
    out["arrays"]["poly." + name] = compare(getattr(gpm, name),
                                            getattr(rpm, name))
out["n_remainder"] = int(got.fb_cells.shape[0])
out["n_shifted"] = int((np.abs(gpm.face_shift).sum(axis=1) > 0).sum())

rl = jgamg.hierarchy_for_mesh(ref)
gl = gamg.hierarchy_for_mesh(got)
levels = []
for g, r in zip(gl, rl):
    rec = {}
    for f in dataclasses.fields(gamg.Level):
        gv, rv = getattr(g, f.name), getattr(r, f.name)
        if f.name in gamg.LEVEL_META:
            rec[f.name] = {"equal": bool(gv == rv or list(gv) == list(rv))
                           if gv is not None else rv is None}
        elif f.name == "st":
            rec[f.name] = {"equal": set(gv) == set(rv)}
            for k in rv:
                rec[f"st[{k}]"] = compare(gv[k], rv[k])
        elif f.name == "rule_masks":
            rec[f.name] = {"equal": len(gv) == len(rv) and all(
                (a is None) == (b is None) for a, b in zip(gv, rv))}
            for i, (a, b) in enumerate(zip(gv, rv)):
                if a is not None and b is not None:
                    rec[f"rule_masks[{i}]"] = compare(a, b)
        elif rv is None:
            rec[f.name] = {"equal": gv is None}
        else:
            rec[f.name] = compare(gv, rv)
    levels.append(rec)
out["levels"] = levels
out["n_levels"] = [len(gl), len(rl)]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def f64_run():
    env = dict(os.environ)
    env.update(FOAMTPU_X64="1", JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               FOAMTPU_GAMG_NC="64")
    r = subprocess.run([sys.executable, "-c", F64_BODY, CHANNEL395],
                       env=env, cwd=REPO, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _held(name, rec):
    assert rec.get("shape_ok", True), (name, rec)
    if "dtype" in rec:
        # the same kind (index arrays may be int32 on one side)
        assert rec["dtype"][0][:3] == rec["dtype"][1][:3], (name, rec)
    if "ulp" in rec:
        assert rec["dtype"][0] == "float64", (name, rec)
        assert rec["ulp"] <= ULP_BOUND, (name, rec)
    else:
        assert rec["equal"], (name, rec)


def test_channel_fvmesh_matches_reference(f64_run):
    assert f64_run["n_cells"] == 24 * 16 * 8
    for name, (g, r) in f64_run["meta"].items():
        assert g == r, name
    assert f64_run["st_deltas"][0] == f64_run["st_deltas"][1]
    # the four cyclic patches are internal faces now; only the walls stay
    assert f64_run["patches"][0] == f64_run["patches"][1]
    assert [p[0] for p in f64_run["patches"][0]] == ["walls"]
    for name, rec in f64_run["arrays"].items():
        _held(name, rec)


def test_channel_wrap_faces_reach_the_remainder(f64_run):
    """The wrap-around faces: 16x8 in x and 24x16 in z are translated;
    the offsets beyond the stencil's 8 go to the COO remainder."""
    assert len(f64_run["st_deltas"][0]) == 8
    assert f64_run["n_shifted"] == 16 * 8 + 24 * 16
    assert 0 < f64_run["n_remainder"] < f64_run["n_shifted"]
    for name in ("fb_cells", "fb_nbrs", "fb_sf", "poly.face_shift"):
        _held(name, f64_run["arrays"][name])


def test_channel_gamg_hierarchy_matches_reference(f64_run):
    n_got, n_ref = f64_run["n_levels"]
    assert n_got == n_ref >= 2
    for i, rec in enumerate(f64_run["levels"]):
        for name, r in rec.items():
            _held(f"level {i} {name}", r)
