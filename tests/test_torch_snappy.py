"""snappyHexMesh in foamtpu_torch against the JAX package: the host copies
mesh/snappy.py and mesh/layers.py, the snappyHexMesh command, the snapped
mesh on the device and its GAMG hierarchy, and simpleFoam / windSimpleFoam
on bluffBody and openTerrain.

On the host (numpy float64 in both packages, so bit for bit): bluffBody
meshed by each package's blockMesh and snappyHexMesh (castellate, octree
level 1, snap) and read back by each package's reader gives the same
points, faces, owner, neighbour and patches; so do the 8^3 sphere octree
of tests/test_snappy.py:208 (leaves, refined, castellated and snapped
meshes), the carved, snapped and layered sphere of
tests/test_layers.py:90, and an ASCII and a binary STL read by both.
openTerrain is bluffBody under another application name: the port's
command meshes it to the reference's bluffBody mesh, and windSimpleFoam
runs it bit for bit as simpleFoam runs bluffBody.

In float64 (one process, FOAMTPU_X64=1 JAX_ENABLE_X64=1), on the
tutorial's snapped bluffBody (7,322 cells; hanging faces give up to 9
face neighbours, so 3,922 incidences go to the SpMV's COO remainder):
every FvMesh array and every GAMG level table equals the reference's to
0 ulp, and both packages' run(case) take 3 SIMPLE iterations from a
seeded U (chip_smoke.slice12_case) with fields at rtol 1e-9 and every
solve's iteration count and residuals equal.

`python tests/test_torch_snappy.py goldens [--perturb]` prints the
goldens of chip_smoke.py's snappy_cht phase from the JAX package.
"""

import contextlib
import io
import json
import os
import shutil
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from foamtpu_torch.apps.cli import main as tcli
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.mesh import layers as tlayers
from foamtpu_torch.mesh import snappy as tsnappy
from foamtpu_torch.solvers import apps as tapps
from test_torch_simple import REPO

torch.set_num_threads(2)

POLY = ("points", "face_pts", "face_npts", "owner", "neighbour")


def poly_record(pm):
    return {"arrays": {k: np.asarray(getattr(pm, k)) for k in POLY},
            "patches": [(p.name, p.type, p.start, p.size)
                        for p in pm.patches]}


def assert_same_poly(got, ref, what):
    """Two PolyMeshes bit for bit: arrays, dtypes' kind and patches."""
    g, r = poly_record(got), poly_record(ref)
    assert g["patches"] == r["patches"], what
    for k in POLY:
        a, b = g["arrays"][k], r["arrays"][k]
        assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, (what, k)
        assert np.array_equal(a, b), (what, k)


def _mesh(cli, src, dst):
    shutil.copytree(src, dst)
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli(["blockMesh", "-case", dst]) == 0
        assert cli(["snappyHexMesh", "-case", dst]) == 0
    return dst


def tutorial(name):
    return os.path.join(REPO, "tutorials",
                        *chip_smoke.SLICE12_TUTORIALS[name])


@pytest.fixture(scope="module")
def bluff_meshes(tmp_path_factory):
    from foamtpu.apps.cli import main as jcli
    from foamtpu.io import polymesh as jio
    from foamtpu_torch.io import polymesh as tio

    root = tmp_path_factory.mktemp("bluff")
    dirs = {tag: _mesh(cli, tutorial("bluffBody"), str(root / tag))
            for tag, cli in (("port", tcli), ("ref", jcli))}
    mdir = lambda tag: os.path.join(dirs[tag], "constant", "polyMesh")  # noqa
    return dirs, tio.read(mdir("port")), jio.read(mdir("ref"))


def test_bluffbody_snappy_command_matches_reference(bluff_meshes):
    dirs, got, ref = bluff_meshes
    assert got.n_cells == 7322
    assert [p.name for p in got.patches][-1] == "body"
    assert_same_poly(got, ref, "bluffBody")


def test_openterrain_windsimplefoam_is_bluffbody_simplefoam(bluff_meshes,
                                                            tmp_path):
    """openTerrain through the port's command meshes to the reference's
    bluffBody; windSimpleFoam is simpleFoam: 3 iterations of each through
    run(case) on the CPU are bit-equal, with the body force written."""
    from foamtpu_torch.io import polymesh as tio

    dirs, _, ref = bluff_meshes
    ot = _mesh(tcli, tutorial("openTerrain"), str(tmp_path / "ot"))
    assert_same_poly(tio.read(os.path.join(ot, "constant", "polyMesh")),
                     ref, "openTerrain")
    bb = str(tmp_path / "bb")
    shutil.copytree(dirs["port"], bb)
    assert tapps.APPLICATIONS["windSimpleFoam"] is tapps.simplefoam
    out = {}
    os.environ["FOAMTPU_CHUNK"] = "3"
    try:
        for d in (bb, ot):
            case = TCase(d, device="cpu")
            with contextlib.redirect_stdout(io.StringIO()):
                tapps.run(case, max_steps=3)
            assert case.time.index == 3
            out[d] = {k: case.final_state[k].data for k in ("U", "p")}
            _, fp, fv = chip_smoke.body_force(d)
            assert np.isfinite(fp + fv).all() and abs(fp[0]) > 0
    finally:
        del os.environ["FOAMTPU_CHUNK"]
    assert TCase(ot, device="cpu").application == "windSimpleFoam"
    for k in ("U", "p"):
        assert torch.isfinite(out[bb][k]).all()
        assert torch.equal(out[bb][k], out[ot][k]), k


def test_sphere_octree_matches_reference():
    """tests/test_snappy.py:208's chain (octree_refine to level 2 with 2:1
    balance, octree_mesh with hanging faces, castellate, snap) bit for
    bit, and its oracles on the port's copy."""
    from foamtpu.core.dictionary import parse_string as jps
    from foamtpu.mesh import blockmesh as jbm, snappy as jsnappy
    from foamtpu_torch.core.dictionary import parse_string as tps
    from foamtpu_torch.mesh import blockmesh as tbm

    got = chip_smoke.sphere_octree(tsnappy, tbm, tps)
    ref = chip_smoke.sphere_octree(jsnappy, jbm, jps)
    assert got[3] == ref[3]
    for what, g, r in zip(("refined", "castellated", "snapped"), got[:3],
                          ref[:3]):
        assert_same_poly(g, r, what)
    rec, checks = chip_smoke.sphere_oracles(got)
    assert all(checks.values()), (rec, checks)


def test_layered_sphere_matches_reference():
    """tests/test_layers.py:90's carved, snapped and layered sphere (two
    layers, expansion 1.2) bit for bit, with its cell count."""
    from foamtpu.core.dictionary import parse_string as jps
    from foamtpu.mesh import blockmesh as jbm, layers as jlayers
    from foamtpu.mesh import snappy as jsnappy
    from foamtpu_torch.core.dictionary import parse_string as tps
    from foamtpu_torch.mesh import blockmesh as tbm

    box = """
convertToMeters 1;
vertices ( (0 0 0) (1 0 0) (1 1 0) (0 1 0)
           (0 0 1) (1 0 1) (1 1 1) (0 1 1) );
blocks ( hex (0 1 2 3 4 5 6 7) (10 10 10) simpleGrading (1 1 1) );
boundary
(
    walls { type wall; faces ((2 6 5 1) (0 4 7 3) (1 5 4 0)
                              (3 7 6 2) (0 3 2 1) (4 5 6 7)); }
);
"""
    th = np.linspace(0, np.pi, 11)
    ph = np.linspace(0, 2 * np.pi, 21)
    pt = lambda a, b: 0.5 + 0.25 * np.array([  # noqa: E731
        np.sin(th[a]) * np.cos(ph[b]), np.sin(th[a]) * np.sin(ph[b]),
        np.cos(th[a])])
    tris = np.asarray([t for i in range(10) for j in range(20) for t in (
        [pt(i, j), pt(i + 1, j), pt(i + 1, j + 1)],
        [pt(i, j), pt(i + 1, j + 1), pt(i, j + 1)])])

    def chain(bm, ps, sn, ly):
        pm1 = sn.castellate(bm.generate(ps(box)), tris, (0.05, 0.05, 0.05),
                            body_patch="body")
        pm2 = sn.snap(pm1, tris, body_patch="body")
        return pm2, ly.add_layers(pm2, "body", n_layers=2, expansion=1.2)

    g2, got = chain(tbm, tps, tsnappy, tlayers)
    r2, ref = chain(jbm, jps, jsnappy, jlayers)
    assert_same_poly(g2, r2, "snapped")
    assert_same_poly(got, ref, "layered")
    assert got.n_cells == g2.n_cells + 2 * g2.patch("body").size
    assert np.array_equal(np.asarray(got.v), np.asarray(ref.v))


@pytest.mark.parametrize("fmt", ["ascii", "binary"])
def test_stl_round_trip_matches_reference(tmp_path, fmt):
    from foamtpu.mesh import snappy as jsnappy

    tris = chip_smoke.sphere_tris((0.5, 0.5, 0.5), 0.25, 4, 8)
    path = str(tmp_path / f"s_{fmt}.stl")
    if fmt == "ascii":
        tsnappy.write_stl(path, tris, name="sphere")
        with open(path) as f:
            assert f.readline().startswith("solid sphere")
    else:
        with open(path, "wb") as f:
            f.write(b"binary sphere".ljust(80, b" "))
            f.write(struct.pack("<I", tris.shape[0]))
            for t in tris:
                f.write(struct.pack("<12fH", 0.0, 0.0, 0.0,
                                    *t.reshape(-1), 0))
    got, ref = tsnappy.read_stl(path), jsnappy.read_stl(path)
    assert got.shape == ref.shape == tris.shape
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert np.allclose(got, tris, atol=1e-6)


F64_BODY = r"""
import contextlib, dataclasses, io, json, os, re, shutil, sys, tempfile
import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke
from foamtpu.apps.cli import main as jcli
from foamtpu.core.case import run_case as jrun
from foamtpu.io import polymesh as jpolymesh
from foamtpu.mesh import to_device as jto_device
from foamtpu.solvers.linear import gamg as jgamg

from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.io import polymesh as tpolymesh
from foamtpu_torch.mesh import to_device
from foamtpu_torch.mesh.core import ARRAY_FIELDS
from foamtpu_torch.solvers import apps as tapps
from foamtpu_torch.solvers.linear import gamg

root = tempfile.mkdtemp()
src = chip_smoke.slice12_case(os.getcwd(), os.path.join(root, "src"),
                              "bluffBody", jcli, seed=12,
                              write_precision=17)
mdir = os.path.join(src, "constant", "polyMesh")
ref = jto_device(jpolymesh.read(mdir))
got = to_device(tpolymesh.read(mdir), "cpu")


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
       "n_remainder": int(got.fb_cells.shape[0]),
       "meta": {n: [getattr(got, n), getattr(ref, n)]
                for n in ("n_cells", "n_faces", "n_internal_faces",
                          "max_faces", "orthogonal", "has_ami")}}
for name in ARRAY_FIELDS:
    out["arrays"][name] = compare(getattr(got, name), getattr(ref, name))
levels = []
g_levels, r_levels = gamg.hierarchy_for_mesh(got), jgamg.hierarchy_for_mesh(ref)
for g, r in zip(g_levels, r_levels):
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
out["n_levels"] = [len(g_levels), len(r_levels)]

# 3 SIMPLE iterations, one per log line, through both packages' run(case)
os.environ["FOAMTPU_CHUNK"] = "1"
SOLVE = re.compile(r"Solving for (\w+), Initial residual = (\S+), "
                   r"Final residual = (\S+), No Iterations (\d+)")
runs = {}
for tag in ("port", "ref"):
    d = os.path.join(root, tag)
    shutil.copytree(src, d)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if tag == "port":
            c = tapps.run(TCase(d, device="cpu"), max_steps=3)
        else:
            c = jrun(d, max_steps=3)
    fs = c.final_state
    a = {k: fs[k] for k in ("U", "p", "phi")}
    a.update({k: fs["turb"][k] for k in ("k", "epsilon", "nut")})
    a = {k: getattr(v, "data", v) for k, v in a.items()}
    runs[tag] = ({k: np.asarray(v.numpy() if torch.is_tensor(v) else v,
                                np.float64) for k, v in a.items()},
                 SOLVE.findall(buf.getvalue()), c.time.index)
(ga, gs, gi), (ra, rs, ri) = runs["port"], runs["ref"]
out["simple"] = {
    "iterations": [gi, ri],
    "errs": {k: float(np.abs(ga[k] - ra[k]).max()
                      / max(np.abs(ra[k]).max(), 1e-300)) for k in ra},
    "solves": [[(n, int(i)) for n, _, _, i in gs],
               [(n, int(i)) for n, _, _, i in rs]],
    "residuals": [[(float(a), float(b)) for _, a, b, _ in gs],
                  [(float(a), float(b)) for _, a, b, _ in rs]]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def f64_run():
    env = dict(os.environ)
    env.update(FOAMTPU_X64="1", JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", F64_BODY], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _held(name, rec):
    assert rec.get("shape_ok", True), (name, rec)
    if "dtype" in rec:
        assert rec["dtype"][0][:3] == rec["dtype"][1][:3], (name, rec)
    if "ulp" in rec:
        assert rec["dtype"][0] == "float64", (name, rec)
        assert rec["ulp"] == 0.0, (name, rec)
    else:
        assert rec["equal"], (name, rec)


def test_snapped_fvmesh_matches_reference(f64_run):
    assert f64_run["n_cells"] == 7322
    for name, (g, r) in f64_run["meta"].items():
        assert g == r, name
    assert f64_run["st_deltas"][0] == f64_run["st_deltas"][1]
    assert len(f64_run["st_deltas"][0]) == 8
    assert f64_run["n_remainder"] == 3922
    for name, rec in f64_run["arrays"].items():
        _held(name, rec)


def test_snapped_gamg_hierarchy_matches_reference(f64_run):
    n_got, n_ref = f64_run["n_levels"]
    assert n_got == n_ref >= 2
    for i, rec in enumerate(f64_run["levels"]):
        for name, r in rec.items():
            _held(f"level {i} {name}", r)


def test_bluffbody_simple_matches_reference_f64(f64_run):
    rec = f64_run["simple"]
    assert rec["iterations"] == [3, 3]
    for k, e in rec["errs"].items():
        assert e <= 1e-9, (k, e)
    got, ref = rec["solves"]
    assert got == ref and len(got) >= 3 * 4, (got, ref)
    assert np.allclose(rec["residuals"][0], rec["residuals"][1],
                       rtol=1e-6, atol=1e-12)


# -- the goldens of chip_smoke.py's snappy_cht phase -------------------------

def reference_slice12(names=None, perturb=0.0):
    """The golden scalars (chip_smoke.slice12_scalars, and the body force
    Fx of bluffBody and openTerrain) of chip_smoke.SLICE12_RUNS from the
    JAX package's applications on the CPU at the runs' depths (meshed by
    its CLI), in the precision the environment gives it (float32;
    FOAMTPU_X64=1 JAX_ENABLE_X64=1 for float64). `perturb` multiplies the
    start U (simpleFoam) or T (the cht regions) cell by cell by
    1 + perturb u, u from a numpy seed: a float32 run with perturb 1e-7
    gives the runs' sensitivity to round-off."""
    import tempfile

    from foamtpu.apps.cli import main as jcli
    from foamtpu.core.case import Case as JCase
    from foamtpu.core.case import run_case as jrun

    out = {}
    root = tempfile.mkdtemp()
    for name, (tut, steps) in chip_smoke.SLICE12_RUNS.items():
        if names is not None and name not in names:
            continue
        with contextlib.redirect_stdout(io.StringIO()):
            d = chip_smoke.slice12_case(REPO, os.path.join(root, name), tut,
                                        jcli)
        cht = name in chip_smoke.CHT_APPS
        if perturb:
            rng = np.random.default_rng(21)
            for r in (chip_smoke.CHT_REGIONS if cht else ("",)):
                jc = JCase(d, region=r)
                f = "T" if cht else "U"
                x = np.asarray(jc.read_field(f).data, np.float64)
                u = rng.random(x.shape[0])
                chip_smoke.set_internal(d, os.path.join(r, f), x * (
                    1.0 + perturb * (u if x.ndim == 1 else u[:, None])))
        with contextlib.redirect_stdout(io.StringIO()):
            jc = jrun(d, max_steps=steps)
        fs = jc.final_state
        if cht:
            v = {r: np.asarray(fs[r]["mesh"].v, np.float64)
                 for r in chip_smoke.CHT_REGIONS}
        else:
            v = np.asarray(jc.mesh.v, np.float64)
        out[name] = chip_smoke.slice12_scalars(name, fs, v, np.asarray)
        if not cht:
            _, fp, fv = chip_smoke.body_force(d)
            out[name]["Fx"] = fp[0] + fv[0]
    return out


if __name__ == "__main__":
    # python tests/test_torch_snappy.py goldens [--perturb]
    import pprint

    if len(sys.argv) > 1 and sys.argv[1] == "goldens":
        pprint.pprint(reference_slice12(
            perturb=1e-7 if "--perturb" in sys.argv else 0.0))
