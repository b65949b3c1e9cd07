"""Corrected non-orthogonal PISO and PIMPLE in the port, held to the JAX
package on chip_smoke.py's mesh chain at a small size: the icoFoam
cavity at 1 m, its left half at 16 x 32, its top half refined by
refineMesh and mirrored by mirrorMesh (2,560 cells, hanging faces along
y = 0.5 m), under `Gauss linear corrected` with one non-orthogonal
corrector and the shipped PCG p controls.

The chain runs through each package's commands (blockMesh, topoSet,
refineMesh, mirrorMesh, changeDictionary, checkMesh); then icoFoam and
pimpleFoam (two outer correctors) take 3 steps in each package's
run_case, in one float64 process (FOAMTPU_X64=1 JAX_ENABLE_X64=1): U, p
and phi at 1e-9 of their largest values, the logged solver iteration
counts equal. The same icoFoam run with the orthogonal laplacian shows
the correction is live: its p differs from the corrected one's by more
than 100 times that tolerance.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-9

BODY = r'''
import contextlib, io, json, os, re, sys, tempfile
import numpy as np
import torch

import chip_smoke as cs
from foamtpu.apps.cli import main as jmain
from foamtpu.core.case import run_case as jrun_case
from foamtpu_torch.apps.cli import main as tmain
from foamtpu_torch.core.case import run_case as trun_case
from foamtpu_torch.io import polymesh as mesh_io
from foamtpu_torch.ops import slot

REPO = os.getcwd()
TMP = tempfile.mkdtemp()
ITERS = re.compile(r"Solving for (\w+),.*No Iterations (\d+)")
OUT = {}
CALLS = {"n": 0}
correction = slot.laplacian_correction


def counted(*args, **kw):
    CALLS["n"] += 1
    return correction(*args, **kw)


slot.laplacian_correction = counted


def chain(pkg, name):
    d = cs.mesh_chain_case(REPO, os.path.join(TMP, pkg, name), (16, 32),
                           gamg=False)
    main = jmain if pkg == "j" else tmain
    with contextlib.redirect_stdout(io.StringIO()):
        for argv in cs.MESH_CHAIN_CMDS:
            assert main(argv + ["-case", d]) == 0, argv
    return d


def pimple(d):
    cs._edit(os.path.join(d, "system", "controlDict"),
             r"application\s+icoFoam;", "application     pimpleFoam;")
    with open(os.path.join(d, "system", "fvSolution"), "a") as f:
        f.write("\nPIMPLE { nOuterCorrectors 2; nCorrectors 2; "
                "nNonOrthogonalCorrectors 1; pRefCell 0; pRefValue 0; }\n")


def orthogonal(d):
    schemes = os.path.join(d, "system", "fvSchemes")
    cs._edit(schemes, r"Gauss linear corrected;", "Gauss linear orthogonal;")
    cs._edit(schemes, r"(snGradSchemes\s*\{\s*default\s+)corrected;",
             r"\1orthogonal;")


def run(pkg, d):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if pkg == "j":
            c = jrun_case(d, max_steps=3)
            st = {k: np.asarray(c.final_state[k] if k == "phi" else
                                c.final_state[k].data, dtype=float)
                  for k in ("U", "p", "phi")}
        else:
            c = trun_case(d, max_steps=3, device="cpu")
            st = {k: (c.final_state[k] if k == "phi" else
                      c.final_state[k].data).double().numpy()
                  for k in ("U", "p", "phi")}
    return st, [(f, int(n)) for f, n in ITERS.findall(buf.getvalue())]


jd, td = chain("j", "piso"), chain("t", "piso")
pj = mesh_io.read(os.path.join(jd, "constant", "polyMesh"))
pt = mesh_io.read(os.path.join(td, "constant", "polyMesh"))
OUT["mesh"] = {
    "equal": all(np.array_equal(getattr(pj, k), getattr(pt, k))
                 for k in ("points", "face_pts", "face_npts", "owner",
                           "neighbour")),
    "n_cells": pt.n_cells, "volume": float(pt.v.sum())}
for app, edit in (("icoFoam", None), ("pimpleFoam", pimple)):
    dirs = {"j": jd, "t": td}
    if edit:
        dirs = {pkg: chain(pkg, app) for pkg in "jt"}
        for d in dirs.values():
            edit(d)
    (sj, ij) = run("j", dirs["j"])
    CALLS["n"] = 0
    (st, it) = run("t", dirs["t"])
    OUT[app] = {"err": {k: float(np.abs(sj[k] - st[k]).max()
                                 / np.abs(sj[k]).max()) for k in sj},
                "iters": [ij, it], "corrections": CALLS["n"],
                "finite": all(bool(np.isfinite(v).all())
                              for v in st.values())}
    if app == "icoFoam":
        p_corr = st["p"]
do = chain("t", "orthogonal")
orthogonal(do)
CALLS["n"] = 0
so, _ = run("t", do)
OUT["orthogonal"] = {"p_rel": float(np.abs(so["p"] - p_corr).max()
                                    / np.abs(p_corr).max()),
                     "corrections": CALLS["n"]}
print(json.dumps(OUT))
'''


@pytest.fixture(scope="module")
def rec():
    env = dict(os.environ)
    env.update(FOAMTPU_X64="1", JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([REPO, env.get("PYTHONPATH",
                                                         "")]))
    r = subprocess.run([sys.executable, "-c", BODY], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_mesh_chain_matches_reference(rec):
    """blockMesh, topoSet, refineMesh, mirrorMesh in the port write the
    JAX package's polyMesh bit for bit: 16 x 32 -> 2,560 cells."""
    r = rec["mesh"]
    assert r["equal"] and r["n_cells"] == 2560, r
    assert abs(r["volume"] - 0.1) <= 1e-14, r


@pytest.mark.parametrize("app", ["icoFoam", "pimpleFoam"])
def test_corrected_run_matches_reference(rec, app):
    r = rec[app]
    assert r["finite"], r
    for k, e in r["err"].items():
        assert e <= TOL, (app, k, r)
    j, t = r["iters"]
    assert j == t and any(f == "p" for f, _ in t), r
    # one correction a non-orthogonal pass: 2 correctors x 2 passes a
    # step (x 2 outer correctors in PIMPLE) over 3 steps
    assert r["corrections"] == 3 * 2 * 2 * (2 if app == "pimpleFoam"
                                            else 1), r


def test_correction_is_live(rec):
    r = rec["orthogonal"]
    assert r["corrections"] == 0, r
    assert r["p_rel"] > 100 * TOL, r


# -- the goldens of chip_smoke.py's mesh_utilities phase ----------------------


def reference_mesh_chain(perturb=False, blocks=None, delta_t=None,
                         orthogonal=False):
    """chip_smoke.py's mesh chain through `python -m foamtpu` on the CPU
    at chip_smoke.MESH_CHAIN_HEAD (or `blocks`), then MESH_CHAIN_STEPS
    icoFoam steps in the JAX package's run_case, in the precision the
    environment gives it (float32; FOAMTPU_X64=1 JAX_ENABLE_X64=1 for
    float64); `perturb` starts from chip_smoke.perturb_case's start,
    `delta_t` replaces chip_smoke.MESH_CHAIN_DT, `orthogonal` the
    corrected schemes. Its checkMesh statistics (mesh_chain_check) and
    flow scalars (mesh_chain_scalars)."""
    import contextlib
    import io
    import tempfile

    import numpy as np

    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from foamtpu.core.case import run_case as jrun

    root = tempfile.mkdtemp()
    d = cs.mesh_chain_case(REPO, os.path.join(root, "chain"),
                           blocks or cs.MESH_CHAIN_HEAD)
    if delta_t:
        cs._edit(os.path.join(d, "system", "controlDict"),
                 r"deltaT\s+[^;]+;", f"deltaT {delta_t};")
    if orthogonal:
        cs._edit(os.path.join(d, "system", "fvSchemes"), r"\bcorrected;",
                 "orthogonal;")
    out = {}
    for argv in cs.MESH_CHAIN_CMDS:
        r = subprocess.run([sys.executable, "-m", "foamtpu", *argv, "-case",
                            d], cwd=REPO, capture_output=True, text=True,
                           check=True)
        if argv[0] == "checkMesh":
            out["mesh"] = cs.mesh_chain_check(r.stdout)
    if perturb:
        cs.perturb_case(d, cs.SLICE16_SEED)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        c = jrun(d, max_steps=cs.MESH_CHAIN_STEPS)
    st = c.final_state
    out["flow"] = cs.mesh_chain_scalars(
        np.asarray(st["U"].data, float), np.asarray(st["p"].data, float),
        np.asarray(c.mesh.v, float))
    out["flow"]["continuity"] = cs.last_continuity(buf.getvalue())
    return out


if __name__ == "__main__":
    # python tests/test_torch_piso_nonorth.py goldens [--perturb]
    # [--delta-t DT] [--orthogonal]: the JSON of reference_mesh_chain (the
    # environment sets float32 or float64);
    # ... spread f32.json f64.json perturbed.json: the largest difference
    # of each flow scalar from the float32 run's
    if sys.argv[1] == "goldens":
        dt = (sys.argv[sys.argv.index("--delta-t") + 1]
              if "--delta-t" in sys.argv else None)
        print(json.dumps(reference_mesh_chain(
            "--perturb" in sys.argv, delta_t=dt,
            orthogonal="--orthogonal" in sys.argv)))
    elif sys.argv[1] == "spread":
        runs = []
        for path in sys.argv[2:]:
            with open(path) as f:
                runs.append(json.load(f)["flow"])
        print(json.dumps({k: max(abs(r[k] - runs[0][k]) for r in runs[1:])
                          for k in runs[0]}))
