"""The solver-side utilities of the port, held to the JAX package:
apps/postutils.py (its 22 commands), apps/cli.py's checkMesh,
renumberMesh, transformPoints, foamListTimes, mapFields, patchAverage,
foamCalc, writeCellCentres, writeCellVolumes, postProcess /
execFlowFunctionObjects, sample and foamToVTK, and the modules behind
them: mesh/{check,renumber,wave}.py, io/vtk.py, utils/foamlog.py,
ops/fvc.py::curl and functionobjects/field.py's vorticity and
q_criterion.

These are the port's twins of tests/test_postutils.py,
tests/test_wave.py, tests/test_renumber.py, tests/test_utilities.py's
foamLog, vorticity/Q, new-utilities and postProcess tests and the
checkMesh and sample parts of tests/test_utilities2.py. Each command
runs in both packages, through each one's `main`, on twin copies of
the same case (the icoFoam cavity at 16x16 after 4 steps, cavityRAS and
heatedDuct at their start, an engine tutorial), in order, and every
file the two runs leave is compared: a host copy's bit for bit, a device
field's with its numbers in float64 at 1e-12 of the file's largest
(the text between the numbers identical, the banner line apart); their
printed lines likewise. It all runs in one float64 process
(FOAMTPU_X64=1 JAX_ENABLE_X64=1), and each test reads its record.
"""

import json
import os
import subprocess
import sys

import pytest

from foamtpu_torch.apps import cli as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BODY = r'''
import contextlib, io, json, os, re, shutil, sys, tempfile
import numpy as np
import torch
import jax.numpy as jnp

from foamtpu.apps.cli import main as jmain
from foamtpu.core.case import run_case as jrun_case
from foamtpu_torch.apps.cli import main as tmain

REPO = os.getcwd()
TMP = tempfile.mkdtemp()
NUM = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")
OUT = {}


def quiet(fn, argv):
    """(return code, or the name of the exception raised; stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            rc = fn(argv)
        except Exception as e:
            rc = type(e).__name__
    return rc, buf.getvalue()


def edit(path, a, b):
    with open(path) as f:
        text = f.read()
    assert a in text, (path, a)
    with open(path, "w") as f:
        f.write(text.replace(a, b))


def numbers(text):
    """(the text with every number replaced by '#', the numbers), the
    banner lines of the writers (which name their package) dropped."""
    lines = [ln for ln in text.splitlines()
             if not (ln.startswith("|") and "Version" in ln)]
    text = "\n".join(lines)
    return NUM.sub("#", text), np.array(
        [float(x) for x in NUM.findall(text)], dtype=float)


def close_text(a, b):
    """0 when equal as bytes; else the numbers' largest difference over
    the largest number (inf when the text between them differs)."""
    if a == b:
        return 0.0
    sa, na = numbers(a)
    sb, nb = numbers(b)
    if sa != sb or na.shape != nb.shape:
        return float("inf")
    scale = max(float(np.abs(na).max(initial=0.0)), 1e-300)
    return float(np.abs(na - nb).max(initial=0.0) / scale)


def tree(d):
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = fh.read()
    return out


def twins(name, src):
    jd, td = os.path.join(TMP, "j", name), os.path.join(TMP, "t", name)
    shutil.copytree(src, jd)
    shutil.copytree(src, td)
    return jd, td


def compare_trees(jd, td):
    """Per file: 0.0 bit for bit, else close_text's error; a file in one
    tree only is inf."""
    a, b = tree(jd), tree(td)
    out = {}
    for rel in sorted(set(a) | set(b)):
        if rel not in a or rel not in b:
            out[rel] = float("inf")
        elif a[rel] == b[rel]:
            out[rel] = 0.0
        else:
            try:
                out[rel] = close_text(a[rel].decode(), b[rel].decode())
            except UnicodeDecodeError:
                out[rel] = float("inf")
    return out


def both(group, jd, td, argv, device=True, label=None):
    """One command in both packages on the twin case dirs."""
    targs = argv + (["-device", "cpu"] if device else [])
    jrc, jout = quiet(jmain, [a.replace("@", jd) for a in argv])
    trc, tout = quiet(tmain, [a.replace("@", td) for a in targs])
    jout, tout = jout.replace(jd, "@"), tout.replace(td, "@")
    OUT.setdefault(group, {})[label or argv[0]] = {
        "rc": [jrc, trc], "stdout": close_text(jout, tout),
        "lines": len(tout.splitlines())}


# ---- the cavity at 16x16 after 4 icoFoam steps -----------------------------
base = os.path.join(TMP, "cavity")
shutil.copytree(os.path.join(
    REPO, "tutorials/incompressible/icoFoam/cavity"), base)
edit(os.path.join(base, "constant/polyMesh/blockMeshDict"), "(20 20 1)",
     "(16 16 1)")
edit(os.path.join(base, "system/controlDict"), "writeInterval   20;",
     "writeInterval   2;")
quiet(jmain, ["blockMesh", "-case", base])
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    jrun_case(base, max_steps=4)
LOG = buf.getvalue()
with open(os.path.join(base, "system/controlDict"), "a") as f:
    f.write("\nfunctions { minmax { type fieldMinMax; fields (U p); } }\n")
with open(os.path.join(base, "system/probesDict"), "w") as f:
    f.write("FoamFile { version 2.0; format ascii; class dictionary; "
            "object probesDict; }\nfields ( p U );\n"
            "probeLocations ( (0.05 0.05 0.005) (0.013 0.091 0.005) );\n")
with open(os.path.join(base, "system/sampleDict"), "w") as f:
    f.write("FoamFile { version 2.0; format ascii; class dictionary; "
            "object sampleDict; }\nfields (U p);\nsets\n(\n"
            "    centreline { type uniform; axis distance;\n"
            "                 start (0.005 0.05 0.005); "
            "end (0.095 0.05 0.005);\n                 nPoints 20; }\n);\n")
jd, td = twins("cavity", base)
for argv, dev in (
        (["checkMesh", "-case", "@"], False),
        (["foamListTimes", "-case", "@"], False),
        (["vorticity", "-case", "@"], True),
        (["enstrophy", "-case", "@"], True),
        (["Q", "-case", "@"], True),
        (["Lambda2", "-case", "@"], True),
        (["flowType", "-case", "@"], True),
        (["Co", "-case", "@"], True),
        (["Pe", "-case", "@"], True),
        (["ptot", "-case", "@"], True),
        (["wallGradU", "-case", "@"], True),
        (["yPlusRAS", "-case", "@"], True),
        (["stressComponents", "-case", "@"], True),
        (["patchIntegrate", "p", "movingWall", "-case", "@"], True),
        (["patchIntegrate", "U", "fixedWalls", "-case", "@"], True),
        (["wallShearStress", "-case", "@"], True),
        (["pdfPlot", "p", "-case", "@"], True),
        (["probeLocations", "-case", "@"], True),
        (["foamCalc", "mag", "U", "-case", "@"], True),
        (["foamCalc", "components", "U", "-case", "@"], True),
        (["patchAverage", "p", "movingWall", "-case", "@"], True),
        (["writeCellCentres", "-case", "@"], True),
        (["writeCellVolumes", "-case", "@"], True),
        (["postProcess", "-case", "@"], True),
        (["execFlowFunctionObjects", "-case", "@", "-time", "0.01"], True),
        (["sample", "-case", "@"], True),
        (["foamToVTK", "-case", "@"], True),
        (["foamToVTK", "-case", "@", "-time", "0.01"], True),
        (["applyBoundaryLayer", "-ybl", "0.02", "-case", "@"], True)):
    label = " ".join(a for a in argv if a not in ("-case", "@"))
    both("cavity", jd, td, argv, dev, label)
# mapFields onto a 32x32 cavity
fine = os.path.join(TMP, "fine")
shutil.copytree(os.path.join(
    REPO, "tutorials/incompressible/icoFoam/cavity"), fine)
edit(os.path.join(fine, "constant/polyMesh/blockMeshDict"), "(20 20 1)",
     "(32 32 1)")
quiet(jmain, ["blockMesh", "-case", fine])
jf, tf = twins("fine", fine)
t_src = "0.02"
OUT["cavity"]["mapFields"] = None
jrc, jout = quiet(jmain, ["mapFields", jd, "-case", jf,
                          "-sourceTime", t_src])
trc, tout = quiet(tmain, ["mapFields", td, "-case", tf, "-sourceTime",
                          t_src, "-device", "cpu"])
OUT["cavity"]["mapFields"] = {
    "rc": [jrc, trc], "lines": 1,
    "stdout": close_text(jout.replace(jd, "@").replace(jf, "@@"),
                         tout.replace(td, "@").replace(tf, "@@"))}
OUT["cavity_files"] = compare_trees(jd, td)
OUT["fine_files"] = compare_trees(jf, tf)
# the mesh utilities last: they rewrite constant/polyMesh
jm, tm = twins("mesh", base)
both("mesh", jm, tm, ["renumberMesh", "-case", "@"], False)
both("mesh", jm, tm, ["checkMesh", "-case", "@"], False)
both("mesh", jm, tm, ["transformPoints", "-case", "@", "-translate",
                      "(1 0 0)", "-scale", "(2 1 1)", "-rollPitchYaw",
                      "(0 0 30)"], False)
both("mesh", jm, tm, ["checkMesh", "-case", "@"], False, "checkMesh moved")
OUT["mesh_files"] = compare_trees(jm, tm)

# ---- cavityRAS, heatedDuct and an engine at their start --------------------
ras = os.path.join(TMP, "ras")
shutil.copytree(os.path.join(
    REPO, "tutorials/incompressible/pisoFoam/cavityRAS"), ras)
quiet(jmain, ["blockMesh", "-case", ras])
jr, tr = twins("ras", ras)
for argv in (["uprime"], ["R"], ["yPlusLES"], ["wallShearStress"], ["Pe"],
             ["wallGradU"],
             ["applyBoundaryLayer", "-ybl", "0.03"]):
    both("ras", jr, tr, argv + ["-case", "@", "-time", "0"], True,
         " ".join(argv))
OUT["ras_files"] = compare_trees(jr, tr)
duct = os.path.join(TMP, "duct")
shutil.copytree(os.path.join(
    REPO, "tutorials/compressible/rhoPimpleFoam/heatedDuct"), duct)
quiet(jmain, ["blockMesh", "-case", duct])
jh, th = twins("duct", duct)
for argv in (["Mach"], ["wallHeatFlux"], ["ptot"]):
    both("duct", jh, th, argv + ["-case", "@", "-time", "0"], True,
         argv[0])
OUT["duct_files"] = compare_trees(jh, th)
je, te = twins("engine", os.path.join(
    REPO, "tutorials/combustion/coldEngineFoam/compression"))
both("engine", je, te, ["engineCompRatio", "-case", "@"], True)

# ---- foamLog on the cavity's log -------------------------------------------
from foamtpu.utils import foamlog as jlog
from foamtpu_torch.utils import foamlog as tlog

for pkg, d in (("j", jd), ("t", td)):
    with open(os.path.join(d, "log.icoFoam"), "w") as f:
        f.write(LOG)
jlog.write_logs(os.path.join(jd, "log.icoFoam"))
tlog.write_logs(os.path.join(td, "log.icoFoam"))
OUT["foamlog"] = {"series_equal": jlog.parse(LOG) == tlog.parse(LOG),
                  "n_series": len(tlog.parse(LOG)),
                  "files": {k: v for k, v in compare_trees(
                      os.path.join(jd, "logs"),
                      os.path.join(td, "logs")).items()}}

# ---- meshWave, renumbering, vorticity / Q ----------------------------------
from foamtpu.core.dictionary import parse_string as jparse
from foamtpu.mesh import blockmesh as jbm, renumber as jrn, to_device as jdev
from foamtpu.mesh import wave as jwave, walldist as jwd
from foamtpu.mesh.check import check as jcheck
from foamtpu.functionobjects.field import (q_criterion as jq,
                                           vorticity as jvort)
from foamtpu.core.fields import vol_vector as jvv
from foamtpu_torch import convert
from foamtpu_torch.core.dictionary import parse_string as tparse
from foamtpu_torch.core.fields import vol_vector as tvv
from foamtpu_torch.functionobjects.field import (q_criterion as tq,
                                                 vorticity as tvort)
from foamtpu_torch.mesh import blockmesh as tbm, renumber as trn
from foamtpu_torch.mesh import to_device as tdev, wave as twave
from foamtpu_torch.mesh.check import check as tcheck
from foamtpu_torch.ops import fvc as tfvc

CAVITY = """
convertToMeters 0.1;
vertices
(
    (0 0 0) (1 0 0) (1 1 0) (0 1 0)
    (0 0 0.1) (1 0 0.1) (1 1 0.1) (0 1 0.1)
);
blocks ( hex (0 1 2 3 4 5 6 7) (NX NY 1) simpleGrading (1 1 1) );
boundary
(
    movingWall { type wall; faces ((3 7 6 2)); }
    fixedWalls { type wall; faces ((0 4 7 3) (2 6 5 1) (1 5 4 0)); }
    frontAndBack { type empty; faces ((0 3 2 1) (4 5 6 7)); }
);
"""


def rel(a, b):
    a = np.asarray(a, dtype=float)
    b = b.detach().cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    scale = max(float(np.abs(a).max(initial=0.0)), 1e-300)
    return float(np.abs(a - b).max(initial=0.0) / scale)


def poly(n, m=None, pkg="t"):
    src = CAVITY.replace("NX", str(n)).replace("NY", str(m or n))
    return (tbm.generate(tparse(src)) if pkg == "t"
            else jbm.generate(jparse(src)))


wave = {}
for lbl, n, m in (("cavity", 20, 20), ("graded", 24, 9)):
    jpm, tpm = poly(n, m, "j"), poly(n, m, "t")
    jmesh, tmesh = jdev(jpm), tdev(tpm, "cpu")
    yj = np.asarray(jwave.wall_distance(jmesh))
    yt = twave.wall_distance(tmesh)
    _, _, itj = jwave.cell_wave(
        jmesh, jnp.asarray(np.where(np.arange(tmesh.n_cells) == 0, 0.0,
                                    np.inf)),
        jnp.asarray(np.asarray(jmesh.c) * (np.arange(tmesh.n_cells)
                                           == 0)[:, None]))
    _, _, itt = twave.cell_wave(
        tmesh, torch.tensor(np.where(np.arange(tmesh.n_cells) == 0, 0.0,
                                     np.inf)),
        tmesh.c * (torch.arange(tmesh.n_cells) == 0)[:, None])
    c = tmesh.c.numpy()
    lx, ly = 0.1, 0.1
    exact = np.minimum.reduce([c[:, 0], lx - c[:, 0], c[:, 1],
                               ly - c[:, 1]])
    interior = (c[:, 0] > 0.02) & (c[:, 0] < 0.08)
    wave[lbl] = {"err": rel(yj, yt), "sweeps": [int(itj), int(itt)],
                 "vs_exact": float(np.max(np.abs(yt.numpy() - exact))),
                 "interior": float(np.max(np.abs(yt.numpy()[interior]
                                                 - exact[interior]))),
                 "vs_kdtree": float(np.max(np.abs(
                     yt.numpy() - jwd.wall_distance(jpm)))),
                 "dx": 0.1 / n}
OUT["wave"] = wave

ren = {}
for seed in (3, 4):
    jpm, tpm = poly(12, pkg="j"), poly(12, pkg="t")
    perm = np.random.default_rng(seed).permutation(tpm.n_cells)
    js, ts = jrn.apply_ordering(jpm, perm), trn.apply_ordering(tpm, perm)
    jfix, jorder = jrn.renumber(js)
    tfix, torder = trn.renumber(ts)
    same = all(np.array_equal(getattr(jfix, k), getattr(tfix, k))
               for k in ("owner", "neighbour", "face_pts", "face_npts",
                         "points"))
    ns, nf = tdev(ts, "cpu"), tdev(tfix, "cpu")
    nif = tpm.n_internal_faces
    s0, s1 = jcheck(jpm), tcheck(tfix)
    ren[str(seed)] = {
        "order_equal": bool(np.array_equal(jorder, torder)),
        "mesh_equal": bool(same),
        "bandwidth": [jrn.bandwidth(js), trn.bandwidth(ts),
                      jrn.bandwidth(jfix), trn.bandwidth(tfix)],
        "frac": [ns.fb_cells.shape[0] / (2 * nif),
                 nf.fb_cells.shape[0] / (2 * nif),
                 tdev(tpm, "cpu").fb_cells.shape[0] / (2 * nif)],
        "volume": [s0["totalVolume"], s1["totalVolume"]],
        "nif": [s0["nInternalFaces"], s1["nInternalFaces"]],
        "check_equal": jcheck(js) == tcheck(ts)}
OUT["renumber"] = ren

jmesh, tmesh = jdev(poly(8, pkg="j")), tdev(poly(8), "cpu")
c = tmesh.c.numpy() - np.array([0.05, 0.05, 0.005])
u = np.stack([-c[:, 1], c[:, 0], 0.3 * c[:, 0] * c[:, 1]], 1)
ju = jvv(jmesh, jnp.zeros(3)).with_data(jnp.asarray(u))
tu = tvv(tmesh, torch.zeros(3, dtype=torch.float64)).with_data(
    torch.tensor(u))
interior = (np.abs(c[:, 0]) < 0.03) & (np.abs(c[:, 1]) < 0.03)
w = tvort(tmesh, tu)
OUT["vorticity"] = {
    "vort": rel(jvort(jmesh, ju), w), "q": rel(jq(jmesh, ju), tq(tmesh, tu)),
    "curl": rel(jvort(jmesh, ju), tfvc.curl(tmesh, tu)),
    "wz_interior": float(np.max(np.abs(w.numpy()[interior, 2] - 2.0))),
    "q_interior_min": float(tq(tmesh, tu).numpy()[interior].min())}
print(json.dumps(OUT))
'''


@pytest.fixture(scope="module")
def rec():
    env = dict(os.environ)
    env.update(FOAMTPU_X64="1", JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", BODY], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


# wallHeatFlux indexes its per-cell conductivity, which a constant-Cp
# thermo (the shipped heatedDuct's hConst) gives as one number: both
# packages raise there (ROADMAP Queue 3)
RAISES = {"wallHeatFlux": "IndexError"}


def _held(cmds, files):
    for name, r in cmds.items():
        want = RAISES.get(name, 0)
        assert r["rc"] == [want, want], (name, r)
        assert r["stdout"] <= 1e-12, (name, r)
    bad = {k: v for k, v in files.items() if v > 1e-12}
    assert not bad, bad


CAVITY_COMMANDS = (
    "checkMesh", "foamListTimes", "vorticity", "enstrophy", "Q", "Lambda2",
    "flowType", "Co", "Pe", "ptot", "wallGradU", "yPlusRAS",
    "stressComponents", "patchIntegrate p movingWall",
    "patchIntegrate U fixedWalls", "wallShearStress", "pdfPlot p",
    "probeLocations", "foamCalc mag U", "foamCalc components U",
    "patchAverage p movingWall", "writeCellCentres", "writeCellVolumes",
    "postProcess", "execFlowFunctionObjects -time 0.01", "sample",
    "foamToVTK", "foamToVTK -time 0.01", "applyBoundaryLayer -ybl 0.02",
    "mapFields")


@pytest.mark.parametrize("name", CAVITY_COMMANDS)
def test_cavity_command_matches_reference(rec, name):
    r = rec["cavity"][name]
    assert r["rc"] == [0, 0], r
    assert r["stdout"] <= 1e-12, r


def test_cavity_files_match_reference(rec):
    files = rec["cavity_files"]
    # every command left its file in both packages' case
    t = "0.02"
    for rel in (f"{t}/vorticity", f"{t}/enstrophy", f"{t}/Q",
                f"{t}/Lambda2", f"{t}/flowType", f"{t}/Co", f"{t}/Pe",
                f"{t}/ptot", f"{t}/wallGradU", f"{t}/yPlus",
                f"{t}/sigmaxy", f"{t}/sigmazz", f"{t}/wallShearStress",
                f"postProcessing/pdfPlot/{t}/p.xy", f"{t}/mag(U)",
                f"{t}/Ux", f"{t}/Uz", "0/ccx", "0/ccz", f"{t}/V",
                "postProcessing/minmax/fieldMinMax.dat",
                f"VTK/cavity_{t}.vtk"):
        assert rel in files, rel
    assert any("centreline" in k and k.endswith(".xy") for k in files)
    _held({}, files)
    # host copies bit for bit (the VTK file of time 0.01 holds the run's
    # own fields only; that of 0.02 holds the device-derived ones too)
    for rel in ("VTK/cavity_0.01.vtk", "0/ccx", "0/ccy",
                "postProcessing/minmax/fieldMinMax.dat"):
        assert files[rel] == 0.0, rel


def test_map_fields_matches_reference(rec):
    files = rec["fine_files"]
    assert "0/U" in files and "0/p" in files
    _held({"mapFields": rec["cavity"]["mapFields"]}, files)


@pytest.mark.parametrize("group", ["mesh", "ras", "duct", "engine"])
def test_other_cases_match_reference(rec, group):
    _held(rec[group], rec.get(f"{group}_files", {}))
    if group == "mesh":
        # renumberMesh, transformPoints: the host copies write the same
        # polyMesh bit for bit
        for name in ("points", "owner", "neighbour", "faces"):
            assert rec["mesh_files"][f"constant/polyMesh/{name}"] == 0.0
    if group == "ras":
        for name in ("Rxx", "Rxy", "Rzz", "uprime", "yPlus", "k",
                     "epsilon", "U"):
            assert f"0/{name}" in rec["ras_files"], name


def test_foamlog_matches_reference(rec):
    r = rec["foamlog"]
    assert r["series_equal"] and r["n_series"] >= 4
    assert r["files"] and all(v == 0.0 for v in r["files"].values())


@pytest.mark.parametrize("case", ["cavity", "graded"])
def test_meshwave_matches_reference_and_distance(rec, case):
    r = rec["wave"][case]
    assert r["err"] <= 1e-12 and r["sweeps"][0] == r["sweeps"][1], r
    # the wave measures to wall-face centres: within half a face width
    # near corners, exact in the interior rows (tests/test_wave.py)
    assert r["vs_exact"] < r["dx"] / 2 + 1e-4, r
    assert r["interior"] < 1e-5, r
    assert r["vs_kdtree"] < 0.006, r


@pytest.mark.parametrize("seed", ["3", "4"])
def test_renumber_matches_reference_bit_for_bit(rec, seed):
    r = rec["renumber"][seed]
    assert r["order_equal"] and r["mesh_equal"] and r["check_equal"], r
    bw = r["bandwidth"]
    assert bw[0] == bw[1] > 50 and bw[2] == bw[3] <= 24, r
    # the stencil coverage improves on the shuffled mesh
    frac_bad, frac_good, frac_native = r["frac"]
    assert frac_good < 0.6 * frac_bad and frac_native < 0.01, r
    assert abs(r["volume"][0] - r["volume"][1]) <= 1e-12 * r["volume"][0]
    assert r["nif"][0] == r["nif"][1]


def test_vorticity_and_q_match_reference(rec):
    r = rec["vorticity"]
    assert r["vort"] <= 1e-12 and r["q"] <= 1e-12 and r["curl"] <= 1e-12
    # rigid rotation: vorticity (0, 0, 2) and Q > 0 inside
    assert r["wz_interior"] < 0.05 and r["q_interior_min"] > 0


def _symmetric_batches(kind):
    """Seeded symmetric [n, 3, 3] float64 batches: random, and with a
    nearly double pair of eigenvalues (split by 1e-16 to 1e-2 of their
    size) in a random frame, or in the x-y plane beside a zero, as the
    2D cavity's S^2 + Omega^2 gives them."""
    import numpy as np

    rng = np.random.default_rng(18)
    n = 4000
    if kind == "random":
        a = rng.standard_normal((n, 3, 3))
        return a + a.transpose(0, 2, 1)
    q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    d = rng.standard_normal((n, 3))
    d[:, 1] = d[:, 0] * (1.0 + 10.0 ** rng.uniform(-16, -2, n))
    if kind == "plane":
        d[:, 2] = 0.0
        t = rng.uniform(0.0, np.pi, n)
        q = np.zeros((n, 3, 3))
        q[:, 0, 0] = q[:, 1, 1] = np.cos(t)
        q[:, 1, 0], q[:, 0, 1] = np.sin(t), -np.sin(t)
        q[:, 2, 2] = 1.0
    a = np.einsum("cij,cj,ckj->cik", q, d, q)
    a[:4] = [np.zeros((3, 3)), 2.0 * np.eye(3), np.diag([3.0, 1.0, 2.0]),
             np.eye(3) + 1e-9 * a[4]]
    return a


@pytest.mark.parametrize("kind", ["random", "pair", "plane"])
def test_eigvalsh3_matches_numpy(kind):
    """postutils.eigvalsh3 (Lambda2's eigenvalues on the device) against
    numpy's eigvalsh, ascending, to 1e-14 of the batch's largest."""
    import numpy as np
    import torch

    from foamtpu_torch.apps.postutils import eigvalsh3

    a = _symmetric_batches(kind)
    ref = np.linalg.eigvalsh(a)
    got = eigvalsh3(torch.tensor(a)).numpy()
    assert np.abs(got - ref).max() <= 1e-14 * np.abs(ref).max()


def test_commands_with_reference_only_are_the_references():
    from foamtpu.apps import cli as jcli

    assert set(tcli.COMMANDS) | set(tcli.REFERENCE_ONLY) == set(
        jcli.COMMANDS)
    assert not set(tcli.COMMANDS) & set(tcli.REFERENCE_ONLY)
    assert len(tcli.COMMANDS) == 75 and "decomposePar" in \
        tcli.REFERENCE_ONLY


@pytest.mark.parametrize("name", tcli.REFERENCE_ONLY)
def test_reference_only_command_raises_naming_itself(name):
    with pytest.raises(NotImplementedError, match=name):
        tcli.main([name, "-case", "."])


def test_new_commands_default_to_the_card():
    """The commands that read fields take `-device`, defaulting to the
    card (core/precision.py::DEFAULT_DEVICE); the ones that work on the
    host's mesh and time directories alone name no device."""
    import inspect

    from foamtpu_torch.apps import postutils
    from foamtpu_torch.io import vtk

    for name in ("foamToVTK", "mapFields", "patchAverage", "foamCalc",
                 "writeCellCentres", "writeCellVolumes", "postProcess",
                 "sample", "foamToEnsight", "foamFormatConvert",
                 "deformedGeom", "postChannel", "temporalInterpolate",
                 "tutorials"):
        src = inspect.getsource(tcli.COMMANDS[name])
        assert "_device(args)" in src, name
    assert "args.device or DEFAULT_DEVICE" in inspect.getsource(tcli._device)
    assert "args.device or DEFAULT_DEVICE" in inspect.getsource(
        postutils._open_case)
    from foamtpu_torch.core.precision import DEFAULT_DEVICE

    assert inspect.signature(vtk.case_to_vtk).parameters[
        "device"].default == DEFAULT_DEVICE
    from foamtpu_torch.apps import meshutils3

    for fn in (meshutils3.foam_format_convert, meshutils3.deformed_geom,
               meshutils3.post_channel, meshutils3.temporal_interpolate):
        assert inspect.signature(fn).parameters[
            "device"].default == DEFAULT_DEVICE, fn.__name__
    for name in ("checkMesh", "renumberMesh", "transformPoints",
                 "foamListTimes", "createPatch", "extrudeMesh",
                 "refineMesh", "changeDictionary", "gmshToFoam",
                 "splitMeshRegions", "mirrorMesh", "subsetMesh",
                 "mergeMeshes", "flattenMesh", "autoPatch",
                 "adiabaticFlameT", "mixtureAdiabaticFlameT",
                 "chemkinToFoam", "surfaceCheck", "surfaceConvert",
                 "objToVTK", "surfaceTransformPoints", "surfaceSubset",
                 "fluentMeshToFoam", "setsToZones", "netgenNeutralToFoam",
                 "writeMeshObj", "foamDebugSwitches", "particleTracks",
                 "setSet", "stitchMesh"):
        assert "device" not in inspect.getsource(tcli.COMMANDS[name]), name


def rcm_duct(nx, ny, nz, iters):
    """bench.py's duct at nx x ny x nz x 6 tets through the port on the
    CPU, as it stands and renumbered by RCM: the bandwidth and the COO
    fraction of each, the GAMG p cycles of each iteration and each
    field's largest difference after `iters` iterations (mapped back
    through the order, relative to its largest value: the numbers behind
    chip_smoke.DUCT_RCM_TOL)."""
    import time

    import torch

    import chip_smoke
    from foamtpu_torch.mesh import renumber
    from foamtpu_torch.mesh.tetmesh import coo_fraction, tet_box
    from foamtpu_torch.solvers import simple

    pm = tet_box(nx, ny, nz, size=(4.0, 1.0, 1.0))
    t0 = time.perf_counter()
    new, order = renumber.renumber(pm)
    out = {"rcm_s": time.perf_counter() - t0,
           "bandwidth": [renumber.bandwidth(pm), renumber.bandwidth(new)]}
    runs = []
    for p in (pm, new):
        mesh, cfg, state, _ = chip_smoke.duct_setup(nx, ny, nz,
                                                    device="cpu", pm=p)
        step = simple.make_step(mesh, cfg)
        cycles = []
        for _ in range(iters):
            state, diag = step(state)
            cycles.append(int(diag["p_iters"]))
        runs.append((coo_fraction(mesh), cycles,
                     chip_smoke.duct_fields(state)))
    o = torch.as_tensor(order)
    errs = {}
    for k, a in runs[1][2].items():
        back = torch.empty_like(a)
        back[o] = a
        ref = runs[0][2][k]
        errs[k] = float((back - ref).abs().max() / ref.abs().max())
    out.update(coo_fraction=[runs[0][0], runs[1][0]],
               p_cycles=[runs[0][1], runs[1][1]], field_rel_err=errs)
    return out


if __name__ == "__main__":
    # python tests/test_torch_utilities.py rcm NX NY NZ ITERS: rcm_duct's
    # numbers as JSON (FOAMTPU_GAMG_NC=64 as the port's CPU rehearsals of
    # the duct use)
    sys.path.insert(0, REPO)
    if sys.argv[1] == "rcm":
        print(json.dumps(rcm_duct(*(int(a) for a in sys.argv[2:6]))))
