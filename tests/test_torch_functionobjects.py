"""foamtpu_torch function objects against the JAX package's.

The icoFoam cavity at 16^2 with a `functions` block of every ported type
that the cavity can run (the blocks of tests/test_fieldvalues.py and
tests/test_fo_misc.py without `coded`, plus forces on the lid, probes at
two points, fieldMinMax and fieldAverage) runs 4 steps through each
package's application, in float64 in a process of its own, each case run
from its own directory (systemCall writes there, as in the reference's
test). Each object's postProcessing files must have the reference's
names, rows, headers and words, and its numbers must agree at rtol 1e-7
(8 significant digits are printed; the states agree to 1e-13), with
differences under 1e-12 of the file's largest number counted as equal
(a component that cancels to round-off, such as the lid's shear force
along y).

Then, in float32 in this process: abortCalculation stops the run at the
first step, the two-blob regionSizeDistribution of the reference's test,
readFields and timeActivatedFileUpdate, nearWallFields' values, the host
fetches each object makes per execute, and the failure count of the list.
Every function-object type of the reference is ported since the
moving-mesh slice
(surfaces.py and coded: tests/test_torch_surfaces.py,
tests/test_torch_coded.py); what the cavity can still ask for and the
port refuses before the first step is a mesh motion that changes the
mesh by more than a rigid motion (sixDoFRigidBodyMotion, attachDetach,
dynamicRefineFvMesh) and an LES filter width other than cubeRootVol.
"""

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from foamtpu_torch.apps.cli import main as tcli
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.solvers import apps as tapps

from test_torch_simple import REPO

torch.set_num_threads(2)

CAVITY = os.path.join(REPO, "tutorials", "incompressible", "icoFoam",
                      "cavity")
FUNCS = """
functions
{
    pAvg { type fieldValues; source all; operation volAverage; fields ( p U ); }
    lidP { type faceSource; sourceName movingWall; operation areaAverage;
           fields ( p ); }
    marker { type systemCall; executeCalls ( "touch syscall.mark" ); }
    stopper { type abortCalculation; fileName ABORT; }
    wallU { type nearWallFields; fields ( (U UNear) ); patches ( fixedWalls ); }
    co { type CourantNo; }
    surf { type surfaceInterpolateFields; fields ( p ); }
    xform
    {
        type fieldCoordinateSystemTransform;
        fields ( U );
        coordinateSystem { e1 (0 1 0); e3 (0 0 1); }
    }
    dicts { type writeDictionary; dictNames ( transportProperties ); }
    blobs { type regionSizeDistribution; field p; threshold 0; nBins 4; }
    lid { type forces; patches ( movingWall ); rhoInf 1; }
    pr
    {
        type probes;
        probeLocations ( (0.05 0.05 0.005) (0.02 0.08 0.005) );
        fields ( p U );
    }
    mm { type fieldMinMax; fields ( U p ); }
    avg { type fieldAverage; fields ( U p ); }
}
"""
NAMES = ["pAvg", "lidP", "marker", "stopper", "wallU", "co", "surf", "xform",
         "dicts", "blobs", "lid", "pr", "mm", "avg"]
STEPS = 4


def cavity(root, name, cli=tcli, funcs=FUNCS, n=16):
    dst = os.path.join(str(root), name)
    shutil.copytree(CAVITY, dst)
    bmd = os.path.join(dst, "constant", "polyMesh", "blockMeshDict")
    with open(bmd) as f:
        text = f.read()
    with open(bmd, "w") as f:
        f.write(text.replace("(20 20 1)", f"({n} {n} 1)"))
    with open(os.path.join(dst, "system", "controlDict"), "a") as f:
        f.write(funcs)
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli(["blockMesh", "-case", dst]) == 0
    return dst


_NUM = re.compile(r"^[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?$")


def _rows(path):
    with open(path) as f:
        return [line.replace("(", " ").replace(")", " ").split()
                for line in f]


def compare_post(ref_dir, got_dir, rtol, atol):
    """Every file under the reference's postProcessing/ against the
    port's: the same files, rows, comment lines and time names; the other
    numbers at rtol, with atol a share of the file's largest number (a
    reduction is as exact as the field it reduces: a component that
    cancels, such as a lid's pressure force along x, is held at the
    scale of the file, not at its own). Returns {object name: largest
    error relative to the tolerance}."""
    ref_root = os.path.join(ref_dir, "postProcessing")
    got_root = os.path.join(got_dir, "postProcessing")
    assert sorted(os.listdir(got_root)) == sorted(os.listdir(ref_root))
    worst = {}
    for name in sorted(os.listdir(ref_root)):
        files = sorted(os.listdir(os.path.join(ref_root, name)))
        assert sorted(os.listdir(os.path.join(got_root, name))) == files
        worst[name] = 0.0
        for fname in files:
            r = _rows(os.path.join(ref_root, name, fname))
            g = _rows(os.path.join(got_root, name, fname))
            assert len(g) == len(r), (name, fname)
            data = [row for row in r if row and not row[0].startswith("#")]
            scale = max([abs(float(t)) for row in data for t in row[1:]
                         if _NUM.match(t)], default=0.0)
            for rr, gr in zip(r, g):
                assert len(gr) == len(rr), (name, fname, rr, gr)
                if not rr or rr[0].startswith("#"):
                    assert gr == rr, (name, fname, rr, gr)
                    continue
                assert gr[0] == rr[0], (name, fname, rr, gr)   # time
                for a, b in zip(rr[1:], gr[1:]):
                    if not _NUM.match(a):
                        assert a == b, (name, fname, rr, gr)
                        continue
                    a, b = float(a), float(b)
                    lim = rtol * abs(a) + atol * scale
                    err = abs(a - b) / lim if lim > 0 else abs(a - b) * 1e300
                    worst[name] = max(worst[name], err)
                    assert err <= 1.0, (name, fname, rr, gr)
    return worst


F64_BODY = """
import contextlib, io, json, os, sys, tempfile
sys.path.insert(0, sys.argv[1])
import numpy as np
import test_torch_functionobjects as T
from foamtpu.apps.cli import main as jcli
from foamtpu.core.case import run_case as jrun
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.solvers import apps as tapps

root = tempfile.mkdtemp()
dj = T.cavity(root, "ref", jcli)
dt_ = T.cavity(root, "port")
with contextlib.redirect_stdout(io.StringIO()):
    os.chdir(dj)
    jc = jrun(dj, max_steps=T.STEPS)
    os.chdir(dt_)
    tc = TCase(dt_, device="cpu")
    tapps.run(tc, max_steps=T.STEPS)
assert tc.final_state["U"].data.dtype.itemsize == 8
worst = T.compare_post(dj, dt_, 1e-7, 1e-12)
fol = tc.function_objects
t = jc.latest_time_name()
near = {}
for tag, case in (("ref", jc), ("port", tc)):
    un = case.read_field("UNear", time=t).data
    near[tag] = np.asarray(un if tag == "ref" else un.numpy())
out = {"worst": worst, "failures": fol.failures, "fetches": fol.fetches(),
       "executes": fol.executes, "index": [jc.time.index, tc.time.index],
       "mark": [os.path.exists(os.path.join(d, "syscall.mark"))
                for d in (dj, dt_)],
       "unear": float(np.max(np.abs(near["ref"] - near["port"])))}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def f64_run():
    env = dict(os.environ)
    env.update(FOAMTPU_X64="1", JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu")
    marks = os.path.exists(os.path.join(REPO, "syscall.mark"))
    r = subprocess.run(
        [sys.executable, "-c", F64_BODY, os.path.dirname(__file__)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    # systemCall ran in the cases' directories, not in the tree
    assert os.path.exists(os.path.join(REPO, "syscall.mark")) == marks
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", NAMES)
def test_function_object_matches_the_reference(f64_run, name):
    assert name in f64_run["worst"], sorted(f64_run["worst"])
    assert f64_run["worst"][name] <= 1.0
    # one fetch per execute at most for these objects on this case, none
    # for the ones that write no numbers
    fetches = f64_run["fetches"][name]
    want = 0 if name in ("marker", "stopper", "dicts", "avg") else STEPS
    assert fetches == want, (name, fetches)


def test_function_object_list_runs_clean(f64_run):
    assert f64_run["failures"] == 0
    assert f64_run["executes"] == STEPS
    assert f64_run["index"] == [STEPS, STEPS]
    assert f64_run["mark"] == [True, True]
    assert f64_run["unear"] <= 1e-12


# ---------------------------------------------------------------------------
# float32, the port alone
# ---------------------------------------------------------------------------


def _run(case_dir, steps=STEPS):
    case = TCase(case_dir, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        tapps.run(case, max_steps=steps)
    return case


def test_abort_calculation_stops_at_the_first_step(tmp_path, monkeypatch):
    d = cavity(tmp_path, "abort",
               funcs="\nfunctions { stop { type abortCalculation; } }\n")
    open(os.path.join(d, "ABORT"), "w").close()
    monkeypatch.chdir(tmp_path)
    case = _run(d, steps=50)
    assert case.time.index == 1 and case.function_objects.failures == 0


def test_near_wall_fields_sample_the_wall_cells(tmp_path, monkeypatch):
    d = cavity(tmp_path, "near", funcs="\nfunctions { w { type "
               "nearWallFields; fields ( (U UNear) ); patches ( fixedWalls );"
               " } }\n")
    monkeypatch.chdir(tmp_path)
    case = _run(d, steps=2)
    mesh = case.mesh
    un = case.read_field("UNear", time=case.time.name).data.numpy()
    own = np.unique(mesh.owner[mesh.patch("fixedWalls").slice].numpy())
    inner = np.setdiff1d(np.arange(mesh.n_cells), own)
    assert np.abs(un[inner]).max() == 0.0
    np.testing.assert_array_equal(un[own],
                                  case.final_state["U"].data.numpy()[own])


def test_region_size_distribution_counts_two_blobs(tmp_path):
    from foamtpu_torch.apps.cases import make_cavity
    from foamtpu_torch.core.dictionary import parse_string
    from foamtpu_torch.core.fields import vol_scalar
    from foamtpu_torch.functionobjects.misc import RegionSizeDistribution

    mesh, _, _ = make_cavity(8, device="cpu")

    class FakeCase:
        dir = str(tmp_path)

    FakeCase.mesh = mesh
    fo = RegionSizeDistribution(
        "blobs", parse_string("field alpha1; threshold 0.5; nBins 4;"),
        FakeCase)
    c = mesh.c.numpy()
    x = (c[:, 0] - c[:, 0].min()) / (c[:, 0].max() - c[:, 0].min())
    a = ((x < 0.25) | (x > 0.75)).astype(np.float32)
    fo.execute("0.1", {"alpha1": vol_scalar(mesh, 0.0).with_data(
        torch.as_tensor(a))})
    line = open(os.path.join(str(tmp_path), "postProcessing", "blobs",
                             "distribution.dat")).read().split()
    assert line[1] == "2" and fo.fetches == 1


def test_read_fields_and_time_activated_file_update(tmp_path, monkeypatch):
    d = cavity(tmp_path, "swap", funcs="""
functions
{
    rf  { type readFields; fields ( p ); }
    swp
    {
        type timeActivatedFileUpdate;
        fileToUpdate "$FOAM_CASE/constant/transportProperties";
        timeVsFile ( (0.002 "$FOAM_CASE/newTransport") );
    }
}
""")
    tp = os.path.join(d, "constant", "transportProperties")
    shutil.copyfile(tp, os.path.join(d, "newTransport"))
    with open(os.path.join(d, "newTransport"), "a") as f:
        f.write("\n// swapped\n")
    monkeypatch.chdir(tmp_path)
    case = _run(d)
    assert "// swapped" in open(tp).read()
    assert case.function_objects.failures == 0


def test_failures_are_counted_and_the_run_goes_on(tmp_path, monkeypatch):
    d = cavity(tmp_path, "fail", funcs="\nfunctions { bad { type probes; "
               "probeLocations ( (0.05 0.05 0.005) ); fields ( U ); } }\n")
    monkeypatch.chdir(tmp_path)
    case = TCase(d, device="cpu")
    fol = tapps._function_objects(case)

    def broken(time_name, state):
        raise RuntimeError("no such field")

    fol.objects[0].execute = broken
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fol.execute("0.1", {})
        fol.execute("0.2", {})
    assert fol.failures == 2 and fol.failed == {"bad": 2}
    assert "functionObject bad: no such field" in out.getvalue()


@pytest.fixture(scope="module")
def meshed_cavity(tmp_path_factory):
    return cavity(tmp_path_factory.mktemp("refuse"), "cavity", funcs="")


# a case the cavity can be turned into that the port refuses before its
# first step: (application, constant/<file>, its text, the word raised).
# sixDoFRigidBodyMotion, attachDetach and dynamicRefineFvMesh are ported
# since the topology-change slice (tests/test_torch_sixdof.py,
# tests/test_torch_topo.py, tests/test_torch_amr.py), and sprayEngineFoam,
# the parcels on its engine mesh, since the Lagrangian slice
# (tests/test_torch_reactingcloud.py); an LES delta other than
# cubeRootVol is not (the reference reads none)
REFUSED = {
    "smoothDelta": (
        "pisoFoam", "LESProperties",
        "LESModel Smagorinsky;\ndelta smooth;\n", "smooth"),
    "vanDriest": (
        "pisoFoam", "LESProperties",
        "LESModel Smagorinsky;\ndelta vanDriest;\n", "vanDriest"),
}


@pytest.mark.parametrize("kind", sorted(REFUSED))
def test_unported_types_are_refused_before_the_first_step(
        meshed_cavity, tmp_path, kind):
    app, fname, text, word = REFUSED[kind]
    d = str(tmp_path / "case")
    shutil.copytree(meshed_cavity, d)
    with open(os.path.join(d, "system", "controlDict"), "a") as f:
        f.write(f"\napplication {app};\n")
    with open(os.path.join(d, "constant", fname), "w") as f:
        f.write(text)
    case = TCase(d, device="cpu")
    with pytest.raises(NotImplementedError, match=word):
        tapps.run(case, max_steps=1)
    assert case.time.index == 0 and not hasattr(case, "final_state")