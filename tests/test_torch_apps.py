"""foamtpu_torch solver applications against the JAX package's.

`solvers.apps.run(case, max_steps=3)` on the unmodified tutorials of the
five ported applications (icoFoam cavity, pisoFoam cavityRAS, pimpleFoam
cavityRAS, simpleFoam pitzDaily, interFoam damBreak after setFields),
each meshed by its own package's blockMesh, with `device="cpu"` in
float32, against the reference's application on a second copy: the same
`case.final_state` (rtol 1e-4, atol 1e-5 of each field's scale: three
steps of float32 solves summed in another order, the tolerance
tests/test_torch_turbulence.py uses for a float32 solve; the flux at 1e-4
of its scale; damBreak's U and phi at 1e-3, see F32_TOL_INTER), the same
time index, time name and written files, the written fields read back
equal by the reference's reader, and the postProcessing files of a
`functions` block (forces on a wall, a probe, fieldMinMax, a volume
average, CourantNo) in the reference's layout, their numbers at the
"fo" tolerance of F32_TOL. simpleFoam runs with
FOAMTPU_CHUNK=3 in both packages (three iterations in one chunk), in
float64 in a process of its own (rtol 1e-6) and from seeded k and
epsilon: see seed_turbulence and the test.

Then the application layer itself: `Time.loop` / `adjust_delta_t` /
`write_time` / `register_write` (purgeWrite) against the reference's Time
on the same controlDict, the log lines against the reference's
formatters, and the cases that must raise: an unknown application,
XiFoam and sonicDyMFoam (outside the ported slices), a
codedSource snippet that uses a jnp name outside the port's subset
(utils/tnp.py).
"""

import contextlib
import io
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from foamtpu_torch.apps.cli import main as tcli
from foamtpu_torch.core import runtime as truntime
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.core.dictionary import parse_string as tparse
from foamtpu_torch.solvers import apps as tapps
from foamtpu_torch.solvers.linear.krylov import SolverPerf
from foamtpu_torch.utils import logging as tlog

from test_torch_simple import REPO

torch.set_num_threads(2)

TUTORIALS = {
    "icoFoam": ("incompressible", "icoFoam", "cavity"),
    "pisoFoam": ("incompressible", "pisoFoam", "cavityRAS"),
    "pimpleFoam": ("incompressible", "pimpleFoam", "cavityRAS"),
    "simpleFoam": ("incompressible", "simpleFoam", "pitzDaily"),
    "interFoam": ("multiphase", "interFoam", "laminar", "damBreak"),
}
STEPS = 3


def tutorial(app, root, cli, name, device=()):
    dst = os.path.join(str(root), name)
    shutil.copytree(os.path.join(REPO, "tutorials", *TUTORIALS[app]), dst)
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli(["blockMesh", "-case", dst]) == 0
        if app == "interFoam":
            assert cli(["setFields", "-case", dst, *device]) == 0
    return dst


def state_arrays(state, host):
    out = {}
    for name in ("U", "p", "p_rgh", "alpha"):
        if name in state:
            out[name] = host(state[name].data)
    out["phi"] = host(state["phi"])
    for name, f in (state.get("turb") or {}).items():
        out[name] = host(f.data)
    return out


def seed_turbulence(case_dir, n_cells):
    """0/k and 0/epsilon of a copy rewritten from `uniform v` to
    v * (1 + 0.2 u), u from a numpy seed. On a uniform field the
    limitedLinear limiter is a 0/0 decided by the rounding of a zero
    gradient, so both packages' first iteration depends on their
    summation order (10 % in k after one iteration, in float64 too)."""
    rng = np.random.default_rng(0)
    for name in ("k", "epsilon"):
        path = os.path.join(case_dir, "0", name)
        with open(path) as f:
            text = f.read()
        m = re.search(r"internalField\s+uniform\s+([0-9.eE+-]+);", text)
        vals = float(m.group(1)) * (1.0 + 0.2 * rng.random(n_cells))
        body = "\n".join(repr(float(v)) for v in vals)
        with open(path, "w") as f:
            f.write(text.replace(
                m.group(0), "internalField nonuniform List<scalar> "
                f"{n_cells}\n(\n{body}\n);"))


# name -> (rtol, atol as a share of the field's scale)
# "fo": the function objects' numbers, atol a share of each file's
# largest number (test_torch_functionobjects.compare_post): a probe or a
# reduction carries its field's error, and the file's scale can be
# below the field's (the centre probe of the cavity); measured up to
# 3.0e-4 (icoFoam), 5.8e-4 (interFoam)
F32_TOL = {"default": (1e-4, 1e-5), "phi": (1e-4, 1e-4), "fo": (1e-4, 1e-3)}
# damBreak after 3 ms: |U| <= 0.4 m/s is the difference of rho g h and
# grad(p_rgh) terms of scale 2e3 Pa, so float32 round-off of p_rgh shows
# in U and phi at 1e-4 of their scale (float64: 3e-13)
F32_TOL_INTER = {"default": (1e-4, 1e-5), "U": (1e-4, 1e-3),
                 "phi": (1e-4, 1e-3), "fo": (1e-4, 2e-3)}
# float64: the packages differ by summation order only; pitzDaily's first
# SIMPLE iterations amplify that from 1e-12 to 6e-9 in three iterations
F64_TOL = {"default": (1e-6, 1e-6)}


def compare_run(app, root, tol):
    """Both packages' application on a copy each of the tutorial, STEPS
    steps; the final states, time, written files and log compared."""
    from foamtpu.apps.cli import main as jcli
    from foamtpu.core.case import run_case as jrun
    from foamtpu.io import fields as jfio

    dj = tutorial(app, root, jcli, "ref")
    dt_ = tutorial(app, root, tcli, "port", ("-device", "cpu"))
    tc = TCase(dt_, device="cpu")
    funcs = function_objects_block(tc.mesh)
    for d in (dj, dt_):
        _append(os.path.join(d, "system", "controlDict"), funcs)
    tc = TCase(dt_, device="cpu")
    if app == "simpleFoam":
        seed_turbulence(dj, tc.mesh.n_cells)
        seed_turbulence(dt_, tc.mesh.n_cells)
    log = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()):
        jc = jrun(dj, max_steps=STEPS)
    assert tc.application == app
    with contextlib.redirect_stdout(log):
        assert tapps.run(tc, max_steps=STEPS) is tc
    assert tc.time.index == jc.time.index == STEPS
    assert tc.time.name == jc.time.name

    ref = state_arrays(jc.final_state, np.asarray)
    got = state_arrays(tc.final_state, lambda t: t.numpy())
    assert sorted(got) == sorted(ref)
    for name, r in ref.items():
        assert got[name].dtype == r.dtype, name
        scale = float(np.abs(r).max())
        rtol, atol = tol.get(name, tol["default"])
        np.testing.assert_allclose(got[name], r, rtol=rtol,
                                   atol=atol * scale,
                                   err_msg=f"{app} {name}")
        assert scale > 0, name

    # the same files at the same time, readable by the reference
    tdir = os.path.join(dt_, tc.time.name)
    assert sorted(os.listdir(tdir)) == sorted(
        os.listdir(os.path.join(dj, jc.time.name)))
    for fname in os.listdir(tdir):
        back = jfio.read_field(os.path.join(tdir, fname), jc.mesh, fname)
        key = {"alpha1": "alpha"}.get(fname, fname)
        np.testing.assert_array_equal(np.asarray(back.data), got[key])

    text = log.getvalue()
    assert text.count("\nTime = ") == (1 if app == "simpleFoam" else STEPS)
    assert "Solving for p" in text and text.rstrip().endswith("End")

    # the function objects: the reference's postProcessing files, rows
    # and words, numbers at the fields' tolerance
    from test_torch_functionobjects import compare_post

    fo_tol = tol.get("fo", tol["default"])
    compare_post(dj, dt_, *fo_tol)
    assert tc.function_objects.failures == 0
    assert tc.function_objects.executes == (1 if app == "simpleFoam"
                                            else STEPS)
    return tc


def function_objects_block(mesh):
    """forces on the first wall patch, probes at the mesh's centre,
    fieldMinMax, a volume average and CourantNo: the types users add
    most, for every application."""
    wall = next(p.name for p in mesh.patches if p.type == "wall")
    c = mesh.c.mean(dim=0).tolist()
    return f"""
functions
{{
    wallForces {{ type forces; patches ( {wall} ); rhoInf 1; }}
    centre
    {{
        type probes; fields ( U p p_rgh );
        probeLocations ( ({c[0]!r} {c[1]!r} {c[2]!r}) );
    }}
    minMax {{ type fieldMinMax; fields ( U p p_rgh ); }}
    pAverage {{ type fieldValues; source all; operation volAverage;
               fields ( p U ); }}
    co {{ type CourantNo; }}
}}
"""


F64_BODY = """
import sys, tempfile
sys.path.insert(0, sys.argv[1])
import numpy as np
import test_torch_apps as T
tc = T.compare_run(sys.argv[2], tempfile.mkdtemp(), T.F64_TOL)
assert tc.final_state["U"].data.numpy().dtype == np.float64
print("ok")
"""


@pytest.mark.parametrize("app", list(TUTORIALS))
def test_run_matches_the_reference_application(app, tmp_path, monkeypatch):
    monkeypatch.setenv("FOAMTPU_CHUNK", str(STEPS))
    if app != "simpleFoam":
        tc = compare_run(app, tmp_path,
                         F32_TOL_INTER if app == "interFoam" else F32_TOL)
        assert tc.mesh.v.dtype == torch.float32
        return
    # three float32 SIMPLE iterations of pitzDaily from rest amplify
    # round-off to 10 % (1e-3 after one): the application is held in
    # float64, in a process of its own as tests/test_torch_simple.py runs
    env = dict(os.environ)
    env.update(FOAMTPU_X64="1", JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", F64_BODY, os.path.dirname(__file__), app],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "ok"


# ---------------------------------------------------------------------------
# Time, logging
# ---------------------------------------------------------------------------

CONTROL = """
application icoFoam; startFrom startTime; startTime 0; endTime 0.05;
deltaT 0.01; writeControl {wc}; writeInterval {wi}; purgeWrite 2;
adjustTimeStep {adj}; maxCo 0.5; maxDeltaT 0.02; runTimeModifiable yes;
"""


@pytest.mark.parametrize("wc,wi,adj", [("timeStep", 2, "no"),
                                       ("adjustableRunTime", 0.02, "yes")])
def test_time_follows_the_reference(tmp_path, wc, wi, adj):
    from foamtpu.core import runtime as jruntime
    from foamtpu.core.dictionary import parse_string as jparse

    text = CONTROL.format(wc=wc, wi=wi, adj=adj)
    dirs = []
    for tag in ("ref", "port"):
        d = tmp_path / tag
        (d / "system").mkdir(parents=True)
        (d / "system" / "controlDict").write_text(text)
        dirs.append(str(d))
    jt = jruntime.Time(jparse(text), dirs[0])
    tt = truntime.Time(tparse(text), dirs[1])
    courant = iter([0.1, 0.9, 0.4, 0.6, 0.2, 0.5, 0.5, 0.5, 0.5, 0.5])
    trace = []
    for a, b in zip(jt.loop(), tt.loop()):
        co = next(courant)
        a.adjust_delta_t(co)
        b.adjust_delta_t(co)
        for t, d in ((a, dirs[0]), (b, dirs[1])):
            if t.write_time():
                os.makedirs(os.path.join(d, t.name), exist_ok=True)
                t.register_write(t.name)
        trace.append(((a.index, a.name, a.current_dt, a.delta_t,
                       a.write_time()),
                      (b.index, b.name, b.current_dt, b.delta_t,
                       b.write_time())))
    assert len(trace) >= 3
    for ref, got in trace:
        assert got == ref
    assert tt._written == jt._written and len(tt._written) <= 2
    assert sorted(os.listdir(dirs[1])) == sorted(os.listdir(dirs[0]))
    assert tt.latest_time() == jt.latest_time()
    assert tt.execution_time() >= 0.0 and tt.clock_time() >= 0.0


def test_time_rereads_a_modified_controldict(tmp_path):
    text = CONTROL.format(wc="timeStep", wi=2, adj="no")
    (tmp_path / "system").mkdir()
    path = tmp_path / "system" / "controlDict"
    path.write_text(text)
    t = truntime.Time(tparse(text), str(tmp_path))
    assert not t.read_if_modified()
    path.write_text(text.replace("endTime 0.05", "endTime 0.03")
                    + "stopAt writeNow;\n")
    os.utime(path, ns=(1, 1))       # a changed mtime, whatever the clock
    assert t.read_if_modified()
    assert t.end_time == 0.03 and t.stop_now
    assert list(t.loop()) == []


def test_log_lines_equal_the_reference():
    from foamtpu.utils import logging as jlog

    vec = SolverPerf(torch.tensor([0.5, 0.25, 0.0]),
                     torch.tensor([1e-7, 2e-7, 0.0]), torch.tensor(4))
    sca = SolverPerf(torch.tensor(0.125), torch.tensor(3e-8), 12)
    for perf, field in ((vec, "U"), (sca, "p_rgh")):
        ref = type(perf)(*(np.asarray(x) for x in perf))
        assert tlog.solver_line(field, perf) == jlog.solver_line(field, ref)
    assert "Solving for Ux, Initial residual = 0.5" in \
        tlog.solver_line("U", vec)
    assert tlog.courant_line(0.1, 0.7) == jlog.courant_line(0.1, 0.7)
    assert tlog.continuity_line(1e-9, -2e-10, 3e-10) == \
        jlog.continuity_line(1e-9, -2e-10, 3e-10)
    tlog.load_debug_switches(tparse("DebugSwitches { lduMatrix 1; fv 0; }"))
    assert tlog.debug("lduMatrix") and not tlog.debug("fv")
    tlog.load_debug_switches()
    assert not tlog.debug("lduMatrix")


# ---------------------------------------------------------------------------
# what must raise
# ---------------------------------------------------------------------------


@pytest.fixture
def cavity(tmp_path):
    return tutorial("icoFoam", tmp_path, tcli, "cavity")


def _append(path, text):
    with open(path, "a") as f:
        f.write(text)


def test_run_rejects_an_unknown_application(cavity):
    # (sonicLiquidFoam is ported since the multiphase slice, reactingFoam
    # since the combustion slice: dieselFoam, which neither package
    # registers, is refused)
    path = os.path.join(cavity, "system", "controlDict")
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text.replace("icoFoam", "dieselFoam"))
    with pytest.raises(NotImplementedError, match="dieselFoam"):
        tapps.run(TCase(cavity, device="cpu"), max_steps=1)


@pytest.mark.parametrize("where,text,word", [
    # surfaces and coded are ported since the moving-mesh slice
    # (tests/test_torch_surfaces.py, tests/test_torch_coded.py), and the
    # compressible buoyantSimpleFoam since the compressible slice
    # (tests/test_torch_buoyantrho.py), chtMultiRegionFoam since the
    # snappyHexMesh and conjugate-heat-transfer slice
    # (tests/test_torch_cht.py), the combustion solver XiFoam since the
    # combustion slice (tests/test_torch_reacting.py); dieselEngineFoam,
    # which neither package registers, is not
    (("system", "controlDict"), "\napplication dieselEngineFoam;\n",
     "dieselEngineFoam"),
    # MRFZones and fvOptions are read since the rotating-frame slice
    # (tests/test_torch_mrf.py), and the compressible MRF family runs since
    # the compressible slice (tests/test_torch_rhopimple.py); sonicDyMFoam
    # (solvers/engine.py) is not, nor a coded snippet that uses a jnp name
    # outside the port's subset
    (("system", "controlDict"), "\napplication sonicDyMFoam;\n",
     "sonicDyMFoam"),
    (("system", "fvOptions"),
     "src { type vectorCodedSource; selectionMode all; fields (U);\n"
     "codeAddSup #{\nsource = jnp.cumsum(jnp.zeros((V.shape[0], 3)))\n"
     "#}; }\n",
     "jnp.cumsum"),
])
def test_run_rejects_features_outside_slice(cavity, where, text, word):
    _append(os.path.join(cavity, *where), text)
    case = TCase(cavity, device="cpu")
    with pytest.raises(NotImplementedError, match=word):
        tapps.run(case, max_steps=1)
    assert not hasattr(case, "final_state")


def test_empty_functions_block_runs(cavity):
    _append(os.path.join(cavity, "system", "controlDict"),
            "\nfunctions { }\n")
    case = TCase(cavity, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        tapps.run(case, max_steps=1)
    assert case.time.index == 1
