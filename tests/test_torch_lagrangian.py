"""foamtpu_torch's kinematic parcels (lagrangian/__init__.py) and the
kinematic parcel applications against the JAX package.

In float64 (one subprocess, FOAMTPU_X64=1 JAX_ENABLE_X64=1) both packages
take the same numpy inputs: the port's mesh and clouds are the reference's
carried over by convert.py (mesh_from_numpy, cloud_from_numpy). Twins of
the tests of tests/test_lagrangian.py: the ballistic parabola, Stokes
settling, escape at an outlet, the wall rebound, patch injection with a
bounded rate, the Ranz-Marshall thermo parcel, the two-way momentum
coupling through PISO's `mom_src`, and icoUncoupledKinematicParcelFoam on
that test's case. Each holds the parcels' cells, `active` flags and (for
the application) origId equal, and x and u (T, the carrier's U and p) at
rtol 1e-9 (atol 1e-9 of the array's scale), and checks the reference
test's own oracle on the port's numbers. Beside it the two kinematic
applications run their shipped fallingCloud through `python -m
foamtpu_torch run -device cpu`.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from foamtpu_torch import lagrangian as tlag
from foamtpu_torch.solvers import apps as tapps

from test_torch_simple import REPO

torch.set_num_threads(2)

# the comparison helpers every f64 body of the slice starts with
COMMON = r'''
import contextlib, io, json, os, re, shutil, sys, tempfile
import numpy as np
import torch

sys.path.insert(0, os.getcwd())
torch.set_num_threads(2)
NUM = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")


def host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def cmp(got, ref, rtol=1e-9):
    """{ok, max_abs, scale}: integers and bools exactly, floats at rtol
    with atol rtol times the reference's scale."""
    g, r = host(got), host(ref)
    if g.shape != r.shape:
        return {"ok": False, "shape": [list(g.shape), list(r.shape)]}
    if r.dtype.kind in "biu":
        return {"ok": bool((g.astype(np.int64) == r.astype(np.int64)).all()),
                "exact": True}
    g, r = g.astype(float), r.astype(float)
    scale = float(np.abs(r).max()) if r.size else 0.0
    return {"ok": bool(np.allclose(g, r, rtol=rtol, atol=rtol * scale)),
            "max_abs": float(np.abs(g - r).max()) if r.size else 0.0,
            "scale": scale}


def cmp_tuple(got, ref, skip=("key", "draws")):
    """Every array of a NamedTuple (cloud, state) compared by name."""
    out = {}
    for k in ref._fields:
        if k in skip or getattr(ref, k) is None:
            continue
        v = getattr(ref, k)
        if hasattr(v, "_fields"):
            for kk, e in cmp_tuple(getattr(got, k), v).items():
                out[k + "." + kk] = e
        else:
            out[k] = cmp(getattr(got, k), v)
    return out


def numbers_of_dir(d):
    out = {}
    for dirpath, _, files in os.walk(d):
        for f in files:
            path = os.path.join(dirpath, f)
            out[os.path.relpath(path, d)] = [
                float(x) for x in NUM.findall(open(path).read())]
    return out


def cmp_dirs(a, b, rtol=1e-9):
    """The written files under a (port) and b (reference): the same names,
    the same count of numbers, equal at rtol of the file's largest."""
    na, nb = numbers_of_dir(a), numbers_of_dir(b)
    bad = []
    for f, r in nb.items():
        g = na.get(f)
        if g is None or len(g) != len(r):
            bad.append(f)
        elif r and np.abs(np.subtract(g, r)).max() > rtol * max(
                np.abs(r).max(), 1e-300):
            bad.append(f)
    return {"names": [sorted(na), sorted(nb)], "bad": bad}


def log_lines(text):
    """The log's lines without the clock times: (words, numbers)."""
    out = []
    for line in text.splitlines():
        if not line.strip() or line.startswith(("ExecutionTime",
                                                "Starting")):
            continue
        out.append((NUM.sub("#", line), [float(x) for x in
                                         NUM.findall(line)]))
    return out


def cmp_logs(t, j, rtol=1e-6):
    lt, lj = log_lines(t), log_lines(j)
    return {"words": [a[0] for a in lt] == [b[0] for b in lj],
            "numbers": len(lt) == len(lj) and all(
                np.allclose(a[1], b[1], rtol=rtol, atol=1e-300)
                for a, b in zip(lt, lj)),
            "n": [len(lt), len(lj)]}
'''

BODY = r'''
import jax
import jax.numpy as jnp
from foamtpu import lagrangian as jlag
from foamtpu.core.dictionary import parse_string as jparse
from foamtpu.mesh import blockmesh as jbm, to_device as jdev
from foamtpu_torch import lagrangian as tlag
from foamtpu_torch.convert import mesh_from_numpy, state_from_numpy

BOX = """
convertToMeters 1;
vertices
(
    (0 0 0) (1 0 0) (1 1 0) (0 1 0)
    (0 0 1) (1 0 1) (1 1 1) (0 1 1)
);
blocks ( hex (0 1 2 3 4 5 6 7) (10 10 10) simpleGrading (1 1 1) );
boundary
(
    outlet { type patch; faces ((2 6 5 1)); }
    walls { type wall; faces ((0 4 7 3) (1 5 4 0) (3 7 6 2)
                              (0 3 2 1) (4 5 6 7)); }
);
"""
jm = jdev(jbm.generate(jparse(BOX)))
tm = mesh_from_numpy(jm, device="cpu")
assert tm.v.dtype == torch.float64
jbt = jnp.asarray(jlag.face_boundary_types(jm))
tbt = torch.tensor(tlag.face_boundary_types(tm))
assert (host(jbt) == host(tbt)).all()
out = {}


def f64(v):
    return torch.tensor(v, dtype=torch.float64)


def both(x, u, d, rho, **kw):
    jc = jlag.make_cloud(jm, x, u, d, rho, **kw)
    tc = tlag.make_cloud(tm, x, u, d, rho, **kw)
    return jc, tc


def run(name, jc, tc, cfg_kw, steps, dt, U=None, T=None, extra=None):
    """Both packages' evolve for `steps`; the comparison and the port's
    trajectory of parcel 0."""
    jcfg = jlag.CloudConfig(**cfg_kw)
    tcfg = tlag.CloudConfig(**cfg_kw)
    Uh = np.zeros((jm.n_cells, 3)) if U is None else U
    jU, tU = jnp.asarray(Uh), torch.tensor(Uh)
    jT = tT = None
    if T is not None:
        jT, tT = jnp.asarray(T), torch.tensor(T)
    traj = []
    jstep = jax.jit(lambda c, d: jlag.evolve(jm, c, jU, d, jbt, jcfg,
                                             T_cell=jT))
    for _ in range(steps):
        jc = jstep(jc, jnp.asarray(dt))
        tc = tlag.evolve(tm, tc, tU, f64(dt), tbt, tcfg, T_cell=tT)
        traj.append({"x": host(tc.x[0]).tolist(), "u": host(tc.u[0]).tolist(),
                     "cell": int(tc.cell[0]), "active": bool(tc.active[0]),
                     "T": float(tc.T[0]) if tc.T is not None else None,
                     "n_active": int(tc.n_active)})
    out[name] = {"errs": cmp_tuple(tc, jc), "traj": traj,
                 "c": host(tm.c).tolist() if name == "ballistic" else None}


jc, tc = both([[0.15, 0.85, 0.5]], [0.5, 0.0, 0.0], 1e-3, 1000.0)
run("ballistic", jc, tc, dict(drag=False, g=(0.0, -1.0, 0.0)), 10, 0.05)

rho_p, d, mu = 2000.0, 50e-6, 1.8e-5
tau = rho_p * d ** 2 / (18 * mu)
jc, tc = both([[0.5, 0.9, 0.5]], [0.0, 0.0, 0.0], d, rho_p)
run("stokes", jc, tc, dict(rho_f=1.2, mu_f=mu, g=(0.0, -9.81, 0.0)), 60,
    tau / 4)

xs = [[0.1, 0.3, 0.5], [0.1, 0.5, 0.5], [0.1, 0.7, 0.5]]
jc, tc = both(xs, [1.0, 0.0, 0.0], 1e-5, 1.0)
run("escape", jc, tc, dict(rho_f=1.0, mu_f=1e-2, g=(0.0, 0.0, 0.0)), 15,
    0.08, U=np.tile([1.0, 0.0, 0.0], (jm.n_cells, 1)))

jc, tc = both([[0.5, 0.2, 0.5]], [0.0, -1.0, 0.0], 1e-3, 1000.0)
run("wall", jc, tc, dict(drag=False, g=(0.0, 0.0, 0.0)), 5, 0.1)

jc, tc = both([[0.5, 0.5, 0.5]], (0, 0, 0), 1e-3, 2000.0, T0=400.0)
tau_t = 2000.0 * 1000.0 * (1e-3) ** 2 / (12.0 * 0.026)
run("thermo", jc, tc, dict(rho_f=1.2, mu_f=1.8e-5, g=(0.0, 0.0, 0.0),
                           drag=False, solve_T=True, cp_p=1000.0,
                           k_f=0.026), 50, tau_t / 50.0,
    T=np.full(jm.n_cells, 300.0))

# patch injection with a bounded rate
jc, tc = both(np.empty((0, 3)), (0, 0, 0), 1e-4, 1000.0, n_slots=40)
jinj = jlag.patch_injection(jm, "walls", u0=(0.0, -0.5, 0.0), d0=2e-4,
                            rho0=800.0, rate=500.0)
tinj = tlag.patch_injection(tm, "walls", u0=(0.0, -0.5, 0.0), d0=2e-4,
                            rho0=800.0, rate=500.0)
inj = {"config": {k: cmp(getattr(tinj, k), getattr(jinj, k))
                  for k in ("positions", "cells", "u0")}, "counts": []}
jcar, jcnt = jnp.zeros(()), jnp.zeros((), jnp.int32)
tcar, tcnt = f64(0.0), torch.zeros((), dtype=torch.int64)
for i in range(15):
    jc, jcar, jcnt = jlag.inject(jc, jinj, jcar, jcnt, 0.01)
    tc, tcar, tcnt = tlag.inject(tc, tinj, tcar, tcnt, f64(0.01))
    inj["counts"].append([int(tc.n_active), int(tcnt), int(jc.n_active),
                          int(jcnt)])
    if i == 4:
        a = host(tc.active)
        inj["at5"] = {"d": host(tc.d)[a].tolist(),
                      "rho": host(tc.rho)[a].tolist()}
inj["errs"] = cmp_tuple(tc, jc)
inj["carry"] = cmp(tcar, jcar)
out["inject"] = inj

# the two-way momentum coupling through PISO's mom_src
from foamtpu.bc import patchfields as jpf
from foamtpu.core.dimensions import DimensionSet, dimVelocity
from foamtpu.core.fields import vol_scalar, vol_vector
from foamtpu.solvers import piso as jpiso
from foamtpu_torch.solvers import piso as tpiso

cfg_c = dict(rho_f=1000.0, mu_f=1e-3, g=(0.0, -9.81, 0.0))
x0 = np.stack([np.full(12, 0.5), np.linspace(0.3, 0.8, 12),
               np.full(12, 0.5)], axis=1)
ubcs, pbcs = [], []
for p in jm.patches:
    ubcs.append(jpf.fixed_value(jnp.zeros(3)))
    pbcs.append(jpf.zero_gradient())
jU = vol_vector(jm, jnp.zeros(3), name="U", dims=dimVelocity,
                bcs=tuple(ubcs))
jp = vol_scalar(jm, 0.0, name="p", dims=DimensionSet.of(0, 2, -2),
                bcs=tuple(pbcs))
n_parcels = 1e4
coupling = {}
for coupled in (True, False):
    jc, tc = both(x0, (0.0, 0.0, 0.0), 2e-3, 8000.0, n_slots=16)
    jst = jpiso.initial_state(jm, jU, jp)
    tst = state_from_numpy(jst, device="cpu")
    jcfg, tcfg = jlag.CloudConfig(**cfg_c), tlag.CloudConfig(**cfg_c)
    jpc = jpiso.PisoConfig(nu=1e-6, n_correctors=2)
    tpc = tpiso.PisoConfig(nu=1e-6, n_correctors=2)
    jstep = jax.jit(lambda s, d: jpiso.piso_step(jm, s, d, jpc))
    jev = jax.jit(lambda c, U: jlag.evolve(jm, c, U, jnp.asarray(1e-3), jbt,
                                           jcfg))
    src_sum = []
    for _ in range(15):
        jb, tb = jc, tc
        jc = jev(jc, jst["U"].data)
        tc = tlag.evolve(tm, tc, tst["U"].data, f64(1e-3), tbt, tcfg)
        jsrc = jlag.momentum_source(jm, jb, jc, n_parcels, 1e-3,
                                    jcfg) / cfg_c["rho_f"]
        tsrc = tlag.momentum_source(tm, tb, tc, n_parcels, 1e-3,
                                    tcfg) / cfg_c["rho_f"]
        src_sum.append(float(host(tsrc)[:, 1].sum()))
        jst["mom_src"] = jsrc if coupled else 0.0 * jsrc
        tst["mom_src"] = tsrc if coupled else 0.0 * tsrc
        jst, _ = jstep(jst, jnp.asarray(1e-3))
        tst, _ = tpiso.piso_step(tm, tst, f64(1e-3), tpc)
    coupling["coupled" if coupled else "uncoupled"] = {
        "cloud": cmp_tuple(tc, jc), "U": cmp(tst["U"].data, jst["U"].data),
        "p": cmp(tst["p"].data, jst["p"].data),
        "src": cmp(tsrc, jsrc),
        "uy_min": float(host(tst["U"].data)[:, 1].min()),
        "finite": bool(torch.isfinite(tst["U"].data).all()),
        "src_y_sum": src_sum}
out["coupling"] = coupling

# icoUncoupledKinematicParcelFoam on tests/test_lagrangian.py's case
from foamtpu.apps.cli import main as jcli
from foamtpu.core.case import run_case as jrun
from foamtpu_torch.apps.cli import main as tcli
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.solvers import apps as tapps

sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
from test_torch_lagrangian import write_app_case

root = tempfile.mkdtemp()
app = {}
jd, td = (write_app_case(os.path.join(root, n)) for n in ("ref", "port"))
with contextlib.redirect_stdout(io.StringIO()):
    assert jcli(["blockMesh", "-case", jd]) == 0
    assert tcli(["blockMesh", "-case", td]) == 0
with contextlib.redirect_stdout(io.StringIO()) as jl:
    jcase = jrun(jd, max_steps=50)
tcase = TCase(td, device="cpu")
with contextlib.redirect_stdout(io.StringIO()) as tl:
    tapps.run(tcase, max_steps=50)
tcl, jcl = tcase.final_state["cloud"], jcase.final_state["cloud"]
act = host(tcl.active)
app["errs"] = cmp_tuple(tcl, jcl)
app["n_active"] = int(tcl.n_active)
app["x_mean"] = float(host(tcl.x)[act][:, 0].mean())
app["finite"] = bool(np.isfinite(host(tcl.x)[act]).all())
app["logs"] = cmp_logs(tl.getvalue(), jl.getvalue())
app["times"] = [tcase.time.name, jcase.time.name]
files = {}
for t in sorted(os.listdir(jd)):
    lag_dir = os.path.join(jd, t, "lagrangian")
    if os.path.isdir(lag_dir):
        files[t] = cmp_dirs(os.path.join(td, t, "lagrangian"), lag_dir)
app["files"] = files
app["positions"] = open(os.path.join(
    td, tcase.time.name, "lagrangian", "kinematicCloud",
    "positions")).read()[:200]
out["app"] = app
print(json.dumps(out))
'''

APP_CASE = {
    "constant/polyMesh/blockMeshDict": ("dictionary", """
convertToMeters 1;
vertices ( (0 0 0) (1 0 0) (1 1 0) (0 1 0) (0 0 1) (1 0 1) (1 1 1) (0 1 1) );
blocks ( hex (0 1 2 3 4 5 6 7) (8 8 8) simpleGrading (1 1 1) );
boundary ( outlet { type patch; faces ((2 6 5 1)); }
           walls { type wall; faces ((0 4 7 3) (1 5 4 0) (3 7 6 2) (0 3 2 1) (4 5 6 7)); } );
"""),
    "system/controlDict": ("dictionary", """
application icoUncoupledKinematicParcelFoam;
startFrom startTime; startTime 0; stopAt endTime; endTime 0.5; deltaT 0.01;
writeControl timeStep; writeInterval 25; writeFormat ascii;
"""),
    "system/fvSchemes": ("dictionary", """
ddtSchemes { default Euler; } gradSchemes { default Gauss linear; }
divSchemes { default none; } laplacianSchemes { default Gauss linear corrected; }
interpolationSchemes { default linear; } snGradSchemes { default corrected; }
"""),
    "system/fvSolution": ("dictionary", "solvers { }\n"),
    "constant/transportProperties": ("dictionary", """
transportModel Newtonian;
nu nu [0 2 -1 0 0 0 0] 1.5e-05;
rhoInf rhoInf [1 -3 0 0 0 0 0] 1.2;
"""),
    "constant/g": ("uniformDimensionedVectorField", """
dimensions [0 1 -2 0 0 0 0];
value (0 -2 0);
"""),
    "constant/kinematicCloudProperties": ("dictionary", """
constantProperties { rho0 2000; }
subModels
{
    injectionModels
    {
        model1 { type manualInjection;
                 positionsFile "kinematicCloudPositions";
                 U0 (0.5 0 0); d0 500e-6; }
    }
}
"""),
    "constant/kinematicCloudPositions": ("vectorField", """
3
(
(0.2 0.8 0.5)
(0.3 0.7 0.4)
(0.25 0.75 0.6)
)
"""),
    "0/U": ("volVectorField", """
dimensions [0 1 -1 0 0 0 0];
internalField uniform (0.5 0 0);
boundaryField { outlet { type zeroGradient; }
                walls { type fixedValue; value uniform (0 0 0); } }
"""),
}


def write_app_case(case):
    """tests/test_lagrangian.py::test_kinematic_parcel_app's case."""
    hdr = ("FoamFile { version 2.0; format ascii; class %s; "
           "object %s; }\n")
    for rel, (cls, body) in APP_CASE.items():
        path = os.path.join(case, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(hdr % (cls, os.path.basename(rel)) + body)
    return case


def f64_body(body, args=(), timeout=600):
    """`body` after COMMON in a float64 process of its own, `args` its
    sys.argv[1:]; its last JSON line."""
    env = dict(os.environ, FOAMTPU_X64="1", JAX_ENABLE_X64="1",
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", COMMON + body, *args],
                       env=env, cwd=REPO, capture_output=True, text=True,
                       timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def cli_runs(names, steps, root):
    """Each tutorial of `names` (chip_smoke.SLICE17_TUTORIALS) copied under
    root, meshed, and run by `python -m foamtpu_torch run -case <copy>
    -steps <steps> -device cpu`, one process each, all at once:
    {name: (returncode, stdout, stderr, case dir)}."""
    from foamtpu_torch.apps.cli import main as tcli

    procs = {}
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("FOAMTPU_X64", None)
    for name in names:
        d = chip_smoke.slice17_case(REPO, os.path.join(root, name), name,
                                    tcli)
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", "foamtpu_torch", "run", "-case", d,
             "-steps", str(steps), "-device", "cpu"], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), d)
    out = {}
    for name, (p, d) in procs.items():
        so, se = p.communicate(timeout=600)
        out[name] = (p.returncode, so, se, d)
    return out


@pytest.fixture(scope="module")
def rec():
    return f64_body(BODY)


def assert_errs(errs, what):
    assert errs, what
    for k, e in errs.items():
        assert e["ok"], (what, k, e)


@pytest.mark.parametrize("name", ["ballistic", "stokes", "escape", "wall",
                                  "thermo"])
def test_cloud_matches_reference_f64(rec, name):
    assert_errs(rec[name]["errs"], name)
    for k in ("cell", "active", "x", "u"):
        assert k in rec[name]["errs"]


def test_ballistic_parabola_and_cell_tracking(rec):
    """No drag: x(t) follows the discrete gravity parabola, and the
    tracked cell holds the parcel (tests/test_lagrangian.py's oracle)."""
    c = np.asarray(rec["ballistic"]["c"])
    dt = 0.05
    for i, s in enumerate(rec["ballistic"]["traj"]):
        k, t = i + 1, dt * (i + 1)
        x = np.asarray(s["x"])
        assert abs(x[0] - (0.15 + 0.5 * t)) < 1e-5
        assert abs(x[1] - (0.85 - dt * dt * k * (k + 1) / 2)) < 1e-5
        assert np.max(np.abs(x - c[s["cell"]])) < 0.051
    assert rec["ballistic"]["traj"][-1]["active"]


def test_stokes_settling_terminal_velocity(rec):
    rho_p, d, mu = 2000.0, 50e-6, 1.8e-5
    tau = rho_p * d ** 2 / (18 * mu)
    g_eff = (1 - 1.2 / rho_p) * 9.81
    ut = g_eff * tau
    for _ in range(50):
        ut = g_eff * tau / (1 + 0.15 * (1.2 * ut * d / mu) ** 0.687)
    uy = rec["stokes"]["traj"][-1]["u"][1]
    assert abs(-uy - ut) / ut < 0.02, (uy, ut)


def test_advection_escape_and_wall_rebound(rec):
    assert rec["escape"]["traj"][-1]["n_active"] == 0
    s = rec["wall"]["traj"][-1]
    assert s["active"] and s["u"][1] > 0.99 and abs(s["x"][1] - 0.3) < 1e-4


def test_thermo_parcel_ranz_marshall(rec):
    T = rec["thermo"]["traj"][-1]["T"]
    assert abs(T - (300.0 + 100.0 * np.exp(-1.0))) < 2.5


def test_patch_injection_matches_reference_f64(rec):
    inj = rec["inject"]
    assert_errs(inj["config"], "injection config")
    assert_errs(inj["errs"], "injected cloud")
    assert inj["carry"]["ok"]
    for n_t, c_t, n_j, c_j in inj["counts"]:
        assert (n_t, c_t) == (n_j, c_j)
        assert n_t <= 40
    assert inj["counts"][4][:2] == [25, 25]
    assert np.allclose(inj["at5"]["d"], 2e-4)
    assert np.allclose(inj["at5"]["rho"], 800.0)


@pytest.mark.parametrize("mode", ["coupled", "uncoupled"])
def test_piso_momentum_source_matches_reference_f64(rec, mode):
    """PISO takes `mom_src` as the reference does: the carrier's U and p,
    the source and the cloud agree at rtol 1e-9 with and without it."""
    r = rec["coupling"][mode]
    assert_errs(r["cloud"], mode)
    for k in ("U", "p", "src"):
        assert r[k]["ok"], (mode, k, r[k])
    assert r["finite"]


def test_two_way_momentum_coupling(rec):
    """The falling parcels drag the carrier down (the reference test's
    oracle), and the exchanged momentum points down."""
    c, u = rec["coupling"]["coupled"], rec["coupling"]["uncoupled"]
    assert c["uy_min"] < u["uy_min"] - 1e-4
    assert u["src_y_sum"][-1] < 0.0


def test_kinematic_parcel_app_matches_reference_f64(rec):
    app = rec["app"]
    assert_errs(app["errs"], "app cloud")
    assert app["times"][0] == app["times"][1]
    assert app["logs"]["words"] and app["logs"]["numbers"], app["logs"]
    assert app["files"], "no cloud written"
    for t, f in app["files"].items():
        assert f["names"][0] == f["names"][1] == ["kinematicCloud/U",
                                                  "kinematicCloud/origId",
                                                  "kinematicCloud/positions"]
        assert not f["bad"], (t, f["bad"])
    assert app["n_active"] >= 1 and app["finite"] and app["x_mean"] > 0.3
    assert "Cloud<basicKinematicParcel>" in app["positions"]


def test_kinematic_applications_run_their_tutorial(tmp_path):
    """fallingCloud through `python -m foamtpu_torch run -device cpu`, for
    both names the reference registers: 16 parcels fall and stay in."""
    names = ("icoUncoupledKinematicParcelFoam",
             "uncoupledKinematicParcelFoam")
    runs = cli_runs(names, 20, str(tmp_path))
    for name, (rc, so, se, d) in runs.items():
        assert rc == 0, (name, se[-2000:])
        counts = [int(x) for x in
                  __import__("re").findall(r"active parcels = (\d+)", so)]
        assert counts == [16] * 20, (name, counts)
        pos = os.path.join(d, "0.1", "lagrangian", "kinematicCloud",
                           "positions")
        assert os.path.exists(pos), os.listdir(d)
    assert tapps.APPLICATIONS[names[0]] is tapps.APPLICATIONS[names[1]]


def test_cloud_on_cpu_tensor_stays_on_cpu():
    """The entry points keep the mesh's device: a cloud made on a CPU mesh
    is on the CPU, its cell index int64 and its flags bool."""
    from foamtpu_torch.apps.cases import make_cavity

    mesh, _, _ = make_cavity(4, device="cpu")
    c = tlag.make_cloud(mesh, [[0.05, 0.05, 0.005]], (0, 0, 0), 1e-4,
                        1000.0, n_slots=4)
    assert c.x.device.type == "cpu" and c.cell.dtype == torch.int64
    assert c.active.dtype == torch.bool and int(c.n_active) == 1


# -- the goldens of chip_smoke.py's lagrangian phase -----------------------------


def reference_lagrangian(perturb=False, seed=None, names=None):
    """chip_smoke.lagrangian_summary of each run of chip_smoke.LAG_RUNS but
    LAG_RANDOM, from the JAX package's applications on the CPU at the runs'
    depths, in the precision the environment gives it (float32;
    FOAMTPU_X64=1 JAX_ENABLE_X64=1 for float64); `perturb` starts from
    chip_smoke.perturb_case's start (U, p and T times 1 + 1e-7 n, n from
    `seed`, SLICE17_SEED by default); `names` picks runs."""
    import contextlib
    import io
    import tempfile

    from foamtpu.apps.cli import main as jcli
    from foamtpu.core.case import run_case as jrun

    out = {}
    root = tempfile.mkdtemp()
    for name, steps in chip_smoke.LAG_RUNS.items():
        if name in chip_smoke.LAG_RANDOM or (names and name not in names):
            continue
        with contextlib.redirect_stdout(io.StringIO()):
            d = chip_smoke.slice17_case(REPO, os.path.join(root, name), name,
                                        jcli,
                                        edits=chip_smoke.LAG_EDITS.get(
                                            name, ()))
            if perturb:
                chip_smoke.perturb_case(
                    d, chip_smoke.SLICE17_SEED if seed is None else seed)
            jc = jrun(d, max_steps=steps)
        s = chip_smoke.lagrangian_summary(jc.final_state,
                                          np.asarray(jc.mesh.v), np.asarray)
        s["steps"] = jc.time.index
        out[name] = s
    return out


def lagrangian_spread(f32, f64, *perturbed):
    """Per run and key: the largest of |f32 - f64| and |perturbed - f32|
    over the perturbed runs (those that hold the run)."""
    return {n: {k: max([abs(f32[n][k] - f64[n].get(k, f32[n][k]))]
                       + [abs(p[n].get(k, f32[n][k]) - f32[n][k])
                          for p in perturbed if n in p])
                for k, v in g.items()
                if isinstance(v, float) and not isinstance(v, bool)}
            for n, g in f32.items()}


if __name__ == "__main__":
    # python tests/test_torch_lagrangian.py goldens [--perturb [seed]]
    # [name ...]: the JSON of reference_lagrangian (the environment sets
    # float32 or float64); python tests/test_torch_lagrangian.py spread
    # f32.json f64.json perturbed.json [perturbed2.json ...]: LAG_SPREAD
    if sys.argv[1] == "goldens":
        args = sys.argv[2:]
        seed = None
        if "--perturb" in args and args.index("--perturb") + 1 < len(args) \
                and args[args.index("--perturb") + 1].isdigit():
            seed = int(args.pop(args.index("--perturb") + 1))
        names = [a for a in args if not a.startswith("--")] or None
        print(json.dumps(reference_lagrangian("--perturb" in args, seed,
                                              names)))
    elif sys.argv[1] == "spread":
        runs = [json.load(open(p)) for p in sys.argv[2:]]
        print(json.dumps(lagrangian_spread(*runs)))
