"""foamtpu_torch PISO slice end to end.

- The icoFoam cavity goldens of tests/test_cavity.py (20^2, 100 steps of
  dt=0.005, PCG pressure), run through the port on the CPU: the same
  checks and tolerances as the reference's own test.
- float64 parity (subprocess with FOAMTPU_X64=1 JAX_ENABLE_X64=1): 3
  PISO steps of the 32^2 cavity with GAMG (n_coarsest=64: 4 levels, the
  strided V-cycle) in both packages from the same mesh, hierarchy and
  state. Fields agree to rtol 1e-9 (float64 round-off through a few
  dozen solver iterations stays near 1e-12; atol 1e-9 of each field's
  scale for entries that are ~0), and every linear solve takes the same
  number of iterations.
- The time schemes, in the same float64 way (a second subprocess): 3 PISO
  steps of the 16^2 cavity each with `backward` and `CrankNicolson 0.9`
  (PCG pressure), the history entries U00, rdt0 and ddt0_U included, and
  the fvm ddt operators themselves on seeded fields at rtol 1e-12.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from foamtpu_torch.apps.cases import make_cavity
from foamtpu_torch.solvers import piso

from test_cavity import GOLDEN_KE, GOLDEN_UCL, GOLDEN_VCL

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def port_cavity20():
    mesh, state, cfg = make_cavity(20, device="cpu")
    cfg = cfg._replace(p_controls={
        "solver": "PCG", "preconditioner": "diagonal",
        "tolerance": 1e-6, "relTol": 0.0, "maxIter": 2000})
    step = piso.make_step(mesh, cfg)
    prev = None
    for _ in range(100):
        prev = state["U"].data
        state, diag = step(state, 0.005)
    du = float(torch.max(torch.abs(state["U"].data - prev)))
    return mesh, state, diag, du


def test_port_cavity_runs_and_converges(port_cavity20):
    mesh, state, diag, du = port_cavity20
    u = state["U"].data.numpy()
    assert np.abs(u).max() <= 1.0 + 1e-3
    assert np.abs(u[:, 2]).max() < 1e-6
    assert float(diag["continuity"]) < 1e-5
    assert du < 2e-4
    assert float(diag["p_final"]) < 1e-6


def test_port_cavity_regression_goldens(port_cavity20):
    mesh, state, diag, du = port_cavity20
    u_grid = state["U"].data.numpy().reshape(20, 20, 3)
    ucl = 0.5 * (u_grid[9, :, 0] + u_grid[10, :, 0])
    vcl = 0.5 * (u_grid[:, 9, 1] + u_grid[:, 10, 1])
    np.testing.assert_allclose(ucl, GOLDEN_UCL, atol=2e-4)
    np.testing.assert_allclose(vcl, GOLDEN_VCL, atol=2e-4)
    ke = float(np.mean(np.sum(u_grid ** 2, axis=-1)))
    np.testing.assert_allclose(ke, GOLDEN_KE, rtol=1e-3)


def rotating_options(mesh):
    """An MRF zone over the cavity's centre and a semiImplicitSource on U:
    the fv_options and mrf a config can carry (tests/test_torch_mrf.py and
    tests/test_torch_fvoptions.py hold them to the JAX package)."""
    from foamtpu_torch.core.dictionary import parse_string
    from foamtpu_torch.models import fvoptions, mrf

    zones = mrf.from_dict(mesh, parse_string(
        "rotor { selectionMode cylinder; origin (0.05 0.05 0); "
        "axis (0 0 1); radius 0.02; omega 5; }"))
    opts = fvoptions.from_dict(mesh, parse_string(
        "src { type semiImplicitSource; semiImplicitSourceCoeffs { "
        "selectionMode all; injectionRateSuSp { U ((0.1 0 0) -0.5); } } }"))
    return {"mrf": zones, "fv_options": opts}


def test_port_rejects_features_outside_slice():
    mesh, state, cfg = make_cavity(4, device="cpu")
    # turbulence, the div(phi,U) schemes (pisoFoam,
    # tests/test_torch_pisoturb.py), nu_fn (nonNewtonianIcoFoam,
    # tests/test_torch_basic.py), fvOptions and MRF zones are ported
    for name, value in rotating_options(mesh).items():
        new, _ = piso.piso_step(mesh, state, 0.005,
                                cfg._replace(**{name: value}))
        assert bool(torch.isfinite(new["U"].data).all()), name
    # a lagrangian momentum source (state["mom_src"]) is taken as the
    # reference takes it, mom_src / V in UEqn (its f64 parity:
    # tests/test_torch_lagrangian.py)
    # (a shear force, f_x growing with y: no pressure gradient balances it)
    y = mesh.c[:, 1] - mesh.c[:, 1].mean()
    src = torch.zeros_like(state["U"].data)
    src[:, 0] = 10.0 * y * mesh.v
    new, _ = piso.piso_step(mesh, dict(state, mom_src=src), 0.005, cfg)
    ref, _ = piso.piso_step(mesh, state, 0.005, cfg)
    assert bool(torch.isfinite(new["U"].data).all())
    gain = new["U"].data[:, 0] - ref["U"].data[:, 0]
    assert float((gain * y).sum()) > 0.0
    assert float(gain.abs().max()) < 10.0 * float(y.abs().max()) * 0.005
    # the second-order time schemes are ported; a scheme that is not a
    # ddtScheme is refused as the reference refuses it
    with pytest.raises(ValueError, match="ddtScheme"):
        piso.piso_step(mesh, state, 0.005,
                       cfg._replace(ddt_scheme="localEuler"))


F64_BODY = r"""
import json
import jax, jax.numpy as jnp, numpy as np, torch

from foamtpu.apps.cases import make_cavity as jmake_cavity
from foamtpu.solvers import linear as jlinear
from foamtpu.solvers import piso as jpiso

import foamtpu_torch.solvers.linear as tlinear
from foamtpu_torch.convert import (levels_from_numpy, mesh_from_numpy,
                                   state_from_numpy)
from foamtpu_torch.solvers import piso as tpiso
from foamtpu_torch.solvers.linear.gamg import GAMG

torch.set_num_threads(2)
assert jnp.zeros(1).dtype == jnp.float64, "x64 mode not active"
N = 32
CTL = {"solver": "GAMG", "tolerance": 1e-8, "relTol": 0.0, "maxIter": 200}
jm, jst, jcfg = jmake_cavity(N, p_solver=CTL)
assert len(jcfg.p_controls["_gamg"].levels) == 4

tm = mesh_from_numpy(jm, device="cpu")
tst = state_from_numpy(jst, device="cpu")
tg = GAMG(tm, levels=levels_from_numpy(jcfg.p_controls["_gamg"].levels,
                                       device="cpu"))
tcfg = tpiso.PisoConfig(nu=jcfg.nu, p_controls=dict(CTL, _gamg=tg),
                        u_controls=dict(jcfg.u_controls))
assert tm.v.dtype == torch.float64

def recorder(mod):
    rec = []
    orig = mod.solve
    def solve(*a, **k):
        out = orig(*a, **k)
        rec.append(out[1].n_iterations)
        return out
    mod.solve = solve
    return rec

jrec, trec = recorder(jlinear), recorder(tlinear)

@jax.jit
def jstep(state, dt):
    jrec.clear()
    st, d = jpiso.piso_step(jm, state, dt, jcfg)
    return st, d["continuity"], list(jrec)

dt = 0.5 * (0.1 / N)
out = {"steps": []}
for i in range(3):
    jst, jcont, jits = jstep(jst, jnp.asarray(dt, jnp.float64))
    trec.clear()
    tst, tdiag = tpiso.piso_step(tm, tst, dt, tcfg)
    errs = {}
    for k, (a, b) in {"U": (tst["U"].data, jst["U"].data),
                      "p": (tst["p"].data, jst["p"].data),
                      "phi": (tst["phi"], jst["phi"])}.items():
        a, b = a.numpy(), np.asarray(b)
        scale = float(np.abs(b).max())
        ok = np.allclose(a, b, rtol=1e-9, atol=1e-9 * scale)
        errs[k] = {"ok": bool(ok), "max_abs": float(np.abs(a - b).max()),
                   "scale": scale}
    out["steps"].append({
        "errs": errs, "jax_iters": [int(x) for x in jits],
        "port_iters": [int(x) for x in trec],
        "continuity": [float(jcont), float(tdiag["continuity"])]})
print(json.dumps(out))
"""


def test_f64_parity_with_reference_gamg():
    env = dict(os.environ)
    env.update(FOAMTPU_X64="1", JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               FOAMTPU_GAMG_NC="64")
    r = subprocess.run([sys.executable, "-c", F64_BODY], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert len(out["steps"]) == 3
    for i, st in enumerate(out["steps"]):
        assert len(st["jax_iters"]) == 3, st        # U, p, pFinal
        assert st["port_iters"] == st["jax_iters"], (i, st)
        for k, e in st["errs"].items():
            assert e["ok"], (i, k, e)


DDT_BODY = r"""
import json
import jax, jax.numpy as jnp, numpy as np, torch

from foamtpu.apps.cases import make_cavity as jmake_cavity
from foamtpu.ops import fvm as jfvm
from foamtpu.solvers import linear as jlinear
from foamtpu.solvers import piso as jpiso

import foamtpu_torch.solvers.linear as tlinear
from foamtpu_torch.convert import (config_from_reference, field_from_numpy,
                                   matrix_from_numpy, mesh_from_numpy,
                                   state_from_numpy, tensor)
from foamtpu_torch.ops import fvm as tfvm
from foamtpu_torch.solvers import piso as tpiso

torch.set_num_threads(2)
assert jnp.zeros(1).dtype == jnp.float64, "x64 mode not active"
N = 16
CTL = {"solver": "PCG", "preconditioner": "diagonal", "tolerance": 1e-9,
       "relTol": 0.0, "maxIter": 2000}
jm, jst0, jcfg0 = jmake_cavity(N, p_solver=CTL)
tm = mesh_from_numpy(jm, device="cpu")


def err(a, b, rtol):
    a = a.numpy() if hasattr(a, "numpy") else np.asarray(a)
    b = np.asarray(b)
    scale = float(np.abs(b).max())
    return {"ok": bool(a.shape == b.shape and np.allclose(
                a, b, rtol=rtol, atol=rtol * scale)),
            "max_abs": float(np.abs(a - b).max()), "scale": scale}


def recorder(mod):
    rec = []
    orig = mod.solve
    def solve(*a, **k):
        out = orig(*a, **k)
        rec.append(out[1].n_iterations)
        return out
    mod.solve = solve
    return rec


jrec, trec = recorder(jlinear), recorder(tlinear)
out = {}
for scheme in ("backward", "CrankNicolson 0.9"):
    jcfg = jcfg0._replace(ddt_scheme=scheme)
    tcfg = config_from_reference(tpiso.PisoConfig, jcfg)
    jst = jpiso.initial_state(jm, jst0["U"], jst0["p"], ddt_scheme=scheme)
    tst = state_from_numpy(jst, device="cpu")
    ti = tpiso.initial_state(tm, tst["U"], tst["p"], ddt_scheme=scheme)
    assert sorted(ti) == sorted(tst), (sorted(ti), sorted(tst))

    @jax.jit
    def jstep(state, dt):
        jrec.clear()
        st, d = jpiso.piso_step(jm, state, dt, jcfg)
        return st, d["continuity"], list(jrec)

    steps = []
    # a varying step, so that the variable-dt coefficients are exercised
    for dt in (0.004, 0.005, 0.003):
        jst, jcont, jits = jstep(jst, jnp.asarray(dt))
        trec.clear()
        tst, tdiag = tpiso.piso_step(tm, tst, dt, tcfg)
        hist = ("U00", "rdt0") if scheme == "backward" else ("ddt0_U", "rdt0")
        pairs = {"U": (tst["U"].data, jst["U"].data),
                 "p": (tst["p"].data, jst["p"].data),
                 "phi": (tst["phi"], jst["phi"]),
                 "U0": (tst["U0"], jst["U0"])}
        pairs.update({k: (tst[k], jst[k]) for k in hist})
        steps.append({"errs": {k: err(a, b, 1e-9)
                               for k, (a, b) in pairs.items()},
                      "jax_iters": [int(x) for x in jits],
                      "port_iters": [int(x) for x in trec]})
    out[scheme.split()[0]] = steps

# the operators on seeded fields
rng = np.random.default_rng(4)
n = jm.n_cells
jU = jst0["U"].with_data(jnp.asarray(rng.standard_normal((n, 3))))
jp = jst0["p"].with_data(jnp.asarray(rng.standard_normal(n)))
ops = {}
for name, jf in (("U", jU), ("p", jp)):
    tf = field_from_numpy(jf, device="cpu")
    shape = tuple(np.asarray(jf.data).shape)
    old, old2, d0 = (rng.standard_normal(shape) for _ in range(3))
    mats = {
        "d2dt2": (tfvm.d2dt2(tm, tf, tensor(old, device="cpu"),
                             tensor(old2, device="cpu"), 200.0),
                  jfvm.d2dt2(jm, jf, jnp.asarray(old), jnp.asarray(old2),
                             200.0)),
        "backward": (tfvm.ddt_backward(tm, tf, tensor(old, device="cpu"),
                                       tensor(old2, device="cpu"),
                                       tensor(200.0, device="cpu"),
                                       tensor(250.0, device="cpu")),
                     jfvm.ddt_backward(jm, jf, jnp.asarray(old),
                                       jnp.asarray(old2), jnp.asarray(200.0),
                                       jnp.asarray(250.0))),
        "backward_first": (
            tfvm.ddt_backward(tm, tf, tensor(old, device="cpu"),
                              tensor(old2, device="cpu"),
                              tensor(200.0, device="cpu"),
                              tensor(1e-30, device="cpu")),
            jfvm.ddt_backward(jm, jf, jnp.asarray(old), jnp.asarray(old2),
                              jnp.asarray(200.0), jnp.asarray(1e-30))),
        "cn": (tfvm.ddt_crank_nicolson(tm, tf, tensor(old, device="cpu"),
                                       tensor(d0, device="cpu"),
                                       tensor(200.0, device="cpu"), 0.9,
                                       rdt0=tensor(250.0, device="cpu")),
               jfvm.ddt_crank_nicolson(jm, jf, jnp.asarray(old),
                                       jnp.asarray(d0), jnp.asarray(200.0),
                                       0.9, rdt0=jnp.asarray(250.0))),
        "cn_first": (tfvm.ddt_crank_nicolson(tm, tf, tensor(old, device="cpu"),
                                             tensor(d0, device="cpu"),
                                             tensor(200.0, device="cpu"), 0.9,
                                             rdt0=tensor(1e-30, device="cpu")),
                     jfvm.ddt_crank_nicolson(jm, jf, jnp.asarray(old),
                                             jnp.asarray(d0),
                                             jnp.asarray(200.0), 0.9,
                                             rdt0=jnp.asarray(1e-30))),
    }
    for k, (tmx, jmx) in mats.items():
        ops[f"{k}_{name}_diag"] = err(tmx.diag, jmx.diag, 1e-12)
        ops[f"{k}_{name}_source"] = err(tmx.source, jmx.source, 1e-12)
        assert tmx.dims.exponents() == tuple(jmx.dims.exponents())
    for k, r0 in (("cn_update", 250.0), ("cn_update_first", 1e-30)):
        ops[f"{k}_{name}"] = err(
            tfvm.ddt_cn_update(tf.data, tensor(old, device="cpu"),
                               tensor(d0, device="cpu"),
                               tensor(200.0, device="cpu"), 0.9,
                               rdt0=tensor(r0, device="cpu")),
            jfvm.ddt_cn_update(jf.data, jnp.asarray(old), jnp.asarray(d0),
                               jnp.asarray(200.0), 0.9,
                               rdt0=jnp.asarray(r0)), 1e-12)
out["ops"] = ops
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ddt_run():
    env = dict(os.environ)
    env.update(FOAMTPU_X64="1", JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", DDT_BODY], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("scheme", ["backward", "CrankNicolson"])
def test_f64_time_scheme_parity(ddt_run, scheme):
    steps = ddt_run[scheme]
    assert len(steps) == 3
    for i, st in enumerate(steps):
        assert len(st["jax_iters"]) == 3, st        # U, p, p
        assert st["port_iters"] == st["jax_iters"], (scheme, i, st)
        for k, e in st["errs"].items():
            assert e["ok"], (scheme, i, k, e)


def test_f64_ddt_operator_parity(ddt_run):
    ops = ddt_run["ops"]
    assert len(ops) == 24
    for k, e in ops.items():
        assert e["ok"] and e["scale"] > 0, (k, e)
