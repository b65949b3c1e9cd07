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
    mesh, state, cfg = make_cavity(20)
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


def test_port_rejects_features_outside_slice():
    mesh, state, cfg = make_cavity(4)
    for bad in (dict(turb=object()), dict(div_scheme="upwind"),
                dict(ddt_scheme="backward"), dict(mrf=object())):
        with pytest.raises(NotImplementedError):
            piso.piso_step(mesh, state, 0.005, cfg._replace(**bad))


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

tm = mesh_from_numpy(jm)
tst = state_from_numpy(jst)
tg = GAMG(tm, levels=levels_from_numpy(jcfg.p_controls["_gamg"].levels))
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
