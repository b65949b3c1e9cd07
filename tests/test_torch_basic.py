"""foamtpu_torch nonNewtonianIcoFoam, laplacianFoam, scalarTransportFoam
and potentialFoam against the JAX package, and the five viscosity models.

- float64 parity (one subprocess with FOAMTPU_X64=1 JAX_ENABLE_X64=1):
  each tutorial as shipped (crossCavity, heatedBlock, pulse after
  setFields, channel) through both packages' blockMesh and application,
  5 steps (channel: its one solve); every field of the final state at
  1e-9 of its scale and the iteration count of every linear solve equal,
  read from the two logs. potentialFoam's one PCG solve is held to +-1
  iteration with both final residuals under the tolerance: its count is
  decided by round-off (perturbing the right side by 1e-15 relative
  moves it between 46 and 47 in either package), see
  test_application_matches_reference_f64. Then the five transport models
  (Newtonian, powerLaw, CrossPowerLaw, BirdCarreau, HerschelBulkley) and
  the strain rate on a seeded velocity on the 16^2 cavity, at 1e-12.
- The goldens of chip_smoke.py's basic phase come from `reference_basic`:
  the JAX package on the CPU in float32, the phase's steps. One test
  re-derives them (rtol 1e-4); one runs the port's application on the CPU
  in float32 against them at chip_smoke's 1e-3, with the phase's
  invariants.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from foamtpu_torch.apps.cli import main as tcli
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.solvers import apps as tapps

import chip_smoke
from test_torch_simple import REPO

torch.set_num_threads(2)

APPS = list(chip_smoke.BASIC_CASES)
MODELS = ["Newtonian", "powerLaw", "CrossPowerLaw", "BirdCarreau",
          "HerschelBulkley"]
TRANSPORT = """
nu nu [0 2 -1 0 0 0 0] 1e-05;
powerLawCoeffs { k k [0 2 -1 0 0 0 0] 0.01; n n [0 0 0 0 0 0 0] 0.6;
                 nuMin nuMin [0 2 -1 0 0 0 0] 1e-05;
                 nuMax nuMax [0 2 -1 0 0 0 0] 0.1; }
CrossPowerLawCoeffs { nu0 nu0 [0 2 -1 0 0 0 0] 0.01;
                      nuInf nuInf [0 2 -1 0 0 0 0] 1e-05;
                      m m [0 0 1 0 0 0 0] 1; n n [0 0 0 0 0 0 0] 0.5; }
BirdCarreauCoeffs { nu0 nu0 [0 2 -1 0 0 0 0] 0.01;
                    nuInf nuInf [0 2 -1 0 0 0 0] 1e-05;
                    k k [0 0 1 0 0 0 0] 1; n n [0 0 0 0 0 0 0] 0.5; }
HerschelBulkleyCoeffs { nu0 nu0 [0 2 -1 0 0 0 0] 0.01;
                        tau0 tau0 [0 2 -2 0 0 0 0] 0.001;
                        k k [0 2 -1 0 0 0 0] 0.001;
                        n n [0 0 0 0 0 0 0] 0.5; }
"""
STEPS = 5


def run_both(root, app, steps):
    """The tutorial through the JAX package and the port (on the CPU),
    `steps` steps each; returns (reference case, port case, reference
    log, port log)."""
    from foamtpu.apps.cli import main as jcli
    from foamtpu.core.case import run_case as jrun

    dj = chip_smoke.basic_case(REPO, app, os.path.join(root, "ref"), jcli)
    dt_ = chip_smoke.basic_case(REPO, app, os.path.join(root, "port"), tcli,
                                ("-device", "cpu"))
    logs = []
    for run in (lambda: jrun(dj, max_steps=steps),
                lambda: tapps.run(TCase(dt_, device="cpu"), max_steps=steps)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            case = run()
        logs.append((case, buf.getvalue()))
    return logs[0][0], logs[1][0], logs[0][1], logs[1][1]


def iterations(log):
    return [int(line.rsplit(" ", 1)[1]) for line in log.splitlines()
            if "No Iterations" in line]


F64_BODY = """
import json, sys, tempfile
sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp
import numpy as np
import torch
import test_torch_basic as T

out = {}
for app in T.APPS:
    jc, tc, jlog, tlog = T.run_both(tempfile.mkdtemp(), app, T.STEPS)
    errs = {}
    for name, v in jc.final_state.items():
        if isinstance(v, (tuple, dict)):
            continue
        r = np.asarray(v.data if hasattr(v, "data") else v)
        g = tc.final_state[name]
        g = (g.data if hasattr(g, "data") else g).numpy()
        assert r.dtype == g.dtype == np.float64, name
        errs[name] = float(np.abs(g - r).max() / np.abs(r).max())
    out[app] = {"errs": errs, "ref_iters": T.iterations(jlog),
                "port_iters": T.iterations(tlog),
                "index": [jc.time.index, tc.time.index],
                "ref_final": [float(l.split("Final residual = ")[1]
                                    .split(",")[0])
                              for l in jlog.splitlines() if "Final" in l],
                "port_final": [float(l.split("Final residual = ")[1]
                                     .split(",")[0])
                               for l in tlog.splitlines() if "Final" in l]}

from foamtpu.core.dictionary import parse_string as jparse
from foamtpu.apps.cases import CAVITY_BLOCKMESH
from foamtpu.core.fields import vol_vector as jvv
from foamtpu.mesh import blockmesh as jblockmesh, to_device as jto_device
from foamtpu.models import transport as jtr
from foamtpu_torch.convert import field_from_numpy, mesh_from_numpy
from foamtpu_torch.core.dictionary import parse_string as tparse
from foamtpu_torch.models import transport as ttr

jm = jto_device(jblockmesh.generate(
    jparse(CAVITY_BLOCKMESH.replace("{n}", "16"))))
tm = mesh_from_numpy(jm, device="cpu")
rng = np.random.default_rng(3)
u = rng.standard_normal((jm.n_cells, 3)) * [1.0, 1.0, 0.0]
jU = jvv(jm, jnp.zeros(3)).with_data(jnp.asarray(u))
tU = field_from_numpy(jU, device="cpu")


def rel(g, r):
    g, r = g.numpy(), np.asarray(r)
    assert g.dtype == r.dtype == np.float64 and g.shape == r.shape
    return float(np.abs(g - r).max() / np.abs(r).max())


out["strain_rate"] = rel(ttr.strain_rate(tm, tU),
                         jax.jit(jtr.strain_rate)(jm, jU))
for name in T.MODELS:
    text = f"transportModel {name};" + T.TRANSPORT
    jnu = jax.jit(jtr.select(jparse(text)))(jm, jU)
    tnu = ttr.select(tparse(text))(tm, tU)
    out[name] = rel(tnu, jnu)
    out[name + "_spread"] = float(np.ptp(np.asarray(jnu)))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def f64():
    env = dict(os.environ)
    env.update(FOAMTPU_X64="1", JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", F64_BODY, os.path.dirname(__file__)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("app", APPS)
def test_application_matches_reference_f64(f64, app):
    res = f64[app]
    want = 0 if app == "potentialFoam" else STEPS
    assert res["index"] == [want, want]
    assert res["errs"], app
    for name, err in res["errs"].items():
        assert err <= 1e-9, (app, name, err)
    ref, got = res["ref_iters"], res["port_iters"]
    assert len(ref) == len(got) > 0
    if app == "potentialFoam":
        # one PCG solve to tolerance 1e-9: the last iteration is decided
        # by round-off (module docstring); both stop under the tolerance
        assert abs(ref[0] - got[0]) <= 1, (ref, got)
        assert max(res["ref_final"] + res["port_final"]) < 1e-9
    else:
        assert got == ref


@pytest.mark.parametrize("model", MODELS)
def test_transport_model_matches_reference_f64(f64, model):
    assert f64["strain_rate"] <= 1e-12
    assert f64[model] <= 1e-12, (model, f64[model])
    if model != "Newtonian":        # the seeded U does exercise the model
        assert f64[model + "_spread"] > 0


def test_basic_applications_are_registered():
    for app in APPS:
        assert app in tapps.APPLICATIONS


# ---------------------------------------------------------------------------
# the basic phase's goldens of chip_smoke.py
# ---------------------------------------------------------------------------


def reference_basic(root, app, steps=None):
    """The goldens' source: the tutorial through the JAX package's
    blockMesh, setFields and application on the CPU in float32, the basic
    phase's steps."""
    from foamtpu.apps.cli import main as jcli
    from foamtpu.core.case import run_case as jrun
    from foamtpu.models import transport as jtr

    steps = steps or chip_smoke.BASIC_CASES[app][1]
    d = chip_smoke.basic_case(REPO, app, str(root), jcli)
    with contextlib.redirect_stdout(io.StringIO()):
        case = jrun(d, max_steps=steps)
    st = case.final_state
    a = {k: np.asarray(st[k].data) for k in ("U", "p", "T") if k in st}
    if app == "nonNewtonianIcoFoam":
        a["nu"] = np.asarray(jtr.select(case.transport_properties())(
            case.mesh, st["U"]))
    return chip_smoke.basic_scalars(app, a)


@pytest.mark.parametrize("app", APPS)
def test_basic_goldens_come_from_the_reference(tmp_path, app):
    got = reference_basic(tmp_path, app)
    for name, gold in chip_smoke.BASIC_GOLDEN[app].items():
        np.testing.assert_allclose(got[name], gold, rtol=1e-4,
                                   err_msg=f"{app} {name}")


@pytest.mark.parametrize("app", APPS)
def test_port_basic_f32_meets_goldens(tmp_path, app):
    """What chip_smoke's basic phase checks on the card, here on the CPU:
    the port's application on the tutorial in float32, the invariants and
    the goldens at 1e-3 relative."""
    d = chip_smoke.basic_case(REPO, app, str(tmp_path), tcli,
                              ("-device", "cpu"))
    case = TCase(d, device="cpu")
    t_sum0 = None
    if app == "scalarTransportFoam":
        t_sum0 = float(torch.sum(case.read_field("T").data * case.mesh.v))
    with contextlib.redirect_stdout(io.StringIO()):
        tapps.run(case, max_steps=chip_smoke.BASIC_CASES[app][1])
    assert case.mesh.v.dtype == torch.float32
    a = chip_smoke.basic_arrays(app, case)
    _, checks = chip_smoke.basic_invariants(app, case, a, t_sum0)
    assert all(checks.values()), checks
    rel = chip_smoke.golden_rel_err(chip_smoke.basic_scalars(app, a),
                                    chip_smoke.BASIC_GOLDEN[app],
                                    chip_smoke.BASIC_FLOOR)
    assert max(rel.values()) <= 1e-3, rel
