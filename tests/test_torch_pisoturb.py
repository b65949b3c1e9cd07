"""foamtpu_torch pisoFoam (PISO + a turbulence model) against the JAX
package.

- The case readers: `Case.ddt_scheme` and `apps._piso_config` on the
  unmodified pisoFoam cavityRAS tutorial give the PisoConfig that the
  reference's `_run_piso` builds (PISO dict, schemes, p/U/k controls).
- The cavityRAS goldens of chip_smoke.py (kinetic energy, max k, max
  nut and the centreline Ux at 5 points after the tutorial's 200 steps)
  come from this file's `reference_cavity_ras`: the JAX package on the
  CPU in float32. The test re-derives them (rtol 1e-4 leaves room for
  another CPU's vector width), and runs the port on the CPU in float32
  through the same 200 steps against them at chip_smoke's tolerance,
  1e-3 relative, with its oracles.
- float64 parity (one subprocess with FOAMTPU_X64=1 JAX_ENABLE_X64=1):
  3 PISO + kOmegaSST steps of tests/test_turbulence.py's channel
  (test_komegasst_channel's mesh, BCs, model and controls: limitedLinear
  1, PCG p, PBiCGStab U), and 3 steps of cavityRAS (kEpsilon with wall
  functions, limitedLinearV 1, GAMG p) from its case files. U, p, phi
  and the turbulence fields at rtol 1e-9 (atol 1e-9 of each field's
  scale) with equal iteration counts of every linear solve. cavityRAS
  starts from its case files with k and epsilon scaled cell by cell by
  1 + 0.2u (seeded), as tests/test_torch_simple.py does for pitzDaily.
  FOAMTPU_GAMG_NC=64 gives the cavity's pressure solve real GAMG levels.
  The channel starts from a seeded perturbation of its fields (Ux by
  1 + 0.1u, Uy + 0.05n, k and omega by 1 + 0.2u): from the test's
  uniform U, the limiter ratio r on faces where U is still uniform is a
  ratio of round-off, its weights differ at O(1) between the packages,
  and the two momentum matrices agree only to the solver tolerance
  (fields 1e-9 apart after the second step, one p iteration more or
  less), as PR 2 found for pitzDaily's uniform k and epsilon.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from foamtpu_torch.apps.cli import main as tcli
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.core.dictionary import dimensioned_scalar
from foamtpu_torch.solvers import piso
from foamtpu_torch.solvers.apps import _load_turbulence, _piso_config

import chip_smoke
from test_torch_simple import REPO

torch.set_num_threads(2)

CAVITY_RAS = os.path.join(REPO, chip_smoke.CAVITY_RAS_CASE)


def ras_case(root, cli=tcli):
    dst = os.path.join(str(root), "cavityRAS")
    shutil.copytree(CAVITY_RAS, dst)
    assert cli(["blockMesh", "-case", dst]) == 0
    return dst


def reference_piso_config(case, nu, model):
    """The PisoConfig of the reference's solvers/apps.py::_run_piso,
    without MRF, fvOptions and nu_fn."""
    from foamtpu.solvers import piso as jpiso

    pdict = case.pimple_controls("PISO")
    return jpiso.PisoConfig(
        nu=nu,
        n_correctors=int(pdict.get("nCorrectors", 2)),
        n_non_orth=int(pdict.get("nNonOrthogonalCorrectors", 0)),
        momentum_predictor=str(pdict.get("momentumPredictor", "yes")) in (
            "yes", "true", "on", "1"),
        corrected=case.laplacian_corrected(),
        div_scheme=case.div_scheme("div(phi,U)"),
        ddt_scheme=case.ddt_scheme(),
        grad_scheme=case.grad_scheme("grad(p)"),
        p_ref_cell=int(pdict.get("pRefCell", 0)),
        p_ref_value=float(pdict.get("pRefValue", 0.0)),
        p_controls=case.solver_controls("p"),
        u_controls=case.solver_controls("U"),
        turb=model, turb_controls=case.solver_controls("k"))


def reference_cavity_ras(root, steps=chip_smoke.CAVITY_RAS_STEPS):
    """The goldens' source: cavityRAS through the JAX package in float32
    (Case, _load_turbulence, the PisoConfig of _run_piso), `steps` steps
    of the tutorial's deltaT."""
    import jax.numpy as jnp
    from foamtpu.apps.cli import main as jcli
    from foamtpu.core.case import Case as JCase
    from foamtpu.solvers import piso as jpiso
    from foamtpu.solvers.apps import _load_turbulence as jload

    case = JCase(ras_case(root, jcli))
    mesh = case.mesh
    _, nu = dimensioned_scalar(case.transport_properties()["nu"])
    model, tstate = jload(case, nu)
    cfg = reference_piso_config(case, nu, model)
    step = jpiso.make_step(mesh, cfg)
    state = jpiso.initial_state(mesh, case.read_field("U"),
                                case.read_field("p"), turb_state=tstate)
    dt = jnp.asarray(case.control_dict["deltaT"], jnp.float32)
    for _ in range(steps):
        state, diag = step(state, dt)
    return {"U": np.asarray(state["U"].data),
            "k": np.asarray(state["turb"]["k"].data),
            "nut": np.asarray(state["turb"]["nut"].data)}


def test_piso_config_from_the_tutorial(tmp_path):
    from foamtpu.core.case import Case as JCase
    from foamtpu.solvers.apps import _load_turbulence as jload

    dst = ras_case(tmp_path)
    tc, jc = TCase(dst, device="cpu"), JCase(dst)
    assert tc.ddt_scheme() == jc.ddt_scheme() == "Euler"
    _, nu = dimensioned_scalar(tc.transport_properties()["nu"])
    tmodel, tts = _load_turbulence(tc, nu)
    jmodel, _ = jload(jc, nu)
    assert type(tmodel).__name__ == type(jmodel).__name__ == "KEpsilon"
    assert sorted(tts) == ["epsilon", "k", "nut"]
    got = _piso_config(tc, nu, tmodel)
    ref = reference_piso_config(jc, nu, jmodel)
    for name in ("nu", "n_correctors", "n_non_orth", "momentum_predictor",
                 "corrected", "corr_limit", "div_scheme", "ddt_scheme",
                 "grad_scheme", "p_ref_cell", "p_ref_value", "u_controls",
                 "turb_controls"):
        assert getattr(got, name) == getattr(ref, name), name
    assert got.div_scheme == "limitedLinearV 1" and got.turb is tmodel
    assert {k: v for k, v in got.p_controls.items() if k != "_gamg"} == \
        {k: v for k, v in ref.p_controls.items() if k != "_gamg"}
    assert got.turb_controls["solver"] == "PBiCGStab"
    assert _piso_config(tc, nu).turb is None


def test_port_rejects_ddt_schemes_outside_slice(tmp_path):
    tc = TCase(ras_case(tmp_path), device="cpu")
    _, nu = dimensioned_scalar(tc.transport_properties()["nu"])
    # CrankNicolson and backward are ported since the PIMPLE slice: their
    # history entries are set up; what is no ddtScheme is still refused
    cfg = _piso_config(tc, nu)._replace(ddt_scheme="CrankNicolson 0.9")
    st = piso.initial_state(tc.mesh, tc.read_field("U"), tc.read_field("p"),
                            ddt_scheme=cfg.ddt_scheme)
    assert float(st["ddt0_U"].abs().max()) == 0.0
    assert float(st["rdt0"]) == pytest.approx(1e-30)
    st = piso.initial_state(tc.mesh, tc.read_field("U"), tc.read_field("p"),
                            ddt_scheme="backward")
    assert torch.equal(st["U00"], st["U0"])
    with pytest.raises(ValueError, match="localEuler"):
        piso.piso_step(tc.mesh, st, 1e-3,
                       cfg._replace(ddt_scheme="localEuler"))


def test_cavity_ras_goldens_come_from_the_reference(tmp_path):
    got = chip_smoke.cavity_ras_scalars(**reference_cavity_ras(tmp_path))
    for name, gold in chip_smoke.CAVITY_RAS_GOLDEN.items():
        np.testing.assert_allclose(got[name], gold, rtol=1e-4, err_msg=name)


def test_port_cavity_ras_f32_meets_goldens(tmp_path):
    """What chip_smoke's cavity_ras phase checks on the card, here on the
    CPU: the unmodified tutorial for its 200 steps, the oracles and the
    goldens at 1e-3 relative."""
    case = TCase(ras_case(tmp_path), device="cpu")
    mesh, cfg, state = chip_smoke.cavity_ras_setup(case)
    assert mesh.v.dtype == torch.float32
    dt = float(case.control_dict["deltaT"])
    for _ in range(chip_smoke.CAVITY_RAS_STEPS):
        state, diag = piso.piso_step(mesh, state, dt, cfg)
    out, checks = chip_smoke.cavity_ras_checks(state, diag)
    assert all(checks.values()), (out, checks)


# ---------------------------------------------------------------------------
# float64 parity: the channel with kOmegaSST and cavityRAS, 3 steps each
# ---------------------------------------------------------------------------

F64_BODY = r"""
import json, os, shutil, sys, tempfile
import jax, jax.numpy as jnp, numpy as np, torch

sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
from foamtpu.apps.cli import main as jcli
from foamtpu.core.case import Case as JCase
from foamtpu.core.dictionary import dimensioned_scalar
from foamtpu.models.turbulence import select as jselect
from foamtpu.solvers import linear as jlinear
from foamtpu.solvers import piso as jpiso
from foamtpu.solvers.apps import _load_turbulence as jload

import foamtpu_torch.solvers.linear as tlinear
from foamtpu_torch.convert import (levels_from_numpy, mesh_from_numpy,
                                   state_from_numpy)
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.core.dictionary import parse_string as tparse
from foamtpu_torch.mesh import blockmesh as tblockmesh
from foamtpu_torch.models.turbulence import base as tbase
from foamtpu_torch.solvers import piso as tpiso
from foamtpu_torch.solvers.apps import _load_turbulence as tload
from foamtpu_torch.solvers.apps import _piso_config
from foamtpu_torch.solvers.linear.gamg import GAMG

import test_turbulence as jt
from test_torch_pisoturb import reference_piso_config

torch.set_num_threads(2)
assert jnp.zeros(1).dtype == jnp.float64, "x64 mode not active"


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


def run(jm, jcfg, jst, tm, tcfg, tst, dt, turb_names):
    @jax.jit
    def jstep(state):
        jrec.clear()
        st, d = jpiso.piso_step(jm, state, jnp.asarray(dt), jcfg)
        return st, d["continuity"], list(jrec)

    steps = []
    for i in range(3):
        jst, jcont, jits = jstep(jst)
        trec.clear()
        tst, tdiag = tpiso.piso_step(tm, tst, dt, tcfg)
        pairs = {"U": (tst["U"].data, jst["U"].data),
                 "p": (tst["p"].data, jst["p"].data),
                 "phi": (tst["phi"], jst["phi"])}
        for name in turb_names:
            pairs[name] = (tst["turb"][name].data, jst["turb"][name].data)
        errs = {}
        for k, (a, b) in pairs.items():
            a, b = a.numpy(), np.asarray(b)
            scale = float(np.abs(b).max())
            ok = np.allclose(a, b, rtol=1e-9, atol=1e-9 * scale)
            errs[k] = {"ok": bool(ok), "max_abs": float(np.abs(a - b).max()),
                       "scale": scale}
        steps.append({"errs": errs, "jax_iters": [int(x) for x in jits],
                      "port_iters": [int(x) for x in trec],
                      "continuity": [float(jcont),
                                     float(tdiag["continuity"])]})
    return steps


out = {}

# -- the channel of tests/test_turbulence.py::test_komegasst_channel -------
BLOCK = '''
vertices (
    (0 0 0) (2 0 0) (2 0.1 0) (0 0.1 0)
    (0 0 0.01) (2 0 0.01) (2 0.1 0.01) (0 0.1 0.01)
);
blocks ( hex (0 1 2 3 4 5 6 7) (30 10 1) simpleGrading (1 1 1) );
boundary (
    inlet { type patch; faces ((0 4 7 3)); }
    outlet { type patch; faces ((2 6 5 1)); }
    walls { type wall; faces ((1 5 4 0) (3 7 6 2)); }
    frontAndBack { type empty; faces ((0 3 2 1) (4 5 6 7)); }
);
'''
jm = jt.channel_mesh()
U, p, tstate = jt.channel_fields(jm, with_omega=True)
jmodel = jselect(jt._props("kOmegaSST"), jt.NU)
from foamtpu.mesh import blockmesh as jblockmesh
from foamtpu.core.dictionary import parse_string as jparse
jmodel.init_wall_distance(jblockmesh.generate(jparse(BLOCK)),
                          np.asarray(jm.v).dtype)
ctl = dict(p_controls={"solver": "PCG", "tolerance": 1e-7, "relTol": 0.0},
           u_controls={"solver": "PBiCGStab", "tolerance": 1e-7,
                       "relTol": 0.0})
jcfg = jpiso.PisoConfig(nu=jt.NU, n_correctors=2,
                        div_scheme="limitedLinear 1", turb=jmodel, **ctl)
# seeded start: Ux * (1 + 0.1u), Uy + 0.05n, k and omega * (1 + 0.2u)
rng = np.random.default_rng(1)
d = np.asarray(U.data).copy()
d[:, 0] *= 1.0 + 0.1 * rng.random(jm.n_cells)
d[:, 1] += 0.05 * rng.standard_normal(jm.n_cells)
U = U.with_data(jnp.asarray(d))
for name in ("k", "omega"):
    tstate[name] = tstate[name].with_data(
        tstate[name].data * jnp.asarray(1.0 + 0.2 * rng.random(jm.n_cells)))
jst = jpiso.initial_state(jm, U, p, turb_state=tstate)

tm = mesh_from_numpy(jm, device="cpu")
tmodel = tbase.select(tparse("RASModel kOmegaSST; turbulence on;"), jt.NU)
tmodel.init_wall_distance(tblockmesh.generate(tparse(BLOCK)), torch.float64,
                          device="cpu")
assert np.array_equal(tmodel.y_wall.numpy(), np.asarray(jmodel.y_wall))
tcfg = tpiso.PisoConfig(nu=jt.NU, n_correctors=2,
                        div_scheme="limitedLinear 1", turb=tmodel, **ctl)
out["channel"] = run(jm, jcfg, jst, tm, tcfg,
                     state_from_numpy(jst, device="cpu"), 0.02,
                     ("k", "omega", "nut"))

# -- pisoFoam cavityRAS from its case files ----------------------------------
dst = os.path.join(tempfile.mkdtemp(), "cavityRAS")
shutil.copytree(sys.argv[1], dst)
assert jcli(["blockMesh", "-case", dst]) == 0
jc = JCase(dst)
jm = jc.mesh
_, nu = dimensioned_scalar(jc.transport_properties()["nu"])
jmodel, jts = jload(jc, nu)
jcfg = reference_piso_config(jc, nu, jmodel)
jst = jpiso.initial_state(jm, jc.read_field("U"), jc.read_field("p"),
                          turb_state=jts)
# the tutorial's uniform k and epsilon scaled by 1 + 0.2u (as in
# tests/test_torch_simple.py)
rng = np.random.default_rng(0)
turb = dict(jst["turb"])
for name in ("k", "epsilon"):
    turb[name] = turb[name].with_data(
        turb[name].data * jnp.asarray(1.0 + 0.2 * rng.random(jm.n_cells)))
jst = dict(jst, turb=turb)
tc = TCase(dst, device="cpu")
tm = tc.mesh
tmodel, _ = tload(tc, nu)
tcfg = _piso_config(tc, nu, tmodel)
jg = jcfg.p_controls["_gamg"]
tcfg = tcfg._replace(p_controls=dict(
    tcfg.p_controls, _gamg=GAMG(tm,
                                levels=levels_from_numpy(jg.levels,
                                                         device="cpu"),
                                smoother=jg.smoother, n_pre=jg.n_pre,
                                n_post=jg.n_post)))
assert tm.v.dtype == torch.float64
dt = float(jc.control_dict["deltaT"])
out["cavityRAS"] = run(jm, jcfg, jst, tm, tcfg,
                       state_from_numpy(jst, device="cpu"), dt,
                       ("k", "epsilon", "nut"))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def f64_run():
    env = dict(os.environ)
    env.update(FOAMTPU_X64="1", JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               FOAMTPU_GAMG_NC="64")
    r = subprocess.run([sys.executable, "-c", F64_BODY, CAVITY_RAS],
                       env=env, cwd=REPO, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case,n_solves", [("channel", 5),
                                           ("cavityRAS", 5)])
def test_f64_piso_turbulence_parity(f64_run, case, n_solves):
    steps = f64_run[case]
    assert len(steps) == 3
    for i, st in enumerate(steps):
        # U, p, pFinal, then the model's two transport solves
        assert len(st["jax_iters"]) == n_solves, st
        assert st["port_iters"] == st["jax_iters"], (case, i, st)
        for k, e in st["errs"].items():
            assert e["ok"], (case, i, k, e)
        assert st["continuity"][1] < 1e-3
