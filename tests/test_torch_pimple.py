"""foamtpu_torch pimpleFoam (PIMPLE outer loop) against the JAX package.

- In process, float32: `pimple_step` with nOuterCorrectors 1 equals the
  port's `piso_step` exactly (assert_array_equal: the same operations in
  the same order; the relaxation factors must be ignored on a final
  iteration); `apps._pimple_config` on the unmodified pimpleFoam
  cavityRAS tutorial gives the PimpleConfig that the reference's
  `pimplefoam` builds; one GAMG prepare is shared by the p and pFinal
  control sets; the features outside the slice raise.
- The pimpleFoam cavityRAS goldens of chip_smoke.py (kinetic energy, max
  k, max nut, the centreline Ux after the tutorial's 200 steps) come
  from `reference_pimple_ras`: the JAX package's application on the CPU
  in float32. One test re-derives them (rtol 1e-4 leaves room for
  another CPU's vector width); one runs the port's application on the
  CPU in float32 against them at chip_smoke's 1e-3 (a few seconds: 400
  cells).
- float64 parity (one subprocess with FOAMTPU_X64=1 JAX_ENABLE_X64=1):
  nOuterCorrectors 1 against `piso_step` (exact); 3 steps of the 16^2
  cavity with n_outer=3, alpha_u=0.7, alpha_p=0.3, a pFinal control set
  and GAMG (FOAMTPU_GAMG_NC=64: real levels); 3 steps of pimpleFoam
  cavityRAS from its case files (k and epsilon scaled by 1 + 0.2u,
  seeded, as tests/test_torch_pisoturb.py does). U, p, phi and the
  turbulence fields at rtol 1e-9 (atol 1e-9 of each field's scale) with
  equal iteration counts of every linear solve.
"""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from foamtpu_torch.apps.cases import make_cavity
from foamtpu_torch.apps.cli import main as tcli
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.core.dictionary import dimensioned_scalar
from foamtpu_torch.solvers import linear, pimple, piso
from foamtpu_torch.solvers.apps import (_load_turbulence, _pimple_config,
                                        pimplefoam)

import chip_smoke
from test_torch_simple import REPO

torch.set_num_threads(2)

PIMPLE_RAS = os.path.join(REPO, chip_smoke.PIMPLE_RAS_CASE)


def pimple_case(root, cli=tcli, name="pimpleRAS"):
    dst = os.path.join(str(root), name)
    shutil.copytree(PIMPLE_RAS, dst)
    assert cli(["blockMesh", "-case", dst]) == 0
    return dst


def test_n_outer_1_equals_piso_step_exactly():
    mesh, state, pcfg = make_cavity(16, device="cpu")
    cfg1 = pimple.PimpleConfig(
        nu=pcfg.nu, n_outer=1, n_correctors=pcfg.n_correctors,
        n_non_orth=pcfg.n_non_orth, p_controls=pcfg.p_controls,
        u_controls=pcfg.u_controls,
        alpha_u=0.7, alpha_p=0.3)   # must be IGNORED on the final iteration
    s1, s2 = state, state
    for _ in range(3):
        s1, d1 = pimple.pimple_step(mesh, s1, 0.005, cfg1)
        s2, d2 = piso.piso_step(mesh, s2, 0.005, pcfg)
    for name in ("U", "p"):
        np.testing.assert_array_equal(s1[name].data.numpy(),
                                      s2[name].data.numpy())
    np.testing.assert_array_equal(s1["phi"].numpy(), s2["phi"].numpy())
    np.testing.assert_array_equal(s1["U0"].numpy(), s2["U0"].numpy())
    assert int(d1["p_iters"]) == int(d2["p_iters"]) > 0
    assert float(d1["continuity"]) == float(d2["continuity"])
    # and the chunk is the step repeated
    s3, _ = pimple.make_chunk(mesh, cfg1, 3)(state, 0.005)
    np.testing.assert_array_equal(s3["U"].data.numpy(), s1["U"].data.numpy())


def test_outer_correctors_converge_large_dt():
    """tests/test_pimple.py's check on the port: at Courant ~ 4, four
    relaxed outer correctors drive the last pressure residual down."""
    mesh, state, pcfg = make_cavity(16, device="cpu")
    cfg = pimple.PimpleConfig(
        nu=pcfg.nu, n_outer=4, n_correctors=2, alpha_u=0.7, alpha_p=0.3,
        p_controls=pcfg.p_controls, u_controls=pcfg.u_controls)
    step = pimple.make_step(mesh, cfg)
    for _ in range(3):
        state, diag = step(state, 0.025)
    assert bool(torch.isfinite(state["U"].data).all())
    assert float(diag["continuity"]) < 1e-5
    assert float(diag["p_final"]) < 1e-5


def test_prepare_controls_shares_one_prepare():
    """The GAMG prepare of the pressure matrix is built once for the p and
    pFinal control sets (pimple_step hands both to prepare_controls)."""
    mesh, state, pcfg = make_cavity(16, p_solver={
        "solver": "GAMG", "tolerance": 1e-6, "relTol": 0.05}, device="cpu")
    from foamtpu_torch.core.dimensions import dimTime
    from foamtpu_torch.ops import fvm

    gamg = pcfg.p_controls["_gamg"]
    calls = []
    orig = gamg.prepare
    gamg.prepare = lambda *a, **k: calls.append(1) or orig(*a, **k)
    pEqn = fvm.laplacian(mesh, 1.0, state["p"], corrected=False,
                         gamma_dims=dimTime)
    final = dict(pcfg.p_controls, relTol=0.0)
    a, b = linear.prepare_controls(mesh, pEqn, pcfg.p_controls, final)
    assert len(calls) == 1 and a["_prep"] is b["_prep"]
    assert a["relTol"] == 0.05 and b["relTol"] == 0.0
    # a non-GAMG final set beside a GAMG one, and an absent one
    c, d = linear.prepare_controls(mesh, pEqn, pcfg.p_controls,
                                   {"solver": "PCG"})
    assert "_prep" in c and "_prep" not in d
    assert linear.prepare_controls(mesh, pEqn, pcfg.p_controls,
                                   None)[1] is None


def reference_pimple_config(case, nu, model):
    """The PimpleConfig of the reference's solvers/apps.py::pimplefoam,
    without MRF and fvOptions."""
    from foamtpu.solvers import pimple as jpimple
    from foamtpu.solvers.apps import _relaxation

    pdict = case.pimple_controls("PIMPLE")
    relax = _relaxation(case)
    try:
        p_final = case.solver_controls("pFinal")
    except KeyError:
        p_final = None
    yes = ("yes", "true", "on", "1")
    return jpimple.PimpleConfig(
        nu=nu,
        n_outer=int(pdict.get("nOuterCorrectors", 1)),
        n_correctors=int(pdict.get("nCorrectors", 2)),
        n_non_orth=int(pdict.get("nNonOrthogonalCorrectors", 0)),
        momentum_predictor=str(pdict.get("momentumPredictor", "yes")) in yes,
        corrected=case.laplacian_corrected(),
        div_scheme=case.div_scheme("div(phi,U)"),
        ddt_scheme=case.ddt_scheme(),
        grad_scheme=case.grad_scheme("grad(p)"),
        p_ref_cell=int(pdict.get("pRefCell", 0)),
        p_ref_value=float(pdict.get("pRefValue", 0.0)),
        alpha_u=relax.get("U", 1.0), alpha_p=relax.get("p", 1.0),
        p_controls=case.solver_controls("p"), p_controls_final=p_final,
        u_controls=case.solver_controls("U"),
        turb=model, turb_controls=case.solver_controls("k"),
        turb_on_final_only=str(pdict.get("turbOnFinalIterOnly", "yes"))
        in yes)


def test_pimple_config_from_the_tutorial(tmp_path):
    from foamtpu.core.case import Case as JCase
    from foamtpu.solvers.apps import _load_turbulence as jload

    dst = pimple_case(tmp_path)
    tc, jc = TCase(dst, device="cpu"), JCase(dst)
    assert tc.application == jc.application == "pimpleFoam"
    _, nu = dimensioned_scalar(tc.transport_properties()["nu"])
    tmodel, _ = _load_turbulence(tc, nu)
    jmodel, _ = jload(jc, nu)
    got = _pimple_config(tc, nu, tmodel)
    ref = reference_pimple_config(jc, nu, jmodel)
    for name in got._fields:
        if name in ("turb", "p_controls", "fv_options", "mrf"):
            continue
        assert getattr(got, name) == getattr(ref, name), name
    assert (got.n_outer, got.n_correctors) == (2, 2)
    assert got.div_scheme == "limitedLinearV 1" and got.turb is tmodel
    assert {k: v for k, v in got.p_controls.items() if k != "_gamg"} == \
        {k: v for k, v in ref.p_controls.items() if k != "_gamg"}
    assert got.fv_options is None and got.mrf is None


def test_pimple_rejects_features_outside_slice():
    mesh, state, pcfg = make_cavity(4, device="cpu")
    cfg = pimple.PimpleConfig(nu=pcfg.nu, n_outer=2)
    # nu_fn, fvOptions and MRF zones are ported
    from test_torch_piso import rotating_options

    for name, value in rotating_options(mesh).items():
        new, _ = pimple.pimple_step(mesh, state, 0.005,
                                    cfg._replace(**{name: value}))
        assert bool(torch.isfinite(new["U"].data).all()), name
    # the fan BC is ported since the single-equation slice
    # (tests/test_torch_fanduct.py); a lagrangian momentum source is not
    with pytest.raises(NotImplementedError, match="mom_src"):
        pimple.pimple_step(mesh, dict(state, mom_src=state["U"].data),
                           0.005, cfg)
    with pytest.raises(ValueError, match="localEuler"):
        pimple.pimple_step(mesh, state, 0.005,
                           cfg._replace(ddt_scheme="localEuler"))


# ---------------------------------------------------------------------------
# the pimpleFoam cavityRAS goldens of chip_smoke.py
# ---------------------------------------------------------------------------


def reference_pimple_ras(root, steps=chip_smoke.PIMPLE_RAS_STEPS):
    """The goldens' source: pimpleFoam cavityRAS through the JAX package's
    blockMesh and `pimplefoam` application on the CPU in float32, `steps`
    steps of the tutorial's deltaT."""
    from foamtpu.apps.cli import main as jcli
    from foamtpu.core.case import Case as JCase
    from foamtpu.solvers.apps import pimplefoam as japp

    case = JCase(pimple_case(root, jcli, "golden"))
    with contextlib.redirect_stdout(io.StringIO()):
        japp(case, max_steps=steps)
    st = case.final_state
    return chip_smoke.cavity_ras_scalars(
        np.asarray(st["U"].data), np.asarray(st["turb"]["k"].data),
        np.asarray(st["turb"]["nut"].data))


def test_pimple_ras_goldens_come_from_the_reference(tmp_path):
    got = reference_pimple_ras(tmp_path)
    for name, gold in chip_smoke.PIMPLE_RAS_GOLDEN.items():
        np.testing.assert_allclose(got[name], gold, rtol=1e-4, err_msg=name)


def test_port_pimple_ras_f32_meets_goldens(tmp_path):
    """What chip_smoke's pimple_ras phase checks on the card, here on the
    CPU: the unmodified tutorial through the port's application for its
    200 steps, the oracles and the goldens at 1e-3 relative."""
    case = TCase(pimple_case(tmp_path), device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        pimplefoam(case)
    assert case.time.index == chip_smoke.PIMPLE_RAS_STEPS
    from foamtpu_torch.ops import surface

    state = case.final_state
    div_phi = surface.surface_sum(case.mesh, state["phi"])
    diag = {"continuity": torch.sum(torch.abs(div_phi))
            / torch.sum(case.mesh.v)}
    out, checks = chip_smoke.pimple_ras_checks(state, diag)
    assert all(checks.values()), (out, checks)


def test_port_pimple_ras_f32_follows_the_reference(tmp_path):
    """The first 20 of those steps, port against reference in float32:
    the same scalars at 1e-3 relative (the card's tolerance)."""
    ref = reference_pimple_ras(tmp_path, steps=20)
    case = TCase(pimple_case(tmp_path), device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        pimplefoam(case, max_steps=20)
    st = case.final_state
    got = chip_smoke.cavity_ras_scalars(
        st["U"].data.numpy(), st["turb"]["k"].data.numpy(),
        st["turb"]["nut"].data.numpy())
    rel = chip_smoke.golden_rel_err(got, ref)
    assert max(rel.values()) <= 1e-3, rel


# ---------------------------------------------------------------------------
# float64 parity
# ---------------------------------------------------------------------------

F64_BODY = r"""
import json, os, shutil, sys, tempfile
import jax, jax.numpy as jnp, numpy as np, torch

sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
from foamtpu.apps.cases import make_cavity as jmake_cavity
from foamtpu.apps.cli import main as jcli
from foamtpu.core.case import Case as JCase
from foamtpu.core.dictionary import dimensioned_scalar
from foamtpu.solvers import linear as jlinear
from foamtpu.solvers import pimple as jpimple
from foamtpu.solvers.apps import _load_turbulence as jload

import foamtpu_torch.solvers.linear as tlinear
from foamtpu_torch.convert import (config_from_reference, levels_from_numpy,
                                   mesh_from_numpy, state_from_numpy)
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.solvers import pimple as tpimple
from foamtpu_torch.solvers import piso as tpiso
from foamtpu_torch.solvers.apps import _load_turbulence as tload
from foamtpu_torch.solvers.apps import _pimple_config
from foamtpu_torch.solvers.linear.gamg import GAMG

from test_torch_pimple import reference_pimple_config

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


def port_gamg(tm, jg):
    return GAMG(tm, levels=levels_from_numpy(jg.levels, device="cpu"),
                smoother=jg.smoother, n_pre=jg.n_pre, n_post=jg.n_post)


def run(jm, jcfg, jst, tm, tcfg, tst, dt, turb_names):
    @jax.jit
    def jstep(state):
        jrec.clear()
        st, d = jpimple.pimple_step(jm, state, jnp.asarray(dt), jcfg)
        return st, d["continuity"], list(jrec)

    steps = []
    for i in range(3):
        jst, jcont, jits = jstep(jst)
        trec.clear()
        tst, tdiag = tpimple.pimple_step(tm, tst, dt, tcfg)
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

# -- the 16^2 cavity: n_outer=3, relaxation, pFinal, GAMG -------------------
CTL = {"solver": "GAMG", "tolerance": 1e-8, "relTol": 0.05, "maxIter": 200}
jm, jst, pcfg = jmake_cavity(16, p_solver=CTL)
jg = pcfg.p_controls["_gamg"]
assert len(jg.levels) >= 2
final = dict(pcfg.p_controls, relTol=0.0)
jcfg = jpimple.PimpleConfig(
    nu=pcfg.nu, n_outer=3, n_correctors=2, alpha_u=0.7, alpha_p=0.3,
    p_controls=pcfg.p_controls, p_controls_final=final,
    u_controls=pcfg.u_controls)
tm = mesh_from_numpy(jm, device="cpu")
tg = port_gamg(tm, jg)
tcfg = config_from_reference(
    tpimple.PimpleConfig, jcfg, p_controls=dict(CTL, _gamg=tg),
    p_controls_final=dict(CTL, relTol=0.0, _gamg=tg))
tst0 = state_from_numpy(jst, device="cpu")
dt = 0.01     # Courant ~ 1.6: the outer correctors have work to do
out["cavity"] = run(jm, jcfg, jst, tm, tcfg, tst0, dt, ())

# n_outer=1 against the port's piso_step, exactly
cfg1 = tcfg._replace(n_outer=1)
pcfg_t = tpiso.PisoConfig(nu=tcfg.nu, n_correctors=2,
                          p_controls=tcfg.p_controls,
                          p_controls_final=tcfg.p_controls_final,
                          u_controls=tcfg.u_controls)
s1, s2 = tst0, tst0
for _ in range(2):
    s1, _ = tpimple.pimple_step(tm, s1, dt, cfg1)
    s2, _ = tpiso.piso_step(tm, s2, dt, pcfg_t)
out["n_outer_1_equal"] = {
    "U": bool(torch.equal(s1["U"].data, s2["U"].data)),
    "p": bool(torch.equal(s1["p"].data, s2["p"].data)),
    "phi": bool(torch.equal(s1["phi"], s2["phi"])),
    "moved": float(s1["U"].data.abs().max())}

# -- pimpleFoam cavityRAS from its case files --------------------------------
dst = os.path.join(tempfile.mkdtemp(), "pimpleRAS")
shutil.copytree(sys.argv[1], dst)
assert jcli(["blockMesh", "-case", dst]) == 0
jc = JCase(dst)
jm = jc.mesh
_, nu = dimensioned_scalar(jc.transport_properties()["nu"])
jmodel, jts = jload(jc, nu)
jcfg = reference_pimple_config(jc, nu, jmodel)
from foamtpu.solvers import piso as jpiso
jst = jpiso.initial_state(jm, jc.read_field("U"), jc.read_field("p"),
                          turb_state=jts)
rng = np.random.default_rng(0)
turb = dict(jst["turb"])
for name in ("k", "epsilon"):
    turb[name] = turb[name].with_data(
        turb[name].data * jnp.asarray(1.0 + 0.2 * rng.random(jm.n_cells)))
jst = dict(jst, turb=turb)
tc = TCase(dst, device="cpu")
tm = tc.mesh
tmodel, _ = tload(tc, nu)
tcfg = _pimple_config(tc, nu, tmodel)
tcfg = tcfg._replace(p_controls=dict(
    tcfg.p_controls, _gamg=port_gamg(tm, jcfg.p_controls["_gamg"])))
assert tm.v.dtype == torch.float64 and tcfg.n_outer == 2
out["pimpleRAS"] = run(jm, jcfg, jst, tm, tcfg,
                       state_from_numpy(jst, device="cpu"),
                       float(jc.control_dict["deltaT"]),
                       ("k", "epsilon", "nut"))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def f64_run():
    env = dict(os.environ)
    env.update(FOAMTPU_X64="1", JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               FOAMTPU_GAMG_NC="64")
    r = subprocess.run([sys.executable, "-c", F64_BODY, PIMPLE_RAS],
                       env=env, cwd=REPO, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


# solves per step: (U + 2 p) per outer iteration, then the model's two
@pytest.mark.parametrize("case,n_solves", [("cavity", 9), ("pimpleRAS", 8)])
def test_f64_pimple_parity(f64_run, case, n_solves):
    steps = f64_run[case]
    assert len(steps) == 3
    for i, st in enumerate(steps):
        assert len(st["jax_iters"]) == n_solves, st
        assert st["port_iters"] == st["jax_iters"], (case, i, st)
        for k, e in st["errs"].items():
            assert e["ok"], (case, i, k, e)
        assert st["continuity"][1] < 1e-3


def test_f64_n_outer_1_equals_piso_step_exactly(f64_run):
    eq = f64_run["n_outer_1_equal"]
    assert eq["U"] and eq["p"] and eq["phi"], eq
    assert eq["moved"] > 0.1
