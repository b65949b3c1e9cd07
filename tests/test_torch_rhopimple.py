"""foamtpu_torch's pressure-based compressible solvers against the JAX
package's (solvers/rhopimple.py and the applications of solvers/apps.py).

In float64, each in a process of its own (FOAMTPU_X64=1
JAX_ENABLE_X64=1):

  * `rhopimple_step` on the setups of tests/test_rhopimple.py, built the
    same way in both packages: the closed acoustic box with a pressure
    bump (PIMPLE, 2 outer x 2 correctors, linear convection; 4 steps),
    the heated channel under rhoSimpleFoam from a seeded U and T (the
    uniform start's transverse fluxes are round-off, and upwind weights
    take its sign; 3 iterations), the transonic
    pressure equation on the box (sonicFoam's non-symmetric p; 3 steps),
    SIMPLEC on the channel (3 iterations), and one box step with the
    state hooks set: a seeded per-cell `lts_rdt` and a seeded `R_mix` /
    `cp_mix` (the reacting and LTS solvers' entries). U, p, T, phi and
    rho0 agree at rtol 1e-9 (atol 1e-9 of each field's scale) after every
    step, and the U, T and p solves take the same iteration counts.
  * `run(case)` on the tutorials (tests/test_torch_ras_models.PARITY_BODY,
    the cases of chip_smoke.SLICE10_CASES): rhoPimpleFoam, rhoSimpleFoam
    and rhoPimplecFoam on heatedDuct, rhoPorousSimpleFoam and
    rhoPorousMRFPimpleFoam on porousDuct, sonicFoam on forwardStep
    coarsened 4x per direction, 3 steps each from a seeded U and T (the
    tutorials ship uniform fields, where limitedLinear and upwind weights
    follow round-off): fields at 1e-9, every solve's iteration count
    equal, the log lines and the written fields (writePrecision 17, at
    1e-9 of each file's largest number).

Then the applications' registration (the porous/MRF aliases, LTS among
them, as the reference registers them).
"""

import json
import os
import subprocess
import sys

import pytest

from foamtpu_torch.solvers import apps as tapps

from test_torch_ras_models import assert_parity, parity
from test_torch_simple import REPO

STEPS = 3

UNIT_BODY = r"""
import json, sys
from types import SimpleNamespace
import numpy as np
import torch
import jax
import jax.numpy as jnp
sys.path.insert(0, "tests")
import test_rhopimple as R

torch.set_num_threads(2)


def api(pkg):
    if pkg == "jax":
        from foamtpu.bc import patchfields as pf
        from foamtpu.core.dictionary import parse_string
        from foamtpu.core.fields import vol_scalar, vol_vector
        from foamtpu.mesh import blockmesh, to_device
        from foamtpu.models.thermo import PerfectGas
        from foamtpu.solvers import rhopimple as rp
        from foamtpu.core.dimensions import DimensionSet, dimVelocity

        return SimpleNamespace(
            pf=pf, vs=vol_scalar, vv=vol_vector, Gas=PerfectGas, rp=rp,
            mesh=lambda t: to_device(blockmesh.generate(parse_string(t))),
            arr=lambda x: jnp.asarray(np.asarray(x, float)),
            host=np.asarray, D=DimensionSet, dimU=dimVelocity,
            step=lambda m, cfg: jax.jit(
                lambda s, d: rp.rhopimple_step(m, s, d, cfg)))
    from foamtpu_torch.bc import patchfields as pf
    from foamtpu_torch.core.dictionary import parse_string
    from foamtpu_torch.core.fields import vol_scalar, vol_vector
    from foamtpu_torch.mesh import blockmesh, to_device
    from foamtpu_torch.models.thermo import PerfectGas
    from foamtpu_torch.solvers import rhopimple as rp
    from foamtpu_torch.core.dimensions import DimensionSet, dimVelocity

    return SimpleNamespace(
        pf=pf, vs=vol_scalar, vv=vol_vector, Gas=PerfectGas, rp=rp,
        mesh=lambda t: to_device(blockmesh.generate(parse_string(t)),
                                 device="cpu"),
        arr=lambda x: torch.tensor(np.asarray(x, float)),
        host=lambda t: t.numpy() if isinstance(t, torch.Tensor)
        else np.asarray(t),
        D=DimensionSet, dimU=dimVelocity, step=rp.make_step)


def box(a):
    # tests/test_rhopimple.py::_box_fields: a pressure bump in a closed box
    mesh = a.mesh(R.BOX)
    bw, bz = [], []
    for p in mesh.patches:
        if p.type == "empty":
            bw.append(a.pf.PatchField(kind="empty", vfrac=0.0))
            bz.append(a.pf.PatchField(kind="empty", vfrac=0.0))
        else:
            bw.append(a.pf.fixed_value(a.arr(np.zeros(3))))
            bz.append(a.pf.zero_gradient())
    U = a.vv(mesh, a.arr(np.zeros(3)), name="U", dims=a.dimU,
             bcs=tuple(bw))
    c = a.host(mesh.c)
    r2 = ((c[:, 0] - 0.5) ** 2 + (c[:, 1] - 0.5) ** 2) / 0.05 ** 2
    p = a.vs(mesh, 0.0, name="p", dims=a.D.of(1, -1, -2),
             bcs=tuple(bz)).with_data(a.arr(1e5 * (1.0 + 0.01
                                                   * np.exp(-r2))))
    T = a.vs(mesh, 300.0, name="T", dims=a.D.of(0, 0, 0, 1),
             bcs=tuple(bz))
    return mesh, U, p, T


def channel(a):
    # tests/test_rhopimple.py's heated channel (inlet 10 m/s, walls 330 K)
    mesh = a.mesh(R.CHANNEL)
    ub, pb, tb = [], [], []
    for pt in mesh.patches:
        if pt.type == "empty":
            for lst in (ub, pb, tb):
                lst.append(a.pf.PatchField(kind="empty", vfrac=0.0))
        elif pt.name == "inlet":
            ub.append(a.pf.fixed_value(a.arr([10.0, 0.0, 0.0])))
            pb.append(a.pf.zero_gradient())
            tb.append(a.pf.fixed_value(300.0))
        elif pt.name == "outlet":
            ub.append(a.pf.zero_gradient())
            pb.append(a.pf.fixed_value(1e5))
            tb.append(a.pf.zero_gradient())
        else:
            ub.append(a.pf.fixed_value(a.arr(np.zeros(3))))
            pb.append(a.pf.zero_gradient())
            tb.append(a.pf.fixed_value(330.0))
    # seeded: from the uniform start the transverse face fluxes are
    # round-off, and the upwind weights take its sign
    rng = np.random.default_rng(6)
    u = np.zeros((mesh.n_cells, 3))
    u[:, 0] = 10.0
    u[:, :2] += 0.5 * rng.standard_normal((mesh.n_cells, 2))
    U = a.vv(mesh, a.arr([10.0, 0.0, 0.0]), name="U", dims=a.dimU,
             bcs=tuple(ub)).with_data(a.arr(u))
    p = a.vs(mesh, 1e5, name="p", dims=a.D.of(1, -1, -2), bcs=tuple(pb))
    T = a.vs(mesh, 300.0, name="T", dims=a.D.of(0, 0, 0, 1),
             bcs=tuple(tb)).with_data(a.arr(300.0 + 3.0 * rng.random(
                 mesh.n_cells)))
    return mesh, U, p, T


SETUPS = {
    "acoustic_box": (box, dict(n_outer=2, n_correctors=2,
                               div_scheme="linear"), False, 4),
    "channel": (channel, dict(steady=True, alpha_u=0.7, alpha_p=0.3,
                              alpha_e=0.7), True, 3),
    "transonic": (box, dict(transonic=True, n_outer=1, n_correctors=2),
                  False, 3),
    "simplec": (channel, dict(steady=True, consistent=True, alpha_u=0.7,
                              alpha_p=1.0, alpha_e=0.7), True, 3),
    "hooks": (box, dict(n_outer=2, n_correctors=2, div_scheme="linear"),
              False, 1),
}


def run(pkg, name):
    a = api(pkg)
    make, opts, steady, n = SETUPS[name]
    mesh, U, p, T = make(a)
    mu = 0.116 if make is channel else 1.8e-5
    th = a.Gas(R=287.0, Cv=717.5, mu=mu)
    cfg = a.rp.RhoPimpleConfig(thermo=th, **opts)
    state = a.rp.initial_state(mesh, U, p, T, th, steady=steady)
    if name == "hooks":
        rng = np.random.default_rng(8)
        nc = mesh.n_cells
        state["lts_rdt"] = a.arr(350.0 / (0.2 * 0.05)
                                 * (1.0 + 0.3 * rng.random(nc)))
        state["R_mix"] = a.arr(287.0 * (1.0 + 0.05 * rng.random(nc)))
        state["cp_mix"] = a.arr(1004.5 * (1.0 + 0.05 * rng.random(nc)))
    step = a.step(mesh, cfg)
    dt = a.arr(1.0 if steady else 0.2 * 0.05 / 350.0)
    out = []
    for _ in range(n):
        state, diag = step(state, dt)
        rec = {k: a.host(state[k].data) for k in ("U", "p", "T")}
        rec["phi"] = a.host(state["phi"])
        if "rho0" in state:
            rec["rho0"] = a.host(state["rho0"])
        its = {"U": int(np.asarray(a.host(diag["Ux"].n_iterations)).max()),
               "T": int(np.asarray(a.host(diag["T"].n_iterations)).max()),
               "p": int(np.asarray(a.host(diag["p_iters"])))}
        out.append((rec, its))
    return out


res = {}
for name in SETUPS:
    jr, tr = run("jax", name), run("port", name)
    steps = []
    for (jf, ji), (tf, ti) in zip(jr, tr):
        errs = {}
        for k, r in jf.items():
            g = tf.get(k)
            scale = float(np.abs(r).max())
            errs[k] = {"ok": bool(g is not None and g.shape == r.shape
                                  and np.allclose(g, r, rtol=1e-9,
                                                  atol=1e-9 * scale)),
                       "max_rel": float(np.abs(g - r).max()
                                        / max(scale, 1e-300))}
        steps.append({"errs": errs, "iters": [ti, ji],
                      "fields": [sorted(tf), sorted(jf)],
                      "u_max": float(np.abs(tf["U"]).max())})
    res[name] = {"n": [len(tr), len(jr)], "steps": steps}
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def unit_runs():
    env = dict(os.environ)
    env.update(FOAMTPU_X64="1", JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", UNIT_BODY], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["acoustic_box", "channel", "transonic",
                                  "simplec", "hooks"])
def test_rhopimple_step_matches_reference_f64(unit_runs, name):
    rec = unit_runs[name]
    assert rec["n"][0] == rec["n"][1] >= 1
    for i, st in enumerate(rec["steps"]):
        assert st["fields"][0] == st["fields"][1], (name, i, st["fields"])
        assert st["iters"][0] == st["iters"][1], (name, i, st["iters"])
        assert st["iters"][0]["p"] > 0, (name, i, st["iters"])
        for k, e in st["errs"].items():
            assert e["ok"], (name, i, k, e)
    # transient runs carry the old-time density, steady ones do not
    steady = name in ("channel", "simplec")
    assert ("rho0" in rec["steps"][0]["fields"][0]) != steady
    # the bump launched a wave / the channel moves
    assert rec["steps"][-1]["u_max"] > 1e-3


APPS = ("rhoPimpleFoam", "rhoSimpleFoam", "rhoPimplecFoam",
        "rhoPorousSimpleFoam", "rhoPorousMRFPimpleFoam", "sonicFoam")


@pytest.fixture(scope="module")
def app_runs():
    return parity("slice10", STEPS, APPS, timeout=900)


@pytest.mark.parametrize("app", APPS)
def test_application_matches_reference_f64(app_runs, app):
    rec = app_runs[app]
    assert_parity(rec, STEPS, app, files_scaled=True)
    assert {"U", "p", "T", "phi"} == set(rec["errs"])
    names = [n for n, _ in rec["solves"][0]]
    # U, p and T every step (the p line is the first solve of the step)
    assert names.count("p") == names.count("T") == STEPS


def test_applications_are_registered_as_the_reference():
    reg = tapps.APPLICATIONS
    for app in ("rhoSimpleFoam", "rhoPorousSimpleFoam",
                "rhoPorousMRFSimpleFoam"):
        assert reg[app] is tapps.rho_simplefoam, app
    # rhoPorousMRFLTSPimpleFoam runs rhoPimpleFoam without local time
    # stepping, as the reference registers it
    for app in ("rhoPimpleFoam", "rhoPorousMRFPimpleFoam",
                "rhoPorousMRFLTSPimpleFoam"):
        assert reg[app] is tapps.rho_pimplefoam, app
    assert reg["rhoSimplecFoam"] is tapps.rho_simplecfoam
    assert reg["rhoPimplecFoam"] is tapps.rho_pimplecfoam
    assert reg["sonicFoam"] is tapps.sonicfoam
    # the single-equation slice's ten (tests/test_torch_electromagnetics.py),
    # windSimpleFoam, chtMultiRegionFoam and chtMultiRegionSimpleFoam
    # (tests/test_torch_snappy.py, tests/test_torch_cht.py) and the
    # multiphase slice's twelve (tests/test_torch_settling_cavitating.py) and
    # the combustion slice's six (tests/test_torch_reacting.py), the
    # topology-change slice's three (tests/test_torch_engine.py) and the
    # Lagrangian slice's twelve (tests/test_torch_reactingcloud.py)
    assert len(reg) == 82


# -- the goldens of chip_smoke.py's compressible phase -------------------------


def reference_compressible(names=None, perturb=0.0):
    """The golden scalars (chip_smoke.comp_scalars) of chip_smoke.COMP_RUNS
    from the JAX package's applications on the CPU at the runs' depths, in
    the precision the environment gives it (float32; FOAMTPU_X64=1
    JAX_ENABLE_X64=1 for float64). `perturb` multiplies the start's T (U
    where there is no T) cell by cell by 1 + perturb u, u from a numpy
    seed: a float32 run with perturb 1e-7 gives the runs' sensitivity to
    round-off."""
    import contextlib
    import io
    import tempfile

    import numpy as np

    import chip_smoke as cs
    from foamtpu.apps.cli import main as jcli
    from foamtpu.core.case import run_case as jrun

    out = {}
    root = tempfile.mkdtemp()
    for name, (app, opts, steps) in cs.COMP_RUNS.items():
        if names is not None and name not in names:
            continue
        d = cs.compressible_case(REPO, os.path.join(root, name), app, jcli,
                                 **opts)
        if perturb:
            from foamtpu.core.case import Case as JCase

            jc = JCase(d)
            f = "T" if os.path.exists(os.path.join(d, "0", "T")) else "U"
            x = np.asarray(jc.read_field(f).data, np.float64)
            rng = np.random.default_rng(21)
            u = rng.random(x.shape[0])
            cs.set_internal(d, f, x * (1.0 + perturb * (
                u if x.ndim == 1 else u[:, None])))
        with contextlib.redirect_stdout(io.StringIO()):
            jc = jrun(d, max_steps=steps)
        a = cs.comp_arrays(jc.final_state, np.asarray)
        out[name] = cs.comp_scalars(a, np.asarray(jc.mesh.v))
    return out


def test_port_on_the_cpu_meets_the_card_goldens(tmp_path):
    """Three of the compressible phase's runs through the port on the CPU
    (float32) against chip_smoke.COMP_GOLDEN at the tolerance the card is
    held to (another float32 summation order, as on the card)."""
    import contextlib
    import io

    import chip_smoke as cs
    from foamtpu_torch.apps.cli import main as tcli
    from foamtpu_torch.core.case import Case as TCase

    for name in ("rhoPimpleFoam", "rhoSimplecFoam", "rhoPorousMRFPimpleFoam"):
        app, opts, steps = cs.COMP_RUNS[name]
        d = cs.compressible_case(REPO, str(tmp_path / name), app, tcli,
                                 device=("-device", "cpu"), **opts)
        case = TCase(d, device="cpu")
        with contextlib.redirect_stdout(io.StringIO()):
            tapps.run(case, max_steps=steps)
        a = cs.comp_arrays(case.final_state, lambda t: t.double().numpy())
        got = cs.comp_scalars(a, case.mesh.v.double().numpy())
        rel = cs.golden_rel_err(got, cs.COMP_GOLDEN[name], cs.COMP_FLOOR)
        for k, r in rel.items():
            tol = cs.comp_tolerance(name, k, cs.COMP_GOLDEN[name][k],
                                    cs.COMP_SPREAD[name][k])
            assert r <= tol, (name, k, r, tol, got[k])


if __name__ == "__main__":
    # python tests/test_torch_rhopimple.py goldens [--perturb] [name ...]:
    # the JSON of reference_compressible (the environment sets float32 or
    # float64; --perturb perturbs the start by 1e-7); ... spread f32.json
    # f64.json perturbed.json: chip_smoke.COMP_SPREAD, each scalar's
    # largest error from the float32 run's relative to max(|value|,
    # chip_smoke.COMP_FLOOR)
    if len(sys.argv) > 1 and sys.argv[1] == "spread":
        sys.path.insert(0, REPO)
        import chip_smoke as cs

        runs = []
        for path in sys.argv[2:]:
            with open(path) as f:
                runs.append(json.load(f))
        print(json.dumps({name: {k: max(cs.golden_rel_err(
            r[name], gold, cs.COMP_FLOOR)[k] for r in runs[1:])
            for k in gold} for name, gold in runs[0].items()}))
    if len(sys.argv) > 1 and sys.argv[1] == "goldens":
        args = sys.argv[2:]
        eps = 1e-7 if "--perturb" in args else 0.0
        names = [a for a in args if a != "--perturb"] or None
        print(json.dumps(reference_compressible(names, perturb=eps)))
