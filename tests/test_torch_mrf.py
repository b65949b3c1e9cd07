"""foamtpu_torch MRF zones (models/mrf.py) and the rotating-frame and porous
applications against the JAX package.

float64 parity, in one subprocess per part (FOAMTPU_X64=1
JAX_ENABLE_X64=1):
- the zones on the annulus of tests/test_mrf.py (a whole-domain zone with
  nonRotatingPatches, a cylinder zone, a box zone, and the 2.2 list form):
  cell masks, the per-face correction, make_relative / make_absolute (with
  and without a face density), make_relative_flat, relative_flux_b,
  make_relative_state, add_coriolis (with and without rho) and
  correct_boundary_velocity on a seeded flux and velocity, at rtol 1e-12;
- `run(case)` on the seven tutorials as shipped against the reference's
  applications (both packages' blockMesh and setFields), every iteration
  logged (FOAMTPU_CHUNK=1): MRFSimpleFoam (mixerVessel2D) and
  SRFSimpleFoam (rotatingMixer) 3 iterations, MRFInterFoam and
  porousInterFoam 3 steps: every field at rtol 1e-9 and the iteration
  count of every linear solve equal. porousSimpleFoam (angledDuct,
  kEpsilon) from seeded k and epsilon (test_torch_apps.seed_turbulence:
  on uniform fields the limitedLinear limiter is a 0/0 that round-off
  decides), 3 iterations at test_torch_apps' kEpsilon tolerance 1e-6
  (measured 5e-9) with equal counts.
  The PIMPLE tutorials (MRFPimpleFoam, SRFPimpleFoam) ship a steadyState
  ddt, and their final outer iteration runs unrelaxed: the U solve
  (PBiCGStab, relTol 0.1) on that matrix is decided by round-off (a
  change of nu by 1e-14 moves the reference's own U by 3e-5 after one
  step) and the run diverges (ROADMAP Queue 3). So they are held one step
  as shipped (equal counts, fields within 1e-3, the reference's own
  spread measured beside them) and 3 steps with `ddtSchemes default
  Euler` (a well-posed step through the same MRF/SRF code) at rtol 1e-9
  with equal counts.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_simple import REPO

torch.set_num_threads(2)

TUTORIALS = {
    "MRFSimpleFoam": ("incompressible", "MRFSimpleFoam", "mixerVessel2D"),
    "SRFSimpleFoam": ("incompressible", "SRFSimpleFoam", "rotatingMixer"),
    "porousSimpleFoam": ("incompressible", "porousSimpleFoam", "angledDuct"),
    "MRFPimpleFoam": ("incompressible", "MRFPimpleFoam", "mixerVessel2D"),
    "SRFPimpleFoam": ("incompressible", "SRFPimpleFoam", "rotatingMixer"),
    "MRFInterFoam": ("multiphase", "MRFInterFoam", "damBreak"),
    "porousInterFoam": ("multiphase", "porousInterFoam", "damBreak"),
}
# (application, variant, steps)
RUNS = [(app, "shipped", 1 if "Pimple" in app else 3) for app in TUTORIALS] \
    + [("MRFPimpleFoam", "euler", 3), ("SRFPimpleFoam", "euler", 3)]
RUN_IDS = [f"{a}-{v}" for a, v, _ in RUNS]

F64_BODY = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp
import numpy as np
import torch
import test_torch_mrf as T
print(json.dumps(getattr(T, sys.argv[2])()))
"""


def run_f64(fn):
    env = dict(os.environ)
    env.update(FOAMTPU_X64="1", JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               FOAMTPU_CHUNK="1")
    r = subprocess.run(
        [sys.executable, "-c", F64_BODY, os.path.dirname(__file__), fn],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _rel(got, ref):
    g = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    r = np.asarray(ref)
    assert g.dtype == r.dtype == np.float64 and g.shape == r.shape
    if r.size == 0:
        return 0.0
    return float(np.abs(g - r).max() / max(np.abs(r).max(), 1e-300))


# ---------------------------------------------------------------------------
# the zones, on the annulus
# ---------------------------------------------------------------------------

ZONES = {
    "all": """rotor { selectionMode all; origin (0 0 0); axis (0 0 1);
                      omega 10; nonRotatingPatches (stator); }""",
    "cylinder": """inner { selectionMode cylinder; origin (0 0 0);
                           axis (0 0 2); radius 0.75; omega 7.5; }""",
    "box": """part { selectionMode box; box (0 -1 -1) (1 1 1);
                     origin (0.1 0 0); axis (0 0 1);
                     omega omega [0 0 -1 0 0 0 0] 4; }""",
    "list": """1 ( rotor { origin (0 0 0); axis (0 0 1); omega 10;
                           nonRotatingPatches (stator); } )""",
}


def zone_units():
    import jax.numpy as jnp

    from foamtpu.core.dictionary import parse_string as jparse
    from foamtpu.core.dimensions import dimVelocity
    from foamtpu.core.fields import vol_scalar as jvs, vol_vector as jvv
    from foamtpu.mesh import blockmesh as jbm, to_device as jto
    from foamtpu.models import mrf as jmrf
    from foamtpu.ops import fvm as jfvm, slot as jslot
    from foamtpu.solvers import piso as jpiso
    from foamtpu_torch.convert import (field_from_numpy, matrix_from_numpy,
                                       mesh_from_numpy, tensor)
    from foamtpu_torch.core.dictionary import parse_string as tparse
    from foamtpu_torch.models import mrf as tmrf
    from foamtpu_torch.ops import slot as tslot
    from foamtpu_torch.solvers import piso as tpiso
    from test_mrf import _annulus_dict, _couette_bcs

    jm = jto(jbm.generate(_annulus_dict()))
    tm = mesh_from_numpy(jm, device="cpu")
    rng = np.random.default_rng(3)
    n, nf = jm.n_cells, jm.n_faces
    ub, pb = _couette_bcs(jm, jnp.asarray([0.3, -0.2, 0.0]))
    jU = jvv(jm, jnp.zeros(3), name="U", dims=dimVelocity, bcs=ub).with_data(
        jnp.asarray(rng.standard_normal((n, 3)) * [1.0, 1.0, 0.0]))
    jp = jvs(jm, 0.0, name="p", bcs=pb)
    tU = field_from_numpy(jU, device="cpu")
    tp = field_from_numpy(jp, device="cpu")
    phi = rng.standard_normal(nf)
    rho = rng.uniform(1.0, 1000.0, n)
    rho_f = rng.uniform(1.0, 1000.0, nf)
    jeq = jfvm.div(jm, jnp.asarray(phi), jU)
    teq = matrix_from_numpy(jeq, device="cpu")
    out = {}
    for name, text in ZONES.items():
        jz = jmrf.from_dict(jm, jparse(text))
        tz = tmrf.from_dict(tm, tparse(text))
        r = {"n_zones": [len(jz.zones), len(tz.zones)],
             "in_zone": int(tz.zones[0].cell_mask.sum()),
             "mask": int(np.sum(jz.zones[0].cell_mask
                                != tz.zones[0].cell_mask)),
             "patch_rotating": [list(jz.zones[0].patch_rotating),
                                list(tz.zones[0].patch_rotating)],
             "face_corr": _rel(tz.zones[0].face_corr, jz.zones[0].face_corr)}
        jsl, tsl = jslot.from_flat(jm, jnp.asarray(phi)), tslot.from_flat(
            tm, tensor(phi, device="cpu"))
        jrs, trs = (jslot.from_flat(jm, jnp.asarray(rho_f)),
                    tslot.from_flat(tm, tensor(rho_f, device="cpu")))
        for tag, jo, to in (
                ("relative", jz.make_relative(jm, jsl),
                 tz.make_relative(tm, tsl)),
                ("relative_rho", jz.make_relative(jm, jsl, jrs),
                 tz.make_relative(tm, tsl, trs)),
                ("absolute", jz.make_absolute(jm, jsl),
                 tz.make_absolute(tm, tsl)),
                ("absolute_rho", jz.make_absolute(jm, jsl, jrs),
                 tz.make_absolute(tm, tsl, trs))):
            r[tag] = max(_rel(getattr(to, k), getattr(jo, k))
                         for k in ("sv", "fb", "bv"))
        r["relative_flat"] = _rel(
            tz.make_relative_flat(tm, tensor(phi, device="cpu")),
            jz.make_relative_flat(jm, jnp.asarray(phi)))
        nif = jm.n_internal_faces
        r["relative_flux_b"] = _rel(
            tz.relative_flux_b(tm, tensor(phi[nif:], device="cpu")),
            jz.relative_flux_b(jm, jnp.asarray(phi[nif:])))
        r["coriolis"] = _rel(tz.add_coriolis(tm, teq, tU).source,
                             jz.add_coriolis(jm, jeq, jU).source)
        r["coriolis_rho"] = _rel(
            tz.add_coriolis(tm, teq, tU, rho=tensor(rho, device="cpu")).source,
            jz.add_coriolis(jm, jeq, jU, rho=jnp.asarray(rho)).source)
        jU2, tU2 = (jz.correct_boundary_velocity(jm, jU),
                    tz.correct_boundary_velocity(tm, tU))
        r["boundary_velocity"] = max(
            _rel(b.ref_value, a.ref_value) for a, b in zip(jU2.bcs, tU2.bcs)
            if a.kind == "fixedValue")
        r["rotor_moved"] = float(np.abs(np.asarray(jU2.bcs[0].ref_value)
                                        - np.asarray(jU.bcs[0].ref_value)
                                        ).max())
        js = jpiso.initial_state(jm, jU, jp, project=False)
        ts = tpiso.initial_state(tm, tU, tp, project=False)
        js2, ts2 = (jmrf.make_relative_state(jm, jz, js),
                    tmrf.make_relative_state(tm, tz, ts))
        r["state_phi"] = _rel(ts2["phi"], js2["phi"])
        r["state_phi_slot"] = max(_rel(a, b) for a, b in
                                  zip(ts2["phi_slot"], js2["phi_slot"]))
        out[name] = r
    return out


# ---------------------------------------------------------------------------
# the applications
# ---------------------------------------------------------------------------


def _copy(app, variant, root, cli, device=()):
    import contextlib
    import io
    import shutil

    dst = os.path.join(root, f"{app}-{variant}")
    shutil.copytree(os.path.join(REPO, "tutorials", *TUTORIALS[app]), dst)
    if variant == "euler":
        path = os.path.join(dst, "system", "fvSchemes")
        with open(path) as f:
            text = f.read()
        assert "default steadyState" in text
        with open(path, "w") as f:
            f.write(text.replace("default steadyState", "default Euler"))
    if variant == "nu":     # nu x (1 + 1e-14): the reference's own spread
        path = os.path.join(dst, "constant", "transportProperties")
        with open(path) as f:
            text = f.read()
        assert "1e-3;" in text
        with open(path, "w") as f:
            f.write(text.replace("1e-3;", "1.00000000000001e-3;"))
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli(["blockMesh", "-case", dst]) == 0
        if os.path.exists(os.path.join(dst, "system", "setFieldsDict")):
            assert cli(["setFields", "-case", dst, *device]) == 0
    return dst


def _iterations(log):
    return [int(line.rsplit(" ", 1)[1]) for line in log.splitlines()
            if "No Iterations" in line]


def _fields(state, host):
    out = {k: host(v.data) for k, v in state.items() if hasattr(v, "bcs")}
    out["phi"] = host(state["phi"])
    for k, v in (state.get("turb") or {}).items():
        out[k] = host(v.data)
    return out


def app_runs():
    import contextlib
    import io
    import tempfile

    from foamtpu.apps.cli import main as jcli
    from foamtpu.core.case import run_case as jrun
    from foamtpu_torch.apps.cli import main as tcli
    from foamtpu_torch.core.case import Case as TCase
    from foamtpu_torch.solvers.apps import run as trun
    from test_torch_apps import seed_turbulence

    root = tempfile.mkdtemp()
    out = {}
    for app, variant, steps in RUNS:
        dj = _copy(app, variant, os.path.join(root, "ref"), jcli)
        dt = _copy(app, variant, os.path.join(root, "port"), tcli,
                   ("-device", "cpu"))
        if app == "porousSimpleFoam":
            n = TCase(dt, device="cpu").mesh.n_cells
            seed_turbulence(dj, n)
            seed_turbulence(dt, n)
        logs = []
        for fn in (lambda: jrun(dj, max_steps=steps),
                   lambda: trun(TCase(dt, device="cpu"), max_steps=steps)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                case = fn()
            logs.append((case, buf.getvalue()))
        (jc, jlog), (tc, tlog) = logs
        ref = _fields(jc.final_state, np.asarray)
        got = _fields(tc.final_state, lambda t: t.numpy())
        res = {"keys": [sorted(ref), sorted(got)],
               "errs": {k: _rel(got[k], ref[k]) for k in ref},
               "index": [jc.time.index, tc.time.index],
               "iters": [_iterations(jlog), _iterations(tlog)]}
        if "Pimple" in app and variant == "shipped":
            dn = _copy(app, "nu", os.path.join(root, "nu"), jcli)
            with contextlib.redirect_stdout(io.StringIO()):
                jn = jrun(dn, max_steps=steps)
            res["ref_spread_nu_1e-14"] = _rel(
                np.asarray(jn.final_state["U"].data), ref["U"])
        out[f"{app}-{variant}"] = res
    return out


@pytest.fixture(scope="module")
def units():
    return run_f64("zone_units")


@pytest.fixture(scope="module")
def apps():
    return run_f64("app_runs")


@pytest.mark.parametrize("zone", list(ZONES))
def test_zone_matches_reference_f64(units, zone):
    r = units[zone]
    assert r["n_zones"] == [1, 1]
    assert r["mask"] == 0 and r["in_zone"] > 0
    assert r["patch_rotating"][0] == r["patch_rotating"][1]
    for name in ("face_corr", "relative", "relative_rho", "absolute",
                 "absolute_rho", "relative_flat", "relative_flux_b",
                 "coriolis", "coriolis_rho", "boundary_velocity",
                 "state_phi", "state_phi_slot"):
        assert r[name] <= 1e-12, (zone, name, r[name])
    if zone in ("all", "list"):
        # the rotor wall turns, the stator (nonRotatingPatches) does not
        assert r["patch_rotating"][1][:2] == [True, False]
        assert r["rotor_moved"] > 1.0


@pytest.mark.parametrize("run", RUN_IDS)
def test_application_matches_reference_f64(apps, run):
    r = apps[run]
    app, variant = run.split("-")
    steps = dict(((a, v), s) for a, v, s in RUNS)[(app, variant)]
    assert r["index"] == [steps, steps]
    assert r["keys"][0] == r["keys"][1] and "U" in r["keys"][0]
    assert r["iters"][0] and r["iters"][0] == r["iters"][1]
    if "Pimple" in app and variant == "shipped":
        # decided by round-off: the reference's own spread under a 1e-14
        # change of nu is of the same order as the port's difference
        assert r["ref_spread_nu_1e-14"] > 1e-6
        tol = 1e-3
    else:
        tol = 1e-6 if app == "porousSimpleFoam" else 1e-9
    for name, err in r["errs"].items():
        assert err <= tol, (run, name, err)
