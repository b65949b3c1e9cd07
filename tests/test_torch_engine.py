"""foamtpu_torch's engine family (mesh/engine.py, solvers/engine.py:
coldEngineFoam, engineFoam) against the JAX package; sonicDyMFoam, on the
same step, in tests/test_torch_sonicdym.py.

In process: the slider-crank kinematics (piston_displacement,
piston_speed) on floats and on tensors against the reference's, and the
motion functions of both piston motions against the reference's; the
port's own oracles of tests/test_engine.py (s(0) = 0, s(180) = stroke,
the speed against a finite difference; the short cold compression:
mass conserved, pressure rising, continuity small, and p V^gamma within
5% of its start, the isentrope test's tolerance).

One float64 subprocess (FOAMTPU_X64=1 JAX_ENABLE_X64=1), both packages'
`run(case)` for 3 steps on chip_smoke.slice16_case's parity variants
(seeded U and T: the tutorials start uniform under upwind, where the
first step's weights follow round-off): compression; layeredCylinder at
120 CAD before TDC and 4 CAD a step, across a layer-removal event;
firingCylinder, ignited at -178 CAD (chip_smoke.FIRING_IGNITION: the
tutorial's spark never fires in either package): the fields at rtol 1e-9,
equal iteration counts, the log lines and the written fields.
"""

import numpy as np
import pytest
import torch

from foamtpu_torch.core.dictionary import parse_string as tparse
from foamtpu_torch.core.fields import vol_scalar, vol_vector
from foamtpu_torch.mesh import blockmesh as tbm
from foamtpu_torch.mesh import engine as teng
from foamtpu_torch.mesh import to_device as tto
from foamtpu_torch.models.thermo import PerfectGas
from foamtpu_torch.solvers import engine as tsolver

from test_torch_ras_models import parity

torch.set_num_threads(2)

STEPS = 3
CASES = ["compression", "layeredCylinder", "firingCylinder"]
CYL = """
convertToMeters 1;
vertices
(
    (0 0 0) (0.05 0 0) (0.05 0.1 0) (0 0.1 0)
    (0 0 0.005) (0.05 0 0.005) (0.05 0.1 0.005) (0 0.1 0.005)
);
blocks ( hex (0 1 2 3 4 5 6 7) (8 24 1) simpleGrading (1 1 1) );
boundary
(
    piston { type wall; faces ((1 5 4 0)); }
    head   { type wall; faces ((3 7 6 2)); }
    liner  { type wall; faces ((0 4 7 3) (2 6 5 1)); }
    frontAndBack { type empty; faces ((0 3 2 1) (4 5 6 7)); }
);
"""
GEOM = dict(rpm=60.0, con_rod_length=0.15, stroke=0.08, clearance=0.02,
            theta0=-180.0, axis=1)
THETAS = (-180.0, -179.0, -131.5, -90.0, -12.25, 0.0, 47.0, 180.0)


def test_slider_crank_matches_reference():
    import jax.numpy as jnp
    from foamtpu.mesh import engine as jeng

    gj, gt = jeng.EngineGeometry(**GEOM), teng.EngineGeometry(**GEOM)
    for fn in ("piston_displacement", "piston_speed"):
        a = np.array([float(getattr(jeng, fn)(gj, th)) for th in THETAS])
        b = np.array([getattr(teng, fn)(gt, th) for th in THETAS])
        c = np.array([float(getattr(teng, fn)(gt, torch.tensor(
            th, dtype=torch.float32))) for th in THETAS])
        d = np.array([float(getattr(jeng, fn)(gj, jnp.asarray(
            th, jnp.float32))) for th in THETAS])
        # the JAX package computes a float in float32 here (x64 off), the
        # port on the host in float64: held at float32's round-off of the
        # function's scale
        scale = np.abs(b).max()
        assert np.abs(a - b).max() <= 1e-6 * scale, fn
        assert np.abs(c - d).max() <= 1e-6 * scale, fn
    assert jeng.deg_per_sec(gj) == teng.deg_per_sec(gt) == 360.0


@pytest.mark.parametrize("motion", ["piston", "layer"])
def test_piston_motion_matches_reference(motion):
    import jax.numpy as jnp
    from foamtpu.mesh import engine as jeng

    gj, gt = jeng.EngineGeometry(**GEOM), teng.EngineGeometry(**GEOM)
    if motion == "piston":
        fj = jeng.piston_motion(gj, z_head=0.1, z_piston0=0.0)
        ft = teng.piston_motion(gt, z_head=0.1, z_piston0=0.0)
    else:
        planes = np.linspace(0.0, 0.1, 11)
        fj = jeng.piston_layer_motion(gj, planes, 0, -150.0)
        ft = teng.piston_layer_motion(gt, planes, 0, -150.0)
    pm = tbm.generate(tparse(CYL))
    p0 = pm.points.astype(np.float32)
    for t in (0.0, 0.004, 0.03):
        a = np.asarray(fj[0](jnp.asarray(p0), jnp.asarray(t, jnp.float32)))
        b = ft[0](torch.tensor(p0), t).numpy()
        assert np.allclose(a, b, rtol=1e-6, atol=1e-7), (motion, t)
        a = np.asarray(fj[1](jnp.asarray(p0), jnp.asarray(t, jnp.float32)))
        b = ft[1](torch.tensor(p0), t).numpy()
        assert np.allclose(a, b, rtol=1e-5, atol=1e-7), (motion, t)


def test_slider_crank_kinematics():
    g = teng.EngineGeometry(**GEOM)
    assert abs(teng.piston_displacement(g, 0.0)) < 1e-12
    assert abs(teng.piston_displacement(g, 180.0) - g.stroke) < 1e-12
    assert 0.0 < teng.piston_displacement(g, 90.0) < g.stroke
    th, dth = 47.0, 0.5
    fd = ((teng.piston_displacement(g, th + dth)
           - teng.piston_displacement(g, th - dth)) / (2 * dth)
          * teng.deg_per_sec(g))
    assert abs(teng.piston_speed(g, th) - fd) < 1e-4 * abs(fd)


def test_cold_compression_short():
    pm = tbm.generate(tparse(CYL))
    mesh = tto(pm, "cpu")
    g = teng.EngineGeometry(**GEOM)
    th = PerfectGas(R=287.0, Cv=717.5, mu=1.8e-5)
    pts_fn, umesh_fn = teng.piston_motion(g, z_head=0.1, z_piston0=0.0)
    cfg = tsolver.EngineConfig(thermo=th, pts_fn=pts_fn, umesh_fn=umesh_fn,
                               s_per_cad=1.0 / teng.deg_per_sec(g))
    p = vol_scalar(mesh, 1e5, name="p")
    T = vol_scalar(mesh, 300.0, name="T")
    U = vol_vector(mesh, (0.0, 0.0, 0.0), name="U")
    state = tsolver.initial_state(pm, mesh, U, p, T, th, cfg)
    step = tsolver.make_step(mesh, cfg)
    m0 = float(torch.sum(mesh.v * th.rho(p.data, T.data)))
    V0 = float(torch.sum(mesh.v))
    for _ in range(20):
        state, diag = step(state, 1.0)
    assert float(diag["mass"]) == pytest.approx(m0, rel=1e-3)
    assert float(diag["p_mean"]) > 1.0e5
    assert float(diag["continuity"]) / teng.deg_per_sec(g) / 1.2 < 1e-2
    g_ = th.gamma
    pv = float(diag["p_mean"]) * float(diag["V_total"]) ** g_
    assert abs(pv / (1e5 * V0 ** g_) - 1.0) < 0.05


@pytest.fixture(scope="module")
def runs():
    return parity("slice16", STEPS, CASES, timeout=600)


@pytest.mark.parametrize("name", CASES)
def test_engine_family_matches_reference_f64(runs, name):
    rec = runs[name]
    assert rec["time"][0] == rec["time"][1] == STEPS
    assert rec["time"][2] == rec["time"][3]
    assert rec["fields"][0] == rec["fields"][1]
    assert {"U", "p", "T", "phi"} <= set(rec["fields"][1])
    for field, e in rec["errs"].items():
        assert e["ok"], (name, field, e)
    assert rec["solves"][0] == rec["solves"][1]
    assert rec["other_lines"][0] == rec["other_lines"][1]
    assert rec["other_numbers_ok"]
    for sub, f in rec["files"].items():
        assert f["names"][0] == f["names"][1]
        assert all(e <= 1e-9 for e in f["scaled"].values()), (sub, f)


def test_events_within_the_parity_runs(runs):
    assert "b" in runs["firingCylinder"]["fields"][0]
    assert "Ignition at theta = # CAD" in \
        runs["firingCylinder"]["other_lines"][0]
    assert any(x.startswith("layerAR event: nCells -> #")
               for x in runs["layeredCylinder"]["other_lines"][0])


def test_firing_cylinder_flame_blows_up_as_reference(tmp_path):
    """The fault both packages share (ROADMAP Queue 3): with
    firingCylinder's flame (Su 0.43, qComb 2.5e6) the b-Xi heat release
    drives p past 1e6 Pa 5 steps after the spark (the reference:
    2.14e6 Pa, T_mean 7,013 K at -174 CAD); with tests/test_engine.py's
    flame (chip_smoke.FIRING_FLAME) the same spark burns steadily."""
    import contextlib
    import io

    import chip_smoke
    from foamtpu_torch.apps.cli import main as tcli
    from foamtpu_torch.core.case import run_case
    from test_torch_simple import REPO

    p_mean = {}
    for flame in (False, True):
        d = chip_smoke.slice16_case(REPO, str(tmp_path / str(flame)),
                                    "firingCylinder", tcli, flame=flame)
        with contextlib.redirect_stdout(io.StringIO()):
            c = run_case(d, max_steps=6, device="cpu")
        p_mean[flame] = float(c.final_state["diag"]["p_mean"])
    assert not p_mean[False] < 1e6, p_mean
    assert 1e5 < p_mean[True] < 1.1e5, p_mean
