"""foamtpu_torch's sixDoF rigid body (models/sixdof.py), the
displacementLaplacian motion solver (mesh/motionsolver.py) and the
floating body (solvers/floating.py, pimpleDyMFoam's
sixDoFRigidBodyMotion) against the JAX package.

One float64 subprocess (FOAMTPU_X64=1 JAX_ENABLE_X64=1):
- the floating body of tests/test_floating.py's case
  (chip_smoke.floating_case: a spring-held square body in a 1 m tank,
  falling under gravity) through both packages' `run(case)` for 3 steps:
  U, p, phi, the moved points and the body's state at rtol 1e-9, equal
  iteration counts, the log lines (its centre of mass) and the written
  fields (tests/test_torch_ras_models.py's PARITY_BODY);
- `sixdof.update` on the three cases of tests/test_sixdof.py (a linear
  spring, a torque-free asymmetric top, gravity with a linear damper),
  one step from each of the reference's first 200 states, and one step
  with every restraint and damper at once and an external force and
  torque: every state component within 1e-12 of the reference's,
  relative to its scale (200 chained steps drift apart by 1.5e-11 on the
  spring, the two packages' round-off compounding);
- `DisplacementLaplacian.solve_points` on tests/test_motionsolver.py's
  12 x 12 box with its top wall moved up by 0.1, uniform and
  inverseDistance diffusivity: the points within 1e-12.
In process, float64 on the port alone: the oracles of tests/test_sixdof.py
(the damped drop at 1000 steps, 20 time constants, where the reference
takes 3000) and tests/test_motionsolver.py.
"""

import numpy as np
import pytest
import torch

from foamtpu_torch.core.dictionary import parse_string as tparse
from foamtpu_torch.mesh import blockmesh as tbm
from foamtpu_torch.mesh import moving as tmoving
from foamtpu_torch.mesh import to_device as tto
from foamtpu_torch.mesh.motionsolver import DisplacementLaplacian
from foamtpu_torch.models import sixdof

from test_torch_ras_models import parity

torch.set_num_threads(2)

STEPS = 3
F64 = torch.float64
BOX = """
convertToMeters 1;
vertices ( (0 0 0) (1 0 0) (1 1 0) (0 1 0)
           (0 0 0.1) (1 0 0.1) (1 1 0.1) (0 1 0.1) );
blocks ( hex (0 1 2 3 4 5 6 7) (12 12 1) simpleGrading (1 1 1) );
boundary (
  movingWall { type wall; faces ((3 7 6 2)); }
  fixedWalls { type wall; faces ((0 4 7 3) (2 6 5 1) (1 5 4 0)); }
  frontAndBack { type empty; faces ((0 3 2 1) (4 5 6 7)); }
);
"""

UNITS = r'''
# -- sixdof.update and DisplacementLaplacian, after the runs ------------------
import jax, jax.numpy as jnp
from foamtpu.core.dictionary import parse_string as jparse
from foamtpu.mesh import blockmesh as jbm, to_device as jto
from foamtpu.mesh.motionsolver import DisplacementLaplacian as JDL
from foamtpu.models import sixdof as js
from foamtpu_torch.core.dictionary import parse_string as tparse
from foamtpu_torch.mesh import blockmesh as tbm, to_device as tto
from foamtpu_torch.mesh.motionsolver import DisplacementLaplacian as TDL
from foamtpu_torch.models import sixdof as ts

BOX = @BOX@
SPRING = (((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), 100.0, 0.0, 0.0),)
ALL = (((0.1, 0.2, 0.0), (0.05, -0.02, 0.01), 40.0, 3.0, 0.05),)
CASES = {
    "spring": (dict(mass=2.5, I_body=(1.0, 1.0, 1.0), springs=SPRING),
               dict(x=(0.1, 0.0, 0.0)), 2 * np.pi * np.sqrt(0.025) / 400,
               None),
    "top": (dict(mass=1.0, I_body=(1.0, 2.0, 3.0)), dict(L=(0.3, 0.5, 0.2)),
            1e-3, None),
    "drop": (dict(mass=2.0, I_body=(1.0, 1.0, 1.0), g=(0.0, -10.0, 0.0),
                  lin_damping=4.0), {}, 0.01, None),
    "all": (dict(mass=3.0, I_body=(0.5, 0.7, 0.9), g=(0.0, -9.81, 0.0),
                 springs=ALL, lin_damping=0.5, ang_damping=0.3),
            dict(x=(0.2, 0.1, 0.05), v=(0.1, -0.2, 0.3),
                 L=(0.01, -0.02, 0.03)), 0.02,
            ((1.0, -2.0, 0.5), (0.1, 0.2, -0.3))),
}


def rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


units = {}
for name, (cfg, init, dt, ext) in CASES.items():
    n = 1 if name == "all" else 200
    jc, tc = js.RigidBodyConfig(**cfg), ts.RigidBodyConfig(**cfg)
    sj = js.initial_state(init.get("x", (0.0, 0.0, 0.0)), jnp.float64)
    st = ts.initial_state(init.get("x", (0.0, 0.0, 0.0)), torch.float64,
                          "cpu")
    for k in ("v", "L"):
        if k in init:
            sj = sj._replace(**{k: jnp.asarray(init[k], jnp.float64)})
            st = st._replace(**{k: torch.tensor(init[k], dtype=torch.float64)})
    fj = tj = ft = tt = None
    if ext:
        fj, tj = (jnp.asarray(e, jnp.float64) for e in ext)
        ft, tt = (torch.tensor(e, dtype=torch.float64) for e in ext)
    step = jax.jit(lambda s: js.update(jc, s, dt, f_ext=fj, tau_ext=tj))
    err = 0.0
    for _ in range(n):
        # one step of each from the reference's state along its trajectory
        st = ts.RigidBodyState(*(torch.tensor(np.asarray(a)) for a in sj))
        sj = step(sj)
        st = ts.update(tc, st, dt, f_ext=ft, tau_ext=tt)
        err = max(err, max(rel(b.numpy(), a) for a, b in zip(sj, st)))
    units[name] = err

pj, pt = jbm.generate(jparse(BOX)), tbm.generate(tparse(BOX))
mj, mt = jto(pj), tto(pt, "cpu")
for diff in ("uniform", "inverseDistance"):
    a = JDL(pj, mj, ["movingWall"], diffusivity=diff).solve_points(
        {"movingWall": jnp.asarray([0.0, 0.1, 0.0])})
    b = TDL(pt, mt, ["movingWall"], diffusivity=diff).solve_points(
        {"movingWall": torch.tensor([0.0, 0.1, 0.0], dtype=torch.float64)})
    units["laplacian_" + diff] = rel(b.numpy(), a)
print(json.dumps(units))
'''


@pytest.fixture(scope="module")
def runs():
    return parity("slice16", STEPS, ["floating"], timeout=600,
                  tail=UNITS.replace("@BOX@", repr(BOX)), lines=2)


def test_floating_body_matches_reference_f64(runs):
    rec = runs[0]["floating"]
    assert rec["time"][0] == rec["time"][1] == STEPS
    assert {"U", "p", "phi", "body", "points"} <= set(rec["fields"][1])
    assert rec["fields"][0] == rec["fields"][1]
    for name, e in rec["errs"].items():
        assert e["ok"], (name, e)
    assert rec["solves"][0] == rec["solves"][1]
    assert rec["other_lines"][0] == rec["other_lines"][1]
    assert rec["other_numbers_ok"]
    for sub, f in rec["files"].items():
        assert f["names"][0] == f["names"][1]
        assert all(f["ok"].values()), (sub, f)


def test_floating_body_moves(runs):
    lines = runs[0]["floating"]["other_lines"][0]
    assert lines.count("Centre of mass: (# # #)") == STEPS
    assert runs[0]["floating"]["errs"]["points"]["max_abs"] < 1e-12


@pytest.mark.parametrize("name", ["spring", "top", "drop", "all"])
def test_sixdof_update_matches_reference(runs, name):
    assert runs[1][name] < 1e-12, runs[1]


@pytest.mark.parametrize("diff", ["uniform", "inverseDistance"])
def test_displacement_laplacian_matches_reference(runs, diff):
    assert runs[1]["laplacian_" + diff] < 1e-12, runs[1]


def _state(x=(0.0, 0.0, 0.0), **kw):
    st = sixdof.initial_state(x, F64, "cpu")
    return st._replace(**{k: torch.tensor(v, dtype=F64)
                          for k, v in kw.items()})


def test_spring_mass_period():
    k, m = 100.0, 2.5
    cfg = sixdof.RigidBodyConfig(
        mass=m, I_body=(1.0, 1.0, 1.0),
        springs=(((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), k, 0.0, 0.0),))
    st = _state((0.1, 0.0, 0.0))
    T = 2 * np.pi * np.sqrt(m / k)
    dt = T / 400
    xs = []
    for _ in range(800):
        st = sixdof.update(cfg, st, dt)
        xs.append(float(st.x[0]))
    xs = np.asarray(xs)
    assert abs(xs[-1] - 0.1) < 0.004
    assert abs(np.abs(xs).max() - 0.1) < 0.004
    assert abs(np.argmax(np.sign(xs) < 0) * dt - T / 4) < 0.06 * T


def test_free_rotation_conserves_momentum():
    cfg = sixdof.RigidBodyConfig(mass=1.0, I_body=(1.0, 2.0, 3.0))
    st = _state(L=(0.3, 0.5, 0.2))
    L0 = st.L.clone()
    for _ in range(2000):
        st = sixdof.update(cfg, st, 1e-3)
    assert float(torch.linalg.norm(st.L - L0)) < 1e-5
    assert abs(float(st.q[0]) - 1.0) > 1e-3
    assert abs(float(torch.linalg.norm(st.q)) - 1.0) < 1e-5


def test_gravity_drop_with_damper():
    cfg = sixdof.RigidBodyConfig(mass=2.0, I_body=(1.0, 1.0, 1.0),
                                 g=(0.0, -10.0, 0.0), lin_damping=4.0)
    st = _state()
    for _ in range(1000):     # 20 time constants m/c
        st = sixdof.update(cfg, st, 0.01)
    assert abs(-float(st.v[1]) - 5.0) < 0.1


def test_displacement_laplacian_smooth_deformation():
    pm = tbm.generate(tparse(BOX))
    mesh = tto(pm, "cpu")
    ms = DisplacementLaplacian(pm, mesh, ["movingWall"],
                               diffusivity="inverseDistance")
    pts = ms.solve_points({"movingWall": torch.tensor([0.0, 0.1, 0.0],
                                                      dtype=F64)}).numpy()
    p0 = pm.points
    fixed = ((np.abs(p0[:, 1]) < 1e-12) | (np.abs(p0[:, 0]) < 1e-12)
             | (np.abs(p0[:, 0] - 1.0) < 1e-12))
    top = np.abs(p0[:, 1] - 1.0) < 1e-12
    assert np.allclose(pts[fixed & ~top], p0[fixed & ~top], atol=1e-7)
    assert np.allclose(pts[top][:, 1], 1.1, atol=1e-6)
    dy = pts[:, 1] - p0[:, 1]
    assert (dy >= -1e-7).all() and dy.max() <= 0.1 + 1e-6
    levels = np.unique(np.round(p0[:, 1], 9))
    means = [dy[np.round(p0[:, 1], 9) == lv].mean() for lv in levels]
    assert all(b >= a - 1e-8 for a, b in zip(means, means[1:]))
    topo = tmoving.topo_from_poly(pm, F64, "cpu")
    v2 = tmoving.update_geometry(mesh, torch.tensor(pts), topo).v.numpy()
    assert (v2 > 0).all()
    assert abs(v2.sum() - (mesh.v.numpy().sum() + 0.1 * 0.1)) < 1e-6
