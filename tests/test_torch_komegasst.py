"""foamtpu_torch kOmegaSST and bench.py's tet duct against the JAX package.

- In process, float32: the model registers and loads its coefficients,
  `init_wall_distance` gives the reference's y_wall bit for bit, the
  blending functions F1, F2 and CDkw agree at rtol 1e-5, and the
  omegaWallFunction kind parses as the reference's does.
- float64 parity (one subprocess with FOAMTPU_X64=1 JAX_ENABLE_X64=1):
  * one KOmegaSST.correct, steady (relaxed 0.7) and transient (Euler,
    dt=0.01), from one seeded non-uniform state on tet_box(6,3,3) with
    the duct's BCs (omegaWallFunction, kqRWallFunction,
    nutkWallFunction): k, omega, nut and nut's wall values at rtol 1e-9
    (atol 1e-9 of each field's scale) with equal omega and k iteration
    counts;
  * 3 SIMPLE + kOmegaSST iterations of chip_smoke.duct_setup(8,4,4),
    bench.py's unstructured row at 768 cells with its controls, against
    the same wiring in the JAX package. FOAMTPU_GAMG_NC=64 gives the
    pressure solve a 4-level hierarchy (at the default 1024 the 768-cell
    duct would have none); the port builds its own. U, p, phi, k, omega
    and nut at rtol 1e-9 with equal U, p, omega and k iteration counts.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from foamtpu.bc import factory as jfactory
from foamtpu.core.dictionary import FoamDict, Word, parse_string
from foamtpu.mesh import to_device as jto_device
from foamtpu.mesh.tetmesh import tet_box as jtet_box
from foamtpu.models.turbulence import select as jselect

from foamtpu_torch.bc import factory
from foamtpu_torch.convert import field_from_numpy, mesh_from_numpy
from foamtpu_torch.core.dictionary import parse_string as tparse
from foamtpu_torch.mesh import to_device
from foamtpu_torch.mesh.tetmesh import tet_box
from foamtpu_torch.models.turbulence import base as tbase
from foamtpu_torch.models.turbulence import ras as tras

from test_torch_simple import REPO, close

torch.set_num_threads(2)
NU = 1e-5


def _props(name="kOmegaSST"):
    d = FoamDict()
    d[Word("RASModel")] = Word(name)
    d[Word("turbulence")] = Word("on")
    return d


def test_select_builds_komegasst():
    model = tbase.select(tparse("RASModel kOmegaSST; turbulence on;"), NU)
    ref = jselect(_props(), NU)
    assert isinstance(model, tras.KOmegaSST)
    assert model.field_names == ref.field_names == ("k", "omega", "nut")
    for attr in ("alphaK1", "alphaK2", "alphaOmega1", "alphaOmega2",
                 "beta1", "beta2", "betaStar", "gamma1", "gamma2", "a1",
                 "b1", "c1", "nu", "div_scheme"):
        assert getattr(model, attr) == getattr(ref, attr), attr
    with pytest.raises(ValueError, match="init_wall_distance"):
        model.correct(None, {"k": None, "omega": None, "nut": None}, None,
                      None, 1.0)


def test_init_wall_distance_equals_reference():
    jm = jtet_box(6, 3, 3)
    ref = jselect(_props(), NU)
    ref.init_wall_distance(jm, np.float32)
    model = tbase.select(tparse("RASModel kOmegaSST;"), NU)
    model.init_wall_distance(tet_box(6, 3, 3), torch.float32, device="cpu")
    assert model.y_wall.dtype == torch.float32
    assert model.y_wall.device.type == "cpu"
    np.testing.assert_array_equal(model.y_wall.numpy(),
                                  np.asarray(ref.y_wall))


def test_blend_functions():
    """F1, F2 and CDkw on seeded k, omega and grad k . grad omega of both
    signs, spanning the near-wall and free-stream branches."""
    pm = jtet_box(6, 3, 3)
    jm = jto_device(pm)
    tm = mesh_from_numpy(jm, device="cpu")
    ref = jselect(_props(), NU)
    ref.init_wall_distance(pm, np.float32)
    model = tbase.select(tparse("RASModel kOmegaSST;"), NU)
    model.init_wall_distance(tet_box(6, 3, 3), torch.float32, device="cpu")
    rng = np.random.default_rng(5)
    n = jm.n_cells
    k = (1e-3 * 10.0 ** rng.uniform(-2, 2, n)).astype(np.float32)
    w = (10.0 ** rng.uniform(-1, 3, n)).astype(np.float32)
    gg = (rng.standard_normal(n) * 1e-2).astype(np.float32)
    got = model._blend(tm, *(torch.from_numpy(a) for a in (k, w, gg)))
    exp = ref._blend(jm, k, w, gg)
    for g, e, what in zip(got, exp, ("F1", "F2", "CDkw")):
        close(g, e, what, rtol=1e-5)
    F1 = got[0].numpy()
    assert F1.min() < 0.1 and F1.max() > 0.9        # both branches hit


def test_omega_wall_function_parses_like_reference():
    jm = jto_device(jtet_box(2, 1, 1))
    tm = to_device(tet_box(2, 1, 1), "cpu")
    spec = "type omegaWallFunction; value uniform 12.5;"
    patch = tm.patches[2]
    got = factory.from_dict(tparse(spec), patch, 0, torch.float32)
    ref = jfactory.from_dict(parse_string(spec), jm.patches[2], 0,
                             np.float32)
    assert got.kind == ref.kind == "omegaWallFunction"
    np.testing.assert_array_equal(got.ref_value.numpy(),
                                  np.asarray(ref.ref_value))
    assert float(got.vfrac) == float(ref.vfrac)
    # a flux-free face: the wall value is the cell value
    omega = field_from_numpy(_omega_field(jm), device="cpu")
    vals = tras.pf.evaluate(omega.bcs[2], tm, patch, omega.data)
    cells = tm.owner[patch.slice].numpy()
    np.testing.assert_array_equal(vals.numpy(), omega.data.numpy()[cells])


def _omega_field(jm):
    from foamtpu.bc import patchfields as jpf
    from foamtpu.core.fields import vol_scalar

    return vol_scalar(jm, np.arange(jm.n_cells, dtype=np.float32),
                      name="omega",
                      bcs=tuple(jpf.make("omegaWallFunction")
                                for _ in jm.patches))


# ---------------------------------------------------------------------------
# float64 parity: KOmegaSST.correct and 3 duct SIMPLE iterations
# ---------------------------------------------------------------------------

F64_BODY = r"""
import json, os, sys
import jax, jax.numpy as jnp, numpy as np, torch

sys.path.insert(0, os.getcwd())
from foamtpu.bc import patchfields as jpf
from foamtpu.core.dictionary import FoamDict, Word
from foamtpu.core.dimensions import DimensionSet, dimVelocity, dimViscosity
from foamtpu.core.fields import vol_scalar, vol_vector
from foamtpu.mesh import to_device as jto_device
from foamtpu.mesh.tetmesh import tet_box as jtet_box
from foamtpu.models.turbulence import select as jselect
from foamtpu.ops import slot as jslot
from foamtpu.solvers import linear as jlinear
from foamtpu.solvers import piso as jpiso
from foamtpu.solvers import simple as jsimple
from foamtpu.solvers.linear.gamg import GAMG as JGAMG

import chip_smoke
import foamtpu_torch.solvers.linear as tlinear
from foamtpu_torch.convert import mesh_from_numpy, state_from_numpy
from foamtpu_torch.models.turbulence import base as tbase
from foamtpu_torch.core.dictionary import parse_string as tparse
from foamtpu_torch.mesh.tetmesh import tet_box
from foamtpu_torch.ops import slot as tslot
from foamtpu_torch.solvers import simple as tsimple

torch.set_num_threads(2)
assert jnp.zeros(1).dtype == jnp.float64, "x64 mode not active"
NU = 1e-5


def jax_duct(nx, ny, nz):
    # bench.py:417-484, the JAX package's own wiring of the duct
    pm = jtet_box(nx, ny, nz, size=(4.0, 1.0, 1.0))
    mesh = jto_device(pm)
    k0 = 1.5 * (1.0 * 0.05) ** 2
    w0 = k0 ** 0.5 / (0.09 ** 0.25 * 0.1)

    def bcs_for(inlet_val, wall_kind):
        out = []
        for p in mesh.patches:
            v = jnp.asarray(inlet_val)
            shape = (p.size,) if v.ndim == 0 else (p.size, 3)

            def pface(val):
                return jnp.broadcast_to(jnp.asarray(val), shape)

            if p.name == "inlet":
                out.append(jpf.fixed_value(pface(inlet_val)))
            elif p.name == "outlet":
                out.append(jpf.make("inletOutlet", ref_value=pface(0.0 * v)))
            elif wall_kind == "fixedValue":
                out.append(jpf.fixed_value(pface(0.0 * v)))
            else:
                out.append(jpf.make(wall_kind, ref_value=pface(0.0 * v)))
        return tuple(out)

    U = vol_vector(mesh, jnp.asarray([1.0, 0.0, 0.0]), name="U",
                   dims=dimVelocity,
                   bcs=bcs_for(jnp.asarray([1.0, 0.0, 0.0]), "fixedValue"))
    pbcs = tuple(jpf.fixed_value(0.0) if p.name == "outlet"
                 else jpf.zero_gradient() for p in mesh.patches)
    p_f = vol_scalar(mesh, 0.0, name="p", dims=DimensionSet.of(0, 2, -2),
                     bcs=pbcs)
    k = vol_scalar(mesh, k0, name="k", dims=DimensionSet.of(0, 2, -2),
                   bcs=bcs_for(jnp.asarray(k0), "kqRWallFunction"))
    om = vol_scalar(mesh, w0, name="omega", dims=DimensionSet.of(0, 0, -1),
                    bcs=bcs_for(jnp.asarray(w0), "omegaWallFunction"))
    nut = vol_scalar(mesh, 0.0, name="nut", dims=dimViscosity,
                     bcs=bcs_for(jnp.asarray(0.0), "nutkWallFunction"))
    props = FoamDict()
    props[Word("RASModel")] = Word("kOmegaSST")
    props[Word("turbulence")] = Word("on")
    model = jselect(props, NU)
    model.init_wall_distance(pm, np.asarray(mesh.v).dtype)
    cfg = jsimple.SimpleConfig(
        nu=NU, alpha_u=0.7, alpha_p=0.3,
        p_controls={"solver": "GAMG", "preconditioner": "polynomial",
                    "tolerance": 1e-7, "relTol": 0.01, "maxIter": 500,
                    "_gamg": JGAMG(mesh)},
        u_controls={"solver": "smoothSolver", "tolerance": 1e-5,
                    "relTol": 0.1, "maxIter": 300, "nSweeps": 2},
        turb=model, turb_relax=0.7)
    state = jpiso.initial_state(mesh, U, p_f,
                                turb_state={"k": k, "omega": om, "nut": nut})
    return mesh, cfg, state


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


def compare(pairs):
    errs = {}
    for k, (a, b) in pairs.items():
        a, b = a.numpy(), np.asarray(b)
        scale = float(np.abs(b).max())
        ok = a.shape == b.shape and np.allclose(a, b, rtol=1e-9,
                                               atol=1e-9 * scale)
        errs[k] = {"ok": bool(ok), "max_abs": float(np.abs(a - b).max()),
                   "scale": scale}
    return errs


out = {}

# -- one KOmegaSST.correct from a seeded state on tet_box(6,3,3) ----------
jm, jcfg, jst = jax_duct(6, 3, 3)
tm = mesh_from_numpy(jm, device="cpu")
rng = np.random.default_rng(3)
n = jm.n_cells
turb = dict(jst["turb"])
turb["k"] = turb["k"].with_data(turb["k"].data * (0.5 + rng.random(n)))
turb["omega"] = turb["omega"].with_data(
    turb["omega"].data * 10.0 ** rng.uniform(-1, 1, n))
turb["nut"] = turb["nut"].with_data(jnp.asarray(1e-4 * rng.random(n)))
Ud = 1.0 + 0.3 * rng.standard_normal((n, 3))
jst = dict(jst, turb=turb, U=jst["U"].with_data(jnp.asarray(Ud)))
phi = rng.standard_normal(jm.n_faces) * 1e-3 * np.asarray(jm.face_active)
jst["phi"] = jnp.asarray(phi)
tst = state_from_numpy(jst, device="cpu")
jmodel = jcfg.turb
tmodel = tbase.select(tparse("RASModel kOmegaSST;"), NU)
tmodel.init_wall_distance(tet_box(6, 3, 3, size=(4.0, 1.0, 1.0)),
                          torch.float64, device="cpu")
assert np.array_equal(tmodel.y_wall.numpy(), np.asarray(jmodel.y_wall))
phi_t = torch.from_numpy(phi)
for mode, kw in (("steady", dict(steady=True, relax=0.7)),
                 ("transient", dict(steady=False))):
    @jax.jit
    def jcorrect(turb, U, phi):
        jrec.clear()
        new, _ = jmodel.correct(jm, turb, U, phi, jnp.asarray(0.01),
                                phi_slot=jslot.from_flat(jm, phi), **kw)
        return new, list(jrec)
    jnew, jits = jcorrect(jst["turb"], jst["U"], jnp.asarray(phi))
    trec.clear()
    tnew, _ = tmodel.correct(tm, tst["turb"], tst["U"], phi_t,
                             torch.tensor(0.01, dtype=torch.float64),
                             phi_slot=tslot.from_flat(tm, phi_t), **kw)
    pairs = {name: (tnew[name].data, jnew[name].data)
             for name in ("k", "omega", "nut")}
    for i, (tb, jb) in enumerate(zip(tnew["nut"].bcs, jnew["nut"].bcs)):
        if tb.kind == "nutkWallFunction":
            pairs[f"nut_wall_{i}"] = (tb.ref_value, jb.ref_value)
    out[mode] = {"errs": compare(pairs), "jax_iters": [int(x) for x in jits],
                 "port_iters": [int(x) for x in trec],
                 "k_min": float(tnew["k"].data.min()),
                 "omega_min": float(tnew["omega"].data.min())}

# -- 3 SIMPLE + kOmegaSST iterations of the 768-cell duct -------------------
jm, jcfg, jst = jax_duct(8, 4, 4)
tm, tcfg, tst, _ = chip_smoke.duct_setup(8, 4, 4, device="cpu")
assert tm.v.dtype == torch.float64
out["levels"] = [len(jcfg.p_controls["_gamg"].levels),
                 len(tcfg.p_controls["_gamg"].levels)]


@jax.jit
def jstep(state):
    jrec.clear()
    st, d = jsimple.simple_step(jm, state, jcfg)
    return st, d["continuity"], list(jrec)


out["iters"] = []
for i in range(3):
    jst, jcont, jits = jstep(jst)
    trec.clear()
    tst, tdiag = tsimple.simple_step(tm, tst, tcfg)
    pairs = {"U": (tst["U"].data, jst["U"].data),
             "p": (tst["p"].data, jst["p"].data),
             "phi": (tst["phi"], jst["phi"])}
    for name in ("k", "omega", "nut"):
        pairs[name] = (tst["turb"][name].data, jst["turb"][name].data)
    out["iters"].append({
        "errs": compare(pairs), "jax_iters": [int(x) for x in jits],
        "port_iters": [int(x) for x in trec],
        "continuity": [float(jcont), float(tdiag["continuity"])]})
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def f64_run():
    env = dict(os.environ)
    env.update(FOAMTPU_X64="1", JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               FOAMTPU_GAMG_NC="64")
    r = subprocess.run([sys.executable, "-c", F64_BODY], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mode", ["steady", "transient"])
def test_f64_komegasst_correct_parity(f64_run, mode):
    res = f64_run[mode]
    assert len(res["jax_iters"]) == 2, res            # omega, k
    assert res["port_iters"] == res["jax_iters"], res
    for k, e in res["errs"].items():
        assert e["ok"], (mode, k, e)
    assert res["k_min"] > 0 and res["omega_min"] > 0


def test_f64_duct_simple_parity(f64_run):
    assert f64_run["levels"][0] == f64_run["levels"][1] >= 3
    assert len(f64_run["iters"]) == 3
    for i, it in enumerate(f64_run["iters"]):
        assert len(it["jax_iters"]) == 4, it          # U, p, omega, k
        assert it["port_iters"] == it["jax_iters"], (i, it)
        for k, e in it["errs"].items():
            assert e["ok"], (i, k, e)
        assert it["continuity"][1] < 1e-3
