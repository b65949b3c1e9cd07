"""foamtpu_torch's compressible turbulence models of compressible2.py
against the JAX package's.

One `correct_rho` of each of the nine models (compressible::RNGkEpsilon,
realizableKE, SpalartAllmaras, LRR, LaunderGibsonRSTM, v2f, dynOneEqEddy,
lowReOneEqEddy, DeardorffDiffStress) on the seeded buoyantCavity state of
tests/test_torch_turbulence_compressible.py (U, T, k, epsilon, mut and
alphat cell by cell, rho0 off rho), with the fields the models carry
besides as chip_smoke.comp2_fields writes them (nuTilda, R and B, v2 and
f, after tests/test_turbulence_compressible2.py::_states_for), in float64
in a process of its own: every returned field and mut's boundary values
agree at rtol 1e-9 (atol 1e-9 of the field's scale) and every transport
solve takes the same number of iterations.

Then the JAX package's test_constant_rho_parity on the port
(chip_smoke.constant_rho_pairs, float32 as there): with rho = 1 and a
solenoidal flux each compressible twin matches its incompressible model
at that test's tolerance; and buoyantPimpleFoam's hotCavity under each
model through the port's run(case) on the CPU (chip_smoke.comp2_case).
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_simple import REPO

torch.set_num_threads(2)

MODELS = chip_smoke.COMP2_MODELS

F64_BODY = r"""
import json, sys, tempfile, os
import numpy as np
import torch
import jax.numpy as jnp
sys.path.insert(0, "tests")
import chip_smoke
import test_torch_turbulence_compressible as T
from foamtpu.core.case import Case as JCase
from foamtpu.core.dictionary import parse_string as jparse
from foamtpu.models import thermo as jthermo
from foamtpu.models.turbulence import base as jbase
from foamtpu.solvers import rhopimple as jrp
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.core.dictionary import parse_string as tparse
from foamtpu_torch.models import thermo as tthermo
from foamtpu_torch.models.turbulence import base as tbase
from foamtpu_torch.solvers import rhopimple as trp

torch.set_num_threads(2)
d = T.seeded_cavity(os.path.join(tempfile.mkdtemp(), "cavity"))
for m in ("SpalartAllmaras", "LRR", "DeardorffDiffStress", "v2f"):
    chip_smoke.comp2_fields(d, m)
jc, tc = JCase(d), TCase(d, device="cpu")
jth = jthermo.from_dict(jc.properties("thermophysicalProperties"))
tth = tthermo.from_dict(tc.properties("thermophysicalProperties"))
mu = jth.mu
rng = np.random.default_rng(4)
rho0_factor = 1.0 + 1e-3 * rng.standard_normal(tc.mesh.n_cells)


def setup(pkg):
    if pkg == "jax":
        c, th, rp, arr = jc, jth, jrp, jnp.asarray
    else:
        c, th, rp, arr = tc, tth, trp, torch.tensor
    U, Tf, p = c.read_field("U"), c.read_field("T"), c.read_field("p_rgh")
    st = rp.initial_state(c.mesh, U, p, Tf, th)
    rho = th.rho(p.data, Tf.data)
    return c, U, st["phi"], rho, rho * arr(rho0_factor)


out = {}
for name, kind in chip_smoke.COMP2_MODELS.items():
    text = (f"RASModel {name}; turbulence on;" if kind == "RAS" else
            f"LESModel {name}; turbulence on; delta cubeRootVol;")
    res = {}
    for pkg, parse, sel in (("jax", jparse, jbase.select),
                            ("port", tparse, tbase.select)):
        c, U, phi, rho, rho0 = setup(pkg)
        model = sel(parse(text), mu, kind=kind, compressible=True)
        model.div_scheme = "limitedLinear 1"
        if hasattr(model, "init_wall_distance"):
            if pkg == "jax":
                model.init_wall_distance(c.poly_mesh, np.float64)
            else:
                model.init_wall_distance(c.poly_mesh, torch.float64,
                                         device="cpu")
        tstate = {n: c.read_field(n) for n in model.field_names
                  + ("alphat",)}
        new, diag = model.correct_rho(c.mesh, tstate, U, phi, rho, 0.05,
                                      rho0=rho0)
        host = (np.asarray if pkg == "jax" else
                lambda t: t.numpy() if isinstance(t, torch.Tensor) else
                np.asarray(t))
        res[pkg] = {
            "name": model.name,
            "fields": {n: host(f.data) for n, f in new.items()},
            "mut_b": host(new["mut"].boundary_values(c.mesh)),
            "iters": {n: int(np.asarray(host(p.n_iterations)).max())
                      for n, p in diag.items()}}
    j, t = res["jax"], res["port"]
    errs = {}
    for n, r in list(j["fields"].items()) + [("mut_b", j["mut_b"])]:
        g = t["fields"].get(n) if n != "mut_b" else t["mut_b"]
        scale = float(np.abs(r).max())
        errs[n] = {"ok": bool(g is not None and g.shape == r.shape
                              and np.allclose(g, r, rtol=1e-9,
                                              atol=1e-9 * scale)),
                   "max_rel": float(np.abs(g - r).max() / max(scale, 1e-300))
                   if g is not None else None,
                   "changed": bool(n == "mut_b"
                                   or not np.array_equal(
                                       r, np.asarray(tstate[n].data)))}
    out[name] = {"names": [t["name"], j["name"]],
                 "fields": [sorted(t["fields"]), sorted(j["fields"])],
                 "iters": [t["iters"], j["iters"]], "errs": errs}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def f64_run():
    env = dict(os.environ)
    env.update(FOAMTPU_X64="1", JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", F64_BODY], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


# the fields each model transports (its solves)
SOLVED = {"RNGkEpsilon": {"k", "epsilon"}, "realizableKE": {"k", "epsilon"},
          "SpalartAllmaras": {"nuTilda"}, "LRR": {"R", "epsilon"},
          "LaunderGibsonRSTM": {"R", "epsilon"},
          "v2f": {"k", "epsilon", "v2", "f"}, "dynOneEqEddy": {"k"},
          "lowReOneEqEddy": {"k"}, "DeardorffDiffStress": {"B"}}


@pytest.mark.parametrize("name", list(MODELS))
def test_correct_rho_matches_reference_f64(f64_run, name):
    rec = f64_run[name]
    assert rec["names"] == [f"compressible::{name}"] * 2, rec["names"]
    assert rec["fields"][0] == rec["fields"][1], rec["fields"]
    assert "mut" in rec["fields"][0] and "alphat" in rec["fields"][0]
    assert rec["iters"][0] == rec["iters"][1], rec["iters"]
    assert set(rec["iters"][0]) == SOLVED[name]
    assert all(v > 0 for v in rec["iters"][0].values())
    for n, e in rec["errs"].items():
        assert e["ok"], (name, n, e)
    assert rec["errs"]["alphat"]["changed"]
    if name != "lowReOneEqEddy":
        # (its low-Re damping takes mut to 0 on this cavity, as it was)
        assert rec["errs"]["mut"]["changed"]


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    return chip_smoke.constant_rho_pairs(
        str(tmp_path_factory.mktemp("pairs")), device="cpu")


@pytest.mark.parametrize("name", list(chip_smoke.RHO_PAIRS))
def test_constant_rho_parity(pairs, name):
    """rho = 1, solenoidal flux: the conservative form reduces to the
    incompressible twin (float32, the JAX package test's tolerance)."""
    rec = pairs[name]
    assert rec["ok"], rec
    assert set(rec) == set(chip_smoke.RHO_PAIRS[name]) | {"mut", "ok"}


def test_hotcavity_runs_every_model_through_run_case(tmp_path):
    """buoyantPimpleFoam's hotCavity under each model from case files
    (chip_smoke.comp2_case) through the port's run(case) on the CPU, 2
    steps: the compressible model is taken, its fields stay finite,
    mut >= 0, and the stress models keep k = tr/2."""
    from foamtpu_torch.apps.cli import main as tcli
    from foamtpu_torch.core.case import Case as TCase
    from foamtpu_torch.solvers import apps as tapps

    for name in MODELS:
        d = chip_smoke.comp2_case(REPO, str(tmp_path / name), name, tcli,
                                  device=("-device", "cpu"))
        case = TCase(d, device="cpu")
        with contextlib.redirect_stdout(io.StringIO()):
            tapps.run(case, max_steps=2)
        model, _ = tapps._load_turbulence(case, 1.8e-5, compressible=True)
        assert model.name == f"compressible::{name}"
        a = chip_smoke.turbulence_arrays(case.final_state,
                                         lambda t: t.double().numpy())
        assert all(np.isfinite(x).all() for x in a.values()), name
        assert a["mut"].min() >= 0.0
        ck = chip_smoke.stress_oracles(name, a)
        assert all(ck.values()), (name, ck)
