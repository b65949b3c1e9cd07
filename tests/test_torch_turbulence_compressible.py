"""foamtpu_torch's compressible turbulence models against the JAX
package's (models/turbulence/compressible.py).

One `correct_rho` of each of the five models (compressible::kEpsilon,
LaunderSharmaKE, kOmegaSST, Smagorinsky, oneEqEddy; kEpsilon also steady
with relaxation 0.7) on the same seeded state of the buoyantCavity
tutorial's mesh (its epsilon, kqR and mutk wall functions, plus an omega
field with omegaWallFunction), in float64 in a process of its own
(FOAMTPU_X64=1 JAX_ENABLE_X64=1): every field the model returns (k,
epsilon or omega, mut, alphat) and mut's boundary values agree at rtol
1e-9 (atol 1e-9 of the field's scale), and every transport solve takes the
same number of iterations. The state is seeded cell by cell (U, T, k,
epsilon, omega, mut, alphat, and rho0 off rho): on uniform fields the
limitedLinear weights are ratios of round-off.

Then `select` and `_load_turbulence` in this process: compressible=True
takes `compressible::<name>` where that is registered and the
incompressible model otherwise, as the reference does (the models of its
compressible2.py among them since the slice of the rest of turbulence);
a case that ships no 0/mut takes the incompressible twin (the
reference's fallback), one that ships mut and alphat the compressible
model with alphat read.
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

from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.core.dictionary import parse_string as tparse
from foamtpu_torch.models.turbulence import base as tbase

import chip_smoke
from test_torch_simple import REPO

CAVITY = os.path.join("tutorials", "heatTransfer", "buoyantSimpleFoam",
                      "buoyantCavity")
MODELS = {"kEpsilon": "RAS", "LaunderSharmaKE": "RAS", "kOmegaSST": "RAS",
          "Smagorinsky": "LES", "oneEqEddy": "LES"}
OMEGA = """FoamFile { version 2.0; format ascii; class volScalarField;
           object omega; }
dimensions      [0 0 -1 0 0 0 0];
internalField   uniform 1;
boundaryField
{
    hotWall  { type omegaWallFunction; value uniform 1; }
    coldWall { type omegaWallFunction; value uniform 1; }
    adiabatic { type omegaWallFunction; value uniform 1; }
    frontAndBack { type empty; }
}
"""


def seeded_cavity(dst, seed=3):
    """buoyantCavity meshed by the port's blockMesh, with 0/omega added
    and U, T, k, epsilon, omega, mut and alphat seeded cell by cell
    (mut = rho Cmu k^2/eps at p = 1e5, alphat = mut/0.85)."""
    from foamtpu_torch.apps.cli import main as tcli

    shutil.copytree(os.path.join(REPO, CAVITY), dst)
    with open(os.path.join(dst, "0", "omega"), "w") as f:
        f.write(OMEGA)
    with contextlib.redirect_stdout(io.StringIO()):
        assert tcli(["blockMesh", "-case", dst]) == 0
    n = 1600
    rng = np.random.default_rng(seed)
    u = np.zeros((n, 3))
    u[:, :2] = 0.05 * rng.standard_normal((n, 2))
    T = 300.0 + 30.0 * rng.random(n)
    k = 7.5e-4 * (1.0 + 0.5 * rng.random(n))
    eps = 4e-5 * (1.0 + 0.5 * rng.random(n))
    rho = 1e5 / (8314.47 / 28.96 * T)
    mut = rho * 0.09 * k * k / eps
    for name, vals in (("U", u), ("T", T), ("k", k), ("epsilon", eps),
                       ("omega", eps / (0.09 * k)), ("mut", mut),
                       ("alphat", mut / 0.85)):
        chip_smoke.set_internal(dst, name, vals)
    return dst


F64_BODY = r"""
import json, sys, tempfile, os
import numpy as np
import torch
import jax.numpy as jnp
sys.path.insert(0, "tests")
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
    U, T, p = c.read_field("U"), c.read_field("T"), c.read_field("p_rgh")
    st = rp.initial_state(c.mesh, U, p, T, th)
    rho = th.rho(p.data, T.data)
    return c, U, st["phi"], rho, rho * arr(rho0_factor)


out = {}
runs = [(m, k, False) for m, k in T.MODELS.items()] + [("kEpsilon", "RAS",
                                                        True)]
for name, kind, steady in runs:
    key = name + ("_steady" if steady else "")
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
        names = model.field_names + ("alphat",)
        tstate = {n: c.read_field(n) for n in names}
        new, diag = model.correct_rho(
            c.mesh, tstate, U, phi, rho, 1.0 if steady else 0.05,
            rho0=None if steady else rho0, steady=steady,
            relax=0.7 if steady else 1.0)
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
    out[key] = {"names": [t["name"], j["name"]],
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


@pytest.mark.parametrize("key", [*MODELS, "kEpsilon_steady"])
def test_correct_rho_matches_reference_f64(f64_run, key):
    rec = f64_run[key]
    name = key.split("_")[0]
    assert rec["names"] == [f"compressible::{name}"] * 2, rec["names"]
    assert rec["fields"][0] == rec["fields"][1], rec["fields"]
    assert "mut" in rec["fields"][0] and "alphat" in rec["fields"][0]
    assert rec["iters"][0] == rec["iters"][1], rec["iters"]
    for n, e in rec["errs"].items():
        assert e["ok"], (key, n, e)
    # the models change mut and alphat (and their transported fields)
    assert rec["errs"]["mut"]["changed"] and rec["errs"]["alphat"]["changed"]
    solved = {"kEpsilon": {"k", "epsilon"}, "LaunderSharmaKE":
              {"k", "epsilon"}, "kOmegaSST": {"k", "omega"},
              "oneEqEddy": {"k"}, "Smagorinsky": set()}[name]
    assert set(rec["iters"][0]) == solved
    assert all(v > 0 for v in rec["iters"][0].values())


# -- select and _load_turbulence --------------------------------------------


def _props(name, kind="RAS"):
    if kind == "RAS":
        return tparse(f"RASModel {name}; turbulence on;")
    return tparse(f"LESModel {name}; turbulence on; delta cubeRootVol;")


@pytest.mark.parametrize("name,kind", list(MODELS.items()))
def test_select_takes_the_compressible_model(name, kind):
    m = tbase.select(_props(name, kind), 1.8e-5, kind=kind,
                     compressible=True)
    assert m.name == f"compressible::{name}"
    assert m.compressible_form and m.mu == 1.8e-5
    assert "mut" in m.field_names and m.optional_fields == ("alphat",)
    inc = tbase.select(_props(name, kind), 1e-5, kind=kind)
    assert inc.name == name and not getattr(inc, "compressible_form", False)


def test_select_falls_back_and_refuses_as_the_reference():
    from foamtpu.core.dictionary import parse_string as jparse
    from foamtpu.models.turbulence import base as jbase

    # no compressible twin, none in compressible2.py: the incompressible
    # model, in both packages
    for name in ("kOmega", "SpalartAllmarasDDES"):
        m = tbase.select(_props(name), 1e-5, compressible=True)
        r = jbase.select(jparse(f"RASModel {name};"), 1e-5,
                         compressible=True)
        assert m.name == r.name == name
    # the reference's compressible2.py models: the compressible model,
    # in both packages
    for name, kind in chip_smoke.COMP2_MODELS.items():
        m = tbase.select(_props(name, kind), 1e-5, kind=kind,
                         compressible=True)
        r = jbase.select(jparse(f"{kind}Model {name};"), 1e-5, kind=kind,
                         compressible=True)
        assert m.name == r.name == f"compressible::{name}"
        assert m.compressible_form and "mut" in m.field_names
    assert tbase.select(_props("laminar"), 1e-5,
                        compressible=True).name == "laminar"
    # a name neither package registers: ValueError, as the reference
    for sel, props in ((tbase.select, _props("noSuchModel")),
                       (jbase.select, jparse("RASModel noSuchModel;"))):
        with pytest.raises(ValueError, match="noSuchModel"):
            sel(props, 1e-5, compressible=True)


def test_load_turbulence_picks_the_model_the_reference_picks(tmp_path):
    """buoyantCavity as shipped (0/mut, 0/alphat): compressible::kEpsilon
    with alphat read; without 0/mut (a 0/nut in its place) the
    incompressible kEpsilon, in both packages."""
    from foamtpu.core.case import Case as JCase
    from foamtpu.solvers.apps import _load_turbulence as jload
    from foamtpu_torch.solvers.apps import _load_turbulence as tload

    d = seeded_cavity(str(tmp_path / "shipped"))
    tm, ts = tload(TCase(d, device="cpu"), 1.8e-4, compressible=True)
    jm, js = jload(JCase(d), 1.8e-4, compressible=True)
    assert tm.name == jm.name == "compressible::kEpsilon"
    assert sorted(ts) == sorted(js) == ["alphat", "epsilon", "k", "mut"]
    assert [b.kind for b in ts["mut"].bcs] == [b.kind for b in js["mut"].bcs]
    assert ts["mut"].bcs[0].kind == "nutkWallFunction"
    assert ts["alphat"].bcs[0].kind == "calculated"

    d2 = str(tmp_path / "nut")
    shutil.copytree(d, d2)
    text = open(os.path.join(d2, "0", "mut")).read()
    os.remove(os.path.join(d2, "0", "mut"))
    os.remove(os.path.join(d2, "0", "alphat"))
    with open(os.path.join(d2, "0", "nut"), "w") as f:
        f.write(text.replace("object mut", "object nut").replace(
            "mutkWallFunction", "nutkWallFunction"))
    tm, ts = tload(TCase(d2, device="cpu"), 1.8e-4, compressible=True)
    jm, js = jload(JCase(d2), 1.8e-4, compressible=True)
    assert tm.name == jm.name == "kEpsilon"
    assert not getattr(tm, "compressible_form", False)
    assert sorted(ts) == sorted(js) == ["epsilon", "k", "nut"]


def test_compressible_bc_names(tmp_path):
    """The compressible:: prefix and the mut* / alphat* names map onto the
    ported kinds; an alias whose target is not ported raises under its
    own name."""
    from foamtpu_torch.bc import factory

    class P:
        size = 3

    for given, kind in (("compressible::mutkWallFunction",
                         "nutkWallFunction"),
                        ("mutUWallFunction", "nutUWallFunction"),
                        ("compressible::alphatWallFunction", "calculated"),
                        ("mutUSpaldingWallFunction",
                         "nutUSpaldingWallFunction"),
                        ("compressible::epsilonWallFunction",
                         "epsilonWallFunction")):
        bc = factory.from_dict(tparse(f"type {given}; value uniform 2;"),
                               P(), 0, torch.float64)
        assert bc.kind == kind, given
    bc = factory.from_dict(tparse("type mutLowReWallFunction;"), P(), 0,
                           torch.float64)
    assert bc.kind == "fixedValue" and float(bc.ref_value) == 0.0
    # its target is built since the boundary-condition slice
    # (tests/test_torch_bc_derived.py); a compressible name the reference
    # does not map raises under its own name
    bc = factory.from_dict(tparse("type mutkRoughWallFunction; value "
                                  "uniform 0;"), P(), 0, torch.float64)
    assert bc.kind == "nutkRoughWallFunction"
    with pytest.raises(NotImplementedError, match="mutURoughWallFunction"):
        factory.from_dict(tparse("type mutURoughWallFunction; value "
                                 "uniform 0;"), P(), 0, torch.float64)
