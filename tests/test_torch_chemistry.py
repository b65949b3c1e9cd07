"""foamtpu_torch's batched ODE integrators, chemistry and combustion
closures against the JAX package (ode/__init__.py, models/chemistry.py,
models/combustion.py) and chemFoam (solvers/apps.py::chem_foam).

In float64 (one process, FOAMTPU_X64=1 JAX_ENABLE_X64=1):
  - `integrate` with RKF45, Rosenbrock (rodas23) and SIBS over a batch of
    lanes whose stiffness spans three decades, so that they need from 17
    to 327 steps: per lane y at rtol 1e-12, and n_steps and n_rejected
    equal to the JAX package's `jax.vmap(integrate)` (the masked loop: a
    finished lane keeps its state while the others go on);
  - `omega`, `heat_release`, `solve` and the analytic `jacobian` (against
    jax.jacfwd and the port's forward-mode one) of smallPoolFire2D's
    methane mechanism (`from_foam_files` on its constant/ files) and of a
    stiff two-step mechanism, `tc`, and `Combustion.advance` in its three models
    (laminar, PaSR with and without mixing data, infinitelyFastChemistry),
    at rtol 1e-9;
  - `from_foam_files` itself: species, stoichiometry, rates, the
    formation enthalpies and W equal;
  - chemFoam's h2 through the port's `run(case)` (100 steps) against the
    reference's reactor step (`ChemistryModel.solve` at rtol 1e-5 plus its
    constant-volume heat release) run the same 100 times: the reference's
    `chem_foam` fixes float32 for c and T, so under float64 its while_loop
    raises on its carry's dtype (ROADMAP Queue 3); the port keeps the
    precision's dtype.

In this process (float32): chemFoam h2 through both packages' `run(case)`,
T and Y held to the JAX package's, and the refusal of an unknown ODE
solver.
"""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest
import torch

from foamtpu_torch import ode as tode
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.models import chemistry as tchem
from foamtpu_torch.solvers import apps as tapps

from test_torch_ras_models import parity
from test_torch_simple import REPO

torch.set_num_threads(2)

H2 = os.path.join(REPO, "tutorials", "combustion", "chemFoam", "h2")
POOL = os.path.join(REPO, "tutorials", "combustion", "fireFoam",
                    "smallPoolFire2D")

UNITS = r'''
import jax
import jax.numpy as jnp
from foamtpu import ode as jode
from foamtpu.core.dictionary import parse_file as jparse
from foamtpu.models import chemistry as jchem, combustion as jcomb
from foamtpu_torch import ode as tode
from foamtpu_torch.core.dictionary import parse_file as tparse
from foamtpu_torch.models import chemistry as tchem, combustion as tcomb

def rel(a, b):
    a = np.asarray(a, float)
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b, float)
    if a.shape != b.shape:
        return float("inf")
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))

units = {}
rng = np.random.default_rng(15)
# -- integrate: a Robertson-like system, stiffness per lane -------------------
B = 8
k = np.exp(rng.uniform(-1.0, 6.0, B))
y0 = rng.uniform(0.5, 1.5, (B, 3))

def jf(kk):
    return lambda t, y: jnp.array([-kk * y[0] + y[1] * y[2],
                                   kk * y[0] - 3 * y[1] ** 2 - y[1] * y[2],
                                   3 * y[1] ** 2 + jnp.sin(t) * 0.0])

def tf(t, y, kk):
    return torch.stack([-kk * y[:, 0] + y[:, 1] * y[:, 2],
                        kk * y[:, 0] - 3 * y[:, 1] ** 2 - y[:, 1] * y[:, 2],
                        3 * y[:, 1] ** 2 + torch.sin(t) * 0.0], dim=1)

for solver in ("RKF45", "rodas23", "SIBS"):
    r = jax.vmap(lambda yy, kk: jode.integrate(
        jf(kk), yy, 0.0, 2.0, solver=solver, rtol=1e-6, atol=1e-10))(
            jnp.asarray(y0), jnp.asarray(k))
    tode.reset_stats()
    g = tode.integrate(tf, torch.tensor(y0), 0.0, 2.0, solver=solver,
                       rtol=1e-6, atol=1e-10, args=(torch.tensor(k),))
    units["integrate_" + solver] = {
        "y": rel(r.y, g.y), "t": rel(r.t, g.t),
        "n_steps": [np.asarray(r.n_steps).tolist(), g.n_steps.tolist()],
        "n_rejected": [np.asarray(r.n_rejected).tolist(),
                       g.n_rejected.tolist()],
        "syncs": tode.STATS["syncs"], "calls": tode.STATS["calls"],
        "lane_attempts": tode.STATS["lane_attempts"]}

# -- the methane mechanism of smallPoolFire2D --------------------------------
pool = os.path.join(os.getcwd(), "tutorials", "combustion", "fireFoam",
                    "smallPoolFire2D")
jc, jW = jchem.from_foam_files(jparse(pool + "/constant/reactions"),
                               jparse(pool + "/constant/thermo.compressibleGas"))
tc, tW = tchem.from_foam_files(tparse(pool + "/constant/reactions"),
                               tparse(pool + "/constant/thermo.compressibleGas"),
                               device="cpu")
units["from_foam_files"] = {
    "species": [list(jc.species), list(tc.species)],
    "arrays": {n: rel(getattr(jc, n), getattr(tc, n))
               for n in ("lhs", "rhs", "A", "beta", "Ta", "hf")},
    "W": rel(jW, torch.tensor(tW))}
nC = 12
Y = rng.dirichlet(np.ones(5), nC)
rho = 0.3 + rng.random(nC)
c = rho[:, None] * Y / jW[None, :]
T = 900.0 + 1200.0 * rng.random(nC)
ct, Tt = torch.tensor(c), torch.tensor(T)
om_j = np.stack([np.asarray(jc.omega(jnp.asarray(c[i]), T[i])) for i in range(nC)])
hr_j = np.array([float(jc.heat_release(jnp.asarray(c[i]), T[i])) for i in range(nC)])
units["omega"] = rel(om_j, tc.omega(ct, Tt))
units["omega_one_cell"] = rel(om_j[3], tc.omega(ct[3], Tt[3]))
units["heat_release"] = rel(hr_j, tc.heat_release(ct, Tt))
units["k"] = rel(jc.k(jnp.asarray(T[0])), tc.k(Tt[0]))
# the analytic Jacobian the port's solve takes, against jax.jacfwd of the
# reference's omega and against the port's forward-mode one
cj0 = ct.clone()
cj0[0, 2] = 0.0                      # a species at 0: no derivative
jac_j = np.stack([np.asarray(jax.jacfwd(lambda y: jc.omega(y, T[i]))(jnp.asarray(host_c)))
                  for i, host_c in enumerate(cj0.numpy())])
jac_t = tc.jacobian(cj0, Tt)
jac_f = tode.jacobian(lambda t, y, TT: tc.omega(y, TT), torch.zeros(nC, dtype=ct.dtype), cj0, (Tt,))
units["jacobian"] = rel(jac_j, jac_t)
units["jacobian_vs_jvp"] = rel(jac_f, jac_t)
units["solve"] = rel(jc.solve(jnp.asarray(c), jnp.asarray(T), 1e-4, rtol=1e-5),
                     tc.solve(ct, Tt, 1e-4, rtol=1e-5))
# a stiff two-step mechanism (tests/test_chemistry.py) over a batch
spec = [{"lhs": [("A", 1.0)], "rhs": [("B", 1.0)], "A": 1e6, "Ta": 0.0},
        {"lhs": [("B", 1.0)], "rhs": [("C", 1.0)], "A": 1.0, "Ta": 0.0}]
js = jchem.ChemistryModel.build(["A", "B", "C"], spec)
ts = tchem.ChemistryModel.build(["A", "B", "C"], spec, device="cpu")
c3 = rng.uniform(0.1, 1.0, (5, 3))
T3 = 300.0 + 100.0 * rng.random(5)
units["solve_stiff"] = rel(js.solve(jnp.asarray(c3), jnp.asarray(T3), 1.0),
                           ts.solve(torch.tensor(c3), torch.tensor(T3), 1.0))
# -- the closures ------------------------------------------------------------
eps = 10.0 ** rng.uniform(-4, 2, nC)
nu = 1e-5 * (1 + rng.random(nC))
adv = {}
for model in ("laminar", "PaSR", "infinitelyFastChemistry"):
    cj = jcomb.Combustion(chem=jc, model=model, Cmix=0.5, C=4.0)
    ctt = tcomb.Combustion(chem=tc, model=model, Cmix=0.5, C=4.0)
    adv[model] = rel(cj.advance(jnp.asarray(c), jnp.asarray(T), 2e-5,
                                epsilon=jnp.asarray(eps), nu_eff=jnp.asarray(nu)),
                     ctt.advance(ct, Tt, 2e-5, epsilon=torch.tensor(eps),
                                 nu_eff=torch.tensor(nu)))
adv["PaSR_no_mixing_data"] = rel(
    jcomb.Combustion(chem=jc, model="PaSR").advance(jnp.asarray(c), jnp.asarray(T), 2e-5),
    tcomb.Combustion(chem=tc, model="PaSR").advance(ct, Tt, 2e-5))
units["advance"] = adv
units["tc"] = rel(jcomb.Combustion(chem=jc).tc(jnp.asarray(c), jnp.asarray(T)),
                  tcomb.Combustion(chem=tc).tc(ct, Tt))
units["from_dict"] = [
    [jcomb.from_dict(d, jc).model, tcomb.from_dict(d, tc).model,
     jcomb.from_dict(d, jc).C, tcomb.from_dict(d, tc).C,
     jcomb.from_dict(d, jc).Cmix, tcomb.from_dict(d, tc).Cmix]
    for d in ({"combustionModel": "PaSR<psiChemistryCombustion>",
               "PaSRCoeffs": {"Cmix": 0.3}},
              {"combustionModel": "infinitelyFastChemistry<x>",
               "infinitelyFastChemistryCoeffs": {"C": 10.0}},
              {"combustionModel": "FSD<x>"}, {})]
# -- chemFoam h2: the port's run(case) against the reference's reactor step -
h2 = os.path.join(root, "h2")
shutil.copytree(os.path.join(os.getcwd(), "tutorials", "combustion",
                             "chemFoam", "h2"), h2)
tcase = TCase(h2, device="cpu")
with contextlib.redirect_stdout(io.StringIO()) as tlog:
    tapps.run(tcase)
from foamtpu.models.thermo import _janaf_from_mixture as jjanaf
rx = jparse(h2 + "/constant/reactions")
thd = jparse(h2 + "/constant/thermo.compressibleGas")
ic = jparse(h2 + "/constant/initialConditions")
hc, hW = jchem.from_foam_files(rx, thd)
sp = list(hc.species)
Yh = np.array([float(ic["fractions"].get(s, 0.0)) for s in sp])
Yh = Yh / Yh.sum()
R = 8314.47 * float((Yh / hW).sum())
p0, T0 = float(ic["p"]), float(ic["T"])
rho_h = p0 / (R * T0)
cp = sum(float(Yh[i]) * float(jjanaf(thd[s]).Cp_of(jnp.asarray(T0)))
         for i, s in enumerate(sp) if s in thd and Yh[i] > 0) / Yh[Yh > 0].sum()
cv = cp - R
ch = jnp.asarray((rho_h * Yh / hW)[None, :])
Th = jnp.asarray([T0])
step = jax.jit(lambda c, T: (lambda cn: (cn, T + (-(cn - c) @ hc.hf) / (rho_h * cv)))(
    hc.solve(c, T, 1e-5, rtol=1e-5)))
for _ in range(100):
    ch, Th = step(ch, Th)
fs = tcase.final_state
units["chemfoam_h2"] = {
    "T": [float(Th[0]), fs["T"]],
    "Y": rel(np.asarray(ch[0]) * hW / rho_h, fs["Y"]),
    "steps": tcase.time.index,
    "log_T": tlog.getvalue().count(" T = ")}
print(json.dumps({"units": units}))
'''


@pytest.fixture(scope="module")
def units():
    return parity("slice15", 3, [], tail=UNITS)["units"]


@pytest.mark.parametrize("solver", ["RKF45", "rodas23", "SIBS"])
def test_integrate_matches_vmapped_reference_per_lane(units, solver):
    u = units["integrate_" + solver]
    assert u["y"] < 1e-12 and u["t"] < 1e-14, u
    assert u["n_steps"][0] == u["n_steps"][1], u
    assert u["n_rejected"][0] == u["n_rejected"][1], u
    # the lanes need different numbers of steps: the loop's masking shows
    assert len(set(u["n_steps"][0])) > 3
    # one host read per pass of the loop, one more before it
    assert u["calls"] == 1
    assert u["syncs"] - 1 == max(
        s + r for s, r in zip(u["n_steps"][1], u["n_rejected"][1]))
    assert u["lane_attempts"] == sum(u["n_steps"][1]) + sum(
        u["n_rejected"][1])


def test_from_foam_files_matches_reference(units):
    u = units["from_foam_files"]
    assert u["species"][0] == u["species"][1] == ["CH4", "O2", "CO2", "H2O",
                                                   "N2"]
    assert all(v == 0.0 for v in u["arrays"].values()), u
    assert u["W"] == 0.0


@pytest.mark.parametrize("what", ["omega", "omega_one_cell", "heat_release",
                                  "k", "solve", "solve_stiff", "tc",
                                  "jacobian", "jacobian_vs_jvp"])
def test_chemistry_functions_match_reference(units, what):
    assert units[what] < 1e-9, (what, units[what])


@pytest.mark.parametrize("model", ["laminar", "PaSR",
                                   "infinitelyFastChemistry",
                                   "PaSR_no_mixing_data"])
def test_combustion_advance_matches_reference(units, model):
    assert units["advance"][model] < 1e-9, (model, units["advance"])


def test_combustion_from_dict_matches_reference(units):
    for row in units["from_dict"]:
        assert row[0] == row[1] and row[2] == row[3] and row[4] == row[5]
    assert [r[0] for r in units["from_dict"]] == [
        "PaSR", "infinitelyFastChemistry", "laminar", "laminar"]


def test_chemfoam_h2_matches_reference_reactor_f64(units):
    u = units["chemfoam_h2"]
    assert u["steps"] == 100 and u["log_T"] == 100
    assert abs(u["T"][1] - u["T"][0]) <= 1e-9 * u["T"][0], u
    assert u["Y"] < 1e-9, u
    # the mixture burns: the reactor heats by more than 1500 K
    assert u["T"][1] > 3000.0


def _run_both(tmp_path):
    from foamtpu.core.case import run_case as jrun

    jd, td = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(H2, jd)
    shutil.copytree(H2, td)
    with contextlib.redirect_stdout(io.StringIO()):
        jc = jrun(jd)
        tc = TCase(td, device="cpu")
        tapps.run(tc)
    return jc.final_state, tc.final_state


def test_chemfoam_h2_matches_reference_f32(tmp_path):
    """Both packages' chemFoam in float32, the port held to the JAX
    package's result (its golden): T at 1e-6 relative, Y at 1e-6."""
    js, ts = _run_both(tmp_path)
    assert ts["species"] == js["species"] == ["O2", "H2O", "CH4", "CO2",
                                              "N2"]
    assert abs(ts["T"] - js["T"]) <= 1e-6 * js["T"], (ts["T"], js["T"])
    np.testing.assert_allclose(ts["Y"], js["Y"], rtol=0, atol=1e-6)
    assert abs(ts["p"] - js["p"]) <= 1e-6 * js["p"]
    assert abs(ts["Y"].sum() - 1.0) < 1e-5


def test_unknown_ode_solver_raises():
    with pytest.raises(ValueError, match="unknown ODE solver"):
        tode.integrate(lambda t, y: y, torch.ones(2, 1), 0.0, 1.0,
                       solver="Euler")


def test_chemistry_model_defaults_to_the_card():
    import inspect

    from foamtpu_torch.core.precision import DEFAULT_DEVICE

    for fn in (tchem.ChemistryModel.build, tchem.from_foam_files):
        assert inspect.signature(fn).parameters["device"].default == \
            DEFAULT_DEVICE
    assert tapps.APPLICATIONS["chemFoam"] is tapps.chem_foam
