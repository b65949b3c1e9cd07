"""foamtpu_torch's reacting parcels (lagrangian/reactingcloud.py), the
liquid package (models/liquids.py), the reacting-parcel applications
(solvers/parcels.py) and sprayEngineFoam against the JAX package.

In float64 (one subprocess, FOAMTPU_X64=1 JAX_ENABLE_X64=1):

- twins of tests/test_reactingcloud.py's unit tests (d^2-law evaporation,
  exhausted parcels, devolatilisation and char burnout, Reitz-Diwakar
  breakup) and of tests/test_liquids.py (both liquids' seven properties
  on a field of temperatures, `from_dict`, `liquid_evaporate`), each on
  the same numpy inputs: arrays at rtol 1e-9, flags equal, and the
  reference test's oracle on the port's numbers;
- the six reacting-parcel applications and sprayEngineFoam on their
  tutorials (chip_smoke.slice17_case, U and T seeded: the shipped starts
  are uniform with U = 0, so the first steps' U is the pressure solve's
  round-off), 3 steps through each package's run(case): every array of
  the final state (the carrier's fields, the cloud, Yvapour, the coal's
  volatile fraction, the film) at rtol 1e-9, every Krylov solve's
  iteration count equal in order, the log lines and the written fields.

Beside it the seven applications run their shipped tutorials through
`python -m foamtpu_torch run -device cpu`.
"""

import re

import numpy as np
import pytest
import torch

import chip_smoke
from foamtpu_torch.models import liquids as tliq
from foamtpu_torch.solvers import apps as tapps
from foamtpu_torch.solvers import parcels

from test_torch_lagrangian import cli_runs, f64_body

torch.set_num_threads(2)

STEPS = 3

UNITS = r'''
import jax
import jax.numpy as jnp
from foamtpu import lagrangian as jlag
from foamtpu.core.dictionary import parse_string as jparse
from foamtpu.lagrangian import reactingcloud as jrc
from foamtpu.mesh import blockmesh as jbm, to_device as jdev
from foamtpu.models import liquids as jliq
from foamtpu_torch import lagrangian as tlag
from foamtpu_torch.convert import (cloud_from_numpy, coal_from_numpy,
                                   mesh_from_numpy)
from foamtpu_torch.lagrangian import reactingcloud as trc
from foamtpu_torch.models import liquids as tliq

BOX = """
convertToMeters 1;
vertices
(
    (0 0 0) (1 0 0) (1 1 0) (0 1 0)
    (0 0 1) (1 0 1) (1 1 1) (0 1 1)
);
blocks ( hex (0 1 2 3 4 5 6 7) (4 4 4) simpleGrading (1 1 1) );
boundary
(
    walls { type wall; faces ((2 6 5 1) (0 4 7 3) (1 5 4 0)
                              (3 7 6 2) (0 3 2 1) (4 5 6 7)); }
);
"""
jm = jdev(jbm.generate(jparse(BOX)))
tm = mesh_from_numpy(jm, device="cpu")
nC = jm.n_cells
out = {}


def f64(v):
    return torch.tensor(v, dtype=torch.float64)


def clouds(n=20, d=1e-4, rho=1000.0):
    rng = np.random.default_rng(0)
    x = 0.2 + 0.6 * rng.random((n, 3))
    jc = jlag.make_cloud(jm, x, [0.0, 0.0, 0.0], d, rho)
    return jc, cloud_from_numpy(jc, device="cpu")


def record(name, tc, jc, pairs=(), extra=None):
    rec = {"errs": cmp_tuple(tc, jc)}
    for k, (a, b) in dict(pairs).items():
        rec["errs"][k] = cmp(a, b)
    rec.update(extra or {})
    out[name] = rec


# d^2-law evaporation, 10 steps
jc, tc = clouds()
cfg_kw = dict(rho_f=1.0, mu_f=1.8e-5)
jcfg, tcfg = jlag.CloudConfig(**cfg_kw), tlag.CloudConfig(**cfg_kw)
jecfg, tecfg = jrc.EvapConfig(K_evap=1e-8), trc.EvapConfig(K_evap=1e-8)
Uf, Tf = np.zeros((nC, 3)), np.full(nC, 400.0)
m0 = float((host(tc.rho) * np.pi / 6 * host(tc.d) ** 3).sum())
d2_0 = float(host(tc.d)[0] ** 2)
vap_tot = 0.0
for _ in range(10):
    jc, jv, jh = jrc.evaporate(jc, jnp.asarray(Uf), jnp.asarray(Tf),
                               jnp.asarray(1e-2), jcfg, jecfg, nC)
    tc, tv, th = trc.evaporate(tc, f64(Uf), f64(Tf), f64(1e-2), tcfg, tecfg,
                               nC)
    vap_tot += float(tv.sum())
act = host(tc.active)
record("evaporate", tc, jc, {"vap": (tv, jv), "heat": (th, jh)},
       {"d2": float(host(tc.d)[0] ** 2), "d2_0": d2_0, "m0": m0,
        "m1": float((host(tc.rho) * np.pi / 6 * host(tc.d) ** 3)[act].sum()),
        "vap_tot": vap_tot})

# exhausted parcels
jc, tc = clouds(d=2e-6)
jecfg, tecfg = (jrc.EvapConfig(K_evap=1e-8, d_min=1e-6),
                trc.EvapConfig(K_evap=1e-8, d_min=1e-6))
jcfg, tcfg = jlag.CloudConfig(), tlag.CloudConfig()
for _ in range(5):
    jc, _, _ = jrc.evaporate(jc, jnp.asarray(Uf), jnp.asarray(Tf),
                             jnp.asarray(0.2), jcfg, jecfg, nC)
    tc, _, _ = trc.evaporate(tc, f64(Uf), f64(Tf), f64(0.2), tcfg, tecfg, nC)
record("exhausted", tc, jc, extra={"n_active": int(tc.n_active)})

# devolatilisation, then char burnout
jb, tb = clouds(d=1e-4, rho=1400.0)
jb = jb._replace(T=jnp.full_like(jb.T, 1200.0))
jcoal = jrc.CoalCloud(base=jb, yvol=jnp.full_like(jb.d, 0.4))
tcoal = coal_from_numpy(jcoal, device="cpu")
jccfg = jrc.CoalConfig(A1=2e5, E=7.4e7, Yvol0=0.4)
tccfg = trc.CoalConfig(A1=2e5, E=7.4e7, Yvol0=0.4)
Th = np.full(nC, 1200.0)
fuel_tot, heat_min = 0.0, 0.0
for i in range(20):
    jcoal, jf, jh = jrc.devolatilise(jcoal, jnp.asarray(Th), jnp.asarray(1e-3),
                                     jccfg, nC)
    tcoal, tf, th = trc.devolatilise(tcoal, f64(Th), f64(1e-3), tccfg, nC)
    fuel_tot += float(tf.sum())
    heat_min = min(heat_min, float(th.sum()))
yv20 = float(tcoal.yvol[0])
d_before = float(tcoal.base.d[0])
for _ in range(40):
    jcoal, jf, jh = jrc.devolatilise(
        jcoal._replace(yvol=jnp.zeros_like(jcoal.yvol)), jnp.asarray(Th),
        jnp.asarray(1e-3), jccfg, nC)
    tcoal, tf, th = trc.devolatilise(
        tcoal._replace(yvol=torch.zeros_like(tcoal.yvol)), f64(Th),
        f64(1e-3), tccfg, nC)
record("devolatilise", tcoal, jcoal, {"fuel": (tf, jf), "heat": (th, jh)},
       {"yv20": yv20, "fuel_tot": fuel_tot, "heat_min": heat_min,
        "d_before": d_before, "d_after": float(tcoal.base.d[0])})

# Reitz-Diwakar breakup
jc, tc = clouds(d=5e-4, rho=800.0)
jbc = jrc.BreakupConfig(sigma=0.026, rho_f=30.0, we_crit=6.0)
tbc = trc.BreakupConfig(sigma=0.026, rho_f=30.0, we_crit=6.0)
# (the reference test passes [Np, 3], whose gather jax clamps; a carrier
# field is [nC, 3])
u_fast = np.zeros((nC, 3))
u_fast[:, 0] = 100.0
d0 = float(tc.d[0])
jc2, tc2 = jc, tc
for _ in range(21):
    jc2 = jrc.reitz_diwakar_breakup(jc2, jnp.asarray(u_fast), 1e-3, jbc)
    tc2 = trc.reitz_diwakar_breakup(tc2, f64(u_fast), 1e-3, tbc)
tc3 = trc.reitz_diwakar_breakup(tc, f64(np.zeros_like(u_fast)), 1e-3, tbc)
record("breakup", tc2, jc2, extra={"d0": d0, "d21": float(tc2.d[0]),
                                   "d_still": float(tc3.d[0])})

# the liquid package on a field of temperatures
T = np.linspace(250.0, 520.0, 55)
props = {}
for name in ("H2O", "C7H16"):
    jl, tl = jliq.get(name), tliq.get(name)
    for p in ("rho", "pv", "hl", "cp", "mu", "kappa", "sigma"):
        props[f"{name}.{p}"] = cmp(getattr(tl, p)(f64(T)),
                                   getattr(jl, p)(jnp.asarray(T)), 1e-12)
    props[f"{name}.Ts_clip"] = cmp(tl.Ts_clip(f64(T + 300.0)),
                                   jl.Ts_clip(jnp.asarray(T + 300.0)))
jl = jliq.from_dict("H2O", {"rho": ["NSRDSfunc0", 950.0],
                            "pv": ["NSRDSfunc1", 70.0, -7000.0, -7.0, 4e-6,
                                   2.0]})
tl = tliq.from_dict("H2O", {"rho": ["NSRDSfunc0", 950.0],
                            "pv": ["NSRDSfunc1", 70.0, -7000.0, -7.0, 4e-6,
                                   2.0]})
for p in ("rho", "pv", "hl"):
    props[f"dict.{p}"] = cmp(getattr(tl, p)(f64(T)),
                             getattr(jl, p)(jnp.asarray(T)), 1e-12)
out["liquids"] = props

# liquid_evaporate (tests/test_liquids.py's droplets)
n = 8
jc = jlag.Cloud(x=jnp.zeros((n, 3)), u=jnp.zeros((n, 3)),
                d=jnp.full(n, 50e-6), rho=jnp.full(n, 998.0),
                cell=jnp.arange(n, dtype=jnp.int32),
                active=jnp.ones(n, bool),
                T=jnp.asarray([300.0] * 4 + [350.0] * 4))
tc = cloud_from_numpy(jc, device="cpu")
cfg_kw = dict(rho_f=1.2, mu_f=1.8e-5)
jc2, jv, jh = jrc.liquid_evaporate(
    jc, jnp.zeros((16, 3)), jnp.full(16, 400.0), jnp.full(16, 1e5), 1e-4,
    jlag.CloudConfig(**cfg_kw), jliq.H2O, 16)
tc2, tv, th = trc.liquid_evaporate(
    tc, torch.zeros((16, 3), dtype=torch.float64),
    torch.full((16,), 400.0, dtype=torch.float64),
    torch.full((16,), 1e5, dtype=torch.float64), 1e-4,
    tlag.CloudConfig(**cfg_kw), tliq.H2O, 16)
record("liquid_evaporate", tc2, jc2, {"vap": (tv, jv), "heat": (th, jh)},
       {"vap": host(tv).tolist(), "heat_sum": float(th[:8].sum()),
        "d": host(tc2.d).tolist(), "T": host(tc2.T).tolist(),
        "hl325": float(tliq.H2O.hl(f64(325.0)))})
print(json.dumps(out))
'''

# both packages' run(case) on a slice-17 case; `draws(name)` may give the
# port's DSMC cloud a random source (the discrete-methods tests replay the
# reference's draws)
APP_BODY = r'''
import jax
import chip_smoke as cs
import foamtpu.solvers.linear as jlin
import foamtpu_torch.solvers.linear as tlin
from foamtpu.apps.cli import main as jcli
from foamtpu.core.case import run_case as jrun
from foamtpu_torch.apps.cli import main as tcli
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.solvers import apps as tapps

# every Krylov solve's iteration count, in order, in both packages (the
# reference's steps are jitted: an ordered debug callback reports them)
counts = {"ref": [], "port": []}
_jsolve, _tsolve = jlin.solve, tlin.solve


def jsolve(*a, **k):
    data, perf = _jsolve(*a, **k)
    jax.debug.callback(lambda n: counts["ref"].append(int(n)),
                       perf.n_iterations, ordered=True)
    return data, perf


def tsolve(*a, **k):
    data, perf = _tsolve(*a, **k)
    counts["port"].append(int(perf.n_iterations))
    return data, perf


jlin.solve, tlin.solve = jsolve, tsolve
steps, names = int(sys.argv[1]), sys.argv[2:]
SKIP = ("diag", "key", "draws", "topo", "points0", "species")


def flat(obj, pre=""):
    """Every array of a final state by its path (VolFields by their
    data, NamedTuples and dicts by their entries)."""
    out = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            if k not in SKIP:
                out.update(flat(v, f"{pre}{k}."))
    elif hasattr(obj, "_fields"):
        for k in obj._fields:
            if k not in SKIP:
                out.update(flat(getattr(obj, k), f"{pre}{k}."))
    elif hasattr(obj, "bcs") and hasattr(obj, "data"):
        out[pre + "data"] = obj.data
    elif isinstance(obj, (torch.Tensor, np.ndarray, jax.Array)):
        out[pre[:-1]] = obj
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        out[pre[:-1]] = np.asarray(obj, dtype=float)
    return out


root = tempfile.mkdtemp()
out = {}
for name in names:
    seed = cs.SLICE17_SEED if name in cs.PARCEL_APPS else None
    jd, td = (cs.slice17_case(os.getcwd(), os.path.join(root, name, tag),
                              name, cli, seed=seed, write_precision=17,
                              edits=cs.SLICE17_TIGHT.get(name, ()))
              for tag, cli in (("ref", jcli), ("port", tcli)))
    counts["ref"].clear()
    counts["port"].clear()
    with contextlib.redirect_stdout(io.StringIO()) as jl:
        jc = jrun(jd, max_steps=steps)
    jax.effects_barrier()
    tc = TCase(td, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()) as tl:
        if name in DRAWS:
            tapps.parcels.dsmc_foam(tc, max_steps=steps, draws=DRAWS[name](tc))
        else:
            tapps.run(tc, max_steps=steps)
    assert tc.mesh.v.dtype == torch.float64
    a, b = flat(tc.final_state), flat(jc.final_state)
    rec = {"time": [tc.time.index, jc.time.index, tc.time.name,
                    jc.time.name],
           "keys": [sorted(a), sorted(b)],
           "errs": {k: cmp(a[k], b[k]) for k in b if k in a},
           "krylov": [list(counts["port"]), list(counts["ref"])],
           "logs": cmp_logs(tl.getvalue(), jl.getvalue()),
           "files": {}}
    for t in sorted(os.listdir(jd)):
        if t not in ("0", "constant", "system") and os.path.isdir(
                os.path.join(jd, t)):
            rec["files"][t] = cmp_dirs(os.path.join(td, t),
                                       os.path.join(jd, t))
    out[name] = rec
print(json.dumps(out))
'''


def app_parity(names, steps, draws=""):
    """APP_BODY over `names`; `draws` code defines DRAWS (name ->
    case -> random source)."""
    return f64_body("DRAWS = {}\n" + draws + APP_BODY,
                    args=(str(steps), *names), timeout=900)


def assert_app_parity(rec, steps, what, n_solves=1, files=True):
    assert rec["time"][0] == rec["time"][1] == steps, (what, rec["time"])
    assert rec["time"][2] == rec["time"][3], (what, rec["time"])
    assert rec["keys"][0] == rec["keys"][1], (what, rec["keys"])
    bad = {k: e for k, e in rec["errs"].items() if not e["ok"]}
    assert not bad, (what, bad)
    assert rec["krylov"][0] == rec["krylov"][1], (what, rec["krylov"])
    assert len(rec["krylov"][0]) >= n_solves * steps, (what, rec["krylov"])
    assert rec["logs"]["words"] and rec["logs"]["numbers"], (what,
                                                              rec["logs"])
    assert bool(rec["files"]) == files, (what, rec["files"])
    for t, f in rec["files"].items():
        assert f["names"][0] == f["names"][1], (what, t, f["names"])
        assert not f["bad"], (what, t, f["bad"])


@pytest.fixture(scope="module")
def units():
    return f64_body(UNITS)


@pytest.fixture(scope="module")
def apps_rec():
    return app_parity(chip_smoke.PARCEL_APPS, STEPS)


def _errs_ok(rec, what):
    assert rec["errs"], what
    for k, e in rec["errs"].items():
        assert e["ok"], (what, k, e)


@pytest.mark.parametrize("name", ["evaporate", "exhausted", "devolatilise",
                                  "breakup", "liquid_evaporate"])
def test_parcel_physics_matches_reference_f64(units, name):
    _errs_ok(units[name], name)


def test_d2_law_evaporation_conserves_mass(units):
    r = units["evaporate"]
    assert abs(r["d2"] - (r["d2_0"] - 10 * 1e-2 * 1e-8)) < 1e-12
    assert abs((r["m0"] - r["m1"]) - r["vap_tot"]) < 1e-5 * r["m0"]
    assert r["vap_tot"] > 0


def test_evaporation_kills_exhausted_parcels(units):
    assert units["exhausted"]["n_active"] == 0


def test_devolatilisation_and_char_burnout(units):
    r = units["devolatilise"]
    kv = 2e5 * np.exp(-7.4e7 / (8314.47 * 1200.0))
    assert abs(r["yv20"] - 0.4 * np.exp(-kv * 20 * 1e-3)) < 1e-3 * 0.4
    assert r["fuel_tot"] > 0 and r["heat_min"] >= 0.0
    assert r["d_after"] < r["d_before"]


def test_reitz_diwakar_breakup_direction(units):
    r = units["breakup"]
    assert r["d21"] < 0.5 * r["d0"] and r["d_still"] == r["d0"]


@pytest.mark.parametrize("liquid", ["H2O", "C7H16", "dict"])
def test_liquid_properties_match_reference_f64(units, liquid):
    errs = {k: e for k, e in units["liquids"].items()
            if k.startswith(liquid + ".")}
    assert len(errs) >= 3
    for k, e in errs.items():
        assert e["ok"], (k, e)


def test_liquid_evaporation_physics(units):
    r = units["liquid_evaporate"]
    vap = np.asarray(r["vap"])
    assert np.all(vap[:8] > 0) and vap[4:8].mean() > 2.0 * vap[:4].mean()
    assert np.all(np.asarray(r["d"]) < 50e-6)
    assert np.all(np.asarray(r["T"]) < np.array([300.0] * 4 + [350.0] * 4))
    assert r["heat_sum"] == pytest.approx(vap.sum() * r["hl325"] / 1e-4,
                                          rel=0.2)


def test_liquid_handbook_values():
    """tests/test_liquids.py's handbook oracles on the port."""
    T20 = torch.tensor(293.15, dtype=torch.float64)
    W = tliq.H2O
    assert float(W.rho(T20)) == pytest.approx(998.0, rel=5e-3)
    assert float(W.mu(T20)) == pytest.approx(1.0e-3, rel=0.05)
    assert float(W.pv(373.15)) == pytest.approx(1.013e5, rel=0.02)
    assert float(W.hl(T20)) == pytest.approx(2.45e6, rel=0.01)
    assert float(W.cp(T20)) == pytest.approx(4187.0, rel=0.01)
    assert float(W.kappa(T20)) == pytest.approx(0.60, rel=0.03)
    assert float(W.sigma(T20)) == pytest.approx(0.0728, rel=0.03)
    H = tliq.C7H16
    assert float(H.rho(300.0)) == pytest.approx(680.0, rel=0.02)
    assert float(H.pv(371.58)) == pytest.approx(1.013e5, rel=0.05)
    assert float(H.hl(300.0)) == pytest.approx(3.65e5, rel=0.03)
    liq = tliq.from_dict("H2O", {"rho": ["NSRDSfunc0", 950.0]})
    assert float(liq.rho(T20)) == 950.0
    assert float(liq.hl(T20)) == float(W.hl(T20))
    assert tliq.get("water") is W and tliq.get("heptane") is H
    with pytest.raises(ValueError):
        tliq.get("unobtanium")


@pytest.mark.parametrize("name", chip_smoke.PARCEL_APPS)
def test_application_matches_reference_f64(apps_rec, name):
    rec = apps_rec[name]
    # the carrier's p, U and T solves, then the Yvapour solve (the spray
    # engine carries Yv explicitly)
    assert_app_parity(rec, STEPS, name, n_solves=3)
    for k in ("state.U.data", "state.p.data", "state.T.data"):
        assert k in rec["errs"], (name, sorted(rec["errs"]))
    cloud = "state.cloud." if name == "sprayEngineFoam" else "cloud."
    for k in ("x", "u", "d", "T", "cell", "active"):
        assert cloud + k in rec["errs"], (name, k)


def test_parcel_applications_run_their_tutorials(tmp_path):
    """The seven tutorials as shipped through `python -m foamtpu_torch run
    -device cpu`: the logged parcel counts, the written Yvapour, and
    sprayEngineFoam's crank-angle log."""
    runs = cli_runs(chip_smoke.PARCEL_APPS, 3, str(tmp_path))
    for name, (rc, so, se, d) in runs.items():
        assert rc == 0, (name, se[-2000:])
        assert so.count("End") == 1, (name, so[-500:])
        if name == "sprayEngineFoam":
            assert len(re.findall(r"Crank angle = ", so)) == 3, so[-800:]
        else:
            n = [int(x) for x in re.findall(r"active parcels = (\d+)", so)]
            # (aachenBomb's 1 s steps carry every parcel out of its box)
            assert len(n) == 3 and (n[-1] > 0 or name == "sprayFoam"), (
                name, n)
            ym = [float(x) for x in re.findall(r"Yvapour mean = (\S+)", so)]
            assert all(np.isfinite(ym)) and all(y >= 0 for y in ym), ym
    assert tapps.APPLICATIONS["sprayFoam"] is parcels.spray_foam
    assert tapps.APPLICATIONS["sprayEngineFoam"] is tapps.spray_engine_foam
