"""foamtpu_torch's DSMC (lagrangian/dsmc.py) and molecular dynamics
(lagrangian/md.py), with dsmcFoam, mdFoam and mdEquilibrationFoam, against
the JAX package.

torch cannot replay jax.random's threefry stream, so every draw of the
port's DSMC goes through the cloud's random source. In float64 (one
subprocess, FOAMTPU_X64=1 JAX_ENABLE_X64=1) the source is `JaxDraws`
below: it makes the reference's draws with jax.random in the reference's
order of splits (per collision round split(key, 5), then uniforms of k1,
k2, k3, k4 and fold_in(k4, 1)) and hands them over, so both packages
collide the same pairs:

- twins of tests/test_discretemethods.py: the anisotropic relaxation (80
  collision calls of 8 rounds), the closed box (20 steps of free flight
  and collisions) with its sampled fields, the NVE Lennard-Jones box (200
  Verlet steps) and the equilibration (300 steps): velocities, positions,
  forces, sigma_cr_max and the fields at rtol 1e-9, cells and flags
  equal, and the reference tests' oracles on the port's numbers;
- dsmcFoam on the shipped dsmcBox (tests/test_discretemethods.py's case:
  3 steps, the reference's draws replayed), mdFoam and
  mdEquilibrationFoam on their tutorials (3 steps), through run(case):
  every array of the final state, the log lines and the written fields.

Beside it the three tutorials run through `python -m foamtpu_torch run
-device cpu` with the port's own torch.Generator: the particle count
conserved, temperatures near the initial 300 K (dsmcBox) and the MD logs.
"""

import re

import numpy as np
import pytest
import torch

from foamtpu_torch.lagrangian import dsmc as tdsmc
from foamtpu_torch.lagrangian import md as tmd
from foamtpu_torch.solvers import apps as tapps
from foamtpu_torch.solvers import parcels

from test_torch_lagrangian import cli_runs, f64_body
from test_torch_reactingcloud import assert_app_parity

torch.set_num_threads(2)

DRAWS = r'''
import jax
import jax.numpy as jnp


class JaxDraws:
    """The reference's draws, in its order of splits (dsmc.py: each
    collision round split(key, 5) -> uniforms of k1, k2 (default dtype),
    k3, k4 and fold_in(k4, 1); a diffuse-wall resample split(key) ->
    normal(k1))."""

    def __init__(self, key):
        self.key = key
        self.queue = []
        self.n = 0

    def uniform(self, shape, dtype):
        if not self.queue:
            self.key, k1, k2, k3, k4 = jax.random.split(self.key, 5)
            f = jnp.float64
            self.queue = [jax.random.uniform(k1, shape),
                          jax.random.uniform(k2, shape),
                          jax.random.uniform(k3, shape, f),
                          jax.random.uniform(k4, shape, f),
                          jax.random.uniform(jax.random.fold_in(k4, 1),
                                             shape, f)]
        self.n += 1
        return torch.tensor(np.asarray(self.queue.pop(0)), dtype=dtype)

    def normal(self, shape, dtype):
        self.key, k1 = jax.random.split(self.key)
        self.n += 1
        return torch.tensor(np.asarray(jax.random.normal(
            k1, shape, jnp.float64)), dtype=dtype)
'''

UNITS = DRAWS + r'''
from foamtpu import lagrangian as jlag
from foamtpu.core.dictionary import parse_string as jparse
from foamtpu.lagrangian import dsmc as jdsmc, md as jmd
from foamtpu.mesh import blockmesh as jbm, to_device as jdev
from foamtpu_torch import lagrangian as tlag
from foamtpu_torch.convert import (dsmc_from_numpy, md_state_from_numpy,
                                   mesh_from_numpy)
from foamtpu_torch.lagrangian import dsmc as tdsmc, md as tmd

BOX = """
convertToMeters 1;
vertices
(
    (0 0 0) (1 0 0) (1 1 0) (0 1 0)
    (0 0 1) (1 0 1) (1 1 1) (0 1 1)
);
blocks ( hex (0 1 2 3 4 5 6 7) (6 6 6) simpleGrading (1 1 1) );
boundary
(
    walls { type wall; faces ((2 6 5 1) (0 4 7 3) (1 5 4 0)
                              (3 7 6 2) (0 3 2 1) (4 5 6 7)); }
);
"""
jm = jdev(jbm.generate(jparse(BOX)))
tm = mesh_from_numpy(jm, device="cpu")
JAR = jdsmc.Species(mass=jnp.asarray([6.63e-26]),
                    d_ref=jnp.asarray([4.17e-10]),
                    omega=jnp.asarray([0.81]), T_ref=273.0)
TAR = tdsmc.Species(mass=torch.tensor([6.63e-26], dtype=torch.float64),
                    d_ref=torch.tensor([4.17e-10], dtype=torch.float64),
                    omega=torch.tensor([0.81], dtype=torch.float64),
                    T_ref=273.0)
out = {}


def f64(v):
    return torch.tensor(v, dtype=torch.float64)


def temps(u, act, m):
    c = u[act] - u[act].mean(axis=0)
    return (m * np.mean(c * c, axis=0) / tdsmc.K_BOLTZ).tolist()


# the anisotropic relaxation
nd = 1.0e20
vc = float(host(jm.v)[0])
fn = nd * vc / 20.0
jc = jdsmc.initialise(jm, JAR, nd, 600.0, (0.0, 0.0, 0.0), fn, seed=3)
rng = np.random.default_rng(4)
n = host(jc.active).shape[0]
m = 6.63e-26
sx, syz = np.sqrt(tdsmc.K_BOLTZ * 600.0 / m), np.sqrt(tdsmc.K_BOLTZ * 150.0 / m)
u = np.stack([sx * rng.standard_normal(n), syz * rng.standard_normal(n),
              syz * rng.standard_normal(n)], axis=1)
jc = jc._replace(u=jnp.asarray(u))
tc = dsmc_from_numpy(jc, JaxDraws(jax.random.PRNGKey(3)), device="cpu")
act = host(tc.active)
T0 = temps(host(tc.u), act, m)
mom0 = host(tc.u)[act].sum(axis=0)
ke0 = float((host(tc.u)[act] ** 2).sum())
jcfg = jdsmc.DsmcConfig(nEquivalentParticles=fn, n_rounds=8)
tcfg = tdsmc.DsmcConfig(nEquivalentParticles=fn, n_rounds=8)
collide = jax.jit(lambda c: jdsmc._collide(jm, c, jnp.asarray(5.0e-6), jcfg,
                                           JAR))
for _ in range(80):
    jc = collide(jc)
    tc = tdsmc._collide(tm, tc, f64(5.0e-6), tcfg, TAR)
out["relax"] = {"errs": cmp_tuple(tc, jc), "T0": T0,
                "T1": temps(host(tc.u), act, m),
                "mom0": mom0.tolist(),
                "mom1": host(tc.u)[act].sum(axis=0).tolist(), "ke0": ke0,
                "ke1": float((host(tc.u)[act] ** 2).sum()),
                "draws": tc.draws.n}

# the closed box: free flight, specular walls, collisions
fn = nd * vc / 12.0
jc = jdsmc.initialise(jm, JAR, nd, 300.0, (0.0, 0.0, 0.0), fn, seed=7)
tc = dsmc_from_numpy(jc, JaxDraws(jax.random.PRNGKey(7)), device="cpu")
jbt = jnp.asarray(jlag.face_boundary_types(jm))
tbt = torch.tensor(tlag.face_boundary_types(tm))
jcfg = jdsmc.DsmcConfig(nEquivalentParticles=fn, n_rounds=4)
tcfg = tdsmc.DsmcConfig(nEquivalentParticles=fn, n_rounds=4)
act0 = host(tc.active)
ke0 = float((host(tc.u)[act0] ** 2).sum())
n0 = int(tc.n_active)
step = jax.jit(lambda c: jdsmc.evolve(jm, c, jnp.asarray(2.0e-5), jbt, jcfg,
                                      JAR))
for _ in range(20):
    jc = step(jc)
    tc = tdsmc.evolve(tm, tc, f64(2.0e-5), tbt, tcfg, TAR)
jf = jdsmc.sample_fields(jm, jc, JAR, fn)
tf = tdsmc.sample_fields(tm, tc, TAR, fn)
act = host(tc.active)
x = host(tc.x)[act]
errs = cmp_tuple(tc, jc)
errs.update({"field." + k: cmp(tf[k], jf[k]) for k in jf})
out["box"] = {"errs": errs, "n0": n0, "n1": int(tc.n_active), "ke0": ke0,
              "ke1": float((host(tc.u)[act] ** 2).sum()),
              "x_min": float(x.min()), "x_max": float(x.max()),
              "T_mean": float(host(tf["T"]).mean()),
              "rhoN_mean": float(host(tf["rhoN"]).mean()), "nd": nd}

# NVE Lennard-Jones (reduced units), 200 Verlet steps
kw = dict(epsilon=1.0, sigma=1.0, mass=1.0, box=(6.3, 6.3, 6.3), r_cut=2.5)
jcf, tcf = jmd.MdConfig(**kw), tmd.MdConfig(**kw)
x, u = jmd.lattice_fill(jcf.box, 5, mass=1.0, T0=0.8 / jmd.K_BOLTZ, seed=1)
js = jmd.make_state(x, u, jcf, dtype=jnp.float64)
ts = tmd.make_state(x, u, tcf, dtype=torch.float64, device="cpu")
# (the lattice's initial forces are round-off: zero by symmetry)
init = {}
_, tpot0 = tmd._pair_forces(ts.x, tcf, tile=32)
_, jpot0 = jmd._pair_forces(js.x, jcf)
init["pot_tiled"] = cmp(tpot0, jpot0)
e0 = float(tmd.kinetic_energy(ts, tcf) + tpot0)
ke0 = float(tmd.kinetic_energy(ts, tcf))
jstep = jax.jit(lambda s: jmd.verlet_step(s, 0.005, jcf))
pots = []
for _ in range(200):
    js, jpot = jstep(js)
    ts, tpot = tmd.verlet_step(ts, 0.005, tcf)
    pots.append(cmp(tpot, jpot))
errs = cmp_tuple(ts, js)
errs.update(init)
errs["pot"] = {"ok": all(p["ok"] for p in pots)}
out["nve"] = {"errs": errs, "e0": e0, "ke0": ke0,
              "e1": float(tmd.kinetic_energy(ts, tcf) + tpot)}

# the equilibration toward 120 K, 300 steps
kw = dict(epsilon=1.656e-21, sigma=3.4e-10, mass=6.63e-26,
          box=(2.14e-9,) * 3, r_cut=8.5e-10)
jcf, tcf = jmd.MdConfig(**kw), tmd.MdConfig(**kw)
x, u = jmd.lattice_fill(jcf.box, 5, mass=jcf.mass, T0=60.0, seed=2)
js = jmd.make_state(x, u, jcf)
ts = md_state_from_numpy(js, device="cpu")
jstep = jax.jit(lambda s: jmd.equilibrate_step(s, 1e-14, jcf, 120.0,
                                               relax=0.1))
for _ in range(300):
    js, _ = jstep(js)
    ts, _ = tmd.equilibrate_step(ts, 1e-14, tcf, 120.0, relax=0.1)
out["equil"] = {"errs": cmp_tuple(ts, js),
                "T": float(tmd.temperature(ts, tcf)),
                "T_ref": float(jmd.temperature(js, jcf))}
print(json.dumps(out))
'''

# dsmcFoam's cases draw the reference's stream: run(case) seeds its
# initialise with 0, the PRNGKey(0) of the reference
APP_DRAWS = DRAWS + r'''
DRAWS = {"dsmcFoam": lambda case: JaxDraws(jax.random.PRNGKey(0))}
'''

STEPS = 3


@pytest.fixture(scope="module")
def units():
    return f64_body(UNITS)


@pytest.fixture(scope="module")
def apps_rec():
    from test_torch_reactingcloud import app_parity

    return app_parity(("dsmcFoam", "mdFoam", "mdEquilibrationFoam"), STEPS,
                      draws=APP_DRAWS)


def _errs_ok(rec, what):
    assert rec["errs"], what
    for k, e in rec["errs"].items():
        assert e["ok"], (what, k, e)


@pytest.mark.parametrize("name", ["relax", "box", "nve", "equil"])
def test_matches_reference_f64(units, name):
    _errs_ok(units[name], name)


def test_dsmc_collisions_isotropize_and_conserve(units):
    r = units["relax"]
    T0, T1 = np.asarray(r["T0"]), np.asarray(r["T1"])
    assert T0[0] > 2.5 * T0[1]
    mom0, mom1 = np.asarray(r["mom0"]), np.asarray(r["mom1"])
    assert (np.max(np.abs(mom1 - mom0)) / np.abs(mom0).max() < 1e-3
            or np.max(np.abs(mom1 - mom0)) < 1e-3 * np.sqrt(r["ke0"]))
    assert abs(r["ke1"] - r["ke0"]) / r["ke0"] < 1e-4
    assert T1.max() - T1.min() < 0.35 * (T0.max() - T0.min())
    assert abs(T1.mean() - T0.mean()) / T0.mean() < 0.02
    # five uniform draws per round, 8 rounds per call, 80 calls
    assert r["draws"] == 5 * 8 * 80


def test_dsmc_evolve_in_box_conserves_energy(units):
    r = units["box"]
    assert r["n1"] == r["n0"]
    assert abs(r["ke1"] - r["ke0"]) / r["ke0"] < 1e-4
    assert r["x_min"] > -1e-6 and r["x_max"] < 1.0 + 1e-6
    assert 200.0 < r["T_mean"] < 400.0
    assert abs(r["rhoN_mean"] - r["nd"]) / r["nd"] < 0.05


def test_md_nve_energy_conservation(units):
    r = units["nve"]
    assert abs(r["e1"] - r["e0"]) < 0.01 * abs(r["ke0"])


def test_md_equilibration_reaches_target(units):
    assert abs(units["equil"]["T"] - 120.0) < 12.0


@pytest.mark.parametrize("name", ["dsmcFoam", "mdFoam",
                                  "mdEquilibrationFoam"])
def test_application_matches_reference_f64(apps_rec, name):
    rec = apps_rec[name]
    # (the MD applications write no fields, as the reference's)
    assert_app_parity(rec, STEPS, name, n_solves=0,
                      files=name == "dsmcFoam")
    want = ({"cloud.x", "cloud.u", "cloud.cell", "cloud.active",
             "cloud.sigma_cr_max", "fields.T", "fields.rhoN"}
            if name == "dsmcFoam" else {"state.x", "state.u", "state.f",
                                        "T"})
    assert want <= set(rec["errs"]), (name, sorted(rec["errs"]))


def test_dsmc_draws_from_a_torch_generator():
    """The default source: a seeded torch.Generator on the given device,
    the same stream for the same seed."""
    a, b = tdsmc.TorchDraws(5, "cpu"), tdsmc.TorchDraws(5, "cpu")
    x = a.uniform((7,), torch.float64)
    assert torch.equal(x, b.uniform((7,), torch.float64))
    assert float(x.min()) >= 0.0 and float(x.max()) < 1.0
    assert a.normal((3, 3), torch.float32).dtype == torch.float32


def test_md_row_tiles_agree():
    """The row-tiled pair forces do not depend on the tile."""
    cfg = tmd.MdConfig(epsilon=1.0, sigma=1.0, mass=1.0, box=(4.2,) * 3,
                       r_cut=2.5)
    x, _ = tmd.lattice_fill(cfg.box, 4, 1.0, 1.0)
    x = torch.tensor(x)
    f1, p1 = tmd._pair_forces(x, cfg, tile=64)
    f2, p2 = tmd._pair_forces(x, cfg, tile=7)
    assert torch.allclose(f1, f2, rtol=1e-12, atol=1e-12)
    assert abs(float(p1) - float(p2)) < 1e-10 * abs(float(p1))


def test_discrete_methods_run_their_tutorials(tmp_path):
    """dsmcBox, nveBox and periodicBox as shipped through `python -m
    foamtpu_torch run -device cpu`."""
    runs = cli_runs(("dsmcFoam", "mdFoam", "mdEquilibrationFoam"), 3,
                    str(tmp_path))
    for name, (rc, so, se, d) in runs.items():
        assert rc == 0, (name, se[-2000:])
        assert so.count("End") == 1
    so = runs["dsmcFoam"][1]
    n = [int(x) for x in re.findall(r"Number of dsmc particles = (\d+)", so)]
    n0 = int(re.search(r"dsmcFoam, (\d+) parcels", so).group(1))
    assert n == [n0] * 3 and n0 > 1000
    T = [float(x) for x in re.findall(r"temperature = (\S+) K",
                                      runs["mdFoam"][1])]
    E = [float(x) for x in re.findall(r"total energy = (\S+) J",
                                      runs["mdFoam"][1])]
    assert len(T) == 3 and len(E) == 3 and all(np.isfinite(T + E))
    assert tapps.APPLICATIONS["dsmcFoam"] is parcels.dsmc_foam
