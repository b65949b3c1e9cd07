"""foamtpu_torch's reactingFoam (solvers/reacting.py), XiFoam and PDRFoam
(solvers/xifoam.py) and the laminar flame-speed correlations
(models/flamespeed.py) against the JAX package.

In float64 (one process, FOAMTPU_X64=1 JAX_ENABLE_X64=1) both packages'
`run(case)` take 3 steps of counterFlowFlame2D (reactingFoam: the laminar
Rosenbrock chemistry in every cell, the reactingMixture EOS from the
species' janaf tables, Y as one [n, 5] field solved multi-RHS), of
moriyoshiHomogeneous (XiFoam) and of flamePropagation (PDRFoam), the last
two after setFields' boxToCell ignition kernel: fields at rtol 1e-9 (U, p,
T, phi, Y, b, Xi, k, epsilon, nut), every solve's iteration count equal,
the log lines and the written fields (tests/test_torch_ras_models.py's
PARITY_BODY). The starts are seeded (chip_smoke.SLICE15_CASES): the
tutorials carry limitedLinear schemes over uniform U, k and epsilon, and
counterFlowFlame2D's Uy is 0.

In the same process the correlations: Gulders for the three fuel sets,
GuldersEGR, RaviPetersen on a two-pressure table (the reference's order of
its `alpha` and `beta` tables, mirrored), each on a field of pressures;
`constant` gives None in both; the reactingMixture's R_mix and cp_mix.
"""

import numpy as np
import pytest
import torch

from foamtpu_torch.models import flamespeed as tfs
from foamtpu_torch.solvers import apps as tapps

from test_torch_ras_models import assert_parity, parity

torch.set_num_threads(2)

STEPS = 3
CASES = ("reactingFoam", "XiFoam", "PDRFoam")

UNITS = r'''
import jax.numpy as jnp
from foamtpu.models import flamespeed as jfs
from foamtpu.solvers import reacting as jre
from foamtpu_torch.models import flamespeed as tfs
from foamtpu_torch.solvers import reacting as tre

RAVI = {"TRef": 320.0, "pPoints": [1.0e5, 2.0e5, 4.0e5],
        "EqRPoints": [0.5, 1.5, 3.0],
        "alpha": [[[1.0, 1.0, 0.2], [3.0, 1.0], [2.0, 0.5, 0.1]],
                  [[0.5, 2.0], [1.0, 1.5], [1.5, 1.0]]],
        "beta": [[[1.0], [2.0], [1.5, 0.1]], [[1.2], [1.4], [1.6]]]}
COMBS = {
    "constant": {"laminarFlameSpeedCorrelation": "constant"},
    "GuldersMethane": {"laminarFlameSpeedCorrelation": "Gulders",
                       "fuel": "Methane", "equivalenceRatio": 0.9},
    "GuldersPropane": {"laminarFlameSpeedCorrelation": "Gulders",
                       "fuel": "Propane", "equivalenceRatio": 1.1},
    "GuldersIsoOctane": {"laminarFlameSpeedCorrelation": "Gulders",
                         "fuel": "IsoOctane", "equivalenceRatio": 1.0,
                         "IsoOctaneCoeffs": {"W": 0.5, "alpha": 1.6}},
    "GuldersEGR": {"laminarFlameSpeedCorrelation": "GuldersEGR",
                   "fuel": "Methane", "equivalenceRatio": 1.0, "EGR": 0.1},
    "RaviPetersen": {"laminarFlameSpeedCorrelation": "RaviPetersen",
                     "fuel": "Hydrogen", "equivalenceRatio": 1.2,
                     "HydrogenCoeffs": RAVI},
}
rng = np.random.default_rng(15)
p = 0.5e5 + 5e5 * rng.random(40)
fs = {}
for name, comb in COMBS.items():
    j, t = jfs.make_flame_speed(comb), tfs.make_flame_speed(comb)
    if j is None or t is None:
        fs[name] = [j is None, t is None]
        continue
    a = np.asarray(j(jnp.asarray(p), 350.0))
    b = t(torch.tensor(p), 350.0).numpy()
    fs[name] = float(np.abs(a - b).max() / np.abs(a).max())
units = {"flamespeed": fs}
# the reactingMixture of counterFlowFlame2D's species
from foamtpu.core.dictionary import parse_file as jparse
thd = jparse(os.getcwd() + "/tutorials/combustion/reactingFoam/"
             "counterFlowFlame2D/constant/thermo.compressibleGas")
sp = ["O2", "H2O", "CH4", "CO2", "N2"]
lo = np.array([[float(x) for x in thd[s]["thermodynamics"]["lowCpCoeffs"]][:7] for s in sp])
hi = np.array([[float(x) for x in thd[s]["thermodynamics"]["highCpCoeffs"]][:7] for s in sp])
tcm = np.array([float(thd[s]["thermodynamics"]["Tcommon"]) for s in sp])
W = np.array([32.0, 18.0, 16.0, 44.0, 28.0])
Y = rng.dirichlet(np.ones(5), 30)
T = 250.0 + 2500.0 * rng.random(30)
rj = jre.ReactingConfig(flow=None, chem=None, W=W, cp_lo=lo, cp_hi=hi,
                        t_common=tcm).mixture_RCp(jnp.asarray(Y), jnp.asarray(T))
rt = tre.ReactingConfig(flow=None, chem=None, W=W, cp_lo=lo, cp_hi=hi,
                        t_common=tcm).mixture_RCp(torch.tensor(Y), torch.tensor(T))
units["mixture"] = [float(np.abs(np.asarray(a) - b.numpy()).max() / np.abs(np.asarray(a)).max())
                    for a, b in zip(rj, rt)]
print(json.dumps({"units": units}))
'''


@pytest.fixture(scope="module")
def runs():
    return parity("slice15", STEPS, CASES, tail=UNITS, lines=2)


@pytest.mark.parametrize("name", CASES)
def test_application_matches_reference_f64(runs, name):
    rec = runs[0][name]
    assert_parity(rec, STEPS, name)
    want = {"U", "p", "T", "phi"} | ({"Y"} if name == "reactingFoam" else
                                      {"b", "Xi", "k", "epsilon", "nut"})
    assert want == set(rec["errs"]), rec["errs"].keys()
    names = [n for n, _ in rec["solves"][0]]
    logged = "T" if name == "reactingFoam" else "b"
    assert names.count(logged) == STEPS


@pytest.mark.parametrize("corr", ["GuldersMethane", "GuldersPropane",
                                  "GuldersIsoOctane", "GuldersEGR",
                                  "RaviPetersen"])
def test_flame_speed_correlations_match_reference(runs, corr):
    assert runs[1]["units"]["flamespeed"][corr] < 1e-12


def test_constant_flame_speed_is_none_in_both(runs):
    assert runs[1]["units"]["flamespeed"]["constant"] == [True, True]
    assert tfs.make_flame_speed({}) is None
    with pytest.raises(ValueError, match="unknown laminarFlameSpeed"):
        tfs.make_flame_speed({"laminarFlameSpeedCorrelation": "Metghalchi"})


def test_reacting_mixture_matches_reference(runs):
    r, cp = runs[1]["units"]["mixture"]
    assert r < 1e-12 and cp < 1e-12


def test_combustion_applications_are_registered():
    assert tapps.APPLICATIONS["reactingFoam"] is tapps.reacting_foam
    assert tapps.APPLICATIONS["rhoReactingFoam"] is tapps.reacting_foam
    assert tapps.APPLICATIONS["XiFoam"] is tapps.xi_foam
    assert tapps.APPLICATIONS["PDRFoam"] is tapps.xi_foam
    # (and sonicDyMFoam, coldEngineFoam, engineFoam since the
    # topology-change slice, tests/test_torch_engine.py, and the twelve of
    # the Lagrangian slice, tests/test_torch_reactingcloud.py)
    assert len(tapps.APPLICATIONS) == 82


def reference_goldens15(root, names=None, perturb=0.0, port=False):
    """The golden scalars of chip_smoke.SLICE15_RUNS (the `combustion`
    phase's runs as shipped) from the JAX package on the CPU, in the
    precision the environment sets; `perturb` scales the start's T by
    1 + perturb u (u uniform in [0, 1) per cell, a numpy seed; chemFoam's
    initial T by 1 + perturb); `port` runs the port on the CPU instead (the
    card's summation orders differ from both). Under float64 the JAX
    package's chemFoam fixes float32 and raises (ROADMAP Queue 3): its
    reactor step is then run as the test_torch_chemistry.py float64 check
    runs it."""
    import contextlib
    import io
    import os
    import re

    import chip_smoke as cs
    from foamtpu.apps.cli import main as jcli
    from foamtpu.core.case import Case as JCase
    from foamtpu.core.case import run_case as jrun
    from foamtpu_torch.apps.cli import main as tcli
    from foamtpu_torch.core.case import Case as TCase

    from test_torch_simple import REPO

    x64 = os.environ.get("FOAMTPU_X64", "0") not in ("0", "")
    out = {}
    for name, (tut, opts, steps) in cs.SLICE15_RUNS.items():
        if names and name not in names:
            continue
        d = os.path.join(str(root), name)
        cli = tcli if port else jcli
        with contextlib.redirect_stdout(io.StringIO()):
            cs.slice15_case(REPO, d, tut, cli,
                            device=("-device", "cpu") if port else (),
                            **opts)
        if perturb and tut == "chemFoam":
            path = os.path.join(d, "constant", "initialConditions")
            text = open(path).read()
            T0 = float(re.search(r"\nT\s+(\S+);", text).group(1))
            open(path, "w").write(re.sub(
                r"\nT\s+\S+;", f"\nT {T0 * (1 + perturb)!r};", text))
        elif perturb:
            Tf = np.asarray(TCase(d, device="cpu").read_field("T").data,
                            np.float64)
            u = np.random.default_rng(21).random(Tf.shape[0])
            cs.set_internal(d, "T", Tf * (1.0 + perturb * u))
        with contextlib.redirect_stdout(io.StringIO()):
            if port:
                case = TCase(d, device="cpu")
                tapps.run(case, max_steps=steps)
                host = (lambda t: t.double().numpy()
                        if isinstance(t, torch.Tensor) else t)
            elif tut == "chemFoam" and x64:
                case = JCase(d)
                case.final_state = _chem_reactor_f64(d, steps or 100)
                host = np.asarray
            else:
                case = jrun(d, max_steps=steps)
                host = np.asarray
        out[name] = cs.slice15_scalars(name, case, case.final_state,
                                       host)[0]
    return out


def _chem_reactor_f64(d, steps=100):
    """chem_foam's reactor in the JAX package's ChemistryModel, float64:
    `steps` constant-volume steps of ChemistryModel.solve (rtol 1e-5) and
    the heat release, as the application takes them."""
    import jax
    import jax.numpy as jnp
    from foamtpu.core.dictionary import parse_file as jparse
    from foamtpu.models import chemistry as jchem
    from foamtpu.models.thermo import _janaf_from_mixture as jjanaf

    rx = jparse(d + "/constant/reactions")
    thd = jparse(d + "/constant/thermo.compressibleGas")
    ic = jparse(d + "/constant/initialConditions")
    hc, hW = jchem.from_foam_files(rx, thd)
    sp = list(hc.species)
    Y = np.array([float(ic["fractions"].get(s, 0.0)) for s in sp])
    Y = Y / Y.sum()
    R = 8314.47 * float((Y / hW).sum())
    p0, T0 = float(ic["p"]), float(ic["T"])
    rho = p0 / (R * T0)
    cp = sum(float(Y[i]) * float(jjanaf(thd[s]).Cp_of(jnp.asarray(T0)))
             for i, s in enumerate(sp) if s in thd and Y[i] > 0) \
        / Y[Y > 0].sum()
    cv = cp - R
    c = jnp.asarray((rho * Y / hW)[None, :])
    T = jnp.asarray([T0])
    dt = float(jparse(d + "/system/controlDict")["deltaT"])
    step = jax.jit(lambda c, T: (lambda cn: (cn, T + (-(cn - c) @ hc.hf)
                                             / (rho * cv)))(
        hc.solve(c, T, dt, rtol=1e-5)))
    for _ in range(steps):
        c, T = step(c, T)
    return {"T": float(T[0]), "Y": np.asarray(c[0]) * hW / rho,
            "species": sp, "p": float(rho * R * float(T[0]))}


def golden_spread15(f32, others):
    """SLICE15_SPREAD: per scalar the largest |f32 - other| over the other
    runs (float64, the perturbed start, the port on the CPU), to 3
    digits."""
    return {name: {k: float("%.3g" % max(abs(v - o[name][k])
                                         for o in others))
                   for k, v in sc.items()}
            for name, sc in f32.items()}


if __name__ == "__main__":
    # python tests/test_torch_reacting.py goldens [--perturb] [--port]
    # [name ...]: reference_goldens15's JSON (the environment sets float32
    # or float64); ... spread F32 OTHER...: SLICE15_SPREAD
    import json
    import sys
    import tempfile

    if sys.argv[1:2] == ["goldens"]:
        args = sys.argv[2:]
        names = [a for a in args if not a.startswith("--")]
        print(json.dumps(reference_goldens15(
            tempfile.mkdtemp(), names or None,
            perturb=1e-7 if "--perturb" in args else 0.0,
            port="--port" in args)))
    if sys.argv[1:2] == ["spread"]:
        f32, *others = (json.load(open(f)) for f in sys.argv[2:])
        print(json.dumps(golden_spread15(f32, others)))
