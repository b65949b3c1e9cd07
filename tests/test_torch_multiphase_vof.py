"""foamtpu_torch's VOF members of the multiphase family against the JAX
package: twoLiquidMixingFoam, interMixingFoam, interPhaseChangeFoam,
multiphaseInterFoam (N = 3 and 4), MRFMultiphaseInterFoam and
compressibleInterFoam (solvers/{twoliquidmixing,intermixing,
interphasechange,multiphaseinter,compressibleinter}.py and their drivers).

In float64 (one process, FOAMTPU_X64=1 JAX_ENABLE_X64=1) both packages'
`run(case)` take 3 steps of each tutorial from a seeded start
(chip_smoke.SLICE13_CASES: a vanLeer limiter on a uniform field follows
the sign of round-off; damBreak3phase ships alpha2 = 0, so the seed
splits the liquid between phases 2 and 3 and the D23 exchange acts;
cavitatingBox's p_rgh is seeded about pSat, so both condensation and
vaporisation act, and its p_rgh solve converged: stopped at relTol 0.05
it turns 1e-14 of round-off into 1.7e-8 of the field within three
steps). damBreak4phase carries three phases here: the N = 4 case adds
mercury, and the MRF case is the N = 3 tutorial under
MRFMultiphaseInterFoam with MRFInterFoam's rotor. Fields at rtol 1e-9,
every solve's iteration count equal, the log lines and the written files
(tests/test_torch_ras_models.py's PARITY_BODY). The three phase-change
models (SchnerrSauer, Kunz, Merkle) are held on seeded fractions and
pressures straddling pSat in the same process.

Then, in this process (float32): the N-phase fraction field's boundary
values at N = 3 and N = 4 against the reference's construction, the
tutorials as shipped through the port held to the reference tests'
oracles and to the card's goldens (chip_smoke.SLICE13_GOLDEN), and the
alpha controls mixingColumn's fvSolution gives.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from foamtpu_torch.apps.cli import main as tcli
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.solvers import apps as tapps

import chip_smoke
from test_torch_electromagnetics import assert_app_parity
from test_torch_ras_models import parity
from test_torch_simple import REPO

torch.set_num_threads(2)

STEPS = 3
CASES = ("twoLiquidMixingFoam", "interMixingFoam", "interPhaseChangeFoam",
         "multiphaseInterFoam_4", "MRFMultiphaseInterFoam",
         "compressibleInterFoam")
MODELS = ("SchnerrSauer", "Kunz", "Merkle")
LOG_NO_SOLVES = ("interMixingFoam", "interPhaseChangeFoam")

# the phase-change models of both packages on seeded liquid fractions and
# absolute pressures straddling pSat (float64): the largest difference of
# each rate coefficient over its largest value
MODELS_TAIL = r"""
from foamtpu.solvers import interfoam as jif, interphasechange as jipc
from foamtpu_torch import convert
from foamtpu_torch.solvers import interfoam as tif, interphasechange as tipc
import jax.numpy as jnp
rng = np.random.default_rng(5)
a = rng.random(400)
p = 2300.0 + 4000.0 * (rng.random(400) - 0.5)
flow = dict(rho1=1000.0, rho2=0.02, nu1=9e-7, nu2=4.3e-4, sigma=0.07)
errs = {}
for model in ("SchnerrSauer", "Kunz", "Merkle"):
    jc = jipc.PhaseChangeConfig(flow=jif.InterConfig(**flow), model=model)
    tc = convert.config_from_reference(tipc.PhaseChangeConfig, jc)
    r = jipc._MODELS[model](jc, jnp.asarray(a), jnp.asarray(p))
    g = tipc._MODELS[model](tc, torch.tensor(a), torch.tensor(p))
    errs[model] = [float(np.abs(x.numpy() - np.asarray(y)).max()
                         / np.abs(np.asarray(y)).max()) for x, y in zip(g, r)]
print(json.dumps(errs))
"""


@pytest.fixture(scope="module")
def runs():
    recs = parity("slice13", STEPS, CASES, tail=MODELS_TAIL, lines=2)
    return recs[0], recs[1]


@pytest.mark.parametrize("name", CASES)
def test_application_matches_reference_f64(runs, name):
    recs, _ = runs
    rec = recs[name]
    # a converged solve's final residual is round-off: held below its
    # tolerance in both packages. interMixingFoam and interPhaseChangeFoam
    # log no solve, as the reference's
    assert_app_parity(rec, STEPS, name, tight={"p_rgh": 1e-12},
                      logs_solves=name not in LOG_NO_SOLVES)
    fields = set(rec["errs"])
    assert {"U", "p_rgh", "phi", "rho", "U0"} <= fields, fields
    if name.startswith(("multiphaseInter", "MRF")):
        assert "alphas" in fields
    elif name == "interMixingFoam":
        assert {"alpha1", "alpha2"} <= fields
    elif name == "compressibleInterFoam":
        assert {"T", "T0", "p_abs", "dgdt", "alpha"} <= fields
    else:
        assert "alpha" in fields
    names = [n for n, _ in rec["solves"][0]]
    if name not in LOG_NO_SOLVES:
        # the first p solve of each step is logged (the implicit alpha
        # solve of twoLiquidMixingFoam is not, in either package)
        assert names.count("p") == STEPS, names


@pytest.mark.parametrize("model", MODELS)
def test_phase_change_models_match_reference_f64(runs, model):
    _, errs = runs
    assert max(errs[model]) <= 1e-12, errs


def _phase_case(tmp_path, four):
    d = chip_smoke.slice13_case(
        REPO, str(tmp_path / f"dam{4 if four else 3}"), "multiphaseInterFoam",
        tcli, device=("-device", "cpu"), four_phases=four)
    return d, [str(x) for x in TCase(d, device="cpu").transport_properties()
               .get("phases")]


@pytest.mark.parametrize("four", [False, True], ids=["N3", "N4"])
def test_phase_fractions_boundary_values_match_reference(tmp_path, four):
    """The [n, N] fraction field carries the first phase's scalar BCs in
    both packages (the reference stacks 0/alpha<name> in its driver); each
    phase's boundary values through those BCs, and the field itself,
    equal the reference's, at N = 3 (where the field looks like a vector
    to code that keys on three columns) and N = 4."""
    import jax.numpy as jnp
    from foamtpu.core.case import Case as JCase
    from foamtpu.core.fields import VolField as JVolField

    d, names = _phase_case(tmp_path, four)
    assert len(names) == (4 if four else 3)
    tc, jc = TCase(d, device="cpu"), JCase(d)
    alphas, flds = tapps.phase_fractions(tc, names)
    jflds = [jc.read_field(f"alpha{n}") for n in names]
    jal = JVolField(data=jnp.stack([f.data for f in jflds], axis=1),
                    bcs=jflds[0].bcs, name="alphas")
    assert tuple(alphas.data.shape) == (tc.mesh.n_cells, len(names))
    np.testing.assert_array_equal(alphas.data.numpy(), np.asarray(jal.data))
    assert [b.kind for b in alphas.bcs] == [b.kind for b in jal.bcs]
    for tb, jb in zip(alphas.bcs, jal.bcs):
        np.testing.assert_array_equal(tb.ref_value.numpy(),
                                      np.asarray(jb.ref_value))
    for i in range(len(names)):
        got = alphas.with_data(alphas.data[:, i]).boundary_values(tc.mesh)
        ref = jal.with_data(jal.data[:, i]).boundary_values(jc.mesh)
        assert got.ndim == 1
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the written fractions keep each phase's own BCs and name
    cols = tapps._alpha_columns(flds, names, alphas.data)
    assert [c.name for c in cols] == [f"alpha{n}" for n in names]
    assert all(c.bcs is f.bcs for c, f in zip(cols, flds))


def run_tutorial(tmp_path, name, steps=None):
    """chip_smoke.SLICE13_RUNS[name] through the port on the CPU (float32),
    for its steps or `steps`: the start fractions, the final arrays, the
    case."""
    app, opts, n = chip_smoke.SLICE13_RUNS[name]
    steps = n if steps is None else steps
    with contextlib.redirect_stderr(io.StringIO()):
        d = chip_smoke.slice13_case(REPO, str(tmp_path / name), app, tcli,
                                    device=("-device", "cpu"), **opts)
    case = TCase(d, device="cpu")
    a0 = chip_smoke.slice13_start_arrays(name, case)
    with contextlib.redirect_stdout(io.StringIO()):
        tapps.run(case, max_steps=steps)
    assert case.time.index == steps
    a = chip_smoke.slice13_arrays(name, case.final_state,
                                  lambda t: t.double().numpy())
    return a0, a, case


def assert_oracles_and_goldens(tmp_path, name):
    a0, a, case = run_tutorial(tmp_path, name)
    v = case.mesh.v.double().numpy()
    checks = chip_smoke.slice13_oracles(name, a0, a, v,
                                        case.mesh.c.double().numpy())
    assert checks and all(checks.values()), checks
    got = chip_smoke.small_scalars(a, v)
    errs = chip_smoke.slice13_golden_errs(name, got, a)
    assert errs
    bad = {k: e for k, e in errs.items() if not e[0] <= e[1]}
    assert not bad, (name, bad)


@pytest.mark.parametrize("name", ["twoLiquidMixingFoam", "interMixingFoam",
                                  "interPhaseChangeFoam",
                                  "multiphaseInterFoam",
                                  "compressibleInterFoam"])
def test_tutorial_meets_oracles_and_card_goldens(tmp_path, name):
    """The tutorial as shipped (its parity above starts seeded) through
    run(case) at the card's depth (float32): the reference tests' oracles
    (chip_smoke.slice13_oracles) and the goldens the card is held to.
    MRFMultiphaseInterFoam's run is the card's (chip_smoke.py's
    `multiphase` phase)."""
    assert_oracles_and_goldens(tmp_path, name)


def test_mixingcolumn_alpha_controls_as_the_reference(tmp_path):
    """mixingColumn's fvSolution has a "(U|alpha1)" key and none for
    "alpha": both packages find none, so the alpha solve takes the step's
    default PBiCGStab (tolerance 1e-8), and U the smoothSolver."""
    from foamtpu.core.case import Case as JCase
    from foamtpu.solvers.apps import _has_solver as jhas

    d = chip_smoke.slice13_case(REPO, str(tmp_path / "mix"),
                                "twoLiquidMixingFoam", None)
    tc, jc = TCase(d, device="cpu"), JCase(d)
    assert not tapps._has_solver(tc, "alpha") and not jhas(jc, "alpha")
    assert tapps._has_solver(tc, "alpha1") and jhas(jc, "alpha1")
    assert tc.solver_controls("U")["solver"] == "smoothSolver"


# -- the goldens of chip_smoke.py's multiphase phase ---------------------------


def reference_multiphase(names=None, perturb=0.0):
    """The golden scalars (chip_smoke.small_scalars of slice13_arrays) of
    chip_smoke.SLICE13_RUNS from the JAX package's applications on the
    CPU at the runs' depths (blockMesh and setFields through its CLI), in
    the precision the environment gives it (float32; FOAMTPU_X64=1
    JAX_ENABLE_X64=1 for float64). `perturb` multiplies every start field
    cell by cell by 1 + perturb u, u from a numpy seed: a float32 run with
    perturb 1e-7 gives the runs' sensitivity to round-off."""
    import tempfile

    from foamtpu.apps.cli import main as jcli
    from foamtpu.core.case import Case as JCase
    from foamtpu.core.case import run_case as jrun

    out = {}
    root = tempfile.mkdtemp()
    for name, (app, opts, steps) in chip_smoke.SLICE13_RUNS.items():
        if names is not None and name not in names:
            continue
        with contextlib.redirect_stdout(io.StringIO()):
            d = chip_smoke.slice13_case(REPO, os.path.join(root, name), app,
                                        jcli, **opts)
        if perturb:
            jc = JCase(d)
            rng = np.random.default_rng(21)
            for f in sorted(os.listdir(os.path.join(d, "0"))):
                x = np.asarray(jc.read_field(f).data, np.float64)
                u = rng.random(x.shape[0])
                chip_smoke.set_internal(d, f, x * (1.0 + perturb * (
                    u if x.ndim == 1 else u[:, None])))
        with contextlib.redirect_stdout(io.StringIO()):
            jc = jrun(d, max_steps=steps)
        a = chip_smoke.slice13_arrays(name, jc.final_state, np.asarray)
        out[name] = chip_smoke.small_scalars(a, np.asarray(jc.mesh.v,
                                                           np.float64))
    return out


if __name__ == "__main__":
    # python tests/test_torch_multiphase_vof.py goldens [--perturb]
    # [name ...]: the JSON of reference_multiphase (the environment sets
    # float32 or float64; --perturb perturbs the start by 1e-7)
    import json
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "goldens":
        args = sys.argv[2:]
        eps = 1e-7 if "--perturb" in args else 0.0
        names = [a for a in args if a != "--perturb"] or None
        print(json.dumps(reference_multiphase(names, perturb=eps)))
