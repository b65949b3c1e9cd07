"""foamtpu_torch's electrostaticFoam, magneticFoam, mhdFoam (solvers/mhd.py)
and financialFoam against the JAX package's.

In float64 (one process, FOAMTPU_X64=1 JAX_ENABLE_X64=1) both packages'
`run(case)` take 3 steps of chargedPlate, hartmann and europeanCall and
barMagnet's one solve, each tutorial as shipped
(chip_smoke.SLICE11_CASES) except hartmann's p and pB controls: its
polynomial PCG stopped at relTol 0.01 turns the two packages' round-off
(1e-14 of the p source, their summation orders) into 3e-6 of p within a
step, so the parity case converges every p and pB solve to 1e-11
(chip_smoke.TIGHT_CONTROLS). Fields at rtol 1e-9, the log lines, the
written files (tests/test_torch_ras_models.py's PARITY_BODY), and every
solve's iteration count equal; at 1e-11 the count of a hartmann p solve
is itself decided by round-off (149 or 150 in the JAX package alone when
B is perturbed by 1e-15), so each p count is held to the JAX package's
own spread under such perturbations, measured in the same process.

Then the reference tests' oracles through the port on the CPU
(chip_smoke.SLICE11_ORACLES: the capacitor's Poisson parabola, the bar
magnet's field, the Hartmann profile at Ha = 20, Black-Scholes), the
registration, and the magnets' box selection.
"""

import os

import numpy as np
import pytest
import torch

from foamtpu_torch.apps.cli import main as tcli
from foamtpu_torch.solvers import apps as tapps

import chip_smoke
from test_torch_ras_models import parity
from test_torch_simple import REPO

torch.set_num_threads(2)

STEPS = 3
APPS = ("electrostaticFoam", "magneticFoam", "mhdFoam", "financialFoam")

# the JAX package's own iteration counts on the hartmann case with B
# perturbed by +-1e-15 (relative, seeded): the largest difference of each
# logged solve from the unperturbed run's, per field
SPREAD_TAIL = r"""
from foamtpu.core.case import Case as JCase
base = out["mhdFoam"]["solves"][1]
spread = {}
for k, eps in enumerate((1e-15, -1e-15)):
    d = make(f"perturbed{k}", "mhdFoam", jcli)
    b = np.asarray(JCase(d).read_field("B").data, dtype=float)
    cs.set_internal(d, "B", b * (1.0 + eps * np.random.default_rng(k)
                                 .standard_normal(b.shape)))
    with contextlib.redirect_stdout(io.StringIO()) as lg:
        jrun(d, max_steps=steps)
    solves, _ = log_parts(lg.getvalue())
    assert [s[0] for s in solves] == [n for n, _ in base]
    for (n, i), s in zip(base, solves):
        spread[n] = max(spread.get(n, 0), abs(i - s[3]))
print(json.dumps(spread))
"""


def assert_app_parity(rec, steps, what, spread=None, tight=None,
                      logs_solves=True):
    """What a run(case) parity record of these applications must show:
    `steps` steps in both packages at the same time, the same fields at
    rtol 1e-9, the same solves with equal iteration counts (or within
    `spread[name]`, the JAX package's own spread under round-off) and
    initial residuals at rtol 1e-6; final residuals at rtol 1e-6 (atol
    1e-12), or, for the solves named in `tight` ({name prefix: its
    tolerance}: where the final residual is round-off of a converged
    solve), both below that tolerance; the other log lines, and the
    written files at 1e-9 of each file's largest number. An application
    that logs no solve (`logs_solves` False) must log none in either."""
    spread = spread or {}
    tight = tight or {}
    assert rec["time"][0] == rec["time"][1] == steps, (what, rec["time"])
    assert rec["time"][2] == rec["time"][3], (what, rec["time"])
    assert rec["fields"][0] == rec["fields"][1], (what, rec["fields"])
    for name, e in rec["errs"].items():
        assert e["ok"], (what, name, e)
    got, ref = rec["solves"]
    assert [n for n, _ in got] == [n for n, _ in ref], what
    assert (len(got) >= max(steps, 1)) if logs_solves else not got, (
        what, got)
    for (n, a), (_, b), ra, rb in zip(got, ref, *rec["residuals"]):
        assert abs(a - b) <= spread.get(n, 0), (what, n, a, b)
        assert np.isclose(ra[0], rb[0], rtol=1e-6, atol=1e-12), (what, n)
        tol = next((t for k, t in tight.items() if n.startswith(k)), None)
        if tol is not None:
            assert ra[1] <= tol and rb[1] <= tol, (what, n, ra, rb)
        elif a == b:
            assert np.isclose(ra[1], rb[1], rtol=1e-6, atol=1e-12), (
                what, n, ra, rb)
    assert rec["other_lines"][0] == rec["other_lines"][1], what
    assert rec["other_numbers_ok"], what
    assert rec["files"], what
    for sub, f in rec["files"].items():
        assert f["names"][0] == f["names"][1], (what, sub, f["names"])
        bad = [n for n, e in f["scaled"].items() if not e <= 1e-9]
        assert not bad, (what, sub, bad)


@pytest.fixture(scope="module")
def runs():
    recs = parity("slice11", STEPS, APPS, tail=SPREAD_TAIL, lines=2)
    return recs[0], recs[1]


@pytest.mark.parametrize("app", APPS)
def test_application_matches_reference_f64(runs, app):
    recs, spread = runs
    rec = recs[app]
    if app == "magneticFoam":
        # one psi solve (no time loop), psi written at the start time
        assert_app_parity(rec, 0, app)
        assert {"psi", "H", "B"} == set(rec["errs"])
    elif app == "mhdFoam":
        # every solve converges: p to 1e-11, U and B to the shipped 1e-8
        assert_app_parity(rec, STEPS, app, spread=spread,
                          tight={"p": 1e-11, "U": 1e-8, "B": 1e-8})
        assert {"U", "p", "B", "pB", "phi", "phiB"} == set(rec["errs"])
        names = [n for n, _ in rec["solves"][0]]
        assert names.count("p") == names.count("Bxx") == STEPS
    else:
        assert_app_parity(rec, STEPS, app)
        assert set(rec["errs"]) == {"electrostaticFoam": {"phi", "rho"},
                                    "financialFoam": {"V"}}[app]


def test_hartmann_count_spread_is_round_off(runs):
    """The JAX package's own p counts move under a 1e-15 perturbation of
    B (that is what the spread measures), by at most a few iterations;
    every other solve's count is held exactly."""
    _, spread = runs
    assert set(k for k, v in spread.items() if v) <= {"p"}, spread
    assert spread.get("p", 0) <= 3, spread


@pytest.mark.parametrize("app", APPS)
def test_reference_oracles_hold_on_the_cpu(tmp_path, app):
    rec, checks = chip_smoke.SLICE11_ORACLES[app](str(tmp_path), tcli, "cpu")
    assert all(checks.values()), (checks, rec)


def test_applications_are_registered():
    assert tapps.APPLICATIONS["electrostaticFoam"] is tapps.electrostatic_foam
    assert tapps.APPLICATIONS["magneticFoam"] is tapps.magnetic_foam
    assert tapps.APPLICATIONS["mhdFoam"] is tapps.mhd_foam
    assert tapps.APPLICATIONS["financialFoam"] is tapps.financial_foam
    # 46 after this slice; windSimpleFoam, chtMultiRegionFoam and
    # chtMultiRegionSimpleFoam since the snappyHexMesh and cht slice, the
    # twelve of the multiphase family since the multiphase slice, the six
    # of the combustion family since the combustion slice, sonicDyMFoam,
    # coldEngineFoam and engineFoam since the topology-change slice
    # (tests/test_torch_engine.py), the Lagrangian family's nine and the
    # discrete methods' three since the Lagrangian slice
    assert len(tapps.APPLICATIONS) == 82


def test_magnets_are_selected_by_box(tmp_path):
    """barMagnet's magnet1 box holds the cells whose centres lie inside it,
    mur and the remanence along its orientation, as the JAX package's
    magnetic_foam selects them."""
    from foamtpu_torch.core.case import Case

    d = chip_smoke.slice11_case(chip_smoke.REPO_DIR,
                                os.path.join(str(tmp_path), "magnet"),
                                "magneticFoam", tcli)
    case = Case(d, device="cpu")
    mur, M = tapps._magnets(case, case.mesh)
    c = case.mesh.c.double().numpy()
    inside = np.all((c >= [0.4, 0.4, 0.0]) & (c <= [0.6, 0.6, 0.1]), axis=1)
    assert inside.sum() == 16
    np.testing.assert_array_equal(mur.numpy(), np.where(inside, 100.0, 1.0))
    np.testing.assert_allclose(M.numpy()[inside], [[79577.5, 0.0, 0.0]] * 16)
    assert float(torch.abs(M[~torch.tensor(inside)]).max()) == 0.0


# -- the goldens of chip_smoke.py's solvers_small phase -------------------------


def reference_small(names=None, perturb=0.0):
    """The golden scalars (chip_smoke.small_scalars) of chip_smoke.SMALL_RUNS
    from the JAX package's applications on the CPU at the runs' depths
    (blockMesh and the Allrun's other commands through its CLI), in the
    precision the environment gives it (float32; FOAMTPU_X64=1
    JAX_ENABLE_X64=1 for float64). `perturb` multiplies each start field
    of SMALL_FIELDS cell by cell by 1 + perturb u, u from a numpy seed: a
    float32 run with perturb 1e-7 gives the runs' sensitivity to
    round-off."""
    import contextlib
    import io
    import tempfile

    from foamtpu.apps.cli import main as jcli
    from foamtpu.core.case import run_case as jrun

    out = {}
    root = tempfile.mkdtemp()
    for name, (tut, opts, steps) in chip_smoke.SMALL_RUNS.items():
        if names is not None and name not in names:
            continue
        with contextlib.redirect_stdout(io.StringIO()):
            d = chip_smoke.slice11_case(REPO, os.path.join(root, name), tut,
                                        jcli, **opts)
        if perturb:
            from foamtpu.core.case import Case as JCase

            jc = JCase(d)
            rng = np.random.default_rng(21)
            for f in chip_smoke.SMALL_FIELDS[name]:
                if not os.path.exists(os.path.join(d, "0", f)):
                    continue
                x = np.asarray(jc.read_field(f).data, np.float64)
                u = rng.random(x.shape[0])
                chip_smoke.set_internal(d, f, x * (1.0 + perturb * (
                    u if x.ndim == 1 else u[:, None])))
        with contextlib.redirect_stdout(io.StringIO()):
            jc = jrun(d, max_steps=steps)
        a = chip_smoke.small_arrays(name, jc.final_state, np.asarray)
        out[name] = chip_smoke.small_scalars(a, np.asarray(jc.mesh.v,
                                                           np.float64))
    return out


@pytest.mark.parametrize("name", ["electrostaticFoam", "financialFoam",
                                  "solidEquilibriumDisplacementFoam"])
def test_port_on_the_cpu_meets_the_card_goldens(tmp_path, name):
    """Three of the solvers_small runs through the port on the CPU
    (float32) against chip_smoke.SMALL_GOLDEN at the tolerance the card
    is held to."""
    import contextlib
    import io

    from foamtpu_torch.core.case import Case as TCase

    tut, opts, steps = chip_smoke.SMALL_RUNS[name]
    d = chip_smoke.slice11_case(REPO, str(tmp_path / name), tut, tcli,
                                device=("-device", "cpu"), **opts)
    case = TCase(d, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        tapps.run(case, max_steps=steps)
    a = chip_smoke.small_arrays(name, case.final_state,
                                lambda t: t.double().numpy())
    got = chip_smoke.small_scalars(a, case.mesh.v.double().numpy())
    errs = chip_smoke.small_golden_errs(got, chip_smoke.SMALL_GOLDEN[name],
                                        chip_smoke.SMALL_SPREAD[name],
                                        chip_smoke.field_scales(a))
    for k, (err, tol) in errs.items():
        assert err <= tol, (name, k, err, tol, got[k])


if __name__ == "__main__":
    # python tests/test_torch_electromagnetics.py goldens [--perturb]
    # [name ...]: the JSON of reference_small (the environment sets
    # float32 or float64; --perturb perturbs the start by 1e-7)
    import json
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "goldens":
        args = sys.argv[2:]
        eps = 1e-7 if "--perturb" in args else 0.0
        names = [a for a in args if a != "--perturb"] or None
        print(json.dumps(reference_small(names, perturb=eps)))
