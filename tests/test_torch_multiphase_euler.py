"""foamtpu_torch's Euler-Euler members of the multiphase family against the
JAX package: twoPhaseEulerFoam and bubbleFoam (solvers/twophaseeuler.py)
and multiphaseEulerFoam (solvers/multiphaseeuler.py), with their drivers.

In float64 (one process, FOAMTPU_X64=1 JAX_ENABLE_X64=1) both packages'
`run(case)` take 3 steps of bubbleColumn and threePhaseColumn as shipped
(chip_smoke.SLICE13_CASES: both steps weigh U upwind and advect alpha by
MULES on linear and upwind fluxes, so a uniform start is well posed):
fields at rtol 1e-9 (Ua, Ub, phia, phib; multiphaseEulerFoam's U{i},
U0_{i} and [nF, nP] phis), every solve's iteration count equal, the log
lines and the written files (tests/test_torch_ras_models.py's
PARITY_BODY). bubbleFoam is twoPhaseEulerFoam under another name, as the
reference registers it: the port's two runs of bubbleColumn agree bit for
bit.

Then, in this process (float32): threePhaseColumn's fraction field
(N = 3, the layout whose phases list carries its subdicts by name)
against the reference's construction. The tutorials' runs at the card's
depth, to the reference tests' oracles (the rising bubble band of
tests/test_tutorial_cases.py) and the goldens, are chip_smoke.py's
`multiphase` phase: their parity above starts from the shipped fields.
"""

import numpy as np
import pytest
import torch

from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.solvers import apps as tapps

import chip_smoke
from test_torch_electromagnetics import assert_app_parity
from test_torch_multiphase_vof import run_tutorial
from test_torch_ras_models import parity
from test_torch_simple import REPO

torch.set_num_threads(2)

STEPS = 3
CASES = ("twoPhaseEulerFoam", "multiphaseEulerFoam")


@pytest.fixture(scope="module")
def runs():
    return parity("slice13", STEPS, CASES)


def test_two_phase_euler_matches_reference_f64(runs):
    rec = runs["twoPhaseEulerFoam"]
    assert_app_parity(rec, STEPS, "twoPhaseEulerFoam")
    assert {"Ua", "Ub", "p", "alpha", "phia", "phib", "Ua0",
            "Ub0"} == set(rec["errs"])
    names = [n for n, _ in rec["solves"][0]]
    # Ua and Ub (each logged by component) and one p solve per step
    assert names.count("p") == STEPS


def test_multiphase_euler_matches_reference_f64(runs):
    rec = runs["multiphaseEulerFoam"]
    assert_app_parity(rec, STEPS, "multiphaseEulerFoam")
    assert {"p", "alphas", "phis", "U0", "U1", "U2", "U0_0", "U0_1",
            "U0_2"} == set(rec["errs"])


def test_bubblefoam_is_two_phase_euler(tmp_path):
    """bubbleFoam's bubbleColumn through the port equals
    twoPhaseEulerFoam's, field for field."""
    assert tapps.APPLICATIONS["bubbleFoam"] is tapps.two_phase_euler_foam
    _, a, _ = run_tutorial(tmp_path / "a", "bubbleFoam")
    _, b, _ = run_tutorial(tmp_path / "b", "twoPhaseEulerFoam",
                           steps=chip_smoke.SLICE13_RUNS["bubbleFoam"][2])
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_three_phase_column_fractions_match_reference(tmp_path):
    """threePhaseColumn's phases (names, rho, nu, d) and its [n, 3]
    fraction field with the first phase's scalar BCs, as the reference's
    multiphase_euler_foam builds them."""
    import contextlib
    import io

    import jax.numpy as jnp
    from foamtpu.core.case import Case as JCase

    from foamtpu_torch.apps.cli import main as tcli

    with contextlib.redirect_stderr(io.StringIO()):
        d = chip_smoke.slice13_case(REPO, str(tmp_path / "col"),
                                    "multiphaseEulerFoam", tcli,
                                    device=("-device", "cpu"))
    tc, jc = TCase(d, device="cpu"), JCase(d)
    names, rhos, nus, ds = tapps.multiphase_euler_phases(
        tc.transport_properties())
    assert names == ["air", "oil", "water"]
    assert rhos == [1.2, 900.0, 1000.0] and nus == [1.5e-5, 1e-5, 1e-6]
    assert ds == [3e-3, 1e-3, 1e-3]
    alphas, _ = tapps.phase_fractions(tc, names)
    jf = [jc.read_field(f"alpha{n}") for n in names]
    A = jnp.stack([f.data for f in jf], axis=1)
    np.testing.assert_array_equal(alphas.data.numpy(), np.asarray(A))
    assert [b.kind for b in alphas.bcs] == [b.kind for b in jf[0].bcs]
    for i in range(3):
        got = alphas.with_data(alphas.data[:, i]).boundary_values(tc.mesh)
        ref = jf[0].with_data(A[:, i]).boundary_values(jc.mesh)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
