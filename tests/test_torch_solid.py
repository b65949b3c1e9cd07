"""foamtpu_torch's solidDisplacementFoam and solidEquilibriumDisplacementFoam
(solvers/soliddisplacement.py) against the JAX package's.

In float64 (one process, FOAMTPU_X64=1 JAX_ENABLE_X64=1) both packages'
`run(case)` take plateTension as shipped (chip_smoke.SLICE11_CASES: 40 x
20 cells, tractionDisplacement on the right and top, 10 corrections per
iteration): the equilibrium solver until it converges (its first D
solve's initial residual below the stressAnalysis D tolerance, 2
iterations) and the transient one for 3 steps: D at rtol 1e-9, every
solve's iteration count equal, the log lines and the written files
(tests/test_torch_ras_models.py's PARITY_BODY).

Then the uniaxial-tension oracle of tests/test_soliddisplacement.py
through the port on the CPU, the tractionDisplacement alias (a
fixedGradient kind whose gradient the solver rewrites), and the
thermalStress refusal, which the JAX package makes too.
"""

import os

import numpy as np
import pytest
import torch

from foamtpu_torch.apps.cli import main as tcli
from foamtpu_torch.bc import factory
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.core.dictionary import parse_string
from foamtpu_torch.solvers import apps as tapps

import chip_smoke
from test_torch_electromagnetics import assert_app_parity
from test_torch_ras_models import parity

torch.set_num_threads(2)

STEPS = 3
APPS = ("solidEquilibriumDisplacementFoam", "solidDisplacementFoam")


@pytest.fixture(scope="module")
def runs():
    return parity("slice11", STEPS, APPS)


@pytest.mark.parametrize("app", APPS)
def test_application_matches_reference_f64(runs, app):
    rec = runs[app]
    steady = app == "solidEquilibriumDisplacementFoam"
    # the equilibrium solver stops when the first D solve's initial
    # residual is below 1e-6, after 2 iterations in both packages
    assert_app_parity(rec, 2 if steady else STEPS, app)
    assert set(rec["errs"]) == {"D"}
    names = [n for n, _ in rec["solves"][0]]
    assert names.count("Dxx") == (2 if steady else STEPS)
    converged = [x for x in rec["other_lines"][0] if x.startswith(
        "Converged in")]
    assert converged == (["Converged in # iterations"] if steady else [])


def test_tension_oracle_holds_on_the_cpu(tmp_path):
    rec, checks = chip_smoke.SLICE11_ORACLES[
        "solidEquilibriumDisplacementFoam"](str(tmp_path), tcli, "cpu")
    assert all(checks.values()), (checks, rec)


def test_traction_displacement_is_fixed_gradient(tmp_path):
    """The reference maps tractionDisplacement to fixedGradient (its
    bc/factory.py); the solver's traction list holds (traction,
    pressure)/rho of those patches, in the field's precision."""
    from foamtpu.bc import factory as jfactory
    from foamtpu.core.dictionary import parse_string as jparse

    d = chip_smoke.slice11_case(chip_smoke.REPO_DIR,
                                os.path.join(str(tmp_path), "plate"),
                                "solidEquilibriumDisplacementFoam", tcli)
    case = TCase(d, device="cpu")
    D = case.read_field("D")
    kinds = {p.name: bc.kind for p, bc in zip(case.mesh.patches, D.bcs)}
    assert kinds["right"] == kinds["up"] == "fixedGradient"
    text = ("type tractionDisplacement; traction uniform (1e6 0 0); "
            "pressure uniform 0; value uniform (0 0 0);")
    p = case.mesh.patch("right")
    got = factory.from_dict(parse_string(text), p, 1, torch.float32)
    ref = jfactory.from_dict(jparse(text), p, 1, np.float32)
    assert got.kind == ref.kind == "fixedGradient"
    assert float(got.vfrac) == float(ref.vfrac) == 0.0
    tr = tapps._traction(case, case.mesh, 7854.0)
    names = [p.name for p in case.mesh.patches]
    right = names.index("right")
    np.testing.assert_allclose(
        tr[right][0], np.broadcast_to([1e6 / 7854.0, 0.0, 0.0],
                                      (case.mesh.patches[right].size, 3)))
    assert tr[names.index("left")] is None


def test_thermal_stress_is_refused(tmp_path):
    d = chip_smoke.slice11_case(chip_smoke.REPO_DIR,
                                os.path.join(str(tmp_path), "plate"),
                                "solidEquilibriumDisplacementFoam", tcli)
    path = os.path.join(d, "constant", "thermalProperties")
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text.replace("thermalStress   no;", "thermalStress   yes;"))
    case = TCase(d, device="cpu")
    with pytest.raises(NotImplementedError, match="thermalStress"):
        tapps.run(case, max_steps=1)
    assert not hasattr(case, "final_state")


def test_applications_are_registered():
    assert tapps.APPLICATIONS["solidDisplacementFoam"] is \
        tapps.solid_displacement_foam
    assert tapps.APPLICATIONS["solidEquilibriumDisplacementFoam"] is \
        tapps.solid_equilibrium_displacement_foam
