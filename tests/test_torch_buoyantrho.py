"""foamtpu_torch's buoyantSimpleFoam and buoyantPimpleFoam against the JAX
package's (solvers/buoyantrho.py and the applications of solvers/apps.py).

In float64 (one process, FOAMTPU_X64=1 JAX_ENABLE_X64=1) both packages'
`run(case)` take 3 SIMPLE iterations of buoyantCavity and 3 PIMPLE steps
of hotCavity (40x40, compressible::kEpsilon with the mutk, alphat,
epsilon and kqR wall functions, p_rgh shifted by pRefValue), from a
seeded U and T (chip_smoke.SLICE10_CASES: from the shipped U = 0 every
face flux is round-off and the upwind weights take its sign): U, p_rgh,
T, phi, k, epsilon, mut and alphat at rtol 1e-9, every solve's iteration
count equal, the log lines and the written fields
(tests/test_torch_ras_models.py's PARITY_BODY).

Then radiation, ported since the combustion slice
(tests/test_torch_radiation.py holds it to the reference): a case whose
constant/radiationProperties switches P1 or fvDOM on runs with G in its
state, and a step whose state has no G runs without radiation, as the
reference's; one with radiation off, or no model, runs.
"""

import contextlib
import io
import os

import pytest
import torch

from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.solvers import apps as tapps
from foamtpu_torch.solvers import buoyantrho

import chip_smoke
from test_torch_ras_models import assert_parity, parity
from test_torch_simple import REPO

STEPS = 3
APPS = ("buoyantSimpleFoam", "buoyantPimpleFoam")


@pytest.fixture(scope="module")
def runs():
    return parity("slice10", STEPS, APPS)


@pytest.mark.parametrize("app", APPS)
def test_application_matches_reference_f64(runs, app):
    rec = runs[app]
    assert_parity(rec, STEPS, app, files_scaled=True)
    assert {"U", "p_rgh", "T", "phi", "k", "epsilon", "mut",
            "alphat"} == set(rec["errs"])
    names = [n for n, _ in rec["solves"][0]]
    # the first p_rgh solve of each step logs as "p", as in the reference
    assert names.count("p") == names.count("T") == STEPS


def test_applications_are_registered():
    assert tapps.APPLICATIONS["buoyantSimpleFoam"] is tapps.buoyant_simplefoam
    assert tapps.APPLICATIONS["buoyantPimpleFoam"] is tapps.buoyant_pimplefoam


RADIATION = """FoamFile {{ version 2.0; format ascii; class dictionary;
           object radiationProperties; }}
radiation {on};
radiationModel {model};
constantAbsorptionEmissionCoeffs {{ absorptivity 0.5; emissivity 0.5; }}
"""


def _cavity(tmp_path, on, model):
    from foamtpu_torch.apps.cli import main as tcli

    d = chip_smoke.compressible_case(REPO, str(tmp_path / f"{on}_{model}"),
                                     "buoyantSimpleFoam", tcli)
    with open(os.path.join(d, "constant", "radiationProperties"), "w") as f:
        f.write(RADIATION.format(on=on, model=model))
    return d


@pytest.mark.parametrize("model", ["P1", "fvDOM"])
def test_radiation_is_refused(tmp_path, model):
    """No longer refused: the case runs with its radiation model."""
    case = TCase(_cavity(tmp_path, "on", model), device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        tapps.run(case, max_steps=1)
    assert case.time.index == 1
    G = case.final_state["G"].data
    assert bool(torch.isfinite(G).all()) and float(G.max()) > 0.0
    # a radiation config without a G in the state solves no G
    cfg = buoyantrho.BuoyantRhoConfig(
        thermo=tapps._thermo(case), steady=True,
        radiation=tapps._load_radiation(case))
    st = buoyantrho.initial_state(case.mesh, case.read_field("U"),
                                  case.read_field("p_rgh"),
                                  case.read_field("T"), cfg.thermo,
                                  steady=True)
    _, diag = buoyantrho.buoyantrho_step(case.mesh, st, 1.0, cfg)
    assert "G" not in diag


@pytest.mark.parametrize("on,model", [("off", "P1"), ("on", "none")])
def test_radiation_off_runs(tmp_path, on, model):
    case = TCase(_cavity(tmp_path, on, model), device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        tapps.run(case, max_steps=1)
    assert case.time.index == 1
