"""foamtpu_torch's adjointShapeOptimizationFoam (solvers/adjoint.py, and the
porosity sink it adds to solvers/simple.py) against the JAX package's.

In float64 (one process, FOAMTPU_X64=1 JAX_ENABLE_X64=1) both packages'
`run(case)` take 3 optimisation sweeps of the tutorial's pitzDaily,
coarsened 2x per direction (3,056 cells) from a seeded U
(chip_smoke.SLICE11_CASES), with the adjoint fields of
tests/test_adjoint.py (chip_smoke.ADJOINT_FIELDS: the tutorial ships no
Ua and pa, and from the default zero fields the adjoint stays zero in
both packages) and every sweep written: U, p, phi, Ua, pa and alpha at
rtol 1e-9, every solve's iteration count equal, the log lines (the
objective and alpha's maximum) and the written fields
(tests/test_torch_ras_models.py's PARITY_BODY).

Then the oracle of tests/test_adjoint.py through the port on the CPU (30
sweeps of its duct: the primal converges, alpha stays in [0, alphaMax]
and at zero next to the inlet, the adjoint responds).
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from foamtpu_torch.apps.cli import main as tcli
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.solvers import adjoint
from foamtpu_torch.solvers import apps as tapps
from foamtpu_torch.solvers import simple

import chip_smoke
from test_torch_electromagnetics import assert_app_parity
from test_torch_ras_models import parity

torch.set_num_threads(2)

STEPS = 3
APP = "adjointShapeOptimizationFoam"


@pytest.fixture(scope="module")
def run():
    return parity("slice11", STEPS, (APP,))[APP]


def test_application_matches_reference_f64(run):
    # the application logs the objective, not its solves (as the reference)
    assert_app_parity(run, STEPS, APP, logs_solves=False)
    assert set(run["errs"]) == {"U", "p", "phi", "Ua", "pa", "alpha"}
    # the design variable moved, and so did the adjoint
    assert run["errs"]["alpha"]["scale"] > 0.0
    assert run["errs"]["Ua"]["scale"] > 0.0
    assert [x for x in run["other_lines"][0] if x.startswith("objective")]


def test_oracle_holds_on_the_cpu(tmp_path):
    rec, checks = chip_smoke.SLICE11_ORACLES[APP](str(tmp_path), tcli, "cpu")
    assert all(checks.values()), (checks, rec)


def test_zero_sink_is_plain_simple(tmp_path):
    """A primal sweep with alpha = 0 is simple_step itself, and the inlet
    cells held at alpha = 0 are the owners of the patches named *in*."""
    d = chip_smoke.slice11_case(chip_smoke.REPO_DIR,
                                os.path.join(str(tmp_path), "pitz"), APP,
                                tcli, scale=0.25)
    case = TCase(d, device="cpu")
    mesh = case.mesh
    U, p = case.read_field("U"), case.read_field("p")
    cfg = adjoint.AdjointConfig(flow=simple.SimpleConfig(nu=1e-5))
    state = adjoint.initial_state(mesh, U, p, U, p, cfg)
    got, _ = adjoint._primal_with_alpha(mesh, state, cfg)
    ref, _ = simple.simple_step(mesh, dict(state), cfg.flow)
    assert torch.equal(got["U"].data, ref["U"].data)
    assert torch.equal(got["p"].data, ref["p"].data)
    with contextlib.redirect_stdout(io.StringIO()):
        tapps.run(case, max_steps=1)
    a = case.final_state["state"]["alpha"]
    inlet = np.unique(mesh.owner[mesh.patch("inlet").slice].numpy())
    assert float(a[inlet].abs().max()) == 0.0


def test_application_is_registered():
    assert tapps.APPLICATIONS[APP] is tapps.adjoint_shape_optimization_foam
