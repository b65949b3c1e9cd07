"""foamtpu_torch's sonicDyMFoam (solvers/engine.py's transonic step on a
solid-body moving mesh) against the JAX package.

One float64 subprocess (FOAMTPU_X64=1 JAX_ENABLE_X64=1): the movingStep
tutorial through both packages' `run(case)` for 3 steps, as
chip_smoke.slice16_case's parity variant makes it: its blocks cut 4x per
direction (1,008 cells), U and T seeded (a uniform start under upwind
weighs round-off) and its pressure scaled by 1e5, the same Mach-3 flow
above the step's p_min: the fields at rtol 1e-9, the log lines and the
written fields.

And the fault both packages share (ROADMAP Queue 3), in process: the
engine step's p_min of 1000 Pa clamps the shipped movingStep's p = 1 on
its first pressure solve (so the shipped case diverges in both).
"""

import contextlib
import io

import pytest
import torch

import chip_smoke
from foamtpu_torch.apps.cli import main as tcli
from foamtpu_torch.core.case import run_case
from foamtpu_torch.solvers import apps as tapps
from foamtpu_torch.solvers import engine as tsolver

from test_torch_ras_models import parity
from test_torch_simple import REPO

torch.set_num_threads(2)

STEPS = 3


@pytest.fixture(scope="module")
def run():
    return parity("slice16", STEPS, ["movingStep"], timeout=600)["movingStep"]


def test_sonicdym_matches_reference_f64(run):
    assert run["time"][0] == run["time"][1] == STEPS
    assert run["fields"][0] == run["fields"][1]
    assert {"U", "p", "T", "phi"} <= set(run["fields"][1])
    for field, e in run["errs"].items():
        assert e["ok"], (field, e)
    assert run["other_lines"][0] == run["other_lines"][1]
    assert run["other_numbers_ok"]
    for sub, f in run["files"].items():
        assert f["names"][0] == f["names"][1]
        assert all(e <= 1e-9 for e in f["scaled"].values()), (sub, f)


def test_sonicdym_is_registered():
    assert tapps.APPLICATIONS["sonicDyMFoam"] is tapps.sonic_dym_foam


def test_moving_step_as_shipped_is_clamped_to_p_min(tmp_path):
    d = chip_smoke.slice16_case(REPO, str(tmp_path / "step"), "movingStep",
                                tcli)
    with contextlib.redirect_stdout(io.StringIO()):
        c = run_case(d, max_steps=1, device="cpu")
    p = c.final_state["state"]["p"].data
    p_min = tsolver.EngineConfig._field_defaults["p_min"]
    # the shipped p is 1 everywhere; after one step no cell is below the
    # clamp
    assert p_min == 1e3 and float(p.min()) >= p_min * (1 - 1e-6)
