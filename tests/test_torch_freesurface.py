"""foamtpu_torch's shallowWaterFoam (solvers/shallowwater.py) and
potentialFreeSurfaceFoam (solvers/potentialfreesurface.py) against the JAX
package's.

In float64 (one process, FOAMTPU_X64=1 JAX_ENABLE_X64=1) both packages'
`run(case)` take 3 steps of squareBump and of movingOscillatingBox, each from a seeded start
(chip_smoke.SLICE11_CASES): squareBump ships a uniform hU under upwind
weights, which then follow the sign of round-off, and the box ships water
at rest under a flat surface, where nothing moves. Fields (h, hU, U, phi;
U, p, phi and the surface elevation zeta) at rtol 1e-9, every solve's
iteration count equal, the log lines and the written files
(tests/test_torch_ras_models.py's PARITY_BODY).

Then the oracles of tests/test_shallowwater.py (the seiche, the lake at
rest) and tests/test_potentialfreesurface.py (the sloshing wave, the
flat surface at rest) through the port on the CPU, and the
waveSurfacePressure BC: the reference maps it to `mixed`, whose value
the solver rewrites from zeta each step.
"""

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

torch.set_num_threads(2)

STEPS = 3
APPS = ("shallowWaterFoam", "potentialFreeSurfaceFoam")
FIELDS = {"shallowWaterFoam": {"h", "hU", "U", "phi"},
          "potentialFreeSurfaceFoam": {"U", "p", "phi", "zeta"}}


@pytest.fixture(scope="module")
def runs():
    return parity("slice11", STEPS, APPS)


@pytest.mark.parametrize("app", APPS)
def test_application_matches_reference_f64(runs, app):
    rec = runs[app]
    # potentialFreeSurfaceFoam logs zeta's range, and no solve (as the
    # reference's application)
    assert_app_parity(rec, STEPS, app,
                      logs_solves=app == "shallowWaterFoam")
    assert set(rec["errs"]) == FIELDS[app]
    if app == "potentialFreeSurfaceFoam":
        # the seeded flow moves the surface
        assert rec["errs"]["zeta"]["scale"] > 0.0


@pytest.mark.parametrize("app", APPS)
def test_reference_oracles_hold_on_the_cpu(tmp_path, app):
    rec, checks = chip_smoke.SLICE11_ORACLES[app](str(tmp_path), tcli, "cpu")
    assert all(checks.values()), (checks, rec)


def test_wave_surface_pressure_is_mixed(tmp_path):
    """0/p's waveSurfacePressure patch reads as `mixed` (refValue 0,
    valueFraction 1), in both packages; the application finds it and
    its initial state keeps it mixed with the surface head as value."""
    from foamtpu.core.case import Case as JCase

    d = chip_smoke.slice11_case(chip_smoke.REPO_DIR,
                                os.path.join(str(tmp_path), "box"),
                                "potentialFreeSurfaceFoam", tcli)
    tc, jc = TCase(d, device="cpu"), JCase(d)
    tp, jp = tc.read_field("p"), jc.read_field("p")
    assert [b.kind for b in tp.bcs] == [b.kind for b in jp.bcs] == [
        "mixed", "zeroGradient", "empty"]
    for tb, jb in zip(tp.bcs, jp.bcs):
        for key in ("ref_value", "ref_grad", "vfrac"):
            np.testing.assert_array_equal(getattr(tb, key).numpy(),
                                          np.asarray(getattr(jb, key)))
    with open(os.devnull, "w") as null:
        import contextlib

        with contextlib.redirect_stdout(null):
            tapps.run(tc, max_steps=1)
    bc = tc.final_state["state"]["p"].bcs[0]
    assert bc.kind == "mixed"
    np.testing.assert_allclose(
        bc.ref_value.numpy(), 9.81 * tc.final_state["state"]["zeta"].numpy(),
        rtol=1e-6)


def test_applications_are_registered():
    assert tapps.APPLICATIONS["shallowWaterFoam"] is tapps.shallow_water_foam
    assert tapps.APPLICATIONS["potentialFreeSurfaceFoam"] is \
        tapps.potential_free_surface_foam
