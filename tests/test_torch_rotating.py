"""The goldens of chip_smoke.py's `rotating` phase, and that phase's
checks run here on the CPU.

`reference_rotating` is the goldens' source: each tutorial of
chip_smoke.ROTATING_CASES through the JAX package's blockMesh, setFields
and application on the CPU in float32, the phase's steps (the SIMPLE
cases 50 iterations in chunks of 10, the PIMPLE cases whole, interFoam 20
steps). One test re-derives the goldens (rtol 1e-4); one runs the port's
application on the CPU in float32 against them at chip_smoke's 1e-3 (the
mixer's velocities relative to the rotor's speed, its pressures to the
rotor's dynamic pressure: chip_smoke.ROTATING_FLOOR) with the phase's
invariants.

The two PIMPLE tutorials ship a steadyState ddt, and the PIMPLE step runs
its final outer iteration unrelaxed (OpenFOAM-2.2.x falls back to the U
and p factors there; the JAX package does not, ROADMAP Queue 3): they
diverge in both packages, Courant number 8 at step 1 and ~1e15 at step
10. Their golden is that divergence.
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
from test_torch_simple import REPO

torch.set_num_threads(2)

APPS = list(chip_smoke.ROTATING_CASES)


def reference_rotating(root, app, monkeypatch):
    """The goldens' source (module docstring)."""
    from foamtpu.apps.cli import main as jcli
    from foamtpu.core.case import run_case as jrun

    monkeypatch.setenv("FOAMTPU_CHUNK", "10")
    steps = chip_smoke.ROTATING_CASES[app][1]
    d = chip_smoke.basic_case(REPO, app, str(root), jcli,
                              cases=chip_smoke.ROTATING_CASES)
    with contextlib.redirect_stdout(io.StringIO()):
        case = jrun(d, max_steps=steps)
    assert case.time.index == steps
    a = chip_smoke.rotating_arrays(case.final_state)
    return chip_smoke.rotating_scalars(app, np.asarray(case.mesh.c),
                                       np.asarray(case.mesh.v), a)


@pytest.mark.parametrize("app", APPS)
def test_rotating_goldens_come_from_the_reference(tmp_path, monkeypatch,
                                                  app):
    got = reference_rotating(tmp_path, app, monkeypatch)
    gold = chip_smoke.ROTATING_GOLDEN[app]
    assert sorted(got) == sorted(gold)
    if "Pimple" in app:
        assert got == gold == {"diverged": True}
        return
    for name, g in gold.items():
        np.testing.assert_allclose(got[name], g, rtol=1e-4,
                                   err_msg=f"{app} {name}")


@pytest.mark.parametrize("app", APPS)
def test_port_rotating_f32_meets_goldens(tmp_path, monkeypatch, app):
    """What chip_smoke's rotating phase checks on the card, here on the
    CPU: the port's application on the tutorial in float32, the
    invariants and the goldens at 1e-3."""
    monkeypatch.setenv("FOAMTPU_CHUNK", "10")
    steps = chip_smoke.ROTATING_CASES[app][1]
    d = chip_smoke.basic_case(REPO, app, str(tmp_path), tcli,
                              ("-device", "cpu"),
                              cases=chip_smoke.ROTATING_CASES)
    case = TCase(d, device="cpu")
    assert case.application == app
    alpha0 = (case.read_field("alpha1").data.clone()
              if os.path.exists(os.path.join(d, "0", "alpha1")) else None)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        tapps.run(case, max_steps=steps)
    assert case.mesh.v.dtype == torch.float32
    assert case.time.index == steps
    a = chip_smoke.rotating_arrays(case.final_state)
    got = chip_smoke.rotating_scalars(app, case.mesh.c.numpy(),
                                      case.mesh.v.numpy(), a)
    _, checks = chip_smoke.rotating_invariants(app, case, a, log.getvalue(),
                                               alpha0)
    assert checks and all(checks.values()), checks
    gold = chip_smoke.ROTATING_GOLDEN[app]
    if "Pimple" in app:
        assert got == gold
        return
    rel = chip_smoke.golden_rel_err(got, gold, chip_smoke.ROTATING_FLOOR)
    assert max(rel.values()) <= 1e-3, rel


def test_rotating_applications_are_registered():
    for app in APPS:
        assert tapps.APPLICATIONS[app] in (tapps.simplefoam,
                                           tapps.pimplefoam,
                                           tapps.interfoam_app)
    # channelFoam (pimpleFoam with an LES model) is ported since the
    # turbulence slice (tests/test_torch_channel.py), the compressible
    # porous/MRF family since the compressible slice
    # (tests/test_torch_rhopimple.py), dnsFoam since the single-equation
    # slice (tests/test_torch_dns.py), windSimpleFoam (simpleFoam, as the
    # reference registers it) since the snappyHexMesh slice
    # (tests/test_torch_snappy.py), the multiphase family since the
    # multiphase slice (tests/test_torch_multiphase_vof.py,
    # test_torch_multiphase_euler.py, test_torch_settling_cavitating.py),
    # XiFoam since the combustion slice (tests/test_torch_reacting.py);
    # still outside the port: sonicDyMFoam, and dieselEngineFoam, which
    # neither package registers
    assert tapps.APPLICATIONS["channelFoam"] is tapps.pimplefoam
    assert tapps.APPLICATIONS["dnsFoam"] is tapps.dns_foam
    assert tapps.APPLICATIONS["rhoPorousSimpleFoam"] is tapps.rho_simplefoam
    assert tapps.APPLICATIONS["rhoPorousMRFSimpleFoam"] is \
        tapps.rho_simplefoam
    assert tapps.APPLICATIONS["rhoPorousMRFPimpleFoam"] is \
        tapps.rho_pimplefoam
    assert tapps.APPLICATIONS["windSimpleFoam"] is tapps.simplefoam
    for app in ("cavitatingFoam", "sonicLiquidFoam", "compressibleInterFoam",
                "twoPhaseEulerFoam", "bubbleFoam", "multiphaseEulerFoam",
                "twoLiquidMixingFoam", "MRFMultiphaseInterFoam",
                "multiphaseInterFoam", "interPhaseChangeFoam",
                "interMixingFoam", "settlingFoam"):
        assert app in tapps.APPLICATIONS
    assert tapps.APPLICATIONS["XiFoam"] is tapps.xi_foam
    for app in ("dieselEngineFoam", "sonicDyMFoam"):
        assert app not in tapps.APPLICATIONS
