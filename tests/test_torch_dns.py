"""foamtpu_torch's dnsFoam, boxTurb and models/randomprocesses.py against
the JAX package's.

models/randomprocesses.py is host numpy in both packages (the port keeps
a copy; the JAX package's module imports jax.numpy without using it), so
boxTurb's field, the spectrum, the divergence check and the forcing
process give the same numbers from the same seed: held equal to the last
bit, and so is the 0/U the boxTurb command writes for the boxTurb16
tutorial.

In float64 (one process, FOAMTPU_X64=1 JAX_ENABLE_X64=1) both packages'
`run(case)` take 3 steps of boxTurb16 as its Allrun makes it (blockMesh,
boxTurb, dnsFoam; chip_smoke.SLICE11_CASES): U, p and phi at rtol 1e-9
with the host forcing added every step, every solve's iteration count
equal, the log lines (k among them) and the written files
(tests/test_torch_ras_models.py's PARITY_BODY).

Then the oracles of tests/test_randomprocesses.py through the port on
the CPU (a div-free boxTurb of the target energy, the boxTurb command,
the forced box that stays alive and finite for 20 steps).
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from foamtpu_torch.apps.cli import main as tcli
from foamtpu_torch.models import randomprocesses as trp
from foamtpu_torch.solvers import apps as tapps

import chip_smoke
from test_torch_electromagnetics import assert_app_parity
from test_torch_ras_models import parity

torch.set_num_threads(2)

STEPS = 3


@pytest.fixture(scope="module")
def run():
    return parity("slice11", STEPS, ("dnsFoam",))["dnsFoam"]


def test_application_matches_reference_f64(run):
    assert_app_parity(run, STEPS, "dnsFoam")
    assert set(run["errs"]) == {"U", "p", "phi"}
    assert [x for x in run["other_lines"][0] if x.startswith("k = ")]


@pytest.mark.parametrize("shape,lengths,ea,k0,seed", [
    ((32, 32, 32), (1.0, 1.0, 1.0), 2.0, 8 * np.pi, 3),
    ((16, 8, 12), (1.0, 0.5, 0.75), 0.5, 12.0, 2),
])
def test_random_processes_match_reference(shape, lengths, ea, k0, seed):
    from foamtpu.models import randomprocesses as jrp

    got = trp.box_turb(shape, lengths, ea, k0, seed)
    ref = jrp.box_turb(shape, lengths, ea, k0, seed)
    np.testing.assert_array_equal(got, ref)
    assert trp.div_rms(got, lengths) == jrp.div_rms(ref, lengths)
    k = np.linspace(0.0, 40.0, 17)
    np.testing.assert_array_equal(trp.energy_spectrum(k, ea, k0),
                                  jrp.energy_spectrum(k, ea, k0))
    tu, ju = trp.UOProcess(26, 0.81, 0.09, seed), jrp.UOProcess(26, 0.81,
                                                               0.09, seed)
    for dt in (0.005, 0.005, 0.0025):
        np.testing.assert_array_equal(tu.update(dt), ju.update(dt))


def test_boxturb_command_writes_the_reference_field(tmp_path):
    from foamtpu.apps.cli import main as jcli

    dirs = {}
    for tag, cli in (("port", tcli), ("ref", jcli)):
        dirs[tag] = chip_smoke.slice11_case(
            chip_smoke.REPO_DIR, os.path.join(str(tmp_path), tag),
            "dnsFoam", cli, device=("-device", "cpu") if tag == "port"
            else ())
    nums = []
    for d in dirs.values():
        with open(os.path.join(d, "0", "U")) as f:
            text = f.read()
        body = text[text.index("internalField"):text.index("boundaryField")]
        nums.append(body)
    assert nums[0] == nums[1]


def test_forcing_is_seeded(tmp_path):
    """dns_forcing draws from its own seeded generator: two forcings of the
    box agree step by step, are finite and non-zero, and differ between
    steps (the Ornstein-Uhlenbeck process moves). The force itself is held
    to the JAX package's by the parity run, which adds it every step."""
    from foamtpu_torch.core.case import Case

    d = chip_smoke.slice11_case(chip_smoke.REPO_DIR,
                                os.path.join(str(tmp_path), "box"),
                                "dnsFoam", tcli, device=("-device", "cpu"))
    mesh = Case(d, device="cpu").mesh
    f1, f2 = tapps.dns_forcing(mesh), tapps.dns_forcing(mesh)
    a, b = f1(0.005), f2(0.005)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (mesh.n_cells, 3) and np.isfinite(a).all()
    assert np.abs(a).max() > 0.0
    assert np.abs(f1(0.005) - a).max() > 0.0


def test_oracles_hold_on_the_cpu(tmp_path):
    rec, checks = chip_smoke.SLICE11_ORACLES["dnsFoam"](str(tmp_path), tcli,
                                                        "cpu")
    assert all(checks.values()), (checks, rec)


def test_application_is_registered():
    assert tapps.APPLICATIONS["dnsFoam"] is tapps.dns_foam
    assert tcli.__module__ == "foamtpu_torch.apps.cli"
    with contextlib.redirect_stdout(io.StringIO()):
        assert tcli([]) == 2
