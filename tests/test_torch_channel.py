"""foamtpu_torch's channelFoam and boundaryFoam against the JAX package's.

- channelFoam: the channel395 tutorial (cyclic in x and z, Smagorinsky,
  PCG p with the polynomial preconditioner), its controlDict and schemes
  as shipped, from a well-posed start: U = Ubar plus a seeded 10%
  perturbation (chip_smoke.les_channel_case; from the shipped uniform U
  the pressure is round-off). Both applications register channelFoam as
  pimpleFoam with the case's LES model; neither reads Ubar (ROADMAP
  Queue 3).
- boundaryFoam: the boundaryLaunderSharma tutorial as shipped (kEpsilon
  with wall functions, 1x40x1 cells between two walls).

Each runs in float64 through both packages' `run(case)` for 3 steps
(tests/test_torch_ras_models.py's PARITY_BODY): fields at rtol 1e-9,
every solve's iteration count equal, the log lines (boundaryFoam's
pressure gradient among them) and the written fields the same.

The goldens of chip_smoke.py's turbulence_models phase (RAS_GOLDEN,
LES_GOLDEN) come from `reference_goldens`: the JAX package on the CPU in
float32 through its own `run_case`, on the cases chip_smoke writes. Run
`JAX_PLATFORMS=cpu python tests/test_torch_channel.py` to print them; the
test below re-derives the tutorial's own model, Smagorinsky on
channel395, and the port on the CPU in float32 meets it at chip_smoke's
tolerance.
"""

import contextlib
import io
import json
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

from foamtpu_torch.apps.cli import main as tcli
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.solvers import apps as tapps

import chip_smoke
from test_torch_ras_models import assert_parity, parity
from test_torch_simple import REPO

torch.set_num_threads(2)

STEPS = 3


@pytest.fixture(scope="module")
def runs():
    return parity("channel395", STEPS, [
        "channel395", "boundary:boundaryLaunderSharma"])


@pytest.fixture(scope="module")
def channel_run(runs):
    return runs["channel395"]


@pytest.fixture(scope="module")
def boundary_run(runs):
    return runs["boundaryLaunderSharma"]


def test_channelfoam_matches_reference_f64(channel_run):
    assert_parity(channel_run, STEPS, "channel395")
    assert set(channel_run["errs"]) == {"U", "p", "phi", "nut"}
    names = [n for n, _ in channel_run["solves"][0]]
    assert names.count("p") == STEPS and "Ux" in names


def test_boundaryfoam_matches_reference_f64(boundary_run):
    assert_parity(boundary_run, STEPS, "boundaryLaunderSharma")
    assert set(boundary_run["errs"]) == {"U", "k", "epsilon", "nut",
                                         "gradP"}
    lines = boundary_run["other_lines"][0]
    assert lines.count("Uncorrected Ubar = ..., pressure gradient = #") \
        == STEPS
    assert [n for n, _ in boundary_run["solves"][0]] == ["Uxx", "Uxy",
                                                         "Uxz"] * STEPS


def test_applications_are_registered():
    assert tapps.APPLICATIONS["channelFoam"] is tapps.pimplefoam
    assert tapps.APPLICATIONS["boundaryFoam"] is tapps.boundary_foam


def _tutorial(root, rel, cli):
    import shutil

    dst = os.path.join(str(root), os.path.basename(rel))
    shutil.copytree(os.path.join(REPO, rel), dst)
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli(["blockMesh", "-case", dst]) == 0
    return dst


def test_boundaryfoam_holds_ubar(tmp_path):
    """After every iteration the volume-averaged U is Ubar = (1 0 0): the
    pressure gradient absorbs the difference (float32, 5 iterations)."""
    case = TCase(_tutorial(tmp_path, chip_smoke.BOUNDARY_CASE, tcli),
                 device="cpu")
    with contextlib.redirect_stdout(io.StringIO()) as log:
        tapps.run(case, max_steps=5)
    U, v = case.final_state["U"].data, case.mesh.v
    ubar = (U * v[:, None]).sum(dim=0) / v.sum()
    np.testing.assert_allclose(ubar.numpy(), [1.0, 0.0, 0.0], atol=2e-6)
    assert log.getvalue().count("pressure gradient = ") == 5
    assert sorted(os.listdir(os.path.join(case.dir, "5"))) == [
        "U", "epsilon", "k", "nut"]


def test_boundaryfoam_develops_with_the_tutorials_turbulence_relaxation(
        tmp_path, monkeypatch):
    """The reference's boundaryFoam corrects kEpsilon steady with its
    equations unrelaxed, and on boundaryLaunderSharma its profile does not
    develop (ROADMAP Queue 3): U changes sign from cell to cell. With the
    tutorial's relaxation factor 0.7 passed to k and epsilon (the port's
    KEpsilon.correct takes it; boundary_foam does not pass it, as the
    reference) the same 100 iterations give a channel profile: U > 0,
    fastest at the centre, the pressure gradient steady (float32)."""
    from foamtpu_torch.models.turbulence import ras

    def run_with(relax):
        orig = ras.KEpsilon.correct
        if relax is not None:
            monkeypatch.setattr(ras.KEpsilon, "correct",
                                lambda self, *a, **k: orig(self, *a, **dict(
                                    k, relax=relax)))
        root = tmp_path / str(relax)
        case = TCase(_tutorial(root, chip_smoke.BOUNDARY_CASE, tcli),
                     device="cpu")
        with contextlib.redirect_stdout(io.StringIO()) as log:
            tapps.run(case, max_steps=chip_smoke.BOUNDARY_STEPS)
        monkeypatch.undo()
        gradp = [float(x.split("=")[-1]) for x in log.getvalue().splitlines()
                 if "pressure gradient" in x]
        return case.final_state["U"].data[:, 0].numpy(), gradp

    u, _ = run_with(None)
    assert u.min() < 0.0            # the shipped behaviour, both packages
    u, gradp = run_with(0.7)
    assert u.min() > 0.5 and u.max() < 1.2
    assert u[19] == u.max() and u[0] == u.min()   # 40 cells, wall to wall
    assert abs(gradp[-1] - gradp[-2]) < 1e-2 * abs(gradp[-1])


def reference_goldens(root, ras=tuple(chip_smoke.RAS_CHANNEL_MODELS),
                      les=chip_smoke.LES_MODELS):
    """The goldens' source: chip_smoke's RAS channel (RAS_CHANNEL_STEPS)
    and LES channel395 (LES_STEPS, with yPlus and wallShearStress) cases
    through the JAX package's run_case on the CPU in float32, reduced by
    chip_smoke's scalar functions."""
    from foamtpu.apps.cli import main as jcli
    from foamtpu.core.case import run_case as jrun

    out = {"ras": {}, "les": {}}
    for kind, names in (("ras", ras), ("les", les)):
        for name in names:
            d = os.path.join(str(root), kind, name)
            if kind == "ras":
                chip_smoke.ras_channel_case(
                    d, name, p_solver=chip_smoke.RAS_CHANNEL_CARD_P)
                steps = chip_smoke.RAS_CHANNEL_STEPS
            else:
                chip_smoke.les_channel_case(REPO, d, name,
                                            funcs=chip_smoke.LES_FUNCS)
                steps = chip_smoke.LES_STEPS
            with contextlib.redirect_stdout(io.StringIO()):
                assert jcli(["blockMesh", "-case", d]) == 0
                jc = jrun(d, max_steps=steps)
            a = chip_smoke.turbulence_arrays(jc.final_state, np.asarray)
            v = np.asarray(jc.mesh.v)
            assert v.dtype == np.float32
            out[kind][name] = (chip_smoke.ras_channel_scalars(a, v)
                               if kind == "ras" else
                               chip_smoke.les_channel_scalars(a, v, d))
    return out


def test_smagorinsky_golden_comes_from_the_reference(tmp_path):
    got = reference_goldens(tmp_path, ras=(), les=("Smagorinsky",))
    rel = chip_smoke.golden_rel_err(got["les"]["Smagorinsky"],
                                    chip_smoke.LES_GOLDEN["Smagorinsky"],
                                    chip_smoke.TURB_GOLDEN_FLOOR)
    # 1e-4 leaves room for another CPU's vector width (measured 0 here)
    assert max(rel.values()) <= 1e-4, rel
    # the port on the CPU in float32 meets it at chip_smoke's tolerance
    d = chip_smoke.les_channel_case(REPO, str(tmp_path / "port"),
                                    "Smagorinsky", funcs=chip_smoke.LES_FUNCS)
    with contextlib.redirect_stdout(io.StringIO()):
        assert tcli(["blockMesh", "-case", d]) == 0
        case = TCase(d, device="cpu")
        tapps.run(case, max_steps=chip_smoke.LES_STEPS)
    a = chip_smoke.turbulence_arrays(case.final_state, lambda t: t.numpy())
    got = chip_smoke.les_channel_scalars(a, case.mesh.v.numpy(), d)
    rel = chip_smoke.golden_rel_err(got, chip_smoke.LES_GOLDEN["Smagorinsky"],
                                    chip_smoke.TURB_GOLDEN_FLOOR)
    assert max(rel.values()) <= chip_smoke.TURB_GOLDEN_TOL, rel


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    print(json.dumps(reference_goldens(tempfile.mkdtemp()), indent=1))
