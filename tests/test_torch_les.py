"""foamtpu_torch's LES models of les.py and les2.py against the JAX
package, on a cyclic mesh.

Smagorinsky, oneEqEddy, homogeneousDynSmagorinsky, dynOneEqEddy,
scaleSimilarity and mixedSmagorinsky, each from case files: channelFoam's
channel395 (cyclic in x and z, walls in y) cut to a 12x8x4 box by
chip_smoke.les_channel_case, its LESProperties naming the model, with a
yPlus and a wallShearStress object, from a well-posed start (U = Ubar plus
a seeded 10% perturbation; 0/k seeded for the two models that carry k).
In float64 (tests/test_torch_ras_models.py's PARITY_BODY, two processes)
each package's `run(case)` takes 3 channelFoam (pimpleFoam) steps: fields
at rtol 1e-9, every solve's iteration count equal, log lines, written
fields and the postProcessing files the same. The test filter
`simple_filter` on seeded random scalar and vector fields of that mesh
agrees to 1e-12 of the result's scale. Then, in-process: the filter width
is np.cbrt of the cell volumes, computed once per mesh; LESProperties'
`delta` other than cubeRootVol raises; select builds each model from case
files with the fields it carries.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from foamtpu_torch.apps.cli import main as tcli
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.core.dictionary import parse_string as tparse
from foamtpu_torch.models.turbulence import base as tbase
from foamtpu_torch.models.turbulence import les as tles

import chip_smoke
from test_torch_ras_models import assert_parity, parity
from test_torch_simple import REPO

torch.set_num_threads(2)

STEPS = 3
GROUP_A = ("Smagorinsky", "oneEqEddy", "homogeneousDynSmagorinsky")
GROUP_B = ("dynOneEqEddy", "scaleSimilarity", "mixedSmagorinsky")
assert GROUP_A + GROUP_B == chip_smoke.LES_MODELS


@pytest.fixture(scope="module")
def runs_a():
    return parity("les", STEPS, GROUP_A)


@pytest.fixture(scope="module")
def runs_b():
    return parity("les", STEPS, GROUP_B)


@pytest.mark.parametrize("model", chip_smoke.LES_MODELS)
def test_les_model_matches_reference_f64(request, model):
    runs = request.getfixturevalue("runs_a" if model in GROUP_A
                                   else "runs_b")
    rec = runs[model]
    assert_parity(rec, STEPS, model)
    carried = {"nut", "k"} if model in chip_smoke.LES_K_MODELS else {"nut"}
    assert set(rec["errs"]) == {"U", "p", "phi"} | carried
    names = [n for n, _ in rec["solves"][0]]
    assert names.count("k") == (STEPS if "k" in carried else 0)
    post = rec["files"]["postProcessing"]
    assert post["names"][0] == ["shear1/wallShearStress.dat",
                                "yPlus1/yPlus.dat"]


def test_simple_filter_matches_reference_f64(runs_a):
    errs = runs_a[GROUP_A[0]]["filter_rel_err"]
    assert set(errs) == {"1", "2"}
    for ndim, err in errs.items():
        assert err <= 1e-12, (ndim, err)


def _case(tmp_path, model, blocks=(12, 8, 4)):
    d = chip_smoke.les_channel_case(REPO, str(tmp_path / model), model,
                                    blocks=blocks, steps=1)
    with contextlib.redirect_stdout(io.StringIO()):
        assert tcli(["blockMesh", "-case", d]) == 0
    return TCase(d, device="cpu")


def test_filter_width_is_the_cube_root_of_the_volume(tmp_path):
    """delta = np.cbrt(V) on the mesh's device, computed once per mesh (a
    second call returns the same tensor)."""
    case = _case(tmp_path, "Smagorinsky")
    model = tles.Smagorinsky(2e-5)
    d1 = model.delta(case.mesh)
    assert d1 is model.delta(case.mesh)
    assert d1.dtype == case.mesh.v.dtype and d1.device == case.mesh.device
    np.testing.assert_array_equal(d1.numpy(),
                                  np.cbrt(case.mesh.v.numpy()))
    # the box's cells are 1/3 x 1/4 x 1/8 m
    np.testing.assert_allclose(d1.numpy(), (1 / 96) ** (1 / 3), rtol=1e-6)


def test_les_delta_other_than_cube_root_vol_raises():
    props = tparse("LESModel Smagorinsky; turbulence on; delta vanDriest;")
    with pytest.raises(NotImplementedError, match="vanDriest"):
        tbase.select(props, 2e-5, kind="LES")
    ok = tbase.select(tparse("LESModel Smagorinsky; delta cubeRootVol;"),
                      2e-5, kind="LES")
    assert ok.name == "Smagorinsky"
    # the reference reads no delta: a RAS dict is not checked for one
    assert tbase.select(tparse("RASModel kOmega; delta smooth;"),
                        1e-5).name == "kOmega"


@pytest.mark.parametrize("model", chip_smoke.LES_MODELS)
def test_select_builds_the_les_model_from_case_files(tmp_path, model):
    from foamtpu.core.case import Case as JCase
    from foamtpu.solvers.apps import _load_turbulence as jload
    from foamtpu_torch.solvers.apps import _load_turbulence as tload

    case = _case(tmp_path, model)
    tm, ts = tload(case, 2e-5)
    jm, js = jload(JCase(case.dir), 2e-5)
    assert type(tm).__name__ == type(jm).__name__ and tm.name == model
    assert sorted(ts) == sorted(js) == sorted(
        ("k", "nut") if model in chip_smoke.LES_K_MODELS else ("nut",))
