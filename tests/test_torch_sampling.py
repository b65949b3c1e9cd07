"""foamtpu_torch's sampling function objects against the JAX package's.

yPlus, yPlusRAS, wallShearStress, sets (a uniform line and a cloud) and
streamLine in one controlDict `functions` block of the 2D RAS channel
(chip_smoke.ras_channel_case, kOmega with nutUSpaldingWallFunction), run
in float64 through both packages' `run(case)` for 2 steps
(tests/test_torch_ras_models.py's PARITY_BODY): the same postProcessing
files, their numbers at 1e-9 (relative; the files print 6 significant
digits for the wall terms and 8 for sets and tracks, so the printed
numbers are equal), and the wall shear itself from both packages'
`_wall_shear` on the final state at 1e-9. Each wall object fetches one
small table per call; sets one gather per call. surfaces, sampledSurfaces
and coded still raise NotImplementedError naming themselves
(tests/test_torch_functionobjects.py holds them).
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from foamtpu_torch.apps.cli import main as tcli
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.core.dictionary import parse_string as tparse
from foamtpu_torch.functionobjects import base as fo_base
from foamtpu_torch.functionobjects import sampling

import chip_smoke
from test_torch_ras_models import assert_parity, parity

torch.set_num_threads(2)

STEPS = 2
TYPES = ("yPlus", "yPlusRAS", "wallShearStress", "sets", "streamLine")


@pytest.fixture(scope="module")
def run():
    return parity("sampling", STEPS, ["kOmega"])["kOmega"]


def test_sampling_run_matches_reference_f64(run):
    assert_parity(run, STEPS, "sampling")
    assert run["failures"] == 0 and run["executes"] == STEPS


@pytest.mark.parametrize("name,files", [
    ("yp", ["yp/yPlus.dat"]),
    ("ypRAS", ["ypRAS/yPlus.dat"]),
    ("shear", ["shear/wallShearStress.dat"]),
    ("lines", [f"lines/{t}/{s}_U_p_k_nut.xy" for t in ("0.02", "0.04")
               for s in ("across", "dots")]),
    ("tracks", ["tracks/0.02/tracks.xy", "tracks/0.04/tracks.xy"]),
])
def test_sampling_files_match_reference(run, name, files):
    post = run["files"]["postProcessing"]
    mine = [f for f in post["names"][0] if f.split("/")[0] == name]
    assert sorted(mine) == sorted(files)
    for f in files:
        assert post["ok"][f], f


def test_wall_shear_matches_reference_f64(run):
    assert set(run["wall_shear"]) == {"walls"}
    rec = run["wall_shear"]["walls"]
    assert rec["ok"] and rec["scale"] > 0


def test_wall_objects_fetch_one_table_per_call(run):
    f = run["fetches"]
    assert f["yp"] == f["ypRAS"] == f["shear"] == STEPS
    # the KD-tree's cell centres once, then one gather per call
    assert f["lines"] == 1 + STEPS
    # cell centres and volumes once, then U once per call
    assert f["tracks"] == 2 + STEPS


def test_sampling_types_are_ported():
    for t in TYPES:
        assert t not in fo_base.NOT_PORTED
    assert set(fo_base.NOT_PORTED) == {"surfaces", "sampledSurfaces",
                                       "coded", "codedFunctionObject"}


def test_yplus_on_a_laminar_state(tmp_path):
    """Without turbulence fields the wall term is nu dU/dn, so y+ =
    sqrt(nu |U_c| / y) y / nu from the wall cells' U at y = dy/2."""
    d = chip_smoke.ras_channel_case(str(tmp_path / "c"), "kOmega", steps=1)
    with contextlib.redirect_stdout(io.StringIO()):
        assert tcli(["blockMesh", "-case", d]) == 0
    case = TCase(d, device="cpu")
    U = case.read_field("U")
    state = {"U": U}
    fo = sampling.YPlus("yp", tparse("type yPlus;"), case)
    fo.execute("0", state)
    rows = open(fo.path).read().strip().splitlines()
    assert rows[0] == "# Time patch min max average" and len(rows) == 2
    t, patch, lo, hi, avg = rows[1].split()
    assert (t, patch) == ("0", "walls")
    # tau = nu (0 - U_c) / (dy/2) per wall face
    nu, y = chip_smoke.RAS_CHANNEL_NU, 0.005
    walls = next(p for p in case.mesh.patches if p.name == "walls")
    ux = U.data[case.mesh.owner[walls.slice]]
    ypl = torch.sqrt(nu * torch.linalg.norm(ux, dim=1) / y) * y / nu
    np.testing.assert_allclose([float(lo), float(hi), float(avg)],
                               [float(ypl.min()), float(ypl.max()),
                                float(ypl.mean())], rtol=2e-5)
    assert fo.fetches == 1
