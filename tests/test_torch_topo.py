"""foamtpu_torch's mesh/topo.py (the host copy of the reference's
polyTopoChange: layer addition and removal, attach and detach) and
pimpleDyMFoam's attachDetach against the JAX package.

In process, bit for bit: `analyze` (every LayerTopo field), `build`
(attached and with a detached plane: points, faces, owner, neighbour,
patches and the derived geometry), `reorder_to_layers`,
`slab_overlap_matrix` and `remap_cells` (merge and split), and
`layer_ar` (merge, split and move on both sides), on the meshes of
tests/test_topochange.py and tests/test_attachdetach.py and on the
attachDuct tutorial's.

One float64 subprocess (FOAMTPU_X64=1 JAX_ENABLE_X64=1): the attachDuct
tutorial through both packages' `run(case)` for 12 steps, across the
detach event at 0.05 s (step 10), with its p solves converged
(chip_smoke.ATTACH_TIGHT_P: stopped by relTol 0.01, its PCG turns 1e-15
into 1e-6): the fields at rtol 1e-9, the log lines and the written fields
(tests/test_torch_ras_models.py's PARITY_BODY). The 24 p solves' PCG
counts are equal at ATTACH_TIGHT_P's tolerance of 1e-9; at 1e-8, 1e-10,
1e-11 and 1e-12 one or two of them differ by one (the residual crosses
the tolerance within the runs' 1e-11 difference), so the test allows two
such crossings, for other CPUs' round-off.
"""

import os

import numpy as np
import pytest
import torch

from foamtpu_torch.core.dictionary import parse_string as tparse
from foamtpu_torch.mesh import blockmesh as tbm
from foamtpu_torch.mesh import topo as ttopo

from test_torch_ras_models import parity
from test_torch_simple import REPO

torch.set_num_threads(2)

STEPS = 12
BOX = open(os.path.join(REPO, "tests", "test_topochange.py")).read().split(
    'BOX = """')[1].split('"""')[0]
DUCT = """
vertices (
    (0 0 0) (2 0 0) (2 0.5 0) (0 0.5 0)
    (0 0 0.1) (2 0 0.1) (2 0.5 0.1) (0 0.5 0.1)
);
blocks ( hex (0 1 2 3 4 5 6 7) (8 4 1) simpleGrading (1 1 1) );
boundary (
    inlet { type patch; faces ((0 4 7 3)); }
    outlet { type patch; faces ((2 6 5 1)); }
    walls { type wall; faces ((3 7 6 2) (1 5 4 0)); }
    frontAndBack { type empty; faces ((0 3 2 1) (4 5 6 7)); }
);
"""
ATTACH_DUCT = open(os.path.join(
    REPO, "tutorials", "incompressible", "pimpleDyMFoam", "attachDuct",
    "system", "blockMeshDict")).read().split("}", 1)[1]
# (name, blockMeshDict, axis)
MESHES = [("layered", BOX, 1), ("duct", DUCT, 0),
          ("attachDuct", ATTACH_DUCT, 0)]
IDS = [m[0] for m in MESHES]
POLY = ("points", "face_pts", "face_npts", "owner", "neighbour", "cf", "sf",
        "c", "v")


def _both(text):
    from foamtpu.core.dictionary import parse_string as jparse
    from foamtpu.mesh import blockmesh as jbm

    return jbm.generate(jparse(text)), tbm.generate(tparse(text))


def _same_poly(a, b):
    for f in POLY:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert [(p.name, p.type, p.start, p.size) for p in a.patches] == \
        [(p.name, p.type, p.start, p.size) for p in b.patches]


@pytest.mark.parametrize("name,text,axis", MESHES, ids=IDS)
def test_analyze_matches_reference(name, text, axis):
    from foamtpu.mesh import topo as jtopo

    pj, pt = _both(text)
    a, b = jtopo.analyze(pj, axis), ttopo.analyze(pt, axis)
    assert a.axis == b.axis and a.patch_defs == b.patch_defs
    assert a.base_faces == b.base_faces and a.edge_patch == b.edge_patch
    for f in ("planes", "base_pts", "bottom_patch", "top_patch",
              "cell_base", "cell_slab"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    data = np.random.default_rng(3).standard_normal((pt.n_cells, 3))
    assert np.array_equal(jtopo.reorder_to_layers(a, data),
                          ttopo.reorder_to_layers(b, data))


@pytest.mark.parametrize("name,text,axis", MESHES, ids=IDS)
@pytest.mark.parametrize("detach", [(), "middle"])
def test_build_matches_reference(name, text, axis, detach):
    from foamtpu.mesh import topo as jtopo

    pj, pt = _both(text)
    a, b = jtopo.analyze(pj, axis), ttopo.analyze(pt, axis)
    planes = b.planes.copy()
    planes[0] -= 0.3 * (planes[1] - planes[0])     # a moved piston plane
    d = () if not detach else (b.n_slabs // 2,)
    ma = jtopo.build(a, planes, detach_planes=d)
    mb = ttopo.build(b, planes, detach_planes=d)
    _same_poly(ma, mb)
    assert mb.n_cells == pt.n_cells
    if d:
        names = [p.name for p in mb.patches]
        assert names[-2:] == [f"attach{d[0]}Master", f"attach{d[0]}Slave"]


def test_slab_remap_matches_reference():
    from foamtpu.mesh import topo as jtopo

    rng = np.random.default_rng(4)
    old = np.asarray([0.0, 0.013, 0.02, 0.03, 0.04])
    nB = 7
    for new in (np.asarray([0.0, 0.02, 0.03, 0.04]),
                np.asarray([0.0, 0.005, 0.013, 0.02, 0.03, 0.04]),
                np.asarray([0.002, 0.011, 0.02, 0.03, 0.04])):
        Wa = jtopo.slab_overlap_matrix(old, new)
        Wb = ttopo.slab_overlap_matrix(old, new)
        assert np.array_equal(Wa, Wb)
        for shape in ((4 * nB,), (4 * nB, 3)):
            f = rng.standard_normal(shape)
            assert np.array_equal(jtopo.remap_cells(Wa, nB, f),
                                  ttopo.remap_cells(Wb, nB, f))


@pytest.mark.parametrize("pos,side", [(0.006, 0), (-0.006, 0), (0.002, 0),
                                      (0.036, -1), (0.024, -1),
                                      (0.031, -1)])
def test_layer_ar_matches_reference(pos, side):
    from foamtpu.mesh import topo as jtopo

    planes = np.asarray([0.0, 0.01, 0.02, 0.03])
    pa, ca = jtopo.layer_ar(planes, pos, h0=0.01, side=side)
    pb, cb = ttopo.layer_ar(planes, pos, h0=0.01, side=side)
    assert ca == cb and np.array_equal(pa, pb)


@pytest.fixture(scope="module")
def attach_run():
    return parity("slice16", STEPS, ["attachDuct"], timeout=600)


def test_attachduct_matches_reference_f64(attach_run):
    rec = attach_run["attachDuct"]
    assert rec["time"][0] == rec["time"][1] == STEPS
    assert rec["time"][2] == rec["time"][3] == "0.06"
    assert rec["fields"][0] == rec["fields"][1]
    for name, e in rec["errs"].items():
        assert e["ok"], (name, e)
    ts, js = rec["solves"]
    assert [n for n, _ in ts] == [n for n, _ in js]
    diff = [(a, b) for a, b in zip(ts, js) if a != b]
    assert len(diff) <= 2 and all(
        a[0] == "p" and abs(a[1] - b[1]) == 1 for a, b in diff), diff
    assert rec["other_lines"][0] == rec["other_lines"][1]
    assert rec["other_numbers_ok"]
    for sub, f in rec["files"].items():
        assert f["names"][0] == f["names"][1]
        assert all(e <= 1e-9 for e in f["scaled"].values()), (sub, f)


def test_attachduct_detaches_at_its_time(attach_run):
    lines = attach_run["attachDuct"]["other_lines"][0]
    assert "attachDetach event at t=#: DETACH" in lines
    assert not any("ATTACH" in x and "DETACH" not in x for x in lines)


def _spread(f64, f32, perturbed, f32_perturbed):
    """Per run and key: the largest of |f32 - f64|, |perturbed - f64| and
    |f32 perturbed - f32|."""
    out = {}
    for name, gold in f64.items():
        out[name] = {k: max(abs(f32[name][k] - g),
                            abs(perturbed[name][k] - g),
                            abs(f32_perturbed[name][k] - f32[name][k]))
                     for k, g in gold.items()
                     if isinstance(g, float)}
    return out


if __name__ == "__main__":
    # python tests/test_torch_topo.py goldens [--perturb]: chip_smoke's
    # TOPO_RUNS through the port on the CPU (float64 with FOAMTPU_X64=1);
    # python tests/test_torch_topo.py spread f64.json f32.json
    # f64_perturbed.json f32_perturbed.json
    import json
    import sys
    import tempfile

    sys.path.insert(0, REPO)
    import chip_smoke

    if sys.argv[1] == "goldens":
        with tempfile.TemporaryDirectory() as root:
            print(json.dumps(chip_smoke.topo_runs_cpu(
                REPO, root, perturb="--perturb" in sys.argv)))
    else:
        runs = [json.load(open(p)) for p in sys.argv[2:6]]
        print(json.dumps(_spread(*runs)))
