"""foamtpu_torch's mesh/refine.py (the host copy of the reference's
dynamicRefineFvMesh) and interDyMFoam's adaptive refinement against the
JAX package.

In process, bit for bit, on the damBreakWithObstacle tutorial's 16 x 16
box with a seeded smeared interface (a tanh band around a wavy line,
plus noise): `amr_init` (the octree and its PolyMesh), two `adapt` events
(refinement, then a moved band that unrefines and refines), their
`build_maps` and `remap_field` of a scalar and a vector field, and
`balance_2to1` on a leaf set that needs balancing. The port's own
oracles of tests/test_amr.py: the remap conserves the integrals.

One float64 subprocess (FOAMTPU_X64=1 JAX_ENABLE_X64=1): the tutorial
through both packages' `run(case)` for 4 steps, two adaptation events
(refineInterval 2): equal cell counts after each event (the log lines),
the fields at rtol 1e-9 and the written fields.

In process, float32: the port's run of the tutorial to 10 steps holds the
oracles of tests/test_amr.py::test_interdym_amr_dambreak_case (the mesh
refines, the water volume within 2%, alpha in [-1e-3, 1 + 2.5e-3]).
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

import chip_smoke
from foamtpu_torch.apps.cli import main as tcli
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.core.dictionary import parse_file as tparse_file
from foamtpu_torch.mesh import blockmesh as tbm
from foamtpu_torch.mesh import refine as trefine
from foamtpu_torch.solvers import apps as tapps

from test_torch_ras_models import parity
from test_torch_simple import REPO

torch.set_num_threads(2)

STEPS = 4
CASE = os.path.join(REPO, chip_smoke.SLICE16_TUTORIALS["damBreakWithObstacle"])
DICT = os.path.join(CASE, "constant", "polyMesh", "blockMeshDict")


def band(c, x0, seed):
    """A smeared interface around a wavy vertical line, with noise."""
    rng = np.random.default_rng(seed)
    d = c[:, 0] - x0 - 0.05 * np.sin(6.0 * c[:, 1])
    return np.clip(0.5 * (1.0 - np.tanh(d / 0.06))
                   + 1e-3 * rng.standard_normal(c.shape[0]), 0.0, 1.0)


def same_poly(a, b):
    for f in ("points", "face_pts", "face_npts", "owner", "neighbour", "cf",
              "sf", "c", "v"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert [(p.name, p.type, p.start, p.size) for p in a.patches] == \
        [(p.name, p.type, p.start, p.size) for p in b.patches]


@pytest.fixture(scope="module")
def events():
    """Both packages' octree through amr_init and two adapt events."""
    from foamtpu.core.dictionary import parse_file as jparse_file
    from foamtpu.mesh import blockmesh as jbm
    from foamtpu.mesh import refine as jrefine

    out = {}
    for tag, bm, parse, ref in (("jax", jbm, jparse_file, jrefine),
                                ("port", tbm, tparse_file, trefine)):
        amr, pm = ref.amr_init(bm.generate(parse(DICT)))
        recs = [(amr, pm, None)]
        for k, x0 in enumerate((0.35, 0.6)):
            f = band(pm.c, x0, k)
            amr2, pm2 = ref.adapt(amr, pm, f, 0.001, 0.999, 1, 1, 20000)
            vo, vn = ref.build_maps(amr, amr2)
            U = np.stack([f, pm.c[:, 1], -f], axis=1)
            maps = (vo, vn, ref.remap_field(f, vo, vn, pm2.n_cells),
                    ref.remap_field(U, vo, vn, pm2.n_cells), f, U, pm)
            amr, pm = amr2, pm2
            recs.append((amr, pm, maps))
        out[tag] = recs
    return out


def test_amr_init_matches_reference(events):
    (ja, jp, _), (ta, tp, _) = events["jax"][0], events["port"][0]
    same_poly(jp, tp)
    assert ja.cells == ta.cells and ja.base_n == ta.base_n == (16, 16, 1)
    assert np.array_equal(ja.bb_min, ta.bb_min)
    assert np.array_equal(ja.bb_max, ta.bb_max)
    assert ja.two_d and ta.two_d and ja.side_patches == ta.side_patches


@pytest.mark.parametrize("event", [1, 2])
def test_adapt_and_remap_match_reference(events, event):
    (ja, jp, jm), (ta, tp, tm) = events["jax"][event], events["port"][event]
    assert ja.cells == ta.cells
    same_poly(jp, tp)
    for a, b in zip(jm[:4], tm[:4]):
        assert np.array_equal(a, b)
    # the remap conserves the integrals (tests/test_amr.py)
    f2, U2, f, U, pm = tm[2], tm[3], tm[4], tm[5], tm[6]
    assert abs((f2 * tp.v).sum() - (f * pm.v).sum()) < 1e-12
    assert np.abs((U2 * tp.v[:, None]).sum(0)
                  - (U * pm.v[:, None]).sum(0)).max() < 1e-12


def test_events_refine_then_unrefine(events):
    n = [pm.n_cells for _, pm, _ in events["port"]]
    levels = [max(c[0] for c in amr.cells) for amr, _, _ in events["port"]]
    assert n[0] == 256 and n[1] > n[0] and levels == [0, 1, 1]
    # the second band unrefines where the first was
    second = events["port"][2][0]
    lv1 = {c for c in second.cells if c[0] == 1}
    first = {c for c in events["port"][1][0].cells if c[0] == 1}
    assert first - lv1 and lv1 - first


def test_balance_2to1_matches_reference():
    from foamtpu.mesh import refine as jrefine

    leaves = {(0, i, j, 0) for i in range(4) for j in range(4)} - {(0, 1, 1,
                                                                   0)}
    leaves |= {(1, i, j, 0) for i in (2, 3) for j in (2, 3)} - {(1, 3, 3, 0)}
    leaves |= {(2, i, j, 0) for i in (6, 7) for j in (6, 7)}
    a = jrefine.balance_2to1(set(leaves), True)
    b = trefine.balance_2to1(set(leaves), True)
    assert a == b and a != leaves


@pytest.fixture(scope="module")
def amr_run():
    return parity("slice16", STEPS, ["damBreakWithObstacle"], timeout=600)


def test_interdym_amr_matches_reference_f64(amr_run):
    rec = amr_run["damBreakWithObstacle"]
    assert rec["time"][0] == rec["time"][1] == STEPS
    assert rec["fields"][0] == rec["fields"][1]
    for name, e in rec["errs"].items():
        assert e["ok"], (name, e)
    assert rec["other_lines"][0] == rec["other_lines"][1]
    assert rec["other_numbers_ok"]
    for sub, f in rec["files"].items():
        assert f["names"][0] == f["names"][1]
        assert all(e <= 1e-9 for e in f["scaled"].values()), (sub, f)


def test_interdym_amr_adapts_every_interval(amr_run):
    lines = amr_run["damBreakWithObstacle"]["other_lines"][0]
    assert lines.count("Refined mesh: # cells") == STEPS // 2


def test_interdym_amr_oracles_port(tmp_path):
    d = chip_smoke.slice16_case(REPO, str(tmp_path / "dam"),
                                "damBreakWithObstacle", tcli)
    c = TCase(d, device="cpu")
    pm0 = c.poly_mesh
    a0 = c.read_field("alpha1").data.double().numpy()
    m0 = float((a0 * pm0.v).sum())
    with contextlib.redirect_stdout(io.StringIO()):
        tapps.run(c, max_steps=10)
    st = c.final_state
    assert st["n_cells"] > pm0.n_cells
    a = st["alpha"].data.double().numpy()
    v = c.mesh.v.double().numpy()
    assert abs(float((a * v).sum()) - m0) / m0 < 0.02
    assert a.min() > -1e-3 and a.max() < 1.0 + 2.5e-3
