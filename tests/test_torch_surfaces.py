"""foamtpu_torch's sampledSurfaces (functionobjects/surfaces.py) against
the JAX package.

In process, float64 arrays in both: the two surface tests of
tests/test_sampling.py on the icoFoam cavity tutorial's mesh (a cutting
plane through the cavity and an iso-surface of the radial scalar T, U the
cell centres), plus the lid's patch surface, executed by both packages'
objects on the same fields: the same files, line for line, their numbers
(vertex positions, triangles, sampled values) at 1e-9 relative; and the
reference test's own oracles. The tables (positions, tets) equal the
reference's; the point weights at 1e-14 (the port builds them vectorised,
in another summation order).

In a float64 subprocess (tests/test_torch_ras_models.py's PARITY_BODY):
the cavity with chip_smoke.SURFACES_FUNCS (a cutting plane, an
iso-surface of |U| and the lid's patch, and a coded object) through both
packages' `run(case)` for 3 steps: every postProcessing file's numbers at
1e-9, no failures, and the sampledSurfaces object fetches each of its two
fields once per execute.

`python tests/test_torch_surfaces.py` prints the goldens of
chip_smoke.py's surfaces_coded phase (the JAX package, CPU, float32).
"""

import contextlib
import io
import os
import re
import sys

import numpy as np
import pytest
import torch

from foamtpu_torch.apps.cli import main as tcli
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.core.dictionary import parse_string as tparse
from foamtpu_torch.functionobjects import surfaces as tsurf

import chip_smoke
from test_torch_ras_models import assert_parity, parity
from test_torch_simple import REPO

torch.set_num_threads(2)

STEPS = 3
NUM = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")


@pytest.fixture(scope="module")
def run():
    return parity("surfaces", STEPS, ["cavity"])["cavity"]


def test_surfaces_run_matches_reference_f64(run):
    assert_parity(run, STEPS, "surfaces")
    names = run["files"]["postProcessing"]["names"][0]
    for t in ("0.005", "0.01", "0.015"):
        for f in ("midPlane", "uIso", "lid"):
            assert f"sampled/{t}/{f}.vtk" in names, names
    assert "maxU/0/maxU.dat" in names
    assert run["failures"] == 0 and run["executes"] == STEPS


def test_surfaces_fetch_each_field_once_per_execute(run):
    # p and U once per execute, whatever the surfaces read them for; the
    # coded object reads the state itself
    assert run["fetches"] == {"sampled": 2 * STEPS, "maxU": 0}


@pytest.fixture(scope="module")
def cavity(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("surf") / "cavity")
    import shutil

    shutil.copytree(os.path.join(REPO, "tutorials", "incompressible",
                                 "icoFoam", "cavity"), d)
    with contextlib.redirect_stdout(io.StringIO()):
        assert tcli(["blockMesh", "-case", d]) == 0
    return d


SPEC = """
type surfaces;
fields (T U);
surfaces
(
    midPlane
    {
        type cuttingPlane;
        pointAndNormalDict
        { basePoint (0.05 0.05 0.005); normalVector (1 0 0); }
    }
    ring
    {
        type isoSurface;
        isoField T;
        isoValue 0.03;
    }
    lid { type patch; patches (movingWall); }
);
"""
FILES = ("midPlane.vtk", "ring.vtk", "lid.vtk")


def analytic_state(c, to):
    """tests/test_sampling.py's fields: T the distance from the cavity's
    axis, U the cell centre; `to` makes each package's array."""
    T = np.linalg.norm(c[:, :2] - 0.05, axis=1)
    return {"T": to(T), "U": type("F", (), {"data": to(c)})()}


def _execute(case, cls, parse, to, name="sampled"):
    fo = cls(name, parse(SPEC), case)
    fo.execute("0.1", analytic_state(np.asarray(case.poly_mesh.c), to))
    base = os.path.join(case.dir, "postProcessing", name, "0.1")
    return fo, {f: open(os.path.join(base, f)).read() for f in FILES}


parse_vtk = chip_smoke.parse_vtk_surface


def test_surfaces_match_reference_f64(cavity, tmp_path):
    from foamtpu.core.case import Case as JCase
    from foamtpu.core.dictionary import parse_string as jparse
    from foamtpu.functionobjects.surfaces import SampledSurfaces as JS

    import shutil

    jd = str(tmp_path / "ref")
    shutil.copytree(cavity, jd)
    tc, jc = TCase(cavity, device="cpu"), JCase(jd)
    tfo, got = _execute(tc, tsurf.SampledSurfaces, tparse, torch.tensor)
    _, ref = _execute(jc, JS, jparse, lambda a: a)
    for f in FILES:
        g, r = got[f].split("\n"), ref[f].split("\n")
        assert len(g) == len(r), f
        # the same words on every line, and the same numbers at 1e-9
        assert [NUM.sub("#", x) for x in g] == [NUM.sub("#", x) for x in r]
        gn = np.array([float(x) for x in NUM.findall(got[f])])
        rn = np.array([float(x) for x in NUM.findall(ref[f])])
        np.testing.assert_allclose(gn, rn, rtol=1e-9, atol=1e-15,
                                   err_msg=f)
    assert tfo.fetches == 2      # T and U, once each


def test_surfaces_tables_match_reference(cavity):
    from foamtpu.core.case import Case as JCase
    from foamtpu.functionobjects.surfaces import _build_tables as jbuild

    pm_t, pm_j = TCase(cavity, device="cpu").poly_mesh, JCase(
        cavity).poly_mesh
    pos_t, tets_t, (rows_t, cols_t, w_t) = tsurf._build_tables(pm_t)
    pos_j, tets_j, (rows_j, cols_j, w_j) = jbuild(pm_j)
    assert np.array_equal(pos_t, pos_j)
    assert np.array_equal(tets_t, tets_j)
    # the same (point, cell) pairs, the port's sorted by cell
    order = np.lexsort((cols_j, rows_j))
    assert np.array_equal(rows_t, rows_j[order])
    assert np.array_equal(cols_t, cols_j[order])
    np.testing.assert_allclose(w_t, w_j[order], rtol=1e-14)


def test_surfaces_meet_the_reference_tests_oracles(cavity):
    """tests/test_sampling.py's checks: the plane's vertices at x = 0.05
    spanning the cavity, the ring's near r = 0.03; 20 lid faces give 40
    triangles of 80 points with U and p."""
    _, files = _execute(TCase(cavity, device="cpu"), tsurf.SampledSurfaces,
                        tparse, torch.tensor, name="oracles")
    pts, _, _ = parse_vtk(files["midPlane.vtk"])
    assert pts.shape[0] > 0
    assert np.allclose(pts[:, 0], 0.05, atol=1e-8)
    assert pts[:, 1].min() < 0.01 and pts[:, 1].max() > 0.09
    pts, _, vals = parse_vtk(files["ring.vtk"])
    r = np.linalg.norm(pts[:, :2] - 0.05, axis=1)
    assert np.abs(r - 0.03).max() < 0.01 and np.abs(r - 0.03).mean() < 0.003
    np.testing.assert_allclose(vals["T"], 0.03, rtol=1e-9)
    pts, tris, vals = parse_vtk(files["lid.vtk"])
    assert (pts.shape[0], tris.shape[0]) == (80, 40)
    assert set(vals) == {"T", "U"}


def test_surface_types_are_registered():
    from foamtpu_torch.functionobjects import base

    for t in ("surfaces", "sampledSurfaces"):
        assert base._TYPES[t] is tsurf.SampledSurfaces


# ---------------------------------------------------------------------------
# the goldens of chip_smoke.py's surfaces_coded phase
# ---------------------------------------------------------------------------


def reference_surfaces_coded(root):
    """The JAX package on the CPU in float32: the cavity with
    SURFACES_FUNCS through run_case for SURFACES_STEPS steps, the
    summaries (chip_smoke.surface_summary) of its last surfaces and its
    coded rows; and the analytic-state surfaces of SPEC."""
    import shutil

    from foamtpu.apps.cli import main as jcli
    from foamtpu.core.case import Case as JCase
    from foamtpu.core.case import run_case as jrun
    from foamtpu.core.dictionary import parse_string as jparse
    from foamtpu.functionobjects.surfaces import SampledSurfaces as JS

    d = chip_smoke.surfaces_case(REPO, os.path.join(root, "run"), jcli)
    with contextlib.redirect_stdout(io.StringIO()):
        case = jrun(d, max_steps=chip_smoke.SURFACES_STEPS)
    out = {"run": chip_smoke.surfaces_run_summary(d, case.time.name)}
    jd = os.path.join(root, "analytic")
    shutil.copytree(d, jd)
    _, files = _execute(JCase(jd), JS, jparse, lambda a: np.asarray(
        a, dtype=np.float32))
    out["analytic"] = {f[:-4]: chip_smoke.surface_summary(t)
                       for f, t in files.items()}
    return out


if __name__ == "__main__":
    import tempfile

    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.stdout.write(repr(reference_surfaces_coded(tempfile.mkdtemp()))
                     + "\n")
