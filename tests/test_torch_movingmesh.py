"""foamtpu_torch's moving meshes (mesh/moving.py, solvers/pimpledym.py,
interDyMFoam) against the JAX package.

One float64 subprocess (FOAMTPU_X64=1 JAX_ENABLE_X64=1):
- both packages' `run(case)` for 3 steps of pimpleDyMFoam's oscillatingBox
  tutorial and of interDyMFoam on the damBreak tutorial with an
  oscillatingLinearMotion dynamicMeshDict (chip_smoke.interdym_case):
  fields at rtol 1e-9, equal iteration counts, the same log lines and
  written fields (tests/test_torch_ras_models.py's PARITY_BODY);
- `update_geometry` on seeded moved points of the graded 12x12 cavity of
  tests/test_movingmesh.py and of a 3x2x2 tet box (whose COO remainder
  carries `fb_*` coefficients) against the reference's, and against the
  port's own host geometry (`PolyMesh.update_geometry` + `to_device`) of
  the moved polyMesh: every geometric FvMesh array within 1e-12 of its
  scale. The bound is not 0 ulp: the segment sums are `index_add_`, whose
  order the card does not fix, and the host's face centres divide by 3
  at another point. `wall_y` is held on the wall cells: off them the
  reference's `update_geometry` writes 0 where the host writes 1 (its mask
  `wall_cnt > 0` passes every cell, as `to_device` clamps the count to 1),
  and the port mirrors it;
- the three motion functions (points and mesh velocity) and `mesh_flux`
  against the reference's at 1e-14.
In process, float32: the Galilean-invariance oracle of
tests/test_movingmesh.py (the cavity on a uniformly translating mesh
gives the static cavity's relative velocity).
"""

import numpy as np
import pytest
import torch

from foamtpu_torch.bc import patchfields as pf
from foamtpu_torch.core.dictionary import parse_string as tparse
from foamtpu_torch.core.dimensions import DimensionSet, dimVelocity
from foamtpu_torch.core.fields import vol_scalar, vol_vector
from foamtpu_torch.mesh import blockmesh, moving, to_device
from foamtpu_torch.solvers import apps as tapps
from foamtpu_torch.solvers import pimpledym, piso

from test_torch_ras_models import assert_parity, parity
from test_torch_simple import REPO

torch.set_num_threads(2)

STEPS = 3

CAVITY = """
convertToMeters 0.1;
vertices
(
    (0 0 0) (1 0 0) (1 1 0) (0 1 0)
    (0 0 0.1) (1 0 0.1) (1 1 0.1) (0 1 0.1)
);
blocks ( hex (0 1 2 3 4 5 6 7) (12 12 1) simpleGrading (1.5 1 1) );
boundary
(
    movingWall { type wall; faces ((3 7 6 2)); }
    fixedWalls { type wall; faces ((0 4 7 3) (2 6 5 1) (1 5 4 0)); }
    frontAndBack { type empty; faces ((0 3 2 1) (4 5 6 7)); }
);
"""

GEOMETRY = ("sf", "mag_sf", "cf", "c", "v", "weights", "delta_coeffs",
            "non_orth_delta_coeffs", "correction_vecs", "st_wself",
            "st_magsf", "st_dc", "st_nodc", "st_sf", "st_corr", "fb_wself",
            "fb_magsf", "fb_dc", "fb_nodc", "fb_sf", "fb_corr", "wall_y",
            "ab_sf")

GEOM_TAIL = r'''
# -- update_geometry and the motion functions, after the runs ---------------
import jax.numpy as jnp
from foamtpu.core.dictionary import parse_string as jparse
from foamtpu.mesh import blockmesh as jbm, moving as jmov, to_device as jto
from foamtpu.mesh.tetmesh import tet_box as jtet
from foamtpu_torch.core.dictionary import parse_string as tparse
from foamtpu_torch.mesh import blockmesh as tbm, moving as tmov
from foamtpu_torch.mesh import to_device as tto
from foamtpu_torch.mesh.tetmesh import tet_box as ttet

CAVITY, GEOMETRY = @CAVITY@, @GEOMETRY@


def rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    if a.shape != b.shape:
        return float("inf")
    if b.size == 0:
        return 0.0
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


geom = {}
for tag, (pm_j, pm_t) in {
        "cavity": (jbm.generate(jparse(CAVITY)), tbm.generate(tparse(CAVITY))),
        "tets": (jtet(3, 2, 2), ttet(3, 2, 2))}.items():
    mj, mt = jto(pm_j), tto(pm_t, "cpu")
    rng = np.random.default_rng(0)
    pts = pm_t.points + 0.002 * rng.standard_normal(pm_t.points.shape)
    if tag == "cavity":
        pts[:, 2] = pm_t.points[:, 2]   # keep the 2D extrusion planar
    gj = jmov.update_geometry(mj, jnp.asarray(pts),
                              jmov.topo_from_poly(pm_j, mj.v.dtype))
    gt = tmov.update_geometry(mt, torch.tensor(pts),
                              tmov.topo_from_poly(pm_t, torch.float64, "cpu"))
    pm_t.points = pts
    pm_t.update_geometry()
    mh = tto(pm_t, "cpu")
    # wall_y off the walls: the host writes 1, update_geometry 0 (the
    # reference's; FvMesh.wall_cnt is clamped to >= 1, so its mask passes
    # every cell): held apart, on the wall cells alone
    wall = mt.wall_mask.numpy() > 0
    interior_y = [float(np.abs(gt.wall_y.numpy()[~wall]).max()),
                  float(np.abs(np.asarray(gj.wall_y)[~wall]).max()),
                  float(mh.wall_y.numpy()[~wall].min())]
    geom[tag] = {
        "interior_wall_y": interior_y,
        "wall_y_on_walls": rel(gt.wall_y.numpy()[wall],
                               mh.wall_y.numpy()[wall]),
        "n_fb": int(mt.fb_cells.shape[0]),
        "layout_kept": gt.fb_layout is mt.fb_layout,
        "moved": rel(gt.v, mt.v),
        "ref": {f: rel(getattr(gt, f).numpy(), getattr(gj, f))
                for f in GEOMETRY},
        "host": {f: rel(getattr(gt, f).numpy(), getattr(mh, f).numpy())
                 for f in GEOMETRY if f != "wall_y"}}

p0 = np.random.default_rng(1).standard_normal((50, 3))
motions = {}
for name, args in (("linear_motion", ((1.0, 2.0, 0.0),)),
                   ("oscillating_linear_motion", ((0.005, 0.001, 0.0), 31.4)),
                   ("rotating_motion", ((0.05, 0.05, 0.0), (0.0, 0.2, 1.0),
                                        2.0))):
    jp, ju = getattr(jmov, name)(*args)
    tp, tu = getattr(tmov, name)(*args)
    t = 0.3
    motions[name] = {
        "pts": rel(tp(torch.tensor(p0), torch.tensor(t, dtype=torch.float64)
                      ).numpy(),
                   jp(jnp.asarray(p0), jnp.asarray(t))),
        "umesh": rel(tu(torch.tensor(p0), t).numpy(),
                     ju(jnp.asarray(p0), t))}
pm_j, pm_t = jbm.generate(jparse(CAVITY)), tbm.generate(tparse(CAVITY))
_, ju = jmov.rotating_motion((0.05, 0.05, 0.0), (0, 0, 1), 2.0)
_, tu = tmov.rotating_motion((0.05, 0.05, 0.0), (0, 0, 1), 2.0)
motions["mesh_flux"] = {"phi": rel(
    tmov.mesh_flux(tto(pm_t, "cpu"), tu, 0.1).numpy(),
    jmov.mesh_flux(jto(pm_j), ju, 0.1))}
print(json.dumps({"geometry": geom, "motions": motions}))
'''


@pytest.fixture(scope="module")
def runs():
    tail = GEOM_TAIL.replace("@CAVITY@", repr(CAVITY)).replace(
        "@GEOMETRY@", repr(GEOMETRY))
    recs = parity("box", STEPS, ["box:box", "interdym:dam"], tail=tail,
                  lines=2)
    return recs[0], recs[1]


@pytest.mark.parametrize("name", ["box", "dam"])
def test_moving_mesh_run_matches_reference_f64(runs, name):
    rec = runs[0][name]
    assert_parity(rec, STEPS, name)
    fields = {"box": {"U", "p", "phi"},
              "dam": {"U", "p_rgh", "alpha", "phi"}}[name]
    assert set(rec["errs"]) == fields
    names = [n for n, _ in rec["solves"][0]]
    assert names.count("p" if name == "box" else "p_rgh") == STEPS


@pytest.mark.parametrize("mesh", ["cavity", "tets"])
def test_update_geometry_matches_reference_and_host_f64(runs, mesh):
    rec = runs[1]["geometry"][mesh]
    assert rec["moved"] > 1e-6            # the points did move the cells
    assert rec["layout_kept"]             # topology tables carried over
    if mesh == "tets":
        assert rec["n_fb"] > 0            # the remainder's fb_* re-gathered
    for what in ("ref", "host"):
        bad = {f: e for f, e in rec[what].items() if not e <= 1e-12}
        assert not bad, (mesh, what, bad)
    assert rec["wall_y_on_walls"] <= 1e-12
    # mirrored from the reference (ROADMAP Queue 3): 0 off the walls after
    # a move, where the host's tables hold 1
    assert rec["interior_wall_y"] == [0.0, 0.0, 1.0]


@pytest.mark.parametrize("fn", ["linear_motion", "oscillating_linear_motion",
                                "rotating_motion", "mesh_flux"])
def test_motion_functions_match_reference_f64(runs, fn):
    rec = runs[1]["motions"][fn]
    assert all(e <= 1e-14 for e in rec.values()), rec


def test_moving_mesh_applications_are_registered():
    assert tapps.APPLICATIONS["pimpleDyMFoam"] is tapps.pimple_dym_foam
    assert "interDyMFoam" in tapps.APPLICATIONS


def _cavity(frame):
    pm = blockmesh.generate(tparse(CAVITY))
    mesh = to_device(pm, "cpu")
    frame_t = torch.tensor(frame, dtype=mesh.v.dtype)
    ub, pb = [], []
    for patch in mesh.patches:
        if patch.type == "empty":
            ub.append(pf.PatchField(kind="empty", vfrac=0.0))
            pb.append(pf.PatchField(kind="empty", vfrac=0.0))
        elif patch.name == "movingWall":
            ub.append(pf.fixed_value(frame_t + torch.tensor(
                [1.0, 0.0, 0.0], dtype=mesh.v.dtype)))
            pb.append(pf.zero_gradient())
        else:
            ub.append(pf.fixed_value(frame_t))
            pb.append(pf.zero_gradient())
    U = vol_vector(mesh, frame_t, name="U", dims=dimVelocity, bcs=tuple(ub))
    p = vol_scalar(mesh, 0.0, name="p", dims=DimensionSet.of(0, 2, -2),
                   bcs=tuple(pb))
    return pm, mesh, U, p


def test_translating_cavity_galilean_invariance_f32():
    """The lid-driven cavity on a mesh translating at V0 (walls carried
    along, relative fluxes) gives the static cavity's velocity relative
    to the frame (tests/test_movingmesh.py, 40 steps, within 0.02 of the
    lid speed 1)."""
    V0 = np.array([0.7, 0.3, 0.0])
    _, mesh_s, U_s, p_s = _cavity(np.zeros(3))
    st_s = piso.initial_state(mesh_s, U_s, p_s, project=False)
    step_s = piso.make_step(mesh_s, piso.PisoConfig(nu=0.01,
                                                    n_correctors=2))
    pm_m, mesh_m, U_m, p_m = _cavity(V0)
    pts_fn, umesh_fn = moving.linear_motion(V0)
    cfg = pimpledym.DyMConfig(nu=0.01, n_correctors=2, pts_fn=pts_fn,
                              umesh_fn=umesh_fn)
    st_m = pimpledym.initial_state(pm_m, mesh_m, U_m, p_m, umesh_fn=umesh_fn)
    step_m = pimpledym.make_step(mesh_m, cfg)
    for _ in range(40):
        st_s, _ = step_s(st_s, 0.002)
        st_m, _ = step_m(st_m, 0.002)
    assert mesh_m.v.dtype == torch.float32
    u_rel = st_m["U"].data.numpy() - V0
    assert np.isfinite(u_rel).all()
    assert np.abs(u_rel - st_s["U"].data.numpy()).max() < 0.02
    assert float(st_m["t"]) > 0.0
    # the mesh moved by V0 t
    moved = st_m["points"] - st_m["points0"]
    np.testing.assert_allclose(moved.numpy(), np.broadcast_to(
        V0 * float(st_m["t"]), moved.shape), atol=1e-6)


# ---------------------------------------------------------------------------
# the goldens of chip_smoke.py's dym phase
# ---------------------------------------------------------------------------


def reference_dym(root):
    """The JAX package on the CPU in float32: oscillatingBox for
    chip_smoke.BOX_STEPS steps and interDyMFoam's damBreak for
    chip_smoke.DAM_DYM_STEPS, through run_case; their golden scalars."""
    import contextlib
    import io
    import os

    from foamtpu.apps.cli import main as jcli
    from foamtpu.core.case import run_case as jrun

    import chip_smoke as cs

    out = {}
    d = cs.box_case(REPO, os.path.join(root, "box"), jcli)
    with contextlib.redirect_stdout(io.StringIO()):
        case = jrun(d, max_steps=cs.BOX_STEPS)
    st = case.final_state
    out["box"] = cs.box_scalars(np.asarray(case.mesh.v),
                                np.asarray(st["U"].data),
                                np.asarray(st["p"].data))
    d = cs.interdym_case(REPO, os.path.join(root, "dam"), jcli)
    with contextlib.redirect_stdout(io.StringIO()):
        case = jrun(d, max_steps=cs.DAM_DYM_STEPS)
    st = case.final_state
    out["dam"] = cs.dambreak_scalars(np.asarray(case.mesh.v),
                                     np.asarray(st["alpha"].data),
                                     np.asarray(st["U"].data),
                                     np.asarray(st["p_rgh"].data))
    return out


def box_big_trajectory(root, n=1024, steps=5):
    """oscillatingBox at n^2 with chip_smoke's dym_headline controls
    (bench.py's GAMG p, deltaT scaled to the shipped Courant number) in
    both packages on the CPU: max |U|, the Courant number, continuity and
    the p iterations after each step (minutes at 1024^2)."""
    import os
    import shutil

    import jax.numpy as jnp
    from foamtpu.core.case import Case as JCase
    from foamtpu.core.dictionary import dimensioned_scalar as jdim
    from foamtpu.core.dictionary import parse_file as jparse_file
    from foamtpu.mesh import blockmesh as jbm
    from foamtpu.solvers import apps as japps
    from foamtpu.solvers import pimpledym as jdym
    from foamtpu.solvers.linear.gamg import GAMG as JGAMG
    from foamtpu_torch.core.case import Case as TCase
    from foamtpu_torch.core.dictionary import dimensioned_scalar as tdim
    from foamtpu_torch.solvers.linear.gamg import GAMG as TGAMG

    import chip_smoke as cs

    dst = os.path.join(root, "box")
    shutil.copytree(os.path.join(REPO, cs.BOX_CASE), dst)
    path = os.path.join(dst, "system", "blockMeshDict")
    text = open(path).read()
    open(path, "w").write(text.replace("(20 20 1)", f"({n} {n} 1)"))
    out = {}
    for tag, (case, dym, dim, gamg, apps_, arr) in {
            "port": (cs.memory_mesh(TCase(dst, device="cpu")), pimpledym,
                     tdim, TGAMG, tapps, torch.as_tensor),
            "ref": (JCase(dst), jdym, jdim, JGAMG, japps,
                    jnp.asarray)}.items():
        if tag == "ref":
            case._poly = jbm.generate(jparse_file(path))
        mesh = case.mesh
        pts_fn, umesh_fn = apps_._dym_motion(case)
        _, nu = dim(case.transport_properties()["nu"])
        cfg = dym.DyMConfig(
            nu=nu, pts_fn=pts_fn, umesh_fn=umesh_fn, n_correctors=2,
            div_scheme=case.div_scheme("div(phi,U)"),
            p_controls={"solver": "GAMG", "preconditioner": "polynomial",
                        "tolerance": 1e-7, "relTol": 0.01, "maxIter": 1000,
                        "_gamg": gamg(mesh)},
            u_controls=case.solver_controls("U"))
        st = dym.initial_state(case.poly_mesh, mesh, case.read_field("U"),
                               case.read_field("p"), umesh_fn)
        step = dym.make_step(mesh, cfg)
        rows = []
        for _ in range(steps):
            st, d = step(st, arr(0.002 * 20 / n))
            u = np.asarray(st["U"].data)
            rows.append([float(np.linalg.norm(u, axis=1).max()),
                         float(d["courant_max"]), float(d["continuity"]),
                         int(d["p_iters"])])
        out[tag] = rows
    return out


if __name__ == "__main__":
    import sys
    import tempfile

    import jax

    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:] == ["box_big"]:
        sys.stdout.write(repr(box_big_trajectory(tempfile.mkdtemp())) + "\n")
    else:
        sys.stdout.write(repr(reference_dym(tempfile.mkdtemp())) + "\n")
