"""foamtpu_torch simpleFoam slice (pitzDaily) against the JAX package.

- Case + read_field on the unmodified tutorial: the port's blockMesh
  writes the same polyMesh, its reader and Case give the same mesh,
  field arrays and BC data as the JAX package's, bit for bit (both parse
  the same decimal text into float64 and round once).
- Unit parity on the pitzDaily mesh (graded, five blocks, non-orthogonal,
  with a COO fallback) with the tutorial's BCs and seeded random fields:
  `schemes.weights`/`weights_slot` (linear, upwind, limitedLinear 1,
  limitedLinearV 1), the corrected `fvm.laplacian` (scalar and vector,
  limit 1 and 0.5), `FvMatrix.relax`, `set_values`, the fvm sources and
  the inletOutlet update. float32 at rtol 1e-5 and atol 1e-6 * max|ref|
  (the same expressions, summed in a different order; see
  test_torch_ops.py).
- float64 parity (subprocess with FOAMTPU_X64=1 JAX_ENABLE_X64=1): 3
  SIMPLE + kEpsilon iterations of the full 4160-cell tutorial through
  both packages from one state, with the reference's GAMG levels. The
  start state is the tutorial's with k and epsilon scaled cell by cell by
  1 + 0.2*u (u uniform in [0, 1), seed 0): on the tutorial's exactly
  uniform k and epsilon the limiter's r = ud/(+-1e-30) takes the sign of
  round-off, so the reference's own jitted and eager runs differ by ~10%
  on the first iteration. U, p, phi, k, epsilon and nut agree to rtol
  1e-9 (atol 1e-9 of each field's scale), and every linear solve (U, p,
  epsilon, k) takes the same number of iterations.
"""

import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foamtpu.core.case import Case as JCase
from foamtpu.core.dimensions import dimViscosity
from foamtpu.ops import fvm as jfvm
from foamtpu.ops import schemes as jschemes
from foamtpu.ops import slot as jslot

from foamtpu_torch.apps.cli import main as tcli
from foamtpu_torch.convert import (field_from_numpy, matrix_from_numpy,
                                   mesh_from_numpy)
from foamtpu_torch.core import dimensions as tdims
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.ops import fvm, schemes, slot

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PITZ = os.path.join(REPO, "tutorials", "incompressible", "simpleFoam",
                    "pitzDaily")
FIELDS = ("U", "p", "k", "epsilon", "nut")


def pitz_case(root):
    """A copy of the tutorial under `root`, meshed by the port's
    blockMesh; returns its directory."""
    dst = os.path.join(str(root), "pitzDaily")
    shutil.copytree(PITZ, dst)
    assert tcli(["blockMesh", "-case", dst]) == 0
    return dst


def random_fields(jc, seed=7):
    """The tutorial's fields (reference objects) with seeded random
    internal values: U ~ N(0, 3), p ~ N(0, 1), k and epsilon positive,
    nut small and positive; and a random face flux."""
    jm = jc.mesh
    rng = np.random.default_rng(seed)
    n = jm.n_cells

    def f32(a):
        return jnp.asarray(a, jnp.float32)

    out = {
        "U": jc.read_field("U").with_data(
            f32(3.0 * rng.standard_normal((n, 3)))),
        "p": jc.read_field("p").with_data(f32(rng.standard_normal(n))),
        "k": jc.read_field("k").with_data(f32(0.1 + rng.random(n))),
        "epsilon": jc.read_field("epsilon").with_data(
            f32(1.0 + 10.0 * rng.random(n))),
        "nut": jc.read_field("nut").with_data(f32(1e-4 * rng.random(n))),
    }
    phi = (rng.standard_normal(jm.n_faces) * 1e-4
           * np.asarray(jm.face_active)).astype(np.float32)
    return out, phi


@pytest.fixture(scope="module")
def pitz(tmp_path_factory):
    dst = pitz_case(tmp_path_factory.mktemp("pitz"))
    jc = JCase(dst)
    jm = jc.mesh
    tm = mesh_from_numpy(jm, device="cpu")
    jf, phi = random_fields(jc)
    tf = {k: field_from_numpy(v, device="cpu") for k, v in jf.items()}
    return dict(dir=dst, jc=jc, jm=jm, tm=tm, jf=jf, tf=tf, phi=phi)


def close(got, ref, what="", rtol=1e-5, atol_rel=1e-6):
    if isinstance(got, (tuple, list)):
        assert len(got) == len(ref), what
        for i, (g, r) in enumerate(zip(got, ref)):
            close(g, r, f"{what}[{i}]", rtol, atol_rel)
        return
    if got is None or ref is None:
        assert got is None and ref is None, what
        return
    g = got.detach().cpu().numpy() if torch.is_tensor(got) else \
        np.asarray(got)
    r = np.asarray(ref)
    assert g.shape == r.shape, (what, g.shape, r.shape)
    scale = float(np.max(np.abs(r))) if r.size else 0.0
    np.testing.assert_allclose(g, r, rtol=rtol, atol=atol_rel * scale + 1e-30,
                               err_msg=what)


MATRIX_FIELDS = ("diag", "lower", "upper", "source", "ic", "bc", "soff",
                 "sfb", "fcorr")


def close_matrix(got, ref, what):
    for name in MATRIX_FIELDS:
        close(getattr(got, name), getattr(ref, name), f"{what}.{name}")
    assert got.symmetric == ref.symmetric, what
    assert got.dims.exponents() == ref.dims.exponents(), what


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


# ---------------------------------------------------------------------------
# Case, mesh and field reading
# ---------------------------------------------------------------------------


def test_block_mesh_writes_the_reference_polymesh(pitz, tmp_path):
    """The port's blockMesh writes the mesh the JAX package's writes
    (the text may differ in number formatting), and either package's
    reader gives the same PolyMesh from either package's files."""
    from foamtpu.apps.cli import main as jcli
    from foamtpu.io import polymesh as jpoly
    from foamtpu_torch.io import polymesh as tpoly

    ref = os.path.join(str(tmp_path), "ref")
    shutil.copytree(PITZ, ref)
    assert jcli(["blockMesh", "-case", ref]) == 0
    port_dir = os.path.join(pitz["dir"], "constant", "polyMesh")
    ref_dir = os.path.join(ref, "constant", "polyMesh")
    jref = jpoly.read(ref_dir)
    for pm in (tpoly.read(port_dir), tpoly.read(ref_dir),
               pitz["jc"].poly_mesh):
        for name in ("points", "face_pts", "face_npts", "owner",
                     "neighbour", "cf", "sf", "c", "v", "weights",
                     "delta_coeffs", "non_orth_delta_coeffs",
                     "correction_vecs"):
            np.testing.assert_array_equal(np.asarray(getattr(pm, name)),
                                          np.asarray(getattr(jref, name)),
                                          name)
        assert [(p.name, p.type, p.start, p.size) for p in pm.patches] == \
            [(p.name, p.type, p.start, p.size) for p in jref.patches]


def test_case_reads_the_tutorial_like_the_reference(pitz):
    jc, tc = pitz["jc"], TCase(pitz["dir"], device="cpu")
    jm, tm = jc.mesh, tc.mesh
    assert tm.n_cells == jm.n_cells == 4160
    assert tm.n_faces == 16780 and not tm.orthogonal
    assert tuple(tm.st_deltas) == tuple(int(d) for d in jm.st_deltas)
    for name in ("v", "c", "sf", "weights", "non_orth_delta_coeffs",
                 "st_corr", "fb_cells", "wall_mask", "wall_y"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)), name)
    for name in FIELDS:
        jf, tf = jc.read_field(name), tc.read_field(name)
        np.testing.assert_array_equal(tf.data.numpy(), np.asarray(jf.data),
                                      name)
        assert tf.dims.exponents() == jf.dims.exponents(), name
        assert [b.kind for b in tf.bcs] == [b.kind for b in jf.bcs], name
        for tb, jb in zip(tf.bcs, jf.bcs):
            for attr in ("ref_value", "ref_grad", "vfrac"):
                np.testing.assert_array_equal(
                    getattr(tb, attr).numpy(), np.asarray(getattr(jb, attr)),
                    f"{name}.{tb.kind}.{attr}")
    assert tc.div_scheme("div(phi,U)") == jc.div_scheme("div(phi,U)") \
        == "limitedLinearV 1"
    assert tc.div_scheme("div(phi,k)") == "limitedLinear 1"
    assert tc.laplacian_corrected() and tc.corr_limit() == 1.0
    assert tc.grad_scheme("grad(p)") == jc.grad_scheme("grad(p)")
    tp, jp = tc.solver_controls("p"), jc.solver_controls("p")
    assert tp["_gamg"].smoother == jp["_gamg"].smoother == "Jacobi"
    assert (tp["_gamg"].n_pre, tp["_gamg"].n_post) == (4, 4)
    assert {k: v for k, v in tp.items() if k != "_gamg"} == \
        {k: v for k, v in jp.items() if k != "_gamg"}


# ---------------------------------------------------------------------------
# Unit parity on the pitzDaily mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("field", ["k", "U"])
@pytest.mark.parametrize("scheme", ["linear", "upwind", "limitedLinear 1",
                                    "limitedLinearV 1"])
def test_scheme_weights(pitz, scheme, field):
    jm, tm, phi = pitz["jm"], pitz["tm"], pitz["phi"]
    jfield, tfield = pitz["jf"][field], pitz["tf"][field]
    phi_j, phi_t = jnp.asarray(phi), _t(phi)
    close(schemes.weights_slot(tm, slot.from_flat(tm, phi_t), scheme, tfield),
          jschemes.weights_slot(jm, jslot.from_flat(jm, phi_j), scheme,
                                jfield), f"weights_slot {scheme}")
    close(schemes.weights(tm, phi_t, scheme, tfield),
          jschemes.weights(jm, phi_j, scheme, jfield), f"weights {scheme}")


@pytest.mark.parametrize("limit", [1.0, 0.5])
@pytest.mark.parametrize("field", ["k", "U"])
def test_corrected_laplacian(pitz, field, limit):
    """Non-deferred corrected laplacian with a slot-form diffusivity:
    matrix, source (the explicit correction) and the stashed fcorr."""
    jm, tm = pitz["jm"], pitz["tm"]
    jfield, tfield = pitz["jf"][field], pitz["tf"][field]
    gamma = (1e-5 + 1e-4 * np.random.default_rng(1).random(jm.n_faces)
             ).astype(np.float32)
    g_j, g_t = jnp.asarray(gamma), _t(gamma)
    tM = fvm.laplacian(tm, g_t, tfield, corrected=True,
                       gamma_dims=tdims.dimViscosity, limit=limit,
                       gamma_slot=slot.from_flat(tm, g_t))
    jM = jfvm.laplacian(jm, g_j, jfield, corrected=True,
                        gamma_dims=dimViscosity, limit=limit,
                        gamma_slot=jslot.from_flat(jm, g_j))
    assert tM.fcorr is not None
    close_matrix(tM, jM, f"laplacian {field} limit={limit}")
    if field == "k":    # FvMatrix.flux is the scalar (pEqn) operator
        close(tM.flux(tm, tfield.data), jM.flux(jm, jfield.data),
              "flux with fcorr")


def _transport(pitz, field):
    """div(phi, psi) - laplacian(gamma, psi) with limitedLinear weights,
    as the turbulence and momentum equations assemble it."""
    jm, tm, phi = pitz["jm"], pitz["tm"], pitz["phi"]
    jfield, tfield = pitz["jf"][field], pitz["tf"][field]
    phi_j, phi_t = jnp.asarray(phi), _t(phi)
    ps_j, ps_t = jslot.from_flat(jm, phi_j), slot.from_flat(tm, phi_t)
    gamma = (1e-5 * (1.0 + np.random.default_rng(2).random(jm.n_faces))
             ).astype(np.float32)
    g_j, g_t = jnp.asarray(gamma), _t(gamma)
    jM = (jfvm.div(jm, phi_j, jfield, phi_slot=ps_j,
                   slot_weights=jschemes.weights_slot(
                       jm, ps_j, "limitedLinear 1", jfield))
          - jfvm.laplacian(jm, g_j, jfield, corrected=True,
                           gamma_dims=dimViscosity,
                           gamma_slot=jslot.from_flat(jm, g_j)))
    tM = (fvm.div(tm, phi_t, tfield, phi_slot=ps_t,
                  slot_weights=schemes.weights_slot(
                      tm, ps_t, "limitedLinear 1", tfield))
          - fvm.laplacian(tm, g_t, tfield, corrected=True,
                          gamma_dims=tdims.dimViscosity,
                          gamma_slot=slot.from_flat(tm, g_t)))
    return jM, tM


@pytest.mark.parametrize("field", ["k", "U"])
def test_relax(pitz, field):
    jM, tM = _transport(pitz, field)
    close_matrix(tM, jM, "transport")
    jfield, tfield = pitz["jf"][field], pitz["tf"][field]
    close_matrix(tM.relax(pitz["tm"], 0.5, tfield.data),
                 jM.relax(pitz["jm"], 0.5, jfield.data), "relax 0.5")
    close(tM.off_abs_sum(pitz["tm"]), jM.off_abs_sum(pitz["jm"]),
          "off_abs_sum")
    tr = tM.residual(pitz["tm"], tfield.data, 0)
    jr = jM.residual(pitz["jm"], jfield.data, 0)
    close(tr, jr, "residual", atol_rel=1e-5)


def test_set_values(pitz):
    """Wall-cell constraint (the epsilon wall function's): rows replaced,
    constrained columns eliminated, boundary coupling dropped."""
    jm, tm = pitz["jm"], pitz["tm"]
    jM, tM = _transport(pitz, "epsilon")
    vals = (1.0 + np.random.default_rng(3).random(jm.n_cells)
            ).astype(np.float32)
    jS = jM.set_values(jm.wall_mask, jnp.asarray(vals), jm)
    tS = tM.set_values(tm.wall_mask, _t(vals), tm)
    close_matrix(tS, jS, "set_values")
    wall = tm.wall_mask.numpy() > 0
    assert wall.sum() > 100
    np.testing.assert_array_equal(tS.soff.numpy()[wall], 0.0)
    np.testing.assert_allclose(tS.source.numpy()[wall],
                               (tS.diag.numpy() * vals)[wall], rtol=1e-6)


def test_fvm_sources(pitz):
    jm, tm = pitz["jm"], pitz["tm"]
    jk, tk = pitz["jf"]["k"], pitz["tf"]["k"]
    sp = (np.random.default_rng(4).standard_normal(jm.n_cells)
          ).astype(np.float32)
    sp_j, sp_t = jnp.asarray(sp), _t(sp)
    close_matrix(fvm.Sp(tm, sp_t, tk), jfvm.Sp(jm, sp_j, jk), "Sp")
    close_matrix(fvm.SuSp(tm, sp_t, tk), jfvm.SuSp(jm, sp_j, jk), "SuSp")
    close_matrix(fvm.Su(tm, sp_t, tk), jfvm.Su(jm, sp_j, jk), "Su")
    close_matrix(fvm.ddt_steady(tm, tk), jfvm.ddt_steady(jm, jk), "steady")


def test_inlet_outlet_update(pitz):
    """U's outlet is inletOutlet: the update sets the value fraction from
    the boundary flux sign, and evaluation follows it."""
    jm, tm, phi = pitz["jm"], pitz["tm"], pitz["phi"]
    jU, tU = pitz["jf"]["U"], pitz["tf"]["U"]
    outlet = [i for i, b in enumerate(tU.bcs) if b.kind == "inletOutlet"]
    assert outlet == [1]
    jU2 = jU.correct_boundary_conditions(jm, phi=jnp.asarray(phi))
    tU2 = tU.correct_boundary_conditions(tm, phi=_t(phi))
    vf = tU2.bcs[1].vfrac.numpy()
    assert 0 < vf.sum() < vf.size       # the random flux goes both ways
    close(tU2.bcs[1].vfrac, jU2.bcs[1].vfrac, "vfrac")
    close(tU2.boundary_values(tm), jU2.boundary_values(jm), "U_b")


def test_simple_rejects_features_outside_slice(pitz):
    from foamtpu_torch.bc import factory
    from foamtpu_torch.core.dictionary import parse_string
    from foamtpu_torch.models.turbulence import base as tbase
    from foamtpu_torch.solvers import simple

    tm = pitz["tm"]
    cfg = simple.SimpleConfig(nu=1e-5)
    state = {"U": pitz["tf"]["U"], "p": pitz["tf"]["p"],
             "phi": _t(pitz["phi"])}
    # fvOptions and MRF zones are ported (tests/test_torch_fvoptions.py,
    # tests/test_torch_mrf.py), and so is the adjoint porosity sink
    # (tests/test_torch_adjoint.py)
    from foamtpu_torch.models import fvoptions, mrf

    zones = mrf.from_dict(tm, parse_string(
        "rotor { selectionMode box; box (0.05 -0.02 -1) (0.15 0.02 1); "
        "origin (0.1 0 0); axis (0 0 1); omega 50; }"))
    opts = fvoptions.from_dict(tm, parse_string(
        "porous { type explicitPorositySource; "
        "explicitPorositySourceCoeffs { selectionMode all; "
        "d (1e3 1e3 1e3); f (0 0 0); } }"), nu=1e-5)
    for name, value in (("mrf", zones), ("fv_options", opts)):
        assert value
        new, _ = simple.simple_step(tm, state, cfg._replace(**{name: value}))
        assert bool(torch.isfinite(new["U"].data).all()), name
    # a zero sink adds nothing to the momentum diagonal
    ref, _ = simple.simple_step(tm, state, cfg)
    new, _ = simple.simple_step(
        tm, dict(state, alpha_sink=torch.zeros_like(tm.v)), cfg)
    assert torch.equal(new["U"].data, ref["U"].data)
    # totalPressure came with the interFoam slice, waveTransmissive with
    # the boundary-condition slice (tests/test_torch_bc_derived.py); a
    # kind the reference does not map is refused by name
    bc = factory.from_dict(parse_string("type totalPressure; p0 uniform 0;"),
                           tm.patches[0], 0, torch.float32)
    assert bc.kind == "totalPressure"
    bc = factory.from_dict(parse_string("type waveTransmissive; gamma 1.4;"),
                           tm.patches[0], 0, torch.float32)
    assert bc.kind == "waveTransmissive"
    with pytest.raises(NotImplementedError, match="waveTransmissiveX"):
        factory.from_dict(parse_string("type waveTransmissiveX; gamma 1.4;"),
                          tm.patches[0], 0, torch.float32)
    # the RAS models of ras.py are ported since the turbulence slice
    # (tests/test_torch_ras_models.py), those of ras2.py since the slice
    # of the rest of turbulence (tests/test_torch_turbulence2.py); a name
    # no package registers raises ValueError, as the JAX package's select
    assert tbase.select(parse_string("RASModel RNGkEpsilon;"),
                        1e-5).name == "RNGkEpsilon"
    assert tbase.select(parse_string("RASModel LamBremhorstKE;"),
                        1e-5).name == "LamBremhorstKE"
    with pytest.raises(ValueError, match="noSuchModel"):
        tbase.select(parse_string("RASModel noSuchModel;"), 1e-5)
    # an unknown interpolation scheme raises the reference's ValueError
    # since the topology-change slice (tests/test_torch_case_run.py)
    with pytest.raises(ValueError,
                       match="unknown interpolation scheme 'QUICKV2'"):
        schemes.weights_slot(tm, slot.from_flat(tm, _t(pitz["phi"])),
                             "QUICKV2", pitz["tf"]["k"])


# ---------------------------------------------------------------------------
# Three SIMPLE + kEpsilon iterations in float64
# ---------------------------------------------------------------------------

F64_BODY = r"""
import json, os, shutil, sys, tempfile
import jax, jax.numpy as jnp, numpy as np, torch

from foamtpu.apps.cli import main as jcli
from foamtpu.core.case import Case as JCase
from foamtpu.core.dictionary import dimensioned_scalar
from foamtpu.solvers import linear as jlinear
from foamtpu.solvers import piso as jpiso
from foamtpu.solvers import simple as jsimple
from foamtpu.solvers.apps import _load_turbulence as jload
from foamtpu.solvers.apps import _relaxation as jrelax

import foamtpu_torch.solvers.linear as tlinear
from foamtpu_torch.convert import levels_from_numpy, state_from_numpy
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.solvers import simple as tsimple
from foamtpu_torch.solvers.apps import _load_turbulence as tload
from foamtpu_torch.solvers.apps import _relaxation as trelax
from foamtpu_torch.solvers.linear.gamg import GAMG

torch.set_num_threads(2)
assert jnp.zeros(1).dtype == jnp.float64, "x64 mode not active"
dst = os.path.join(tempfile.mkdtemp(), "pitzDaily")
shutil.copytree(sys.argv[1], dst)
assert jcli(["blockMesh", "-case", dst]) == 0


def config(case, load, relaxation, simple, p_controls):
    _, nu = dimensioned_scalar(case.transport_properties()["nu"])
    model, tstate = load(case, nu)
    relax = relaxation(case)
    cfg = simple.SimpleConfig(
        nu=nu, div_scheme=case.div_scheme("div(phi,U)"),
        corrected=case.laplacian_corrected(),
        grad_scheme=case.grad_scheme("grad(p)"),
        alpha_u=relax.get("U", 0.7), alpha_p=relax.get("p", 0.3),
        p_controls=p_controls, u_controls=case.solver_controls("U"),
        turb=model, turb_relax=relax.get("k", 0.7))
    return cfg, tstate


jc = JCase(dst)
jm = jc.mesh
jcfg, jts = config(jc, jload, jrelax, jsimple, jc.solver_controls("p"))
jst = jpiso.initial_state(jm, jc.read_field("U"), jc.read_field("p"),
                          turb_state=jts)
rng = np.random.default_rng(0)
turb = dict(jst["turb"])
for name in ("k", "epsilon"):
    scale = jnp.asarray(1.0 + 0.2 * rng.random(jm.n_cells))
    turb[name] = turb[name].with_data(turb[name].data * scale)
jst = dict(jst, turb=turb)

tc = TCase(dst, device="cpu")
tm = tc.mesh
jg = jcfg.p_controls["_gamg"]
tp = dict(tc.solver_controls("p"))
tp["_gamg"] = GAMG(tm, levels=levels_from_numpy(jg.levels, device="cpu"),
                   smoother=jg.smoother, n_pre=jg.n_pre, n_post=jg.n_post)
tcfg, _ = config(tc, tload, trelax, tsimple, tp)
tst = state_from_numpy(jst, device="cpu")
assert tm.v.dtype == torch.float64


def recorder(mod):
    rec = []
    orig = mod.solve
    def solve(*a, **k):
        out = orig(*a, **k)
        rec.append(out[1].n_iterations)
        return out
    mod.solve = solve
    return rec


jrec, trec = recorder(jlinear), recorder(tlinear)


@jax.jit
def jstep(state):
    jrec.clear()
    st, d = jsimple.simple_step(jm, state, jcfg)
    return st, d["continuity"], list(jrec)


out = {"levels": len(jg.levels), "iters": []}
for i in range(3):
    jst, jcont, jits = jstep(jst)
    trec.clear()
    tst, tdiag = tsimple.simple_step(tm, tst, tcfg)
    errs = {}
    pairs = {"U": (tst["U"].data, jst["U"].data),
             "p": (tst["p"].data, jst["p"].data),
             "phi": (tst["phi"], jst["phi"])}
    for name in ("k", "epsilon", "nut"):
        pairs[name] = (tst["turb"][name].data, jst["turb"][name].data)
    for k, (a, b) in pairs.items():
        a, b = a.numpy(), np.asarray(b)
        scale = float(np.abs(b).max())
        ok = np.allclose(a, b, rtol=1e-9, atol=1e-9 * scale)
        errs[k] = {"ok": bool(ok), "max_abs": float(np.abs(a - b).max()),
                   "scale": scale}
    out["iters"].append({
        "errs": errs, "jax_iters": [int(x) for x in jits],
        "port_iters": [int(x) for x in trec],
        "continuity": [float(jcont), float(tdiag["continuity"])]})
print(json.dumps(out))
"""


def test_f64_simple_parity_with_reference():
    env = dict(os.environ)
    env.update(FOAMTPU_X64="1", JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", F64_BODY, PITZ], env=env,
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert len(out["iters"]) == 3
    for i, it in enumerate(out["iters"]):
        assert len(it["jax_iters"]) == 4, it      # U, p, epsilon, k
        assert it["port_iters"] == it["jax_iters"], (i, it)
        for k, e in it["errs"].items():
            assert e["ok"], (i, k, e)
