"""foamtpu_torch interFoam (MULES VOF) against the JAX package.

- float64 parity (one subprocess with FOAMTPU_X64=1 JAX_ENABLE_X64=1),
  the same numpy-seeded inputs through both packages:
  * `mules.limiter` / `explicit_solve` on a seeded, smoothed alpha and a
    seeded flux, on tests/test_interfoam.py's 24^2 dam mesh and on
    `tet_box(4,3,3)`: rtol 1e-12, lambda within [0,1];
  * each function of models/interface.py, each new fvc function and the
    totalPressure / pressureInletOutletVelocity updates: rtol 1e-12;
  * 5 `interfoam_step`s of the dam mesh from a seeded, smoothed alpha
    with the damBreak tutorial's controls, and 3 LTS steps: U, p_rgh,
    alpha, phi (and lts_rdt) at rtol 1e-9 (atol 1e-9 of each field's
    scale) with equal iteration counts of every linear solve.
  1e-12 is float64 round-off through a handful of sums in another
  order; 1e-9 leaves room for its growth through a few dozen Krylov
  iterations, as in tests/test_torch_piso.py.
- float32, in process: MULES on both meshes at rtol 1e-5 (atol 1e-6 of
  scale); `setFields` on a copy of damBreak writes the reference's
  0/alpha1 (array_equal); fields written by the port are read back equal
  by both packages' readers; the features outside the slice raise.
- The damBreak goldens of chip_smoke.py (20 steps of the tutorial) come
  from `reference_dambreak`: the JAX package on the CPU in float32. One
  test re-derives them (rtol 1e-4 leaves room for another CPU's vector
  width), one holds the port on the CPU to them at chip_smoke's 1e-3.
"""

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from foamtpu_torch.apps.cli import main as tcli
from foamtpu_torch.convert import field_from_numpy, mesh_from_numpy, tensor
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.models import interface as tiface
from foamtpu_torch.ops import mules as tmules
from foamtpu_torch.solvers import interfoam as tinter
from foamtpu_torch.solvers.apps import interfoam_app, run

import chip_smoke
from test_torch_simple import REPO

torch.set_num_threads(2)

DAMBREAK = os.path.join(REPO, chip_smoke.DAMBREAK_CASE)


def dam_case(root, cli=tcli, extra=("-device", "cpu"), name="damBreak"):
    dst = os.path.join(str(root), name)
    shutil.copytree(DAMBREAK, dst)
    assert cli(["blockMesh", "-case", dst]) == 0
    assert cli(["setFields", "-case", dst, *extra]) == 0
    return dst


def smooth_alpha(mesh, seed, sweeps=3):
    """A seeded phase fraction in [0,1] with a smeared interface: a
    random blob field averaged over face neighbours `sweeps` times
    (numpy, from the mesh's cnbr table)."""
    rng = np.random.default_rng(seed)
    cnbr = np.asarray(mesh.cnbr)
    valid = np.asarray(mesh.cnbr_valid)
    a = (rng.random(mesh.n_cells) < 0.4).astype(np.float64)
    for _ in range(sweeps):
        nb = (a[cnbr] * valid).sum(axis=1) / np.maximum(valid.sum(axis=1), 1)
        a = 0.5 * a + 0.5 * nb
    return np.clip(a, 0.0, 1.0)


def mules_inputs(mesh, seed):
    """(alpha, phi_bd, phi_corr, dt): a smoothed alpha, its upwind flux by
    a seeded face flux and a seeded antidiffusive correction, at a
    Courant number of ~0.3."""
    rng = np.random.default_rng(seed + 100)
    a = smooth_alpha(mesh, seed)
    nif = mesh.n_internal_faces
    act = np.asarray(mesh.face_active)
    phi = rng.standard_normal(mesh.n_faces) * np.asarray(mesh.mag_sf) * act
    own = np.asarray(mesh.owner)
    nei = np.asarray(mesh.neighbour)
    a_up = np.where(phi[:nif] >= 0, a[own[:nif]], a[nei])
    a_lin = 0.5 * (a[own[:nif]] + a[nei])
    af_b = a[own[nif:]]
    phi_bd = phi * np.concatenate([a_up, af_b])
    phi_corr = phi * np.concatenate([a_lin - a_up, 0.0 * af_b]) \
        + 0.1 * np.abs(phi) * rng.standard_normal(mesh.n_faces)
    cface = np.asarray(mesh.cface)
    csign = np.abs(np.asarray(mesh.csign))
    co = (np.abs(phi)[cface] * csign).sum(axis=1) / np.asarray(mesh.v)
    return a, phi_bd, phi_corr * act, 0.3 / co.max()


def jax_meshes():
    from foamtpu.mesh import tetmesh as jtet
    from foamtpu.mesh import to_device as jto_device
    from test_interfoam import dam_mesh

    return {"dam24": dam_mesh(24), "tet433": jto_device(jtet.tet_box(4, 3, 3))}


# ---------------------------------------------------------------------------
# float32, in process
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def meshes():
    jm = jax_meshes()
    return {k: (m, mesh_from_numpy(m, device="cpu")) for k, m in jm.items()}


@pytest.mark.parametrize("which", ["dam24", "tet433"])
def test_mules_f32_matches_reference(meshes, which):
    import jax.numpy as jnp
    from foamtpu.ops import mules as jmules

    jm, tm = meshes[which]
    a, bd, corr, dt = (np.asarray(x, np.float32)
                       for x in mules_inputs(jm, 7))
    jl = jmules.limiter(jm, jnp.asarray(a), jnp.asarray(bd),
                        jnp.asarray(corr), jnp.asarray(dt))
    tl = tmules.limiter(tm, tensor(a, device="cpu"), tensor(bd, device="cpu"),
                        tensor(corr, device="cpu"),
                        torch.tensor(dt))
    assert float(tl.min()) >= 0.0 and float(tl.max()) <= 1.0
    assert 0.0 < float(tl.mean()) < 1.0          # the limiter is at work
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-6)
    jn, jf = jmules.explicit_solve(jm, jnp.asarray(a), jnp.asarray(bd),
                                   jnp.asarray(corr), jnp.asarray(dt))
    tn, tf = tmules.explicit_solve(tm, tensor(a, device="cpu"),
                                   tensor(bd, device="cpu"),
                                   tensor(corr, device="cpu"),
                                   torch.tensor(dt))
    for got, ref in ((tn, jn), (tf, jf)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                   atol=1e-6 * np.abs(ref).max())


def test_setfields_writes_the_reference_alpha(tmp_path):
    from foamtpu.apps.cli import main as jcli
    from foamtpu.core.case import Case as JCase

    dj = dam_case(tmp_path, jcli, (), "ref")
    dt_ = dam_case(tmp_path)
    ja = JCase(dj).read_field("alpha1")
    tcase = TCase(dt_, device="cpu")
    ta = tcase.read_field("alpha1")
    assert np.array_equal(ta.data.numpy(), np.asarray(ja.data))
    assert 0 < float(ta.data.sum()) < tcase.mesh.n_cells
    assert [bc.kind for bc in ta.bcs] == [bc.kind for bc in ja.bcs]
    # and each package reads the other's file
    assert np.array_equal(JCase(dt_).read_field("alpha1").data,
                          np.asarray(ja.data))
    assert np.array_equal(TCase(dj, device="cpu").read_field("alpha1")
                          .data.numpy(), np.asarray(ja.data))


def test_setfields_rejects_other_sources(tmp_path):
    dst = dam_case(tmp_path)
    path = os.path.join(dst, "system", "setFieldsDict")
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text.replace("boxToCell", "sphereToCell"))
    with pytest.raises(NotImplementedError, match="sphereToCell"):
        tcli(["setFields", "-case", dst, "-device", "cpu"])


@pytest.mark.parametrize("fmt", ["ascii", "binary"])
def test_written_fields_are_read_back_by_both_packages(tmp_path, fmt):
    from foamtpu.core.case import Case as JCase

    dst = dam_case(tmp_path)
    case = TCase(dst, device="cpu")
    case.control_dict["writeFormat"] = fmt
    rng = np.random.default_rng(2)
    n = case.mesh.n_cells
    fields = [
        case.read_field("U").with_data(tensor(rng.standard_normal((n, 3)),
                                              device="cpu")),
        case.read_field("p_rgh").with_data(tensor(rng.standard_normal(n),
                                                  device="cpu")),
        case.read_field("alpha1").with_data(tensor(rng.random(n),
                                                   device="cpu")),
    ]
    case.write_fields(fields, "0.25")
    assert case.time._written == ["0.25"]
    jc = JCase(dst)
    for f in fields:
        back_t = case.read_field(f.name, time="0.25")
        back_j = jc.read_field(f.name, time="0.25")
        assert np.array_equal(back_t.data.numpy(), f.data.numpy()), f.name
        assert np.array_equal(np.asarray(back_j.data), f.data.numpy()), f.name
        assert [b.kind for b in back_t.bcs] == [b.kind for b in f.bcs]
        assert [b.kind for b in back_j.bcs] == [b.kind for b in f.bcs]


def test_interfoam_rejects_features_outside_slice(tmp_path):
    dst = dam_case(tmp_path)
    # interDyMFoam runs on a solidBodyMotionFvMesh since the moving-mesh slice
    # (tests/test_torch_movingmesh.py), and on a dynamicRefineFvMesh since
    # the topology-change slice (tests/test_torch_amr.py): the refusal is
    # lifted, and damBreak's 46 x 46 box takes a step on its octree
    with open(os.path.join(dst, "constant", "dynamicMeshDict"), "w") as f:
        f.write("dynamicFvMesh dynamicRefineFvMesh;\n")
    case = TCase(dst, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        interfoam_app(case, max_steps=1, dym=True)
    assert case.time.index == 1 and case.final_state["n_cells"] >= 46 * 46
    case = TCase(dst, device="cpu")
    mesh = case.mesh
    cfg = tinter.InterConfig(rho1=1000.0, rho2=1.0, nu1=1e-6, nu2=1e-5,
                             sigma=0.07)
    state = tinter.initial_state(mesh, case.read_field("U"),
                                 case.read_field("p_rgh"),
                                 case.read_field("alpha1"), cfg)
    # MRF zones and porous zones are ported (MRFInterFoam, porousInterFoam:
    # tests/test_torch_mrf.py)
    from foamtpu_torch.core.dictionary import parse_string
    from foamtpu_torch.models import fvoptions, mrf

    zones = mrf.from_dict(mesh, parse_string(
        "rotor { selectionMode cylinder; origin (0.3 0.25 0); "
        "axis (0 0 1); radius 0.05; omega 10; }"))
    opts = fvoptions.from_dict(mesh, parse_string(
        "screen { type explicitPorositySource; "
        "explicitPorositySourceCoeffs { selectionMode box; "
        "box ((0.35 0 -1) (0.45 0.3 1)); d (1e6 1e6 1e6); f (0 0 0); } }"),
        nu=1e-6)
    for name, value in (("mrf", zones), ("fv_options", opts)):
        assert value
        new, _ = tinter.interfoam_step(mesh, state, 1e-3,
                                       cfg._replace(**{name: value}))
        assert bool(torch.isfinite(new["U"].data).all()), name
    # the moving-mesh flux is subtracted from phiHbyA (fvc::makeRelative):
    # a zero mesh flux leaves the step as it was
    still, _ = tinter.interfoam_step(mesh, state, 1e-3, cfg)
    zero, _ = tinter.interfoam_step(
        mesh, dict(state, mesh_phi=torch.zeros_like(state["phi"])), 1e-3,
        cfg)
    for name in ("U", "p_rgh", "alpha"):
        assert torch.equal(still[name].data, zero[name].data), name
    assert torch.equal(still["phi"], zero["phi"])
    # a contact-angle wall (ported since the boundary-condition slice,
    # tests/test_torch_bc_derived.py): the file is read as the kind
    # alphaContactAngle, which turns the wall normals; an internal kind
    # name written into the file is still refused by name
    alpha = case.read_field("alpha1")
    ca = tuple(bc.replace(kind="alphaContactAngle",
                          opts=(("theta0", 0.25 * np.pi),))
               if p.type == "wall" else bc
               for p, bc in zip(mesh.patches, alpha.bcs))
    plain = tiface.interface_normals(mesh, alpha)
    turned = tiface.interface_normals(mesh, alpha.replace(bcs=ca))
    nif = mesh.n_internal_faces
    assert torch.equal(plain[:nif], turned[:nif])
    path = os.path.join(dst, "0", "alpha1")
    with open(path) as f:
        text = f.read()
    edited = re.sub(r"(leftWall\s*\{\s*type\s+)zeroGradient;",
                    r"\1constantAlphaContactAngle; theta0 45; "
                    r"limit gradient; value uniform 0;", text)
    assert edited != text
    with open(path, "w") as f:
        f.write(edited)
    left = [p.name for p in mesh.patches].index("leftWall")
    bc = case.read_field("alpha1").bcs[left]
    assert bc.kind == "alphaContactAngle"
    assert abs(bc.opt("theta0") - 0.25 * np.pi) < 1e-12
    with open(path, "w") as f:
        f.write(edited.replace("constantAlphaContactAngle",
                               "alphaContactAngle"))
    with pytest.raises(NotImplementedError, match="alphaContactAngle"):
        case.read_field("alpha1")


# ---------------------------------------------------------------------------
# the damBreak goldens of chip_smoke.py
# ---------------------------------------------------------------------------


def reference_dambreak(root, steps=chip_smoke.DAMBREAK_GOLDEN_STEPS):
    """The goldens' source: damBreak through the JAX package's blockMesh,
    setFields and interfoam_app on the CPU in float32, `steps` steps of
    the tutorial's deltaT."""
    from foamtpu.apps.cli import main as jcli
    from foamtpu.core.case import Case as JCase
    from foamtpu.solvers.apps import interfoam_app as japp

    case = JCase(dam_case(root, jcli, (), "golden"))
    with contextlib.redirect_stdout(io.StringIO()):
        japp(case, max_steps=steps)
    st = case.final_state
    return chip_smoke.dambreak_scalars(
        np.asarray(case.mesh.v), np.asarray(st["alpha"].data),
        np.asarray(st["U"].data), np.asarray(st["p_rgh"].data))


def test_dambreak_goldens_come_from_the_reference(tmp_path):
    got = reference_dambreak(tmp_path)
    for name, gold in chip_smoke.DAMBREAK_GOLDEN.items():
        np.testing.assert_allclose(got[name], gold, rtol=1e-4, err_msg=name)


def test_port_dambreak_f32_meets_goldens(tmp_path):
    """What chip_smoke's dambreak phase checks on the card at the
    tutorial's size, here on the CPU: blockMesh, setFields, the
    application for 20 steps against the goldens at 1e-3 relative, then
    the run again for 60 steps held by the invariants (the card runs
    chip_smoke.DAMBREAK_STEPS)."""
    case = TCase(dam_case(tmp_path), device="cpu")
    assert case.mesh.v.dtype == torch.float32
    a0 = case.read_field("alpha1").data.clone()
    with contextlib.redirect_stdout(io.StringIO()):
        run(case, max_steps=chip_smoke.DAMBREAK_GOLDEN_STEPS)
    out, checks = chip_smoke.dambreak_golden_checks(case.mesh,
                                                    case.final_state)
    assert all(checks.values()), (out, checks)
    case = TCase(case.dir, device="cpu")      # from the start again
    with contextlib.redirect_stdout(io.StringIO()):
        run(case, max_steps=60)
    assert case.time.index == 60
    out, checks = chip_smoke.dambreak_invariants(case.mesh, a0,
                                                 case.final_state)
    assert all(checks.values()), (out, checks)


# ---------------------------------------------------------------------------
# float64 parity
# ---------------------------------------------------------------------------

F64_BODY = r"""
import json, os, sys
import jax, jax.numpy as jnp, numpy as np, torch

sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
from foamtpu.bc import patchfields as jpf
from foamtpu.core.dimensions import DimensionSet, dimVelocity
from foamtpu.core.fields import vol_scalar, vol_vector
from foamtpu.models import interface as jiface
from foamtpu.ops import fvc as jfvc
from foamtpu.ops import mules as jmules
from foamtpu.solvers import interfoam as jinter
from foamtpu.solvers import linear as jlinear

import foamtpu_torch.solvers.linear as tlinear
from foamtpu_torch.bc import patchfields as tpf
from foamtpu_torch.convert import (config_from_reference, field_from_numpy,
                                   mesh_from_numpy, state_from_numpy, tensor)
from foamtpu_torch.models import interface as tiface
from foamtpu_torch.ops import fvc as tfvc
from foamtpu_torch.ops import mules as tmules
from foamtpu_torch.solvers import interfoam as tinter

from test_torch_interfoam import jax_meshes, mules_inputs, smooth_alpha

torch.set_num_threads(2)
assert jnp.zeros(1).dtype == jnp.float64, "x64 mode not active"
out = {}


def err(got, ref, rtol):
    a = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    b = np.asarray(ref)
    scale = float(np.abs(b).max()) if b.size else 0.0
    ok = a.shape == b.shape and np.allclose(a, b, rtol=rtol,
                                            atol=rtol * scale)
    return {"ok": bool(ok), "scale": scale,
            "max_abs": float(np.abs(a - b).max()) if b.size else 0.0}


jms = jax_meshes()
tms = {k: mesh_from_numpy(m, device="cpu") for k, m in jms.items()}

# -- MULES -------------------------------------------------------------------
for which, jm in jms.items():
    tm = tms[which]
    a, bd, corr, dt = mules_inputs(jm, 7)
    jl = jmules.limiter(jm, jnp.asarray(a), jnp.asarray(bd),
                        jnp.asarray(corr), jnp.asarray(dt))
    tl = tmules.limiter(tm, tensor(a, device="cpu"), tensor(bd, device="cpu"),
                        tensor(corr, device="cpu"), dt)
    jn, jf = jmules.explicit_solve(jm, jnp.asarray(a), jnp.asarray(bd),
                                   jnp.asarray(corr), jnp.asarray(dt))
    tn, tf = tmules.explicit_solve(tm, tensor(a, device="cpu"),
                                   tensor(bd, device="cpu"),
                                   tensor(corr, device="cpu"), dt)
    out["mules_" + which] = {
        "lambda": err(tl, jl, 1e-12), "psi": err(tn, jn, 1e-12),
        "phi_psi": err(tf, jf, 1e-12),
        "lambda_range": [float(tl.min()), float(tl.max()),
                         float(tl.mean())]}


# -- fields on a mesh: the damBreak BC kinds on the dam, defaults on tets ---
def fields(jm, seed):
    rng = np.random.default_rng(seed)
    n = jm.n_cells
    ubcs, pbcs, abcs = [], [], []
    for patch in jm.patches:
        if patch.type == "empty":
            for lst in (ubcs, pbcs, abcs):
                lst.append(jpf.PatchField(kind="empty", vfrac=0.0))
        elif patch.name == "atmosphere":
            ubcs.append(jpf.make("pressureInletOutletVelocity",
                                 ref_value=jnp.zeros(3)))
            pbcs.append(jpf.make("totalPressure", ref_value=0.0, p0=0.0))
            abcs.append(jpf.make("inletOutlet", ref_value=0.0))
        elif patch.type == "wall":
            ubcs.append(jpf.fixed_value(jnp.zeros(3)))
            pbcs.append(jpf.zero_gradient())
            abcs.append(jpf.zero_gradient())
        else:
            ubcs.append(jpf.zero_gradient())
            pbcs.append(jpf.fixed_value(0.0))
            abcs.append(jpf.zero_gradient())
    U = vol_vector(jm, jnp.zeros(3), name="U", dims=dimVelocity,
                   bcs=tuple(ubcs))
    U = U.with_data(jnp.asarray(0.3 * rng.standard_normal((n, 3))
                                * np.array([1.0, 1.0, 0.0 if
                                            "dam" in which else 1.0])))
    p = vol_scalar(jm, 0.0, name="p_rgh", dims=DimensionSet.of(0, 2, -2),
                   bcs=tuple(pbcs))
    p = p.with_data(jnp.asarray(rng.standard_normal(n)))
    al = vol_scalar(jm, 0.0, name="alpha1", bcs=tuple(abcs))
    al = al.with_data(jnp.asarray(smooth_alpha(jm, seed)))
    phi = np.asarray(jfvc.flux(jm, U)) + 1e-3 * np.asarray(jm.mag_sf) \
        * np.asarray(jm.face_active) * rng.standard_normal(jm.n_faces)
    return U, p, al, phi, rng


for which, jm in jms.items():
    tm = tms[which]
    U, p, al, phi, rng = fields(jm, 11)
    tU, tp, tal = (field_from_numpy(f, device="cpu") for f in (U, p, al))
    jphi, tphi = jnp.asarray(phi), tensor(phi, device="cpu")
    fv = rng.standard_normal(jm.n_faces)
    fvv = rng.standard_normal((jm.n_faces, 3))
    gam = 1.0 + rng.random(jm.n_faces)
    res = {}
    # models/interface.py
    res["interface_normals"] = err(tiface.interface_normals(tm, tal),
                                   jiface.interface_normals(jm, al), 1e-12)
    res["curvature"] = err(tiface.curvature(tm, tal),
                           jiface.curvature(jm, al), 1e-12)
    res["surface_tension_flux"] = err(
        tiface.surface_tension_flux(tm, tal, 0.07),
        jiface.surface_tension_flux(jm, al, 0.07), 1e-12)
    res["compression_flux"] = err(
        tiface.compression_flux(tm, tphi, tal, 1.0),
        jiface.compression_flux(jm, jphi, al, 1.0), 1e-12)
    # ops/fvc.py
    res["surface_integrate"] = err(
        tfvc.surface_integrate(tm, tensor(fv, device="cpu")),
        jfvc.surface_integrate(jm, jnp.asarray(fv)), 1e-12)
    res["surface_integrate_vec"] = err(
        tfvc.surface_integrate(tm, tensor(fvv, device="cpu")),
        jfvc.surface_integrate(jm, jnp.asarray(fvv)), 1e-12)
    res["div_surface"] = err(tfvc.div_surface(tm, tphi),
                             jfvc.div_surface(jm, jphi), 1e-12)
    res["div_scalar"] = err(tfvc.div(tm, tphi, tal),
                            jfvc.div(jm, jphi, al), 1e-12)
    res["div_vector"] = err(tfvc.div(tm, tphi, tU),
                            jfvc.div(jm, jphi, U), 1e-12)
    for corrected in (False, True):
        tag = "_corrected" if corrected else ""
        res["sn_grad" + tag] = err(
            tfvc.sn_grad(tm, tal, corrected=corrected),
            jfvc.sn_grad(jm, al, corrected=corrected), 1e-12)
        res["sn_grad_vec" + tag] = err(
            tfvc.sn_grad(tm, tU, corrected=corrected),
            jfvc.sn_grad(jm, U, corrected=corrected), 1e-12)
        res["laplacian" + tag] = err(
            tfvc.laplacian(tm, tensor(gam, device="cpu"), tp,
                           corrected=corrected),
            jfvc.laplacian(jm, jnp.asarray(gam), p, corrected=corrected),
            1e-12)
    res["average"] = err(tfvc.average(tm, tensor(fv, device="cpu")),
                         jfvc.average(jm, jnp.asarray(fv)), 1e-12)
    res["average_vec"] = err(tfvc.average(tm, tensor(fvv, device="cpu")),
                             jfvc.average(jm, jnp.asarray(fvv)), 1e-12)
    res["reconstruct"] = err(tfvc.reconstruct(tm, tphi),
                             jfvc.reconstruct(jm, jphi), 1e-12)
    res["ddt"] = err(tfvc.ddt(tm, tU.data, 0.5 * tU.data, 200.0),
                     jfvc.ddt(jm, U.data, 0.5 * U.data, 200.0), 1e-12)
    res["domain_integrate"] = err(tfvc.domain_integrate(tm, tal.data),
                                  jfvc.domain_integrate(jm, al.data), 1e-12)
    res["domain_integrate_vec"] = err(tfvc.domain_integrate(tm, tU.data),
                                      jfvc.domain_integrate(jm, U.data),
                                      1e-12)
    out["ops_" + which] = res
    if which != "dam24":
        continue
    # the two BC updates, as interfoam_step passes their context
    rho = 1.0 + 999.0 * np.asarray(al.data)
    jp2 = p.correct_boundary_conditions(jm, phi=jphi, U=U.data,
                                        rho_b=jnp.asarray(rho))
    tp2 = tp.correct_boundary_conditions(tm, phi=tphi, U=tU.data,
                                         rho_b=tensor(rho, device="cpu"))
    jU2 = U.correct_boundary_conditions(jm, phi=jphi)
    tU2 = tU.correct_boundary_conditions(tm, phi=tphi)
    bc = {}
    for name, tf_, jf_ in (("totalPressure", tp2, jp2),
                           ("pressureInletOutletVelocity", tU2, jU2)):
        i = [b.kind for b in jf_.bcs].index(name)
        assert tf_.bcs[i].kind == name
        bc[name + "_ref_value"] = err(tf_.bcs[i].ref_value,
                                      jf_.bcs[i].ref_value, 1e-12)
        bc[name + "_vfrac"] = err(tf_.bcs[i].vfrac, jf_.bcs[i].vfrac, 1e-12)
        bc[name + "_boundary_values"] = err(tf_.boundary_values(tm),
                                            jf_.boundary_values(jm), 1e-12)
        # both branches of the update are exercised
        ph = phi[jm.patches[i].slice]
        assert (ph > 0).any() and (ph < 0).any()
    out["bc_updates"] = bc


# -- interfoam_step: 5 steps, then 3 LTS steps -----------------------------
def recorder(mod):
    rec = []
    orig = mod.solve
    def solve(*a, **k):
        o = orig(*a, **k)
        rec.append(o[1].n_iterations)
        return o
    mod.solve = solve
    return rec


jrec, trec = recorder(jlinear), recorder(tlinear)
jm, tm = jms["dam24"], tms["dam24"]
which = "dam24"
U, p, al, _, _ = fields(jm, 5)
U = U.with_data(jnp.zeros_like(U.data))
p = p.with_data(jnp.zeros_like(p.data))


def run(cfg, n):
    jst = jinter.initial_state(jm, U, p, al, cfg)
    tst = state_from_numpy(jst, device="cpu")
    tcfg = config_from_reference(tinter.InterConfig, cfg)

    @jax.jit
    def jstep(state, dt):
        jrec.clear()
        if cfg.lts:
            st, d = jinter.lts_interfoam_step(jm, state, dt, cfg)
        else:
            st, d = jinter.interfoam_step(jm, state, dt, cfg)
        return st, d, list(jrec)

    tstep = tinter.make_step(tm, tcfg)
    steps = []
    for i in range(n):
        jst, jd, jits = jstep(jst, jnp.asarray(1e-3))
        trec.clear()
        tst, td = tstep(tst, 1e-3)
        names = ["U", "p_rgh", "alpha"]
        pairs = {k: (tst[k].data, jst[k].data) for k in names}
        pairs["phi"] = (tst["phi"], jst["phi"])
        pairs["rho"] = (tst["rho"], jst["rho"])
        if cfg.lts:
            pairs["lts_rdt"] = (tst["lts_rdt"], jst["lts_rdt"])
        steps.append({
            "errs": {k: err(a, b, 1e-9) for k, (a, b) in pairs.items()},
            "jax_iters": [int(x) for x in jits],
            "port_iters": [int(x) for x in trec],
            "alpha_range": [float(td["alpha_min"]), float(td["alpha_max"])],
            "courant": [float(jd["courant_max"]), float(td["courant_max"])],
            "maxU": float(tst["U"].data.abs().max())})
    return steps


base = dict(rho1=1000.0, rho2=1.0, nu1=1e-6, nu2=1.48e-5, sigma=0.07,
            g=(0.0, -9.81, 0.0), c_alpha=1.0, n_alpha_subcycles=2,
            n_correctors=3,
            p_controls={"solver": "PCG", "preconditioner": "diagonal",
                        "tolerance": 1e-7, "relTol": 0.05},
            u_controls={"solver": "smoothSolver", "tolerance": 1e-8,
                        "relTol": 0.0})
out["interfoam"] = run(jinter.InterConfig(**base), 5)
out["lts"] = run(jinter.InterConfig(lts=True, lts_max_co=0.25,
                                    lts_max_dt=0.01, **base), 3)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def f64_run():
    env = dict(os.environ)
    env.update(FOAMTPU_X64="1", JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", F64_BODY], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("which", ["dam24", "tet433"])
def test_f64_mules_parity(f64_run, which):
    res = f64_run["mules_" + which]
    for name in ("lambda", "psi", "phi_psi"):
        assert res[name]["ok"], (which, name, res[name])
    lo, hi, mean = res["lambda_range"]
    assert lo >= 0.0 and hi <= 1.0 and 0.0 < mean < 1.0


@pytest.mark.parametrize("which", ["dam24", "tet433"])
@pytest.mark.parametrize("fn", [
    "interface_normals", "curvature", "surface_tension_flux",
    "compression_flux"])
def test_f64_interface_parity(f64_run, which, fn):
    e = f64_run["ops_" + which][fn]
    assert e["ok"] and e["scale"] > 0, (which, fn, e)


@pytest.mark.parametrize("which", ["dam24", "tet433"])
@pytest.mark.parametrize("fn", [
    "surface_integrate", "surface_integrate_vec", "div_surface",
    "div_scalar", "div_vector", "sn_grad", "sn_grad_vec", "laplacian",
    "sn_grad_corrected", "sn_grad_vec_corrected", "laplacian_corrected",
    "average", "average_vec", "reconstruct", "ddt", "domain_integrate",
    "domain_integrate_vec"])
def test_f64_fvc_parity(f64_run, which, fn):
    e = f64_run["ops_" + which][fn]
    assert e["ok"] and e["scale"] > 0, (which, fn, e)


@pytest.mark.parametrize("kind", ["totalPressure",
                                  "pressureInletOutletVelocity"])
def test_f64_bc_update_parity(f64_run, kind):
    for part in ("_ref_value", "_vfrac", "_boundary_values"):
        e = f64_run["bc_updates"][kind + part]
        assert e["ok"], (kind, part, e)


@pytest.mark.parametrize("mode,n_steps", [("interfoam", 5), ("lts", 3)])
def test_f64_interfoam_parity(f64_run, mode, n_steps):
    steps = f64_run[mode]
    assert len(steps) == n_steps
    for i, st in enumerate(steps):
        # U, then one p_rgh solve per corrector
        assert len(st["jax_iters"]) == 4, st
        assert st["port_iters"] == st["jax_iters"], (mode, i, st)
        assert min(st["jax_iters"][1:]) > 0
        for k, e in st["errs"].items():
            assert e["ok"], (mode, i, k, e)
        assert -1e-6 < st["alpha_range"][0] and st["alpha_range"][1] < 1.0 + 1e-3
    assert steps[-1]["maxU"] > 0.0


def test_ltsinterfoam_application_matches_reference_f64():
    """LTSInterFoam is registered as the reference registers it
    (interfoam_app with lts=True): both packages' run(case) on the
    LTSInterFoam damBreak tutorial (blockMesh, setFields) for 3 steps in
    float64 (tests/test_torch_ras_models.py's PARITY_BODY): U, p_rgh,
    alpha and phi at rtol 1e-9, every p_rgh solve with the same iteration
    count, the log lines and the written fields. The case caps the local
    time step at the tutorial's deltaT (maxDeltaT 0.001): as shipped it
    sets none, the still water's local step is 1e6 s, and |U| reaches 3e11
    in the first step in both packages (chip_smoke.SLICE10_CASES)."""
    from test_torch_ras_models import assert_parity, parity

    rec = parity("slice10", 3, ["LTSInterFoam"])["LTSInterFoam"]
    assert_parity(rec, 3, "LTSInterFoam", files_scaled=True)
    assert {"U", "p_rgh", "alpha", "phi"} == set(rec["errs"])
    assert [n for n, _ in rec["solves"][0]] == ["p_rgh"] * 3
