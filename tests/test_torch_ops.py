"""foamtpu_torch face/cell operators against the JAX package.

ops/slot.py, ops/surface.py, ops/fvm.py, ops/fvc.py and FvMatrix (A, H,
flux, ...) run on the same mesh and the same random fields (numpy,
seeded) in both packages. Meshes: the 20^2 cavity (structured, no COO
fallback) and a small tet box (non-orthogonal, a third of the faces in
the COO fallback), so every fallback branch runs too.

Tolerance: float32 at rtol 1e-5 and atol 1e-6 * max|ref|. The ports
compute the same float32 expressions, but sums may group differently
(torch.sum vs XLA reductions, index_add vs scatter-add), which moves the
last bits; 1e-6 of the array's scale covers entries that cancel to ~0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foamtpu.apps.cases import CAVITY_BLOCKMESH
from foamtpu.bc import patchfields as jpf
from foamtpu.core.dictionary import parse_string as jparse
from foamtpu.core.dimensions import dimTime, dimViscosity
from foamtpu.core.fields import vol_scalar as jvol_scalar
from foamtpu.core.fields import vol_vector as jvol_vector
from foamtpu.mesh import blockmesh as jblockmesh
from foamtpu.mesh import to_device as jto_device
from foamtpu.mesh.tetmesh import tet_box
from foamtpu.ops import fvc as jfvc
from foamtpu.ops import fvm as jfvm
from foamtpu.ops import slot as jslot
from foamtpu.ops import surface as jsurface

from foamtpu_torch.convert import field_from_numpy, mesh_from_numpy
from foamtpu_torch.core import dimensions as tdims
from foamtpu_torch.ops import fvc, fvm, slot, surface

torch.set_num_threads(2)


def _jmesh(kind):
    if kind == "cavity20":
        return jto_device(jblockmesh.generate(
            jparse(CAVITY_BLOCKMESH.replace("{n}", "20"))))
    return jto_device(tet_box(4, 3, 3))


@pytest.fixture(scope="module", params=["cavity20", "tet"])
def case(request):
    """(jmesh, tmesh, jfields, tfields, rng arrays) on one mesh."""
    jm = _jmesh(request.param)
    tm = mesh_from_numpy(jm, device="cpu")
    rng = np.random.default_rng(7)
    nC = jm.n_cells
    ubcs, pbcs = [], []
    for p in jm.patches:
        if p.type == "empty":
            ubcs.append(jpf.PatchField(kind="empty", vfrac=0.0))
            pbcs.append(jpf.PatchField(kind="empty", vfrac=0.0))
        else:
            ubcs.append(jpf.fixed_value(
                jnp.asarray(rng.standard_normal((p.size, 3)), jnp.float32)))
            pbcs.append(jpf.zero_gradient())
    jU = jvol_vector(jm, jnp.asarray(rng.standard_normal((nC, 3)),
                                     jnp.float32), name="U", bcs=tuple(ubcs))
    jp = jvol_scalar(jm, 0.0, name="p", bcs=tuple(pbcs)).with_data(
        jnp.asarray(rng.standard_normal(nC), jnp.float32))
    extra = dict(
        phi=rng.standard_normal(jm.n_faces).astype(np.float32)
        * np.asarray(jm.face_active),
        gamma=(0.1 + rng.random(jm.n_faces)).astype(np.float32),
        bvec=rng.standard_normal((jm.n_faces - jm.n_internal_faces, 3))
        .astype(np.float32),
    )
    return jm, tm, (jU, jp), (field_from_numpy(jU, device="cpu"),
                              field_from_numpy(jp, device="cpu")), \
        extra


def close(got, ref, what=""):
    if isinstance(got, (tuple, list)):
        assert len(got) == len(ref), what
        for i, (g, r) in enumerate(zip(got, ref)):
            close(g, r, f"{what}[{i}]")
        return
    if got is None or ref is None:
        assert got is None and ref is None, what
        return
    g = got.detach().cpu().numpy() if torch.is_tensor(got) else \
        np.asarray(got)
    r = np.asarray(ref)
    assert g.shape == r.shape, (what, g.shape, r.shape)
    scale = float(np.max(np.abs(r))) if r.size else 0.0
    np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6 * scale + 1e-30,
                               err_msg=what)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _close_matrix(got, ref, what):
    for name in ("diag", "lower", "upper", "source", "ic", "bc", "soff",
                 "sfb"):
        close(getattr(got, name), getattr(ref, name), f"{what}.{name}")
    assert got.symmetric == ref.symmetric
    assert got.dims.exponents() == ref.dims.exponents(), what


def test_surface_ops(case):
    jm, tm, (jU, jp), (tU, tp), ex = case
    for data_j, data_t in ((jp.data, tp.data), (jU.data, tU.data)):
        close(surface.owner_to_b(tm, data_t),
              jsurface.owner_to_b(jm, data_j), "owner_to_b")
        close(surface.interpolate_internal(tm, data_t),
              jsurface.interpolate_internal(jm, data_j), "interp_internal")
        close(surface.delta(tm, data_t), jsurface.delta(jm, data_j), "delta")
    nbf = jm.n_faces - jm.n_internal_faces
    close(surface.boundary_sum(tm, _t(ex["bvec"])),
          jsurface.boundary_sum(jm, jnp.asarray(ex["bvec"])), "bsum vec")
    close(surface.boundary_sum(tm, _t(ex["bvec"][:, 0].copy())),
          jsurface.boundary_sum(jm, jnp.asarray(ex["bvec"][:, 0])), "bsum")
    assert ex["bvec"].shape[0] == nbf
    close(surface.surface_sum(tm, _t(ex["phi"])),
          jsurface.surface_sum(jm, jnp.asarray(ex["phi"])), "surface_sum")
    close(surface.face_values(tm, tU), jsurface.face_values(jm, jU),
          "face_values")


def test_slot_ops(case):
    jm, tm, (jU, jp), (tU, tp), ex = case
    for data_j, data_t in ((jp.data, tp.data), (jU.data, tU.data)):
        close(slot.nbr_values(tm, data_t) * _t(jm.st_valid).reshape(
            tm.st_valid.shape + (1,) * (data_t.ndim - 1)),
            jslot.nbr_values(jm, data_j) * jnp.asarray(jm.st_valid).reshape(
                jm.st_valid.shape + (1,) * (data_j.ndim - 1)), "nbr_values")
        close(tuple(slot.interpolate(tm, data_t)),
              tuple(jslot.interpolate(jm, data_j)), "interpolate")
        close(tuple(slot.delta(tm, data_t)), tuple(jslot.delta(jm, data_j)),
              "delta")
    phi_j = jnp.asarray(ex["phi"])
    phi_t = _t(ex["phi"])
    fj, ft = jslot.from_flat(jm, phi_j), slot.from_flat(tm, phi_t)
    close(tuple(ft), tuple(fj), "from_flat")
    close(slot.to_flat(tm, ft), jslot.to_flat(jm, fj), "to_flat")
    close(slot.to_flat_internal(tm, ft), jslot.to_flat_internal(jm, fj),
          "to_flat_internal")
    close(slot.surface_sum(tm, ft), jslot.surface_sum(jm, fj), "surface_sum")
    for ab in (False, True):
        close(slot.weighted_cell_sum(tm, ft, absolute=ab),
              jslot.weighted_cell_sum(jm, fj, absolute=ab), "wcs")
    bp_j, bp_t = jp.boundary_values(jm), tp.boundary_values(tm)
    close(bp_t, bp_j, "p boundary values")
    close(slot.grad(tm, tp.data, bp_t), jslot.grad(jm, jp.data, bp_j),
          "grad scalar")
    bU_j, bU_t = jU.boundary_values(jm), tU.boundary_values(tm)
    close(slot.grad(tm, tU.data, bU_t), jslot.grad(jm, jU.data, bU_j),
          "grad vector")
    close(tuple(slot.flux_of(tm, tU.data, bv=phi_t[jm.n_internal_faces:])),
          tuple(jslot.flux_of(jm, jU.data,
                              bv=phi_j[jm.n_internal_faces:])), "flux_of")
    gj = jslot.from_flat(jm, jnp.asarray(ex["gamma"]))
    gt = slot.from_flat(tm, _t(ex["gamma"]))
    for corrected in (False, True):
        close(tuple(slot.laplacian_flux(tm, gt, tp.data, corrected)),
              tuple(jslot.laplacian_flux(jm, gj, jp.data, corrected)),
              "laplacian_flux")
    corr_t = slot.laplacian_correction(tm, gt, tp.data, bp_t)
    corr_j = jslot.laplacian_correction(jm, gj, jp.data, bp_j)
    close(tuple(corr_t[0]), tuple(corr_j[0]), "lap corr face")
    close(corr_t[1], corr_j[1], "lap corr cell")
    soff = np.asarray(jm.st_valid) * ex["gamma"][np.asarray(jm.st_cface)]
    sfb = ex["gamma"][np.asarray(jm.fb_faces)]
    for data_j, data_t in ((jp.data, tp.data), (jU.data, tU.data)):
        close(slot.off_apply(tm, _t(soff), _t(sfb), data_t),
              jslot.off_apply(jm, jnp.asarray(soff), jnp.asarray(sfb),
                              data_j), "off_apply")


def test_fvm_ops(case):
    jm, tm, (jU, jp), (tU, tp), ex = case
    rdt = 200.0
    _close_matrix(fvm.ddt(tm, tU, tU.data, torch.tensor(rdt)),
                  jfvm.ddt(jm, jU, jU.data, jnp.asarray(rdt, jnp.float32)),
                  "ddt")
    phi_j, phi_t = jnp.asarray(ex["phi"]), _t(ex["phi"])
    _close_matrix(fvm.div(tm, phi_t, tU, phi_slot=slot.from_flat(tm, phi_t)),
                  jfvm.div(jm, phi_j, jU, phi_slot=jslot.from_flat(jm, phi_j)),
                  "div slot")
    nu = 0.01
    _close_matrix(
        fvm.laplacian(tm, torch.tensor(nu), tU, corrected=False,
                      gamma_dims=tdims.dimViscosity),
        jfvm.laplacian(jm, jnp.asarray(nu, jnp.float32), jU, corrected=False,
                       gamma_dims=dimViscosity), "laplacian scalar")
    g_j, g_t = jnp.asarray(ex["gamma"]), _t(ex["gamma"])
    _close_matrix(
        fvm.laplacian(tm, g_t, tp, corrected=False, gamma_dims=tdims.dimTime,
                      gamma_slot=slot.from_flat(tm, g_t)),
        jfvm.laplacian(jm, g_j, jp, corrected=False, gamma_dims=dimTime,
                       gamma_slot=jslot.from_flat(jm, g_j)), "laplacian slot")
    _close_matrix(
        fvm.laplacian(tm, g_t, tp, corrected=False,
                      gamma_dims=tdims.dimTime),
        jfvm.laplacian(jm, g_j, jp, corrected=False, gamma_dims=dimTime),
        "laplacian flat")


def test_fvc_ops(case):
    jm, tm, (jU, jp), (tU, tp), ex = case
    close(fvc.grad_of(tm, tp), jfvc.grad_of(jm, jp), "grad p")
    close(fvc.grad_of(tm, tU, "Gauss linear"),
          jfvc.grad_of(jm, jU, "Gauss linear"), "grad U")
    close(fvc.flux(tm, tU), jfvc.flux(jm, jU), "flux")
    # the least-squares gradient and the limiter on top of it
    # (tests/test_torch_grad.py holds every scheme in float64); an
    # unknown scheme is refused as the reference refuses it
    # (jitted: the reference compiles once, not once per eager op)
    jgrad_of = jax.jit(jfvc.grad_of, static_argnums=2)
    scheme = "cellLimited leastSquares 0.5"
    close(fvc.grad_of(tm, tp, scheme), jgrad_of(jm, jp, scheme),
          f"grad p {scheme}")
    close(fvc.grad_of(tm, tU, "leastSquares"),
          jgrad_of(jm, jU, "leastSquares"), "grad U leastSquares")
    with pytest.raises(ValueError, match="gradScheme"):
        fvc.grad_of(tm, tp, "fourth")


def _momentum(jm, tm, jU, tU, ex):
    phi_j, phi_t = jnp.asarray(ex["phi"]), _t(ex["phi"])
    rdt = 200.0
    jm_ = (jfvm.ddt(jm, jU, jU.data, jnp.asarray(rdt, jnp.float32))
           + jfvm.div(jm, phi_j, jU, phi_slot=jslot.from_flat(jm, phi_j))
           - jfvm.laplacian(jm, jnp.asarray(0.01, jnp.float32), jU,
                            corrected=False, gamma_dims=dimViscosity))
    tm_ = (fvm.ddt(tm, tU, tU.data, torch.tensor(rdt))
           + fvm.div(tm, phi_t, tU, phi_slot=slot.from_flat(tm, phi_t))
           - fvm.laplacian(tm, torch.tensor(0.01), tU, corrected=False,
                           gamma_dims=tdims.dimViscosity))
    return jm_, tm_


def test_matrix_ops(case):
    jm, tm, (jU, jp), (tU, tp), ex = case
    jM, tM = _momentum(jm, tm, jU, tU, ex)
    _close_matrix(tM, jM, "UEqn")
    close(tM.A(tm), jM.A(jm), "A")
    close(tM.H(tm, tU.data), jM.H(jm, jU.data), "H vector")
    close(tM.diag_eff(tm), jM.diag_eff(jm), "diag_eff")
    close(tM.source_eff(tm), jM.source_eff(jm), "source_eff")
    close(tM.row_sum(tm), jM.row_sum(jm), "row_sum")
    src = np.asarray(ex["bvec"][:1]).repeat(jm.n_cells, 0)
    close(tM.add_source(_t(src), tm).source,
          jM.add_source(jnp.asarray(src), jm).source, "add_source")
    g_j, g_t = jnp.asarray(ex["gamma"]), _t(ex["gamma"])
    jP = jfvm.laplacian(jm, g_j, jp, corrected=False, gamma_dims=dimTime,
                        gamma_slot=jslot.from_flat(jm, g_j))
    tP = fvm.laplacian(tm, g_t, tp, corrected=False,
                       gamma_dims=tdims.dimTime,
                       gamma_slot=slot.from_flat(tm, g_t))
    close(tP.H(tm, tp.data), jP.H(jm, jp.data), "H scalar")
    close(tP.flux(tm, tp.data), jP.flux(jm, jp.data), "flux")
    close(tP.off_mul(tm, tp.data), jP.off_mul(jm, jp.data), "off_mul")
    _close_matrix(tP.set_reference(3, 0.5), jP.set_reference(3, 0.5),
                  "set_reference")
    _close_matrix(tP - tP.set_reference(0, 1.0),
                  jP - jP.set_reference(0, 1.0), "sub")


def test_fixed_gradient_and_mixed_bcs(case):
    """The fixedGradient and mixed kinds (and the reference's aliases
    tractionDisplacement -> fixedGradient, waveSurfacePressure -> mixed)
    from boundaryField entries, their value and gradient coefficients,
    face values, and the laplacian and convection matrices they give, on
    random per-face data; a kind outside the port still raises."""
    from foamtpu.bc import factory as jfactory
    from foamtpu_torch.bc import factory as tfactory
    from foamtpu_torch.bc import patchfields as tpf
    from foamtpu_torch.core.dictionary import parse_string as tparse

    jm, tm, (jU, jp), (tU, tp), ex = case
    rng = np.random.default_rng(11)
    walls = [i for i, p in enumerate(jm.patches) if p.type != "empty"]
    specs = {}
    for n, i in enumerate(walls):
        size = jm.patches[i].size
        vals = " ".join(repr(float(x)) for x in rng.standard_normal(size))
        fracs = " ".join(repr(float(x)) for x in rng.random(size))
        specs[i] = [
            f"type fixedGradient; gradient nonuniform List<scalar> {size} "
            f"({vals});",
            f"type mixed; refValue uniform 0.7; refGradient nonuniform "
            f"List<scalar> {size} ({vals}); valueFraction nonuniform "
            f"List<scalar> {size} ({fracs});",
            "type tractionDisplacement; gradient uniform 0.3; traction "
            "uniform (1 0 0); pressure uniform 0;",
            "type waveSurfacePressure; value uniform 0;"][n % 4]
    jb, tb = list(jp.bcs), list(tp.bcs)
    for i, text in specs.items():
        j = jfactory.from_dict(jparse(text), jm.patches[i], 0, np.float32)
        t = tfactory.from_dict(tparse(text), tm.patches[i], 0,
                               torch.float32)
        assert t.kind == j.kind and t.kind in ("fixedGradient", "mixed")
        for key in ("ref_value", "ref_grad", "vfrac"):
            close(torch.as_tensor(getattr(t, key)), getattr(j, key),
                  f"{t.kind}.{key}")
        jb[i], tb[i] = j, t
    jf = jp.replace(bcs=jpf.normalize_bcs(jm, tuple(jb), 0))
    tf = tp.replace(bcs=tpf.normalize_bcs(tm, tuple(tb), 0))
    for i in walls:
        jpatch, tpatch = jm.patches[i], tm.patches[i]
        close(tpf.value_coeffs(tf.bcs[i], tm, tpatch, tf.data),
              jpf.value_coeffs(jf.bcs[i], jm, jpatch, jf.data), "value")
        close(tpf.grad_coeffs(tf.bcs[i], tm, tpatch, tf.data),
              jpf.grad_coeffs(jf.bcs[i], jm, jpatch, jf.data), "grad")
        close(tpf.evaluate(tf.bcs[i], tm, tpatch, tf.data),
              jpf.evaluate(jf.bcs[i], jm, jpatch, jf.data), "evaluate")
    g_j, g_t = jnp.asarray(ex["gamma"]), _t(ex["gamma"])
    _close_matrix(
        fvm.laplacian(tm, g_t, tf, corrected=False, gamma_dims=tdims.dimTime,
                      gamma_slot=slot.from_flat(tm, g_t)),
        jfvm.laplacian(jm, g_j, jf, corrected=False, gamma_dims=dimTime,
                       gamma_slot=jslot.from_flat(jm, g_j)), "laplacian")
    phi_j, phi_t = jnp.asarray(ex["phi"]), _t(ex["phi"])
    _close_matrix(fvm.div(tm, phi_t, tf, phi_slot=slot.from_flat(tm, phi_t)),
                  jfvm.div(jm, phi_j, jf, phi_slot=jslot.from_flat(jm, phi_j)),
                  "div")
    with pytest.raises(NotImplementedError, match="fixedMean"):
        tfactory.from_dict(tparse("type fixedMean; meanValue 1;"),
                           tm.patches[walls[0]], 0, torch.float32)
