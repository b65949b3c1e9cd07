"""foamtpu_torch gradient schemes and the slip family of boundary
conditions against the JAX package, in float64.

In a process of its own (FOAMTPU_X64=1, JAX_ENABLE_X64=1): on the 16^2
cavity of tests/test_schemes_ddt_grad.py and on a small tet box
(non-orthogonal, with a COO remainder), seeded scalar and vector fields
with fixedValue, zeroGradient, slip and symmetryPlane patches go through
the reference's `grad_least_squares`, `grad_cell_limited` (k = 1 and
0.5) and `grad_of` (every scheme string it dispatches) and through the
port's, the port's inputs converted from the reference's
(`convert.field_from_numpy`). Each result is held at 1e-9 of its scale.
The slip family (slip, symmetryPlane, symmetry, wedge: one value rule)
is held through the BC's value and gradient coefficients, its face
values and a laplacian matrix that carries it, at 1e-12.

Then, in float32 in this process, the properties of
tests/test_schemes_ddt_grad.py: least squares is exact for linear
scalar and vector fields, the limiter leaves a linear field alone and
keeps a step's extrapolations inside the neighbours' extrema.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from foamtpu_torch.apps.cases import cavity_polymesh
from foamtpu_torch.bc import patchfields as pf
from foamtpu_torch.core.dimensions import dimVelocity
from foamtpu_torch.core.fields import vol_scalar, vol_vector
from foamtpu_torch.mesh import to_device
from foamtpu_torch.ops import fvc

from test_torch_simple import REPO

torch.set_num_threads(2)

SCHEMES = ["Gauss linear", "linear", "leastSquares",
           "cellLimited Gauss linear 1", "cellLimited leastSquares 0.5",
           "faceLimited Gauss linear 1", "Gauss pointLinear"]
MESHES = ["cavity16", "tet"]
KINDS = ["slip", "symmetryPlane", "symmetry", "wedge"]

F64_BODY = r"""
import json
import jax
import jax.numpy as jnp
import numpy as np
import torch

from foamtpu.bc import patchfields as jpf
from foamtpu.core.dictionary import parse_string as jparse
from foamtpu.core.fields import vol_scalar as jvs, vol_vector as jvv
from foamtpu.core.dimensions import dimless as jdl
from foamtpu.apps.cases import CAVITY_BLOCKMESH
from foamtpu.mesh import blockmesh as jblockmesh, to_device as jto_device
from foamtpu.mesh.tetmesh import tet_box
from foamtpu.ops import fvc as jfvc, fvm as jfvm

from foamtpu_torch.bc import patchfields as tpf
from foamtpu_torch.convert import field_from_numpy, mesh_from_numpy
from foamtpu_torch.core.dimensions import dimless as tdl
from foamtpu_torch.ops import fvc as tfvc, fvm as tfvm

SCHEMES = %(schemes)r
KINDS = %(kinds)r
out = {}


# jitted, the reference compiles once per mesh and rank instead of once
# per eager operation
@jax.jit
def ref_grads(jm, jf):
    g = jfvc.grad(jm, jf)
    res = {"leastSquares": jfvc.grad_least_squares(jm, jf)}
    for k in (1.0, 0.5):
        res[f"cellLimited {k}"] = jfvc.grad_cell_limited(jm, jf, g, k)
    for s in SCHEMES:
        res[f"grad_of {s}"] = jfvc.grad_of(jm, jf, s)
    return res


@jax.jit
def ref_bc(jm, jf):
    res = []
    for p, bc in zip(jm.patches, jf.bcs):
        if bc.kind not in ("empty", "fixedValue", "zeroGradient"):
            res += list(jpf.value_coeffs(bc, jm, p, jf.data))
            res += list(jpf.grad_coeffs(bc, jm, p, jf.data))
    mat = jfvm.laplacian(jm, 0.01, jf, corrected=False, gamma_dims=jdl)
    res.append(jf.boundary_values(jm))
    return res + [getattr(mat, n) for n in ("diag", "ic", "bc", "upper",
                                             "lower", "source")]


def rel(got, ref):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.float64
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300))


def fields(jm, rng, slip_kind="slip"):
    cf = np.asarray(jm.cf)
    sb, vb = [], []
    for i, p in enumerate(jm.patches):
        if p.type == "empty":
            sb.append(jpf.PatchField(kind="empty", vfrac=0.0))
            vb.append(jpf.PatchField(kind="empty", vfrac=0.0))
        elif i %% 3 == 0:
            sb.append(jpf.fixed_value(jnp.asarray(rng.random(p.size))))
            vb.append(jpf.fixed_value(jnp.asarray(rng.random((p.size, 3)))))
        elif i %% 3 == 1:
            sb.append(jpf.PatchField(kind=slip_kind, vfrac=0.0))
            vb.append(jpf.PatchField(kind=slip_kind, vfrac=0.0))
        else:
            sb.append(jpf.zero_gradient())
            vb.append(jpf.zero_gradient())
    c = np.asarray(jm.c)
    # smooth part plus a step plus noise: every limiter branch is taken
    base = np.sin(7.0 * c[:, 0]) + (c[:, 1] > c[:, 1].mean())
    s = base + 0.1 * rng.random(jm.n_cells)
    v = np.stack([base, -2.0 * base, 0.5 * base], 1) \
        + 0.1 * rng.random((jm.n_cells, 3))
    js = jvs(jm, 0.0, bcs=tuple(sb)).with_data(jnp.asarray(s))
    jv = jvv(jm, jnp.zeros(3), bcs=tuple(vb)).with_data(jnp.asarray(v))
    return js, jv


meshes = {
    "cavity16": jto_device(jblockmesh.generate(
        jparse(CAVITY_BLOCKMESH.replace("{n}", "16")))),
    "tet": jto_device(tet_box(4, 3, 3)),
}
for mname, jm in meshes.items():
    tm = mesh_from_numpy(jm, device="cpu")
    rng = np.random.default_rng(7)
    for fname, jf in zip(("scalar", "vector"), fields(jm, rng)):
        tf = field_from_numpy(jf, device="cpu")
        key = f"{mname}/{fname}"
        ref = ref_grads(jm, jf)
        out[f"{key}/leastSquares"] = rel(tfvc.grad_least_squares(tm, tf),
                                         ref["leastSquares"])
        g_t = tfvc.grad(tm, tf)
        for k in (1.0, 0.5):
            out[f"{key}/cellLimited {k}"] = rel(
                tfvc.grad_cell_limited(tm, tf, g_t, k),
                ref[f"cellLimited {k}"])
        for s in SCHEMES:
            out[f"{key}/grad_of {s}"] = rel(tfvc.grad_of(tm, tf, s),
                                            ref[f"grad_of {s}"])

jm = meshes["cavity16"]
tm = mesh_from_numpy(jm, device="cpu")
for kind in KINDS:
    rng = np.random.default_rng(11)
    for fname, jf in zip(("scalar", "vector"), fields(jm, rng, kind)):
        tf = field_from_numpy(jf, device="cpu")
        got = []
        for p, tbc in zip(tm.patches, tf.bcs):
            if tbc.kind == kind:
                got += list(tpf.value_coeffs(tbc, tm, p, tf.data))
                got += list(tpf.grad_coeffs(tbc, tm, p, tf.data))
        assert got, kind
        tmat = tfvm.laplacian(tm, 0.01, tf, corrected=False, gamma_dims=tdl)
        got.append(tf.boundary_values(tm))
        got += [getattr(tmat, n) for n in ("diag", "ic", "bc", "upper",
                                           "lower", "source")]
        ref = ref_bc(jm, jf)
        assert len(ref) == len(got)
        out[f"bc/{kind}/{fname}"] = max(rel(g, r) for g, r in zip(got, ref))
print(json.dumps(out))
""" % {"schemes": SCHEMES, "kinds": KINDS}


@pytest.fixture(scope="module")
def f64():
    env = dict(os.environ)
    env.update(FOAMTPU_X64="1", JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", F64_BODY], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("field", ["scalar", "vector"])
@pytest.mark.parametrize("mesh", MESHES)
def test_least_squares_and_limited_match_reference_f64(f64, mesh, field):
    key = f"{mesh}/{field}"
    for name in ("leastSquares", "cellLimited 1.0", "cellLimited 0.5"):
        assert f64[f"{key}/{name}"] <= 1e-9, (key, name, f64[f"{key}/{name}"])


@pytest.mark.parametrize("scheme", SCHEMES)
def test_grad_of_dispatch_matches_reference_f64(f64, scheme):
    for mesh in MESHES:
        for field in ("scalar", "vector"):
            err = f64[f"{mesh}/{field}/grad_of {scheme}"]
            assert err <= 1e-9, (mesh, field, scheme, err)


@pytest.mark.parametrize("kind", KINDS)
def test_slip_family_matches_reference_f64(f64, kind):
    for field in ("scalar", "vector"):
        assert f64[f"bc/{kind}/{field}"] <= 1e-12, (kind, field)


# ---------------------------------------------------------------------------
# float32 properties (tests/test_schemes_ddt_grad.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh16():
    return to_device(cavity_polymesh(16), "cpu")


def _linear_bcs(mesh, fn):
    cf = mesh.cf.numpy()
    bcs = []
    for p in mesh.patches:
        if p.type == "empty":
            bcs.append(pf.PatchField(kind="empty", vfrac=0.0))
        else:
            bcs.append(pf.fixed_value(torch.as_tensor(fn(cf[p.slice]),
                                                      dtype=mesh.v.dtype)))
    return tuple(bcs)


def _linear_scalar(mesh, a=(2.0, -3.0, 0.0), b=0.5):
    fn = lambda x: x @ np.asarray(a) + b  # noqa: E731
    f = vol_scalar(mesh, 0.0, bcs=_linear_bcs(mesh, fn))
    return f.with_data(torch.as_tensor(fn(mesh.c.numpy()), dtype=mesh.v.dtype))


def test_least_squares_is_exact_for_linear_fields(mesh16):
    g = fvc.grad_least_squares(mesh16, _linear_scalar(mesh16)).numpy()
    np.testing.assert_allclose(g, np.broadcast_to([2.0, -3.0, 0.0], g.shape),
                               atol=1e-4)
    A = np.array([[1.0, 2.0, 0.0], [4.0, -1.0, 0.0], [0.0, 0.0, 0.0]])
    U = vol_vector(mesh16, torch.zeros(3), dims=dimVelocity,
                   bcs=_linear_bcs(mesh16, lambda x: x @ A)).with_data(
        torch.as_tensor(mesh16.c.numpy() @ A, dtype=mesh16.v.dtype))
    g = fvc.grad_least_squares(mesh16, U).numpy()   # g[c,i,j] = d_i u_j
    np.testing.assert_allclose(g, np.broadcast_to(A, g.shape), atol=2e-4)


def test_cell_limited_keeps_extrapolations_bounded(mesh16):
    f = _linear_scalar(mesh16)
    g0 = fvc.grad(mesh16, f)
    np.testing.assert_allclose(fvc.grad_cell_limited(mesh16, f, g0, 1.0),
                               g0, rtol=1e-5, atol=1e-6)
    c = mesh16.c.numpy()
    data = (c[:, 0] > 0.05).astype(np.float32)
    fs = vol_scalar(mesh16, 0.0, bcs=f.bcs).with_data(torch.as_tensor(data))
    g = fvc.grad(mesh16, fs)
    gl = fvc.grad_cell_limited(mesh16, fs, g, 1.0).numpy()
    assert (np.linalg.norm(gl, axis=1)
            <= np.linalg.norm(g.numpy(), axis=1) + 1e-12).all()
    valid = mesh16.cnbr_valid.numpy()
    vn = data[mesh16.cnbr.numpy()]
    vmax = np.max(np.where(valid > 0, vn, -np.inf), axis=1)
    vmin = np.min(np.where(valid > 0, vn, np.inf), axis=1)
    pres = np.abs(mesh16.csign.numpy())
    rvec = (mesh16.cf.numpy()[mesh16.cface.numpy()] - c[:, None, :]) \
        * pres[:, :, None]
    ext = np.einsum("cki,ci->ck", rvec, gl)
    ok = ext <= np.maximum(vmax - data, 0.0)[:, None] + 1e-6
    ok &= ext >= np.minimum(vmin - data, 0.0)[:, None] - 1e-6
    assert (ok | (valid == 0)).all()
