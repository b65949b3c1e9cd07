"""foamtpu_torch offset-stencil SpMV (ops/spmv.py, ops/stencil.py).

- The plain torch version against the JAX package's StencilOp
  (apply_off and matvec; on the CPU the reference runs its jnp.roll
  chain, as its own tests do) at the shapes of tests/test_pallas_spmv.py,
  float32 at rtol 2e-6 / atol 2e-5: the same elementwise operations in
  the same order, so only last-bit rounding differences are allowed.
- The CUDA kernel against the plain version on the card (marked `cuda`,
  skipped without a card).
- An import test: the port runs without jax and the JAX package.

The file imports jax lazily (importorskip inside the reference tests), so
on a machine with a card and no jax the kernel tests still run:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spmv.py
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from foamtpu_torch.ops import spmv
from foamtpu_torch.ops import stencil

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHAPES = [
    (1024, (1, -1, 16, -16)),
    (160000, (1, -1, 400, -400)),
    (5000, (1, -1, 128, -128, 3000, -3000)),
]


def _inputs(n, deltas, ncols=1, seed=0):
    """Random operands with the st_valid contract: coefficients whose
    neighbour c+d is out of range are zero."""
    rng = np.random.default_rng(seed)
    shape = (n,) if ncols == 1 else (n, ncols)
    x = rng.standard_normal(shape).astype(np.float32)
    diag = rng.standard_normal(shape).astype(np.float32)
    soff = rng.standard_normal((n, len(deltas))).astype(np.float32)
    idx = np.arange(n)
    for m, d in enumerate(deltas):
        soff[(idx + d < 0) | (idx + d >= n), m] = 0.0
    return diag, x, soff


def _reference():
    """The JAX package's jnp and StencilOp (skips where jax is absent)."""
    jnp = pytest.importorskip("jax.numpy")
    from foamtpu.ops import stencil as jstencil

    return jnp, jstencil


def _ops(soff, deltas):
    jnp, jstencil = _reference()
    empty_i = np.zeros(0, np.int32)
    empty_f = np.zeros(0, np.float32)
    jop = jstencil.StencilOp(tuple(deltas), jnp.asarray(soff),
                             jnp.asarray(empty_i), jnp.asarray(empty_i),
                             jnp.asarray(empty_f))
    t = torch.from_numpy
    top = stencil.StencilOp(tuple(deltas), t(soff),
                            torch.zeros(0, dtype=torch.int64),
                            torch.zeros(0, dtype=torch.int64),
                            torch.zeros(0))
    return jop, top


@pytest.mark.parametrize("ncols", [1, 3])
@pytest.mark.parametrize("n,deltas", SHAPES)
def test_plain_matches_reference_stencil(n, deltas, ncols):
    jnp, _ = _reference()
    diag, x, soff = _inputs(n, deltas, ncols)
    jop, top = _ops(soff, deltas)
    ref_off = np.asarray(jop.apply_off(jnp.asarray(x)))
    got_off = top.apply_off(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_off, ref_off, rtol=2e-6, atol=2e-5)
    ref_mv = np.asarray(jop.matvec(jnp.asarray(diag), jnp.asarray(x)))
    got_mv = top.matvec(torch.from_numpy(diag), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_mv, ref_mv, rtol=2e-6, atol=2e-5)


def test_fallback_added_after_stencil():
    """The COO fallback rides index_add after the kernel, as the
    reference adds it after its Pallas call."""
    jnp, jstencil = _reference()
    n, deltas = 64, (1, -1, 8, -8)
    diag, x, soff = _inputs(n, deltas)
    rng = np.random.default_rng(1)
    fb_c = rng.integers(0, n, 10)
    fb_n = rng.integers(0, n, 10)
    fb_v = rng.standard_normal(10).astype(np.float32)
    jop = jstencil.StencilOp(tuple(deltas), jnp.asarray(soff),
                             jnp.asarray(fb_c.astype(np.int32)),
                             jnp.asarray(fb_n.astype(np.int32)),
                             jnp.asarray(fb_v))
    t = torch.from_numpy
    top = stencil.StencilOp(tuple(deltas), t(soff), t(fb_c), t(fb_n), t(fb_v))
    ref = np.asarray(jop.matvec(jnp.asarray(diag), jnp.asarray(x)))
    got = top.matvec(t(diag), t(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-5)


def test_wrapper_rejects_bad_operands():
    diag, x, soff = (torch.from_numpy(a) for a in _inputs(64, (1, -1)))
    with pytest.raises(ValueError):
        spmv.spmv(diag, x, soff[:, :1], (1, -1))
    with pytest.raises(ValueError):
        spmv.spmv(diag, x, soff.T.contiguous().T, (1, -1))
    with pytest.raises(ValueError):
        spmv.spmv(diag.double(), x, soff, (1, -1))
    with pytest.raises(ValueError):
        spmv.spmv(None, x, torch.zeros(64, 17), tuple(range(1, 18)))


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,deltas", SHAPES)
def test_kernel_matches_plain_on_card(cuda_card, n, deltas, dtype):
    # float32: rtol 2e-6 / atol 2e-5 (FMA and summation order differ);
    # float64: rtol 1e-12, atol 1e-12 for outputs that cancel to ~0
    tol = (2e-6, 2e-5) if dtype == torch.float32 else (1e-12, 1e-12)
    for ncols in (1, 3):
        diag, x, soff = (torch.from_numpy(a).to(cuda_card, dtype)
                         for a in _inputs(n, deltas, ncols))
        for d in (diag, None):
            before = spmv.LAUNCHES
            got = spmv.spmv(d, x, soff, deltas)
            torch.cuda.synchronize()
            assert spmv.LAUNCHES == before + 1
            ref = spmv.plain(d, x, soff, deltas)
            torch.testing.assert_close(got, ref, rtol=tol[0], atol=tol[1])


IMPORT_BODY = r"""
import json, sys
import foamtpu_torch
from foamtpu_torch.apps.cases import make_cavity
from foamtpu_torch.solvers import piso
mesh, state, cfg = make_cavity(20)
step = piso.make_step(mesh, cfg)
for _ in range(2):
    state, diag = step(state, 0.005)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "foamtpu"
             or m.startswith("foamtpu."))
print(json.dumps({"bad": bad, "continuity": float(diag["continuity"])}))
"""


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", IMPORT_BODY], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["bad"] == [], out
    assert out["continuity"] < 1e-4
