"""foamtpu_torch offset-stencil SpMV (ops/spmv.py, ops/stencil.py).

- The plain torch version against the JAX package's StencilOp
  (apply_off and matvec; on the CPU the reference runs its jnp.roll
  chain, as its own tests do) at the shapes of tests/test_pallas_spmv.py,
  float32 at rtol 2e-6 / atol 2e-5: the same elementwise operations in
  the same order, so only last-bit rounding differences are allowed.
- The CUDA kernel against the plain version on the card (marked `cuda`,
  skipped without a card).
- An import test: the port (and chip_smoke.py) runs without jax and the
  JAX package, through a cavity PISO step and a duct SIMPLE iteration.
- The COO remainder's row layout (spmv.row_layout), which the fused
  kernel reads: evaluated through the layout by a plain per-row sum it
  reproduces index_add over the COO (float64, 1e-14) for a random
  unsorted COO, a tet mesh's fallback and every GAMG level's two
  fallbacks; a bad layout is rejected; the CPU path stays the roll chain
  then index_add, bit for bit.

The file imports jax lazily (importorskip inside the reference tests), so
on a machine with a card and no jax the kernel tests still run:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spmv.py
"""

import dataclasses
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


def _random_coo(n, rng, nfb=None):
    """An unsorted COO remainder with repeated cells, rows with no entry
    (the upper half and random gaps) and one row of six entries."""
    nfb = nfb or max(n // 3, 12)
    cells = rng.integers(0, max(n // 2, 1), nfb)
    cells[rng.choice(nfb, 6, replace=False)] = n // 4
    nbrs = rng.integers(0, n, nfb)
    return cells, nbrs


def _rows_sum(fb, x):
    """The remainder through its row layout, one row at a time: what the
    kernel computes, as a plain loop."""
    rowptr = fb.layout.rowptr.tolist()
    col = fb.layout.col.long()
    out = torch.zeros_like(x)
    for c in range(len(rowptr) - 1):
        for e in range(rowptr[c], rowptr[c + 1]):
            out[c] += fb.vals[e] * x[col[e]]
    return out


def _check_layout(cells, nbrs, n):
    cells = torch.as_tensor(np.asarray(cells), dtype=torch.int64)
    nbrs = torch.as_tensor(np.asarray(nbrs), dtype=torch.int64)
    lay = spmv.row_layout(cells, nbrs, n, "cpu")
    assert lay.rowptr.dtype == lay.col.dtype == torch.int32
    assert lay.rowptr.shape == (n + 1,) and int(lay.rowptr[-1]) == len(cells)
    assert (lay.order is None) == bool(torch.all(cells[1:] >= cells[:-1]))
    rng = np.random.default_rng(n)
    coeffs = torch.from_numpy(rng.standard_normal(len(cells)))
    fb = spmv.remainder(cells, nbrs, coeffs, lay)
    if fb is None:
        assert len(cells) == 0 and int(lay.rowptr.max()) == 0
        return lay
    for shape in ((n,), (n, 3)):
        x = torch.from_numpy(rng.standard_normal(shape))
        pn = x[nbrs]
        ref = torch.zeros_like(x).index_add(
            0, cells, coeffs[:, None] * pn if x.ndim == 2 else coeffs * pn)
        torch.testing.assert_close(_rows_sum(fb, x), ref, rtol=0, atol=1e-14)
    return lay


def test_row_layout_of_a_random_unsorted_coo():
    n = 200
    cells, nbrs = _random_coo(n, np.random.default_rng(0))
    lay = _check_layout(cells, nbrs, n)
    assert lay.order is not None and lay.n_cols == int(nbrs.max()) + 1
    counts = np.diff(lay.rowptr.numpy())
    assert counts.max() >= 6 and (counts == 0).sum() > n // 2


def _tet_levels(size, pairwise, monkeypatch):
    from foamtpu_torch.mesh import to_device
    from foamtpu_torch.mesh.tetmesh import tet_box
    from foamtpu_torch.solvers.linear import gamg

    monkeypatch.setenv("FOAMTPU_GAMG_NC", "8")
    monkeypatch.setenv("FOAMTPU_GAMG_PAIRWISE", pairwise)
    mesh = to_device(tet_box(*size), "cpu")
    return mesh, gamg.hierarchy_for_mesh(mesh)


@pytest.mark.parametrize("size,pairwise", [((4, 2, 2), "auto"),
                                           ((4, 2, 2), "1"),
                                           ((8, 4, 4), "auto")])
def test_row_layout_of_tet_mesh_and_gamg_levels(size, pairwise, monkeypatch):
    """The fine mesh's fallback (row-sorted: no order), each level's
    gather-path fallback (st) and, on plane levels, its plane-path
    fallback (pfb, concatenated from two sources: (8,4,4) has an
    unsorted one). The layouts on the mesh and the levels are the ones
    to_device and the hierarchy built."""
    mesh, levels = _tet_levels(size, pairwise, monkeypatch)
    assert levels and mesh.fb_cells.shape[0]
    lay = _check_layout(mesh.fb_cells, mesh.fb_nbrs, mesh.n_cells)
    assert lay.order is None and mesh.fb_layout.order is None
    assert torch.equal(mesh.fb_layout.rowptr, lay.rowptr)
    unsorted = 0
    for lv in levels:
        _check_layout(lv.st["fb_cells"], lv.st["fb_nbrs"], lv.n_coarse)
        assert torch.equal(lv.fb_layout.col, spmv.row_layout(
            lv.st["fb_cells"], lv.st["fb_nbrs"], lv.n_coarse, "cpu").col)
        assert (lv.pfb_cells is not None) == lv.plane_ok == (pairwise != "1")
        if lv.plane_ok:
            pl = _check_layout(lv.pfb_cells, lv.pfb_nbrs, lv.n_coarse)
            unsorted += pl.order is not None
            assert (lv.pfb_layout.order is None) == (pl.order is None)
    assert (unsorted > 0) == (size == (8, 4, 4))


def test_row_layout_rejects_rows_outside_the_operator():
    with pytest.raises(ValueError):
        spmv.row_layout(np.array([0, 5]), np.array([1, 2]), 5, "cpu")
    with pytest.raises(ValueError):
        spmv.row_layout(np.array([0, 1]), np.array([1, -1]), 5, "cpu")


def test_check_rejects_bad_remainder():
    n, deltas = 64, (1, -1, 8, -8)
    diag, x, soff = (torch.from_numpy(a) for a in _inputs(n, deltas))
    cells, nbrs = _random_coo(n, np.random.default_rng(3))
    cells_t, nbrs_t = torch.from_numpy(cells), torch.from_numpy(nbrs)
    coeffs = torch.ones(len(cells))
    good = spmv.row_layout(cells, nbrs, n, "cpu")
    spmv.spmv(diag, x, soff, deltas,
              spmv.remainder(cells_t, nbrs_t, coeffs, good))
    bad_col = nbrs.copy()
    bad_col[3] = n                      # a column out of range
    bad = [spmv.row_layout(cells, nbrs, n + 1, "cpu"),   # rowptr length
           dataclasses.replace(good, rowptr=good.rowptr.long()),
           dataclasses.replace(good, col=good.col.long()),
           spmv.row_layout(cells, bad_col, n, "cpu")]
    for lay in bad:
        with pytest.raises(ValueError):
            spmv.spmv(diag, x, soff, deltas,
                      spmv.remainder(cells_t, nbrs_t, coeffs, lay))
    with pytest.raises(ValueError):     # coefficients of another dtype
        spmv.spmv(diag, x, soff, deltas,
                  spmv.remainder(cells_t, nbrs_t, coeffs.double(), good))


@pytest.mark.parametrize("ncols", [1, 3])
def test_cpu_path_is_roll_chain_then_index_add(ncols):
    """On CPU tensors the operator is the roll chain, diag*x, then the
    remainder by index_add in COO order: bit for bit, and no launch."""
    n, deltas = 300, (1, -1, 20, -20)
    diag, x, soff = (torch.from_numpy(a).double()
                     for a in _inputs(n, deltas, ncols))
    cells, nbrs = _random_coo(n, np.random.default_rng(4))
    coeffs = torch.from_numpy(np.random.default_rng(5).standard_normal(
        len(cells)))
    cells, nbrs = torch.from_numpy(cells), torch.from_numpy(nbrs)
    op = stencil.StencilOp(deltas, soff, cells, nbrs, coeffs,
                           spmv.row_layout(cells, nbrs, n, "cpu"))
    acc = torch.zeros_like(x)
    for m, d in enumerate(deltas):
        c = soff[:, m] if ncols == 1 else soff[:, m, None]
        acc = acc + c * torch.roll(x, -d, 0)
    pn = x[nbrs]
    contrib = coeffs * pn if ncols == 1 else coeffs[:, None] * pn
    launches = (spmv.LAUNCHES, spmv.FB_LAUNCHES)
    assert torch.equal(op.matvec(diag, x),
                       (diag * x + acc).index_add(0, cells, contrib))
    assert torch.equal(op.apply_off(x), acc.index_add(0, cells, contrib))
    assert (spmv.LAUNCHES, spmv.FB_LAUNCHES) == launches


def _fused_inputs(n, deltas, ncols, dtype, device, seed=0):
    diag, x, soff = (torch.from_numpy(a).to(device, dtype)
                     for a in _inputs(n, deltas, ncols, seed))
    rng = np.random.default_rng(seed + 1)
    cells, nbrs = _random_coo(n, rng)
    fb = spmv.remainder(torch.from_numpy(cells).to(device),
                        torch.from_numpy(nbrs).to(device),
                        torch.from_numpy(rng.standard_normal(len(cells)))
                        .to(device, dtype),
                        spmv.row_layout(cells, nbrs, n, device))
    return diag, x, soff, fb


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,deltas", SHAPES + [
    (5000, (1, -1, 64)),                                  # scalar soff loads
    (5000, (1, -1, 2, -2, 50, -50, 100, -100, 200, -200)),  # generic body
    (1024, ())])                                          # no slot
def test_fused_kernel_matches_plain_on_card(cuda_card, n, deltas, dtype):
    """The whole operator, remainder included, in one launch against the
    plain roll chain + index_add (tolerances as above)."""
    tol = (2e-6, 2e-5) if dtype == torch.float32 else (1e-12, 1e-12)
    for ncols in (1, 2, 3, 4, 8):
        diag, x, soff, fb = _fused_inputs(n, deltas, ncols, dtype, cuda_card)
        for d in (diag, None):
            before = (spmv.LAUNCHES, spmv.FB_LAUNCHES)
            got = spmv.spmv(d, x, soff, deltas, fb)
            torch.cuda.synchronize()
            assert (spmv.LAUNCHES, spmv.FB_LAUNCHES) == (before[0] + 1,
                                                         before[1] + 1)
            ref = spmv.plain(d, x, soff, deltas, fb)
            torch.testing.assert_close(got, ref, rtol=tol[0], atol=tol[1])


@pytest.mark.cuda
def test_fused_kernel_dense_assembly_on_card(cuda_card):
    """The coarsest GAMG level's assembly: the operator applied to the
    identity (C = n), remainder included."""
    n, deltas = 576, (1, -1, 8, -8, 64, -64)
    _, _, soff, fb = _fused_inputs(n, deltas, 1, torch.float64, cuda_card)
    eye = torch.eye(n, dtype=torch.float64, device=cuda_card)
    got = spmv.spmv(None, eye, soff, deltas, fb)
    torch.testing.assert_close(got, spmv.plain(None, eye, soff, deltas, fb),
                               rtol=1e-12, atol=1e-12)


IMPORT_BODY = r"""
import json, sys
import foamtpu_torch
import foamtpu_torch.mesh.gmsh, foamtpu_torch.mesh.tetmesh
import foamtpu_torch.mesh.walldist, foamtpu_torch.models.turbulence.ras
import foamtpu_torch.solvers.apps, foamtpu_torch.solvers.simple
import chip_smoke
from foamtpu_torch.apps.cases import make_cavity
from foamtpu_torch.solvers import piso
mesh, state, cfg = make_cavity(20, device="cpu")
step = piso.make_step(mesh, cfg)
for _ in range(2):
    state, diag = step(state, 0.005)
# the kOmegaSST tet duct too (tet mesher, wall distance, SIMPLE)
dmesh, dcfg, dstate, _ = chip_smoke.duct_setup(4, 2, 2, device="cpu")
dstate, ddiag = foamtpu_torch.solvers.simple.make_step(dmesh, dcfg)(dstate)
assert float(ddiag["continuity"]) < 1e-3
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
