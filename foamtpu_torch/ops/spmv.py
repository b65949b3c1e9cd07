"""Offset-stencil SpMV with its COO remainder: the hand-written CUDA
kernel and its plain version.

    y[c] = (diag[c] * x[c] if diag) + sum_m soff[c, m] * x[(c + d_m) mod n]
           + sum_{e: cells[e] = c} coeffs[e] * x[nbrs[e]]

Port of openfoam-2.2.x_tpu/ops/pallas_spmv.py::spmv_fused (the JAX
package's one Pallas kernel) together with the COO remainder that the
reference adds after it (openfoam-2.2.x_tpu/ops/stencil.py:85-87). The
kernel source is foamtpu_torch/csrc/spmv_stencil.cu; it is compiled with
nvcc for sm_90a at first use into foamtpu_torch/build/ (keyed on a hash
of the source and flags) and loaded with ctypes.

Dispatch is by the device of the operands: a CPU tensor takes `plain`,
the torch.roll chain of the reference's StencilOp.apply_off and then the
remainder by index_add in COO order; a CUDA tensor launches the kernel
once for the whole operator, remainder included, or raises. Each launch
adds one to `LAUNCHES`, and one to `FB_LAUNCHES` when it carried a
remainder; callers reset and read them to show a run went through the
kernel.

The kernel reads the remainder in a row layout (`RowLayout`, built with
numpy by `row_layout` once per mesh and per GAMG level, never per call):
int32 row pointers and columns in row order, and the stable argsort
`order` that puts COO-ordered coefficients in row order (None where the
COO is already row-sorted, as a mesh's np.nonzero-built fb_cells are).
`remainder` applies `order` to a solve's coefficients once, when the
operator is made.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

MAX_OFFSETS = 16          # SPMV_MAX_OFFSETS in the .cu source
LAUNCHES = 0              # kernel launches since import (reset by callers)
FB_LAUNCHES = 0           # of those, launches that carried a remainder

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "csrc" / "spmv_stencil.cu"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None


@dataclasses.dataclass(frozen=True)
class RowLayout:
    """Row layout of a COO remainder, for the kernel. `n_cols` is one
    more than the largest column, read on the host when the layout is
    built, so that a call checks its columns without a device sync."""

    rowptr: torch.Tensor            # [n + 1] int32
    col: torch.Tensor               # [nfb] int32, row order
    order: Optional[torch.Tensor]   # [nfb] int64 COO index per row entry
    n_cols: int


class Remainder(NamedTuple):
    """The COO remainder of one operator: entry e adds coeffs[e] *
    x[nbrs[e]] to row cells[e]."""

    cells: torch.Tensor               # [nfb] int64, COO order
    nbrs: torch.Tensor                # [nfb] int64
    coeffs: torch.Tensor              # [nfb], COO order (plain version)
    layout: Optional[RowLayout]       # for the kernel
    vals: Optional[torch.Tensor]      # coeffs in the layout's row order


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def row_layout(cells, nbrs, n: int, device) -> RowLayout:
    """The row layout of the COO remainder (cells, nbrs) of an n-row
    operator, on `device` (numpy on the host; cells and nbrs may be
    tensors or arrays)."""
    cells = _host(cells).astype(np.int64).reshape(-1)
    nbrs = _host(nbrs).astype(np.int64).reshape(-1)
    if cells.shape != nbrs.shape:
        raise ValueError("row_layout: cells and nbrs differ in length")
    if n >= 2 ** 31 or cells.size >= 2 ** 31:
        raise ValueError("row_layout: int32 indices need n, nfb < 2^31")
    if cells.size and (cells.min() < 0 or cells.max() >= n
                       or nbrs.min() < 0):
        raise ValueError("row_layout: an index lies outside [0, n)")
    order = None
    if cells.size > 1 and bool(np.any(cells[1:] < cells[:-1])):
        order = np.argsort(cells, kind="stable")
    col = nbrs if order is None else nbrs[order]
    rowptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(cells, minlength=n), out=rowptr[1:])

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return RowLayout(rowptr=dev(rowptr.astype(np.int32)),
                     col=dev(col.astype(np.int32)),
                     order=None if order is None else dev(order),
                     n_cols=int(nbrs.max()) + 1 if nbrs.size else 0)


def remainder(cells, nbrs, coeffs, layout: Optional[RowLayout] = None
              ) -> Optional[Remainder]:
    """A Remainder for spmv (None when it has no entry). The kernel's
    row-ordered coefficients are gathered here, once per operator."""
    if cells.shape[0] == 0:
        return None
    vals = None
    if layout is not None:
        vals = coeffs if layout.order is None else coeffs[layout.order]
        vals = vals.contiguous()
    return Remainder(cells, nbrs, coeffs, layout, vals)


def plain(diag: Optional[torch.Tensor], x: torch.Tensor, soff: torch.Tensor,
          deltas: Sequence[int], fb: Optional[Remainder] = None
          ) -> torch.Tensor:
    """The plain torch version: the roll chain of the reference's
    StencilOp.apply_off, plus diag*x when a diagonal is given, then the
    remainder by index_add in COO order."""
    vec = x.ndim == 2
    acc = torch.zeros_like(x)
    for m, d in enumerate(deltas):
        coeff = soff[:, m]
        acc = acc + (coeff[:, None] if vec else coeff) * torch.roll(x, -d, 0)
    if diag is not None:
        acc = diag * x + acc
    if fb is not None:
        pn = x[fb.nbrs]
        acc = acc.index_add(0, fb.cells,
                            fb.coeffs[:, None] * pn if vec else fb.coeffs * pn)
    return acc


def _check_remainder(x, fb: Remainder):
    n, nfb = x.shape[0], fb.cells.shape[0]
    if fb.cells.shape != (nfb,) or fb.nbrs.shape != (nfb,) \
            or fb.coeffs.shape != (nfb,):
        raise ValueError("spmv: remainder cells, nbrs and coeffs must be "
                         "1-D of one length")
    if fb.coeffs.dtype != x.dtype:
        raise ValueError("spmv: remainder coefficients must share x's dtype")
    for t in (fb.cells, fb.nbrs, fb.coeffs):
        if t.device != x.device:
            raise ValueError("spmv: the remainder must be on x's device")
    lay = fb.layout
    if lay is None:
        if x.device.type != "cpu":
            raise ValueError("spmv: a remainder on the card needs its row "
                             "layout (spmv.row_layout)")
    else:
        if lay.rowptr.dtype != torch.int32 or lay.col.dtype != torch.int32:
            raise ValueError("spmv: remainder rowptr and col must be int32")
        if lay.rowptr.shape != (n + 1,):
            raise ValueError(f"spmv: remainder rowptr {tuple(lay.rowptr.shape)}"
                             f" must have n + 1 = {n + 1} entries")
        if lay.col.shape != (nfb,) or fb.vals is None \
                or fb.vals.shape != (nfb,) or fb.vals.dtype != x.dtype:
            raise ValueError("spmv: remainder layout does not match its "
                             f"{nfb} entries")
        if lay.n_cols > n:
            raise ValueError(f"spmv: a remainder column reaches "
                             f"{lay.n_cols - 1}, outside [0, {n})")
        for t in (lay.rowptr, lay.col, fb.vals):
            if t.device != x.device:
                raise ValueError("spmv: the remainder must be on x's device")
            if not t.is_contiguous():
                raise ValueError("spmv: the remainder layout must be "
                                 "contiguous")


def _check(diag, x, soff, deltas, fb=None):
    if x.ndim not in (1, 2):
        raise ValueError(f"spmv: x must be [n] or [n, C], got {tuple(x.shape)}")
    n = x.shape[0]
    if soff.ndim != 2 or soff.shape[0] != n or soff.shape[1] < len(deltas):
        raise ValueError(f"spmv: soff {tuple(soff.shape)} does not match "
                         f"x {tuple(x.shape)} and {len(deltas)} offsets")
    if len(deltas) > MAX_OFFSETS:
        raise ValueError(f"spmv: {len(deltas)} offsets exceed the kernel's "
                         f"maximum of {MAX_OFFSETS}")
    ts = [x, soff] + ([] if diag is None else [diag])
    if diag is not None and diag.shape != x.shape:
        raise ValueError(f"spmv: diag {tuple(diag.shape)} must match "
                         f"x {tuple(x.shape)}")
    for t in ts:
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError("spmv: operands must share dtype and device")
        if not t.is_contiguous():
            raise ValueError("spmv: operands must be contiguous")
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"spmv: unsupported dtype {x.dtype}")
    if n >= 2 ** 31:
        raise ValueError("spmv: the kernel's int32 row indices need n < 2^31")
    if fb is not None:
        _check_remainder(x, fb)


def build() -> dict:
    """Compile csrc/spmv_stencil.cu with nvcc into BUILD_DIR (once per
    hash of the source and flags). Returns {"path", "seconds", "log"}
    (the log holds ptxas's register and spill report)."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libspmv_stencil_{key}.so"
    if out.exists():
        return {"path": out, "seconds": 0.0, "log": "(already built)"}
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    r = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, out)
    return {"path": out, "seconds": time.perf_counter() - t0,
            "log": r.stderr.strip()}


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()["path"]))
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for name in ("spmv_stencil_f32", "spmv_stencil_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32,
                           ctypes.POINTER(i64), i32, ptr, ptr, ptr, ptr]
            fn.restype = i32
        lib.spmv_stencil_max_offsets.restype = i32
        if lib.spmv_stencil_max_offsets() != MAX_OFFSETS:
            raise RuntimeError("spmv: MAX_OFFSETS disagrees with the source")
        _lib = lib
    return _lib


def _launch(diag, x, soff, deltas, fb) -> torch.Tensor:
    global LAUNCHES, FB_LAUNCHES
    lib = _load()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    darr = (ctypes.c_longlong * max(len(deltas), 1))(*deltas)
    fn = lib.spmv_stencil_f32 if x.dtype == torch.float32 \
        else lib.spmv_stencil_f64
    ncols = 1 if x.ndim == 1 else x.shape[1]
    rowptr = col = vals = None
    if fb is not None:
        rowptr = fb.layout.rowptr.data_ptr()
        col, vals = fb.layout.col.data_ptr(), fb.vals.data_ptr()
    err = fn(None if diag is None else diag.data_ptr(), x.data_ptr(),
             soff.data_ptr(), y.data_ptr(), x.shape[0], ncols, soff.shape[1],
             darr, len(deltas), rowptr, col, vals,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"spmv_stencil launch failed: CUDA error {err}")
    LAUNCHES += 1
    if fb is not None:
        FB_LAUNCHES += 1
    return y


def spmv(diag: Optional[torch.Tensor], x: torch.Tensor, soff: torch.Tensor,
         deltas: Sequence[int], fb: Optional[Remainder] = None
         ) -> torch.Tensor:
    """y = diag*x + sum_m soff[:, m] * roll(x, -d_m) + the remainder fb
    (diag and fb may be None). CPU tensors take the plain version; CUDA
    tensors launch the kernel once for the whole operator."""
    _check(diag, x, soff, deltas, fb)
    if x.device.type == "cpu":
        return plain(diag, x, soff, deltas, fb)
    if x.device.type != "cuda":
        raise RuntimeError(f"spmv: no kernel for device {x.device}")
    return _launch(diag, x, soff, deltas, fb)
