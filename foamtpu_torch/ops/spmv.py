"""Offset-stencil SpMV: the hand-written CUDA kernel and its plain version.

    y[c] = (diag[c] * x[c] if diag) + sum_m soff[c, m] * x[(c + d_m) mod n]

Port of openfoam-2.2.x_tpu/ops/pallas_spmv.py::spmv_fused (the JAX
package's one Pallas kernel). The kernel source is
foamtpu_torch/csrc/spmv_stencil.cu; it is compiled with nvcc for sm_90a
at first use into foamtpu_torch/build/ (keyed on a hash of the source
and flags) and loaded with ctypes.

Dispatch is by the device of the operands: a CPU tensor takes `plain`,
the torch.roll chain of the reference's StencilOp.apply_off; a CUDA
tensor launches the kernel or raises. Each launch adds one to
`LAUNCHES`, which callers reset and read to show a run went through the
kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Sequence

import torch

MAX_OFFSETS = 16          # SPMV_MAX_OFFSETS in the .cu source
LAUNCHES = 0              # kernel launches since import (reset by callers)

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "csrc" / "spmv_stencil.cu"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None


def plain(diag: Optional[torch.Tensor], x: torch.Tensor, soff: torch.Tensor,
          deltas: Sequence[int]) -> torch.Tensor:
    """The plain torch version: the roll chain of the reference's
    StencilOp.apply_off, plus diag*x when a diagonal is given."""
    vec = x.ndim == 2
    acc = torch.zeros_like(x)
    for m, d in enumerate(deltas):
        coeff = soff[:, m]
        acc = acc + (coeff[:, None] if vec else coeff) * torch.roll(x, -d, 0)
    if diag is not None:
        return diag * x + acc
    return acc


def _check(diag, x, soff, deltas):
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
                           ctypes.POINTER(i64), i32, ptr]
            fn.restype = i32
        lib.spmv_stencil_max_offsets.restype = i32
        if lib.spmv_stencil_max_offsets() != MAX_OFFSETS:
            raise RuntimeError("spmv: MAX_OFFSETS disagrees with the source")
        _lib = lib
    return _lib


def _launch(diag, x, soff, deltas) -> torch.Tensor:
    global LAUNCHES
    lib = _load()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    darr = (ctypes.c_longlong * max(len(deltas), 1))(*deltas)
    fn = lib.spmv_stencil_f32 if x.dtype == torch.float32 \
        else lib.spmv_stencil_f64
    ncols = 1 if x.ndim == 1 else x.shape[1]
    err = fn(None if diag is None else diag.data_ptr(), x.data_ptr(),
             soff.data_ptr(), y.data_ptr(), x.shape[0], ncols, soff.shape[1],
             darr, len(deltas),
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"spmv_stencil launch failed: CUDA error {err}")
    LAUNCHES += 1
    return y


def spmv(diag: Optional[torch.Tensor], x: torch.Tensor, soff: torch.Tensor,
         deltas: Sequence[int]) -> torch.Tensor:
    """y = diag*x + sum_m soff[:, m] * roll(x, -d_m) (diag may be None).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check(diag, x, soff, deltas)
    if x.device.type == "cpu":
        return plain(diag, x, soff, deltas)
    if x.device.type != "cuda":
        raise RuntimeError(f"spmv: no kernel for device {x.device}")
    return _launch(diag, x, soff, deltas)
