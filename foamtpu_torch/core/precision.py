"""Precision policy (twin of openfoam-2.2.x_tpu/core/precision.py).

float32 on the device by default; FOAMTPU_X64=1 selects float64 for
both packages at once (one variable flips the reference and the port).
Host-side geometry precompute is always float64. Device index arrays
are int64, torch's native index type (the reference uses int32; the
values are identical).
"""

import os

import numpy as np
import torch


def x64_enabled() -> bool:
    return os.environ.get("FOAMTPU_X64", "0") not in ("0", "", "false")


def scalar_np():
    return np.float64 if x64_enabled() else np.float32


def scalar_dtype() -> torch.dtype:
    return torch.float64 if x64_enabled() else torch.float32


label_np = np.int64
label_dtype = torch.int64
