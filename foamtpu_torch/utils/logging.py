"""Solver logging in the reference's grep-able stdout format (a copy of
openfoam-2.2.x_tpu/utils/logging.py, host code): the line shapes that
foamLog-style tooling parses, and the DebugSwitches gate.

`solver_line` names a symmetric tensor's six components (Rxx ... Rzz) as
OpenFOAM does; the reference's copy knows the three of a vector only and
raises IndexError at the first line of an R or B solve."""

from __future__ import annotations

import sys
from typing import Any

import numpy as np


def _host(x) -> np.ndarray:
    """A solver diagnostic (tensor on any device, or a number) as numpy."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return np.asarray(x)


def info(*args) -> None:
    print(*args)
    sys.stdout.flush()


# the component names of a vector's and of a symmetric tensor's solve
_COMPONENTS = {3: ("x", "y", "z"), 6: ("xx", "xy", "xz", "yy", "yz", "zz")}


def solver_line(field: str, perf) -> str:
    r0 = np.atleast_1d(_host(perf.initial_residual))
    rf = np.atleast_1d(_host(perf.final_residual))
    it = int(np.max(_host(perf.n_iterations)))
    lines = []
    comps = _COMPONENTS.get(r0.shape[0])
    if r0.shape[0] > 1:
        for c in range(r0.shape[0]):
            lines.append(
                f"Solving for {field}{comps[c]}, Initial residual = {float(r0[c]):.6g}, "
                f"Final residual = {float(rf[c]):.6g}, No Iterations {it}"
            )
    else:
        lines.append(
            f"Solving for {field}, Initial residual = {float(r0[0]):.6g}, "
            f"Final residual = {float(rf[0]):.6g}, No Iterations {it}"
        )
    return "\n".join(lines)


def courant_line(mean: float, maxv: float) -> str:
    return f"Courant Number mean: {mean:.6g} max: {maxv:.6g}"


def continuity_line(local: float, global_: float, cumulative: float) -> str:
    return (
        "time step continuity errors : "
        f"sum local = {local:.6g}, global = {global_:.6g}, "
        f"cumulative = {cumulative:.6g}"
    )


# ---------------------------------------------------------------------------
# DebugSwitches (reference: etc/controlDict DebugSwitches { fvMesh 1; }
# gating per-class `if (debug)` blocks, togglable without recompiling).
# Sources, later wins: FOAMTPU_DEBUG env ("lduMatrix,fvMesh") and the
# case controlDict's DebugSwitches subdict (loaded by Case).
# ---------------------------------------------------------------------------

import os as _os

_DEBUG_SWITCHES = {}


def load_debug_switches(control_dict=None) -> None:
    _DEBUG_SWITCHES.clear()
    for name in _os.environ.get("FOAMTPU_DEBUG", "").split(","):
        if name.strip():
            _DEBUG_SWITCHES[name.strip()] = 1
    if control_dict is not None:
        ds = control_dict.get("DebugSwitches")
        if ds is not None and hasattr(ds, "items"):
            for k, v in ds.items():
                try:
                    _DEBUG_SWITCHES[str(k)] = int(v)
                except (TypeError, ValueError):
                    _DEBUG_SWITCHES[str(k)] = 1


def debug(name: str) -> bool:
    """Gate for per-subsystem debug output (DebugSwitches analogue)."""
    return _DEBUG_SWITCHES.get(name, 0) > 0


load_debug_switches()
