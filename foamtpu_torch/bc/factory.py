"""BC factory: boundaryField dictionary entries -> PatchField (port of
openfoam-2.2.x_tpu/bc/factory.py: `parse_value` and the part of
`from_dict` that builds the kinds of the ported slice).

Ported kinds: fixedValue, zeroGradient, fixedGradient, mixed, calculated,
empty, inletOutlet, totalPressure, pressureInletOutletVelocity,
nutkWallFunction, nutUWallFunction, nutUSpaldingWallFunction,
nutLowReWallFunction (fixed value 0, as the reference sets it),
kqRWallFunction, epsilonWallFunction, omegaWallFunction, slip,
symmetryPlane, symmetry and wedge (one value rule), flowRateInletVelocity
(its `value` fixed, `massFlowRate` read nowhere, as the reference maps
it), and on a retained cyclic pair cyclicAMI, fixedJump and fan. Any
other `type` raises
NotImplementedError naming it
(the reference degrades unknown types to calculated/zeroGradient; the
port refuses instead).

The reference's explicit aliases of these kinds are mapped as it maps
them: tractionDisplacement is fixedGradient (the solid solvers rewrite
its gradient), waveSurfacePressure is mixed (potentialFreeSurfaceFoam
rewrites its value from the surface elevation each step), cyclic is
cyclicAMI (a cyclic pair that reaches the factory was retained because
its partner field carries a jump) and fixedJumpAMI is fixedJump.

The compressible names are the reference's aliases (copied from
openfoam-2.2.x_tpu/bc/factory.py::from_dict): a `compressible::` prefix
is dropped, the mut* wall functions are the nut* kinds (the compressible
models evaluate them on nu = mu/rho and scale by rho), and
alphatWallFunction is calculated. An alias whose target is not ported
(mutkRoughWallFunction) raises under the name the case gave.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.dictionary import FoamDict, Word
from . import derived2  # noqa: F401  (registers nutUSpaldingWallFunction)
from .patchfields import PatchField, make

KINDS = ("fixedValue", "zeroGradient", "calculated", "empty", "inletOutlet",
         "totalPressure", "pressureInletOutletVelocity", "nutkWallFunction",
         "nutUWallFunction", "nutUSpaldingWallFunction",
         "nutLowReWallFunction", "kqRWallFunction", "epsilonWallFunction",
         "omegaWallFunction", "slip", "symmetryPlane", "symmetry", "wedge",
         "fixedGradient", "mixed", "cyclicAMI", "fixedJump", "fan",
         "flowRateInletVelocity")


def parse_value(entry: Any, size: int, rank: int, dtype, device="cpu"):
    """Parse `uniform v` / `uniform (x y z)` / `nonuniform List<..> N (..)`
    into a tensor of `dtype` on `device` (None when absent)."""
    if entry is None:
        return None
    items = entry if isinstance(entry, list) else [entry]
    mode = None
    payload = None
    for x in items:
        if isinstance(x, (Word, str)) and str(x) in ("uniform", "nonuniform"):
            mode = str(x)
        elif isinstance(x, (int, float, np.ndarray)):
            payload = x
    if payload is None:
        return None
    arr = np.asarray(payload, dtype=np.float64)
    if mode == "uniform" or arr.ndim == 0 or (rank == 1 and arr.ndim == 1):
        if rank == 0:
            arr = np.full(size, float(arr))
        else:
            arr = np.broadcast_to(arr.reshape(-1)[:3], (size, 3))
    return torch.tensor(np.asarray(arr), dtype=dtype, device=device)


# the compressible names of the ported kinds
ALIASES = {"mutkWallFunction": "nutkWallFunction",
           "mutUWallFunction": "nutUWallFunction",
           "mutkRoughWallFunction": "nutkRoughWallFunction",
           "mutUSpaldingWallFunction": "nutUSpaldingWallFunction",
           "mutLowReWallFunction": "nutLowReWallFunction",
           "alphatWallFunction": "calculated",
           "tractionDisplacement": "fixedGradient",
           "waveSurfacePressure": "mixed",
           # the conjugate-heat-transfer interface: its refValue, refGrad
           # and valueFraction are set by chtmultiregion.update_coupled_bcs
           "turbulentTemperatureCoupledBaffleMixed": "mixed",
           "cyclic": "cyclicAMI",
           "fixedJumpAMI": "fixedJump"}


def from_dict(spec: FoamDict, patch, rank: int, dtype, device="cpu",
              mesh=None) -> PatchField:
    """The PatchField of one boundaryField entry; `mesh` (its patches)
    tells the master side of a jump pair."""
    given = str(spec["type"])
    kind = given
    if kind.startswith("compressible::"):
        kind = kind[len("compressible::"):]
    kind = ALIASES.get(kind, kind)
    if kind not in KINDS:
        raise NotImplementedError(
            f"boundary condition kind {given!r} is not ported to "
            "foamtpu_torch yet")
    # nut/mutLowReWallFunction: nut = 0 at the wall of a wall-resolved mesh
    if kind == "nutLowReWallFunction":
        return make("fixedValue", ref_value=0.0, vfrac=1.0)
    size = patch.size
    val = parse_value(spec.get("value"), size, rank, dtype, device)

    kw = {}
    if kind in ("fixedValue", "calculated", "nutkWallFunction",
                "nutUWallFunction", "nutUSpaldingWallFunction",
                "epsilonWallFunction", "omegaWallFunction",
                "flowRateInletVelocity"):
        kw["ref_value"] = val if val is not None else 0.0
        kw["vfrac"] = 1.0
    elif kind == "inletOutlet":
        iv = parse_value(spec.get("inletValue"), size, rank, dtype, device)
        if iv is None:
            iv = val
        kw["ref_value"] = iv if iv is not None else 0.0
        kw["vfrac"] = 1.0
    elif kind == "fixedGradient":
        grad = parse_value(spec.get("gradient"), size, rank, dtype, device)
        kw["ref_grad"] = grad if grad is not None else 0.0
        kw["vfrac"] = 0.0
    elif kind == "mixed":
        rv = parse_value(spec.get("refValue"), size, rank, dtype, device)
        rg = parse_value(spec.get("refGradient"), size, rank, dtype, device)
        vf = parse_value(spec.get("valueFraction"), size, 0, dtype, device)
        kw["ref_value"] = rv if rv is not None else 0.0
        kw["ref_grad"] = rg if rg is not None else 0.0
        kw["vfrac"] = vf if vf is not None else 1.0
    elif kind == "cyclicAMI":
        kw["vfrac"] = 0.0
    elif kind in ("fixedJump", "fan"):
        kw["vfrac"] = 0.0
        # master side: the pair member listed first in the boundary
        # (jumpCyclic applies +jump on the owner patch)
        master = True
        if mesh is not None and getattr(patch, "neighbour_patch", None):
            names = [p.name for p in mesh.patches]
            try:
                master = names.index(patch.name) < names.index(
                    patch.neighbour_patch)
            except ValueError:
                pass
        kw["master"] = master
        if kind == "fixedJump":
            jv = parse_value(spec.get("jump"), size, rank, dtype, device)
            kw["ref_value"] = jv if jv is not None else 0.0
        else:
            # the 2.2 fan curve: `f (c0 c1 ...)`, a polynomial in the
            # volumetric flow rate (fan::calcFanJump)
            fco = spec.get("f", spec.get("fanCoeffs"))
            if fco is not None:
                kw["fanPoly"] = tuple(
                    float(x) for x in np.asarray(fco, float).reshape(-1))
            kw["ref_value"] = 0.0
    elif kind == "totalPressure":
        p0 = parse_value(spec.get("p0"), size, 0, dtype, device)
        kw["ref_value"] = p0 if p0 is not None else 0.0
        kw["p0"] = float(p0.mean()) if p0 is not None else 0.0
        kw["vfrac"] = 1.0
    return make(kind, **kw)
