"""BC factory: boundaryField dictionary entries -> PatchField (port of
openfoam-2.2.x_tpu/bc/factory.py: `parse_value`, `_ALIASES`,
`_coded_value`, `from_dict`, `_table_rows`, `_num` and `_uniform_entry`).

Every name the reference's factory maps builds here with the reference's
meaning (`NAMES` lists them). They land on the kinds of `KINDS`: the
basic kinds (fixedValue, zeroGradient, fixedGradient, mixed, calculated,
empty), the constraint kinds (slip, symmetryPlane, symmetry, wedge; a
retained cyclic pair's cyclicAMI, fixedJump and fan), the kinds of
bc/patchfields.py (inletOutlet, outletInlet, freestream, totalPressure,
pressureInletOutletVelocity, flowRateInletVelocity,
surfaceNormalFixedValue, the turbulent-inlet family, the wall functions,
fixedFluxPressure, waveTransmissive, pressureInletVelocity,
pressureDirectedInletVelocity, supersonicFreestream,
variableHeightFlowRate) and of the derived batches (bc/derived2.py,
derived3.py, derived4.py: partialSlip, fixedNormalSlip,
inletOutletTotalTemperature, outletMappedUniformInlet, turbulentInlet,
the rotating pair, nutkRough and alphatJayatilleke wall functions, the
time tables uniformFixedValueT, oscillatingFixedValueT and
uniformFixedGradientT, advective, the pressure-driven inlets,
fixedShearStress, buoyantPressure, turbulentHeatFluxTemperature,
fixedPressureCompressibleDensity, timeVaryingMappedFixedValue,
alphaContactAngle, maxwellSlipU, smoluchowskiJumpT, fixedRho,
fanPressure, syringePressure, pressureInletOutletParSlipVelocity).

The reference's geometry-derived kinds become fixed values here as
there (rotatingWallVelocity, cylindricalInletVelocity,
swirlFlowRateInletVelocity, translatingWallVelocity, the atmBoundaryLayer
pair, uniformDensityHydrostaticPressure, totalTemperature), and so do
codedFixedValue and codedMixed, whose Python snippet runs once at read
time with the port's `utils/tnp.py` as its `jnp`. A `compressible::`
prefix is dropped, the mut* wall functions are the nut* kinds and
alphatWallFunction is calculated.

One departure: a `type` that the reference does not map by name (and a
coded BC without its `code`) raises NotImplementedError naming it. The
reference degrades such a type to calculated (with a `value`) or
zeroGradient; the port refuses instead. So `dictionary_entries` gives
the kinds built under another name (the contact angles, the table and
oscillating forms) back their dictionary name and entries, for the field
writer: a written field reads back as it was read.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.dictionary import FoamDict, Word
from . import derived2, derived3, derived4  # noqa: F401  (register kinds)
from .patchfields import PatchField, make


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


# keyword -> canonical kind (the reference's `_ALIASES`)
ALIASES = {
    "noSlip": "fixedValue",
    "slip": "slip",
    "symmetry": "symmetry",
    "symmetryPlane": "symmetryPlane",
    "wedge": "wedge",
    "empty": "empty",
    "zeroGradient": "zeroGradient",
    "fixedValue": "fixedValue",
    "fixedGradient": "fixedGradient",
    # the solid solvers rewrite its gradient from the traction
    "tractionDisplacement": "fixedGradient",
    # the conjugate-heat-transfer interface: its refValue, refGrad and
    # valueFraction are set by chtmultiregion.update_coupled_bcs
    "compressible::turbulentTemperatureCoupledBaffleMixed": "mixed",
    "turbulentTemperatureCoupledBaffleMixed": "mixed",
    "solidWallMixedTemperatureCoupled": "mixed",
    "mixed": "mixed",
    "calculated": "calculated",
    "inletOutlet": "inletOutlet",
    "outletInlet": "outletInlet",
    "totalPressure": "totalPressure",
    "pressureInletOutletVelocity": "pressureInletOutletVelocity",
    "freestream": "freestream",
    # zeroGradient on outflow, the freestream value on inflow
    "freestreamPressure": "inletOutlet",
    "partialSlip": "partialSlip",
    "fixedNormalSlip": "fixedNormalSlip",
    "translatingWallVelocity": "translatingWallVelocity",
    "uniformTotalPressure": "uniformTotalPressure",
    "inletOutletTotalTemperature": "inletOutletTotalTemperature",
    "outletMappedUniformInlet": "outletMappedUniformInlet",
    "turbulentInlet": "turbulentInlet",
    "atmBoundaryLayerInletVelocity": "atmBoundaryLayerInletVelocity",
    "atmBoundaryLayerInletEpsilon": "atmBoundaryLayerInletEpsilon",
    "nutUSpaldingWallFunction": "nutUSpaldingWallFunction",
    "nutkRoughWallFunction": "nutkRoughWallFunction",
    "nutURoughWallFunction": "nutUSpaldingWallFunction",
    "rotatingPressureInletOutletVelocity":
        "rotatingPressureInletOutletVelocity",
    "rotatingTotalPressure": "rotatingTotalPressure",
    "alphatJayatillekeWallFunction": "alphatJayatillekeWallFunction",
    "movingWallVelocity": "fixedValue",
    "kqRWallFunction": "kqRWallFunction",
    "nutkWallFunction": "nutkWallFunction",
    "nutUWallFunction": "nutUWallFunction",
    "epsilonWallFunction": "epsilonWallFunction",
    "omegaWallFunction": "omegaWallFunction",
    "kLowReWallFunction": "kLowReWallFunction",
    "turbulentIntensityKineticEnergyInlet":
        "turbulentIntensityKineticEnergyInlet",
    "turbulentMixingLengthDissipationRateInlet":
        "turbulentMixingLengthDissipationRateInlet",
    "turbulentMixingLengthFrequencyInlet":
        "turbulentMixingLengthFrequencyInlet",
    "surfaceNormalFixedValue": "surfaceNormalFixedValue",
    "flowRateInletVelocity": "flowRateInletVelocity",
    "fixedFluxPressure": "fixedFluxPressure",
    "waveTransmissive": "waveTransmissive",
    "pressureInletVelocity": "pressureInletVelocity",
    "rotatingWallVelocity": "rotatingWallVelocity",
    "supersonicFreestream": "supersonicFreestream",
    "variableHeightFlowRate": "variableHeightFlowRate",
    "cyclicAMI": "cyclicAMI",
    # a plain cyclic pair that reaches the factory was retained because
    # its partner field carries a jump
    "cyclic": "cyclicAMI",
    "fixedJump": "fixedJump",
    "fixedJumpAMI": "fixedJump",
    "fan": "fan",
    "cylindricalInletVelocity": "cylindricalInletVelocity",
    "swirlFlowRateInletVelocity": "swirlFlowRateInletVelocity",
    "uniformFixedValue": "uniformFixedValue",
    "oscillatingFixedValue": "oscillatingFixedValue",
    # zeroGradient plus the normal flux correction: the closure of
    # pressureInletOutletVelocity (the reference's mapping)
    "fluxCorrectedVelocity": "pressureInletOutletVelocity",
    "externalWallHeatFluxTemperature": "externalWallHeatFluxTemperature",
    "pressureDirectedInletVelocity": "pressureDirectedInletVelocity",
    # the reservoir temperature at inflow (static T = T0)
    "totalTemperature": "totalTemperature",
    # potentialFreeSurfaceFoam rewrites its value from the surface
    # elevation each step
    "waveSurfacePressure": "mixed",
    # batch 3 (bc/derived3.py)
    "advective": "advective",
    "uniformFixedGradient": "uniformFixedGradient",
    "pressureInletUniformVelocity": "pressureInletUniformVelocity",
    "pressureNormalInletOutletVelocity":
        "pressureNormalInletOutletVelocity",
    "variableHeightFlowRateInletVelocity":
        "variableHeightFlowRateInletVelocity",
    "fixedShearStress": "fixedShearStress",
    "buoyantPressure": "buoyantPressure",
    "uniformDensityHydrostaticPressure":
        "uniformDensityHydrostaticPressure",
    "turbulentHeatFluxTemperature": "turbulentHeatFluxTemperature",
    "fixedPressureCompressibleDensity":
        "fixedPressureCompressibleDensity",
    # a zeroGradient facade: the internal-cell forcing is a solver's
    # set-values concern (the reference's mapping)
    "fixedInternalValue": "zeroGradient",
    "timeVaryingMappedFixedValue": "timeVaryingMappedFixedValue",
    # batch 4 (bc/derived4.py)
    "constantAlphaContactAngle": "alphaContactAngle",
    "dynamicAlphaContactAngle": "alphaContactAngle",
    "maxwellSlipU": "maxwellSlipU",
    "smoluchowskiJumpT": "smoluchowskiJumpT",
    "fixedRho": "fixedRho",
    "fanPressure": "fanPressure",
    "syringePressure": "syringePressure",
    "pressureInletOutletParSlipVelocity":
        "pressureInletOutletParSlipVelocity",
}

# the compressible names of the wall functions
_RENAMES = {"mutkWallFunction": "nutkWallFunction",
            "mutUWallFunction": "nutUWallFunction",
            "mutkRoughWallFunction": "nutkRoughWallFunction",
            "mutUSpaldingWallFunction": "nutUSpaldingWallFunction",
            "alphatWallFunction": "calculated"}

# every `type` name the factory builds
NAMES = tuple(sorted(set(ALIASES) | set(_RENAMES)
                     | {"nutLowReWallFunction", "mutLowReWallFunction",
                        "codedFixedValue", "codedMixed"}))

# every kind a built PatchField can carry
KINDS = tuple(sorted(
    (set(ALIASES.values()) | {"uniformFixedValueT", "oscillatingFixedValueT",
                              "uniformFixedGradientT"})
    - {"rotatingWallVelocity", "cylindricalInletVelocity",
       "swirlFlowRateInletVelocity", "uniformFixedValue",
       "oscillatingFixedValue", "externalWallHeatFluxTemperature",
       "translatingWallVelocity", "uniformTotalPressure",
       "atmBoundaryLayerInletVelocity", "atmBoundaryLayerInletEpsilon",
       "totalTemperature", "uniformFixedGradient",
       "uniformDensityHydrostaticPressure"}))


def _refuse(given):
    raise NotImplementedError(
        f"boundary condition kind {given!r} is not ported to "
        "foamtpu_torch (the reference maps no such name)")


def _coded_value(spec: FoamDict, patch, rank: int, dtype, device, mesh):
    """codedFixedValue / codedMixed: the reference compiles a C++
    snippet at run time; both packages run a Python snippet from the
    `code` entry once at read time, with the names np, jnp (here
    utils/tnp.py), Cf [n,3] face centres, normal [n,3] outward unit
    normals and t (0, the start), and take its `value`."""
    from ..utils import tnp

    code = spec.get("code")
    if code is None:
        return None
    sl = patch.slice
    cf = mesh.cf[sl].detach().cpu().numpy()
    sf = mesh.sf[sl].detach().cpu().numpy()
    nrm = sf / np.maximum(np.linalg.norm(sf, axis=1, keepdims=True), 1e-30)
    ns = {"np": np, "jnp": tnp, "Cf": cf, "normal": nrm, "t": 0.0,
          "value": None}
    exec(compile(str(code), "<codedFixedValue>", "exec"), ns)  # noqa: S102
    val = ns.get("value")
    if val is None:
        raise ValueError("codedFixedValue code must assign `value`")
    if torch.is_tensor(val):
        val = val.detach().cpu().numpy()
    want = (patch.size, 3) if rank == 1 else (patch.size,)
    val = np.broadcast_to(np.asarray(val, dtype=float), want)
    return torch.tensor(np.asarray(val), dtype=dtype, device=device)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def from_dict(spec: FoamDict, patch, rank: int, dtype, device="cpu",
              mesh=None, case_dir=None, field_name=None) -> PatchField:
    """The PatchField of one boundaryField entry. `mesh` gives the patch
    geometry of the geometry-derived kinds and the master side of a jump
    pair; `case_dir` and `field_name` find timeVaryingMappedFixedValue's
    constant/boundaryData."""
    given = str(spec["type"])
    t = given
    if t.startswith("compressible::"):
        t = t[len("compressible::"):]
    # nut/mutLowReWallFunction: nut = 0 at the wall of a wall-resolved
    # mesh, as the reference sets it
    if t in ("nutLowReWallFunction", "mutLowReWallFunction"):
        return make("fixedValue", ref_value=0.0, vfrac=1.0)
    t = _RENAMES.get(t, t)
    if t in ("codedFixedValue", "codedMixed") and mesh is not None:
        cv = _coded_value(spec, patch, rank, dtype, device, mesh)
        if cv is not None:
            return make("fixedValue", ref_value=cv, vfrac=1.0)
    kind = ALIASES.get(t)
    if kind is None:
        _refuse(given)
    size = patch.size

    def value(entry, r=rank):
        return parse_value(entry, size, r, dtype, device)

    def dev(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    def face_geometry(name):
        return _host(getattr(mesh, name)[patch.slice])

    val = value(spec.get("value"))
    grad = value(spec.get("gradient"))

    kw = {}
    if kind in ("fixedValue", "calculated", "nutkWallFunction",
                "nutUWallFunction", "epsilonWallFunction",
                "omegaWallFunction", "kLowReWallFunction",
                "surfaceNormalFixedValue", "flowRateInletVelocity"):
        kw["ref_value"] = val if val is not None else 0.0
        kw["vfrac"] = 1.0
    elif kind == "fixedGradient":
        kw["ref_grad"] = grad if grad is not None else 0.0
        kw["vfrac"] = 0.0
    elif kind == "mixed":
        rv = value(spec.get("refValue"))
        rg = value(spec.get("refGradient"))
        vf = value(spec.get("valueFraction"), 0)
        kw["ref_value"] = rv if rv is not None else 0.0
        kw["ref_grad"] = rg if rg is not None else 0.0
        kw["vfrac"] = vf if vf is not None else 1.0
    elif kind in ("inletOutlet", "outletInlet"):
        iv = value(spec.get("inletValue" if kind == "inletOutlet"
                            else "outletValue"))
        if iv is None:  # freestreamPressure: freestreamValue / value
            iv = value(spec.get("freestreamValue"))
        if iv is None:
            iv = val
        kw["ref_value"] = iv if iv is not None else 0.0
        kw["vfrac"] = 1.0
    elif kind == "totalPressure":
        p0 = value(spec.get("p0"), 0)
        kw["ref_value"] = p0 if p0 is not None else 0.0
        kw["p0"] = float(p0.mean()) if p0 is not None else 0.0
        kw["vfrac"] = 1.0
    elif kind == "turbulentIntensityKineticEnergyInlet":
        kw["ref_value"] = val if val is not None else 0.0
        kw["vfrac"] = 1.0
        kw["intensity"] = float(spec.get("intensity", 0.05))
    elif kind in ("turbulentMixingLengthDissipationRateInlet",
                  "turbulentMixingLengthFrequencyInlet"):
        kw["ref_value"] = val if val is not None else 0.0
        kw["vfrac"] = 1.0
        kw["mixingLength"] = float(spec.get("mixingLength", 0.001))
    elif kind == "fixedFluxPressure":
        kw["ref_grad"] = grad if grad is not None else 0.0
        kw["vfrac"] = 0.0
    elif kind in ("waveTransmissive", "advective"):
        kw["ref_value"] = val if val is not None else 0.0
        kw["vfrac"] = 0.0
        fi = spec.get("fieldInf")
        if fi is not None:
            kw["fieldInf"] = float(np.asarray(fi).reshape(-1)[-1]) \
                if not isinstance(fi, (list, tuple)) else float(fi[-1])
        kw["lInf"] = _num(spec.get("lInf", 0.0))
    elif kind == "pressureInletVelocity":
        kw["ref_value"] = val if val is not None else 0.0
        kw["vfrac"] = 1.0
    elif kind == "rotatingWallVelocity":
        # U = omega x (Cf - origin), static
        origin = np.asarray(spec.get("origin", (0.0, 0.0, 0.0)),
                            dtype=float).reshape(3)
        axis = np.asarray(spec.get("axis", (0.0, 0.0, 1.0)),
                          dtype=float).reshape(3)
        axis = axis / max(np.linalg.norm(axis), 1e-30)
        om = spec.get("omega", 0.0)
        if isinstance(om, (list, tuple)):
            om = om[-1]
        if mesh is not None:
            kw["ref_value"] = dev(np.cross(float(om) * axis,
                                           face_geometry("cf") - origin))
        else:
            kw["ref_value"] = 0.0
        kw["vfrac"] = 1.0
        kind = "fixedValue"
    elif kind == "supersonicFreestream":
        kw["ref_value"] = val if val is not None else 0.0
        kw["vfrac"] = 0.0
    elif kind == "variableHeightFlowRate":
        kw["ref_value"] = val if val is not None else 0.0
        kw["vfrac"] = 0.0
        kw["lowerBound"] = float(spec.get("lowerBound", 0.0))
        kw["upperBound"] = float(spec.get("upperBound", 1.0))
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
            jv = value(spec.get("jump"))
            kw["ref_value"] = jv if jv is not None else 0.0
        else:
            # the 2.2 fan curve: `f (c0 c1 ...)`, a polynomial in the
            # volumetric flow rate (fan::calcFanJump)
            fco = spec.get("f", spec.get("fanCoeffs"))
            if fco is not None:
                kw["fanPoly"] = tuple(
                    float(x) for x in np.asarray(fco, float).reshape(-1))
            kw["ref_value"] = 0.0
    elif kind == "cylindricalInletVelocity":
        # U = Ua a + Ur r^ + (rpm 2pi/60)(a x r), static
        origin = np.asarray(spec.get("centre", spec.get("origin", (0, 0, 0))),
                            dtype=float).reshape(3)
        axis = np.asarray(spec.get("axis", (0, 0, 1)),
                          dtype=float).reshape(3)
        axis = axis / max(np.linalg.norm(axis), 1e-30)
        ua = _num(spec.get("axialVelocity", 0.0))
        ur = _num(spec.get("radialVelocity", 0.0))
        rpm = _num(spec.get("rpm", 0.0))
        if mesh is not None:
            d = face_geometry("cf") - origin
            d = d - np.outer(d @ axis, axis)
            r = np.linalg.norm(d, axis=1, keepdims=True)
            rhat = d / np.maximum(r, 1e-30)
            kw["ref_value"] = dev(
                ua * axis[None, :] + ur * rhat
                + rpm * np.pi / 30.0 * np.cross(axis[None, :], d))
        else:
            kw["ref_value"] = 0.0
        kw["vfrac"] = 1.0
        kind = "fixedValue"
    elif kind == "swirlFlowRateInletVelocity":
        # the normal velocity from flowRate over the patch area, plus the
        # rpm swirl
        origin = np.asarray(spec.get("origin", (0, 0, 0)),
                            dtype=float).reshape(3)
        axis = np.asarray(spec.get("axis", (0, 0, 1)),
                          dtype=float).reshape(3)
        axis = axis / max(np.linalg.norm(axis), 1e-30)
        qdot = _num(spec.get("flowRate", 0.0))
        rpm = _num(spec.get("rpm", 0.0))
        if mesh is not None:
            sf = face_geometry("sf")
            area = float(np.linalg.norm(sf, axis=1).sum())
            nrm = sf / np.maximum(
                np.linalg.norm(sf, axis=1, keepdims=True), 1e-30)
            d = face_geometry("cf") - origin
            d = d - np.outer(d @ axis, axis)
            kw["ref_value"] = dev(
                -qdot / max(area, 1e-30) * nrm
                + rpm * np.pi / 30.0 * np.cross(axis[None, :], d))
        else:
            kw["ref_value"] = 0.0
        kw["vfrac"] = 1.0
        kind = "fixedValue"
    elif kind == "uniformFixedValue":
        # the constant or `table ((t v) ...)` form; a table becomes the
        # kind sampled again from the solver time
        uv = spec.get("uniformValue")
        kw["ref_value"] = _uniform_entry(uv, size, rank, dtype, device, val)
        kw["vfrac"] = 1.0
        tbl = _table_rows(uv, rank)
        if tbl is not None:
            kw["table"] = tbl
            kind = "uniformFixedValueT"
        else:
            kind = "fixedValue"
    elif kind == "oscillatingFixedValue":
        # refValue (1 + amplitude sin(2 pi f t)) from the `t` context
        rv = value(spec.get("refValue"))
        rv = rv if rv is not None else (val if val is not None else 0.0)
        kw["ref_value"] = rv
        kw["ref_grad"] = rv
        kw["amplitude"] = _num(spec.get("amplitude", 0.0))
        kw["frequency"] = _num(spec.get("frequency", 0.0))
        kw["vfrac"] = 1.0
        kind = "oscillatingFixedValueT"
    elif kind == "externalWallHeatFluxTemperature":
        # q-mode: fixedGradient q/kappa; h-mode: Robin (mixed) with
        # vfrac = h/(h + kappa dc) per face (kappa a dictionary value,
        # as the reference reads it)
        kappa = max(_num(spec.get("kappaValue", spec.get("kappa", 1.0))),
                    1e-30)
        if "q" in spec:
            kw["ref_grad"] = _num(spec.get("q", 0.0)) / kappa
            kw["vfrac"] = 0.0
            kind = "fixedGradient"
        else:
            h = _num(spec.get("h", 0.0))
            Ta = _num(spec.get("Ta", 300.0))
            if mesh is not None:
                dc = face_geometry("delta_coeffs")
                kw["vfrac"] = dev(h / (h + kappa * np.maximum(dc, 1e-30)))
            else:
                kw["vfrac"] = 1.0
            kw["ref_value"] = Ta
            kw["ref_grad"] = 0.0
            kind = "mixed"
    elif kind == "pressureDirectedInletVelocity":
        kw["ref_value"] = val if val is not None else 0.0
        kw["vfrac"] = 1.0
        d = np.asarray(spec.get("inletDirection", [(1.0, 0.0, 0.0)]),
                       dtype=float).reshape(-1)[-3:]
        kw["inletDir"] = tuple(float(x) for x in d)
    elif kind == "partialSlip":
        vf = value(spec.get("valueFraction"), 0)
        kw["vfrac"] = vf if vf is not None else 0.5
    elif kind == "fixedNormalSlip":
        fv = value(spec.get("fixedValue"))
        kw["ref_value"] = fv if fv is not None else (
            val if val is not None else 0.0)
    elif kind == "translatingWallVelocity":
        # U = U0 - n (n.U0)
        u0 = np.asarray(spec.get("U", (0.0, 0.0, 0.0)),
                        dtype=float).reshape(-1)[-3:]
        if mesh is not None:
            sf = face_geometry("sf")
            nrm = sf / np.maximum(
                np.linalg.norm(sf, axis=1, keepdims=True), 1e-30)
            kw["ref_value"] = dev(u0[None, :] - nrm * (nrm @ u0)[:, None])
        else:
            kw["ref_value"] = dev(np.broadcast_to(u0, (size, 3)))
        kw["vfrac"] = 1.0
        kind = "fixedValue"
    elif kind == "uniformTotalPressure":
        # p0 from a constant or table entry sampled at t = 0, then the
        # totalPressure closure
        p0e = _uniform_entry(spec.get("p0", spec.get("pressure")),
                             size, 0, dtype, device, val)
        kw["ref_value"] = p0e
        kw["p0"] = float(np.asarray(_host(p0e)).mean())
        kw["vfrac"] = 1.0
        kind = "totalPressure"
    elif kind == "inletOutletTotalTemperature":
        t0 = value(spec.get("T0"), 0)
        kw["ref_grad"] = t0 if t0 is not None else (
            val if val is not None else 300.0)
        kw["ref_value"] = kw["ref_grad"]
        kw["vfrac"] = 0.0
        kw["Cp"] = _num(spec.get("Cp", 1005.0))
    elif kind == "outletMappedUniformInlet":
        out_name = str(spec.get("outletPatchName",
                                spec.get("outletPatch", "")))
        kw["fraction"] = _num(spec.get("fraction", 1.0))
        kw["out_start"], kw["out_size"] = -1, 0
        if mesh is not None:
            for op in mesh.patches:
                if op.name == out_name:
                    kw["out_start"], kw["out_size"] = op.start, op.size
        kw["ref_value"] = val if val is not None else 0.0
        kw["vfrac"] = 1.0
    elif kind == "turbulentInlet":
        ref = value(spec.get("referenceField"))
        kw["ref_grad"] = ref if ref is not None else (
            val if val is not None else 0.0)
        kw["ref_value"] = kw["ref_grad"]
        fsv = np.asarray(spec.get("fluctuationScale", 0.0),
                         dtype=float).reshape(-1)
        kw["fluctuationScale"] = tuple(float(x) for x in fsv) \
            if rank == 1 else float(fsv[-1])
        kw["seed"] = int(_num(spec.get("seed", 0)))
        kw["vfrac"] = 1.0
    elif kind in ("atmBoundaryLayerInletVelocity",
                  "atmBoundaryLayerInletEpsilon"):
        # log-law atmospheric boundary layer: Ustar = kappa Uref /
        # ln((Href+z0)/z0); U = Ustar/kappa ln((z-zg+z0)/z0) flowDir;
        # epsilon = Ustar^3 / (kappa (z-zg+z0))
        kappa_c = _num(spec.get("kappa", 0.41))
        z0 = max(_num(spec.get("z0", 0.1)), 1e-6)
        uref = _num(spec.get("Uref", 10.0))
        href = max(_num(spec.get("Href", spec.get("Zref", 10.0))), z0)
        zg = _num(spec.get("zGround", 0.0))
        zdir = np.asarray(spec.get("zDir", spec.get("z", (0, 0, 1))),
                          dtype=float).reshape(-1)[-3:]
        zdir = zdir / max(np.linalg.norm(zdir), 1e-30)
        ustar = kappa_c * uref / np.log((href + z0) / z0)
        if mesh is not None:
            z = face_geometry("cf") @ zdir - zg
            prof = np.log(np.maximum(z + z0, z0) / z0)
            if kind == "atmBoundaryLayerInletVelocity":
                fdir = np.asarray(
                    spec.get("flowDir", spec.get("n", (1, 0, 0))),
                    dtype=float).reshape(-1)[-3:]
                fdir = fdir / max(np.linalg.norm(fdir), 1e-30)
                kw["ref_value"] = dev((ustar / kappa_c) * prof[:, None]
                                      * fdir[None, :])
            else:
                kw["ref_value"] = dev(
                    ustar ** 3 / (kappa_c * np.maximum(z + z0, z0)))
        else:
            kw["ref_value"] = val if val is not None else 0.0
        kw["vfrac"] = 1.0
        kind = "fixedValue"
    elif kind in ("nutUSpaldingWallFunction", "nutkRoughWallFunction"):
        kw["ref_value"] = val if val is not None else 0.0
        kw["vfrac"] = 1.0
        if kind == "nutkRoughWallFunction":
            kw["Ks"] = _num(spec.get("Ks", 0.0))
            kw["Cs"] = _num(spec.get("Cs", 0.5))
    elif kind == "alphatJayatillekeWallFunction":
        kw["ref_value"] = val if val is not None else 0.0
        kw["vfrac"] = 1.0
        kw["Prt"] = _num(spec.get("Prt", 0.85))
        kw["Pr"] = _num(spec.get("Pr", 0.7))
    elif kind in ("rotatingPressureInletOutletVelocity",
                  "rotatingTotalPressure"):
        origin = np.asarray(spec.get("origin", (0.0, 0.0, 0.0)),
                            dtype=float).reshape(-1)[-3:]
        axis = np.asarray(spec.get("axis", (0.0, 0.0, 1.0)),
                          dtype=float).reshape(-1)[-3:]
        axis = axis / max(np.linalg.norm(axis), 1e-30)
        om = _num(spec.get("omega", 0.0))
        if mesh is not None:
            omxr = np.cross(om * axis, face_geometry("cf") - origin)
        else:
            omxr = np.zeros((size, 3))
        if kind == "rotatingPressureInletOutletVelocity":
            kw["ref_grad"] = dev(-omxr)
            kw["ref_value"] = val if val is not None else 0.0
        else:
            p0 = value(spec.get("p0"), 0)
            p0a = p0 if p0 is not None else torch.zeros(
                size, dtype=dtype, device=device)
            kw["ref_grad"] = p0a - 0.5 * dev(np.sum(omxr * omxr, axis=1))
            kw["ref_value"] = kw["ref_grad"]
        kw["vfrac"] = 1.0
    elif kind == "totalTemperature":
        t0 = value(spec.get("T0"), 0)
        kw["ref_value"] = t0 if t0 is not None else (
            val if val is not None else 300.0)
        kw["vfrac"] = 1.0
        kind = "fixedValue"
    elif kind == "uniformFixedGradient":
        ug = spec.get("uniformGradient")
        kw["ref_grad"] = _uniform_entry(ug, size, rank, dtype, device, grad)
        kw["vfrac"] = 0.0
        tbl = _table_rows(ug, rank)
        if tbl is not None:
            kw["table"] = tbl
            kind = "uniformFixedGradientT"
        else:
            kind = "fixedGradient"
    elif kind in ("pressureInletUniformVelocity",
                  "pressureNormalInletOutletVelocity"):
        kw["ref_value"] = val if val is not None else 0.0
        kw["vfrac"] = 1.0 if kind == "pressureInletUniformVelocity" \
            else 0.0
    elif kind == "variableHeightFlowRateInletVelocity":
        kw["ref_value"] = val if val is not None else 0.0
        kw["vfrac"] = 1.0
        kw["flowRate"] = _num(spec.get("flowRate", 0.0))
    elif kind == "fixedShearStress":
        tau = np.asarray(spec.get("tau", (0.0, 0.0, 0.0)),
                         dtype=float).reshape(-1)[-3:]
        kw["tau"] = tuple(float(x) for x in tau)
        kw["ref_value"] = val if val is not None else 0.0
        kw["vfrac"] = 1.0
    elif kind == "buoyantPressure":
        kw["ref_grad"] = grad if grad is not None else 0.0
        kw["vfrac"] = 0.0
        kw["rho"] = _num(spec.get("rho", 1.0)) \
            if not isinstance(spec.get("rho"), (str, Word)) else 1.0
    elif kind == "uniformDensityHydrostaticPressure":
        # p = pRefValue + rho g.(Cf - pRefPoint), static; g from an
        # optional `g` entry, earth gravity along -z by default
        rho0 = _num(spec.get("rho", spec.get("rhoRef", 1000.0)))
        pref = _num(spec.get("pRefValue", 0.0))
        prp = np.asarray(spec.get("pRefPoint", (0.0, 0.0, 0.0)),
                         dtype=float).reshape(-1)[-3:]
        gv = np.asarray(spec.get("g", (0.0, 0.0, -9.81)),
                        dtype=float).reshape(-1)[-3:]
        if mesh is not None:
            kw["ref_value"] = dev(pref + rho0 * (face_geometry("cf") - prp)
                                  @ gv)
        else:
            kw["ref_value"] = pref
        kw["vfrac"] = 1.0
        kind = "fixedValue"
    elif kind == "turbulentHeatFluxTemperature":
        kw["ref_grad"] = grad if grad is not None else 0.0
        kw["vfrac"] = 0.0
        kw["heatSource"] = str(spec.get("heatSource", "flux"))
        kw["q"] = _num(spec.get("q", 0.0))
        kw["alphaEff"] = _num(spec.get("alphaEff", spec.get("kappa", 2e-5)))
        kw["rho"] = _num(spec.get("rho", 1.2))
        kw["Cp"] = _num(spec.get("Cp", 1005.0))
    elif kind == "fixedPressureCompressibleDensity":
        kw["ref_value"] = val if val is not None else 0.0
        kw["vfrac"] = 1.0
        kw["p0"] = _num(spec.get("p0", 0.0))
        kw["rho0"] = _num(spec.get("rho0", 1000.0))
        kw["psi"] = _num(spec.get("psi", 1e-5))
    elif kind == "timeVaryingMappedFixedValue":
        kw["ref_value"] = val if val is not None else 0.0
        kw["vfrac"] = 1.0
        fname = str(spec.get("fieldTableName", field_name or ""))
        if case_dir is not None and mesh is not None and fname:
            tbl = derived3.load_boundary_data(case_dir, patch.name, fname,
                                              face_geometry("cf"))
            if tbl is not None:
                kw["tvm"] = derived3.boundary_table(tbl, dtype, device)
                # the value at the first row
                kw["ref_value"] = kw["tvm"].a[1][0]
        if "tvm" not in kw:
            kind = "fixedValue"   # no boundaryData: hold `value`
    elif kind == "alphaContactAngle":
        # zeroGradient carrying the contact angle for the interface
        # normals (models/interface.py); angles in RADIANS
        kw["ref_grad"] = 0.0
        kw["vfrac"] = 0.0
        kw["theta0"] = float(np.radians(_num(spec.get("theta0", 90.0))))
        for k in ("uTheta", "thetaA", "thetaR"):
            if k in spec:
                kw[k] = float(np.radians(_num(spec[k]))) \
                    if k != "uTheta" else _num(spec[k])
    elif kind in ("maxwellSlipU", "smoluchowskiJumpT"):
        kw["ref_value"] = val if val is not None else (
            0.0 if kind == "maxwellSlipU" else 300.0)
        kw["vfrac"] = 1.0
        kw["accommodationCoeff"] = _num(spec.get("accommodationCoeff", 1.0))
        if "lambda" in spec:
            kw["lambda"] = _num(spec["lambda"])
        if kind == "maxwellSlipU":
            uw = spec.get("Uwall", (0.0, 0.0, 0.0))
            kw["Uwall"] = tuple(float(x) for x in np.asarray(
                uw, dtype=float).reshape(-1)[-3:])
        else:
            kw["Twall"] = _num(spec.get("Twall", 300.0))
            kw["gamma"] = _num(spec.get("gamma", 1.4))
            kw["Pr"] = _num(spec.get("Pr", 0.72))
    elif kind == "fixedRho":
        kw["ref_value"] = val if val is not None else 1.0
        kw["vfrac"] = 1.0
        if "psi" in spec:
            kw["psi"] = _num(spec["psi"])
    elif kind == "fanPressure":
        kw["ref_value"] = val if val is not None else 0.0
        kw["vfrac"] = 1.0
        kw["p0"] = _num(spec.get("p0", 0.0))
        kw["direction"] = str(spec.get("direction", "in"))
        fc = spec.get("fanCurve", spec.get("jumpTable"))
        rows = _table_rows(fc, 0) if fc is not None else None
        if rows is not None:
            kw["fanCurve"] = derived3._Frozen(np.asarray(
                [(t, v) for t, v in rows], dtype=float))
    elif kind == "syringePressure":
        kw["ref_value"] = val if val is not None else 0.0
        kw["vfrac"] = 1.0
        for k in ("Ap", "Sp", "VsI", "tas", "tae", "tds", "tde",
                  "psI", "psE", "ams"):
            if k in spec:
                kw[k] = _num(spec[k])
    elif kind == "pressureInletOutletParSlipVelocity":
        kw["ref_value"] = val if val is not None else 0.0
        kw["vfrac"] = 0.0
    return make(kind, **kw)


_DYNAMIC_ANGLE = ("uTheta", "thetaA", "thetaR")


def dictionary_entries(bc: PatchField):
    """The `type` name a PatchField is written under and its entries
    [(key, text, or a per-face value)], so that from_dict builds the
    same kind with the same options from them: a kind that from_dict
    builds from another name (alphaContactAngle, uniformFixedValueT,
    uniformFixedGradientT, oscillatingFixedValueT) under that name with
    the options it keeps (angles in degrees; `limit` is kept by neither
    package), any other kind under its own name alone. The reference's
    writer writes the internal name, which neither reader takes back."""
    kind = bc.kind
    if kind == "alphaContactAngle":
        dynamic = any(bc.opt(k) is not None for k in _DYNAMIC_ANGLE)
        out = [("theta0", repr(float(np.degrees(bc.opt("theta0")))))]
        for k in _DYNAMIC_ANGLE if dynamic else ():
            v = bc.opt(k)
            if v is not None:
                out.append((k, repr(float(v if k == "uTheta"
                                          else np.degrees(v)))))
        return ("dynamicAlphaContactAngle" if dynamic
                else "constantAlphaContactAngle"), out
    if kind in ("uniformFixedValueT", "uniformFixedGradientT"):
        rows = " ".join(
            "(%r %s)" % (t, "(" + " ".join(map(repr, v)) + ")"
                         if isinstance(v, tuple) else repr(v))
            for t, v in bc.opt("table"))
        if kind == "uniformFixedValueT":
            return "uniformFixedValue", [("uniformValue",
                                          f"table ({rows})")]
        return "uniformFixedGradient", [("uniformGradient",
                                         f"table ({rows})")]
    if kind == "oscillatingFixedValueT":
        # the clean refValue, staged in ref_grad (bc/derived2.py)
        return "oscillatingFixedValue", [
            ("refValue", bc.ref_grad),
            *((k, repr(float(bc.opt(k)))) for k in ("amplitude",
                                                    "frequency"))]
    return kind, []


def _table_rows(uv, rank: int):
    """`table ((t0 v0) (t1 v1) ...)` rows as a hashable tuple ((t, v), ...)
    (scalar v, or a tuple v for vectors); None for another form or a
    table of fewer than two rows."""
    if uv is None:
        return None
    items = uv if isinstance(uv, list) else [uv]
    words = [str(x) for x in items if isinstance(x, (Word, str))]
    nums = [x for x in items if isinstance(x, (int, float, np.ndarray))]
    if "table" not in words or not nums:
        return None
    rows = np.asarray(nums[-1], dtype=float)
    rows = rows.reshape(-1, rows.shape[-1]) if rows.ndim > 1 \
        else rows.reshape(1, -1)
    if rows.shape[0] < 2:
        return None
    out = []
    for r in rows:
        v = tuple(float(x) for x in r[1:]) if rank == 1 else float(r[-1])
        out.append((float(r[0]), v))
    return tuple(out)


def _num(x) -> float:
    """The last numeric token of a possibly dimensioned entry."""
    if isinstance(x, (list, tuple)):
        x = x[-1]
    return float(np.asarray(x, dtype=float).reshape(-1)[-1])


def _uniform_entry(uv, size, rank, dtype, device, fallback):
    """uniformValue: a bare number or vector, `constant v`, or
    `table ((t0 v0) (t1 v1) ...)` sampled at t = 0."""
    if uv is None:
        return fallback if fallback is not None else 0.0
    items = uv if isinstance(uv, list) else [uv]
    words = [str(x) for x in items if isinstance(x, (Word, str))]
    nums = [x for x in items if isinstance(x, (int, float, np.ndarray))]
    if "table" in words and nums:
        rows = np.asarray(nums[-1], dtype=float)
        rows = rows.reshape(-1, rows.shape[-1]) if rows.ndim > 1 \
            else rows.reshape(1, -1)
        first = rows[0]
        v = first[1:] if first.shape[0] > 1 else first
    elif nums:
        v = np.asarray(nums[-1], dtype=float).reshape(-1)
    else:
        return fallback if fallback is not None else 0.0
    if rank == 1:
        arr = np.broadcast_to(v[-3:], (size, 3))
    else:
        arr = np.full(size, float(v[-1]))
    return torch.tensor(np.asarray(arr), dtype=dtype, device=device)
