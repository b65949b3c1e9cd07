"""The boundary-condition layer of the port (foamtpu_torch/bc/: the
derived batches of derived2.py, derived3.py and derived4.py, the kinds
bc/patchfields.py maps directly, and the whole of factory.py's map) and
the contact angle of models/interface.py, held to the JAX package.

- The unit cases are the port's twins of tests/test_bc_derived{,2,3,4}.py
  (47 tests there): the same BC built in both packages from the same
  dictionary entry (or the same `make` arguments), updated with the same
  seeded context on the 8x8 cavity, then its ref_value, ref_grad and
  vfrac, its value and gradient coefficients and `evaluate` held in
  float64 at rtol 1e-12. turbulentInlet's noise is drawn differently in
  the port (bc/derived2.py), so its case holds the bounds and the mean.
- Every name the reference's factory maps builds in both packages with
  the same kind, value and coefficients; a name it does not map raises
  in the port.
- Solver level: interFoam's damBreak at 16x16 with constantAlpha- and
  dynamicAlphaContactAngle walls and fixedFluxPressure, and the icoFoam
  cavity with a timeVaryingMappedFixedValue lid (its
  constant/boundaryData written from a seed) and a uniformFixedValue
  table, run 3 steps in both packages; fields held at rtol 1e-9, Krylov
  counts equal.

All of it runs in one float64 process (FOAMTPU_X64=1 JAX_ENABLE_X64=1);
each test reads its record.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from foamtpu_torch.bc import factory as tfactory
from foamtpu_torch.core.dictionary import parse_string as tparse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BODY = r'''
import contextlib, io, json, os, re, shutil, sys, tempfile
import numpy as np
import torch
import jax.numpy as jnp

import foamtpu.models.turbulence.ras  # noqa: F401 (wall-function rules)
import foamtpu_torch.models.turbulence.ras  # noqa: F401
from foamtpu.apps.cases import CAVITY_BLOCKMESH
from foamtpu.bc import factory as jfac, patchfields as jpf
from foamtpu.bc.derived3 import _Frozen as JFrozen
from foamtpu.core.dictionary import parse_string as jparse
from foamtpu.core.fields import vol_scalar as jvs, vol_vector as jvv
from foamtpu.mesh import blockmesh, to_device
from foamtpu.models.interface import _correct_contact_angle as jcca
from foamtpu_torch import convert
from foamtpu_torch.bc import factory as tfac, patchfields as tpf
from foamtpu_torch.bc.derived3 import _Frozen as TFrozen
from foamtpu_torch.core.dictionary import parse_string as tparse
from foamtpu_torch.core.fields import vol_scalar as tvs, vol_vector as tvv
from foamtpu_torch.models.interface import _correct_contact_angle as tcca

JM = to_device(blockmesh.generate(
    jparse(CAVITY_BLOCKMESH.replace("{n}", "8"))))
TM = convert.mesh_from_numpy(JM, device="cpu")
RNG = np.random.default_rng(18)
NC, NF = JM.n_cells, JM.n_faces
TMP = tempfile.mkdtemp()


def jt(x):
    return jnp.asarray(x) if isinstance(x, np.ndarray) else x


def tt(x):
    return torch.tensor(x, dtype=torch.float64) \
        if isinstance(x, np.ndarray) else x


def patch(name):
    return JM.patch(name), TM.patches[[p.name for p in TM.patches]
                                      .index(name)]


def build(spec, name="movingWall", rank=0, **kw):
    jp, tp = patch(name)
    jb = jfac.from_dict(jparse(spec), jp, rank, jnp.float64, mesh=JM, **kw)
    tb = tfac.from_dict(tparse(spec), tp, rank, torch.float64, "cpu",
                        mesh=TM, **kw)
    return jb, tb


def conv(v, frozen):
    return frozen(v[1]) if isinstance(v, tuple) and v and v[0] == "F" \
        else v


def made(kind, name="movingWall", **kw):
    jp, tp = patch(name)
    jk = {k: conv(jt(v), JFrozen) for k, v in kw.items()}
    tk = {k: conv(tt(v), TFrozen) for k, v in kw.items()}
    return jpf.make(kind, **jk), tpf.make(kind, **tk)


def err(a, b):
    a = np.asarray(a, dtype=float)
    b = b.detach().cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    a, b = np.broadcast_arrays(a, np.asarray(b, dtype=float))
    if a.shape != b.shape:
        return float("inf")
    scale = max(float(np.abs(a).max(initial=0.0)), 1e-300)
    return float(np.abs(a - b).max(initial=0.0) / scale)


def compare(rec, jb, tb, name, internal, coeffs=True, label=""):
    """Hold the BC's data and, with `coeffs`, its value and gradient
    coefficients and evaluate on `internal`."""
    jp, tp = patch(name)
    rec.setdefault("kinds", []).append([jb.kind, tb.kind])
    errs = rec.setdefault("errs", {})
    for a in ("ref_value", "ref_grad", "vfrac"):
        errs[label + a] = err(getattr(jb, a), getattr(tb, a))
    if coeffs:
        ji, ti = jt(internal), tt(internal)
        for what, jf, tf in (("value_coeffs", jpf.value_coeffs,
                              tpf.value_coeffs),
                             ("grad_coeffs", jpf.grad_coeffs,
                              tpf.grad_coeffs)):
            for i, (a, b) in enumerate(zip(jf(jb, JM, jp, ji),
                                           tf(tb, TM, tp, ti))):
                errs[f"{label}{what}{i}"] = err(a, b)
        errs[label + "evaluate"] = err(jpf.evaluate(jb, JM, jp, ji),
                                       tpf.evaluate(tb, TM, tp, ti))


def updated(jb, tb, name, internal, **ctx):
    jp, tp = patch(name)
    jc = {k: jt(v) for k, v in ctx.items()}
    tc = {k: tt(v) for k, v in ctx.items()}
    return (jpf.update(jb, JM, jp, jt(internal), **jc),
            tpf.update(tb, TM, tp, tt(internal), **tc))


def run(rec, jb, tb, internal, name="movingWall", coeffs=True, **ctx):
    compare(rec, jb, tb, name, internal, coeffs, "built_")
    jb, tb = updated(jb, tb, name, internal, **ctx)
    compare(rec, jb, tb, name, internal, coeffs)
    return jb, tb


S = RNG.standard_normal(NC)
V = RNG.standard_normal((NC, 3))
PHI = RNG.standard_normal(NF)
UP = V * 0.0 + np.array([10.0, 0.0, 0.0])
CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


# ---- tests/test_bc_derived.py --------------------------------------------
@case
def rotating_wall_velocity(rec):
    run(rec, *build("type rotatingWallVelocity; origin (0.05 0.05 0); "
                    "axis (0 0 1); omega 10;", rank=1), V, phi=PHI)


@case
def pressure_inlet_velocity(rec):
    run(rec, *made("pressureInletVelocity", ref_value=np.zeros(3),
                   vfrac=1.0), V, phi=PHI)


@case
def variable_height_flow_rate(rec):
    a = RNG.random(NC) * 1.6 - 0.3
    run(rec, *made("variableHeightFlowRate", vfrac=0.0, lowerBound=0.0,
                   upperBound=1.0), a)


@case
def wave_transmissive(rec):
    c = np.abs(RNG.standard_normal(NF)) * 300.0
    for lbl, fi, li in (("a", 1e5, 0.0), ("b", 5.0, 1e-4)):
        jb, tb = made("waveTransmissive", ref_value=np.zeros(8),
                      vfrac=0.0, fieldInf=fi, lInf=li)
        jb, tb = updated(jb, tb, "movingWall", S, phi=PHI, dt=0.7,
                         c_sound=c)
        compare(rec, jb, tb, "movingWall", S, label=lbl)
    run(rec, *build("type waveTransmissive; fieldInf 2; lInf 0.3; "
                    "value uniform 1;"), S, phi=PHI, dt=0.01)


@case
def fixed_flux_pressure(rec):
    sg = RNG.standard_normal(NF)
    run(rec, *build("type fixedFluxPressure;"), S, snGradP=sg)


@case
def supersonic_freestream(rec):
    run(rec, *made("supersonicFreestream", ref_value=3.0, vfrac=0.0), S,
        phi=PHI)


@case
def cylindrical_inlet_velocity(rec):
    run(rec, *build("type cylindricalInletVelocity; centre (0.05 0.05 0);"
                    " axis (0 0 1); axialVelocity 2; radialVelocity 0.5;"
                    " rpm 60;", rank=1), V)


@case
def swirl_flow_rate_inlet_velocity(rec):
    run(rec, *build("type swirlFlowRateInletVelocity; origin (0.05 0.05 "
                    "0); axis (0 0 1); flowRate 0.002; rpm 30;", rank=1), V)


@case
def uniform_fixed_value_table(rec):
    run(rec, *build("type uniformFixedValue; uniformValue table ((0 3.5) "
                    "(1 7));"), S)


@case
def external_wall_heat_flux(rec):
    for lbl, spec in (("q", "q 1000; kappaValue 10;"),
                      ("h", "h 20; Ta 350; kappaValue 1;")):
        jb, tb = build("type externalWallHeatFluxTemperature; " + spec)
        compare(rec, jb, tb, "movingWall", S, label=lbl)


@case
def pressure_directed_inlet_velocity(rec):
    run(rec, *build("type pressureDirectedInletVelocity; "
                    "inletDirection (0 -1 0.2); "
                    "value uniform (0 0 0);", rank=1), V,
        phi=np.full(NF, -0.004))


@case
def flux_corrected_and_total_temperature(rec):
    run(rec, *build("type fluxCorrectedVelocity; value uniform (1 0 0);",
                    rank=1), V, phi=PHI)
    jb, tb = build("type totalTemperature; T0 uniform 400;")
    compare(rec, jb, tb, "movingWall", S, label="T")


# ---- tests/test_bc_derived2.py -------------------------------------------
@case
def partial_slip(rec):
    run(rec, *made("partialSlip", vfrac=0.25), V)
    run(rec, *build("type partialSlip; valueFraction uniform 0.4;",
                    rank=1), V)


@case
def fixed_normal_slip(rec):
    run(rec, *build("type fixedNormalSlip; fixedValue uniform (0 2 0);",
                    rank=1), V)


@case
def translating_wall_velocity(rec):
    run(rec, *build("type translatingWallVelocity; U (1 2 3);", rank=1), V)


@case
def inlet_outlet_total_temperature(rec):
    for lbl, sgn in (("in", -1.0), ("out", 1.0)):
        jb, tb = build("type inletOutletTotalTemperature; T0 uniform 400; "
                       "Cp 1000;")
        jb, tb = updated(jb, tb, "movingWall", S, phi=sgn * np.abs(PHI),
                         U=UP + V)
        compare(rec, jb, tb, "movingWall", S, label=lbl)


@case
def outlet_mapped_uniform_inlet(rec):
    run(rec, *build("type outletMappedUniformInlet; outletPatchName "
                    "fixedWalls; fraction 0.5;"), S)
    run(rec, *build("type outletMappedUniformInlet; outletPatchName "
                    "fixedWalls; fraction 0.5;", rank=1), V)


@case
def turbulent_inlet(rec):
    """Both lie in ref +- scale |ref| / 2 and differ between times; the
    port's draws (its own generator) are held by bounds and mean."""
    out = {}
    for lbl, rank, spec in (
            ("U", 1, "referenceField uniform (10 0 0); "
                     "fluctuationScale (0.1 0 0);"),
            ("k", 0, "referenceField uniform 2; fluctuationScale 0.2;")):
        jb, tb = build("type turbulentInlet; " + spec, rank=rank)
        _, tp = patch("movingWall")
        tpf_bc = tb
        internal = tt(V if rank else S)
        draws = []
        for t in (0.37, 0.62):
            u = tpf.update(tpf_bc, TM, tp, internal, t=t).ref_value
            draws.append(u.numpy().copy())
        jd = np.asarray(jpf.update(jb, JM, patch("movingWall")[0],
                                   jt(V if rank else S), t=0.37).ref_value)
        ref, sc = (10.0, 0.1) if rank else (2.0, 0.2)
        a = draws[0][:, 0] if rank else draws[0]
        b = jd[:, 0] if rank else jd
        out[lbl] = {"port_in_bounds": bool(np.all(np.abs(a - ref)
                                                  <= 0.5 * sc * ref)),
                    "jax_in_bounds": bool(np.all(np.abs(b - ref)
                                                 <= 0.5 * sc * ref + 1e-12)),
                    "port_mean": float(np.mean(a - ref) / (sc * ref)),
                    "moves": not np.allclose(draws[0], draws[1]),
                    "others_zero": bool(not rank or np.allclose(
                        draws[0][:, 1:], 0.0)),
                    "kind": [jb.kind, tb.kind]}
    rec["turbulent"] = out


@case
def atm_boundary_layer(rec):
    for lbl, rank, spec in (
            ("U", 1, "type atmBoundaryLayerInletVelocity; Uref 10; "
                     "Href 20; z0 0.1; flowDir (1 0 0); zDir (0 1 0); "
                     "zGround 0;"),
            ("eps", 0, "type atmBoundaryLayerInletEpsilon; Uref 10; "
                       "Href 20; z0 0.1; zDir (0 1 0);")):
        jb, tb = build(spec, "fixedWalls", rank)
        compare(rec, jb, tb, "fixedWalls", V if rank else S, label=lbl)


@case
def nut_spalding(rec):
    run(rec, *made("nutUSpaldingWallFunction", ref_value=0.0, vfrac=1.0),
        S, U=UP * 0.02 + 0.01 * V, nu=1e-5)


@case
def nutk_rough(rec):
    k = 0.01 + 0.001 * np.abs(S)
    for lbl, ks in (("smooth", 0.0), ("rough", 0.01)):
        jb, tb = build(f"type nutkRoughWallFunction; Ks {ks}; Cs 0.5;")
        jb, tb = updated(jb, tb, "movingWall", k, k=k, nu=1e-5)
        compare(rec, jb, tb, "movingWall", k, label=lbl)
    jb, tb = made("nutkWallFunction", ref_value=0.0, vfrac=1.0)
    jb, tb = updated(jb, tb, "movingWall", k, k=k, nu=1e-5)
    compare(rec, jb, tb, "movingWall", k, label="nutk")


@case
def rotating_total_pressure(rec):
    run(rec, *build("type rotatingTotalPressure; p0 uniform 10; origin "
                    "(0.05 0.05 0); axis (0 0 1); omega 5;"), S, phi=PHI,
        U=V)


@case
def rotating_pio_velocity(rec):
    """Its update sets a per-component valueFraction [n, 3], which the
    mixed value coefficients cannot take (per face): after an update
    both packages raise there (ROADMAP Queue 3); the data are held."""
    jb, tb = build("type rotatingPressureInletOutletVelocity; origin "
                   "(0.05 0.05 0); axis (0 0 1); omega 5;", rank=1)
    run(rec, jb, tb, V, coeffs=False, phi=PHI)
    compare(rec, jb, tb, "movingWall", V, label="built_")
    jb, tb = updated(jb, tb, "movingWall", V, phi=PHI)
    jp, tp = patch("movingWall")
    raised = []
    for fn, b, m, p, x in ((jpf.value_coeffs, jb, JM, jp, jt(V)),
                           (tpf.value_coeffs, tb, TM, tp, tt(V))):
        try:
            fn(b, m, p, x)
            raised.append(False)
        except (ValueError, RuntimeError):
            raised.append(True)
    rec["errs"]["both_raise"] = 0.0 if raised == [True, True] else 1.0


@case
def uniform_fixed_value_table_dynamic(rec):
    for lbl, t in (("mid", 0.5), ("end", 5.0), ("start", -1.0)):
        jb, tb = build("type uniformFixedValue; uniformValue table ((0 1) "
                       "(1 3) (2 2.5));")
        jb, tb = updated(jb, tb, "movingWall", S, t=t)
        compare(rec, jb, tb, "movingWall", S, label=lbl)
    jb, tb = build("type uniformFixedValue; uniformValue table ((0 (1 0 0))"
                   " (1 (3 1 0)));", rank=1)
    run(rec, jb, tb, V, t=0.25)


@case
def oscillating_fixed_value(rec):
    run(rec, *build("type oscillatingFixedValue; refValue uniform 2; "
                    "amplitude 0.5; frequency 1;"), S, t=0.3)


@case
def alphat_jayatilleke(rec):
    for lbl, pr in (("equal", 0.85), ("air", 0.7)):
        jb, tb = build("type alphatJayatillekeWallFunction; Prt 0.85; "
                       f"Pr {pr};")
        jb, tb = updated(jb, tb, "movingWall", S,
                         nut=1e-3 + 1e-4 * np.abs(PHI), nu=1e-5)
        compare(rec, jb, tb, "movingWall", S, label=lbl)


@case
def freestream_pressure(rec):
    run(rec, *build("type freestreamPressure; value uniform 101325;"), S,
        phi=PHI)


# ---- tests/test_bc_derived3.py -------------------------------------------
@case
def pressure_inlet_uniform_velocity(rec):
    run(rec, *build("type pressureInletUniformVelocity; value uniform "
                    "(0 0 0);", rank=1), V, phi=PHI)


@case
def pressure_normal_io_velocity(rec):
    for lbl, sgn in (("out", 1.0), ("in", -1.0)):
        jb, tb = build("type pressureNormalInletOutletVelocity; value "
                       "uniform (0 0 0);", rank=1)
        jb, tb = updated(jb, tb, "movingWall", V, phi=sgn * np.abs(PHI))
        compare(rec, jb, tb, "movingWall", V, label=lbl)


@case
def fixed_shear_stress(rec):
    run(rec, *build("type fixedShearStress; tau (0 0.2 0); value uniform "
                    "(0 0 0);", rank=1), V, nu=1e-2,
        nut_b=1e-3 * np.abs(PHI))


@case
def buoyant_pressure(rec):
    run(rec, *build("type buoyantPressure; value uniform 0;", "fixedWalls"),
        S, name="fixedWalls", rho_b=2.0 + 0.1 * S, g=(0.0, -9.81, 0.0))


@case
def uniform_density_hydrostatic_pressure(rec):
    jb, tb = build("type uniformDensityHydrostaticPressure; rho 1000; "
                   "pRefValue 101325; pRefPoint (0 0.1 0); g (0 -9.81 0);",
                   "fixedWalls")
    compare(rec, jb, tb, "fixedWalls", S)


@case
def turbulent_heat_flux_temperature(rec):
    for lbl, mode in (("flux", "flux"), ("power", "power")):
        jb, tb = build(f"type turbulentHeatFluxTemperature; heatSource "
                       f"{mode}; q 100; alphaEff 1e-3; rho 1; Cp 1000; "
                       "value uniform 300;", "fixedWalls")
        jb, tb = updated(jb, tb, "fixedWalls", S)
        compare(rec, jb, tb, "fixedWalls", S, label=lbl)


@case
def fixed_pressure_compressible_density(rec):
    run(rec, *build("type fixedPressureCompressibleDensity; p0 1e5; rho0 "
                    "1000; psi 1e-5; value uniform 1000;", "fixedWalls"),
        1000.0 + S, name="fixedWalls", p_b=2e5 + 1e3 * S)


@case
def uniform_fixed_gradient_table(rec):
    run(rec, *build("type uniformFixedGradient; uniformGradient table "
                    "((0 0) (1 10));", "fixedWalls"), S, name="fixedWalls",
        t=0.5)


@case
def advective(rec):
    jb, tb = build("type advective; fieldInf 10; lInf 0.1; value uniform "
                   "0;")
    for _ in range(20):
        jb, tb = updated(jb, tb, "movingWall", S, phi=0.01 + 0 * PHI,
                         dt=0.1)
    compare(rec, jb, tb, "movingWall", S, label="relaxed")
    run(rec, *build("type advective; value uniform 0;"), S,
        phi=0.01 + 0 * PHI, dt=0.1)


@case
def time_varying_mapped_fixed_value(rec):
    d = os.path.join(TMP, "tvm")
    jp, tp = patch("movingWall")
    cf = np.asarray(JM.cf)[jp.slice]
    bd = os.path.join(d, "constant", "boundaryData", "movingWall")
    rng = np.random.default_rng(7)
    for tname in ("0", "2", "3.5"):
        os.makedirs(os.path.join(bd, tname), exist_ok=True)
        vals = rng.standard_normal((jp.size, 3))
        with open(os.path.join(bd, tname, "U"), "w") as f:
            f.write(f"{jp.size}\n(" + " ".join(
                "(%r %r %r)" % tuple(map(float, v)) for v in vals) + ")\n")
    pts = cf[::-1] + 1e-4
    with open(os.path.join(bd, "points"), "w") as f:
        f.write(f"{jp.size}\n(" + " ".join(
            "(%r %r %r)" % tuple(map(float, p)) for p in pts) + ")\n")
    spec = "type timeVaryingMappedFixedValue; value uniform (0 0 0);"
    for lbl, t in (("mid", 1.0), ("before", -5.0), ("late", 3.0),
                   ("after", 9.0)):
        jb, tb = build(spec, rank=1, case_dir=d, field_name="U")
        jb, tb = updated(jb, tb, "movingWall", V, t=t)
        compare(rec, jb, tb, "movingWall", V, label=lbl)
    # the reference's BC carried across by convert.py, then updated
    jb, _ = build(spec, rank=1, case_dir=d, field_name="U")
    tb = convert.patchfield_from_numpy(jb, device="cpu")
    jb, tb = updated(jb, tb, "movingWall", V, t=2.5)
    compare(rec, jb, tb, "movingWall", V, label="convert")


# ---- tests/test_bc_derived4.py -------------------------------------------
def angle_fields(theta0, dynamic, uwall=0.0):
    i = [p.name for p in JM.patches].index("movingWall")
    kw = dict(ref_grad=0.0, vfrac=0.0, theta0=float(np.radians(theta0)))
    if dynamic:
        kw.update(thetaA=float(np.radians(120.0)),
                  thetaR=float(np.radians(60.0)), uTheta=0.5)
    out = []
    for vs, vv, pf, arr in ((jvs, jvv, jpf, jnp.asarray),
                            (tvs, tvv, tpf, tt)):
        mesh = JM if pf is jpf else TM
        alpha = vs(mesh, 0.5, name="alpha")
        bcs = list(alpha.bcs)
        bcs[i] = pf.make("alphaContactAngle", **kw)
        alpha = alpha.replace(bcs=tuple(bcs))
        U = vv(mesh, [0.0, 0.0, 0.0], name="U")
        U = U.with_data(arr(V * 0.3))
        ub = list(U.bcs)
        ub[i] = pf.make("fixedValue", ref_value=arr(
            np.array([uwall, 0.0, 0.0])))
        out.append((alpha, U.replace(bcs=tuple(ub))))
    return out


@case
def contact_angle_rotates_boundary_normals(rec):
    nh = RNG.standard_normal((NF, 3))
    nh /= np.linalg.norm(nh, axis=1, keepdims=True)
    (ja, _), (ta, _) = angle_fields(45.0, False)
    rec["errs"] = {"nhat": err(jcca(JM, ja, jnp.asarray(nh)),
                               tcca(TM, ta, tt(nh)))}
    i = [p.name for p in TM.patches].index("movingWall")
    rec["kinds"] = [["alphaContactAngle", ta.bcs[i].kind]]


@case
def contact_angle_parse(rec):
    for lbl, spec in (("const", "type constantAlphaContactAngle; theta0 60;"
                       " limit gradient; value uniform 0;"),
                      ("dyn", "type dynamicAlphaContactAngle; theta0 90; "
                       "uTheta 1; thetaA 120; thetaR 60; value uniform 0;")):
        jb, tb = build(spec)
        compare(rec, jb, tb, "movingWall", S, label=lbl)
        rec.setdefault("opts", []).append([list(map(list, jb.opts)),
                                           list(map(list, tb.opts))])


@case
def maxwell_slip_u(rec):
    jp, _ = patch("movingWall")
    ui = V[:jp.size] + np.array([1.0, 0.0, 0.0])
    for lbl, lam in (("noslip", 0.0), ("slip", 1e9), ("mid", 0.01)):
        jb, tb = made("maxwellSlipU", ref_value=0.0, vfrac=1.0,
                      **{"lambda": lam, "accommodationCoeff": 0.9,
                         "Uwall": (0.1, 0.0, 0.0)})
        jb, tb = updated(jb, tb, "movingWall", ui)
        compare(rec, jb, tb, "movingWall", ui, coeffs=False, label=lbl)


@case
def smoluchowski_jump_t(rec):
    jp, _ = patch("movingWall")
    ti = 400.0 + S[:jp.size]
    for lbl, lam in (("wall", 0.0), ("jump", 1e9), ("mid", 0.01)):
        jb, tb = made("smoluchowskiJumpT", ref_value=300.0, vfrac=1.0,
                      **{"lambda": lam, "Twall": 300.0})
        jb, tb = updated(jb, tb, "movingWall", ti)
        compare(rec, jb, tb, "movingWall", ti, coeffs=False, label=lbl)


@case
def fixed_rho(rec):
    run(rec, *made("fixedRho", ref_value=1.0, vfrac=1.0, psi=1e-5),
        1.0 + 0.1 * S, p_b=2e5 + 1e3 * PHI)


@case
def fan_pressure(rec):
    jp, _ = patch("movingWall")
    area = float(np.asarray(JM.mag_sf)[jp.slice].sum())
    for lbl, q in (("still", 0.0), ("half", 0.5), ("full", 1.0),
                   ("over", 2.0)):
        phi = np.zeros(NF)
        phi[jp.slice] = -q * np.asarray(JM.mag_sf)[jp.slice] / area
        jb, tb = made("fanPressure", ref_value=0.0, vfrac=1.0, p0=5.0,
                      direction="in",
                      fanCurve=("F", np.array([[0.0, 10.0], [0.3, 8.0],
                                               [1.0, 0.0]])))
        jb, tb = updated(jb, tb, "movingWall", np.zeros(jp.size), phi=phi)
        compare(rec, jb, tb, "movingWall", S, coeffs=False, label=lbl)
    jb, tb = build("type fanPressure; p0 0; fanCurve table ((0 10) (1 0));"
                   " direction in; value uniform 0;")
    compare(rec, jb, tb, "movingWall", S, label="parsed")


@case
def syringe_pressure(rec):
    jp, _ = patch("movingWall")
    for lbl, t in (("ramp", 0.05), ("mid", 0.2), ("late", 0.5)):
        jb, tb = made("syringePressure", ref_value=0.0, vfrac=1.0, Ap=1e-4,
                      Sp=0.1, VsI=1e-5, tas=0.0, tae=0.1, tds=0.3, tde=0.4,
                      psI=1e5)
        jb, tb = updated(jb, tb, "movingWall", np.zeros(jp.size), t=t)
        compare(rec, jb, tb, "movingWall", S, coeffs=False, label=lbl)


@case
def pressure_io_par_slip(rec):
    jp, _ = patch("movingWall")
    ui = V[:jp.size]
    phi = np.zeros(NF)
    phi[jp.slice] = PHI[:jp.size]
    jb, tb = made("pressureInletOutletParSlipVelocity", ref_value=0.0,
                  vfrac=0.0)
    jb, tb = updated(jb, tb, "movingWall", ui, phi=phi)
    compare(rec, jb, tb, "movingWall", ui, coeffs=False)


@case
def parse_batch4_kinds(rec):
    for lbl, rank, spec in (
            ("maxwell", 1, "type maxwellSlipU; accommodationCoeff 0.9; "
                           "Uwall (0 0 0); value uniform (0 0 0);"),
            ("smol", 0, "type smoluchowskiJumpT; accommodationCoeff 1; "
                        "Twall 300; value uniform 300;"),
            ("rho", 0, "type fixedRho; value uniform 1;"),
            ("syringe", 0, "type syringePressure; Ap 1e-4; Sp 0.1; VsI 1e-5;"
                           " tas 0; tae 0.1; tds 0.2; tde 0.3; psI 1e5; "
                           "value uniform 1e5;"),
            ("parslip", 1, "type pressureInletOutletParSlipVelocity; "
                           "value uniform (0 0 0);"),
            ("lowre", 0, "type nutLowReWallFunction; value uniform 0.3;")):
        jb, tb = build(spec, rank=rank)
        compare(rec, jb, tb, "movingWall", V if rank else S, label=lbl)


@case
def dynamic_contact_angle_velocity_dependence(rec):
    nh = RNG.standard_normal((NF, 3))
    nh /= np.linalg.norm(nh, axis=1, keepdims=True)
    errs = {}
    for ux in (0.0, 0.8, -0.8):
        (ja, jU), (ta, tU) = angle_fields(90.0, True, ux)
        errs[f"u{ux}"] = err(jcca(JM, ja, jnp.asarray(nh), U=jU),
                             tcca(TM, ta, tt(nh), U=tU))
    rec["errs"] = errs
    rec["kinds"] = [["alphaContactAngle", "alphaContactAngle"]]


def run_cases():
    out = {}
    for name, fn in CASES.items():
        rec = {}
        try:
            fn(rec)
        except Exception as e:  # reported per case
            rec["error"] = repr(e)
        out[name] = rec
    return out


def all_names():
    """Every name the reference's factory maps: its _ALIASES, the
    compressible renames, the low-Re wall functions and the coded
    pair; built in both packages from a `value`, and a `code` for the
    coded ones."""
    names = sorted(set(jfac._ALIASES) | set(tfac.NAMES))
    out = {}
    vec = ("Velocity", "Slip", "U", "noSlip", "slip", "wedge", "symmetry",
           "cyclic", "fan", "Jump", "empty", "partial", "FixedValue",
           "coded")
    for name in names:
        rank = 1 if any(s in name for s in vec) else 0
        val = "(1.5 -0.5 0.25)" if rank else "2.5"
        spec = f"type {name}; value uniform {val};"
        if name.startswith("coded"):
            spec += (" code #{\nvalue = np.stack([Cf[:, 0], Cf[:, 1], "
                     "normal[:, 1]], axis=1)\n#};")
        rec = {"rank": rank}
        try:
            jb, tb = build(spec, rank=rank)
            compare(rec, jb, tb, "movingWall", V if rank else S)
            # the port's turbulentInlet carries its generator's seed
            rec["opts_equal"] = [k for k, _ in jb.opts] == \
                [k for k, _ in tb.opts if k != "seed"]
        except Exception as e:
            rec["error"] = repr(e)
        out[name] = rec
    return out


# ---- solver level ----------------------------------------------------------
def solver_cases(steps):
    from foamtpu.apps.cli import main as jcli
    import foamtpu.solvers.apps  # noqa: F401 (registers the applications)
    from foamtpu.core.case import _APPLICATIONS, Case as JCase
    from foamtpu_torch.core.case import Case as TCase
    from foamtpu_torch.solvers.apps import run as trun

    repo = os.getcwd()
    out = {}

    def edit(path, pairs):
        with open(path) as f:
            text = f.read()
        for a, b in pairs:
            new = re.sub(a, b, text)
            assert new != text, (path, a)
            text = new
        with open(path, "w") as f:
            f.write(text)

    def dam(dyn):
        d = os.path.join(TMP, "dam_dyn" if dyn else "dam")
        shutil.copytree(os.path.join(
            repo, "tutorials/multiphase/interFoam/laminar/damBreak"), d)
        edit(os.path.join(d, "constant/polyMesh/blockMeshDict"),
             [(r"\(46 46 1\)", "(16 16 1)")])
        angle = ("dynamicAlphaContactAngle; theta0 70; uTheta 0.05; "
                 "thetaA 100; thetaR 40;" if dyn else
                 "constantAlphaContactAngle; theta0 45;")
        with contextlib.redirect_stdout(io.StringIO()):
            assert jcli(["blockMesh", "-case", d]) == 0
            assert jcli(["setFields", "-case", d]) == 0
        # after setFields, which writes the walls back as they were read
        wall = r"(leftWall|rightWall|lowerWall)\s*\{\s*type\s+zeroGradient;\s*\}"
        edit(os.path.join(d, "0/alpha1"),
             [(wall, r"\1 { type " + angle
               + " limit gradient; value uniform 0; }")])
        edit(os.path.join(d, "0/p_rgh"),
             [(wall, r"\1 { type fixedFluxPressure; value uniform 0; }")])
        return d

    def cavity():
        d = os.path.join(TMP, "cavity")
        shutil.copytree(os.path.join(
            repo, "tutorials/incompressible/icoFoam/cavity"), d)
        edit(os.path.join(d, "constant/polyMesh/blockMeshDict"),
             [(r"\(20 20 1\)", "(16 16 1)")])
        edit(os.path.join(d, "0/U"),
             [(r"movingWall\s*\{[^}]*\}",
               "movingWall { type timeVaryingMappedFixedValue; "
               "value uniform (1 0 0); }")])
        edit(os.path.join(d, "0/p"),
             [(r"fixedWalls\s*\{[^}]*\}",
               "fixedWalls { type uniformFixedValue; uniformValue table "
               "((0 0.25) (1 0.5)); }")])
        with contextlib.redirect_stdout(io.StringIO()):
            assert jcli(["blockMesh", "-case", d]) == 0
        jm = JCase(d).mesh
        wall = jm.patch("movingWall")
        cf = np.asarray(jm.cf)[wall.slice]
        bd = os.path.join(d, "constant/boundaryData/movingWall")
        rng = np.random.default_rng(18)
        for tname, base in (("0", 1.0), ("0.01", 1.2)):
            os.makedirs(os.path.join(bd, tname))
            vals = np.stack([base + 0.1 * rng.standard_normal(wall.size),
                             0.05 * rng.standard_normal(wall.size),
                             np.zeros(wall.size)], axis=1)
            with open(os.path.join(bd, tname, "U"), "w") as f:
                f.write(f"{wall.size}\n(" + " ".join(
                    "(%r %r %r)" % tuple(map(float, v)) for v in vals) + ")\n")
        with open(os.path.join(bd, "points"), "w") as f:
            f.write(f"{wall.size}\n(" + " ".join(
                "(%r %r %r)" % tuple(map(float, p)) for p in cf) + ")\n")
        return d

    def jrun(case, max_steps):
        _APPLICATIONS[case.application](case, max_steps=max_steps)

    def iters(text):
        return [int(m) for m in re.findall(r"No Iterations (\d+)", text)]

    for name, make in (("dam_constant", lambda: dam(False)),
                       ("dam_dynamic", lambda: dam(True)),
                       ("cavity_tvm", cavity)):
        d = make()
        jc, tc = JCase(d), TCase(d, device="cpu")
        logs = []
        for fn, c in ((jrun, jc), (trun, tc)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                fn(c, max_steps=steps)
            logs.append(buf.getvalue())
        js, ts = jc.final_state, tc.final_state
        rec = {"iters": [iters(logs[0]), iters(logs[1])], "errs": {},
               "kinds": [b.kind for k in ("alpha", "U", "p", "p_rgh")
                         if k in ts for b in ts[k].bcs]}
        for k in ("U", "p", "p_rgh", "alpha"):
            if k in js and hasattr(js[k], "data"):
                rec["errs"][k] = err(js[k].data, ts[k].data)
        if "phi" in js:
            rec["errs"]["phi"] = err(js["phi"], ts["phi"])
        out[name] = rec
    return out


print(json.dumps({"cases": run_cases(), "names": all_names(),
                  "solvers": solver_cases(int(sys.argv[1]))}))
'''


def _body(*args, timeout=600):
    env = dict(os.environ)
    env.update(FOAMTPU_X64="1", JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", BODY, *args], env=env,
                       cwd=REPO, capture_output=True, text=True,
                       timeout=timeout)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def units():
    return _body("3")


UNIT_CASES = (
    # tests/test_bc_derived.py
    "rotating_wall_velocity", "pressure_inlet_velocity",
    "variable_height_flow_rate", "wave_transmissive", "fixed_flux_pressure",
    "supersonic_freestream", "cylindrical_inlet_velocity",
    "swirl_flow_rate_inlet_velocity", "uniform_fixed_value_table",
    "external_wall_heat_flux", "pressure_directed_inlet_velocity",
    "flux_corrected_and_total_temperature",
    # tests/test_bc_derived2.py
    "partial_slip", "fixed_normal_slip", "translating_wall_velocity",
    "inlet_outlet_total_temperature", "outlet_mapped_uniform_inlet",
    "atm_boundary_layer", "nut_spalding", "nutk_rough",
    "rotating_total_pressure", "rotating_pio_velocity",
    "uniform_fixed_value_table_dynamic", "oscillating_fixed_value",
    "alphat_jayatilleke", "freestream_pressure",
    # tests/test_bc_derived3.py
    "pressure_inlet_uniform_velocity", "pressure_normal_io_velocity",
    "fixed_shear_stress", "buoyant_pressure",
    "uniform_density_hydrostatic_pressure",
    "turbulent_heat_flux_temperature", "fixed_pressure_compressible_density",
    "uniform_fixed_gradient_table", "advective",
    "time_varying_mapped_fixed_value",
    # tests/test_bc_derived4.py
    "contact_angle_rotates_boundary_normals", "contact_angle_parse",
    "maxwell_slip_u", "smoluchowski_jump_t", "fixed_rho", "fan_pressure",
    "syringe_pressure", "pressure_io_par_slip", "parse_batch4_kinds",
    "dynamic_contact_angle_velocity_dependence")


def _assert_record(rec, what):
    assert "error" not in rec, (what, rec.get("error"))
    assert rec.get("errs"), what
    for a, b in rec["kinds"]:
        assert a == b, (what, a, b)
    for name, e in rec["errs"].items():
        assert e <= 1e-12, (what, name, e)


@pytest.mark.parametrize("name", UNIT_CASES)
def test_derived_bc_matches_reference(units, name):
    _assert_record(units["cases"][name], name)
    if name == "contact_angle_parse":
        for jo, to in units["cases"][name]["opts"]:
            assert jo == to


def test_turbulent_inlet_bounds_and_mean(units):
    rec = units["cases"]["turbulent_inlet"]
    assert "error" not in rec, rec.get("error")
    for lbl, r in rec["turbulent"].items():
        assert r["kind"] == ["turbulentInlet", "turbulentInlet"], lbl
        assert r["port_in_bounds"] and r["jax_in_bounds"], (lbl, r)
        # 8 draws of U(-0.5, 0.5): the mean within 3.5 standard errors
        assert abs(r["port_mean"]) < 3.5 * (1 / 12) ** 0.5 / 8 ** 0.5, r
        assert r["moves"] and r["others_zero"], (lbl, r)


@pytest.mark.parametrize("name", tfactory.NAMES)
def test_every_mapped_name_builds_as_in_the_reference(units, name):
    rec = units["names"][name]
    _assert_record(rec, name)
    assert rec["opts_equal"], name


def test_the_name_list_is_the_references(units):
    from foamtpu_torch.bc import patchfields as tpf

    assert sorted(units["names"]) == list(tfactory.NAMES)
    # every kind the factory can build has its value coefficients
    assert set(tfactory.KINDS) - set(tpf._VALUE_COEFFS) <= set(
        tpf._COUPLED_KINDS)
    # the kinds the port's factory refuses before this layer, now built
    for name in ("noSlip", "fixedFluxPressure", "constantAlphaContactAngle",
                 "timeVaryingMappedFixedValue", "codedFixedValue",
                 "solidWallMixedTemperatureCoupled"):
        assert name in tfactory.NAMES


@pytest.mark.parametrize("name", ["fixedMeanValue", "fixedMean",
                                  "alphaContactAngle", "uniformFixedValueT",
                                  "codedFixedValue"])
def test_an_unmapped_name_still_raises(name):
    """A name the reference does not map by name (the internal kinds
    uniformFixedValueT and alphaContactAngle among them), and a coded BC
    without a mesh to run its code on, raise naming themselves."""
    class P:
        size = 3
        name = "w"

    with pytest.raises(NotImplementedError, match=name):
        tfactory.from_dict(tparse(f"type {name}; value uniform 0;"), P(), 0,
                           torch.float64)


@pytest.mark.parametrize("name", ["dam_constant", "dam_dynamic",
                                  "cavity_tvm"])
def test_solver_parity_f64(units, name):
    rec = units["solvers"][name]
    assert rec["iters"][0] == rec["iters"][1] and rec["iters"][0], rec
    for k, e in rec["errs"].items():
        assert e <= 1e-9, (name, k, e)
    if name.startswith("dam"):
        assert rec["kinds"].count("alphaContactAngle") == 3, rec["kinds"]
        assert rec["kinds"].count("fixedFluxPressure") == 3, rec["kinds"]
    else:
        assert "timeVaryingMappedFixedValue" in rec["kinds"], rec["kinds"]
        assert "uniformFixedValueT" in rec["kinds"], rec["kinds"]


@pytest.mark.parametrize("entry", [
    "type constantAlphaContactAngle; theta0 45; limit gradient; "
    "value uniform 0;",
    "type dynamicAlphaContactAngle; theta0 70; uTheta 0.05; thetaA 100; "
    "thetaR 40; limit gradient; value uniform 0;",
    "type uniformFixedValue; uniformValue table ((0 0.375) (2000 0.5));",
    "type uniformFixedGradient; uniformGradient table ((0 1) (1 3));",
    "type oscillatingFixedValue; refValue uniform 2; amplitude 0.5; "
    "frequency 4; value uniform 2;"])
def test_written_field_reads_back_as_it_was_read(tmp_path, entry):
    """A field with one of the kinds the factory builds under an internal
    name (the contact angles, the table and oscillating forms), written
    by io/fields.py::write_field and read back by read_field: the same
    kind, options and boundary values, and the second write the same
    text as the first. setFields, mapFields and a solver's writes go
    through this writer."""
    from foamtpu_torch.apps.cases import make_cavity
    from foamtpu_torch.bc import patchfields as tpf
    from foamtpu_torch.core.fields import vol_scalar
    from foamtpu_torch.io.fields import read_field, write_field

    mesh = make_cavity(4, device="cpu")[0]
    i = [p.name for p in mesh.patches].index("movingWall")
    field = vol_scalar(mesh, 0.5, name="f")
    bcs = list(field.bcs)
    bcs[i] = tfactory.from_dict(tparse(entry), mesh.patches[i], 0,
                                mesh.v.dtype, "cpu", mesh=mesh)
    field = field.replace(bcs=tpf.normalize_bcs(mesh, tuple(bcs), 0))
    texts, fields = [], [field]
    for t in ("1", "2"):
        path = write_field(fields[-1], mesh, str(tmp_path), t)
        with open(path) as f:
            texts.append(f.read().replace(f"location    \"{t}\"", ""))
        fields.append(read_field(path, mesh, "f"))
    assert texts[0] == texts[1]
    for got in fields[1:]:
        a, b = field.bcs[i], got.bcs[i]
        assert a.kind == b.kind and dict(a.opts) == dict(b.opts), (a, b)
        for x, y in ((a.ref_value, b.ref_value), (a.ref_grad, b.ref_grad),
                     (a.vfrac, b.vfrac)):
            assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


@pytest.fixture(scope="module")
def left_column_fills(tmp_path_factory):
    return contact_angle_fills(str(tmp_path_factory.mktemp("dam")))


def contact_angle_fills(root):
    """damBreak at 16 x 16 (setFields) through the port's interFoam on
    the CPU for ANGLE_STEPS steps, its three walls zeroGradient ("none")
    or constantAlphaContactAngle at 45, 90 and 135 degrees: the fill of
    the cell column at the left wall (chip_smoke.dambreak_invariants), by
    angle."""
    import contextlib
    import io
    import re
    import shutil

    from chip_smoke import DAMBREAK_CASE, dambreak_invariants
    from foamtpu_torch.apps.cli import main as tcli
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.solvers.apps import run

    out = {}
    for theta in ("none", "45", "90", "135"):
        d = os.path.join(root, theta)
        shutil.copytree(os.path.join(REPO, DAMBREAK_CASE), d)
        bm = os.path.join(d, "constant", "polyMesh", "blockMeshDict")
        with open(bm) as f:
            text = f.read()
        with open(bm, "w") as f:
            f.write(text.replace("(46 46 1)", "(16 16 1)"))
        with contextlib.redirect_stdout(io.StringIO()):
            assert tcli(["blockMesh", "-case", d]) == 0
            assert tcli(["setFields", "-case", d, "-device", "cpu"]) == 0
        if theta != "none":
            path = os.path.join(d, "0", "alpha1")
            with open(path) as f:
                text = f.read()
            text, n = re.subn(
                r"((?:left|right|lower)Wall\s*\{\s*type\s+)zeroGradient;",
                r"\1constantAlphaContactAngle; theta0 %s; limit gradient; "
                r"value uniform 0;" % theta, text)
            assert n == 3
            with open(path, "w") as f:
                f.write(text)
        case = Case(d, device="cpu")
        alpha0 = case.read_field("alpha1").data.clone()
        with contextlib.redirect_stdout(io.StringIO()):
            run(case, max_steps=ANGLE_STEPS)
        inv, _ = dambreak_invariants(case.mesh, alpha0, case.final_state)
        assert inv["water_volume_rel_change"] < 1e-6, (theta, inv)
        out[theta] = inv["left_column_fill"]
    return out


ANGLE_STEPS = 30


@pytest.mark.parametrize("theta", ["45", "90", "135"])
def test_contact_angle_moves_the_left_column_fill(left_column_fills, theta):
    """A wall at 45 degrees wets: the water climbs the left wall, and the
    column's cells fill above the run's without the angle; at 135 the
    wall repels the water by as much; at 90 the fill stays as without
    the angle (to a hundredth of the 45-degree rise). chip_smoke's
    utilities_headline holds the 45-degree run at 736 x 736 to the first
    of these."""
    f = left_column_fills
    rise = f["45"] - f["none"]
    assert rise > 5e-6, f
    if theta == "135":
        assert f["none"] - f["135"] > 0.5 * rise, f
    elif theta == "90":
        assert abs(f["90"] - f["none"]) < 0.01 * rise, f


def test_contact_angle_turns_the_wall_normals_on_the_cpu():
    """The constant angle in the port alone: after the correction the
    wall faces' normals make theta0 with the wall."""
    from foamtpu_torch.apps.cases import make_cavity
    from foamtpu_torch.bc import patchfields as tpf
    from foamtpu_torch.core.fields import vol_scalar
    from foamtpu_torch.models.interface import _correct_contact_angle

    mesh = make_cavity(4, device="cpu")[0]
    i = [p.name for p in mesh.patches].index("movingWall")
    alpha = vol_scalar(mesh, 0.5, name="alpha")
    bcs = list(alpha.bcs)
    bcs[i] = tpf.make("alphaContactAngle", ref_grad=0.0, vfrac=0.0,
                      theta0=float(np.radians(45.0)))
    alpha = alpha.replace(bcs=tuple(bcs))
    nhat = torch.tensor([1.0, 0.0, 0.0], dtype=mesh.v.dtype).expand(
        mesh.n_faces, 3).clone()
    out = _correct_contact_angle(mesh, alpha, nhat)
    sl = mesh.patches[i].slice
    nf = mesh.sf[sl] / mesh.mag_sf[sl][:, None]
    dots = torch.sum(out[sl] * nf, dim=1)
    np.testing.assert_allclose(dots.numpy(), np.cos(np.radians(45.0)),
                               atol=1e-5)
    assert torch.equal(out[:mesh.n_internal_faces],
                       nhat[:mesh.n_internal_faces])


def bcu_reference(here, root, perturb=False):
    """The chains through the JAX package's command line in process (the
    goldens of BCU_GOLDEN: float32, and float64 with FOAMTPU_X64=1
    JAX_ENABLE_X64=1; with `perturb` the written starts perturbed by
    bcu_perturb): {name: bcu_summary}."""
    import contextlib
    import io

    from chip_smoke import (BCU_SEED, BCU_TUTORIALS, bcu_case, bcu_chains,
                            bcu_contact_angle, bcu_perturb, bcu_summary,
                            check)
    from foamtpu.apps.cli import main as jcli

    dirs = {n: os.path.join(root, n) for n in BCU_TUTORIALS}
    for n, d in dirs.items():
        bcu_case(here, d, n, jcli)
        # pitzDaily's SIMPLE iterations from rest diverge within 10 from a
        # 1e-9 noise on U in the JAX package's float32 (ROADMAP Queue 3):
        # its perturbed start perturbs p alone
        if perturb and n != "dam_fine":
            bcu_perturb(d, BCU_SEED, fields=("p",) if n == "pitz" else
                        ("U", "p", "p_rgh"))
    out = {}
    for name, chain in bcu_chains(dirs).items():
        logs = []
        for step in chain:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                check(jcli(list(step)) in (0, None), f"{name}: {step}")
            logs.append(buf.getvalue())
            if step[0] == "mapFields":
                # the JAX package's mapFields writes the walls back as
                # `alphaContactAngle` without the angle, which its reader
                # does not take back as the angle (ROADMAP Queue 3): put
                # back by hand what the port's writer keeps
                bcu_contact_angle(step[step.index("-case") + 1])
        out[name] = bcu_summary(name, dirs, logs)
    return out


# faults planted in pitzDaily's case of bc_utilities: (field file,
# pattern, replacement)
BCU_PLANTS = {
    "clean": None,
    "partialSlip valueFraction 0.4": ("U", r"valueFraction uniform 0.5",
                                      "valueFraction uniform 0.4"),
    "partialSlip valueFraction 1": ("U", r"valueFraction uniform 0.5",
                                    "valueFraction uniform 1"),
    "k table 0.39 at t = 0": ("k", r"\(0 0.375\)", "(0 0.39)"),
}


def bcu_plants(here, root):
    """pitzDaily's chain of chip_smoke's bc_utilities through the port's
    command line on the CPU, as it is and with each fault of BCU_PLANTS
    planted in its case: {plant: {"passes": the held goldens all met,
    "worst": (error over tolerance, key)}}. The goldens must catch the
    plants."""
    import contextlib
    import io

    from chip_smoke import (_edit, bcu_case, bcu_chains, bcu_golden_errs,
                            bcu_summary, check)
    from foamtpu_torch.apps.cli import main as tcli

    out = {}
    for name, plant in BCU_PLANTS.items():
        d = os.path.join(root, name.replace(" ", "_"), "pitz")
        bcu_case(here, d, "pitz", tcli, ("-device", "cpu"))
        if plant:
            _edit(os.path.join(d, "0", plant[0]), plant[1], plant[2])
        dirs = {"pitz": d, "cavity": "", "dam": "", "dam_fine": ""}
        logs = []
        for step in bcu_chains(dirs)["pitz"]:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                check(tcli(list(step) + ["-device", "cpu"]) in (0, None),
                      f"{name}: {step}")
            logs.append(buf.getvalue())
        errs, _ = bcu_golden_errs("pitz", bcu_summary("pitz", dirs, logs))
        out[name] = {"passes": all(e <= t for e, t in errs.values()),
                     "worst": max((e / t if t else float(e > 0), k)
                                  for k, (e, t) in errs.items())}
    return out


if __name__ == "__main__":
    # python tests/test_torch_bc_derived.py goldens [--perturb]: the JSON
    # of bcu_reference (the JAX package's chains of chip_smoke's
    # bc_utilities phase; the environment sets float32, or float64 with
    # FOAMTPU_X64=1 JAX_ENABLE_X64=1); python tests/test_torch_bc_derived.py
    # spread f32.json f64.json perturbed.json: BCU_SPREAD, the largest of
    # |f32 - f64| and |perturbed - f32| per scalar
    import tempfile

    import chip_smoke

    # python tests/test_torch_bc_derived.py plants | fills: the JSON of
    # bcu_plants or of contact_angle_fills
    if sys.argv[1] == "fills":
        with tempfile.TemporaryDirectory() as root:
            print(json.dumps(contact_angle_fills(root)))
    elif sys.argv[1] == "plants":
        with tempfile.TemporaryDirectory() as root:
            print(json.dumps(bcu_plants(REPO, root)))
    elif sys.argv[1] == "goldens":
        with tempfile.TemporaryDirectory() as root:
            print(json.dumps(bcu_reference(
                REPO, root, perturb="--perturb" in sys.argv)))
    elif sys.argv[1] == "spread":
        f32, f64, pert = (json.load(open(p)) for p in sys.argv[2:5])
        print(json.dumps({
            n: {k: max(abs(f32[n][k] - f64[n][k]),
                       abs(pert[n][k] - f32[n][k]))
                for k, v in f32[n].items()
                if isinstance(v, float) and k not in chip_smoke.BCU_EXACT}
            for n in f32}))
