"""Solver applications: case-driven host loops (port of
openfoam-2.2.x_tpu/solvers/apps.py).

Each application reads its config from the case dictionaries, builds the
step, runs the Time loop with reference-format logging, writes
OpenFOAM-format output at write times and leaves the last state in
`case.final_state`. Ported: icoFoam, nonNewtonianIcoFoam, pisoFoam,
pimpleFoam, simpleFoam, interFoam (with LTSInterFoam's `lts=True`), their
rotating-frame and porous variants (MRFSimpleFoam, MRFPimpleFoam,
SRFSimpleFoam, SRFPimpleFoam, porousSimpleFoam, MRFInterFoam,
porousInterFoam), channelFoam (pimpleFoam with an LES model, as the
reference registers it), boundaryFoam, the basic solvers laplacianFoam,
scalarTransportFoam and potentialFoam, buoyantBoussinesqSimpleFoam and
buoyantBoussinesqPimpleFoam, and on solid-body moving meshes
pimpleDyMFoam and interDyMFoam; `run(case)` picks among them by
controlDict's `application`. The turbulence model comes
from constant/RASProperties or constant/LESProperties.

    from foamtpu_torch.core.case import Case
    from foamtpu_torch.solvers.apps import run
    run(Case(case_dir))              # on the card; Case(d, device="cpu")

The controlDict's `functions` block runs after every step of the six
flow solvers, as in the reference (functionobjects/; the list is left in
`case.function_objects`); the basic solvers run none, as the reference's
do not. constant/MRFZones, constant/SRFProperties, system/fvOptions,
constant/fvOptions and constant/porousZones are read by the flow
solvers, so the MRF*, SRF* and porous* applications are aliases of
their base solvers, as in the reference. The sixDoF and attachDetach
variants of pimpleDyMFoam and interDyMFoam's dynamicRefineFvMesh are
outside the ported slice and raise NotImplementedError naming the
reference's function for them, before the first step.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..core.dictionary import FoamDict, dimensioned_scalar, parse_file
from ..models.turbulence import base as turb_mod
from ..utils import logging as log
from . import piso as piso_mod
from . import simple as simple_mod
from .linear.krylov import SolverPerf

_TRUE = ("yes", "true", "on", "1")


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported to foamtpu_torch yet")


def _load_turbulence(case, nu: float, compressible: bool = False):
    """Read RASProperties/LESProperties/turbulenceProperties and build
    the model + its field state from the start-time directory; (None,
    None) for a laminar case. A model that needs the wall distance gets
    it on the case mesh's device."""
    for fname, kind in (("RASProperties", "RAS"), ("LESProperties", "LES"),
                        ("turbulenceProperties", "RAS")):
        path = case.const_path(fname)
        if os.path.exists(path):
            props = parse_file(path)
            break
    else:
        return None, None
    model = turb_mod.select(props, nu, kind=kind, compressible=compressible)
    model.corrected = case.laplacian_corrected()
    model.corr_limit = case.corr_limit()
    try:
        model.div_scheme = case.div_scheme("div(phi,k)")
    except KeyError:
        pass
    if not model.field_names:
        return None, None
    tstate = {name: case.read_field(name) for name in model.field_names}
    if hasattr(model, "init_wall_distance"):
        model.init_wall_distance(case.poly_mesh, case.mesh.v.dtype,
                                 device=case.mesh.device)
    return model, tstate


def _dim_scalar_of(d: FoamDict, key: str, default: float) -> float:
    if key not in d:
        return default
    try:
        return float(dimensioned_scalar(d[key])[1])
    except Exception:
        return float(d[key])


def _load_mrf(case):
    """constant/MRFZones -> models/mrf.MRFZones, or None. With
    constant/SRFProperties (SRFSimpleFoam, SRFPimpleFoam) the single
    rotating frame is one zone over the whole mesh (selectionMode all):
    the same Coriolis and frame-flux terms, rpm converted to rad/s."""
    from ..models import mrf as mrf_mod

    srf_path = case.const_path("SRFProperties")
    if not os.path.exists(srf_path):
        return mrf_mod.from_case(case)
    srf = parse_file(srf_path)
    rpm = srf.get("rpmCoeffs", srf).get("rpm", None)
    if rpm is not None:
        omega = float(rpm if not isinstance(rpm, (list, tuple))
                      else rpm[-1]) * 2.0 * np.pi / 60.0
    else:
        omega = _dim_scalar_of(srf, "omega", 0.0)
    spec = FoamDict([
        ("selectionMode", "all"),
        ("origin", tuple(np.asarray(srf.get("origin", (0.0, 0.0, 0.0)),
                                    dtype=float))),
        ("axis", tuple(np.asarray(srf.get("axis", (0.0, 0.0, 1.0)),
                                  dtype=float))),
        ("omega", omega)])
    nrp = srf.get("nonRotatingPatches")
    if nrp is not None:
        spec["nonRotatingPatches"] = nrp
    return mrf_mod.from_dict(case.mesh, FoamDict([("SRF", spec)]))


def _load_fvoptions(case, nu: float):
    """system/fvOptions (or constant/fvOptions) and constant/porousZones
    -> models/fvoptions.OptionList, or None when the case has none."""
    from ..models import fvoptions as fvopt_mod

    return fvopt_mod.from_case(case, nu)


def _frames(case, cfg, state):
    """The initial state in the rotating frames and with the fvOptions'
    state: the absolute flux made relative to the MRF zones, and the
    fvOptions' entries (meanVelocityForce's gradient) under "fvopt"."""
    if cfg.mrf:
        from ..models import mrf as mrf_mod

        state = mrf_mod.make_relative_state(case.mesh, cfg.mrf, state)
    if cfg.fv_options:
        state["fvopt"] = cfg.fv_options.init_state(case.mesh)
    return state


def _function_objects(case):
    """The controlDict's function objects, built before the first step
    and kept on the case (`case.function_objects`)."""
    from ..functionobjects import make_function_objects

    case.function_objects = make_function_objects(case)
    return case.function_objects


def _read_u(case, mrf):
    """U from the start time, the rotating walls of the MRF zones set to
    omega x r (MRFZones::correctBoundaryVelocity)."""
    U = case.read_field("U")
    return mrf.correct_boundary_velocity(case.mesh, U) if mrf else U


def _piso_config(case, nu: float, model=None,
                 nu_fn=None) -> piso_mod.PisoConfig:
    """The PisoConfig of an icoFoam/nonNewtonianIcoFoam/pisoFoam case:
    the PISO dict, the schemes, the p/U solver controls, the viscosity
    model's nu(mesh, U) and, with a turbulence model, the k controls for
    its transport solves."""
    pdict = case.pimple_controls("PISO")
    turb_ctl = None
    try:
        turb_ctl = case.solver_controls("k")
    except KeyError:
        pass
    return piso_mod.PisoConfig(
        nu=nu,
        n_correctors=int(pdict.get("nCorrectors", 2)),
        n_non_orth=int(pdict.get("nNonOrthogonalCorrectors", 0)),
        momentum_predictor=str(
            pdict.get("momentumPredictor", "yes")) in _TRUE,
        corrected=case.laplacian_corrected(),
        div_scheme=case.div_scheme("div(phi,U)"),
        ddt_scheme=case.ddt_scheme(),
        grad_scheme=case.grad_scheme("grad(p)"),
        p_ref_cell=int(pdict.get("pRefCell", 0)),
        p_ref_value=float(pdict.get("pRefValue", 0.0)),
        p_controls=case.solver_controls("p"),
        u_controls=case.solver_controls("U"),
        turb=model,
        turb_controls=turb_ctl,
        nu_fn=nu_fn,
        fv_options=_load_fvoptions(case, nu),
        mrf=_load_mrf(case),
    )


def _relaxation(case) -> Dict[str, float]:
    out: Dict[str, float] = {}
    rf = case.fv_solution.get("relaxationFactors")
    if isinstance(rf, FoamDict):
        for sub in ("fields", "equations"):
            if sub in rf and isinstance(rf[sub], FoamDict):
                for k, v in rf[sub].items():
                    out[str(k)] = float(v)
        for k, v in rf.items():
            if not isinstance(v, FoamDict):
                out[str(k)] = float(v)
    return out


def _residual_control(case, name="SIMPLE") -> Dict[str, float]:
    d = case.pimple_controls(name).get("residualControl")
    if isinstance(d, FoamDict):
        return {str(k): float(v) for k, v in d.items()
                if isinstance(v, (int, float))}
    return {}


def _log_step(case, t, diag, cumulative, extra_fields=()):
    log.info(f"Time = {t.name}\n")
    if "courant_mean" in diag:
        log.info(log.courant_line(float(diag["courant_mean"]),
                                  float(diag["courant_max"])))
    if diag.get("Ux") is not None:
        log.info(log.solver_line("U", diag["Ux"]))
    if "p_initial" in diag:
        log.info(log.solver_line("p", SolverPerf(
            diag["p_initial"], diag["p_final"], diag["p_iters"])))
    for name in extra_fields:
        perf = diag.get(f"turb_{name}")
        if perf is not None:
            log.info(log.solver_line(name, perf))
    if "continuity" in diag:
        dtv = getattr(t, "current_dt", 1.0)
        local = float(diag["continuity"]) * dtv
        glob = float(diag.get("continuity_global", 0.0)) * dtv
        cumulative += glob
        log.info(log.continuity_line(local, glob, cumulative))
    log.info(f"ExecutionTime = {t.execution_time():.2f} s"
             f"  ClockTime = {t.clock_time():.0f} s\n")
    # runTimeModifiable: pick up controlDict edits between steps
    if t.read_if_modified():
        log.info("regIOobject::readIfModified() : "
                 "Re-reading object controlDict\n")
    return cumulative


def _write_state(case, state):
    fields = [state["U"], state["p"]]
    if "turb" in state and state["turb"]:
        fields += list(state["turb"].values())
    case.write_fields(fields)


def _time_loop(case, step, state, max_steps, extra, fol):
    """The transient applications' loop: step, log, run the function
    objects, adjust deltaT, write at write times and once more at the
    end."""
    cumulative = 0.0
    for t in case.time.loop():
        state, diag = step(state, t.current_dt)
        cumulative = _log_step(case, t, diag, cumulative, extra)
        fol.execute(t.name, state)
        t.adjust_delta_t(float(diag["courant_max"]))
        if t.write_time():
            _write_state(case, state)
            log.info(f"Writing fields at time {t.name}\n")
        if max_steps is not None and t.index >= max_steps:
            break
    _write_state(case, state)
    log.info("End\n")
    case.final_state = state


# ---------------------------------------------------------------------------
# transient PISO family
# ---------------------------------------------------------------------------


def _run_piso(case, max_steps, with_turbulence: bool, nu_fn=None) -> None:
    fol = _function_objects(case)
    mesh = case.mesh
    _, nu = dimensioned_scalar(case.transport_properties()["nu"])
    model = tstate = None
    if with_turbulence:
        model, tstate = _load_turbulence(case, nu)
    cfg = _piso_config(case, nu, model, nu_fn=nu_fn)
    U = _read_u(case, cfg.mrf)
    p = case.read_field("p")
    step = piso_mod.make_step(mesh, cfg)
    state = _frames(case, cfg, piso_mod.initial_state(
        mesh, U, p, turb_state=tstate, ddt_scheme=cfg.ddt_scheme))
    extra = model.field_names[:-1] if model else ()
    log.info(f"Starting time loop: {case.application}, {mesh.n_cells} cells\n")
    _time_loop(case, step, state, max_steps, extra, fol)


def icofoam(case, max_steps: Optional[int] = None) -> None:
    """icoFoam (incompressible/icoFoam/icoFoam.C)."""
    _run_piso(case, max_steps, with_turbulence=False)


def non_newtonian_icofoam(case, max_steps: Optional[int] = None) -> None:
    """nonNewtonianIcoFoam (incompressible/nonNewtonianIcoFoam): icoFoam
    with the strain-rate dependent viscosity model that
    transportProperties selects."""
    from ..models import transport as transport_mod

    _run_piso(case, max_steps, with_turbulence=False,
              nu_fn=transport_mod.select(case.transport_properties()))


def pisofoam(case, max_steps: Optional[int] = None) -> None:
    """pisoFoam: PISO + turbulence model (incompressible/pisoFoam)."""
    _run_piso(case, max_steps, with_turbulence=True)


def _pimple_config(case, nu: float, model=None):
    """The PimpleConfig of a pimpleFoam case: the PIMPLE dict, the
    relaxation factors, the schemes and the p/pFinal/U/k controls."""
    from . import pimple as pimple_mod

    pdict = case.pimple_controls("PIMPLE")
    relax = _relaxation(case)
    turb_ctl = None
    try:
        turb_ctl = case.solver_controls("k")
    except KeyError:
        pass
    try:
        p_final = case.solver_controls("pFinal")
    except KeyError:
        p_final = None
    return pimple_mod.PimpleConfig(
        nu=nu,
        n_outer=int(pdict.get("nOuterCorrectors", 1)),
        n_correctors=int(pdict.get("nCorrectors", 2)),
        n_non_orth=int(pdict.get("nNonOrthogonalCorrectors", 0)),
        momentum_predictor=str(
            pdict.get("momentumPredictor", "yes")) in _TRUE,
        corrected=case.laplacian_corrected(),
        div_scheme=case.div_scheme("div(phi,U)"),
        ddt_scheme=case.ddt_scheme(),
        grad_scheme=case.grad_scheme("grad(p)"),
        p_ref_cell=int(pdict.get("pRefCell", 0)),
        p_ref_value=float(pdict.get("pRefValue", 0.0)),
        alpha_u=relax.get("U", 1.0),
        alpha_p=relax.get("p", 1.0),
        p_controls=case.solver_controls("p"),
        p_controls_final=p_final,
        u_controls=case.solver_controls("U"),
        turb=model,
        turb_controls=turb_ctl,
        turb_on_final_only=str(
            pdict.get("turbOnFinalIterOnly", "yes")) in _TRUE,
        fv_options=_load_fvoptions(case, nu),
        mrf=_load_mrf(case),
    )


def pimplefoam(case, max_steps: Optional[int] = None) -> None:
    """pimpleFoam: merged PISO-SIMPLE with nOuterCorrectors outer
    iterations, inter-iteration relaxation and final-iteration semantics
    (incompressible/pimpleFoam + pimpleControl). nOuterCorrectors=1
    reduces to PISO."""
    from . import pimple as pimple_mod

    fol = _function_objects(case)
    mesh = case.mesh
    _, nu = dimensioned_scalar(case.transport_properties()["nu"])
    model, tstate = _load_turbulence(case, nu)
    cfg = _pimple_config(case, nu, model)
    U = _read_u(case, cfg.mrf)
    p = case.read_field("p")
    step = pimple_mod.make_step(mesh, cfg)
    state = _frames(case, cfg, piso_mod.initial_state(
        mesh, U, p, turb_state=tstate, ddt_scheme=cfg.ddt_scheme))
    extra = model.field_names[:-1] if model else ()
    log.info(f"Starting time loop: pimpleFoam, {mesh.n_cells} cells\n")
    _time_loop(case, step, state, max_steps, extra, fol)


# ---------------------------------------------------------------------------
# steady SIMPLE
# ---------------------------------------------------------------------------


def _simple_config(case, nu: float, model=None) -> simple_mod.SimpleConfig:
    """The SimpleConfig of a simpleFoam case: the SIMPLE dict, the
    relaxation factors, the schemes and the p/U/k controls."""
    sdict = case.pimple_controls("SIMPLE")
    relax = _relaxation(case)
    turb_ctl = None
    try:
        turb_ctl = case.solver_controls("k")
    except KeyError:
        pass
    return simple_mod.SimpleConfig(
        nu=nu,
        n_non_orth=int(sdict.get("nNonOrthogonalCorrectors", 0)),
        corrected=case.laplacian_corrected(),
        div_scheme=case.div_scheme("div(phi,U)"),
        grad_scheme=case.grad_scheme("grad(p)"),
        p_ref_cell=int(sdict.get("pRefCell", 0)),
        p_ref_value=float(sdict.get("pRefValue", 0.0)),
        alpha_u=relax.get("U", 0.7),
        alpha_p=relax.get("p", 0.3),
        p_controls=case.solver_controls("p"),
        u_controls=case.solver_controls("U"),
        turb=model,
        turb_controls=turb_ctl,
        turb_relax=relax.get("k", relax.get("epsilon", 0.7)),
        fv_options=_load_fvoptions(case, nu),
        mrf=_load_mrf(case),
    )


def simplefoam(case, max_steps: Optional[int] = None) -> None:
    """simpleFoam (incompressible/simpleFoam): chunks of FOAMTPU_CHUNK
    iterations (default 10) between log lines, stopped by
    residualControl."""
    fol = _function_objects(case)
    mesh = case.mesh
    _, nu = dimensioned_scalar(case.transport_properties()["nu"])
    model, tstate = _load_turbulence(case, nu)
    cfg = _simple_config(case, nu, model)
    U = _read_u(case, cfg.mrf)
    p = case.read_field("p")
    chunk_n = int(os.environ.get("FOAMTPU_CHUNK", "10"))
    chunk = simple_mod.make_chunk(mesh, cfg, chunk_n)
    state = _frames(case, cfg, piso_mod.initial_state(
        mesh, U, p, turb_state=tstate))
    res_ctl = _residual_control(case, "SIMPLE")

    extra = model.field_names[:-1] if model else ()
    log.info(f"Starting SIMPLE loop: simpleFoam, {mesh.n_cells} cells\n")
    cumulative = 0.0
    t = case.time
    max_iter = max(int(round((t.end_time - t.start_time) / t.delta_t)), 1)
    if max_steps is not None:
        max_iter = min(max_iter, max_steps)
    while (t.index < max_iter and not t.stop_now
           and t.value < t.end_time - 1e-12):
        state, diag = chunk(state)
        t.index += chunk_n
        t.value = t.start_time + t.index * t.delta_t
        t.current_dt = t.delta_t
        cumulative = _log_step(case, t, diag, cumulative, extra)
        fol.execute(t.name, state)
        if t.write_time():
            _write_state(case, state)
        if simple_mod.converged(diag, res_ctl):
            log.info(f"SIMPLE solution converged in {t.index} iterations\n")
            break
    _write_state(case, state)
    log.info("End\n")
    case.final_state = state


# ---------------------------------------------------------------------------
# interFoam
# ---------------------------------------------------------------------------


def _inter_config(case, lts: bool = False):
    """The InterConfig of an interFoam case: the two phases (2.2 layout:
    phase1 { nu; rho; } phase2 { ... } sigma), constant/g, the PIMPLE
    dict and the p_rgh/U controls. As in the reference, the PIMPLE
    dict's momentumPredictor is not read (the step always solves the
    momentum predictor), and the U controls are taken when any solvers
    key mentions U (damBreak's "(U|alpha1)")."""
    from . import interfoam as inter_mod

    tp = case.transport_properties()

    def phase(name):
        ph = tp.get(name, tp)
        _, nu_v = dimensioned_scalar(ph["nu"])
        _, rho_v = dimensioned_scalar(ph["rho"])
        return nu_v, rho_v

    nu1, rho1 = phase("phase1")
    nu2, rho2 = phase("phase2")
    _, sigma = dimensioned_scalar(tp.get("sigma", 0.0))
    g_vec = (0.0, -9.81, 0.0)
    g_path = case.const_path("g")
    if os.path.exists(g_path):
        val = parse_file(g_path).get("value")
        if val is not None:
            g_vec = tuple(float(x) for x in np.asarray(val).reshape(3))
    pdict = case.pimple_controls("PIMPLE")
    return inter_mod.InterConfig(
        lts=lts,
        lts_max_co=float(case.control_dict.get("maxCo", 0.5)),
        lts_max_dt=float(case.control_dict.get("maxDeltaT", 1e6)),
        rho1=rho1, rho2=rho2, nu1=nu1, nu2=nu2, sigma=sigma, g=g_vec,
        c_alpha=float(pdict.get("cAlpha", 1.0)),
        n_alpha_subcycles=int(pdict.get("nAlphaSubCycles", 1)),
        n_correctors=int(pdict.get("nCorrectors", 3)),
        n_non_orth=int(pdict.get("nNonOrthogonalCorrectors", 0)),
        p_controls=case.solver_controls("p_rgh"),
        u_controls=case.solver_controls("U") if "U" in str(
            case.fv_solution.get("solvers", {})) else None,
        fv_options=_load_fvoptions(case, min(nu1, nu2)),
        mrf=_load_mrf(case),
    )


def interfoam_app(case, max_steps: Optional[int] = None,
                  lts: bool = False, dym: bool = False) -> None:
    """interFoam from case files (multiphase/interFoam); lts=True is
    LTSInterFoam, dym=True interDyMFoam on a solidBodyMotionFvMesh
    (constant/dynamicMeshDict; dynamicRefineFvMesh is not ported)."""
    from . import interfoam as inter_mod

    if dym:
        dmd = case.properties("dynamicMeshDict")
        if str(dmd.get("dynamicFvMesh", "")) == "dynamicRefineFvMesh":
            _not_ported("interDyMFoam with dynamicRefineFvMesh (the "
                        "reference's _inter_amr_run: mesh/topo.py, "
                        "mesh/refine.py)")
    fol = _function_objects(case)
    mesh = case.mesh
    cfg = _inter_config(case, lts=lts)
    U = case.read_field("U")
    alpha = None
    for nm in ("alpha1", "alpha.water", "alpha"):
        if os.path.exists(os.path.join(case.dir, "0", nm)):
            alpha = case.read_field(nm)
            break
    p_rgh = case.read_field("p_rgh")
    if dym:
        # interDyMFoam: solid-body mesh motion, relative fluxes
        pts_fn, umesh_fn = _dym_motion(case)
        step = inter_mod.make_dym_step(mesh, cfg, pts_fn, umesh_fn)
        state = inter_mod.interdym_initial_state(
            case.poly_mesh, mesh, U, p_rgh, alpha, cfg, umesh_fn)
    else:
        step = inter_mod.make_step(mesh, cfg)
        state = inter_mod.initial_state(mesh, U, p_rgh, alpha, cfg)

    def fields(state):
        return [state["U"], state["p_rgh"], state["alpha"]]

    log.info(f"Starting time loop: interFoam, {mesh.n_cells} cells\n")
    for t in case.time.loop():
        state, diag = step(state, t.current_dt)
        log.info(f"Time = {t.name}")
        log.info(f"Phase-1 volume fraction: min = "
                 f"{float(diag['alpha_min']):.6g} max = "
                 f"{float(diag['alpha_max']):.6g}")
        log.info(log.solver_line("p_rgh", SolverPerf(
            diag["p_initial"], diag["p_final"], diag["p_iters"])) + "\n")
        fol.execute(t.name, state)
        t.adjust_delta_t(float(diag["courant_max"]))
        if t.write_time():
            case.write_fields(fields(state))
        if max_steps is not None and t.index >= max_steps:
            break
    case.write_fields(fields(state))
    case.final_state = state
    log.info("End\n")


# ---------------------------------------------------------------------------
# moving meshes
# ---------------------------------------------------------------------------


def _dym_motion(case):
    """(pts_fn, umesh_fn) from constant/dynamicMeshDict solid-body
    motion coefficients (shared by pimpleDyMFoam / interDyMFoam)."""
    from ..mesh import moving

    dmd = case.properties("dynamicMeshDict")
    coeffs = dmd.get("solidBodyMotionFvMeshCoeffs", dmd)
    fn = str(coeffs.get("solidBodyMotionFunction", "linearMotion"))
    c = coeffs.get(fn + "Coeffs", FoamDict())

    def vec(key, default=(0.0, 0.0, 0.0)):
        return tuple(float(q) for q in c.get(key, default))

    def scal(key, default=1.0):
        v = c.get(key, default)
        if isinstance(v, (list, tuple)):
            v = v[-1]
        return float(v)

    if fn == "oscillatingLinearMotion":
        return moving.oscillating_linear_motion(vec("amplitude"),
                                                scal("omega"))
    if fn == "rotatingMotion":
        return moving.rotating_motion(vec("origin"),
                                      vec("axis", (0.0, 0.0, 1.0)),
                                      scal("omega"))
    if fn == "linearMotion":
        return moving.linear_motion(vec("velocity"))
    raise ValueError(f"unsupported solidBodyMotionFunction {fn!r}")


def pimple_dym_foam(case, max_steps: Optional[int] = None) -> None:
    """pimpleDyMFoam (incompressible/pimpleFoam/pimpleDyMFoam) on a
    solidBodyMotionFvMesh: linear, oscillatingLinear or rotating motion
    from constant/dynamicMeshDict. Laminar, as the reference (no
    turbulence on the moving-mesh path), and with no function objects,
    as the reference's. The sixDoFRigidBodyMotion solver and the
    attachDetach topology changer are not ported."""
    from . import pimpledym as dym_mod

    mesh = case.mesh
    dmd = case.properties("dynamicMeshDict")
    solver_nm = str(dmd.get("motionSolverLibs", ""))
    msd = dmd.get("motionSolver", dmd.get("solver", ""))
    if (str(msd) == "sixDoFRigidBodyMotion"
            or "sixDoFRigidBodyMotion" in solver_nm):
        _not_ported("pimpleDyMFoam with sixDoFRigidBodyMotion (the "
                    "reference's _pimple_dym_sixdof, models/sixdof.py)")
    if (str(dmd.get("topoChanger", "")) == "attachDetach"
            or "attachDetachCoeffs" in dmd):
        _not_ported("pimpleDyMFoam with attachDetach (the reference's "
                    "_pimple_attach_detach, mesh/topo.py)")
    coeffs = dmd.get("solidBodyMotionFvMeshCoeffs", dmd)
    fn = str(coeffs.get("solidBodyMotionFunction", "linearMotion"))
    pts_fn, umesh_fn = _dym_motion(case)

    _, nu = dimensioned_scalar(case.transport_properties()["nu"])
    cdict = case.pimple_controls("PIMPLE")
    cfg = dym_mod.DyMConfig(
        nu=nu, pts_fn=pts_fn, umesh_fn=umesh_fn,
        n_correctors=int(cdict.get("nCorrectors", 2)),
        n_non_orth=int(cdict.get("nNonOrthogonalCorrectors", 0)),
        corrected=case.laplacian_corrected(),
        div_scheme=case.div_scheme("div(phi,U)"),
        p_ref_cell=int(cdict.get("pRefCell", 0)),
        p_ref_value=float(cdict.get("pRefValue", 0.0)),
        p_controls=case.solver_controls("p"),
        u_controls=case.solver_controls("U"))
    U = case.read_field("U")
    p = case.read_field("p")
    state = dym_mod.initial_state(case.poly_mesh, mesh, U, p, umesh_fn)
    step = dym_mod.make_step(mesh, cfg)
    log.info(f"Starting loop: pimpleDyMFoam ({fn}), "
             f"{mesh.n_cells} cells\n")
    cumulative = 0.0
    t = case.time
    max_iter = max(int(round((t.end_time - t.start_time) / t.delta_t)), 1)
    if max_steps is not None:
        max_iter = min(max_iter, max_steps)
    dt = torch.tensor(t.delta_t, dtype=mesh.v.dtype, device=mesh.device)

    def write(state):
        case.write_fields([state["U"], state["p"]])

    while (t.index < max_iter and not t.stop_now
           and t.value < t.end_time - 1e-12):
        state, diag = step(state, dt)
        t.index += 1
        t.value = t.start_time + t.index * t.delta_t
        t.current_dt = float(dt)
        cumulative = _log_step(case, t, diag, cumulative)
        if t.write_time():
            write(state)
    write(state)
    log.info("End\n")
    case.final_state = state


# ---------------------------------------------------------------------------
# heat transfer: buoyantBoussinesq{Simple,Pimple}Foam
# ---------------------------------------------------------------------------


def _read_gravity(case):
    """constant/g (uniformDimensionedVectorField g)."""
    path = case.const_path("g")
    if os.path.exists(path):
        v = np.asarray(parse_file(path).get("value")).reshape(-1)
        return (float(v[0]), float(v[1]), float(v[2]))
    return (0.0, -9.81, 0.0)


def _boussinesq_config(case, steady: bool, nu: float, model=None):
    """The BoussinesqConfig of a buoyantBoussinesq*Foam case: the
    transport properties (beta, TRef, Pr, Prt), constant/g, the SIMPLE or
    PIMPLE dict, the relaxation factors, the schemes and the p_rgh
    (p_rghFinal), U, T and k controls."""
    from . import buoyant as buoy_mod

    tp = case.transport_properties()
    relax = _relaxation(case)
    cdict = case.pimple_controls("SIMPLE" if steady else "PIMPLE")
    turb_ctl = None
    try:
        turb_ctl = case.solver_controls("k")
    except KeyError:
        pass
    try:
        pf_ctl = case.solver_controls("p_rghFinal")
    except KeyError:
        pf_ctl = None
    return buoy_mod.BoussinesqConfig(
        nu=nu,
        beta=_dim_scalar_of(tp, "beta", 3e-3),
        t_ref=_dim_scalar_of(tp, "TRef", 300.0),
        pr=_dim_scalar_of(tp, "Pr", 0.7),
        prt=_dim_scalar_of(tp, "Prt", 0.85),
        g=_read_gravity(case),
        steady=steady,
        n_outer=int(cdict.get("nOuterCorrectors", 1)),
        n_correctors=int(cdict.get("nCorrectors", 2)),
        n_non_orth=int(cdict.get("nNonOrthogonalCorrectors", 0)),
        corrected=case.laplacian_corrected(),
        div_scheme=case.div_scheme("div(phi,U)"),
        div_scheme_t=case.div_scheme("div(phi,T)"),
        ddt_scheme=case.ddt_scheme(),
        grad_scheme=case.grad_scheme("grad(p_rgh)"),
        p_ref_cell=int(cdict.get("pRefCell", 0)),
        p_ref_value=float(cdict.get("pRefValue", 0.0)),
        alpha_u=relax.get("U", 0.3 if steady else 1.0),
        alpha_p=relax.get("p_rgh", 0.7 if steady else 1.0),
        alpha_t=relax.get("T", 0.5 if steady else 1.0),
        p_controls=case.solver_controls("p_rgh"),
        p_controls_final=pf_ctl,
        u_controls=case.solver_controls("U"),
        t_controls=case.solver_controls("T"),
        turb=model,
        turb_controls=turb_ctl,
        turb_relax=relax.get("k", 0.7),
    )


def _boussinesq_run(case, steady: bool, max_steps: Optional[int]) -> None:
    """The shared loop of buoyantBoussinesq{Simple,Pimple}Foam
    (heatTransfer/): chunks of FOAMTPU_CHUNK iterations or steps (default
    10) between log lines, the function objects after each chunk, SIMPLE
    stopped by residualControl."""
    from . import buoyant as buoy_mod

    fol = _function_objects(case)
    mesh = case.mesh
    _, nu = dimensioned_scalar(case.transport_properties()["nu"])
    model, tstate = _load_turbulence(case, nu)
    cname = "SIMPLE" if steady else "PIMPLE"
    cfg = _boussinesq_config(case, steady, nu, model)
    U = case.read_field("U")
    p_rgh = case.read_field("p_rgh")
    T = case.read_field("T")
    state = buoy_mod.initial_state(mesh, U, p_rgh, T, turb_state=tstate,
                                   steady=steady)
    chunk_n = int(os.environ.get("FOAMTPU_CHUNK", "10"))
    chunk = buoy_mod.make_chunk(mesh, cfg, chunk_n)
    res_ctl = _residual_control(case, cname)
    extra = model.field_names[:-1] if model else ()
    name = ("buoyantBoussinesqSimpleFoam" if steady
            else "buoyantBoussinesqPimpleFoam")
    log.info(f"Starting loop: {name}, {mesh.n_cells} cells\n")
    cumulative = 0.0
    t = case.time
    max_iter = max(int(round((t.end_time - t.start_time) / t.delta_t)), 1)
    if max_steps is not None:
        max_iter = min(max_iter, max_steps)
    dt = torch.tensor(1.0 if steady else t.delta_t, dtype=mesh.v.dtype,
                      device=mesh.device)

    def write(state):
        fields = [state["U"], state["p_rgh"], state["T"]]
        if "turb" in state and state["turb"]:
            fields += list(state["turb"].values())
        case.write_fields(fields)

    while (t.index < max_iter and not t.stop_now
           and t.value < t.end_time - 1e-12):
        state, diag = chunk(state, dt)
        t.index += chunk_n
        t.value = t.start_time + t.index * t.delta_t
        t.current_dt = float(dt)
        cumulative = _log_step(case, t, diag, cumulative, extra)
        log.info(log.solver_line("T", diag["T"]))
        fol.execute(t.name, state)
        if t.write_time():
            write(state)
        if steady and simple_mod.converged(diag, res_ctl):
            log.info(f"SIMPLE solution converged in {t.index} iterations\n")
            break
    write(state)
    log.info("End\n")
    case.final_state = state


def buoyant_boussinesq_simplefoam(case, max_steps: Optional[int] = None):
    """buoyantBoussinesqSimpleFoam (heatTransfer/): steady SIMPLE."""
    _boussinesq_run(case, steady=True, max_steps=max_steps)


def buoyant_boussinesq_pimplefoam(case, max_steps: Optional[int] = None):
    """buoyantBoussinesqPimpleFoam (heatTransfer/): transient PIMPLE."""
    _boussinesq_run(case, steady=False, max_steps=max_steps)


# ---------------------------------------------------------------------------
# basic solvers
# ---------------------------------------------------------------------------


def _basic_loop(case, step, T, max_steps) -> None:
    """The loop of laplacianFoam and scalarTransportFoam: one T solve a
    step, its log line, T written at write times and at the end."""
    for t in case.time.loop():
        T, perf = step(T, t.current_dt)
        log.info(f"Time = {t.name}")
        log.info(log.solver_line("T", perf))
        if t.write_time():
            case.write_fields([T])
        if max_steps is not None and t.index >= max_steps:
            break
    case.write_fields([T])
    case.final_state = {"T": T}
    log.info("End\n")


def basic_step(case, convection: bool):
    """(T, dt) -> (T, perf): the step of scalarTransportFoam
    (basic/scalarTransportFoam; ddt(T) + div(phi,T) - laplacian(DT,T),
    phi the flux of the case's fixed U) or, without `convection`, of
    laplacianFoam (basic/laplacianFoam; ddt(T) - laplacian(DT,T))."""
    from ..core.dimensions import dimViscosity
    from ..ops import fvc, fvm, schemes
    from . import linear

    mesh = case.mesh
    _, DT = dimensioned_scalar(case.transport_properties()["DT"])
    DT = piso_mod._as_scalar(mesh, DT)
    ctl = case.solver_controls("T")
    corrected = case.laplacian_corrected()
    if convection:
        phi = fvc.flux(mesh, case.read_field("U"))
        scheme = case.div_scheme("div(phi,T)")

    def step(T, dt):
        rdt = 1.0 / piso_mod._as_scalar(mesh, dt)
        eqn = fvm.ddt(mesh, T, T.data, rdt)
        if convection:
            w = schemes.weights(mesh, phi, scheme, T)
            eqn = eqn + fvm.div(mesh, phi, T, weights=w)
        eqn = eqn - fvm.laplacian(mesh, DT, T, corrected=corrected,
                                  gamma_dims=dimViscosity)
        data, perf = linear.solve(mesh, eqn, T.data, ctl)
        return T.with_data(data), perf

    return step


def scalar_transport_foam(case, max_steps: Optional[int] = None) -> None:
    """scalarTransportFoam: passive scalar advection-diffusion."""
    _basic_loop(case, basic_step(case, convection=True),
                case.read_field("T"), max_steps)


def laplacian_foam(case, max_steps: Optional[int] = None) -> None:
    """laplacianFoam: transient diffusion of T."""
    _basic_loop(case, basic_step(case, convection=False),
                case.read_field("T"), max_steps)


def boundary_foam(case, max_steps: Optional[int] = None) -> None:
    """boundaryFoam (incompressible/boundaryFoam): steady 1D
    fully-developed channel or boundary-layer flow. Momentum diffusion
    only (no convection), relaxed as UEqn.relax() does; after each solve
    the axial pressure gradient is adjusted to hold transportProperties'
    Ubar, and the turbulence model is corrected on the 1D profile (steady,
    zero flux, its own equations unrelaxed, as in the reference). Logs
    the Ux solve and the pressure gradient each iteration; writes U and
    the turbulence fields at write times and at the end."""
    from ..core.dimensions import dimViscosity
    from ..ops import fvm
    from . import linear

    mesh = case.mesh
    tp = case.transport_properties()
    _, nu = dimensioned_scalar(tp["nu"])
    ubar_e = tp.get("Ubar")
    ub = np.asarray([float(x) for x in ubar_e[-1]]) \
        if isinstance(ubar_e, list) and isinstance(ubar_e[-1], list) \
        else np.asarray([1.0, 0.0, 0.0])
    mag_ub = float(np.linalg.norm(ub))
    fdir = ub / max(mag_ub, 1e-30)
    model, tstate = _load_turbulence(case, nu)
    U = case.read_field("U")
    u_ctl = case.solver_controls("U")
    alpha_u = _relaxation(case).get("U", 0.5)
    flow_dir = torch.tensor(fdir, dtype=mesh.v.dtype, device=mesh.device)
    phi0 = mesh.v.new_zeros((mesh.n_faces,))
    vtot = torch.sum(mesh.v)
    dt1 = torch.ones((), dtype=mesh.v.dtype, device=mesh.device)

    def one(U, tstate, gradP):
        if model is not None:
            visc_mat, visc_expl = model.div_dev_reff(mesh, tstate, U)
            UEqn = visc_mat.add_source(-visc_expl, mesh)
        else:
            UEqn = -fvm.laplacian(mesh, piso_mod._as_scalar(mesh, nu), U,
                                  gamma_dims=dimViscosity)
        # UEqn.relax(): without it the gradP fixed point oscillates
        UEqn = UEqn.relax(mesh, alpha_u, U.data)
        Umat = UEqn.add_source(
            torch.broadcast_to(gradP * flow_dir, U.data.shape), mesh)
        data, perf = linear.solve(mesh, Umat, U.data, u_ctl)
        U = U.with_data(data)
        # adjust gradP to hold Ubar (boundaryFoam.C)
        rAU = 1.0 / UEqn.A(mesh)
        magUbarStar = torch.sum(mesh.v * (U.data @ flow_dir)) / vtot
        rAUw = torch.sum(mesh.v * rAU) / vtot
        dG = (mag_ub - magUbarStar) / rAUw
        U = U.with_data(U.data + (rAU * dG)[:, None] * flow_dir[None, :])
        gradP = gradP + dG
        if model is not None:
            tstate, _ = model.correct(mesh, tstate, U, phi0, dt1,
                                      steady=True)
        return U, tstate, gradP, perf

    def fields(U, tstate):
        return [U] + (list(tstate.values()) if tstate else [])

    gradP = mesh.v.new_zeros(())
    log.info(f"Starting loop: boundaryFoam, {mesh.n_cells} cells\n")
    for t in case.time.loop():
        U, tstate, gradP, perf = one(U, tstate, gradP)
        log.info(f"Time = {t.name}")
        log.info(log.solver_line("Ux", perf))
        log.info(f"Uncorrected Ubar = ..., pressure gradient = "
                 f"{float(gradP):.6g}\n")
        if t.write_time():
            case.write_fields(fields(U, tstate))
        if max_steps is not None and t.index >= max_steps:
            break
    case.write_fields(fields(U, tstate))
    case.final_state = {"U": U, "turb": tstate, "gradP": gradP}
    log.info("End\n")


def potential_foam(case, max_steps: Optional[int] = None) -> None:
    """potentialFoam: potential-flow initialisation (basic/potentialFoam):
    solve laplacian(Phi) = div(phi0) for the velocity potential Phi with
    p's boundary types, correct the flux by the equation's flux, and
    reconstruct U from it. As in the reference (its "r2 fix"), the right
    side stays div(phi0) in every non-orthogonal pass, and phi is
    corrected once, after the last."""
    from ..core.dimensions import dimless
    from ..core.fields import vol_scalar
    from ..ops import fvc, fvm, surface
    from . import linear

    mesh = case.mesh
    U = case.read_field("U")
    p = case.read_field("p")
    Phi = vol_scalar(mesh, 0.0, name="Phi", bcs=p.bcs)
    ctl = case.solver_controls("p")
    nno = int(case.pimple_controls("potentialFlow").get(
        "nNonOrthogonalCorrectors", 3))

    nif = mesh.n_internal_faces
    phi0 = torch.cat([mesh.v.new_zeros(nif),
                      piso_mod.boundary_flux(mesh, U)])
    src0 = surface.surface_sum(mesh, phi0)
    corrected = case.laplacian_corrected()
    for _ in range(max(nno, 1)):
        eqn = fvm.laplacian(mesh, 1.0, Phi, corrected=corrected,
                            gamma_dims=dimless)
        eqn = eqn.replace_fields(source=eqn.source + src0)
        if piso_mod.needs_reference(Phi, mesh):
            eqn = eqn.set_reference(0, 0.0)
        data, perf = linear.solve(mesh, eqn, Phi.data, ctl)
        Phi = Phi.with_data(data)
    phi = phi0 - eqn.flux(mesh, data)

    log.info(log.solver_line("Phi", perf))
    Unew = U.with_data(fvc.reconstruct(mesh, phi))
    case.write_fields([Unew, p])
    case.final_state = {"U": Unew, "phi": phi, "Phi": Phi}
    log.info("End\n")


APPLICATIONS = {
    "icoFoam": icofoam,
    "nonNewtonianIcoFoam": non_newtonian_icofoam,
    "pisoFoam": pisofoam,
    "pimpleFoam": pimplefoam,
    "simpleFoam": simplefoam,
    "interFoam": interfoam_app,
    # the rotating-frame and porous variants: the base solvers read
    # constant/MRFZones, constant/SRFProperties and constant/porousZones
    # (OpenFOAM 2.2 ships them as applications of their own)
    "MRFSimpleFoam": simplefoam,
    "MRFPimpleFoam": pimplefoam,
    "SRFSimpleFoam": simplefoam,
    "SRFPimpleFoam": pimplefoam,
    "porousSimpleFoam": simplefoam,
    "MRFInterFoam": interfoam_app,
    "porousInterFoam": interfoam_app,
    # channelFoam is pimpleFoam with an LES model, as in the reference,
    # whose channelFoam reads no Ubar: nothing holds the bulk velocity
    # (OpenFOAM's channelFoam adjusts gradP to hold it)
    "channelFoam": pimplefoam,
    "boundaryFoam": boundary_foam,
    "laplacianFoam": laplacian_foam,
    "scalarTransportFoam": scalar_transport_foam,
    "potentialFoam": potential_foam,
    "buoyantBoussinesqSimpleFoam": buoyant_boussinesq_simplefoam,
    "buoyantBoussinesqPimpleFoam": buoyant_boussinesq_pimplefoam,
    "pimpleDyMFoam": pimple_dym_foam,
    "interDyMFoam": lambda case, max_steps=None: interfoam_app(
        case, max_steps, dym=True),
}


def run(case, max_steps: Optional[int] = None):
    """Run the application that the case's controlDict names; returns the
    case, with the last state in `case.final_state`."""
    fn = APPLICATIONS.get(case.application)
    if fn is None:
        _not_ported(f"application {case.application!r} (ported: "
                    f"{sorted(APPLICATIONS)})")
    fn(case, max_steps=max_steps)
    return case
