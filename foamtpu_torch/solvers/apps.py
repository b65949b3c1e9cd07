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
buoyantBoussinesqPimpleFoam, on solid-body moving meshes pimpleDyMFoam
and interDyMFoam, and the compressible family: rhoSimpleFoam,
rhoPimpleFoam, rhoSimplecFoam, rhoPimplecFoam and sonicFoam with their
porous/MRF aliases (rhoPorousSimpleFoam, rhoPorousMRFSimpleFoam,
rhoPorousMRFPimpleFoam, rhoPorousMRFLTSPimpleFoam), rhoCentralFoam,
rhoCentralDyMFoam, buoyantSimpleFoam and buoyantPimpleFoam, and the
single-equation applications: electrostaticFoam, magneticFoam, mhdFoam,
financialFoam, shallowWaterFoam, solidDisplacementFoam,
solidEquilibriumDisplacementFoam, potentialFreeSurfaceFoam,
adjointShapeOptimizationFoam and dnsFoam, and the multiphase family:
twoLiquidMixingFoam, interMixingFoam, interPhaseChangeFoam,
multiphaseInterFoam and MRFMultiphaseInterFoam, compressibleInterFoam,
settlingFoam, cavitatingFoam and sonicLiquidFoam, twoPhaseEulerFoam and
bubbleFoam, multiphaseEulerFoam, and the combustion family: chemFoam,
reactingFoam and rhoReactingFoam, XiFoam and PDRFoam, fireFoam (with
P1/fvDOM radiation and the pyrolysis and film regions; buoyantSimpleFoam
and buoyantPimpleFoam take constant/radiationProperties too), the engine
family (coldEngineFoam, engineFoam, sonicDyMFoam and sprayEngineFoam),
and from solvers/parcels.py the Lagrangian family
(icoUncoupledKinematicParcelFoam, uncoupledKinematicParcelFoam,
reactingParcelFoam, LTSReactingParcelFoam,
porousExplicitSourceReactingParcelFoam, coalChemistryFoam, sprayFoam,
reactingParcelFilmFoam) and the discrete methods (dsmcFoam, mdFoam,
mdEquilibrationFoam): every application the reference registers.
`run(case)` picks among them by controlDict's `application`. The turbulence model
comes from constant/RASProperties or constant/LESProperties (the
compressible applications take the models of compressible.py where the
case ships 0/mut).

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

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..core.dictionary import FoamDict, dimensioned_scalar, parse_file
from ..models.turbulence import base as turb_mod
from ..utils import logging as log
from . import parcels
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
    it on the case mesh's device.

    compressible=True (`nu` is then the dynamic viscosity mu) selects the
    rho-weighted model of compressible.py where one is registered; it
    reads the model's optional fields (alphat) when the case has them.
    When the case ships no field the compressible model needs (0/mut),
    the incompressible twin is taken instead, as in the reference: its
    solvers then run rho*(nu + nut) on the volumetric flux."""
    for fname, kind in (("RASProperties", "RAS"), ("LESProperties", "LES"),
                        ("turbulenceProperties", "RAS")):
        path = case.const_path(fname)
        if os.path.exists(path):
            props = parse_file(path)
            break
    else:
        return None, None

    def build(compressible):
        model = turb_mod.select(props, nu, kind=kind,
                                compressible=compressible)
        model.corrected = case.laplacian_corrected()
        model.corr_limit = case.corr_limit()
        try:
            model.div_scheme = case.div_scheme("div(phi,k)")
        except KeyError:
            pass
        return model

    def read_state(model):
        tstate = {}
        optional = getattr(model, "optional_fields", ())
        for name in model.field_names + tuple(
                f for f in optional if f not in model.field_names):
            try:
                tstate[name] = case.read_field(name)
            except (FileNotFoundError, KeyError, OSError):
                if name not in optional:
                    raise
        return tstate

    model = build(compressible)
    if not model.field_names:
        return None, None
    try:
        tstate = read_state(model)
    except (FileNotFoundError, KeyError, OSError):
        if not getattr(model, "compressible_form", False):
            raise
        model = build(False)
        if not model.field_names:
            return None, None
        tstate = read_state(model)
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


def _phases(tp, *names):
    """(nu, rho) of each named phase subdict of transportProperties."""
    out = []
    for name in names:
        ph = tp.get(name, tp)
        _, nu_v = dimensioned_scalar(ph["nu"])
        _, rho_v = dimensioned_scalar(ph["rho"])
        out.append((nu_v, rho_v))
    return out


def _read_alpha1(case):
    """The VOF fraction of the start time, under its 2.2 names."""
    for nm in ("alpha1", "alpha.water", "alpha"):
        if os.path.exists(os.path.join(case.dir, "0", nm)):
            return case.read_field(nm)
    return None


def _inter_config(case, lts: bool = False):
    """The InterConfig of an interFoam case: the two phases (2.2 layout:
    phase1 { nu; rho; } phase2 { ... } sigma), constant/g, the PIMPLE
    dict and the p_rgh/U controls. As in the reference, the PIMPLE
    dict's momentumPredictor is not read (the step always solves the
    momentum predictor), and the U controls are taken when any solvers
    key mentions U (damBreak's "(U|alpha1)")."""
    from . import interfoam as inter_mod

    tp = case.transport_properties()
    (nu1, rho1), (nu2, rho2) = _phases(tp, "phase1", "phase2")
    _, sigma = dimensioned_scalar(tp.get("sigma", 0.0))
    g_vec = _read_gravity(case)
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
    LTSInterFoam, dym=True interDyMFoam on a solidBodyMotionFvMesh or a
    dynamicRefineFvMesh (constant/dynamicMeshDict; _inter_amr_run)."""
    from . import interfoam as inter_mod

    cfg = _inter_config(case, lts=lts)
    if dym:
        dmd = case.properties("dynamicMeshDict")
        if str(dmd.get("dynamicFvMesh", "")) == "dynamicRefineFvMesh":
            # adaptive refinement around the interface (the reference's
            # damBreakWithObstacle): no function objects, as the reference
            return _inter_amr_run(case, cfg, dmd, max_steps)
    fol = _function_objects(case)
    mesh = case.mesh
    U = case.read_field("U")
    alpha = _read_alpha1(case)
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


def _field_on_mesh(case, name: str, mesh2, data):
    """A 0/ field's BCs rebuilt on a new mesh around the given cell data
    (the reference's: the patch face counts change at every adaptation,
    so the boundaryField entries are instantiated anew on the new
    patches; per-face nonuniform BC values are not remapped, uniform and
    keyword BCs, the damBreak pattern, are exact)."""
    from ..bc import factory as bc_factory
    from ..bc.patchfields import normalize_bcs
    from ..core.dimensions import DimensionSet
    from ..core.fields import VolField
    from ..io.fields import load_field_dict

    d = load_field_dict(os.path.join(case.dir, "0", name))
    dims = d.get("dimensions", DimensionSet.of())
    if not isinstance(dims, DimensionSet):
        dims = DimensionSet.of()
    rank = 1 if data.ndim == 2 else 0
    dtype, dev = mesh2.v.dtype, mesh2.device
    bf = d["boundaryField"]
    bcs = [bc_factory.from_dict(bf.match(p.name), p, rank, dtype, dev,
                                mesh=mesh2)
           for p in mesh2.patches]
    return VolField(data=torch.as_tensor(data, dtype=dtype, device=dev),
                    bcs=normalize_bcs(mesh2, tuple(bcs), rank),
                    name=name, dims=dims)


def _correct_phi(mesh, phi, p_like):
    """The projection of a remapped flux to div-free (correctPhi.H):
    laplacian(pcorr) == div(phi); phi -= flux(pcorr)."""
    from ..core.dimensions import dimTime
    from ..ops import fvm, surface
    from . import linear
    from .piso import needs_reference

    pcorr = p_like.with_data(torch.zeros_like(p_like.data))
    pEqn = fvm.laplacian(mesh, torch.tensor(1.0, dtype=mesh.v.dtype,
                                            device=mesh.device),
                         pcorr, gamma_dims=dimTime)
    pEqn = pEqn.replace_fields(
        source=pEqn.source + surface.surface_sum(mesh, phi))
    pEqn, ctl = linear.prep_pressure(
        pEqn, needs_reference(pcorr, mesh),
        {"solver": "PCG", "preconditioner": "polynomial",
         "tolerance": 1e-8, "relTol": 0.0, "maxIter": 1000}, 0, 0.0)
    data, _ = linear.solve(mesh, pEqn, pcorr.data, ctl)
    return phi - pEqn.flux(mesh, data)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def amr_start(case, cfg, dmd, init=None) -> Dict:
    """The start of an interDyMFoam run on a dynamicRefineFvMesh: the
    octree of the case's box mesh (`init`: the (amr, pm) of
    refine.amr_init when the caller made it), its device mesh, the fields
    read on the blockMesh order and put in the octree's, the state and
    the step. Returns the run's record, which amr_adapt advances."""
    from ..mesh import refine, to_device
    from . import interfoam as inter_mod

    coeffs = dmd.get("dynamicRefineFvMeshCoeffs", FoamDict())
    amr, pm = init if init is not None else refine.amr_init(case.poly_mesh)
    # the permutation from the blockMesh order to the octree's
    pm0 = case.poly_mesh
    nx, ny, nz = amr.base_n
    ext = amr.bb_max - amr.bb_min
    ijk = np.clip(np.floor((pm0.c - amr.bb_min) / ext
                           * np.array([nx, ny, nz])).astype(int),
                  0, np.array([nx, ny, nz]) - 1)
    canon_idx = {c: i for i, c in enumerate(amr.cells)}
    perm = np.array([canon_idx[(0, int(i), int(j), int(k))]
                     for i, j, k in ijk])
    mesh = to_device(pm, case.device)
    case._poly, case._mesh = pm, mesh

    def reorder(f):
        data = _host(f.data)
        out = np.empty_like(data)
        out[perm] = data
        return out

    alpha_name = next(nm for nm in ("alpha1", "alpha.water", "alpha")
                      if os.path.exists(os.path.join(case.dir, "0", nm)))
    U = _field_on_mesh(case, "U", mesh, reorder(case.read_field("U")))
    p_rgh = _field_on_mesh(case, "p_rgh", mesh,
                           reorder(case.read_field("p_rgh")))
    alpha = _field_on_mesh(case, alpha_name, mesh,
                           reorder(case.read_field(alpha_name)))
    return {"amr": amr, "pm": pm, "mesh": mesh, "cfg": cfg,
            "alpha_name": alpha_name,
            "interval": int(_dim_scalar_of(coeffs, "refineInterval", 1)),
            "adapt": (_dim_scalar_of(coeffs, "lowerRefineLevel", 0.001),
                      _dim_scalar_of(coeffs, "upperRefineLevel", 0.999),
                      int(_dim_scalar_of(coeffs, "maxRefinement", 1)),
                      int(_dim_scalar_of(coeffs, "nBufferLayers", 1)),
                      int(_dim_scalar_of(coeffs, "maxCells", 500000))),
            "state": inter_mod.initial_state(mesh, U, p_rgh, alpha, cfg),
            "step": inter_mod.make_step(mesh, cfg)}


def amr_adapt(case, run: Dict, clock=None) -> Dict:
    """One adaptation event (dynamicRefineFvMesh::update): the octree
    adapts to the alpha band on the host, the fields remap
    volume-conservatively, the device mesh is rebuilt (to_device), the p_rgh
    controls anew on it (a GAMG hierarchy when the case asks for GAMG),
    the state rebuilt with its flux projected div-free (correctPhi), the
    wall distance of any model that carries one refreshed, and the step
    remade. Returns the event's record: whether the mesh changed, its
    cell count, and with `clock` (a function returning seconds, which may
    synchronise the device) the seconds of each part. The port is eager:
    nothing is recompiled."""
    from ..mesh import refine, to_device
    from ..mesh.walldist import refresh_wall_distance
    from . import interfoam as inter_mod

    tick = clock or (lambda: 0.0)
    state, cfg = run["state"], run["cfg"]
    t0 = tick()
    out = refine.adapt(run["amr"], run["pm"], _host(state["alpha"].data),
                       *run["adapt"])
    t1 = tick()
    if out is None:
        rec = {"changed": False, "n_cells": run["mesh"].n_cells}
        if clock is not None:
            rec["adapt_s"] = t1 - t0
        return rec
    amr2, pm2 = out
    vo, vn = refine.build_maps(run["amr"], amr2)
    n2 = pm2.n_cells
    remapped = {k: refine.remap_field(_host(state[k].data), vo, vn, n2)
                for k in ("U", "p_rgh", "alpha")}
    t2 = tick()
    mesh2 = to_device(pm2, case.device)
    case._poly, case._mesh = pm2, mesh2
    t3 = tick()
    # the p_rgh controls on the new mesh (a GAMG hierarchy is built for
    # one mesh)
    cfg = cfg._replace(p_controls=case.solver_controls("p_rgh"))
    t4 = tick()
    U = _field_on_mesh(case, "U", mesh2, remapped["U"])
    p_rgh = _field_on_mesh(case, "p_rgh", mesh2, remapped["p_rgh"])
    alpha = _field_on_mesh(case, run["alpha_name"], mesh2,
                           remapped["alpha"])
    state = inter_mod.initial_state(mesh2, U, p_rgh, alpha, cfg)
    # correctPhi: project the rebuilt flux to div-free, so that the next
    # MULES step stays bounded
    state["phi"] = _correct_phi(mesh2, state["phi"], p_rgh)
    t5 = tick()
    refresh_wall_distance(getattr(cfg, "turb", None), pm2, mesh2.v.dtype,
                          device=mesh2.device)
    run.update(amr=amr2, pm=pm2, mesh=mesh2, cfg=cfg, state=state,
               step=inter_mod.make_step(mesh2, cfg))
    rec = {"changed": True, "n_cells": n2}
    if clock is not None:
        rec.update(adapt_s=t1 - t0, maps_remap_s=t2 - t1,
                   to_device_s=t3 - t2, gamg_rebuild_s=t4 - t3,
                   correct_phi_s=t5 - t4)
    return rec


def _inter_amr_run(case, cfg, dmd, max_steps: Optional[int]) -> None:
    """interFoam on a dynamicRefineFvMesh (src/dynamicFvMesh/
    dynamicRefineFvMesh, the damBreakWithObstacle tutorial): every
    refineInterval steps the octree adapts to the alpha band (amr_adapt),
    the fields remap volume-conservatively and the device mesh is
    rebuilt. The flux is rebuilt from the remapped velocity and
    projected (correctPhi)."""
    run = amr_start(case, cfg, dmd)
    log.info(f"Starting time loop: interDyMFoam/dynamicRefineFvMesh, "
             f"{run['mesh'].n_cells} cells\n")
    for t in case.time.loop():
        mesh = run["mesh"]
        run["state"], diag = run["step"](run["state"],
                                         _dt(mesh, t.current_dt))
        log.info(f"Time = {t.name}\nPhase-1 volume fraction: min = "
                 f"{float(diag['alpha_min']):.6g} max = "
                 f"{float(diag['alpha_max']):.6g}  cells = "
                 f"{mesh.n_cells}\n")
        t.adjust_delta_t(float(diag["courant_max"]))
        if t.index % run["interval"] == 0:
            if amr_adapt(case, run)["changed"]:
                log.info(f"Refined mesh: {run['mesh'].n_cells} cells\n")
        state = run["state"]
        if t.write_time():
            case.write_fields([state["U"], state["p_rgh"], state["alpha"]])
        if max_steps is not None and t.index >= max_steps:
            break
    state = run["state"]
    case.write_fields([state["U"], state["p_rgh"], state["alpha"]])
    case.final_state = state
    case.final_state["n_cells"] = run["mesh"].n_cells
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
    as the reference's. The sixDoFRigidBodyMotion motion solver runs
    _pimple_dym_sixdof, the attachDetach topology changer
    _pimple_attach_detach."""
    from . import pimpledym as dym_mod

    mesh = case.mesh
    dmd = case.properties("dynamicMeshDict")
    solver_nm = str(dmd.get("motionSolverLibs", ""))
    msd = dmd.get("motionSolver", dmd.get("solver", ""))
    if (str(msd) == "sixDoFRigidBodyMotion"
            or "sixDoFRigidBodyMotion" in solver_nm):
        return _pimple_dym_sixdof(case, dmd, max_steps)
    if (str(dmd.get("topoChanger", "")) == "attachDetach"
            or "attachDetachCoeffs" in dmd):
        return _pimple_attach_detach(case, dmd, max_steps)
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


def _vec3(v, default) -> tuple:
    return tuple(float(x) for x in np.asarray(
        v if v is not None else default, float).reshape(-1)[-3:])


def _pimple_dym_sixdof(case, dmd, max_steps: Optional[int]) -> None:
    """pimpleDyMFoam with the sixDoFRigidBodyMotion motion solver
    (src/sixDoFRigidBodyMotion, the floatingObject pattern): the flow's
    forces on the body patch drive the rigid body, the mesh blends with
    its motion (solvers/floating.py). dynamicMeshDict keys:
    sixDoFRigidBodyMotionCoeffs { patch; mass; momentOfInertia;
    centreOfMass; innerDistance; outerDistance; rhoInf; restraints {
    ... linearSpring ... } }."""
    from ..models import sixdof
    from . import floating as fl_mod

    mesh = case.mesh
    _, nu = dimensioned_scalar(case.transport_properties()["nu"])
    co = dmd.get("sixDoFRigidBodyMotionCoeffs", dmd)
    patch_name = str(co.get("patch", co.get("patches", "body")))
    body_idx = [i for i, p in enumerate(mesh.patches)
                if p.name == patch_name][0]
    com = _vec3(co.get("centreOfMass"), [0, 0, 0])
    moi = _vec3(co.get("momentOfInertia"), [1, 1, 1])
    springs = []
    restr = co.get("restraints", FoamDict())
    for _, rd in (restr.items() if hasattr(restr, "items") else []):
        if not hasattr(rd, "get"):
            continue
        if str(rd.get("sixDoFRigidBodyMotionRestraint",
                      rd.get("type", ""))) == "linearSpring":
            springs.append((_vec3(rd.get("anchor"), com),
                            _vec3(rd.get("refAttachmentPt"), [0, 0, 0]),
                            _dim_scalar_of(rd, "stiffness", 0.0),
                            _dim_scalar_of(rd, "damping", 0.0),
                            _dim_scalar_of(rd, "restLength", 0.0)))
    bcfg = sixdof.RigidBodyConfig(mass=_dim_scalar_of(co, "mass", 1.0),
                                  I_body=moi, g=_read_gravity(case),
                                  springs=tuple(springs))
    cfg = fl_mod.FloatingConfig(
        nu=nu, body=bcfg, body_patch=body_idx, x0=com,
        r_inner=_dim_scalar_of(co, "innerDistance", 0.1),
        r_outer=_dim_scalar_of(co, "outerDistance", 0.3),
        rho_ref=_dim_scalar_of(co, "rhoInf", 1000.0),
        p_controls=case.solver_controls("p"))
    U = case.read_field("U")
    p = case.read_field("p")
    state = fl_mod.initial_state(case.poly_mesh, mesh, U, p, cfg)
    step = fl_mod.make_step(mesh, cfg)
    log.info(f"Starting loop: pimpleDyMFoam + sixDoFRigidBodyMotion "
             f"(patch {patch_name})\n")
    diag = None
    for t in case.time.loop():
        state, diag = step(state, _dt(mesh, t.current_dt))
        bx = _host(diag["body_x"])
        log.info(f"Time = {t.name}\nCentre of mass: ({bx[0]:.6g} "
                 f"{bx[1]:.6g} {bx[2]:.6g})\n")
        if t.write_time():
            case.write_fields([state["U"], state["p"]])
        if max_steps is not None and t.index >= max_steps:
            break
    case.write_fields([state["U"], state["p"]])
    case.final_state = {"state": state, "diag": diag}
    log.info("End\n")


def _pimple_attach_detach(case, dmd, max_steps: Optional[int]) -> None:
    """pimpleDyMFoam with an attachDetach topology modifier
    (src/dynamicMesh/attachDetach/ under topoChangerFvMesh, the valve or
    gate pattern): the internal faces of one plane of a layered mesh
    detach into a wall pair at detachTime and attach again at
    attachTime (mesh/topo.py). The two topologies share the same cells,
    only the face list differs, so the fields carry over by identity,
    exactly conservative; the flux is made anew from U on the new faces
    (zero through the detached pair) and the device mesh is rebuilt."""
    from ..mesh import to_device
    from ..mesh import topo as topo_mod

    coeffs = dmd.get("attachDetachCoeffs", FoamDict())
    axis = {"x": 0, "y": 1, "z": 2}[str(coeffs.get("axis", "x"))]
    plane_pos = float(coeffs.get("position", 0.5))
    detach_t = float(coeffs.get("detachTime", 0.0))
    attach_t = float(coeffs.get("attachTime", 1e30))

    topo = topo_mod.analyze(case.poly_mesh, axis)
    planes = topo.planes
    s = int(np.argmin(np.abs(planes[1:-1] - plane_pos))) + 1
    log.info(f"attachDetach: plane {s} at {planes[s]:.6g} along "
             f"{'xyz'[axis]}, detach at t={detach_t:.6g}, "
             f"attach at t={attach_t:.6g}\n")

    _, nu = dimensioned_scalar(case.transport_properties()["nu"])
    cdict = case.pimple_controls("PIMPLE")

    def build(detached):
        pm = topo_mod.build(topo, planes,
                            detach_planes=(s,) if detached else ())
        mesh = to_device(pm, case.device)
        case._poly, case._mesh = pm, mesh
        cfg = piso_mod.PisoConfig(
            nu=nu, n_correctors=int(cdict.get("nCorrectors", 2)),
            n_non_orth=int(cdict.get("nNonOrthogonalCorrectors", 0)),
            corrected=case.laplacian_corrected(),
            div_scheme=case.div_scheme("div(phi,U)"),
            p_ref_cell=int(cdict.get("pRefCell", 0)),
            p_ref_value=float(cdict.get("pRefValue", 0.0)),
            p_controls=case.solver_controls("p"),
            u_controls=case.solver_controls("U"))
        return pm, mesh, cfg

    # the initial fields in slab-major layered order (the cell ids are
    # then the same across attach and detach events)
    U0 = topo_mod.reorder_to_layers(topo, _host(case.read_field("U").data))
    p0 = topo_mod.reorder_to_layers(topo, _host(case.read_field("p").data))

    t = case.time
    detached = detach_t <= t.start_time < attach_t
    pm, mesh, cfg = build(detached)
    state = piso_mod.initial_state(mesh, _field_on_mesh(case, "U", mesh, U0),
                                   _field_on_mesh(case, "p", mesh, p0))
    step = piso_mod.make_step(mesh, cfg)
    log.info(f"Starting loop: pimpleDyMFoam (attachDetach), "
             f"{mesh.n_cells} cells, "
             f"{'DETACHED' if detached else 'attached'}\n")
    cumulative = 0.0
    max_iter = max(int(round((t.end_time - t.start_time) / t.delta_t)), 1)
    if max_steps is not None:
        max_iter = min(max_iter, max_steps)

    def write(state):
        case.write_fields([state["U"], state["p"]])

    while (t.index < max_iter and not t.stop_now
           and t.value < t.end_time - 1e-12):
        t_next = t.start_time + (t.index + 1) * t.delta_t
        want_detached = detach_t <= t_next < attach_t
        if want_detached != detached:
            # the topology event: the same cells, the identity remap
            log.info(f"attachDetach event at t={t_next:.6g}: "
                     f"{'DETACH' if want_detached else 'ATTACH'}\n")
            detached = want_detached
            Ud, pd = state["U"].data, state["p"].data
            pm, mesh, cfg = build(detached)
            state = piso_mod.initial_state(
                mesh, _field_on_mesh(case, "U", mesh, Ud),
                _field_on_mesh(case, "p", mesh, pd))
            step = piso_mod.make_step(mesh, cfg)
        dt = _dt(mesh, t.delta_t)
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
    """constant/g (uniformDimensionedVectorField g); (0, -9.81, 0) when
    the case has none, as in the reference."""
    path = case.const_path("g")
    if os.path.exists(path):
        v = np.asarray(parse_file(path).get("value")).reshape(-1)
        return (float(v[0]), float(v[1]), float(v[2]))
    return (0.0, -9.81, 0.0)
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
# compressible: rhoSimpleFoam, rhoPimpleFoam, their SIMPLEC twins, sonicFoam
# and the porous/MRF variants; rhoCentralFoam(DyM); buoyant{Simple,Pimple}Foam
# ---------------------------------------------------------------------------


def _has_solver(case, name) -> bool:
    try:
        case.solver_controls(name)
        return True
    except KeyError:
        return False


def _thermo(case):
    from ..models import thermo as thermo_mod

    return thermo_mod.from_dict(case.properties("thermophysicalProperties"))


def _rho_loop(case, step, state, steady, name, max_steps, res_ctl, fol,
              fields, log_field="T", start=None):
    """The loop of the pressure-based compressible applications: one
    iteration or step at a time with its log lines (`log_field`'s solve
    too: T, or XiFoam's b), the function objects, the fields
    `fields(state)` written at write times and at the end, SIMPLE
    stopped by residualControl. `start` replaces the loop's first line."""
    mesh = case.mesh
    log.info(start or f"Starting loop: {name}, {mesh.n_cells} cells\n")
    cumulative = 0.0
    t = case.time
    max_iter = max(int(round((t.end_time - t.start_time) / t.delta_t)), 1)
    if max_steps is not None:
        max_iter = min(max_iter, max_steps)
    dt = torch.tensor(1.0 if steady else t.delta_t, dtype=mesh.v.dtype,
                      device=mesh.device)

    def write(state):
        out = fields(state)
        if "turb" in state and state["turb"]:
            out += list(state["turb"].values())
        case.write_fields(out)

    while (t.index < max_iter and not t.stop_now
           and t.value < t.end_time - 1e-12):
        state, diag = step(state, dt)
        t.index += 1
        t.value = t.start_time + t.index * t.delta_t
        t.current_dt = float(dt)
        cumulative = _log_step(case, t, diag, cumulative)
        log.info(log.solver_line(log_field, diag[log_field]))
        fol.execute(t.name, state)
        if t.write_time():
            write(state)
        if steady and simple_mod.converged(diag, res_ctl):
            log.info(f"SIMPLE solution converged in {t.index} iterations\n")
            break
    write(state)
    log.info("End\n")
    case.final_state = state


def _flow_fields(case, pname: str, steady: bool = False, model=None
                 ) -> dict:
    """The fields every compressible flow config reads alike: the SIMPLE
    or PIMPLE dict's correctors and pRefValue, the laplacian, div and
    grad(`pname`) schemes, the `pname`/`pname`Final/U/T controls, the
    turbulence model and its relaxation factor."""
    cdict = case.pimple_controls("SIMPLE" if steady else "PIMPLE")
    try:
        pf_ctl = case.solver_controls(pname + "Final")
    except KeyError:
        pf_ctl = None
    return dict(
        n_outer=int(cdict.get("nOuterCorrectors", 1)),
        n_correctors=int(cdict.get("nCorrectors", 2)),
        n_non_orth=int(cdict.get("nNonOrthogonalCorrectors", 0)),
        corrected=case.laplacian_corrected(),
        div_scheme=case.div_scheme("div(phi,U)"),
        div_scheme_e=case.div_scheme("div(phi,e)"),
        grad_scheme=case.grad_scheme(f"grad({pname})"),
        p_ref_value=float(cdict.get("pRefValue", 1e5)),
        p_controls=case.solver_controls(pname),
        p_controls_final=pf_ctl,
        u_controls=case.solver_controls("U"),
        e_controls=(case.solver_controls("T") if _has_solver(case, "T")
                    else None),
        turb=model,
        turb_relax=_relaxation(case).get("k", 0.7),
    )


def _rho_pimple_config(case, th, steady: bool, transonic: bool,
                       consistent: bool = False, model=None):
    """The RhoPimpleConfig of a rhoSimpleFoam / rhoPimpleFoam / sonicFoam
    case: the SIMPLE or PIMPLE dict (its `transonic` switch), the
    relaxation factors, the schemes, the p/pFinal/U/T controls, the
    turbulence model, fvOptions and porousZones, and the MRF zones."""
    from . import rhopimple as rp_mod

    relax = _relaxation(case)
    cdict = case.pimple_controls("SIMPLE" if steady else "PIMPLE")
    return rp_mod.RhoPimpleConfig(
        thermo=th,
        steady=steady,
        consistent=consistent,
        transonic=transonic or str(cdict.get("transonic", "no")) in _TRUE,
        ddt_scheme=case.ddt_scheme(),
        alpha_u=relax.get("U", 0.7 if steady else 1.0),
        alpha_p=relax.get("p", 0.3 if steady else 1.0),
        alpha_e=relax.get("e", relax.get("h", 0.7 if steady else 1.0)),
        p_ref_cell=int(cdict.get("pRefCell", 0)),
        fv_options=_load_fvoptions(case, th.mu),
        mrf=_load_mrf(case),
        **_flow_fields(case, "p", steady, model),
    )


def _rho_pimple_state(case, cfg, tstate=None):
    """The first state of a rhoPimple-family case: U with the MRF zones'
    rotating walls, the mass flux made relative to the zones
    (rho-weighted), and the fvOptions' state."""
    from ..ops import slot as slot_mod
    from ..ops import surface
    from . import rhopimple as rp_mod

    mesh = case.mesh
    th = cfg.thermo
    U = _read_u(case, cfg.mrf)
    p = case.read_field("p")
    T = case.read_field("T")
    state = rp_mod.initial_state(mesh, U, p, T, th, turb_state=tstate,
                                 steady=cfg.steady)
    if cfg.mrf:
        rho_c = th.rho(p.data, T.data)
        rho_slot = slot_mod.interpolate(
            mesh, rho_c, bv=surface.owner_to_b(mesh, rho_c))
        sl = cfg.mrf.make_relative(
            mesh, slot_mod.from_flat(mesh, state["phi"]), rho_slot=rho_slot)
        state["phi"] = slot_mod.to_flat(mesh, sl)
        state["phi_slot"] = (sl.sv, sl.fb)
    if cfg.fv_options:
        state["fvopt"] = cfg.fv_options.init_state(mesh)
    return state


def _rho_pimple_run(case, steady: bool, transonic: bool,
                    max_steps: Optional[int],
                    consistent: bool = False) -> None:
    """The shared driver of rhoSimpleFoam, rhoPimpleFoam, their SIMPLEC
    twins and sonicFoam (compressible/); it reads constant/porousZones,
    system/fvOptions and constant/MRFZones, so the porous and MRF
    applications are aliases of it."""
    from . import rhopimple as rp_mod

    fol = _function_objects(case)
    mesh = case.mesh
    th = _thermo(case)
    model, tstate = _load_turbulence(case, max(th.mu, 1e-12),
                                     compressible=True)
    cfg = _rho_pimple_config(case, th, steady, transonic, consistent, model)
    state = _rho_pimple_state(case, cfg, tstate)
    name = ("rhoSimpleFoam" if steady
            else ("sonicFoam" if cfg.transonic else "rhoPimpleFoam"))
    _rho_loop(case, rp_mod.make_step(mesh, cfg), state, steady, name,
              max_steps, _residual_control(
                  case, "SIMPLE" if steady else "PIMPLE"),
              fol, lambda st: [st["U"], st["p"], st["T"]])


def rho_simplefoam(case, max_steps: Optional[int] = None):
    """rhoSimpleFoam (compressible/rhoSimpleFoam): steady SIMPLE."""
    _rho_pimple_run(case, steady=True, transonic=False, max_steps=max_steps)


def rho_pimplefoam(case, max_steps: Optional[int] = None):
    """rhoPimpleFoam (compressible/rhoPimpleFoam): transient PIMPLE."""
    _rho_pimple_run(case, steady=False, transonic=False, max_steps=max_steps)


def rho_simplecfoam(case, max_steps: Optional[int] = None):
    """rhoSimplecFoam (compressible/rhoSimpleFoam/rhoSimplecFoam):
    SIMPLEC-consistent rhoSimpleFoam."""
    _rho_pimple_run(case, steady=True, transonic=False,
                    max_steps=max_steps, consistent=True)


def rho_pimplecfoam(case, max_steps: Optional[int] = None):
    """rhoPimplecFoam (compressible/rhoPimpleFoam/rhoPimplecFoam):
    SIMPLEC-consistent rhoPimpleFoam."""
    _rho_pimple_run(case, steady=False, transonic=False,
                    max_steps=max_steps, consistent=True)


def sonicfoam(case, max_steps: Optional[int] = None):
    """sonicFoam (compressible/sonicFoam): the transonic pressure
    equation, implicit div(phid, p)."""
    _rho_pimple_run(case, steady=False, transonic=True, max_steps=max_steps)


def _rho_central_setup(case):
    """The thermo, the config (fvSchemes' fluxScheme) and rho's VolField
    (zeroGradient and constraint BCs) of a rhoCentralFoam case, with its
    U and T."""
    from ..bc.patchfields import default_bcs
    from ..core.fields import VolField
    from ..core.dimensions import DimensionSet
    from . import rhocentral as rc_mod

    mesh = case.mesh
    th = _thermo(case)
    U = case.read_field("U")
    T = case.read_field("T")
    p_f = case.read_field("p")
    rho = VolField(data=th.rho(p_f.data, T.data), bcs=default_bcs(mesh, 0),
                   name="rho", dims=DimensionSet.of(1, -3, 0))
    scheme = str(case.fv_schemes.get("fluxScheme", "Kurganov"))
    cfg = rc_mod.RhoCentralConfig(thermo=th, flux_scheme=scheme)
    return cfg, rho, U, T


def rhocentralfoam_app(case, max_steps: Optional[int] = None) -> None:
    """rhoCentralFoam (compressible/rhoCentralFoam): chunks of
    FOAMTPU_CHUNK steps (default 10) between log lines; a run of fewer
    steps than a chunk still runs the whole chunk, as the reference's."""
    from . import rhocentral as rc_mod

    mesh = case.mesh
    cfg, rho, U, T = _rho_central_setup(case)
    chunk_n = int(os.environ.get("FOAMTPU_CHUNK", "10"))
    chunk = rc_mod.make_chunk(mesh, cfg, chunk_n)
    state = rc_mod.initial_state(mesh, rho, U, T, cfg)

    log.info(f"Starting time loop: rhoCentralFoam, {mesh.n_cells} cells\n")
    t = case.time
    n_steps = max(int(round((t.end_time - t.start_time) / t.delta_t)), 1)
    if max_steps is not None:
        n_steps = min(n_steps, max_steps)
    dt = torch.tensor(t.delta_t, dtype=mesh.v.dtype, device=mesh.device)
    while t.index < n_steps:
        state, diag = chunk(state, dt)
        t.index += chunk_n
        t.value = t.start_time + t.index * t.delta_t
        log.info(f"Time = {t.name}  Courant = "
                 f"{float(diag['courant_max']):.4g}  rho: "
                 f"[{float(diag['rho_min']):.4g}, "
                 f"{float(diag['rho_max']):.4g}]")
        if t.write_time():
            case.write_fields([state["U"], state["T"], state["rho"]])
    case.write_fields([state["U"], state["T"], state["rho"]])
    case.final_state = state
    log.info("End\n")


def rhocentral_dym_foam(case, max_steps: Optional[int] = None) -> None:
    """rhoCentralDyMFoam (compressible/rhoCentralFoam/rhoCentralDyMFoam):
    the KNP step on a solid-body moving mesh from constant/
    dynamicMeshDict (relative convection, absolute pressure work; rigid
    motions only, see solvers/rhocentral.py)."""
    from ..mesh import moving
    from . import rhocentral as rc_mod

    mesh = case.mesh
    cfg, rho, U, T = _rho_central_setup(case)
    pts_fn, umesh_fn = _dym_motion(case)
    pm = case.poly_mesh
    state = rc_mod.initial_state(mesh, rho, U, T, cfg)
    state["topo"] = moving.topo_from_poly(pm, mesh.v.dtype, mesh.device)
    state["points0"] = torch.tensor(pm.points, dtype=mesh.v.dtype,
                                    device=mesh.device)
    state["t"] = mesh.v.new_zeros(())
    log.info(f"Starting time loop: rhoCentralDyMFoam, "
             f"{mesh.n_cells} cells\n")
    for t in case.time.loop():
        state, diag = rc_mod.rhocentraldym_step(
            mesh, state, torch.tensor(t.current_dt, dtype=mesh.v.dtype,
                                      device=mesh.device),
            cfg, pts_fn, umesh_fn)
        log.info(f"Time = {t.name}  Courant = "
                 f"{float(diag['courant_max']):.4g}\n")
        if t.write_time():
            case.write_fields([state["U"], state["T"], state["rho"]])
        if max_steps is not None and t.index >= max_steps:
            break
    case.write_fields([state["U"], state["T"], state["rho"]])
    case.final_state = state
    log.info("End\n")


def _load_radiation(case):
    """constant/radiationProperties -> models/radiation's P1Config or
    FvDOMConfig (constantAbsorptionEmissionCoeffs: absorptivity,
    emissivity, scatter; fvDOMCoeffs: nTheta, nPhi), or None when the
    case has none, switches radiation off or names another model
    (radiationModel::New, as the reference reads it: the wall emissivity
    is 1 and no G controls are set)."""
    rad_path = case.const_path("radiationProperties")
    if not os.path.exists(rad_path):
        return None
    rd = parse_file(rad_path)
    if str(rd.get("radiation", "on")) not in ("on", "yes", "true"):
        return None
    model = str(rd.get("radiationModel", "none"))
    from ..models import radiation as rad_mod

    cc = rd.get("constantAbsorptionEmissionCoeffs", FoamDict())
    a = _dim_scalar_of(cc, "absorptivity", 0.5)
    e = _dim_scalar_of(cc, "emissivity", 0.5)
    s = _dim_scalar_of(cc, "scatter", 0.0)
    if model == "P1":
        return rad_mod.P1Config(a=a, e=e, s=s, emissivity=1.0)
    if model == "fvDOM":
        fc = rd.get("fvDOMCoeffs", FoamDict())
        return rad_mod.FvDOMConfig(
            a=a, e=e, s=s, emissivity=1.0,
            n_theta=int(fc.get("nTheta", 2)),
            n_phi=int(fc.get("nPhi", 2)))
    return None


def _buoyant_rho_config(case, th, steady: bool, model=None):
    """The BuoyantRhoConfig of a buoyantSimpleFoam / buoyantPimpleFoam
    case: constant/g, the SIMPLE or PIMPLE dict, the relaxation factors
    (h or e for the energy), the schemes and the p_rgh/p_rghFinal/U/T
    controls."""
    from . import buoyantrho as br_mod

    relax = _relaxation(case)
    cdict = case.pimple_controls("SIMPLE" if steady else "PIMPLE")
    return br_mod.BuoyantRhoConfig(
        thermo=th,
        g=_read_gravity(case),
        steady=steady,
        alpha_u=relax.get("U", 0.3 if steady else 1.0),
        alpha_p=relax.get("p_rgh", 0.7 if steady else 1.0),
        alpha_e=relax.get("h", relax.get("e", 0.3 if steady else 1.0)),
        p_ref_cell=int(cdict.get("pRefCell", 0)),
        **_flow_fields(case, "p_rgh", steady, model),
    )


def _buoyant_rho_run(case, steady: bool, max_steps: Optional[int]) -> None:
    """The shared driver of buoyantSimpleFoam and buoyantPimpleFoam
    (heatTransfer/): compressible buoyant heat transfer, one iteration or
    step at a time."""
    from . import buoyantrho as br_mod

    rad = _load_radiation(case)
    fol = _function_objects(case)
    mesh = case.mesh
    th = _thermo(case)
    model, tstate = _load_turbulence(case, max(th.mu, 1e-12),
                                     compressible=True)
    cfg = _buoyant_rho_config(case, th, steady, model)
    if rad is not None:
        cfg = cfg._replace(radiation=rad)
    T = case.read_field("T")
    state = br_mod.initial_state(mesh, case.read_field("U"),
                                 case.read_field("p_rgh"), T, th, g=cfg.g,
                                 turb_state=tstate, steady=steady)
    if rad is not None:
        from ..models import radiation as rad_mod

        state["G"] = rad_mod.make_G(mesh, rad, T.bcs)
    name = "buoyantSimpleFoam" if steady else "buoyantPimpleFoam"
    _rho_loop(case, br_mod.make_step(mesh, cfg), state, steady, name,
              max_steps, _residual_control(
                  case, "SIMPLE" if steady else "PIMPLE"),
              fol, lambda st: [st["U"], st["p_rgh"], st["T"]])


def buoyant_simplefoam(case, max_steps: Optional[int] = None):
    """buoyantSimpleFoam (heatTransfer/): steady SIMPLE."""
    _buoyant_rho_run(case, steady=True, max_steps=max_steps)


def buoyant_pimplefoam(case, max_steps: Optional[int] = None):
    """buoyantPimpleFoam (heatTransfer/): transient PIMPLE."""
    _buoyant_rho_run(case, steady=False, max_steps=max_steps)


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


# ---------------------------------------------------------------------------
# the single-equation applications
# ---------------------------------------------------------------------------


def _tensor(mesh, a):
    return torch.as_tensor(np.asarray(a), dtype=mesh.v.dtype,
                           device=mesh.device)


def financial_foam(case, max_steps: Optional[int] = None) -> None:
    """financialFoam (financial/financialFoam): Black-Scholes option
    pricing on a 1-D stock-price mesh,

        ddt(V) + 0.5 sigma^2 S^2 d2V/dS2 + r S dV/dS - r V = 0,

    marched backwards from expiry (tau = T - t), S the mesh x coordinate.
    The conservative form div(0.5 s^2 S^2 grad V) = 0.5 s^2 S^2 V'' +
    s^2 S V' shifts the drift to (r - s^2) S and the sink to (2r - s^2) V,
    as in the reference. constant/financialProperties: sigma, r."""
    from ..core.dimensions import dimViscosity
    from ..ops import fvm
    from . import linear

    mesh = case.mesh
    fp = case.properties("financialProperties")
    sigma = _dim_scalar_of(fp, "sigma", 0.2)
    r = _dim_scalar_of(fp, "r", 0.05)
    V = case.read_field("V")
    ctl = case.solver_controls("V")
    Sf = mesh.cf[:, 0]
    gamma_f = 0.5 * sigma * sigma * Sf * Sf
    phi = (r - sigma * sigma) * Sf * mesh.sf[:, 0] * mesh.face_active
    sink = mesh.v.new_full((mesh.n_cells,), 2.0 * r - sigma * sigma)

    def step(V, dt):
        rdt = 1.0 / piso_mod._as_scalar(mesh, dt)
        # in tau: dV/dtau = 0.5 s^2 S^2 V'' + r S V' - r V
        eqn = (fvm.ddt(mesh, V, V.data, rdt)
               - fvm.laplacian(mesh, gamma_f, V, corrected=False,
                               gamma_dims=dimViscosity)
               - fvm.div(mesh, phi, V)
               + fvm.Sp(mesh, sink, V))
        data, perf = linear.solve(mesh, eqn, V.data, ctl)
        return V.with_data(data), perf

    for t in case.time.loop():
        V, perf = step(V, t.current_dt)
        log.info(f"Time = {t.name}")
        log.info(log.solver_line("V", perf))
        if t.write_time():
            case.write_fields([V])
        if max_steps is not None and t.index >= max_steps:
            break
    case.write_fields([V])
    case.final_state = {"V": V}
    log.info("End\n")


def electrostatic_foam(case, max_steps: Optional[int] = None) -> None:
    """electrostaticFoam (electromagnetics/electrostaticFoam): the Poisson
    equation of the electric potential and the drift transport of the
    space charge,

        laplacian(phi) == rho/epsilon0
        rhoFlux = -k * magSf * snGrad(phi)
        ddt(rho) + div(rhoFlux, rho) = 0   (upwind)

    constant/physicalProperties: epsilon0, k."""
    from ..core.dimensions import DimensionSet, dimless
    from ..ops import fvc, fvm, schemes
    from . import linear

    mesh = case.mesh
    pp = case.properties("physicalProperties")
    eps0 = _dim_scalar_of(pp, "epsilon0", 8.85418782e-12)
    k_mob = _dim_scalar_of(pp, "k", 1.9e-9)
    phiE = case.read_field("phi")   # the electric potential
    rho = case.read_field("rho")    # the space charge density
    phi_ctl = case.solver_controls("phi")
    rho_ctl = case.solver_controls("rho")
    corrected = case.laplacian_corrected()

    def step(phiE, rho, dt):
        rdt = 1.0 / piso_mod._as_scalar(mesh, dt)
        eqn = fvm.laplacian(mesh, 1.0, phiE, corrected=corrected,
                            gamma_dims=dimless)
        eqn = eqn.add_source(rho.data / eps0, mesh)
        data, pperf = linear.solve(mesh, eqn, phiE.data, phi_ctl)
        phiE = phiE.with_data(data)
        # the drift flux on the faces
        rho_flux = (-k_mob * mesh.mag_sf * fvc.sn_grad(mesh, phiE)
                    * mesh.face_active)
        w = schemes.weights(mesh, rho_flux, "upwind", rho)
        req = (fvm.ddt(mesh, rho, rho.data, rdt)
               + fvm.div(mesh, rho_flux, rho, weights=w,
                         phi_dims=DimensionSet.of(0, 3, -1)))
        rdata, rperf = linear.solve(mesh, req, rho.data, rho_ctl)
        return phiE, rho.with_data(rdata), pperf, rperf

    for t in case.time.loop():
        phiE, rho, pperf, rperf = step(phiE, rho, t.current_dt)
        log.info(f"Time = {t.name}")
        log.info(log.solver_line("phi", pperf))
        log.info(log.solver_line("rho", rperf))
        if t.write_time():
            case.write_fields([phiE, rho])
        if max_steps is not None and t.index >= max_steps:
            break
    case.write_fields([phiE, rho])
    case.final_state = {"phi": phiE, "rho": rho}
    log.info("End\n")


def _magnets(case, mesh):
    """(mur [nC], M [nC,3]) from constant/transportProperties' `magnets`:
    a list of { box ((x0 y0 z0) (x1 y1 z1)); mur; Mr; orientation; } -
    the cells are selected by box, as in the reference, in place of
    OpenFOAM's cellZone names (its documented deviation)."""
    tp = case.transport_properties()
    mur = np.ones(mesh.n_cells)
    M = np.zeros((mesh.n_cells, 3))
    c = mesh.c.detach().cpu().numpy()
    mags = tp.get("magnets", [])
    # the list form `( magnet1 { ... } ... )` parses as alternating
    # name / body items: keep the bodies
    entries = (list(mags.values()) if isinstance(mags, FoamDict)
               else [e for e in list(mags) if hasattr(e, "get")])
    for spec in entries:
        box = np.asarray(spec.get("box")).reshape(2, 3)
        inside = np.all((c >= box[0]) & (c <= box[1]), axis=1)
        ori = np.asarray(spec.get("orientation", (0.0, 0.0, 1.0)),
                         dtype=float).reshape(3)
        ori = ori / max(np.linalg.norm(ori), 1e-30)
        mur[inside] = float(spec.get("mur", 1.0))
        M[inside] = float(spec.get("Mr", 0.0)) * ori
    return _tensor(mesh, mur), _tensor(mesh, M)


def magnetic_foam(case, max_steps: Optional[int] = None) -> None:
    """magneticFoam (electromagnetics/magneticFoam): magnetostatics by the
    scalar potential psi,

        laplacian(murf, psi) == div(murf * M . Sf),  H = -grad(psi),
        B = mu0 (mur H + M),

    with nNonOrthogonalCorrectors + 1 psi solves (SIMPLE dict); the
    magnets come from `_magnets`. Logs max|B|."""
    from ..core.dimensions import dimless
    from ..ops import fvc, fvm, slot as slot_mod, surface
    from . import linear

    mesh = case.mesh
    mu0 = 4.0e-7 * np.pi
    mur, M = _magnets(case, mesh)
    psi = case.read_field("psi")
    psi_ctl = case.solver_controls("psi")
    n_non_orth = int(case.pimple_controls("SIMPLE").get(
        "nNonOrthogonalCorrectors", 0))
    corrected = case.laplacian_corrected()

    def solve_psi(psi):
        mur_slot = slot_mod.interpolate(mesh, mur,
                                        bv=surface.owner_to_b(mesh, mur))
        # div(murf * M_f . Sf), the remanence source: the magnets are
        # interior bodies, so its boundary flux is zero
        m_flux = slot_mod.flux_of(
            mesh, M, bv=mesh.v.new_zeros(mesh.n_boundary_faces))
        mflux = slot_mod.SlotFace(mur_slot.sv * m_flux.sv,
                                  mur_slot.fb * m_flux.fb, m_flux.bv)
        src = slot_mod.surface_sum(mesh, mflux)
        eqn = fvm.laplacian(mesh, slot_mod.to_flat(mesh, mur_slot), psi,
                            corrected=corrected, gamma_dims=dimless,
                            gamma_slot=mur_slot)
        eqn = eqn.replace_fields(source=eqn.source + src)
        eqn, ctl = linear.prep_pressure(
            eqn, piso_mod.needs_reference(psi, mesh), dict(psi_ctl), 0, 0.0)
        data, perf = linear.solve(mesh, eqn, psi.data, ctl)
        psi = psi.with_data(data).correct_boundary_conditions(mesh)
        # div(B) = 0 with B = mu0 (mur H + M) and H = -grad(psi)
        H = -fvc.grad(mesh, psi)
        return psi, H, mu0 * (mur[:, None] * H + M), perf

    for _ in range(max(n_non_orth, 0) + 1):
        psi, H, B, perf = solve_psi(psi)
        log.info(log.solver_line("psi", perf))
    case.write_fields([psi])
    case.final_state = {"psi": psi, "H": H, "B": B}
    log.info(f"max|B| = {float(torch.max(torch.linalg.norm(B, dim=1))):.6g}\n")
    log.info("End\n")


def _fixed_steps(case, max_steps):
    """The number of steps of the fixed-deltaT loops (mhdFoam and the
    solid solvers): endTime/deltaT, capped by max_steps."""
    t = case.time
    max_iter = max(int(round((t.end_time - t.start_time) / t.delta_t)), 1)
    return min(max_iter, max_steps) if max_steps is not None else max_iter


def mhd_foam(case, max_steps: Optional[int] = None) -> None:
    """mhdFoam (electromagnetics/mhdFoam): incompressible MHD, solvers/mhd.py.
    constant/transportProperties: nu, rho, mu (magnetic permeability),
    sigma (conductivity); fields U, p, B (Alfven-velocity units), pB."""
    from . import mhd as mhd_mod

    mesh = case.mesh
    tp = case.transport_properties()
    cdict = case.pimple_controls("PISO")
    cfg = mhd_mod.MhdConfig(
        nu=_dim_scalar_of(tp, "nu", 1e-6),
        rho=_dim_scalar_of(tp, "rho", 1.0),
        mu_mag=_dim_scalar_of(tp, "mu", 1.0),
        sigma_c=_dim_scalar_of(tp, "sigma", 1.0),
        n_correctors=int(cdict.get("nCorrectors", 2)),
        n_non_orth=int(cdict.get("nNonOrthogonalCorrectors", 0)),
        corrected=case.laplacian_corrected(),
        p_controls=case.solver_controls("p"),
        u_controls=case.solver_controls("U"),
        pb_controls=case.solver_controls("pB")
        if _has_solver(case, "pB") else None)
    state = mhd_mod.initial_state(mesh, case.read_field("U"),
                                  case.read_field("p"), case.read_field("B"),
                                  case.read_field("pB"))
    step = mhd_mod.make_step(mesh, cfg)
    log.info(f"Starting loop: mhdFoam, {mesh.n_cells} cells\n")
    cumulative = 0.0
    t = case.time
    max_iter = _fixed_steps(case, max_steps)
    dt = t.delta_t

    def write(state):
        case.write_fields([state["U"], state["p"], state["B"],
                           state["pB"]])

    while (t.index < max_iter and not t.stop_now
           and t.value < t.end_time - 1e-12):
        state, diag = step(state, dt)
        t.index += 1
        t.value = t.start_time + t.index * t.delta_t
        t.current_dt = float(dt)
        cumulative = _log_step(case, t, diag, cumulative)
        log.info(log.solver_line("Bx", diag["Bx"]))
        if t.write_time():
            write(state)
    write(state)
    log.info("End\n")
    case.final_state = state


def shallow_water_foam(case, max_steps: Optional[int] = None) -> None:
    """shallowWaterFoam (shallowWater/shallowWaterFoam): solvers/
    shallowwater.py. constant/gravitationalProperties (magg, rotating,
    Omega), 0/h, 0/hU and the optional bed 0/h0; deltaT follows the
    Courant number when the controlDict asks."""
    from . import shallowwater as sw_mod

    mesh = case.mesh
    try:
        gp = case.properties("gravitationalProperties")
    except OSError:
        gp = FoamDict()
    magg = _dim_scalar_of(gp, "magg", 9.81)
    rotating = str(gp.get("rotating", "no")) in ("yes", "true", "on")
    om = gp.get("Omega")
    omega = (0.0, 0.0, 0.0)
    if isinstance(om, list):
        v = np.asarray(om[-1] if isinstance(om[-1], (list, np.ndarray))
                       else om, dtype=float).reshape(-1)[-3:]
        omega = (float(v[0]), float(v[1]), float(v[2]))
    h = case.read_field("h")
    hU = case.read_field("hU")
    try:
        h0 = case.read_field("h0").data
    except OSError:
        h0 = mesh.v.new_zeros(mesh.n_cells)
    pdict = case.pimple_controls("PIMPLE")
    cfg = sw_mod.ShallowWaterConfig(
        g=magg, rotating=rotating, omega=omega,
        n_outer=int(pdict.get("nOuterCorrectors", 1)),
        n_correctors=int(pdict.get("nCorrectors", 2)),
        n_non_orth=int(pdict.get("nNonOrthogonalCorrectors", 0)),
        div_scheme=case.div_scheme("div(phiv,hU)"),
        h_controls=case.solver_controls("h"),
        hu_controls=case.solver_controls("hU"),
    )
    state = sw_mod.initial_state(mesh, h, hU, h0)
    step = sw_mod.make_step(mesh, cfg)
    log.info(f"Starting loop: shallowWaterFoam, {mesh.n_cells} cells\n")
    cumulative = 0.0
    for t in case.time.loop():
        state, diag = step(state, t.current_dt)
        cumulative = _log_step(case, t, diag, cumulative)
        t.adjust_delta_t(float(diag["courant_max"]))
        if t.write_time():
            case.write_fields([state["h"], state["hU"], state["U"]])
        if max_steps is not None and t.index >= max_steps:
            break
    case.write_fields([state["h"], state["hU"], state["U"]])
    log.info("End\n")
    case.final_state = state


def _traction(case, mesh, rho):
    """Per patch (traction, pressure) / rho of the tractionDisplacement
    patches of the raw 0/D boundaryField, None elsewhere (in the field's
    precision, as the reference parses them)."""
    from ..bc.factory import parse_value

    raw = parse_file(os.path.join(case.dir, "0", "D"))
    bf = raw.get("boundaryField", FoamDict())
    out = []
    for patch in mesh.patches:
        spec = bf.get(patch.name) if isinstance(bf, FoamDict) else None
        if (isinstance(spec, FoamDict)
                and str(spec.get("type")) == "tractionDisplacement"):
            tv = parse_value(spec.get("traction"), patch.size, 1,
                             mesh.v.dtype)
            pv = parse_value(spec.get("pressure"), patch.size, 0,
                             mesh.v.dtype)
            tv = np.zeros(3) if tv is None else tv.numpy().astype(float)
            pv = 0.0 if pv is None else pv.numpy().astype(float)
            out.append((tv / rho, pv / rho))
        else:
            out.append(None)
    return tuple(out)


def _solid_run(case, steady: bool, max_steps: Optional[int]) -> None:
    """solidDisplacementFoam / solidEquilibriumDisplacementFoam
    (stressAnalysis/): solvers/soliddisplacement.py. The steady one stops
    when the first D solve's initial residual falls below the
    stressAnalysis dict's D tolerance. thermalStress yes raises."""
    from . import soliddisplacement as sd_mod

    mesh = case.mesh
    mp = case.properties("mechanicalProperties")
    rho = _dim_scalar_of(mp, "rho", 7854.0)
    E = _dim_scalar_of(mp, "E", 2e11)
    nu = _dim_scalar_of(mp, "nu", 0.3)
    plane_stress = str(mp.get("planeStress", "no")) in _TRUE
    try:
        thp = case.properties("thermalProperties")
    except OSError:
        thp = FoamDict()
    if str(thp.get("thermalStress", "no")) in ("yes", "true", "on"):
        raise NotImplementedError(
            "thermalStress coupling not implemented yet (as in the "
            "reference)")
    D = case.read_field("D")
    sdict = case.pimple_controls("stressAnalysis")
    cfg = sd_mod.SolidConfig(
        rho=rho, E=E, nu=nu, plane_stress=plane_stress, steady=steady,
        n_corr=max(int(sdict.get("nCorrectors", 1)), 1),
        tolerance=float(sdict.get("D", 1e-6)),
        d_controls=case.solver_controls("D"),
        traction=_traction(case, mesh, rho))
    state = sd_mod.initial_state(mesh, D, steady=steady)
    step = sd_mod.make_step(mesh, cfg)
    name = ("solidEquilibriumDisplacementFoam" if steady
            else "solidDisplacementFoam")
    log.info(f"Starting loop: {name}, {mesh.n_cells} cells\n")
    t = case.time
    max_iter = _fixed_steps(case, max_steps)
    dt = 1.0 if steady else t.delta_t
    while (t.index < max_iter and not t.stop_now
           and t.value < t.end_time - 1e-12):
        state, diag = step(state, dt)
        t.index += 1
        t.value = t.start_time + t.index * t.delta_t
        t.current_dt = float(dt)
        log.info(f"Time = {t.name}\n")
        log.info(log.solver_line("Dx", diag["D"]))
        if t.write_time():
            case.write_fields([state["D"]])
        res = float(torch.max(torch.as_tensor(
            diag["D"].initial_residual)))
        if steady and res < cfg.tolerance:
            log.info(f"Converged in {t.index} iterations\n")
            break
    case.write_fields([state["D"]])
    log.info("End\n")
    case.final_state = state


def solid_displacement_foam(case, max_steps: Optional[int] = None):
    _solid_run(case, steady=False, max_steps=max_steps)


def solid_equilibrium_displacement_foam(case,
                                        max_steps: Optional[int] = None):
    _solid_run(case, steady=True, max_steps=max_steps)


def potential_free_surface_foam(case, max_steps: Optional[int] = None
                                ) -> None:
    """potentialFreeSurfaceFoam (multiphase/potentialFreeSurfaceFoam):
    pisoFoam with the waveSurfacePressure free surface,
    solvers/potentialfreesurface.py. The free-surface patch is the one
    whose p_gh (or p) boundary type is waveSurfacePressure, else a patch
    named freeSurface."""
    from . import potentialfreesurface as pfs_mod

    mesh = case.mesh
    _, nu = dimensioned_scalar(case.transport_properties()["nu"])
    pname = "p_gh" if os.path.exists(os.path.join(case.dir, "0",
                                                  "p_gh")) else "p"
    raw = parse_file(os.path.join(case.dir, "0", pname))
    bf = raw.get("boundaryField", FoamDict())
    fs_idx = None
    for i, p in enumerate(mesh.patches):
        ent = bf.get(p.name)
        if (isinstance(ent, FoamDict)
                and str(ent.get("type")) == "waveSurfacePressure"):
            fs_idx = i
            break
    if fs_idx is None:
        for i, p in enumerate(mesh.patches):
            if p.name == "freeSurface":
                fs_idx = i
                break
    if fs_idx is None:
        raise ValueError("potentialFreeSurfaceFoam: no "
                         "waveSurfacePressure patch found")
    g = _read_gravity(case)
    pdict = case.pimple_controls("PIMPLE")
    flow = piso_mod.PisoConfig(
        nu=nu,
        n_correctors=int(pdict.get("nCorrectors", 2)),
        n_non_orth=int(pdict.get("nNonOrthogonalCorrectors", 0)),
        p_controls=case.solver_controls(pname))
    cfg = pfs_mod.FreeSurfaceConfig(
        flow=flow, fs_patch=fs_idx,
        g_mag=float(np.linalg.norm(np.asarray(g))))
    state = pfs_mod.initial_state(mesh, case.read_field("U"),
                                  case.read_field(pname), cfg)
    step = pfs_mod.make_step(mesh, cfg)
    log.info("Starting loop: potentialFreeSurfaceFoam\n")
    diag = None
    for t in case.time.loop():
        state, diag = step(state, t.current_dt)
        log.info(f"Time = {t.name}\nzeta: min = "
                 f"{float(diag['zeta_min']):.6g} max = "
                 f"{float(diag['zeta_max']):.6g}\n")
        if t.write_time():
            case.write_fields([state["U"], state["p"]])
        if max_steps is not None and t.index >= max_steps:
            break
    case.write_fields([state["U"], state["p"]])
    case.final_state = {"state": state, "diag": diag}
    log.info("End\n")


def adjoint_shape_optimization_foam(case,
                                    max_steps: Optional[int] = None
                                    ) -> None:
    """adjointShapeOptimizationFoam (incompressible/
    adjointShapeOptimizationFoam): primal and adjoint SIMPLE with a
    porosity design variable, solvers/adjoint.py. lambda and alphaMax
    from constant/transportProperties; Ua and pa from the case, else zero
    with default BCs; alpha held at zero in the cells next to the inlet
    patches (a `patch` whose name holds "in")."""
    from ..core.fields import vol_scalar, vol_vector
    from . import adjoint as adj_mod

    mesh = case.mesh
    tp = case.transport_properties()
    _, nu = dimensioned_scalar(tp["nu"])
    relax = _relaxation(case)
    flow = simple_mod.SimpleConfig(
        nu=nu,
        alpha_u=float(relax.get("U", 0.7)),
        alpha_p=float(relax.get("p", 0.3)),
        p_controls=case.solver_controls("p"),
        u_controls=case.solver_controls("U"))
    U = case.read_field("U")
    p = case.read_field("p")
    try:
        Ua = case.read_field("Ua")
        pa = case.read_field("pa")
    except Exception:
        Ua = vol_vector(mesh, (0.0, 0.0, 0.0), name="Ua")
        pa = vol_scalar(mesh, 0.0, name="pa")
    owner = mesh.owner.detach().cpu().numpy()
    inlet_cells = [np.unique(owner[pt.slice]) for pt in mesh.patches
                   if pt.type == "patch" and "in" in pt.name.lower()]
    zc = (torch.as_tensor(np.concatenate(inlet_cells), dtype=torch.int64,
                          device=mesh.device) if inlet_cells else None)
    cfg = adj_mod.AdjointConfig(
        flow=flow,
        lam=_dim_scalar_of(tp, "lambda", 1e5),
        alpha_max=_dim_scalar_of(tp, "alphaMax", 200.0),
        zero_alpha_cells=zc)
    state = adj_mod.initial_state(mesh, U, p, Ua, pa, cfg)
    step = adj_mod.make_step(mesh, cfg)
    log.info("Starting loop: adjointShapeOptimizationFoam\n")
    diag = None
    for t in case.time.loop():
        state, diag = step(state)
        log.info(f"Time = {t.name}\nobjective = "
                 f"{float(diag['objective']):.6g}  alpha_max = "
                 f"{float(diag['alpha_max_val']):.4g}\n")
        if t.write_time():
            alpha_f = vol_scalar(mesh, 0.0, name="alpha").with_data(
                state["alpha"])
            case.write_fields([state["U"], state["p"], state["Ua"],
                               state["pa"], alpha_f])
        if max_steps is not None and t.index >= max_steps:
            break
    case.final_state = {"state": state, "diag": diag}
    log.info("End\n")


def dns_forcing(mesh, seed: int = 1):
    """dnsFoam's forcing: an Ornstein-Uhlenbeck process
    (models/randomprocesses.UOProcess, alpha 0.81, sigma 0.09) on the 26
    modes of the first wavenumber shell of the box, each projected
    divergence-free, summed on the host into a body force [nC,3] per
    step (forceGen = Kmesh + UOprocess). Returns dt -> force (numpy)."""
    from ..models import randomprocesses as rp

    c = mesh.c.detach().cpu().numpy()
    lo, hi = c.min(axis=0), c.max(axis=0)
    L = np.maximum(hi - lo, 1e-30)
    k1 = 2 * np.pi / L
    kvecs = np.asarray([[kx * k1[0], ky * k1[1], kz * k1[2]]
                        for kx in (-1, 0, 1) for ky in (-1, 0, 1)
                        for kz in (-1, 0, 1) if (kx, ky, kz) != (0, 0, 0)])
    uo = rp.UOProcess(len(kvecs), alpha=0.81, sigma=0.09, seed=seed)
    phase = c @ kvecs.T                       # [nC, nK]
    cosk = np.cos(phase)
    sink = np.sin(phase)
    khat = kvecs / np.linalg.norm(kvecs, axis=1, keepdims=True)

    def force(dt):
        w = uo.update(dt)                     # [nK,3] complex
        # each mode divergence-free: w -= (w.khat) khat
        w = (w - khat * np.einsum("kd,kd->k", w.real, khat)[:, None]
             - 1j * khat * np.einsum("kd,kd->k", w.imag, khat)[:, None])
        return cosk @ w.real + sink @ w.imag  # [nC,3]

    return force


def dns_foam(case, max_steps: Optional[int] = None) -> None:
    """dnsFoam (DNS/dnsFoam): isotropic box turbulence, icoFoam's PISO
    step plus the host forcing of `dns_forcing`, added as U += dt f after
    each step (explicit, as the reference adds the force). Logs the
    kinetic energy k each step."""
    mesh = case.mesh
    _, nu = dimensioned_scalar(case.transport_properties()["nu"])
    pdict = case.pimple_controls("PISO")
    cfg = piso_mod.PisoConfig(
        nu=nu,
        n_correctors=int(pdict.get("nCorrectors", 2)),
        n_non_orth=int(pdict.get("nNonOrthogonalCorrectors", 0)),
        div_scheme=case.div_scheme("div(phi,U)"),
        p_controls=case.solver_controls("p"),
        u_controls=case.solver_controls("U"),
    )
    state = piso_mod.initial_state(mesh, case.read_field("U"),
                                   case.read_field("p"), ddt_scheme="Euler")
    step = piso_mod.make_step(mesh, cfg)
    force = dns_forcing(mesh)
    log.info(f"Starting time loop: dnsFoam, {mesh.n_cells} cells\n")
    cumulative = 0.0
    for t in case.time.loop():
        dt = piso_mod._as_scalar(mesh, t.current_dt)
        state, diag = step(state, dt)
        f = _tensor(mesh, force(float(t.current_dt)))
        state = dict(state)
        state["U"] = state["U"].with_data(state["U"].data + dt * f)
        cumulative = _log_step(case, t, diag, cumulative)
        k_tke = 0.5 * float(torch.mean(torch.sum(state["U"].data ** 2,
                                                 dim=1)))
        log.info(f"k = {k_tke:.6g}\n")
        if t.write_time():
            _write_state(case, state)
        if max_steps is not None and t.index >= max_steps:
            break
    _write_state(case, state)
    log.info("End\n")
    case.final_state = state


# ---------------------------------------------------------------------------
# the multiphase family: cavitatingFoam / sonicLiquidFoam, settlingFoam,
# interMixingFoam, interPhaseChangeFoam, (MRF)multiphaseInterFoam,
# twoLiquidMixingFoam, twoPhaseEulerFoam / bubbleFoam,
# multiphaseEulerFoam, compressibleInterFoam
# ---------------------------------------------------------------------------


def _dt(mesh, value):
    """deltaT as a 0-d tensor of the mesh's dtype, on its device."""
    return torch.tensor(value, dtype=mesh.v.dtype, device=mesh.device)


def _fixed_loop(case, step, state, max_steps, write, log_fn=None):
    """The fixed-deltaT loop of the multiphase drivers: endTime/deltaT
    steps capped by max_steps, `log_fn(t, diag)` before the step's
    standard log lines, `write(state)` at write times and at the end."""
    mesh = case.mesh
    cumulative = 0.0
    t = case.time
    max_iter = _fixed_steps(case, max_steps)
    dt = _dt(mesh, t.delta_t)
    while (t.index < max_iter and not t.stop_now
           and t.value < t.end_time - 1e-12):
        state, diag = step(state, dt)
        t.index += 1
        t.value = t.start_time + t.index * t.delta_t
        t.current_dt = float(dt)
        if log_fn is not None:
            log_fn(t, diag, state)
        cumulative = _log_step(case, t, diag, cumulative)
        if t.write_time():
            write(state)
    write(state)
    log.info("End\n")
    case.final_state = state


def cavitating_foam(case, max_steps: Optional[int] = None,
                    sonic_liquid: bool = False) -> None:
    """cavitatingFoam (multiphase/cavitatingFoam): barotropic
    homogeneous-equilibrium cavitation, solvers/cavitating.py.
    constant/thermodynamicProperties: psil/psiv/rhol0/pSat;
    constant/transportProperties: nul (phase viscosities optional).

    sonic_liquid: sonicLiquidFoam (compressible/sonicLiquidFoam), the
    single-phase limit rho = rho0 + psi (p - p0): rhol0 := rho0 - psi p0
    with the saturation pressure pushed to -1e8 so no vapour ever forms,
    as the reference registers it."""
    from . import cavitating as cav_mod

    mesh = case.mesh
    th = case.properties("thermodynamicProperties")
    tp = case.transport_properties()
    cdict = case.pimple_controls("PIMPLE")
    if sonic_liquid:
        rho0_l = _dim_scalar_of(th, "rho0", 1000.0)
        p0_l = _dim_scalar_of(th, "p0", 1e5)
        psi_l = _dim_scalar_of(th, "psi", 4.54e-7)
        mu_l = _dim_scalar_of(tp, "mu", 1e-3)
        nu_l = _dim_scalar_of(tp, "nu", mu_l / max(rho0_l, 1e-12))
        cfg = cav_mod.CavitatingConfig(
            rhol0=rho0_l - psi_l * p0_l,
            psil=psi_l, psiv=psi_l,
            p_sat=-1e8,            # never cavitates
            rho_min=1e-3,
            nul=nu_l, nuv=nu_l,
            n_outer=int(cdict.get("nOuterCorrectors", 1)),
            n_correctors=int(cdict.get("nCorrectors", 2)),
            n_non_orth=int(cdict.get("nNonOrthogonalCorrectors", 0)),
            corrected=case.laplacian_corrected(),
            p_controls=case.solver_controls("p"),
            u_controls=case.solver_controls("U"))
    else:
        cfg = cav_mod.CavitatingConfig(
            rhol0=_dim_scalar_of(th, "rhol0", 1000.0),
            psil=_dim_scalar_of(th, "psil", 4.54e-7),
            psiv=_dim_scalar_of(th, "psiv", 2.5e-6),
            p_sat=_dim_scalar_of(th, "pSat", 2300.0),
            rho_min=_dim_scalar_of(th, "rhoMin", 0.001),
            nul=_dim_scalar_of(tp, "nul", _dim_scalar_of(tp, "nu", 1e-6)),
            nuv=_dim_scalar_of(tp, "nuv", 4.273e-7),
            n_outer=int(cdict.get("nOuterCorrectors", 2)),
            n_correctors=int(cdict.get("nCorrectors", 2)),
            n_non_orth=int(cdict.get("nNonOrthogonalCorrectors", 0)),
            corrected=case.laplacian_corrected(),
            p_controls=case.solver_controls("p"),
            u_controls=case.solver_controls("U"))
    state = cav_mod.initial_state(mesh, case.read_field("U"),
                                  case.read_field("p"), cfg)
    step = cav_mod.make_step(mesh, cfg)
    log.info(f"Starting loop: cavitatingFoam, {mesh.n_cells} cells\n")

    def log_gamma(t, diag, state):
        log.info(f"Time = {t.name}\n")
        log.info(f"max(gamma) = {float(diag['gamma_max']):.6g}\n")

    _fixed_loop(case, step, state, max_steps,
                lambda st: case.write_fields([st["U"], st["p"]]), log_gamma)


def _looped(case, step, state, max_steps, write, log_fn):
    """The case.time.loop() drivers (settlingFoam, interMixingFoam,
    interPhaseChangeFoam): one log line per step, no solver lines, and
    {"state", "diag"} left in case.final_state, as in the reference."""
    mesh = case.mesh
    diag = None
    for t in case.time.loop():
        state, diag = step(state, _dt(mesh, t.current_dt))
        log_fn(t, diag, state)
        if t.write_time():
            write(state)
        if max_steps is not None and t.index >= max_steps:
            break
    write(state)
    case.final_state = {"state": state, "diag": diag}
    log.info("End\n")


def settling_foam(case, max_steps: Optional[int] = None) -> None:
    """settlingFoam (multiphase/settlingFoam): drift-flux mixture with
    hindered settling, solvers/settling.py, from
    constant/transportProperties (rhoc/rhod/muc, V0/a/a1/alphaMin,
    plasticViscosityCoeff/Exponent)."""
    from . import settling as set_mod

    mesh = case.mesh
    tp = case.transport_properties()
    V0v = tp.get("V0", [0.0, -0.002, 0.0])
    if isinstance(V0v, list) and V0v and isinstance(V0v[-1],
                                                    (list, tuple)):
        V0v = V0v[-1]
    pdict = case.pimple_controls("PIMPLE")
    plast = tp.get("plastic", tp.get("plasticCoeffs", tp))
    cfg = set_mod.SettlingConfig(
        rhoc=_dim_scalar_of(tp, "rhoc", 1000.0),
        rhod=_dim_scalar_of(tp, "rhod", 1042.0),
        muc=_dim_scalar_of(tp, "muc", 1e-3),
        plastic_coeff=_dim_scalar_of(plast, "plasticViscosityCoeff",
                                     0.0),
        plastic_exp=_dim_scalar_of(plast, "plasticViscosityExponent",
                                   0.0),
        vdj_model=str(tp.get("VdjModel", "simple")),
        V0=tuple(float(x) for x in np.asarray(V0v,
                                              float).reshape(-1)[-3:]),
        a=_dim_scalar_of(tp, "a", 8.84),
        a1=_dim_scalar_of(tp, "a1", 0.0),
        alpha_min=_dim_scalar_of(tp, "alphaMin", 0.0),
        g=_read_gravity(case),
        n_correctors=int(pdict.get("nCorrectors", 2)),
        n_non_orth=int(pdict.get("nNonOrthogonalCorrectors", 0)),
        p_controls=case.solver_controls("p_rgh"))
    state = set_mod.initial_state(mesh, case.read_field("U"),
                                  case.read_field("p_rgh"),
                                  case.read_field("alpha"), cfg)
    step = set_mod.make_step(mesh, cfg)
    log.info("Starting loop: settlingFoam\n")

    def log_fn(t, diag, state):
        log.info(f"Time = {t.name}\nDispersed phase fraction = "
                 f"{float(torch.mean(state['alpha'].data)):.6g}\n")

    _looped(case, step, state, max_steps,
            lambda st: case.write_fields([st["U"], st["p_rgh"],
                                          st["alpha"]]), log_fn)


def inter_mixing_foam(case, max_steps: Optional[int] = None) -> None:
    """interMixingFoam (multiphase/interMixingFoam): three phases from
    transportProperties (phase1 = air immiscible, phase2/phase3 miscible
    liquids with diffusivity D23), solvers/intermixing.py."""
    from . import interfoam as inter_mod
    from . import intermixing as imx_mod

    mesh = case.mesh
    tp = case.transport_properties()
    (nu1, rho1), (nu2, rho2), (nu3, rho3) = _phases(
        tp, "phase1", "phase2", "phase3")
    _, sigma = dimensioned_scalar(tp.get("sigma", 0.0))
    pdict = case.pimple_controls("PIMPLE")
    flow = inter_mod.InterConfig(
        rho1=rho1, rho2=rho2, nu1=nu1, nu2=nu2, sigma=sigma,
        g=_read_gravity(case),
        c_alpha=float(pdict.get("cAlpha", 1.0)),
        n_correctors=int(pdict.get("nCorrectors", 3)),
        n_non_orth=int(pdict.get("nNonOrthogonalCorrectors", 0)),
        p_controls=case.solver_controls("p_rgh"))
    cfg = imx_mod.InterMixingConfig(
        flow=flow, rho3=rho3, nu3=nu3,
        D23=_dim_scalar_of(tp, "D23", 3e-9))
    state = imx_mod.initial_state(
        mesh, case.read_field("U"), case.read_field("p_rgh"),
        case.read_field("alpha1"), case.read_field("alpha2"), cfg)
    step = imx_mod.make_step(mesh, cfg)
    log.info("Starting loop: interMixingFoam\n")

    def log_fn(t, diag, state):
        log.info(f"Time = {t.name}\nAir phase volume fraction = "
                 f"{float(torch.mean(state['alpha1'].data)):.6g}  "
                 f"Liquid A = "
                 f"{float(torch.mean(state['alpha2'].data)):.6g}\n")

    _looped(case, step, state, max_steps,
            lambda st: case.write_fields([st["U"], st["p_rgh"],
                                          st["alpha1"], st["alpha2"]]),
            log_fn)


def inter_phase_change_foam(case, max_steps: Optional[int] = None
                            ) -> None:
    """interPhaseChangeFoam (multiphase/interPhaseChangeFoam): VOF with
    cavitation mass transfer, solvers/interphasechange.py.
    transportProperties carries phase1/phase2, sigma and
    phaseChangeTwoPhaseMixture (SchnerrSauer/Kunz/Merkle) with its coeffs
    dict; pSat from the top level or the coeffs."""
    from . import interfoam as inter_mod
    from . import interphasechange as ipc_mod

    mesh = case.mesh
    tp = case.transport_properties()
    (nu1, rho1), (nu2, rho2) = _phases(tp, "phase1", "phase2")
    _, sigma = dimensioned_scalar(tp.get("sigma", 0.0))
    model = str(tp.get("phaseChangeTwoPhaseMixture", "SchnerrSauer"))
    coeffs = tp.get(model + "Coeffs", FoamDict())
    p_sat = _dim_scalar_of(tp, "pSat", _dim_scalar_of(coeffs, "pSat",
                                                      2300.0))
    pdict = case.pimple_controls("PIMPLE")
    flow = inter_mod.InterConfig(
        rho1=rho1, rho2=rho2, nu1=nu1, nu2=nu2, sigma=sigma,
        g=_read_gravity(case),
        c_alpha=float(pdict.get("cAlpha", 1.0)),
        n_alpha_subcycles=int(pdict.get("nAlphaSubCycles", 1)),
        n_correctors=int(pdict.get("nCorrectors", 3)),
        n_non_orth=int(pdict.get("nNonOrthogonalCorrectors", 0)),
        p_controls=case.solver_controls("p_rgh"))
    cfg = ipc_mod.PhaseChangeConfig(
        flow=flow, model=model, p_sat=p_sat,
        n_bubbles=_dim_scalar_of(coeffs, "n", 1.6e13),
        d_nuc=_dim_scalar_of(coeffs, "dNuc", 2.0e-6),
        Cc=_dim_scalar_of(coeffs, "Cc", 1.0),
        Cv=_dim_scalar_of(coeffs, "Cv", 1.0),
        U_inf=_dim_scalar_of(coeffs, "UInf", 20.0),
        t_inf=_dim_scalar_of(coeffs, "tInf", 0.005))
    state = ipc_mod.initial_state(mesh, case.read_field("U"),
                                  case.read_field("p_rgh"),
                                  _read_alpha1(case), cfg)
    step = ipc_mod.make_step(mesh, cfg)
    log.info(f"Starting loop: interPhaseChangeFoam ({model})\n")

    def log_fn(t, diag, state):
        log.info(f"Time = {t.name}\n")
        log.info(f"Liquid phase volume fraction = "
                 f"{float(torch.mean(state['alpha'].data)):.6g}  "
                 f"Min(alpha1) = {float(diag['alpha_min']):.4g}  "
                 f"Max(alpha1) = {float(diag['alpha_max']):.4g}\n")

    _looped(case, step, state, max_steps,
            lambda st: case.write_fields([st["U"], st["p_rgh"],
                                          st["alpha"]]), log_fn)


def _p_rgh_controls(case):
    return (case.solver_controls("p_rgh") if _has_solver(case, "p_rgh")
            else case.solver_controls("p"))


def phase_fractions(case, names):
    """The [nC, nP] fraction field of the N-phase solvers: 0/alpha<name>
    per phase, stacked, carrying the first phase's scalar BCs (each
    column is evaluated as a scalar field), as the reference builds it;
    with the per-phase fields for writing."""
    from ..core.fields import VolField

    flds = [case.read_field(f"alpha{n}") for n in names]
    A = torch.stack([f.data for f in flds], dim=1)
    return VolField(data=A, bcs=flds[0].bcs, name="alphas"), flds


def _alpha_columns(flds, names, A):
    return [dataclasses.replace(flds[i], data=A[:, i], name=f"alpha{n}")
            for i, n in enumerate(names)]


def multiphase_inter_foam(case, max_steps: Optional[int] = None) -> None:
    """multiphaseInterFoam (multiphase/multiphaseInterFoam): N immiscible
    phases with pairwise MULES compression, solvers/multiphaseinter.py.
    Phases from constant/transportProperties `phases (name1 name2 ...)`
    with per-phase subdicts {rho, nu} and `sigmas ((a b s) ...)`;
    fractions from 0/alpha<name>. constant/MRFZones, where the case has
    one, adds the rotating zones (MRFMultiphaseInterFoam)."""
    from . import multiphaseinter as mpi_mod

    mesh = case.mesh
    tp = case.transport_properties()
    names = [str(x) for x in tp.get("phases", [])]
    if not names:
        raise ValueError("multiphaseInterFoam needs transportProperties"
                         " `phases (...)`")
    rhos, nus = [], []
    for n in names:
        ph = tp.get(n, FoamDict())
        rhos.append(_dim_scalar_of(ph, "rho", 1000.0))
        nus.append(_dim_scalar_of(ph, "nu", 1e-6))
    sigmas = {}
    for row in tp.get("sigmas", []) or []:
        try:
            arr = np.asarray(row, dtype=float).ravel()
            if arr.size == 3:
                sigmas[(int(arr[0]), int(arr[1]))] = float(arr[2])
        except (TypeError, ValueError):
            continue
    alphas, flds = phase_fractions(case, names)
    cdict = case.pimple_controls("PIMPLE")
    cfg = mpi_mod.MultiphaseConfig(
        rhos=tuple(rhos), nus=tuple(nus), sigmas=sigmas,
        g=_read_gravity(case),
        c_alpha=float(cdict.get("cAlpha", 1.0)),
        n_correctors=int(cdict.get("nCorrectors", 3)),
        n_non_orth=int(cdict.get("nNonOrthogonalCorrectors", 0)),
        corrected=case.laplacian_corrected(),
        p_controls=_p_rgh_controls(case),
        u_controls=case.solver_controls("U"),
        mrf=_load_mrf(case))
    state = mpi_mod.initial_state(mesh, case.read_field("U"),
                                  case.read_field("p_rgh"), alphas, cfg)
    step = mpi_mod.make_step(mesh, cfg)
    log.info(f"Starting loop: multiphaseInterFoam, {mesh.n_cells} "
             f"cells, phases {names}\n")

    def write(state):
        case.write_fields([state["U"], state["p_rgh"]] + _alpha_columns(
            flds, names, state["alphas"].data))

    _fixed_loop(case, step, state, max_steps, write)


def two_liquid_mixing_foam(case, max_steps: Optional[int] = None) -> None:
    """twoLiquidMixingFoam (multiphase/twoLiquidMixingFoam): two miscible
    incompressible liquids, solvers/twoliquidmixing.py. Phase properties
    from constant/transportProperties phase1/phase2 (rho, nu) and Dab.
    The alpha solve takes the controls fvSolution gives "alpha" (none in
    mixingColumn, whose key is "(U|alpha1)": the step's default)."""
    from . import twoliquidmixing as tlm_mod

    mesh = case.mesh
    tp = case.transport_properties()
    ph1 = tp.get("phase1", FoamDict())
    ph2 = tp.get("phase2", FoamDict())
    cdict = case.pimple_controls("PIMPLE")
    cfg = tlm_mod.TwoLiquidConfig(
        rho1=_dim_scalar_of(ph1, "rho", 1010.0),
        rho2=_dim_scalar_of(ph2, "rho", 1000.0),
        nu1=_dim_scalar_of(ph1, "nu", 1e-6),
        nu2=_dim_scalar_of(ph2, "nu", 1e-6),
        Dab=_dim_scalar_of(tp, "Dab", 1e-6),
        g=_read_gravity(case),
        n_correctors=int(cdict.get("nCorrectors", 3)),
        n_non_orth=int(cdict.get("nNonOrthogonalCorrectors", 0)),
        corrected=case.laplacian_corrected(),
        p_controls=_p_rgh_controls(case),
        u_controls=case.solver_controls("U"),
        a_controls=case.solver_controls("alpha")
        if _has_solver(case, "alpha") else None,
    )
    try:
        alpha = case.read_field("alpha")
    except Exception:
        alpha = case.read_field("alpha1")
    state = tlm_mod.initial_state(mesh, case.read_field("U"),
                                  case.read_field("p_rgh"), alpha, cfg)
    step = tlm_mod.make_step(mesh, cfg)
    log.info(f"Starting loop: twoLiquidMixingFoam, "
             f"{mesh.n_cells} cells\n")
    _fixed_loop(case, step, state, max_steps,
                lambda st: case.write_fields([st["U"], st["p_rgh"],
                                              st["alpha"]]))


def two_phase_euler_foam(case, max_steps: Optional[int] = None) -> None:
    """twoPhaseEulerFoam and bubbleFoam (multiphase/twoPhaseEulerFoam):
    Euler-Euler two-phase flow with Schiller-Naumann drag,
    solvers/twophaseeuler.py. Phase properties from
    constant/transportProperties `phasea`/`phaseb` (rho, nu, d);
    constant/interfacialProperties is accepted, and only SchillerNaumann
    is implemented, as in the reference."""
    from . import twophaseeuler as tpe_mod

    mesh = case.mesh
    cfg = two_phase_euler_config(case)
    state = tpe_mod.initial_state(mesh, case.read_field("Ua"),
                                  case.read_field("Ub"),
                                  case.read_field("p"),
                                  case.read_field("alpha"))
    step = tpe_mod.make_step(mesh, cfg)
    log.info(f"Starting loop: twoPhaseEulerFoam, {mesh.n_cells} cells\n")

    def log_fn(t, diag, state):
        log.info(f"Time = {t.name}\n")
        log.info(
            f"Min(alpha) = {float(diag['alpha_min']):.6g}  "
            f"Max(alpha) = {float(diag['alpha_max']):.6g}\n")

    _fixed_loop(case, step, state, max_steps,
                lambda st: case.write_fields([st["Ua"], st["Ub"], st["p"],
                                              st["alpha"]]), log_fn)


def two_phase_euler_config(case):
    """twoPhaseEulerFoam's TwoPhaseConfig from the case: phasea / phaseb
    of transportProperties, g, the PIMPLE dict and the p and U (or Ua)
    controls."""
    from . import twophaseeuler as tpe_mod

    tp = case.transport_properties()
    pa = tp.get("phasea", tp.get("phase1", FoamDict()))
    pb = tp.get("phaseb", tp.get("phase2", FoamDict()))
    cdict = case.pimple_controls("PIMPLE")
    return tpe_mod.TwoPhaseConfig(
        rhoa=_dim_scalar_of(pa, "rho", 1.2),
        rhob=_dim_scalar_of(pb, "rho", 1000.0),
        nua=_dim_scalar_of(pa, "nu", 1.5e-5),
        nub=_dim_scalar_of(pb, "nu", 1e-6),
        d_a=_dim_scalar_of(pa, "d", 3e-3),
        g=_read_gravity(case),
        n_correctors=int(cdict.get("nCorrectors", 2)),
        n_non_orth=int(cdict.get("nNonOrthogonalCorrectors", 0)),
        corrected=case.laplacian_corrected(),
        p_ref_cell=int(cdict.get("pRefCell", 0)),
        p_ref_value=float(cdict.get("pRefValue", 0.0)),
        p_controls=case.solver_controls("p"),
        u_controls=case.solver_controls("U")
        if _has_solver(case, "U") else case.solver_controls("Ua"),
    )


def multiphase_euler_phases(tp):
    """(names, rhos, nus, ds) of multiphaseEulerFoam's phases, in either
    layout: inline subdicts inside the `phases` list, or a bare name list
    with top-level per-phase subdicts."""
    raw = tp.get("phases", [])
    names, rhos, nus, ds = [], [], [], []
    idx = 0
    while idx < len(raw):
        n = str(raw[idx])
        if idx + 1 < len(raw) and isinstance(raw[idx + 1],
                                             (dict, FoamDict)):
            ph = raw[idx + 1]
            idx += 2
        else:
            ph = tp.get(n, FoamDict())
            idx += 1
        names.append(n)
        rhos.append(_dim_scalar_of(ph, "rho", 1000.0))
        nus.append(_dim_scalar_of(ph, "nu", 1e-6))
        d_val = ph.get("d", None)
        if d_val is None:
            cc = ph.get("constantCoeffs", FoamDict())
            d_val = cc.get("d", 1e-3)
        _, d_num = dimensioned_scalar(d_val)
        ds.append(d_num)
    return names, rhos, nus, ds


def multiphase_euler_foam(case, max_steps: Optional[int] = None) -> None:
    """multiphaseEulerFoam (multiphase/multiphaseEulerFoam): N
    interpenetrating phases, each with its own velocity, pairwise blended
    drag and a shared pressure, solvers/multiphaseeuler.py. Phases from
    constant/transportProperties (multiphase_euler_phases); fractions from
    0/alpha<name>, velocities from 0/U<name> (else a shared 0/U)."""
    from . import multiphaseeuler as mpe_mod

    mesh = case.mesh
    tp = case.transport_properties()
    names, rhos, nus, ds = multiphase_euler_phases(tp)
    if not names:
        raise ValueError("multiphaseEulerFoam needs transportProperties"
                         " `phases (...)`")
    alphas, flds = phase_fractions(case, names)
    Us = []
    for n in names:
        try:
            Us.append(case.read_field(f"U{n}"))
        except Exception:
            Us.append(case.read_field("U"))
    p = case.read_field("p")
    cdict = case.pimple_controls("PIMPLE")
    cfg = mpe_mod.MultiphaseEulerConfig(
        rhos=tuple(rhos), nus=tuple(nus), ds=tuple(ds),
        g=_read_gravity(case),
        n_correctors=int(cdict.get("nCorrectors", 2)),
        n_non_orth=int(cdict.get("nNonOrthogonalCorrectors", 0)),
        corrected=case.laplacian_corrected(),
        p_ref_cell=int(cdict.get("pRefCell", 0)),
        p_ref_value=float(cdict.get("pRefValue", 0.0)),
        p_controls=case.solver_controls("p"),
        u_controls=case.solver_controls("U")
        if _has_solver(case, "U") else None)
    state = mpe_mod.initial_state(mesh, Us, p, alphas)
    step = mpe_mod.make_step(mesh, cfg)
    log.info(f"Starting loop: multiphaseEulerFoam, {mesh.n_cells} "
             f"cells, phases {names}\n")

    def write(state):
        fields = [state["p"]]
        for i, (a, n) in enumerate(zip(_alpha_columns(
                flds, names, state["alphas"].data), names)):
            fields.append(a)
            fields.append(dataclasses.replace(state[f"U{i}"],
                                              name=f"U{n}"))
        case.write_fields(fields)

    _fixed_loop(case, step, state, max_steps, write)


def compressible_inter_foam(case, max_steps: Optional[int] = None) -> None:
    """compressibleInterFoam (multiphase/compressibleInterFoam): two
    compressible phases and a MULES VOF interface,
    solvers/compressibleinter.py. Phase EOS from
    constant/thermophysicalProperties `phase1` (perfectGas: R, Cv, nu) /
    `phase2` (perfectFluid: R, rho0, Cv, nu); sigma and g from
    constant/{transportProperties,g}."""
    from . import compressibleinter as ci_mod

    mesh = case.mesh
    th = case.properties("thermophysicalProperties")
    ph1 = th.get("phase1", FoamDict())
    ph2 = th.get("phase2", FoamDict())
    tp = case.transport_properties()
    _, sigma = dimensioned_scalar(tp.get("sigma", 0.07))
    cdict = case.pimple_controls("PIMPLE")
    p_min = th.get("pMin", 1000.0)
    cfg = ci_mod.CompIntConfig(
        R1=_dim_scalar_of(ph1, "R", 287.0),
        R2=_dim_scalar_of(ph2, "R", 3000.0),
        rho0_2=_dim_scalar_of(ph2, "rho0", 1000.0),
        nu1=_dim_scalar_of(ph1, "nu", 1.5e-5),
        nu2=_dim_scalar_of(ph2, "nu", 1e-6),
        Cv1=_dim_scalar_of(ph1, "Cv", 718.0),
        Cv2=_dim_scalar_of(ph2, "Cv", 4186.0),
        sigma=sigma, g=_read_gravity(case),
        c_alpha=float(cdict.get("cAlpha", 1.0)),
        n_alpha_subcycles=int(cdict.get("nAlphaSubCycles", 1)),
        n_correctors=int(cdict.get("nCorrectors", 3)),
        n_non_orth=int(cdict.get("nNonOrthogonalCorrectors", 0)),
        corrected=case.laplacian_corrected(),
        p_min=float(p_min[-1] if isinstance(p_min, (list, tuple))
                    else p_min),
        p_controls=_p_rgh_controls(case),
        u_controls=case.solver_controls("U"),
        t_controls=case.solver_controls("T") if _has_solver(case, "T")
        else None,
    )
    try:
        alpha = case.read_field("alpha1")
    except Exception:
        alpha = case.read_field("alpha")
    state = ci_mod.initial_state(mesh, case.read_field("U"),
                                 case.read_field("p_rgh"),
                                 case.read_field("T"), alpha, cfg)
    step = ci_mod.make_step(mesh, cfg)
    log.info(f"Starting loop: compressibleInterFoam, "
             f"{mesh.n_cells} cells\n")

    def log_fn(t, diag, state):
        log.info(f"Time = {t.name}\n")
        log.info(
            "Phase-1 volume fraction = "
            f"{float(torch.mean(state['alpha'].data)):.6g}  "
            f"Min(alpha1) = {float(diag['alpha_min']):.6g}  "
            f"Max(alpha1) = {float(diag['alpha_max']):.6g}\n")

    _fixed_loop(case, step, state, max_steps,
                lambda st: case.write_fields([st["U"], st["p_rgh"], st["T"],
                                              st["alpha"]]), log_fn)


# ---------------------------------------------------------------------------
# the combustion family
# ---------------------------------------------------------------------------


def _mechanism(case):
    """(ChemistryModel, W, reactions dict, species thermo dict or None)
    from constant/reactions and constant/thermo.compressibleGas."""
    from ..models import chemistry as chem_mod

    rx = case.properties("reactions")
    thd = (case.properties("thermo.compressibleGas")
           if os.path.exists(case.const_path("thermo.compressibleGas"))
           else None)
    chem, W = chem_mod.from_foam_files(rx, thd, device=case.device)
    return chem, W, rx, thd


def species_field(case, species):
    """The [nC, nS] mass-fraction field: 0/<species> per species (0/Ydefault
    where a species has none), stacked, with one PatchField per patch whose
    ref values are [size, nS] columns; the kind is the species' common
    kind ("mixed" where they differ) with the first species' valueFraction,
    as the reference builds it. With the per-species fields for writing."""
    from ..bc import patchfields as pfm
    from ..core.fields import VolField

    mesh = case.mesh
    flds = []
    for s in species:
        try:
            flds.append(case.read_field(s))
        except FileNotFoundError:
            flds.append(case.read_field("Ydefault"))
    Ydata = torch.stack([f.data for f in flds], dim=1)
    dt, dev = mesh.v.dtype, mesh.device
    bcs = []
    for ip, p in enumerate(mesh.patches):
        pbcs = [f.bcs[ip] for f in flds]
        kinds = [b.kind for b in pbcs]
        if kinds[0] == "empty":
            bcs.append(pfm.PatchField(kind="empty", vfrac=0.0))
            continue
        kind = kinds[0] if len(set(kinds)) == 1 else "mixed"

        def col(vals):
            return torch.stack(
                [torch.broadcast_to(torch.as_tensor(v, dtype=dt, device=dev),
                                    (p.size,)) for v in vals], dim=1)

        bcs.append(pfm.PatchField(
            kind=kind,
            ref_value=col([b.ref_value for b in pbcs]),
            ref_grad=col([b.ref_grad for b in pbcs]),
            vfrac=torch.broadcast_to(torch.as_tensor(
                pbcs[0].vfrac, dtype=dt, device=dev), (p.size,)),
            opts=pbcs[0].opts))
    return VolField(data=Ydata, bcs=tuple(bcs), name="Y"), flds


def _species_columns(flds, species, Y):
    return [dataclasses.replace(flds[i], data=Y.data[:, i], name=s)
            for i, s in enumerate(species)]


def chem_foam(case, max_steps: Optional[int] = None) -> None:
    """chemFoam (combustion/chemFoam): a single-cell (0-D) reactor at
    constant volume. The mechanism from constant/reactions (+
    thermo.compressibleGas), the start from constant/initialConditions
    {p; T; fractions {..};}; the stiff system integrates with the batched
    Rosenbrock solver and T is logged each step. Cv is the janaf mixture's
    at T0 (air-like 718 without the tables). The reactor's state is in the
    precision's dtype (the reference fixes float32, so its run fails under
    float64: ROADMAP Queue 3)."""
    from ..core.precision import scalar_dtype
    from ..models.thermo import _janaf_from_mixture

    chem, W, _, thd = _mechanism(case)
    species = list(chem.species)
    ic = case.properties("initialConditions")
    p0 = _dim_scalar_of(ic, "p", 1e5)
    T0 = _dim_scalar_of(ic, "T", 1000.0)
    fr = ic.get("fractions", FoamDict())
    Y = np.zeros(len(species))
    for i, s in enumerate(species):
        Y[i] = float(fr.get(s, 0.0))
    Y = Y / max(Y.sum(), 1e-300)
    Wmix = 1.0 / float((Y / W).sum())
    R = 8314.47 / Wmix
    rho = p0 / (R * T0)
    dt_, dev = scalar_dtype(), case.device
    # mean Cv from janaf at T0 when available, else air-like
    cv = 718.0
    if thd is not None:
        try:
            cps = []
            for i, s in enumerate(species):
                if s in thd and Y[i] > 0:
                    g = _janaf_from_mixture(thd[s])
                    cps.append(float(Y[i]) * float(g.Cp_of(
                        torch.tensor(float(T0), dtype=dt_))))
            if cps:
                cp = sum(cps) / Y[Y > 0].sum()
                cv = cp - R
        except (KeyError, TypeError, ValueError):
            pass

    c0 = rho * Y / np.asarray(W)        # kmol/m^3
    c = torch.tensor(c0[None, :], dtype=dt_, device=dev)
    T = torch.tensor([T0], dtype=dt_, device=dev)

    def step(c, T, dt):
        c_new = chem.solve(c, T, dt, rtol=1e-5)
        q = -(c_new - c) @ chem.hf          # J/m^3 released
        return c_new, T + q / (rho * cv)

    t = case.time
    max_iter = max(int(round((t.end_time - t.start_time) / t.delta_t)), 1)
    if max_steps is not None:
        max_iter = min(max_iter, max_steps)
    dt = torch.tensor(t.delta_t, dtype=dt_, device=dev)
    log.info(f"Starting loop: chemFoam, {len(species)} species, "
             f"{chem.A.shape[0]} reaction(s)\n")
    while t.index < max_iter and not t.stop_now:
        c, T = step(c, T, dt)
        t.index += 1
        t.value = t.start_time + t.index * t.delta_t
        log.info(f"Time = {t.name}  T = {float(T[0]):.2f}\n")
    Yf = c[0].cpu().numpy() * np.asarray(W) / rho
    case.final_state = {"T": float(T[0]), "Y": Yf, "species": species,
                        "p": float(rho * R * float(T[0]))}
    log.info("End\n")


def _combustion_model(case, chem, default=None):
    from ..models import combustion as comb_mod

    if not os.path.exists(case.const_path("combustionProperties")):
        return default
    return comb_mod.from_dict(case.properties("combustionProperties"), chem)


def _janaf_tables(thd, species):
    """Per-species janaf tables (cp_lo, cp_hi, t_common) of the
    reactingMixture, or Nones when a species lacks its low coefficients."""
    if thd is None:
        return None, None, None
    lo_rows, hi_rows, tc_rows = [], [], []
    for sname in species:
        ent = thd.get(sname)
        if ent is None:
            return None, None, None
        tdct = ent.get("thermodynamics", FoamDict())
        lo = [float(x) for x in tdct.get("lowCpCoeffs", [])]
        hi = [float(x) for x in tdct.get("highCpCoeffs", lo)]
        if len(lo) < 7:
            return None, None, None
        lo_rows.append(lo[:7])
        hi_rows.append(hi[:7])
        tc_rows.append(float(tdct.get("Tcommon", 1000.0)))
    return np.asarray(lo_rows), np.asarray(hi_rows), np.asarray(tc_rows)


def reacting_foam(case, max_steps: Optional[int] = None) -> None:
    """reactingFoam and rhoReactingFoam (combustion/reactingFoam):
    compressible reacting flow, solvers/reacting.py. The mechanism from
    constant/reactions + thermo.compressibleGas, the species from 0/
    (Ydefault where one has no file), the closure from
    constant/combustionProperties (laminar integration without one). With
    every species' janaf table the step runs the reactingMixture EOS;
    transport is the dominant species' Sutherland law, with the mixture R
    of the mean composition."""
    from ..models import thermo as thermo_mod
    from . import reacting as reacting_mod
    from . import rhopimple as rp_mod

    fol = _function_objects(case)
    mesh = case.mesh
    chem, W, _, thd = _mechanism(case)
    species = list(chem.species)
    Y, flds = species_field(case, species)
    ymean = torch.mean(Y.data, dim=0).cpu().numpy()
    dom = int(np.argmax(ymean))
    if thd is not None and species[dom] in thd:
        th = thermo_mod._janaf_from_mixture(thd[species[dom]])
        wsum = float(np.sum(ymean / np.maximum(W, 1e-3)))
        th = dataclasses.replace(th, R=8314.47 * wsum)
    else:
        th = _thermo(case)
    model, tstate = _load_turbulence(case, max(th.mu, 1e-12))
    # (as the reference: no relaxation factors, the default ddt scheme)
    flow = rp_mod.RhoPimpleConfig(thermo=th,
                                  **_flow_fields(case, "p", model=model))
    y_ctl = case.solver_controls("Yi") if _has_solver(case, "Yi") else None
    comb = _combustion_model(case, chem)
    cp_lo, cp_hi, t_common = _janaf_tables(thd, species)
    cfg = reacting_mod.ReactingConfig(flow=flow, chem=chem, W=W,
                                      y_controls=y_ctl, combustion=comb,
                                      cp_lo=cp_lo, cp_hi=cp_hi,
                                      t_common=t_common)
    state = reacting_mod.initial_state(mesh, case.read_field("U"),
                                       case.read_field("p"),
                                       case.read_field("T"), Y, th)
    state = reacting_mod.seed_mixture_state(state, cfg)
    _rho_loop(case, reacting_mod.make_step(mesh, cfg), state, False,
              "reactingFoam", max_steps, {}, fol,
              lambda st: [st["U"], st["p"], st["T"]]
              + _species_columns(flds, species, st["Y"]),
              start=f"Starting loop: reactingFoam, {mesh.n_cells} cells, "
                    f"{len(species)} species\n")


def xi_foam(case, max_steps: Optional[int] = None) -> None:
    """XiFoam and PDRFoam (combustion/XiFoam, PDRFoam): premixed
    combustion with the b-Xi model on the compressible PIMPLE step,
    solvers/xifoam.py. b from 0/b (ignition by an initial burnt kernel:
    setFields), Su and the Xi coefficients from
    constant/combustionProperties (laminarFlameSpeedCorrelation selects a
    models/flamespeed.py correlation). PDRFoam runs the same function, as the
    reference registers it: its obstacle drag is a porosity of
    system/fvOptions (the reference omits the Ep/Xp flame-area fields)."""
    from ..models.flamespeed import make_flame_speed
    from . import rhopimple as rp_mod
    from . import xifoam as xi_mod

    fol = _function_objects(case)
    mesh = case.mesh
    th = _thermo(case)
    model, tstate = _load_turbulence(case, max(th.mu, 1e-12))
    # (as the reference: no relaxation factors, the default ddt scheme)
    flow = rp_mod.RhoPimpleConfig(
        thermo=th, fv_options=_load_fvoptions(case, th.mu / 1.2),
        **_flow_fields(case, "p", model=model))
    comb = case.properties("combustionProperties")
    su_e = comb.get("Su", 0.4)
    su = float(su_e[-1] if isinstance(su_e, (list, tuple)) else su_e)
    su_fn = make_flame_speed(comb, su_default=su)
    T = case.read_field("T")
    cfg = xi_mod.XiFoamConfig(
        flow=flow, Su0=su, su_fn=su_fn,
        SuMin=float(comb.get("SuMin", 0.01)),
        XiEqCoef=float(comb.get("XiEqCoef", comb.get("XiCoef", 0.62))),
        XiShapeCoef=float(comb.get("XiShapeCoef", 1.0)),
        q_comb=float(comb.get("qComb", 2.0e6)),
        Tu=float(comb.get("Tu", float(torch.min(T.data)))),
        b_controls=(case.solver_controls("b") if _has_solver(case, "b")
                    else None))
    state = xi_mod.initial_state(mesh, case.read_field("U"),
                                 case.read_field("p"), T,
                                 case.read_field("b"), th,
                                 turb_state=tstate)
    _rho_loop(case, xi_mod.make_step(mesh, cfg), state, False, "XiFoam",
              max_steps, {}, fol,
              lambda st: [st["U"], st["p"], st["T"], st["b"],
                          st["b"].replace(data=st["Xi"], name="Xi")],
              log_field="b",
              start=f"Starting loop: XiFoam, {mesh.n_cells} cells, "
                    f"Su={su} m/s\n")


def _fire_regions(case):
    """fireFoam's optional regions: (pyro_mesh, pyro_cfg, film_mesh,
    film_cfg, h_conv, T_ref_wall) from constant/pyrolysisProperties
    (reactingOneDimCoeffs) and constant/surfaceFilmProperties
    (thermoSingleLayerCoeffs), each naming its coupled patches."""
    from ..regionmodels import FilmConfig, PyrolysisConfig, build_film_mesh

    mesh = case.mesh
    pyro_mesh = pyro_cfg = film_mesh = film_cfg = None
    h_conv, T_ref_wall = 20.0, 300.0

    def film_mesh_of(patches):
        return build_film_mesh(case.poly_mesh, patches, device=mesh.device,
                               dtype=mesh.v.dtype)

    ppath = case.const_path("pyrolysisProperties")
    if os.path.exists(ppath):
        pd = parse_file(ppath)
        patches = [str(s) for s in pd.get("patches", [])]
        if patches:
            pyro_mesh = film_mesh_of(patches)
            cc = pd.get("reactingOneDimCoeffs", FoamDict())
            h_conv = float(cc.get("h", h_conv))
            T_ref_wall = float(cc.get("T0", T_ref_wall))
            pyro_cfg = PyrolysisConfig(
                n_layers=int(cc.get("nLayers", 8)),
                thickness=float(cc.get("thickness", 0.01)),
                k_s=float(cc.get("k", 0.2)),
                rho_s0=float(cc.get("rho", 700.0)),
                rho_char=float(cc.get("rhoChar", 100.0)),
                cp_s=float(cc.get("Cp", 1500.0)),
                A=float(cc.get("A", 1e8)),
                Ta=float(cc.get("Ta", 15000.0)))
    fpath = case.const_path("surfaceFilmProperties")
    if os.path.exists(fpath):
        fd = parse_file(fpath)
        patches = [str(s) for s in fd.get("patches", [])]
        if patches:
            film_mesh = film_mesh_of(patches)
            cc = fd.get("thermoSingleLayerCoeffs", FoamDict())
            film_cfg = FilmConfig(
                thermo=True, g=_read_gravity(case),
                nu=float(cc.get("nu", 1e-6)),
                rho=float(cc.get("rho", 1000.0)),
                T_sat=float(cc.get("Tsat", 373.15)),
                evap_coeff=float(cc.get("evapCoeff", 1e-3)))
    return pyro_mesh, pyro_cfg, film_mesh, film_cfg, h_conv, T_ref_wall


def fire_config(case):
    """fireFoam's FireConfig, its Y field with the per-species fields,
    and its turbulence state."""
    from ..models import combustion as comb_mod
    from . import buoyantrho as br_mod
    from . import firefoam as ff_mod

    chem, W, rx, _ = _mechanism(case)
    species = list(chem.species)
    Y, flds = species_field(case, species)
    th = _thermo(case)
    model, tstate = _load_turbulence(case, max(th.mu, 1e-12))
    # (as the reference: no relaxation factors)
    flow = br_mod.BuoyantRhoConfig(
        thermo=th, g=_read_gravity(case),
        **_flow_fields(case, "p_rgh", model=model))
    rad = _load_radiation(case)
    if rad is not None:
        flow = flow._replace(radiation=rad)
    comb = _combustion_model(case, chem, comb_mod.Combustion(
        chem=chem, model="infinitelyFastChemistry"))
    (pyro_mesh, pyro_cfg, film_mesh, film_cfg, h_conv,
     T_ref_wall) = _fire_regions(case)
    fuel = str(rx.get("fuel", species[0]))
    cfg = ff_mod.FireConfig(
        flow=flow, chem=chem, W=W, combustion=comb,
        y_controls=(case.solver_controls("Yi") if _has_solver(case, "Yi")
                    else None),
        fuel_index=species.index(fuel) if fuel in species else 0,
        pyro_mesh=pyro_mesh, pyro_cfg=pyro_cfg,
        film_mesh=film_mesh, film_cfg=film_cfg,
        h_conv=h_conv, T_ref_wall=T_ref_wall)
    return cfg, Y, flds, tstate


def fire_state(case, cfg, Y, tstate):
    """fireFoam's first state (G seeded when the config has radiation)."""
    from . import firefoam as ff_mod

    mesh = case.mesh
    T = case.read_field("T")
    state = ff_mod.initial_state(mesh, case.read_field("U"),
                                 case.read_field("p_rgh"), T, Y,
                                 cfg.flow.thermo, g=cfg.flow.g,
                                 turb_state=tstate, cfg=cfg)
    if cfg.flow.radiation is not None:
        from ..models import radiation as rad_mod

        state["G"] = rad_mod.make_G(mesh, cfg.flow.radiation, T.bcs)
    return state


def fire_foam(case, max_steps: Optional[int] = None) -> None:
    """fireFoam (combustion/fireFoam): a buoyant diffusion flame,
    solvers/firefoam.py, with infinitelyFastChemistry by default, the
    P1/fvDOM radiation of constant/radiationProperties, and the pyrolysis
    and film regions of constant/pyrolysisProperties and
    constant/surfaceFilmProperties. The time step adapts to maxCo."""
    from . import firefoam as ff_mod

    fol = _function_objects(case)
    mesh = case.mesh
    cfg, Y, flds, tstate = fire_config(case)
    species = list(cfg.chem.species)
    state = fire_state(case, cfg, Y, tstate)
    step = ff_mod.make_step(mesh, cfg)
    log.info(f"Starting loop: fireFoam, {mesh.n_cells} cells, "
             f"{len(species)} species\n")
    cumulative = 0.0

    def write(state):
        fields = ([state["U"], state["p_rgh"], state["T"]]
                  + _species_columns(flds, species, state["Y"]))
        if "turb" in state and state["turb"]:
            fields += list(state["turb"].values())
        case.write_fields(fields)

    for t in case.time.loop():
        state, diag = step(state, _dt(mesh, t.current_dt))
        cumulative = _log_step(case, t, diag, cumulative)
        log.info(log.solver_line("T", diag["T"]))
        fol.execute(t.name, state)
        t.adjust_delta_t(float(diag["courant_max"]))
        if t.write_time():
            write(state)
        if max_steps is not None and t.index >= max_steps:
            break
    write(state)
    log.info("End\n")
    case.final_state = state


# ---------------------------------------------------------------------------
# the engine family and sonicDyMFoam (solvers/engine.py)
# ---------------------------------------------------------------------------


def _engine_extra_fields(mesh, state, spray):
    """sprayEngineFoam's Yvapour, written beside U, p and T."""
    if not spray:
        return []
    from ..core.fields import vol_scalar

    return [vol_scalar(mesh, 0.0, name="Yvapour").with_data(state["Yv"])]


def _spray_config(case, mesh, geom, p, T, th):
    """sprayEngineFoam's SprayConfig and its empty cloud, from
    constant/sprayCloudProperties (or reactingCloud1Properties): the cone
    injection (by default at the head's end of the axis, pointing down
    it), maxParcels slots, the evaporation and breakup settings."""
    from .. import lagrangian as lag
    from ..lagrangian import reactingcloud as rcloud
    from . import engine as engine_solver

    try:
        props = case.properties("sprayCloudProperties")
    except Exception:
        try:
            props = case.properties("reactingCloud1Properties")
        except Exception:
            props = FoamDict()
    cp = props.get("constantProperties", FoamDict())
    rho0p = _dim_scalar_of(cp, "rho0", 700.0)
    d0 = _dim_scalar_of(cp, "d0", 50e-6)
    T0p = _dim_scalar_of(cp, "T0", 320.0)
    rho_f0 = float(_host(p.data).mean()) / (th.R * float(_host(T.data).mean()))
    lcfg = lag.CloudConfig(rho_f=rho_f0, mu_f=th.mu, g=_read_gravity(case),
                           solve_T=True,
                           cp_p=_dim_scalar_of(cp, "Cp0", 2000.0))
    inj_d = props.get("injection", FoamDict())
    c = _host(mesh.c)
    apex_default = list(c.mean(axis=0))
    apex_default[geom.axis] = float(c[:, geom.axis].max())
    apex = inj_d.get("position", apex_default)
    direc_default = [0.0, 0.0, 0.0]
    direc_default[geom.axis] = -1.0
    direc = inj_d.get("direction", direc_default)
    inj = lag.cone_injection(
        mesh, [float(x) for x in np.asarray(apex, float).reshape(-1)[-3:]],
        [float(x) for x in np.asarray(direc, float).reshape(-1)[-3:]],
        half_angle_deg=_dim_scalar_of(inj_d, "coneAngle", 10.0),
        u_mag=_dim_scalar_of(inj_d, "Umag", 100.0), d0=d0, rho0=rho0p,
        rate=_dim_scalar_of(inj_d, "parcelsPerSecond", 20000.0))
    n_slots = int(_dim_scalar_of(props, "maxParcels", 512))
    cloud = lag.make_cloud(mesh, np.asarray(apex, float).reshape(1, 3),
                           [0.0, 0.0, 0.0], d0, rho0p, n_slots=n_slots,
                           T0=T0p)
    # the seed parcel is a placeholder slot
    cloud = cloud._replace(active=torch.zeros_like(cloud.active))
    spray_cfg = engine_solver.SprayConfig(
        lcfg=lcfg,
        ecfg=rcloud.EvapConfig(K_evap=_dim_scalar_of(props, "Kevap", 1e-7),
                               L_vap=_dim_scalar_of(cp, "Lvap", 3.5e5)),
        bcfg=rcloud.BreakupConfig(rho_f=rho_f0), inj=inj,
        bt=torch.tensor(lag.face_boundary_types(mesh), device=mesh.device))
    return spray_cfg, cloud


def _engine_foam(case, max_steps: Optional[int] = None,
                 combustion: bool = False, spray: bool = False) -> None:
    """engineFoam / coldEngineFoam (applications/solvers/combustion/
    {engineFoam,coldEngineFoam}/ with src/engine/): in-cylinder
    compressible flow under the slider-crank piston motion of
    constant/engineGeometry. The controlDict times are crank-angle
    degrees (engineTime's user time). The patch named `piston` is the
    moving crown, the other end of the cylinder axis the head.
    engineFoam adds the b-Xi heat release, ignited as
    constant/combustionProperties' `ignition` says (start CAD, location,
    diameter). A non-zero engineGeometry `pistonLayers` selects the
    layerAdditionRemoval motion (_engine_foam_layered), except with
    `spray` (sprayEngineFoam: the cloud of _spray_config rides the moving
    mesh inside the engine step)."""
    from ..core.fields import vol_scalar
    from ..mesh import engine as eng_mod
    from ..models import thermo as thermo_mod
    from . import engine as engine_solver

    geom_d = case.properties("engineGeometry")
    geom = eng_mod.from_dict(geom_d)
    if _dim_scalar_of(geom_d, "pistonLayers", 0.0) > 0.0 and not spray:
        _engine_foam_layered(case, max_steps, combustion, geom, geom_d)
        return
    mesh = case.mesh
    th = thermo_mod.from_dict(case.properties("thermophysicalProperties"))
    U = case.read_field("U")
    p = case.read_field("p")
    T = case.read_field("T")

    # the piston crown and the head along the engine axis
    cf = _host(mesh.cf)
    z_piston0 = float(cf[mesh.patch("piston").slice, geom.axis].mean())
    ax_all = cf[:, geom.axis]
    z_head = float(ax_all.max() if z_piston0 < ax_all.mean()
                   else ax_all.min())
    pts_fn, umesh_fn = eng_mod.piston_motion(geom, z_head=z_head,
                                             z_piston0=z_piston0)
    comb = (case.properties("combustionProperties")
            if combustion else FoamDict())
    spray_cfg = cloud = None
    if spray:
        spray_cfg, cloud = _spray_config(case, mesh, geom, p, T, th)
    cfg = engine_solver.EngineConfig(
        thermo=th, pts_fn=pts_fn, umesh_fn=umesh_fn,
        s_per_cad=1.0 / eng_mod.deg_per_sec(geom), spray=spray_cfg,
        n_correctors=int(case.pimple_controls("PIMPLE").get(
            "nCorrectors", 2)),
        p_ref_value=float(_host(p.data).mean()),
        Su0=_dim_scalar_of(comb, "Su", 0.0) if combustion else 0.0,
        Xi=_dim_scalar_of(comb, "Xi", 2.0),
        q_comb=_dim_scalar_of(comb, "qComb", 2.0e6),
        Tu=_dim_scalar_of(comb, "Tu", 300.0),
        p_controls=case.solver_controls("p"),
        u_controls=case.solver_controls("U"))
    b = None
    if combustion:
        try:
            b = case.read_field("b")
        except Exception:
            b = vol_scalar(mesh, 1.0, name="b")
    state = engine_solver.initial_state(case.poly_mesh, mesh, U, p, T, th,
                                        cfg, b=b, cloud=cloud)
    step = engine_solver.make_step(mesh, cfg)

    # the spark (ignitionSite: a one-shot burnt kernel set on the host).
    # Only an `ignition { start ...; }` entry schedules it, as in the
    # reference; without one the charge counts as ignited from the start
    ign = comb.get("ignition", FoamDict()) if combustion else FoamDict()
    ign_start = _dim_scalar_of(ign, "start", 0.0)       # CAD
    ign_d = _dim_scalar_of(ign, "diameter", 0.02)
    loc = ign.get("location", None)
    ignited = (not combustion or not isinstance(ign, FoamDict)
               or "start" not in ign)

    def fields(state):
        return ([state["U"], state["p"], state["T"]]
                + ([state["b"]] if combustion else [])
                + _engine_extra_fields(mesh, state, spray))

    name = ("sprayEngineFoam" if spray else
            "engineFoam" if combustion else "coldEngineFoam")
    log.info(f"Starting loop: {name}, rpm {geom.rpm}, "
             f"theta0 {geom.theta0} CAD\n")
    diag = None
    for t in case.time.loop():
        theta = geom.theta0 + t.value     # the controlDict time is CAD
        if combustion and not ignited and theta >= ign_start:
            c = _host(mesh.c)
            lc = (np.asarray([float(x) for x in loc])
                  if loc is not None else c.mean(axis=0))
            r = np.linalg.norm(c - lc[None, :], axis=1)
            bb = _host(state["b"].data).copy()
            bb[r < 0.5 * ign_d] = 0.0
            state["b"] = state["b"].with_data(torch.tensor(
                bb, dtype=mesh.v.dtype, device=mesh.device))
            state["b0"] = state["b"].data
            ignited = True
            log.info(f"Ignition at theta = {theta:.2f} CAD\n")
        state, diag = step(state, _dt(mesh, t.current_dt))
        log.info(f"Crank angle = {theta + t.current_dt:.6g} CAD\n"
                 f"p_mean = {float(diag['p_mean']):.6g}  "
                 f"T_mean = {float(diag['T_mean']):.6g}  "
                 f"V = {float(diag['V_total']):.6g}\n")
        if t.write_time():
            case.write_fields(fields(state))
        if max_steps is not None and t.index >= max_steps:
            break
    case.write_fields(fields(state))
    case.final_state = {"state": state, "diag": diag}
    log.info("End\n")


def _engine_foam_layered(case, max_steps: Optional[int],
                         combustion: bool, geom, geom_d) -> None:
    """engineFoam / coldEngineFoam with layer addition and removal: the
    cell count changes during the run (src/dynamicMesh/polyTopoChange/
    polyTopoChanger/layerAdditionRemoval driven by src/engine/engineMesh,
    selected by engineGeometry's `pistonLayers`). Between events only the
    piston plane moves (mesh/engine.py::piston_layer_motion); when the
    piston layer passes 0.5 or 1.5 pistonLayers the host re-extrudes the
    mesh (mesh/topo.py), rho, momentum and energy remap through the
    exact conservative slab overlap, and the device mesh and the step
    are made anew: the mass is conserved exactly across an event."""
    from ..bc import factory as bc_factory
    from ..bc.patchfields import normalize_bcs
    from ..core.fields import VolField, vol_scalar
    from ..io import fields as field_io
    from ..io import polymesh as pmesh_io
    from ..mesh import engine as eng_mod
    from ..mesh import topo as topo_mod
    from ..models import thermo as thermo_mod
    from . import engine as engine_solver

    th = thermo_mod.from_dict(case.properties("thermophysicalProperties"))
    h0 = _dim_scalar_of(geom_d, "pistonLayers", 0.0)
    pm0 = case.poly_mesh
    topo = topo_mod.analyze(pm0, geom.axis)
    z_p = float(np.asarray(pm0.cf)[pm0.patch("piston").slice,
                                   geom.axis].mean())
    side = (0 if abs(z_p - topo.planes[0]) <= abs(z_p - topo.planes[-1])
            else -1)

    # the initial fields on the original cell order, with their boundary
    # entries
    names = ["U", "p", "T"] + (["b"] if combustion else [])
    t0 = case.latest_time_name()
    raw, specs, meta = {}, {}, {}
    for nm in names:
        path = os.path.join(case.dir, t0, nm)
        if not os.path.exists(path) and not os.path.exists(path + ".gz"):
            path = os.path.join(case.dir, "0", nm)
        try:
            d = field_io.load_field_dict(path)
        except Exception:
            if nm != "b":
                raise
            d = None
        if d is None:
            raw[nm] = np.ones(pm0.n_cells)
            specs[nm] = None
            meta[nm] = (0, None)
            continue
        f = field_io.read_field(path, case.mesh, name=nm)
        raw[nm] = _host(f.data)
        specs[nm] = d["boundaryField"]
        meta[nm] = (f.rank, f.dims)

    # the slab-major layered order, once: the layout build() makes
    for nm in names:
        raw[nm] = topo_mod.reorder_to_layers(topo, raw[nm])
    planes = topo.planes.copy()
    nB = topo.n_base

    def rebuild_mesh(new_planes):
        # a model that carries a wall distance would call
        # mesh.walldist.refresh_wall_distance here; the wall adjacency
        # (mesh.wall_mask, wall_y) is rebuilt with the device mesh
        pm = topo_mod.build(topo, new_planes)
        case._poly = pm
        case._mesh = None
        return pm, case.mesh

    def mk_field(nm, mesh, data):
        rank, dims = meta[nm]
        if specs[nm] is None:
            return vol_scalar(mesh, 1.0, name=nm)
        dtype, dev = mesh.v.dtype, mesh.device
        bcs = tuple(bc_factory.from_dict(specs[nm].match(p.name), p, rank,
                                         dtype, dev, mesh=mesh)
                    for p in mesh.patches)
        data = torch.as_tensor(data, dtype=dtype, device=dev)
        if rank == 1 and data.ndim == 1:
            data = data[None, :].expand(mesh.n_cells, 3).clone()
        return VolField(data=data, bcs=normalize_bcs(mesh, bcs, rank),
                        name=nm, dims=dims)

    def mk_chunk(theta_abs, data):
        """The mesh, state and step for the current planes at the
        absolute crank angle theta_abs, from the slab-major cell data."""
        pm, mesh = rebuild_mesh(planes)
        pts_fn, umesh_fn = eng_mod.piston_layer_motion(
            geom, planes, side, theta_abs)
        cfg = engine_solver.EngineConfig(
            thermo=th, pts_fn=pts_fn, umesh_fn=umesh_fn,
            s_per_cad=1.0 / eng_mod.deg_per_sec(geom),
            n_correctors=int(case.pimple_controls("PIMPLE").get(
                "nCorrectors", 2)),
            p_ref_value=float(np.asarray(data["p"]).mean()),
            Su0=_dim_scalar_of(case.properties("combustionProperties"),
                               "Su", 0.0) if combustion else 0.0,
            p_controls=case.solver_controls("p"),
            u_controls=case.solver_controls("U"))
        U = mk_field("U", mesh, data["U"])
        p = mk_field("p", mesh, data["p"])
        T = mk_field("T", mesh, data["T"])
        b = mk_field("b", mesh, data["b"]) if combustion else None
        state = engine_solver.initial_state(pm, mesh, U, p, T, th, cfg,
                                            b=b)
        return pm, mesh, state, engine_solver.make_step(mesh, cfg)

    def fields(state):
        return ([state["U"], state["p"], state["T"]]
                + ([state["b"]] if combustion else []))

    theta = geom.theta0 + case.time.start_time
    data = {nm: raw[nm] for nm in names}
    pm, mesh, state, step = mk_chunk(theta, data)
    n_events = 0
    mesh_written_since_event = True
    log.info(f"Starting loop: "
             f"{'engineFoam' if combustion else 'coldEngineFoam'} "
             f"(layerAR), rpm {geom.rpm}, pistonLayers {h0}, "
             f"nCells {pm.n_cells}\n")
    diag = None
    for t in case.time.loop():
        state, diag = step(state, _dt(mesh, t.current_dt))
        theta = geom.theta0 + t.value + t.current_dt
        log.info(f"Crank angle = {theta:.6g} CAD\n"
                 f"p_mean = {float(diag['p_mean']):.6g}  "
                 f"T_mean = {float(diag['T_mean']):.6g}  "
                 f"V = {float(diag['V_total']):.6g}  "
                 f"mass = {float(diag['mass']):.8g}  "
                 f"nCells = {pm.n_cells}\n")

        # layerAdditionRemoval at the step's end: the piston plane from
        # the slider-crank increment since the last step
        ds = (float(eng_mod.piston_displacement(geom, theta))
              - float(eng_mod.piston_displacement(
                  geom, theta - t.current_dt)))
        zp = planes[0] - ds if side == 0 else planes[-1] + ds
        new_planes, changed = topo_mod.layer_ar(planes, zp, h0, side=side)
        if changed:
            # the conservative rho, momentum and energy remap between the
            # step's moved planes and the re-layered ones
            WT = topo_mod.slab_overlap_matrix(_moved(planes, zp, side),
                                              new_planes)
            rho = _host(th.rho(state["p"].data, state["T"].data))
            Ud = _host(state["U"].data)
            Td = _host(state["T"].data)
            rho_h = topo_mod.remap_cells(WT, nB, rho)
            rhoU = topo_mod.remap_cells(WT, nB, rho[:, None] * Ud)
            rhoT = topo_mod.remap_cells(WT, nB, rho * Td)
            data = {"U": rhoU / rho_h[:, None], "T": rhoT / rho_h,
                    "p": rho_h * getattr(th, "R", 287.0) * (rhoT / rho_h)}
            if combustion:
                rhob = topo_mod.remap_cells(WT, nB,
                                            rho * _host(state["b"].data))
                data["b"] = rhob / rho_h
            planes = new_planes
            pm, mesh, state, step = mk_chunk(theta, data)
            n_events += 1
            mesh_written_since_event = False
            log.info(f"layerAR event: nCells -> {pm.n_cells} "
                     f"(layers {planes.shape[0] - 1})\n")
        else:
            planes = _moved(planes, zp, side)

        if t.write_time():
            case.write_fields(fields(state))
            if not mesh_written_since_event:
                pmesh_io.write(pm, os.path.join(case.dir, t.name,
                                                "polyMesh"))
                mesh_written_since_event = True
        if max_steps is not None and t.index >= max_steps:
            break
    case.write_fields(fields(state))
    case.final_state = {"state": state, "diag": diag,
                        "n_cells": pm.n_cells, "n_events": n_events}
    log.info("End\n")


def _moved(planes, zp, side):
    p = np.asarray(planes, dtype=np.float64).copy()
    p[0 if side == 0 else -1] = zp
    return p


def cold_engine_foam(case, max_steps: Optional[int] = None) -> None:
    _engine_foam(case, max_steps, combustion=False)


def engine_foam(case, max_steps: Optional[int] = None) -> None:
    _engine_foam(case, max_steps, combustion=True)


def spray_engine_foam(case, max_steps: Optional[int] = None) -> None:
    """sprayEngineFoam (applications/solvers/lagrangian/sprayFoam/
    sprayEngineFoam/): sprayFoam's spray cloud on the crank-angle engine
    mesh; the b-Xi heat release engages when constant/combustionProperties
    exists."""
    comb = os.path.exists(case.const_path("combustionProperties"))
    _engine_foam(case, max_steps, combustion=comb, spray=True)


def sonic_dym_foam(case, max_steps: Optional[int] = None) -> None:
    """sonicDyMFoam (applications/solvers/compressible/sonicFoam/
    sonicDyMFoam/): transonic pressure-based compressible flow on a
    solid-body moving mesh: the ALE engine step (solvers/engine.py) with
    the transonic div(phid, p) pressure equation, the motion from
    constant/dynamicMeshDict."""
    from ..models import thermo as thermo_mod
    from . import engine as engine_solver

    mesh = case.mesh
    th = thermo_mod.from_dict(case.properties("thermophysicalProperties"))
    pts_fn, umesh_fn = _dym_motion(case)
    cdict = case.pimple_controls("PIMPLE")
    U = case.read_field("U")
    p = case.read_field("p")
    T = case.read_field("T")
    cfg = engine_solver.EngineConfig(
        thermo=th, pts_fn=pts_fn, umesh_fn=umesh_fn, s_per_cad=1.0,
        n_correctors=int(cdict.get("nCorrectors", 2)),
        p_ref_value=float(_host(p.data).mean()), transonic=True,
        p_controls=case.solver_controls("p"),
        u_controls=case.solver_controls("U"))
    state = engine_solver.initial_state(case.poly_mesh, mesh, U, p, T, th,
                                        cfg)
    step = engine_solver.make_step(mesh, cfg)
    log.info("Starting loop: sonicDyMFoam\n")
    diag = None
    for t in case.time.loop():
        state, diag = step(state, _dt(mesh, t.current_dt))
        log.info(f"Time = {t.name}\np_mean = "
                 f"{float(diag['p_mean']):.6g}  T_mean = "
                 f"{float(diag['T_mean']):.6g}\n")
        if t.write_time():
            case.write_fields([state["U"], state["p"], state["T"]])
        if max_steps is not None and t.index >= max_steps:
            break
    case.write_fields([state["U"], state["p"], state["T"]])
    case.final_state = {"state": state, "diag": diag}
    log.info("End\n")


def _cht(case, max_steps: Optional[int] = None) -> None:
    from .chtmultiregion import cht_multi_region_foam

    cht_multi_region_foam(case, max_steps=max_steps)


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
    "LTSInterFoam": lambda case, max_steps=None: interfoam_app(
        case, max_steps, lts=True),
    # the compressible family
    "rhoSimpleFoam": rho_simplefoam,
    "rhoPimpleFoam": rho_pimplefoam,
    "rhoSimplecFoam": rho_simplecfoam,
    "rhoPimplecFoam": rho_pimplecfoam,
    "sonicFoam": sonicfoam,
    # its porous/MRF variants read constant/{porousZones,MRFZones}; the
    # LTS one runs rho_pimplefoam without local time stepping, as the
    # reference registers it
    "rhoPorousSimpleFoam": rho_simplefoam,
    "rhoPorousMRFSimpleFoam": rho_simplefoam,
    "rhoPorousMRFPimpleFoam": rho_pimplefoam,
    "rhoPorousMRFLTSPimpleFoam": rho_pimplefoam,
    "rhoCentralFoam": rhocentralfoam_app,
    "rhoCentralDyMFoam": rhocentral_dym_foam,
    "buoyantSimpleFoam": buoyant_simplefoam,
    "buoyantPimpleFoam": buoyant_pimplefoam,
    # the single-equation applications
    "electrostaticFoam": electrostatic_foam,
    "magneticFoam": magnetic_foam,
    "mhdFoam": mhd_foam,
    "financialFoam": financial_foam,
    "shallowWaterFoam": shallow_water_foam,
    "solidDisplacementFoam": solid_displacement_foam,
    "solidEquilibriumDisplacementFoam": solid_equilibrium_displacement_foam,
    "potentialFreeSurfaceFoam": potential_free_surface_foam,
    "adjointShapeOptimizationFoam": adjoint_shape_optimization_foam,
    "dnsFoam": dns_foam,
    # windSimpleFoam is simpleFoam, whose fvOptions carry the
    # actuationDiskSource (openTerrain ships none), as the reference
    # registers it
    "windSimpleFoam": simplefoam,
    # conjugate heat transfer over the regions of constant/regionProperties
    "chtMultiRegionFoam": _cht,
    "chtMultiRegionSimpleFoam": _cht,
    # the multiphase family; bubbleFoam is twoPhaseEulerFoam, and
    # MRFMultiphaseInterFoam is multiphaseInterFoam, which reads
    # constant/MRFZones, as the reference registers them
    "cavitatingFoam": cavitating_foam,
    "sonicLiquidFoam": lambda case, max_steps=None: cavitating_foam(
        case, max_steps, sonic_liquid=True),
    "compressibleInterFoam": compressible_inter_foam,
    "twoPhaseEulerFoam": two_phase_euler_foam,
    "bubbleFoam": two_phase_euler_foam,
    "multiphaseEulerFoam": multiphase_euler_foam,
    "twoLiquidMixingFoam": two_liquid_mixing_foam,
    "MRFMultiphaseInterFoam": multiphase_inter_foam,
    "multiphaseInterFoam": multiphase_inter_foam,
    "interPhaseChangeFoam": inter_phase_change_foam,
    "interMixingFoam": inter_mixing_foam,
    "settlingFoam": settling_foam,
    # the combustion family; rhoReactingFoam is reactingFoam and PDRFoam
    # XiFoam, as the reference registers them
    "chemFoam": chem_foam,
    "reactingFoam": reacting_foam,
    "rhoReactingFoam": reacting_foam,
    "XiFoam": xi_foam,
    "PDRFoam": xi_foam,
    "fireFoam": fire_foam,
    # the moving-mesh compressible solvers on solvers/engine.py
    "sonicDyMFoam": sonic_dym_foam,
    "coldEngineFoam": cold_engine_foam,
    "engineFoam": engine_foam,
    # the Lagrangian family (solvers/parcels.py; uncoupledKinematicParcelFoam
    # is icoUncoupledKinematicParcelFoam, as the reference registers it) and
    # sprayEngineFoam, the spray on the engine mesh
    "icoUncoupledKinematicParcelFoam":
        parcels.ico_uncoupled_kinematic_parcel_foam,
    "uncoupledKinematicParcelFoam":
        parcels.ico_uncoupled_kinematic_parcel_foam,
    "reactingParcelFoam": parcels.reacting_parcel_foam,
    "LTSReactingParcelFoam": parcels.lts_reacting_parcel_foam,
    "porousExplicitSourceReactingParcelFoam":
        parcels.porous_reacting_parcel_foam,
    "coalChemistryFoam": parcels.coal_chemistry_foam,
    "sprayFoam": parcels.spray_foam,
    "reactingParcelFilmFoam": parcels.reacting_parcel_film_foam,
    "sprayEngineFoam": spray_engine_foam,
    # the discrete methods
    "dsmcFoam": parcels.dsmc_foam,
    "mdFoam": parcels.md_foam,
    "mdEquilibrationFoam": parcels.md_equilibration_foam,
}

# the applications the reference registers that the port has not ported:
# none, since the Lagrangian family and the discrete methods
REFERENCE_ONLY = ()


def run(case, max_steps: Optional[int] = None):
    """Run the application that the case's controlDict names; returns the
    case, with the last state in `case.final_state`."""
    fn = APPLICATIONS.get(case.application)
    if fn is None:
        _not_ported(f"application {case.application!r} (ported: "
                    f"{sorted(APPLICATIONS)})")
    fn(case, max_steps=max_steps)
    return case
