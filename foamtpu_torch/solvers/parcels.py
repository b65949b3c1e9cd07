"""The Lagrangian and discrete-method applications (port of the loops in
openfoam-2.2.x_tpu/solvers/apps.py: `_read_positions`,
`ico_uncoupled_kinematic_parcel_foam`, `_reacting_parcel_run` and its six
wrappers, `dsmc_foam`, `_md_setup`, `md_foam`, `md_equilibration_foam`;
reference applications/solvers/lagrangian/ and
applications/solvers/discreteMethods/).

- icoUncoupledKinematicParcelFoam and uncoupledKinematicParcelFoam: a
  frozen carrier U transports a kinematic cloud (manualInjection from
  constant/kinematicCloudPositions); the cloud is written as
  <time>/lagrangian/kinematicCloud/{positions,U,origId}.
- The reacting-parcel family (reactingParcelFoam,
  porousExplicitSourceReactingParcelFoam, LTSReactingParcelFoam,
  coalChemistryFoam, sprayFoam, reactingParcelFilmFoam): the rhoPimpleFoam
  carrier (solvers/rhopimple.py) and an evaporating (or devolatilising)
  thermo cloud, operator-split each step: the flow step, then
  `cloud_step` (injection, evolve, breakup, momentum source, evaporation
  or devolatilisation, the explicit feedback into U and T), then the
  implicit Yvapour transport (upwind, non-symmetric: PBiCGStab through
  linear.solve, so the SpMV kernel). sprayFoam's cloud has
  max(4 nPositions, 64) slots, which caps it as the reference does.
- dsmcFoam (lagrangian/dsmc.py) and mdFoam / mdEquilibrationFoam
  (lagrangian/md.py).

Each step reads the host once for the logged parcel count (and the
logged means); the cloud itself stays on the device.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch

from ..core.dictionary import FoamDict, dimensioned_scalar, parse_file
from ..utils import logging as log

# the applications take solvers/apps.py's helpers (_dim_scalar_of, _dt,
# _read_gravity, _load_fvoptions) at call time: apps imports this module
# at its top to register the applications


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _read_positions(path: str) -> np.ndarray:
    """Parse an OpenFOAM positions file (a vectorField or Cloud
    positions: `( (x y z) ... )`, possibly with trailing cell labels
    `(x y z) celli`). Host text parsing: set-up."""
    txt = open(path).read()
    txt = re.sub(r"/\*.*?\*/", "", txt, flags=re.S)
    txt = re.sub(r"//.*", "", txt)
    vecs = re.findall(
        r"\(\s*(-?[\d.eE+-]+)\s+(-?[\d.eE+-]+)\s+(-?[\d.eE+-]+)\s*\)",
        txt)
    # numpy converts the strings (correctly rounded, as float() does)
    return np.asarray(vecs, dtype=float).reshape(-1, 3)


def write_kinematic_cloud(case, time_name: str, cloud) -> None:
    """<time>/lagrangian/kinematicCloud/{positions,U,origId} in the
    reference's text format. origId is the slot index, which stays with
    the parcel, so particleTracks can follow it across times."""
    d = os.path.join(case.dir, time_name, "lagrangian", "kinematicCloud")
    os.makedirs(d, exist_ok=True)
    act = _host(cloud.active)
    x = _host(cloud.x)[act]
    u = _host(cloud.u)[act]
    with open(os.path.join(d, "positions"), "w") as f:
        f.write("FoamFile { version 2.0; format ascii; "
                "class Cloud<basicKinematicParcel>; object positions; }\n")
        f.write(f"{len(x)}\n(\n")
        for p, ci in zip(x, _host(cloud.cell)[act]):
            f.write(f"({p[0]:.8g} {p[1]:.8g} {p[2]:.8g}) {ci}\n")
        f.write(")\n")
    with open(os.path.join(d, "U"), "w") as f:
        f.write("FoamFile { version 2.0; format ascii; "
                "class vectorField; object U; }\n")
        f.write(f"{len(u)}\n(\n")
        for p in u:
            f.write(f"({p[0]:.8g} {p[1]:.8g} {p[2]:.8g})\n")
        f.write(")\n")
    ids = np.nonzero(act)[0]
    with open(os.path.join(d, "origId"), "w") as f:
        f.write("FoamFile { version 2.0; format ascii; "
                "class labelField; object origId; }\n")
        f.write(f"{len(ids)}\n(\n")
        f.write("\n".join(str(int(i)) for i in ids))
        f.write("\n)\n")


def ico_uncoupled_kinematic_parcel_foam(case,
                                        max_steps: Optional[int] = None
                                        ) -> None:
    """icoUncoupledKinematicParcelFoam (applications/solvers/lagrangian/
    icoUncoupledKinematicParcelFoam/): a frozen carrier velocity field
    transports a kinematic cloud (manualInjection from
    kinematicCloudPositions, sphere drag and gravity)."""
    from .. import lagrangian as lag
    from .apps import _dim_scalar_of, _dt, _read_gravity

    mesh = case.mesh
    U = case.read_field("U")
    tp = case.transport_properties()
    _, nu = dimensioned_scalar(tp["nu"])
    rho_f = _dim_scalar_of(tp, "rhoInf", _dim_scalar_of(tp, "rho", 1.2))
    mu_f = nu * rho_f
    props = case.properties("kinematicCloudProperties")
    cp = props.get("constantProperties", FoamDict())
    rho0 = _dim_scalar_of(cp, "rho0", 1000.0)
    sub = props.get("subModels", props)
    inj = FoamDict()
    im = sub.get("injectionModels", sub.get("injectionModel"))
    if isinstance(im, FoamDict):
        for v in im.values():
            if isinstance(v, FoamDict):
                inj = v
                break
        else:
            inj = im
    d0 = _dim_scalar_of(inj, "d0", _dim_scalar_of(cp, "d0", 100e-6))
    U0v = inj.get("U0", [0, 0, 0])
    U0 = np.asarray(U0v[-1] if isinstance(U0v, list)
                    and isinstance(U0v[-1], (list, np.ndarray)) else U0v,
                    dtype=float).reshape(-1)[-3:]
    pos_path = case.const_path("kinematicCloudPositions")
    pos = (_read_positions(pos_path) if os.path.exists(pos_path)
           else np.asarray([[float(x) for x in _host(mesh.c)[0]]]))
    cfg = lag.CloudConfig(rho_f=rho_f, mu_f=mu_f, g=_read_gravity(case))
    cloud = lag.make_cloud(mesh, pos, U0, d0, rho0)
    bt = torch.tensor(lag.face_boundary_types(mesh), device=mesh.device)

    log.info(f"Starting loop: icoUncoupledKinematicParcelFoam, "
             f"{len(pos)} parcels\n")
    for t in case.time.loop():
        cloud = lag.evolve(mesh, cloud, U.data, _dt(mesh, t.current_dt),
                           bt, cfg)
        n_act = int(cloud.n_active)
        log.info(f"Time = {t.name}\nCloud: kinematicCloud  active "
                 f"parcels = {n_act}\n")
        if t.write_time():
            write_kinematic_cloud(case, t.name, cloud)
        if max_steps is not None and t.index >= max_steps:
            break
    write_kinematic_cloud(case, case.time.name, cloud)
    log.info("End\n")
    case.final_state = {"cloud": cloud, "U": U}


def _reacting_parcel_run(case, max_steps: Optional[int], coal=False,
                         spray=False, porous=False, film=False,
                         lts=False) -> None:
    """The reacting-parcel family's shared run loop (applications/solvers/
    lagrangian/{reactingParcelFoam,porousExplicitSourceReactingParcelFoam,
    coalChemistryFoam,sprayFoam}): the rhoPimpleFoam carrier and an
    evaporating (or devolatilising) thermo cloud, two-way coupled
    (momentum through drag, vapour or volatile mass into Yvapour, latent
    or combustion heat into T), operator-split per step."""
    from .. import lagrangian as lag
    from ..core.dimensions import DimensionSet
    from ..core.fields import vol_scalar
    from ..lagrangian import reactingcloud as rcloud
    from ..models import thermo as thermo_mod
    from ..ops import fvm, schemes as schemes_mod, slot as slot_mod
    from . import linear
    from . import rhopimple as rp_mod
    from .apps import _dim_scalar_of, _dt, _load_fvoptions, _read_gravity

    mesh = case.mesh
    dev = mesh.device
    th = thermo_mod.from_dict(case.properties("thermophysicalProperties"))
    cdict = case.pimple_controls("PIMPLE")
    cfg = rp_mod.RhoPimpleConfig(
        thermo=th, steady=False,
        n_correctors=int(cdict.get("nCorrectors", 2)),
        n_non_orth=int(cdict.get("nNonOrthogonalCorrectors", 0)),
        p_ref_value=1e5,
        p_controls=case.solver_controls("p"),
        fv_options=_load_fvoptions(case, th.mu) if porous else None)
    U = case.read_field("U")
    p = case.read_field("p")
    T = case.read_field("T")
    try:
        Yv = case.read_field("Yvapour")
    except Exception:
        Yv = vol_scalar(mesh, 0.0, name="Yvapour")
    state = rp_mod.initial_state(mesh, U, p, T, th)
    if porous and cfg.fv_options:
        # (the reference calls OptionList.initial_state here, which it
        # does not define: ROADMAP Queue 3)
        state["fvopt"] = cfg.fv_options.init_state(mesh)
    flow_step = rp_mod.make_step(mesh, cfg)

    # -- the cloud ----------------------------------------------------------
    props_name = ("coalCloud1Properties" if coal else
                  "reactingCloud1Properties")
    try:
        props = case.properties(props_name)
    except Exception:
        props = FoamDict()
    cp = props.get("constantProperties", FoamDict())
    rho0 = _dim_scalar_of(cp, "rho0", 1400.0 if coal else 1000.0)
    d0 = _dim_scalar_of(cp, "d0", 100e-6)
    T0p = _dim_scalar_of(cp, "T0", 300.0)
    pos_path = case.const_path(
        "coalCloud1Positions" if coal else "reactingCloudPositions")
    if os.path.exists(pos_path):
        pos = _read_positions(pos_path)
    else:
        pos = _host(mesh.c)[:: max(1, mesh.n_cells // 32)][:32]
    n_slots = max(4 * len(pos), 64) if spray else len(pos)
    lcfg = lag.CloudConfig(
        rho_f=float(_host(p.data).mean())
        / (th.R * float(_host(T.data).mean())),
        mu_f=th.mu, g=_read_gravity(case), solve_T=True,
        cp_p=_dim_scalar_of(cp, "Cp0", 4187.0))
    cloud = lag.make_cloud(mesh, pos, [0.0, 0.0, 0.0], d0, rho0,
                           n_slots=n_slots, T0=T0p)
    ecfg = rcloud.EvapConfig(
        K_evap=_dim_scalar_of(props, "Kevap", 1e-8),
        L_vap=_dim_scalar_of(cp, "Lvap", 2.26e6))
    # phaseChangeModel liquidEvaporation selects the liquid-properties
    # path (LiquidEvaporation and liquidProperties); the liquid is named
    # by a `liquid` keyword or defaults to the tutorials' fuels
    pc_model = str(props.get("subModels", FoamDict()).get(
        "phaseChangeModel", "none")).strip()
    liquid = None
    if pc_model.startswith("liquidEvaporation"):
        from ..models import liquids as liquids_mod

        lname = str(props.get("liquid", "C7H16" if spray else "H2O"))
        ldict = props.get(lname + "Coeffs")
        liquid = (liquids_mod.from_dict(lname, ldict) if ldict
                  else liquids_mod.get(lname))
    ccfg = rcloud.CoalConfig(Yvol0=_dim_scalar_of(cp, "Yvolatile", 0.4))
    coal_state = (rcloud.CoalCloud(
        base=cloud, yvol=torch.full_like(cloud.d, ccfg.Yvol0))
        if coal else None)
    bcfg = rcloud.BreakupConfig(rho_f=lcfg.rho_f)
    inj = None
    if spray:
        inj_d = props.get("injection", FoamDict())
        apex = inj_d.get("position", list(_host(mesh.c)[0]))
        direc = inj_d.get("direction", [0.0, -1.0, 0.0])
        inj = lag.cone_injection(
            mesh, [float(x) for x in np.asarray(apex,
                                                float).reshape(-1)[-3:]],
            [float(x) for x in np.asarray(direc, float).reshape(-1)[-3:]],
            half_angle_deg=_dim_scalar_of(inj_d, "coneAngle", 10.0),
            u_mag=_dim_scalar_of(inj_d, "Umag", 50.0), d0=d0,
            rho0=rho0, rate=_dim_scalar_of(inj_d, "parcelsPerSecond",
                                           1000.0))
    bt_host = lag.face_boundary_types(mesh)

    name = ("coalChemistryFoam" if coal else
            "sprayFoam" if spray else
            "porousExplicitSourceReactingParcelFoam" if porous else
            "reactingParcelFilmFoam" if film else
            "LTSReactingParcelFoam" if lts else
            "reactingParcelFoam")

    # LTS (LTSReactingParcelFoam's fv::localEulerDdt): the carrier and the
    # species advance on a per-cell pseudo-time from the local Courant
    # limit; the parcels keep the global deltaT
    lts_max_co = float(case.control_dict.get("maxCo", 0.5))
    lts_max_dt = float(case.control_dict.get("maxDeltaT", 1.0))

    def lts_rdt(st, rdt_old):
        rho_c = torch.clamp(th.rho(st["p"].data, st["T"].data), min=0.01)
        sum_phi = torch.sum(torch.abs(st["phi"])[mesh.cface]
                            * torch.abs(mesh.csign), dim=1)
        rdt = torch.clamp(sum_phi / (2.0 * lts_max_co * rho_c * mesh.v),
                          min=1.0 / lts_max_dt)
        for _ in range(3):
            nb = slot_mod.nbr_values(mesh, rdt)
            nb = torch.where(mesh.st_valid > 0, nb, torch.zeros_like(nb))
            rdt = torch.maximum(rdt, 0.7 * torch.max(nb, dim=1).values)
        if rdt_old is not None:
            rdt = torch.maximum(rdt, rdt_old / 1.2)
        return rdt

    # -- the surface film (reactingParcelFilmFoam: parcels that reach the
    # film patches deposit their mass there; the surfaceFilmModel's parcel
    # injection and absorption coupling) --------------------------------------
    fmm = film_cfg = film_state = None
    cell_to_filmface = None
    if film:
        from ..regionmodels import FilmConfig, build_film_mesh, film_init

        try:
            sfp = case.properties("surfaceFilmProperties")
        except Exception:
            sfp = FoamDict()
        patches = [str(x) for x in (sfp.get("filmPatches") or ["film"])]
        fmm = build_film_mesh(case.poly_mesh, patches, device=dev,
                              dtype=mesh.v.dtype)
        film_cfg = FilmConfig(
            nu=_dim_scalar_of(sfp, "nu", 1e-6),
            rho=_dim_scalar_of(sfp, "rho", 1000.0),
            g=_read_gravity(case), thermo=False)
        film_state = film_init(fmm, film_cfg)
        c2f = np.full(mesh.n_cells, -1, np.int64)
        c2f[_host(fmm.owner_cells)] = np.arange(fmm.n_faces)
        cell_to_filmface = torch.tensor(c2f, device=dev)
        # the film-patch faces absorb parcels (the escape code)
        for pch in mesh.patches:
            if pch.name in patches:
                bt_host[pch.slice] = lag.BND_ESCAPE
    bt = torch.tensor(bt_host, device=dev)

    def cloud_step(cloud_in, coal_in, st, dt, carry, counter):
        """Injection, evolve and the parcel sources of one step."""
        Udata = st["U"].data
        Tdata = st["T"].data
        rho = torch.clamp(th.rho(st["p"].data, Tdata), min=0.01)
        c0 = cloud_in
        if inj is not None:
            c0, carry, counter = lag.inject(c0, inj, carry, counter, dt)
        c1 = lag.evolve(mesh, c0, Udata, dt, bt, lcfg, T_cell=Tdata)
        # the parcels absorbed at boundaries this step (film impingement)
        dep_mask = c0.active & (~c1.active)
        dep = torch.where(dep_mask, c1.rho * torch.pi / 6.0 * c1.d ** 3,
                          torch.zeros_like(c1.d))
        dep_mass_c = dep.new_zeros(mesh.n_cells).index_add_(0, c1.cell, dep)
        if spray:
            c1 = rcloud.reitz_diwakar_breakup(c1, Udata, dt, bcfg)
        mom = lag.momentum_source(mesh, c0, c1, 1.0, dt, lcfg)
        coal_out = coal_in
        if coal:
            coal_out, fuel, qsrc = rcloud.devolatilise(
                coal_in._replace(base=c1), Tdata, dt, ccfg, mesh.n_cells)
            c1 = coal_out.base
            vap = fuel
            heat = -qsrc          # combustion heats the carrier
        elif liquid is not None:
            c1, vap, heat = rcloud.liquid_evaporate(
                c1, Udata, Tdata, st["p"].data, dt, lcfg, liquid,
                mesh.n_cells)     # latent heat cools the carrier
        else:
            c1, vap, heat = rcloud.evaporate(c1, Udata, Tdata, dt, lcfg,
                                             ecfg, mesh.n_cells)
        # the explicit coupling back into the carrier
        cp_c = th.Cp_of(Tdata)
        T_new = Tdata - dt * heat / (rho * cp_c * mesh.v)
        U_new = Udata + dt * mom / (rho * mesh.v)[:, None]
        return (c1, coal_out, carry, counter, vap,
                st["T"].with_data(T_new), st["U"].with_data(U_new),
                dep_mass_c)

    def transport_Yv(st, Yv_f, vap, dt):
        """The implicit vapour transport with the parcel source."""
        rdt = 1.0 / dt
        rho = torch.clamp(th.rho(st["p"].data, st["T"].data), min=0.01)
        phi = st["phi"]
        phi_slot = slot_mod.from_flat(mesh, phi)
        w = schemes_mod.weights_slot(mesh, phi_slot, "upwind", Yv_f)
        eqn = (rp_mod._rho_ddt(mesh, Yv_f, rho, st["rho0"], Yv_f.data, rdt)
               + fvm.div(mesh, phi, Yv_f, phi_slot=phi_slot,
                         slot_weights=w,
                         phi_dims=DimensionSet.of(1, 0, -1)))
        eqn = eqn.add_source(vap / (dt * mesh.v), mesh)
        data, perf = linear.solve(mesh, eqn, Yv_f.data,
                                  {"solver": "PBiCGStab",
                                   "tolerance": 1e-8, "relTol": 0.05,
                                   "maxIter": 200})
        return Yv_f.with_data(torch.clamp(data, 0.0, 1.0)), perf

    carry = torch.zeros((), dtype=mesh.v.dtype, device=dev)
    counter = torch.zeros((), dtype=torch.int64, device=dev)

    log.info(f"Starting loop: {name}, {int(cloud.n_active)} parcels\n")
    diag = {}
    for t in case.time.loop():
        dt = _dt(mesh, t.current_dt)
        if lts:
            state["lts_rdt"] = lts_rdt(state, state.get("lts_rdt"))
        state, diag = flow_step(state, dt)
        (cloud, coal_state, carry, counter, vap, T_new, U_new,
         dep_mass_c) = cloud_step(cloud, coal_state, state, dt, carry,
                                  counter)
        state = dict(state)
        state["T"] = T_new
        state["U"] = U_new
        state["T0"] = T_new.data
        Yv, yperf = transport_Yv(state, Yv, vap, dt)
        if film:
            from ..regionmodels import film_step

            dep_face = dep_mass_c.new_zeros(fmm.n_faces).index_add_(
                0, torch.clamp(cell_to_filmface, min=0),
                torch.where(cell_to_filmface >= 0, dep_mass_c,
                            torch.zeros_like(dep_mass_c)))
            S_mass = dep_face / (fmm.area * dt)   # kg/m^2/s
            film_state, fdiag = film_step(fmm, film_state, dt, film_cfg,
                                          S_mass=S_mass)
        log.info(f"Time = {t.name}\nCloud: active parcels = "
                 f"{int(cloud.n_active)}, Yvapour mean = "
                 f"{float(torch.mean(Yv.data)):.6g}\n")
        if t.write_time():
            case.write_fields([state["U"], state["p"], state["T"], Yv])
        if max_steps is not None and t.index >= max_steps:
            break
    case.write_fields([state["U"], state["p"], state["T"], Yv])
    case.final_state = {"state": state, "cloud": cloud, "Yv": Yv,
                        "coal": coal_state, "diag": diag,
                        "film": film_state}
    log.info("End\n")


def reacting_parcel_foam(case, max_steps: Optional[int] = None):
    _reacting_parcel_run(case, max_steps)


def porous_reacting_parcel_foam(case, max_steps: Optional[int] = None):
    _reacting_parcel_run(case, max_steps, porous=True)


def lts_reacting_parcel_foam(case, max_steps: Optional[int] = None):
    _reacting_parcel_run(case, max_steps, lts=True)


def coal_chemistry_foam(case, max_steps: Optional[int] = None):
    _reacting_parcel_run(case, max_steps, coal=True)


def spray_foam(case, max_steps: Optional[int] = None):
    _reacting_parcel_run(case, max_steps, spray=True)


def reacting_parcel_film_foam(case, max_steps: Optional[int] = None):
    _reacting_parcel_run(case, max_steps, film=True)


# ---------------------------------------------------------------------------
# the discrete methods
# ---------------------------------------------------------------------------


def dsmc_foam(case, max_steps: Optional[int] = None, draws=None) -> None:
    """dsmcFoam (applications/solvers/discreteMethods/dsmc/dsmcFoam/): VHS
    direct simulation Monte Carlo. Reads constant/dsmcProperties
    (nEquivalentParticles and moleculeProperties per species) and
    system/dsmcInitialiseDict (numberDensities, temperature, velocity:
    the reference's dsmcInitialise folded into the start); writes the
    sampled rhoN, overallT and overallU at write times. `draws` replaces
    the cloud's random source (lagrangian/dsmc.py::TorchDraws seeded with
    0, the reference's PRNGKey(0))."""
    from .. import lagrangian as lag
    from ..bc.patchfields import default_bcs
    from ..core.dimensions import DimensionSet
    from ..core.fields import VolField
    from ..lagrangian import dsmc
    from .apps import _dim_scalar_of, _dt

    mesh = case.mesh
    dev, dtype = mesh.device, mesh.v.dtype
    props = case.properties("dsmcProperties")
    fn = _dim_scalar_of(props, "nEquivalentParticles", 1e12)
    mol = props.get("moleculeProperties", FoamDict())
    names, mass, dref, omega, tref = [], [], [], [], 273.0
    for k, v in mol.items():
        if isinstance(v, FoamDict):
            names.append(k)
            mass.append(_dim_scalar_of(v, "mass", 6.63e-26))
            dref.append(_dim_scalar_of(v, "diameter", 4.17e-10))
            omega.append(_dim_scalar_of(v, "omega", 0.81))
            tref = _dim_scalar_of(v, "Tref", tref)
    if not names:
        names, mass, dref, omega = ["Ar"], [6.63e-26], [4.17e-10], [0.81]

    def vec(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    species = dsmc.Species(mass=vec(mass), d_ref=vec(dref),
                           omega=vec(omega), T_ref=tref)
    init_path = os.path.join(case.dir, "system", "dsmcInitialiseDict")
    init = (parse_file(init_path) if os.path.exists(init_path)
            else FoamDict())
    nds = init.get("numberDensities", FoamDict())
    nd_by_sp = [_dim_scalar_of(nds, n, 0.0) for n in names]
    nd_tot = sum(nd_by_sp) or 1e20
    fracs = ([x / nd_tot for x in nd_by_sp] if sum(nd_by_sp) > 0
             else None)
    T0 = _dim_scalar_of(init, "temperature", 300.0)
    U0v = init.get("velocity", [0.0, 0.0, 0.0])
    U0 = tuple(float(x) for x in np.asarray(U0v, float).reshape(-1)[-3:])
    cloud = dsmc.initialise(mesh, species, nd_tot, T0, U0, fn,
                            typ_fracs=fracs, draws=draws)
    bt = torch.tensor(lag.face_boundary_types(mesh), device=dev)
    cfg = dsmc.DsmcConfig(nEquivalentParticles=fn)

    def write(t):
        f = dsmc.sample_fields(mesh, cloud, species, fn)
        flds = [
            VolField(data=f["rhoN"], bcs=default_bcs(mesh, 0),
                     name="rhoN", dims=DimensionSet.of(0, -3, 0)),
            VolField(data=f["T"], bcs=default_bcs(mesh, 0),
                     name="overallT", dims=DimensionSet.of(0, 0, 0, 1)),
            VolField(data=f["U"], bcs=default_bcs(mesh, 1),
                     name="overallU", dims=DimensionSet.of(0, 1, -1)),
        ]
        case.write_fields(flds, time_name=t.name)

    log.info(f"Starting loop: dsmcFoam, {int(cloud.n_active)} "
             f"parcels, {len(names)} species\n")
    for t in case.time.loop():
        cloud = dsmc.evolve(mesh, cloud, _dt(mesh, t.current_dt), bt,
                            cfg, species)
        log.info(f"Time = {t.name}\n    Number of dsmc particles = "
                 f"{int(cloud.n_active)}\n")
        if t.write_time():
            write(t)
        if max_steps is not None and t.index >= max_steps:
            break
    write(case.time)
    case.final_state = {"cloud": cloud, "species": species,
                        "fields": dsmc.sample_fields(mesh, cloud, species,
                                                     fn)}
    log.info("End\n")


def _md_setup(case):
    """mdFoam's and mdEquilibrationFoam's set-up: the LJ properties from
    constant/moleculeProperties, the lattice fill from
    system/mdInitialiseDict, the periodic box the mesh's bounding box."""
    from ..lagrangian import md
    from .apps import _dim_scalar_of

    mesh = case.mesh
    props = case.properties("moleculeProperties")
    eps = _dim_scalar_of(props, "epsilon", 1.656e-21)
    sig = _dim_scalar_of(props, "sigma", 3.4e-10)
    m = _dim_scalar_of(props, "mass", 6.63e-26)
    rcut = _dim_scalar_of(props, "rCut", 2.5 * sig)
    # the domain's bounds from the face centres (boundary faces included;
    # exact for the box domains MD uses)
    pts = _host(mesh.cf)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    cfg = md.MdConfig(epsilon=eps, sigma=sig, mass=m,
                      box=tuple(float(x) for x in (hi - lo)), r_cut=rcut)
    init_path = os.path.join(case.dir, "system", "mdInitialiseDict")
    init = (parse_file(init_path) if os.path.exists(init_path)
            else FoamDict())
    n_side = int(_dim_scalar_of(init, "nSide", 5))
    T0 = _dim_scalar_of(init, "temperature", 120.0)
    x, u = md.lattice_fill(cfg.box, n_side, mass=m, T0=T0)
    x = x + lo[None, :]
    return md, cfg, md.make_state(x, u, cfg, dtype=mesh.v.dtype,
                                  device=mesh.device), init


def md_foam(case, max_steps: Optional[int] = None) -> None:
    """mdFoam (applications/solvers/discreteMethods/molecularDynamics/
    mdFoam/): NVE Lennard-Jones molecular dynamics, velocity Verlet, a
    periodic box."""
    from .apps import _dt

    md, cfg, state, _ = _md_setup(case)
    log.info(f"Starting loop: mdFoam, {state.x.shape[0]} molecules\n")
    pot = 0.0
    for t in case.time.loop():
        state, pot = md.verlet_step(state, _dt(case.mesh, t.current_dt), cfg)
        T = float(md.temperature(state, cfg))
        E = float(md.kinetic_energy(state, cfg)) + float(pot)
        log.info(f"Time = {t.name}\n    temperature = {T:.6g} K, "
                 f"total energy = {E:.6g} J\n")
        if max_steps is not None and t.index >= max_steps:
            break
    case.final_state = {"state": state,
                        "T": float(md.temperature(state, cfg)),
                        "E": float(md.kinetic_energy(state, cfg))
                        + float(pot)}
    log.info("End\n")


def md_equilibration_foam(case, max_steps: Optional[int] = None) -> None:
    """mdEquilibrationFoam (applications/solvers/discreteMethods/
    molecularDynamics/mdEquilibrationFoam/): mdFoam with the velocities
    rescaled toward targetTemperature each step."""
    from .apps import _dim_scalar_of, _dt

    md, cfg, state, init = _md_setup(case)
    T_tgt = _dim_scalar_of(init, "targetTemperature",
                           _dim_scalar_of(init, "temperature", 120.0))
    log.info(f"Starting loop: mdEquilibrationFoam, "
             f"{state.x.shape[0]} molecules, target {T_tgt} K\n")
    for t in case.time.loop():
        state, _ = md.equilibrate_step(state, _dt(case.mesh, t.current_dt),
                                       cfg, T_tgt, relax=0.1)
        log.info(f"Time = {t.name}\n    temperature = "
                 f"{float(md.temperature(state, cfg)):.6g} K\n")
        if max_steps is not None and t.index >= max_steps:
            break
    case.final_state = {"state": state,
                        "T": float(md.temperature(state, cfg))}
    log.info("End\n")
