"""chtMultiRegionFoam / chtMultiRegionSimpleFoam: conjugate heat transfer
across fluid and solid regions (port of
openfoam-2.2.x_tpu/solvers/chtmultiregion.py; the reference's
applications/solvers/heatTransfer/chtMultiRegionFoam/ with the
turbulentTemperatureCoupledBaffleMixed interface BC).

Each region is a Case of its own (`Case(dir, region=name)`) with its mesh
on the device and its own step. Once per iteration the interfaces
exchange the mixed BC's data on the device: refValue is the neighbour's
patch-internal temperature, refGrad 0 and valueFraction
kd_nbr / (kd_nbr + kd_own) from kappa * deltaCoeffs on either side. The
face-to-face maps are matched once per case on the host (`match_interface`,
nearest face centres through scipy's cKDTree, the mappedPatchBase
equivalent) and kept on the device. Solid regions solve
ddt(rho Cp T) = laplacian(kappa, T); fluid regions run the compressible
buoyant step of solvers/buoyantrho.py.

Mirrored from the reference as it stands: the solid T solve never reads
the region's fvSolution (polynomial PCG at relTol 0.01, maxIter 2000),
its Laplacian is uncorrected whatever laplacianSchemes says, the steady
solid equation is -laplacian with no relaxation, and a fluid region's
interface conductivity is the laminar mu/Pr*Cp.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.dimensions import DimensionSet
from ..core.fields import VolField
from ..ops import fvm
from . import linear


class Interface(NamedTuple):
    """One coupled patch pair (regionA.patchA <-> regionB.patchB)."""
    region_a: str
    patch_a: str
    region_b: str
    patch_b: str
    # face maps: for each face of A's patch, the matched face index
    # WITHIN B's patch (and vice versa): host int64 from match_interface,
    # device tensors in ChtRun's copy (`on_device`)
    a_to_b: Any
    b_to_a: Any

    def on_device(self, device) -> "Interface":
        """The same interface with its face maps on `device`, copied once
        so that the per-iteration exchange makes no host transfer."""
        return self._replace(a_to_b=torch.as_tensor(self.a_to_b,
                                                    device=device),
                             b_to_a=torch.as_tensor(self.b_to_a,
                                                    device=device))


def match_interface(mesh_a, patch_a: str, mesh_b, patch_b: str,
                    region_a="A", region_b="B") -> Interface:
    """Nearest-centre face matching (mappedPatchBase equivalent), on the
    host once per case."""
    from scipy.spatial import cKDTree

    pa = mesh_a.patch(patch_a)
    pb = mesh_b.patch(patch_b)
    ca = mesh_a.cf[pa.slice].detach().cpu().numpy()
    cb = mesh_b.cf[pb.slice].detach().cpu().numpy()
    assert pa.size == pb.size, (pa.size, pb.size)
    ta = cKDTree(cb)
    d_ab, a_to_b = ta.query(ca)
    tb = cKDTree(ca)
    d_ba, b_to_a = tb.query(cb)
    assert d_ab.max() < 1e-6 + 0.5 * d_ab.mean() + 1e-9, \
        "interface faces do not conform"
    return Interface(region_a, patch_a, region_b, patch_b,
                     a_to_b.astype(np.int64), b_to_a.astype(np.int64))


def _patch_side_data(mesh, T: VolField, patch_name: str, kappa):
    """(T_cell, kappa*deltaCoeffs) on the patch faces: the coupled-BC
    exchange quantities (reference: temperatureCoupledBase::kappa and
    patchInternalField)."""
    p = mesh.patch(patch_name)
    cells = mesh.owner[p.slice]
    Tc = T.data[cells]
    kd = (kappa[cells] if torch.is_tensor(kappa) and kappa.ndim
          else kappa) * mesh.delta_coeffs[p.slice]
    return Tc, kd


def update_coupled_bcs(mesh_a, Ta: VolField, kappa_a,
                       mesh_b, Tb: VolField, kappa_b,
                       iface: Interface) -> Tuple[VolField, VolField]:
    """Refresh both sides' mixed BCs on the device, with no host fetch
    (reference: turbulentTemperatureCoupledBaffleMixed::updateCoeffs):
      refValue      = neighbour patch-internal T
      refGrad       = 0
      valueFraction = kd_nbr / (kd_nbr + kd_own)
    """
    Tc_a, kd_a = _patch_side_data(mesh_a, Ta, iface.patch_a, kappa_a)
    Tc_b, kd_b = _patch_side_data(mesh_b, Tb, iface.patch_b, kappa_b)
    ab = torch.as_tensor(iface.a_to_b, device=Tc_b.device)
    ba = torch.as_tensor(iface.b_to_a, device=Tc_a.device)

    def set_bc(field, mesh, patch_name, t_nbr, kd_nbr, kd_own):
        ip = [i for i, p in enumerate(mesh.patches)
              if p.name == patch_name][0]
        bcs = list(field.bcs)
        frac = kd_nbr / torch.clamp_min(kd_nbr + kd_own, 1e-30)
        bcs[ip] = bcs[ip].replace(ref_value=t_nbr, ref_grad=0.0,
                                  vfrac=frac)
        return dataclasses.replace(field, bcs=tuple(bcs))

    Ta = set_bc(Ta, mesh_a, iface.patch_a, Tc_b[ab], kd_b[ab], kd_a)
    Tb = set_bc(Tb, mesh_b, iface.patch_b, Tc_a[ba], kd_a[ba], kd_b)
    return Ta, Tb


# ---------------------------------------------------------------------------
# solid region (reference: chtMultiRegionFoam/solid/solveSolid.H)
# ---------------------------------------------------------------------------


class SolidConfig(NamedTuple):
    rho: float
    cp: float
    kappa: float
    steady: bool = False
    t_controls: Dict = None
    # optional solidThermo model (models/solidthermo.SolidThermo): when
    # set, solid_step runs the variable-property conservative form
    # rho(T) Cp(T) dT/dt = div(kappa(T) grad T) with face-interpolated
    # (or anisotropic n.K.n) conductivity instead of the constant path
    thermo: Any = None


def parse_regions(rp) -> Tuple[List[str], List[str]]:
    """constant/regionProperties `regions ( fluid (a b) solid (c) );`
    -> (fluids, solids)."""
    fluids: List[str] = []
    solids: List[str] = []
    items = rp.get("regions", [])
    items = list(items) if isinstance(items, list) else [items]
    current = None
    for it in items:
        s = str(it)
        if s in ("fluid", "solid"):
            current = s
        elif isinstance(it, (list, tuple)):
            names = [str(x) for x in it]
            (fluids if current == "fluid" else solids).extend(names)
        elif current is not None:
            (fluids if current == "fluid" else solids).append(s)
    return fluids, solids


def solid_step(mesh, T: VolField, T0, dt, cfg: SolidConfig):
    """rho Cp dT/dt = div(kappa grad T) (reference:
    chtMultiRegionFoam/solid/solveSolid.H). With cfg.thermo set the
    properties are evaluated per cell from the solidThermo model at the
    current T (explicit property lagging, as the reference's
    heSolidThermo correct() before the solve)."""
    ctl = cfg.t_controls or {"solver": "PCG",
                             "preconditioner": "polynomial",
                             "tolerance": 1e-9, "relTol": 0.01,
                             "maxIter": 2000}
    if cfg.thermo is not None:
        st = cfg.thermo
        kf = st.kappa_face(mesh, T.data).to(mesh.v.dtype)
        lap = fvm.laplacian(
            mesh, kf, T, corrected=False,
            gamma_dims=DimensionSet.of(1, 1, -3, -1))   # W/m/K
        if cfg.steady:
            eqn = -lap
        else:
            rc = st.rho_cp(T.data).to(mesh.v.dtype)  # J/m^3/K
            rdt = 1.0 / dt
            m = fvm.ddt(mesh, T, T0, rdt)
            m = m.replace_fields(
                diag=m.diag * rc, source=m.source * rc,
                dims=m.dims * DimensionSet.of(1, -1, -2, -1))
            eqn = m - lap
    else:
        lap = fvm.laplacian(
            mesh, torch.tensor(cfg.kappa / (cfg.rho * cfg.cp),
                               dtype=mesh.v.dtype, device=mesh.device),
            T, corrected=False,
            gamma_dims=DimensionSet.of(0, 2, -1))
        if cfg.steady:
            eqn = -lap
        else:
            rdt = 1.0 / dt
            eqn = fvm.ddt(mesh, T, T0, rdt) - lap
    data, perf = linear.solve(mesh, eqn, T.data, ctl)
    return T.with_data(data), perf


# ---------------------------------------------------------------------------
# application driver
# ---------------------------------------------------------------------------


class ChtRun:
    """The regions of a multi-region case set up as the reference's
    driver sets them up (per-region Cases and meshes on the case's
    device, interfaces found by the `<A>_to_<B>` patch naming), with one
    iteration (`step`: the coupled-BC exchange, then each region's solve)
    and the writer. `poly_meshes` (region -> PolyMesh) gives regions their
    mesh from memory instead of constant/<region>/polyMesh."""

    def __init__(self, case, poly_meshes: Optional[Dict[str, Any]] = None):
        from ..core.case import Case
        from ..models import solidthermo as sth_mod
        from ..models import thermo as thermo_mod
        from . import buoyantrho as br_mod
        from .apps import _read_gravity

        self.case = case
        rp = case.properties("regionProperties")
        fluids, solids = parse_regions(rp)
        app = str(case.control_dict.get("application"))
        steady = "SIMPLE" in app or app.endswith("SimpleFoam")
        self.steady = steady

        def region_case(name):
            rc = Case(case.dir, device=case.device, region=name)
            if poly_meshes and name in poly_meshes:
                rc._poly = poly_meshes[name]
            return rc

        regions: Dict[str, Dict[str, Any]] = {}
        for name in solids:
            rc = region_case(name)
            st = sth_mod.from_dict(rc.properties("thermophysicalProperties"))
            T = rc.read_field("T")
            const_props = (st.transport == "constIso"
                           and st.thermo == "hConst")
            cfg = SolidConfig(
                rho=st.rho0, cp=float(st.cp_c[0]),
                kappa=float(st.kappa_c[0]), steady=steady,
                thermo=None if const_props else st)
            regions[name] = dict(kind="solid", case=rc, mesh=rc.mesh, T=T,
                                 T0=T.data, cfg=cfg, sthermo=st,
                                 kappa_cells=st.kappa(T.data).to(
                                     rc.mesh.v.dtype))
        for name in fluids:
            rc = region_case(name)
            th = thermo_mod.from_dict(
                rc.properties("thermophysicalProperties"))
            cfg = br_mod.BuoyantRhoConfig(
                thermo=th, g=_read_gravity(rc), steady=steady,
                alpha_u=0.5 if steady else 1.0,
                alpha_p=0.7 if steady else 1.0,
                alpha_e=0.5 if steady else 1.0)
            U = rc.read_field("U")
            p_rgh = rc.read_field("p_rgh")
            T = rc.read_field("T")
            state = br_mod.initial_state(rc.mesh, U, p_rgh, T, th, g=cfg.g,
                                         steady=steady)
            kappa_f = th.mu / th.Pr * th.Cp   # laminar conductivity
            regions[name] = dict(kind="fluid", case=rc, mesh=rc.mesh,
                                 state=state, cfg=cfg, thermo=th,
                                 kappa_cells=torch.full(
                                     (rc.mesh.n_cells,), kappa_f,
                                     dtype=rc.mesh.v.dtype,
                                     device=rc.mesh.device))
        self.regions = regions

        # interface discovery: patch "<A>_to_<B>" in region A pairs with
        # "<B>_to_<A>" in region B
        self.interfaces: List[Interface] = []
        names = list(regions)
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                pa, pb = f"{a}_to_{b}", f"{b}_to_{a}"
                try:
                    regions[a]["mesh"].patch(pa)
                    regions[b]["mesh"].patch(pb)
                except KeyError:
                    continue
                self.interfaces.append(match_interface(
                    regions[a]["mesh"], pa, regions[b]["mesh"], pb, a,
                    b).on_device(regions[a]["mesh"].device))

        self.steps: Dict[str, Any] = {}
        for name, r in regions.items():
            mesh, cfg = r["mesh"], r["cfg"]
            if r["kind"] == "solid":
                self.steps[name] = (lambda T, T0, dt, mesh=mesh, cfg=cfg:
                                    solid_step(mesh, T, T0, dt, cfg))
            else:
                self.steps[name] = (lambda s, dt, mesh=mesh, cfg=cfg:
                                    br_mod.buoyantrho_step(mesh, s, dt, cfg))

    def get_T(self, name):
        r = self.regions[name]
        return r["T"] if r["kind"] == "solid" else r["state"]["T"]

    def set_T(self, name, T):
        r = self.regions[name]
        if r["kind"] == "solid":
            r["T"] = T
        else:
            r["state"]["T"] = T

    def exchange(self) -> None:
        for ifc in self.interfaces:
            ra, rb = self.regions[ifc.region_a], self.regions[ifc.region_b]
            Ta, Tb = update_coupled_bcs(
                ra["mesh"], self.get_T(ifc.region_a), ra["kappa_cells"],
                rb["mesh"], self.get_T(ifc.region_b), rb["kappa_cells"],
                ifc)
            self.set_T(ifc.region_a, Ta)
            self.set_T(ifc.region_b, Tb)

    def step(self, dt):
        """One iteration: the exchange, then every region's solve in the
        order of regionProperties' solids then fluids; the last solid's
        SolverPerf (None when a fluid region came last)."""
        self.exchange()
        last_perf = None
        for name, r in self.regions.items():
            if r["kind"] == "solid":
                Tn, perf = self.steps[name](r["T"], r["T0"], dt)
                r["T"] = Tn.correct_boundary_conditions(r["mesh"])
                if not self.steady:
                    r["T0"] = r["T"].data
                st = r.get("sthermo")
                if st is not None and st.transport in ("exponential",
                                                      "polynomial"):
                    r["kappa_cells"] = st.kappa(r["T"].data).to(
                        r["mesh"].v.dtype)
                last_perf = perf
            else:
                r["state"], _ = self.steps[name](r["state"], dt)
                last_perf = None
        return last_perf

    def write_all(self) -> None:
        for r in self.regions.values():
            if r["kind"] == "solid":
                r["case"].write_fields([r["T"]],
                                       time_name=self.case.time.name)
            else:
                st = r["state"]
                r["case"].write_fields([st["U"], st["p_rgh"], st["T"]],
                                       time_name=self.case.time.name)


def cht_multi_region_foam(case, max_steps: Optional[int] = None) -> None:
    """chtMultiRegionFoam driver: the regions of `ChtRun`, stepped to the
    controlDict's end (or max_steps), the solid regions' last T solve
    logged per step, fields written at write times and at the end. Fluid
    regions run the compressible buoyant step (stagnant fluids reduce to
    conduction); solid regions the kappa Laplacian. The regions land in
    `case.final_state` (name -> dict of kind, case, mesh, T or state)."""
    from ..utils import logging as log

    sim = ChtRun(case)
    log.info(f"Starting loop: chtMultiRegionFoam, regions "
             f"{sorted(sim.regions)}, {len(sim.interfaces)} interfaces\n")
    t = case.time
    max_iter = max(int(round((t.end_time - t.start_time) / t.delta_t)), 1)
    if max_steps is not None:
        max_iter = min(max_iter, max_steps)
    any_mesh = next(iter(sim.regions.values()))["mesh"]
    dt = torch.tensor(1.0 if sim.steady else t.delta_t,
                      dtype=any_mesh.v.dtype, device=any_mesh.device)
    while (t.index < max_iter and not t.stop_now
           and t.value < t.end_time - 1e-12):
        last_perf = sim.step(dt)
        t.index += 1
        t.value = t.start_time + t.index * t.delta_t
        log.info(f"Time = {t.name}\n")
        if last_perf is not None:
            log.info(log.solver_line("T", last_perf))
        if t.write_time():
            sim.write_all()
    sim.write_all()
    log.info("End\n")
    case.final_state = sim.regions
