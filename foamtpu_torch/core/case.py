"""Case: load an OpenFOAM case directory (port of
openfoam-2.2.x_tpu/core/case.py: `Case` without `request_parallel`, and
`run_case`; the application registry is `solvers.apps.APPLICATIONS`).
Cyclic pairs that carry a jump BC (fan, fixedJump) are kept as coincident
cyclicAMI patches, as in the reference.

A Case owns system/ (controlDict with its Time, fvSchemes, fvSolution),
constant/ (polyMesh, read once and moved to the case's device, and the
*Properties dicts) and the time directories: fields are read at the
start time and written at write times. A region of a multi-region case
(chtMultiRegionFoam) is a Case of its own, `Case(dir, region=name)`: its
dictionaries, mesh and fields live under system/<region>/,
constant/<region>/ and <time>/<region>/, while controlDict stays at the
top. The top-level Case of such a case has no constant/polyMesh; its mesh
is read only when asked for.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from . import runtime
from .dictionary import FoamDict, parse_file
from .precision import DEFAULT_DEVICE
from ..io import fields as field_io
from ..io import polymesh as mesh_io
from ..mesh import to_device
from ..utils import logging as log


class Case:
    def __init__(self, case_dir: str, device=DEFAULT_DEVICE,
                 region: str = ""):
        self.dir = os.path.abspath(case_dir)
        self.device = device
        self.region = region
        self.control_dict = parse_file(
            os.path.join(self.dir, "system", "controlDict"))
        self.fv_schemes = parse_file(self.sys_path("fvSchemes"))
        self.fv_solution = parse_file(self.sys_path("fvSolution"))
        self.time = runtime.Time(self.control_dict, self.dir)
        log.load_debug_switches(self.control_dict)
        self._mesh = None
        self._poly = None

    def sys_path(self, name: str) -> str:
        return os.path.join(self.dir, "system", self.region, name)

    def const_path(self, name: str) -> str:
        return os.path.join(self.dir, "constant", self.region, name)

    @property
    def application(self) -> str:
        return str(self.control_dict.get("application", "unknown"))

    # -- mesh -------------------------------------------------------------------
    @property
    def poly_mesh(self):
        if self._poly is None:
            self._poly = mesh_io.read(self.const_path("polyMesh"))
        return self._poly

    def latest_time_name(self) -> str:
        """Name of the latest time directory (falls back to start)."""
        t = self.time.latest_time()
        if t is None:
            t = self.time.start_time
        return runtime.time_name(t, self.time.time_precision)

    def _retain_jump_cyclics(self, pm):
        """Scan the latest time's fields for jumpCyclic-family BCs (fan,
        fixedJump) on cyclic patches, and retype those pairs to cyclicAMI,
        so that they are RETAINED as coincident coupled boundary patches
        (an identity AMI) instead of being internalised: the jump then
        enters through the fixedJump/fan patch fields (createBaffles'
        cyclic pairs feeding derived/fan)."""
        import dataclasses

        jump_names = set()
        tdir = os.path.join(self.dir, self.latest_time_name())
        if not os.path.isdir(tdir):
            return pm
        cyc = {p.name: p for p in pm.patches if p.type == "cyclic"}
        if not cyc:
            return pm
        for fn in sorted(os.listdir(tdir)):
            path = os.path.join(tdir, fn)
            if not os.path.isfile(path):
                continue
            try:
                bf = parse_file(path).get("boundaryField")
            except Exception:
                continue
            if not hasattr(bf, "items"):
                continue
            for pname, spec in bf.items():
                if not hasattr(spec, "get"):
                    continue
                if str(spec.get("type", "")) in ("fan", "fixedJump",
                                                 "fixedJumpAMI") \
                        and str(pname) in cyc:
                    p = cyc[str(pname)]
                    jump_names.add(p.name)
                    nbr = p.neighbour_patch
                    if nbr is None:
                        for q in cyc.values():
                            if q.neighbour_patch == p.name:
                                nbr = q.name
                    if nbr:
                        jump_names.add(nbr)
        if not jump_names:
            return pm
        patches = tuple(
            dataclasses.replace(p, type="cyclicAMI") if p.name in jump_names
            else p for p in pm.patches)
        return dataclasses.replace(pm, patches=patches)

    @property
    def mesh(self):
        if self._mesh is None:
            # cyclic pairs are internalised by to_device, except those
            # that carry a jump BC, retained as coincident cyclicAMI
            self._mesh = to_device(self._retain_jump_cyclics(
                self.poly_mesh), self.device)
        return self._mesh

    # -- dictionaries -----------------------------------------------------------
    def properties(self, name: str) -> FoamDict:
        """A dictionary of constant/ (dynamicMeshDict, RASProperties, ...)."""
        return parse_file(self.const_path(name))

    def transport_properties(self) -> FoamDict:
        return parse_file(self.const_path("transportProperties"))

    # -- fields -------------------------------------------------------------------
    def read_field(self, name: str, time: Optional[str] = None):
        t = time or runtime.time_name(self.time.start_time)
        path = os.path.join(self.dir, t, self.region, name)
        if (not os.path.exists(path) and not os.path.exists(path + ".gz")
                and t == "0.0"):
            path = os.path.join(self.dir, "0", self.region, name)
        return field_io.read_field(path, self.mesh, name=name)

    def write_fields(self, fields, time_name: Optional[str] = None) -> None:
        t = time_name or self.time.name
        fmt = str(self.control_dict.get("writeFormat", "ascii"))
        compress = str(self.control_dict.get("writeCompression", "off")) in (
            "on", "yes", "true", "compressed")
        tdir = os.path.join(t, self.region) if self.region else t
        for f in fields:
            field_io.write_field(f, self.mesh, self.dir, tdir,
                                 fmt=fmt, compress=compress)
        self.time.register_write(t)

    # -- solver controls ------------------------------------------------------------
    def solver_controls(self, field_name: str) -> Dict:
        solvers = self.fv_solution.subdict("solvers")
        d = dict(solvers.match(field_name))
        d = {str(k): v for k, v in d.items()}
        # DIC/DILU/GaussSeidel are sequential: map to parallel
        # equivalents (the reference's documented deviation)
        if str(d.get("preconditioner", "")) in ("DIC", "FDIC", "DILU"):
            d["preconditioner"] = "diagonal"
        if str(d.get("solver", "")) == "GAMG" and "_gamg" not in d:
            from ..solvers.linear.gamg import GAMG

            # the GaussSeidel family maps to damped Jacobi; sweep
            # counts default to 4+4 (explicit fvSolution entries win)
            sm = str(d.get("smoother", "Jacobi"))
            sm = {"GaussSeidel": "Jacobi", "symGaussSeidel": "Jacobi",
                  "DIC": "Jacobi", "DICGaussSeidel": "Jacobi"}.get(sm, sm)
            d["_gamg"] = GAMG(
                self.mesh, smoother=sm,
                n_pre=int(d.get("nPreSweeps", 4)),
                n_post=int(d.get("nPostSweeps", 4)))
        return d

    def pimple_controls(self, name: str = "PISO") -> FoamDict:
        for key in (name, "PISO", "PIMPLE", "SIMPLE"):
            if key in self.fv_solution:
                return self.fv_solution.subdict(key)
        return FoamDict()

    def div_scheme(self, keyword: str) -> str:
        div = self.fv_schemes.subdict("divSchemes")
        try:
            entry = div.match(keyword)
        except KeyError:
            entry = div["default"]
        toks = entry if isinstance(entry, list) else [entry]
        toks = [str(t) for t in toks]
        # "Gauss <scheme> [coeff...]"
        if toks and toks[0] == "Gauss":
            toks = toks[1:]
        return " ".join(toks) if toks else "linear"

    def ddt_scheme(self) -> str:
        """ddtSchemes/default keyword (fv::ddtScheme::New): e.g. 'Euler',
        'backward', 'CrankNicolson 0.9', 'steadyState'."""
        dd = self.fv_schemes.get("ddtSchemes")
        entry = dd.get("default", "Euler") if isinstance(dd, FoamDict) \
            else "Euler"
        toks = [str(t) for t in (entry if isinstance(entry, list)
                                 else [entry])]
        return " ".join(toks) if toks else "Euler"

    def grad_scheme(self, keyword: str = "default") -> str:
        gs = self.fv_schemes.get("gradSchemes")
        if not isinstance(gs, FoamDict):
            return "Gauss linear"
        try:
            entry = gs.match(keyword)
        except KeyError:
            entry = gs.get("default", ["Gauss", "linear"])
        toks = [str(t) for t in (entry if isinstance(entry, list)
                                 else [entry])]
        return " ".join(toks) if toks else "Gauss linear"

    def laplacian_corrected(self) -> bool:
        lap = self.fv_schemes.subdict("laplacianSchemes")
        entry = lap.get("default", ["Gauss", "linear", "corrected"])
        toks = [str(t) for t in (entry if isinstance(entry, list)
                                 else [entry])]
        return "corrected" in toks or "limited" in " ".join(toks)

    def corr_limit(self) -> float:
        """snGrad correction limiter coefficient: 'corrected' -> 1.0,
        'limited <c>' / 'limited corrected <c>' -> c, from the
        laplacianSchemes default (falling back to snGradSchemes)."""
        for dname in ("laplacianSchemes", "snGradSchemes"):
            d = self.fv_schemes.get(dname)
            if not isinstance(d, FoamDict):
                continue
            entry = d.get("default")
            if entry is None:
                continue
            toks = [str(t) for t in
                    (entry if isinstance(entry, list) else [entry])]
            if "limited" in toks:
                for t in reversed(toks):
                    try:
                        return float(t)
                    except ValueError:
                        continue
        return 1.0


def run_case(case_dir: str, max_steps: Optional[int] = None,
             device=DEFAULT_DEVICE, parallel: bool = False) -> Case:
    """Run the application that the case's controlDict names (the twin of
    the reference's run_case): an application that neither package
    registers raises the reference's ValueError, one the reference
    registers but the port has not ported its NotImplementedError (see
    solvers.apps.run). `parallel` (decomposePar / GSPMD in the reference)
    raises NotImplementedError: the parallel layer is not ported."""
    from ..solvers import apps

    if parallel:
        raise NotImplementedError(
            "-parallel (the reference's GSPMD sharding, parallel/) is not "
            "ported to foamtpu_torch yet: Queue 1 item 8, the parallel "
            "layer")
    case = Case(case_dir, device=device)
    app = case.application
    if app not in apps.APPLICATIONS and app not in apps.REFERENCE_ONLY:
        raise ValueError(
            f"unknown application {app!r}; available: "
            f"{sorted(apps.APPLICATIONS)}")
    return apps.run(case, max_steps=max_steps)
