"""Case-reading helpers of the solver applications (port of
openfoam-2.2.x_tpu/solvers/apps.py: `_load_turbulence`, `_relaxation`,
`_residual_control`, and `_piso_config`, the PisoConfig that the
reference's `_run_piso` builds for icoFoam/pisoFoam). The applications
themselves (time loop, logging, field output) are outside the ported
slice, as are MRF zones, fvOptions and non-Newtonian viscosity.
"""

from __future__ import annotations

import os
from typing import Dict

from ..core.dictionary import FoamDict, parse_file
from ..models.turbulence import base as turb_mod
from . import piso as piso_mod


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


def _piso_config(case, nu: float, model=None) -> piso_mod.PisoConfig:
    """The PisoConfig of an icoFoam/pisoFoam case: the PISO dict, the
    schemes, the p/U solver controls and, with a turbulence model, the
    k controls for its transport solves."""
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
        momentum_predictor=str(pdict.get("momentumPredictor", "yes")) in (
            "yes", "true", "on", "1"),
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
