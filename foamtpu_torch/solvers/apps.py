"""Case-reading helpers of the solver applications (port of
openfoam-2.2.x_tpu/solvers/apps.py: `_load_turbulence`, `_relaxation`
and `_residual_control`). The applications themselves (time
loop, logging, field output) are outside the ported slice.
"""

from __future__ import annotations

import os
from typing import Dict

from ..core.dictionary import FoamDict, parse_file
from ..models.turbulence import base as turb_mod


def _load_turbulence(case, nu: float, compressible: bool = False):
    """Read RASProperties/LESProperties/turbulenceProperties and build
    the model + its field state from the start-time directory; (None,
    None) for a laminar case."""
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
    return model, tstate


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
