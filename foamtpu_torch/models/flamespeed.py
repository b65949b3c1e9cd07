"""Laminar flame-speed correlations of the b-Xi combustion family (port of
openfoam-2.2.x_tpu/models/flamespeed.py: `_gulder_su`, `_poly_eval`,
`_ravi_petersen`, `make_flame_speed`; reference
src/thermophysicalModels/laminarFlameSpeed/{constant,Gulders,GuldersEGR,
RaviPetersen}/).

A correlation is an elementwise function Su(p, Tu) over whole fields,
closed over its fuel's static coefficients:
  - Gulders: Su0 = W phi^eta exp(-xi (phi-1.075)^2) (Tu/300)^alpha
    (p/1.013e5)^beta, with the reference's Methane/Propane/IsoOctane sets;
  - GuldersEGR: the same derated by (1 - 2.1 Yres);
  - RaviPetersen: polynomials of the equivalence ratio per pressure point,
    interpolated linearly between the bracketing pPoints. The reference
    takes the `alpha` table for the speed polynomial and the `beta` table
    for the temperature exponent, each indexed [EqR interval][pressure]:
    the port reads them in the same order.
The equivalence ratio is the dictionary's (the `unstrained` SuModel
without a transported ft). `constant` returns None: the caller keeps its
scalar Su.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

_GULDER_FUELS = {
    "Methane":   dict(W=0.422,  eta=0.15,   xi=5.18, alpha=2.00, beta=-0.5),
    "Propane":   dict(W=0.446,  eta=0.12,   xi=4.95, alpha=1.77, beta=-0.2),
    "IsoOctane": dict(W=0.4658, eta=-0.326, xi=4.48, alpha=1.56, beta=-0.22),
}
_T_REF = 300.0
_P_REF = 1.013e5


def _gulder_su(coeffs: dict, phi: float, egr: float = 0.0
               ) -> Callable[[Any, Any], Any]:
    W, eta, xi = coeffs["W"], coeffs["eta"], coeffs["xi"]
    alpha, beta = coeffs["alpha"], coeffs["beta"]
    su_ref = W * phi ** eta * np.exp(-xi * (phi - 1.075) ** 2)
    derate = max(1.0 - 2.1 * egr, 0.0)   # GuldersEGR.C: (1 - 2.1 Yres)

    def su(p, Tu):
        return (su_ref * derate
                * (Tu / _T_REF) ** alpha
                * (torch.clamp(torch.as_tensor(p), min=1e3) / _P_REF) ** beta)

    return su


def _poly_eval(coeffs: np.ndarray, x: Any) -> Any:
    """sum_i c_i x^i with static coefficients (ascending order)."""
    acc = torch.zeros_like(x) + float(coeffs[-1])
    for c in coeffs[-2::-1]:
        acc = acc * x + float(c)
    return acc


def _ravi_petersen(coeffs, phi: float) -> Callable[[Any, Any], Any]:
    """RaviPetersen.C: Su = su_p(phi) (Tu/Tref)^alpha_p(phi), su and the
    exponent per pressure point, interpolated between the bracketing
    pPoints pressures."""
    p_pts = np.asarray([float(v) for v in coeffs["pPoints"]])
    eqr_pts = np.asarray([float(v) for v in coeffs["EqRPoints"]])
    t_ref = float(coeffs.get("TRef", 320.0))

    def _table(key):
        raw = coeffs[key]
        return [[np.asarray([float(c) for c in poly]) for poly in row]
                for row in raw]

    alpha_tab = _table("alpha")
    beta_tab = _table("beta")
    # static equivalence-ratio interval (phi is a dictionary constant)
    i = int(np.clip(np.searchsorted(eqr_pts, phi) - 1, 0,
                    len(alpha_tab) - 1))
    su_polys = [alpha_tab[i][j] for j in range(len(p_pts))]
    ex_polys = [beta_tab[i][j] for j in range(len(p_pts))]

    def su(p, Tu):
        p = torch.as_tensor(p)
        su_j = torch.stack([_poly_eval(c, torch.full_like(p, phi))
                            for c in su_polys])       # [nP, ...]
        ex_j = torch.stack([_poly_eval(c, torch.full_like(p, phi))
                            for c in ex_polys])
        pj = torch.tensor(p_pts, dtype=p.dtype, device=p.device)
        j = torch.clamp(torch.searchsorted(pj, p.contiguous()) - 1, 0,
                        len(p_pts) - 2)
        w = torch.clamp((p - pj[j]) / (pj[j + 1] - pj[j]), 0.0, 1.0)
        su_lo = torch.gather(su_j, 0, j[None])[0]
        su_hi = torch.gather(su_j, 0, (j + 1)[None])[0]
        ex_lo = torch.gather(ex_j, 0, j[None])[0]
        ex_hi = torch.gather(ex_j, 0, (j + 1)[None])[0]
        su0 = (1.0 - w) * su_lo + w * su_hi
        ex = (1.0 - w) * ex_lo + w * ex_hi
        return torch.clamp(su0, min=0.0) * (Tu / t_ref) ** ex

    return su


def make_flame_speed(comb: dict, su_default: float = 0.4
                     ) -> Optional[Callable[[Any, Any], Any]]:
    """Su(p, Tu) from a combustionProperties dictionary (laminarFlameSpeed::
    New, keyword `laminarFlameSpeedCorrelation`; `fuel` selects the Gulder
    set, a <Fuel>Coeffs sub-dict overrides it). None for `constant`."""
    name = str(comb.get("laminarFlameSpeedCorrelation",
                        "constant")).strip()
    if name in ("constant", "", "unstrained"):
        return None
    phi = float(comb.get("equivalenceRatio", 1.0))
    fuel = str(comb.get("fuel", "Methane")).strip()
    if name == "RaviPetersen":
        coeffs = comb.get(fuel + "Coeffs", comb.get("RaviPetersenCoeffs"))
        if coeffs is None:
            raise ValueError("RaviPetersen needs a coefficients sub-dict")
        return _ravi_petersen(coeffs, phi)
    if name in ("Gulders", "GuldersEGR"):
        base = dict(_GULDER_FUELS.get(fuel, _GULDER_FUELS["Methane"]))
        over = comb.get(fuel + "Coeffs", {}) or {}
        for k in base:
            if k in over:
                base[k] = float(over[k])
        egr = float(comb.get("EGR", comb.get("Yres", 0.0))) \
            if name == "GuldersEGR" else 0.0
        return _gulder_su(base, phi, egr)
    raise ValueError(f"unknown laminarFlameSpeedCorrelation '{name}'")
