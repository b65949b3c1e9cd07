"""Liquid property packages, the SLGThermo (solid-liquid-gas) layer (port
of openfoam-2.2.x_tpu/models/liquids.py: `nsrds0`, `nsrds1`, `nsrds5`,
`nsrds6`, `Liquid`, `H2O`, `C7H16`, `get`, `from_dict`; reference
src/thermophysicalModels/properties/liquidProperties/ and
src/thermophysicalModels/SLGThermo/).

A liquid is a frozen bundle of elementwise correlation closures over T
(the NSRDS functions 0, 1, 5 and 6): plain torch on whatever tensor they
are given. The built-in sets, H2O and C7H16 (n-heptane, the sprayFoam
fuel), and their coefficients are copied from the reference; a
dictionary-defined liquid overrides them through `from_dict`, falling
back to the built-in property where a key is absent.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

R_UNIV = 8314.47


def _t(T) -> torch.Tensor:
    return T if isinstance(T, torch.Tensor) else torch.as_tensor(
        T, dtype=torch.float64)


def nsrds0(*c):
    """NSRDSfunc0: the polynomial sum c_i T^i (NSRDSfunc0.H)."""
    def f(T):
        T = _t(T)
        acc = torch.zeros_like(T) + c[-1]
        for ci in c[-2::-1]:
            acc = acc * T + ci
        return acc
    return f


def nsrds1(a, b, c, d, e):
    """NSRDSfunc1: exp(a + b/T + c lnT + d T^e) (the vapour pressure and
    viscosity form)."""
    def f(T):
        Ts = torch.clamp(_t(T), min=50.0)
        return torch.exp(a + b / Ts + c * torch.log(Ts) + d * Ts ** e)
    return f


def nsrds5(a, b, c, d):
    """NSRDSfunc5: a / b^(1 + (1 - T/c)^d) (saturated liquid density)."""
    def f(T):
        tr = torch.clamp(1.0 - _t(T) / c, 1e-6, 1.0)
        return a / b ** (1.0 + tr ** d)
    return f


def nsrds6(Tc, a, b, c, d, e=0.0):
    """NSRDSfunc6: a (1-Tr)^(b + c Tr + d Tr^2 + e Tr^3) (latent heat and
    surface tension)."""
    def f(T):
        Tr = torch.clamp(_t(T) / Tc, 1e-6, 1.0 - 1e-6)
        return a * (1.0 - Tr) ** (b + Tr * (c + Tr * (d + Tr * e)))
    return f


@dataclasses.dataclass(frozen=True)
class Liquid:
    """One liquid component: critical data and correlation closures over
    T. All SI (kg, m, s, K, J, Pa)."""

    name: str
    W: float                    # molecular weight [kg/kmol]
    Tc: float                   # critical temperature [K]
    Pc: float                   # critical pressure [Pa]
    T_boil: float               # normal boiling point [K]
    rho: Callable[[Any], Any]   # liquid density [kg/m^3]
    pv: Callable[[Any], Any]    # saturation vapour pressure [Pa]
    hl: Callable[[Any], Any]    # latent heat of vapourisation [J/kg]
    cp: Callable[[Any], Any]    # liquid heat capacity [J/kg/K]
    mu: Callable[[Any], Any]    # liquid dynamic viscosity [Pa s]
    kappa: Callable[[Any], Any]  # liquid thermal conductivity [W/m/K]
    sigma: Callable[[Any], Any]  # surface tension [N/m]
    D: float = 2.4e-5           # vapour-in-air diffusivity [m^2/s]

    def Ts_clip(self, T):
        """Clamp a droplet temperature into the correlation range."""
        return torch.clamp(_t(T), 200.0, self.Tc - 1.0)


# -- built-in coefficient sets (liquidProperties/H2O/H2O.C,
#    C7H16/C7H16.C: DIPPR-form constants, public handbook data) -------------

H2O = Liquid(
    name="H2O", W=18.015, Tc=647.13, Pc=2.2055e7, T_boil=373.15,
    rho=nsrds5(98.343885, 0.30542, 647.13, 0.081),
    pv=nsrds1(73.649, -7258.2, -7.3037, 4.1653e-6, 2.0),
    hl=nsrds6(647.13, 2889425.48, 0.3199, -0.212, 0.25795),
    cp=nsrds0(15341.1046, -116.019983, 0.451013045,
              -7.83569248e-4, 5.20127671e-7),
    mu=nsrds1(-51.964, 3670.6, 5.7331, -5.349e-29, 10.0),
    kappa=nsrds0(-0.4267, 5.6903e-3, -8.0065e-6, 1.815e-9),
    sigma=nsrds6(647.13, 0.18548, 2.717, -3.554, 2.047),
    D=2.4e-5)

C7H16 = Liquid(
    name="C7H16", W=100.204, Tc=540.2, Pc=2.74e6, T_boil=371.58,
    rho=nsrds5(61.38048561, 0.26211, 540.2, 0.28141),
    pv=nsrds1(87.829, -6996.4, -9.8802, 7.2099e-6, 2.0),
    hl=nsrds6(540.2, 499121.79, 0.38795, 0.0, 0.0),
    # linear fit through the DIPPR liquid-cp curve (2248 J/kg/K @300 K)
    cp=nsrds0(915.0, 4.445),
    mu=nsrds1(-24.451, 1533.1, 2.0087, 0.0, 1.0),
    kappa=nsrds0(0.215, -3.03e-4),
    sigma=nsrds6(540.2, 0.054143, 1.2512, 0.0, 0.0),
    D=6.0e-6)

_LIQUIDS: Dict[str, Liquid] = {"H2O": H2O, "C7H16": C7H16,
                               "water": H2O, "heptane": C7H16}


def get(name: str) -> Liquid:
    try:
        return _LIQUIDS[str(name).strip()]
    except KeyError:
        raise ValueError(
            f"unknown liquid '{name}' (built-ins: H2O, C7H16; define "
            "coefficients in the dictionary for others)") from None


def from_dict(name: str, d: dict) -> Liquid:
    """Dictionary-defined liquid (the liquidProperties dictionary
    constructor: per-property NSRDS coefficient lists, `rho NSRDSfunc5
    (a b c d);` and so on). Falls back to a built-in property when a key
    is absent and the name is known."""
    base = _LIQUIDS.get(str(name).strip())

    def corr(key, default):
        spec = d.get(key)
        if spec is None:
            return default
        kind, coeffs = str(spec[0]), [float(v) for v in spec[1:]]
        fn = {"NSRDSfunc0": nsrds0, "NSRDSfunc1": nsrds1,
              "NSRDSfunc5": nsrds5, "NSRDSfunc6": nsrds6}[kind]
        return fn(*coeffs)

    def scalar(key, default):
        return float(d.get(key, default))

    if base is None and any(
            k not in d for k in ("W", "Tc", "rho", "pv", "hl")):
        raise ValueError(f"liquid '{name}' needs W/Tc/rho/pv/hl entries")
    b = base or H2O
    return Liquid(
        name=name, W=scalar("W", b.W), Tc=scalar("Tc", b.Tc),
        Pc=scalar("Pc", b.Pc), T_boil=scalar("Tb", b.T_boil),
        rho=corr("rho", b.rho), pv=corr("pv", b.pv),
        hl=corr("hl", b.hl), cp=corr("Cp", b.cp),
        mu=corr("mu", b.mu), kappa=corr("kappa", b.kappa),
        sigma=corr("sigma", b.sigma), D=scalar("D", b.D))
