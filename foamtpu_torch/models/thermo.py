"""Thermophysical models of the compressible stack (port of
openfoam-2.2.x_tpu/models/thermo.py: every class and the dictionary
parsing).

The reference's thermophysicalModels template tower (an equation of
state, hConst/eConst or janaf thermo, const or Sutherland transport,
composed into psiThermo/rhoThermo) collapses into a frozen dataclass of
Python-float constants whose methods take and return tensors:
`PerfectGas`, `JanafGas` (NASA 7-coefficient polynomials, Newton
inversion T(h)), and the equations of state `IncompressiblePerfectGas`,
`RhoConst`, `IcoPolynomial` and `AdiabaticPerfectFluid`.

`from_dict` and its helpers (`_parse_perfect_or_janaf`,
`from_dict_perfect`, `_janaf_from_mixture`, `_eos_from_dict`) are host
code copied from the reference: they read a constant/
thermophysicalProperties dictionary (the 2.2 `thermoType` one-liner
cases and the explicit `mixture` dictionaries) into those dataclasses.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core.dictionary import FoamDict


def _const_like(value: float, T: Any) -> Any:
    """A constant as a 0-d tensor of T's dtype and device (T a tensor),
    else as a Python float."""
    if isinstance(T, torch.Tensor):
        return torch.tensor(value, dtype=T.dtype, device=T.device)
    return value


def _tensor(x: Any) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


@dataclasses.dataclass(frozen=True)
class PerfectGas:
    """perfectGas EOS + eConst/hConst thermo + const/Sutherland transport
    (specie/equationOfState/perfectGas, thermo/eConst,
    transport/{const,sutherland}Transport)."""

    R: float = 287.0          # specific gas constant [J/kg K]
    Cv: float = 717.5         # [J/kg K]
    mu: float = 0.0           # dynamic viscosity (0 = inviscid)
    Pr: float = 0.7
    sutherland_As: float = 0.0   # if >0 use Sutherland mu(T)
    sutherland_Ts: float = 110.4

    @property
    def Cp(self) -> float:
        return self.Cv + self.R

    @property
    def gamma(self) -> float:
        return self.Cp / self.Cv

    # -- state relations -------------------------------------------------------
    def p(self, rho: Any, T: Any) -> Any:
        return rho * self.R * T

    def rho(self, p: Any, T: Any) -> Any:
        return p / (self.R * T)

    def T_from_e(self, e: Any) -> Any:
        return e / self.Cv

    def e(self, T: Any) -> Any:
        return self.Cv * T

    def c(self, T: Any) -> Any:
        """Speed of sound."""
        return torch.sqrt(self.gamma * self.R * torch.clamp(T, min=1e-10))

    def psi(self, T: Any) -> Any:
        """Compressibility psi = rho/p = 1/(R T)."""
        return 1.0 / (self.R * torch.clamp(T, min=1e-10))

    def Cp_of(self, T: Any) -> Any:
        """The constant-Cp twin of JanafGas.Cp_of."""
        return _const_like(self.Cp, T)

    def mu_T(self, T: Any) -> Any:
        if self.sutherland_As > 0:
            return (self.sutherland_As * torch.sqrt(T)
                    / (1.0 + self.sutherland_Ts / T))
        return _const_like(self.mu, T)

    def kappa(self, T: Any) -> Any:
        """Thermal conductivity from Pr."""
        return self.mu_T(T) * self.Cp / self.Pr


def from_dict(d: FoamDict) -> PerfectGas:
    """Build from a thermophysicalProperties dictionary (the 2.2
    `thermoType` one-liner cases and explicit mixture dicts). A `janaf`
    thermoType (or explicit low/highCpCoeffs) selects JanafGas; the other
    2.2 equations of state (incompressiblePerfectGas, rhoConst,
    icoPolynomial, adiabaticPerfectFluid) dispatch on the thermoType
    string."""
    alt = _eos_from_dict(d)
    if alt is not None:
        return alt
    return _parse_perfect_or_janaf(d)


def _parse_perfect_or_janaf(d: FoamDict) -> PerfectGas:
    mix = d.get("mixture")
    tt = str(d.get("thermoType", ""))
    if isinstance(mix, FoamDict):
        th_sub = mix.get("thermodynamics", FoamDict())
        if ("janaf" in tt or (isinstance(th_sub, FoamDict)
                              and "highCpCoeffs" in th_sub)):
            return _janaf_from_mixture(mix)
    R, Cv, mu, Pr = 287.0, 717.5, 0.0, 0.7
    As, Ts = 0.0, 110.4
    if isinstance(mix, FoamDict):
        spec = mix.get("specie", FoamDict())
        if isinstance(spec, FoamDict):
            # R never scales with nMoles (specie::R() = RR/molWeight;
            # nMoles only weights mixture composition)
            _ = float(spec.get("nMoles", 1))
            W = float(spec.get("molWeight", 28.96))
            R = 8314.47 / W
        th = mix.get("thermodynamics", FoamDict())
        if isinstance(th, FoamDict):
            if "Cv" in th:
                Cv = float(th["Cv"])
            elif "Cp" in th:
                Cv = float(th["Cp"]) - R
        tr = mix.get("transport", FoamDict())
        if isinstance(tr, FoamDict):
            mu = float(tr.get("mu", 0.0))
            Pr = float(tr.get("Pr", 0.7))
            As = float(tr.get("As", 0.0))
            Ts = float(tr.get("Ts", 110.4))
    elif isinstance(mix, list):
        # 2.2 one-line mixture: name nMoles molWeight Cv/Cp mu Pr ...
        nums = [float(x) for x in mix if isinstance(x, (int, float))]
        if len(nums) >= 5:
            nmol, W, CpCv, Hf_or_mu = nums[0], nums[1], nums[2], nums[3]
            R = 8314.47 / W
            Cv = CpCv - R if CpCv > R else CpCv
            if len(nums) >= 6:
                mu, Pr = nums[4], nums[5]
    return PerfectGas(R=R, Cv=Cv, mu=mu, Pr=Pr,
                      sutherland_As=As, sutherland_Ts=Ts)


def from_dict_perfect(d: FoamDict) -> PerfectGas:
    """The plain perfectGas parse (R/Cv/transport) without EOS dispatch:
    the base the other equations of state extend."""
    return _parse_perfect_or_janaf(d)


@dataclasses.dataclass(frozen=True)
class JanafGas:
    """perfectGas EOS + janaf thermo (specie/thermo/janaf/janafThermo.H:
    Cp/R = a0 + a1 T + a2 T^2 + a3 T^3 + a4 T^4,
    h/(RT) = a0 + a1/2 T + ... + a5/T): temperature-dependent Cp with the
    Newton inversion T(h); Sutherland or constant transport."""

    R: float = 287.0
    coeffs_low: tuple = (3.298677, 1.4082404e-3, -3.963222e-6,
                         5.641515e-9, -2.444854e-12, -1020.8999,
                         3.950372)          # N2-ish default
    coeffs_high: tuple = (2.92664, 1.4879768e-3, -5.68476e-7,
                          1.0097038e-10, -6.753351e-15, -922.7977,
                          5.980528)
    T_common: float = 1000.0
    T_low: float = 200.0
    T_high: float = 6000.0
    mu: float = 1.8e-5
    Pr: float = 0.7
    sutherland_As: float = 0.0
    sutherland_Ts: float = 110.4

    def _coeffs(self, T):
        """The seven coefficients per cell: the low set below T_common,
        the high set above (one `where` each)."""
        lo = torch.tensor(self.coeffs_low, dtype=T.dtype, device=T.device)
        hi = torch.tensor(self.coeffs_high, dtype=T.dtype, device=T.device)
        sel = T < self.T_common
        return [torch.where(sel, lo[i], hi[i]) for i in range(7)]

    def Cp_of(self, T: Any) -> Any:
        T = torch.clamp(T, self.T_low, self.T_high)
        a = self._coeffs(T)
        return self.R * (a[0] + T * (a[1] + T * (a[2] + T * (a[3]
                                                             + T * a[4]))))

    @property
    def Cp(self) -> float:
        """Cp at 300 K, for the paths that assume a constant; host
        arithmetic on Python floats."""
        T = 300.0
        a = self.coeffs_low if T < self.T_common else self.coeffs_high
        return self.R * (a[0] + T * (a[1] + T * (a[2] + T * (a[3]
                                                             + T * a[4]))))

    @property
    def Cv(self) -> float:
        return self.Cp - self.R

    @property
    def gamma(self) -> float:
        return self.Cp / self.Cv

    def h(self, T: Any) -> Any:
        """Absolute enthalpy h(T) [J/kg] with the chemical offset a5*R
        (janafThermo::ha)."""
        T = torch.clamp(T, self.T_low, self.T_high)
        a = self._coeffs(T)
        return self.R * T * (a[0] + T * (a[1] / 2 + T * (
            a[2] / 3 + T * (a[3] / 4 + T * a[4] / 5)))) \
            + self.R * a[5]

    def T_from_h(self, h: Any, T_guess: Any = None) -> Any:
        """Newton inversion h -> T: six fixed iterations, each an update
        then the clip to [T_low, T_high] (thermo::T's bounded loop)."""
        T = (torch.full_like(h, 300.0) if T_guess is None
             else torch.as_tensor(T_guess, dtype=h.dtype, device=h.device))
        for _ in range(6):
            T = torch.clamp(T - (self.h(T) - h) / self.Cp_of(T),
                            self.T_low, self.T_high)
        return T

    # EOS relations (perfectGas)
    def p(self, rho, T):
        return rho * self.R * T

    def rho(self, p, T):
        return p / (self.R * torch.clamp(T, min=1e-10))

    def c(self, T):
        return torch.sqrt(self.gamma * self.R * torch.clamp(T, min=1e-10))

    def psi(self, T):
        return 1.0 / (self.R * torch.clamp(T, min=1e-10))

    def mu_T(self, T: Any) -> Any:
        if self.sutherland_As > 0:
            return (self.sutherland_As * torch.sqrt(T)
                    / (1.0 + self.sutherland_Ts / T))
        return _const_like(self.mu, T)


def _janaf_from_mixture(mix: FoamDict) -> JanafGas:
    spec = mix.get("specie", FoamDict())
    W = float(spec.get("molWeight", 28.96))
    # specie::R() = RR/molWeight: nMoles is parsed and unused
    _ = float(spec.get("nMoles", 1))
    R = 8314.47 / W
    th = mix.get("thermodynamics", FoamDict())
    lo = [float(x) for x in th.get("lowCpCoeffs", [])]
    hi = [float(x) for x in th.get("highCpCoeffs", [])]
    tr = mix.get("transport", FoamDict())
    return JanafGas(
        R=R,
        coeffs_low=tuple(lo[:7]) if len(lo) >= 7
        else JanafGas.coeffs_low,
        coeffs_high=tuple(hi[:7]) if len(hi) >= 7
        else JanafGas.coeffs_high,
        T_common=float(th.get("Tcommon", 1000.0)),
        T_low=float(th.get("Tlow", 200.0)),
        T_high=float(th.get("Thigh", 6000.0)),
        mu=float(tr.get("mu", 1.8e-5)),
        Pr=float(tr.get("Pr", 0.7)),
        sutherland_As=float(tr.get("As", 0.0)),
        sutherland_Ts=float(tr.get("Ts", 110.4)))


# ---------------------------------------------------------------------------
# The other 2.2.x equations of state (specie/equationOfState/
# {incompressiblePerfectGas,rhoConst,icoPolynomial,adiabaticPerfectFluid}).
# Each keeps the PerfectGas interface; psi is d(rho)/d(p) of the law (zero
# for the pressure-independent ones).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class IncompressiblePerfectGas(PerfectGas):
    """rho = pRef/(R T): thermally expandable, pressure-incompressible."""

    p_ref: float = 1e5

    def rho(self, p: Any, T: Any) -> Any:
        return self.p_ref / (self.R * torch.clamp(T, min=1e-10))

    def psi(self, T: Any) -> Any:
        return torch.zeros_like(_tensor(T))


@dataclasses.dataclass(frozen=True)
class RhoConst(PerfectGas):
    """rho = rho0 (liquid-like constant density)."""

    rho0: float = 1000.0

    def rho(self, p: Any, T: Any) -> Any:
        return torch.full_like(_tensor(T), self.rho0)

    def psi(self, T: Any) -> Any:
        return torch.zeros_like(_tensor(T))


@dataclasses.dataclass(frozen=True)
class IcoPolynomial(PerfectGas):
    """rho(T) = sum_i a_i T^i (pressure-independent polynomial)."""

    rho_coeffs: tuple = (1000.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)

    def rho(self, p: Any, T: Any) -> Any:
        T = _tensor(T)
        out = torch.zeros_like(T)
        for a in reversed(self.rho_coeffs):
            out = out * T + a
        return out

    def psi(self, T: Any) -> Any:
        return torch.zeros_like(_tensor(T))


@dataclasses.dataclass(frozen=True)
class AdiabaticPerfectFluid(PerfectGas):
    """rho = rho0 ((p + B)/(p0 + B))^(1/gamma) (Tait-like barotropic
    liquid)."""

    rho0: float = 1000.0
    p0: float = 1e5
    B: float = 3e8
    gamma_f: float = 7.15

    def rho(self, p: Any, T: Any) -> Any:
        r = (torch.clamp(_tensor(p) + self.B, min=1.0)
             / (self.p0 + self.B))
        return self.rho0 * r ** (1.0 / self.gamma_f)

    def psi(self, T_or_p: Any, p: Any = None) -> Any:
        """d(rho)/dp at the reference state (linearised; the pressure
        solvers take psi as a constant compressibility)."""
        x = _tensor(T_or_p if p is None else p)
        return torch.full_like(
            x, self.rho0 / (self.gamma_f * (self.p0 + self.B)))


def _eos_from_dict(d: FoamDict):
    """thermoType-driven EOS selection; None -> the perfectGas/janaf path
    of from_dict."""
    tt = str(d.get("thermoType", ""))
    mix = d.get("mixture")
    eos = FoamDict()
    if isinstance(mix, FoamDict):
        eos = mix.get("equationOfState", FoamDict())
    base = from_dict_perfect(d)

    def f(key, default):
        v = eos.get(key, default) if isinstance(eos, FoamDict) \
            else default
        if isinstance(v, (list, tuple)):
            v = v[-1]
        return float(np.asarray(v, dtype=float).reshape(-1)[-1])

    if "incompressiblePerfectGas" in tt:
        return IncompressiblePerfectGas(
            R=base.R, Cv=base.Cv, mu=base.mu, Pr=base.Pr,
            sutherland_As=base.sutherland_As,
            sutherland_Ts=base.sutherland_Ts,
            p_ref=f("pRef", 1e5))
    if "rhoConst" in tt:
        return RhoConst(R=base.R, Cv=base.Cv, mu=base.mu, Pr=base.Pr,
                        rho0=f("rho", f("rho0", 1000.0)))
    if "icoPolynomial" in tt:
        rc = eos.get("rhoCoeffs<8>", eos.get("rhoCoeffs", None)) \
            if isinstance(eos, FoamDict) else None
        coeffs = tuple(np.asarray(rc, dtype=float).reshape(-1)[:8]) \
            if rc is not None else (1000.0, 0, 0, 0, 0, 0, 0, 0)
        coeffs = coeffs + (0.0,) * (8 - len(coeffs))
        return IcoPolynomial(R=base.R, Cv=base.Cv, mu=base.mu,
                             Pr=base.Pr, rho_coeffs=coeffs)
    if "adiabaticPerfectFluid" in tt:
        return AdiabaticPerfectFluid(
            R=base.R, Cv=base.Cv, mu=base.mu, Pr=base.Pr,
            rho0=f("rho0", 1000.0), p0=f("p0", 1e5),
            B=f("B", 3e8), gamma_f=f("gamma", 7.15))
    return None
