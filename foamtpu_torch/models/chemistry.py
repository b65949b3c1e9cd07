"""Finite-rate chemistry: Arrhenius reaction sets integrated per cell
(port of openfoam-2.2.x_tpu/models/chemistry.py: `Reaction`,
`ChemistryModel` with `k`, `omega`, `heat_release` and `solve`,
`parse_reaction`, `_species_hf`, `from_foam_files`; reference
src/thermophysicalModels/chemistryModel/ chemistryModel::omega, solve).

Species state is molar concentration c [kmol/m^3]; reactions are
irreversible Arrhenius k = A T^beta exp(-Ta/T) with real stoichiometry.
`omega` and `heat_release` take one cell (c [nS], T []) or a batch of
cells (c [nC, nS], T [nC]). `solve` integrates every cell's system over
dt with the Rosenbrock solver of `foamtpu_torch.ode`, batched over the
cells (the reference vmaps its integrator over them), T frozen over the
sub-step; its Jacobian is `jacobian`, the analytic one (the reference's
is `jax.jacfwd` of `omega`: the same matrix to rounding).

float32: the `log(max(c, 1e-20))` floor keeps the logarithm finite
(log(1e-300) is -inf in float32, and 0 * inf is NaN), as the reference's.

`parse_reaction`, `_species_hf` and `from_foam_files` are host code copied
from the reference (the foamChemistryReader format of constant/reactions
and the species thermo of constant/thermo.compressibleGas).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import ode
from ..core.precision import DEFAULT_DEVICE, scalar_dtype


class Reaction(NamedTuple):
    """lhs/rhs: stoichiometric coefficient per species (dense [nS])."""
    lhs: Any
    rhs: Any
    A: float
    beta: float
    Ta: float


@dataclasses.dataclass(frozen=True)
class ChemistryModel:
    """An immutable reaction mechanism over nS species."""

    species: Tuple[str, ...]
    lhs: Any           # [nR, nS]
    rhs: Any           # [nR, nS]
    A: Any             # [nR]
    beta: Any          # [nR]
    Ta: Any            # [nR]
    hf: Any            # [nS] formation enthalpy [J/kmol]

    @staticmethod
    def build(species: Sequence[str], reactions: Sequence[Dict],
              hf: Optional[Sequence[float]] = None, dtype=None,
              device=DEFAULT_DEVICE) -> "ChemistryModel":
        ns = len(species)
        idx = {s: i for i, s in enumerate(species)}
        L = np.zeros((len(reactions), ns))
        R = np.zeros((len(reactions), ns))
        A, beta, Ta = [], [], []
        for r, spec in enumerate(reactions):
            for name, coef in spec["lhs"]:
                L[r, idx[name]] += coef
            for name, coef in spec["rhs"]:
                R[r, idx[name]] += coef
            A.append(float(spec["A"]))
            beta.append(float(spec.get("beta", 0.0)))
            Ta.append(float(spec.get("Ta", 0.0)))
        dt = dtype or scalar_dtype()

        def t(x):
            return torch.tensor(np.asarray(x, dtype=np.float64), dtype=dt,
                                device=device)

        return ChemistryModel(
            species=tuple(species), lhs=t(L), rhs=t(R), A=t(A),
            beta=t(beta), Ta=t(Ta),
            hf=t(np.zeros(ns) if hf is None else hf))

    # -- reaction rates ------------------------------------------------------
    def k(self, T):
        """Arrhenius rate constants [..., nR]."""
        T = torch.clamp(T, min=1e-3)[..., None]
        return self.A * T ** self.beta * torch.exp(-self.Ta / T)

    def omega(self, c, T):
        """dc/dt [..., nS] (reference: chemistryModel::omega)."""
        kf = self.k(T)
        cs = torch.clamp(c, min=0.0)
        logc = torch.log(torch.clamp(cs, min=1e-20))
        rate = kf * torch.exp(logc @ self.lhs.T)
        return rate @ (self.rhs - self.lhs)

    def jacobian(self, c, T):
        """d omega / dc [..., nS, nS], analytic: J[i, j] = sum_r
        (rhs - lhs)[r, i] rate_r lhs[r, j] / c_j where c_j > 1e-20, else 0
        (the floor and the clip at 0 pass no derivative, as jax.jacfwd's
        of `omega` gives it)."""
        kf = self.k(T)
        cs = torch.clamp(c, min=0.0)
        live = cs > 1e-20
        logc = torch.log(torch.clamp(cs, min=1e-20))
        rate = kf * torch.exp(logc @ self.lhs.T)              # [..., nR]
        dlogc = torch.where(live, 1.0 / torch.where(live, cs, 1.0),
                            torch.zeros_like(cs))             # [..., nS]
        J = torch.einsum("ri,...r,rj->...ij", self.rhs - self.lhs, rate,
                         self.lhs)
        return J * dlogc[..., None, :]

    def heat_release(self, c, T):
        """-sum_s hf_s dc_s/dt [J/m^3/s]."""
        return -(self.omega(c, T) @ self.hf)

    # -- stiff integration (the chemistry `solve`) ---------------------------
    def solve(self, c_field, T_field, dt, rtol=1e-6, atol=1e-12):
        """Integrate every cell's concentrations [nC, nS] over dt with the
        Rosenbrock solver (reference: chemistryModel::solve looping cells
        with the selected ODESolver)."""
        return ode.integrate(lambda t, y, T: self.omega(y, T), c_field,
                             0.0, dt, solver="rodas23", rtol=rtol,
                             atol=atol, args=(T_field,),
                             jac=lambda t, y, T: self.jacobian(y, T)).y


# ---------------------------------------------------------------------------
# foamChemistry-format mechanism reader (host code, copied)
# ---------------------------------------------------------------------------

_R_UNIV = 8314.47  # J/(kmol K)


def parse_reaction(s: str) -> Tuple[List[Tuple[str, float]],
                                    List[Tuple[str, float]]]:
    """Parse "CH4 + 2O2 = CO2 + 2H2O" into (lhs, rhs) stoichiometric lists
    (reference: Reaction::setLRhs). Coefficients may be real ("0.5O2");
    "^" exponents are not supported, as in the reference."""
    import re

    def side(txt):
        out = []
        for term in txt.split("+"):
            term = term.strip()
            if not term:
                continue
            m = re.match(r"^([\d.]*)\s*([A-Za-z(][\w()\-+,*']*)$", term)
            if not m:
                raise ValueError(f"cannot parse reaction term {term!r}")
            coef = float(m.group(1)) if m.group(1) else 1.0
            out.append((m.group(2), coef))
        return out

    lhs_txt, rhs_txt = s.split("=")
    return side(lhs_txt), side(rhs_txt)


def _species_hf(entry) -> Tuple[float, float]:
    """(molWeight, formation enthalpy [J/kmol]) from a species thermo
    entry: janaf NASA-7 at Tstd = 298.15 or an hConst `Hf` [J/kg]."""
    spec = entry.get("specie", {})
    W = float(spec.get("molWeight", 28.96))
    th = entry.get("thermodynamics", {})
    if "Hf" in th:
        return W, float(th["Hf"]) * W
    lo = [float(x) for x in th.get("lowCpCoeffs", [])]
    if len(lo) >= 6:
        T = 298.15
        h_RT = (lo[0] + lo[1] * T / 2 + lo[2] * T ** 2 / 3
                + lo[3] * T ** 3 / 4 + lo[4] * T ** 4 / 5 + lo[5] / T)
        return W, h_RT * _R_UNIV * T
    return W, 0.0


def from_foam_files(reactions_dict, thermo_dict=None, dtype=None,
                    device=DEFAULT_DEVICE):
    """(ChemistryModel, W [nS] numpy) from parsed `constant/reactions` and
    `constant/thermo.compressibleGas` dictionaries."""
    species = [str(s) for s in reactions_dict["species"]]
    rxns = []
    rsec = reactions_dict.get("reactions", {})
    for name, spec in (rsec.items() if hasattr(rsec, "items") else []):
        if not hasattr(spec, "get"):
            continue
        eq = str(spec.get("reaction", "")).strip().strip('"')
        if not eq:
            continue
        lhs, rhs = parse_reaction(eq)
        rxns.append({"lhs": lhs, "rhs": rhs,
                     "A": float(spec.get("A", 1.0)),
                     "beta": float(spec.get("beta", 0.0)),
                     "Ta": float(spec.get("Ta", 0.0))})
    W = np.full(len(species), 28.96)
    hf = np.zeros(len(species))
    if thermo_dict is not None:
        for i, s in enumerate(species):
            if s in thermo_dict:
                W[i], hf[i] = _species_hf(thermo_dict[s])
    model = ChemistryModel.build(species, rxns, hf=hf, dtype=dtype,
                                 device=device)
    return model, W
