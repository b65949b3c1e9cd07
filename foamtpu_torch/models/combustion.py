"""Combustion model closures: laminar, PaSR, infinitelyFastChemistry
(port of openfoam-2.2.x_tpu/models/combustion.py: `epsilon_of`,
`Combustion` with `tc`, `advance` and `_infinitely_fast`, `from_dict`;
reference src/combustionModels/{laminar,PaSR,infinitelyFastChemistry}/
and chemistryModel::tc()).

  - laminar: direct finite-rate integration (ChemistryModel.solve);
  - PaSR: the laminar increment scaled by kappa = (dt+tc)/(dt+tc+tk),
    tk = Cmix sqrt(nuEff/epsilon);
  - infinitelyFastChemistry: mixed-is-burnt over the first reaction,
    dc = (c_eq - c)/C.

Every closure works on whole fields, c [nC, nS] and T [nC]; only laminar
and PaSR run the batched stiff integration.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

_TINY = 1e-30


def epsilon_of(tstate: Optional[dict]) -> Optional[Any]:
    """Turbulent dissipation rate from a turbulence state dict (epsilon,
    or Cmu k omega for the omega-based models)."""
    if not tstate:
        return None
    if "epsilon" in tstate:
        return tstate["epsilon"].data
    if "omega" in tstate and "k" in tstate:
        return 0.09 * tstate["k"].data * tstate["omega"].data
    return None


@dataclasses.dataclass(frozen=True)
class Combustion:
    """model: 'laminar' | 'PaSR' | 'infinitelyFastChemistry';
    Cmix: PaSR mixing-time coefficient (reference default 1.0);
    C: infinitelyFastChemistry rate coefficient (reference: 5.0)."""

    chem: Any                      # models/chemistry.ChemistryModel
    model: str = "laminar"
    Cmix: float = 1.0
    C: float = 5.0

    def tc(self, c, T):
        """Per-cell chemical time [nC]: total concentration over the summed
        forward consumption rate (chemistryModel.C tc())."""
        chem = self.chem
        Tc = torch.clamp(T, min=1e-3)
        kf = chem.A[None, :] * Tc[:, None] ** chem.beta[None, :] * \
            torch.exp(-chem.Ta[None, :] / Tc[:, None])      # [nC, nR]
        logc = torch.log(torch.clamp(c, min=1e-20))          # [nC, nS]
        rate = kf * torch.exp(logc @ chem.lhs.T)             # [nC, nR]
        nu_rhs = torch.sum(chem.rhs, dim=1)                  # [nR]
        denom = rate @ nu_rhs                                # [nC]
        csum = torch.sum(torch.clamp(c, min=0.0), dim=1)
        return csum / torch.clamp(denom, min=_TINY)

    def advance(self, c, T, dt, rtol=1e-4, epsilon=None, nu_eff=None):
        """Advance concentrations c [nC, nS] over dt under the closure;
        epsilon and nu_eff feed PaSR's mixing time (None: kappa = 1)."""
        if self.model == "infinitelyFastChemistry":
            return self._infinitely_fast(c, dt)
        c_lam = self.chem.solve(c, T, dt, rtol=rtol)
        if self.model == "PaSR" and epsilon is not None \
                and nu_eff is not None:
            tc = self.tc(c, T)
            tk = self.Cmix * torch.sqrt(
                torch.clamp(nu_eff, min=0.0)
                / torch.clamp(epsilon, min=_TINY))
            kappa = (dt + tc) / (dt + tc + tk)
            return c + kappa[:, None] * (c_lam - c)
        return c_lam

    def _infinitely_fast(self, c, dt):
        """Mixed-is-burnt over the FIRST reaction: the deficient reactant
        is consumed toward equilibrium with relaxation 1/C
        (infinitelyFastChemistry.C: R = (Y - Yeq)/(C dt))."""
        chem = self.chem
        lhs, rhs = chem.lhs[0], chem.rhs[0]     # [nS]
        with_r = lhs > 0.0
        ratio = (torch.clamp(c, min=0.0)
                 / torch.clamp(lhs, min=_TINY)[None, :])
        ext = torch.amin(torch.where(with_r[None, :], ratio,
                                     torch.full_like(ratio, float("inf"))),
                         dim=1)                  # [nC]
        c_eq = c + ext[:, None] * (rhs - lhs)[None, :]
        return c + (c_eq - c) / self.C


def from_dict(props, chem) -> Combustion:
    """Build from constant/combustionProperties (combustionModel::New:
    `combustionModel PaSR<psiChemistryCombustion>;` + <model>Coeffs).
    An unknown closure falls back to laminar, as in the reference."""
    raw = str(props.get("combustionModel", "laminar")).strip()
    name = raw.split("<")[0].strip()
    kw = {}
    coeffs = props.get(name + "Coeffs", {}) or {}
    if name == "PaSR":
        kw["Cmix"] = float(coeffs.get("Cmix", 1.0))
    elif name == "infinitelyFastChemistry":
        kw["C"] = float(coeffs.get("C", 5.0))
    elif name not in ("laminar",):
        name = "laminar"
    return Combustion(chem=chem, model=name, **kw)
