"""Transport (viscosity) models (port of
openfoam-2.2.x_tpu/models/transport.py).

Newtonian, powerLaw, CrossPowerLaw, BirdCarreau and HerschelBulkley
(src/transportModels/incompressible/viscosityModels/). Each model is a
function nu(mesh, U) -> [nC] of the strain rate, selected by the
transportModel keyword of transportProperties
(singlePhaseTransportModel).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..core.dictionary import FoamDict, dimensioned_scalar
from ..ops import fvc


def strain_rate(mesh, U) -> torch.Tensor:
    """sqrt(2) |symm(grad U)| (strainRate())."""
    g = fvc.grad(mesh, U)
    s = 0.5 * (g + torch.transpose(g, 1, 2))
    return torch.sqrt(2.0 * torch.sum(s * s, dim=(1, 2)))


def _coeffs(props: FoamDict, model: str, *names):
    c = props.subdict(f"{model}Coeffs")
    return [dimensioned_scalar(c[n])[1] for n in names]


def newtonian(props: FoamDict) -> Callable:
    _, nu0 = dimensioned_scalar(props["nu"])

    def nu(mesh, U):
        return torch.full((mesh.n_cells,), nu0, dtype=mesh.v.dtype,
                          device=mesh.device)

    return nu


def power_law(props: FoamDict) -> Callable:
    k, n, nu_min, nu_max = _coeffs(props, "powerLaw", "k", "n", "nuMin",
                                   "nuMax")

    def nu(mesh, U):
        sr = strain_rate(mesh, U)
        return torch.clamp(k * torch.clamp(sr, min=1e-10) ** (n - 1.0),
                           nu_min, nu_max)

    return nu


def cross_power_law(props: FoamDict) -> Callable:
    nu0, nu_inf, m, n = _coeffs(props, "CrossPowerLaw", "nu0", "nuInf", "m",
                                "n")

    def nu(mesh, U):
        sr = strain_rate(mesh, U)
        return nu_inf + (nu0 - nu_inf) / (1.0 + (m * sr) ** n)

    return nu


def bird_carreau(props: FoamDict) -> Callable:
    nu0, nu_inf, k, n = _coeffs(props, "BirdCarreau", "nu0", "nuInf", "k",
                                "n")

    def nu(mesh, U):
        sr = strain_rate(mesh, U)
        return nu_inf + (nu0 - nu_inf) * (1.0 + (k * sr) ** 2) ** (
            (n - 1.0) / 2.0)

    return nu


def herschel_bulkley(props: FoamDict) -> Callable:
    nu0, tau0, k, n = _coeffs(props, "HerschelBulkley", "nu0", "tau0", "k",
                              "n")

    def nu(mesh, U):
        sr = torch.clamp(strain_rate(mesh, U), min=1e-10)
        return torch.clamp(tau0 / sr + k * sr ** (n - 1.0), max=nu0)

    return nu


_MODELS: Dict[str, Callable] = {
    "Newtonian": newtonian,
    "powerLaw": power_law,
    "CrossPowerLaw": cross_power_law,
    "BirdCarreau": bird_carreau,
    "HerschelBulkley": herschel_bulkley,
}


def select(props: FoamDict) -> Callable:
    """singlePhaseTransportModel::New equivalent."""
    name = str(props.get("transportModel", "Newtonian"))
    return _MODELS[name](props)
