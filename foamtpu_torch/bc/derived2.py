"""nutUSpaldingWallFunction (port of the Spalding part of
openfoam-2.2.x_tpu/bc/derived2.py: `_spalding_utau` and
`_up_nut_spalding`).

The wall nut comes from Spalding's unified law of the wall, solved for
u_tau by six Newton steps from the larger of the viscous and the log-law
estimates (nutUSpaldingWallFunction::calcUTau). Its value coefficients
are fixedValue's (bc/patchfields.py); the rule is registered into the BC
update registry, so the nut field's `correct_boundary_conditions(U=...,
nu=...)` applies it.
"""

from __future__ import annotations

import torch

from . import patchfields as pf

_KAPPA = 0.41
_E = 9.8


def _spalding_utau(magU, y, nu, n_newton: int = 6):
    """u_tau from y+ = u+ + 1/E [exp(k u+) - 1 - k u+ - (k u+)^2/2 -
    (k u+)^3/6], with y+ = utau y/nu and u+ = magU/utau."""
    re = torch.clamp(magU * y / nu, min=2.0)
    utau = torch.maximum(
        torch.sqrt(torch.clamp(magU * nu / y, min=1e-30)),   # viscous
        _KAPPA * magU / torch.log(_E * re))                  # log estimate
    for _ in range(n_newton):
        ut = torch.clamp(utau, min=1e-12)
        up = magU / ut
        kup = torch.clamp(_KAPPA * up, max=50.0)
        ekup = torch.exp(kup)
        f = (-ut * y / nu + up
             + (ekup - 1.0 - kup - 0.5 * kup ** 2 - kup ** 3 / 6.0) / _E)
        df = (y / nu
              + magU / ut ** 2
              + (kup / ut) * (ekup - 1.0 - kup - 0.5 * kup ** 2) / _E)
        utau = torch.clamp(ut + f / torch.clamp(df, min=1e-30), min=0.0)
    return utau


def _up_nut_spalding(bc, mesh, patch, internal, *, U=None, nu=None,
                     **ctx):
    """nutUSpaldingWallFunction (wallFunctions/nutWallFunctions/
    nutUSpaldingWallFunction/)."""
    if U is None or nu is None:
        return bc
    cells = mesh.owner[patch.slice]
    y = 1.0 / torch.clamp(mesh.delta_coeffs[patch.slice], min=1e-30)
    n = pf._patch_normals(mesh, patch)
    Uc = U[cells]
    Ut = Uc - n * torch.sum(n * Uc, dim=1, keepdim=True)
    magU = torch.clamp(torch.linalg.norm(Ut, dim=1), min=1e-12)
    utau = _spalding_utau(magU, y, nu)
    nutw = torch.clamp(utau ** 2 * y / magU - nu, min=0.0)
    return bc.replace(ref_value=nutw, vfrac=torch.ones_like(nutw))


pf.register_update("nutUSpaldingWallFunction", _up_nut_spalding)
