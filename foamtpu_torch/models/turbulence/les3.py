"""The Lagrangian-averaged dynamic Smagorinsky of Meneveau, Lund and Cabot
(port of openfoam-2.2.x_tpu/models/turbulence/les3.py: dynLagrangian).

The dynamic coefficient is averaged along pathlines by transporting the
Germano correlations flm ~ <L:M> and fmm ~ <M:M> with the relaxation time
T = theta delta (flm fmm)^(-1/8):

    ddt(flm) + div(phi, flm) == invT (L:M - flm)
    ddt(fmm) + div(phi, fmm) == invT (M:M - fmm)
    cD = flm / fmm,   nuSgs = cD delta^2 |S|

with les2's test filter and Germano tensors; each equation takes the
upwind weights of ras._div_weights on the flat flux.
"""

from __future__ import annotations

import torch

from ...core.fields import VolField
from ...ops import fvm
from ...solvers import linear
from .base import register
from .les import Smagorinsky
from .les2 import _dev, _filter_tensor, _sym_grad, simple_filter
from .ras import _div_weights


class DynLagrangian(Smagorinsky):
    """LES/dynLagrangian/: the case carries 0/flm and 0/fmm; fmm is
    floored at fmm0."""

    name = "dynLagrangian"
    field_names = ("nut", "flm", "fmm")

    theta = 1.5
    fmm0 = 1e-7

    def __init__(self, nu, coeffs=None):
        super().__init__(nu, coeffs)
        c = self.coeffs or {}
        self.theta = float(c.get("theta", self.theta))

    def correct(self, mesh, tstate, U, phi, dt, steady=False,
                relax=1.0, controls=None, phi_slot=None):
        nut_f: VolField = tstate["nut"]
        flm_f: VolField = tstate["flm"]
        fmm_f: VolField = tstate["fmm"]
        rdt = 1.0 / dt
        delta = self.delta(mesh)
        delta2 = delta ** 2

        S = _sym_grad(mesh, U)
        magS = torch.sqrt(2.0 * torch.sum(S * S, dim=(1, 2)))
        Uf = simple_filter(mesh, U.data)
        UU = torch.einsum("ci,cj->cij", U.data, U.data)
        L = _dev(_filter_tensor(mesh, UU)
                 - torch.einsum("ci,cj->cij", Uf, Uf))
        Sf = _filter_tensor(mesh, S)
        magSf = torch.sqrt(2.0 * torch.sum(Sf * Sf, dim=(1, 2)))
        M = delta2[:, None, None] * (
            4.0 * magSf[:, None, None] * Sf
            - _filter_tensor(mesh, magS[:, None, None] * S))
        LM = torch.sum(L * M, dim=(1, 2))
        MM = torch.sum(M * M, dim=(1, 2))

        flm = torch.clamp(flm_f.data, min=0.0)
        fmm = torch.clamp(fmm_f.data, min=self.fmm0)
        invT = (flm * fmm) ** 0.125 / (self.theta * delta)

        ctl = controls or {"solver": "PBiCGStab", "tolerance": 1e-8,
                           "relTol": 0.01, "maxIter": 200}
        diag, new_vals = {}, {}
        for nm, f, rhs in (("flm", flm_f, LM), ("fmm", fmm_f, MM)):
            w = _div_weights(mesh, phi, f)
            eqn = (fvm.ddt(mesh, f, f.data, rdt)
                   + fvm.div(mesh, phi, f, weights=w)
                   + fvm.Sp(mesh, invT, f))
            eqn = eqn.add_source(invT * rhs, mesh)
            new_vals[nm], diag[nm] = linear.solve(mesh, eqn, f.data, ctl)
        flm_n = torch.clamp(new_vals["flm"], min=0.0)
        fmm_n = torch.clamp(new_vals["fmm"], min=self.fmm0)

        cD = torch.clamp(flm_n / fmm_n, 0.0, 0.5)
        nut_new = cD * delta2 * magS
        new_nut = nut_f.with_data(nut_new).correct_boundary_conditions(
            mesh, nu=self.nu, U=U.data)
        new = dict(tstate)
        new.update(nut=new_nut, flm=flm_f.with_data(flm_n),
                   fmm=fmm_f.with_data(fmm_n))
        return new, diag


register("dynLagrangian", DynLagrangian)
