"""LES subgrid-scale models (port of
openfoam-2.2.x_tpu/models/turbulence/les.py: `Smagorinsky` and
`OneEqEddy`), with the filter width of LESdeltas' cubeRootVol.

The filter width is delta = V^(1/3). torch has no cube root, so
`cube_root_vol` computes it once per mesh on the host (np.cbrt of the
cell volumes) and keeps it on the mesh's device: one fetch per mesh, and
no power in the step. LESProperties' `delta` keyword is checked in
`base.select`: cubeRootVol is the only width the reference computes.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.dimensions import dimViscosity
from ...core.fields import VolField
from ...ops import fvm
from .base import TurbulenceModel, bound_below, production, register
from .ras import _gamma_forms, _phi_slotform, _solve_transport

K_MIN = 1e-10


def cube_root_vol(mesh, cache: dict) -> torch.Tensor:
    """delta = cbrt(V) [nC] on the mesh's device, computed on the host
    once per mesh and kept in `cache` (a model's own dict)."""
    if cache.get("mesh") is not mesh:
        v = mesh.v.detach().cpu().numpy()
        cache["mesh"] = mesh
        cache["delta"] = torch.tensor(np.cbrt(v), dtype=mesh.v.dtype,
                                      device=mesh.device)
    return cache["delta"]


class Smagorinsky(TurbulenceModel):
    """Smagorinsky SGS (LES/Smagorinsky/Smagorinsky.C):
    nuSgs = (Ck delta)^2 sqrt(2|symm(grad U)|^2) in the reference's
    Ck/Ce parameterisation, Cs^2 = Ck sqrt(Ck/Ce)."""

    name = "Smagorinsky"
    field_names = ("nut",)
    Ck = 0.094
    Ce = 1.048

    def __init__(self, nu, coeffs=None):
        super().__init__(nu, coeffs)
        c = self.coeffs or {}
        self.Ck = float(c.get("ck", c.get("Ck", self.Ck)))
        self.Ce = float(c.get("ce", c.get("Ce", self.Ce)))
        self._delta_cache = {}

    def delta(self, mesh) -> torch.Tensor:
        return cube_root_vol(mesh, self._delta_cache)

    def nut(self, mesh, tstate):
        return tstate["nut"].data

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, phi_slot=None):
        nut_f: VolField = tstate["nut"]
        delta = self.delta(mesh)
        _, S2 = production(mesh, torch.zeros_like(mesh.v), U)
        # k_sgs = (Ck/Ce) delta^2 S2; nuSgs = Ck delta sqrt(k)
        k_sgs = (self.Ck / self.Ce) * delta ** 2 * S2
        nut_new = self.Ck * delta * torch.sqrt(torch.clamp(k_sgs, min=0.0))
        new_nut = nut_f.with_data(nut_new).correct_boundary_conditions(
            mesh, nu=self.nu, U=U.data)
        new = dict(tstate)
        new["nut"] = new_nut
        return new, {}


class OneEqEddy(Smagorinsky):
    """One-equation eddy-viscosity SGS model (LES/oneEqEddy/oneEqEddy.C):
    a transport equation for k_sgs, nuSgs = Ck delta sqrt(k)."""

    name = "oneEqEddy"
    field_names = ("k", "nut")

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, phi_slot=None):
        k_f: VolField = tstate["k"]
        nut_f: VolField = tstate["nut"]
        k, nut = k_f.data, nut_f.data
        delta = self.delta(mesh)
        rdt = 1.0 / dt

        G, S2 = production(mesh, nut, U)
        eps_coeff = self.Ce * torch.sqrt(torch.clamp(k, min=K_MIN)) / delta
        phi_sl = _phi_slotform(mesh, phi, phi_slot)
        k_flat, k_slot = _gamma_forms(mesh, self.nu, nut_f)
        k_eqn = (
            fvm.ddt(mesh, k_f, k, rdt)
            + fvm.div(mesh, phi, k_f, phi_slot=phi_sl)
            - fvm.laplacian(mesh, k_flat, k_f, corrected=False,
                            gamma_dims=dimViscosity, gamma_slot=k_slot)
            + fvm.Sp(mesh, eps_coeff, k_f)
        )
        k_eqn = k_eqn.add_source(G, mesh)
        k_new, perf = _solve_transport(mesh, k_f, k_eqn, controls)
        k_new = bound_below(k_new, K_MIN)
        nut_new = self.Ck * delta * torch.sqrt(k_new)
        new_nut = nut_f.with_data(nut_new).correct_boundary_conditions(
            mesh, k=k_new, nu=self.nu, U=U.data)
        new = dict(tstate)
        new.update(k=k_f.with_data(k_new), nut=new_nut)
        return new, {"k": perf}


register("Smagorinsky", Smagorinsky)
register("oneEqEddy", OneEqEddy)
