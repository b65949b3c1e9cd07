"""Differential-stress and localized-dynamic LES closures (port of
openfoam-2.2.x_tpu/models/turbulence/les4.py: locDynOneEqEddy,
dynMixedSmagorinsky, DeardorffDiffStress, `_dev6`, LRDDiffStress and
spectEddyVisc).

The stress-transport models carry the subgrid stress B as one [nC, 6]
field whose six components solve against one matrix (as ras2.LRR's R):
the SpMV sees an [n, 6] operand. Their dissipation is algebraic at the
subgrid scale (eps = Ce k^(3/2)/delta). The localized dynamic
coefficient is the per-cell Germano contraction smoothed by one test
filter, clipped to [0, 0.5], as in the reference package. The filter
width is les.cube_root_vol.
"""

from __future__ import annotations

import torch

from ...core.dimensions import dimViscosity
from ...core.fields import VolField
from ...ops import fvc, fvm
from ...ops import slot as slot_mod
from .base import TurbulenceModel, production, register
from .les import K_MIN, OneEqEddy, Smagorinsky, cube_root_vol
from .les2 import (DynOneEqEddy, HomogeneousDynSmagorinsky, _dev,
                   _filter_tensor, _sym_grad, simple_filter)
from .ras import _phi_slotform, _solve_transport, _transport_ops
from .ras2 import (_cell_gamma, _div_symm_tensor, dev6, eye6,
                   floor_normals, full_to_symm, half_trace,
                   stress_production)


# dev of a [nC, 6] symmetric tensor
_dev6 = dev6


class LocDynOneEqEddy(DynOneEqEddy):
    """Localized dynamic one-equation eddy viscosity
    (LES/locDynOneEqEddy/): Ck per cell from the Germano identity, the
    cellwise contraction smoothed by one test filter and clipped to
    [0, 0.5]."""

    name = "locDynOneEqEddy"

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, phi_slot=None):
        k = torch.clamp(tstate["k"].data, min=K_MIN)
        delta = self.delta(mesh)
        S = _sym_grad(mesh, U)
        Uf = simple_filter(mesh, U.data)
        UU = torch.einsum("ci,cj->cij", U.data, U.data)
        L = _dev(_filter_tensor(mesh, UU)
                 - torch.einsum("ci,cj->cij", Uf, Uf))
        KK = torch.clamp(
            0.5 * (simple_filter(mesh, torch.sum(U.data ** 2, dim=1))
                   - torch.sum(Uf ** 2, dim=1)), min=0.0)
        kf = torch.clamp(simple_filter(mesh, k), min=K_MIN)
        Sf = _filter_tensor(mesh, S)
        M = delta[:, None, None] * (
            _filter_tensor(mesh, torch.sqrt(k)[:, None, None] * S)
            - 2.0 * torch.sqrt(kf + KK)[:, None, None] * Sf)
        # localized: the per-cell contraction, filter-smoothed
        num = simple_filter(mesh, torch.sum(L * M, dim=(1, 2)))
        den = simple_filter(mesh, torch.sum(M * M, dim=(1, 2)))
        ck = -num / torch.clamp(2.0 * den, min=1e-30)
        ck = torch.clamp(ck, 0.0, 0.5)
        new, diag = OneEqEddy.correct(self, mesh, tstate, U, phi, dt,
                                      steady, relax, controls,
                                      phi_slot=phi_slot)
        k_new = torch.clamp(new["k"].data, min=K_MIN)
        nut_new = ck * delta * torch.sqrt(k_new)
        new["nut"] = new["nut"].with_data(
            nut_new).correct_boundary_conditions(
            mesh, k=k_new, nu=self.nu, U=U.data)
        return new, diag


class DynMixedSmagorinsky(HomogeneousDynSmagorinsky):
    """Dynamic Smagorinsky plus Bardina scale similarity
    (LES/dynMixedSmagorinsky/): the resolved scale-similarity stress is
    added explicitly to the dynamic eddy viscosity's momentum term."""

    name = "dynMixedSmagorinsky"

    def div_dev_reff(self, mesh, tstate, U: VolField):
        mat, src = super().div_dev_reff(mesh, tstate, U)
        Uf = simple_filter(mesh, U.data)
        UU = torch.einsum("ci,cj->cij", U.data, U.data)
        B = _dev(_filter_tensor(mesh, UU)
                 - torch.einsum("ci,cj->cij", Uf, Uf))
        return mat, src + _div_symm_tensor(mesh, full_to_symm(B))


class DeardorffDiffStress(TurbulenceModel):
    """Deardorff SGS stress transport (LES/DeardorffDiffStress/;
    Deardorff 1973): the subgrid stress B [nC,6],

        P = -twoSymm(B & grad U)
        eps = Ce k^{3/2}/delta          (algebraic, k = tr(B)/2)
        BEqn: ddt(B) + div(phi,B) - lap(DBEff,B)
              + Sp(Cm sqrt(k)/delta) B
              == P + (2/3)(Cm sqrt(k)/delta) k I - (2/3) eps I

    with DBEff = nu + Cs k^2/eps and nuSgs = Ck delta sqrt(k). The six
    components solve against one matrix."""

    name = "DeardorffDiffStress"
    field_names = ("B", "k", "nut")

    Ck = 0.094
    Cm = 4.13
    Ce = 1.048
    Cs = 0.25

    def __init__(self, nu, coeffs=None):
        super().__init__(nu, coeffs)
        c = self.coeffs or {}
        for key in ("Ck", "Cm", "Ce", "Cs"):
            setattr(self, key, float(c.get(
                key, c.get(key.lower(), getattr(self, key)))))
        self._delta_cache = {}

    def nut(self, mesh, tstate):
        return tstate["nut"].data

    def _rapid_term(self, P6):
        """LRDDiffStress's -C2 dev(P); Deardorff has none."""
        return None

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, phi_slot=None):
        B_f: VolField = tstate["B"]
        k_fld: VolField = tstate["k"]
        nut_f: VolField = tstate["nut"]
        B6 = B_f.data
        delta = cube_root_vol(mesh, self._delta_cache)
        rdt = 1.0 / dt
        phi_sl = _phi_slotform(mesh, phi, phi_slot)

        k = half_trace(B6)
        sqrtk = torch.sqrt(k)
        eps = self.Ce * sqrtk ** 3 / delta
        P6 = stress_production(B6, fvc.grad(mesh, U))

        dB_flat, dB_slot = _cell_gamma(
            mesh, self.nu + self.Cs * k * k / torch.clamp(eps, min=1e-20))
        rotta = self.Cm * sqrtk / delta
        B_eqn = (
            fvm.ddt(mesh, B_f, B6, rdt)
            + _transport_ops(mesh, phi, phi_sl, B_f, self.div_scheme,
                             dB_flat, dB_slot, self.corrected,
                             self.corr_limit)
            + fvm.Sp(mesh, rotta, B_f)
        )
        I6 = eye6(B6)
        srcB = (P6
                + ((2.0 / 3.0) * rotta * k)[:, None] * I6
                - ((2.0 / 3.0) * eps)[:, None] * I6)
        rapid = self._rapid_term(P6)
        if rapid is not None:
            srcB = srcB + rapid
        B_eqn = B_eqn.add_source(srcB, mesh)
        B_new, perf = _solve_transport(mesh, B_f, B_eqn, controls)
        B_new = floor_normals(B_new)
        k_new = half_trace(B_new)
        nut_new = self.Ck * delta * torch.sqrt(k_new)
        new_nut = nut_f.with_data(nut_new).correct_boundary_conditions(
            mesh, k=k_new, nu=self.nu, U=U.data)
        new = dict(tstate)
        new.update(B=B_f.with_data(B_new), k=k_fld.with_data(k_new),
                   nut=new_nut)
        return new, {"B": perf}

    def div_dev_reff(self, mesh, tstate, U: VolField):
        """fvc::div(dev(B)) + fvc::laplacian(nuSgs, U)
        - fvm::laplacian(nuEff, U) (DeardorffDiffStress::divDevBeff)."""
        nu_slot = self.nu_eff_slot(mesh, tstate)
        mat = -fvm.laplacian(mesh, slot_mod.to_flat(mesh, nu_slot), U,
                             corrected=self.corrected,
                             gamma_dims=dimViscosity,
                             limit=self.corr_limit, gamma_slot=nu_slot)
        div_B = _div_symm_tensor(mesh, _dev6(tstate["B"].data))
        nut_face = self.nu_eff_face(mesh, tstate) - self.nu
        lap_U = fvc.laplacian(mesh, nut_face, U, corrected=False)
        return mat, div_B + lap_U


class LRDDiffStress(DeardorffDiffStress):
    """LRR-type SGS stress transport (LES/LRDDiffStress/): Deardorff plus
    the LRR rapid pressure-strain term -C2 dev(P)."""

    name = "LRDDiffStress"
    C2 = 0.6

    def __init__(self, nu, coeffs=None):
        super().__init__(nu, coeffs)
        c = self.coeffs or {}
        self.C2 = float(c.get("C2", self.C2))

    def _rapid_term(self, P6):
        return -self.C2 * dev6(P6)


class SpectEddyVisc(Smagorinsky):
    """Spectral eddy viscosity (LES/spectEddyVisc/): the subgrid energy is
    the Kolmogorov spectrum integrated from the grid cutoff to the
    dissipation scale,

        eps = 2 nuEff |symm(grad U)|^2          (the previous step's nuEff)
        k   = cK1 (delta eps)^{2/3}
                  exp(-cK2 delta^{-4/3} nu eps^{-1/3})
            - cK3 sqrt(nu eps)
                  erfc(cK4 delta^{-2/3} sqrt(nu) eps^{-1/6})
        nuSgs = Ck delta sqrt(k)."""

    name = "spectEddyVisc"
    cK1 = 0.83
    cK2 = 1.03
    cK3 = 4.75
    cK4 = 2.55

    def __init__(self, nu, coeffs=None):
        super().__init__(nu, coeffs)
        c = self.coeffs or {}
        for key in ("cK1", "cK2", "cK3", "cK4"):
            setattr(self, key, float(c.get(key, getattr(self, key))))

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, phi_slot=None):
        nut_f = tstate["nut"]
        delta = self.delta(mesh)
        _, S2 = production(mesh, torch.zeros_like(mesh.v), U)
        eps = torch.clamp(2.0 * (self.nu + nut_f.data) * 0.5 * S2,
                          min=1e-20)
        nu = self.nu
        k = (self.cK1 * (delta * eps) ** (2.0 / 3.0)
             * torch.exp(-self.cK2 * delta ** (-4.0 / 3.0) * nu
                         * eps ** (-1.0 / 3.0))
             - self.cK3 * torch.sqrt(nu * eps)
             * torch.special.erfc(self.cK4 * delta ** (-2.0 / 3.0)
                                  * nu ** 0.5 * eps ** (-1.0 / 6.0)))
        k = torch.clamp(k, min=0.0)
        nut_new = self.Ck * delta * torch.sqrt(k)
        new_nut = nut_f.with_data(nut_new).correct_boundary_conditions(
            mesh, k=k, nu=self.nu, U=U.data)
        new = dict(tstate)
        new["nut"] = new_nut
        return new, {}


register("spectEddyVisc", SpectEddyVisc)
register("locDynOneEqEddy", LocDynOneEqEddy)
register("dynMixedSmagorinsky", DynMixedSmagorinsky)
register("DeardorffDiffStress", DeardorffDiffStress)
register("LRDDiffStress", LRDDiffStress)
