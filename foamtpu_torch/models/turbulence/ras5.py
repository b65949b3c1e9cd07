"""kkLOmega, the Walters-Cokljat three-equation transition model (port of
openfoam-2.2.x_tpu/models/turbulence/ras5.py).

Transports the turbulent kinetic energy kt, the laminar kinetic energy kl
and omega; bypass and natural transition move energy from kl to kt. The
damping and transition functions are elementwise over (kt, kl, omega,
|S|, |Omega|, y); the wall distance comes from the host mesh through
`init_wall_distance`. The constants are the published Walters-Cokljat
(2008) values.
"""

from __future__ import annotations

from typing import Dict

import torch

from ...core.fields import VolField
from ...ops import fvc, fvm
from .base import TurbulenceModel, bound_below, register
from .ras import (K_MIN, OMEGA_MIN, _phi_slotform, _solve_transport,
                  _transport_ops)
from .ras2 import _WallDistance, _cell_gamma


class KKLOmega(_WallDistance, TurbulenceModel):
    """Walters-Cokljat kt-kl-omega transitional model (RAS/kkLOmega/). It
    integrates to the wall: kt = kl = 0 and omega zeroGradient there."""

    name = "kkLOmega"
    field_names = ("kt", "kl", "omega", "nut")

    A0 = 4.04
    As = 2.12
    Av = 6.75
    Abp = 0.6
    Anat = 200.0
    Ats = 200.0
    CbpCrit = 1.2
    Cnc = 0.1
    CnatCrit = 1250.0
    Cint = 0.75
    CtsCrit = 1000.0
    CrNat = 0.02
    C11 = 3.4e-6
    C12 = 1.0e-10
    CR = 0.12
    CalphaTheta = 0.035
    Css = 1.5
    CtauL = 4360.0
    Cw1 = 0.44
    Cw2 = 0.92
    Cw3 = 0.3
    CwR = 1.5
    Clambda = 2.495
    CmuStd = 0.09
    Sigmak = 1.0
    Sigmaw = 1.17

    def __init__(self, nu, coeffs=None):
        super().__init__(nu, coeffs)
        c = self.coeffs or {}
        for key in ("A0", "As", "Av", "Abp", "Anat", "Ats", "CbpCrit",
                    "Cnc", "CnatCrit", "Cint", "CtsCrit", "CrNat",
                    "C11", "C12", "CR", "CalphaTheta", "Css", "CtauL",
                    "Cw1", "Cw2", "Cw3", "CwR", "Clambda", "CmuStd",
                    "Sigmak", "Sigmaw"):
            setattr(self, key, float(c.get(key, getattr(self, key))))

    def nut(self, mesh, tstate):
        return tstate["nut"].data

    def _functions(self, kt, kl, omega, S2, W2):
        """The model functions (Walters & Cokljat 2008, Table 1)."""
        nu = self.nu
        y = self.y_wall
        S = torch.sqrt(torch.clamp(S2, min=1e-20))
        Om = torch.sqrt(torch.clamp(W2, min=1e-20))
        kt_s = torch.clamp(kt, min=K_MIN)
        om_s = torch.clamp(omega, min=OMEGA_MIN)

        lambdaT = torch.sqrt(kt_s) / om_s
        lambdaEff = torch.minimum(self.Clambda * y, lambdaT)
        fW = (lambdaEff / torch.clamp(lambdaT, min=1e-20)) ** (2.0 / 3.0)
        fSS = torch.exp(-((self.Css * nu * Om / kt_s) ** 2))
        ktS = fSS * fW * kt                      # small-scale energy
        ktL = torch.clamp(kt - ktS, min=0.0)     # large-scale energy
        ReT = fW ** 2 * kt_s / (nu * om_s)
        fNu = 1.0 - torch.exp(-torch.sqrt(torch.clamp(ReT, min=0.0))
                              / self.Av)
        fINT = torch.clamp(kt / (self.Cint
                                 * torch.clamp(kl + kt, min=K_MIN)), max=1.0)
        Cmu = 1.0 / (self.A0 + self.As * S / om_s)
        nuts = fNu * fINT * Cmu * torch.sqrt(torch.clamp(ktS, min=0.0)) \
            * lambdaEff
        # the large-scale (laminar) production viscosity
        ReOmega = y ** 2 * Om / nu
        betaTS = 1.0 - torch.exp(
            -torch.clamp(ReOmega - self.CtsCrit, min=0.0) ** 2 / self.Ats)
        fTaul = 1.0 - torch.exp(
            -self.CtauL * ktL
            / torch.clamp((lambdaEff * Om) ** 2, min=1e-20))
        nutl = (self.C11 * fTaul * Om * lambdaEff ** 2
                * torch.sqrt(torch.clamp(ktL, min=0.0)) * lambdaEff / nu
                + self.C12 * betaTS * ReOmega * y ** 2 * Om)
        nutl = torch.minimum(nutl,
                             0.5 * (kl + ktL) / torch.clamp(S, min=1e-10))
        # bypass and natural transition rates (per unit kl)
        phiBP = torch.clamp(kt / (nu * Om) - self.CbpCrit, 0.0, 50.0)
        betaBP = 1.0 - torch.exp(-phiBP / self.Abp)
        R_BP = self.CR * betaBP * omega / torch.clamp(fW, min=1e-6)
        fNatCrit = 1.0 - torch.exp(
            -self.Cnc * torch.sqrt(torch.clamp(kl, min=0.0)) * y / nu)
        betaNAT = 1.0 - torch.exp(
            -torch.clamp(ReOmega
                         - self.CnatCrit
                         / torch.clamp(fNatCrit, min=1e-6), min=0.0)
            / self.Anat)
        R_NAT = self.CrNat * betaNAT * Om
        fOmega = 1.0 - torch.exp(
            -0.41 * (lambdaEff / torch.clamp(lambdaT, min=1e-20)) ** 4)
        alphaT = fNu * self.CmuStd * torch.sqrt(torch.clamp(ktS, min=0.0)) \
            * lambdaEff
        return dict(lambdaEff=lambdaEff, fW=fW, ktS=ktS, ktL=ktL,
                    nuts=nuts, nutl=nutl, R_BP=R_BP, R_NAT=R_NAT,
                    fOmega=fOmega, alphaT=alphaT, S=S, Om=Om)

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, phi_slot=None):
        kt_f: VolField = tstate["kt"]
        kl_f: VolField = tstate["kl"]
        om_f: VolField = tstate["omega"]
        nut_f: VolField = tstate["nut"]
        kt, kl, omega = kt_f.data, kl_f.data, om_f.data
        rdt = 1.0 / dt
        diag: Dict = {}
        phi_sl = _phi_slotform(mesh, phi, phi_slot)

        g = fvc.grad(mesh, U)
        Ssym = 0.5 * (g + torch.transpose(g, 1, 2))
        Wskw = 0.5 * (g - torch.transpose(g, 1, 2))
        S2 = 2.0 * torch.sum(Ssym * Ssym, dim=(1, 2))
        W2 = 2.0 * torch.sum(Wskw * Wskw, dim=(1, 2))
        f = self._functions(kt, kl, omega, S2, W2)

        PkT = f["nuts"] * S2
        PkL = f["nutl"] * S2
        transfer = (f["R_BP"] + f["R_NAT"]) * kl   # kl -> kt
        # wall dissipation D = 2 nu |grad sqrt(k)|^2
        sqkt = kt_f.with_data(torch.sqrt(torch.clamp(kt, min=0.0)))
        sqkl = kl_f.with_data(torch.sqrt(torch.clamp(kl, min=0.0)))
        DT = 2.0 * self.nu * torch.sum(fvc.grad(mesh, sqkt) ** 2, dim=1)
        DL = 2.0 * self.nu * torch.sum(fvc.grad(mesh, sqkl) ** 2, dim=1)

        kt_s = torch.clamp(kt, min=K_MIN)
        # kt
        gam_f, gam_sl = _cell_gamma(mesh, self.nu + f["alphaT"] / self.Sigmak)
        ddt_kt = (fvm.ddt(mesh, kt_f, kt, rdt) if not steady
                  else fvm.ddt_steady(mesh, kt_f))
        kt_eqn = (
            ddt_kt
            + _transport_ops(mesh, phi, phi_sl, kt_f, self.div_scheme,
                             gam_f, gam_sl, self.corrected,
                             self.corr_limit)
            + fvm.Sp(mesh, omega + DT / kt_s, kt_f)
        )
        kt_eqn = kt_eqn.add_source(PkT + transfer, mesh)
        if steady and relax < 1.0:
            kt_eqn = kt_eqn.relax(mesh, relax, kt)
        kt_new, perf = _solve_transport(mesh, kt_f, kt_eqn, controls)
        kt_new = bound_below(kt_new, K_MIN)
        diag["kt"] = perf

        # kl (molecular diffusion only)
        nu_flat = torch.tensor(self.nu, dtype=kt.dtype, device=kt.device)
        ddt_kl = (fvm.ddt(mesh, kl_f, kl, rdt) if not steady
                  else fvm.ddt_steady(mesh, kl_f))
        kl_eqn = (
            ddt_kl
            + _transport_ops(mesh, phi, phi_sl, kl_f, self.div_scheme,
                             nu_flat, None, self.corrected,
                             self.corr_limit)
            + fvm.Sp(mesh, f["R_BP"] + f["R_NAT"]
                     + DL / torch.clamp(kl, min=K_MIN), kl_f)
        )
        kl_eqn = kl_eqn.add_source(PkL, mesh)
        if steady and relax < 1.0:
            kl_eqn = kl_eqn.relax(mesh, relax, kl)
        kl_new, perf = _solve_transport(mesh, kl_f, kl_eqn, controls)
        kl_new = bound_below(kl_new, K_MIN)
        diag["kl"] = perf

        # omega
        gam_f, gam_sl = _cell_gamma(mesh, self.nu + f["alphaT"] / self.Sigmaw)
        ddt_om = (fvm.ddt(mesh, om_f, omega, rdt) if not steady
                  else fvm.ddt_steady(mesh, om_f))
        om_eqn = (
            ddt_om
            + _transport_ops(mesh, phi, phi_sl, om_f, self.div_scheme,
                             gam_f, gam_sl, self.corrected,
                             self.corr_limit)
            + fvm.Sp(mesh, self.Cw2 * f["fW"] ** 2 * omega, om_f)
        )
        src_om = (self.Cw1 * PkT * omega / kt_s
                  + (self.CwR / torch.clamp(f["fW"], min=1e-6) - 1.0)
                  * omega / kt_s * transfer
                  + self.Cw3 * f["fOmega"] * f["alphaT"]
                  * f["fW"] ** 2 * torch.sqrt(kt_s) / self.y_wall ** 3)
        om_eqn = om_eqn.add_source(src_om, mesh)
        if steady and relax < 1.0:
            om_eqn = om_eqn.relax(mesh, relax, omega)
        om_new, perf = _solve_transport(mesh, om_f, om_eqn, controls)
        om_new = bound_below(om_new, OMEGA_MIN)
        diag["omega"] = perf

        f_new = self._functions(kt_new, kl_new, om_new, S2, W2)
        nut_new = torch.clamp(f_new["nuts"] + f_new["nutl"], min=0.0)
        new_nut = nut_f.with_data(nut_new).correct_boundary_conditions(
            mesh, k=kt_new, nu=self.nu, U=U.data)
        new = dict(tstate)
        new.update(kt=kt_f.with_data(kt_new), kl=kl_f.with_data(kl_new),
                   omega=om_f.with_data(om_new), nut=new_nut)
        return new, diag


register("kkLOmega", KKLOmega)
