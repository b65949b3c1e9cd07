"""The cubic Lien family, Lien-Leschziner low-Re and SA-IDDES (port of
openfoam-2.2.x_tpu/models/turbulence/ras4.py: LienCubicKE,
LienCubicKELowRe, LienLeschzinerLowRe and SpalartAllmarasIDDES).

The cubic terms proportional to S enter as a strain- and
vorticity-dependent eddy viscosity (the reference's C5viscosity_), a
per-cell factor on nut. IDDES's blending functions are elementwise over
the wall distance; its hmax and Delta are cbrt(V) from the host volumes,
as SpalartAllmarasDDES's CDES delta.
"""

from __future__ import annotations

import torch

from ...core.precision import DEFAULT_DEVICE
from ...ops import fvc
from .base import register
from .ras import (EPS_MIN, K_MIN, KEpsilon, SpalartAllmarasDDES,
                  _cdes_delta)
from .ras2 import _WallDistance
from .ras3 import NonlinearKEShih


def _lien_damping(model, k, eps):
    """The Lien-Leschziner damping: fMu = (1 - exp(-Am y*)) /
    (1 - exp(-Aeps y*)) in [1e-4, 1], y* = sqrt(k) y / nu, and
    f2 = 1 - 0.3 exp(-Rt^2), Rt = k^2/(nu eps)."""
    y_star = torch.sqrt(torch.clamp(k, min=K_MIN)) * model.y_wall / model.nu
    fmu = ((1.0 - torch.exp(-model.Am * y_star))
           / torch.clamp(1.0 - torch.exp(-model.Aepsilon * y_star),
                         min=1e-6))
    fmu = torch.clamp(fmu, 1e-4, 1.0)
    Rt = k * k / (model.nu * torch.clamp(eps, min=EPS_MIN))
    f2 = 1.0 - 0.3 * torch.exp(-torch.clamp(Rt * Rt, max=50.0))
    return fmu, f2


class LienCubicKE(NonlinearKEShih):
    """Lien cubic nonlinear k-epsilon (RAS/LienCubicKE/): the Shih
    quadratic stress plus the cubic terms, which in the Lien coefficient
    set enter as the viscosity

        nut = [Cmu - 4 Cmu^3 (eta^2 - ksi^2)] k^2/eps

    its correction factor clipped to [0.05, 2]."""

    name = "LienCubicKE"

    def _cmu_eff(self, eta, ksi):
        cmu = self._cmu_var(eta, ksi)
        corr = torch.clamp(1.0 - 4.0 * cmu * cmu * (eta ** 2 - ksi ** 2),
                           0.05, 2.0)
        return cmu * corr

    def _lowre_damping(self, k, eps):
        """(fMu factor on nut, C2 field); none at high Re."""
        return None, None

    def correct(self, mesh, tstate, U, phi, dt, steady=False,
                relax=1.0, controls=None, phi_slot=None, **kw):
        k = tstate["k"].data
        eps = tstate["epsilon"].data
        nls, g = self.nonlinear_stress(mesh, U, k, eps)
        G_extra = -torch.sum(nls * g, dim=(1, 2))
        eta, ksi = self._eta_ksi(g, k, eps)
        fmu = self._cmu_eff(eta, ksi) / 0.09
        fmu_lowre, c2 = self._lowre_damping(k, eps)
        if fmu_lowre is not None:
            fmu = fmu * fmu_lowre
        return KEpsilon.correct(self, mesh, tstate, U, phi, dt,
                                steady=steady, relax=relax,
                                controls=controls, phi_slot=phi_slot,
                                fmu_field=fmu, c2_field=c2,
                                G_extra=G_extra)


class LienCubicKELowRe(_WallDistance, LienCubicKE):
    """Low-Re cubic Lien k-epsilon (RAS/LienCubicKELowRe/): the cubic
    model integrated to the wall with the Lien-Leschziner damping
    (`_lien_damping`); the reference's near-wall epsilon source is left
    out, as in the reference package."""

    name = "LienCubicKELowRe"
    Am = 0.016
    Aepsilon = 0.263

    def __init__(self, nu, coeffs=None):
        super().__init__(nu, coeffs)
        c = self.coeffs or {}
        self.Am = float(c.get("Am", self.Am))
        self.Aepsilon = float(c.get("Aepsilon", self.Aepsilon))

    def _lowre_damping(self, k, eps):
        fmu, f2 = _lien_damping(self, k, eps)
        return fmu, self.C2 * f2


class LienLeschzinerLowRe(_WallDistance, KEpsilon):
    """Lien-Leschziner linear low-Re k-epsilon
    (RAS/LienLeschzinerLowRe/): kEpsilon integrated to the wall with the
    damping of `_lien_damping`."""

    name = "LienLeschzinerLowRe"
    Am = 0.016
    Aepsilon = 0.263

    def __init__(self, nu, coeffs=None):
        super().__init__(nu, coeffs)
        c = self.coeffs or {}
        self.Am = float(c.get("Am", self.Am))
        self.Aepsilon = float(c.get("Aepsilon", self.Aepsilon))

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, phi_slot=None, **kw):
        fmu, f2 = _lien_damping(self, tstate["k"].data,
                                tstate["epsilon"].data)
        return super().correct(mesh, tstate, U, phi, dt, steady, relax,
                               controls, phi_slot=phi_slot,
                               fmu_field=fmu, c2_field=self.C2 * f2)


class SpalartAllmarasIDDES(SpalartAllmarasDDES):
    """Improved delayed DES (LES/SpalartAllmarasIDDES/; Shur et al. 2008):

        alpha = 0.25 - y/hmax
        fB  = min(2 exp(-9 alpha^2), 1)
        fe1 = 2 exp(-11.09 alpha^2)  (alpha >= 0), 2 exp(-9 alpha^2) else
        fe2 = 1 - max(ft, fl);  ft = tanh((Ct^2 rdt)^3),
                                fl = tanh((Cl^2 rdl)^10)
        fe  = max(fe1 - 1, 0) fe2
        fdt = 1 - tanh((8 rdt)^3);  fdTilda = max(1 - fdt, fB)
        dTilda = max(fdTilda (1 + fe) y + (1 - fdTilda) CDES Delta, 1e-10)

    rdt and rdl are the eddy and molecular viscosity over
    kappa^2 y^2 |grad U|; hmax and Delta are cbrt(V), as in the reference
    package."""

    name = "SpalartAllmarasIDDES"
    Ct = 1.63
    Cl = 3.55

    def __init__(self, nu, coeffs=None, y_wall=None):
        super().__init__(nu, coeffs, y_wall)
        c = self.coeffs or {}
        self.Ct = float(c.get("Ct", self.Ct))
        self.Cl = float(c.get("Cl", self.Cl))

    def init_wall_distance(self, poly_mesh, dtype, device=DEFAULT_DEVICE):
        super().init_wall_distance(poly_mesh, dtype, device)
        self._hmax = _cdes_delta(poly_mesh, 1.0, dtype, device)

    def d_tilda(self, mesh, U, nuT_f):
        y = self.y_wall
        g = fvc.grad(mesh, U)
        mag_gu = torch.sqrt(torch.clamp(torch.sum(g * g, dim=(1, 2)),
                                        min=1e-20))
        denom = mag_gu * (self.kappa * y) ** 2 + 1e-20
        chi = nuT_f.data / self.nu
        nut = nuT_f.data * self._fv1(chi)
        rdt = torch.clamp(nut / denom, max=10.0)
        rdl = torch.clamp(self.nu / denom, max=10.0)
        alpha = 0.25 - y / self._hmax
        fB = torch.clamp(2.0 * torch.exp(-9.0 * alpha ** 2), max=1.0)
        ft = torch.tanh((self.Ct ** 2 * rdt) ** 3)
        fl = torch.tanh((self.Cl ** 2 * rdl) ** 10)
        fe2 = 1.0 - torch.maximum(ft, fl)
        fe1 = torch.where(alpha >= 0.0,
                          2.0 * torch.exp(-11.09 * alpha ** 2),
                          2.0 * torch.exp(-9.0 * alpha ** 2))
        fe = torch.clamp(fe1 - 1.0, min=0.0) * fe2
        fdt = 1.0 - torch.tanh((8.0 * rdt) ** 3)
        fd = torch.maximum(1.0 - fdt, fB)
        return torch.clamp(
            fd * (1.0 + fe) * y + (1.0 - fd) * self._cdes_delta, min=1e-10)


register("LienCubicKE", LienCubicKE)
register("LienCubicKELowRe", LienCubicKELowRe)
register("LienLeschzinerLowRe", LienLeschzinerLowRe)
register("SpalartAllmarasIDDES", SpalartAllmarasIDDES)
