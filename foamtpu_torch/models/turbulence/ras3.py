"""The Shih quadratic nonlinear k-epsilon (port of
openfoam-2.2.x_tpu/models/turbulence/ras3.py: NonlinearKEShih).

The nonlinear stress is an elementwise [nC,3,3] expression of grad(U); its
divergence goes through ras2._div_symm_tensor. The variable Cmu and the
nonlinear stress are taken from the previous step's k and epsilon, as in
the reference.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ...core.fields import VolField
from ...ops import fvc
from .base import register
from .ras import EPS_MIN, K_MIN, KEpsilon
from .ras2 import _div_symm_tensor, full_to_symm


class NonlinearKEShih(KEpsilon):
    """Shih quadratic nonlinear k-epsilon (RAS/NonlinearKEShih/):

        eta = (k/eps) sqrt(2 S:S),  ksi = (k/eps) sqrt(2 W:W)
        Cmu = (2/3) / (A1 + eta + alphaKsi ksi)
        fEta = A2 + eta^3
        NLS = symm( (k^3/eps^2) [ Ctau1/fEta (gU.gU + (gU.gU)^T)
                                 + Ctau2/fEta (gU.gU^T)
                                 + Ctau3/fEta (gU^T.gU) ] )
        divDevReff += fvc::div(NLS);  G -= NLS && grad(U)
    """

    name = "NonlinearKEShih"
    field_names = ("k", "epsilon", "nut")

    C1 = 1.44
    C2 = 1.92
    sigma_k = 1.0
    sigma_eps = 1.3
    A1 = 1.25
    A2 = 1000.0
    Ctau1 = -4.0
    Ctau2 = 13.0
    Ctau3 = -2.0
    alphaKsi = 0.9

    def __init__(self, nu, coeffs=None):
        super().__init__(nu, coeffs)
        c = self.coeffs or {}
        for key in ("A1", "A2", "Ctau1", "Ctau2", "Ctau3", "alphaKsi"):
            setattr(self, key, float(c.get(key, getattr(self, key))))

    def _eta_ksi(self, g, k, eps):
        S = 0.5 * (g + torch.transpose(g, 1, 2))
        W = 0.5 * (g - torch.transpose(g, 1, 2))
        ke = k / torch.clamp(eps, min=EPS_MIN)
        eta = ke * torch.sqrt(2.0 * torch.sum(S * S, dim=(1, 2)))
        ksi = ke * torch.sqrt(2.0 * torch.sum(W * W, dim=(1, 2)))
        return eta, ksi

    def _cmu_var(self, eta, ksi):
        return (2.0 / 3.0) / (self.A1 + eta + self.alphaKsi * ksi)

    def nonlinear_stress(self, mesh, U: VolField, k, eps
                         ) -> Tuple[Any, Any]:
        """-> (NLS [nC,3,3] in m^2/s^2, grad U)."""
        g = fvc.grad(mesh, U)                    # g[c,i,j] = d_i u_j
        eta, _ = self._eta_ksi(g, k, eps)
        fEta = self.A2 + eta ** 3
        k3e2 = (torch.clamp(k, min=K_MIN) ** 3
                / torch.clamp(eps, min=EPS_MIN) ** 2 / fEta)
        gg = torch.einsum("cik,ckj->cij", g, g)
        ggT = torch.einsum("cik,cjk->cij", g, g)   # gU . gU^T
        gTg = torch.einsum("cki,ckj->cij", g, g)   # gU^T . gU
        t = (self.Ctau1 * (gg + torch.transpose(gg, 1, 2))
             + self.Ctau2 * ggT + self.Ctau3 * gTg)
        t = k3e2[:, None, None] * t
        return 0.5 * (t + torch.transpose(t, 1, 2)), g

    def _nut_from(self, k, eps):
        # the variable Cmu enters through fmu_field in correct()
        return 0.09 * k * k / torch.clamp(eps, min=EPS_MIN)

    def div_dev_reff(self, mesh, tstate, U: VolField):
        mat, expl = super().div_dev_reff(mesh, tstate, U)
        nls, _ = self.nonlinear_stress(
            mesh, U, tstate["k"].data, tstate["epsilon"].data)
        return mat, expl + _div_symm_tensor(mesh, full_to_symm(nls))

    def correct(self, mesh, tstate, U, phi, dt, steady=False,
                relax=1.0, controls=None, phi_slot=None, **kw):
        k = tstate["k"].data
        eps = tstate["epsilon"].data
        nls, g = self.nonlinear_stress(mesh, U, k, eps)
        G_extra = -torch.sum(nls * g, dim=(1, 2))
        eta, ksi = self._eta_ksi(g, k, eps)
        fmu = self._cmu_var(eta, ksi) / 0.09
        return super().correct(mesh, tstate, U, phi, dt, steady=steady,
                               relax=relax, controls=controls,
                               phi_slot=phi_slot, fmu_field=fmu,
                               G_extra=G_extra)


register("NonlinearKEShih", NonlinearKEShih)
