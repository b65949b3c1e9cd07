"""Dynamic and scale-similarity LES subgrid models (port of
openfoam-2.2.x_tpu/models/turbulence/les2.py): the test filter
`simple_filter` (LESfilters/simpleFilter) with `_filter_tensor`,
`_vavg`, `_sym_grad` and `_dev`, and the models
homogeneousDynSmagorinsky, dynOneEqEddy, scaleSimilarity and
mixedSmagorinsky.

The test filter is the face-area-weighted neighbour average assembled on
the slot tables; the COO remainder and the boundary faces add their
shares with `index_add`, which on a CUDA tensor is an atomic sum whose
order is not fixed between runs (the reference's `.at[].add`). The
homogeneous (volume-averaged) Germano coefficients are one global
reduction each.

`symm_to_full`, `full_to_symm` and `_div_symm_tensor` come from ras2.py,
as in the reference.
"""

from __future__ import annotations

from typing import Any

import torch

from ...core.dimensions import dimViscosity
from ...core.fields import VolField
from ...ops import fvc, fvm
from ...ops import slot as slot_mod
from .base import TurbulenceModel, register
from .les import OneEqEddy, Smagorinsky
from .ras2 import _div_symm_tensor, full_to_symm

K_MIN = 1e-10


def simple_filter(mesh, data: Any) -> Any:
    """Test filter: surfaceSum(|Sf| interp(phi)) / surfaceSum(|Sf|)
    (LESfilters/simpleFilter); boundary faces take the owner value
    (zero-gradient). data [nC] or [nC,k]."""
    vec = data.ndim == 2
    f = slot_mod.interpolate(mesh, data)
    w_sv = torch.linalg.norm(mesh.st_sf, dim=2) * mesh.st_valid  # [nC,M]
    if vec:
        num = torch.sum(w_sv[:, :, None] * f.sv, dim=1)
    else:
        num = torch.sum(w_sv * f.sv, dim=1)
    den = torch.sum(w_sv, dim=1)
    if mesh.fb_cells.shape[0]:
        w_fb = torch.linalg.norm(mesh.fb_sf, dim=1)
        contrib = w_fb[:, None] * f.fb if vec else w_fb * f.fb
        num = num.index_add(0, mesh.fb_cells, contrib)
        den = den.index_add(0, mesh.fb_cells, w_fb)
    w_b = torch.linalg.norm(mesh.ab_sf, dim=1)
    bvals = data[mesh.ab_owner]
    num = num.index_add(0, mesh.ab_owner,
                        w_b[:, None] * bvals if vec else w_b * bvals)
    den = den.index_add(0, mesh.ab_owner, w_b)
    den = torch.clamp(den, min=1e-30)
    return num / (den[:, None] if vec else den)


def _filter_tensor(mesh, T: Any) -> Any:
    """simple_filter over the trailing tensor axes ([nC,3,3] or [nC,6])."""
    shape = T.shape
    return simple_filter(mesh, T.reshape(shape[0], -1)).reshape(shape)


def _vavg(mesh, x: Any) -> Any:
    """Volume-weighted global average."""
    return torch.sum(x * mesh.v) / torch.sum(mesh.v)


def _sym_grad(mesh, U: VolField) -> Any:
    g = fvc.grad(mesh, U)
    return 0.5 * (g + torch.transpose(g, 1, 2))   # [nC,3,3]


def _dev(T: Any) -> Any:
    tr = torch.diagonal(T, dim1=1, dim2=2).sum(dim=1)
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    return T - (tr / 3.0)[:, None, None] * eye


def _resolved_stress(mesh, U: VolField):
    """(filt(U), filt(U U) - filt(U) filt(U)): the Leonard stress."""
    Uf = simple_filter(mesh, U.data)
    UU = torch.einsum("ci,cj->cij", U.data, U.data)
    return Uf, (_filter_tensor(mesh, UU)
                - torch.einsum("ci,cj->cij", Uf, Uf))


class HomogeneousDynSmagorinsky(Smagorinsky):
    """Dynamic Smagorinsky with volume-averaged (homogeneous) Germano
    coefficients (LES/homogeneousDynSmagorinsky/):

        L  = dev(filt(U U) - filt(U) filt(U))
        M  = delta^2 (4 |filt(S)| filt(S) - filt(|S| S))
        cD = <L:M> / <M:M>,  clipped to [0, 0.5]
        nuSgs = cD delta^2 |S|"""

    name = "homogeneousDynSmagorinsky"
    field_names = ("nut",)

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, phi_slot=None):
        nut_f: VolField = tstate["nut"]
        delta2 = self.delta(mesh) ** 2
        S = _sym_grad(mesh, U)                       # [nC,3,3]
        magS = torch.sqrt(2.0 * torch.sum(S * S, dim=(1, 2)))

        _, B = _resolved_stress(mesh, U)
        L = _dev(B)
        Sf = _filter_tensor(mesh, S)
        magSf = torch.sqrt(2.0 * torch.sum(Sf * Sf, dim=(1, 2)))
        M = delta2[:, None, None] * (
            4.0 * magSf[:, None, None] * Sf
            - _filter_tensor(mesh, magS[:, None, None] * S))
        cD = _vavg(mesh, torch.sum(L * M, dim=(1, 2))) / torch.clamp(
            _vavg(mesh, torch.sum(M * M, dim=(1, 2))), min=1e-30)
        cD = torch.clamp(cD, 0.0, 0.5)               # stability clip
        nut_new = cD * delta2 * magS
        new_nut = nut_f.with_data(nut_new).correct_boundary_conditions(
            mesh, nu=self.nu, U=U.data)
        new = dict(tstate)
        new["nut"] = new_nut
        return new, {}


class DynOneEqEddy(OneEqEddy):
    """One-equation SGS with a dynamically computed Ck
    (LES/dynOneEqEddy/): Ck from the Germano identity on the resolved
    stress, volume-averaged,

        L  = dev(filt(U U) - filt(U) filt(U))
        M  = delta (filt(sqrt(k) S) - 2 sqrt(filt(k)+KK) filt(S))
        Ck = -<L:M>/(2 <M:M>), clipped to [0.02, 0.3]

    Ce stays at its equilibrium value (the reference's documented
    deviation). The k equation runs with the static Ck and nut is then
    rescaled with the dynamic one, as in the reference."""

    name = "dynOneEqEddy"

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, phi_slot=None):
        k = torch.clamp(tstate["k"].data, min=K_MIN)
        delta = self.delta(mesh)
        S = _sym_grad(mesh, U)
        Uf, B = _resolved_stress(mesh, U)
        L = _dev(B)
        KK = torch.clamp(
            0.5 * (simple_filter(mesh, torch.sum(U.data ** 2, dim=1))
                   - torch.sum(Uf ** 2, dim=1)), min=0.0)
        kf = torch.clamp(simple_filter(mesh, k), min=K_MIN)
        Sf = _filter_tensor(mesh, S)
        M = delta[:, None, None] * (
            _filter_tensor(mesh, torch.sqrt(k)[:, None, None] * S)
            - 2.0 * torch.sqrt(kf + KK)[:, None, None] * Sf)
        ck = -_vavg(mesh, torch.sum(L * M, dim=(1, 2))) / torch.clamp(
            2.0 * _vavg(mesh, torch.sum(M * M, dim=(1, 2))), min=1e-30)
        ck = torch.clamp(ck, 0.02, 0.3)
        new, diag = super().correct(mesh, tstate, U, phi, dt, steady,
                                    relax, controls, phi_slot=phi_slot)
        k_new = torch.clamp(new["k"].data, min=K_MIN)
        nut_new = ck * delta * torch.sqrt(k_new)
        new["nut"] = new["nut"].with_data(
            nut_new).correct_boundary_conditions(
            mesh, k=k_new, nu=self.nu, U=U.data)
        return new, diag


class ScaleSimilarity(TurbulenceModel):
    """Bardina scale-similarity model (LES/scaleSimilarity/):
    B = filt(U U) - filt(U) filt(U); no eddy viscosity, the divergence
    of dev(B) enters the momentum equation explicitly."""

    name = "scaleSimilarity"
    field_names = ("nut",)      # carried (zero) for solver uniformity

    def nut(self, mesh, tstate):
        return mesh.v.new_zeros((mesh.n_cells,))

    def div_dev_reff(self, mesh, tstate, U: VolField):
        # the molecular part implicit, the divergence of dev(B) explicit
        nu = torch.tensor(self.nu, dtype=mesh.v.dtype, device=mesh.device)
        mat = -fvm.laplacian(mesh, nu, U, corrected=self.corrected,
                             gamma_dims=dimViscosity,
                             limit=self.corr_limit)
        _, B = _resolved_stress(mesh, U)
        divB = _div_symm_tensor(mesh, full_to_symm(_dev(B)))
        return mat, divB

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, phi_slot=None):
        nut_f = tstate["nut"]
        new = dict(tstate)
        new["nut"] = nut_f.with_data(torch.zeros_like(nut_f.data))
        return new, {}


class MixedSmagorinsky(Smagorinsky):
    """scaleSimilarity + Smagorinsky (LES/mixedSmagorinsky/): the
    scale-similarity stress explicit, the Smagorinsky eddy viscosity
    implicit."""

    name = "mixedSmagorinsky"
    field_names = ("nut",)

    def div_dev_reff(self, mesh, tstate, U: VolField):
        mat, src = super().div_dev_reff(mesh, tstate, U)
        _, B = _resolved_stress(mesh, U)
        divB = _div_symm_tensor(mesh, full_to_symm(_dev(B)))
        return mat, src + divB


register("homogeneousDynSmagorinsky", HomogeneousDynSmagorinsky)
register("dynOneEqEddy", DynOneEqEddy)
register("scaleSimilarity", ScaleSimilarity)
register("mixedSmagorinsky", MixedSmagorinsky)
