"""fvm — implicit finite-volume operators returning FvMatrix (port of
openfoam-2.2.x_tpu/ops/fvm.py: Euler `ddt`, Gauss linear `div` on the
slot-form flux, and Gauss `laplacian` on slot and flat coefficients).

Coefficients follow the reference's assembly + negSumDiag:
  convection (face flux phi, owner weight w):
      upper = phi*(1-w); lower = -phi*w
  diffusion (coef = gamma_f |Sf| deltaCoeff):
      upper = lower = coef;  diag[own] -= coef; diag[nei] -= coef
Boundary faces fold the BC linearisation into internalCoeffs (ic) and
boundaryCoeffs (bc). The explicit non-orthogonal correction is outside
the ported slice and raises.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..bc import patchfields as pf
from ..core.dimensions import (DimensionSet, dimFlux, dimLength, dimless,
                               dimTime, dimVolume)
from ..core.fields import VolField
from .matrix import FvMatrix, zero_matrix


def _ncmp(field: VolField) -> int:
    return 1 if field.data.ndim == 1 else field.data.shape[1]


def _colv(x, field_data):
    return x[:, None] if field_data.ndim == 2 else x


def ddt(mesh, field: VolField, old_data: Any, rdt: Any) -> FvMatrix:
    """Euler implicit d/dt (EulerDdtScheme::fvmDdt): diag = V/dt,
    source = V/dt * psi_old."""
    m = zero_matrix(mesh, _ncmp(field), dims=field.dims * dimVolume / dimTime)
    vdt = mesh.v * rdt
    return m.replace_fields(diag=vdt, source=_colv(vdt, field.data) * old_data)


def div(mesh, phi: Any, field: VolField, phi_slot: Any) -> FvMatrix:
    """Implicit Gauss convection div(phi, psi) with linear weights
    (gaussConvectionScheme::fvmDiv), slot path: the diagonal and the slot
    off-diagonals assemble elementwise over [nC,M] from the slot-form
    flux `phi_slot`."""
    nif = mesh.n_internal_faces
    act = mesh.face_active
    phi_i = phi[:nif]
    w = mesh.weights[:nif]
    lower = -phi_i * w
    upper = phi_i * (1.0 - w)

    wself, fb_wself = mesh.st_wself, mesh.fb_wself
    phi_out = mesh.st_sign * phi_slot.sv
    soff = phi_out * (1.0 - wself) * mesh.st_valid
    diag = torch.sum(phi_out * wself * mesh.st_valid, dim=1)
    if mesh.fb_cells.shape[0]:
        phi_ofb = mesh.fb_signs * phi_slot.fb
        sfb = phi_ofb * (1.0 - fb_wself)
        diag = diag.index_add(0, mesh.fb_cells, phi_ofb * fb_wself)
    else:
        sfb = diag.new_zeros((0,))

    # boundary: term phi_b * (vic*psi_c + vbc)
    ics, bcs = [], []
    for p, bc in zip(mesh.patches, field.bcs):
        phib = (phi * act)[p.slice]
        vic, vbc = pf.value_coeffs(bc, mesh, p, field.data)
        phib_c = _colv(phib, field.data)
        ics.append(phib_c * vic)
        bcs.append(-phib_c * vbc)
    ic = torch.cat(ics, dim=0)
    bcc = torch.cat(bcs, dim=0)

    dims = dimFlux * field.dims
    src = diag.new_zeros(tuple(field.data.shape))
    return FvMatrix(diag=diag, lower=lower, upper=upper, source=src, ic=ic,
                    bc=bcc, soff=soff, sfb=sfb, dims=dims, symmetric=False)


def laplacian(
    mesh,
    gamma_f: Any,
    field: VolField,
    corrected: bool = True,
    gamma_dims: Optional[DimensionSet] = None,
    limit: float = 1.0,
    defer_correction: bool = False,
    gamma_slot: Any = None,
) -> FvMatrix:
    """Implicit Gauss Laplacian laplacian(gamma, psi)
    (gaussLaplacianScheme::fvmLaplacian). gamma_f is a face field [nF]
    or a scalar. corrected=True on an orthogonal mesh is exact without
    the correction; on a non-orthogonal mesh it is not ported and raises
    (unless the caller defers the correction)."""
    if corrected and getattr(mesh, "orthogonal", False):
        corrected = False
    if corrected and not defer_correction:
        raise NotImplementedError(
            "non-orthogonal laplacian correction is not ported to "
            "foamtpu_torch yet")
    nif = mesh.n_internal_faces
    act = mesh.face_active
    gamma_scalar = not torch.is_tensor(gamma_f) or gamma_f.ndim == 0
    gamma_f = torch.broadcast_to(
        torch.as_tensor(gamma_f, dtype=mesh.v.dtype, device=mesh.device),
        (mesh.n_faces,))
    dc = mesh.non_orth_delta_coeffs if corrected else mesh.delta_coeffs
    coef = gamma_f * mesh.mag_sf * act * dc
    coef_i = coef[:nif]

    upper = coef_i
    lower = coef_i
    if gamma_slot is not None or gamma_scalar:
        # slot path (elementwise, zero gathers)
        dcs = mesh.st_nodc if corrected else mesh.st_dc
        dcf = mesh.fb_nodc if corrected else mesh.fb_dc
        if gamma_scalar:
            g_sv = gamma_f[0]
            g_fb = gamma_f[0]
        else:
            g_sv, g_fb = gamma_slot.sv, gamma_slot.fb
        soff = g_sv * mesh.st_magsf * dcs * mesh.st_valid
        diag = -torch.sum(soff, dim=1)
        if mesh.fb_cells.shape[0]:
            sfb = g_fb * mesh.fb_magsf * dcf
            diag = diag.index_add(0, mesh.fb_cells, -sfb)
        else:
            sfb = diag.new_zeros((0,))
    else:
        soff = sfb = None
        diag = -torch.sum(coef_i[mesh.cface_i] * mesh.cnbr_valid, dim=1)

    src = diag.new_zeros(tuple(field.data.shape))

    gb = gamma_f * mesh.mag_sf * act
    ics, bcs = [], []
    for p, bc in zip(mesh.patches, field.bcs):
        gic, gbc = pf.grad_coeffs(bc, mesh, p, field.data)
        gbp = _colv(gb[p.slice], field.data)
        ics.append(gbp * gic)
        bcs.append(-gbp * gbc)
    ic = torch.cat(ics, dim=0)
    bcc = torch.cat(bcs, dim=0)

    gdims = gamma_dims if gamma_dims is not None else dimless
    dims = gdims * field.dims * dimLength
    return FvMatrix(diag=diag, lower=lower, upper=upper, source=src, ic=ic,
                    bc=bcc, soff=soff, sfb=sfb, dims=dims, symmetric=True)
