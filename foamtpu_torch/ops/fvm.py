"""fvm — implicit finite-volume operators returning FvMatrix (port of
openfoam-2.2.x_tpu/ops/fvm.py: the Euler, steadyState, backward and
Crank-Nicolson `ddt`, `d2dt2`, Gauss `div` with scheme weights on the
slot-form or the flat flux, the Gauss `laplacian` with its
non-orthogonal correction, and the `Sp`/`SuSp`/`Su` sources).

Coefficients follow the reference's assembly + negSumDiag:
  convection (face flux phi, owner weight w):
      upper = phi*(1-w); lower = -phi*w
  diffusion (coef = gamma_f |Sf| deltaCoeff):
      upper = lower = coef;  diag[own] -= coef; diag[nei] -= coef
Boundary faces fold the BC linearisation into internalCoeffs (ic) and
boundaryCoeffs (bc). A corrected laplacian on a non-orthogonal mesh
moves the explicit correction to the source and stashes its face flux
in `fcorr` (unless the caller defers the correction, as the pressure
equations do). On a cyclicAMI pair (and its fixedJump/fan kinds) the
laplacian couples implicitly: the own side on the diagonal, the
interpolated neighbour in the matrix's ami_coef, a jump in the source.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..bc import patchfields as pf
from ..core.dimensions import (DimensionSet, dimFlux, dimLength, dimless,
                               dimTime, dimVolume)
from ..core.fields import VolField
from . import fvc, surface
from . import slot as slot_mod
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


def ddt_steady(mesh, field: VolField) -> FvMatrix:
    """steadyState ddt: zero contribution."""
    return zero_matrix(mesh, _ncmp(field),
                       dims=field.dims * dimVolume / dimTime)


def d2dt2(mesh, field: VolField, old: Any, old_old: Any, rdt: Any
          ) -> FvMatrix:
    """Euler implicit d2/dt2 (EulerD2dt2Scheme::fvmD2dt2):
    diag = V/dt^2, source = V/dt^2 * (2 psi0 - psi00)."""
    m = zero_matrix(mesh, _ncmp(field),
                    dims=field.dims * dimVolume / (dimTime * dimTime))
    vdt2 = mesh.v * rdt * rdt
    return m.replace_fields(
        diag=vdt2, source=_colv(vdt2, field.data) * (2.0 * old - old_old))


def ddt_backward(mesh, field: VolField, old: Any, old_old: Any,
                 rdt: Any, rdt0: Any) -> FvMatrix:
    """Second-order backward (BDF2) implicit d/dt
    (backwardDdtScheme.C), variable-dt coefficients:
        coefft   = 1 + dt/(dt+dt0)
        coefft00 = dt^2 / (dt0 (dt+dt0))
        coefft0  = coefft + coefft00
        diag = coefft V/dt;  source = V/dt (coefft0 old - coefft00 old_old)
    First step: dt0 is huge (rdt0 tiny, as deltaT0_ = GREAT while
    oldTime.oldTime is unset), so coefft -> 1 and coefft00 -> 0: Euler."""
    dt = 1.0 / rdt
    dt0 = 1.0 / torch.clamp(_as(mesh, rdt0), min=1e-30)
    coefft = 1.0 + dt / (dt + dt0)
    coefft00 = dt * dt / (dt0 * (dt + dt0))
    coefft0 = coefft + coefft00
    m = zero_matrix(mesh, _ncmp(field), dims=field.dims * dimVolume / dimTime)
    vdt = mesh.v * rdt
    return m.replace_fields(
        diag=coefft * vdt,
        source=_colv(vdt, field.data) * (coefft0 * old - coefft00 * old_old))


def _as(mesh, x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=mesh.v.dtype, device=mesh.device)


def _cn_active(oc: float, rdt0: Any) -> Any:
    """CrankNicolsonDdtScheme::coef_: the off-centre term is active only
    AFTER the first step (ddt0 undefined at startup, so the first step
    runs as pure Euler). rdt0 <= tiny marks startup."""
    if rdt0 is None:
        return oc
    return oc * (torch.as_tensor(rdt0) > 1e-20).to(torch.as_tensor(rdt0).dtype)


def ddt_crank_nicolson(mesh, field: VolField, old: Any, ddt0: Any,
                       rdt: Any, oc: float = 1.0,
                       rdt0: Any = None) -> FvMatrix:
    """Crank-Nicolson implicit d/dt (CrankNicolsonDdtScheme, 2.2
    convention: the dict coefficient oc in [0,1] blends Euler (0) to
    pure CN (1)):
        ddt(psi) = (1+oc)(psi - old)/dt - oc*ddt0
    where ddt0 is the PREVIOUS step's ddt, updated after the solve via
    ddt_cn_update; the caller carries ddt0 (and rdt0, the previous
    step's 1/dt, tiny at startup) in the solver state."""
    oc_eff = _cn_active(oc, rdt0)
    m = zero_matrix(mesh, _ncmp(field), dims=field.dims * dimVolume / dimTime)
    vrc = mesh.v * ((1.0 + oc_eff) * rdt)
    return m.replace_fields(
        diag=vrc,
        source=(_colv(vrc, field.data) * old
                + oc_eff * _colv(mesh.v, field.data) * ddt0))


def ddt_cn_update(new: Any, old: Any, ddt0: Any, rdt: Any,
                  oc: float = 1.0, rdt0: Any = None) -> Any:
    """Advance the stored ddt0 at the END of a CN step:
    ddt0 <- (1+oc')*rdt*(new-old) - oc'*ddt0, with oc' gated off on the
    startup step (matching the matrix)."""
    oc_eff = _cn_active(oc, rdt0)
    return (1.0 + oc_eff) * rdt * (new - old) - oc_eff * ddt0


def div(mesh, phi: Any, field: VolField, weights: Optional[Any] = None,
        phi_dims: Optional[DimensionSet] = None, phi_slot: Any = None,
        slot_weights: Any = None) -> FvMatrix:
    """Implicit Gauss convection div(phi, psi)
    (gaussConvectionScheme::fvmDiv). `weights` are owner-side
    interpolation weights on internal faces (ops/schemes.py; default
    linear).

    With `phi_slot` (the slot form of the flux) the diagonal and the slot
    off-diagonals assemble elementwise over [nC,M]; `slot_weights` =
    (wself [nC,M], fb_wself [nfb]) are the self-side scheme weights
    (default linear). Without it the matrix is flat (upper/lower only,
    the diagonal by negSumDiag in gather form) and the solvers build
    their operator with stencil.mesh_stencil."""
    nif = mesh.n_internal_faces
    act = mesh.face_active
    phi_i = phi[:nif]

    soff = sfb = None
    if phi_slot is not None:
        if slot_weights is None:
            wself, fb_wself = mesh.st_wself, mesh.fb_wself
        else:
            wself, fb_wself = slot_weights
        phi_out = mesh.st_sign * phi_slot.sv
        soff = phi_out * (1.0 - wself) * mesh.st_valid
        diag = torch.sum(phi_out * wself * mesh.st_valid, dim=1)
        if mesh.fb_cells.shape[0]:
            phi_ofb = mesh.fb_signs * phi_slot.fb
            sfb = phi_ofb * (1.0 - fb_wself)
            diag = diag.index_add(0, mesh.fb_cells, phi_ofb * fb_wself)
        else:
            sfb = diag.new_zeros((0,))
        if weights is None and slot_weights is not None:
            weights = slot_mod.to_flat_internal(
                mesh, slot_mod.SlotFace(wself, fb_wself))
        w = mesh.weights[:nif] if weights is None else weights
        lower = -phi_i * w
        upper = phi_i * (1.0 - w)
    else:
        w = mesh.weights[:nif] if weights is None else weights
        lower = -phi_i * w
        upper = phi_i * (1.0 - w)
        # negSumDiag in gather form: diag[own] -= lower; diag[nei] -= upper
        own_side = torch.where(mesh.csign > 0, lower[mesh.cface_i],
                               upper[mesh.cface_i])
        diag = -torch.sum(own_side * mesh.cnbr_valid, dim=1)

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

    dims = (phi_dims or dimFlux) * field.dims
    src = diag.new_zeros(tuple(field.data.shape))
    return FvMatrix(diag=diag, lower=lower, upper=upper, source=src, ic=ic,
                    bc=bcc, soff=soff, sfb=sfb, dims=dims, symmetric=False)


def laplacian_correction(mesh, gamma_f: Any, field: VolField,
                         limit: float = 1.0, coef_i: Any = None):
    """Explicit non-orthogonal deferred correction of the Gauss
    laplacian (correctedSnGrad::correction). Returns (corr_full
    [nF,(C)], corr_cell [nC,(C)]): the per-face correction flux (for
    FvMatrix.flux) and its cell integral (subtracted from the source).
    limit < 1 clips the correction to limit/(1-limit) * |orthogonal
    part| per face (limitedSnGrad)."""
    nif = mesh.n_internal_faces
    act = mesh.face_active
    gamma_f = torch.broadcast_to(
        torch.as_tensor(gamma_f, dtype=mesh.v.dtype, device=mesh.device),
        (mesh.n_faces,))
    g = fvc.grad(mesh, field)
    gf = surface.interpolate_internal(mesh, g)
    gamsf_i = (gamma_f * mesh.mag_sf * act)[:nif]
    if field.data.ndim == 1:
        corr_f = gamsf_i * torch.sum(mesh.correction_vecs[:nif] * gf, dim=1)
    else:
        corr_f = gamsf_i[:, None] * torch.sum(
            mesh.correction_vecs[:nif, :, None] * gf, dim=1)
    if limit < 1.0:
        if coef_i is None:
            coef_i = (gamma_f * mesh.mag_sf * act
                      * mesh.non_orth_delta_coeffs)[:nif]
        d = surface.delta(mesh, field.data)
        orth = coef_i[:, None] * d if d.ndim == 2 else coef_i * d
        cap = (limit / (1.0 - limit)) * torch.abs(orth)
        corr_f = torch.clamp(corr_f, -cap, cap)
    corr_full = corr_f.new_zeros((mesh.n_faces,) + tuple(corr_f.shape[1:]))
    corr_full[:nif] = corr_f
    corr_cell = surface.surface_sum(mesh, corr_full)
    return corr_full, corr_cell


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
    or a scalar. corrected=True adds the explicit non-orthogonal
    correction to the source and stashes its face flux in fcorr (the
    correction is identically zero on an orthogonal mesh and skipped);
    defer_correction leaves it to the caller. limit < 1 clips it
    (limitedSnGrad)."""
    if corrected and getattr(mesh, "orthogonal", False):
        corrected = False
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
    fcorr = None
    if corrected and not defer_correction:
        corr_full, corr_cell = laplacian_correction(
            mesh, gamma_f, field, limit=limit, coef_i=coef_i)
        # the explicit part moves to the source with a minus sign; its
        # face flux keeps FvMatrix.flux consistent with the operator
        src = src - corr_cell
        fcorr = corr_full

    gb = gamma_f * mesh.mag_sf * act
    ics, bcs = [], []
    ami_coef = None
    for p, bc in zip(mesh.patches, field.bcs):
        if bc.kind in pf._COUPLED_KINDS:
            # implicit coupled-interface diffusion: the own side on the
            # diagonal here, the interpolated neighbour as the matrix's
            # ami_coef in every product
            # (cyclicAMIFvPatchField::updateInterfaceMatrix). The jump
            # kinds add their constant jump through the boundary source:
            # the coupled snGrad is dc*(nbr + jump - own)
            # (jumpCyclicFvPatchField::updateInterfaceMatrix).
            gbp = _colv(gb[p.slice], field.data)
            dcp_c = _colv(dc[p.slice], field.data)
            shape = (p.size,) + tuple(field.data.shape[1:])
            ics.append(torch.broadcast_to(gbp * (-dcp_c), shape))
            if bc.kind in pf._JUMP_KINDS:
                j = pf.jump_signed(bc, diag.new_zeros(shape))
                bcs.append(-gbp * dcp_c * j)
            else:
                bcs.append(diag.new_zeros(shape))
            if ami_coef is None:
                ami_coef = diag.new_zeros(mesh.n_faces - nif)
            rel = p.start - nif
            ami_coef[rel:rel + p.size] = (gb * dc)[p.slice]
            continue
        gic, gbc = pf.grad_coeffs(bc, mesh, p, field.data)
        gbp = _colv(gb[p.slice], field.data)
        ics.append(gbp * gic)
        bcs.append(-gbp * gbc)
    ic = torch.cat(ics, dim=0)
    bcc = torch.cat(bcs, dim=0)

    gdims = gamma_dims if gamma_dims is not None else dimless
    dims = gdims * field.dims * dimLength
    return FvMatrix(diag=diag, lower=lower, upper=upper, source=src, ic=ic,
                    bc=bcc, fcorr=fcorr, soff=soff, sfb=sfb,
                    ami_coef=ami_coef, dims=dims, symmetric=True)


def Sp(mesh, sp: Any, field: VolField, sp_dims=None) -> FvMatrix:
    """Implicit source sp*psi (fvm::Sp): diag += V*sp. sp_dims: the
    dimensions of sp (default 1/s)."""
    d = DimensionSet.of(0, 0, -1) if sp_dims is None else sp_dims
    m = zero_matrix(mesh, _ncmp(field), dims=field.dims * dimVolume * d)
    return m.replace_fields(diag=mesh.v * sp)


def SuSp(mesh, susp: Any, field: VolField, susp_dims=None) -> FvMatrix:
    """Implicit/explicit split source (fvm::SuSp): the positive part goes
    on the diagonal, the negative part is explicit."""
    d = DimensionSet.of(0, 0, -1) if susp_dims is None else susp_dims
    m = zero_matrix(mesh, _ncmp(field), dims=field.dims * dimVolume * d)
    diag = mesh.v * torch.clamp(susp, min=0.0)
    src = -_colv(mesh.v * torch.clamp(susp, max=0.0), field.data) * field.data
    return m.replace_fields(diag=diag, source=src)


def Su(mesh, su: Any, field: VolField) -> FvMatrix:
    """Explicit source inside the operator (fvm::Su): source -= V*su
    (the term appears on the LHS)."""
    m = zero_matrix(mesh, _ncmp(field),
                    dims=field.dims * dimVolume / dimTime)
    return m.replace_fields(source=-_colv(mesh.v, field.data) * su)
