"""fvc — explicit finite-volume operators (port of
openfoam-2.2.x_tpu/ops/fvc.py): cell->face interpolation, surface
integration and divergence, the Gauss linear gradient through the slot
layout, the face-normal gradient, the face flux, the explicit laplacian,
face->cell averaging and reconstruction, and the domain integral. The
least-squares and cell-limited gradients and `curl` are outside the
ported slice.

Empty-patch faces are masked out via mesh.face_active, which makes 2-D
extruded meshes exact."""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..bc import patchfields as pf
from ..core.fields import VolField
from . import slot as slot_mod
from . import surface


def interpolate(mesh, field: VolField, weights: Optional[Any] = None) -> Any:
    """Cell -> face interpolation (linear by default). [nF,(3)]."""
    return surface.face_values(mesh, field, weights)


def surface_integrate(mesh, face_vals: Any) -> Any:
    """(1/V) * sum_f sign_f face_vals_f (fvc::surfaceIntegrate)."""
    s = surface.surface_sum(mesh, face_vals)
    if s.ndim == 2:
        return s / mesh.v[:, None]
    return s / mesh.v


def div_surface(mesh, phi: Any) -> Any:
    """fvc::div(phi) for a face flux [nF] -> [nC]."""
    return surface_integrate(mesh, phi * mesh.face_active)


def div(mesh, phi: Any, field: VolField, weights: Optional[Any] = None
        ) -> Any:
    """Gauss divergence of phi*field -> [nC,(3)]
    (gaussConvectionScheme::fvcDiv)."""
    vf = interpolate(mesh, field, weights)
    if vf.ndim == 2:
        return surface_integrate(
            mesh, phi[:, None] * vf * mesh.face_active[:, None])
    return surface_integrate(mesh, phi * vf * mesh.face_active)


def grad(mesh, field: VolField) -> Any:
    """Gauss gradient. scalar -> [nC,3]; vector -> [nC,3,3] with
    g[c,i,j] = d(u_j)/d(x_i), computed on the slot layout."""
    return slot_mod.grad(mesh, field.data, field.boundary_values(mesh))


def grad_of(mesh, field: VolField, scheme: str = "Gauss linear") -> Any:
    """Gradient dispatch by fvSchemes keyword. The slice ports
    'Gauss linear'; other schemes raise."""
    toks = str(scheme).split()
    if toks in (["Gauss", "linear"], ["linear"], ["Gauss"], []):
        return grad(mesh, field)
    raise NotImplementedError(
        f"gradScheme {scheme!r} is not ported to foamtpu_torch yet")


def flux(mesh, field: VolField) -> Any:
    """Face flux of a vector field: phi = Sf . interp(U), masked on empty
    patches (fvc::flux)."""
    uf = interpolate(mesh, field)
    return torch.sum(mesh.sf * uf, dim=1) * mesh.face_active


def sn_grad(mesh, field: VolField, corrected: bool = False) -> Any:
    """Face-normal gradient [nF,(3)]: orthogonal part + optional explicit
    non-orthogonality correction (snGradScheme / correctedSnGrad)."""
    nif = mesh.n_internal_faces
    d = surface.delta(mesh, field.data)
    dc = mesh.delta_coeffs if not corrected else mesh.non_orth_delta_coeffs
    dci = dc[:nif]
    sng_i = d * (dci[:, None] if d.ndim == 2 else dci)
    if corrected:
        gf = surface.interpolate_internal(mesh, grad(mesh, field))
        if field.data.ndim == 1:
            corr = torch.sum(mesh.correction_vecs[:nif] * gf, dim=1)
        else:
            corr = torch.sum(mesh.correction_vecs[:nif, :, None] * gf, dim=1)
        sng_i = sng_i + corr
    # boundary snGrad from the BC gradient coefficients
    sng_b = []
    for p, bc in zip(mesh.patches, field.bcs):
        gic, gbc = pf.grad_coeffs(bc, mesh, p, field.data)
        vi = field.data[mesh.owner[p.slice]]
        sng_b.append(gic * vi + gbc)
    return torch.cat([sng_i] + sng_b, dim=0)


def laplacian(mesh, gamma_f: Any, field: VolField, corrected: bool = True
              ) -> Any:
    """Explicit Laplacian: surfaceIntegrate(gamma_f |Sf| snGrad)."""
    sng = sn_grad(mesh, field, corrected=corrected)
    coef = gamma_f * mesh.mag_sf * mesh.face_active
    if sng.ndim == 2:
        return surface_integrate(mesh, coef[:, None] * sng)
    return surface_integrate(mesh, coef * sng)


def average(mesh, face_vals: Any) -> Any:
    """Face -> cell arithmetic mean over the cell's faces."""
    ones = torch.abs(mesh.csign)
    if face_vals.ndim == 2:
        s = torch.sum(face_vals[mesh.cface] * ones[:, :, None], dim=1)
        return s / torch.sum(ones, dim=1)[:, None]
    s = torch.sum(face_vals[mesh.cface] * ones, dim=1)
    return s / torch.sum(ones, dim=1)


def reconstruct(mesh, phi: Any) -> Any:
    """Reconstruct a cell vector field from face fluxes (fvc::reconstruct):
    (sum Sf (x) Sf/|Sf|)^-1 . sum (Sf phi/|Sf|)."""
    sf = mesh.sf * mesh.face_active[:, None]
    w = 1.0 / torch.clamp(mesh.mag_sf, min=1e-30)
    # per-cell 3x3: sum_f sign^2 * Sf Sf^T / |Sf|  (sign^2 = presence)
    pres = torch.abs(mesh.csign)
    outer = (sf[:, :, None] * sf[:, None, :]) * w[:, None, None]
    Gsum = torch.sum(outer[mesh.cface] * pres[:, :, None, None], dim=1)
    rhs_f = sf * (phi * w)[:, None]
    rhs = torch.sum(rhs_f[mesh.cface] * pres[:, :, None], dim=1)
    # regularise null directions (2-D meshes: empty faces are masked, so
    # the z-z entry is exactly zero; the matching rhs is zero too, which
    # gives a clean 0 component instead of NaN)
    tr = torch.diagonal(Gsum, dim1=1, dim2=2).sum(dim=1)
    eps = (1e-6 * tr + 1e-300)[:, None, None] * torch.eye(
        3, dtype=Gsum.dtype, device=Gsum.device)
    return torch.linalg.solve(Gsum + eps, rhs[..., None])[..., 0]


def ddt(mesh, data: Any, old_data: Any, rdt: Any) -> Any:
    return (data - old_data) * rdt


def domain_integrate(mesh, data: Any) -> Any:
    if data.ndim == 2:
        return torch.sum(data * mesh.v[:, None], dim=0)
    return torch.sum(data * mesh.v)
