"""fvc — explicit finite-volume operators (port of
openfoam-2.2.x_tpu/ops/fvc.py): cell->face interpolation, surface
integration and divergence, the Gauss linear gradient through the slot
layout, the least-squares and cell-limited gradients and their fvSchemes
dispatch, the face-normal gradient, the face flux, the explicit
laplacian, face->cell averaging and reconstruction, and the domain
integral. `curl` is outside the ported slice.

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


def grad_least_squares(mesh, field: VolField) -> Any:
    """Least-squares gradient (gradSchemes/leastSquaresGrad):
    inverse-distance-squared weighted fit over the face neighbours and
    the boundary faces; exact for linear fields on any mesh. scalar ->
    [nC,3]; vector -> [nC,3,3] with g[c,i,j] = d(u_j)/d(x_i)."""
    data = field.data
    c = mesh.c
    tiny = 1e-30
    vec = data.ndim == 2

    valid = mesh.cnbr_valid                                   # [nC,K]
    d = (c[mesh.cnbr] - c[:, None, :]) * valid[:, :, None]
    w2 = valid / torch.clamp(torch.sum(d * d, dim=2), min=tiny)
    G = torch.sum(w2[:, :, None, None] * d[:, :, :, None]
                  * d[:, :, None, :], dim=1)                  # [nC,3,3]
    dpsi = data[mesh.cnbr] - data[:, None]                    # [nC,K(,C)]
    if vec:
        rhs = torch.sum((w2[:, :, None] * d)[:, :, :, None]
                        * dpsi[:, :, None, :], dim=1)         # [nC,3,C]
    else:
        rhs = torch.sum(w2[:, :, None] * d * dpsi[:, :, None], dim=1)

    # boundary faces: d = Cf - C(own), the value from the BC
    act = mesh.face_active
    for p, bc in zip(mesh.patches, field.bcs):
        cells = mesh.owner[p.slice]
        a = act[p.slice]
        db = (mesh.cf[p.slice] - c[cells]) * a[:, None]
        w2b = a / torch.clamp(torch.sum(db * db, dim=1), min=tiny)
        dvb = pf.evaluate(bc, mesh, p, data) - data[cells]
        G = G.index_add(0, cells, w2b[:, None, None] * db[:, :, None]
                        * db[:, None, :])
        if vec:
            rb = (w2b[:, None] * db)[:, :, None] * dvb[:, None, :]
        else:
            rb = w2b[:, None] * db * dvb[:, None]
        rhs = rhs.index_add(0, cells, rb)

    # regularise null directions (2-D empty-masked meshes: the z row and
    # column are exactly zero with a zero rhs -> a clean 0, not NaN)
    tr = torch.diagonal(G, dim1=1, dim2=2).sum(dim=1)
    eps = (1e-9 * tr + tiny)[:, None, None] * torch.eye(
        3, dtype=G.dtype, device=G.device)
    if vec:
        return torch.linalg.solve(G + eps, rhs)
    return torch.linalg.solve(G + eps, rhs[..., None])[..., 0]


def grad_cell_limited(mesh, field: VolField, g: Any, k: float) -> Any:
    """cellLimited gradient limiter (limitedGradSchemes/cellLimitedGrad):
    scale each cell's gradient so that the face-extrapolated values stay
    within the extrema over the cell's neighbours and boundary faces.
    k in (0,1]; k=1 limits fully."""
    data = field.data
    vec = data.ndim == 2
    big = torch.tensor(1e30, dtype=data.dtype, device=data.device)
    valid = mesh.cnbr_valid                                   # [nC,K]
    vn = data[mesh.cnbr]                                      # [nC,K(,C)]
    vmask = (valid[:, :, None] if vec else valid) > 0
    vmax = torch.amax(torch.where(vmask, vn, -big), dim=1)
    vmin = torch.amin(torch.where(vmask, vn, big), dim=1)
    # the boundary face values extend the extrema
    act = mesh.face_active
    for p, bc in zip(mesh.patches, field.bcs):
        cells = mesh.owner[p.slice]
        a = act[p.slice]
        vb = pf.evaluate(bc, mesh, p, data)
        am = (a[:, None] if vec else a) > 0
        idx = cells[:, None].expand_as(vb) if vec else cells
        vmax = vmax.scatter_reduce(0, idx, torch.where(am, vb, -big), "amax")
        vmin = vmin.scatter_reduce(0, idx, torch.where(am, vb, big), "amin")

    max_d = vmax - data
    min_d = vmin - data
    if k < 1.0:
        rk = (1.0 / max(k, 1e-3) - 1.0)
        span = rk * (max_d - min_d)
        max_d = max_d + span
        min_d = min_d - span

    # extrapolation to every face of the cell (boundary faces included)
    pres = torch.abs(mesh.csign)                              # [nC,K]
    rvec = (mesh.cf[mesh.cface] - mesh.c[:, None, :]) * pres[:, :, None]
    if vec:
        ext = torch.einsum("cki,cij->ckj", rvec, g)           # [nC,K,C]
        md, nd = max_d[:, None, :], min_d[:, None, :]
        pm = pres[:, :, None]
    else:
        ext = torch.sum(rvec * g[:, None, :], dim=2)          # [nC,K]
        md, nd = max_d[:, None], min_d[:, None]
        pm = pres
    tinyx = 1e-30
    lim_hi = torch.where(ext > md + tinyx,
                         md / torch.clamp(ext, min=tinyx), 1.0)
    lim_lo = torch.where(ext < nd - tinyx,
                         nd / torch.clamp(ext, max=-tinyx), 1.0)
    lim = torch.clamp(torch.minimum(lim_hi, lim_lo), 0.0, 1.0)
    lim = torch.where(pm > 0, lim, 1.0)
    limiter = torch.amin(lim, dim=1)                          # [nC(,C)]
    if vec:
        return g * limiter[:, None, :]
    return g * limiter[:, None]


def grad_of(mesh, field: VolField, scheme: str = "Gauss linear") -> Any:
    """Gradient dispatch by fvSchemes keyword (gradScheme::New):
    'Gauss linear' (and any 'Gauss ...'), 'leastSquares',
    'cellLimited <base...> <k>', and 'faceLimited ...', which the
    reference maps to cellLimited."""
    toks = str(scheme).split()
    if not toks or toks == ["linear"]:
        return grad(mesh, field)
    if toks[0] in ("cellLimited", "faceLimited"):
        k = float(toks[-1])
        base = " ".join(toks[1:-1]) or "Gauss linear"
        return grad_cell_limited(mesh, field, grad_of(mesh, field, base), k)
    if toks[0] == "leastSquares":
        return grad_least_squares(mesh, field)
    if toks[0] == "Gauss":
        return grad(mesh, field)
    raise ValueError(f"unknown gradScheme {scheme!r}")


def grad_component(mesh, data: Any, bvals: Any) -> Any:
    """Gauss gradient of raw per-cell data [nC(,C)] with the given
    boundary face values [nBf(,C)] -> [nC,3(,C)]."""
    return slot_mod.grad(mesh, data, bvals)


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
