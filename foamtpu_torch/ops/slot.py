"""Slot-form FV primitives (port of openfoam-2.2.x_tpu/ops/slot.py).

A face quantity lives at [nC, M]: slot (c, m) holds the value of the
face between cell c and cell c + d_m (each internal face is stored once
per side); the irregular remainder lives in the COO fallback [nfb];
boundary faces stay flat [nBf]. Neighbour access c -> c + d_m is
torch.roll, which has jnp.roll's circular semantics; `.at[i].add`
becomes `index_add`. The off-diagonal product `off_apply` goes through
the offset-stencil SpMV kernel (ops/spmv.py).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from . import spmv


def nbr_values(mesh, data: Any) -> Any:
    """[nC(,C)] cell data -> [nC,M(,C)] values at c + d_m (unmasked:
    invalid slots hold wrapped values — multiply by st_valid downstream)."""
    return torch.stack([torch.roll(data, -d, dims=0) for d in mesh.st_deltas],
                       dim=1)


def fb_pair(mesh, data: Any) -> Tuple[Any, Any]:
    """Fallback self/neighbour values ([nfb(,C)], [nfb(,C)])."""
    return data[mesh.fb_cells], data[mesh.fb_nbrs]


class SlotFace(NamedTuple):
    """A face field in slot form: sv [nC,M(,C)], fb [nfb(,C)],
    bv [nBf(,C)] (None where not materialised)."""

    sv: Any
    fb: Any
    bv: Optional[Any] = None


def _empty_fb(data: Any) -> Any:
    return data.new_zeros((0,) + tuple(data.shape[1:]))


def interpolate(mesh, data: Any, bv: Optional[Any] = None) -> SlotFace:
    """Linear cell->face interpolation in slot form:
    vf = wself*self + (1-wself)*nbr."""
    nb = nbr_values(mesh, data)
    if data.ndim == 2:
        w = mesh.st_wself[:, :, None]
        sv = w * data[:, None, :] + (1.0 - w) * nb
    else:
        w = mesh.st_wself
        sv = w * data[:, None] + (1.0 - w) * nb
    if mesh.fb_cells.shape[0]:
        s, n = fb_pair(mesh, data)
        wf = mesh.fb_wself if data.ndim == 1 else mesh.fb_wself[:, None]
        fb = wf * s + (1.0 - wf) * n
    else:
        fb = _empty_fb(data)
    return SlotFace(sv, fb, bv)


def delta(mesh, data: Any) -> SlotFace:
    """nbr - self per slot (for snGrad-style differences)."""
    nb = nbr_values(mesh, data)
    sv = nb - (data[:, None, :] if data.ndim == 2 else data[:, None])
    if mesh.fb_cells.shape[0]:
        s, n = fb_pair(mesh, data)
        fb = n - s
    else:
        fb = _empty_fb(data)
    return SlotFace(sv, fb)


def surface_sum(mesh, f: SlotFace) -> Any:
    """Sum of OUTWARD-signed face values per cell (fvc::surfaceIntegrate
    * V). Slot values are stored unsigned; the orientation sign is
    st_sign/fb_signs. Boundary values f.bv [nBf] add through a small
    index_add over the active boundary faces."""
    sv = f.sv
    if sv.ndim == 3:
        acc = torch.sum(sv * (mesh.st_sign * mesh.st_valid)[:, :, None],
                        dim=1)
    else:
        acc = torch.sum(sv * mesh.st_sign * mesh.st_valid, dim=1)
    if mesh.fb_cells.shape[0]:
        contrib = f.fb * (mesh.fb_signs[:, None] if f.fb.ndim == 2
                          else mesh.fb_signs)
        acc = acc.index_add(0, mesh.fb_cells, contrib)
    if f.bv is not None:
        acc = acc.index_add(0, mesh.ab_owner, f.bv[mesh.ab_rel])
    return acc


def weighted_cell_sum(mesh, f: SlotFace, absolute: bool = False) -> Any:
    """sum_f |v_f| (absolute=True) or unsigned sum over each cell's faces
    (each internal face counts for BOTH adjacent cells)."""
    sv = torch.abs(f.sv) if absolute else f.sv
    acc = torch.sum(sv * mesh.st_valid, dim=1)
    if mesh.fb_cells.shape[0]:
        c = torch.abs(f.fb) if absolute else f.fb
        acc = acc.index_add(0, mesh.fb_cells, c)
    if f.bv is not None:
        bva = f.bv[mesh.ab_rel]
        bva = torch.abs(bva) if absolute else bva
        acc = acc.index_add(0, mesh.ab_owner, bva)
    return acc


def to_flat_internal(mesh, f: SlotFace) -> Any:
    """Extract the flat [nIf(,C)] internal-face array."""
    sv = f.sv
    lin = sv.reshape((-1,) + tuple(sv.shape[2:]))
    out = lin[mesh.ex_own_lin]
    if mesh.ex_fb_faces.shape[0]:
        out = out.index_copy(0, mesh.ex_fb_faces, f.fb[mesh.ex_fb_idx])
    return out


def to_flat(mesh, f: SlotFace) -> Any:
    """Full flat [nF(,C)] face array (internal extraction + boundary)."""
    fi = to_flat_internal(mesh, f)
    if f.bv is None:
        pad = fi.new_zeros((mesh.n_boundary_faces,) + tuple(fi.shape[1:]))
        return torch.cat([fi, pad], dim=0)
    return torch.cat([fi, f.bv], dim=0)


def from_flat(mesh, face_vals: Any) -> SlotFace:
    """Gather a flat [nF(,C)] face array into slot form."""
    sv = face_vals[mesh.st_cface]
    fb = (face_vals[mesh.fb_faces] if mesh.fb_cells.shape[0]
          else _empty_fb(face_vals))
    bv = face_vals[mesh.n_internal_faces:]
    return SlotFace(sv, fb, bv)


def grad(mesh, data: Any, bv: Any) -> Any:
    """Gauss gradient, slot form. scalar [nC] -> [nC,3]; vector [nC,3] ->
    [nC,3,3] with g[c,i,j] = d(u_j)/d(x_i). bv [nBf(,C)] are the
    boundary face values from the BC layer."""
    f = interpolate(mesh, data)
    if data.ndim == 1:
        acc = torch.sum(mesh.st_sf * f.sv[:, :, None], dim=1)
        if mesh.fb_cells.shape[0]:
            acc = acc.index_add(0, mesh.fb_cells, mesh.fb_sf * f.fb[:, None])
        acc = acc.index_add(0, mesh.ab_owner,
                            mesh.ab_sf * bv[mesh.ab_rel][:, None])
        return acc / mesh.v[:, None]
    acc = torch.sum(mesh.st_sf[:, :, :, None] * f.sv[:, :, None, :], dim=1)
    if mesh.fb_cells.shape[0]:
        acc = acc.index_add(0, mesh.fb_cells,
                            mesh.fb_sf[:, :, None] * f.fb[:, None, :])
    acc = acc.index_add(0, mesh.ab_owner,
                        mesh.ab_sf[:, :, None] * bv[mesh.ab_rel][:, None, :])
    return acc / mesh.v[:, None, None]


def flux_of(mesh, vec_data: Any, bv: Optional[Any] = None) -> SlotFace:
    """Face flux Sf . interp(vec) in slot form (owner->neighbour oriented
    face value, identical on both sides). bv = boundary flux [nBf]."""
    f = interpolate(mesh, vec_data)
    sv = mesh.st_sign * torch.sum(mesh.st_sf * f.sv, dim=2)
    if mesh.fb_cells.shape[0]:
        fb = mesh.fb_signs * torch.sum(mesh.fb_sf * f.fb, dim=1)
    else:
        fb = vec_data.new_zeros((0,))
    return SlotFace(sv, fb, bv)


def laplacian_correction(mesh, gamma_slot: SlotFace, data: Any, bv: Any,
                         limit: float = 1.0) -> Tuple[SlotFace, Any]:
    """Non-orthogonal deferred correction of the Gauss laplacian in slot
    form: the per-face correction and its signed cell sum."""
    if data.ndim != 1:
        raise NotImplementedError("slot laplacian correction is scalar-only")
    g = grad(mesh, data, bv)
    gf = interpolate(mesh, g)
    corr_sv = (gamma_slot.sv * mesh.st_magsf
               * torch.sum(mesh.st_corr * gf.sv, dim=2))
    if mesh.fb_cells.shape[0]:
        corr_fb = (gamma_slot.fb * mesh.fb_magsf
                   * torch.sum(mesh.fb_corr * gf.fb, dim=1))
    else:
        corr_fb = data.new_zeros((0,))
    if limit < 1.0:
        d = delta(mesh, data)
        orth = gamma_slot.sv * mesh.st_magsf * mesh.st_nodc * (
            mesh.st_sign * d.sv)
        cap = (limit / (1.0 - limit)) * torch.abs(orth)
        corr_sv = torch.clamp(corr_sv, -cap, cap)
        if mesh.fb_cells.shape[0]:
            orth_fb = gamma_slot.fb * mesh.fb_magsf * mesh.fb_nodc * (
                mesh.fb_signs * d.fb)
            cap_fb = (limit / (1.0 - limit)) * torch.abs(orth_fb)
            corr_fb = torch.clamp(corr_fb, -cap_fb, cap_fb)
    corr = SlotFace(corr_sv, corr_fb)
    return corr, surface_sum(mesh, corr)


def laplacian_flux(mesh, gamma_slot: SlotFace, data: Any, corrected: bool,
                   corr: Optional[SlotFace] = None) -> SlotFace:
    """Internal-face flux of the symmetric laplacian operator:
    F = coef*(psi_nei - psi_own) (+ deferred correction), as an
    owner-oriented slot face value."""
    dcs = mesh.st_nodc if corrected else mesh.st_dc
    dcf = mesh.fb_nodc if corrected else mesh.fb_dc
    d = delta(mesh, data)
    sv = gamma_slot.sv * mesh.st_magsf * dcs * (mesh.st_sign * d.sv)
    if mesh.fb_cells.shape[0]:
        fb = gamma_slot.fb * mesh.fb_magsf * dcf * (mesh.fb_signs * d.fb)
    else:
        fb = data.new_zeros((0,))
    if corr is not None:
        sv = sv + corr.sv
        fb = fb + corr.fb
    return SlotFace(sv, fb)


def off_apply(mesh, soff: Any, sfb: Any, psi: Any) -> Any:
    """Off-diagonal SpMV from slot coefficients:
    sum_m soff[c,m] * psi[c+d_m] (+ fallback), through the offset-stencil
    kernel (ops/spmv.py)."""
    acc = spmv.spmv(None, psi, soff, tuple(mesh.st_deltas))
    if mesh.fb_cells.shape[0]:
        pn = psi[mesh.fb_nbrs]
        acc = acc.index_add(0, mesh.fb_cells,
                            sfb[:, None] * pn if psi.ndim == 2 else sfb * pn)
    return acc
