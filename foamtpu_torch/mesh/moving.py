"""Dynamic mesh: geometry recomputed on the device from moved points, and
the solid-body motion functions (port of openfoam-2.2.x_tpu/mesh/moving.py;
src/dynamicFvMesh solidBodyMotionFvMesh, the solidBodyMotionFunctions
linearMotion / oscillatingLinearMotion / rotatingMotion, and the
mesh-flux machinery of the moving-mesh solvers).

The topology is static: the slot tables, the stencil offsets and the COO
remainder's row layout (`FvMesh.fb_layout`) never change, so
`update_geometry` returns a `dataclasses.replace` of the mesh that keeps
them and replaces every geometric tensor: face centres and areas, cell
centres and volumes, interpolation factors, delta coefficients, the
slot-form coefficients and the remainder's `fb_*` coefficients. All of
it runs on the mesh's device, once per time step. The reference's
`jax.ops.segment_sum` is `index_add_` here (atomic on the card, so the
order of a cell's 2-6 face terms is not fixed: f64 parity holds to
round-off, not to 0 ulp).

`topo_from_poly`'s host half (the padded face tables and the wall faces)
is a numpy copy of the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Tuple

import numpy as np
import torch

from ..core.precision import label_dtype
from .core import FvMesh, PolyMesh


class MeshTopo(NamedTuple):
    """Static-topology device tables needed to rebuild geometry from
    points."""
    face_pts: Any      # [nF,maxPts] int (pad clamped to 0)
    face_valid: Any    # [nF,maxPts] 1/0
    face_npts: Any     # [nF] float
    nxt: Any           # [nF,maxPts] int: next-vertex slot index
    face_shift: Any    # [nIf,3] (zeros when no cyclics)
    wall_faces: Any    # [nWf] int flat wall-face ids
    wall_cells: Any    # [nWf] int owner cells of those faces


def topo_from_poly(pm: PolyMesh, dtype, device) -> MeshTopo:
    """The face tables of `pm` on `device` (host numpy, then one copy
    each)."""
    nF, mp = pm.face_pts.shape
    idx = np.arange(mp)
    valid = idx[None, :] < pm.face_npts[:, None]
    fpts = np.clip(pm.face_pts, 0, None)
    nxt = (idx[None, :] + 1) % np.maximum(pm.face_npts[:, None], 1)
    shift = (pm.face_shift if pm.face_shift is not None
             else np.zeros((pm.n_internal_faces, 3)))
    wf, wc = [], []
    for p in pm.patches:
        if p.type == "wall":
            f = np.arange(p.start, p.start + p.size)
            wf.append(f)
            wc.append(pm.owner[f])
    wall_faces = (np.concatenate(wf) if wf else np.zeros(0, np.int64))
    wall_cells = (np.concatenate(wc) if wc else np.zeros(0, np.int64))

    def lab(a):
        return torch.tensor(np.asarray(a), dtype=label_dtype, device=device)

    def flt(a):
        return torch.tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                            device=device)

    return MeshTopo(
        face_pts=lab(fpts), face_valid=flt(valid), face_npts=flt(pm.face_npts),
        nxt=lab(nxt), face_shift=flt(shift), wall_faces=lab(wall_faces),
        wall_cells=lab(wall_cells))


def _seg(vals, idx, n):
    """segment_sum(vals, idx, num_segments=n)."""
    return vals.new_zeros((n,) + tuple(vals.shape[1:])).index_add_(0, idx,
                                                                    vals)


def _dot(a, b):
    return torch.sum(a * b, dim=1)


def update_geometry(mesh: FvMesh, points: Any, topo: MeshTopo) -> FvMesh:
    """Recompute every geometric quantity of the FvMesh from new point
    positions (topology static)."""
    nif = mesh.n_internal_faces
    nC = mesh.n_cells

    # -- face centres / areas (fan triangulation, mesh/core.py) -------------
    fv = topo.face_valid[:, :, None]
    fp = points[topo.face_pts] * fv
    c_est = torch.sum(fp, dim=1) / topo.face_npts[:, None]
    p_i = fp
    p_n = torch.gather(fp, 1, topo.nxt[:, :, None].expand(-1, -1, 3))
    n_tri = torch.linalg.cross(p_n - p_i, c_est[:, None, :] - p_i, dim=2)
    n_tri = n_tri * fv
    a_tri = torch.linalg.vector_norm(n_tri, dim=2)
    c_tri = (p_i + p_n + c_est[:, None, :]) / 3.0
    sum_n = torch.sum(n_tri, dim=1)
    sum_a = torch.sum(a_tri, dim=1)
    sum_ac = torch.sum(a_tri[:, :, None] * c_tri, dim=1)
    small = sum_a < 1e-20
    cf = torch.where(small[:, None], c_est,
                     sum_ac / torch.clamp(sum_a, min=1e-30)[:, None])
    sf = 0.5 * sum_n
    mag_sf = torch.linalg.vector_norm(sf, dim=1)

    # -- cell centres / volumes (pyramids, mesh/core.py) --------------------
    cf_nei = cf[:nif] + topo.face_shift
    own, nei = mesh.owner, mesh.neighbour
    c_acc = _seg(cf, own, nC) + _seg(cf_nei, nei, nC)
    n_cf = (_seg(torch.ones_like(mag_sf), own, nC)
            + _seg(mag_sf.new_ones(nif), nei, nC))
    ce = c_acc / n_cf[:, None]

    def pyr(cells, sign, cf_, sf_):
        p3 = sign * _dot(sf_, cf_ - ce[cells])
        pc = 0.75 * cf_ + 0.25 * ce[cells]
        return _seg(p3, cells, nC), _seg(p3[:, None] * pc, cells, nC)

    v1, c1 = pyr(own, 1.0, cf, sf)
    v2, c2 = pyr(nei, -1.0, cf_nei, sf[:nif])
    vol3 = v1 + v2
    ctr = torch.where(torch.abs(vol3)[:, None] > 1e-30,
                      (c1 + c2) / vol3[:, None], ce)
    v = vol3 / 3.0

    # -- interpolation factors (mesh/core.py::_update_interpolation) --------
    c_nei = ctr[nei] - topo.face_shift
    sfd_own = torch.abs(_dot(sf[:nif], cf[:nif] - ctr[own[:nif]]))
    sfd_nei = torch.abs(_dot(sf[:nif], c_nei - cf[:nif]))
    w = torch.ones(mesh.n_faces, dtype=v.dtype, device=v.device)
    w[:nif] = sfd_nei / torch.clamp(sfd_own + sfd_nei, min=1e-30)
    delta = torch.cat([c_nei - ctr[own[:nif]], cf[nif:] - ctr[own[nif:]]],
                      dim=0)
    mag_delta = torch.linalg.vector_norm(delta, dim=1)
    dc = 1.0 / torch.clamp(mag_delta, min=1e-30)
    nhat = sf / torch.clamp(mag_sf, min=1e-30)[:, None]
    sn = _dot(nhat, delta)
    nodc = 1.0 / torch.maximum(sn, 0.05 * mag_delta)
    corr = nhat - delta * nodc[:, None]

    # -- slot-form geometry re-gather (the to_device block) -----------------
    st_cf = mesh.st_cface
    st_v = mesh.st_valid
    st_s = mesh.st_sign
    w_i = w[st_cf]
    st_wself = torch.where(st_s > 0, w_i, 1.0 - w_i) * st_v
    st_magsf = mag_sf[st_cf] * st_v
    st_dc = dc[st_cf] * st_v
    st_nodc = nodc[st_cf] * st_v
    st_sf = sf[st_cf] * (st_v * st_s)[:, :, None]
    st_corr = corr[st_cf] * st_v[:, :, None]
    if mesh.fb_faces.shape[0]:
        fbf = mesh.fb_faces
        fb_w = w[fbf]
        fb_wself = torch.where(mesh.fb_signs > 0, fb_w, 1.0 - fb_w)
        fb_magsf = mag_sf[fbf]
        fb_dc = dc[fbf]
        fb_nodc = nodc[fbf]
        fb_sf = sf[fbf] * mesh.fb_signs[:, None]
        fb_corr = corr[fbf]
    else:
        fb_wself, fb_magsf, fb_dc, fb_nodc = (mesh.fb_wself, mesh.fb_magsf,
                                              mesh.fb_dc, mesh.fb_nodc)
        fb_sf, fb_corr = mesh.fb_sf, mesh.fb_corr

    # wall distance of wall-adjacent cells
    if topo.wall_faces.shape[0]:
        yw = 1.0 / torch.clamp(dc[topo.wall_faces], min=1e-30)
        acc = _seg(yw, topo.wall_cells, nC)
        wall_y = torch.where(mesh.wall_cnt > 0,
                             acc / torch.clamp(mesh.wall_cnt, min=1.0),
                             torch.ones_like(acc))
    else:
        wall_y = mesh.wall_y

    return dataclasses.replace(
        mesh, ab_sf=sf[nif:][mesh.ab_rel],
        sf=sf, mag_sf=mag_sf, cf=cf, c=ctr, v=v, weights=w,
        delta_coeffs=dc, non_orth_delta_coeffs=nodc,
        correction_vecs=corr, st_wself=st_wself, st_magsf=st_magsf,
        st_dc=st_dc, st_nodc=st_nodc, st_sf=st_sf, st_corr=st_corr,
        fb_wself=fb_wself, fb_magsf=fb_magsf, fb_dc=fb_dc,
        fb_nodc=fb_nodc, fb_sf=fb_sf, fb_corr=fb_corr, wall_y=wall_y)


# ---------------------------------------------------------------------------
# solidBodyMotionFunctions (src/fvMotionSolver/solidBodyMotionFunctions/
# linearMotion, oscillatingLinearMotion, rotatingMotion). Each returns
# (pts(p0, t), umesh(x, t)); the vectors take the dtype and device of the
# tensor they are applied to, t may be a float or a 0-d tensor.
# ---------------------------------------------------------------------------


def _vec(v, like):
    return torch.tensor(np.asarray(v, dtype=float), dtype=like.dtype,
                        device=like.device)


def _time(t, like):
    return torch.as_tensor(t, dtype=like.dtype, device=like.device)


def linear_motion(velocity) -> Tuple[Callable, Callable]:
    """points(t) = p0 + v t; U_mesh = v."""
    vv = np.asarray(velocity, dtype=float)

    def pts(p0, t):
        return p0 + _vec(vv, p0) * _time(t, p0)

    def umesh(x, t):
        return _vec(vv, x).expand(x.shape)

    return pts, umesh


def oscillating_linear_motion(amplitude, omega: float
                              ) -> Tuple[Callable, Callable]:
    """points(t) = p0 + A sin(w t); U_mesh = A w cos(w t)."""
    A = np.asarray(amplitude, dtype=float)

    def pts(p0, t):
        return p0 + _vec(A, p0) * torch.sin(omega * _time(t, p0))

    def umesh(x, t):
        return (_vec(A, x) * (omega * torch.cos(omega * _time(t, x)))
                ).expand(x.shape)

    return pts, umesh


def rotating_motion(origin, axis, omega: float
                    ) -> Tuple[Callable, Callable]:
    """Rigid rotation about (origin, axis) at rate omega [rad/s]."""
    o = np.asarray(origin, dtype=float)
    ax = np.asarray(axis, dtype=float)
    ax = ax / max(np.linalg.norm(ax), 1e-30)

    def pts(p0, t):
        th = omega * _time(t, p0)
        k = _vec(ax, p0)
        r = p0 - _vec(o, p0)
        # Rodrigues rotation
        return (_vec(o, p0) + r * torch.cos(th)
                + torch.linalg.cross(k.expand(r.shape), r, dim=1)
                * torch.sin(th)
                + k[None, :] * (r @ k)[:, None] * (1 - torch.cos(th)))

    def umesh(x, t):
        k = _vec(ax, x)
        r = x - _vec(o, x)
        return omega * torch.linalg.cross(k.expand(r.shape), r, dim=1)

    return pts, umesh


def mesh_flux(mesh: FvMesh, umesh_fn: Callable, t) -> Any:
    """meshPhi: U_mesh . Sf at face centres (the exact space-conservation
    flux of a rigid motion; fvMesh::phi())."""
    return _dot(umesh_fn(mesh.cf, t), mesh.sf)
