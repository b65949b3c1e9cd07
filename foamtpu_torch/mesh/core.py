"""Unstructured finite-volume mesh: host topology/geometry + torch tables.

Port of openfoam-2.2.x_tpu/mesh/core.py. Lines 1-505 of that file (the
host half: `Patch`, `face_centres_areas`, `cell_centres_volumes`,
`PolyMesh`, `internalize_cyclics`, `offset_stencil`) are copied here
unchanged in behaviour: the reference module runs `import jax` when it
registers its FvMesh pytree, so the port cannot import it. The device
half (`FvMesh`, `to_device`) is written for torch: a plain dataclass of
tensors on an explicit device.
"""


from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.precision import (DEFAULT_DEVICE, label_dtype, label_np,
                               scalar_dtype, scalar_np)
from ..ops.spmv import row_layout

# ---------------------------------------------------------------------------
# Patches
# ---------------------------------------------------------------------------

# Geometric/constraint patch types understood by the framework
# (reference: src/OpenFOAM/meshes/polyMesh/polyPatches/).
PATCH_TYPES = (
    "patch",
    "wall",
    "empty",
    "symmetryPlane",
    "symmetry",
    "cyclic",
    "wedge",
    "processor",
    "mappedWall",
    "cyclicAMI",
)


@dataclasses.dataclass(frozen=True)
class Patch:
    """A boundary patch = contiguous face range [start, start+size)."""

    name: str
    type: str
    start: int
    size: int
    # for cyclic/cyclicAMI patches: name of the coupled partner
    neighbour_patch: Optional[str] = None
    # static extras (cyclicAMI transform etc.) as hashable pairs
    attrs: Tuple[Tuple[str, str], ...] = ()

    def attr(self, key: str, default=None):
        for k, v in self.attrs:
            if k == key:
                return v
        return default

    @property
    def slice(self) -> slice:
        return slice(self.start, self.start + self.size)


# ---------------------------------------------------------------------------
# Geometry kernels (host, NumPy f64)
# ---------------------------------------------------------------------------


def face_centres_areas(
    points: np.ndarray, face_pts: np.ndarray, face_npts: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Face centres and area vectors by fan triangulation about the
    point-average centre (the reference's algorithm, exact for planar
    and consistent for warped faces). The copy always takes the numpy
    path (the JAX package routes large meshes through its native
    helper, same formula)."""
    n_faces, max_pts = face_pts.shape
    idx = np.arange(max_pts)
    valid = idx[None, :] < face_npts[:, None]  # [nF, maxPts]
    fpts = np.clip(face_pts, 0, None)
    fp = np.where(valid[:, :, None], points[fpts], 0.0)
    c_est = fp.sum(axis=1) / face_npts[:, None]

    nxt = (idx[None, :] + 1) % np.maximum(face_npts[:, None], 1)
    p_i = np.where(valid[:, :, None], points[fpts], 0.0)
    p_n = np.where(valid[:, :, None], points[np.take_along_axis(fpts, nxt, axis=1)], 0.0)

    tri_n = np.cross(p_n - p_i, c_est[:, None, :] - p_i)  # 2x triangle normal
    tri_a = np.linalg.norm(tri_n, axis=2)
    tri_c = p_i + p_n + c_est[:, None, :]  # 3x triangle centroid
    tri_n = np.where(valid[:, :, None], tri_n, 0.0)
    tri_a = np.where(valid, tri_a, 0.0)

    sum_n = tri_n.sum(axis=1)
    sum_a = tri_a.sum(axis=1)
    sum_ac = (tri_a[:, :, None] * tri_c).sum(axis=1)

    small = sum_a < 1e-30
    ctr = np.where(small[:, None], c_est, sum_ac / np.maximum(sum_a, 1e-300)[:, None] / 3.0)
    area = 0.5 * sum_n
    # triangles degenerate for 3-point faces handled fine by the same formula
    return ctr, area


def cell_centres_volumes(
    owner: np.ndarray,
    neighbour: np.ndarray,
    n_cells: int,
    cf: np.ndarray,
    sf: np.ndarray,
    face_shift: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Cell centres/volumes by pyramid decomposition about the estimated
    centre (average of face centres), as in the reference. face_shift
    [nIf,3] is the translation of internalised cyclic faces: the
    neighbour cell sees the face at cf + shift (its own side of the
    periodic gap)."""
    n_ifaces = neighbour.shape[0]
    cf_nei = cf[:n_ifaces]
    if face_shift is not None:
        cf_nei = cf_nei + face_shift
    # estimated centre: average of face centres over each cell's faces
    c_est = np.zeros((n_cells, 3))
    n_cf = np.zeros(n_cells)
    np.add.at(c_est, owner, cf)
    np.add.at(n_cf, owner, 1.0)
    np.add.at(c_est, neighbour, cf_nei)
    np.add.at(n_cf, neighbour, 1.0)
    c_est /= n_cf[:, None]

    vol = np.zeros(n_cells)
    ctr = np.zeros((n_cells, 3))

    def accum(cells, sign, cf_, sf_):
        pyr3vol = sign * np.einsum("fi,fi->f", sf_, cf_ - c_est[cells])
        pc = 0.75 * cf_ + 0.25 * c_est[cells]
        np.add.at(vol, cells, pyr3vol)
        np.add.at(ctr, cells, pyr3vol[:, None] * pc)

    accum(owner, 1.0, cf, sf)
    accum(neighbour, -1.0, cf_nei, sf[:n_ifaces])

    ctr = np.where(np.abs(vol)[:, None] > 1e-300, ctr / vol[:, None], c_est)
    vol = vol / 3.0
    return ctr, vol


# ---------------------------------------------------------------------------
# Host mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PolyMesh:
    """Host-side mesh: topology + derived geometry (NumPy, float64)."""

    points: np.ndarray          # [nPts, 3]
    face_pts: np.ndarray        # [nF, maxPts] padded with -1
    face_npts: np.ndarray       # [nF]
    owner: np.ndarray           # [nF]
    neighbour: np.ndarray       # [nIf]
    patches: List[Patch]
    # translation of internalised cyclic faces [nIf,3] (None = all zero):
    # the neighbour cell's copy of the face sits at cf + face_shift
    face_shift: np.ndarray = None
    # named cell zones: {name: [nZoneCells] int cell ids} (reference:
    # polyMesh/zones/cellZone — used by MRF/porous/fvOptions selection)
    cell_zones: Dict[str, np.ndarray] = None

    # derived (filled by update_geometry)
    cf: np.ndarray = None       # face centres [nF,3]
    sf: np.ndarray = None       # face area vectors [nF,3]
    mag_sf: np.ndarray = None   # [nF]
    c: np.ndarray = None        # cell centres [nC,3]
    v: np.ndarray = None        # cell volumes [nC]
    weights: np.ndarray = None  # interpolation weights [nF] (boundary = 1)
    delta_coeffs: np.ndarray = None       # [nF]
    non_orth_delta_coeffs: np.ndarray = None  # [nF]
    correction_vecs: np.ndarray = None    # [nF,3] non-orthogonality correction

    def __post_init__(self):
        self.owner = np.asarray(self.owner, dtype=np.int64)
        self.neighbour = np.asarray(self.neighbour, dtype=np.int64)
        if self.cell_zones is None:
            self.cell_zones = {}
        if self.cf is None:
            self.update_geometry()

    # -- sizes --------------------------------------------------------------
    @property
    def n_points(self) -> int:
        return self.points.shape[0]

    @property
    def n_faces(self) -> int:
        return self.owner.shape[0]

    @property
    def n_internal_faces(self) -> int:
        return self.neighbour.shape[0]

    @property
    def n_boundary_faces(self) -> int:
        return self.n_faces - self.n_internal_faces

    @property
    def n_cells(self) -> int:
        m = int(self.owner.max()) if self.owner.size else -1
        if self.neighbour.size:
            m = max(m, int(self.neighbour.max()))
        return m + 1

    def patch(self, name: str) -> Patch:
        for p in self.patches:
            if p.name == name:
                return p
        raise KeyError(f"no patch named {name!r}")

    # -- geometry -----------------------------------------------------------
    def update_geometry(self) -> None:
        self.cf, self.sf = face_centres_areas(self.points, self.face_pts, self.face_npts)
        self.mag_sf = np.linalg.norm(self.sf, axis=1)
        self.c, self.v = cell_centres_volumes(
            self.owner, self.neighbour, self.n_cells, self.cf, self.sf,
            self.face_shift,
        )
        self._update_interpolation()

    def _update_interpolation(self) -> None:
        nif = self.n_internal_faces
        own, nei = self.owner[:nif], self.neighbour
        sf, cf = self.sf[:nif], self.cf[:nif]
        c_nei = self.c[nei]
        if self.face_shift is not None:
            # cyclic-internalised faces: bring the neighbour cell centre
            # into the owner side's frame
            c_nei = c_nei - self.face_shift

        sfd_own = np.abs(np.einsum("fi,fi->f", sf, cf - self.c[own]))
        sfd_nei = np.abs(np.einsum("fi,fi->f", sf, c_nei - cf))
        w = np.ones(self.n_faces)
        w[:nif] = sfd_nei / np.maximum(sfd_own + sfd_nei, 1e-300)
        self.weights = w

        delta = np.empty((self.n_faces, 3))
        delta[:nif] = c_nei - self.c[own]
        bsl = slice(nif, self.n_faces)
        delta[bsl] = self.cf[bsl] - self.c[self.owner[bsl]]
        mag_delta = np.linalg.norm(delta, axis=1)
        self.delta_coeffs = 1.0 / np.maximum(mag_delta, 1e-300)

        nhat = self.sf / np.maximum(self.mag_sf, 1e-300)[:, None]
        sn = np.einsum("fi,fi->f", nhat, delta)
        self.non_orth_delta_coeffs = 1.0 / np.maximum(sn, 0.05 * mag_delta)
        self.correction_vecs = nhat - delta * self.non_orth_delta_coeffs[:, None]
        # empty patches get zero correction (no flux through them anyway)

    # -- cell->face adjacency (gather tables) --------------------------------
    def cell_tables(self) -> Dict[str, np.ndarray]:
        """Build padded per-cell gather tables.

        Returns arrays of shape [nC, K] with K = max faces/cell:
          cface       face index (pad -> 0)
          csign       +1 cell is owner / -1 neighbour / 0 pad
          cnbr        adjacent cell across internal face (pad/boundary -> 0)
          cnbr_valid  1.0 for internal faces, else 0.0
          cbnd        1.0 for boundary faces, else 0.0
          cface_i     face index clamped to internal range (for upper/lower gathers)
        """
        nC, nF, nIf = self.n_cells, self.n_faces, self.n_internal_faces
        counts = np.zeros(nC, dtype=np.int64)
        np.add.at(counts, self.owner, 1)
        np.add.at(counts, self.neighbour, 1)
        K = int(counts.max())

        cface = np.zeros((nC, K), dtype=np.int64)
        csign = np.zeros((nC, K))
        cnbr = np.zeros((nC, K), dtype=np.int64)
        cnbr_valid = np.zeros((nC, K))
        cbnd = np.zeros((nC, K))

        own_counts = np.bincount(self.owner, minlength=nC)

        def slots(cells):
            """Rank of each entry within its cell group (vectorized)."""
            order = np.argsort(cells, kind="stable")
            sorted_cells = cells[order]
            group_start = np.zeros(nC, dtype=np.int64)
            cnts = np.bincount(sorted_cells, minlength=nC)
            group_start[1:] = np.cumsum(cnts)[:-1]
            rank = np.arange(cells.shape[0]) - group_start[sorted_cells]
            inv = np.empty_like(order)
            inv[order] = rank
            return inv

        # owner side: slots 0..own_counts-1
        faces = np.arange(nF)
        k_o = slots(self.owner)
        cface[self.owner, k_o] = faces
        csign[self.owner, k_o] = 1.0
        cnbr[self.owner[:nIf], k_o[:nIf]] = self.neighbour
        cnbr_valid[self.owner[:nIf], k_o[:nIf]] = 1.0
        cbnd[self.owner[nIf:], k_o[nIf:]] = 1.0

        # neighbour side: slots continue after the owner-side count
        k_n = own_counts[self.neighbour] + slots(self.neighbour)
        ifaces = np.arange(nIf)
        cface[self.neighbour, k_n] = ifaces
        csign[self.neighbour, k_n] = -1.0
        cnbr[self.neighbour, k_n] = self.owner[:nIf]
        cnbr_valid[self.neighbour, k_n] = 1.0

        cface_i = np.minimum(cface, max(nIf - 1, 0))
        out = dict(
            cface=cface,
            csign=csign,
            cnbr=cnbr,
            cnbr_valid=cnbr_valid,
            cbnd=cbnd,
            cface_i=cface_i,
            max_faces=K,
        )
        out.update(offset_stencil(cface_i, csign, cnbr, cnbr_valid, nC))
        return out


def internalize_cyclics(pm: PolyMesh) -> PolyMesh:
    """Convert translationally-coupled cyclic patch pairs into internal
    faces (reference: cyclicPolyPatch + cyclicFvPatchField,
    src/OpenFOAM/meshes/polyMesh/polyPatches/constraint/cyclic/).

    TPU-native design: instead of a coupled-interface update per solver
    sweep, each cyclic face pair becomes ONE internal face whose
    neighbour sits across the periodic gap; the separation vector is
    recorded in PolyMesh.face_shift so deltas/weights are exact. The
    periodic coupling then rides the ordinary offset-stencil machinery —
    jnp.roll is itself periodic, so a renumbered periodic direction
    costs nothing extra. Rotational cyclics (transform rotational) are
    not supported yet and raise.
    """
    cyc = {p.name: p for p in pm.patches if p.type == "cyclic"}
    if not cyc:
        return pm
    pairs = []
    done = set()
    for name, p in cyc.items():
        if name in done:
            continue
        nbr_name = p.neighbour_patch
        if nbr_name is None:
            # find the partner pointing at us
            for q in cyc.values():
                if q.neighbour_patch == name:
                    nbr_name = q.name
                    break
        if nbr_name is None or nbr_name not in cyc:
            raise ValueError(f"cyclic patch {name!r} has no partner")
        q = cyc[nbr_name]
        pairs.append((p, q))
        done.add(p.name)
        done.add(q.name)

    nif = pm.n_internal_faces
    drop = np.zeros(pm.n_faces, dtype=bool)
    new_own, new_nei, new_rows, new_shift = [], [], [], []
    for p, q in pairs:
        if p.size != q.size:
            raise ValueError(
                f"cyclic pair {p.name}/{q.name} sizes differ")
        cfa = pm.cf[p.slice]
        cfb = pm.cf[q.slice]
        T = cfb.mean(axis=0) - cfa.mean(axis=0)
        # match faces by shifted centre (translational transform only)
        scale = max(float(np.max(np.abs(cfb - cfb.mean(axis=0)))), 1e-12)
        key_a = np.round((cfa + T) / (1e-6 * scale)).astype(np.int64)
        key_b = np.round(cfb / (1e-6 * scale)).astype(np.int64)
        oa = np.lexsort(key_a.T)
        ob = np.lexsort(key_b.T)
        if not np.allclose(cfa[oa] + T, cfb[ob], atol=1e-4 * scale):
            raise ValueError(
                f"cyclic pair {p.name}/{q.name}: faces do not match under "
                "a pure translation (rotational cyclics not supported yet)")
        fa = p.start + oa
        fb = q.start + ob
        own_a = pm.owner[fa]
        own_b = pm.owner[fb]
        # keep owner < neighbour: take A's polygon when ownA <= ownB,
        # else B's (each patch's faces point OUT of their own cell, so
        # whichever polygon we keep is correctly owner-outward)
        use_a = own_a <= own_b
        rows = np.where(use_a, fa, fb)
        new_own.append(np.where(use_a, own_a, own_b))
        new_nei.append(np.where(use_a, own_b, own_a))
        new_rows.append(rows)
        new_shift.append(np.where(use_a[:, None], T[None, :], -T[None, :]))
        drop[fa] = True
        drop[fb] = True

    new_rows = np.concatenate(new_rows)
    add_shift = np.concatenate(new_shift)
    n_add = new_rows.shape[0]
    keep_b = ~drop
    keep_b[:nif] = False
    keep_idx = np.nonzero(keep_b)[0]

    order = np.concatenate([np.arange(nif), new_rows, keep_idx])
    face_pts = pm.face_pts[order]
    face_npts = pm.face_npts[order]
    owner = np.concatenate([pm.owner[:nif], np.concatenate(new_own),
                            pm.owner[keep_idx]])
    neighbour = np.concatenate([pm.neighbour, np.concatenate(new_nei)])
    shift = np.zeros((nif + n_add, 3))
    shift[nif:] = add_shift

    # rebuild surviving boundary patches with new starts
    patches = []
    start = nif + n_add
    for p in pm.patches:
        if p.type == "cyclic":
            continue
        patches.append(Patch(name=p.name, type=p.type, start=start,
                             size=p.size, neighbour_patch=p.neighbour_patch))
        start += p.size

    return PolyMesh(points=pm.points, face_pts=face_pts,
                    face_npts=face_npts, owner=owner, neighbour=neighbour,
                    patches=patches, face_shift=shift,
                    cell_zones=dict(pm.cell_zones or {}))


def offset_stencil(cface_i, csign, cnbr, valid, n_cells, max_offsets=8):
    """Offset-canonical neighbor tables — the TPU SpMV design.

    TPU gathers are slow (~order-of-magnitude below bandwidth); after
    renumbering, almost all cell->neighbour hops are one of a few
    constant index offsets (structured interior: exactly +-1, +-nx,
    +-nx*ny — the CuthillMcKee locality the reference exploits for
    cache, reference: src/renumber/). We canonicalise slots so slot m
    always means "neighbour at offset d_m"; the SpMV becomes
    sum_m coeff[:,m] * roll(psi, -d_m) — pure vector ops. The
    unstructured remainder goes to a small COO fallback gather.

    Returns: st_cface [nC,M], st_sign, st_valid, st_deltas (tuple),
    fb_cells/fb_faces/fb_signs/fb_nbrs (1-D COO fallback).
    """
    idx = np.arange(n_cells)[:, None]
    deltas_all = np.where(valid > 0, cnbr - idx, 0)
    vals, counts = np.unique(deltas_all[valid > 0], return_counts=True)
    order = np.argsort(-counts)
    chosen = [int(v) for v in vals[order][:max_offsets]]
    M = max(len(chosen), 1)
    K = cface_i.shape[1]

    st_cface = np.zeros((n_cells, M), dtype=np.int64)
    st_sign = np.zeros((n_cells, M))
    st_valid = np.zeros((n_cells, M))
    covered = np.zeros_like(valid, dtype=bool)
    for m, d in enumerate(chosen):
        match = (deltas_all == d) & (valid > 0) & ~covered
        k_sel = np.argmax(match, axis=1)
        has = match.any(axis=1)
        rows = np.nonzero(has)[0]
        ks = k_sel[rows]
        st_cface[rows, m] = cface_i[rows, ks]
        st_sign[rows, m] = csign[rows, ks]
        st_valid[rows, m] = 1.0
        covered[rows, ks] = True

    fb = (valid > 0) & ~covered
    fb_cells, fb_k = np.nonzero(fb)
    return dict(
        st_cface=st_cface,
        st_sign=st_sign,
        st_valid=st_valid,
        st_deltas=tuple(chosen),
        fb_cells=fb_cells.astype(np.int64),
        fb_faces=cface_i[fb_cells, fb_k],
        fb_signs=csign[fb_cells, fb_k],
        fb_nbrs=cnbr[fb_cells, fb_k],
    )


# ---------------------------------------------------------------------------
# Device mesh (torch dataclass)
# ---------------------------------------------------------------------------

# array fields of FvMesh, in the reference's order (mesh/core.py:530-612)
ARRAY_FIELDS = (
    "sf", "mag_sf", "cf", "c", "v", "weights", "delta_coeffs",
    "non_orth_delta_coeffs", "correction_vecs", "face_active", "owner",
    "neighbour", "cface", "csign", "cnbr", "cnbr_valid", "cbnd", "cface_i",
    "st_cface", "st_sign", "st_valid", "fb_cells", "fb_faces", "fb_signs",
    "fb_nbrs", "st_wself", "st_magsf", "st_dc", "st_nodc", "st_sf",
    "st_corr", "fb_wself", "fb_magsf", "fb_dc", "fb_nodc", "fb_sf",
    "fb_corr", "ex_own_lin", "ex_fb_faces", "ex_fb_idx", "wall_mask",
    "wall_y", "wall_cnt", "ab_rel", "ab_owner", "ab_sf", "ami_entry_face",
    "ami_entry_row", "ami_entry_cell", "ami_entry_w", "ami_mask",
    "ami_wown",
)
STATIC_FIELDS = ("st_deltas", "n_cells", "n_faces", "n_internal_faces",
                 "max_faces", "patches", "orthogonal", "has_ami")


@dataclasses.dataclass(frozen=True)
class FvMesh:
    """Device-side FV mesh: flat geometry tensors + gather tables, with
    the same fields as the reference's FvMesh (see its comments there).
    Float tensors use the scalar dtype, index tensors int64; all live on
    one device. `fb_layout` is port-only (outside ARRAY_FIELDS): the row
    layout of the COO fallback that the SpMV kernel reads
    (ops/spmv.py::row_layout), built by `from_arrays`."""

    sf: Any
    mag_sf: Any
    cf: Any
    c: Any
    v: Any
    weights: Any
    delta_coeffs: Any
    non_orth_delta_coeffs: Any
    correction_vecs: Any
    face_active: Any
    owner: Any
    neighbour: Any
    cface: Any
    csign: Any
    cnbr: Any
    cnbr_valid: Any
    cbnd: Any
    cface_i: Any
    st_cface: Any
    st_sign: Any
    st_valid: Any
    fb_cells: Any
    fb_faces: Any
    fb_signs: Any
    fb_nbrs: Any
    st_wself: Any
    st_magsf: Any
    st_dc: Any
    st_nodc: Any
    st_sf: Any
    st_corr: Any
    fb_wself: Any
    fb_magsf: Any
    fb_dc: Any
    fb_nodc: Any
    fb_sf: Any
    fb_corr: Any
    ex_own_lin: Any
    ex_fb_faces: Any
    ex_fb_idx: Any
    wall_mask: Any
    wall_y: Any
    wall_cnt: Any
    ab_rel: Any
    ab_owner: Any
    ab_sf: Any
    ami_entry_face: Any
    ami_entry_row: Any
    ami_entry_cell: Any
    ami_entry_w: Any
    ami_mask: Any
    ami_wown: Any
    cell_zone_masks: Dict[str, Any]
    st_deltas: Tuple[int, ...]
    n_cells: int
    n_faces: int
    n_internal_faces: int
    max_faces: int
    patches: Tuple[Patch, ...]
    orthogonal: bool = False
    has_ami: bool = False
    fb_layout: Any = None

    @property
    def n_boundary_faces(self) -> int:
        return self.n_faces - self.n_internal_faces

    @property
    def device(self) -> torch.device:
        return self.v.device

    def patch(self, name: str) -> Patch:
        for p in self.patches:
            if p.name == name:
                return p
        raise KeyError(f"no patch named {name!r}")


def from_arrays(arrays: Dict[str, np.ndarray], static: Dict[str, Any],
                cell_zone_masks: Dict[str, np.ndarray],
                device) -> FvMesh:
    """FvMesh from host arrays: float arrays go to the scalar dtype,
    integer arrays to int64, all in one pass to `device`; plus the row
    layout of the COO fallback."""
    fdt, idt = scalar_dtype(), label_dtype

    def dev(a):
        a = np.asarray(a)
        dt = fdt if a.dtype.kind == "f" else idt
        return torch.tensor(a, dtype=dt, device=device)

    return FvMesh(
        **{k: dev(arrays[k]) for k in ARRAY_FIELDS},
        cell_zone_masks={k: dev(v) for k, v in cell_zone_masks.items()},
        **static,
        fb_layout=row_layout(arrays["fb_cells"], arrays["fb_nbrs"],
                             static["n_cells"], device),
    )


def to_device(mesh: PolyMesh, device=DEFAULT_DEVICE) -> FvMesh:
    """Build the torch FvMesh on `device` (twin of the reference's
    mesh/core.py::to_device). Cyclic patch pairs are internalised here;
    cyclicAMI pairs get their interpolation tables (mesh/ami.py) and
    the two-sided delta coefficients of their faces."""
    if any(p.type == "cyclic" for p in mesh.patches):
        mesh = internalize_cyclics(mesh)

    sdt = scalar_np()
    tabs = mesh.cell_tables()

    face_active = np.ones(mesh.n_faces, dtype=sdt)
    for p in mesh.patches:
        if p.type == "empty":
            face_active[p.slice] = 0.0

    nif = mesh.n_internal_faces
    corr_int = mesh.correction_vecs[:nif]
    orthogonal = bool(
        corr_int.size == 0 or np.max(np.linalg.norm(corr_int, axis=1)) < 1e-6
    )

    # slot-form geometry (host gathers, once at load)
    st_cf = tabs["st_cface"]
    st_v = tabs["st_valid"]
    st_s = tabs["st_sign"]
    w_i = mesh.weights[st_cf]
    st_wself = np.where(st_s > 0, w_i, 1.0 - w_i) * st_v
    st_magsf = mesh.mag_sf[st_cf] * st_v
    st_dc = mesh.delta_coeffs[st_cf] * st_v
    st_nodc = mesh.non_orth_delta_coeffs[st_cf] * st_v
    st_sf = mesh.sf[st_cf] * (st_v * st_s)[:, :, None]
    st_corr_t = mesh.correction_vecs[st_cf] * st_v[:, :, None]

    fb_f = tabs["fb_faces"]
    fb_s = tabs["fb_signs"]
    if fb_f.shape[0]:
        fb_w = mesh.weights[fb_f]
        fb_wself = np.where(fb_s > 0, fb_w, 1.0 - fb_w)
        fb_magsf = mesh.mag_sf[fb_f]
        fb_dc = mesh.delta_coeffs[fb_f]
        fb_nodc = mesh.non_orth_delta_coeffs[fb_f]
        fb_sf = mesh.sf[fb_f] * fb_s[:, None]
        fb_corr = mesh.correction_vecs[fb_f]
    else:
        fb_wself = np.zeros((0,))
        fb_magsf = np.zeros((0,))
        fb_dc = np.zeros((0,))
        fb_nodc = np.zeros((0,))
        fb_sf = np.zeros((0, 3))
        fb_corr = np.zeros((0, 3))

    # slot -> flat extraction tables
    M = st_cf.shape[1]
    ex_own_lin = np.full(nif, -1, dtype=np.int64)
    rows, slots = np.nonzero((st_s > 0) & (st_v > 0))
    ex_own_lin[st_cf[rows, slots]] = rows * M + slots
    own_fb = np.nonzero(fb_s > 0)[0]
    ex_fb_faces = fb_f[own_fb]
    ex_fb_idx = own_fb
    missing = int(np.sum(ex_own_lin < 0)) - ex_fb_faces.shape[0]
    assert missing == 0, f"{missing} internal faces lack an owner side"
    ex_own_lin = np.maximum(ex_own_lin, 0)

    # wall adjacency
    wall_mask = np.zeros(mesh.n_cells)
    wall_yacc = np.zeros(mesh.n_cells)
    wall_cnt = np.zeros(mesh.n_cells)
    for p in mesh.patches:
        if p.type != "wall":
            continue
        cells = mesh.owner[p.slice]
        yw = 1.0 / np.maximum(mesh.delta_coeffs[p.slice], 1e-300)
        np.add.at(wall_yacc, cells, yw)
        np.add.at(wall_cnt, cells, 1.0)
        wall_mask[cells] = 1.0
    wall_y = np.where(wall_cnt > 0, wall_yacc / np.maximum(wall_cnt, 1.0),
                      1.0)

    # compact active-boundary tables (skip empty-patch faces entirely)
    ab_rel = np.nonzero(face_active[nif:] > 0)[0].astype(np.int64)
    ab_owner = mesh.owner[nif:][ab_rel]
    ab_sf = mesh.sf[nif:][ab_rel]

    # cyclicAMI interpolation tables
    from . import ami as ami_mod

    ami = ami_mod.build(mesh)
    dcs_all = mesh.delta_coeffs
    nodcs_all = mesh.non_orth_delta_coeffs
    if ami is None:
        nbf_ = mesh.n_faces - nif
        ami_tabs = dict(
            ami_entry_face=np.zeros(0, dtype=np.int64),
            ami_entry_row=np.zeros(0, dtype=np.int64),
            ami_entry_cell=np.zeros(0, dtype=np.int64),
            ami_entry_w=np.zeros(0), ami_mask=np.zeros(nbf_),
            ami_wown=np.ones(nbf_))
    else:
        ami_tabs = dict(
            ami_entry_face=ami.entry_face, ami_entry_row=ami.entry_row,
            ami_entry_cell=ami.entry_cell, ami_entry_w=ami.entry_w,
            ami_mask=ami.face_mask, ami_wown=ami.w_own)
        # coupled faces carry the two-sided (cell-to-cell) delta
        dcs_all = dcs_all.copy()
        nodcs_all = nodcs_all.copy()
        on = ami.face_mask > 0
        dcs_all[nif:][on] = ami.dc_eff[on]
        nodcs_all[nif:][on] = ami.dc_eff[on]
    arrays = dict(
        sf=mesh.sf, mag_sf=mesh.mag_sf, cf=mesh.cf, c=mesh.c, v=mesh.v,
        weights=mesh.weights, delta_coeffs=dcs_all,
        non_orth_delta_coeffs=nodcs_all,
        correction_vecs=mesh.correction_vecs, face_active=face_active,
        owner=mesh.owner, neighbour=mesh.neighbour,
        cface=tabs["cface"], csign=tabs["csign"], cnbr=tabs["cnbr"],
        cnbr_valid=tabs["cnbr_valid"], cbnd=tabs["cbnd"],
        cface_i=tabs["cface_i"], st_cface=tabs["st_cface"],
        st_sign=tabs["st_sign"], st_valid=tabs["st_valid"],
        fb_cells=tabs["fb_cells"], fb_faces=tabs["fb_faces"],
        fb_signs=tabs["fb_signs"], fb_nbrs=tabs["fb_nbrs"],
        st_wself=st_wself, st_magsf=st_magsf, st_dc=st_dc,
        st_nodc=st_nodc, st_sf=st_sf, st_corr=st_corr_t,
        fb_wself=fb_wself, fb_magsf=fb_magsf, fb_dc=fb_dc, fb_nodc=fb_nodc,
        fb_sf=fb_sf, fb_corr=fb_corr, ex_own_lin=ex_own_lin,
        ex_fb_faces=ex_fb_faces, ex_fb_idx=ex_fb_idx, wall_mask=wall_mask,
        wall_y=wall_y, wall_cnt=np.maximum(wall_cnt, 1.0), ab_rel=ab_rel,
        ab_owner=ab_owner, ab_sf=ab_sf, **ami_tabs,
    )
    # round through the scalar dtype on the host, exactly as the
    # reference's farr() does before its device_put
    arrays = {k: (np.asarray(v, dtype=sdt) if np.asarray(v).dtype.kind == "f"
                  else np.asarray(v, dtype=label_np))
              for k, v in arrays.items()}
    static = dict(
        st_deltas=tabs["st_deltas"],
        n_cells=mesh.n_cells,
        n_faces=mesh.n_faces,
        n_internal_faces=mesh.n_internal_faces,
        max_faces=int(tabs["max_faces"]),
        patches=tuple(mesh.patches),
        orthogonal=orthogonal,
        has_ami=ami is not None,
    )
    zones = {
        name: np.bincount(np.asarray(ids, dtype=np.int64),
                          minlength=mesh.n_cells).astype(float).clip(0, 1)
        .astype(sdt)
        for name, ids in (mesh.cell_zones or {}).items()}
    return from_arrays(arrays, static, zones, device)
