"""GAMG: geometric-algebraic multigrid (port of
openfoam-2.2.x_tpu/solvers/linear/gamg.py).

Host half: a copy of the reference's numpy hierarchy construction
(`_dominant_delta`, `_pairwise_match`, `_pad_groups`,
`_cell_tables_internal`, `_build_plane_tables`, `build_hierarchy`,
`hierarchy_for_mesh`); the reference module imports jax at its top, so
the port cannot import it. `jax.device_put` becomes one tensor
conversion onto the mesh's device, and `Level` is a plain dataclass of
tensors.

Device half: the Galerkin coarsening (plane path and gather path),
restrict/prolong as reshapes, the coarsest-level dense inverse
(`torch.linalg.inv`, then a matrix-vector product), the V-cycle (plain
and strided) and the flexible Polak-Ribiere PCG with null-space
deflation. Every smoothing, residual and scale SpMV goes through the
offset-stencil kernel (ops/stencil.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...core.precision import label_np, scalar_np
from ...mesh.core import offset_stencil
from ...ops import stencil as stencil_mod
from .krylov import SolverPerf, _small


def _np(t) -> np.ndarray:
    """Host numpy copy of a tensor (or array)."""
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _dominant_delta(owner, neighbour, n_cells) -> int:
    d = neighbour - owner
    vals, counts = np.unique(d, return_counts=True)
    # prefer the smallest dominant offset on ties (merge along the
    # fastest-varying axis first)
    best = vals[np.lexsort((vals, -counts))][0]
    return int(max(best, 1))


def _pairwise_match(owner, neighbour, w, n_cells, rounds=6):
    """Greedy mutual-max face-weight matching (the reference's
    pairGAMGAgglomeration / faceAreaPairGAMGAgglomeration merge,
    src/OpenFOAM/matrices/lduMatrix/solvers/GAMG/GAMGAgglomeration),
    vectorised: each round every unmatched cell nominates its
    max-weight unmatched neighbour; mutual nominations become pairs.
    Leftovers after `rounds` stay singletons (reference keeps
    singletons too). Returns partner[c] (-1 = singleton)."""
    partner = np.full(n_cells, -1, dtype=np.int64)
    # break weight ties with a deterministic per-face jitter: both
    # endpoints of a face see the SAME jittered weight, so each cell's
    # argmax face is unique and mutual nominations actually coincide
    # (uniform weights otherwise yield an O(1/degree) match rate)
    jit = np.random.default_rng(0).random(owner.shape[0])
    w = np.asarray(w, dtype=np.float64)
    wmax = w.max() if w.size else 1.0
    w = w + (1e-6 * max(wmax, 1e-300)) * jit
    for _ in range(rounds):
        live = (partner[owner] < 0) & (partner[neighbour] < 0)
        if not live.any():
            break
        o, n, ww = owner[live], neighbour[live], w[live]
        best_w = np.zeros(n_cells, dtype=ww.dtype)
        np.maximum.at(best_w, o, ww)
        np.maximum.at(best_w, n, ww)
        best_n = np.full(n_cells, -1, dtype=np.int64)
        hit_o = ww >= best_w[o]
        best_n[o[hit_o]] = n[hit_o]
        hit_n = ww >= best_w[n]
        best_n[n[hit_n]] = o[hit_n]
        cand = np.nonzero(best_n >= 0)[0]
        mutual = best_n[best_n[cand]] == cand
        a = cand[mutual]
        b = best_n[a]
        keep = a < b
        a, b = a[keep], b[keep]
        partner[a] = b
        partner[b] = a
    return partner


@dataclasses.dataclass(frozen=True)
class Level:
    """Tables for one coarsening step fine->coarse (field meanings as in
    the reference's Level)."""

    face_src: Any        # [nFc, Mf]
    face_src_mask: Any
    face_src_flip: Any
    intra_faces: Any     # [nCc, Mi]
    intra_mask: Any
    members_pad: Any     # [nCc, 2]
    st: Dict[str, Any]   # coarse-level stencil tables
    cluster_of_fine: Any = None
    rule_masks: Tuple = ()
    irr_plane_c: Any = None
    irr_plane_m: Any = None
    irr_fb_idx: Any = None
    tg_diag_sel: Any = None
    tg_diag_cell: Any = None
    tg_plane_sel: Any = None
    tg_plane_flat: Any = None
    tg_fb_sel: Any = None
    pfb_cells: Any = None
    pfb_nbrs: Any = None
    n_fine: int = 0
    n_fine_pad: int = 0
    n_coarse: int = 0
    d: int = 1
    st_deltas: Tuple[int, ...] = ()
    plane_rules: Tuple = ()
    plane_deltas: Tuple[int, ...] = ()
    plane_ok: bool = False


LEVEL_META = ("n_fine", "n_fine_pad", "n_coarse", "d", "st_deltas",
              "plane_rules", "plane_deltas", "plane_ok")


def _to_tensors(obj, device):
    """numpy arrays (nested in dicts/tuples) -> tensors on `device`;
    None and python scalars pass through."""
    if isinstance(obj, dict):
        return {k: _to_tensors(v, device) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_tensors(v, device) for v in obj)
    if isinstance(obj, np.ndarray):
        return torch.as_tensor(obj).to(device)
    return obj


def _pad_groups(group_of, n_groups, payload):
    n = group_of.shape[0]
    order = np.argsort(group_of, kind="stable")
    sorted_g = group_of[order]
    counts = np.bincount(sorted_g, minlength=n_groups)
    M = max(int(counts.max()) if n else 1, 1)
    starts = np.zeros(n_groups, dtype=np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    rank = np.arange(n) - starts[sorted_g]
    table = np.zeros((n_groups, M), dtype=np.int64)
    mask = np.zeros((n_groups, M))
    table[sorted_g, rank] = payload[order]
    mask[sorted_g, rank] = 1.0
    return table, mask


def _cell_tables_internal(owner, neighbour, n_cells):
    nIf = owner.shape[0]
    counts = np.bincount(owner, minlength=n_cells) + np.bincount(
        neighbour, minlength=n_cells
    )
    K = max(int(counts.max()) if nIf else 1, 1)
    cface = np.zeros((n_cells, K), dtype=np.int64)
    csign = np.zeros((n_cells, K))
    cnbr = np.zeros((n_cells, K), dtype=np.int64)
    valid = np.zeros((n_cells, K))

    def slots(cells, offset):
        order = np.argsort(cells, kind="stable")
        cnts = np.bincount(cells, minlength=n_cells)
        starts = np.zeros(n_cells, dtype=np.int64)
        starts[1:] = np.cumsum(cnts)[:-1]
        rank = np.empty_like(order)
        rank[order] = np.arange(cells.shape[0]) - starts[cells[order]]
        return rank + offset[cells]

    own_counts = np.bincount(owner, minlength=n_cells)
    faces = np.arange(nIf)
    k_o = slots(owner, np.zeros(n_cells, dtype=np.int64))
    cface[owner, k_o] = faces
    csign[owner, k_o] = 1.0
    cnbr[owner, k_o] = neighbour
    valid[owner, k_o] = 1.0
    k_n = slots(neighbour, own_counts)
    cface[neighbour, k_n] = faces
    csign[neighbour, k_n] = -1.0
    cnbr[neighbour, k_n] = owner
    valid[neighbour, k_n] = 1.0
    return offset_stencil(cface, csign, cnbr, valid, n_cells)


def _build_plane_tables(deltas, valid, fb_c, fb_n, nC, d, nC_pad):
    """Host precompute for the gather-free plane Galerkin coarsening of
    one structured level (pairing c with c+d by even-block parity).

    Inputs describe the FINE level's slot coefficient layout: `deltas`
    (tuple of slot offsets), `valid` bool [nC, M] (slot entry exists),
    and the COO fallback pairs (fb_c, fb_n). Every directed matrix
    entry A[c, c+d_m] maps under J(c) = (c//2d)*d + c%d to a coarse
    pair (J(c), J(c+d_m)); when the coarse offset is CONSTANT over a
    (slot m, parity s) class the transfer is a pure reshape+add
    ("rule"), otherwise the entry joins the irregular remainder
    (small gather/scatter). Returns (meta, tables, coarse_spec).

    Reference analogue: GAMGAgglomeration::agglomerateLduAddressing
    (src/OpenFOAM/matrices/lduMatrix/solvers/GAMG/GAMGAgglomeration) —
    rebuilt as offset arithmetic so the per-solve Galerkin products
    need no face gather tables."""
    block = 2 * d
    nCc = nC_pad // 2
    cells = np.arange(nC, dtype=np.int64)

    def J(c):
        return (c // block) * d + (c % d)

    s_of = (cells // d) % 2
    rules = []            # (m, s, D)
    masks = []            # None | np [nCc]
    irr_c, irr_m = [], []           # irregular plane-sourced entries
    irr_Jc, irr_Jn = [], []
    cvalid: Dict[int, np.ndarray] = {}

    def mark(Dv, Jc_arr):
        a = cvalid.setdefault(int(Dv), np.zeros(nCc, dtype=bool))
        a[Jc_arr] = True

    for m, dm in enumerate(deltas):
        for s in (0, 1):
            sel = (np.asarray(valid[:, m]) > 0) & (s_of == s)
            idx = cells[sel]
            if idx.size == 0:
                continue
            Jc = J(idx)
            Jn = J(idx + dm)
            Dv = Jn - Jc
            uu, cc = np.unique(Dv, return_counts=True)
            Ddom = int(uu[np.argmax(cc)])
            dev = Dv != Ddom
            if dev.any():
                mask = np.ones(nCc)
                mask[Jc[dev]] = 0.0
                irr_c.append(idx[dev])
                irr_m.append(np.full(int(dev.sum()), m, dtype=np.int64))
                irr_Jc.append(Jc[dev])
                irr_Jn.append(Jn[dev])
                masks.append(mask)
            else:
                masks.append(None)
            rules.append((m, s, Ddom))
            if Ddom != 0:
                mark(Ddom, Jc[~dev] if dev.any() else Jc)

    irr_c = np.concatenate(irr_c) if irr_c else np.zeros(0, np.int64)
    irr_m = np.concatenate(irr_m) if irr_m else np.zeros(0, np.int64)
    irr_Jc = np.concatenate(irr_Jc) if irr_Jc else np.zeros(0, np.int64)
    irr_Jn = np.concatenate(irr_Jn) if irr_Jn else np.zeros(0, np.int64)

    fb_c = np.asarray(fb_c, np.int64)
    fb_n = np.asarray(fb_n, np.int64)
    fb_Jc = J(fb_c) if fb_c.size else np.zeros(0, np.int64)
    fb_Jn = J(fb_n) if fb_n.size else np.zeros(0, np.int64)

    # concatenated runtime source order: [plane-sourced | fb-sourced]
    all_Jc = np.concatenate([irr_Jc, fb_Jc])
    all_Jn = np.concatenate([irr_Jn, fb_Jn])
    all_D = all_Jn - all_Jc

    # plane-target irregulars must land on a coarse slot: include their
    # offsets in the coarse delta set before resolving slot indices
    to_diag = all_D == 0
    for Dv in np.unique(all_D[~to_diag]):
        # only offsets that at least one rule produced stay planes;
        # one-off offsets go to the coarse COO fallback instead of
        # widening every coarse plane
        if int(Dv) not in cvalid:
            continue
        sel = all_D == Dv
        cvalid[int(Dv)][all_Jc[sel]] = True

    coarse_deltas = tuple(sorted(cvalid.keys()))
    slot_of = {D: i for i, D in enumerate(coarse_deltas)}
    Mc = max(len(coarse_deltas), 1)

    to_plane = (~to_diag) & np.isin(all_D, list(slot_of.keys()))
    to_fb = (~to_diag) & ~to_plane
    sel_idx = np.arange(all_D.shape[0], dtype=np.int64)
    tg_diag_sel = sel_idx[to_diag]
    tg_diag_cell = all_Jc[to_diag]
    tg_plane_sel = sel_idx[to_plane]
    tg_plane_flat = all_Jc[to_plane] * Mc + np.asarray(
        [slot_of[int(Dv)] for Dv in all_D[to_plane]], np.int64)
    tg_fb_sel = sel_idx[to_fb]
    pfb_cells = all_Jc[to_fb]
    pfb_nbrs = all_Jn[to_fb]

    rules = tuple((m, s, (-1 if D == 0 else slot_of[D]))
                  for (m, s, D) in rules)
    coarse_valid = (np.stack([cvalid[D] for D in coarse_deltas], axis=1)
                    if coarse_deltas else np.zeros((nCc, 1), dtype=bool))
    meta = dict(plane_rules=rules, plane_deltas=coarse_deltas,
                plane_ok=True)
    tables = dict(
        rule_masks=tuple(masks),
        irr_plane_c=irr_c, irr_plane_m=irr_m,
        irr_fb_idx=np.arange(fb_c.shape[0], dtype=np.int64),
        tg_diag_sel=tg_diag_sel, tg_diag_cell=tg_diag_cell,
        tg_plane_sel=tg_plane_sel, tg_plane_flat=tg_plane_flat,
        tg_fb_sel=tg_fb_sel, pfb_cells=pfb_cells, pfb_nbrs=pfb_nbrs,
    )
    coarse_spec = dict(deltas=coarse_deltas, valid=coarse_valid,
                       fb_c=pfb_cells, fb_n=pfb_nbrs)
    return meta, tables, coarse_spec


def build_hierarchy(
    owner: np.ndarray,
    neighbour: np.ndarray,
    n_cells: int,
    n_coarsest: int = 1024,
    # 1024 (not the reference's ~10s): each extra level costs a fixed
    # ~10 small-kernel dispatches per cycle (latency-bound on TPU), and
    # the dense-inverse coarsest solve is MXU-cheap up to ~1k cells.
    # Measured on the 400^2 cavity: 13 levels/10 CG iters -> 8 levels/
    # 5 iters, 90 -> 80 ms/step.
    max_levels: int = 24,
    face_weights: Optional[np.ndarray] = None,
    pairwise: str = "auto",
    level0_spec: Optional[Dict[str, Any]] = None,
    device="cpu",
) -> List[Level]:
    """pairwise: 'auto' = per level, use index-offset pairing when it
    pairs >=50% of cells across a shared face (structured/renumbered
    meshes: restrict/prolong become reshapes), else greedy face-weight
    matching (reference faceAreaPairGAMGAgglomeration) with
    segment-sum transfers; '1'/'0' force one mode."""
    import os as _os

    owner = np.asarray(owner, dtype=np.int64)
    neighbour = np.asarray(neighbour, dtype=np.int64)
    pairwise = _os.environ.get("FOAMTPU_GAMG_PAIRWISE", pairwise)
    w = (np.ones(owner.shape[0]) if face_weights is None
         else np.asarray(face_weights, dtype=np.float64))
    levels: List[Level] = []
    nC = n_cells
    sdt = scalar_np()
    # slot-form spec of the CURRENT level's coefficient layout, for the
    # gather-free plane coarsening (level 0: the mesh's tables; coarser:
    # derived). None once a pairwise level breaks the offset arithmetic.
    spec = level0_spec

    for _ in range(max_levels):
        if nC <= n_coarsest or owner.shape[0] == 0:
            break
        d = _dominant_delta(owner, neighbour, nC)
        block = 2 * d
        nC_pad = ((nC + block - 1) // block) * block

        # full map: J(c) = (c // (2d))*d + (c % d) for both halves
        def J(c):
            return (c // block) * d + (c % d)

        use_pairwise = pairwise == "1"
        if pairwise == "auto":
            # fraction of 2-member structured clusters whose members
            # share a face (the quality the reshape pairing relies on)
            co_s = J(owner)
            cn_s = J(neighbour)
            nCc_s = nC_pad // 2
            have = np.zeros(nCc_s, dtype=bool)
            have[co_s[co_s == cn_s]] = True
            jidx_s = np.arange(nCc_s)
            base_s = (jidx_s // d) * block + (jidx_s % d)
            two = (base_s + d) < nC
            frac = (have & two).sum() / max(two.sum(), 1)
            use_pairwise = frac < 0.5

        if use_pairwise:
            partner = _pairwise_match(owner, neighbour, w, nC)
            cells = np.arange(nC)
            rep = np.where(partner < 0, cells, np.minimum(cells, partner))
            is_rep = rep == cells
            cluster_ids = np.cumsum(is_rep) - 1
            cluster_of = cluster_ids[rep]
            nCc = int(cluster_ids[-1]) + 1
            co = cluster_of[owner]
            cn = cluster_of[neighbour]
            reps_idx = np.nonzero(is_rep)[0]
            mem2 = np.where(partner[reps_idx] >= 0, partner[reps_idx], nC)
            members = np.stack([reps_idx, mem2], axis=1)
            cof = cluster_of
            nC_pad = nC
        else:
            co = J(owner)
            cn = J(neighbour)
            nCc = nC_pad // 2
            jidx = np.arange(nCc)
            base = (jidx // d) * block + (jidx % d)
            members = np.stack([base, base + d], axis=1)
            cof = None

        flip = co > cn
        lo = np.where(flip, cn, co)
        hi = np.where(flip, co, cn)
        intra = lo == hi
        inter_idx = np.nonzero(~intra)[0]
        intra_idx = np.nonzero(intra)[0]

        pairs = np.stack([lo[inter_idx], hi[inter_idx]], axis=1)
        uniq, face_of = np.unique(pairs, axis=0, return_inverse=True)
        forder = np.lexsort((uniq[:, 1], uniq[:, 0]))
        remap = np.empty(forder.shape[0], dtype=np.int64)
        remap[forder] = np.arange(forder.shape[0])
        face_of = remap[face_of]
        c_own = uniq[forder, 0]
        c_nei = uniq[forder, 1]
        nFc = c_own.shape[0]

        face_src, face_mask = _pad_groups(face_of, nFc, inter_idx)
        flip_src, _ = _pad_groups(face_of, nFc, flip[inter_idx].astype(np.int64))
        if intra_idx.shape[0]:
            intra_tab, intra_mask = _pad_groups(lo[intra_idx], nCc, intra_idx)
        else:
            intra_tab = np.zeros((nCc, 1), dtype=np.int64)
            intra_mask = np.zeros((nCc, 1))

        st = _cell_tables_internal(c_own, c_nei, nCc)
        # coarsen the face weights for the next level's matching
        w = np.bincount(face_of, weights=w[inter_idx], minlength=nFc)

        plane_meta: Dict[str, Any] = dict(plane_rules=(), plane_deltas=(),
                                          plane_ok=False)
        plane_tables: Dict[str, Any] = {}
        if use_pairwise:
            spec = None     # offset arithmetic broken from here down
        elif spec is not None:
            plane_meta, plane_tables, spec = _build_plane_tables(
                spec["deltas"], spec["valid"], spec["fb_c"], spec["fb_n"],
                nC, d, nC_pad)

        # stage in NumPy; converted to tensors once at the end
        st_deltas = st.pop("st_deltas")
        st_np = {}
        for k, v in st.items():
            if isinstance(v, np.ndarray) and v.dtype.kind == "f":
                st_np[k] = v.astype(sdt)
            else:
                st_np[k] = np.asarray(v, label_np)
        pt = {}
        for k2, v2 in plane_tables.items():
            if k2 == "rule_masks":
                pt[k2] = tuple(None if mm is None else mm.astype(sdt)
                               for mm in v2)
            else:
                pt[k2] = np.asarray(v2, label_np)
        levels.append(dict(
            n_fine=nC,
            n_fine_pad=nC_pad,
            n_coarse=nCc,
            d=1 if use_pairwise else d,
            st_deltas=tuple(st_deltas),
            cluster_of_fine=(cof.astype(label_np) if use_pairwise
                             else None),
            face_src=face_src.astype(label_np),
            face_src_mask=face_mask.astype(sdt),
            face_src_flip=flip_src.astype(sdt),
            intra_faces=intra_tab.astype(label_np),
            intra_mask=intra_mask.astype(sdt),
            members_pad=members.astype(label_np),
            st=st_np,
            **plane_meta,
            **pt,
        ))
        owner, neighbour, nC = c_own, c_nei, nCc

    meta_keys = ("n_fine", "n_fine_pad", "n_coarse", "d", "st_deltas",
                 "plane_rules", "plane_deltas", "plane_ok")
    arrays = [{k: v for k, v in lv.items() if k not in meta_keys}
              for lv in levels]
    arrays = [_to_tensors(a, device) for a in arrays]
    return [
        Level(**{k: lv[k] for k in meta_keys}, **arr)
        for lv, arr in zip(levels, arrays)
    ]


def hierarchy_for_mesh(mesh, n_coarsest: int = 1024) -> List[Level]:
    import os

    n_coarsest = int(os.environ.get("FOAMTPU_GAMG_NC", n_coarsest))
    nif = mesh.n_internal_faces
    # level-0 slot layout for the gather-free plane coarsening: the
    # mesh's own offset-canonical tables (matches FvMatrix.soff)
    spec = dict(deltas=tuple(mesh.st_deltas),
                valid=_np(mesh.st_valid) > 0,
                fb_c=_np(mesh.fb_cells),
                fb_n=_np(mesh.fb_nbrs))
    return build_hierarchy(
        _np(mesh.owner)[:nif], _np(mesh.neighbour),
        mesh.n_cells, n_coarsest=n_coarsest,
        face_weights=_np(mesh.mag_sf)[:nif], level0_spec=spec,
        device=mesh.device,
    )



# ---------------------------------------------------------------------------
# Device-side solve
# ---------------------------------------------------------------------------


def _pad_to(x, n):
    if x.shape[0] == n:
        return x
    return torch.cat([x, x.new_zeros((n - x.shape[0],) + tuple(x.shape[1:]))])


def _restrict(lv: Level, r):
    if lv.cluster_of_fine is not None:
        return r.new_zeros(lv.n_coarse).index_add(0, lv.cluster_of_fine, r)
    rp = _pad_to(r, lv.n_fine_pad)
    return rp.reshape(-1, 2, lv.d).sum(dim=1).reshape(-1)


def _prolong(lv: Level, xc):
    if lv.cluster_of_fine is not None:
        return xc[lv.cluster_of_fine]
    xf = torch.broadcast_to(xc.reshape(-1, 1, lv.d),
                            (xc.shape[0] // lv.d, 2, lv.d)).reshape(-1)
    return xf[: lv.n_fine]


def _sign_fix(cdiag):
    """Disconnected all-pad clusters: sign-matched unit diagonal."""
    sgn = torch.where(torch.sum(cdiag) < 0, -1.0, 1.0).to(cdiag.dtype)
    return torch.where(cdiag == 0.0, sgn, cdiag)


def _coarsen_planes(lv: Level, diag, planes, fbc):
    """Plane Galerkin coarsening: fine (diag [nC], planes [nC,M], fbc
    [nfb]) -> coarse (cdiag, cplanes [nCc,Mc], cfbc) by reshape+add for
    the structured rules and a small gather/index_add for the irregular
    remainder."""
    d = lv.d
    nCc, Mc = lv.n_coarse, max(len(lv.plane_deltas), 1)
    k = lv.n_fine_pad // (2 * d)

    P = _pad_to(planes, lv.n_fine_pad)
    V = P.reshape(k, 2, d, P.shape[1])
    cdiag = _pad_to(diag, lv.n_fine_pad).reshape(k, 2, d).sum(dim=1) \
        .reshape(nCc)

    cols = [None] * Mc
    for ri, (m, s, mc) in enumerate(lv.plane_rules):
        contrib = V[:, s, :, m].reshape(nCc)
        msk = lv.rule_masks[ri]
        if msk is not None:
            contrib = contrib * msk
        if mc < 0:
            cdiag = cdiag + contrib
        else:
            cols[mc] = contrib if cols[mc] is None else cols[mc] + contrib
    cols = [c if c is not None else planes.new_zeros(nCc) for c in cols]
    cplanes = torch.stack(cols, dim=1)

    n_irr = lv.irr_plane_c.shape[0] + lv.irr_fb_idx.shape[0]
    if n_irr:
        vals = torch.cat([
            planes[lv.irr_plane_c, lv.irr_plane_m],
            fbc[lv.irr_fb_idx] if lv.irr_fb_idx.shape[0]
            else planes.new_zeros(0),
        ])
        if lv.tg_diag_sel.shape[0]:
            cdiag = cdiag.index_add(0, lv.tg_diag_cell, vals[lv.tg_diag_sel])
        if lv.tg_plane_sel.shape[0]:
            cplanes = cplanes.reshape(-1).index_add(
                0, lv.tg_plane_flat, vals[lv.tg_plane_sel]).reshape(nCc, Mc)
        cfbc = (vals[lv.tg_fb_sel] if lv.tg_fb_sel.shape[0]
                else planes.new_zeros(0))
    else:
        cfbc = planes.new_zeros(0)
    return _sign_fix(cdiag), cplanes, cfbc


def _coarsen_matrix(lv: Level, diag, upper, lower):
    """Gather-path Galerkin coarsening over the face tables."""
    up_g = upper[lv.face_src]
    lo_g = lower[lv.face_src]
    flip = lv.face_src_flip
    m = lv.face_src_mask
    c_upper = torch.sum(torch.where(flip > 0, lo_g, up_g) * m, dim=1)
    c_lower = torch.sum(torch.where(flip > 0, up_g, lo_g) * m, dim=1)
    # pad cells contribute nothing to their cluster's diagonal
    if lv.cluster_of_fine is not None:
        diag_pad = torch.cat([diag, diag.new_zeros(1)])
        d_members = diag_pad[lv.members_pad].sum(dim=1)
    else:
        diag_pad = _pad_to(diag, lv.n_fine_pad)
        d_members = diag_pad.reshape(-1, 2, lv.d).sum(dim=1).reshape(-1)
    d_intra = torch.sum(
        (upper[lv.intra_faces] + lower[lv.intra_faces]) * lv.intra_mask,
        dim=1)
    return _sign_fix(d_members + d_intra), c_upper, c_lower


def _make_st_op(deltas, st: Dict[str, Any], upper, lower
                ) -> stencil_mod.StencilOp:
    return stencil_mod.from_tables(
        deltas, st["st_cface"], st["st_sign"], st["st_valid"],
        st["fb_cells"], st["fb_faces"], st["fb_signs"], st["fb_nbrs"],
        upper, lower,
    )


def _dense_inverse(st_op: stencil_mod.StencilOp, diag):
    """Coarsest-level dense inverse: assemble A by applying the stencil to
    the identity (one multi-column kernel launch), add a tiny ridge for
    singular systems, invert once per solve."""
    n = diag.shape[0]
    eye = torch.eye(n, dtype=diag.dtype, device=diag.device)
    A = diag[:, None] * eye + st_op.apply_off(eye)
    ridge = 1e-6 * torch.max(torch.abs(diag))
    A = A + ridge * torch.sign(torch.mean(diag)) * eye
    return torch.linalg.inv(A)


def _vdot(a, b):
    return torch.sum(a * b)


def _scale_factor(c, r_i, Ac):
    """GAMGSolver::scale: the optimal step along the prolonged
    correction, clipped to [0, 2]."""
    num = _vdot(c, r_i)
    den = _vdot(c, Ac)
    floor = torch.where(den >= 0, torch.full_like(den, 1e-30),
                        torch.full_like(den, -1e-30))
    safe = torch.where(torch.abs(den) > 1e-30, den, floor)
    return torch.clamp(num / safe, 0.0, 2.0)


class _CmptView:
    """Per-component view of a vector FvMatrix for prepare()."""

    def __init__(self, mat, cmpt):
        self._mat = mat
        self._cmpt = cmpt
        self.upper = mat.upper
        self.lower = mat.lower
        self.soff = None

    def diag_eff(self, mesh):
        return self._mat.diag_eff(mesh, self._cmpt)


class GAMG:
    """Multigrid preconditioner/solver bound to one mesh hierarchy, with
    the reference's defaults (damped Jacobi 4+4 sweeps, omega 0.8,
    scale correction on every level, level_stride 2)."""

    def __init__(self, mesh, levels: Optional[List[Level]] = None,
                 n_pre: int = 4, n_post: int = 4, omega: float = 0.8,
                 smoother: str = "Jacobi", scale_mode: str = "all",
                 level_stride: int = 2):
        self.levels = (levels if levels is not None
                       else hierarchy_for_mesh(mesh))
        self.mesh = mesh
        self.n_pre = n_pre
        self.n_post = n_post
        self.omega = omega
        self.smoother = smoother
        self.scale_mode = scale_mode
        self.scale_correction = scale_mode != "off"
        self.level_stride = max(int(level_stride), 1)

    def _ops(self, mesh, mats, fine_op=None):
        """StencilOps per level from the per-level (diag, upper, lower)."""
        ops = []
        for i, (diag, upper, lower) in enumerate(mats):
            if i == 0:
                ops.append(fine_op if fine_op is not None
                           else stencil_mod.mesh_stencil(mesh, upper, lower))
            else:
                lv = self.levels[i - 1]
                ops.append(_make_st_op(lv.st_deltas, lv.st, upper, lower))
        return ops

    def coarsen_all(self, diag_eff, upper, lower):
        mats = [(diag_eff, upper, lower)]
        d, u, l = diag_eff, upper, lower
        for lv in self.levels:
            d, u, l = _coarsen_matrix(lv, d, u, l)
            mats.append((d, u, l))
        return mats

    def prepare(self, mesh, mat):
        """Everything that depends only on the matrix coefficients: the
        Galerkin hierarchy, per-level stencil ops, Chebyshev bounds and
        the coarsest-level dense inverse (shared across correctors)."""
        d_eff = mat.diag_eff(mesh)
        soff = getattr(mat, "soff", None)
        plane_ok = (soff is not None and self.levels
                    and all(lv.plane_ok for lv in self.levels))
        if plane_ok:
            planes, fbc = mat.soff, mat.sfb
            ops = [stencil_mod.StencilOp(tuple(mesh.st_deltas), planes,
                                         mesh.fb_cells, mesh.fb_nbrs, fbc)]
            diags = [d_eff]
            for lv in self.levels:
                dg, planes, fbc = _coarsen_planes(lv, diags[-1], planes, fbc)
                ops.append(stencil_mod.StencilOp(
                    lv.plane_deltas, planes, lv.pfb_cells, lv.pfb_nbrs, fbc))
                diags.append(dg)
            mats = [(dg, None, None) for dg in diags]
        else:
            mats = self.coarsen_all(d_eff, mat.upper, mat.lower)
            fine_op = None
            if soff is not None:
                fine_op = stencil_mod.StencilOp(
                    tuple(mesh.st_deltas), mat.soff, mesh.fb_cells,
                    mesh.fb_nbrs, mat.sfb)
            ops = self._ops(mesh, mats, fine_op=fine_op)

        def lam_of(diag, op):
            s = torch.sum(torch.abs(op.off), dim=1)
            if op.fb_cells.shape[0]:
                s = s.index_add(0, op.fb_cells, torch.abs(op.fb_coeffs))
            return torch.max(1.0 + s / torch.abs(diag))

        lam_max = [lam_of(m[0], op) for m, op in zip(mats, ops)]
        Ainv = _dense_inverse(ops[-1], mats[-1][0]) if len(mats) > 1 else None
        fine_op = ops[0]
        row_sum = d_eff + fine_op.off.sum(dim=1)
        if fine_op.fb_cells.shape[0]:
            row_sum = row_sum.index_add(0, fine_op.fb_cells, fine_op.fb_coeffs)
        return dict(mats=mats, ops=ops, lam_max=lam_max, Ainv=Ainv,
                    d_eff=d_eff, row_sum=row_sum)

    def _smooth(self, diag, op, x, b, n, lam, fused):
        """n smoothing sweeps at one level; `fused` uses the kernel's
        diagonal (matvec) as the strided V-cycle does."""
        def amul(x):
            return op.matvec(diag, x) if fused else diag * x + op.apply_off(x)

        if self.smoother == "Chebyshev" and lam is not None:
            # Chebyshev on D^-1 A, spectrum in [lmax/15, 1.05*lmax]
            lmax = 1.05 * lam
            lmin = lmax / 15.0
            theta = 0.5 * (lmax + lmin)
            delta = 0.5 * (lmax - lmin)
            sigma = theta / delta
            rho = 1.0 / sigma
            z = (b - amul(x)) / diag
            p = z / theta
            x = x + p
            for _ in range(max(n - 1, 0)):
                rho_new = 1.0 / (2.0 * sigma - rho)
                z = (b - amul(x)) / diag
                p = (rho_new * rho) * p + (2.0 * rho_new / delta) * z
                x = x + p
                rho = rho_new
            return x
        rd = self.omega / diag
        for _ in range(n):
            x = x + (b - amul(x)) * rd
        return x

    def vcycle(self, mesh, mats, ops, b, x, lam_max=None, Ainv=None):
        levels = self.levels
        n_levels = len(mats)
        if self.level_stride > 1 and n_levels > 2:
            return self._vcycle_strided(mesh, mats, ops, b, x,
                                        lam_max=lam_max, Ainv=Ainv)

        def smooth(i, x, b, n):
            lam = None if lam_max is None else lam_max[i]
            return self._smooth(mats[i][0], ops[i], x, b, n, lam, False)

        def amul_i(i, x):
            return mats[i][0] * x + ops[i].apply_off(x)

        bs = [b]
        xs = [x]
        for i in range(n_levels - 1):
            xi = smooth(i, xs[i], bs[i], self.n_pre)
            xs[i] = xi
            r = bs[i] - amul_i(i, xi)
            bs.append(_restrict(levels[i], r))
            xs.append(x.new_zeros(levels[i].n_coarse))
        if n_levels == 1:
            xs[0] = smooth(0, xs[0], bs[0], 8)
        elif Ainv is not None:
            xs[-1] = Ainv @ bs[-1]
        else:
            xs[-1] = _dense_inverse(ops[-1], mats[-1][0]) @ bs[-1]
        for i in range(n_levels - 2, -1, -1):
            c = _prolong(levels[i], xs[i + 1])
            if self.scale_correction and (self.scale_mode == "all"
                                          or i == 0):
                r_i = bs[i] - amul_i(i, xs[i])
                c = _scale_factor(c, r_i, amul_i(i, c)) * c
            xs[i] = smooth(i, xs[i] + c, bs[i], self.n_post)
        return xs[0]

    def _vcycle_strided(self, mesh, mats, ops, b, x, lam_max=None,
                        Ainv=None):
        """V-cycle visiting every level_stride-th level; restrict/prolong
        compose the intermediate reshape hops. Smoothing, residual and
        scale SpMVs use the kernel with its diagonal (matvec)."""
        levels = self.levels
        n_levels = len(mats)
        s = self.level_stride
        visited = list(range(0, n_levels - 1, s))
        visited.append(n_levels - 1)
        if len(visited) >= 2 and visited[-2] == visited[-1]:
            visited.pop()

        def smooth(i, x, b, n):
            lam = None if lam_max is None else lam_max[i]
            return self._smooth(mats[i][0], ops[i], x, b, n, lam, True)

        def amul_i(i, x):
            return ops[i].matvec(mats[i][0], x)

        def restrict_span(i_from, i_to, r):
            for j in range(i_from, i_to):
                r = _restrict(levels[j], r)
            return r

        def prolong_span(i_from, i_to, xc):
            for j in range(i_to - 1, i_from - 1, -1):
                xc = _prolong(levels[j], xc)
            return xc

        nv = len(visited)
        bs = [b]
        xs = [x]
        for v in range(nv - 1):
            i = visited[v]
            xi = smooth(i, xs[v], bs[v], self.n_pre)
            xs[v] = xi
            r = bs[v] - amul_i(i, xi)
            bs.append(restrict_span(i, visited[v + 1], r))
            xs.append(x.new_zeros(levels[visited[v + 1] - 1].n_coarse))
        if Ainv is not None:
            xs[-1] = Ainv @ bs[-1]
        else:
            xs[-1] = _dense_inverse(ops[-1], mats[-1][0]) @ bs[-1]
        for v in range(nv - 2, -1, -1):
            i = visited[v]
            c = prolong_span(i, visited[v + 1], xs[v + 1])
            if self.scale_correction and (self.scale_mode == "all"
                                          or i == 0):
                r_i = bs[v] - amul_i(i, xs[v])
                c = _scale_factor(c, r_i, amul_i(i, c)) * c
            xs[v] = smooth(i, xs[v] + c, bs[v], self.n_post)
        return xs[0]

    def solve(self, mesh, mat, psi, controls) -> Tuple[Any, SolverPerf]:
        """GAMG-preconditioned flexible (Polak-Ribiere) CG. Singular
        (all-Neumann) systems solve with the constant null space deflated
        and take the pRefCell/pRefValue gauge afterwards."""
        tol = float(controls.get("tolerance", 1e-6))
        rel_tol = float(controls.get("relTol", 0.0))
        max_iter = int(controls.get("maxIter", 200))
        singular = bool(controls.get("_singular", False))
        ref_cell, ref_value = controls.get("_ref", (0, 0.0))
        flexible = bool(controls.get("_flexible", True))

        def solve_one(psi1, b, prep):
            mats, ops = prep["mats"], prep["ops"]
            lam_max, Ainv = prep["lam_max"], prep["Ainv"]
            d_eff, row_sum = prep["d_eff"], prep["row_sum"]
            fine_op = ops[0]

            def amul(x):
                return d_eff * x + fine_op.apply_off(x)

            def prec(r):
                return self.vcycle(mesh, mats, ops, r, torch.zeros_like(r),
                                   lam_max=lam_max, Ainv=Ainv)

            if singular:
                b = b - torch.mean(b)

            Apsi = amul(psi1)
            pA = row_sum * torch.mean(psi1)
            norm = (torch.sum(torch.abs(Apsi - pA))
                    + torch.sum(torch.abs(b - pA)) + _small(psi1.dtype))
            r = b - Apsi
            res0 = torch.sum(torch.abs(r)) / norm
            tiny = torch.tensor(_small(psi1.dtype), dtype=psi1.dtype,
                                device=psi1.device)
            x, r_old, p = psi1, r, torch.zeros_like(psi1)
            wArA_old = psi1.new_zeros(())
            it, res = 0, res0
            while it < max_iter and bool((res > tol) & (res > rel_tol * res0)):
                z = prec(r)
                if singular:
                    z = z - torch.mean(z)
                wArA = _vdot(r, z)
                num = wArA - _vdot(r_old, z) if flexible else wArA
                beta = (torch.zeros_like(wArA) if it == 0 else
                        num / torch.where(wArA_old == 0, tiny, wArA_old))
                p = z + beta * p
                q = amul(p)
                pq = _vdot(p, q)
                alpha = wArA / torch.where(pq == 0, tiny, pq)
                x = x + alpha * p
                r_old, r = r, r - alpha * q
                res = torch.sum(torch.abs(r)) / norm
                wArA_old = wArA
                it += 1
            if singular:
                x = x - x[ref_cell] + ref_value
            return x, SolverPerf(res0, res, it)

        if psi.ndim == 1:
            prep = controls.get("_prep") or self.prepare(mesh, mat)
            return solve_one(psi, mat.source_eff(mesh), prep)
        cols, perf0 = [], None
        for c in range(psi.shape[1]):
            prep = self.prepare(mesh, _CmptView(mat, c))
            col, perf = solve_one(psi[:, c].contiguous(),
                                  mat.source_eff(mesh, c), prep)
            cols.append(col)
            perf0 = perf0 or perf
        return torch.stack(cols, dim=1), perf0


def solve_gamg(mesh, mat, psi, controls) -> Tuple[Any, SolverPerf]:
    g = controls.get("_gamg")
    if g is None:
        raise ValueError(
            "GAMG solver needs a prebuilt hierarchy: pass controls['_gamg'] "
            "= GAMG(mesh) (built once per mesh at case load)")
    return g.solve(mesh, mat, psi, controls)
