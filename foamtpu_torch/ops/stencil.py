"""Offset-stencil SpMV operator (port of openfoam-2.2.x_tpu/ops/stencil.py).

    Apsi[c] = diag[c]*psi[c] + sum_m off[c,m] * psi[c + d_m]  (+ fallback)

Both `apply_off` and `matvec` go through ops/spmv.py for every operand:
the hand-written CUDA kernel on CUDA tensors (any size, no threshold),
the plain roll chain on CPU tensors. The small COO fallback is added
after the kernel with index_add, as the reference does after its Pallas
call.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from . import spmv


@dataclasses.dataclass(frozen=True)
class StencilOp:
    deltas: Tuple[int, ...]
    off: Any          # [nC, M] off-diagonal coeffs in offset-slot order
    fb_cells: Any     # COO fallback
    fb_nbrs: Any
    fb_coeffs: Any

    def _add_fallback(self, acc: Any, psi: Any) -> Any:
        if self.fb_cells.shape[0]:
            pn = psi[self.fb_nbrs]
            contrib = (self.fb_coeffs[:, None] * pn if psi.ndim == 2
                       else self.fb_coeffs * pn)
            acc = acc.index_add(0, self.fb_cells, contrib)
        return acc

    def apply_off(self, psi: Any) -> Any:
        """offdiag @ psi (no diagonal); psi [nC] or [nC, C]."""
        return self._add_fallback(spmv.spmv(None, psi, self.off, self.deltas),
                                  psi)

    def matvec(self, diag: Any, psi: Any) -> Any:
        """diag*psi + offdiag@psi in one kernel launch (reference hot
        path: lduMatrix::Amul)."""
        return self._add_fallback(spmv.spmv(diag, psi, self.off, self.deltas),
                                  psi)


def from_tables(deltas, st_cface, st_sign, st_valid,
                fb_cells, fb_faces, fb_signs, fb_nbrs,
                upper: Any, lower: Any) -> StencilOp:
    """Materialise per-offset coefficients from LDU upper/lower. Rows
    where the cell owns the face use `upper`, else `lower`."""
    up = upper[st_cface]
    lo = lower[st_cface]
    off = torch.where(st_sign > 0, up, lo) * st_valid
    if fb_cells.shape[0]:
        fb_coeffs = torch.where(fb_signs > 0, upper[fb_faces],
                                lower[fb_faces])
    else:
        fb_coeffs = off.new_zeros((0,))
    return StencilOp(tuple(deltas), off, fb_cells, fb_nbrs, fb_coeffs)


def mesh_stencil(mesh, upper: Any, lower: Any) -> StencilOp:
    return from_tables(
        mesh.st_deltas, mesh.st_cface, mesh.st_sign, mesh.st_valid,
        mesh.fb_cells, mesh.fb_faces, mesh.fb_signs, mesh.fb_nbrs,
        upper, lower,
    )


def make_amul(st: StencilOp, diag_eff: Any) -> Callable:
    def amul(psi: Any) -> Any:
        return st.matvec(diag_eff, psi)

    return amul
