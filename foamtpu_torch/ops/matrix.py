"""FvMatrix: the LDU-addressed implicit FV system (port of
openfoam-2.2.x_tpu/ops/matrix.py) as a plain dataclass of tensors.

Row convention (the reference's Amul):
    diag_eff[c]*psi[c] + sum_f off(f)*psi[nbr(f)] = source_eff[c]
with off(f) = upper[f] when c owns f, lower[f] otherwise;
    diag_eff = diag + sum_bfaces ic,   source_eff = source + sum_bfaces bc.
Vector equations are segregated: diag/upper/lower are scalar, source
and boundary coefficients carry one column per component. soff [nC,M] /
sfb [nfb] are the slot-form off-diagonals (ops/slot.py).

The reference's cyclicAMI coupling (ami_coef) and deferred non-orthogonal
flux correction (fcorr) are outside the ported slice: no ported operator
produces them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..core.dimensions import DimensionSet, dimless
from . import surface


def _addn(a, b):
    """None-aware add of optional flat coefficient arrays."""
    if a is None:
        return b
    if b is None:
        return a
    return a + b


@dataclasses.dataclass(frozen=True)
class FvMatrix:
    diag: Any       # [nC]
    lower: Any      # [nIf] or None (slot-only matrix)
    upper: Any      # [nIf] or None
    source: Any     # [nC] or [nC,C]
    ic: Any         # internalCoeffs  [nBf] or [nBf,C] (adds to diag)
    bc: Any         # boundaryCoeffs  [nBf] or [nBf,C] (adds to source)
    soff: Any = None
    sfb: Any = None
    dims: DimensionSet = dimless   # of source (= op * volume)
    symmetric: bool = True

    def replace_fields(self, **kw) -> "FvMatrix":
        return dataclasses.replace(self, **kw)

    # ---- algebra -----------------------------------------------------------
    def __add__(self, other: "FvMatrix") -> "FvMatrix":
        if not isinstance(other, FvMatrix):
            return NotImplemented
        d = self.dims + other.dims  # raises on mismatch
        if self.soff is None or other.soff is None:
            so, sf = None, None
        else:
            so = self.soff + other.soff
            sf = self.sfb + other.sfb
        return FvMatrix(
            diag=self.diag + other.diag,
            lower=_addn(self.lower, other.lower),
            upper=_addn(self.upper, other.upper),
            source=self.source + other.source,
            ic=self.ic + other.ic,
            bc=self.bc + other.bc,
            soff=so,
            sfb=sf,
            dims=d,
            symmetric=self.symmetric and other.symmetric,
        )

    def __neg__(self) -> "FvMatrix":
        return FvMatrix(
            diag=-self.diag,
            lower=None if self.lower is None else -self.lower,
            upper=None if self.upper is None else -self.upper,
            source=-self.source, ic=-self.ic, bc=-self.bc,
            soff=None if self.soff is None else -self.soff,
            sfb=None if self.sfb is None else -self.sfb,
            dims=self.dims, symmetric=self.symmetric,
        )

    def __sub__(self, other: "FvMatrix") -> "FvMatrix":
        if not isinstance(other, FvMatrix):
            return NotImplemented
        return self + (-other)

    def add_source(self, vol_source: Any, mesh=None) -> "FvMatrix":
        """RHS += V * field (the `fvm == fvc_field` operator)."""
        v = mesh.v
        if vol_source.ndim == 2:
            v = v[:, None]
        return dataclasses.replace(self, source=self.source + v * vol_source)

    # ---- effective system ---------------------------------------------------
    def diag_eff(self, mesh, cmpt: Optional[int] = None) -> Any:
        ic = self.ic
        if ic.ndim == 2:
            ic = ic[:, cmpt] if cmpt is not None else ic
        if ic.ndim == 2:
            return self.diag[:, None] + surface.boundary_sum(mesh, ic)
        return self.diag + surface.boundary_sum(mesh, ic)

    def source_eff(self, mesh, cmpt: Optional[int] = None) -> Any:
        bc = self.bc
        src = self.source
        if bc.ndim == 2 and cmpt is not None:
            bc = bc[:, cmpt]
            src = src[:, cmpt]
        return src + surface.boundary_sum(mesh, bc)

    def off_coeffs(self, mesh) -> Any:
        """Per-cell off-diagonal coefficients [nC,K] (gather form)."""
        if self.upper is None:
            raise ValueError("flat LDU coefficients were not materialised "
                             "(slot-only matrix); use the soff/off_mul path")
        up = self.upper[mesh.cface_i]
        lo = self.lower[mesh.cface_i]
        return torch.where(mesh.csign > 0, up, lo) * mesh.cnbr_valid

    def amul(self, mesh, psi: Any, diag_eff: Optional[Any] = None) -> Any:
        """A @ psi for a scalar psi [nC]."""
        if diag_eff is None:
            diag_eff = self.diag_eff(mesh)
        return diag_eff * psi + self.off_mul(mesh, psi)

    def row_sum(self, mesh, diag_eff: Optional[Any] = None) -> Any:
        """sumA: diag + sum of off-diagonals per row (lduMatrix::sumA)."""
        if diag_eff is None:
            diag_eff = self.diag_eff(mesh)
        if self.soff is not None:
            off_row = torch.sum(self.soff, dim=1)
            if mesh.fb_cells.shape[0]:
                off_row = off_row.index_add(0, mesh.fb_cells, self.sfb)
            if off_row.ndim == 1 and diag_eff.ndim == 2:
                off_row = off_row[:, None]
            return diag_eff + off_row
        return diag_eff + torch.sum(self.off_coeffs(mesh), dim=1)

    # ---- PISO/SIMPLE operator splits ----------------------------------------
    def A(self, mesh) -> Any:
        """Central coefficient / volume as a scalar field (vector matrices
        average their boundary coefficients over components)."""
        ic = self.ic if self.ic.ndim == 1 else torch.mean(self.ic, dim=1)
        d = self.diag + surface.boundary_sum(mesh, ic)
        return d / mesh.v

    def off_mul(self, mesh, psi: Any) -> Any:
        """Off-diagonal product sum_f off(f)*psi[nbr(f)]: the stencil
        kernel when soff is present, the gather path otherwise."""
        if self.soff is not None:
            from . import slot as slot_mod

            return slot_mod.off_apply(mesh, self.soff, self.sfb, psi)
        off = self.off_coeffs(mesh)
        if psi.ndim == 2:
            return torch.sum(off[:, :, None] * psi[mesh.cnbr], dim=1)
        return torch.sum(off * psi[mesh.cnbr], dim=1)

    def H(self, mesh, psi: Any) -> Any:
        """(source_eff - offdiag*psi + (Dav - Dc)*psi) / V
        (reference: fvMatrix::H)."""
        offpsi = self.off_mul(mesh, psi)
        if psi.ndim == 2:
            d_c = surface.boundary_sum(mesh, self.ic)        # [nC,C]
            d_av = torch.mean(d_c, dim=1, keepdim=True)
            corr = (d_av - d_c) * psi
            return (self.source_eff(mesh) - offpsi + corr) / mesh.v[:, None]
        return (self.source_eff(mesh) - offpsi) / mesh.v

    def flux(self, mesh, psi: Any) -> Any:
        """Consistent face flux of the implicit operator (fvMatrix::flux):
        internal upper*psi_nei - lower*psi_own; boundary ic*psi_c - bc."""
        nif = mesh.n_internal_faces
        f_int = (self.upper * psi[mesh.neighbour]
                 - self.lower * psi[mesh.owner[:nif]])
        f_bnd = self.ic * surface.owner_to_b(mesh, psi) - self.bc
        return torch.cat([f_int, f_bnd], dim=0)

    # ---- constraints ---------------------------------------------------------
    def set_reference(self, cell: int, value: float) -> "FvMatrix":
        """Pin the solution level in one cell (fvMatrix::setReference)."""
        d = self.diag[cell]
        source = self.source.clone()
        source[cell] += d * value
        diag = self.diag.clone()
        diag[cell] += d
        return dataclasses.replace(self, source=source, diag=diag)


def zero_matrix(mesh, n_cmpts: int = 1, dims: DimensionSet = dimless
                ) -> FvMatrix:
    dt, dev = mesh.v.dtype, mesh.device
    shape_c = (mesh.n_cells,) if n_cmpts == 1 else (mesh.n_cells, n_cmpts)
    shape_b = ((mesh.n_boundary_faces,) if n_cmpts == 1
               else (mesh.n_boundary_faces, n_cmpts))

    def z(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    return FvMatrix(
        diag=z(mesh.n_cells),
        lower=z(mesh.n_internal_faces),
        upper=z(mesh.n_internal_faces),
        source=z(*shape_c),
        ic=z(*shape_b),
        bc=z(*shape_b),
        soff=z(mesh.n_cells, len(mesh.st_deltas)),
        sfb=z(mesh.fb_cells.shape[0]),
        dims=dims,
    )
