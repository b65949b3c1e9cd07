"""FvMatrix: the LDU-addressed implicit FV system (port of
openfoam-2.2.x_tpu/ops/matrix.py) as a plain dataclass of tensors.

Row convention (the reference's Amul):
    diag_eff[c]*psi[c] + sum_f off(f)*psi[nbr(f)] = source_eff[c]
with off(f) = upper[f] when c owns f, lower[f] otherwise;
    diag_eff = diag + sum_bfaces ic,   source_eff = source + sum_bfaces bc.
Vector equations are segregated: diag/upper/lower are scalar, source
and boundary coefficients carry one column per component. soff [nC,M] /
sfb [nfb] are the slot-form off-diagonals (ops/slot.py). fcorr [nF(,C)]
is the explicit non-orthogonal face-flux correction a corrected
laplacian stashes (fvMatrix::faceFluxCorrectionPtr_); `flux` adds it.
ami_coef [nBf] is the cyclicAMI implicit coupling coefficient per
boundary face (zero off the AMI patches): the owner row of AMI face f
gains ami_coef[f] * sum_j w_fj psi[cell_j] in every product
(cyclicAMIFvPatchField::updateInterfaceMatrix), a gather and a
scatter-add over the mesh's ami_entry_* tables beside the stencil.
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
    fcorr: Any = None
    soff: Any = None
    sfb: Any = None
    ami_coef: Any = None
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
            fcorr=_addn(self.fcorr, other.fcorr),
            soff=so,
            sfb=sf,
            ami_coef=_addn(self.ami_coef, other.ami_coef),
            dims=d,
            symmetric=self.symmetric and other.symmetric,
        )

    def __neg__(self) -> "FvMatrix":
        return FvMatrix(
            diag=-self.diag,
            lower=None if self.lower is None else -self.lower,
            upper=None if self.upper is None else -self.upper,
            source=-self.source, ic=-self.ic, bc=-self.bc,
            fcorr=None if self.fcorr is None else -self.fcorr,
            soff=None if self.soff is None else -self.soff,
            sfb=None if self.sfb is None else -self.sfb,
            ami_coef=None if self.ami_coef is None else -self.ami_coef,
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

    def ami_entry_coeffs(self, mesh) -> Any:
        """The cyclicAMI off-diagonal coefficient of each interpolation
        entry [nE] (None without an AMI coupling)."""
        if self.ami_coef is None or not mesh.has_ami:
            return None
        c = self.ami_coef if self.ami_coef.ndim == 1 else self.ami_coef[:, 0]
        return c[mesh.ami_entry_face] * mesh.ami_entry_w

    def ami_mul(self, mesh, psi: Any) -> Any:
        """cyclicAMI off-diagonal product [nC,(C)] (zero without AMI)."""
        ce = self.ami_entry_coeffs(mesh)
        if ce is None:
            return 0.0
        src = psi[mesh.ami_entry_cell]
        contrib = ce[:, None] * src if psi.ndim == 2 else ce * src
        return torch.zeros_like(psi).index_add(0, mesh.ami_entry_row,
                                               contrib)

    def _ami_row_sum(self, mesh, rs: Any) -> Any:
        """rs plus each row's sum of cyclicAMI coefficients."""
        ce = self.ami_entry_coeffs(mesh)
        if ce is None:
            return rs
        add = rs.new_zeros(mesh.n_cells).index_add(0, mesh.ami_entry_row,
                                                   ce)
        return rs + (add[:, None] if rs.ndim == 2 else add)

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
            rs = diag_eff + off_row
        else:
            rs = diag_eff + torch.sum(self.off_coeffs(mesh), dim=1)
        return self._ami_row_sum(mesh, rs)

    # ---- PISO/SIMPLE operator splits ----------------------------------------
    def A(self, mesh) -> Any:
        """Central coefficient / volume as a scalar field (vector matrices
        average their boundary coefficients over components)."""
        ic = self.ic if self.ic.ndim == 1 else torch.mean(self.ic, dim=1)
        d = self.diag + surface.boundary_sum(mesh, ic)
        return d / mesh.v

    def off_mul(self, mesh, psi: Any) -> Any:
        """Off-diagonal product sum_f off(f)*psi[nbr(f)]: the stencil
        kernel when soff is present, the gather path otherwise; plus the
        cyclicAMI term."""
        ami = self.ami_mul(mesh, psi) if self.ami_coef is not None else 0.0
        if self.soff is not None:
            from . import slot as slot_mod

            return slot_mod.off_apply(mesh, self.soff, self.sfb, psi) + ami
        off = self.off_coeffs(mesh)
        if psi.ndim == 2:
            return torch.sum(off[:, :, None] * psi[mesh.cnbr], dim=1) + ami
        return torch.sum(off * psi[mesh.cnbr], dim=1) + ami

    def H1(self, mesh) -> Any:
        """H at psi == 1 with no source: -(sum of the off-diagonal
        coefficients)/V (fvMatrix::H1, the SIMPLEC rAtU = 1/(A - H1))."""
        ones = torch.ones(self.diag.shape[0], dtype=mesh.v.dtype,
                          device=mesh.device)
        return -self.off_mul(mesh, ones) / mesh.v

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
        if self.ami_coef is not None and mesh.has_ami:
            # the coupled face's flux gains its interpolated neighbour
            av = psi.new_zeros(mesh.n_boundary_faces).index_add(
                0, mesh.ami_entry_face,
                mesh.ami_entry_w * psi[mesh.ami_entry_cell])
            c = (self.ami_coef if self.ami_coef.ndim == 1
                 else self.ami_coef[:, 0])
            f_bnd = f_bnd + c * av
        out = torch.cat([f_int, f_bnd], dim=0)
        if self.fcorr is not None:
            # the deferred non-orthogonal correction is part of the
            # operator's flux (flux += *faceFluxCorrectionPtr_)
            out = out + self.fcorr
        return out

    # ---- constraints ---------------------------------------------------------
    def set_reference(self, cell: int, value: float) -> "FvMatrix":
        """Pin the solution level in one cell (fvMatrix::setReference)."""
        d = self.diag[cell]
        source = self.source.clone()
        source[cell] += d * value
        diag = self.diag.clone()
        diag[cell] += d
        return dataclasses.replace(self, source=source, diag=diag)

    def set_values(self, mask: Any, values: Any, mesh) -> "FvMatrix":
        """Constrain psi to `values` where mask==1 by exact row
        replacement + column elimination (fvMatrix::setValues): the
        constrained row becomes diag*psi = diag*value, its
        off-diagonals are zeroed, and its known value is eliminated
        from the free rows' sources. Used by wall functions to fix
        near-wall epsilon."""
        nif = mesh.n_internal_faces
        m_o = mask[mesh.owner[:nif]]
        m_n = mask[mesh.neighbour]
        # eliminate constrained neighbours into the free rows' sources
        elim = self.off_mul(mesh, mask * values)
        keep_f = (1.0 - m_o) * (1.0 - m_n)
        so, sf = self.soff, self.sfb
        if so is not None:
            from . import slot as slot_mod

            nbm = slot_mod.nbr_values(mesh, mask)
            so = so * ((1.0 - mask[:, None]) * (1.0 - nbm))
            if mesh.fb_cells.shape[0]:
                sf = (sf * (1.0 - mask[mesh.fb_cells])
                      * (1.0 - mask[mesh.fb_nbrs]))
        # zero boundary coupling on constrained rows (empty faces read
        # keep_b=1, and their ic/bc are zero anyway)
        keep_b = 1.0 - surface.owner_to_b(mesh, mask)
        if self.ic.ndim == 2:
            keep_b = keep_b[:, None]
        src = self.source
        if src.ndim == 2:
            src = torch.where(mask[:, None] > 0, self.diag[:, None] * values,
                              src - elim[:, None])
        else:
            src = torch.where(mask > 0, self.diag * values, src - elim)
        return dataclasses.replace(
            self, upper=self.upper * keep_f, lower=self.lower * keep_f,
            source=src, ic=self.ic * keep_b, bc=self.bc * keep_b,
            soff=so, sfb=sf)

    def off_abs_sum(self, mesh) -> Any:
        """sum_f |off(f)| per row (slot path when available)."""
        if self.soff is not None:
            s = torch.sum(torch.abs(self.soff), dim=1)
            if mesh.fb_cells.shape[0]:
                s = s.index_add(0, mesh.fb_cells, torch.abs(self.sfb))
        else:
            s = torch.sum(torch.abs(self.off_coeffs(mesh)), dim=1)
        ce = self.ami_entry_coeffs(mesh)
        if ce is not None:
            s = s.index_add(0, mesh.ami_entry_row, torch.abs(ce))
        return s

    def relax(self, mesh, alpha: float, psi: Any) -> "FvMatrix":
        """Under-relaxation (fvMatrix::relax): add the boundary internal
        coefficients to the diagonal, force it positive and diagonally
        dominant (a convection matrix can have locally negative diags,
        which would make rAU = 1/A(U) negative), divide by alpha, and
        compensate the source with the current solution."""
        sum_off = self.off_abs_sum(mesh)
        ic_min = self.ic if self.ic.ndim == 1 else torch.amin(self.ic, dim=1)
        b_ic = surface.boundary_sum(mesh, ic_min)
        d0 = self.diag
        d_tot = torch.maximum(torch.abs(d0 + b_ic), sum_off) / alpha
        d1 = d_tot - b_ic
        dd = d1 - d0
        if psi.ndim == 2:
            src = self.source + dd[:, None] * psi
        else:
            src = self.source + dd * psi
        return dataclasses.replace(self, diag=d1, source=src)

    def residual(self, mesh, psi: Any, cmpt: Optional[int] = None) -> Any:
        d = self.diag_eff(mesh, cmpt)
        b = self.source_eff(mesh, cmpt)
        p = psi if psi.ndim == 1 else psi[:, cmpt].contiguous()
        return b - self.amul(mesh, p, d)


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
