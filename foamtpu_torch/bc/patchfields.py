"""Boundary conditions in data-driven mixed form (port of
openfoam-2.2.x_tpu/bc/patchfields.py).

Each BC kind supplies value coefficients (vf = vic*psi_c + vbc); the
gradient coefficients and evaluation follow from them exactly as in the
reference module. The ported slice covers the kinds of the icoFoam
cavity, the simpleFoam pitzDaily case, the kOmegaSST tet duct and the
interFoam damBreak case: fixedValue, zeroGradient, fixedGradient, empty,
calculated, mixed, inletOutlet, totalPressure (incompressible form),
pressureInletOutletVelocity, flowRateInletVelocity (a fixed value), the
nutk/nutU/nutUSpalding/kqR/epsilon/omega wall functions,
and slip with the kinds that share its value coefficients
(symmetryPlane, symmetry, wedge); and the coupled kinds of a cyclicAMI
pair: cyclicAMI, with the jumpCyclic family fixedJump and fan on a pair
retained as coincident AMI faces (ami_values, jump_signed, the fan
curve's update `_up_fan`). Derived kinds re-evaluate their
mixed triple through the update registry (`update` /
`register_update`; the turbulence models register their wall-function
rules). Any other kind raises NotImplementedError naming it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class PatchField:
    """Per-patch BC state. Tensors are per-face on the patch: [n] or
    [n,3] matching the field rank (or scalars, broadcast)."""

    ref_value: Any = 0.0
    ref_grad: Any = 0.0
    vfrac: Any = 1.0           # valueFraction f in [0,1]
    kind: str = "calculated"
    opts: Tuple[Tuple[str, Any], ...] = ()

    def opt(self, key, default=None):
        for k, v in self.opts:
            if k == key:
                return v
        return default

    def replace(self, **kw) -> "PatchField":
        return dataclasses.replace(self, **kw)


def _patch_normals(mesh, patch):
    sl = patch.slice
    return mesh.sf[sl] / torch.clamp(mesh.mag_sf[sl], min=1e-30)[:, None]


def _patch_internal(mesh, patch, data):
    """Internal (owner cell) values at the patch faces."""
    return data[mesh.owner[patch.slice]]


def _bcast(x, like):
    """Broadcast BC data (possibly a python scalar) against face values."""
    x = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    if x.shape == like.shape:
        return x
    return torch.broadcast_to(x, like.shape)


def _col(x, like):
    """Broadcast a per-face scalar [n] against [n,3] values if needed."""
    x = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    if like.ndim == 2 and x.ndim == 1:
        return x[:, None]
    return x


def _vc_mixed(bc, mesh, patch, vi):
    dc = _col(mesh.delta_coeffs[patch.slice], vi)
    f = _col(_bcast(bc.vfrac, vi[..., 0] if vi.ndim == 2 else vi), vi)
    rv = _bcast(bc.ref_value, vi)
    rg = _bcast(bc.ref_grad, vi)
    vic = 1.0 - f
    vbc = f * rv + (1.0 - f) * rg / dc
    return vic, vbc


def _vc_fixed_value(bc, mesh, patch, vi):
    return torch.zeros_like(vi), _bcast(bc.ref_value, vi)


def _vc_zero_gradient(bc, mesh, patch, vi):
    return torch.ones_like(vi), torch.zeros_like(vi)


def _vc_fixed_gradient(bc, mesh, patch, vi):
    dc = _col(mesh.delta_coeffs[patch.slice], vi)
    return torch.ones_like(vi), _bcast(bc.ref_grad, vi) / dc


def ami_values(mesh, internal):
    """cyclicAMI interpolated values on ALL boundary faces [nBf,(C)]:
    sum_j w_ij psi_own(Bj) on AMI faces, zero elsewhere
    (cyclicAMIFvPatchField::patchNeighbourField)."""
    src = internal[mesh.ami_entry_cell]
    w = mesh.ami_entry_w
    contrib = (w[:, None] * src) if internal.ndim == 2 else w * src
    out = internal.new_zeros((mesh.n_boundary_faces,)
                             + tuple(internal.shape[1:]))
    return out.index_add(0, mesh.ami_entry_face, contrib)


def _ami_patch_values(mesh, patch, internal):
    """AMI-interpolated values for one patch [size,(C)]."""
    rel = patch.start - mesh.n_internal_faces
    return ami_values(mesh, internal)[rel:rel + patch.size]


def _ami_wown(mesh, patch, like):
    """The own-side blend weight of the patch's coupled face values."""
    rel = patch.start - mesh.n_internal_faces
    w = mesh.ami_wown[rel:rel + patch.size]
    return w[:, None] if like.ndim == 2 else w


_JUMP_KINDS = ("fixedJump", "fixedJumpAMI", "fan")
_COUPLED_KINDS = ("cyclicAMI",) + _JUMP_KINDS


def jump_signed(bc: PatchField, like) -> Any:
    """Signed jump of the jumpCyclic family: the master side sees the
    partner value MINUS the jump, the slave PLUS it
    (jumpCyclicFvPatchField::patchNeighbourField), i.e. psi rises by
    +jump from master to slave: a fan with a positive curve blows
    master -> slave."""
    s = -1.0 if bc.opt("master", True) else 1.0
    return s * _bcast(bc.ref_value, like)


def _coupled_nbr(bc, mesh, patch, internal):
    """The partner side's interpolated values, offset by the jump."""
    vb = _ami_patch_values(mesh, patch, internal)
    if bc.kind in _JUMP_KINDS:
        vb = vb + jump_signed(bc, vb)
    return vb


def _vc_symmetry(bc, mesh, patch, vi):
    """Scalars: zero gradient. Vectors: vf = vi - n (n . vi), its
    diagonal part (1 - n_c^2) implicit and the rest explicit."""
    if vi.ndim == 1:
        return torch.ones_like(vi), torch.zeros_like(vi)
    n = _patch_normals(mesh, patch).to(vi.dtype)
    vic = 1.0 - n * n
    vf = vi - n * torch.sum(n * vi, dim=1, keepdim=True)
    return vic, vf - vic * vi


_VALUE_COEFFS: Dict[str, Callable] = {
    "mixed": _vc_mixed,
    "fixedValue": _vc_fixed_value,
    "zeroGradient": _vc_zero_gradient,
    "fixedGradient": _vc_fixed_gradient,
    "calculated": _vc_fixed_value,
    "empty": _vc_zero_gradient,
    "inletOutlet": _vc_mixed,
    "totalPressure": _vc_mixed,
    "pressureInletOutletVelocity": _vc_mixed,
    # its `value` as a fixed value; the reference reads no massFlowRate
    "flowRateInletVelocity": _vc_fixed_value,
    "symmetryPlane": _vc_symmetry,
    "symmetry": _vc_symmetry,
    "slip": _vc_symmetry,
    # wedge: for the small wedge angles the reference prescribes (< 5
    # deg) the rotation is the symmetry transform to O(theta^2)
    "wedge": _vc_symmetry,
    # wall functions: fixed-value-like on nut (the value comes from the
    # update rule), zero-gradient-like on k; the epsilon and omega wall
    # functions fix the wall-adjacent CELL value through the matrix
    # constraint (models/turbulence/ras.py), the face itself is
    # flux-free
    "nutkWallFunction": _vc_fixed_value,
    "nutUWallFunction": _vc_fixed_value,
    "nutUSpaldingWallFunction": _vc_fixed_value,
    "kqRWallFunction": _vc_zero_gradient,
    "epsilonWallFunction": _vc_zero_gradient,
    "omegaWallFunction": _vc_zero_gradient,
}


def _value_fn(bc: PatchField) -> Callable:
    fn = _VALUE_COEFFS.get(bc.kind)
    if fn is None:
        raise NotImplementedError(
            f"boundary condition kind {bc.kind!r} is not ported to "
            "foamtpu_torch yet")
    return fn


def _empty_shape(patch, internal):
    return (patch.size,) + tuple(internal.shape[1:])


def value_coeffs(bc: PatchField, mesh, patch, internal) -> Tuple[Any, Any]:
    if bc.kind in _COUPLED_KINDS:
        # the coupled face value: distance-weighted blend of the own
        # cell and the interpolated neighbour cells, the jump kinds'
        # neighbour offset by their jump (cyclicAMIFvPatchField::evaluate;
        # the implicit coupling rides the matrix's ami_coef)
        vb = _coupled_nbr(bc, mesh, patch, internal)
        w = _ami_wown(mesh, patch, vb)
        return torch.broadcast_to(w, vb.shape), (1.0 - w) * vb
    fn = _value_fn(bc)
    if bc.kind == "empty":
        # empty patches are masked out by every consumer: skip the
        # owner gather (reference: same shortcut)
        z = internal.new_zeros(_empty_shape(patch, internal))
        return z, z
    vi = _patch_internal(mesh, patch, internal)
    vic, vbc = fn(bc, mesh, patch, vi)
    return torch.broadcast_to(vic, vi.shape), torch.broadcast_to(vbc, vi.shape)


def grad_coeffs(bc: PatchField, mesh, patch, internal) -> Tuple[Any, Any]:
    if bc.kind == "empty":
        z = internal.new_zeros(_empty_shape(patch, internal))
        return z, z
    if bc.kind in _COUPLED_KINDS:
        vi = _patch_internal(mesh, patch, internal)
        vb = _coupled_nbr(bc, mesh, patch, internal)
        dc = _col(mesh.delta_coeffs[patch.slice], vi)
        return (torch.broadcast_to(-dc, vi.shape),
                torch.broadcast_to(dc * vb, vi.shape))
    fn = _value_fn(bc)
    vi = _patch_internal(mesh, patch, internal)
    vic, vbc = fn(bc, mesh, patch, vi)
    dc = mesh.delta_coeffs[patch.slice]
    if vi.ndim == 2:
        dc = dc[:, None]
    return (torch.broadcast_to(dc * (vic - 1.0), vi.shape),
            torch.broadcast_to(dc * vbc, vi.shape))


def evaluate(bc: PatchField, mesh, patch, internal) -> Any:
    if bc.kind in _COUPLED_KINDS:
        vb = _coupled_nbr(bc, mesh, patch, internal)
        vi = _patch_internal(mesh, patch, internal)
        w = _ami_wown(mesh, patch, vb)
        return w * vi + (1.0 - w) * vb
    fn = _value_fn(bc)
    if bc.kind == "empty":
        return internal.new_zeros(_empty_shape(patch, internal))
    vi = _patch_internal(mesh, patch, internal)
    vic, vbc = fn(bc, mesh, patch, vi)
    return vic * vi + vbc


def is_value_bc(bc: PatchField) -> bool:
    return bc.kind in ("fixedValue", "noSlip", "calculated")


# ---------------------------------------------------------------------------
# Update rules for derived BCs (lagged re-evaluation of the mixed triple)
# ---------------------------------------------------------------------------


def _up_inlet_outlet(bc, mesh, patch, internal, *, phi=None, **ctx):
    """zeroGradient on outflow, fixedValue(inletValue) on inflow."""
    if phi is None:
        return bc
    phib = phi[patch.slice]
    return bc.replace(vfrac=(phib < 0.0).to(phib.dtype))


def _up_total_pressure(bc, mesh, patch, internal, *, phi=None, U=None,
                       rho_b=None, **ctx):
    """Fixed-value: p = p0 on outflow, p0 - 0.5 (rho) |U|^2 on inflow
    (derived/totalPressure, the incompressible psi=none form; rho_b
    supplies the density factor for p_rgh-style solvers)."""
    if phi is None or U is None:
        return bc
    phib = phi[patch.slice]
    p0 = bc.opt("p0", 0.0)
    cells = mesh.owner[patch.slice]
    Ub = U[cells]
    magU2 = torch.sum(Ub * Ub, dim=1)
    if rho_b is not None:
        magU2 = magU2 * rho_b[cells]
    pval = torch.where(phib > 0.0, torch.full_like(magU2, p0),
                       p0 - 0.5 * magU2)
    return bc.replace(ref_value=pval, vfrac=torch.ones_like(pval))


def _up_pressure_io_velocity(bc, mesh, patch, internal, *, phi=None, **ctx):
    """On outflow zeroGradient; on inflow the normal component is set
    from the flux (derived/pressureInletOutletVelocity)."""
    if phi is None:
        return bc
    phib = phi[patch.slice]
    n = _patch_normals(mesh, patch)
    Un = (phib / torch.clamp(mesh.mag_sf[patch.slice], min=1e-30))[:, None] * n
    return bc.replace(ref_value=Un, vfrac=(phib < 0.0).to(phib.dtype))


def _up_fan(bc, mesh, patch, internal, *, phi=None, **ctx):
    """fan: the pressure jump from the fan curve at the current
    volumetric flow rate through the pair (derived/fan: jump = sum_i
    f_i Q^i with the 2.2 `f` coefficients), clipped at zero. Both sides
    carry the same curve; Q is the total flow through the pair, measured
    on the MASTER side with outflow positive so that the sides agree."""
    if phi is None:
        return bc
    coeffs = bc.opt("fanPoly")
    if coeffs is None:
        return bc
    phib = phi[patch.slice]
    s = 1.0 if bc.opt("master", True) else -1.0
    Q = s * torch.sum(phib * mesh.face_active[patch.slice])
    jump = phib.new_zeros(())
    for c in coeffs[::-1]:
        jump = jump * Q + c
    like = _patch_internal(mesh, patch, internal)
    return bc.replace(ref_value=torch.broadcast_to(
        torch.clamp(jump, min=0.0), like.shape))


_UPDATE: Dict[str, Callable] = {
    "fan": _up_fan,
    "inletOutlet": _up_inlet_outlet,
    "totalPressure": _up_total_pressure,
    "pressureInletOutletVelocity": _up_pressure_io_velocity,
}


def update(bc: PatchField, mesh, patch, internal, **ctx) -> PatchField:
    if bc.kind not in _COUPLED_KINDS:
        _value_fn(bc)
    fn = _UPDATE.get(bc.kind)
    return fn(bc, mesh, patch, internal, **ctx) if fn else bc


def register_update(kind: str, fn: Callable) -> None:
    """Extension point for model libraries (e.g. wall functions)."""
    _UPDATE[kind] = fn


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------


def fixed_value(value, **opts) -> PatchField:
    return PatchField(ref_value=value, vfrac=1.0, kind="fixedValue",
                      opts=tuple(opts.items()))


def zero_gradient(**opts) -> PatchField:
    return PatchField(ref_value=0.0, ref_grad=0.0, vfrac=0.0,
                      kind="zeroGradient", opts=tuple(opts.items()))


def fixed_gradient(grad, **opts) -> PatchField:
    return PatchField(ref_grad=grad, vfrac=0.0, kind="fixedGradient",
                      opts=tuple(opts.items()))


def mixed(ref_value, ref_grad, vfrac, **opts) -> PatchField:
    return PatchField(ref_value=ref_value, ref_grad=ref_grad, vfrac=vfrac,
                      kind="mixed", opts=tuple(opts.items()))


def make(kind: str, **kw) -> PatchField:
    opts = {k: v for k, v in kw.items()
            if k not in ("ref_value", "ref_grad", "vfrac")}
    value_kinds = ("fixedValue", "totalPressure", "calculated")
    return PatchField(
        ref_value=kw.get("ref_value", 0.0),
        ref_grad=kw.get("ref_grad", 0.0),
        vfrac=kw.get("vfrac", 1.0 if kind in value_kinds else 0.0),
        kind=kind,
        opts=tuple(opts.items()),
    )


def normalize_bcs(mesh, bcs, rank: int,
                  ncomp: int = 3) -> Tuple[PatchField, ...]:
    """Broadcast all BC data to per-face shapes on the mesh's device and
    dtype (ncomp: component count of rank-1 fields)."""
    dt, dev = mesh.v.dtype, mesh.device
    out = []
    for p, bc in zip(mesh.patches, bcs):
        vshape = (p.size,) if rank == 0 else (p.size, ncomp)
        rv = torch.broadcast_to(torch.as_tensor(bc.ref_value, dtype=dt,
                                                device=dev), vshape)
        rg = torch.broadcast_to(torch.as_tensor(bc.ref_grad, dtype=dt,
                                                device=dev), vshape)
        vf = torch.as_tensor(bc.vfrac, dtype=dt, device=dev)
        vf = torch.broadcast_to(vf, vshape if vf.ndim == rank + 1
                                else (p.size,))
        out.append(dataclasses.replace(bc, ref_value=rv, ref_grad=rg,
                                       vfrac=vf))
    return tuple(out)


def shift_value_bcs(bcs, delta) -> Tuple[PatchField, ...]:
    """Every BC's ref_value shifted by a constant: the compressible
    pressure solves run on p - pRef in float32 (kinds that do not use
    ref_value, or hold a jump in it, stay as they are)."""
    out = []
    for bc in bcs:
        if bc.kind in ("zeroGradient", "fixedGradient", "empty",
                       "symmetry", "symmetryPlane", "wedge", "slip",
                       "cyclicAMI", "fixedJump", "fixedJumpAMI", "fan"):
            out.append(bc)
        else:
            out.append(bc.replace(ref_value=bc.ref_value + delta))
    return tuple(out)


def default_bcs(mesh, rank: int) -> Tuple[PatchField, ...]:
    """zeroGradient everywhere except constraint patches get their type."""
    out = []
    for p in mesh.patches:
        if p.type == "empty":
            out.append(PatchField(kind="empty", vfrac=0.0))
        elif p.type in ("symmetryPlane", "symmetry", "wedge", "cyclicAMI"):
            out.append(PatchField(kind=p.type, vfrac=0.0))
        else:
            out.append(zero_gradient())
    return tuple(out)
