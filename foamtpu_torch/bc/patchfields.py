"""Boundary conditions in data-driven mixed form (port of
openfoam-2.2.x_tpu/bc/patchfields.py).

Each BC kind supplies value coefficients (vf = vic*psi_c + vbc); the
gradient coefficients and evaluation follow from them exactly as in the
reference module. The ported slice covers the kinds the icoFoam cavity
uses: fixedValue, zeroGradient, empty and calculated. Any other kind
raises NotImplementedError naming it.
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


def _patch_internal(mesh, patch, data):
    """Internal (owner cell) values at the patch faces."""
    return data[mesh.owner[patch.slice]]


def _bcast(x, like):
    """Broadcast BC data (possibly a python scalar) against face values."""
    x = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    if x.shape == like.shape:
        return x
    return torch.broadcast_to(x, like.shape)


def _vc_fixed_value(bc, mesh, patch, vi):
    return torch.zeros_like(vi), _bcast(bc.ref_value, vi)


def _vc_zero_gradient(bc, mesh, patch, vi):
    return torch.ones_like(vi), torch.zeros_like(vi)


_VALUE_COEFFS: Dict[str, Callable] = {
    "fixedValue": _vc_fixed_value,
    "zeroGradient": _vc_zero_gradient,
    "calculated": _vc_fixed_value,
    "empty": _vc_zero_gradient,
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
    fn = _value_fn(bc)
    if bc.kind == "empty":
        z = internal.new_zeros(_empty_shape(patch, internal))
        return z, z
    vi = _patch_internal(mesh, patch, internal)
    vic, vbc = fn(bc, mesh, patch, vi)
    dc = mesh.delta_coeffs[patch.slice]
    if vi.ndim == 2:
        dc = dc[:, None]
    return (torch.broadcast_to(dc * (vic - 1.0), vi.shape),
            torch.broadcast_to(dc * vbc, vi.shape))


def evaluate(bc: PatchField, mesh, patch, internal) -> Any:
    fn = _value_fn(bc)
    if bc.kind == "empty":
        return internal.new_zeros(_empty_shape(patch, internal))
    vi = _patch_internal(mesh, patch, internal)
    vic, vbc = fn(bc, mesh, patch, vi)
    return vic * vi + vbc


def is_value_bc(bc: PatchField) -> bool:
    return bc.kind in ("fixedValue", "noSlip", "calculated")


def update(bc: PatchField, mesh, patch, internal, **ctx) -> PatchField:
    """Derived-BC update rule. The ported kinds have none (the reference's
    _UPDATE table holds no entry for them)."""
    _value_fn(bc)
    return bc


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------


def fixed_value(value, **opts) -> PatchField:
    return PatchField(ref_value=value, vfrac=1.0, kind="fixedValue",
                      opts=tuple(opts.items()))


def zero_gradient(**opts) -> PatchField:
    return PatchField(ref_value=0.0, ref_grad=0.0, vfrac=0.0,
                      kind="zeroGradient", opts=tuple(opts.items()))


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
