"""fvc — explicit finite-volume operators (port of the slice's part of
openfoam-2.2.x_tpu/ops/fvc.py): cell->face interpolation, the Gauss
linear gradient through the slot layout, and the face flux."""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..core.fields import VolField
from . import slot as slot_mod
from . import surface


def interpolate(mesh, field: VolField, weights: Optional[Any] = None) -> Any:
    """Cell -> face interpolation (linear by default). [nF,(3)]."""
    return surface.face_values(mesh, field, weights)


def grad(mesh, field: VolField) -> Any:
    """Gauss gradient. scalar -> [nC,3]; vector -> [nC,3,3] with
    g[c,i,j] = d(u_j)/d(x_i), computed on the slot layout."""
    return slot_mod.grad(mesh, field.data, field.boundary_values(mesh))


def grad_of(mesh, field: VolField, scheme: str = "Gauss linear") -> Any:
    """Gradient dispatch by fvSchemes keyword. The slice ports
    'Gauss linear'; other schemes raise."""
    toks = str(scheme).split()
    if toks in (["Gauss", "linear"], ["linear"], ["Gauss"], []):
        return grad(mesh, field)
    raise NotImplementedError(
        f"gradScheme {scheme!r} is not ported to foamtpu_torch yet")


def flux(mesh, field: VolField) -> Any:
    """Face flux of a vector field: phi = Sf . interp(U), masked on empty
    patches (fvc::flux)."""
    uf = interpolate(mesh, field)
    return torch.sum(mesh.sf * uf, dim=1) * mesh.face_active
