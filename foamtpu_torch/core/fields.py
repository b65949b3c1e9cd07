"""Cell-centred fields (port of openfoam-2.2.x_tpu/core/fields.py):
internal values + one PatchField per mesh patch + SI dimensions, as a
plain dataclass of tensors."""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from ..bc.patchfields import (PatchField, default_bcs, normalize_bcs,
                              evaluate as bc_evaluate, update as bc_update)
from .dimensions import DimensionSet, dimless


@dataclasses.dataclass(frozen=True)
class VolField:
    """Cell-centred field: values [nC] (scalar) or [nC, 3] (vector)."""

    data: Any
    bcs: Tuple[PatchField, ...]
    name: str = "field"
    dims: DimensionSet = dimless

    @property
    def rank(self) -> int:
        return 0 if self.data.ndim == 1 else 1

    def replace(self, **kw) -> "VolField":
        return dataclasses.replace(self, **kw)

    def with_data(self, data) -> "VolField":
        return dataclasses.replace(self, data=data)

    def boundary_values(self, mesh) -> Any:
        """Evaluate all patch face values, concatenated [nBf,(3)]."""
        return torch.cat([bc_evaluate(bc, mesh, p, self.data)
                          for p, bc in zip(mesh.patches, self.bcs)], dim=0)

    def correct_boundary_conditions(self, mesh, **ctx) -> "VolField":
        """Re-evaluate derived BC coefficient data."""
        new_bcs = tuple(bc_update(bc, mesh, p, self.data, **ctx)
                        for p, bc in zip(mesh.patches, self.bcs))
        return dataclasses.replace(self, bcs=new_bcs)


def vol_scalar(mesh, value, name="field", dims=dimless, bcs=None) -> VolField:
    data = torch.broadcast_to(
        torch.as_tensor(value, dtype=mesh.v.dtype, device=mesh.device),
        (mesh.n_cells,)).clone()
    bcs = bcs if bcs is not None else default_bcs(mesh, rank=0)
    return VolField(data=data, bcs=normalize_bcs(mesh, bcs, rank=0),
                    name=name, dims=dims)


def vol_vector(mesh, value, name="field", dims=dimless, bcs=None) -> VolField:
    value = torch.as_tensor(value, dtype=mesh.v.dtype, device=mesh.device)
    if value.ndim <= 1:
        data = torch.broadcast_to(value, (mesh.n_cells, 3)).clone()
    else:
        data = value
    bcs = bcs if bcs is not None else default_bcs(mesh, rank=1)
    return VolField(data=data,
                    bcs=normalize_bcs(mesh, bcs, rank=1, ncomp=data.shape[1]),
                    name=name, dims=dims)
