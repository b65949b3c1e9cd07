"""Carry the JAX package's mesh, GAMG levels and state into the port.

The JAX package's arrays arrive as anything numpy can read
(`np.asarray` of a jax array is a numpy array), so this module never
imports jax: the parity tests hand it the reference's objects (or
dicts of numpy arrays with the same names) and get the port's twins
on `device`, so both packages start from identical inputs.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any, Dict, List

import numpy as np
import torch

from .bc.patchfields import PatchField
from .core.dimensions import DimensionSet
from .core.fields import VolField
from .core.precision import label_dtype, scalar_dtype
from .mesh.core import (ARRAY_FIELDS, STATIC_FIELDS, FvMesh, Patch,
                        from_arrays)
from .ops.matrix import FvMatrix
from .solvers.linear.gamg import LEVEL_META, Level


def _get(src, key, default=None):
    if isinstance(src, Mapping):
        return src.get(key, default)
    return getattr(src, key, default)


def tensor(a, device="cpu") -> torch.Tensor:
    """numpy-readable array -> tensor: floats in the scalar dtype,
    integers as int64, bools as bool."""
    a = np.asarray(a)
    if a.dtype.kind == "f":
        dt = scalar_dtype()
    elif a.dtype.kind == "b":
        dt = torch.bool
    else:
        dt = label_dtype
    return torch.tensor(a, dtype=dt, device=device)


def _patch(p) -> Patch:
    return Patch(name=p.name, type=p.type, start=int(p.start),
                 size=int(p.size), neighbour_patch=p.neighbour_patch,
                 attrs=tuple(p.attrs))


def mesh_from_numpy(src, device="cpu") -> FvMesh:
    """The port's FvMesh from the reference FvMesh's fields."""
    if _get(src, "has_ami", False):
        raise NotImplementedError(
            "cyclicAMI meshes are not ported to foamtpu_torch yet")
    arrays = {k: np.asarray(_get(src, k)) for k in ARRAY_FIELDS}
    static = {k: _get(src, k) for k in STATIC_FIELDS}
    static.update(
        st_deltas=tuple(int(d) for d in static["st_deltas"]),
        patches=tuple(_patch(p) for p in static["patches"]),
        n_cells=int(static["n_cells"]), n_faces=int(static["n_faces"]),
        n_internal_faces=int(static["n_internal_faces"]),
        max_faces=int(static["max_faces"]),
        orthogonal=bool(static["orthogonal"]), has_ami=False)
    zones = {k: np.asarray(v)
             for k, v in (_get(src, "cell_zone_masks") or {}).items()}
    return from_arrays(arrays, static, zones, device)


def _py(obj):
    """Static metadata -> plain python ints/tuples."""
    if isinstance(obj, (tuple, list)):
        return tuple(_py(v) for v in obj)
    if isinstance(obj, (bool, np.bool_)):
        return bool(obj)
    if isinstance(obj, (int, np.integer)):
        return int(obj)
    return obj


def levels_from_numpy(levels, device="cpu") -> List[Level]:
    """The port's GAMG Levels from the reference's."""
    out = []
    for lv in levels:
        kw: Dict[str, Any] = {}
        for f in dataclasses.fields(Level):
            v = _get(lv, f.name)
            if f.name in LEVEL_META:
                kw[f.name] = _py(v)
            elif f.name == "st":
                kw["st"] = {k: (_py(a) if k == "st_deltas"
                                else tensor(a, device))
                            for k, a in v.items()}
            elif f.name == "rule_masks":
                kw["rule_masks"] = tuple(None if m is None
                                         else tensor(m, device) for m in v)
            else:
                kw[f.name] = None if v is None else tensor(v, device)
        out.append(Level(**kw))
    return out


def _dims(d) -> DimensionSet:
    return DimensionSet(*[getattr(d, f.name)
                          for f in dataclasses.fields(DimensionSet)])


def field_from_numpy(field, device="cpu") -> VolField:
    """The port's VolField (data and per-patch BC data) from the
    reference's."""
    bcs = tuple(PatchField(ref_value=tensor(bc.ref_value, device),
                           ref_grad=tensor(bc.ref_grad, device),
                           vfrac=tensor(bc.vfrac, device),
                           kind=bc.kind, opts=tuple(bc.opts))
                for bc in field.bcs)
    return VolField(data=tensor(field.data, device), bcs=bcs,
                    name=field.name, dims=_dims(field.dims))


def matrix_from_numpy(mat, device="cpu") -> FvMatrix:
    """The port's FvMatrix from the reference's (slot and flat
    coefficients; cyclicAMI and deferred-correction terms are outside
    the slice and raise)."""
    if (_get(mat, "ami_coef") is not None
            or _get(mat, "fcorr") is not None):
        raise NotImplementedError(
            "ami_coef/fcorr matrices are not ported to foamtpu_torch yet")

    def t(name):
        v = _get(mat, name)
        return None if v is None else tensor(v, device)

    return FvMatrix(diag=t("diag"), lower=t("lower"), upper=t("upper"),
                    source=t("source"), ic=t("ic"), bc=t("bc"),
                    soff=t("soff"), sfb=t("sfb"), dims=_dims(mat.dims),
                    symmetric=bool(mat.symmetric))


def state_from_numpy(state, device="cpu") -> Dict[str, Any]:
    """The port's PISO state from the reference's: U, p, phi, phi_slot
    and U0."""
    return {
        "U": field_from_numpy(state["U"], device),
        "p": field_from_numpy(state["p"], device),
        "phi": tensor(state["phi"], device),
        "phi_slot": tuple(tensor(a, device) for a in state["phi_slot"]),
        "U0": tensor(state["U0"], device),
    }
