"""Carry the JAX package's mesh, GAMG levels and state into the port.

The JAX package's arrays arrive as anything numpy can read
(`np.asarray` of a jax array is a numpy array), so this module never
imports jax: the parity tests hand it the reference's objects (or
dicts of numpy arrays with the same names) and get the port's twins
on `device`, so both packages start from identical inputs.
"""

from __future__ import annotations

import dataclasses
import re
from collections.abc import Mapping
from typing import Any, Dict, List

import numpy as np
import torch

from .bc.patchfields import PatchField
from .core.dimensions import DimensionSet
from .core.fields import VolField
from .core.precision import DEFAULT_DEVICE, label_dtype, scalar_dtype
from .mesh.core import (ARRAY_FIELDS, STATIC_FIELDS, FvMesh, Patch,
                        from_arrays)
from .ops.matrix import FvMatrix
from .solvers.linear.gamg import LEVEL_META, Level


def _get(src, key, default=None):
    if isinstance(src, Mapping):
        return src.get(key, default)
    return getattr(src, key, default)


def tensor(a, device=DEFAULT_DEVICE) -> torch.Tensor:
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


def mesh_from_numpy(src, device=DEFAULT_DEVICE) -> FvMesh:
    """The port's FvMesh from the reference FvMesh's fields."""
    arrays = {k: np.asarray(_get(src, k)) for k in ARRAY_FIELDS}
    static = {k: _get(src, k) for k in STATIC_FIELDS}
    static.update(
        st_deltas=tuple(int(d) for d in static["st_deltas"]),
        patches=tuple(_patch(p) for p in static["patches"]),
        n_cells=int(static["n_cells"]), n_faces=int(static["n_faces"]),
        n_internal_faces=int(static["n_internal_faces"]),
        max_faces=int(static["max_faces"]),
        orthogonal=bool(static["orthogonal"]),
        has_ami=bool(static["has_ami"]))
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


def levels_from_numpy(levels, device=DEFAULT_DEVICE) -> List[Level]:
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


def field_from_numpy(field, device=DEFAULT_DEVICE) -> VolField:
    """The port's VolField (data and per-patch BC data) from the
    reference's."""
    bcs = tuple(PatchField(ref_value=tensor(bc.ref_value, device),
                           ref_grad=tensor(bc.ref_grad, device),
                           vfrac=tensor(bc.vfrac, device),
                           kind=bc.kind, opts=tuple(bc.opts))
                for bc in field.bcs)
    return VolField(data=tensor(field.data, device), bcs=bcs,
                    name=field.name, dims=_dims(field.dims))


def matrix_from_numpy(mat, device=DEFAULT_DEVICE) -> FvMatrix:
    """The port's FvMatrix from the reference's (slot and flat
    coefficients, the non-orthogonal flux correction and the cyclicAMI
    coupling coefficients)."""

    def t(name):
        v = _get(mat, name)
        return None if v is None else tensor(v, device)

    return FvMatrix(diag=t("diag"), lower=t("lower"), upper=t("upper"),
                    source=t("source"), ic=t("ic"), bc=t("bc"),
                    fcorr=t("fcorr"), soff=t("soff"), sfb=t("sfb"),
                    ami_coef=t("ami_coef"), dims=_dims(mat.dims),
                    symmetric=bool(mat.symmetric))


_STATE_FIELDS = ("U", "p", "p_rgh", "alpha",
                 # the multiphase family: twoPhaseEulerFoam's phases, the
                 # N-phase fractions, interMixingFoam's two fractions,
                 # compressibleInterFoam's T
                 "Ua", "Ub", "alphas", "alpha1", "alpha2", "T",
                 # radiation's G, the [n, nS] mass fractions of the
                 # combustion family, XiFoam's regress variable
                 "G", "Y", "b")
# the fields of the turbulence models: RAS k, epsilon, omega, nuTilda,
# nut, the Reynolds stress R, v2f's v2 and f, kkLOmega's kt and kl; LES
# nut, the subgrid k and stress B, dynLagrangian's flm and fmm; the
# compressible models' mut and alphat
_TURB_FIELDS = ("k", "epsilon", "omega", "nuTilda", "nut", "R", "B", "v2",
                "f", "kt", "kl", "flm", "fmm", "mut", "alphat")
_STATE_ARRAYS = ("phi", "U0", "U00", "rdt0", "ddt0_U", "rho", "lts_rdt",
                 "phia", "phib", "Ua0", "Ub0", "alpha0", "T0", "p_abs",
                 "dgdt", "phis",
                 # the compressible old-time levels, the combustion family's
                 # Y0, b0, Xi, rho_prev, mixture R and Cp, the pyrolysis
                 # fuel release
                 "p0", "rho0", "p_rgh0", "Y0", "b0", "Xi", "rho_prev",
                 "R_mix", "cp_mix", "pyro_m_gas")
# fireFoam's region states: {name: array} dicts
_REGION_STATES = ("pyro", "film")
# multiphaseEulerFoam's per-phase velocities U{i} and their old values
_PHASE_FIELD = re.compile(r"U\d+")
_PHASE_ARRAY = re.compile(r"U0_\d+")


def state_from_numpy(state, device=DEFAULT_DEVICE) -> Dict[str, Any]:
    """The port's solver state from the reference's. PISO/PIMPLE/SIMPLE:
    U, p, phi, phi_slot and U0, the `backward` / `CrankNicolson` history
    (U00, rdt0, ddt0_U), plus the turbulence fields (k, epsilon, omega,
    nuTilda, nut, with their wall BCs) under 'turb' when present; any
    other turbulence field raises. interFoam: U, p_rgh,
    alpha, phi, rho, U0 and, under local time stepping, lts_rdt. The
    multiphase family: Ua, Ub, phia, phib, Ua0, Ub0 (twoPhaseEulerFoam),
    alphas, alpha1, alpha2, alpha0, T, T0, p_abs, dgdt, and
    multiphaseEulerFoam's U{i}, U0_{i} and phis. Radiation and the
    combustion family: G, Y [n, nS], b, p0, rho0, p_rgh0, Y0, b0, Xi,
    rho_prev, R_mix, cp_mix, pyro_m_gas and the region states pyro
    {Ts, rho_s} and film {delta, Uf, Tf}. Any other entry raises."""
    out: Dict[str, Any] = {}
    for name in _STATE_FIELDS:
        if name in state:
            out[name] = field_from_numpy(state[name], device)
    for name in _STATE_ARRAYS:
        if name in state and not hasattr(state[name], "bcs"):
            out[name] = tensor(state[name], device)
    for name in state:
        # (multiphaseEulerFoam's first phase velocity U0 is a field, the
        # other states' U0 an array of old values)
        if _PHASE_FIELD.fullmatch(name) and hasattr(state[name], "bcs"):
            out[name] = field_from_numpy(state[name], device)
        elif _PHASE_ARRAY.fullmatch(name):
            out[name] = tensor(state[name], device)
    if "phi_slot" in state:
        out["phi_slot"] = tuple(tensor(a, device) for a in state["phi_slot"])
    for name in _REGION_STATES:
        if name in state:
            out[name] = {k: tensor(a, device) for k, a in state[name].items()}
    if state.get("turb") is not None:
        extra = set(state["turb"]) - set(_TURB_FIELDS)
        if extra:
            raise NotImplementedError(
                f"turbulence fields {sorted(extra)} are not ported to "
                "foamtpu_torch yet")
        out["turb"] = {name: field_from_numpy(f, device)
                       for name, f in state["turb"].items()}
    unknown = set(state) - set(out)
    if unknown:
        raise NotImplementedError(
            f"state entries {sorted(unknown)} are not ported to "
            "foamtpu_torch yet")
    return out


def config_from_reference(cls, cfg, **overrides):
    """A port config NamedTuple (PisoConfig, PimpleConfig, SimpleConfig,
    InterConfig, and the multiphase family's nine configs) from the
    reference's NamedTuple of the same fields. Entries that hold reference
    objects (GAMG controls, a turbulence model) are passed in `overrides`
    as their port twins; the control dicts are copied. A nested config
    (InterMixingConfig's and PhaseChangeConfig's `flow`, an InterConfig)
    is converted too."""
    kw = {}
    for name in cls._fields:
        v = overrides[name] if name in overrides else getattr(cfg, name)
        if name == "flow" and name not in overrides:
            from .solvers.interfoam import InterConfig

            v = config_from_reference(InterConfig, v)
        kw[name] = dict(v) if isinstance(v, dict) else v
    return cls(**kw)
