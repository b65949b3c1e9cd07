"""Turbulence model framework (port of
openfoam-2.2.x_tpu/models/turbulence/base.py: `TurbulenceModel`,
`bound_below`, `production`, `div_dev_reff`, `register` and `select`).

A model is a static config object whose methods are plain functions of
(mesh, tstate, U, phi); its fields (k, epsilon, nut, ...) live in the
solver state under 'turb'. `select` builds every model the reference
registers: the RAS models of ras.py to ras5.py, the LES models of les.py
to les4.py and the compressible models of compressible.py and
compressible2.py. A name neither registers raises ValueError listing the
models, as in the reference; an LESProperties `delta` other than
cubeRootVol raises NotImplementedError (the reference reads none and
always takes cubeRootVol).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ...core.dictionary import FoamDict
from ...core.dimensions import dimViscosity
from ...core.fields import VolField
from ...ops import fvc, fvm
from ...ops import slot as slot_mod


def bound_below(x: Any, min_val: float) -> Any:
    """bound.C: clip from below."""
    return torch.clamp(x, min=min_val)


class TurbulenceModel:
    """Base: laminar (no-op) model."""

    name = "laminar"
    field_names: Tuple[str, ...] = ()

    def __init__(self, nu: float, coeffs: Optional[FoamDict] = None):
        self.nu = nu
        self.coeffs = coeffs or {}
        # convection scheme of the model's transport equations
        self.div_scheme = "upwind"
        # non-orthogonal correction in the model's laplacians (set from
        # the case's laplacianSchemes at load)
        self.corrected = False
        self.corr_limit = 1.0

    # -- state ------------------------------------------------------------------
    def init_state(self, mesh, case=None) -> Dict[str, VolField]:
        return {}

    # -- coupling ------------------------------------------------------------------
    def nut(self, mesh, tstate) -> Any:
        return mesh.v.new_zeros((mesh.n_cells,))

    def nu_eff_cell(self, mesh, tstate) -> Any:
        return self.nu + self.nut(mesh, tstate)

    def nu_eff_face(self, mesh, tstate) -> Any:
        """nu + nut at faces; wall-function nut BCs contribute through
        the nut field's boundary values."""
        if "nut" in tstate:
            return self.nu + fvc.interpolate(mesh, tstate["nut"])
        return torch.full((mesh.n_faces,), self.nu, dtype=mesh.v.dtype,
                          device=mesh.device)

    def nu_eff_slot(self, mesh, tstate):
        """SlotFace of nuEff over internal faces + boundary values: the
        gather-free twin of nu_eff_face."""
        if "nut" in tstate:
            nut: VolField = tstate["nut"]
            bv = self.nu + nut.boundary_values(mesh)
            f = slot_mod.interpolate(mesh, nut.data, bv=bv)
            return slot_mod.SlotFace(self.nu + f.sv, self.nu + f.fb, bv)
        return slot_mod.SlotFace(
            torch.full_like(mesh.st_wself, self.nu),
            torch.full_like(mesh.fb_wself, self.nu),
            mesh.v.new_full((mesh.n_boundary_faces,), self.nu))

    def div_dev_reff(self, mesh, tstate, U: VolField):
        """-laplacian(nuEff, U) - div(nuEff dev(grad(U)^T))
        (incompressible RASModel divDevReff). Returns (FvMatrix
        implicit, explicit source [nC,3] per volume)."""
        nu_slot = self.nu_eff_slot(mesh, tstate)
        nu_eff_f = slot_mod.to_flat(mesh, nu_slot)
        mat = -fvm.laplacian(mesh, nu_eff_f, U, corrected=self.corrected,
                             gamma_dims=dimViscosity,
                             limit=self.corr_limit, gamma_slot=nu_slot)
        g = fvc.grad(mesh, U)  # [nC,3,3], g[i,j] = d_i u_j
        gT = torch.transpose(g, 1, 2)
        tr = torch.diagonal(g, dim1=1, dim2=2).sum(dim=1)
        eye = torch.eye(3, dtype=g.dtype, device=g.device)
        dev_t = gT - (tr / 3.0)[:, None, None] * eye
        nu_eff_c = self.nu_eff_cell(mesh, tstate)
        tau = nu_eff_c[:, None, None] * dev_t
        # div of a tensor: (1/V) sum_f Sf . tau_f -> [nC,3], slot form
        tau_f = slot_mod.interpolate(mesh, tau.reshape(-1, 9))
        sv = tau_f.sv.reshape(tau_f.sv.shape[:2] + (3, 3))
        flux_sv = torch.einsum("cmi,cmij->cmj", mesh.st_sf, sv)
        div_tau = torch.sum(flux_sv * mesh.st_valid[:, :, None], dim=1)
        if mesh.fb_cells.shape[0]:
            fbt = tau_f.fb.reshape(-1, 3, 3)
            flux_fb = torch.einsum("fi,fij->fj", mesh.fb_sf, fbt)
            div_tau = div_tau.index_add(0, mesh.fb_cells, flux_fb)
        # compact active-boundary contribution (zero-gradient tau)
        flux_b = torch.einsum("fi,fij->fj", mesh.ab_sf, tau[mesh.ab_owner])
        div_tau = div_tau.index_add(0, mesh.ab_owner, flux_b)
        div_tau = div_tau / mesh.v[:, None]
        return mat, -div_tau

    # -- per-step update --------------------------------------------------------
    def correct(self, mesh, tstate, U: VolField, phi, dt,
                steady: bool = False, relax: float = 1.0,
                controls: Optional[Dict] = None,
                phi_slot=None) -> Tuple[Dict, Dict]:
        return tstate, {}


def production(mesh, nut: Any, U: VolField) -> Tuple[Any, Any]:
    """G = nut * 2|symm(grad U)|^2 and S2 = 2|symm|^2; returns (G, S2)."""
    g = fvc.grad(mesh, U)
    s = 0.5 * (g + torch.transpose(g, 1, 2))
    s2 = 2.0 * torch.sum(s * s, dim=(1, 2))
    return nut * s2, s2


_REGISTRY: Dict[str, Callable] = {}


def register(name: str, cls) -> None:
    _REGISTRY[name] = cls


def select(props: FoamDict, nu: float, kind: str = "RAS",
           compressible: bool = False) -> TurbulenceModel:
    """turbulenceModel::New: dispatch on the RASModel/LESModel keyword
    of RASProperties/LESProperties.

    compressible=True (`nu` is then the dynamic viscosity mu) takes
    `compressible::<name>` where that is registered, else the
    incompressible model, as the reference does (its namespace comes
    from the library the solver links, not from the dictionary)."""
    from . import (compressible as _comp,  # noqa: F401
                   compressible2 as _comp2, les, les2, les3,
                   les4, ras, ras2, ras3, ras4, ras5)

    if str(props.get("simulationType", kind)) == "laminar":
        return TurbulenceModel(nu)
    name = str(props.get("RASModel", props.get("LESModel", "laminar")))
    if name == "laminar" or str(props.get("turbulence", "on")) in ("off",
                                                                   "no"):
        return TurbulenceModel(nu)
    if compressible and f"compressible::{name}" in _REGISTRY:
        name = f"compressible::{name}"
    if name not in _REGISTRY:
        raise ValueError(f"unknown turbulence model {name!r}; "
                         f"available: {sorted(_REGISTRY)}")
    if kind == "LES":
        # the reference reads no delta and always takes cubeRootVol
        delta = str(props.get("delta", "cubeRootVol"))
        if delta != "cubeRootVol":
            raise NotImplementedError(
                f"LES delta {delta!r} is not ported to foamtpu_torch yet "
                "(ported: cubeRootVol)")
    coeffs = props.get(name.split("::")[-1] + "Coeffs", FoamDict())
    return _REGISTRY[name](nu, coeffs)
