"""Surface interpolation schemes: linear/upwind/midPoint and the TVD
limiter family (port of openfoam-2.2.x_tpu/ops/schemes.py).

A limited scheme blends central (CD) and upwind (UD) weights per face,

    w_f = limiter*w_CD + (1-limiter)*w_UD,

with the TVD ratio r from the upwind-cell gradient

    r = 2*(d . grad_upwind)/(psi_N - psi_P) - 1,  d = C_N - C_P

(for vectors, projected onto psi_N - psi_P). The `...V` variants
(limitedLinearV, vanLeerV, ...) apply this one scalar limiter to all
components, as the reference does (not upstream OpenFOAM's
direction-of-steepest-change form). `weights` is the flat gather form on
internal faces, `weights_slot` the slot-form twin the solvers use.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..core.fields import VolField
from . import fvc
from . import slot as slot_mod

# limiter functions: lam(r) -> blending factor (Sweby phi)
_LIMITERS: Dict[str, Callable] = {
    "vanLeer": lambda r: (r + torch.abs(r)) / (1.0 + torch.abs(r)),
    "Minmod": lambda r: torch.clamp(r, 0.0, 1.0),
    "SuperBee": lambda r: torch.maximum(
        torch.clamp(2.0 * r, 0.0, 1.0), torch.clamp(r, 0.0, 2.0)),
    "vanAlbada": lambda r: torch.where(
        r > 0, r * (r + 1.0) / (r * r + 1.0), torch.zeros_like(r)),
    "MUSCL": lambda r: torch.clamp(
        torch.minimum(torch.minimum(2.0 * r, 0.5 * (r + 1.0)),
                      torch.full_like(r, 2.0)), min=0.0),
    "OSPRE": lambda r: torch.where(
        r > 0, 1.5 * r * (r + 1.0) / (r * r + r + 1.0), torch.zeros_like(r)),
    "QUICK": lambda r: torch.clamp((3.0 + r) / 4.0, 0.0, 2.0),
    "UMIST": lambda r: torch.clamp(
        torch.minimum(torch.minimum(2.0 * r, 0.25 + 0.75 * r),
                      torch.clamp(0.75 + 0.25 * r, max=2.0)), min=0.0),
}


def limited_linear(k: float) -> Callable:
    two_by_k = 2.0 / max(k, 1e-6)
    return lambda r: torch.clamp(two_by_k * r, 0.0, 1.0)


def _safe_den(x):
    """x where |x| > 1e-30, else +-1e-30 by the sign of x (0 -> +)."""
    tiny = torch.where(x >= 0, torch.full_like(x, 1e-30),
                       torch.full_like(x, -1e-30))
    return torch.where(torch.abs(x) > 1e-30, x, tiny)


def _tvd_r(mesh, phi_i: Any, field: VolField) -> Any:
    """TVD ratio r on internal faces."""
    nif = mesh.n_internal_faces
    own = mesh.owner[:nif]
    nei = mesh.neighbour
    data = field.data
    d = mesh.c[nei] - mesh.c[own]
    g = fvc.grad(mesh, field)  # [nC,3] or [nC,3,3]
    upwind_is_owner = phi_i >= 0
    gradf = data[nei] - data[own]
    if data.ndim == 1:
        g_up = torch.where(upwind_is_owner[:, None], g[own], g[nei])
        ud = 2.0 * torch.sum(d * g_up, dim=1)
        return ud / _safe_den(gradf) - 1.0
    g_up = torch.where(upwind_is_owner[:, None, None], g[own], g[nei])
    dg = torch.einsum("fi,fij->fj", d, g_up)  # [nIf,3]
    num = 2.0 * torch.sum(dg * gradf, dim=1)
    den = torch.sum(gradf * gradf, dim=1)
    return num / torch.clamp(den, min=1e-30) - 1.0


def _limiter_fn(scheme: str):
    """Resolve the scheme keyword to (limiter_fn | None, simple kind |
    None); simple kinds are 'linear', 'upwind' and 'midPoint'."""
    parts = scheme.split()
    name = parts[0]
    # V-variants apply one limiter to all components (the reference's
    # formulation: same face weights as the scalar scheme)
    if name.endswith("V") and (name[:-1] in _LIMITERS
                               or name[:-1] == "limitedLinear"):
        name = name[:-1]
    if name == "linearUpwind":
        # the reference maps linearUpwind to limitedLinear 1
        name, parts = "limitedLinear", ["limitedLinear", "1"]
    if name in ("linear", "upwind", "midPoint"):
        return None, name
    if name == "limitedLinear":
        k = float(parts[1]) if len(parts) > 1 else 1.0
        return limited_linear(k), None
    if name in _LIMITERS:
        return _LIMITERS[name], None
    raise NotImplementedError(
        f"interpolation scheme {scheme!r} is not ported to foamtpu_torch "
        "yet")


def weights(mesh, phi: Any, scheme: str,
            field: Optional[VolField] = None) -> Any:
    """Owner-side interpolation weights on INTERNAL faces for the named
    divScheme interpolation keyword."""
    nif = mesh.n_internal_faces
    phi_i = phi[:nif]
    w_cd = mesh.weights[:nif]
    w_ud = (phi_i >= 0).to(w_cd.dtype)
    lam_fn, simple = _limiter_fn(scheme)
    if simple == "linear":
        return w_cd
    if simple == "upwind":
        return w_ud
    if simple == "midPoint":
        return torch.full_like(w_cd, 0.5)
    if field is None:
        raise ValueError(f"scheme {scheme!r} needs the transported field")
    r = _tvd_r(mesh, phi_i, field)
    lam = torch.clamp(lam_fn(r), 0.0, 2.0).to(w_cd.dtype)
    return lam * w_cd + (1.0 - lam) * w_ud


def register_limiter(name: str, fn: Callable) -> None:
    _LIMITERS[name] = fn


def _upwind_self(phi_out, sign):
    """1 where the flux leaves the cell (self is upwind); the phi==0 tie
    goes to the owner side so both copies of a face agree."""
    return ((phi_out > 0).to(phi_out.dtype)
            + ((phi_out == 0) & (sign > 0)).to(phi_out.dtype))


def weights_slot(mesh, phi_slot, scheme: str,
                 field: Optional[VolField] = None):
    """Self-side interpolation weights in SLOT form: (wself [nC,M],
    fb_wself [nfb]) with vf = wself*psi_self + (1-wself)*psi_nbr. Both
    sides of a face compute the same value (r is invariant under the
    side flip since d, gradf and the upwind-cell choice flip together)."""
    lam_fn, simple = _limiter_fn(scheme)
    dt = mesh.v.dtype
    if simple == "linear":
        return mesh.st_wself, mesh.fb_wself
    phi_out = mesh.st_sign * phi_slot.sv       # outward flux per slot
    wud = _upwind_self(phi_out, mesh.st_sign)
    if mesh.fb_cells.shape[0]:
        phi_ofb = mesh.fb_signs * phi_slot.fb
        wud_fb = _upwind_self(phi_ofb, mesh.fb_signs)
    else:
        wud_fb = mesh.fb_wself.new_zeros((0,))
    if simple == "upwind":
        return wud, wud_fb
    if simple == "midPoint":
        return (torch.full_like(mesh.st_wself, 0.5),
                torch.full_like(mesh.fb_wself, 0.5))
    if field is None:
        raise ValueError(f"scheme {scheme!r} needs the transported field")

    data = field.data
    vec = data.ndim == 2
    g = fvc.grad(mesh, field)                  # [nC,3] or [nC,3,3]
    d = slot_mod.nbr_values(mesh, mesh.c) - mesh.c[:, None, :]  # [nC,M,3]
    gradf = slot_mod.delta(mesh, data)         # nbr - self per slot
    self_up = phi_out > 0                      # [nC,M]
    g_nb = slot_mod.nbr_values(mesh, g)
    if vec:
        g_up = torch.where(self_up[:, :, None, None], g[:, None], g_nb)
        dg = torch.einsum("cmi,cmij->cmj", d, g_up)       # [nC,M,C]
        num = 2.0 * torch.sum(dg * gradf.sv, dim=2)
        den = torch.sum(gradf.sv * gradf.sv, dim=2)
        r = num / torch.clamp(den, min=1e-30) - 1.0
    else:
        g_up = torch.where(self_up[:, :, None], g[:, None], g_nb)
        ud = 2.0 * torch.sum(d * g_up, dim=2)
        r = ud / _safe_den(gradf.sv) - 1.0
    lam = torch.clamp(lam_fn(r), 0.0, 2.0).to(dt)
    wself = lam * mesh.st_wself + (1.0 - lam) * wud
    if mesh.fb_cells.shape[0]:
        df = mesh.c[mesh.fb_nbrs] - mesh.c[mesh.fb_cells]
        s_fb, n_fb = data[mesh.fb_cells], data[mesh.fb_nbrs]
        gffb = n_fb - s_fb
        gs, gn = g[mesh.fb_cells], g[mesh.fb_nbrs]
        up_fb = (mesh.fb_signs * phi_slot.fb) > 0
        if vec:
            gu = torch.where(up_fb[:, None, None], gs, gn)
            dgf = torch.einsum("fi,fij->fj", df, gu)
            rf = (2.0 * torch.sum(dgf * gffb, dim=1)
                  / torch.clamp(torch.sum(gffb * gffb, dim=1), min=1e-30)
                  - 1.0)
        else:
            gu = torch.where(up_fb[:, None], gs, gn)
            udf = 2.0 * torch.sum(df * gu, dim=1)
            rf = udf / _safe_den(gffb) - 1.0
        lamf = torch.clamp(lam_fn(rf), 0.0, 2.0).to(dt)
        fb_wself = lamf * mesh.fb_wself + (1.0 - lamf) * wud_fb
    else:
        fb_wself = mesh.fb_wself.new_zeros((0,))
    return wself, fb_wself
