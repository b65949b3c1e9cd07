"""Derived boundary conditions, batch 4 (port of
openfoam-2.2.x_tpu/bc/derived4.py), in the data-driven mixed form of
bc/patchfields.py:

  alphaContactAngle (constantAlphaContactAngle, dynamicAlphaContactAngle:
    zeroGradient on alpha; the angle acts in
    models/interface.py::_correct_contact_angle)
  maxwellSlipU       rarefied tangential slip (rhoCentralFoam's wall BC)
  smoluchowskiJumpT  its temperature-jump partner
  fixedRho           rho_b = psi * p_b (rhoCentralFoam/BCs/rho/fixedRho)
  fanPressure        totalPressure less a fan curve at the patch flow
  syringePressure    isothermal gas compression under a trapezoidal
                     piston-speed profile (no leakage, as the reference)
  pressureInletOutletParSlipVelocity  tangential slip kept on inflow,
                     zeroGradient on outflow

As in the reference, the maxwellSlipU and pressureInletOutletParSlipVelocity
rules and fanPressure's p0 take `internal` as the patch's own values.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import patchfields as pf
from .patchfields import (_bcast, _patch_normals, _vc_fixed_gradient,
                          _vc_mixed)

# kind "alphaContactAngle": opts carry theta0 [rad] (and uTheta, thetaA,
# thetaR for the dynamic variant); zeroGradient for the transport
pf.register_value_coeffs("alphaContactAngle", _vc_fixed_gradient)


def _tensor(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# rarefied-gas wall BCs (rhoCentralFoam)
# ---------------------------------------------------------------------------


def _up_maxwell_slip_u(bc, mesh, patch, internal, *, nu=None, T_b=None,
                       p_b=None, **ctx):
    """maxwellSlipU: the tangential value blended between the interior
    and the wall, f = 1/(1 + C lambda deltaCoeff), C = 2(2-sigma)/sigma,
    with the mean free path from the dictionary or lambda = nu
    sqrt(pi/(2 R T)); the normal component is the wall's."""
    sl = patch.slice
    n = _patch_normals(mesh, patch)
    dc = mesh.delta_coeffs[sl]
    sigma = float(bc.opt("accommodationCoeff", 1.0))
    lam = bc.opt("lambda", None)
    if lam is None:
        R = float(bc.opt("R", 287.0))
        if nu is not None and T_b is not None:
            nu_p = nu[mesh.owner[sl]] if torch.is_tensor(nu) \
                and nu.ndim == 1 else nu
            lam = nu_p * torch.sqrt(math.pi / (2.0 * R * torch.clamp(
                T_b, min=1.0)))
        else:
            lam = 1e-7
    C = 2.0 * (2.0 - sigma) / max(sigma, 1e-6)
    f = 1.0 / (1.0 + C * _tensor(lam, internal) * dc)
    uw = _bcast(bc.opt("Uwall", (0.0, 0.0, 0.0)), internal)
    ui = internal
    ui_t = ui - torch.sum(ui * n, dim=1, keepdim=True) * n
    uw_n = torch.sum(uw * n, dim=1, keepdim=True) * n
    ref = uw_n + (1.0 - f)[:, None] * ui_t \
        + f[:, None] * (uw - torch.sum(uw * n, dim=1, keepdim=True) * n)
    return bc.replace(ref_value=ref, vfrac=internal.new_ones(patch.size))


def _up_smoluchowski_jump_t(bc, mesh, patch, internal, *, nu=None,
                            p_b=None, **ctx):
    """smoluchowskiJumpT: T_w' = (1-f) T_c + f T_wall,
    f = 1/(1 + C lambda deltaCoeff),
    C = 2(2-sigmaT)/sigmaT * 2 gamma/((gamma+1) Pr)."""
    dc = mesh.delta_coeffs[patch.slice]
    sigma = float(bc.opt("accommodationCoeff", 1.0))
    gamma = float(bc.opt("gamma", 1.4))
    Pr = float(bc.opt("Pr", 0.72))
    lam = bc.opt("lambda", 1e-7)
    C = (2.0 * (2.0 - sigma) / max(sigma, 1e-6)
         * 2.0 * gamma / ((gamma + 1.0) * Pr))
    f = 1.0 / (1.0 + C * _tensor(lam, internal) * dc)
    tw = _bcast(bc.opt("Twall", 300.0), internal)
    return bc.replace(ref_value=tw, vfrac=f)


def _up_fixed_rho(bc, mesh, patch, internal, *, p_b=None, psi_b=None,
                  **ctx):
    """fixedRho: rho_b = psi * p_b; the stored value stands until the
    solver provides p."""
    if p_b is None:
        return bc
    psi = psi_b if psi_b is not None else float(bc.opt("psi", 1e-5))
    pb = p_b[patch.slice] if torch.is_tensor(p_b) and p_b.ndim \
        and p_b.shape[0] == mesh.n_faces else p_b
    return bc.replace(ref_value=psi * pb,
                      vfrac=internal.new_ones(patch.size))


# ---------------------------------------------------------------------------
# fanPressure
# ---------------------------------------------------------------------------


def _interp(x, xs, ys):
    """numpy's interp (constant outside the table), as the reference's
    jnp.interp evaluates it."""
    i = torch.clamp(torch.searchsorted(xs, x.reshape(1), right=True)[0],
                    1, xs.shape[0] - 1)
    dx = xs[i] - xs[i - 1]
    eps = float(np.spacing(np.finfo(
        np.float64 if xs.dtype == torch.float64 else np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, ys[i - 1], ys[i - 1] + ((x - xs[i - 1])
                    / torch.where(dx0, torch.ones_like(dx), dx))
                    * (ys[i] - ys[i - 1]))
    f = torch.where(x < xs[0], ys[0], f)
    return torch.where(x > xs[-1], ys[-1], f)


def _up_fan_pressure(bc, mesh, patch, internal, *, phi=None, U=None,
                     rho_b=None, **ctx):
    """fanPressure: the total pressure less the fan curve dp(Q) at the
    patch's volumetric flow (direction `in`: the fan blows into the
    domain, Q = -sum phi), through the totalPressure closure (p = p0_eff
    on outflow, p0_eff - 0.5 (rho)|U|^2 on inflow)."""
    if phi is None:
        return bc
    sl = patch.slice
    sgn = -1.0 if str(bc.opt("direction", "in")) == "in" else 1.0
    vdot = sgn * torch.sum(phi[sl])
    tbl = bc.opt("fanCurve")
    if tbl is not None:
        xs = _tensor(tbl.a[:, 0], internal)
        ys = _tensor(tbl.a[:, 1], internal)
        dp = _interp(torch.clamp(vdot, min=0.0), xs, ys)
    else:
        dp = 0.0
    p0 = _bcast(bc.opt("p0", 0.0), internal)
    p0_eff = p0 + dp * (1.0 if sgn < 0 else -1.0)
    ones = internal.new_ones(patch.size)
    if U is None:
        return bc.replace(ref_value=p0_eff, vfrac=ones)
    phib = phi[sl]
    cells = mesh.owner[sl]
    magU2 = torch.sum(U[cells] * U[cells], dim=1)
    if rho_b is not None:
        magU2 = magU2 * rho_b[cells]
    pval = torch.where(phib > 0.0, p0_eff, p0_eff - 0.5 * magU2)
    return bc.replace(ref_value=pval, vfrac=ones)


# ---------------------------------------------------------------------------
# syringePressure
# ---------------------------------------------------------------------------


def _syringe_volume(bc, t):
    """Gas volume in the syringe at time t (a tensor) under the
    reference's trapezoidal piston-speed profile (Ap piston area, Sp
    maximum speed, ramp-up [tas, tae], ramp-down [tds, tde], initial
    VsI)."""
    Ap = float(bc.opt("Ap", 1e-4))
    Sp = float(bc.opt("Sp", 0.1))
    VsI = float(bc.opt("VsI", 1e-5))
    tas = float(bc.opt("tas", 0.0))
    tae = float(bc.opt("tae", 0.0))
    tds = float(bc.opt("tds", 1e30))
    tde = float(bc.opt("tde", 1e30))
    # the integral of the speed fraction: 0 before tas, 0 -> 1 on
    # [tas, tae], 1 on [tae, tds], 1 -> 0 on [tds, tde]
    t1 = torch.clamp(t, tas, tae)
    up = (t1 - tas) ** 2 / (2.0 * max(tae - tas, 1e-30))
    mid = torch.clamp(t, tae, tds) - tae
    t3 = torch.clamp(t, tds, tde)
    dn = (t3 - tds) - (t3 - tds) ** 2 / (2.0 * max(tde - tds, 1e-30))
    return VsI - Ap * Sp * (up + mid + dn)


def _up_syringe_pressure(bc, mesh, patch, internal, *, t=None, **ctx):
    """syringePressure: isothermal compression p(t) = psI VsI / Vs(t)."""
    if t is None:
        return bc
    psI = float(bc.opt("psI", 1e5))
    VsI = float(bc.opt("VsI", 1e-5))
    Vs = torch.clamp(_syringe_volume(bc, _tensor(t, internal)),
                     min=1e-12)
    p = psI * VsI / Vs
    return bc.replace(
        ref_value=torch.broadcast_to(
            p, (patch.size,) + tuple(internal.shape[1:])).clone(),
        vfrac=internal.new_ones(patch.size))


# ---------------------------------------------------------------------------
# pressureInletOutletParSlipVelocity
# ---------------------------------------------------------------------------


def _up_pressure_io_par_slip(bc, mesh, patch, internal, *, phi=None,
                             **ctx):
    """pressureInletOutletParSlipVelocity: zeroGradient on outflow; on
    inflow the normal component from the flux, the interior's
    tangential (slip) component kept."""
    if phi is None:
        return bc
    sl = patch.slice
    mag = torch.clamp(mesh.mag_sf[sl], min=1e-30)
    n = mesh.sf[sl] / mag[:, None]
    ui = internal
    ui_t = ui - torch.sum(ui * n, dim=1, keepdim=True) * n
    u_in = ui_t + (phi[sl] / mag)[:, None] * n
    return bc.replace(ref_value=u_in,
                      vfrac=(phi[sl] < 0.0).to(internal.dtype))


pf.register_value_coeffs("maxwellSlipU", _vc_mixed)
pf.register_value_coeffs("smoluchowskiJumpT", _vc_mixed)
pf.register_value_coeffs("fixedRho", _vc_mixed)
pf.register_value_coeffs("fanPressure", _vc_mixed)
pf.register_value_coeffs("syringePressure", _vc_mixed)
pf.register_value_coeffs("pressureInletOutletParSlipVelocity", _vc_mixed)

pf.register_update("maxwellSlipU", _up_maxwell_slip_u)
pf.register_update("smoluchowskiJumpT", _up_smoluchowski_jump_t)
pf.register_update("fixedRho", _up_fixed_rho)
pf.register_update("fanPressure", _up_fan_pressure)
pf.register_update("syringePressure", _up_syringe_pressure)
pf.register_update("pressureInletOutletParSlipVelocity",
                   _up_pressure_io_par_slip)
