"""Derived boundary conditions, batch 2 (port of
openfoam-2.2.x_tpu/bc/derived2.py).

Derived BCs of src/finiteVolume/fields/fvPatchFields/derived/ and the
RAS wall functions in the data-driven mixed form of bc/patchfields.py:
each kind supplies value coefficients and, where the reference's
updateCoeffs() reads solver state, an update rule over the context the
solvers pass (phi, U, k, nu, t, ...).

Kinds: partialSlip, fixedNormalSlip, inletOutletTotalTemperature,
outletMappedUniformInlet, turbulentInlet,
rotatingPressureInletOutletVelocity, rotatingTotalPressure,
nutUSpaldingWallFunction (Spalding's law by six Newton steps,
nutUSpaldingWallFunction::calcUTau), nutkRoughWallFunction,
alphatJayatillekeWallFunction, and the time-table kinds
uniformFixedValueT (`_table_interp`) and oscillatingFixedValueT. The
factory (bc/factory.py) builds translatingWallVelocity,
freestreamPressure, uniformTotalPressure and the atmBoundaryLayer pair
on the kinds of bc/patchfields.py, as the reference does.

One departure: turbulentInlet's noise. The reference draws a
deterministic per-face hash of (face index, time); the port draws
uniform numbers from an explicit torch.Generator on the field's device,
seeded by the BC's `seed` and the time. Both lie in [-0.5, 0.5) with
mean 0, and the tests hold those bounds, not the stream.
"""

from __future__ import annotations

import math

import torch

from . import patchfields as pf
from .patchfields import (_bcast, _col, _patch_internal, _patch_normals,
                          _vc_fixed_value, _vc_mixed)

_KAPPA = 0.41
_E = 9.8


# ---------------------------------------------------------------------------
# slip-family vector BCs
# ---------------------------------------------------------------------------


def _vc_partial_slip(bc, mesh, patch, vi):
    """partialSlip: the blend of noSlip (fraction f = valueFraction) and
    slip (1-f), vf = (1-f) * (vi - n (n.vi))."""
    if vi.ndim == 1:
        f = _bcast(bc.vfrac, vi)
        return (1.0 - f), torch.zeros_like(vi)
    n = _patch_normals(mesh, patch).to(vi.dtype)
    f = _col(_bcast(bc.vfrac, vi[..., 0]), vi)
    vic = (1.0 - f) * (1.0 - n * n)
    vf = (1.0 - f) * (vi - n * torch.sum(n * vi, dim=1, keepdim=True))
    return vic, vf - vic * vi


def _vc_fixed_normal_slip(bc, mesh, patch, vi):
    """fixedNormalSlip: the normal component fixed to (n.refValue) n,
    the tangential one slips: vf = n (n.rv) + (vi - n (n.vi))."""
    rv = _bcast(bc.ref_value, vi)
    if vi.ndim == 1:
        return torch.zeros_like(vi), rv
    n = _patch_normals(mesh, patch).to(vi.dtype)
    vic = 1.0 - n * n
    vf = n * torch.sum(n * rv, dim=1, keepdim=True) \
        + vi - n * torch.sum(n * vi, dim=1, keepdim=True)
    return vic, vf - vic * vi


# ---------------------------------------------------------------------------
# inlet/outlet derived updates
# ---------------------------------------------------------------------------


def _up_inlet_outlet_total_T(bc, mesh, patch, internal, *, phi=None,
                             U=None, **ctx):
    """inletOutletTotalTemperature: zeroGradient on outflow; on inflow
    the static temperature from the reservoir total temperature,
    T = T0 - |U|^2 / (2 Cp) (the reference's low-Mach form)."""
    if phi is None:
        return bc
    phib = phi[patch.slice]
    t0 = bc.ref_grad  # T0 staged per face at parse
    cp = float(bc.opt("Cp", 1005.0))
    if U is not None:
        magU2 = torch.sum(U[mesh.owner[patch.slice]] ** 2, dim=1)
    else:
        magU2 = 0.0
    tval = t0 - 0.5 * magU2 / cp
    return bc.replace(ref_value=tval,
                      vfrac=(phib < 0.0).to(internal.dtype))


def _up_outlet_mapped_uniform_inlet(bc, mesh, patch, internal, **ctx):
    """outletMappedUniformInlet: the inlet value is the area-weighted
    average of the field over the named outlet patch, times fraction."""
    start = int(bc.opt("out_start", -1))
    size = int(bc.opt("out_size", 0))
    if start < 0 or size == 0:
        return bc
    frac = float(bc.opt("fraction", 1.0))
    cells = mesh.owner[start:start + size]
    w = mesh.mag_sf[start:start + size]
    vals = internal[cells]
    if vals.ndim == 2:
        mean = torch.sum(vals * w[:, None], dim=0) / torch.clamp(
            torch.sum(w), min=1e-30)
        rv = torch.broadcast_to(frac * mean, (patch.size, vals.shape[1]))
    else:
        mean = torch.sum(vals * w) / torch.clamp(torch.sum(w), min=1e-30)
        rv = torch.broadcast_to(frac * mean, (patch.size,))
    return bc.replace(ref_value=rv, vfrac=internal.new_ones(patch.size))


def _noise(n, t, seed, like):
    """n uniform numbers in [-0.5, 0.5) from a generator on `like`'s
    device, seeded by (seed, t)."""
    g = torch.Generator(device=like.device)
    g.manual_seed((int(seed) * 1000003
                   + int(round(float(t) * 1e6))) % (2 ** 63 - 1))
    return torch.rand(n, generator=g, device=like.device,
                      dtype=like.dtype) - 0.5


def _up_turbulent_inlet(bc, mesh, patch, internal, *, t=None, **ctx):
    """turbulentInlet: the reference value with a superimposed random
    fluctuation, v = ref + fluctuationScale * |ref| * r, r uniform in
    [-0.5, 0.5), one draw per face for every component (the draw: see
    the module docstring)."""
    rv = bc.ref_grad  # the clean reference field staged at parse
    scale = bc.opt("fluctuationScale", 0.0)
    r = _noise(patch.size, 0.0 if t is None else t, bc.opt("seed", 0),
               internal)
    if rv.ndim == 2:
        sc = torch.as_tensor(scale, dtype=internal.dtype,
                             device=internal.device).reshape(-1)
        fluct = sc[None, :] * torch.abs(rv) * r[:, None]
    else:
        fluct = float(torch.as_tensor(scale).reshape(-1)[0]) \
            * torch.abs(rv) * r
    return bc.replace(ref_value=rv + fluct)


def _up_rotating_pio_velocity(bc, mesh, patch, internal, *, phi=None,
                              **ctx):
    """rotatingPressureInletOutletVelocity: pressureInletOutletVelocity
    whose tangential component is the frame velocity -omega x r on
    inflow faces."""
    if phi is None:
        return bc
    phib = phi[patch.slice]
    n = _patch_normals(mesh, patch)
    un = (phib / torch.clamp(mesh.mag_sf[patch.slice], min=1e-30)
          )[:, None] * n
    utan = bc.ref_grad  # -omega x r staged per face at parse
    utan = utan - n * torch.sum(n * utan, dim=1, keepdim=True)
    f = (phib < 0.0).to(internal.dtype)
    return bc.replace(ref_value=un + utan,
                      vfrac=torch.broadcast_to(f[:, None], un.shape))


def _up_rotating_total_pressure(bc, mesh, patch, internal, *, phi=None,
                                U=None, rho_b=None, **ctx):
    """rotatingTotalPressure: totalPressure in the rotating frame,
    p0_eff = p0 - 0.5 |omega x r|^2 (incompressible form), staged per
    face in ref_grad at parse."""
    if phi is None or U is None:
        return bc
    phib = phi[patch.slice]
    p0 = bc.ref_grad
    cells = mesh.owner[patch.slice]
    magU2 = torch.sum(U[cells] ** 2, dim=1)
    if rho_b is not None:
        magU2 = magU2 * rho_b[cells]
    pval = torch.where(phib > 0.0, p0, p0 - 0.5 * magU2)
    return bc.replace(ref_value=pval, vfrac=torch.ones_like(pval))


# ---------------------------------------------------------------------------
# wall functions
# ---------------------------------------------------------------------------


def _spalding_utau(magU, y, nu, n_newton: int = 6):
    """u_tau from y+ = u+ + 1/E [exp(k u+) - 1 - k u+ - (k u+)^2/2 -
    (k u+)^3/6], with y+ = utau y/nu and u+ = magU/utau."""
    re = torch.clamp(magU * y / nu, min=2.0)
    utau = torch.maximum(
        torch.sqrt(torch.clamp(magU * nu / y, min=1e-30)),   # viscous
        _KAPPA * magU / torch.log(_E * re))                  # log estimate
    for _ in range(n_newton):
        ut = torch.clamp(utau, min=1e-12)
        up = magU / ut
        kup = torch.clamp(_KAPPA * up, max=50.0)
        ekup = torch.exp(kup)
        f = (-ut * y / nu + up
             + (ekup - 1.0 - kup - 0.5 * kup ** 2 - kup ** 3 / 6.0) / _E)
        df = (y / nu
              + magU / ut ** 2
              + (kup / ut) * (ekup - 1.0 - kup - 0.5 * kup ** 2) / _E)
        utau = torch.clamp(ut + f / torch.clamp(df, min=1e-30), min=0.0)
    return utau


def _up_nut_spalding(bc, mesh, patch, internal, *, U=None, nu=None,
                     **ctx):
    """nutUSpaldingWallFunction (wallFunctions/nutWallFunctions/
    nutUSpaldingWallFunction/)."""
    if U is None or nu is None:
        return bc
    cells = mesh.owner[patch.slice]
    y = 1.0 / torch.clamp(mesh.delta_coeffs[patch.slice], min=1e-30)
    n = _patch_normals(mesh, patch)
    Uc = U[cells]
    Ut = Uc - n * torch.sum(n * Uc, dim=1, keepdim=True)
    magU = torch.clamp(torch.linalg.norm(Ut, dim=1), min=1e-12)
    utau = _spalding_utau(magU, y, nu)
    nutw = torch.clamp(utau ** 2 * y / magU - nu, min=0.0)
    return bc.replace(ref_value=nutw, vfrac=torch.ones_like(nutw))


def _up_nutk_rough(bc, mesh, patch, internal, *, k=None, nu=None, **ctx):
    """nutkRoughWallFunction: the log-law E reduced by the roughness
    function fn = 1 + Cs Ks+ above the reference's transitional limit
    Ks+ = 2.25."""
    if k is None or nu is None:
        return bc
    Ks = float(bc.opt("Ks", 0.0))
    Cs = float(bc.opt("Cs", 0.5))
    cells = mesh.owner[patch.slice]
    y = 1.0 / torch.clamp(mesh.delta_coeffs[patch.slice], min=1e-30)
    kc = torch.clamp(k[cells], min=1e-10)
    ustar = (0.09 ** 0.25) * torch.sqrt(kc)
    ypl = ustar * y / nu
    kspl = ustar * Ks / nu
    fn = torch.where(kspl > 2.25, 1.0 + Cs * kspl, torch.ones_like(kspl))
    edash = _E / fn
    nutw = nu * (ypl * _KAPPA
                 / torch.log(torch.clamp(edash * ypl, min=1.001 + 1e-4))
                 - 1.0)
    nutw = torch.where(ypl > 11.0, torch.clamp(nutw, min=0.0),
                       torch.zeros_like(nutw))
    return bc.replace(ref_value=nutw, vfrac=torch.ones_like(nutw))


def _up_alphat_jayatilleke(bc, mesh, patch, internal, *, nut=None,
                           nu=None, **ctx):
    """alphatJayatillekeWallFunction: the turbulent thermal diffusivity
    at the wall from the thermal log law with Jayatilleke's P-function,
    in its high-y+ limit (kinematic alphat [m^2/s])."""
    if nut is None or nu is None:
        return bc
    Prt = float(bc.opt("Prt", 0.85))
    Pr = float(bc.opt("Pr", 0.7))
    P = 9.24 * ((Pr / Prt) ** 0.75 - 1.0) \
        * (1.0 + 0.28 * math.exp(-0.007 * Pr / Prt))
    nutw = nut
    if torch.is_tensor(nut) and nut.ndim and nut.shape[0] == mesh.n_faces:
        nutw = nut[patch.slice]
    nutw = torch.as_tensor(nutw, dtype=internal.dtype,
                           device=internal.device)
    if nutw.ndim == 0:
        nutw = torch.full((patch.size,), float(nutw), dtype=internal.dtype,
                          device=internal.device)
    alphat = nutw / Prt * (1.0 / (1.0 + P * Prt
                                  / torch.clamp(nutw / nu, min=1e-3)))
    return bc.replace(ref_value=alphat, vfrac=torch.ones_like(alphat))


# ---------------------------------------------------------------------------
# time-table updates for uniformFixedValue / oscillatingFixedValue
# ---------------------------------------------------------------------------


def _table_interp(table, t, like):
    """Linear interpolation of `table` ((t, v), ...) at time t, clamped
    at its ends, in `like`'s dtype on its device."""
    kw = dict(dtype=like.dtype, device=like.device)
    ts = torch.tensor([row[0] for row in table], **kw)
    vs = torch.tensor([row[1] for row in table], **kw)
    tt = torch.clamp(torch.as_tensor(t, **kw), ts[0], ts[-1])
    i = torch.clamp(torch.searchsorted(ts, tt.reshape(1), right=True)[0]
                    - 1, 0, ts.shape[0] - 2)
    w = (tt - ts[i]) / torch.clamp(ts[i + 1] - ts[i], min=1e-30)
    return (1.0 - w) * vs[i] + w * vs[i + 1]


def _up_uniform_fixed_value(bc, mesh, patch, internal, *, t=None, **ctx):
    """uniformFixedValue's `table` form: the value sampled again at the
    current time (uniformFixedValueFvPatchField with a DataEntry
    table)."""
    table = bc.opt("table")
    if table is None or t is None:
        return bc
    v = _table_interp(table, t, internal)
    return bc.replace(ref_value=torch.broadcast_to(
        v, (patch.size,) + tuple(v.shape)))


def _up_oscillating_fixed_value(bc, mesh, patch, internal, *, t=None,
                                **ctx):
    """oscillatingFixedValue: value = ref (1 + amplitude sin(2 pi f t))."""
    if t is None:
        return bc
    amp = float(bc.opt("amplitude", 0.0))
    freq = float(bc.opt("frequency", 0.0))
    rv = bc.ref_grad  # the clean refValue staged at parse
    s = 1.0 + amp * torch.sin(2.0 * math.pi * freq * torch.as_tensor(
        t, dtype=internal.dtype, device=internal.device))
    return bc.replace(ref_value=rv * s)


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------

pf.register_value_coeffs("partialSlip", _vc_partial_slip)
pf.register_value_coeffs("fixedNormalSlip", _vc_fixed_normal_slip)
pf.register_value_coeffs("inletOutletTotalTemperature", _vc_mixed)
pf.register_value_coeffs("outletMappedUniformInlet", _vc_fixed_value)
pf.register_value_coeffs("turbulentInlet", _vc_fixed_value)
pf.register_value_coeffs("nutUSpaldingWallFunction", _vc_fixed_value)
pf.register_value_coeffs("nutkRoughWallFunction", _vc_fixed_value)
pf.register_value_coeffs("alphatJayatillekeWallFunction", _vc_fixed_value)
pf.register_value_coeffs("rotatingPressureInletOutletVelocity", _vc_mixed)
pf.register_value_coeffs("rotatingTotalPressure", _vc_mixed)
pf.register_value_coeffs("uniformFixedValueT", _vc_fixed_value)
pf.register_value_coeffs("oscillatingFixedValueT", _vc_fixed_value)

pf.register_update("inletOutletTotalTemperature", _up_inlet_outlet_total_T)
pf.register_update("outletMappedUniformInlet",
                   _up_outlet_mapped_uniform_inlet)
pf.register_update("turbulentInlet", _up_turbulent_inlet)
pf.register_update("nutUSpaldingWallFunction", _up_nut_spalding)
pf.register_update("nutkRoughWallFunction", _up_nutk_rough)
pf.register_update("alphatJayatillekeWallFunction", _up_alphat_jayatilleke)
pf.register_update("rotatingPressureInletOutletVelocity",
                   _up_rotating_pio_velocity)
pf.register_update("rotatingTotalPressure", _up_rotating_total_pressure)
pf.register_update("uniformFixedValueT", _up_uniform_fixed_value)
pf.register_update("oscillatingFixedValueT", _up_oscillating_fixed_value)
