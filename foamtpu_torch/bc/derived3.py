"""Derived boundary conditions, batch 3 (port of
openfoam-2.2.x_tpu/bc/derived3.py).

Derived BCs of src/finiteVolume/fields/fvPatchFields/derived/ in the
data-driven mixed form of bc/patchfields.py: advective,
uniformFixedGradient (its table form as uniformFixedGradientT),
pressureInletUniformVelocity, pressureNormalInletOutletVelocity,
variableHeightFlowRateInletVelocity, fixedShearStress, buoyantPressure,
turbulentHeatFluxTemperature, fixedPressureCompressibleDensity and
timeVaryingMappedFixedValue. The factory builds
uniformDensityHydrostaticPressure (a fixed value) and
fixedInternalValue (zeroGradient) from them, as the reference does.

timeVaryingMappedFixedValue reads constant/boundaryData/<patch>/ on the
host once (`load_boundary_data`, a copy of the reference's: each time
row mapped to the faces by the nearest sample point); the rows are kept
on the field's device, and the update interpolates between the two that
bracket the time.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import patchfields as pf
from .derived2 import _table_interp
from .patchfields import (_col, _patch_internal, _patch_normals,
                          _up_wave_transmissive, _vc_fixed_gradient,
                          _vc_fixed_value, _vc_mixed)


class _Frozen:
    """Hashable-by-identity wrapper so that large tables can live in a
    BC's opts tuple (the reference's wrapper keeps them out of its
    jaxpr's static structure; here it keeps opts cheap to compare)."""

    __slots__ = ("a",)

    def __init__(self, a):
        self.a = a

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


# ---------------------------------------------------------------------------
# advective (the waveTransmissive base class, wave speed = |Un| only)
# ---------------------------------------------------------------------------


def _up_advective(bc, mesh, patch, internal, *, phi=None, dt=None,
                  **ctx):
    """advective: the outgoing-characteristic outflow at the material
    speed |Un| (the acoustic term is waveTransmissive's addition)."""
    ctx.pop("c_sound", None)
    return _up_wave_transmissive(bc, mesh, patch, internal, phi=phi,
                                 dt=dt, c_sound=None, **ctx)


# ---------------------------------------------------------------------------
# pressure-driven velocity inlets
# ---------------------------------------------------------------------------


def _normals_mag(mesh, patch):
    mag = torch.clamp(mesh.mag_sf[patch.slice], min=1e-30)
    return mesh.sf[patch.slice] / mag[:, None], mag


def _up_pressure_inlet_uniform_velocity(bc, mesh, patch, internal, *,
                                        phi=None, **ctx):
    """pressureInletUniformVelocity: the patch average of the flux
    velocity, applied uniformly along the face normals."""
    if phi is None:
        return bc
    n, mag = _normals_mag(mesh, patch)
    u_avg = torch.sum(phi[patch.slice]) / torch.sum(mag)
    return bc.replace(ref_value=u_avg * n,
                      vfrac=internal.new_ones(patch.size))


def _up_pressure_normal_io_velocity(bc, mesh, patch, internal, *,
                                    phi=None, **ctx):
    """pressureNormalInletOutletVelocity: zeroGradient on outflow; on
    inflow the flux magnitude along the face normal."""
    if phi is None:
        return bc
    n, mag = _normals_mag(mesh, patch)
    phib = phi[patch.slice]
    return bc.replace(ref_value=(phib / mag)[:, None] * n,
                      vfrac=(phib < 0.0).to(internal.dtype))


def _up_variable_height_flow_rate_inlet(bc, mesh, patch, internal, *,
                                        alpha_b=None, **ctx):
    """variableHeightFlowRateInletVelocity: the prescribed volumetric
    flow rate spread over the wetted (alpha-weighted) part of the patch,
    U = -n flowRate alpha_f / sum(alpha_f |Sf|)."""
    q = float(bc.opt("flowRate", 0.0))
    n, mag = _normals_mag(mesh, patch)
    if alpha_b is None:
        a = internal.new_ones(patch.size)
    else:
        a = torch.clamp(alpha_b[patch.slice], 0.0, 1.0)
    denom = torch.clamp(torch.sum(a * mag), min=1e-30)
    return bc.replace(ref_value=(-q * a / denom)[:, None] * n,
                      vfrac=internal.new_ones(patch.size))


# ---------------------------------------------------------------------------
# wall stress / pressure gradients
# ---------------------------------------------------------------------------


def _up_fixed_shear_stress(bc, mesh, patch, internal, *, nu=None,
                           nut_b=None, **ctx):
    """fixedShearStress: the wall velocity set so that the tangential
    viscous stress equals the prescribed (kinematic) tau,
    U_f = U_c,t + tau / (nuEff deltaCoeff), nuEff = nu + nut_b when the
    solver supplies the wall nut."""
    tau = bc.opt("tau")
    if tau is None or nu is None:
        return bc
    sl = patch.slice
    vi = _patch_internal(mesh, patch, internal)
    n = _patch_normals(mesh, patch).to(vi.dtype)
    vit = vi - n * torch.sum(n * vi, dim=1, keepdim=True)
    nu_eff = torch.as_tensor(nu, dtype=vi.dtype, device=vi.device)
    if nut_b is not None:
        nu_eff = nu_eff + nut_b[sl]
    tau_v = torch.broadcast_to(torch.as_tensor(
        tau, dtype=vi.dtype, device=vi.device), (patch.size, 3))
    u = vit + tau_v / (_col(nu_eff * mesh.delta_coeffs[sl], tau_v) + 1e-30)
    return bc.replace(ref_value=u, vfrac=vi.new_ones(patch.size))


def _up_buoyant_pressure(bc, mesh, patch, internal, *, rho_b=None,
                         g=None, **ctx):
    """buoyantPressure: fixedGradient with snGrad(p) = rho (g . n), the
    hydrostatic balance at the patch."""
    gv = g if g is not None else bc.opt("g", (0.0, 0.0, -9.81))
    gv = torch.as_tensor(gv, dtype=internal.dtype,
                         device=internal.device).reshape(3)
    gn = _patch_normals(mesh, patch).to(internal.dtype) @ gv
    if rho_b is not None:
        cells = mesh.owner[patch.slice]
        r = rho_b[cells] if rho_b.shape[0] == internal.shape[0] \
            else rho_b[patch.slice]
        gn = gn * r
    else:
        gn = gn * float(bc.opt("rho", 1.0))
    return bc.replace(ref_grad=gn)


def _up_turbulent_heat_flux_T(bc, mesh, patch, internal, *,
                              alpha_eff_b=None, **ctx):
    """turbulentHeatFluxTemperature: fixedGradient from a prescribed
    heat flux, snGrad(T) = q / (rho Cp alphaEff). Mode `flux` gives q
    in W/m^2 per face, mode `power` spreads the total Q over the patch
    area; alphaEff from the solver when supplied, else the
    dictionary's."""
    mode = str(bc.opt("heatSource", "flux"))
    q = float(bc.opt("q", 0.0))
    rho_cp = float(bc.opt("rho", 1.2)) * float(bc.opt("Cp", 1005.0))
    sl = patch.slice
    if mode == "power":
        qf = q / torch.clamp(torch.sum(mesh.mag_sf[sl]), min=1e-30)
    else:
        qf = q
    if alpha_eff_b is not None:
        alpha = alpha_eff_b[sl]
    else:
        alpha = float(bc.opt("alphaEff", 2e-5))
    grad = torch.as_tensor(qf / (rho_cp * alpha), dtype=internal.dtype,
                           device=internal.device)
    return bc.replace(ref_grad=torch.broadcast_to(grad, (patch.size,)))


def _up_fixed_pressure_compressible_density(bc, mesh, patch, internal,
                                            *, p_b=None, **ctx):
    """fixedPressureCompressibleDensity (cavitatingFoam's barotropic
    closure): rho = rho0 + psi (p - p0) from the named pressure."""
    if p_b is None:
        return bc
    sl = patch.slice
    cells = mesh.owner[sl]
    p = p_b[cells] if p_b.shape[0] == internal.shape[0] else p_b[sl]
    rho0 = float(bc.opt("rho0", 1000.0))
    p0 = float(bc.opt("p0", 0.0))
    psi = float(bc.opt("psi", 1e-5))
    return bc.replace(ref_value=rho0 + psi * (p - p0),
                      vfrac=internal.new_ones(patch.size))


# ---------------------------------------------------------------------------
# uniformFixedGradient (table form)
# ---------------------------------------------------------------------------


def _up_uniform_fixed_gradient(bc, mesh, patch, internal, *, t=None,
                               **ctx):
    """uniformFixedGradient's `table` form: the gradient sampled again
    at the current time."""
    table = bc.opt("table")
    if table is None or t is None:
        return bc
    v = _table_interp(table, t, internal)
    return bc.replace(ref_grad=torch.broadcast_to(
        v, (patch.size,) + tuple(v.shape)))


# ---------------------------------------------------------------------------
# timeVaryingMappedFixedValue
# ---------------------------------------------------------------------------


def load_boundary_data(case_dir: str, patch_name: str, field_name: str,
                       cf: np.ndarray):
    """Read constant/boundaryData/<patch>/{points,<time>/<field>} and map
    the sample points to the patch faces by nearest neighbour (host copy
    of the reference's: the reference's triangulated planar
    interpolation is replaced there by the nearest-sample map, exact when
    the sample points are the face centres). Returns (times[nT],
    values[nT, nF(,3)]) as numpy, or None."""
    from ..core.dictionary import parse_string

    root = os.path.join(case_dir, "constant", "boundaryData", patch_name)
    pts_path = os.path.join(root, "points")
    if not os.path.isfile(pts_path):
        return None
    pts = np.asarray(parse_string("v " + open(pts_path).read())["v"],
                     dtype=float).reshape(-1, 3)
    times = sorted(
        (float(d), d) for d in os.listdir(root)
        if os.path.isfile(os.path.join(root, d, field_name)))
    if not times:
        return None
    d2 = ((cf[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    nearest = d2.argmin(axis=1)
    vals = []
    for _, dname in times:
        body = open(os.path.join(root, dname, field_name)).read()
        arr = np.asarray(parse_string("v " + body)["v"], dtype=float)
        if arr.ndim == 2:
            arr = arr.reshape(-1, 3)[nearest]
        else:
            arr = arr.reshape(-1)[nearest]
        vals.append(arr)
    return (np.asarray([t for t, _ in times]), np.stack(vals, axis=0))


def boundary_table(tbl, dtype, device) -> _Frozen:
    """The (times, values) of load_boundary_data as the BC's `tvm` opt:
    the times on the host, the values on `device`."""
    times, values = tbl
    return _Frozen((np.asarray(times, dtype=np.float64),
                    torch.as_tensor(np.asarray(values), dtype=dtype,
                                    device=device)))


def _up_time_varying_mapped(bc, mesh, patch, internal, *, t=None,
                            **ctx):
    """timeVaryingMappedFixedValue: linear interpolation between the two
    boundaryData rows that bracket the solver time (clamped at the
    ends); the bracket and weight are found on the host."""
    tbl = bc.opt("tvm")
    if tbl is None or t is None:
        return bc
    times, values = tbl.a
    npdt = np.float64 if internal.dtype == torch.float64 else np.float32
    ts = times.astype(npdt)
    tt = np.clip(npdt(t), ts[0], ts[-1])
    if ts.shape[0] == 1:
        rv = values[0]
    else:
        i = int(np.clip(np.searchsorted(ts, tt, side="right") - 1, 0,
                        ts.shape[0] - 2))
        w = float((tt - ts[i]) / max(ts[i + 1] - ts[i], npdt(1e-30)))
        rv = (1.0 - w) * values[i] + w * values[i + 1]
    return bc.replace(ref_value=rv.to(internal.dtype))


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------

pf.register_value_coeffs("advective", _vc_mixed)
pf.register_value_coeffs("pressureInletUniformVelocity", _vc_mixed)
pf.register_value_coeffs("pressureNormalInletOutletVelocity", _vc_mixed)
pf.register_value_coeffs("variableHeightFlowRateInletVelocity",
                         _vc_mixed)
pf.register_value_coeffs("fixedShearStress", _vc_mixed)
pf.register_value_coeffs("buoyantPressure", _vc_fixed_gradient)
pf.register_value_coeffs("turbulentHeatFluxTemperature",
                         _vc_fixed_gradient)
pf.register_value_coeffs("fixedPressureCompressibleDensity", _vc_mixed)
pf.register_value_coeffs("uniformFixedGradientT", _vc_fixed_gradient)
pf.register_value_coeffs("timeVaryingMappedFixedValue", _vc_fixed_value)

pf.register_update("advective", _up_advective)
pf.register_update("pressureInletUniformVelocity",
                   _up_pressure_inlet_uniform_velocity)
pf.register_update("pressureNormalInletOutletVelocity",
                   _up_pressure_normal_io_velocity)
pf.register_update("variableHeightFlowRateInletVelocity",
                   _up_variable_height_flow_rate_inlet)
pf.register_update("fixedShearStress", _up_fixed_shear_stress)
pf.register_update("buoyantPressure", _up_buoyant_pressure)
pf.register_update("turbulentHeatFluxTemperature",
                   _up_turbulent_heat_flux_T)
pf.register_update("fixedPressureCompressibleDensity",
                   _up_fixed_pressure_compressible_density)
pf.register_update("uniformFixedGradientT", _up_uniform_fixed_gradient)
pf.register_update("timeVaryingMappedFixedValue",
                   _up_time_varying_mapped)
