"""engine: IC-engine crank-angle time and piston mesh motion (port of
openfoam-2.2.x_tpu/mesh/engine.py; src/engine/: engineTime's user time in
crank-angle degrees, rpm / conRodLength / stroke / clearance from
constant/engineGeometry, the piston motion).

Two motions, as the reference:
- `piston_motion`: the cylinder keeps its topology and the points between
  the crown and the head stretch linearly (static-topology ALE, as
  mesh/moving.py's solid-body motions);
- `piston_layer_motion`: one step of a layerAdditionRemoval run (see
  mesh/topo.py): only the piston plane moves, the layer next to it
  stretches, and the host adds or removes a layer between steps.

Slider-crank kinematics (engineTime::pistonPosition):
    s(theta) = R + L - (R cos(theta) + sqrt(L^2 - R^2 sin^2(theta)))
with R = stroke/2 and L = conRodLength; s is the distance below TDC (s(0)
= 0, s(180) = stroke). The crank turns at 6 rpm degrees per second;
controlDict times of the engine solvers are in CAD. The kinematics take
floats (host math, float64) or tensors (torch, in their dtype); the
motion functions work in the dtype and on the device of the points.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

import torch


class EngineGeometry(NamedTuple):
    rpm: float = 1000.0
    con_rod_length: float = 0.15
    stroke: float = 0.1
    clearance: float = 0.01     # clearance height at TDC
    theta0: float = -180.0      # crank angle at startTime [CAD]
    axis: int = 1               # the piston moves along this axis


def from_dict(d) -> EngineGeometry:
    """From a constant/engineGeometry FoamDict (dimensioned entries
    allowed)."""
    def g(key, default):
        v = d.get(key, default)
        if isinstance(v, list):      # dimensioned: name [dims] value
            v = v[-1]
        try:
            return float(v)
        except (TypeError, ValueError):
            return default

    return EngineGeometry(
        rpm=g("rpm", 1000.0),
        con_rod_length=g("conRodLength", 0.15),
        stroke=g("stroke", 0.1),
        clearance=g("clearance", 0.01),
        theta0=g("theta0", g("startTheta", -180.0)),
        axis=int(g("axis", 1)))


def deg_per_sec(geom: EngineGeometry) -> float:
    return 6.0 * geom.rpm


def cad_to_seconds(geom: EngineGeometry, cad: float) -> float:
    """engineTime: user time (CAD) -> solver time (s)."""
    return cad / deg_per_sec(geom)


def _fns(x):
    if torch.is_tensor(x):
        return torch.sin, torch.cos, torch.sqrt
    return math.sin, math.cos, math.sqrt


def piston_displacement(geom: EngineGeometry, theta_deg):
    """Distance of the piston crown below TDC at crank angle theta."""
    sin, cos, sqrt = _fns(theta_deg)
    R = geom.stroke / 2.0
    L = geom.con_rod_length
    th = theta_deg * math.pi / 180.0
    return (R + L) - (R * cos(th) + sqrt(L * L - (R * sin(th)) ** 2))


def piston_speed(geom: EngineGeometry, theta_deg):
    """ds/dt at theta [m/s] (the analytic derivative)."""
    sin, cos, sqrt = _fns(theta_deg)
    R = geom.stroke / 2.0
    L = geom.con_rod_length
    th = theta_deg * math.pi / 180.0
    om = deg_per_sec(geom) * math.pi / 180.0       # rad/s
    s, c = sin(th), cos(th)
    return om * (R * s + (R * R * s * c) / sqrt(L * L - (R * s) ** 2))


def _time(t, like):
    return torch.as_tensor(t, dtype=like.dtype, device=like.device)


def piston_layer_motion(geom: EngineGeometry, planes, side: int,
                        theta_start: float) -> Tuple[Callable, Callable]:
    """Motion functions for ONE static-topology stretch of a layerAR
    engine run (src/engine/engineMesh's layered motion with
    layerAdditionRemoval, mesh/topo.py): only the piston plane moves, the
    layer next to it stretches, everything beyond the first interior
    plane stays. `t` is seconds since the stretch began (crank angle
    theta_start)."""
    ax = geom.axis
    dps = deg_per_sec(geom)
    planes = [float(p) for p in planes]
    if side == 0:
        z0, z_fix = planes[0], planes[1]
        sgn = 1.0          # the crown below the fixed plane
    else:
        z0, z_fix = planes[-1], planes[-2]
        sgn = -1.0
    s_start = float(piston_displacement(geom, theta_start))
    # the TDC crown coordinate consistent with the stretch's first mesh
    z_tdc = z0 + sgn * s_start
    eps = 1e-6 * max(abs(z_fix - z0), 1e-30)

    def z_piston(t):
        return z_tdc - sgn * piston_displacement(geom, theta_start + dps * t)

    def pts(p0, t):
        zp = z_piston(_time(t, p0))
        moving = sgn * (z0 + sgn * eps - p0[:, ax]) >= 0.0
        out = p0.clone()
        out[:, ax] = torch.where(moving, zp, p0[:, ax])
        return out

    def umesh(x, t):
        t = _time(t, x)
        vp = -sgn * piston_speed(geom, theta_start + dps * t)
        zp = z_piston(t)
        den = z_fix - zp
        lam = (z_fix - x[..., ax]) / torch.where(torch.abs(den) < eps,
                                                 torch.full_like(den, eps),
                                                 den)
        u = torch.zeros_like(x)
        u[..., ax] = torch.clamp(lam, 0.0, 1.0) * vp
        return u

    return pts, umesh


def piston_motion(geom: EngineGeometry, z_head: float, z_piston0: float
                  ) -> Tuple[Callable, Callable]:
    """Motion functions for mesh/moving.py. The mesh is built at crank
    angle theta0 with the crown at z_piston0 (coordinates along
    `geom.axis`, the head above the piston: z_head > z_piston). The
    points scale linearly between the moving crown and the fixed head
    (enginePiston with the engineTopoChangerMesh family replaced by
    static-topology stretching, as the reference)."""
    ax = geom.axis
    dps = deg_per_sec(geom)
    # the TDC crown position from the mesh's crown at theta0 (so that
    # pts(p0, 0) == p0 exactly; the dictionary's clearance is not trusted
    # to match the mesh to the last digit)
    z_tdc = z_piston0 + float(piston_displacement(geom, geom.theta0))
    h0 = z_head - z_piston0

    def z_piston(t):
        return z_tdc - piston_displacement(geom, geom.theta0 + dps * t)

    def pts(p0, t):
        zp = z_piston(_time(t, p0))
        lam = (z_head - p0[:, ax]) / h0       # 0 at the head, 1 at the crown
        out = p0.clone()
        out[:, ax] = z_head - lam * (z_head - zp)
        return out

    def umesh(x, t):
        t = _time(t, x)
        vp = -piston_speed(geom, geom.theta0 + dps * t)   # crown velocity
        zp = z_piston(t)
        lam = (z_head - x[..., ax]) / torch.clamp(z_head - zp, min=1e-12)
        u = torch.zeros_like(x)
        u[..., ax] = lam * vp
        return u

    return pts, umesh
