"""sixDoFRigidBodyMotion: rigid-body dynamics for a floating body (port of
openfoam-2.2.x_tpu/models/sixdof.py; src/sixDoFRigidBodyMotion/: centre
of mass, orientation quaternion, velocity and angular momentum; a
symplectic leapfrog step; the linearSpring, linearDamper and
sphericalAngularDamper restraints; no constraints).

The body state is a handful of tensors of the flow's dtype on the mesh's
device ([3] and [4]), as the reference keeps it in its step's pytree:
`update` then runs in the same precision as the flow it is coupled to,
and the forces from the flow's patch sums and the moved points never
leave the device. It costs a few hundred launches of a few elements per
step, against the step's thousands.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from ..core.precision import DEFAULT_DEVICE

class RigidBodyState(NamedTuple):
    x: Any        # [3] centre of mass
    q: Any        # [4] orientation quaternion (w, x, y, z), body->global
    v: Any        # [3] linear velocity (global)
    L: Any        # [3] angular momentum (global frame: torque-free
    #               conservation is structural, the body-frame gyroscopic
    #               term lives in omega_b = I^-1 R^T L)


class RigidBodyConfig(NamedTuple):
    mass: float
    I_body: Tuple[float, float, float]     # principal inertia (body)
    g: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # linearSpring restraints: (anchor (global), refAttachmentPt (body),
    # stiffness, damping, restLength)
    springs: Tuple = ()
    lin_damping: float = 0.0               # linearDamper coefficient
    ang_damping: float = 0.0               # sphericalAngularDamper


def _vec(values, like) -> torch.Tensor:
    return torch.as_tensor(values, dtype=like.dtype, device=like.device)


def quat_rotate(q, v):
    """Rotate v (body; [3] or [n, 3]) into global by quaternion q."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    R = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)]),
    ])
    return R @ v if v.ndim == 1 else v @ R.T


def quat_mul(a, b):
    aw, av = a[0], a[1:]
    bw, bv = b[0], b[1:]
    return torch.cat([(aw * bw - av @ bv).reshape(1),
                      aw * bv + bw * av + torch.linalg.cross(av, bv)])


def _conj(q):
    return q * _vec([1.0, -1.0, -1.0, -1.0], q)


def _forces(cfg: RigidBodyConfig, st: RigidBodyState, f_ext, tau_ext):
    F = _vec(cfg.g, f_ext) * cfg.mass + f_ext
    tau_g = torch.zeros_like(f_ext)
    for anchor, attach_b, k, c, l0 in cfg.springs:
        attach_b = _vec(attach_b, f_ext)
        attach_g = st.x + quat_rotate(st.q, attach_b)
        d = attach_g - _vec(anchor, f_ext)
        mag = torch.linalg.norm(d)
        nhat = d / torch.clamp(mag, min=1e-30)
        # the attachment point's velocity
        omega_b = quat_rotate(_conj(st.q), st.L) / _vec(cfg.I_body, f_ext)
        vel_att = st.v + quat_rotate(st.q, torch.linalg.cross(omega_b,
                                                              attach_b))
        fs = -k * (mag - l0) * nhat - c * (vel_att @ nhat) * nhat
        F = F + fs
        tau_g = tau_g + torch.linalg.cross(attach_g - st.x, fs)
    F = F - cfg.lin_damping * st.v
    return F, tau_ext + tau_g


def update(cfg: RigidBodyConfig, st: RigidBodyState, dt,
           f_ext=None, tau_ext=None) -> RigidBodyState:
    """One symplectic (leapfrog) step (sixDoFRigidBodyMotion::update with
    the symplectic solver). f_ext, tau_ext: the flow's force and torque in
    the global frame."""
    f_ext = torch.zeros_like(st.x) if f_ext is None else f_ext
    tau_ext = torch.zeros_like(st.x) if tau_ext is None else tau_ext
    I = _vec(cfg.I_body, st.x)

    def omega_body(q, L):
        return quat_rotate(_conj(q), L) / I

    F, tau = _forces(cfg, st, f_ext, tau_ext)
    # half kick (L is global; the damper torque is -c omega, global)
    v_half = st.v + 0.5 * dt * F / cfg.mass
    om_g = quat_rotate(st.q, omega_body(st.q, st.L))
    L_half = st.L + 0.5 * dt * (tau - cfg.ang_damping * om_g)
    # drift
    x_new = st.x + dt * v_half
    omega_b = omega_body(st.q, L_half)
    dq = 0.5 * quat_mul(st.q, torch.cat([st.q.new_zeros(1), omega_b]))
    q_new = st.q + dt * dq
    q_new = q_new / torch.clamp(torch.linalg.norm(q_new), min=1e-30)
    # the forces again at the new configuration, second half kick
    st_mid = RigidBodyState(x=x_new, q=q_new, v=v_half, L=L_half)
    F2, tau2 = _forces(cfg, st_mid, f_ext, tau_ext)
    v_new = v_half + 0.5 * dt * F2 / cfg.mass
    om_g2 = quat_rotate(q_new, omega_body(q_new, L_half))
    L_new = L_half + 0.5 * dt * (tau2 - cfg.ang_damping * om_g2)
    return RigidBodyState(x=x_new, q=q_new, v=v_new, L=L_new)


def initial_state(x=(0.0, 0.0, 0.0), dtype=torch.float32,
                  device=DEFAULT_DEVICE) -> RigidBodyState:
    """At rest at x, unrotated, on `device` (the mesh's)."""
    def t(v):
        return torch.tensor(v, dtype=dtype, device=device)

    return RigidBodyState(x=t(list(x)), q=t([1.0, 0.0, 0.0, 0.0]),
                          v=t([0.0, 0.0, 0.0]), L=t([0.0, 0.0, 0.0]))
