"""ODE — stiff and non-stiff integrators for batches of small systems
(port of openfoam-2.2.x_tpu/ode/__init__.py: `rk45_step`,
`rosenbrock23_step`, `sibs_step`, `integrate`, `ODEResult`; reference
src/ODE/ODESolvers/{ODESolver,RKF45,rodas23,seulex,SIBS}/).

Every function here is batched over a leading dimension: y [B, n], and
the derivative f(t [B], y [B, n], *args) -> [B, n] acts on each lane
alone (lane b of the result depends on lane b of t, y and args only);
chemistry integrates one lane per cell. The reference writes one system
and vmaps `lax.while_loop` over the cells. That loop runs until the last
lane's condition is false, and a lane whose condition is false keeps its
(t, y, h, n_steps, n_rejected) while the others go on. `integrate` keeps
the same semantics with an active set: each pass advances the lanes that
are still running, per lane its own step size, accept/reject, factor
clip and isfinite guard, and lanes that finish leave the set. The loop
tests its end with one host read per pass (`STATS["syncs"]`).

- Dormand-Prince 5(4) ("RKF45", "RKCK45", "RKDP45", "DP45").
- Rosenbrock 3(2) ("rodas23", "rodas34", "Rosenbrock"): the Jacobian by
  forward-mode AD, one column per `torch.func.jvp` (the reference's
  `jax.jacfwd`), or the caller's `jac(t, y, *args)` (chemistry gives its
  analytic one: a jvp costs tens of kernel launches), the stage solves by
  a batched LU (`torch.linalg`).
- "SIBS"/"seulex": the Bader-Deuflhard semi-implicit midpoint with the
  static Bader substep sequence and Neville extrapolation in (h/n)^2.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

__all__ = ["integrate", "rk45_step", "rosenbrock23_step", "sibs_step",
           "ODEResult", "STATS", "reset_stats"]

# counters of the integration loop, read by chip_smoke.py: calls of
# `integrate`, its lanes, the host reads of its loop (one per pass, one
# before it), the attempts summed over the lanes, and the most passes one
# call took (its stiffest lane's attempts)
STATS = {"calls": 0, "lanes": 0, "syncs": 0, "lane_attempts": 0,
         "max_passes": 0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


class ODEResult(NamedTuple):
    y: Any            # final state [B, n]
    t: Any            # final time per lane (== t1 on success)
    n_steps: Any      # accepted steps per lane
    n_rejected: Any   # rejected attempts per lane


def _like(vals, y):
    return torch.tensor(vals, dtype=y.dtype, device=y.device)


def _sqrt2(y):
    return torch.sqrt(_like(2.0, y))


# -- Dormand-Prince 5(4) ----------------------------------------------------

_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
          187 / 2100, 1 / 40)


def rk45_step(f: Callable, t, y, h, args=(), jac=None):
    """One Dormand-Prince 5(4) attempt per lane: (y5, err [B, n])."""
    c = _like(_DP_C, y)
    ks = []
    for i in range(7):
        yi = y
        for j, a in enumerate(_DP_A[i]):
            yi = yi + (h * a)[:, None] * ks[j]
        ks.append(f(t + c[i] * h, yi, *args))
    K = torch.stack(ks, dim=1)                  # [B, 7, n]
    y5 = y + h[:, None] * torch.einsum("s,bsn->bn", _like(_DP_B5, y), K)
    y4 = y + h[:, None] * torch.einsum("s,bsn->bn", _like(_DP_B4, y), K)
    return y5, y5 - y4


# -- Rosenbrock 3(2) (rodas23-class) ----------------------------------------


def jacobian(f: Callable, t, y, args=()):
    """df/dy per lane [B, n, n] (J[b, i, j] = df_i/dy_j), one column per
    forward-mode product (the reference's jax.jacfwd)."""
    cols = []
    for j in range(y.shape[1]):
        e = torch.zeros_like(y)
        e[:, j] = 1.0
        cols.append(torch.func.jvp(lambda yy: f(t, yy, *args), (y,),
                                   (e,))[1])
    return torch.stack(cols, dim=2)


def _lu_solver(W):
    lu, piv = torch.linalg.lu_factor(W)

    def solve(b):
        return torch.linalg.lu_solve(lu, piv, b[:, :, None])[:, :, 0]

    return solve


def rosenbrock23_step(f: Callable, t, y, h, args=(), jac=None):
    """One L-stable Rosenbrock 3(2) attempt per lane (Shampine form):
    (y2, err). The advancing solution is the 2nd-order y + h k2; the
    3rd-order stage k3 forms the error only."""
    gamma = 1.0 / (2.0 + _sqrt2(y))
    n = y.shape[1]
    J = jacobian(f, t, y, args) if jac is None else jac(t, y, *args)
    eye = torch.eye(n, dtype=y.dtype, device=y.device)
    hg = h * gamma
    solve = _lu_solver(eye - hg[:, None, None] * J)
    eps_t = 1e-8 * torch.clamp(torch.abs(h), min=1e-30)
    dfdt = (f(t + eps_t, y, *args) - f(t, y, *args)) / eps_t[:, None]

    f0 = f(t, y, *args)
    k1 = solve(f0 + hg[:, None] * dfdt)
    f1 = f(t + 0.5 * h, y + (0.5 * h)[:, None] * k1, *args)
    k2 = solve(f1 - k1) + k1
    y2 = y + h[:, None] * k2
    f2 = f(t + h, y2, *args)
    d32 = 6.0 + _sqrt2(y)
    k3 = solve(f2 - d32 * (k2 - f1) - 2.0 * (k1 - f0)
               + hg[:, None] * dfdt)
    err = (h / 6.0)[:, None] * (k1 - 2.0 * k2 + k3)
    return y2, err


# -- SIBS (semi-implicit Bulirsch-Stoer, Bader-Deuflhard) --------------------

_SIBS_SEQ = (2, 6, 10, 14, 22)     # Bader's even substep sequence


def sibs_step(f: Callable, t, y, h, args=(), jac=None, levels: int = 3):
    """One SIBS attempt per lane (reference: SIBS.C): the semi-implicit
    midpoint rule at `levels` substep counts of the Bader sequence,
    Neville-extrapolated in (h/n)^2; each level LU-factors its own
    W = I - h_sub J. Returns (y_extrap, err)."""
    n_dim = y.shape[1]
    J = jacobian(f, t, y, args) if jac is None else jac(t, y, *args)
    eye = torch.eye(n_dim, dtype=y.dtype, device=y.device)
    seq = _SIBS_SEQ[:levels]
    T = []
    for nj in seq:
        hs = h / nj
        solve = _lu_solver(eye - hs[:, None, None] * J)
        delta = solve(hs[:, None] * f(t, y, *args))
        yk = y + delta
        for k in range(1, nj):
            delta = delta + 2.0 * solve(hs[:, None] * f(t + k * hs, yk, *args)
                                        - delta)
            yk = yk + delta
        # Bader's smoothing step
        T.append(yk + solve(hs[:, None] * f(t + h, yk, *args) - delta))
    err = T[-1] - (T[-2] if levels > 1 else y)
    for m in range(1, levels):
        for j in range(levels - 1, m - 1, -1):
            fac = (seq[j] / seq[j - m]) ** 2 - 1.0
            corr = (T[j] - T[j - 1]) / fac
            if j == levels - 1 and m == levels - 1:
                err = corr
            T[j] = T[j] + corr
    return T[-1], err


_STEPPERS = {
    "RKF45": rk45_step, "RKCK45": rk45_step, "RKDP45": rk45_step,
    "DP45": rk45_step,
    "rodas23": rosenbrock23_step, "rodas34": rosenbrock23_step,
    "Rosenbrock": rosenbrock23_step,
    "SIBS": sibs_step, "seulex": sibs_step,
}


def _lanes(x, y):
    """A scalar or per-lane time as a [B] tensor of y's dtype."""
    x = torch.as_tensor(x, dtype=y.dtype, device=y.device)
    return torch.broadcast_to(x, (y.shape[0],)).clone()


def integrate(f: Callable, y0, t0, t1, *, solver: str = "RKF45",
              rtol: float = 1e-6, atol: float = 1e-10, h0: float = None,
              max_steps: int = 100000, args=(), jac=None) -> ODEResult:
    """Integrate dy/dt = f(t, y, *args) from t0 to t1 for every lane of
    y0 [B, n] with adaptive step-size control (reference:
    ODESolver::solve). t0, t1 and h0 are scalars or [B]; `args` are
    per-lane tensors [B, ...] that follow their lanes; `jac(t, y, *args)`
    [B, n, n], where given, replaces the forward-mode Jacobian."""
    stepper = _STEPPERS.get(solver)
    if stepper is None:
        raise ValueError(f"unknown ODE solver {solver!r} "
                         f"(have {sorted(_STEPPERS)})")
    y = torch.as_tensor(y0).clone()
    t1 = _lanes(t1, y)
    t0 = _lanes(t0, y)
    h = _lanes(h0 if h0 is not None else (t1 - t0) * 1e-3, y)
    t = t0.clone()
    ns = torch.zeros(y.shape[0], dtype=torch.int32, device=y.device)
    nr = torch.zeros_like(ns)
    STATS["calls"] += 1
    STATS["lanes"] += y.shape[0]
    syncs0 = STATS["syncs"]

    def running(t, t1, ns, nr):
        return (t < t1 - 1e-12 * torch.abs(t1)) & (ns + nr < max_steps)

    # the active set: lane ids and their working state
    ids = torch.nonzero(running(t, t1, ns, nr)).flatten()
    STATS["syncs"] += 1
    while ids.numel():
        ts, ys, hs, nss, nrs = t[ids], y[ids], h[ids], ns[ids], nr[ids]
        t1s, t0s = t1[ids], t0[ids]
        a = tuple(x[ids] for x in args)
        while True:
            hh = torch.minimum(hs, t1s - ts)
            y_new, err = stepper(f, ts, ys, hh, a, jac)
            sc = atol + rtol * torch.maximum(torch.abs(ys), torch.abs(y_new))
            enorm = torch.sqrt(torch.mean((err / sc) ** 2, dim=1))
            accept = enorm <= 1.0
            fac = torch.clamp(0.9 * enorm ** -0.2, 0.2, 5.0)
            fac = torch.where(torch.isfinite(fac), fac,
                              torch.full_like(fac, 0.2))
            ts = torch.where(accept, ts + hh, ts)
            ys = torch.where(accept[:, None], y_new, ys)
            hs = torch.maximum(hh * fac, 1e-14 * (t1s - t0s))
            acc = accept.to(torch.int32)
            nss = nss + acc
            nrs = nrs + (1 - acc)
            STATS["lane_attempts"] += ids.numel()
            keep = running(ts, t1s, nss, nrs)
            n_keep = int(keep.sum())
            STATS["syncs"] += 1
            if n_keep < ids.numel():
                break
        # write the pass back; the lanes that finished leave the set
        t[ids], y[ids], h[ids], ns[ids], nr[ids] = ts, ys, hs, nss, nrs
        ids = ids[keep]
    STATS["max_passes"] = max(STATS["max_passes"],
                              STATS["syncs"] - syncs0 - 1)
    return ODEResult(y=y, t=t, n_steps=ns, n_rejected=nr)
