"""Krylov / smoother linear solvers (port of
openfoam-2.2.x_tpu/solvers/linear/krylov.py).

Iteration structure, residual definition and normalisation follow the
reference exactly:

    normFactor = gSum(|Apsi - pA| + |b - pA|) + SMALL,  pA = sumA*avg(psi)
    residual   = gSum(|b - Apsi|) / normFactor

The reference's lax.while_loop becomes a Python loop that checks the
residual on the host once per iteration (one device sync each), so the
f64 iteration counts equal the reference's. All solvers are multi-RHS:
psi [nC] or [nC, C], per-column alphas/betas broadcast over cells.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


class SolverPerf(NamedTuple):
    initial_residual: Any
    final_residual: Any
    n_iterations: Any


def _small(dtype) -> float:
    return 1e-20 if dtype == torch.float64 else 1e-12


# Per-component stagnation guard (reference krylov.py:42-75): a component
# whose residual is already below the precision floor and fails to
# improve by 0.1% for STALL_ITERS consecutive iterations stops gating the
# loop.
STALL_ITERS = 15
IMPROVE_FACTOR = 0.999


def _stall_floor(dtype) -> float:
    return 1e-13 if dtype == torch.float64 else 1e-5


def _stall_init(res0):
    return res0, torch.zeros_like(res0, dtype=torch.int32)


def _stall_update(res, best, stall):
    at_floor = res < _stall_floor(res.dtype)
    improved = res < IMPROVE_FACTOR * best
    stall = torch.where(improved | ~at_floor, torch.zeros_like(stall),
                        stall + 1)
    return torch.minimum(best, res), stall


def _unconverged(res, res0, tol, rel_tol, stall) -> bool:
    return bool(torch.any((res > tol) & (res > rel_tol * res0)
                          & (stall < STALL_ITERS)))


def _sum(x):
    """Cell-wise sum: scalar for [nC], per-component [C] for [nC,C]."""
    return torch.sum(x, dim=0)


def _bcol(x, like):
    """Broadcast a per-component scalar over cells."""
    return x if like.ndim == 1 else x[None, :]


def _norm_factor(amul, psi, b, row_sum):
    Apsi = amul(psi)
    avg = torch.mean(psi, dim=0)
    if psi.ndim == 2:
        pA = (row_sum[:, None] * avg[None, :] if row_sum.ndim == 1
              else row_sum * avg[None, :])
    else:
        pA = row_sum * avg
    nf = (_sum(torch.abs(Apsi - pA)) + _sum(torch.abs(b - pA))
          + _small(psi.dtype))
    return Apsi, nf


def make_preconditioner(kind: str, diag, amul_off=None, order: int = 2):
    """kind: 'diagonal' | 'none' | 'polynomial' (truncated Neumann series
    M^-1 ~ sum_k (-D^-1 N)^k D^-1; each order is one stencil SpMV)."""
    rdiag = 1.0 / diag
    if kind == "none":
        return lambda r: r
    if kind in ("diagonal", "Jacobi", "DIC", "DILU", "FDIC"):
        return lambda r: r * rdiag
    if kind == "polynomial":
        def prec(r):
            z = r * rdiag
            x = z
            for _ in range(order):
                x = z - amul_off(x) * rdiag
            return x
        return prec
    raise ValueError(f"unknown preconditioner {kind!r}")


def _tiny(psi):
    return torch.tensor(_small(psi.dtype), dtype=psi.dtype, device=psi.device)


def _guard(x, tiny):
    return torch.where(x == 0, tiny, x)


def _cshape(psi):
    return () if psi.ndim == 1 else (psi.shape[1],)


def pcg(amul, psi0, b, diag, *, tol: float, rel_tol: float, max_iter: int,
        precond: str = "diagonal", amul_off=None, row_sum=None):
    """Preconditioned conjugate gradient (reference: PCG.C)."""
    prec = make_preconditioner(precond, diag, amul_off)
    Apsi, norm = _norm_factor(amul, psi0, b, row_sum)
    r = b - Apsi
    res0 = _sum(torch.abs(r)) / norm
    tiny = _tiny(psi0)
    psi, p = psi0, torch.zeros_like(psi0)
    wArA_old = psi0.new_zeros(_cshape(psi0))
    it, res = 0, res0
    best, stall = _stall_init(res0)
    while it < max_iter and _unconverged(res, res0, tol, rel_tol, stall):
        z = prec(r)
        wArA = _sum(r * z)
        beta = (torch.zeros_like(wArA) if it == 0
                else wArA / _guard(wArA_old, tiny))
        p = z + _bcol(beta, psi0) * p
        q = amul(p)
        pq = _sum(p * q)
        alpha = wArA / _guard(pq, tiny)
        psi = psi + _bcol(alpha, psi0) * p
        r = r - _bcol(alpha, psi0) * q
        res = _sum(torch.abs(r)) / norm
        best, stall = _stall_update(res, best, stall)
        wArA_old = wArA
        it += 1
    return psi, SolverPerf(res0, res, it)


def bicgstab(amul, psi0, b, diag, *, tol: float, rel_tol: float,
             max_iter: int, precond: str = "diagonal", amul_off=None,
             row_sum=None):
    """Preconditioned BiCGStab for asymmetric matrices (dispatched from
    both PBiCG and PBiCGStab, as in the reference)."""
    prec = make_preconditioner(precond, diag, amul_off)
    Apsi, norm = _norm_factor(amul, psi0, b, row_sum)
    r = b - Apsi
    res0 = _sum(torch.abs(r)) / norm
    rhat = r
    tiny = _tiny(psi0)
    psi = psi0
    p = torch.zeros_like(psi0)
    v = torch.zeros_like(psi0)
    one = psi0.new_ones(_cshape(psi0))
    rho_old, alpha, omega = one, one, one
    it, res = 0, res0
    best, stall = _stall_init(res0)
    while it < max_iter and _unconverged(res, res0, tol, rel_tol, stall):
        rho = _sum(rhat * r)
        beta = (rho / _guard(rho_old, tiny)) * (alpha / _guard(omega, tiny))
        if it == 0:
            beta = torch.zeros_like(beta)
        p = r + _bcol(beta, psi0) * (p - _bcol(omega, psi0) * v)
        phat = prec(p)
        v = amul(phat)
        rhv = _sum(rhat * v)
        alpha = rho / _guard(rhv, tiny)
        s = r - _bcol(alpha, psi0) * v
        shat = prec(s)
        t = amul(shat)
        tt = _sum(t * t)
        omega = _sum(t * s) / _guard(tt, tiny)
        psi = psi + _bcol(alpha, psi0) * phat + _bcol(omega, psi0) * shat
        r = s - _bcol(omega, psi0) * t
        res = _sum(torch.abs(r)) / norm
        best, stall = _stall_update(res, best, stall)
        rho_old = rho
        it += 1
    return psi, SolverPerf(res0, res, it)


def smooth_solver(amul, psi0, b, diag, *, tol: float, rel_tol: float,
                  max_iter: int, n_sweeps: int = 1, omega: float = 0.9,
                  row_sum=None, lam_max=None, **_):
    """smoothSolver: Chebyshev-accelerated Jacobi on the D^-1 A operator
    (Gershgorin bound lam_max from the dispatcher), damped Jacobi without
    a bound. Tolerance semantics are the reference's."""
    Apsi, norm = _norm_factor(amul, psi0, b, row_sum)
    r0 = b - Apsi
    res0 = _sum(torch.abs(r0)) / norm
    rdiag = 1.0 / diag
    n_in = max(int(n_sweeps), 4)

    if lam_max is not None:
        lmax = 1.05 * lam_max
        lmin = lmax / 30.0
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta

        def sweeps(psi):
            z = (b - amul(psi)) * rdiag
            d = z / theta
            psi = psi + d
            rho = 1.0 / sigma
            for _ in range(n_in - 1):
                rho_new = 1.0 / (2.0 * sigma - rho)
                z = (b - amul(psi)) * rdiag
                d = (rho_new * rho) * d + (2.0 * rho_new / delta) * z
                psi = psi + d
                rho = rho_new
            return psi
    else:
        def sweeps(psi):
            for _ in range(n_in):
                psi = psi + (b - amul(psi)) * (omega * rdiag)
            return psi

    psi, it, res = psi0, 0, res0
    best, stall = _stall_init(res0)
    while it < max_iter and _unconverged(res, res0, tol, rel_tol, stall):
        psi = sweeps(psi)
        res = _sum(torch.abs(b - amul(psi))) / norm
        best, stall = _stall_update(res, best, stall)
        it += 1
    return psi, SolverPerf(res0, res, it * n_in)


def diagonal_solver(amul, psi0, b, diag, **kw):
    """Exact solve for diagonal matrices (reference: diagonalSolver.C)."""
    z = psi0.new_zeros(())
    return b / diag, SolverPerf(z, z, 0)
