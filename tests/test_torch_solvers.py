"""foamtpu_torch linear solvers against the JAX package.

The same assembled systems (built by the JAX package, carried into the
port with foamtpu_torch.convert) are solved by both packages from the
same start: PCG (diagonal and polynomial preconditioners) on the pinned
pressure Laplacian, BiCGStab on the multi-RHS momentum system (the
smoothSolver dispatch of a non-symmetric matrix), and GAMG (shared level
tables, flexible PCG with null-space deflation) on the singular pressure
system of the 32^2 cavity with n_coarsest=64 (4 levels, strided
V-cycle).

Tolerance (float32): fields at rtol 1e-4 of the solution's scale and
iteration counts to +-1. Both packages run the same float32 arithmetic
in a different summation order; through a few dozen Krylov iterations
that rounding noise grows to ~1e-5 relative and can move a stopping
test by one iteration.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foamtpu.apps.cases import make_cavity as jmake_cavity
from foamtpu.core.dimensions import dimTime, dimViscosity
from foamtpu.ops import fvc as jfvc
from foamtpu.ops import fvm as jfvm
from foamtpu.ops import slot as jslot
from foamtpu.solvers import linear as jlinear

from foamtpu_torch.convert import (levels_from_numpy, matrix_from_numpy,
                                   mesh_from_numpy, tensor)
from foamtpu_torch.solvers import linear
from foamtpu_torch.solvers.linear.gamg import GAMG

torch.set_num_threads(2)


def build_systems():
    import os

    old = os.environ.get("FOAMTPU_GAMG_NC")
    os.environ["FOAMTPU_GAMG_NC"] = "64"
    try:
        jm, jstate, jcfg = jmake_cavity(32, p_solver={
            "solver": "GAMG", "tolerance": 1e-6, "relTol": 0.0,
            "maxIter": 200})
    finally:
        if old is None:
            os.environ.pop("FOAMTPU_GAMG_NC")
        else:
            os.environ["FOAMTPU_GAMG_NC"] = old
    jg = jcfg.p_controls["_gamg"]
    assert len(jg.levels) == 4
    rng = np.random.default_rng(3)
    jU, jp = jstate["U"], jstate["p"]
    nC = jm.n_cells
    jU = jU.with_data(jnp.asarray(0.1 * rng.standard_normal((nC, 3)),
                                  jnp.float32))
    # pressure: laplacian(rAf, p) == random balanced source
    rAf = jnp.asarray(1e-3 * (1.0 + rng.random(jm.n_faces)), jnp.float32)
    P = jfvm.laplacian(jm, rAf, jp, corrected=False, gamma_dims=dimTime,
                       gamma_slot=jslot.from_flat(jm, rAf))
    src = rng.standard_normal(nC)
    P = P.replace_fields(source=P.source + jnp.asarray(src - src.mean(),
                                                       jnp.float32))
    # momentum: ddt + div(phi) - laplacian(nu) == -grad(p)
    phi = jfvc.flux(jm, jU)
    rdt = jnp.asarray(400.0, jnp.float32)
    M = (jfvm.ddt(jm, jU, jU.data, rdt)
         + jfvm.div(jm, phi, jU, phi_slot=jslot.from_flat(jm, phi))
         - jfvm.laplacian(jm, jnp.asarray(0.01, jnp.float32), jU,
                          corrected=False, gamma_dims=dimViscosity))
    M = M.add_source(-jfvc.grad(jm, jp.with_data(jnp.asarray(
        rng.standard_normal(nC), jnp.float32))), jm)
    # the same operator without slot coefficients (GAMG's gather path)
    P_flat = jfvm.laplacian(jm, rAf, jp, corrected=False, gamma_dims=dimTime)
    P_flat = P_flat.replace_fields(source=P.source)
    tm = mesh_from_numpy(jm)
    tg = GAMG(tm, levels=levels_from_numpy(jg.levels))
    return dict(jm=jm, tm=tm, jg=jg, tg=tg, P=P, P_flat=P_flat, M=M,
                U0=jU.data)


@pytest.fixture(scope="module")
def systems():
    return build_systems()


def _check(got, ref, perf_t, perf_j, what):
    g = got.numpy()
    r = np.asarray(ref)
    scale = float(np.max(np.abs(r)))
    np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4 * scale,
                               err_msg=what)
    it_t = int(perf_t.n_iterations)
    it_j = int(perf_j.n_iterations)
    assert abs(it_t - it_j) <= 1, (what, it_t, it_j)
    assert it_j > 0, what


@pytest.mark.parametrize("precond", ["diagonal", "polynomial"])
def test_pcg_matches_reference(systems, precond):
    jm, tm = systems["jm"], systems["tm"]
    ctl = {"solver": "PCG", "preconditioner": precond, "tolerance": 1e-6,
           "relTol": 0.0, "maxIter": 2000}
    jP, ctl_j = jlinear.prep_pressure(systems["P"], True, ctl, 0, 0.0)
    tP, ctl_t = linear.prep_pressure(matrix_from_numpy(systems["P"]), True,
                                     ctl, 0, 0.0)
    psi0 = np.zeros(jm.n_cells, np.float32)
    xj, pj = jlinear.solve(jm, jP, jnp.asarray(psi0), ctl_j)
    xt, pt = linear.solve(tm, tP, tensor(psi0), ctl_t)
    _check(xt, xj, pt, pj, f"PCG {precond}")


@pytest.mark.parametrize("ctl", [
    {"solver": "smoothSolver", "tolerance": 1e-6, "relTol": 0.0,
     "maxIter": 500, "nSweeps": 2},
    {"solver": "PBiCGStab", "preconditioner": "polynomial",
     "tolerance": 1e-6, "relTol": 0.0, "maxIter": 500},
], ids=["smoothSolver", "PBiCGStab-poly"])
def test_bicgstab_multi_rhs_matches_reference(systems, ctl):
    jm, tm = systems["jm"], systems["tm"]
    U0 = np.asarray(systems["U0"])
    xj, pj = jlinear.solve(jm, systems["M"], jnp.asarray(U0), ctl)
    xt, pt = linear.solve(tm, matrix_from_numpy(systems["M"]), tensor(U0),
                          ctl)
    assert xt.shape == (jm.n_cells, 3)
    _check(xt, xj, pt, pj, ctl["solver"])


# In float32 the coarsest-level inverse of the singular pressure system
# (ridge 1e-6 * max|diag|, as in the reference) amplifies rounding by
# ~1e6, so the two packages' V-cycles differ at the 1e-3 level and deep
# solves (tol 1e-6, relTol 0) drift apart by an iteration or two. The
# f32 cases stop where both converge alike; the float64 parity test in
# test_torch_piso.py holds every iteration count equal.
@pytest.mark.parametrize("tol,rel_tol", [(1e-4, 0.0), (1e-6, 0.01)])
def test_gamg_matches_reference(systems, tol, rel_tol):
    jm, tm = systems["jm"], systems["tm"]
    ctl = {"solver": "GAMG", "tolerance": tol, "relTol": rel_tol,
           "maxIter": 200}
    jP, ctl_j = jlinear.prep_pressure(
        systems["P"], True, dict(ctl, _gamg=systems["jg"]), 0, 0.0)
    tP, ctl_t = linear.prep_pressure(
        matrix_from_numpy(systems["P"]), True,
        dict(ctl, _gamg=systems["tg"]), 0, 0.0)
    assert ctl_t["_singular"]
    ctl_j = jlinear.prepare_controls(jm, jP, ctl_j)
    ctl_t = linear.prepare_controls(tm, tP, ctl_t)
    psi0 = np.zeros(jm.n_cells, np.float32)
    xj, pj = jlinear.solve(jm, jP, jnp.asarray(psi0), ctl_j)
    xt, pt = linear.solve(tm, tP, tensor(psi0), ctl_t)
    _check(xt, xj, pt, pj, f"GAMG relTol={rel_tol}")
    assert float(xt[0]) == 0.0   # the pRefCell gauge


@pytest.mark.parametrize("variant", ["gather", "stride1-chebyshev"])
def test_gamg_variants_match_reference(systems, variant):
    """The gather-path Galerkin coarsening (a matrix without slot
    coefficients) and the unstrided V-cycle with Chebyshev smoothing."""
    from foamtpu.solvers.linear.gamg import GAMG as JGAMG

    jm, tm = systems["jm"], systems["tm"]
    if variant == "gather":
        P, jg, tg = systems["P_flat"], systems["jg"], systems["tg"]
        assert P.soff is None
    else:
        P = systems["P"]
        kw = dict(level_stride=1, smoother="Chebyshev")
        jg = JGAMG(jm, levels=systems["jg"].levels, **kw)
        tg = GAMG(tm, levels=systems["tg"].levels, **kw)
    ctl = {"solver": "GAMG", "tolerance": 1e-4, "relTol": 0.0,
           "maxIter": 200}
    jP, ctl_j = jlinear.prep_pressure(P, True, dict(ctl, _gamg=jg), 0, 0.0)
    tP, ctl_t = linear.prep_pressure(matrix_from_numpy(P), True,
                                     dict(ctl, _gamg=tg), 0, 0.0)
    psi0 = np.zeros(jm.n_cells, np.float32)
    xj, pj = jlinear.solve(jm, jP, jnp.asarray(psi0), ctl_j)
    xt, pt = linear.solve(tm, tP, tensor(psi0), ctl_t)
    _check(xt, xj, pt, pj, f"GAMG {variant}")


def test_gamg_prepare_matches_reference(systems):
    """The plane Galerkin hierarchy and coarsest inverse agree level by
    level (the V-cycle's inputs)."""
    jm, tm = systems["jm"], systems["tm"]
    jprep = systems["jg"].prepare(jm, systems["P"])
    tprep = systems["tg"].prepare(tm, matrix_from_numpy(systems["P"]))
    assert len(tprep["ops"]) == len(jprep["ops"]) == 5
    for (dt_, _, _), (dj, _, _), ot, oj in zip(
            tprep["mats"], jprep["mats"], tprep["ops"], jprep["ops"]):
        np.testing.assert_allclose(dt_.numpy(), np.asarray(dj), rtol=1e-5,
                                   atol=1e-6 * float(np.abs(dj).max()))
        assert ot.deltas == tuple(oj.deltas)
        np.testing.assert_allclose(ot.off.numpy(), np.asarray(oj.off),
                                   rtol=1e-5,
                                   atol=1e-6 * float(np.abs(oj.off).max()))
    # the coarsest inverse on a zero-sum vector (the deflated residual
    # the V-cycle feeds it): 1e-2 of scale, see the float32 note above
    b = np.random.default_rng(0).standard_normal(
        jprep["Ainv"].shape[0]).astype(np.float32)
    b -= b.mean()
    y_j = np.asarray(jprep["Ainv"]) @ b
    y_t = tprep["Ainv"].numpy() @ b
    np.testing.assert_allclose(y_t, y_j, rtol=1e-2,
                               atol=1e-2 * float(np.abs(y_j).max()))
