"""Smoke run of the foamtpu_torch port on one CUDA card.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits non-zero):
  1. device: the card's name and power limit, and the build of the
     offset-stencil SpMV kernel (foamtpu_torch/csrc/spmv_stencil.cu).
  2. kernel: the kernel against its plain torch version on the card, at
     the shapes of tests/test_pallas_spmv.py plus a [160000, 3] operand
     and a no-diagonal call, in float32 and float64, with timings; and
     at pitzDaily's own stencil (its st_deltas with the pressure matrix
     [n] and the relaxed momentum matrix [n, 3] that the first SIMPLE
     iteration hands to its linear solves).
  3. physics: the 20^2 icoFoam cavity, 100 steps, against the goldens of
     tests/test_cavity.py.
  4. headline: the 400^2 cavity with the GAMG pressure controls of
     bench.py, one 10-step warm-up chunk and three timed 10-step chunks;
     the SpMV launch count shows the main path ran through the kernel.
  5. pitz: simpleFoam on the unmodified pitzDaily tutorial (blockMesh,
     Case, kEpsilon with wall functions, GAMG p): a 50-iteration warm-up
     chunk, three timed 50-iteration chunks (bench.py's bench_pitz), and
     on to 1000 iterations, held to the oracles of
     tests/test_pitzdaily.py; then one 20-iteration chunk with each
     linear solve fenced by torch.cuda.synchronize for the time share
     per solve, and one 10-iteration chunk under torch.profiler for the
     device time per iteration, per solve and per kernel, with the SpMV
     launches of that chunk.
Then the kernel table and the final `{"ok": true, ...}` line.

It needs a CUDA card and the repository's foamtpu_torch package beside
it; without either it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

KERNEL_SOURCE = "foamtpu_torch/csrc/spmv_stencil.cu"
KERNEL_REPLACES = "openfoam-2.2.x_tpu/ops/pallas_spmv.py:109"
PITZ_CASE = os.path.join("tutorials", "incompressible", "simpleFoam",
                         "pitzDaily")
PITZ_CHUNK = 50       # iterations per chunk (bench.py's BENCH_PITZ_ITERS)
PITZ_CHUNKS = 20      # 1000 iterations, the horizon of test_pitzdaily.py

# tests/test_cavity.py:120-134 (f32, 20x20, 100 steps of dt=0.005)
GOLDEN_UCL = np.array([
    -0.017685, -0.046086, -0.070346, -0.09222, -0.112751, -0.1325,
    -0.151547, -0.169462, -0.185223, -0.197112, -0.202589, -0.198158,
    -0.179274, -0.140323, -0.074767, 0.024439, 0.163997, 0.348883,
    0.58027, 0.852023,
])
GOLDEN_VCL = np.array([
    0.043238, 0.109501, 0.152965, 0.174689, 0.17771, 0.165628,
    0.141914, 0.109609, 0.071243, 0.028943, -0.01538, -0.059788,
    -0.102053, -0.139413, -0.1684, -0.184832, -0.184097, -0.161848,
    -0.115184, -0.044569,
])
GOLDEN_KE = 0.0632169

SPMV_CASES = [  # (name, n, deltas, ncols, with_diag)
    ("n1024", 1024, (1, -1, 16, -16), 1, True),
    ("n160000", 160000, (1, -1, 400, -400), 1, True),
    ("n5000", 5000, (1, -1, 128, -128, 3000, -3000), 1, True),
    ("n160000x3", 160000, (1, -1, 400, -400), 3, True),
    ("n160000_nodiag", 160000, (1, -1, 400, -400), 1, False),
]
# float32: rtol 2e-6 / atol 2e-5 (tests/test_pallas_spmv.py; FMA and
# summation order differ from the roll chain). float64: rtol 1e-12 with
# atol 1e-12 for outputs that cancel to near zero (O(1) inputs, 7 terms).
TOL = {torch.float32: (2e-6, 2e-5), torch.float64: (1e-12, 1e-12)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what) -> None:
    """A failed check ends the run (and survives python -O, unlike
    assert)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        f"nvidia-smi failed: {r.stderr.strip()}"


def spmv_inputs(n, deltas, ncols, with_diag, dtype, seed=0):
    """Random operands with the st_valid contract: coefficients whose
    neighbour c+d leaves [0, n) are zero (tests/test_pallas_spmv.py)."""
    rng = np.random.default_rng(seed)
    shape = (n,) if ncols == 1 else (n, ncols)
    x = rng.standard_normal(shape)
    diag = rng.standard_normal(shape) if with_diag else None
    soff = rng.standard_normal((n, len(deltas)))
    idx = np.arange(n)
    for m, d in enumerate(deltas):
        soff[(idx + d < 0) | (idx + d >= n), m] = 0.0

    def dev(a):
        return None if a is None else torch.tensor(a, dtype=dtype,
                                                   device="cuda")
    return dev(diag), dev(x), dev(soff)


def time_ms(fn, reps=5, inner=200) -> float:
    """Median over `reps` of CUDA-event time per call of `inner`
    back-to-back calls (after a warm-up)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / inner)
    return statistics.median(out)


def pitz_setup(here, root):
    """The pitzDaily tutorial copied under `root`, meshed by the port's
    blockMesh, loaded as a Case on the card with its kEpsilon model and
    fvSolution controls (bench.py:300-326). Returns (mesh, cfg, state)."""
    from foamtpu_torch.apps.cli import main as cli
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.core.dictionary import dimensioned_scalar
    from foamtpu_torch.solvers import piso, simple
    from foamtpu_torch.solvers.apps import _load_turbulence, _relaxation

    dst = os.path.join(root, "pitzDaily")
    shutil.copytree(os.path.join(here, PITZ_CASE), dst)
    with contextlib.redirect_stdout(sys.stderr):
        check(cli(["blockMesh", "-case", dst]) == 0, "blockMesh failed")
    case = Case(dst, device="cuda")
    mesh = case.mesh
    _, nu = dimensioned_scalar(case.transport_properties()["nu"])
    model, tstate = _load_turbulence(case, nu)
    relax = _relaxation(case)
    cfg = simple.SimpleConfig(
        nu=nu, div_scheme=case.div_scheme("div(phi,U)"),
        corrected=case.laplacian_corrected(),
        grad_scheme=case.grad_scheme("grad(p)"),
        alpha_u=relax.get("U", 0.7), alpha_p=relax.get("p", 0.3),
        p_controls=case.solver_controls("p"),
        u_controls=case.solver_controls("U"),
        turb=model, turb_relax=relax.get("k", 0.7))
    state = piso.initial_state(mesh, case.read_field("U"),
                               case.read_field("p"), turb_state=tstate)
    return mesh, cfg, state


class SolveLog:
    """The one wrapper around foamtpu_torch.solvers.linear.solve that the
    pitzDaily runs use. Each call is named by its equation's dimensions
    (FvMatrix.dims: U, p, k and epsilon differ; an equation of other
    dimensions fails the run), counted, and its first matrix per name
    kept; with `fence` it is timed between two torch.cuda.synchronize,
    with `ranges` it runs in a torch.profiler range solve_<name>."""

    def __init__(self, state, fence=False, ranges=False):
        from foamtpu_torch.core.dimensions import dimFlux, dimLength, dimTime

        turb = state["turb"]
        self.names = {dimFlux * state["U"].dims: "U",
                      dimTime * state["p"].dims * dimLength: "p",
                      dimFlux * turb["epsilon"].dims: "epsilon",
                      dimFlux * turb["k"].dims: "k"}
        check(len(self.names) == 4, f"equation dimensions collide: "
              f"{self.names}")
        self.fence, self.ranges = fence, ranges
        self.calls = dict.fromkeys(self.names.values(), 0)
        self.seconds = dict.fromkeys(self.names.values(), 0.0)
        self.matrices = {}

    def __enter__(self):
        from foamtpu_torch.solvers import linear

        self._linear, self._orig = linear, linear.solve
        linear.solve = self._solve
        return self

    def __exit__(self, *exc):
        self._linear.solve = self._orig

    def _solve(self, mesh, mat, psi, controls):
        from torch.profiler import record_function

        name = self.names.get(mat.dims)
        check(name is not None, f"a solve of unnamed dimensions {mat.dims}")
        self.calls[name] += 1
        self.matrices.setdefault(name, mat)
        with (record_function(f"solve_{name}") if self.ranges
              else contextlib.nullcontext()):
            if self.fence:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            out = self._orig(mesh, mat, psi, controls)
            if self.fence:
                torch.cuda.synchronize()
                self.seconds[name] += time.perf_counter() - t0
        return out


def pitz_operands(mesh, cfg, state):
    """The SpMV operands of pitzDaily's first SIMPLE iteration, taken
    from the matrices that iteration hands to the linear solves: the
    pressure matrix (diag_eff [n]) and the relaxed momentum matrix
    (diag_eff [n,3]), with their slot coefficients over st_deltas."""
    from foamtpu_torch.solvers import simple

    with SolveLog(state) as log:
        simple.make_step(mesh, cfg)(state)
    p, u = log.matrices["p"], log.matrices["U"]
    return [("pitz_p", p.soff, p.diag_eff(mesh)),
            ("pitz_Ux3", u.soff, u.diag_eff(mesh))]


def phase_kernel(spmv, pitz_ops, deltas_pitz):
    max_err = 0.0
    cases = []
    timing = {}
    for dtype in (torch.float32, torch.float64):
        rtol, atol = TOL[dtype]
        for name, n, deltas, ncols, with_diag in SPMV_CASES:
            diag, x, soff = spmv_inputs(n, deltas, ncols, with_diag, dtype)
            got = spmv.spmv(diag, x, soff, deltas)
            torch.cuda.synchronize()
            ref = spmv.plain(diag, x, soff, deltas)
            err = float(torch.max(torch.abs(got - ref)))
            ok = bool(torch.allclose(got, ref, rtol=rtol, atol=atol))
            cases.append({"case": name, "dtype": str(dtype), "ok": ok,
                          "max_abs_err": err})
            check(ok, f"spmv kernel disagrees with plain: {name} {dtype}")
            if dtype == torch.float32:
                max_err = max(max_err, err)
            if name == "n160000" and dtype == torch.float32:
                # plain, kernel, kernel, plain: compare within one call
                t = [time_ms(lambda: spmv.plain(diag, x, soff, deltas)),
                     time_ms(lambda: spmv.spmv(diag, x, soff, deltas)),
                     time_ms(lambda: spmv.spmv(diag, x, soff, deltas)),
                     time_ms(lambda: spmv.plain(diag, x, soff, deltas))]
                timing = {"kernel_ms": min(t[1], t[2]),
                          "plain_ms": min(t[0], t[3]), "runs_ms": t}
        # pitzDaily's own stencil: the assembled coefficients with
        # seeded O(1) x; atol is taken relative to max|plain| because
        # the matrices' scale is far from 1
        rng = np.random.default_rng(1)
        for name, soff, diag in pitz_ops:
            soff = soff.to(dtype).contiguous()
            diag = diag.to(dtype).contiguous()
            x = torch.tensor(rng.standard_normal(tuple(diag.shape)),
                             dtype=dtype, device="cuda")
            got = spmv.spmv(diag, x, soff, deltas_pitz)
            torch.cuda.synchronize()
            ref = spmv.plain(diag, x, soff, deltas_pitz)
            scale = float(torch.max(torch.abs(ref)))
            err = float(torch.max(torch.abs(got - ref)))
            ok = bool(torch.allclose(got, ref, rtol=rtol,
                                     atol=atol * scale))
            if dtype == torch.float32:
                max_err = max(max_err, err)
            cases.append({"case": name, "dtype": str(dtype), "ok": ok,
                          "n": int(x.shape[0]),
                          "ncols": 1 if x.ndim == 1 else int(x.shape[1]),
                          "offsets": len(deltas_pitz),
                          "max_abs_err": err, "scale": scale})
            check(ok, f"spmv kernel disagrees with plain: {name} {dtype}")
            if dtype == torch.float32 and name == "pitz_p":
                t = [time_ms(lambda: spmv.plain(diag, x, soff, deltas_pitz)),
                     time_ms(lambda: spmv.spmv(diag, x, soff, deltas_pitz)),
                     time_ms(lambda: spmv.spmv(diag, x, soff, deltas_pitz)),
                     time_ms(lambda: spmv.plain(diag, x, soff, deltas_pitz))]
                timing_pitz = {"kernel_ms": min(t[1], t[2]),
                               "plain_ms": min(t[0], t[3]), "runs_ms": t}
    emit({"phase": "kernel", "cases": cases, "max_abs_err_f32": max_err,
          "n160000_f32": timing, "n4160_pitz_p_f32": timing_pitz,
          "kernel_us": timing["kernel_ms"] * 1e3,
          "plain_us": timing["plain_ms"] * 1e3,
          "pitz_kernel_us": timing_pitz["kernel_ms"] * 1e3,
          "pitz_plain_us": timing_pitz["plain_ms"] * 1e3})
    return max_err, timing


def phase_physics():
    from foamtpu_torch.apps.cases import make_cavity
    from foamtpu_torch.solvers import piso

    mesh, state, cfg = make_cavity(20, device="cuda")
    cfg = cfg._replace(p_controls={
        "solver": "PCG", "preconditioner": "diagonal",
        "tolerance": 1e-6, "relTol": 0.0, "maxIter": 2000})
    step = piso.make_step(mesh, cfg)
    t0 = time.perf_counter()
    for _ in range(100):
        state, diag = step(state, 0.005)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    u = state["U"].data.cpu().numpy().reshape(20, 20, 3)
    ucl = 0.5 * (u[9, :, 0] + u[10, :, 0])
    vcl = 0.5 * (u[:, 9, 1] + u[:, 10, 1])
    ke = float(np.mean(np.sum(u ** 2, axis=-1)))
    out = {"phase": "physics", "case": "cavity 20x20, 100 steps, PCG",
           "ucl_max_err": float(np.abs(ucl - GOLDEN_UCL).max()),
           "vcl_max_err": float(np.abs(vcl - GOLDEN_VCL).max()),
           "ke": ke, "ke_golden": GOLDEN_KE,
           "continuity": float(diag["continuity"]), "seconds": sec}
    emit(out)
    np.testing.assert_allclose(ucl, GOLDEN_UCL, atol=2e-4)
    np.testing.assert_allclose(vcl, GOLDEN_VCL, atol=2e-4)
    np.testing.assert_allclose(ke, GOLDEN_KE, rtol=1e-3)
    check(float(diag["continuity"]) < 1e-5, out)


def phase_headline(spmv, n=400, nsteps=10, trials=3):
    from foamtpu_torch.apps.cases import make_cavity
    from foamtpu_torch.solvers import piso

    spmv.LAUNCHES = 0
    t0 = time.perf_counter()
    # bench.py:146-153: GAMG p-solve, tol 1e-7, relTol 0.01
    mesh, state, cfg = make_cavity(n, p_solver={
        "solver": "GAMG", "preconditioner": "polynomial",
        "tolerance": 1e-7, "relTol": 0.01, "maxIter": 1000}, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    levels = cfg.p_controls["_gamg"].levels
    dt = 0.5 * (0.1 / n)
    chunk = piso.make_chunk(mesh, cfg, nsteps)
    t0 = time.perf_counter()
    state, diag = chunk(state, dt)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches0 = spmv.LAUNCHES
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        state, diag = chunk(state, dt)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / nsteps)
    launches = spmv.LAUNCHES
    finite = all(bool(torch.isfinite(t).all()) for t in (
        state["U"].data, state["p"].data, state["phi"]))
    out = {"phase": "headline",
           "case": f"icoFoam cavity {n}x{n} GAMG (bench.py p-controls)",
           "n_cells": mesh.n_cells, "dtype": str(mesh.v.dtype),
           "gamg_levels": len(levels),
           "max_offsets_per_level": max(
               [len(mesh.st_deltas)] + [len(lv.plane_deltas)
                                        for lv in levels]),
           "setup_s": setup_s, "warmup_chunk_s": warm_s,
           "sec_per_step": statistics.median(times),
           "trial_sec_per_step": times,
           "steps": nsteps * (trials + 1),
           "p_iters": int(diag["p_iters"]),
           "p_final": float(diag["p_final"]),
           "u_iters": int(diag["Ux"].n_iterations),
           "continuity": float(diag["continuity"]),
           "courant_max": float(diag["courant_max"]),
           "spmv_launches_per_step": (launches - launches0)
           / (nsteps * trials),
           "spmv_launches_total": launches,
           "finite": finite,
           "u_max": float(torch.max(torch.abs(state["U"].data))),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(out)
    # bench.py's p-controls stop every corrector at relTol 0.01, so the
    # continuity error is set by that residual: the JAX package recorded
    # 3.45e-4 on this case (BENCH_r03.json), far above the 20^2 bound of
    # 1e-5 that tests/test_cavity.py uses with tight controls.
    check(out["continuity"] < 1e-3, out["continuity"])
    check(finite, "non-finite U, p or phi")
    check(out["u_max"] <= 1.0 + 1e-3, "|U| above the lid velocity")
    check(launches > 0 and out["spmv_launches_per_step"] > 0,
          "the main path did not launch the SpMV kernel")
    return out


def pitz_oracles(mesh, state, min_ux_seen, ux_res):
    """tests/test_pitzdaily.py:79-102 on the port's state."""
    c = mesh.c.cpu().numpy()
    u = state["U"].data.cpu().numpy()
    k = state["turb"]["k"].data.cpu().numpy()
    nut = state["turb"]["nut"].data.cpu().numpy()
    wall = (c[:, 1] < -0.02) & (c[:, 0] > 0)
    xs = c[wall, 0]
    neg = xs[u[wall, 0] < 0]
    x_r = float(neg.max()) if neg.size else 0.0
    out = {"finite": bool(np.isfinite(u).all() and np.isfinite(k).all()
                          and np.isfinite(nut).all()),
           "k_min": float(k.min()), "nut_min": float(nut.min()),
           "u_max": float(np.abs(u).max()), "k_max": float(k.max()),
           "min_ux_behind_step": min_ux_seen,
           "ux_res_last": ux_res[-1], "ux_res_early_max": max(ux_res[:3]),
           "x_reattach": x_r, "nut_max": float(nut.max())}
    checks = {"finite": out["finite"], "k>0": out["k_min"] > 0,
              "nut>=0": out["nut_min"] >= 0, "|U|<15": out["u_max"] < 15.0,
              "k<15": out["k_max"] < 15.0,
              "recirculation": min_ux_seen < -0.05,
              "residual halves": ux_res[-1] < max(ux_res[:3]) / 2,
              "residual<8e-3": ux_res[-1] < 8e-3,
              "x_r in [0.10,0.23]": 0.10 < x_r < 0.23,
              "nut_max>2e-4": out["nut_max"] > 20 * 1e-5}
    return out, checks


def phase_pitz(spmv, here, root, trials=3):
    from foamtpu_torch.solvers import simple

    torch.cuda.reset_peak_memory_stats()
    spmv.LAUNCHES = 0
    t0 = time.perf_counter()
    mesh, cfg, state = pitz_setup(here, root)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    chunk = simple.make_chunk(mesh, cfg, PITZ_CHUNK)
    c = mesh.c
    behind = (c[:, 0] > 0.0) & (c[:, 0] < 0.06) & (c[:, 1] < -0.005)
    min_ux, ux_res, times = 1e9, [], []
    launches0 = None
    t_run = time.perf_counter()
    for i in range(PITZ_CHUNKS):
        t0 = time.perf_counter()
        state, diag = chunk(state)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / PITZ_CHUNK
        if i == 0:
            launches0 = spmv.LAUNCHES
        elif i <= trials:
            times.append(dt)
        if i == trials:
            launches_timed = spmv.LAUNCHES - launches0
        ux = state["U"].data
        check(bool(torch.isfinite(ux).all()), f"diverged in chunk {i}")
        min_ux = min(min_ux, float(ux[behind, 0].min()))
        ux_res.append(float(diag["Ux"].initial_residual.max()))
    run_s = time.perf_counter() - t_run
    launches = spmv.LAUNCHES
    oracles, checks = pitz_oracles(mesh, state, min_ux, ux_res)
    iters = {"p": int(diag["p_iters"]),
             "U": int(diag["Ux"].n_iterations),
             "k": int(diag["turb_k"].n_iterations),
             "epsilon": int(diag["turb_epsilon"].n_iterations)}
    # the time share per solve: one more chunk, each solve fenced
    n_share = 20
    with SolveLog(state, fence=True) as log:
        t0 = time.perf_counter()
        state, _ = simple.make_chunk(mesh, cfg, n_share)(state)
        torch.cuda.synchronize()
        fenced_s = time.perf_counter() - t0
    out = {"phase": "pitz",
           "case": "simpleFoam pitzDaily, kEpsilon + wall functions, "
                   "unmodified tutorial files",
           "n_cells": mesh.n_cells, "n_faces": mesh.n_faces,
           "st_deltas": list(mesh.st_deltas),
           "n_fallback": int(mesh.fb_cells.shape[0]),
           "dtype": str(mesh.v.dtype),
           "gamg_levels": len(cfg.p_controls["_gamg"].levels),
           "setup_s": setup_s,
           "iterations": PITZ_CHUNK * PITZ_CHUNKS, "run_s": run_s,
           "simple_sec_per_iter": statistics.median(times),
           "trial_sec_per_iter": times,
           "last_iter_solver_iterations": iters,
           "spmv_launches_per_iter": launches_timed / (PITZ_CHUNK * trials),
           "spmv_launches_total": launches,
           "p_initial": float(diag["p_initial"]),
           "continuity": float(diag["continuity"]),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "solve_share_fenced": {k: v / fenced_s
                                  for k, v in log.seconds.items()},
           "solve_calls_fenced": log.calls,
           "fenced_sec_per_iter": fenced_s / n_share,
           "oracles": oracles, "checks": checks}
    emit(out)
    for name, ok in checks.items():
        check(ok, f"pitzDaily oracle {name}: {oracles}")
    check(launches > 0 and out["spmv_launches_per_iter"] > 0,
          "the pitzDaily path did not launch the SpMV kernel")
    return out, (mesh, cfg, state)


def profile_pitz(spmv, pitz_run, sec_per_iter, n=10, top=12):
    """One n-iteration pitzDaily chunk under torch.profiler (CPU + CUDA),
    each linear solve in a record_function range named after its field,
    with the SpMV launches counted over the same chunk. Device time is
    the sum over device-side events (the GPU copies of the
    record_function ranges are spans, not work, and are left out); the
    busy share divides it by the unprofiled time per iteration."""
    from torch.profiler import ProfilerActivity, profile

    from foamtpu_torch.solvers import simple

    mesh, cfg, state = pitz_run
    chunk = simple.make_chunk(mesh, cfg, n)
    launches0 = spmv.LAUNCHES
    with SolveLog(state, ranges=True) as log:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, diag = chunk(state)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spmv_launches = spmv.LAUNCHES - launches0
    ka = prof.key_averages()

    def dev(e, attr):
        return float(getattr(e, attr, getattr(e, attr.replace(
            "device", "cuda"), 0.0)))

    # device-side events (kernels, copies, memsets); the CPU ops carry
    # the same time again as their children's
    work = [e for e in ka
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("solve_")]
    device_ms = sum(dev(e, "self_device_time_total") for e in work) / 1e3
    solves = {e.key[len("solve_"):]: {
        "cpu_ms_per_call": e.cpu_time_total / 1e3 / e.count,
        "device_ms_per_call": dev(e, "device_time_total") / 1e3 / e.count}
        for e in ka if e.key.startswith("solve_") and e.cpu_time_total > 0}
    spmv_device_ms = sum(dev(e, "self_device_time_total") for e in work
                         if e.key.startswith("void spmv_stencil_kernel"))
    kernels = sorted(((dev(e, "self_device_time_total") / 1e3 / n,
                      e.count / n, e.key[:70]) for e in work),
                     reverse=True)[:top]
    launches = sum(e.count for e in ka if e.key == "cudaLaunchKernel")
    emit({"phase": "pitz_profile", "iterations": n,
          "profiled_wall_s": wall,
          "device_ms_per_iter": device_ms / n,
          "device_busy_share_unprofiled": device_ms / n / 1e3 / sec_per_iter,
          "cuda_launch_kernel_per_iter": launches / n,
          "spmv_launches_per_iter": spmv_launches / n,
          "spmv_device_ms_per_iter": spmv_device_ms / 1e3 / n,
          "solver_iterations": {
              "p": int(diag["p_iters"]), "U": int(diag["Ux"].n_iterations),
              "epsilon": int(diag["turb_epsilon"].n_iterations),
              "k": int(diag["turb_k"].n_iterations)},
          "solve_calls": log.calls, "solves": solves,
          "top_kernels_ms_per_iter": kernels})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from foamtpu_torch.ops import spmv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(smi, flush=True)
    built = spmv.build()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "build_s": built["seconds"],
          "library": os.path.relpath(built["path"], here),
          "ptxas": built["log"][-1500:]})

    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        mesh, cfg, state = pitz_setup(here, os.path.join(root, "ops"))
        ops = pitz_operands(mesh, cfg, state)
        max_err, timing = phase_kernel(spmv, ops, tuple(mesh.st_deltas))
        del mesh, cfg, state, ops
        phase_physics()
        head = phase_headline(spmv)
        pitz, pitz_run = phase_pitz(spmv, here, os.path.join(root, "run"))
        profile_pitz(spmv, pitz_run, pitz["simple_sec_per_iter"])
    finally:
        shutil.rmtree(root, ignore_errors=True)

    emit({"kernels": [{
        "name": "spmv_stencil", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": head["spmv_launches_total"] + pitz["spmv_launches_total"],
        "max_abs_err": max_err, "ms": timing["kernel_ms"],
        "plain_ms": timing["plain_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
