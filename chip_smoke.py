"""Smoke run of the foamtpu_torch port on one CUDA card.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits non-zero):
  1. device: the card's name and power limit, and the build of the
     offset-stencil SpMV kernel (foamtpu_torch/csrc/spmv_stencil.cu).
  2. kernel: the kernel against its plain torch version on the card, at
     the shapes of tests/test_pallas_spmv.py plus a [160000, 3] operand
     and a no-diagonal call, in float32 and float64, with timings.
  3. physics: the 20^2 icoFoam cavity, 100 steps, against the goldens of
     tests/test_cavity.py.
  4. headline: the 400^2 cavity with the GAMG pressure controls of
     bench.py, one 10-step warm-up chunk and three timed 10-step chunks;
     the SpMV launch count shows the main path ran through the kernel.
Then the kernel table and the final `{"ok": true, ...}` line.

It needs a CUDA card and the repository's foamtpu_torch package beside
it; without either it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

KERNEL_SOURCE = "foamtpu_torch/csrc/spmv_stencil.cu"
KERNEL_REPLACES = "openfoam-2.2.x_tpu/ops/pallas_spmv.py:109"

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


def phase_kernel(spmv):
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
    emit({"phase": "kernel", "cases": cases, "max_abs_err_f32": max_err,
          "n160000_f32": timing,
          "kernel_us": timing["kernel_ms"] * 1e3,
          "plain_us": timing["plain_ms"] * 1e3})
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

    max_err, timing = phase_kernel(spmv)
    phase_physics()
    head = phase_headline(spmv)

    emit({"kernels": [{
        "name": "spmv_stencil", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": head["spmv_launches_total"],
        "max_abs_err": max_err, "ms": timing["kernel_ms"],
        "plain_ms": timing["plain_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
