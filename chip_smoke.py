"""Smoke run of the foamtpu_torch port on one CUDA card.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits non-zero):
  1. device: the card's name and power limit, and the build of the
     offset-stencil SpMV kernel with its fused COO remainder
     (foamtpu_torch/csrc/spmv_stencil.cu).
  2. kernel: the kernel against its plain torch version (the roll chain,
     then the remainder by index_add) on the card, at the shapes of
     tests/test_pallas_spmv.py plus a [160000, 3] operand and a
     no-diagonal call, and with random unsorted COO remainders (repeated
     cells, empty rows, a row of six entries) at n = 1024, 5000 and
     160,000, [n] and [n, 3], with and without a diagonal, plus the
     scalar-load, generic-M, no-slot and C = 2, 4, 8 bodies, in float32
     and float64, with timings; and at pitzDaily's own stencil (its
     st_deltas with the pressure matrix [n] and the relaxed momentum
     matrix [n, 3] that the first SIMPLE iteration hands to its linear
     solves), whole operator included.
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
  6. duct: bench.py's unstructured row at its own size, the 589,824-cell
     tet duct (96x32x32x6, simpleFoam + kOmegaSST + omegaWallFunction,
     GAMG p): set-up split into mesh build, to_device, wall distance and
     GAMG hierarchy; a 5-iteration warm-up chunk and three timed
     5-iteration chunks (bench.py's BENCH_UNSTRUCT_ITERS); per-iteration
     solver iterations, held to tests/test_turbulence.py's bounds and to
     the JAX package's COO fraction of this mesh.
  7. kernel_duct: the kernel against its plain version at the duct's own
     operands (the pressure matrix [n] and the relaxed momentum matrix
     [n, 3] of its first SIMPLE iteration), whole operator included, at
     one GAMG plane level whose COO remainder is not row-sorted, and at
     the coarsest level's dense assembly (C = n); the slot part alone
     and the whole operator (one launch) timed against a CSR product.
  8. duct_profile: one 2-iteration duct chunk under torch.profiler.
  9. cavity_ras: pisoFoam on the unmodified cavityRAS tutorial (Case,
     kEpsilon with wall functions, limitedLinearV 1, GAMG p) for its 200
     steps, held to its oracles and to goldens from the JAX package.
 10. pimple_ras: pimpleFoam on the unmodified cavityRAS tutorial through
     the port's application (blockMesh, `run(case)`: nOuterCorrectors 2,
     nCorrectors 2, kEpsilon, GAMG p) for its 200 steps, held to goldens
     from the JAX package and to continuity < 1e-6; and one step with
     nOuterCorrectors 1 held to piso_step on the card.
 11. pimple_headline: the 400^2 cavity of phase 4 as PimpleConfig(n_outer=2,
     n_correctors=2, alpha_u=0.7, alpha_p=0.3): a 10-step warm-up chunk,
     three timed 10-step chunks, and one 5-step chunk under
     torch.profiler.
 12. dambreak: interFoam (MULES VOF) on the damBreak tutorial through
     blockMesh, setFields and the port's application: 20 steps held to
     goldens from the JAX package, 120 steps held to the invariants of
     tests/test_interfoam.py (see DAMBREAK_STEPS); then the same case at
     736^2 cells (541,696, deltaT 6.25e-05): two warm-up steps through
     the application, three timed 10-step chunks of the application's
     step, one 3-step chunk under torch.profiler, the invariants, and the
     SpMV kernel held to its plain version and timed at the p_rgh operand.
 13. basic: nonNewtonianIcoFoam (crossCavity, 50 steps), laplacianFoam
     (heatedBlock), scalarTransportFoam (pulse, after setFields) and
     potentialFoam (channel) from their unmodified tutorials through
     run(case), held to goldens from the JAX package and to their
     invariants (nu inside [nuInf, nu0], T between its boundary values, T
     bounded and conserved, div(phi) ~ 0 and U = (1 0 0)).
 14. cross_headline: crossCavity at 400^2 with a functions block (forces,
     probes, fieldMinMax, fieldValues) through the application's loop:
     three 10-step chunks with the function objects and three without,
     in turns, the host time of fol.execute per step and per object, its
     fetches, one profiled chunk; no object may fail, each writes its rows.
 15. heated_1m: heatedBlock at 1024^2 (1,048,576 cells): one step through
     run(case), ten of the application's step timed with their T
     iterations, one profiled chunk, and the SpMV kernel held to its
     plain version and timed at the T operand.
Every timed SpMV shape (kernel, plain version, one CSR product from
torch.sparse as the library yardstick) gets its device time per call
from torch.profiler, back to back with the operands warm in L2 and
again with L2 flushed before each call (per call the profile recorded:
CUPTI loses events), the kernel's flushed time also from a CUDA graph
without the profiler, and its wrapper time per call back to back by
CUDA events (the host launch path, where that is the slower side),
beside its HBM bound: the bytes it must move (each input
read once, each output written once; the remainder as its int32 row
pointers, int32 columns and coefficients) over 3.35 TB/s (H100 SXM data
sheet).
Then the kernel table and the final `{"ok": true, ...}` line.

It needs a CUDA card and the repository's foamtpu_torch package beside
it; without either it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
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

DUCT = (96, 32, 32)   # bench.py's BENCH_UNSTRUCT default: 589,824 tets
DUCT_CHUNK = 5        # bench.py's BENCH_UNSTRUCT_ITERS
DUCT_TRIALS = 3
# the JAX package's COO fraction of this mesh (NOTES_r5.md:55-57); a
# property of the mesh, so it holds to 0.002
DUCT_COO_FRACTION = 0.327
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, data sheet
F32_FLOPS = 67e12           # H100 SXM, float32 outside the tensor cores
L2_FLUSH_BYTES = 128 << 20  # written before each flushed launch (L2: 50 MB)
INCOMPLETE_PROFILES = 0     # device_ms profiles that missed device work
CAVITY_RAS_CASE = os.path.join("tutorials", "incompressible", "pisoFoam",
                               "cavityRAS")
CAVITY_RAS_STEPS = 200   # the tutorial's endTime 0.1 / deltaT 0.0005
CAVITY_RAS_UCL = (2, 6, 10, 14, 18)   # centreline rows of the 20x20 grid
# tests/test_torch_pisoturb.py::reference_cavity_ras: the JAX package on
# the CPU in float32, the tutorial's 200 steps. Held at 1e-3 relative.
CAVITY_RAS_GOLDEN = {
    "ke": 0.00014997612743172795,
    "k_max": 0.0036708072293549776,
    "nut_max": 0.001575167290866375,
    "ucl": [-0.001463092747144401, -0.0021033992525190115,
            -0.0035601831041276455, -0.005434846971184015,
            0.0026751933619379997],
}

PIMPLE_RAS_CASE = os.path.join("tutorials", "incompressible", "pimpleFoam",
                               "cavityRAS")
PIMPLE_RAS_STEPS = 200   # the tutorial's endTime 0.1 / deltaT 0.0005
# tests/test_torch_pimple.py::reference_pimple_ras: the JAX package's
# pimplefoam on the CPU in float32, the tutorial's 200 steps. Held at 1e-3
# relative.
PIMPLE_RAS_GOLDEN = {
    "ke": 0.00014997422113083303,
    "k_max": 0.0036708081606775522,
    "nut_max": 0.0015751677565276623,
    "ucl": [-0.0014631750527769327, -0.0021035117097198963,
            -0.003560975193977356, -0.00543519202619791,
            0.0026772094424813986],
}
DAMBREAK_CASE = os.path.join("tutorials", "multiphase", "interFoam",
                             "laminar", "damBreak")
DAMBREAK_GOLDEN_STEPS = 20    # of the tutorial's deltaT 0.001
# The invariants are held at step 120 (t = 0.12, the front well on its
# way). At step 146, when the front has reached the obstacle, the p_rgh
# solve of this tutorial (fixed deltaT 0.001) returns NaN: in the JAX
# package's interfoam_app too, at the same step, in float32 and float64
# alike (continuity jumps to 6.5e-2 at step 144 first), and the port
# mirrors the reference. So a run to 200 steps is not held.
DAMBREAK_STEPS = 120
DAMBREAK_N = 46               # the tutorial's block: 46 x 46 x 1
# three cells inside the water column at t = 0.02
DAMBREAK_P_CELLS = (2 * 46 + 2, 6 * 46 + 10, 9 * 46 + 16)
# tests/test_torch_interfoam.py::reference_dambreak: the JAX package's
# blockMesh, setFields and interfoam_app on the CPU in float32, 20 steps.
# Held at 1e-3 relative (alpha's extrema relative to 1: its minimum is 0).
DAMBREAK_GOLDEN = {
    "water_volume": 0.0012989784175101947,
    "u_max": 0.9744970202445984,
    "alpha_min": -1.0269972941729169e-13,
    "alpha_max": 1.0000147819519043,
    "p_rgh": [1155.385498046875, 1525.573486328125, 2090.9296875],
}
DAMBREAK_BIG_N = 736          # 541,696 cells, 16x the tutorial per side
DAMBREAK_BIG_DT = 6.25e-05    # the tutorial's 0.001 / 16: the same Courant
DAMBREAK_BIG_CHUNK = 10
DAMBREAK_BIG_WARMUP = 2

# The basic phase: each tutorial as shipped, from its case files through
# run(case), for `steps` steps (the whole run but for crossCavity, 50 of
# its 200).
BASIC_CASES = {
    "nonNewtonianIcoFoam": (os.path.join(
        "tutorials", "incompressible", "nonNewtonianIcoFoam", "crossCavity"),
        50),
    "laplacianFoam": (os.path.join(
        "tutorials", "basic", "laplacianFoam", "heatedBlock"), 100),
    "scalarTransportFoam": (os.path.join(
        "tutorials", "basic", "scalarTransportFoam", "pulse"), 100),
    "potentialFoam": (os.path.join(
        "tutorials", "basic", "potentialFoam", "channel"), 1),
}
BASIC_COLS = (1, 5, 10, 14, 18)    # crossCavity: cells along its centre rows
HEATED_COLS = (0, 1, 2, 3)    # heatedBlock: the heat reaches ~1 cm in 0.5 s
# the least magnitude each golden's error is taken relative to: the lid
# velocity's 1e-2, 0.1 K of heatedBlock's rise
BASIC_FLOOR = {"ucl": 1e-2, "rise_row": 0.1}
# tests/test_torch_basic.py::reference_basic: the JAX package's blockMesh,
# setFields and application on the CPU in float32, the steps above. Held
# at 1e-3 relative (tests/test_torch_basic.py: the CPU port is within
# 4e-5 of them).
BASIC_GOLDEN = {
    "nonNewtonianIcoFoam": {
        "ke": 0.0001863329836508016,
        "u_max": 0.06779012829065323,
        "ucl": [-0.0009118674206547439, -0.002317975740879774,
                -0.004981556674465537, -0.007363141747191548,
                0.0037270241882652044],
        "nu_min": 5.93498807575088e-05,
        "nu_max": 0.009989469312131405,
    },
    "laplacianFoam": {
        "rise_mean": 4.569947814941406,
        "rise_row": [64.50039672851562, 20.8099365234375,
                     4.97894287109375, 0.941131591796875],
    },
    "scalarTransportFoam": {
        "t_max": 0.9584218263626099,
        "t_sum": 10.000032159113136,
        "t_centroid": 0.5999556363207048,
    },
    "potentialFoam": {
        "ux_mean": 0.99995709836483,
        "ux_min": 0.999934196472168,
        "ux_max": 1.0000028610229492,
    },
}
# crossCavity at 400^2 (160,000 cells, the headline's width), deltaT cut
# by the refinement (20x) so the Courant number is the tutorial's, p on
# bench.py's GAMG controls (the tutorial's PCG, polynomial, stops at its
# 1,000-iteration cap in every solve at this width: 995 iterations, 1.6
# s/step, continuity 2e-3), with a functions block of the four most used
# types
CROSS_N = 400
CROSS_DT = 0.0005 / 20
CROSS_CHUNK = 10
CROSS_FUNCS = """
functions
{
    lidForces { type forces; patches ( movingWall ); rhoInf 1; }
    probes1
    {
        type probes;
        probeLocations ( (0.025 0.025 0.005) (0.05 0.05 0.005)
                         (0.075 0.075 0.005) );
        fields ( p U );
    }
    minMax { type fieldMinMax; fields ( U p ); }
    pAverage { type fieldValues; source all; operation volAverage;
               fields ( p ); }
}
"""
# heatedBlock at 1024^2 (1,048,576 cells), the tutorial's deltaT and
# controls (PCG, polynomial, tolerance 1e-9, maxIter 500)
HEATED_N = 1024
HEATED_STEPS = 10
# the rotating-frame and porous applications from their tutorials, as
# shipped, through run(case): the SIMPLE cases 50 iterations of their
# 500 / 2000, the PIMPLE cases whole, interFoam 20 steps
ROTATING_CASES = {
    "MRFSimpleFoam": (os.path.join(
        "tutorials", "incompressible", "MRFSimpleFoam", "mixerVessel2D"), 50),
    "SRFSimpleFoam": (os.path.join(
        "tutorials", "incompressible", "SRFSimpleFoam", "rotatingMixer"), 50),
    "porousSimpleFoam": (os.path.join(
        "tutorials", "incompressible", "porousSimpleFoam", "angledDuct"), 50),
    "MRFPimpleFoam": (os.path.join(
        "tutorials", "incompressible", "MRFPimpleFoam", "mixerVessel2D"), 10),
    "SRFPimpleFoam": (os.path.join(
        "tutorials", "incompressible", "SRFPimpleFoam", "rotatingMixer"), 10),
    "MRFInterFoam": (os.path.join(
        "tutorials", "multiphase", "MRFInterFoam", "damBreak"), 20),
    "porousInterFoam": (os.path.join(
        "tutorials", "multiphase", "porousInterFoam", "damBreak"), 20),
}
# the mixer (4 blocks of 12 radial x 24 tangential cells): the rotor wall
# at r = 0.02 m turns at 104.72 rad/s (MRFZones) or 1000 rpm
# (SRFProperties); rings of cells, inside out, whose means the goldens hold
MIXER_TIP = 104.72 * 0.02
MIXER_RINGS = (0, 3, 6, 9, 11)
# the goldens' error is taken relative to max(|golden|, floor): the mixer's
# velocities relative to the rotor's speed and its pressures to the rotor's
# dynamic pressure (the outer rings are at rest to 1e-4 of them), alpha's
# extrema to 1
ROTATING_FLOOR = {"u_theta": MIXER_TIP, "p_ring": 0.5 * MIXER_TIP ** 2,
                  "alpha_min": 1.0, "alpha_max": 1.0}
# tests/test_torch_rotating.py::reference_rotating: the JAX package's
# blockMesh, setFields and application on the CPU in float32, the steps of
# ROTATING_CASES. The PIMPLE tutorials diverge there (their steadyState
# ddt runs unrelaxed: Courant 8 at step 1, ~1e15 at step 10, ROADMAP
# Queue 3): their golden is that divergence
ROTATING_GOLDEN = {
    "MRFSimpleFoam": {
        "u_theta": [1.1980989388239767, 0.03584116764376558, 0.00010695027569310573, -0.00012380293204812147, -2.6251307166434886e-05],
        "p_ring": [-0.4031275875937433, 0.07509347517043352, -0.005547327610353647, -4.238480081159013e-05],
        "u_max": 1.205424092681386,
    },
    "SRFSimpleFoam": {
        "u_theta": [1.1986230658696686, 0.036001779459491456, 0.0006469387588837434, -0.00012185385269505401, -8.735247599326837e-05],
        "p_ring": [-0.4037089303255802, 0.08108994551002979, -0.021918345242738724, 0.004079189772407232],
        "u_max": 1.2057848166301635,
    },
    "porousSimpleFoam": {
        "ux_zone": 5.013888327938743,
    },
    "MRFPimpleFoam": {
        "diverged": True,
    },
    "SRFPimpleFoam": {
        "diverged": True,
    },
    "MRFInterFoam": {
        "water_volume": 0.001298978424777084,
        "u_max": 0.974524199962616,
        "alpha_min": -1.5388854978247011e-24,
        "alpha_max": 1.0000135898590088,
        "p_rgh": [1155.3929443359375, 1525.5765380859375, 2090.925537109375],
    },
    "porousInterFoam": {
        "water_volume": 0.0012989784096682688,
        "u_max": 0.9739917516708374,
        "alpha_min": -7.00107333550913e-21,
        "alpha_max": 1.000013828277588,
        "p_rgh": [1155.4501953125, 1525.6279296875, 2090.958984375],
    },
}
# MRFSimpleFoam on mixerVessel2D with every block's (12 24 1) scaled 16x:
# 294,912 cells, the tutorial's schemes, BCs and MRF zone. The tutorial's
# PCG p stops at its 1,000 cap in the first iteration, so p takes
# bench.py's GAMG controls; the second p solve of an iteration
# (nNonOrthogonalCorrectors 1 on this orthogonal mesh solves the same
# system again, from the first's answer) then often runs to the cap in
# float32 (0.2 s per iteration on the card, 3.4 s when it does). Chunks of
# 3 iterations (the profiled one 2) keep the phase under 200 s
MRF_HEAD_SCALE = 16
MRF_HEAD_CHUNK = 3
MRF_HEAD_PROFILE = 2

SPMV_SHAPES = {"n1024": (1024, (1, -1, 16, -16)),
               "n5000": (5000, (1, -1, 128, -128, 3000, -3000)),
               "n160000": (160000, (1, -1, 400, -400))}
SPMV_CASES = [  # (name, n, deltas, ncols, with_diag, with_remainder)
    ("n1024", 1024, (1, -1, 16, -16), 1, True, False),
    ("n160000", 160000, (1, -1, 400, -400), 1, True, False),
    ("n5000", 5000, (1, -1, 128, -128, 3000, -3000), 1, True, False),
    ("n160000x3", 160000, (1, -1, 400, -400), 3, True, False),
    ("n160000_nodiag", 160000, (1, -1, 400, -400), 1, False, False),
] + [(f"{name}{'' if c == 1 else 'x%d' % c}_fb{'' if d else '_nodiag'}",
      n, deltas, c, d, True)
     for name, (n, deltas) in SPMV_SHAPES.items()
     for c in (1, 3) for d in (True, False)] + [
    ("n5000_m3_fb", 5000, (1, -1, 64), 1, True, True),      # scalar loads
    ("n5000_m10_fb", 5000, (1, -1, 2, -2, 50, -50, 100, -100, 200, -200),
     1, True, True),                                        # generic body
    ("n1024_m0_fb", 1024, (), 1, True, True),               # no slot
    ("n1024x2_fb", 1024, (1, -1, 16, -16), 2, True, True),
    ("n1024x4_fb", 1024, (1, -1, 16, -16), 4, False, True),
    ("n1024x8_fb", 1024, (1, -1, 16, -16), 8, True, True),  # (cell, column)
]
# float32: rtol 2e-6 / atol 2e-5 (tests/test_pallas_spmv.py; FMA and
# summation order differ from the roll chain). float64: rtol 1e-12 with
# atol 1e-12 for outputs that cancel to near zero (O(1) inputs, 7 terms).
TOL = {torch.float32: (2e-6, 2e-5), torch.float64: (1e-12, 1e-12)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def progress(phase, what) -> None:
    """A phase's progress on stderr, with the script's elapsed seconds."""
    sys.stderr.write(f"[{time.perf_counter() - T_START:.1f} s] {phase}: "
                     f"{what}\n")
    sys.stderr.flush()


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
    soff = rng.standard_normal((n, max(len(deltas), 1)))
    idx = np.arange(n)
    for m, d in enumerate(deltas):
        soff[(idx + d < 0) | (idx + d >= n), m] = 0.0

    def dev(a):
        return None if a is None else torch.tensor(a, dtype=dtype,
                                                   device="cuda")
    return dev(diag), dev(x), dev(soff)


def random_remainder(spmv, n, dtype, seed=0):
    """A random COO remainder for an n-row operator, unsorted, with
    repeated cells, rows with no entry (the upper half and random gaps)
    and one row of six entries, with its row layout, on the card."""
    rng = np.random.default_rng(seed + 100)
    nfb = max(n // 3, 12)
    cells = rng.integers(0, max(n // 2, 1), nfb)
    cells[rng.choice(nfb, 6, replace=False)] = n // 4
    nbrs = rng.integers(0, n, nfb)
    coeffs = rng.standard_normal(nfb)

    def dev(a, dt):
        return torch.tensor(a, dtype=dt, device="cuda")
    layout = spmv.row_layout(cells, nbrs, n, "cuda")
    check(layout.order is not None, "the random remainder came out sorted")
    return spmv.remainder(dev(cells, torch.int64), dev(nbrs, torch.int64),
                          dev(coeffs, dtype), layout)


def mesh_remainder(spmv, mesh, sfb, dtype):
    """The mesh's COO remainder with a matrix's coefficients sfb."""
    return spmv.remainder(mesh.fb_cells, mesh.fb_nbrs,
                          sfb.to(dtype).contiguous(), mesh.fb_layout)


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


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def duct_setup(nx, ny, nz, device="cuda"):
    """bench.py's unstructured row (bench.py:417-486) through the port:
    the 6-tet split of an nx*ny*nz box of size 4x1x1, U=1 inlet with
    inletOutlet outlet and no-slip walls, simpleFoam + kOmegaSST with
    omegaWallFunction/kqRWallFunction/nutkWallFunction, GAMG p with the
    polynomial preconditioner. Returns (mesh, cfg, state,
    seconds) with the set-up time split into mesh build, to_device,
    wall distance and GAMG hierarchy."""
    from foamtpu_torch.bc import patchfields as pf
    from foamtpu_torch.core.dictionary import FoamDict, Word
    from foamtpu_torch.core.dimensions import (DimensionSet, dimVelocity,
                                               dimViscosity)
    from foamtpu_torch.core.fields import vol_scalar, vol_vector
    from foamtpu_torch.mesh import to_device
    from foamtpu_torch.mesh.tetmesh import tet_box
    from foamtpu_torch.models.turbulence.base import select
    from foamtpu_torch.solvers import piso, simple
    from foamtpu_torch.solvers.linear.gamg import GAMG

    seconds = {}
    t0 = time.perf_counter()
    pm = tet_box(nx, ny, nz, size=(4.0, 1.0, 1.0))
    seconds["mesh_build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = to_device(pm, device)
    _sync(device)
    seconds["to_device"] = time.perf_counter() - t0

    nu = 1e-5
    k0 = 1.5 * (1.0 * 0.05) ** 2
    w0 = k0 ** 0.5 / (0.09 ** 0.25 * 0.1)

    def bcs_for(inlet_val, wall_kind):
        out = []
        for p in mesh.patches:
            v = np.asarray(inlet_val, dtype=np.float64)
            shape = (p.size,) if v.ndim == 0 else (p.size, 3)

            def pface(val):
                return torch.broadcast_to(torch.as_tensor(
                    val, dtype=mesh.v.dtype, device=mesh.device), shape)

            if p.name == "inlet":
                out.append(pf.fixed_value(pface(inlet_val)))
            elif p.name == "outlet":
                out.append(pf.make("inletOutlet", ref_value=pface(0.0 * v)))
            elif wall_kind == "fixedValue":
                out.append(pf.fixed_value(pface(0.0 * v)))
            else:
                out.append(pf.make(wall_kind, ref_value=pface(0.0 * v)))
        return tuple(out)

    U = vol_vector(mesh, [1.0, 0.0, 0.0], name="U", dims=dimVelocity,
                   bcs=bcs_for([1.0, 0.0, 0.0], "fixedValue"))
    pbcs = tuple(pf.fixed_value(0.0) if p.name == "outlet"
                 else pf.zero_gradient() for p in mesh.patches)
    p_f = vol_scalar(mesh, 0.0, name="p", dims=DimensionSet.of(0, 2, -2),
                     bcs=pbcs)
    k = vol_scalar(mesh, k0, name="k", dims=DimensionSet.of(0, 2, -2),
                   bcs=bcs_for(k0, "kqRWallFunction"))
    om = vol_scalar(mesh, w0, name="omega", dims=DimensionSet.of(0, 0, -1),
                    bcs=bcs_for(w0, "omegaWallFunction"))
    nut = vol_scalar(mesh, 0.0, name="nut", dims=dimViscosity,
                     bcs=bcs_for(0.0, "nutkWallFunction"))

    props = FoamDict()
    props[Word("RASModel")] = Word("kOmegaSST")
    props[Word("turbulence")] = Word("on")
    model = select(props, nu)
    t0 = time.perf_counter()
    model.init_wall_distance(pm, mesh.v.dtype, device=mesh.device)
    _sync(device)
    seconds["wall_distance"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    gamg = GAMG(mesh)
    _sync(device)
    seconds["gamg_hierarchy"] = time.perf_counter() - t0

    cfg = simple.SimpleConfig(
        nu=nu, alpha_u=0.7, alpha_p=0.3,
        p_controls={"solver": "GAMG", "preconditioner": "polynomial",
                    "tolerance": 1e-7, "relTol": 0.01, "maxIter": 500,
                    "_gamg": gamg},
        u_controls={"solver": "smoothSolver", "tolerance": 1e-5,
                    "relTol": 0.1, "maxIter": 300, "nSweeps": 2},
        turb=model, turb_relax=0.7)
    state = piso.initial_state(mesh, U, p_f,
                               turb_state={"k": k, "omega": om, "nut": nut})
    return mesh, cfg, state, seconds


class SolveLog:
    """The one wrapper around foamtpu_torch.solvers.linear.solve that the
    profiled and fenced runs use. Each call is named by its equation's
    dimensions (FvMatrix.dims: U, p and the turbulence fields other than
    nut differ; an equation of other dimensions fails the run), counted,
    its iteration count and its first matrix per name kept; with `fence`
    it is timed between two torch.cuda.synchronize, with `ranges` it runs
    in a torch.profiler range solve_<name>."""

    def __init__(self, state, fence=False, ranges=False):
        from foamtpu_torch.core.dimensions import (dimDensity, dimFlux,
                                                   dimLength, dimTime,
                                                   dimVolume)

        if "p_rgh" in state:
            # interFoam: the momentum equation carries rho
            self.names = {
                dimDensity * dimFlux * state["U"].dims: "U",
                dimTime * state["p_rgh"].dims * dimLength: "p"}
        elif "p" in state:
            self.names = {dimFlux * state["U"].dims: "U",
                          dimTime * state["p"].dims * dimLength: "p"}
        else:
            # laplacianFoam / scalarTransportFoam: one T equation
            self.names = {state["T"].dims * dimVolume / dimTime: "T"}
        transported = [k for k in state.get("turb", {}) if k != "nut"]
        for name in transported:
            self.names[dimFlux * state["turb"][name].dims] = name
        check(len(self.names) == (1 if "T" in state else 2)
              + len(transported),
              f"equation dimensions collide: {self.names}")
        self.fence, self.ranges = fence, ranges
        self.calls = dict.fromkeys(self.names.values(), 0)
        self.seconds = dict.fromkeys(self.names.values(), 0.0)
        self.iterations = {name: [] for name in self.names.values()}
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
        self.iterations[name].append(out[1].n_iterations)
        return out


def solve_operands(log, mesh, prefix):
    """The SpMV operands of the matrices a SolveLog kept from the first
    SIMPLE iteration: the pressure matrix (diag_eff [n]) and the relaxed
    momentum matrix (diag_eff [n,3]), with their slot coefficients over
    st_deltas and their COO remainder (sfb over mesh.fb_cells)."""
    p, u = log.matrices["p"], log.matrices["U"]
    return [(f"{prefix}_p", p.soff, p.diag_eff(mesh), p.sfb),
            (f"{prefix}_Ux3", u.soff, u.diag_eff(mesh), u.sfb)]


def pitz_operands(mesh, cfg, state):
    """pitzDaily's first-iteration operands (see solve_operands)."""
    from foamtpu_torch.solvers import simple

    with SolveLog(state) as log:
        simple.make_step(mesh, cfg)(state)
    return solve_operands(log, mesh, "pitz")


def spmv_bound(n, ncols, n_off, with_diag, n_fb=0, itemsize=4):
    """The least time the card could take for one call: bytes moved
    (x, diag and y of n*ncols each, soff of n*n_off; a COO remainder of
    n_fb entries reads its int32 row pointers [n+1] once and, per entry,
    its coefficient and int32 column) over HBM_BYTES_PER_S, against the
    multiply-adds over F32_FLOPS."""
    vec = n * ncols
    nbytes = (itemsize * (vec * (3 if with_diag else 2) + n * n_off + n_fb)
              + (4 * (n + 1) + 4 * n_fb if n_fb else 0))
    flops = 2 * vec * (n_off + (1 if with_diag else 0)) + 2 * n_fb * ncols
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations"}


def csr_operator(diag, soff, deltas, fb=None):
    """torch.sparse CSR of the same operator, for one library call
    `A @ x`: diag + the slot entries (+ the COO remainder fb = (cells,
    nbrs, coeffs)). A vector operand [n,C] with a per-component diagonal
    becomes the block-diagonal [nC, nC] operator on x.reshape(-1)."""
    n = soff.shape[0]
    ncols = 1 if diag is None or diag.ndim == 1 else diag.shape[1]
    dev = soff.device
    c = torch.arange(n, device=dev)
    rows, cols, vals = [], [], []
    for m, d in enumerate(deltas):
        keep = soff[:, m] != 0
        rows.append(c[keep])
        cols.append(torch.remainder(c[keep] + d, n))
        vals.append(soff[keep, m])
    if fb is not None and fb[0].shape[0]:
        rows.append(fb[0])
        cols.append(fb[1])
        vals.append(fb[2])
    r, k, v = torch.cat(rows), torch.cat(cols), torch.cat(vals)
    if ncols > 1:
        j = torch.arange(ncols, device=dev)
        r = (r[:, None] * ncols + j).reshape(-1)
        k = (k[:, None] * ncols + j).reshape(-1)
        v = v[:, None].expand(-1, ncols).reshape(-1)
    if diag is not None:
        cd = torch.arange(n * ncols, device=dev)
        r, k = torch.cat([r, cd]), torch.cat([k, cd])
        v = torch.cat([v, diag.reshape(-1)])
    a = torch.sparse_coo_tensor(torch.stack([r, k]), v,
                                (n * ncols, n * ncols)).coalesce()
    return a.to_sparse_csr()


def device_ms(fn, flush=None, reps=30, trials=2, attempts=3) -> float:
    """Device time of one call of fn from torch.profiler (CUPTI): the
    device-side work (kernels, copies, memsets) a profile of `reps` calls
    recorded, divided by the calls it recorded; the median over `trials`
    profiles. With `flush`, a uint8 buffer of L2_FLUSH_BYTES, L2 is
    flushed by a write of it before every call (its fill kernel,
    FillFunctor<unsigned char>, is left out); without, the calls run back
    to back with their operands warm in L2. A profile often loses an
    event, and now and then many, so dividing by `reps` would read low:
    every call launches the same work, so the calls a profile recorded
    are its events over the events per call (the most any profile
    recorded, over `reps`). A profile with events missing counts in
    INCOMPLETE_PROFILES; one with none is taken again, at most `attempts`
    times."""
    global INCOMPLETE_PROFILES
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    taken = []                      # (device events, ms) per profile
    for _ in range(trials):
        for _ in range(attempts):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    if flush is not None:
                        flush.fill_(1)
                    fn()
                torch.cuda.synchronize()
            work = [e for e in prof.key_averages()
                    if getattr(e, "device_type", None)
                    == torch.autograd.DeviceType.CUDA
                    and "unsigned char" not in e.key]
            events = sum(e.count for e in work)
            if events:
                break
            INCOMPLETE_PROFILES += 1
        check(events > 0, "the profiler saw no device time in a timed call")
        taken.append((events, sum(_dev_time(e, "self_device_time_total")
                                  for e in work) / 1e3))
    per_call = max(1, round(max(n for n, _ in taken) / reps))
    INCOMPLETE_PROFILES += sum(n < per_call * reps for n, _ in taken)
    return statistics.median(ms * per_call / n for n, ms in taken)


def graph_ms(fn, flush, reps=30, replays=7) -> float:
    """Device ms per call of fn with L2 flushed, without the profiler:
    CUDA-event time of a CUDA graph of `reps` (flush, fn) pairs less that
    of a graph of `reps` flushes, over `reps`; the median of `replays`.
    A check of the profiler's time that does not depend on CUPTI; the
    gaps and overlap between a graph's kernels move it either way."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graphs = [torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()]
    for g, with_fn in zip(graphs, (True, False)):
        with torch.cuda.graph(g):
            for _ in range(reps):
                flush.fill_(1)
                if with_fn:
                    fn()

    def replay_ms(g):
        out = []
        for _ in range(replays):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            g.replay()
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b))
        return statistics.median(out)
    return (replay_ms(graphs[0]) - replay_ms(graphs[1])) / reps


def timed(fn, flush):
    """Device ms per call: `ms` with L2 flushed before every call, so the
    operands come from HBM and the time compares with the HBM bound, and
    `ms_l2_warm` back to back with the operands warm in the 50 MB L2,
    which is faster than HBM and so not held to that bound."""
    return {"ms": device_ms(fn, flush), "ms_l2_warm": device_ms(fn)}


def time_shape(spmv, name, diag, x, soff, deltas, flush, fb=None):
    """Kernel, plain version and the CSR product at one operand (the
    plain version timed in turns plain/kernel/kernel/plain), with the
    bound: the slot part alone, and with a remainder fb (spmv.Remainder)
    also the whole operator in one launch (the main path's call, shape
    `<name>_whole`) against its plain version (roll chain + index_add)
    and the CSR product of the whole operator. Returns the entries."""
    n = x.shape[0]
    ncols = 1 if x.ndim == 1 else x.shape[1]
    xs = x.reshape(-1)
    out = []
    for part in ((None,) if fb is None else (None, fb)):
        def kern():
            return spmv.spmv(diag, x, soff, deltas, part)

        def plain():
            return spmv.plain(diag, x, soff, deltas, part)

        a = csr_operator(diag, soff, deltas, None if part is None else
                         (part.cells, part.nbrs, part.coeffs))

        def lib():
            return a @ xs

        ref = plain()
        check(bool(torch.allclose(lib().reshape(x.shape), ref, rtol=1e-4,
                                  atol=1e-5 * float(ref.abs().max()))),
              f"CSR operator disagrees with plain at {name}")
        p1, k1, k2, p2 = (timed(f, flush) for f in (plain, kern, kern, plain))
        k = min((k1, k2), key=lambda t: t["ms"])
        p = min((p1, p2), key=lambda t: t["ms"])
        lb = timed(lib, flush)
        n_fb = 0 if part is None else int(part.cells.shape[0])
        t = {"shape": name if part is None else f"{name}_whole", "n": n,
             "ncols": ncols, "offsets": len(deltas), "coo_entries": n_fb,
             "diag": diag is not None, "dtype": str(x.dtype),
             "kernel_ms": k["ms"], "kernel_ms_l2_warm": k["ms_l2_warm"],
             "kernel_graph_ms": graph_ms(kern, flush),
             # CUDA events around the wrapper, calls back to back: the
             # host launch path when it is the slower side
             "kernel_wrapper_ms": time_ms(kern),
             "plain_ms": p["ms"], "plain_ms_l2_warm": p["ms_l2_warm"],
             "library_ms": lb["ms"], "library_ms_l2_warm": lb["ms_l2_warm"],
             "runs": {"plain": [p1, p2], "kernel": [k1, k2]},
             "library": "torch.sparse CSR @ x (cuSPARSE), "
                        f"nnz {int(a.values().shape[0])}"}
        t.update(spmv_bound(n, ncols, len(deltas), diag is not None, n_fb,
                            x.element_size()))
        t["bound_share"] = t["bound_ms"] / t["kernel_ms"]
        out.append(t)
    return out


def hold(cases, name, dtype, got, ref, relative=False):
    """One kernel result against its plain version at TOL[dtype]; with
    `relative`, atol is taken relative to max|plain| (mesh operands,
    whose scale is far from 1). Returns the max abs error."""
    rtol, atol = TOL[dtype]
    scale = float(torch.max(torch.abs(ref))) if ref.numel() else 0.0
    err = float(torch.max(torch.abs(got - ref))) if ref.numel() else 0.0
    ok = bool(torch.allclose(got, ref, rtol=rtol,
                             atol=atol * scale if relative else atol))
    cases.append({"case": name, "dtype": str(dtype), "ok": ok,
                  "n": int(ref.shape[0]),
                  "ncols": 1 if ref.ndim == 1 else int(ref.shape[1]),
                  "max_abs_err": err, "scale": scale})
    check(ok, f"spmv kernel disagrees with plain: {name} {dtype}")
    return err


def check_operands(spmv, ops, mesh, deltas, dtype, rng, cases):
    """The kernel against its plain version at a mesh's own operands,
    the slot part alone and the whole operator with the mesh's COO
    remainder, with seeded O(1) x. Returns the largest error."""
    max_err = 0.0
    for name, soff, diag, sfb in ops:
        soff = soff.to(dtype).contiguous()
        diag = diag.to(dtype).contiguous()
        x = torch.tensor(rng.standard_normal(tuple(diag.shape)),
                         dtype=dtype, device="cuda")
        fb = mesh_remainder(spmv, mesh, sfb, dtype)
        for part, suffix in ((None, ""), (fb, "_whole")):
            if suffix and part is None:
                continue
            got = spmv.spmv(diag, x, soff, deltas, part)
            torch.cuda.synchronize()
            ref = spmv.plain(diag, x, soff, deltas, part)
            max_err = max(max_err, hold(cases, name + suffix, dtype, got,
                                        ref, relative=True))
    return max_err


def operand_x(diag, seed):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.standard_normal(tuple(diag.shape)),
                        dtype=diag.dtype, device=diag.device)


def phase_kernel(spmv, pitz_mesh, pitz_ops, deltas_pitz, flush):
    max_err = 0.0
    cases = []
    timings = []
    for dtype in (torch.float32, torch.float64):
        for name, n, deltas, ncols, with_diag, with_fb in SPMV_CASES:
            diag, x, soff = spmv_inputs(n, deltas, ncols, with_diag, dtype)
            fb = random_remainder(spmv, n, dtype) if with_fb else None
            got = spmv.spmv(diag, x, soff, deltas, fb)
            torch.cuda.synchronize()
            ref = spmv.plain(diag, x, soff, deltas, fb)
            err = hold(cases, name, dtype, got, ref)
            if dtype == torch.float32:
                max_err = max(max_err, err)
                if name in ("n160000", "n160000x3"):
                    # the 400^2 cavity's shapes: 4 offsets, a diagonal
                    timings += time_shape(spmv, f"cavity_{name}", diag, x,
                                          soff, deltas, flush)
        err = check_operands(spmv, pitz_ops, pitz_mesh, deltas_pitz, dtype,
                             np.random.default_rng(1), cases)
        if dtype == torch.float32:
            max_err = max(max_err, err)
    name, soff, diag, sfb = pitz_ops[0]
    timings += time_shape(spmv, name, diag.contiguous(), operand_x(diag, 1),
                          soff.contiguous(), deltas_pitz, flush,
                          fb=mesh_remainder(spmv, pitz_mesh, sfb, diag.dtype))
    emit({"phase": "kernel", "cases": cases, "max_abs_err_f32": max_err,
          "timings": timings, "incomplete_profiles": INCOMPLETE_PROFILES})
    return max_err, timings


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

    spmv.LAUNCHES = spmv.FB_LAUNCHES = 0
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
           "spmv_fb_launches_total": spmv.FB_LAUNCHES,
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
    spmv.LAUNCHES = spmv.FB_LAUNCHES = 0
    t0 = time.perf_counter()
    mesh, cfg, state = pitz_setup(here, root)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    chunk = simple.make_chunk(mesh, cfg, PITZ_CHUNK)
    c = mesh.c
    behind = (c[:, 0] > 0.0) & (c[:, 0] < 0.06) & (c[:, 1] < -0.005)
    min_ux, ux_res, times = 1e9, [], []
    launches0 = fb0 = None
    t_run = time.perf_counter()
    for i in range(PITZ_CHUNKS):
        t0 = time.perf_counter()
        state, diag = chunk(state)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / PITZ_CHUNK
        if i == 0:
            launches0, fb0 = spmv.LAUNCHES, spmv.FB_LAUNCHES
        elif i <= trials:
            times.append(dt)
        if i == trials:
            launches_timed = spmv.LAUNCHES - launches0
            fb_timed = spmv.FB_LAUNCHES - fb0
        ux = state["U"].data
        check(bool(torch.isfinite(ux).all()), f"diverged in chunk {i}")
        min_ux = min(min_ux, float(ux[behind, 0].min()))
        ux_res.append(float(diag["Ux"].initial_residual.max()))
    run_s = time.perf_counter() - t_run
    launches, fb_launches = spmv.LAUNCHES, spmv.FB_LAUNCHES
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
           "spmv_fb_launches_per_iter": fb_timed / (PITZ_CHUNK * trials),
           "spmv_launches_total": launches,
           "spmv_fb_launches_total": fb_launches,
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
    check(fb_launches > 0 or not mesh.fb_cells.shape[0],
          "no pitzDaily SpMV launch carried the COO remainder")
    return out, (mesh, cfg, state)


def _dev_time(e, attr):
    return float(getattr(e, attr, getattr(e, attr.replace("device", "cuda"),
                                          0.0)))


def solver_iterations(diag):
    if "p_iters" not in diag:       # the basic solvers: one T solve
        return {"T": int(diag["T"].n_iterations)}
    out = {"p": int(diag["p_iters"]), "U": int(diag["Ux"].n_iterations)}
    out.update({k[len("turb_"):]: int(v.n_iterations)
                for k, v in diag.items() if k.startswith("turb_")})
    return out


def profile_chunk(spmv, phase, mesh, chunk, state, n, sec_per_iter, top=12):
    """One n-iteration chunk under torch.profiler (CPU + CUDA), each
    linear solve in a record_function range named after its field, with
    the SpMV launches counted over the same chunk, and among them those
    that carried the COO remainder (spmv.FB_LAUNCHES); where the mesh
    has COO entries, a chunk with no such launch fails the run, and so
    does one whose SpMV kernels the profiler saw no device time of.
    Device time is the sum over device-side events (the GPU copies of
    the record_function ranges are spans, not work, and are left out);
    the busy share divides it by the unprofiled time per iteration. A
    solve's device ms counts the kernels of the torch ops inside its
    range: the SpMV kernels, launched through ctypes, are not attributed
    to ranges and have their own line."""
    from torch.profiler import ProfilerActivity, profile

    launches0, fb0 = spmv.LAUNCHES, spmv.FB_LAUNCHES
    with SolveLog(state, ranges=True) as log:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, diag = chunk(state)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spmv_launches = spmv.LAUNCHES - launches0
    fb_launches = spmv.FB_LAUNCHES - fb0
    ka = prof.key_averages()
    # device-side events (kernels, copies, memsets); the CPU ops carry
    # the same time again as their children's
    work = [e for e in ka
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("solve_")]
    device_ms = sum(_dev_time(e, "self_device_time_total") for e in work) / 1e3
    solves = {e.key[len("solve_"):]: {
        "cpu_ms_per_call": e.cpu_time_total / 1e3 / e.count,
        "device_ms_per_call": _dev_time(e, "device_time_total") / 1e3 / e.count}
        for e in ka if e.key.startswith("solve_") and e.cpu_time_total > 0}
    spmv_events = [e for e in work
                   if e.key.startswith("void spmv_stencil_kernel")]
    spmv_device_ms = sum(_dev_time(e, "self_device_time_total")
                         for e in spmv_events)
    index_add_ms = sum(_dev_time(e, "self_device_time_total") for e in work
                       if "indexFunc" in e.key or "index_add" in e.key)
    kernels = sorted(((_dev_time(e, "self_device_time_total") / 1e3 / n,
                       e.count / n, e.key[:70]) for e in work),
                     reverse=True)[:top]
    launches = sum(e.count for e in ka if e.key == "cudaLaunchKernel")
    # host-side aten ops by the device time of the kernels they launch
    # (inclusive: an op's children count again under their own names)
    ops = sorted(((_dev_time(e, "device_time_total") / 1e3 / n, e.count / n,
                   e.key) for e in ka
                  if e.key.startswith("aten::") and getattr(
                      e, "device_type", None) != torch.autograd.DeviceType.CUDA),
                 reverse=True)[:top]
    out = {"phase": phase, "iterations": n, "profiled_wall_s": wall,
           "device_ms_per_iter": device_ms / n,
           "device_busy_share_unprofiled": device_ms / n / 1e3 / sec_per_iter,
           "cuda_launch_kernel_per_iter": launches / n,
           "spmv_launches_per_iter": spmv_launches / n,
           "spmv_fb_launches_per_iter": fb_launches / n,
           "spmv_kernel_events_per_iter": sum(e.count for e in spmv_events)
           / n,
           "spmv_device_ms_per_iter": spmv_device_ms / 1e3 / n,
           "index_add_device_ms_per_iter": index_add_ms / 1e3 / n,
           "solver_iterations": solver_iterations(diag),
           "solve_calls": log.calls, "solves": solves,
           "top_kernels_ms_per_iter": kernels,
           "top_ops_device_ms_per_iter": ops}
    emit(out)
    check(spmv_launches > 0 and spmv_device_ms > 0,
          f"{phase}: the profiler saw no SpMV kernel time")
    if mesh.fb_cells.shape[0]:
        check(fb_launches > 0,
              f"{phase}: no SpMV launch carried the COO remainder")
    return state, out


def run_iterations(step, state, n):
    """n SIMPLE iterations, their diagnostics kept as device tensors
    (read after the caller's synchronize)."""
    diags = []
    for _ in range(n):
        state, diag = step(state)
        diags.append(diag)
    return state, diags


def iteration_record(diag):
    return {"iters": solver_iterations(diag),
            "p_initial": float(diag["p_initial"]),
            "continuity": float(diag["continuity"])}


def phase_duct(spmv, chunk=DUCT_CHUNK, trials=DUCT_TRIALS):
    """bench.py's unstructured row through the port on the card."""
    from foamtpu_torch.mesh.tetmesh import coo_fraction
    from foamtpu_torch.solvers import simple

    torch.cuda.reset_peak_memory_stats()
    spmv.LAUNCHES = spmv.FB_LAUNCHES = 0
    t0 = time.perf_counter()
    mesh, cfg, state, setup = duct_setup(*DUCT, device="cuda")
    setup_s = time.perf_counter() - t0
    step = simple.make_step(mesh, cfg)
    p_max_iter = cfg.p_controls["maxIter"]
    # warm-up chunk; its first iteration hands its matrices to SolveLog
    # (the kernel_duct operands)
    t0 = time.perf_counter()
    with SolveLog(state) as log:
        state, diags = run_iterations(step, state, 1)
    state, more = run_iterations(step, state, chunk - 1)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    records = [iteration_record(d) for d in diags + more]
    launches0, fb0 = spmv.LAUNCHES, spmv.FB_LAUNCHES
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        state, diags = run_iterations(step, state, chunk)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / chunk)
        records += [iteration_record(d) for d in diags]
    launches, fb_launches = spmv.LAUNCHES, spmv.FB_LAUNCHES
    sec = statistics.median(times)
    turb = state["turb"]
    u, k = state["U"].data, turb["k"].data
    om, nut = turb["omega"].data, turb["nut"].data
    finite = all(bool(torch.isfinite(t).all())
                 for t in (u, state["p"].data, state["phi"], k, om, nut))
    frac = coo_fraction(mesh)
    levels = cfg.p_controls["_gamg"].levels
    out = {"phase": "duct",
           "case": "simpleFoam kOmegaSST tet duct %dx%dx%dx6 (bench.py "
                   "bench_unstructured)" % DUCT,
           "n_cells": mesh.n_cells, "n_faces": mesh.n_faces,
           "dtype": str(mesh.v.dtype), "st_deltas": list(mesh.st_deltas),
           "coo_fraction": frac, "n_coo": int(mesh.fb_cells.shape[0]),
           "gamg_level_sizes": [mesh.n_cells] + [lv.n_coarse
                                                 for lv in levels],
           "gamg_pairwise_levels": sum(lv.cluster_of_fine is not None
                                       for lv in levels),
           "setup_s": setup_s, "setup_split_s": setup,
           "warmup_chunk_s": warm_s, "sec_per_iter": sec,
           "trial_sec_per_iter": times,
           "cells_per_sec": mesh.n_cells / sec,
           "iterations": chunk * (trials + 1),
           "per_iteration": records,
           "spmv_launches_per_iter": (launches - launches0)
           / (chunk * trials),
           "spmv_fb_launches_per_iter": (fb_launches - fb0)
           / (chunk * trials),
           "spmv_launches_total": launches,
           "spmv_fb_launches_total": fb_launches,
           "finite": finite, "u_max": float(torch.max(torch.abs(u))),
           "k_min": float(k.min()), "omega_min": float(om.min()),
           "nut_min": float(nut.min()),
           "continuity": records[-1]["continuity"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(out)
    # tests/test_turbulence.py:185-188's bounds, convergence and the
    # mesh's COO fraction
    checks = {"finite": finite, "k>0": out["k_min"] > 0,
              "omega>0": out["omega_min"] > 0, "nut>=0": out["nut_min"] >= 0,
              "continuity<1e-3": out["continuity"] < 1e-3,
              "|U|<3": out["u_max"] < 3.0,
              "p converged": all(r["iters"]["p"] < p_max_iter
                                 for r in records),
              "coo_fraction": abs(frac - DUCT_COO_FRACTION) < 0.002,
              "spmv launched": launches > 0
              and out["spmv_launches_per_iter"] > 0,
              "remainder fused": out["spmv_fb_launches_per_iter"] > 0}
    for name, ok in checks.items():
        check(ok, f"duct check {name}: {out}")
    return out, (mesh, cfg, state), log


def gamg_cases(spmv, mesh, cfg, pmat, rng, cases):
    """The kernel at the duct's GAMG operators, built by prepare() from
    its pressure matrix: the first plane level whose COO remainder is not
    row-sorted (its coefficients reordered when the operator was made),
    and the coarsest level's dense assembly, the operator applied to the
    identity (C = n), held to their plain versions in float32 (the
    operators as the solve makes them) and float64. Returns the largest
    float32 error and what was held."""
    from foamtpu_torch.ops.stencil import StencilOp

    gamg = cfg.p_controls["_gamg"]
    check(all(lv.plane_ok for lv in gamg.levels),
          "the duct's GAMG levels are not all plane levels")
    prep = gamg.prepare(mesh, pmat)
    ops, diags = prep["ops"], [m[0] for m in prep["mats"]]
    unsorted = [i for i, op in enumerate(ops)
                if i > 0 and op.fb is not None and op.fb_layout.order
                is not None]
    check(bool(unsorted), "no duct GAMG plane level has an unsorted "
                          "COO remainder")
    lvl, last = unsorted[0], len(ops) - 1
    check(ops[last].fb is not None, "the coarsest level has no remainder")
    max_err = 0.0
    for dtype in (torch.float32, torch.float64):
        for i, what in ((lvl, "level"), (last, "dense")):
            op = ops[i]
            if dtype != op.off.dtype:
                op = StencilOp(op.deltas, op.off.to(dtype), op.fb_cells,
                               op.fb_nbrs, op.fb_coeffs.to(dtype),
                               op.fb_layout)
            n = op.off.shape[0]
            if what == "level":
                x = torch.tensor(rng.standard_normal(n), dtype=dtype,
                                 device="cuda")
                d = diags[i].to(dtype)
                got = op.matvec(d, x)
                torch.cuda.synchronize()
                ref = spmv.plain(d, x, op.off, op.deltas, op.fb)
            else:
                eye = torch.eye(n, dtype=dtype, device="cuda")
                got = op.apply_off(eye)
                torch.cuda.synchronize()
                ref = spmv.plain(None, eye, op.off, op.deltas, op.fb)
            err = hold(cases, f"duct_gamg_{what}{i}", dtype, got, ref,
                       relative=True)
            if dtype == torch.float32:
                max_err = max(max_err, err)
    held = {"plane_level": lvl, "plane_level_n": int(ops[lvl].off.shape[0]),
            "plane_level_coo_entries": int(ops[lvl].fb_cells.shape[0]),
            "dense_level": last, "dense_n": int(ops[last].off.shape[0]),
            "dense_coo_entries": int(ops[last].fb_cells.shape[0]),
            "unsorted_levels": unsorted}
    return max_err, held


def phase_kernel_duct(spmv, mesh, cfg, log, flush):
    """The kernel at the duct's own operands, whole operator included,
    and at its GAMG operators: held to its plain version (f32 and f64),
    then the slot part and the whole operator timed against CSR."""
    ops = solve_operands(log, mesh, "duct")
    deltas = tuple(mesh.st_deltas)
    cases = []
    max_err = 0.0
    for dtype in (torch.float32, torch.float64):
        err = check_operands(spmv, ops, mesh, deltas, dtype,
                             np.random.default_rng(2), cases)
        if dtype == torch.float32:
            max_err = max(max_err, err)
    err, held = gamg_cases(spmv, mesh, cfg, log.matrices["p"],
                           np.random.default_rng(3), cases)
    max_err = max(max_err, err)
    timings = []
    for i, (name, soff, diag, sfb) in enumerate(ops):
        soff, diag = soff.contiguous(), diag.contiguous()
        timings += time_shape(
            spmv, name, diag, operand_x(diag, 10 + i), soff, deltas, flush,
            fb=mesh_remainder(spmv, mesh, sfb, diag.dtype))
    emit({"phase": "kernel_duct", "cases": cases, "max_abs_err_f32": max_err,
          "gamg": held, "timings": timings,
          "incomplete_profiles": INCOMPLETE_PROFILES})
    return max_err, timings


def cavity_ras_setup(case):
    """pisoFoam on a Case: the transport model, the turbulence model and
    its fields from the case files, the PisoConfig of
    solvers/apps.py::_piso_config and the initial state. Returns
    (mesh, cfg, state)."""
    from foamtpu_torch.core.dictionary import dimensioned_scalar
    from foamtpu_torch.solvers import piso
    from foamtpu_torch.solvers.apps import _load_turbulence, _piso_config

    _, nu = dimensioned_scalar(case.transport_properties()["nu"])
    model, tstate = _load_turbulence(case, nu)
    cfg = _piso_config(case, nu, model)
    state = piso.initial_state(case.mesh, case.read_field("U"),
                               case.read_field("p"), turb_state=tstate,
                               ddt_scheme=cfg.ddt_scheme)
    return case.mesh, cfg, state


def cavity_ras_scalars(U, k, nut):
    """The golden scalars of a 20x20 cavityRAS state (numpy arrays):
    kinetic energy, max k, max nut, the centreline Ux at CAVITY_RAS_UCL."""
    u = np.asarray(U).reshape(20, 20, 3)
    ucl = 0.5 * (u[9, :, 0] + u[10, :, 0])
    return {"ke": float(np.mean(np.sum(u ** 2, axis=-1))),
            "k_max": float(np.max(k)), "nut_max": float(np.max(nut)),
            "ucl": [float(ucl[i]) for i in CAVITY_RAS_UCL]}


def cavity_ras_checks(state, diag):
    """cavityRAS's oracles and goldens (1e-3 relative)."""
    turb = state["turb"]
    u = state["U"].data.cpu().numpy()
    k = turb["k"].data.cpu().numpy()
    eps = turb["epsilon"].data.cpu().numpy()
    nut = turb["nut"].data.cpu().numpy()
    got = cavity_ras_scalars(u, k, nut)
    rel = {name: float(np.max(np.abs(np.asarray(got[name]) - np.asarray(g))
                              / np.abs(np.asarray(g))))
           for name, g in CAVITY_RAS_GOLDEN.items()}
    out = {"scalars": got, "golden_rel_err": rel,
           "continuity": float(diag["continuity"]),
           "u_max": float(np.abs(u).max()), "k_min": float(k.min()),
           "epsilon_min": float(eps.min()), "nut_min": float(nut.min())}
    checks = {"finite": all(bool(np.isfinite(a).all())
                            for a in (u, k, eps, nut)),
              "k>0": out["k_min"] > 0, "epsilon>0": out["epsilon_min"] > 0,
              "nut>=0": out["nut_min"] >= 0,
              "continuity<1e-3": out["continuity"] < 1e-3,
              "|U|<=1.05": out["u_max"] <= 1.05}
    checks.update({f"golden {name}": r <= 1e-3 for name, r in rel.items()})
    return out, checks


def phase_cavity_ras(spmv, here, root):
    from foamtpu_torch.apps.cli import main as cli
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.solvers import piso

    dst = os.path.join(root, "cavityRAS")
    shutil.copytree(os.path.join(here, CAVITY_RAS_CASE), dst)
    with contextlib.redirect_stdout(sys.stderr):
        check(cli(["blockMesh", "-case", dst]) == 0, "blockMesh failed")
    spmv.LAUNCHES = spmv.FB_LAUNCHES = 0
    t0 = time.perf_counter()
    case = Case(dst, device="cuda")
    mesh, cfg, state = cavity_ras_setup(case)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    dt = float(case.control_dict["deltaT"])
    steps = round(float(case.control_dict["endTime"]) / dt)
    check(steps == CAVITY_RAS_STEPS, f"cavityRAS runs {steps} steps")
    step = piso.make_step(mesh, cfg)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, diag = step(state, dt)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches, fb_launches = spmv.LAUNCHES, spmv.FB_LAUNCHES
    res, checks = cavity_ras_checks(state, diag)
    out = {"phase": "cavity_ras",
           "case": "pisoFoam cavityRAS, kEpsilon + wall functions, "
                   "unmodified tutorial files",
           "n_cells": mesh.n_cells, "dtype": str(mesh.v.dtype),
           "div_scheme": cfg.div_scheme, "steps": steps, "setup_s": setup_s,
           "run_s": run_s, "sec_per_step": run_s / steps,
           "solver_iterations_last_step": solver_iterations(diag),
           "spmv_launches_total": launches,
           "spmv_fb_launches_total": fb_launches,
           "spmv_launches_per_step": launches / steps, **res,
           "checks": checks}
    emit(out)
    for name, ok in checks.items():
        check(ok, f"cavityRAS check {name}: {res}")
    check(launches > 0, "the cavityRAS path did not launch the SpMV kernel")
    return out


def quiet():
    """The applications log every step to stdout; the phases send that to
    stderr so that stdout keeps one JSON line per phase."""
    return contextlib.redirect_stdout(sys.stderr)


def copy_case(here, rel, root, name, edits=()):
    """A tutorial copied under `root` with (path, old, new) text edits,
    each of which must change its file, then meshed by the port's
    blockMesh. Returns the copy's path."""
    from foamtpu_torch.apps.cli import main as cli

    dst = os.path.join(root, name)
    shutil.copytree(os.path.join(here, rel), dst)
    for path, old, new in edits:
        path = os.path.join(dst, path)
        with open(path) as f:
            text = f.read()
        check(old in text, f"{path} holds no {old!r}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    with quiet():
        check(cli(["blockMesh", "-case", dst]) == 0, "blockMesh failed")
    return dst


def golden_rel_err(got, golden, floor=None):
    """Largest relative error of each golden entry (scalars or lists);
    `floor` maps a name to the least magnitude its error is taken
    relative to."""
    out = {}
    for name, g in golden.items():
        g = np.asarray(g, dtype=np.float64)
        den = np.maximum(np.abs(g), (floor or {}).get(name, 0.0))
        out[name] = float(np.max(np.abs(np.asarray(got[name]) - g) / den))
    return out


def pimple_ras_checks(state, diag):
    """pimpleFoam cavityRAS: cavityRAS's oracles, continuity < 1e-6 and
    the goldens (1e-3 relative)."""
    turb = state["turb"]
    u = state["U"].data.cpu().numpy()
    k = turb["k"].data.cpu().numpy()
    eps = turb["epsilon"].data.cpu().numpy()
    nut = turb["nut"].data.cpu().numpy()
    got = cavity_ras_scalars(u, k, nut)
    rel = golden_rel_err(got, PIMPLE_RAS_GOLDEN)
    out = {"scalars": got, "golden_rel_err": rel,
           "continuity": float(diag["continuity"]),
           "u_max": float(np.abs(u).max()), "k_min": float(k.min()),
           "epsilon_min": float(eps.min()), "nut_min": float(nut.min())}
    checks = {"finite": all(bool(np.isfinite(a).all())
                            for a in (u, k, eps, nut)),
              "k>0": out["k_min"] > 0, "epsilon>0": out["epsilon_min"] > 0,
              "nut>=0": out["nut_min"] >= 0,
              "continuity<1e-6": out["continuity"] < 1e-6,
              "|U|<=1.05": out["u_max"] <= 1.05}
    checks.update({f"golden {name}": r <= 1e-3 for name, r in rel.items()})
    return out, checks


def pimple_reduces_to_piso(case):
    """One step of the case with nOuterCorrectors 1 against piso_step from
    the same state: the largest difference of U, p and phi relative to
    each field's scale."""
    from foamtpu_torch.core.dictionary import dimensioned_scalar
    from foamtpu_torch.solvers import pimple, piso
    from foamtpu_torch.solvers.apps import (_load_turbulence, _pimple_config,
                                            _piso_config)

    _, nu = dimensioned_scalar(case.transport_properties()["nu"])
    model, tstate = _load_turbulence(case, nu)
    cfg1 = _pimple_config(case, nu, model)._replace(
        n_outer=1, alpha_u=0.7, alpha_p=0.3)   # ignored on a final iteration
    pcfg = _piso_config(case, nu, model)._replace(
        p_controls=cfg1.p_controls, p_controls_final=cfg1.p_controls_final)
    state = piso.initial_state(case.mesh, case.read_field("U"),
                               case.read_field("p"), turb_state=tstate)
    dt = float(case.control_dict["deltaT"])
    s1, s2 = state, state
    for _ in range(2):
        s1, _ = pimple.pimple_step(case.mesh, s1, dt, cfg1)
        s2, _ = piso.piso_step(case.mesh, s2, dt, pcfg)
    rel = {}
    for name in ("U", "p", "phi"):
        a, b = s1[name], s2[name]
        a, b = (a, b) if torch.is_tensor(a) else (a.data, b.data)
        rel[name] = float(torch.max(torch.abs(a - b))
                          / torch.max(torch.abs(b)))
    return rel


def phase_pimple_ras(spmv, here, root):
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.solvers.apps import run

    dst = copy_case(here, PIMPLE_RAS_CASE, root, "pimpleRAS")
    spmv.LAUNCHES = spmv.FB_LAUNCHES = 0
    t0 = time.perf_counter()
    case = Case(dst, device="cuda")
    check(case.application == "pimpleFoam", case.application)
    with quiet():
        run(case)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches, fb_launches = spmv.LAUNCHES, spmv.FB_LAUNCHES
    steps = case.time.index
    check(steps == PIMPLE_RAS_STEPS, f"pimpleFoam cavityRAS ran {steps} steps")
    state = case.final_state
    # the application's last diagnostics are gone with its loop: the
    # continuity error of the state it left, from its flux
    from foamtpu_torch.ops import surface

    div_phi = surface.surface_sum(case.mesh, state["phi"])
    diag = {"continuity": torch.sum(torch.abs(div_phi))
            / torch.sum(case.mesh.v)}
    res, checks = pimple_ras_checks(state, diag)
    written = sorted(os.listdir(os.path.join(dst, case.time.name)))
    rel = pimple_reduces_to_piso(Case(dst, device="cuda"))
    checks["n_outer=1 is PISO (1e-6)"] = max(rel.values()) <= 1e-6
    checks["fields written"] = written == ["U", "epsilon", "k", "nut", "p"]
    out = {"phase": "pimple_ras",
           "case": "pimpleFoam cavityRAS through solvers.apps.run, "
                   "unmodified tutorial files",
           "n_cells": case.mesh.n_cells, "dtype": str(case.mesh.v.dtype),
           "steps": steps, "run_s": run_s, "sec_per_step": run_s / steps,
           "spmv_launches_total": launches,
           "spmv_fb_launches_total": fb_launches,
           "spmv_launches_per_step": launches / steps, **res,
           "n_outer_1_vs_piso_rel": rel, "written": written,
           "checks": checks}
    emit(out)
    for name, ok in checks.items():
        check(ok, f"pimpleFoam cavityRAS check {name}: {out}")
    check(launches > 0, "the pimpleFoam path did not launch the SpMV kernel")
    return out


def phase_pimple_headline(spmv, n=400, nsteps=10, trials=3, n_profile=5):
    """The 400^2 cavity of phase_headline, same GAMG p-controls, as a
    PIMPLE step with two outer and two inner correctors, U and p relaxed
    (0.7, 0.3) on the first outer iteration."""
    from foamtpu_torch.apps.cases import make_cavity
    from foamtpu_torch.solvers import pimple

    torch.cuda.reset_peak_memory_stats()
    spmv.LAUNCHES = spmv.FB_LAUNCHES = 0
    mesh, state, pcfg = make_cavity(n, p_solver={
        "solver": "GAMG", "preconditioner": "polynomial",
        "tolerance": 1e-7, "relTol": 0.01, "maxIter": 1000}, device="cuda")
    # relaxed on the first outer iteration (0.7 / 0.3, the tutorials'
    # factors): unrelaxed, two outer iterations of this case diverge
    # (max |U| 1.9 after 45 steps, in the JAX package alike), where one
    # (PISO) and the relaxed two are stable
    cfg = pimple.PimpleConfig(
        nu=pcfg.nu, n_outer=2, n_correctors=2, alpha_u=0.7, alpha_p=0.3,
        p_controls=pcfg.p_controls, u_controls=pcfg.u_controls)
    dt = 0.5 * (0.1 / n)
    chunk = pimple.make_chunk(mesh, cfg, nsteps)
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
    launches_timed = spmv.LAUNCHES - launches0
    sec = statistics.median(times)
    prof_chunk = pimple.make_chunk(mesh, cfg, n_profile)
    state, prof = profile_chunk(
        spmv, "pimple_headline_profile", mesh,
        lambda s: prof_chunk(s, dt), state, n_profile, sec)
    launches = spmv.LAUNCHES
    finite = all(bool(torch.isfinite(t).all()) for t in (
        state["U"].data, state["p"].data, state["phi"]))
    out = {"phase": "pimple_headline",
           "case": f"pimpleFoam cavity {n}x{n}, nOuterCorrectors 2, "
                   "nCorrectors 2, relaxation U 0.7 p 0.3, GAMG (bench.py "
                   "p-controls)",
           "n_cells": mesh.n_cells, "dtype": str(mesh.v.dtype),
           "warmup_chunk_s": warm_s, "sec_per_step": sec,
           "trial_sec_per_step": times,
           "steps": nsteps * (trials + 1) + n_profile,
           "p_iters": int(diag["p_iters"]),
           "p_final": float(diag["p_final"]),
           "u_iters": int(diag["Ux"].n_iterations),
           "continuity": float(diag["continuity"]),
           "courant_max": float(diag["courant_max"]),
           "spmv_launches_per_step": launches_timed / (nsteps * trials),
           "cuda_launch_kernel_per_step": prof["cuda_launch_kernel_per_iter"],
           "device_ms_per_step": prof["device_ms_per_iter"],
           "device_busy_share": prof["device_busy_share_unprofiled"],
           "spmv_launches_total": launches,
           "spmv_fb_launches_total": spmv.FB_LAUNCHES,
           "finite": finite,
           "u_max": float(torch.max(torch.abs(state["U"].data))),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(out)
    # the bound of phase_headline: the p-controls stop at relTol 0.01
    check(out["continuity"] < 1e-3, out["continuity"])
    check(finite, "non-finite U, p or phi")
    check(out["u_max"] <= 1.0 + 1e-3, "|U| above the lid velocity")
    check(launches > 0 and out["spmv_launches_per_step"] > 0,
          "the PIMPLE path did not launch the SpMV kernel")
    return out


def dambreak_scalars(v, alpha, U, p_rgh):
    """The golden scalars of a 46x46 damBreak state (numpy arrays): the
    water volume sum(alpha V), max |U|, alpha's extrema and p_rgh at
    DAMBREAK_P_CELLS."""
    return {"water_volume": float(np.sum(np.asarray(alpha, np.float64)
                                         * np.asarray(v, np.float64))),
            "u_max": float(np.sqrt(np.sum(np.asarray(U) ** 2, axis=1)).max()),
            "alpha_min": float(np.min(alpha)),
            "alpha_max": float(np.max(alpha)),
            "p_rgh": [float(p_rgh[i]) for i in DAMBREAK_P_CELLS]}


def dambreak_golden_checks(mesh, state):
    """The 46x46 damBreak state after DAMBREAK_GOLDEN_STEPS steps against
    the goldens, 1e-3 relative (alpha's extrema relative to 1)."""
    got = dambreak_scalars(mesh.v.cpu().numpy(),
                           state["alpha"].data.cpu().numpy(),
                           state["U"].data.cpu().numpy(),
                           state["p_rgh"].data.cpu().numpy())
    rel = golden_rel_err(got, DAMBREAK_GOLDEN,
                         floor={"alpha_min": 1.0, "alpha_max": 1.0})
    checks = {f"golden {name}": r <= 1e-3 for name, r in rel.items()}
    return {"scalars": got, "golden_rel_err": rel}, checks


def dambreak_invariants(mesh, alpha0, state):
    """tests/test_interfoam.py's invariants on a damBreak state: alpha
    within [-1e-4, 1 + 1e-4], the water volume conserved to 1e-4
    relative, the fill of the cell column at the left wall lower than at
    the start, U finite."""
    v = mesh.v.double()
    a = state["alpha"].data
    left = mesh.c[:, 0] < mesh.c[:, 0].min() * 1.5   # the first column

    def fill(x):
        return float(torch.sum(x.double()[left] * v[left])
                     / torch.sum(v[left]))

    vol0 = float(torch.sum(alpha0.double() * v))
    vol = float(torch.sum(a.double() * v))
    out = {"alpha_min": float(a.min()), "alpha_max": float(a.max()),
           "water_volume_0": vol0, "water_volume": vol,
           "water_volume_rel_change": abs(vol - vol0) / vol0,
           "left_column_fill_0": fill(alpha0), "left_column_fill": fill(a),
           "u_max": float(torch.max(torch.abs(state["U"].data)))}
    checks = {"alpha bounded": out["alpha_min"] > -1e-4
              and out["alpha_max"] < 1.0 + 1e-4,
              "volume conserved (1e-4)": out["water_volume_rel_change"] < 1e-4,
              "column falls": out["left_column_fill"]
              < out["left_column_fill_0"],
              "U finite": bool(torch.isfinite(state["U"].data).all())
              and bool(torch.isfinite(state["p_rgh"].data).all())}
    return out, checks


def dambreak_small(spmv, here, root):
    """(a) the tutorial as it is: 20 steps to the goldens, then the run
    again for DAMBREAK_STEPS steps to the invariants."""
    from foamtpu_torch.apps.cli import main as cli
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.solvers.apps import run

    dst = copy_case(here, DAMBREAK_CASE, root, "damBreak")
    with quiet():
        check(cli(["setFields", "-case", dst]) == 0, "setFields failed")
    case = Case(dst, device="cuda")
    check(case.application == "interFoam", case.application)
    check(case.mesh.n_cells == DAMBREAK_N ** 2, case.mesh.n_cells)
    alpha0 = case.read_field("alpha1").data.clone()
    with quiet():
        run(case, max_steps=DAMBREAK_GOLDEN_STEPS)
    gold, checks = dambreak_golden_checks(case.mesh, case.final_state)
    case = Case(dst, device="cuda")
    t0 = time.perf_counter()
    with quiet():
        run(case, max_steps=DAMBREAK_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    check(case.time.index == DAMBREAK_STEPS, case.time.index)
    inv, inv_checks = dambreak_invariants(case.mesh, alpha0,
                                          case.final_state)
    checks.update(inv_checks)
    written = sorted(os.listdir(os.path.join(dst, case.time.name)))
    checks["fields written"] = written == ["U", "alpha1", "p_rgh"]
    return {"n_cells": case.mesh.n_cells, "steps": DAMBREAK_STEPS,
            "run_s": run_s, "sec_per_step": run_s / DAMBREAK_STEPS,
            **gold, "invariants": inv, "written": written}, checks


def dambreak_big(spmv, here, root, n=DAMBREAK_BIG_N, trials=3):
    """(b) the same case at n x n cells: set-up and two warm-up steps
    through the application, then its own step (the config and state the
    application built) in three timed chunks and one profiled chunk."""
    from foamtpu_torch.apps.cli import main as cli
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.solvers import interfoam
    from foamtpu_torch.solvers.apps import _inter_config, run

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dst = copy_case(here, DAMBREAK_CASE, root, f"damBreak{n}", edits=[
        ("constant/polyMesh/blockMeshDict", f"({DAMBREAK_N} {DAMBREAK_N} 1)",
         f"({n} {n} 1)"),
        ("system/controlDict", "deltaT          0.001;",
         f"deltaT          {DAMBREAK_BIG_DT};")])
    with quiet():
        check(cli(["setFields", "-case", dst]) == 0, "setFields failed")
    case = Case(dst, device="cuda")
    mesh = case.mesh
    check(mesh.n_cells == n * n, mesh.n_cells)
    alpha0 = case.read_field("alpha1").data.clone()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with quiet():
        run(case, max_steps=DAMBREAK_BIG_WARMUP)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    if warm_s / DAMBREAK_BIG_WARMUP > 20.0 and n == DAMBREAK_BIG_N:
        return None     # too slow to fit the run: the caller halves n
    dt = case.time.delta_t
    check(dt == DAMBREAK_BIG_DT, dt)
    cfg = _inter_config(case)
    step = interfoam.make_step(mesh, cfg)
    state = case.final_state

    def chunk(state, n_steps=DAMBREAK_BIG_CHUNK):
        diags = []
        for _ in range(n_steps):
            state, diag = step(state, dt)
            diags.append(diag)
        return state, diags

    launches0 = spmv.LAUNCHES
    times = []
    with SolveLog(state) as log:
        for _ in range(trials):
            t0 = time.perf_counter()
            state, diags = chunk(state)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) / DAMBREAK_BIG_CHUNK)
    launches_timed = spmv.LAUNCHES - launches0
    sec = statistics.median(times)
    diag = diags[-1]
    p_iters = [int(i) for i in log.iterations["p"]]
    n_profile = 3

    def profiled(state):
        state, diags = chunk(state, n_profile)
        return state, diags[-1]

    state, prof = profile_chunk(spmv, "dambreak_profile", mesh, profiled,
                                state, n_profile, sec)
    inv, checks = dambreak_invariants(mesh, alpha0, state)
    out = {"n_cells": mesh.n_cells, "dtype": str(mesh.v.dtype),
           "delta_t": dt, "st_deltas": list(mesh.st_deltas),
           "setup_s": setup_s, "warmup_steps": DAMBREAK_BIG_WARMUP,
           "warmup_s": warm_s, "sec_per_step": sec,
           "trial_sec_per_step": times, "cells_per_sec": mesh.n_cells / sec,
           "steps": (DAMBREAK_BIG_WARMUP + DAMBREAK_BIG_CHUNK * trials + 1
                     + n_profile),
           "p_rgh_solves_per_step": len(p_iters)
           / (DAMBREAK_BIG_CHUNK * trials),
           "p_rgh_iterations_per_solve": statistics.mean(p_iters),
           "p_rgh_iterations_max": max(p_iters),
           "u_iterations": int(diag["Ux"].n_iterations),
           "courant_max": float(diag["courant_max"]),
           "continuity": float(diag["continuity"]),
           "spmv_launches_per_step": launches_timed
           / (DAMBREAK_BIG_CHUNK * trials),
           "cuda_launch_kernel_per_step": prof["cuda_launch_kernel_per_iter"],
           "device_ms_per_step": prof["device_ms_per_iter"],
           "device_busy_share": prof["device_busy_share_unprofiled"],
           "invariants": inv,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    checks["spmv launched"] = out["spmv_launches_per_step"] > 0
    # every SpMV of the profiled chunk went through the kernel: the
    # profiler's kernel events equal the wrapper's launch count
    checks["all SpMV through the kernel"] = (
        prof["spmv_kernel_events_per_iter"] > 0
        and abs(prof["spmv_kernel_events_per_iter"]
                - prof["spmv_launches_per_iter"])
        <= 0.02 * prof["spmv_launches_per_iter"])
    return out, checks, (mesh, log)


def phase_dambreak(spmv, here, root, flush):
    spmv.LAUNCHES = spmv.FB_LAUNCHES = 0
    small, checks = dambreak_small(spmv, here, root)
    launches_small = spmv.LAUNCHES
    n = DAMBREAK_BIG_N
    res = dambreak_big(spmv, here, root, n)
    if res is None:
        # over 20 s a step at 736^2: once, at half the width
        n //= 2
        res = dambreak_big(spmv, here, root, n)
    big, big_checks, (mesh, log) = res
    launches, fb_launches = spmv.LAUNCHES, spmv.FB_LAUNCHES
    checks.update({f"{n}^2 {k}": v for k, v in big_checks.items()})
    # the kernel at the p_rgh operand of the flat-path operator: held to
    # its plain version, then timed against the bound and CSR
    from foamtpu_torch.ops import stencil

    pm = log.matrices["p"]
    check(pm.soff is None, "the interFoam pressure matrix is not flat")
    op = stencil.mesh_stencil(mesh, pm.upper, pm.lower)
    diag = pm.diag_eff(mesh).contiguous()
    cases = []
    max_err = 0.0
    for dtype in (torch.float32, torch.float64):
        d, off = diag.to(dtype), op.off.to(dtype).contiguous()
        x = operand_x(d, 21)
        got = spmv.spmv(d, x, off, op.deltas, None)
        torch.cuda.synchronize()
        err = hold(cases, "dambreak_p_rgh", dtype, got,
                   spmv.plain(d, x, off, op.deltas, None), relative=True)
        if dtype == torch.float32:
            max_err = err
    check(op.fb is None, "the hex damBreak mesh has a COO remainder")
    timings = time_shape(spmv, "dambreak_p_rgh", diag, operand_x(diag, 22),
                         op.off.contiguous(), op.deltas, flush)
    out = {"phase": "dambreak",
           "case": "interFoam damBreak through blockMesh, setFields and "
                   "solvers.apps.run, tutorial files",
           "tutorial": small, f"n{n}": big, "big_n": n,
           "spmv_launches_total": launches,
           "spmv_launches_tutorial": launches_small,
           "spmv_fb_launches_total": fb_launches,
           "kernel_cases": cases, "max_abs_err_f32": max_err,
           "timings": timings, "checks": checks}
    emit(out)
    for name, ok in checks.items():
        check(ok, f"damBreak check {name}: {out}")
    check(launches_small > 0 and launches > launches_small,
          "the interFoam path did not launch the SpMV kernel")
    return out, max_err, timings


def solve_iterations(log):
    """{field: [iterations of each solve]} from an application's log
    lines ("Solving for <field>, ... No Iterations <n>")."""
    out = {}
    for m in re.finditer(r"Solving for (\w+),.*No Iterations (\d+)", log):
        out.setdefault(m.group(1), []).append(int(m.group(2)))
    return out


def basic_case(here, app, root, cli, device=(), cases=BASIC_CASES):
    """A copy of the app's tutorial (`cases[app][0]`) under root, meshed
    by `cli` (the port's command line or the JAX package's), with
    setFields where the tutorial has a setFieldsDict. Returns the copy's
    path."""
    dst = os.path.join(root, app)
    shutil.copytree(os.path.join(here, cases[app][0]), dst)
    with quiet():
        check(cli(["blockMesh", "-case", dst]) == 0, "blockMesh failed")
        if os.path.exists(os.path.join(dst, "system", "setFieldsDict")):
            check(cli(["setFields", "-case", dst, *device]) == 0,
                  "setFields failed")
    return dst


def basic_scalars(app, a):
    """The golden scalars of a basic tutorial's final state, from numpy
    arrays `a` (U, p, T and, for crossCavity, nu)."""
    if app == "nonNewtonianIcoFoam":
        u = np.asarray(a["U"], np.float64).reshape(20, 20, 3)
        ucl = 0.5 * (u[9, :, 0] + u[10, :, 0])
        return {"ke": float(np.mean(np.sum(u ** 2, axis=-1))),
                "u_max": float(np.abs(u).max()),
                "ucl": [float(ucl[i]) for i in BASIC_COLS],
                "nu_min": float(np.min(a["nu"])),
                "nu_max": float(np.max(a["nu"]))}
    if app == "laplacianFoam":
        # the rise above the cold wall's 273 K along the mid-height line
        # (blockMesh orders the cells y-fastest: t[x index, y index])
        t = np.asarray(a["T"], np.float64).reshape(20, 20) - 273.0
        row = 0.5 * (t[:, 9] + t[:, 10])
        return {"rise_mean": float(np.mean(t)),
                "rise_row": [float(row[i]) for i in HEATED_COLS]}
    if app == "scalarTransportFoam":
        t = np.asarray(a["T"], np.float64)
        x = (np.arange(t.shape[0]) + 0.5) / t.shape[0]
        return {"t_max": float(t.max()), "t_sum": float(t.sum()),
                "t_centroid": float(np.sum(t * x) / np.sum(t))}
    u = np.asarray(a["U"], np.float64)
    return {"ux_mean": float(u[:, 0].mean()), "ux_min": float(u[:, 0].min()),
            "ux_max": float(u[:, 0].max())}


def basic_arrays(app, case):
    """The final state's arrays that basic_scalars reads, on the host."""
    st = case.final_state
    out = {k: st[k].data.cpu().numpy() for k in ("U", "p", "T") if k in st}
    if app == "nonNewtonianIcoFoam":
        from foamtpu_torch.models import transport

        nu = transport.select(case.transport_properties())(case.mesh,
                                                           st["U"])
        out["nu"] = nu.cpu().numpy()
    return out


def basic_invariants(app, case, a, t_sum0=None):
    """What each basic tutorial must keep, whatever its goldens."""
    from foamtpu_torch.core.dictionary import dimensioned_scalar
    from foamtpu_torch.ops import surface

    checks = {"finite": all(bool(np.isfinite(v).all()) for v in a.values())}
    out = {}
    if app == "nonNewtonianIcoFoam":
        c = case.transport_properties().subdict("CrossPowerLawCoeffs")
        nu0 = dimensioned_scalar(c["nu0"])[1]
        nu_inf = dimensioned_scalar(c["nuInf"])[1]
        out.update(nu_min=float(a["nu"].min()), nu_max=float(a["nu"].max()),
                   u_max=float(np.abs(a["U"]).max()))
        checks["nuInf <= nu <= nu0"] = (out["nu_min"] >= nu_inf * (1 - 1e-5)
                                        and out["nu_max"] <= nu0 * (1 + 1e-5))
        checks["|U| <= 1"] = out["u_max"] <= 1.0 + 1e-3
    if app == "laplacianFoam":
        out.update(t_min=float(a["T"].min()), t_max=float(a["T"].max()))
        # the maximum principle: T between its boundary values
        checks["273 <= T <= 373"] = (out["t_min"] >= 273.0 - 1e-3
                                     and out["t_max"] <= 373.0 + 1e-3)
    if app == "scalarTransportFoam":
        v = case.mesh.v.cpu().numpy()
        out.update(t_min=float(a["T"].min()), t_max=float(a["T"].max()),
                   t_integral=float(np.sum(a["T"] * v)), t_integral_0=t_sum0)
        out["t_integral_rel_change"] = abs(out["t_integral"] / t_sum0 - 1.0)
        checks["0 <= T <= 1"] = out["t_min"] >= -1e-3 \
            and out["t_max"] <= 1.0 + 1e-3
        # the pulse is still inside the channel: T is conserved
        checks["T conserved (1e-4)"] = out["t_integral_rel_change"] < 1e-4
    if app == "potentialFoam":
        phi = case.final_state["phi"]
        div = surface.surface_sum(case.mesh, phi)
        out["div_phi_rel"] = float(torch.max(torch.abs(div))
                                   / torch.max(torch.abs(phi)))
        # uniform inflow between slip walls: the potential flow is U = (1 0 0)
        out["u_dev"] = float(np.abs(a["U"] - [1.0, 0.0, 0.0]).max())
        # from O(1) before the solve (phi0 crosses only the inlet and the
        # outlet); float32 differences of a potential of O(1) leave 5e-5
        checks["div(phi) ~ 0 (1e-3)"] = out["div_phi_rel"] < 1e-3
        checks["U = (1 0 0) (1e-3)"] = out["u_dev"] < 1e-3
    return out, checks


def phase_basic(spmv, here, root):
    """The four tutorials from their case files through run(case), each
    held to its goldens and invariants, each through the SpMV kernel."""
    from foamtpu_torch.apps.cli import main as cli
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.solvers.apps import run

    spmv.LAUNCHES = spmv.FB_LAUNCHES = 0
    results, checks = {}, {}
    for app, (_, steps) in BASIC_CASES.items():
        dst = basic_case(here, app, os.path.join(root, "basic"), cli)
        case = Case(dst, device="cuda")
        check(case.application == app, case.application)
        t_sum0 = None
        if app == "scalarTransportFoam":
            t_sum0 = float(torch.sum(case.read_field("T").data
                                     * case.mesh.v))
        launches0 = spmv.LAUNCHES
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            run(case, max_steps=steps)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        sys.stderr.write(log.getvalue())
        a = basic_arrays(app, case)
        got = basic_scalars(app, a)
        rel = golden_rel_err(got, BASIC_GOLDEN[app], BASIC_FLOOR)
        inv, inv_checks = basic_invariants(app, case, a, t_sum0)
        iters = solve_iterations(log.getvalue())
        launches = spmv.LAUNCHES - launches0
        ran = case.time.index if app != "potentialFoam" else 1
        results[app] = {
            "case": BASIC_CASES[app][0], "n_cells": case.mesh.n_cells,
            "steps": ran, "run_s": run_s, "sec_per_step": run_s / ran,
            "iterations_mean": {k: statistics.mean(v)
                                for k, v in iters.items()},
            "iterations_max": {k: max(v) for k, v in iters.items()},
            "spmv_launches": launches,
            "scalars": got, "golden_rel_err": rel, "invariants": inv}
        checks.update({f"{app} {k}": v for k, v in inv_checks.items()})
        checks.update({f"{app} golden {k}": r <= 1e-3
                       for k, r in rel.items()})
        checks[f"{app} steps"] = ran == steps
        checks[f"{app} spmv launched"] = launches > 0
    out = {"phase": "basic", "dtype": "torch.float32", "apps": results,
           "spmv_launches_total": spmv.LAUNCHES,
           "spmv_fb_launches_total": spmv.FB_LAUNCHES, "checks": checks}
    emit(out)
    for name, ok in checks.items():
        check(ok, f"basic check {name}: {out}")
    return out


def app_steps(case, step, state, n, fol):
    """n steps of the transient applications' loop
    (solvers/apps.py::_time_loop) without its writes: step, log, the
    function objects, deltaT."""
    from foamtpu_torch.solvers import apps

    diag = None
    for t in case.time.loop():
        state, diag = step(state, t.current_dt)
        apps._log_step(case, t, diag, 0.0)
        fol.execute(t.name, state)
        t.adjust_delta_t(float(diag["courant_max"]))
        n -= 1
        if n == 0:
            break
    return state, diag


def phase_cross_headline(spmv, here, root, trials=3, n_profile=5):
    """crossCavity at CROSS_N^2 with CROSS_FUNCS through the
    application's loop: chunks with the function objects and without
    them, taken in turns, and one profiled chunk."""
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.core.dictionary import dimensioned_scalar
    from foamtpu_torch.functionobjects.base import FunctionObjectList
    from foamtpu_torch.models import transport
    from foamtpu_torch.solvers import piso
    from foamtpu_torch.solvers.apps import _piso_config, run

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dst = copy_case(here, BASIC_CASES["nonNewtonianIcoFoam"][0], root,
                    f"cross{CROSS_N}", edits=[
                        ("system/blockMeshDict", "(20 20 1)",
                         f"({CROSS_N} {CROSS_N} 1)"),
                        ("system/controlDict", "deltaT 0.0005;",
                         f"deltaT {CROSS_DT!r};"),
                        ("system/fvSolution", "p { solver PCG;",
                         "p { solver GAMG;")])
    with open(os.path.join(dst, "system", "controlDict"), "a") as f:
        f.write(CROSS_FUNCS)
    case = Case(dst, device="cuda")
    mesh = case.mesh
    check(mesh.n_cells == CROSS_N ** 2, mesh.n_cells)
    setup_s = time.perf_counter() - t0
    spmv.LAUNCHES = spmv.FB_LAUNCHES = 0
    t0 = time.perf_counter()
    with quiet():
        run(case, max_steps=2)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    fol = case.function_objects
    check(len(fol.objects) == 4, [o.name for o in fol.objects])
    props = case.transport_properties()
    _, nu = dimensioned_scalar(props["nu"])
    cfg = _piso_config(case, nu, nu_fn=transport.select(props))
    step = piso.make_step(mesh, cfg)
    state = case.final_state
    bare = FunctionObjectList([])
    with_fo, without, fo_host = [], [], []
    launches0 = spmv.LAUNCHES
    fetch0 = sum(fol.fetches().values())
    by0 = dict(fol.seconds_by_object)
    with quiet():
        for _ in range(trials):
            for lst, times in ((fol, with_fo), (bare, without)):
                s0 = fol.seconds
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, diag = app_steps(case, step, state, CROSS_CHUNK, lst)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) / CROSS_CHUNK)
                if lst is fol:
                    fo_host.append((fol.seconds - s0) / CROSS_CHUNK)
    timed_steps = 2 * trials * CROSS_CHUNK
    launches_timed = spmv.LAUNCHES - launches0
    fetches = (sum(fol.fetches().values()) - fetch0) / (trials * CROSS_CHUNK)
    sec = statistics.median(with_fo)
    with quiet():
        state, prof = profile_chunk(
            spmv, "cross_headline_profile", mesh,
            lambda st: app_steps(case, step, st, n_profile, fol), state,
            n_profile, sec)
    nu_cell = cfg.nu_fn(mesh, state["U"])
    c = props.subdict("CrossPowerLawCoeffs")
    nu0 = dimensioned_scalar(c["nu0"])[1]
    nu_inf = dimensioned_scalar(c["nuInf"])[1]
    rows = {}
    post = os.path.join(dst, "postProcessing")
    for name in sorted(os.listdir(post)):
        for fname in sorted(os.listdir(os.path.join(post, name))):
            with open(os.path.join(post, name, fname)) as f:
                rows[f"{name}/{fname}"] = sum(
                    1 for line in f if not line.startswith("#"))
    executes = fol.executes
    out = {"phase": "cross_headline",
           "case": f"nonNewtonianIcoFoam crossCavity {CROSS_N}x{CROSS_N} "
                   f"(CrossPowerLaw, GAMG p (bench.py's controls), the "
                   f"tutorial's PBiCGStab U, deltaT {CROSS_DT!r}), functions: "
                   + ", ".join(o.name for o in fol.objects),
           "n_cells": mesh.n_cells, "dtype": str(mesh.v.dtype),
           "setup_s": setup_s, "warmup_s": warm_s, "sec_per_step": sec,
           "trial_sec_per_step": with_fo,
           "sec_per_step_without_functions": statistics.median(without),
           "trial_sec_per_step_without_functions": without,
           "fol_execute_host_ms_per_step": 1e3 * statistics.median(fo_host),
           "fol_execute_host_ms_trials": [1e3 * x for x in fo_host],
           "fol_host_ms_per_step_by_object": {
               k: 1e3 * (v - by0[k]) / (trials * CROSS_CHUNK)
               for k, v in fol.seconds_by_object.items()},
           "fol_fetches_per_step": fetches,
           "fol_fetches_by_object": fol.fetches(), "fol_executes": executes,
           "fol_failures": fol.failures, "postprocessing_rows": rows,
           "p_iters": int(diag["p_iters"]),
           "u_iters": int(diag["Ux"].n_iterations),
           "continuity": float(diag["continuity"]),
           "courant_max": float(diag["courant_max"]),
           "nu_min": float(nu_cell.min()), "nu_max": float(nu_cell.max()),
           "spmv_launches_per_step": launches_timed / timed_steps,
           "cuda_launch_kernel_per_step": prof["cuda_launch_kernel_per_iter"],
           "device_ms_per_step": prof["device_ms_per_iter"],
           "device_busy_share": prof["device_busy_share_unprofiled"],
           "spmv_launches_total": spmv.LAUNCHES,
           "spmv_fb_launches_total": spmv.FB_LAUNCHES,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    checks = {
        "function objects failed 0 times": fol.failures == 0,
        # a row per execute; fieldMinMax one per field (U and p)
        "every object wrote its rows": len(rows) == 5 and all(
            n == executes * (2 if name.startswith("minMax/") else 1)
            for name, n in rows.items()),
        "nuInf <= nu <= nu0": (out["nu_min"] >= nu_inf * (1 - 1e-5)
                               and out["nu_max"] <= nu0 * (1 + 1e-5)),
        "finite": bool(torch.isfinite(state["U"].data).all())
        and bool(torch.isfinite(state["p"].data).all()),
        # the log's "sum local" (continuity x deltaT): GAMG at relTol
        # 0.01 leaves ~4e-8 on the 400^2 PISO headline too (3e-4 x 1.25e-4)
        "continuity x deltaT < 1e-7": out["continuity"] * CROSS_DT < 1e-7,
        "spmv launched": out["spmv_launches_per_step"] > 0}
    out["checks"] = checks
    emit(out)
    for name, ok in checks.items():
        check(ok, f"cross_headline check {name}: {out}")
    return out


def phase_heated(spmv, here, root, flush, n_profile=2):
    """heatedBlock at HEATED_N^2: one step through run(case), then
    HEATED_STEPS of the application's step timed, one profiled chunk,
    and the SpMV kernel at the T operand held to its plain version and
    timed."""
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.ops import stencil
    from foamtpu_torch.solvers.apps import basic_step, run

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dst = copy_case(here, BASIC_CASES["laplacianFoam"][0], root,
                    f"heated{HEATED_N}", edits=[
                        ("system/blockMeshDict", "(20 20 1)",
                         f"({HEATED_N} {HEATED_N} 1)")])
    case = Case(dst, device="cuda")
    mesh = case.mesh
    check(mesh.n_cells == HEATED_N ** 2, mesh.n_cells)
    setup_s = time.perf_counter() - t0
    spmv.LAUNCHES = spmv.FB_LAUNCHES = 0
    t0 = time.perf_counter()
    with quiet():
        run(case, max_steps=1)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    step = basic_step(case, convection=False)
    T = case.final_state["T"]
    dt = case.time.delta_t
    launches0 = spmv.LAUNCHES
    with SolveLog({"T": T}) as log:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HEATED_STEPS):
            T, perf = step(T, dt)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / HEATED_STEPS
    launches_timed = spmv.LAUNCHES - launches0
    iters = [int(i) for i in log.iterations["T"]]

    def chunk(st):
        T, perf = st["T"], None
        for _ in range(n_profile):
            T, perf = step(T, dt)
        return {"T": T}, {"T": perf}

    _, prof = profile_chunk(spmv, "heated_profile", mesh, chunk, {"T": T},
                            n_profile, sec)
    # the main path's count, before the hold and the timing launch it
    launches, fb_launches = spmv.LAUNCHES, spmv.FB_LAUNCHES
    t = T.data
    # the kernel at the T operand: held to its plain version, then timed
    tm = log.matrices["T"]
    check(tm.soff is not None and mesh.fb_cells.shape[0] == 0,
          "the heatedBlock T matrix is not a slot operator")
    op = stencil.StencilOp(tuple(mesh.st_deltas), tm.soff, mesh.fb_cells,
                           mesh.fb_nbrs, tm.sfb, mesh.fb_layout)
    diag = tm.diag_eff(mesh).contiguous()
    cases, max_err = [], 0.0
    for dtype in (torch.float32, torch.float64):
        d, off = diag.to(dtype), op.off.to(dtype).contiguous()
        x = operand_x(d, 31)
        got = spmv.spmv(d, x, off, op.deltas, None)
        torch.cuda.synchronize()
        err = hold(cases, "heated_T", dtype, got,
                   spmv.plain(d, x, off, op.deltas, None), relative=True)
        if dtype == torch.float32:
            max_err = err
    timings = time_shape(spmv, "heated_T", diag, operand_x(diag, 32),
                         op.off.contiguous(), op.deltas, flush)
    out = {"phase": "heated_1m",
           "case": f"laplacianFoam heatedBlock {HEATED_N}x{HEATED_N}, "
                   "the tutorial's deltaT and T controls (PCG, polynomial, "
                   "tolerance 1e-9, maxIter 500)",
           "n_cells": mesh.n_cells, "dtype": str(mesh.v.dtype),
           "setup_s": setup_s, "warmup_s": warm_s, "sec_per_step": sec,
           "cells_per_sec": mesh.n_cells / sec,
           "t_iterations_per_step": iters,
           "t_iterations_mean": statistics.mean(iters),
           "t_final_residual": float(perf.final_residual),
           "spmv_launches_per_step": launches_timed / HEATED_STEPS,
           "cuda_launch_kernel_per_step": prof["cuda_launch_kernel_per_iter"],
           "device_ms_per_step": prof["device_ms_per_iter"],
           "device_busy_share": prof["device_busy_share_unprofiled"],
           "t_min": float(t.min()), "t_max": float(t.max()),
           "spmv_launches_total": launches,
           "spmv_fb_launches_total": fb_launches,
           "kernel_cases": cases, "max_abs_err_f32": max_err,
           "timings": timings,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    # the maximum principle to what a float32 solve can hold: eps x the
    # operator's condition (1 + 8 DT dt / dx^2, ~161 here) x |T| ~ 7e-3 K
    # (the tolerance 1e-9 is met in float32, but T's error is that)
    from foamtpu_torch.core.dictionary import dimensioned_scalar

    _, DT = dimensioned_scalar(case.transport_properties()["DT"])
    dx = 0.1 / HEATED_N                  # the block is 0.1 m wide
    kappa = 1.0 + 8.0 * DT * dt / dx ** 2
    t_tol = float(torch.finfo(t.dtype).eps) * kappa * 373.0
    out.update(condition_estimate=kappa, t_bound_tol=t_tol)
    checks = {"273 <= T <= 373 (float32 solve)": out["t_min"] >= 273.0 - t_tol
              and out["t_max"] <= 373.0 + t_tol,
              "finite": bool(torch.isfinite(t).all()),
              "spmv launched": out["spmv_launches_per_step"] > 0}
    out["checks"] = checks
    emit(out)
    for name, ok in checks.items():
        check(ok, f"heated_1m check {name}: {out}")
    return out, max_err, timings


def rotating_arrays(state):
    """The final state's fields (turbulence fields included) on the host."""
    fields = dict(state.get("turb") or {})
    fields.update({k: v for k, v in state.items() if hasattr(v, "bcs")})
    out = {}
    for k, f in fields.items():
        d = f.data
        out[k] = d.cpu().numpy() if torch.is_tensor(d) else np.asarray(d)
    return out


def rotating_scalars(app, c, v, a):
    """The golden scalars of a final state (numpy arrays: cell centres c,
    volumes v, fields a). The mixer: the mean tangential velocity on
    MIXER_RINGS, the mean p of those rings less the outermost ring's, and
    max |U|; angledDuct: the mean Ux in the porous box, the mean k and max
    |U| (its pressure drop is an invariant); damBreak: dambreak_scalars.
    A diverged PIMPLE run: whether it diverged."""
    if "p_rgh" in a:
        return dambreak_scalars(v, a["alpha"], a["U"], a["p_rgh"])
    U = np.asarray(a["U"], np.float64)
    u_max = float(np.sqrt(np.sum(U ** 2, axis=1)).max())
    if "Pimple" in app:
        return {"diverged": bool(not np.isfinite(u_max)
                                 or u_max > 1e3 * MIXER_TIP)}
    if app == "porousSimpleFoam":
        # what the inflow and the drag decide: the tutorial's uniform k
        # and epsilon make the limitedLinear limiter a 0/0 that round-off
        # decides, and a change of nu by 3e-7 moves U, p and k by ~3%
        # after 50 iterations in the JAX package (float32): their values
        # are reported (porous_drop), not held
        zone = (c[:, 0] > 0.05) & (c[:, 0] < 0.15)
        return {"ux_zone": float(np.sum(U[zone, 0] * v[zone])
                                 / np.sum(v[zone]))}
    p = np.asarray(a["p"], np.float64)
    r = np.hypot(c[:, 0], c[:, 1])
    ring = np.unique(np.round(r, 6), return_inverse=True)[1]
    ut = (U[:, 1] * c[:, 0] - U[:, 0] * c[:, 1]) / r

    def mean(x, i):
        return float(np.mean(x[ring == i]))

    return {"u_theta": [mean(ut, i) for i in MIXER_RINGS],
            "p_ring": [mean(p, i) - mean(p, ring.max())
                       for i in MIXER_RINGS[:-1]],
            "u_max": u_max}


def porous_drop(case, a):
    """angledDuct's pressure drop across the porous box (the mean p of
    the cell band upstream of it less the band downstream) against
    nu d U L from the case's own porousZones (d's first component, L the
    box's length, U the mean Ux in the box)."""
    from foamtpu_torch.core.dictionary import dimensioned_scalar, parse_file

    pz = parse_file(case.const_path("porousZones"))["porosity"]
    box = np.asarray(pz["box"], np.float64).reshape(2, 3)
    d = float(np.asarray(pz["Darcy"]["d"][-1], np.float64).reshape(3)[0])
    nu = float(dimensioned_scalar(case.transport_properties()["nu"])[1])
    c = case.mesh.c.cpu().numpy()
    v = case.mesh.v.cpu().numpy()
    p, U = np.asarray(a["p"], np.float64), np.asarray(a["U"], np.float64)
    length = float(box[1, 0] - box[0, 0])
    band = 0.1 * length
    up = (c[:, 0] > box[0, 0] - band) & (c[:, 0] < box[0, 0])
    dn = (c[:, 0] > box[1, 0]) & (c[:, 0] < box[1, 0] + band)
    zone = (c[:, 0] > box[0, 0]) & (c[:, 0] < box[1, 0])
    ux = float(np.sum(U[zone, 0] * v[zone]) / np.sum(v[zone]))
    drop = float(np.mean(p[up]) - np.mean(p[dn]))
    return {"dp_zone": drop, "nu_d_U_L": nu * d * ux * length,
            "dp_over_nu_d_U_L": drop / (nu * d * ux * length),
            "k_mean": float(np.mean(a["k"])),
            "u_max": float(np.sqrt(np.sum(U ** 2, axis=1)).max())}


def rotor_velocity_error(case, state):
    """max |U_b - omega x (Cf - o)| on the rotating walls, and max |U_b|
    on the non-rotating ones, relative to the rotor's speed, from the
    case's own MRF zone."""
    from foamtpu_torch.solvers.apps import _load_mrf

    mrf = _load_mrf(case)
    mesh = case.mesh
    z = mrf.zones[0]
    ub = state["U"].boundary_values(mesh).cpu().numpy()
    cf = mesh.cf.cpu().numpy()
    nif = mesh.n_internal_faces
    rot, still = 0.0, 0.0
    for ip, patch in enumerate(mesh.patches):
        if patch.type == "empty":
            continue
        s, e = patch.start, patch.start + patch.size
        u = ub[s - nif:e - nif]
        if z.patch_rotating[ip]:
            want = np.cross(np.broadcast_to(z.omega_vec, (patch.size, 3)),
                            cf[s:e] - z.origin)
            rot = max(rot, float(np.abs(u - want).max()))
        else:
            still = max(still, float(np.abs(u).max()))
    return {"rotor_u_err": rot / MIXER_TIP, "stator_u_max": still / MIXER_TIP}


def rotating_invariants(app, case, a, log_text, alpha0=None):
    """What each case must keep, whatever its goldens."""
    from foamtpu_torch.ops import surface

    state = case.final_state
    out, checks = {}, {}
    cont = [float(x) for x in re.findall(r"sum local = ([0-9.eE+-]+)",
                                         log_text)]
    if cont:
        out["continuity_dt_per_step"] = cont
    # continuity x deltaT is reported, not held to 1e-7: the tutorials'
    # own p controls (relTol 0.01-0.05, no final controls) leave 2e-7 at
    # damBreak's step 20 and ~5e-5 per mixer SIMPLE iteration, in the JAX
    # package as in the port; the water volume is damBreak's mass check
    if "p_rgh" in a:
        inv, checks = dambreak_invariants(case.mesh, alpha0, state)
        out.update(inv)
        div = surface.surface_sum(case.mesh, state["phi"])
        out["continuity_dt_last"] = float(
            torch.sum(torch.abs(div)) / torch.sum(case.mesh.v)
            * case.time.delta_t)
        return out, checks
    if "Pimple" not in app:
        checks["finite"] = all(bool(np.isfinite(x).all())
                               for x in a.values())
        checks["continuity finite"] = bool(cont) and bool(
            np.isfinite(cont).all())
    if app == "porousSimpleFoam":
        out.update(porous_drop(case, a))
        # p falls across the box by the Darcy drag's order
        checks["p falls across the porous box"] = out["dp_zone"] > 0
        checks["drop ~ nu d U L (0.1-10x)"] = \
            0.1 <= out["dp_over_nu_d_U_L"] <= 10.0
        return out, checks
    out.update(rotor_velocity_error(case, state))
    checks["rotor U = omega x r (1e-6)"] = out["rotor_u_err"] <= 1e-6
    checks["stator U = 0"] = out["stator_u_max"] == 0.0
    return out, checks


def phase_rotating(spmv, here, root):
    """The seven rotating-frame and porous tutorials from their case files
    through run(case), each held to its goldens and invariants, each
    through the SpMV kernel; the counts set to 0 before each case."""
    from foamtpu_torch.apps.cli import main as cli
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.solvers.apps import run

    results, checks = {}, {}
    launches_total = fb_total = 0
    for app, (_, steps) in ROTATING_CASES.items():
        dst = basic_case(here, app, os.path.join(root, "rotating"), cli,
                         cases=ROTATING_CASES)
        case = Case(dst, device="cuda")
        check(case.application == app, case.application)
        alpha0 = (case.read_field("alpha1").data.clone()
                  if os.path.exists(os.path.join(dst, "0", "alpha1"))
                  else None)
        mesh = case.mesh
        log = io.StringIO()
        spmv.LAUNCHES = spmv.FB_LAUNCHES = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            run(case, max_steps=steps)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches, fb_launches = spmv.LAUNCHES, spmv.FB_LAUNCHES
        launches_total += launches
        fb_total += fb_launches
        sys.stderr.write(log.getvalue())
        a = rotating_arrays(case.final_state)
        got = rotating_scalars(app, mesh.c.cpu().numpy(),
                               mesh.v.cpu().numpy(), a)
        if "Pimple" in app:
            rel = {"diverged": float(got["diverged"]
                                     != ROTATING_GOLDEN[app]["diverged"])}
        else:
            rel = golden_rel_err(got, ROTATING_GOLDEN[app], ROTATING_FLOOR)
        inv, inv_checks = rotating_invariants(app, case, a, log.getvalue(),
                                              alpha0)
        iters = solve_iterations(log.getvalue())
        n_if = mesh.n_internal_faces
        results[app] = {
            "case": ROTATING_CASES[app][0], "n_cells": mesh.n_cells,
            "steps": case.time.index, "run_s": run_s,
            "sec_per_step": run_s / case.time.index,
            "coo_fraction": float(mesh.fb_cells.shape[0]) / (2 * n_if),
            "iterations_mean": {k: statistics.mean(v)
                                for k, v in iters.items()},
            "iterations_max": {k: max(v) for k, v in iters.items()},
            "spmv_launches": launches, "spmv_fb_launches": fb_launches,
            "scalars": got, "golden_rel_err": rel, "invariants": inv}
        checks.update({f"{app} {k}": v for k, v in inv_checks.items()})
        checks.update({f"{app} golden {k}": r <= 1e-3
                       for k, r in rel.items()})
        checks[f"{app} steps"] = case.time.index == steps
        checks[f"{app} spmv launched"] = launches > 0
    out = {"phase": "rotating", "dtype": "torch.float32", "apps": results,
           "spmv_launches_total": launches_total,
           "spmv_fb_launches_total": fb_total, "checks": checks}
    emit(out)
    for name, ok in checks.items():
        check(ok, f"rotating check {name}: {out}")
    return out


def mrf_hooks_ms(mesh, cfg, state):
    """Device ms per call of the MRF hooks alone at the case's shapes:
    add_coriolis on a momentum matrix and make_relative of a slot flux."""
    from foamtpu_torch.ops import fvm
    from foamtpu_torch.ops import slot as slot_mod

    U = state["U"]
    eqn = fvm.div(mesh, state["phi"], U)
    phi = slot_mod.from_flat(mesh, state["phi"])
    return {"add_coriolis_ms": device_ms(
                lambda: cfg.mrf.add_coriolis(mesh, eqn, U)),
            "make_relative_ms": device_ms(
                lambda: cfg.mrf.make_relative(mesh, phi))}


def phase_mrf_headline(spmv, here, root, flush, trials=3):
    """MRFSimpleFoam on mixerVessel2D with every block scaled
    MRF_HEAD_SCALE x per side (294,912 cells): set-up, one iteration with
    the tutorial's controls (which decides the p controls), a warm-up
    chunk, `trials` timed chunks of MRF_HEAD_CHUNK iterations, the MRF
    hooks alone, the SpMV kernel at the p operand held to its plain
    version and timed, and last one profiled chunk of MRF_HEAD_PROFILE
    iterations from the state the warm-up left."""
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.core.dictionary import dimensioned_scalar
    from foamtpu_torch.solvers import apps, piso, simple
    from foamtpu_torch.solvers.linear.gamg import GAMG

    k = MRF_HEAD_SCALE
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dst = copy_case(here, ROTATING_CASES["MRFSimpleFoam"][0], root,
                    f"mixer{k}", edits=[
                        ("constant/polyMesh/blockMeshDict", "(12 24 1)",
                         f"({12 * k} {24 * k} 1)")])
    blockmesh_s = time.perf_counter() - t0
    case = Case(dst, device="cuda")
    mesh = case.mesh
    check(mesh.n_cells == 4 * 12 * 24 * k * k, mesh.n_cells)
    _, nu = dimensioned_scalar(case.transport_properties()["nu"])
    cfg = apps._simple_config(case, nu)
    state = apps._frames(case, cfg, piso.initial_state(
        mesh, apps._read_u(case, cfg.mrf), case.read_field("p")))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    progress("mrf_headline", f"set-up {setup_s:.1f} s, {mesh.n_cells} cells")
    p_cap = int(cfg.p_controls.get("maxIter", 1000))
    spmv.LAUNCHES = spmv.FB_LAUNCHES = 0
    # one iteration with the tutorial's controls decides them
    t0 = time.perf_counter()
    with SolveLog(state) as log:
        simple.make_step(mesh, cfg)(state)
        torch.cuda.synchronize()
    first = [int(i) for i in log.iterations["p"]]
    its_first = {"p": first, "U": [int(torch.max(torch.as_tensor(i)))
                                   for i in log.iterations["U"]]}
    progress("mrf_headline", f"first iteration {time.perf_counter() - t0:.1f}"
             f" s, p iterations {first}")
    p_controls = "tutorial (PCG, diagonal for DIC, relTol 0.01)"
    if max(first) >= p_cap:
        # the tutorial's PCG at its cap at this width: bench.py's GAMG
        # p-controls, as cross_headline takes them
        cfg = cfg._replace(p_controls={
            "solver": "GAMG", "preconditioner": "polynomial",
            "tolerance": 1e-7, "relTol": 0.01, "maxIter": 1000,
            "_gamg": GAMG(mesh)})
        p_controls = ("bench.py's GAMG (the tutorial's PCG reached its cap "
                      f"of {p_cap} in the first iteration: {first})")
    chunk = simple.make_chunk(mesh, cfg, MRF_HEAD_CHUNK)
    t0 = time.perf_counter()
    with SolveLog(state) as log:
        state, diag = chunk(state)
        torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    progress("mrf_headline", f"warm-up chunk {warm_s:.1f} s")
    # the profiled chunk starts here (the step functions keep no state of
    # their own): the iterations just after the warm-up are ones whose p
    # solves converge, while a later one may run to the cap, and profiling
    # that (~180,000 kernels an iteration) takes minutes
    state_prof = state
    secs, its = [], {"U": [], "p": []}
    for _ in range(trials):
        with SolveLog(state) as tlog:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, diag = chunk(state)
            torch.cuda.synchronize()
            secs.append((time.perf_counter() - t0) / MRF_HEAD_CHUNK)
        for name in its:
            its[name] += [int(i) if not torch.is_tensor(i) else
                          int(torch.max(i)) for i in tlog.iterations[name]]
    sec = statistics.median(secs)
    progress("mrf_headline", f"timed chunks {secs}")
    # the main path's count so far, before the hooks' timing, the hold and
    # the kernel's timing; the profiled chunk's launches are added below
    launches, fb_launches = spmv.LAUNCHES, spmv.FB_LAUNCHES
    hooks = mrf_hooks_ms(mesh, cfg, state)
    # the kernel at the p and U operands of the first iteration: held to
    # its plain version (f32, f64), then the p operand timed
    ops = solve_operands(log, mesh, "mixer")
    deltas = tuple(mesh.st_deltas)
    cases, max_err = [], 0.0
    for dtype in (torch.float32, torch.float64):
        err = check_operands(spmv, ops, mesh, deltas, dtype,
                             np.random.default_rng(41), cases)
        if dtype == torch.float32:
            max_err = err
    _, soff, diag_p, sfb = ops[0]
    timings = time_shape(
        spmv, "mixer_p", diag_p.contiguous(), operand_x(diag_p, 42),
        soff.contiguous(), deltas, flush,
        fb=(mesh_remainder(spmv, mesh, sfb, diag_p.dtype)
            if mesh.fb_cells.shape[0] else None))
    # the profiled chunk last: no profile is taken after it. Its work is run
    # first without the profiler from the same state, and the busy share
    # divides by those seconds
    l0, f0 = spmv.LAUNCHES, spmv.FB_LAUNCHES
    pchunk = simple.make_chunk(mesh, cfg, MRF_HEAD_PROFILE)
    with SolveLog(state_prof) as plog:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pchunk(state_prof)
        torch.cuda.synchronize()
        sec_p = (time.perf_counter() - t0) / MRF_HEAD_PROFILE
    _, prof = profile_chunk(spmv, "mrf_headline_profile", mesh, pchunk,
                            state_prof, MRF_HEAD_PROFILE, sec_p)
    progress("mrf_headline", "profiled chunk")
    launches += spmv.LAUNCHES - l0
    fb_launches += spmv.FB_LAUNCHES - f0
    hooks["share_of_device"] = ((hooks["add_coriolis_ms"]
                                 + hooks["make_relative_ms"])
                                / prof["device_ms_per_iter"])
    u = state["U"].data
    out = {"phase": "mrf_headline",
           "case": f"MRFSimpleFoam mixerVessel2D, blocks ({12 * k} {24 * k} "
                   "1): the tutorial's schemes, BCs and MRF zone",
           "n_cells": mesh.n_cells, "dtype": str(mesh.v.dtype),
           "coo_fraction": float(mesh.fb_cells.shape[0])
           / (2 * mesh.n_internal_faces),
           "st_deltas": list(deltas), "p_controls": p_controls,
           "blockmesh_s": blockmesh_s, "setup_s": setup_s, "warmup_s": warm_s,
           "sec_per_iter": sec, "sec_per_iter_trials": secs,
           "cells_per_sec": mesh.n_cells / sec,
           "tutorial_first_iteration_iterations": its_first,
           "p_iterations": its["p"], "u_iterations": its["U"],
           "p_iterations_mean": statistics.mean(its["p"]),
           "p_iterations_max": max(its["p"]),
           "u_iterations_mean": statistics.mean(its["U"]),
           "profiled_chunk_start": "after the warm-up chunk",
           "profiled_chunk_sec_per_iter": sec_p,
           "profiled_chunk_p_iterations": [int(i) for i in
                                           plog.iterations["p"]],
           "spmv_launches_per_iter": prof["spmv_launches_per_iter"],
           "cuda_launch_kernel_per_iter": prof["cuda_launch_kernel_per_iter"],
           "device_ms_per_iter": prof["device_ms_per_iter"],
           "device_busy_share": prof["device_busy_share_unprofiled"],
           "mrf_hooks": hooks,
           "continuity": float(diag["continuity"]),
           "u_max": float(torch.linalg.norm(u, dim=1).max()),
           "spmv_launches_total": launches,
           "spmv_fb_launches_total": fb_launches,
           "kernel_cases": cases, "max_abs_err_f32": max_err,
           "timings": timings,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    checks = {"finite": bool(torch.isfinite(u).all()),
              "|U| <= 1.05 x rotor speed": out["u_max"] <= 1.05 * MIXER_TIP,
              "rotor U = omega x r (1e-6)": rotor_velocity_error(
                  case, state)["rotor_u_err"] <= 1e-6,
              "spmv launched": launches > 0}
    out["checks"] = checks
    emit(out)
    for name, ok in checks.items():
        check(ok, f"mrf_headline check {name}: {out}")
    return out, max_err, timings


T_START = time.perf_counter()
TIMELINE = {}


def stamp(phase) -> None:
    """Seconds since the previous stamp (or the start), under `phase`."""
    now = time.perf_counter()
    TIMELINE[phase] = now - T_START - sum(TIMELINE.values())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from foamtpu_torch.ops import spmv
    from foamtpu_torch.solvers import simple

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
    stamp("device")
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        mesh, cfg, state = pitz_setup(here, os.path.join(root, "ops"))
        ops = pitz_operands(mesh, cfg, state)
        max_err, timings = phase_kernel(spmv, mesh, ops,
                                        tuple(mesh.st_deltas), flush)
        del mesh, cfg, state, ops
        stamp("kernel")
        phase_physics()
        stamp("physics")
        head = phase_headline(spmv)
        stamp("headline")
        pitz, pitz_run = phase_pitz(spmv, here, os.path.join(root, "run"))
        mesh, cfg, state = pitz_run
        profile_chunk(spmv, "pitz_profile", mesh,
                      simple.make_chunk(mesh, cfg, 10), state, 10,
                      pitz["simple_sec_per_iter"])
        del pitz_run, mesh, cfg, state
        stamp("pitz")
        duct, (mesh, cfg, state), log = phase_duct(spmv)
        err_duct, t_duct = phase_kernel_duct(spmv, mesh, cfg, log, flush)
        del log
        profile_chunk(spmv, "duct_profile", mesh,
                      simple.make_chunk(mesh, cfg, 2), state, 2,
                      duct["sec_per_iter"])
        del mesh, cfg, state
        stamp("duct")
        ras = phase_cavity_ras(spmv, here, os.path.join(root, "ras"))
        stamp("cavity_ras")
        pras = phase_pimple_ras(spmv, here, root)
        stamp("pimple_ras")
        phead = phase_pimple_headline(spmv)
        stamp("pimple_headline")
        dam, err_dam, t_dam = phase_dambreak(spmv, here, root, flush)
        stamp("dambreak")
        basic = phase_basic(spmv, here, root)
        stamp("basic")
        cross = phase_cross_headline(spmv, here, root)
        stamp("cross_headline")
        heated, err_heat, t_heat = phase_heated(spmv, here, root, flush)
        stamp("heated_1m")
        rot = phase_rotating(spmv, here, root)
        stamp("rotating")
        mrf, err_mrf, t_mrf = phase_mrf_headline(spmv, here, root, flush)
        stamp("mrf_headline")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "timeline", "seconds": TIMELINE,
          "total_s": time.perf_counter() - T_START})

    # the kernels line: device ms per call (torch.profiler) with L2
    # flushed before every call, beside the HBM bound, of the whole
    # operator at the duct's pressure operand (one launch, remainder
    # included), the largest call the main path makes; the warm-L2 time
    # apart, and every timed shape beside it
    main_shape = next(t for t in t_duct if t["shape"] == "duct_p_whole")
    paths = (head, pitz, duct, ras, pras, phead, dam, basic, cross, heated,
             rot, mrf)
    emit({"kernels": [{
        "name": "spmv_stencil", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": sum(p["spmv_launches_total"] for p in paths),
        "fb_launches": sum(p["spmv_fb_launches_total"] for p in paths),
        "max_abs_err": max(max_err, err_duct, err_dam, err_heat, err_mrf),
        "ms": main_shape["kernel_ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "ms_l2_warm": main_shape["kernel_ms_l2_warm"],
        "ms_cuda_graph": main_shape["kernel_graph_ms"],
        "shape": main_shape["shape"],
        "shapes": [{k: t[k] for k in (
            "shape", "n", "ncols", "offsets", "coo_entries", "kernel_ms",
            "kernel_ms_l2_warm", "kernel_graph_ms", "kernel_wrapper_ms",
            "plain_ms",
            "plain_ms_l2_warm", "library_ms", "library_ms_l2_warm",
            "bound_ms", "bound_by", "bound_share")}
            for t in timings + t_duct + t_dam + t_heat + t_mrf]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
