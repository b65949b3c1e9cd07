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
 16. rotating: the seven rotating-frame and porous tutorials through
     run(case), held to goldens and invariants.
 17. mrf_headline: MRFSimpleFoam's mixer at 294,912 cells, timed and
     profiled, the SpMV kernel held and timed at its p operand.
 18. turbulence_models: the seven RAS models of ras.py on the 2D channel
     of tests/test_turbulence.py (20 pisoFoam steps each), boundaryFoam
     on boundaryLaunderSharma (100 iterations) and channelFoam's
     channel395 (the first cyclic mesh on the card) under the six LES
     models (10 steps each, with yPlus and wallShearStress), all from
     case files through run(case): goldens from the JAX package and the
     reference tests' physics oracles (see phase_turbulence_models).
 19. les_headline: channel395 refined to 192x128x32 (786,432 cells, the
     cyclic wrap faces in the SpMV's COO remainder), Smagorinsky from a
     perturbed start: blockMesh, Case, 3 warm-up steps through run(case),
     three timed 5-step chunks, the SpMV kernel held to its plain version
     at the channel's p and U operands (f32, f64) and timed at p, and one
     profiled step last.
 20. thermal: both hotRoom tutorials through run(case) (SIMPLE 200
     iterations to tests/test_buoyant.py's oracles; PIMPLE 10 steps to the
     divergence the JAX package shows as shipped, and with the Euler ddt
     from a seeded start to goldens), and the Rayleigh-Benard onset.
 21. boussinesq_headline: hotRoom SIMPLE at 1024x768 (786,432 cells, the
     shipped GAMG p_rgh controls), three timed 5-iteration chunks, the
     GAMG cycles per p_rgh solve, the SpMV at the p_rgh operand, one
     profiled iteration.
 22. dym: pimpleDyMFoam's oscillatingBox (50 steps) and interDyMFoam on
     damBreak with an oscillatingLinearMotion dynamicMeshDict (20 steps)
     through run(case): goldens, constant volume, the motion, continuity.
 23. dym_headline: oscillatingBox at 1024^2 (1,048,576 cells) in memory,
     bench.py's GAMG p: timed steps, the device ms of update_geometry +
     mesh_flux, the SpMV at the moved mesh's p operand, one profiled step.
 24. surfaces_coded: sampledSurfaces (cutting plane, iso-surface, patch)
     and a coded object in the cavity through run(case) and on analytic
     fields, to goldens from the JAX package; their host ms at 400^2.
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
PROFILER_FALLBACKS = 0      # device_ms calls timed by CUDA events instead
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

        heat = "p_rgh" in state and "T" in state
        if heat:
            # buoyantBoussinesq*Foam: U, p_rgh and T
            self.names = {dimFlux * state["U"].dims: "U",
                          dimTime * state["p_rgh"].dims * dimLength: "p",
                          dimFlux * state["T"].dims: "T"}
        elif "p_rgh" in state:
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
        check(len(self.names) == (3 if heat else 1 if "T" in state else 2)
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
    times. When every attempt comes back empty (CUPTI stops recording in
    some processes), the call is timed without the profiler by
    `events_ms` and counted in PROFILER_FALLBACKS."""
    global INCOMPLETE_PROFILES, PROFILER_FALLBACKS
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
        if not events:
            PROFILER_FALLBACKS += 1
            return events_ms(fn, flush, reps)
        taken.append((events, sum(_dev_time(e, "self_device_time_total")
                                  for e in work) / 1e3))
    per_call = max(1, round(max(n for n, _ in taken) / reps))
    INCOMPLETE_PROFILES += sum(n < per_call * reps for n, _ in taken)
    return statistics.median(ms * per_call / n for n, ms in taken)


def events_ms(fn, flush=None, reps=30, replays=7) -> float:
    """Device ms per call of fn without the profiler: CUDA-event time of a
    CUDA graph of `reps` calls (each after a flush, with `flush`) less
    that of the flushes alone, over `reps`, the median of `replays`; where
    fn cannot be captured, events around `reps` eager calls (the host's
    launch gaps included, so an upper bound)."""
    try:
        return graph_ms(fn, flush, reps, replays)
    except RuntimeError:
        pass
    torch.cuda.synchronize()
    out = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            if flush is not None:
                flush.fill_(1)
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def graph_ms(fn, flush, reps=30, replays=7) -> float:
    """Device ms per call of fn with L2 flushed, without the profiler:
    CUDA-event time of a CUDA graph of `reps` (flush, fn) pairs less that
    of a graph of `reps` flushes, over `reps`; the median of `replays`
    (flush None: a graph of the calls back to back).
    A check of the profiler's time that does not depend on CUPTI; the
    gaps and overlap between a graph's kernels move it either way."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graphs = [torch.cuda.CUDAGraph()] + (
        [torch.cuda.CUDAGraph()] if flush is not None else [])
    for g, with_fn in zip(graphs, (True, False)):
        with torch.cuda.graph(g):
            for _ in range(reps):
                if flush is not None:
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
    base = replay_ms(graphs[1]) if flush is not None else 0.0
    return (replay_ms(graphs[0]) - base) / reps


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


# ---------------------------------------------------------------------------
# turbulence_models and les_headline: the RAS models of ras.py on the 2D
# channel of tests/test_turbulence.py, boundaryFoam, and channelFoam's
# channel395 under the six LES models of les.py and les2.py
# ---------------------------------------------------------------------------

RAS_CHANNEL_NU = 1e-4         # tests/test_turbulence.py: U 1, H 0.1
RAS_CHANNEL_STEPS = 20
RAS_CHANNEL_DT = 0.02
# model: (its second transported field, the nut wall BC it is run with;
# the BCs ported with the models are spread over them)
RAS_CHANNEL_MODELS = {
    "RNGkEpsilon": ("epsilon", "nutkWallFunction"),
    "realizableKE": ("epsilon", "nutUWallFunction"),
    "LaunderSharmaKE": ("epsilon", "nutLowReWallFunction"),
    "kOmega": ("omega", "nutUSpaldingWallFunction"),
    "SpalartAllmaras": (None, "nutUSpaldingWallFunction"),
    "SpalartAllmarasDES": (None, "nutUWallFunction"),
    "SpalartAllmarasDDES": (None, "nutUSpaldingWallFunction"),
}
CHANNEL395_CASE = os.path.join("tutorials", "incompressible", "channelFoam",
                               "channel395")
BOUNDARY_CASE = os.path.join("tutorials", "incompressible", "boundaryFoam",
                             "boundaryLaunderSharma")
BOUNDARY_STEPS = 100          # the tutorial's endTime 100 / deltaT 1
LES_MODELS = ("Smagorinsky", "oneEqEddy", "homogeneousDynSmagorinsky",
              "dynOneEqEddy", "scaleSimilarity", "mixedSmagorinsky")
LES_K_MODELS = ("oneEqEddy", "dynOneEqEddy")
LES_STEPS = 10
LES_FUNCS = """
functions
{
    yPlus1 { type yPlus; }
    shear1 { type wallShearStress; }
}
"""

# from tests/test_torch_channel.py::reference_goldens (the JAX package on the CPU
# in float32, through its run_case, on the cases written above)
RAS_GOLDEN = {
    "RNGkEpsilon": {
        "ke": 0.5117350220680237,
        "ux_centre_out": 0.6911365985870361,
        "ux_centre_row": 0.9999900460243225,
        "ux_wall_row": 0.9979972243309021,
        "k_max": 0.06511863321065903,
        "k_mean": 0.013255960308015347,
        "epsilon_max": 1.2905679941177368,
        "epsilon_mean": 0.17046070098876953,
        "nut_max": 0.0006952387630008161,
        "nut_mean": 0.00014770434063393623,
    },
    "realizableKE": {
        "ke": 0.5120598077774048,
        "ux_centre_out": 0.682236909866333,
        "ux_centre_row": 0.9999908804893494,
        "ux_wall_row": 0.9980452060699463,
        "k_max": 0.06353656947612762,
        "k_mean": 0.012216247618198395,
        "epsilon_max": 1.3067806959152222,
        "epsilon_mean": 0.17540444433689117,
        "nut_max": 0.0016722457949072123,
        "nut_mean": 0.0002180171140935272,
    },
    "LaunderSharmaKE": {
        "ke": 0.503154456615448,
        "ux_centre_out": 0.8681455254554749,
        "ux_centre_row": 0.9999850988388062,
        "ux_wall_row": 0.9977337718009949,
        "k_max": 1.5880711078643799,
        "k_mean": 0.27780431509017944,
        "epsilon_max": 31.05703353881836,
        "epsilon_mean": 4.4745774269104,
        "nut_max": 0.007225282955914736,
        "nut_mean": 0.0015147414524108171,
    },
    "kOmega": {
        "ke": 0.5152376890182495,
        "ux_centre_out": 0.6366220116615295,
        "ux_centre_row": 0.9999997615814209,
        "ux_wall_row": 0.9977689385414124,
        "k_max": 0.02053774520754814,
        "k_mean": 0.005895450245589018,
        "omega_max": 357.6550598144531,
        "omega_mean": 97.27108764648438,
        "nut_max": 0.00033390987664461136,
        "nut_mean": 0.00014952782657928765,
    },
    "SpalartAllmaras": {
        "ke": 0.5178465247154236,
        "ux_centre_out": 0.6032958030700684,
        "ux_centre_row": 1.0000003576278687,
        "ux_wall_row": 0.9977140426635742,
        "nuTilda_max": 0.0008827498531900346,
        "nuTilda_mean": 0.0002103252918459475,
        "nut_max": 0.0005806380650028586,
        "nut_mean": 1.5108946172404103e-05,
    },
    "SpalartAllmarasDES": {
        "ke": 0.5167974233627319,
        "ux_centre_out": 0.6144391894340515,
        "ux_centre_row": 0.9999968409538269,
        "ux_wall_row": 0.9978778958320618,
        "nuTilda_max": 0.0002611973031889647,
        "nuTilda_mean": 9.415398380951956e-05,
        "nut_max": 1.2387902643240523e-05,
        "nut_mean": 7.031505333543464e-07,
    },
    "SpalartAllmarasDDES": {
        "ke": 0.5178455114364624,
        "ux_centre_out": 0.6032947897911072,
        "ux_centre_row": 0.9999993443489075,
        "ux_wall_row": 0.9977138638496399,
        "nuTilda_max": 0.0008827500860206783,
        "nuTilda_mean": 0.00021032516087871045,
        "nut_max": 0.000580638472456485,
        "nut_mean": 1.5108938896446489e-05,
    },
}
LES_GOLDEN = {
    "Smagorinsky": {
        "ke": 0.009157366119325161,
        "ux_mean": 0.13398291170597076,
        "ux_wall_layers": 0.13304540514945984,
        "ux_centre_layers": 0.13413278758525848,
        "nut_mean": 0.00011662590986816213,
        "yplus_min": 17.836,
        "yplus_max": 23.2466,
        "yplus_avg": 20.5728,
        "wall_shear_min": 3.25758e-05,
        "wall_shear_max": 5.53372e-05,
    },
    "oneEqEddy": {
        "ke": 0.009158619679510593,
        "ux_mean": 0.13398100435733795,
        "ux_wall_layers": 0.13303901255130768,
        "ux_centre_layers": 0.1341327279806137,
        "nut_mean": 8.924316352931783e-05,
        "yplus_min": 20.253,
        "yplus_max": 27.4004,
        "yplus_avg": 23.6799,
        "wall_shear_min": 4.20028e-05,
        "wall_shear_max": 7.68801e-05,
        "k_mean": 7.575711788376793e-05,
    },
    "homogeneousDynSmagorinsky": {
        "ke": 0.009163140319287777,
        "ux_mean": 0.13398297131061554,
        "ux_wall_layers": 0.13304363191127777,
        "ux_centre_layers": 0.13413196802139282,
        "nut_mean": 0.0,
        "yplus_min": 17.706,
        "yplus_max": 23.3691,
        "yplus_avg": 20.5768,
        "wall_shear_min": 3.21026e-05,
        "wall_shear_max": 5.59221e-05,
    },
    "dynOneEqEddy": {
        "ke": 0.00916200876235962,
        "ux_mean": 0.1339813470840454,
        "ux_wall_layers": 0.13303937017917633,
        "ux_centre_layers": 0.13413219153881073,
        "nut_mean": 1.8656231986824423e-05,
        "yplus_min": 19.5615,
        "yplus_max": 26.0771,
        "yplus_avg": 22.7957,
        "wall_shear_min": 3.91835e-05,
        "wall_shear_max": 6.96334e-05,
        "k_mean": 7.302653102669865e-05,
    },
    "scaleSimilarity": {
        "ke": 0.009162929840385914,
        "ux_mean": 0.13398145139217377,
        "ux_wall_layers": 0.1330329030752182,
        "ux_centre_layers": 0.13413403928279877,
        "nut_mean": 0.0,
        "yplus_min": 17.6912,
        "yplus_max": 23.3357,
        "yplus_avg": 20.5768,
        "wall_shear_min": 3.20491e-05,
        "wall_shear_max": 5.57625e-05,
    },
    "mixedSmagorinsky": {
        "ke": 0.009157159365713596,
        "ux_mean": 0.13398145139217377,
        "ux_wall_layers": 0.13303498923778534,
        "ux_centre_layers": 0.13413481414318085,
        "nut_mean": 0.00011662683391477913,
        "yplus_min": 17.8222,
        "yplus_max": 23.2151,
        "yplus_avg": 20.5728,
        "wall_shear_min": 3.25253e-05,
        "wall_shear_max": 5.51877e-05,
    },
}
# the golden tolerance (relative), and the least magnitude an error is
# taken relative to where a golden is 0 (homogeneousDynSmagorinsky's cD
# clips to 0 from this start; scaleSimilarity has no eddy viscosity)
TURB_GOLDEN_TOL = 1e-3
TURB_GOLDEN_FLOOR = {"nut_mean": 1e-7}
# the oracle "nut exceeds nu somewhere": not for SpalartAllmarasDES, whose
# length scale CDES cbrt(V) (~4e-3 m on this 2D mesh) keeps nut below nu,
# nor for the LES models whose nut is 0 here (homogeneousDynSmagorinsky,
# scaleSimilarity) or held below nu by its dynamic Ck (dynOneEqEddy:
# mean nut 1.9e-5 against nu 2e-5 in the JAX package's run)
NUT_BELOW_NU = ("SpalartAllmarasDES", "homogeneousDynSmagorinsky",
                "scaleSimilarity", "dynOneEqEddy")
LES_HEAD_BLOCKS = (192, 128, 32)   # 786,432 cells of 0.021 x 0.016 x 0.016
LES_HEAD_WARMUP = 3
LES_HEAD_STEPS = 5
LES_HEAD_PROFILE = 1


_rows = "\n".join


def _foam_header(cls, obj):
    return ("FoamFile { version 2.0; format ascii; "
            f"class {cls}; object {obj}; }}\n")


def write_field(case_dir, name, dims, internal, boundary):
    """0/<name> with `internal` a scalar, a 3-vector, or per-cell values
    ([n] or [n,3], written exactly with repr) and `boundary` the text of
    the boundaryField entries."""
    a = np.asarray(internal, dtype=np.float64)
    vec = a.shape[-1:] == (3,)
    cls = "volVectorField" if vec else "volScalarField"
    if a.ndim == (1 if vec else 0):
        body = ("uniform (" + " ".join(repr(float(x)) for x in a) + ")"
                if vec else f"uniform {float(a)!r}")
    else:
        rows = ("(" + " ".join(repr(float(x)) for x in r) + ")"
                for r in a) if vec else (repr(float(x)) for x in a)
        body = (f"nonuniform List<{'vector' if vec else 'scalar'}> "
                f"{a.shape[0]}\n(\n" + "\n".join(rows) + "\n)")
    with open(os.path.join(case_dir, "0", name), "w") as f:
        f.write(_foam_header(cls, name)
                + f"dimensions {dims};\ninternalField {body};\n"
                + f"boundaryField\n{{\n{boundary}\n}}\n")


def _write_text(case_dir, rel, text):
    path = os.path.join(case_dir, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def ras_channel_scales():
    """The inlet turbulence of tests/test_turbulence.py::channel_fields
    (5 % intensity, 0.01 m length scale), and nuTilda 4 nu."""
    k0 = 1.5 * (1.0 * 0.05) ** 2
    eps0 = 0.09 ** 0.75 * k0 ** 1.5 / 0.01
    return {"k": k0, "epsilon": eps0, "omega": eps0 / (0.09 * k0),
            "nuTilda": 4.0 * RAS_CHANNEL_NU}


def ras_channel_case(dst, model, steps=RAS_CHANNEL_STEPS, seed=1,
                     nx=30, ny=10):
    """The 2D channel of tests/test_turbulence.py (2 x 0.1 m, nx x ny,
    walls top and bottom, U = 1 at the inlet) as pisoFoam case files for
    one RAS model: its fields under 0/ with the channel's BCs (the nut
    wall BC of RAS_CHANNEL_MODELS; LaunderSharmaKE integrates to the wall:
    k fixed at 1e-10 and epsilon zeroGradient there), PCG p and PBiCGStab
    U at relTol 0, limitedLinear 1 for U and the model's fields. A
    well-posed start: Ux = 1 + 0.1u, Uy = 0.05n and each turbulence field
    its inlet value times 1 + 0.2u, u and n from numpy's generator at
    `seed` (the limiter of a uniform field is a ratio of round-off).
    Returns dst; mesh it with blockMesh."""
    second, nut_wall = RAS_CHANNEL_MODELS[model]
    os.makedirs(os.path.join(dst, "0"), exist_ok=True)
    _write_text(dst, "system/blockMeshDict", _foam_header(
        "dictionary", "blockMeshDict") + f"""
convertToMeters 1;
vertices ( (0 0 0) (2 0 0) (2 0.1 0) (0 0.1 0)
           (0 0 0.01) (2 0 0.01) (2 0.1 0.01) (0 0.1 0.01) );
blocks ( hex (0 1 2 3 4 5 6 7) ({nx} {ny} 1) simpleGrading (1 1 1) );
boundary (
    inlet {{ type patch; faces ((0 4 7 3)); }}
    outlet {{ type patch; faces ((2 6 5 1)); }}
    walls {{ type wall; faces ((1 5 4 0) (3 7 6 2)); }}
    frontAndBack {{ type empty; faces ((0 3 2 1) (4 5 6 7)); }}
);
""")
    _write_text(dst, "system/controlDict", _foam_header(
        "dictionary", "controlDict") + f"""
application pisoFoam; startFrom startTime; startTime 0; stopAt endTime;
endTime {steps * RAS_CHANNEL_DT!r}; deltaT {RAS_CHANNEL_DT!r};
writeControl timeStep; writeInterval {steps}; writeFormat ascii;
""")
    _write_text(dst, "system/fvSchemes", _foam_header(
        "dictionary", "fvSchemes") + """
ddtSchemes { default Euler; }
gradSchemes { default Gauss linear; }
divSchemes { default none; div(phi,U) Gauss limitedLinear 1;
             div(phi,k) Gauss limitedLinear 1; }
laplacianSchemes { default Gauss linear corrected; }
interpolationSchemes { default linear; }
snGradSchemes { default corrected; }
""")
    _write_text(dst, "system/fvSolution", _foam_header(
        "dictionary", "fvSolution") + """
solvers
{
    p { solver PCG; preconditioner DIC; tolerance 1e-07; relTol 0; }
    U { solver PBiCGStab; preconditioner DILU; tolerance 1e-07; relTol 0; }
    "(k|epsilon|omega|nuTilda)"
    { solver PBiCGStab; preconditioner DILU; tolerance 1e-08; relTol 0.01; }
}
PISO { nCorrectors 2; nNonOrthogonalCorrectors 0; pRefCell 0; pRefValue 0; }
""")
    _write_text(dst, "constant/transportProperties", _foam_header(
        "dictionary", "transportProperties")
        + f"nu nu [0 2 -1 0 0 0 0] {RAS_CHANNEL_NU!r};\n")
    _write_text(dst, "constant/RASProperties", _foam_header(
        "dictionary", "RASProperties")
        + f"RASModel {model}; turbulence on; printCoeffs on;\n")

    n = nx * ny
    rng = np.random.default_rng(seed)
    U = np.zeros((n, 3))
    U[:, 0] = 1.0 + 0.1 * rng.random(n)
    U[:, 1] = 0.05 * rng.standard_normal(n)
    empty = "frontAndBack { type empty; }"
    write_field(dst, "U", "[0 1 -1 0 0 0 0]", U, _rows([
        "inlet { type fixedValue; value uniform (1 0 0); }",
        "outlet { type inletOutlet; inletValue uniform (0 0 0); "
        "value uniform (0 0 0); }",
        "walls { type fixedValue; value uniform (0 0 0); }", empty]))
    write_field(dst, "p", "[0 2 -2 0 0 0 0]", 0.0, _rows([
        "inlet { type zeroGradient; }",
        "outlet { type fixedValue; value uniform 0; }",
        "walls { type zeroGradient; }", empty]))
    scales = ras_channel_scales()
    low_re = model == "LaunderSharmaKE"
    walls = {"k": ("walls { type fixedValue; value uniform 1e-10; }"
                   if low_re else
                   f"walls {{ type kqRWallFunction; value uniform "
                   f"{scales['k']!r}; }}"),
             "epsilon": ("walls { type zeroGradient; }" if low_re else
                         f"walls {{ type epsilonWallFunction; value uniform "
                         f"{scales['epsilon']!r}; }}"),
             "omega": f"walls {{ type omegaWallFunction; value uniform "
                      f"{scales['omega']!r}; }}",
             "nuTilda": "walls { type fixedValue; value uniform 0; }"}
    dims = {"k": "[0 2 -2 0 0 0 0]", "epsilon": "[0 2 -3 0 0 0 0]",
            "omega": "[0 0 -1 0 0 0 0]", "nuTilda": "[0 2 -1 0 0 0 0]"}
    names = ("nuTilda",) if second is None else ("k", second)
    for name in names:
        v0 = scales[name]
        write_field(dst, name, dims[name], v0 * (1.0 + 0.2 * rng.random(n)),
                    _rows([
                        f"inlet {{ type fixedValue; value uniform {v0!r}; }}",
                        "outlet { type inletOutlet; inletValue uniform 0; "
                        "value uniform 0; }", walls[name], empty]))
    write_field(dst, "nut", "[0 2 -1 0 0 0 0]", 0.0, _rows([
        "inlet { type calculated; value uniform 0; }",
        "outlet { type calculated; value uniform 0; }",
        f"walls {{ type {nut_wall}; value uniform 0; }}", empty]))
    return dst


def les_channel_case(here, dst, model, blocks=(24, 16, 8), steps=LES_STEPS,
                     seed=2, funcs=""):
    """channelFoam's channel395 copied to dst with its block cut to
    `blocks`, LESProperties naming `model`, endTime `steps` deltaT, and
    a well-posed start: U = Ubar + 0.1 |Ubar| n per component and, for
    the models that carry k (LES_K_MODELS), 0/k = k0 (1 + 0.2u) with
    k0 = 1.5 (0.05 Ubar)^2, fixed at 0 on the walls; u and n from numpy's
    generator at `seed`. Returns dst; mesh it with blockMesh."""
    shutil.copytree(os.path.join(here, CHANNEL395_CASE), dst)

    def edit(rel, old, new):
        path = os.path.join(dst, rel)
        with open(path) as f:
            text = f.read()
        check(old in text, f"{path} holds no {old!r}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))

    edit("system/blockMeshDict", "(24 16 8)", "({} {} {})".format(*blocks))
    edit("constant/LESProperties", "LESModel        Smagorinsky;",
         f"LESModel        {model};")
    edit("system/controlDict", "endTime         0.2;",
         f"endTime         {steps * 0.02!r};\n{funcs}")
    edit("system/controlDict", "writeInterval   10;",
         f"writeInterval   {steps};")
    n = blocks[0] * blocks[1] * blocks[2]
    rng = np.random.default_rng(seed)
    ubar = np.array([0.1335, 0.0, 0.0])
    U = ubar + 0.1 * np.linalg.norm(ubar) * rng.standard_normal((n, 3))
    cyclic = _rows(f"{p} {{ type cyclic; }}"
                         for p in ("inlet", "outlet", "front", "back"))
    write_field(dst, "U", "[0 1 -1 0 0 0 0]", U, cyclic + "\n"
                "walls { type fixedValue; value uniform (0 0 0); }")
    if model in LES_K_MODELS:
        k0 = 1.5 * (0.05 * 0.1335) ** 2
        write_field(dst, "k", "[0 2 -2 0 0 0 0]",
                    k0 * (1.0 + 0.2 * rng.random(n)), cyclic + "\n"
                    "walls { type fixedValue; value uniform 0; }")
    return dst


def turbulence_arrays(state, host):
    """U, p and the turbulence fields of a final state as numpy arrays."""
    out = {"U": host(state["U"].data)}
    if "p" in state:
        out["p"] = host(state["p"].data)
    for name, f in (state.get("turb") or {}).items():
        out[name] = host(f.data)
    return out


def ras_channel_scalars(a, v, nx=30, ny=10):
    """The golden scalars of a RAS channel run: the volume-averaged
    kinetic energy, Ux of the outlet column's centreline cell, the mean
    Ux of the centre row and of the wall row, and the largest and the
    mean value of each turbulence field (cells are numbered x first)."""
    u = a["U"]
    ux = u[:, 0].reshape(ny, nx)
    out = {"ke": float(np.sum(0.5 * np.sum(u * u, axis=1) * v) / v.sum()),
           "ux_centre_out": float(ux[ny // 2, -1]),
           "ux_centre_row": float(ux[ny // 2].mean()),
           "ux_wall_row": float(ux[0].mean())}
    for name in ("k", "epsilon", "omega", "nuTilda", "nut"):
        if name in a:
            out[f"{name}_max"] = float(a[name].max())
            out[f"{name}_mean"] = float(np.sum(a[name] * v) / v.sum())
    return out


def post_last_row(case_dir, rel):
    """The numbers of the last row of a postProcessing .dat file."""
    with open(os.path.join(case_dir, "postProcessing", rel)) as f:
        row = f.read().strip().splitlines()[-1].split()
    return [float(x) for x in row[2:]]


def les_channel_scalars(a, v, case_dir, blocks=(24, 16, 8)):
    """The golden scalars of an LES channel run: the volume-averaged
    kinetic energy and Ux, the mean Ux of the two wall-adjacent layers
    and of the two centre layers (cells are numbered x, then y, then z),
    the mean nut (and k), and the last rows of the yPlus and
    wallShearStress files."""
    u = a["U"]
    nx, ny, nz = blocks
    ux = u[:, 0].reshape(nz, ny, nx)
    yp = post_last_row(case_dir, "yPlus1/yPlus.dat")
    ws = post_last_row(case_dir, "shear1/wallShearStress.dat")
    out = {"ke": float(np.sum(0.5 * np.sum(u * u, axis=1) * v) / v.sum()),
           "ux_mean": float(np.sum(u[:, 0] * v) / v.sum()),
           "ux_wall_layers": float(ux[:, [0, ny - 1], :].mean()),
           "ux_centre_layers": float(ux[:, [ny // 2 - 1, ny // 2], :].mean()),
           "nut_mean": float(np.sum(a["nut"] * v) / v.sum()),
           "yplus_min": yp[0], "yplus_max": yp[1], "yplus_avg": yp[2],
           "wall_shear_min": ws[0], "wall_shear_max": ws[1]}
    if "k" in a:
        out["k_mean"] = float(np.sum(a["k"] * v) / v.sum())
    return out


def log_continuity(text):
    """The 'sum local' continuity errors of an application's log."""
    return [float(m) for m in re.findall(
        r"continuity errors : sum local = (\S+),", text)]


def turbulence_oracles(name, a, nu):
    """The physics oracles of the reference's turbulence tests that hold
    on these starts: finite fields, nut >= 0, k, epsilon, omega and
    nuTilda > 0, the centre faster than the wall (RAS: the centre row
    over the wall row; LES: the two centre layers over the two wall
    layers), and nut above nu somewhere (not for NUT_BELOW_NU)."""
    checks = {"finite": all(bool(np.isfinite(x).all()) for x in a.values()),
              "nut >= 0": bool(a["nut"].min() >= 0.0)}
    for f in ("k", "epsilon", "omega", "nuTilda"):
        if f in a:
            checks[f"{f} > 0"] = bool(a[f].min() > 0.0)
    if name not in NUT_BELOW_NU:
        checks["nut > nu somewhere"] = bool(a["nut"].max() > nu)
    if name == "scaleSimilarity":
        checks["nut == 0"] = bool(np.all(a["nut"] == 0.0))
    return checks


def phase_turbulence_models(spmv, here, root):
    """The seven RAS models of ras.py on the 2D channel
    (ras_channel_case, RAS_CHANNEL_STEPS pisoFoam steps), boundaryFoam on
    its tutorial (BOUNDARY_STEPS iterations) and channel395 under the six
    LES models (les_channel_case, LES_STEPS channelFoam steps, with a
    yPlus and a wallShearStress object), each from case files through
    run(case) on the card, the counts set to 0 before each run. Held to
    goldens from the JAX package (RAS and LES, TURB_GOLDEN_TOL), to the
    oracles of `turbulence_oracles` and continuity < 1e-3 per unit time
    step (tests/test_turbulence.py's bound). boundaryFoam, whose profile
    does not develop in either package (ROADMAP Queue 3), is held to its
    invariants: finite, k and epsilon > 0, nut >= 0 and the bulk velocity
    at Ubar after every iteration."""
    from foamtpu_torch.apps.cli import main as cli
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.solvers.apps import run

    results, checks = {}, {}
    launches_total = fb_total = 0

    def one(kind, dst, steps):
        nonlocal launches_total, fb_total
        with quiet():
            check(cli(["blockMesh", "-case", dst]) == 0, "blockMesh failed")
        case = Case(dst, device="cuda")
        log = io.StringIO()
        spmv.LAUNCHES = spmv.FB_LAUNCHES = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            run(case, max_steps=steps)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches_total += spmv.LAUNCHES
        fb_total += spmv.FB_LAUNCHES
        text = log.getvalue()
        sys.stderr.write(text[-2000:])
        a = turbulence_arrays(case.final_state, lambda t: t.cpu().numpy())
        v = case.mesh.v.cpu().numpy()
        rec = {"kind": kind, "n_cells": case.mesh.n_cells,
               "steps": case.time.index, "run_s": run_s,
               "sec_per_step": run_s / max(case.time.index, 1),
               "coo_fraction": float(case.mesh.fb_cells.shape[0])
               / (2 * case.mesh.n_internal_faces),
               "spmv_launches": spmv.LAUNCHES,
               "spmv_fb_launches": spmv.FB_LAUNCHES}
        ck = {"steps": case.time.index == steps,
              "spmv launched": spmv.LAUNCHES > 0}
        its = solve_iterations(text)
        rec["iterations_max"] = {k: max(x) for k, x in its.items()}
        return case, a, v, text, rec, ck

    from foamtpu_torch.core.dictionary import dimensioned_scalar

    for model in RAS_CHANNEL_MODELS:
        dst = ras_channel_case(os.path.join(root, "ras", model), model)
        case, a, v, text, rec, ck = one("ras", dst, RAS_CHANNEL_STEPS)
        got = ras_channel_scalars(a, v)
        rel = golden_rel_err(got, RAS_GOLDEN[model], TURB_GOLDEN_FLOOR)
        ck.update(turbulence_oracles(model, a, RAS_CHANNEL_NU))
        ck["centre row faster than wall row"] = (got["ux_centre_row"]
                                                 > got["ux_wall_row"])
        cont = max(log_continuity(text)) / RAS_CHANNEL_DT
        ck["continuity < 1e-3"] = cont < 1e-3
        ck.update({f"golden {k}": r <= TURB_GOLDEN_TOL
                   for k, r in rel.items()})
        rec.update(scalars=got, golden_rel_err=rel, continuity=cont,
                   checks="goldens and oracles")
        results[model] = rec
        checks.update({f"{model} {k}": x for k, x in ck.items()})

    dst = os.path.join(root, "boundary")
    shutil.copytree(os.path.join(here, BOUNDARY_CASE), dst)
    case, a, v, text, rec, ck = one("boundaryFoam", dst, BOUNDARY_STEPS)
    ubar = (a["U"] * v[:, None]).sum(axis=0) / v.sum()
    gradp = [float(x) for x in re.findall(r"pressure gradient = (\S+)",
                                          text)]
    ck.update({"finite": all(bool(np.isfinite(x).all())
                             for x in a.values()),
               "k > 0": bool(a["k"].min() > 0),
               "epsilon > 0": bool(a["epsilon"].min() > 0),
               "nut >= 0": bool(a["nut"].min() >= 0),
               "bulk U = Ubar (1e-5)": bool(
                   np.abs(ubar - [1.0, 0.0, 0.0]).max() <= 1e-5),
               "gradP logged every iteration": len(gradp) == BOUNDARY_STEPS})
    rec.update(ubar=ubar.tolist(), gradp_last=gradp[-5:],
               u_min=float(a["U"][:, 0].min()),
               u_max=float(a["U"][:, 0].max()),
               checks="invariants (the reference's profile does not develop)")
    results["boundaryLaunderSharma"] = rec
    checks.update({f"boundaryLaunderSharma {k}": x for k, x in ck.items()})

    for model in LES_MODELS:
        dst = les_channel_case(here, os.path.join(root, "les", model), model,
                               funcs=LES_FUNCS)
        case, a, v, text, rec, ck = one("les", dst, LES_STEPS)
        _, nu = dimensioned_scalar(case.transport_properties()["nu"])
        got = les_channel_scalars(a, v, dst)
        rel = golden_rel_err(got, LES_GOLDEN[model], TURB_GOLDEN_FLOOR)
        ck.update(turbulence_oracles(model, a, nu))
        ck["centre layers faster than wall layers"] = (
            got["ux_centre_layers"] > got["ux_wall_layers"])
        cont = max(log_continuity(text)) / 0.02
        ck["continuity < 1e-3"] = cont < 1e-3
        ck.update({f"golden {k}": r <= TURB_GOLDEN_TOL
                   for k, r in rel.items()})
        fol = case.function_objects
        ck["function objects ran"] = (fol.failures == 0
                                      and fol.executes == LES_STEPS)
        rec.update(scalars=got, golden_rel_err=rel, continuity=cont,
                   fo_fetches=fol.fetches(), fo_seconds=fol.seconds,
                   checks="goldens (yPlus and wallShearStress files among "
                          "them) and oracles")
        results[model] = rec
        checks.update({f"{model} {k}": x for k, x in ck.items()})

    out = {"phase": "turbulence_models", "dtype": "torch.float32",
           "runs": results, "spmv_launches_total": launches_total,
           "spmv_fb_launches_total": fb_total, "checks": checks}
    emit(out)
    for name, ok in checks.items():
        check(ok, f"turbulence_models check {name}: {out}")
    return out


def phase_les_headline(spmv, here, root, flush, trials=3):
    """channel395 with its block refined to LES_HEAD_BLOCKS (786,432
    cells; geometry, cyclic pairs, schemes and deltaT as shipped),
    Smagorinsky, U = Ubar plus a 10% perturbation drawn on the card with
    a torch.Generator: blockMesh, Case, LES_HEAD_WARMUP steps through
    run(case) (the tutorial's PCG p; bench.py's GAMG controls if a p
    solve reaches its cap), `trials` timed chunks of LES_HEAD_STEPS steps
    of the application's step, the SpMV kernel held to its plain version
    at the channel's p and U operands (f32, f64) and timed at the p
    operand, and last one profiled chunk of LES_HEAD_PROFILE steps."""
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.core.dictionary import dimensioned_scalar
    from foamtpu_torch.solvers import apps, pimple
    from foamtpu_torch.solvers.apps import run
    from foamtpu_torch.solvers.linear.gamg import GAMG

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    blocks = "({} {} {})".format(*LES_HEAD_BLOCKS)
    dst = copy_case(here, CHANNEL395_CASE, root, "channel_big", edits=[
        ("system/blockMeshDict", "(24 16 8)", blocks)])
    blockmesh_s = time.perf_counter() - t0
    case = Case(dst, device="cuda")
    mesh = case.mesh
    n = LES_HEAD_BLOCKS[0] * LES_HEAD_BLOCKS[1] * LES_HEAD_BLOCKS[2]
    check(mesh.n_cells == n, mesh.n_cells)
    # U = Ubar + 0.1 |Ubar| n, drawn on the card
    U0 = case.read_field("U")
    gen = torch.Generator(device="cuda").manual_seed(395)
    ubar = U0.data[0].clone()
    u_start = ubar + 0.1 * torch.linalg.norm(ubar) * torch.randn(
        U0.data.shape, generator=gen, device="cuda", dtype=U0.data.dtype)
    read_field = case.read_field
    case.read_field = lambda name, *a, **k: (
        read_field(name, *a, **k).with_data(u_start) if name == "U"
        else read_field(name, *a, **k))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    progress("les_headline", f"set-up {setup_s:.1f} s, {n} cells")
    spmv.LAUNCHES = spmv.FB_LAUNCHES = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        run(case, max_steps=LES_HEAD_WARMUP)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_its = solve_iterations(log.getvalue())
    progress("les_headline", f"warm-up {warm_s:.1f} s, p iterations "
             f"{warm_its.get('p')}")
    _, nu = dimensioned_scalar(case.transport_properties()["nu"])
    model, _ = apps._load_turbulence(case, nu)
    cfg = apps._pimple_config(case, nu, model)
    p_cap = int(cfg.p_controls.get("maxIter", 1000))
    p_controls = "tutorial (PCG, polynomial preconditioner)"
    if max(warm_its.get("p", [0])) >= p_cap:
        gamg = {"solver": "GAMG", "preconditioner": "polynomial",
                "tolerance": 1e-6, "relTol": 0.01, "maxIter": 1000,
                "_gamg": GAMG(mesh)}
        cfg = cfg._replace(p_controls=gamg, p_controls_final=dict(
            gamg, relTol=0.0))
        p_controls = ("bench.py's GAMG (the tutorial's PCG reached its cap "
                      f"of {p_cap} in the warm-up: {warm_its['p']})")
    step = pimple.make_step(mesh, cfg)
    state = case.final_state
    dt = case.time.delta_t

    def chunk_of(k):
        def chunk(st):
            diag = None
            for _ in range(k):
                st, diag = step(st, dt)
            return st, diag
        return chunk

    chunk = chunk_of(LES_HEAD_STEPS)
    secs = []
    l0 = spmv.LAUNCHES
    with SolveLog(state) as tlog:
        for _ in range(trials):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, diag = chunk(state)
            torch.cuda.synchronize()
            secs.append((time.perf_counter() - t0) / LES_HEAD_STEPS)
    p_its = [int(i) for i in tlog.iterations["p"]]
    launches_per_step = (spmv.LAUNCHES - l0) / (trials * LES_HEAD_STEPS)
    sec = statistics.median(secs)
    progress("les_headline", f"timed chunks {secs}")
    launches, fb_launches = spmv.LAUNCHES, spmv.FB_LAUNCHES
    # the kernel at the channel's p and U operands (the cyclic wrap
    # offsets, the remainder fused): held to its plain version, timed at p
    ops = solve_operands(tlog, mesh, "channel")
    deltas = tuple(mesh.st_deltas)
    cases, max_err = [], 0.0
    for dtype in (torch.float32, torch.float64):
        err = check_operands(spmv, ops, mesh, deltas, dtype,
                             np.random.default_rng(43), cases)
        if dtype == torch.float32:
            max_err = err
    _, soff, diag_p, sfb = ops[0]
    timings = time_shape(
        spmv, "channel_p", diag_p.contiguous(), operand_x(diag_p, 44),
        soff.contiguous(), deltas, flush,
        fb=mesh_remainder(spmv, mesh, sfb, diag_p.dtype))
    # the profiled chunk last, from the state the timed chunks left
    l1, f1 = spmv.LAUNCHES, spmv.FB_LAUNCHES
    _, prof = profile_chunk(spmv, "les_headline_profile", mesh,
                            chunk_of(LES_HEAD_PROFILE), state,
                            LES_HEAD_PROFILE, sec)
    launches += spmv.LAUNCHES - l1
    fb_launches += spmv.FB_LAUNCHES - f1
    u = state["U"].data
    nut = state["turb"]["nut"].data
    n_fb = int(mesh.fb_cells.shape[0])
    out = {"phase": "les_headline",
           "case": f"channelFoam channel395, block {blocks}: the tutorial's "
                   "geometry, cyclic pairs, schemes, deltaT and Smagorinsky",
           "n_cells": n, "dtype": str(mesh.v.dtype),
           "coo_fraction": n_fb / (2 * mesh.n_internal_faces),
           "coo_entries": n_fb, "st_deltas": list(deltas),
           "p_controls": p_controls, "blockmesh_s": blockmesh_s,
           "setup_s": setup_s, "warmup_s": warm_s,
           "warmup_p_iterations": warm_its.get("p"),
           "sec_per_step": sec, "sec_per_step_trials": secs,
           "m_cells_per_sec": n / sec / 1e6,
           "p_iterations": p_its, "p_iterations_mean": statistics.mean(p_its),
           "p_iterations_max": max(p_its),
           "spmv_launches_per_step": launches_per_step,
           "cuda_launch_kernel_per_step": prof["cuda_launch_kernel_per_iter"],
           "device_ms_per_step": prof["device_ms_per_iter"],
           "device_busy_share": prof["device_busy_share_unprofiled"],
           "spmv_device_ms_per_step": prof["spmv_device_ms_per_iter"],
           "continuity": float(diag["continuity"]),
           "u_max": float(torch.linalg.norm(u, dim=1).max()),
           "nut_mean": float(nut.mean()),
           "spmv_launches_total": launches,
           "spmv_fb_launches_total": fb_launches,
           "kernel_cases": cases, "max_abs_err_f32": max_err,
           "timings": timings,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    checks = {"finite": bool(torch.isfinite(u).all()
                             and torch.isfinite(nut).all()),
              "nut >= 0": bool(nut.min() >= 0),
              "continuity < 1e-3": out["continuity"] < 1e-3,
              "the remainder carries the wrap faces": n_fb > 0
              and fb_launches > 0,
              "spmv launched": launches > 0}
    out["checks"] = checks
    emit(out)
    for name, ok in checks.items():
        check(ok, f"les_headline check {name}: {out}")
    return out, max_err, timings


# ---------------------------------------------------------------------------
# heat transfer, moving meshes, sampledSurfaces and coded
# ---------------------------------------------------------------------------

HOTROOM_CASES = {
    app: os.path.join("tutorials", "heatTransfer", app, "hotRoom")
    for app in ("buoyantBoussinesqSimpleFoam", "buoyantBoussinesqPimpleFoam")}
HOTROOM_APPS = {"simple": "buoyantBoussinesqSimpleFoam",
                "pimple": "buoyantBoussinesqPimpleFoam"}
HOTROOM_SEED = 9
HOTROOM_SEED_U = 0.01         # m/s, the seeded start's velocity scale
HOTROOM_SEED_T = 1.0          # K, its temperature scale
BOX_CASE = os.path.join("tutorials", "incompressible", "pimpleDyMFoam",
                        "oscillatingBox")


def set_internal(case_dir, name, values):
    """Replace the internalField of 0/<name> by per-cell `values` ([n] or
    [n,3], written exactly with repr); the boundaryField stays."""
    a = np.asarray(values, dtype=np.float64)
    path = os.path.join(case_dir, "0", name)
    with open(path) as f:
        text = f.read()
    if a.ndim == 2:
        rows = ("(" + " ".join(repr(float(x)) for x in r) + ")" for r in a)
        kind = "vector"
    else:
        rows = (repr(float(x)) for x in a)
        kind = "scalar"
    body = (f"internalField nonuniform List<{kind}> {a.shape[0]}\n(\n"
            + "\n".join(rows) + "\n);")
    new = re.sub(r"internalField\s+[^;]*;", lambda _: body, text, count=1)
    check(new != text, f"{path}: no internalField")
    with open(path, "w") as f:
        f.write(new)


def hotroom_case(here, dst, app, cli, seed=None, euler=False, blocks=None,
                 write_precision=None):
    """The hotRoom tutorial of `app` copied to dst and meshed with `cli`'s
    blockMesh (cli None: not meshed, see `memory_mesh`). `blocks` (nx, ny)
    refines its block; `euler` gives it
    `ddtSchemes default Euler` (the PIMPLE tutorial ships steadyState);
    `seed` starts it from U = HOTROOM_SEED_U n (x and y) and T = 300 +
    HOTROOM_SEED_T u K, n and u drawn cell by cell from numpy's generator
    (from the shipped U = 0 the sign of every face flux is round-off, and
    the upwind weights with it); `write_precision` replaces the shipped
    writePrecision 7. Returns
    dst."""
    shutil.copytree(os.path.join(here, HOTROOM_CASES[app]), dst)

    def edit(rel, old, new):
        path = os.path.join(dst, rel)
        with open(path) as f:
            text = f.read()
        check(old in text, f"{path} holds no {old!r}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))

    if blocks is not None:
        edit("constant/polyMesh/blockMeshDict", "(40 30 1)",
             "({} {} 1)".format(*blocks))
    if euler:
        edit("system/fvSchemes", "default steadyState", "default Euler")
    if write_precision is not None:
        edit("system/controlDict", "writePrecision  7;",
             f"writePrecision  {write_precision};")
    if cli is not None:
        with quiet():
            check(cli(["blockMesh", "-case", dst]) == 0, "blockMesh failed")
    if seed is not None:
        nx, ny = blocks or (40, 30)
        rng = np.random.default_rng(seed)
        u = np.zeros((nx * ny, 3))
        u[:, :2] = HOTROOM_SEED_U * rng.standard_normal((nx * ny, 2))
        set_internal(dst, "U", u)
        set_internal(dst, "T", 300.0 + HOTROOM_SEED_T * rng.random(nx * ny))
    return dst


DAM_MOTION = """FoamFile { version 2.0; format ascii; class dictionary;
           object dynamicMeshDict; }
dynamicFvMesh solidBodyMotionFvMesh;
solidBodyMotionFvMeshCoeffs
{
    solidBodyMotionFunction oscillatingLinearMotion;
    oscillatingLinearMotionCoeffs { amplitude (0.01 0 0); omega 10; }
}
"""
SURFACES_FUNCS = """
functions
{
    sampled
    {
        type surfaces;
        surfaceFormat vtk;
        fields (p U);
        surfaces
        (
            midPlane
            {
                type cuttingPlane;
                pointAndNormalDict
                { basePoint (0.05 0.05 0.005); normalVector (1 0 0); }
            }
            uIso { type isoSurface; isoField U; isoValue 0.1; }
            lid { type patch; patches (movingWall); }
        );
    }
    maxU
    {
        type coded;
        codeExecute #{
umax = float(jnp.max(jnp.linalg.norm(state["U"].data, axis=1)))
pmean = float(jnp.mean(jnp.abs(state["p"].data)))
store["n"] = store.get("n", 0) + 1
output(f"{time_name}\\t{umax:.6g}\\t{pmean:.6g}\\t{store['n']}")
        #};
    }
}
"""


def thermal_scalars(a, v):
    """Volume averages of a hotRoom state (a: host U, p_rgh, T): the mean
    and extremes of T, the kinetic energy, and the largest upward and
    downward velocity."""
    u, T = a["U"], a["T"]
    vol = v.sum()
    return {"T_mean": float((T * v).sum() / vol),
            "T_min": float(T.min()), "T_max": float(T.max()),
            "ke": float((0.5 * (u * u).sum(axis=1) * v).sum() / vol),
            "uy_max": float(u[:, 1].max()), "uy_min": float(u[:, 1].min())}


SURFACES_STEPS = 10


def parse_vtk_surface(text):
    """(points [n,3], triangles [m,3], {field: values}) of a legacy-VTK
    surface file written by sampledSurfaces."""
    lines = text.split("\n")
    npts = int(lines[4].split()[1])
    pts = np.array([[float(x) for x in lines[5 + i].split()]
                    for i in range(npts)]).reshape(-1, 3)
    ntri = int(lines[5 + npts].split()[1])
    tris = np.array([[int(x) for x in lines[6 + npts + i].split()[1:]]
                     for i in range(ntri)]).reshape(-1, 3)
    fields, i = {}, 6 + npts + ntri + 1
    while i < len(lines) and lines[i]:
        head = lines[i].split()
        if head[0] == "SCALARS":
            fields[head[1]] = np.array([float(x) for x in
                                        lines[i + 2:i + 2 + npts]])
            i += 2 + npts
        else:
            fields[head[1]] = np.array([[float(x) for x in ln.split()]
                                        for ln in lines[i + 1:i + 1 + npts]])
            i += 1 + npts
    return pts, tris, fields


def surface_summary(text):
    """A surface file's counts, the mean and spread of its vertices, and
    the mean and largest magnitude of each sampled field."""
    pts, tris, fields = parse_vtk_surface(text)
    out = {"points": pts.shape[0], "triangles": tris.shape[0],
           "centroid": pts.mean(axis=0).tolist(),
           "spread": pts.std(axis=0).tolist()}
    for name, v in fields.items():
        out[f"{name}_mean"] = np.atleast_1d(v.mean(axis=0)).tolist()
        out[f"{name}_absmax"] = float(np.abs(v).max())
    return out


def surfaces_run_summary(case_dir, time_name):
    """The summaries of the SURFACES_FUNCS files at `time_name`, and the
    coded object's last row (time, max |U|, mean |p|, executes)."""
    post = os.path.join(case_dir, "postProcessing")
    out = {}
    for f in ("midPlane", "uIso", "lid"):
        with open(os.path.join(post, "sampled", time_name, f + ".vtk")) as fh:
            out[f] = surface_summary(fh.read())
    with open(os.path.join(post, "maxU", "0", "maxU.dat")) as fh:
        out["coded"] = [float(x) for x in fh.read().split("\n")[-2].split()]
    return out


def box_case(here, dst, cli, device=()):
    """pimpleDyMFoam's oscillatingBox tutorial, copied and meshed."""
    shutil.copytree(os.path.join(here, BOX_CASE), dst)
    with quiet():
        check(cli(["blockMesh", "-case", dst]) == 0, "blockMesh failed")
    return dst


def interdym_case(here, dst, cli, device=()):
    """interFoam's damBreak tutorial as an interDyMFoam case: meshed,
    setFields, and a constant/dynamicMeshDict of oscillatingLinearMotion
    (DAM_MOTION: 1 cm at 10 rad/s along x)."""
    shutil.copytree(os.path.join(here, DAMBREAK_CASE), dst)
    _write_text(dst, "constant/dynamicMeshDict", DAM_MOTION)
    path = os.path.join(dst, "system", "controlDict")
    with open(path) as f:
        text = f.read()
    check("interFoam" in text, path)
    with open(path, "w") as f:
        f.write(text.replace("interFoam", "interDyMFoam"))
    with quiet():
        check(cli(["blockMesh", "-case", dst]) == 0, "blockMesh failed")
        check(cli(["setFields", "-case", dst, *device]) == 0,
              "setFields failed")
    return dst


def surfaces_case(here, dst, cli, device=(), rel=None, funcs=SURFACES_FUNCS):
    """icoFoam's cavity (or the tutorial `rel`) with a sampledSurfaces
    object (a cutting plane, an iso-surface of |U|, the lid's patch) and
    a coded object in its controlDict (SURFACES_FUNCS), meshed."""
    src = rel or os.path.join("tutorials", "incompressible", "icoFoam",
                              "cavity")
    shutil.copytree(os.path.join(here, src), dst)
    with open(os.path.join(dst, "system", "controlDict"), "a") as f:
        f.write(funcs)
    with quiet():
        check(cli(["blockMesh", "-case", dst]) == 0, "blockMesh failed")
    return dst


SLICE9_CASES = {"box": box_case, "interdym": interdym_case,
                "surfaces": surfaces_case}


# ---------------------------------------------------------------------------
# the phases of heat transfer, moving meshes, sampledSurfaces and coded
# ---------------------------------------------------------------------------

# tests/test_buoyant.py::test_hotroom_tutorial_runs
THERMAL_SIMPLE_ITERS = 200
THERMAL_PIMPLE_STEPS = 10     # the PIMPLE tutorial's endTime 1 / deltaT 0.1
# the PIMPLE tutorial as shipped diverges in the JAX package (float32, CPU,
# |U| max after 3, 5, 7 steps: 7.63, 1.19e4, 9.8e8; NaN at 10, where a
# coarsest GAMG inverse on the card raises): run it 3 steps
THERMAL_PIMPLE_SHIPPED_STEPS = 3
# the runs held to goldens: (application, steps, seed, Euler ddt)
THERMAL_RUNS = {"pimple_euler": ("buoyantBoussinesqPimpleFoam",
                                 THERMAL_PIMPLE_STEPS, HOTROOM_SEED, True)}
# tests/test_torch_buoyant.py::reference_thermal (JAX package, CPU, float32)
THERMAL_GOLDEN = {'pimple_euler': {'T_mean': 300.5133972167969,
                  'T_min': 300.03564453125,
                  'T_max': 301.15264892578125,
                  'ke': 4.880757114733569e-05,
                  'uy_max': 0.021725164726376534,
                  'uy_min': -0.019019195809960365}}

THERMAL_FLOOR = {"uy_max": 1e-3, "uy_min": 1e-3, "ke": 1e-6}
BOUSS_HEAD = (1024, 768)      # 786,432 cells, 25.6x the tutorial per side
BOUSS_HEAD_CHUNK = 5
BOUSS_HEAD_PROFILE = 1
BOX_STEPS = 50                # the tutorial's endTime 0.1 / deltaT 0.002
BOX_UCL = (2 * 20 + 10, 6 * 20 + 10, 10 * 20 + 10, 14 * 20 + 10,
           18 * 20 + 10)      # the 20x20 grid's centre column
# tests/test_torch_movingmesh.py::reference_dym (JAX package, CPU, float32)
BOX_GOLDEN = {'ke': 0.031383807218024806,
 'u_max': 0.8518719991331828,
 'ux_cl': [-0.045219071209430695,
           -0.15837138891220093,
           -0.20300191640853882,
           -0.1607574224472046,
           -0.025696007534861565],
 'p_mean': 0.039208443097833195,
 'p_std': 0.5320998369390879}
DAM_DYM_STEPS = 20
# tests/test_torch_movingmesh.py::reference_dym
DAM_DYM_GOLDEN = {'water_volume': 0.001282061861678456,
 'u_max': 0.787596583366394,
 'alpha_min': -2.7321911687293657e-15,
 'alpha_max': 1.000002145767212,
 'p_rgh': [1138.974853515625, 1515.370849609375, 2088.40185546875]}
BOX_HEAD_N = 1024             # 1,048,576 cells, 51.2x the tutorial per side
BOX_HEAD_DT = 0.002 * 20 / BOX_HEAD_N   # the shipped Courant number
BOX_HEAD_WARMUP = 2
BOX_HEAD_CHUNK = 5
BOX_HEAD_TRIALS = 2
# tests/test_torch_surfaces.py::reference_surfaces_coded (JAX package, CPU,
# float32)
SURFACES_GOLDEN = {'run': {'midPlane': {'points': 1644,
                      'triangles': 548,
                      'centroid': [0.04999999999999846,
                                   0.050396390916464036,
                                   0.004999999999999921],
                      'spread': [1.5404344466674047e-15,
                                 0.029099665445033993,
                                 0.004861907593189645],
                      'p_mean': [-7.326345016843437e-05],
                      'p_absmax': 0.0536358831450344,
                      'U_mean': [0.002920857919584008,
                                 0.005493160791765271,
                                 0.0],
                      'U_absmax': 0.8475725650787355},
         'uIso': {'points': 2598,
                  'triangles': 866,
                  'centroid': [0.05036716210626179,
                               0.05016753746106395,
                               0.00500307835262928],
                  'spread': [0.029620306548385485,
                             0.020302285793282273,
                             0.003527993915987201],
                  'p_mean': [0.016991720184902342],
                  'p_absmax': 0.34882535632427814,
                  'U_mean': [-0.039510678251649854,
                             -0.0012288850548255832,
                             0.0],
                  'U_absmax': 0.09987795313594482},
         'lid': {'points': 80,
                 'triangles': 40,
                 'centroid': [0.050000000000000024,
                              0.09999999999999984,
                              0.005000000000000004],
                 'spread': [0.02893959225697556,
                            1.665912677742146e-16,
                            0.005000000000000004],
                 'p_mean': [0.06082277740351856],
                 'p_absmax': 4.885335922241211,
                 'U_mean': [0.6849097400903702,
                            0.0007387402976746671,
                            0.0],
                 'U_absmax': 0.8481901288032532},
         'coded': [0.05, 0.84819, 0.231064, 10.0]},
 'analytic': {'midPlane': {'points': 1644,
                           'triangles': 548,
                           'centroid': [0.04999999999999846,
                                        0.050396390916464036,
                                        0.004999999999999921],
                           'spread': [1.5404344466674047e-15,
                                      0.029099665445033993,
                                      0.004861907593189645],
                           'T_mean': [0.025395318889946637],
                           'T_absmax': 0.04756574332714081,
                           'U_mean': [0.04999999888241291,
                                      0.050396390947938526,
                                      0.004999999888241291],
                           'U_absmax': 0.09749999642372131},
              'ring': {'points': 2304,
                       'triangles': 768,
                       'centroid': [0.050000000000000315,
                                    0.05000000000000033,
                                    0.004999999999999997],
                       'spread': [0.02115681873650611,
                                  0.02115681873650613,
                                  0.0036540513194908164],
                       'T_mean': [0.030000000000000002],
                       'T_absmax': 0.03,
                       'U_mean': [0.050000000326608125,
                                  0.050000000326608146,
                                  0.004999999888241291],
                       'U_absmax': 0.07989492938965759},
              'lid': {'points': 80,
                      'triangles': 40,
                      'centroid': [0.050000000000000024,
                                   0.09999999999999984,
                                   0.005000000000000004],
                      'spread': [0.02893959225697556,
                                 1.665912677742146e-16,
                                 0.005000000000000004],
                      'T_mean': [0.05518240891396999],
                      'T_absmax': 0.06717514246702194,
                      'U_mean': [0.05000000004656613,
                                 0.09749999642372131,
                                 0.004999999888241291],
                      'U_absmax': 0.09749999642372131}}}

SURFACES_TOL = 1e-4
SURF_HEAD_N = 400
SURF_HEAD_STEPS = 3
SURFACES_SPEC = """
type surfaces;
fields (T U);
surfaces
(
    midPlane
    {
        type cuttingPlane;
        pointAndNormalDict
        { basePoint (0.05 0.05 0.005); normalVector (1 0 0); }
    }
    ring { type isoSurface; isoField T; isoValue 0.03; }
    lid { type patch; patches (movingWall); }
);
"""


def memory_mesh(case):
    """Give `case` its polyMesh straight from blockMesh in memory (the
    case's blockMeshDict), without the ascii polyMesh files."""
    from foamtpu_torch.core.dictionary import parse_file
    from foamtpu_torch.mesh import blockmesh

    for rel in ("constant/polyMesh/blockMeshDict", "system/blockMeshDict"):
        path = os.path.join(case.dir, rel)
        if os.path.exists(path):
            case._poly = blockmesh.generate(parse_file(path))
            return case
    check(False, f"{case.dir}: no blockMeshDict")


RB_BLOCKMESH = """
convertToMeters 1;
vertices
(
    (0 0 0) (4 0 0) (4 1 0) (0 1 0)
    (0 0 0.1) (4 0 0.1) (4 1 0.1) (0 1 0.1)
);
blocks ( hex (0 1 2 3 4 5 6 7) (32 8 1) simpleGrading (1 1 1) );
boundary
(
    floor   { type wall; faces ((1 5 4 0)); }
    ceiling { type wall; faces ((3 7 6 2)); }
    sides   { type cyclic; neighbourPatch sides2; faces ((0 4 7 3)); }
    sides2  { type cyclic; neighbourPatch sides;  faces ((2 6 5 1)); }
    frontAndBack { type empty; faces ((0 3 2 1) (4 5 6 7)); }
);
"""
RB_CFG = dict(beta=3.3e-3, t_ref=300.0, pr=1.0, g=(0.0, -9.81, 0.0),
              steady=False, n_outer=1, n_correctors=2, div_scheme="linear",
              div_scheme_t="upwind", alpha_u=1.0, alpha_p=1.0, alpha_t=1.0)


def rb_setup(dT, device="cuda"):
    """The periodic slab of tests/test_buoyant.py::_rb_setup heated from
    below by dT (T perturbed from numpy's generator at 0)."""
    from foamtpu_torch.bc import patchfields as pf
    from foamtpu_torch.core.dictionary import parse_string
    from foamtpu_torch.core.dimensions import DimensionSet, dimVelocity
    from foamtpu_torch.core.fields import vol_scalar, vol_vector
    from foamtpu_torch.mesh import blockmesh, to_device

    mesh = to_device(blockmesh.generate(parse_string(RB_BLOCKMESH)), device)
    zero3 = torch.zeros(3, dtype=mesh.v.dtype, device=device)
    ubcs, pbcs, tbcs = [], [], []
    for p in mesh.patches:
        if p.type == "empty":
            for lst in (ubcs, pbcs, tbcs):
                lst.append(pf.PatchField(kind="empty", vfrac=0.0))
        elif p.name in ("floor", "ceiling"):
            ubcs.append(pf.fixed_value(zero3))
            pbcs.append(pf.zero_gradient())
            tbcs.append(pf.fixed_value(300.0 + (dT if p.name == "floor"
                                                else 0.0)))
        else:
            for lst in (ubcs, pbcs, tbcs):
                lst.append(pf.zero_gradient())
    U = vol_vector(mesh, zero3, name="U", dims=dimVelocity, bcs=tuple(ubcs))
    p_rgh = vol_scalar(mesh, 0.0, name="p_rgh",
                       dims=DimensionSet.of(0, 2, -2), bcs=tuple(pbcs))
    rng = np.random.default_rng(0)
    c = mesh.c.cpu().numpy()
    T0 = 300.0 + dT * (1.0 - c[:, 1])
    T0 = T0 + 1e-3 * dT * rng.standard_normal(mesh.n_cells)
    T = vol_scalar(mesh, 0.0, name="T", dims=DimensionSet.of(0, 0, 0, 1),
                   bcs=tuple(tbcs)).with_data(
        torch.tensor(T0, dtype=mesh.v.dtype, device=device))
    return mesh, U, p_rgh, T


def run_rb(dT, nu=1e-3, n=60, device="cuda"):
    """n steps of 0.25 s of the slab; (max |Uy|, continuity of the last
    step, finite)."""
    from foamtpu_torch.solvers import buoyant

    mesh, U, p_rgh, T = rb_setup(dT, device)
    cfg = buoyant.BoussinesqConfig(nu=nu, **RB_CFG)
    state = buoyant.initial_state(mesh, U, p_rgh, T, steady=False)
    state, diag = buoyant.make_chunk(mesh, cfg, n)(state, 0.25)
    u = state["U"].data
    return (float(torch.abs(u[:, 1]).max()), float(diag["continuity"]),
            bool(torch.isfinite(u).all()))


def app_run(spmv, case, steps, chunk=None):
    """run(case) for `steps` (with FOAMTPU_CHUNK `chunk` where given) with
    the SpMV counts set to 0 just before; (seconds, log text, launches,
    remainder launches)."""
    from foamtpu_torch.solvers.apps import run

    log = io.StringIO()
    saved = os.environ.get("FOAMTPU_CHUNK")
    if chunk is not None:
        os.environ["FOAMTPU_CHUNK"] = str(chunk)
    spmv.LAUNCHES = spmv.FB_LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(log):
            run(case, max_steps=steps)
    finally:
        if chunk is not None:
            if saved is None:
                del os.environ["FOAMTPU_CHUNK"]
            else:
                os.environ["FOAMTPU_CHUNK"] = saved
    torch.cuda.synchronize()
    sys.stderr.write(log.getvalue()[-1500:])
    return (time.perf_counter() - t0, log.getvalue(), spmv.LAUNCHES,
            spmv.FB_LAUNCHES)


def hotroom_arrays(state):
    return {k: state[k].data.float().cpu().numpy()
            for k in ("U", "p_rgh", "T")}


def phase_thermal(spmv, here, root):
    """Both hotRoom tutorials through run(case) on the card: SIMPLE for
    THERMAL_SIMPLE_ITERS iterations as shipped, held to the plume oracle
    of tests/test_buoyant.py (finite, max Uy > 0.1; its T bounds are
    recorded);
    PIMPLE for THERMAL_PIMPLE_SHIPPED_STEPS steps as shipped, held to the
    divergence the JAX package shows (steadyState ddt, unrelaxed); and
    THERMAL_RUNS (PIMPLE with the Euler ddt from a seeded start) held to
    goldens from the JAX package and to the T bounds. Then the
    Rayleigh-Benard onset of tests/test_buoyant.py (32x8, cyclic in x)."""
    from foamtpu_torch.apps.cli import main as cli
    from foamtpu_torch.core.case import Case

    simple_app, pimple_app = HOTROOM_CASES
    runs = {"simple": (simple_app, THERMAL_SIMPLE_ITERS, None, False),
            "pimple": (pimple_app, THERMAL_PIMPLE_SHIPPED_STEPS, None, False),
            **THERMAL_RUNS}
    results, checks = {}, {}
    launches_total = fb_total = 0
    for tag, (app, steps, seed, euler) in runs.items():
        dst = hotroom_case(here, os.path.join(root, "thermal", tag), app,
                           cli, seed=seed, euler=euler)
        case = Case(dst, device="cuda")
        # PIMPLE a step per chunk (the application's loop runs whole
        # chunks of FOAMTPU_CHUNK)
        run_s, text, launches, fb = app_run(
            spmv, case, steps, chunk=None if tag == "simple" else 1)
        launches_total += launches
        fb_total += fb
        a = hotroom_arrays(case.final_state)
        v = case.mesh.v.cpu().numpy()
        finite = all(bool(np.isfinite(x).all()) for x in a.values())
        got = thermal_scalars(a, v) if finite else {}
        its = solve_iterations(text)
        rec = {"app": app, "n_cells": case.mesh.n_cells,
               "steps": case.time.index, "run_s": run_s,
               "sec_per_step": run_s / max(case.time.index, 1),
               "scalars": got, "finite": finite,
               "u_abs_max": float(np.abs(a["U"]).max()),
               "continuity_sum_local": log_continuity(text)[-3:],
               "iterations_max": {k: max(x) for k, x in its.items()},
               "p_rgh_gamg_cycles": its.get("p"),
               "spmv_launches": launches, "spmv_fb_launches": fb}
        ck = {"steps": case.time.index == steps,
              "spmv launched": launches > 0}
        if tag == "simple":
            # tests/test_buoyant.py's plume; its T bounds (295-312 K) are
            # recorded, not held: from the shipped U = 0 round-off decides
            # the plume; on the CPU in float32 the port ends at T_min
            # 281.4 K and the JAX package at 299.1 K (tests/
            # test_torch_buoyant.py's `sensitivity`; ROADMAP Queue 3)
            ck.update({"finite": finite,
                       "max Uy > 0.1": finite and got["uy_max"] > 0.1})
            rec["T_within_295_312"] = finite and bool(
                295.0 <= got["T_min"] and got["T_max"] <= 312.0)
            rec["checks"] = "tests/test_buoyant.py's plume oracle"
        elif tag == "pimple":
            # diverging as in the JAX package (|U| 7.63 after 3 steps,
            # where the Euler ddt's run stays under 0.03)
            ck["finite"] = finite
            ck["diverging, as in the JAX package (|U| > 1)"] = (
                rec["u_abs_max"] > 1.0)
            rec["checks"] = "the reference's divergence"
        else:
            rel = golden_rel_err(got, THERMAL_GOLDEN[tag], THERMAL_FLOOR)
            rec["golden_rel_err"] = rel
            ck.update({f"golden {k}": r <= 1e-3 for k, r in rel.items()})
            ck.update({"finite": finite,
                       "295 <= T <= 312": 295.0 <= got["T_min"]
                       and got["T_max"] <= 312.0})
            rec["checks"] = "goldens and the T bounds"
        results[tag] = rec
        checks.update({f"{tag} {k}": x for k, x in ck.items()})

    spmv.LAUNCHES = spmv.FB_LAUNCHES = 0
    t0 = time.perf_counter()
    v_unstable, cont, fin_u = run_rb(10.0)
    v_stable, _, fin_s = run_rb(-10.0)
    torch.cuda.synchronize()
    launches_total += spmv.LAUNCHES
    fb_total += spmv.FB_LAUNCHES
    results["rayleigh_benard"] = {
        "run_s": time.perf_counter() - t0, "v_unstable": v_unstable,
        "v_stable": v_stable, "continuity": cont,
        "spmv_launches": spmv.LAUNCHES, "spmv_fb_launches": spmv.FB_LAUNCHES}
    checks.update({
        "rayleigh_benard finite": fin_u and fin_s,
        "rayleigh_benard unstable > 50 x stable":
            v_unstable > 50.0 * max(v_stable, 1e-12),
        "rayleigh_benard convective velocity > 1e-3": v_unstable > 1e-3,
        "rayleigh_benard continuity < 1e-4": cont < 1e-4})
    out = {"phase": "thermal", "dtype": "torch.float32", "runs": results,
           "spmv_launches_total": launches_total,
           "spmv_fb_launches_total": fb_total, "checks": checks}
    emit(out)
    for name, ok in checks.items():
        check(ok, f"thermal check {name}: {out}")
    return out


def phase_boussinesq_headline(spmv, here, root, flush, trials=3):
    """hotRoom's SIMPLE case refined to BOUSS_HEAD (786,432 cells;
    geometry, BCs, schemes, relaxation, kEpsilon and the GAMG p_rgh
    controls as shipped), meshed in memory: buoyantBoussinesqSimpleFoam's
    chunk (the application's config, state and step) for one warm-up
    chunk and `trials` timed chunks of BOUSS_HEAD_CHUNK iterations with
    the GAMG cycles of every p_rgh solve, the SpMV kernel held to its
    plain version at the p_rgh and U operands (f32, f64) and timed at
    p_rgh, and last one profiled iteration."""
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.core.dictionary import dimensioned_scalar
    from foamtpu_torch.solvers import apps, buoyant

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dst = hotroom_case(here, os.path.join(root, "hotroom_big"),
                       "buoyantBoussinesqSimpleFoam", None,
                       blocks=BOUSS_HEAD)
    case = memory_mesh(Case(dst, device="cuda"))
    blockmesh_s = time.perf_counter() - t0
    mesh = case.mesh
    n = BOUSS_HEAD[0] * BOUSS_HEAD[1]
    check(mesh.n_cells == n, mesh.n_cells)
    _, nu = dimensioned_scalar(case.transport_properties()["nu"])
    model, tstate = apps._load_turbulence(case, nu)
    cfg = apps._boussinesq_config(case, True, nu, model)
    levels = len(cfg.p_controls["_gamg"].levels)
    state = buoyant.initial_state(mesh, case.read_field("U"),
                                  case.read_field("p_rgh"),
                                  case.read_field("T"), turb_state=tstate)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    progress("boussinesq_headline", f"set-up {setup_s:.1f} s, {n} cells")
    spmv.LAUNCHES = spmv.FB_LAUNCHES = 0
    step_chunk = buoyant.make_chunk(mesh, cfg, BOUSS_HEAD_CHUNK)

    def chunk_of(k):
        c = buoyant.make_chunk(mesh, cfg, k)
        return lambda st: c(st, 1.0)

    t0 = time.perf_counter()
    state, diag = step_chunk(state, 1.0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    secs = []
    l0 = spmv.LAUNCHES
    with SolveLog(state) as tlog:
        for _ in range(trials):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, diag = step_chunk(state, 1.0)
            torch.cuda.synchronize()
            secs.append((time.perf_counter() - t0) / BOUSS_HEAD_CHUNK)
    sec = statistics.median(secs)
    cycles = [int(i) for i in tlog.iterations["p"]]
    launches_per_iter = (spmv.LAUNCHES - l0) / (trials * BOUSS_HEAD_CHUNK)
    progress("boussinesq_headline", f"timed chunks {secs}, p_rgh GAMG "
             f"cycles {cycles}")
    launches, fb_launches = spmv.LAUNCHES, spmv.FB_LAUNCHES
    ops = solve_operands(tlog, mesh, "hotroom")
    deltas = tuple(mesh.st_deltas)
    cases, max_err = [], 0.0
    for dtype in (torch.float32, torch.float64):
        err = check_operands(spmv, ops, mesh, deltas, dtype,
                             np.random.default_rng(91), cases)
        if dtype == torch.float32:
            max_err = err
    _, soff, diag_p, sfb = ops[0]
    timings = time_shape(spmv, "hotroom_p_rgh", diag_p.contiguous(),
                         operand_x(diag_p, 92), soff.contiguous(), deltas,
                         flush, fb=mesh_remainder(spmv, mesh, sfb,
                                                  diag_p.dtype))
    l1, f1 = spmv.LAUNCHES, spmv.FB_LAUNCHES
    state, prof = profile_chunk(spmv, "boussinesq_headline_profile", mesh,
                                chunk_of(BOUSS_HEAD_PROFILE), state,
                                BOUSS_HEAD_PROFILE, sec)
    launches += spmv.LAUNCHES - l1
    fb_launches += spmv.FB_LAUNCHES - f1
    a = hotroom_arrays(state)
    finite = all(bool(np.isfinite(x).all()) for x in a.values())
    out = {"phase": "boussinesq_headline",
           "case": "buoyantBoussinesqSimpleFoam hotRoom, block "
                   f"({BOUSS_HEAD[0]} {BOUSS_HEAD[1]} 1): the tutorial's "
                   "geometry, BCs, schemes, relaxation, kEpsilon and GAMG "
                   "p_rgh controls (GaussSeidel -> damped Jacobi)",
           "n_cells": n, "dtype": str(mesh.v.dtype), "gamg_levels": levels,
           "blockmesh_s": blockmesh_s, "setup_s": setup_s,
           "warmup_s": warm_s, "sec_per_iter": sec,
           "sec_per_iter_trials": secs, "m_cells_per_sec": n / sec / 1e6,
           "p_rgh_gamg_cycles": cycles,
           "p_rgh_gamg_cycles_mean": statistics.mean(cycles),
           "iterations_per_solve": {k: statistics.mean(v) for k, v in
                                    tlog.iterations.items() if v},
           "spmv_launches_per_iter": launches_per_iter,
           "cuda_launch_kernel_per_iter": prof["cuda_launch_kernel_per_iter"],
           "device_ms_per_iter": prof["device_ms_per_iter"],
           "device_busy_share": prof["device_busy_share_unprofiled"],
           "spmv_device_ms_per_iter": prof["spmv_device_ms_per_iter"],
           "top_kernels_ms_per_iter": prof["top_kernels_ms_per_iter"][:8],
           "continuity": float(diag["continuity"]),
           "scalars": thermal_scalars(a, mesh.v.cpu().numpy())
           if finite else {},
           "spmv_launches_total": launches,
           "spmv_fb_launches_total": fb_launches,
           "kernel_cases": cases, "max_abs_err_f32": max_err,
           "timings": timings,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    checks = {"finite": finite,
              "GAMG p_rgh": str(cfg.p_controls["solver"]) == "GAMG"
              and levels >= 2,
              "GAMG cycles under the cap": max(cycles) < int(
                  cfg.p_controls.get("maxIter", 1000)),
              "spmv launched": launches > 0}
    out["checks"] = checks
    emit(out)
    for name, ok in checks.items():
        check(ok, f"boussinesq_headline check {name}: {out}")
    return out, max_err, timings


def box_scalars(v, U, p):
    """The golden scalars of an oscillatingBox state: the kinetic energy,
    max |U|, Ux down the centre column (BOX_UCL) and p's mean and spread."""
    U, p, v = (np.asarray(x, np.float64) for x in (U, p, v))
    return {"ke": float((0.5 * (U * U).sum(axis=1) * v).sum() / v.sum()),
            "u_max": float(np.sqrt((U * U).sum(axis=1)).max()),
            "ux_cl": [float(U[i, 0]) for i in BOX_UCL],
            "p_mean": float((p * v).sum() / v.sum()),
            "p_std": float(p.std())}


class GeometryLog:
    """Wraps mesh/moving.py::update_geometry for a run: the sum of the
    cell volumes and the points' displacement from points0 at each call
    (one host fetch each)."""

    def __init__(self, points0):
        self.points0 = points0
        self.volumes, self.shift = [], []

    def __enter__(self):
        from foamtpu_torch.mesh import moving

        self._moving, self._orig = moving, moving.update_geometry

        def update(mesh, points, topo):
            out = self._orig(mesh, points, topo)
            self.volumes.append(float(out.v.double().sum()))
            self.shift.append((points - self.points0)[0].tolist())
            return out

        moving.update_geometry = update
        return self

    def __exit__(self, *exc):
        self._moving.update_geometry = self._orig


def phase_dym(spmv, here, root):
    """pimpleDyMFoam's oscillatingBox tutorial through run(case) for
    BOX_STEPS steps, held to goldens from the JAX package, the total
    volume constant, the box moved by amplitude sin(omega t) at every
    step and continuity; interDyMFoam on the damBreak tutorial with
    DAM_MOTION for DAM_DYM_STEPS steps, held to goldens and to the alpha
    bounds of the damBreak checks (dambreak_invariants)."""
    from foamtpu_torch.apps.cli import main as cli
    from foamtpu_torch.core.case import Case

    results, checks = {}, {}
    launches_total = fb_total = 0
    dst = box_case(here, os.path.join(root, "dym", "box"), cli)
    case = Case(dst, device="cuda")
    points0 = torch.tensor(case.poly_mesh.points, dtype=case.mesh.v.dtype,
                           device="cuda")
    v0 = float(case.mesh.v.double().sum())
    with GeometryLog(points0) as glog:
        run_s, text, launches, fb = app_run(spmv, case, BOX_STEPS)
    launches_total += launches
    fb_total += fb
    st = case.final_state
    got = box_scalars(case.mesh.v.cpu().numpy(), st["U"].data.cpu().numpy(),
                      st["p"].data.cpu().numpy())
    # p_mean relative to 1 (p spans ~1 m2/s2 here: p_std 0.53); the
    # tutorial's PCG stops at relTol 0.01, which leaves ~3e-5 between the
    # packages after 50 steps
    rel = golden_rel_err(got, BOX_GOLDEN, {"p_mean": 1.0})
    dmd = case.properties("dynamicMeshDict")
    c = dmd["solidBodyMotionFvMeshCoeffs"]["oscillatingLinearMotionCoeffs"]
    amp = float(np.asarray(c["amplitude"], float)[0])
    omega = float(c["omega"])
    dt = case.time.delta_t
    want = [amp * np.sin(omega * dt * (k + 1)) for k in range(BOX_STEPS)]
    shift_err = float(max(abs(s[0] - w) for s, w in zip(glog.shift, want))
                      / amp)
    vol_err = max(abs(x - v0) for x in glog.volumes) / v0
    cont = log_continuity(text)
    results["oscillatingBox"] = {
        "n_cells": case.mesh.n_cells, "steps": case.time.index,
        "run_s": run_s, "sec_per_step": run_s / BOX_STEPS,
        "scalars": got, "golden_rel_err": rel, "volume_rel_change": vol_err,
        "shift_err_over_amplitude": shift_err,
        "continuity_sum_local_max": max(cont),
        "spmv_launches": launches, "spmv_fb_launches": fb}
    checks.update({f"oscillatingBox golden {k}": r <= 1e-3
                   for k, r in rel.items()})
    checks.update({
        "oscillatingBox steps": case.time.index == BOX_STEPS,
        "oscillatingBox every step moved the mesh":
            len(glog.volumes) == BOX_STEPS,
        "oscillatingBox sum V constant (1e-6)": vol_err <= 1e-6,
        "oscillatingBox moved by A sin(wt) (1e-4 A)": shift_err <= 1e-4,
        "oscillatingBox continuity < 1e-5": max(cont) < 1e-5,
        "oscillatingBox spmv launched": launches > 0})

    dst = interdym_case(here, os.path.join(root, "dym", "dam"), cli)
    case = Case(dst, device="cuda")
    check(case.application == "interDyMFoam", case.application)
    alpha0 = case.read_field("alpha1").data.clone()
    run_s, text, launches, fb = app_run(spmv, case, DAM_DYM_STEPS)
    launches_total += launches
    fb_total += fb
    st = case.final_state
    got = dambreak_scalars(case.mesh.v.cpu().numpy(),
                           st["alpha"].data.cpu().numpy(),
                           st["U"].data.cpu().numpy(),
                           st["p_rgh"].data.cpu().numpy())
    rel = golden_rel_err(got, DAM_DYM_GOLDEN,
                         floor={"alpha_min": 1.0, "alpha_max": 1.0})
    inv, inv_checks = dambreak_invariants(case.mesh, alpha0, st)
    results["damBreak_interDyMFoam"] = {
        "n_cells": case.mesh.n_cells, "steps": case.time.index,
        "run_s": run_s, "sec_per_step": run_s / DAM_DYM_STEPS,
        "scalars": got, "golden_rel_err": rel, "invariants": inv,
        "mesh_time": float(st["t"]),
        "spmv_launches": launches, "spmv_fb_launches": fb}
    checks.update({f"interDyMFoam golden {k}": r <= 1e-3
                   for k, r in rel.items()})
    # the damBreak alpha bounds and finite fields; not its volume check: the
    # walls stay fixedValue (0 0 0) while the mesh moves, so the relative
    # flux -meshPhi crosses them and the water volume changes (1.3% in 20
    # steps in the JAX package too, which the golden holds)
    checks.update({f"interDyMFoam {k}": inv_checks[k]
                   for k in ("alpha bounded", "U finite")})
    checks["interDyMFoam steps"] = case.time.index == DAM_DYM_STEPS
    checks["interDyMFoam spmv launched"] = launches > 0
    out = {"phase": "dym", "dtype": "torch.float32", "runs": results,
           "spmv_launches_total": launches_total,
           "spmv_fb_launches_total": fb_total, "checks": checks}
    emit(out)
    for name, ok in checks.items():
        check(ok, f"dym check {name}: {out}")
    return out


def phase_dym_headline(spmv, here, root, flush):
    """oscillatingBox at BOX_HEAD_N^2 (1,048,576 cells) meshed in memory,
    deltaT BOX_HEAD_DT (the shipped Courant number), bench.py's GAMG p
    controls (the shipped PCG sits at its cap from 400^2 up): the
    application's config and step, BOX_HEAD_WARMUP warm-up steps (the
    Courant number held near the shipped 0.4 there; at this width the
    flow then overshoots the lid speed and continuity grows, in the JAX
    package too, tests/test_torch_movingmesh.py's `box_big_trajectory`),
    BOX_HEAD_TRIALS timed chunks of BOX_HEAD_CHUNK steps, the device ms
    of update_geometry + mesh_flux alone, the SpMV kernel held to its
    plain version at the moved mesh's p and U operands and timed at p,
    and last one profiled step."""
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.core.dictionary import dimensioned_scalar
    from foamtpu_torch.mesh import moving
    from foamtpu_torch.solvers import apps, pimpledym
    from foamtpu_torch.solvers.linear.gamg import GAMG

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dst = os.path.join(root, "box_big")
    shutil.copytree(os.path.join(here, BOX_CASE), dst)
    path = os.path.join(dst, "system", "blockMeshDict")
    with open(path) as f:
        text = f.read()
    check("(20 20 1)" in text, path)
    with open(path, "w") as f:
        f.write(text.replace("(20 20 1)", f"({BOX_HEAD_N} {BOX_HEAD_N} 1)"))
    case = memory_mesh(Case(dst, device="cuda"))
    mesh = case.mesh
    n = BOX_HEAD_N ** 2
    check(mesh.n_cells == n, mesh.n_cells)
    pts_fn, umesh_fn = apps._dym_motion(case)
    _, nu = dimensioned_scalar(case.transport_properties()["nu"])
    gamg = {"solver": "GAMG", "preconditioner": "polynomial",
            "tolerance": 1e-7, "relTol": 0.01, "maxIter": 1000,
            "_gamg": GAMG(mesh)}
    cfg = pimpledym.DyMConfig(
        nu=nu, pts_fn=pts_fn, umesh_fn=umesh_fn, n_correctors=2,
        div_scheme=case.div_scheme("div(phi,U)"), p_controls=gamg,
        u_controls=case.solver_controls("U"))
    state = pimpledym.initial_state(case.poly_mesh, mesh,
                                    case.read_field("U"),
                                    case.read_field("p"), umesh_fn)
    step = pimpledym.make_step(mesh, cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    progress("dym_headline", f"set-up {setup_s:.1f} s, {n} cells")

    def chunk_of(k):
        def chunk(st):
            diag = None
            for _ in range(k):
                st, diag = step(st, BOX_HEAD_DT)
            return st, diag
        return chunk

    spmv.LAUNCHES = spmv.FB_LAUNCHES = 0
    t0 = time.perf_counter()
    state, diag = chunk_of(BOX_HEAD_WARMUP)(state)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_co = float(diag["courant_max"])
    secs = []
    l0 = spmv.LAUNCHES
    with SolveLog(state) as tlog:
        for _ in range(BOX_HEAD_TRIALS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, diag = chunk_of(BOX_HEAD_CHUNK)(state)
            torch.cuda.synchronize()
            secs.append((time.perf_counter() - t0) / BOX_HEAD_CHUNK)
    sec = statistics.median(secs)
    p_its = [int(i) for i in tlog.iterations["p"]]
    launches_per_step = (spmv.LAUNCHES - l0) / (BOX_HEAD_TRIALS
                                                * BOX_HEAD_CHUNK)
    progress("dym_headline", f"timed chunks {secs}, p cycles {p_its}")
    launches, fb_launches = spmv.LAUNCHES, spmv.FB_LAUNCHES
    # the moving-mesh work alone: the geometry and the mesh flux of a step
    topo, p0, t_now = state["topo"], state["points0"], state["t"]

    def geometry():
        m = moving.update_geometry(mesh, pts_fn(p0, t_now), topo)
        return moving.mesh_flux(m, umesh_fn, t_now)

    geom_ms = device_ms(geometry)
    # the device geometry in float32 from the load-time points, against
    # the host's float64 geometry that to_device cast: the digits a
    # recompute from absolute coordinates keeps at this cell size
    still = moving.update_geometry(mesh, p0, topo)
    geom_err = {f: float((getattr(still, f).double() - getattr(mesh, f)
                          .double()).abs().max()
                         / getattr(mesh, f).double().abs().max())
                for f in ("v", "mag_sf", "weights", "delta_coeffs")}
    del still
    moved = moving.update_geometry(mesh, state["points"], topo)
    ops = solve_operands(tlog, moved, "box")
    deltas = tuple(mesh.st_deltas)
    cases, max_err = [], 0.0
    for dtype in (torch.float32, torch.float64):
        err = check_operands(spmv, ops, moved, deltas, dtype,
                             np.random.default_rng(93), cases)
        if dtype == torch.float32:
            max_err = err
    _, soff, diag_p, sfb = ops[0]
    timings = time_shape(spmv, "box_moved_p", diag_p.contiguous(),
                         operand_x(diag_p, 94), soff.contiguous(), deltas,
                         flush, fb=mesh_remainder(spmv, moved, sfb,
                                                  diag_p.dtype))
    l1, f1 = spmv.LAUNCHES, spmv.FB_LAUNCHES
    state, prof = profile_chunk(spmv, "dym_headline_profile", mesh,
                                chunk_of(1), state, 1, sec)
    launches += spmv.LAUNCHES - l1
    fb_launches += spmv.FB_LAUNCHES - f1
    u = state["U"].data
    out = {"phase": "dym_headline",
           "case": f"pimpleDyMFoam oscillatingBox, block ({BOX_HEAD_N} "
                   f"{BOX_HEAD_N} 1), deltaT {BOX_HEAD_DT!r}, "
                   "oscillatingLinearMotion as shipped, bench.py's GAMG p",
           "n_cells": n, "dtype": str(mesh.v.dtype), "setup_s": setup_s,
           "warmup_s": warm_s, "sec_per_step": sec,
           "sec_per_step_trials": secs, "m_cells_per_sec": n / sec / 1e6,
           "p_iterations": p_its,
           "geometry_device_ms_per_step": geom_ms,
           "geometry_f32_rel_err_unmoved": geom_err,
           "geometry_share_of_device": geom_ms / prof["device_ms_per_iter"],
           "spmv_launches_per_step": launches_per_step,
           "cuda_launch_kernel_per_step": prof["cuda_launch_kernel_per_iter"],
           "device_ms_per_step": prof["device_ms_per_iter"],
           "device_busy_share": prof["device_busy_share_unprofiled"],
           "spmv_device_ms_per_step": prof["spmv_device_ms_per_iter"],
           "top_kernels_ms_per_step": prof["top_kernels_ms_per_iter"][:8],
           "courant_max_after_warmup": warm_co,
           # these grow at this width in both packages (ROADMAP Queue 3)
           "continuity": float(diag["continuity"]),
           "courant_max": float(diag["courant_max"]),
           "u_max": float(torch.linalg.norm(u, dim=1).max()),
           "spmv_launches_total": launches,
           "spmv_fb_launches_total": fb_launches,
           "kernel_cases": cases, "max_abs_err_f32": max_err,
           "timings": timings,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    checks = {"finite": bool(torch.isfinite(u).all()),
              # 0.29 and 0.34 after steps 1 and 2 in both packages (CPU)
              "Courant number near the shipped 0.4 after the warm-up":
                  warm_co < 0.5,
              "p solves under the cap": max(p_its) < 1000,
              "the mesh moved": float(state["t"]) > 0.0,
              "spmv launched": launches > 0}
    out["checks"] = checks
    emit(out)
    for name, ok in checks.items():
        check(ok, f"dym_headline check {name}: {out}")
    return out, max_err, timings


def analytic_surface_state(c, device):
    """tests/test_sampling.py's fields on the card, float32: T the
    distance from the cavity's axis, U the cell centres."""
    T = np.linalg.norm(c[:, :2] - 0.05, axis=1)
    return {"T": torch.tensor(T, dtype=torch.float32, device=device),
            "U": type("F", (), {"data": torch.tensor(
                c, dtype=torch.float32, device=device)})()}


def phase_surfaces_coded(spmv, here, root):
    """The cavity tutorial with SURFACES_FUNCS (sampledSurfaces: a cutting
    plane, an iso-surface of |U| and the lid; a coded object) through
    run(case) for SURFACES_STEPS steps, its last surfaces and coded rows
    held to the JAX package's (SURFACES_GOLDEN, SURFACES_TOL); the
    analytic fields of tests/test_sampling.py through a sampledSurfaces
    object, held the same way; then crossCavity at SURF_HEAD_N^2 with
    SURFACES_FUNCS through the application's loop for SURF_HEAD_STEPS
    steps: the host ms of fol.execute per object and step."""
    from foamtpu_torch.apps.cli import main as cli
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.core.dictionary import (dimensioned_scalar,
                                               parse_string)
    from foamtpu_torch.functionobjects.surfaces import SampledSurfaces
    from foamtpu_torch.models import transport
    from foamtpu_torch.solvers import piso
    from foamtpu_torch.solvers.apps import _piso_config

    checks = {}
    dst = surfaces_case(here, os.path.join(root, "surf", "cavity"), cli)
    case = Case(dst, device="cuda")
    run_s, text, launches, fb = app_run(spmv, case, SURFACES_STEPS)
    fol = case.function_objects
    got = surfaces_run_summary(dst, case.time.name)
    t0 = time.perf_counter()
    fo = SampledSurfaces("analytic", parse_string(SURFACES_SPEC), case)
    fo.execute("0", analytic_surface_state(case.poly_mesh.c, "cuda"))
    analytic_s = time.perf_counter() - t0
    got_a = {}
    for f in ("midPlane", "ring", "lid"):
        with open(os.path.join(dst, "postProcessing", "analytic", "0",
                               f + ".vtk")) as fh:
            got_a[f] = surface_summary(fh.read())
    rel = {}
    for tag, g, gold in (("run", got, SURFACES_GOLDEN["run"]),
                         ("analytic", got_a, SURFACES_GOLDEN["analytic"])):
        for name, vals in gold.items():
            # the least magnitudes: a coordinate's spread across a plane
            # is round-off, and p is held relative to 1 (the lid's p is
            # ~5; float32 leaves ~1e-5 between the packages after 10
            # steps)
            floor = {"centroid": 1e-3, "spread": 1e-3, "p_mean": 1.0,
                     "p_absmax": 1.0, "U_mean": 1e-2, "U_absmax": 1e-2,
                     "T_mean": 1e-3, "T_absmax": 1e-3}
            if name == "coded":
                r = golden_rel_err({"coded": g[name][1:]},
                                   {"coded": vals[1:]}, {"coded": 1e-3})
                rel[f"{tag} coded"] = r["coded"]
                continue
            r = golden_rel_err(g[name], vals, floor)
            rel.update({f"{tag} {name} {k}": x for k, x in r.items()})
    checks.update({f"golden {k}": r <= SURFACES_TOL for k, r in rel.items()})
    checks["cavity run: no object failed"] = fol.failures == 0
    checks["cavity run: sampledSurfaces fetched p and U once per execute"] = (
        fol.fetches()["sampled"] == 2 * SURFACES_STEPS)
    checks["cavity run: spmv launched"] = launches > 0
    launches_total, fb_total = launches, fb

    # host time at 400^2
    t0 = time.perf_counter()
    big = copy_case(here, BASIC_CASES["nonNewtonianIcoFoam"][0], root,
                    f"surf{SURF_HEAD_N}", edits=[
                        ("system/blockMeshDict", "(20 20 1)",
                         f"({SURF_HEAD_N} {SURF_HEAD_N} 1)"),
                        ("system/controlDict", "deltaT 0.0005;",
                         f"deltaT {0.0005 * 20 / SURF_HEAD_N!r};"),
                        ("system/fvSolution", "p { solver PCG;",
                         "p { solver GAMG;")])
    with open(os.path.join(big, "system", "controlDict"), "a") as f:
        f.write(SURFACES_FUNCS)
    bcase = Case(big, device="cuda")
    mesh = bcase.mesh
    props = bcase.transport_properties()
    _, nu = dimensioned_scalar(props["nu"])
    cfg = _piso_config(bcase, nu, nu_fn=transport.select(props))
    from foamtpu_torch.solvers.apps import _function_objects

    bfol = _function_objects(bcase)
    state = piso.initial_state(mesh, bcase.read_field("U"),
                               bcase.read_field("p"))
    setup_s = time.perf_counter() - t0
    spmv.LAUNCHES = spmv.FB_LAUNCHES = 0
    t0 = time.perf_counter()
    with quiet():
        state, diag = app_steps(bcase, piso.make_step(mesh, cfg), state,
                                SURF_HEAD_STEPS, bfol)
    torch.cuda.synchronize()
    big_s = time.perf_counter() - t0
    launches_total += spmv.LAUNCHES
    fb_total += spmv.FB_LAUNCHES
    by = {k: 1e3 * v / SURF_HEAD_STEPS
          for k, v in bfol.seconds_by_object.items()}
    checks["400^2: no object failed"] = bfol.failures == 0
    checks["400^2: every step wrote its surfaces"] = all(
        len(os.listdir(os.path.join(big, "postProcessing", "sampled", t)))
        == 3 for t in os.listdir(os.path.join(big, "postProcessing",
                                              "sampled")))
    out = {"phase": "surfaces_coded", "dtype": "torch.float32",
           "cavity": {"steps": case.time.index, "run_s": run_s,
                      "summary": got, "analytic": got_a,
                      "analytic_execute_s": analytic_s,
                      "fo_host_ms_per_step_by_object": {
                          k: 1e3 * v / SURFACES_STEPS
                          for k, v in fol.seconds_by_object.items()},
                      "fo_fetches": fol.fetches()},
           "golden_rel_err": rel,
           "cross400": {"n_cells": mesh.n_cells, "setup_s": setup_s,
                        "steps": SURF_HEAD_STEPS,
                        "sec_per_step": big_s / SURF_HEAD_STEPS,
                        "fol_execute_host_ms_per_step_by_object": by,
                        "fol_fetches": bfol.fetches(),
                        "fol_failures": bfol.failures},
           "spmv_launches_total": launches_total,
           "spmv_fb_launches_total": fb_total, "checks": checks}
    emit(out)
    for name, ok in checks.items():
        check(ok, f"surfaces_coded check {name}: {out}")
    return out


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
        turb = phase_turbulence_models(spmv, here,
                                       os.path.join(root, "turbulence"))
        stamp("turbulence_models")
        les, err_les, t_les = phase_les_headline(spmv, here, root, flush)
        stamp("les_headline")
        thermal = phase_thermal(spmv, here, root)
        stamp("thermal")
        bouss, err_bh, t_bh = phase_boussinesq_headline(spmv, here, root,
                                                        flush)
        stamp("boussinesq_headline")
        dym = phase_dym(spmv, here, root)
        stamp("dym")
        dymh, err_dh, t_dh = phase_dym_headline(spmv, here, root, flush)
        stamp("dym_headline")
        surf = phase_surfaces_coded(spmv, here, root)
        stamp("surfaces_coded")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "timeline", "seconds": TIMELINE,
          "total_s": time.perf_counter() - T_START,
          "incomplete_profiles": INCOMPLETE_PROFILES,
          "profiler_fallbacks": PROFILER_FALLBACKS})

    # the kernels line: device ms per call (torch.profiler) with L2
    # flushed before every call, beside the HBM bound, of the whole
    # operator at the duct's pressure operand (one launch, remainder
    # included), the largest call the main path makes; the warm-L2 time
    # apart, and every timed shape beside it
    main_shape = next(t for t in t_duct if t["shape"] == "duct_p_whole")
    paths = (head, pitz, duct, ras, pras, phead, dam, basic, cross, heated,
             rot, mrf, turb, les, thermal, bouss, dym, dymh, surf)
    emit({"kernels": [{
        "name": "spmv_stencil", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": sum(p["spmv_launches_total"] for p in paths),
        "fb_launches": sum(p["spmv_fb_launches_total"] for p in paths),
        "max_abs_err": max(max_err, err_duct, err_dam, err_heat, err_mrf,
                           err_les, err_bh, err_dh),
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
            for t in timings + t_duct + t_dam + t_heat + t_mrf + t_les
            + t_bh + t_dh]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
