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
     perturbed start: blockMesh in memory, Case, 3 warm-up steps through
     run(case), three timed 5-step chunks, the SpMV kernel held to its plain version
     at the channel's p and U operands (f32, f64) and timed at p, and one
     profiled step last.
 20. turbulence_models2: the 27 models of ras2.py-ras5.py, les3.py, les4.py
     and compressible2.py from case files through run(case): the twelve
     RAS models on the 2D channel (10 pisoFoam steps; qZeta 2), the six
     LES models on channel395 (10 channelFoam steps), the nine
     compressible models under buoyantPimpleFoam on hotCavity (3 steps),
     to goldens from the JAX package and the reference tests' oracles (R
     and B: positive normal components, k = tr/2); the constant-rho
     twins of tests/test_turbulence_compressible2.py; the SpMV kernel
     held and timed at LRR's R [300, 6], its first six-column operand.
 21. diffstress_headline: channel395 at 192x128x32 (786,432 cells) under
     DeardorffDiffStress on les_headline's host mesh: 2 warm-up steps
     through run(case), three timed 3-step chunks, the SpMV held to its
     plain version at the subgrid stress B [786432, 6] (f32, f64) and
     timed there, one profiled step last; the B solve's iterations,
     host and device ms.
 22. thermal: both hotRoom tutorials through run(case) (SIMPLE 200
     iterations to tests/test_buoyant.py's oracles; PIMPLE 10 steps to the
     divergence the JAX package shows as shipped, and with the Euler ddt
     from a seeded start to goldens), and the Rayleigh-Benard onset.
 23. boussinesq_headline: hotRoom SIMPLE at 1024x768 (786,432 cells, the
     shipped GAMG p_rgh controls), three timed 5-iteration chunks, the
     GAMG cycles per p_rgh solve, the SpMV at the p_rgh operand, one
     profiled iteration.
 24. dym: pimpleDyMFoam's oscillatingBox (50 steps) and interDyMFoam on
     damBreak with an oscillatingLinearMotion dynamicMeshDict (20 steps)
     through run(case): goldens, constant volume, the motion, continuity.
 25. dym_headline: oscillatingBox at 1024^2 (1,048,576 cells) in memory,
     bench.py's GAMG p: timed steps, the device ms of update_geometry +
     mesh_flux, the SpMV at the moved mesh's p operand, one profiled step.
 26. surfaces_coded: sampledSurfaces (cutting plane, iso-surface, patch)
     and a coded object in the cavity through run(case) and on analytic
     fields, to goldens from the JAX package; their host ms at 400^2.
 27. compressible: the compressible family's tutorials through run(case)
     (rhoPimpleFoam, rhoSimpleFoam, rhoSimplecFoam, rhoPimplecFoam on
     heatedDuct; rhoPorousSimpleFoam, rhoPorousMRFSimpleFoam,
     rhoPorousMRFPimpleFoam on porousDuct; sonicFoam, rhoCentralFoam on
     forwardStep; rhoCentralDyMFoam on movingStep; buoyantSimpleFoam on
     buoyantCavity, buoyantPimpleFoam on hotCavity; LTSInterFoam) to
     goldens from the JAX package and their invariants (COMP_RUNS gives
     each run's depth); the oracles of tests/test_rhopimple.py and
     tests/test_buoyantrho.py on their own setups; the SpMV kernel held to
     its plain version at rhoPimpleFoam's p and U and at sonicFoam's
     non-symmetric transonic p, timed there.
 28. compressible_headline: rhoPimpleFoam on heatedDuct at 1536 x 512
     (786,432 cells, deltaT scaled to the shipped Courant number, the
     shipped PCG p), timed steps with the p iterations of the first and
     the final solve of each step; bench.py's GAMG p controls where the
     final solve sits at its cap; the SpMV at the p operand; one profiled
     step.
 29. rhocentral_headline: rhoCentralFoam on forwardStep refined 8x per
     direction (1,032,192 cells), 50 steps in chunks of 10: steps/s, one
     profiled chunk, the bow shock, the mean density and one step's mass
     balance against its boundary fluxes.
 30. solvers_small: the single-equation applications (electrostaticFoam,
     magneticFoam, mhdFoam, financialFoam, shallowWaterFoam,
     solidEquilibriumDisplacementFoam, potentialFreeSurfaceFoam,
     adjointShapeOptimizationFoam, dnsFoam after boxTurb) and pimpleFoam's
     fanDuct (after topoSet and createBaffles: the fan on a retained
     cyclicAMI pair) from their tutorials through run(case), cut where
     SMALL_RUNS says, to goldens from the JAX package; the oracles of the
     JAX package's tests for each on their own setups; the SpMV kernel
     held to its plain version at plateTension's D and fanDuct's p and
     timed there.
 31. mhd_headline: mhdFoam's hartmann at 1536 x 512 (786,432 cells) in
     memory at Ha = 20, deltaT scaled to an Alfven Courant number of 0.5:
     a warm-up step (GAMG p and pB where the shipped PCG reaches
     its cap), three timed 5-step chunks, the SpMV held and timed at the
     p and B operands, one profiled step.
 32. snappy_cht: bluffBody and openTerrain through blockMesh,
     snappyHexMesh and run(case), heatedSlabs under both cht
     applications, to goldens and oracles; the SpMV at bluffBody's p and
     the heater's T.
 33. snappy_headline: bluffBody's background at 192 x 48 x 48 (443,180
     cells snapped in the background process), timed and profiled, the
     SpMV at the snapped p.
 34. cht_headline: two slabs of 393,216 cells each under
     chtMultiRegionFoam, timed and profiled, the SpMV at a slab's T.
 35. multiphase: the multiphase family's eleven tutorials and
     MRFMultiphaseInterFoam (damBreak4phase with MRFInterFoam's rotor)
     through blockMesh, setFields and run(case) at 20-50 steps
     (SLICE13_RUNS), to goldens from the JAX package and the reference
     tests' oracles (bounded fractions summing to 1, phase volumes, the
     rising bubble band, depthCharge2D's pressure range, cavitatingBox's
     vaporisation); the SpMV held and timed at mixingColumn's alpha
     operator (non-symmetric) and cavitatingBox's p_rgh.
 36. multiphase_headline: twoPhaseEulerFoam on bubbleColumn refined 32x
     (480 x 1600 = 768,000 cells, meshed in the background process): the
     shipped PCG p for 2 steps (its iterations and continuity), then GAMG
     p: timed 10-step chunks with the GAMG cycles and BiCGStab iterations
     per solve, the SpMV held and timed at the two-fluid p and Ub, one
     profiled step.
 37. combustion: chemFoam h2, reactingFoam counterFlowFlame2D, XiFoam
     moriyoshiHomogeneous and PDRFoam flamePropagation after setFields,
     fireFoam smallPoolFire2D and its pyrolysis case, buoyantPimpleFoam
     hotCavity dark and with P1, and dark and with fvDOM (a thick medium)
     over shorter steps, through run(case) (SLICE15_RUNS) to goldens from
     the JAX package and the reference tests' oracles; counterFlowFlame2D
     at 51,200 cells with the batched ODE's passes, attempts and host
     reads; the SpMV held and timed at an fvDOM ray's operand, at the
     species' Y [1500, 5], at counterFlowFlame2D's p and at
     moriyoshiHomogeneous's b.
 38. fire_headline: fireFoam on smallPoolFire2D at 600 x 1000 cells of
     20 mm with P1 radiation (meshed in the background process): a
     2-step warm-up, three timed 3-step chunks with the p_rgh and G PCG
     and Y BiCGStab iterations and each step's continuity, the SpMV held
     and timed at p_rgh, G and Y [600000, 5], one profiled step.
 39. topo: the case-directory entry end to end, `python -m foamtpu_torch
     run -case <copy> -steps N` in a process per case, all at once:
     pimpleDyMFoam's attachDuct across its detach event (12 steps),
     interDyMFoam's damBreakWithObstacle under dynamicRefineFvMesh (10
     steps), sonicDyMFoam's movingStep (p in Pa, 20 steps),
     coldEngineFoam's compression (20) and layeredCylinder past its first
     layer removal (35), engineFoam's firingCylinder with a spark 2 CAD
     in (20), the floating body of tests/test_floating.py (20 steps):
     goldens from the port on the CPU in float64 at ten times the spread
     under round-off, the reference tests' oracles (the water volume,
     alpha's bounds, the isentrope, the burnt kernel), each process's
     SpMV launches.
 40. amr_headline: interDyMFoam with dynamicRefineFvMesh on
     damBreakWithObstacle's box at 384^2 (147,456 cells; blockMesh and
     the octree in the background process): 6 steps, an adaptation every
     2, each step's host seconds, stream ms and launches, each event's
     host seconds of adapt, build_maps + remap, to_device, the GAMG
     controls and correctPhi; the SpMV held and timed at the refined
     mesh's p_rgh (its hanging faces in the remainder); one step to settle
     the last event, then one profiled step.
 41. lagrangian, lagrangian_headline: the Lagrangian and discrete-method
     tutorials, one process each, and their paths at width.
 42. mesh_utilities (after lagrangian_headline): the icoFoam cavity at 1
     m cut to its left half at 192 x 384, through blockMesh, topoSet,
     refineMesh (the top half), mirrorMesh, changeDictionary and
     checkMesh, each `python -m foamtpu_torch <command>` in a process of
     its own in the background premesh process (368,640 cells, hanging
     faces along the refinement edge), then `python -m foamtpu_torch run`
     on the card for 20 corrected non-orthogonal PISO steps (a warm-up
     chunk of 10 and a timed one): checkMesh's statistics and the flow
     scalars against goldens from the JAX package, the 80 corrector
     passes, the SpMV held and timed at the p operand, one profiled step.
 43. bc_utilities (after dambreak): the boundary-condition layer and
     the utilities as a user runs them, three processes at once, each
     command through `python -m foamtpu_torch` (bcu_case, bcu_chains):
     pitzDaily with a uniformFixedValue inlet (a k table) and partialSlip
     walls (checkMesh, 10 SIMPLE iterations, yPlusRAS, wallShearStress),
     the cavity with a timeVaryingMappedFixedValue lid from seeded
     boundaryData (20 steps, postProcess, vorticity, Q, Lambda2, sample,
     foamToVTK), damBreak with a 45-degree contact angle and
     fixedFluxPressure walls (checkMesh, mapFields onto 92^2, 20 steps,
     vorticity); every summary (foamLog of each run's log among it) held
     to goldens from the JAX package.
 44. utilities_headline (last): bench.py's duct renumbered by reverse
     Cuthill-McKee in process (its host seconds, bandwidth, COO fraction
     and checkMesh; its GAMG hierarchy, minutes of host numpy, built by a
     background process from the same renumbering), its first 5
     iterations beside the duct's (GAMG cycles, s/iter, the fields mapped
     back held to the duct's), its p operand held to the plain version
     and timed; the vorticity, Q and Lambda2
     fields on its state (device ms each); damBreak at 736^2 with the
     contact angle: a warm-up, a timed chunk, one profiled chunk, alpha's
     bounds, the water volume and the normals at the contact line.
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
sheet). The operands of THREE_RUN_SHAPES, which PERF.md holds from three
chip runs, are timed flushed only (kernel and plain).
Then the kernel table and the final `{"ok": true, ...}` line.

It needs a CUDA card and the repository's foamtpu_torch package beside
it; without either it exits non-zero before printing any result.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

REPO_DIR = os.path.dirname(os.path.abspath(__file__))
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
MRF_HEAD_CHUNK = 2   # the timed chunks end before the p solves that
                     # reach their cap (at 3 they took 4.6-7 s an iteration)
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
    # numpy scalars (a bool of a comparison, a float32) as Python numbers
    print(json.dumps(obj, default=lambda o: o.item()), flush=True)


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


def duct_setup(nx, ny, nz, device="cuda", pm=None, levels=None):
    """bench.py's unstructured row (bench.py:417-486) through the port:
    the 6-tet split of an nx*ny*nz box of size 4x1x1, U=1 inlet with
    inletOutlet outlet and no-slip walls, simpleFoam + kOmegaSST with
    omegaWallFunction/kqRWallFunction/nutkWallFunction, GAMG p with the
    polynomial preconditioner (its hierarchy `levels` where given).
    Returns (mesh, cfg, state, seconds) with the set-up time split into
    mesh build, to_device, wall distance and GAMG hierarchy."""
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
    if pm is None:
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
    gamg = GAMG(mesh, levels=levels)
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
        from foamtpu_torch.core.dimensions import (DimensionSet,
                                                   dimDensity, dimFlux,
                                                   dimLength, dimTime,
                                                   dimVolume)

        heat = "p_rgh" in state and "T" in state
        mass = DimensionSet.of(1, 0, -1)    # kg/s
        if "p" in state and "T" in state:
            # rhoPimpleFoam / sonicFoam: U and T rows carry the mass flux
            heat = True
            self.names = {mass * state["U"].dims: "U",
                          dimTime * state["p"].dims * dimLength: "p",
                          mass * state["T"].dims: "T"}
        elif heat:
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
        transported = [k for k in state.get("turb", {})
                       if k not in ("nut", "mut", "alphat")]
        flux = mass if "mut" in state.get("turb", {}) else dimFlux
        for name in transported:
            self.names[flux * state["turb"][name].dims] = name
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

    def _name(self, mat):
        name = self.names.get(mat.dims)
        check(name is not None, f"a solve of unnamed dimensions {mat.dims}")
        return name

    def _solve(self, mesh, mat, psi, controls):
        from torch.profiler import record_function

        name = self._name(mat)
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


class StepLog(SolveLog):
    """A SolveLog that names each solve by its place in the step, `cycle`
    repeating after the `lead` solves (mhdFoam's B and U equations share
    their dimensions; a PISO state starts with the pcorr solve of its
    initial flux projection)."""

    def __init__(self, cycle, fence=False, ranges=False, lead=()):
        self.cycle, self.lead, self.k = tuple(cycle), tuple(lead), 0
        names = list(dict.fromkeys(self.lead + self.cycle))
        self.fence, self.ranges = fence, ranges
        self.calls = dict.fromkeys(names, 0)
        self.seconds = dict.fromkeys(names, 0.0)
        self.iterations = {name: [] for name in names}
        self.matrices = {}

    def _name(self, mat):
        k, self.k = self.k, self.k + 1
        if k < len(self.lead):
            return self.lead[k]
        return self.cycle[(k - len(self.lead)) % len(self.cycle)]


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
            raw = RawProfile(prof)
            events = sum(k for name, (_, k) in raw.by_name.items()
                         if "unsigned char" not in name)
            if events:
                break
            INCOMPLETE_PROFILES += 1
        if not events:
            PROFILER_FALLBACKS += 1
            return events_ms(fn, flush, reps)
        taken.append((events, raw.device_ms(
            lambda name: "unsigned char" not in name)))
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


# the operands PERF.md §6 already holds from three chip runs: time_shape
# keeps their flushed kernel and plain timings (their check against the
# plain version stays at the call site) and leaves out the warm, graph and
# CSR timings, for the script's time limit
THREE_RUN_SHAPES = frozenset((
    "channel_p", "hotroom_p_rgh", "box_moved_p", "heatedDuct_p", "sonic_p",
    "bluffBody_p", "heatedSlabs_T", "snapped_p", "slab_T",
    "mixingColumn_alpha", "cavitatingBox_p_rgh", "bubbleColumn_p",
    "bubbleColumn_Ub", "channel_B6",
    # since the topology-change slice, whose whole-script runs timed every
    # shape in full, three times (the duct's p stays: the kernels line
    # reads it)
    "cavity_n160000", "cavity_n160000x3", "pitz_p", "duct_Ux3",
    "dambreak_p_rgh", "heated_T", "mixer_p", "ras_channel_R6",
    "plateTension_D", "fanDuct_p", "hartmann_p", "hartmann_B",
    "hotCavity_fvDOM_ray", "smallPoolFire2D_Y5", "counterFlowFlame2D_p",
    "moriyoshiHomogeneous_b", "fire_p_rgh", "fire_G", "fire_Y5",
    "amr_p_rgh"))
# the operands timed flushed only but with their CSR product (kernel,
# plain and cuSPARSE, no warm or graph timings): the duct's p, which the
# kernels line reads, since the Lagrangian slice, and that slice's two
# new operands (reactingParcelFoam's p and Yvapour at 512 x 512), the
# renumbered duct's p and the mesh chain's p (its hanging faces in the
# remainder)
CSR_FLUSHED_SHAPES = frozenset(("duct_p", "rpf_p", "rpf_Yv", "duct_rcm_p",
                                "mesh_chain_p"))


def time_shape(spmv, name, diag, x, soff, deltas, flush, fb=None):
    """Kernel, plain version and the CSR product at one operand (the
    plain version timed in turns plain/kernel/kernel/plain), with the
    bound: the slot part alone, and with a remainder fb (spmv.Remainder)
    also the whole operator in one launch (the main path's call, shape
    `<name>_whole`) against its plain version (roll chain + index_add)
    and the CSR product of the whole operator. A shape of
    THREE_RUN_SHAPES is timed flushed only, kernel and plain (its warm,
    graph and CSR entries None); one of CSR_FLUSHED_SHAPES flushed only
    with its CSR product. Returns the entries."""
    n = x.shape[0]
    ncols = 1 if x.ndim == 1 else x.shape[1]
    xs = x.reshape(-1)
    brief = name in THREE_RUN_SHAPES
    flushed = brief or name in CSR_FLUSHED_SHAPES
    out = []
    for part in ((None,) if fb is None else (None, fb)):
        def kern():
            return spmv.spmv(diag, x, soff, deltas, part)

        def plain():
            return spmv.plain(diag, x, soff, deltas, part)

        if flushed:
            def timing(f):
                return {"ms": device_ms(f, flush), "ms_l2_warm": None}
        else:
            def timing(f):
                return timed(f, flush)
        a = lb = None
        if not brief:
            a = csr_operator(diag, soff, deltas, None if part is None else
                             (part.cells, part.nbrs, part.coeffs))

            def lib():
                return a @ xs

            ref = plain()
            check(bool(torch.allclose(lib().reshape(x.shape), ref,
                                      rtol=1e-4,
                                      atol=1e-5 * float(ref.abs().max()))),
                  f"CSR operator disagrees with plain at {name}")
        p1, k1, k2, p2 = (timing(f) for f in (plain, kern, kern, plain))
        k = min((k1, k2), key=lambda t: t["ms"])
        p = min((p1, p2), key=lambda t: t["ms"])
        if not brief:
            lb = timing(lib)
        n_fb = 0 if part is None else int(part.cells.shape[0])
        t = {"shape": name if part is None else f"{name}_whole", "n": n,
             "ncols": ncols, "offsets": len(deltas), "coo_entries": n_fb,
             "diag": diag is not None, "dtype": str(x.dtype),
             "kernel_ms": k["ms"], "kernel_ms_l2_warm": k["ms_l2_warm"],
             "kernel_graph_ms": None if flushed else graph_ms(kern, flush),
             # CUDA events around the wrapper, calls back to back: the
             # host launch path when it is the slower side
             "kernel_wrapper_ms": time_ms(kern),
             "plain_ms": p["ms"], "plain_ms_l2_warm": p["ms_l2_warm"],
             "library_ms": None if brief else lb["ms"],
             "library_ms_l2_warm": None if brief else lb["ms_l2_warm"],
             "runs": {"plain": [p1, p2], "kernel": [k1, k2]},
             "library": None if brief else
             "torch.sparse CSR @ x (cuSPARSE), "
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


class RawProfile:
    """A finished torch.profiler profile read from its kineto events, in
    place of `key_averages`, whose Python parse of the events took ~0.4 ms
    a kernel launch (15-40 s on a step of 10^5 launches; ~140 s over the
    script's profiles before the Lagrangian slice). `device`: the device
    events (kernels, copies, memsets) but the GPU copies of record_function
    ranges; `self_ms(name)` and `count(name)` per event name; `launches`:
    the cudaLaunchKernel calls; `inclusive_ms(prefix)`: per CPU op or range
    whose name starts with `prefix`, its calls, CPU ms and the device ms
    of the kernels launched inside it (a kernel counts toward every op or
    range whose interval on its thread holds the start of the CPU event
    it is linked to), as key_averages' device_time_total."""

    def __init__(self, prof, skip=("solve_",)):
        cuda = torch.autograd.DeviceType.CUDA
        events = prof.profiler.kineto_results.events()
        self.device = [e for e in events if e.device_type() == cuda
                       and not e.name().startswith(skip)]
        self.cpu = [e for e in events if e.device_type() != cuda]
        self.launches = sum(e.name() == "cudaLaunchKernel" for e in self.cpu)
        self.by_name = {}
        for e in self.device:
            ns, k = self.by_name.get(e.name(), (0, 0))
            self.by_name[e.name()] = (ns + e.duration_ns(), k + 1)

    def device_ms(self, keep=lambda name: True):
        return sum(ns for name, (ns, _) in self.by_name.items()
                   if keep(name)) / 1e6

    def top(self, n, per=1.0):
        """The n largest device events by name: (ms, calls, name), each
        divided by `per`."""
        return sorted(((ns / 1e6 / per, k / per, name[:70])
                       for name, (ns, k) in self.by_name.items()),
                      reverse=True)[:n]

    def inclusive_ms(self, prefix):
        start = {e.correlation_id(): (e.start_thread_id(), e.start_ns())
                 for e in self.cpu}
        per_thread = {}
        for e in self.device:
            key = start.get(e.linked_correlation_id())
            if key is not None:
                per_thread.setdefault(key[0], []).append(
                    (key[1], e.duration_ns()))
        tables = {}
        for tid, pairs in per_thread.items():
            pairs.sort()
            t = np.array([a for a, _ in pairs], dtype=np.int64)
            c = np.concatenate([[0], np.cumsum([b for _, b in pairs])])
            tables[tid] = (t, c)
        out = {}
        for e in self.cpu:
            if not e.name().startswith(prefix):
                continue
            calls, cpu_ns, dev_ns = out.get(e.name(), (0, 0, 0))
            t, c = tables.get(e.start_thread_id(), (None, None))
            if t is not None:
                lo = np.searchsorted(t, e.start_ns(), side="left")
                hi = np.searchsorted(t, e.start_ns() + e.duration_ns(),
                                     side="right")
                dev_ns += int(c[hi] - c[lo])
            out[e.name()] = (calls + 1, cpu_ns + e.duration_ns(), dev_ns)
        return {k: (n, cpu / 1e6, dev / 1e6) for k, (n, cpu, dev)
                in out.items()}


def solver_iterations(diag):
    if "p_iters" not in diag and "T" not in diag:
        return {}                   # rhoCentralFoam: explicit
    if "p_iters" not in diag:       # the basic solvers: one T solve
        return {"T": int(diag["T"].n_iterations)}
    out = {"p": int(diag["p_iters"]), "U": int(diag["Ux"].n_iterations)}
    out.update({k[len("turb_"):]: int(v.n_iterations)
                for k, v in diag.items() if k.startswith("turb_")})
    return out


def profile_chunk(spmv, phase, mesh, chunk, state, n, sec_per_iter, top=12,
                  solves=True, log=None):
    """One n-iteration chunk under torch.profiler (CPU + CUDA), each
    linear solve in a record_function range named after its field, with
    the SpMV launches counted over the same chunk, and among them those
    that carried the COO remainder (spmv.FB_LAUNCHES); where the mesh
    has COO entries, a chunk with no such launch fails the run, and so
    does one whose SpMV kernels the profiler saw no device time of.
    With `solves` False (rhoCentralFoam: explicit, no linear solve) no
    solve is logged and no SpMV is expected.
    Device time is the sum over device-side events (the GPU copies of
    the record_function ranges are spans, not work, and are left out);
    the busy share divides it by the unprofiled time per iteration. A
    solve's device ms counts the kernels of the torch ops inside its
    range: the SpMV kernels, launched through ctypes, are not attributed
    to ranges and have their own line. `log` replaces the SolveLog (a
    StepLog with ranges, where dimensions do not name the solves)."""
    from torch.profiler import ProfilerActivity, profile

    launches0, fb0 = spmv.LAUNCHES, spmv.FB_LAUNCHES
    if log is None:
        log = (SolveLog(state, ranges=True) if solves
               else contextlib.nullcontext())
    with log as log:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, diag = chunk(state)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spmv_launches = spmv.LAUNCHES - launches0
    fb_launches = spmv.FB_LAUNCHES - fb0
    raw = RawProfile(prof)
    # device-side events (kernels, copies, memsets); the CPU ops carry
    # the same time again as their children's
    device_ms = raw.device_ms()
    solve_ms = {name[len("solve_"):]: {
        "cpu_ms_per_call": cpu / calls, "device_ms_per_call": dev / calls}
        for name, (calls, cpu, dev) in raw.inclusive_ms("solve_").items()
        if cpu > 0}

    def is_spmv(name):
        return name.startswith("void spmv_stencil_kernel")

    spmv_device_ms = raw.device_ms(is_spmv)
    spmv_events = sum(k for name, (_, k) in raw.by_name.items()
                      if is_spmv(name))
    index_add_ms = raw.device_ms(
        lambda name: "indexFunc" in name or "index_add" in name)
    kernels = raw.top(top, per=n)
    launches = raw.launches
    # host-side aten ops by the device time of the kernels they launch
    # (inclusive: an op's children count again under their own names)
    ops = sorted(((dev / n, calls / n, name) for name, (calls, _, dev)
                  in raw.inclusive_ms("aten::").items()),
                 reverse=True)[:top]
    out = {"phase": phase, "iterations": n, "profiled_wall_s": wall,
           "device_ms_per_iter": device_ms / n,
           "device_busy_share_unprofiled": device_ms / n / 1e3 / sec_per_iter,
           "cuda_launch_kernel_per_iter": launches / n,
           "spmv_launches_per_iter": spmv_launches / n,
           "spmv_fb_launches_per_iter": fb_launches / n,
           "spmv_kernel_events_per_iter": spmv_events / n,
           "spmv_device_ms_per_iter": spmv_device_ms / n,
           "index_add_device_ms_per_iter": index_add_ms / n,
           "solver_iterations": solver_iterations(diag),
           "solve_calls": log.calls if solves else {},
           "solves": solve_ms,
           "top_kernels_ms_per_iter": kernels,
           "top_ops_device_ms_per_iter": ops}
    emit(out)
    if not solves:
        check(spmv_launches == 0, f"{phase}: an SpMV launch on an explicit "
              "path")
        return state, out
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


def duct_fields(state):
    """Copies of the duct state's U, p, k, omega and nut."""
    turb = state["turb"]
    return {"U": state["U"].data.clone(), "p": state["p"].data.clone(),
            **{k: turb[k].data.clone() for k in ("k", "omega", "nut")}}


def phase_duct(spmv, chunk=DUCT_CHUNK, trials=DUCT_TRIALS):
    """bench.py's unstructured row through the port on the card."""
    from foamtpu_torch.mesh.tetmesh import coo_fraction
    from foamtpu_torch.solvers import simple

    torch.cuda.reset_peak_memory_stats()
    spmv.LAUNCHES = spmv.FB_LAUNCHES = 0
    from foamtpu_torch.mesh.tetmesh import tet_box

    t0 = time.perf_counter()
    pre = premeshed("duct")
    pm = pre[0] if pre else tet_box(*DUCT, size=(4.0, 1.0, 1.0))
    build_s = time.perf_counter() - t0
    mesh, cfg, state, setup = duct_setup(*DUCT, device="cuda", pm=pm)
    setup_s = time.perf_counter() - t0
    if pre:
        # the tets were built beside the earlier phases
        setup.update(mesh_build=pre[1]["mesh_s"],
                     premesh_wait=pre[1]["premesh_wait_s"])
    else:
        setup.update(mesh_build=build_s)
    # the host mesh, for utilities_headline's renumbering
    HEAD_KEEP["duct_pm"] = pm
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
    # the fields after every iteration, for utilities_headline's
    # renumbered duct over the same iterations
    HEAD_KEEP["duct_fields"] = duct_fields(state)
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


def copy_case(here, rel, root, name, edits=(), mesh=True):
    """A tutorial copied under `root` with (path, old, new) text edits,
    each of which must change its file, then (with `mesh`) meshed by the
    port's blockMesh. Returns the copy's path."""
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
    if mesh:
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


def phase_pimple_headline(spmv, n=400, nsteps=10, trials=2, n_profile=5):
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


def max_iter(controls):
    """A solve's iteration cap: its controls' maxIter, or the linear
    solvers' default (foamtpu_torch/solvers/linear/__init__.py)."""
    return int((controls or {}).get("maxIter", 1000))


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

    got = premeshed("dambreak_small")
    if got is not None:
        # blockMesh and setFields made in the background process
        dst = got[1]["case_dir"]
    else:
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


def dambreak_big_case(here, root, n):
    """damBreak copied under root at n x n cells and DAMBREAK_BIG_DT (not
    meshed)."""
    return copy_case(here, DAMBREAK_CASE, root, f"damBreak{n}", edits=[
        ("constant/polyMesh/blockMeshDict", f"({DAMBREAK_N} {DAMBREAK_N} 1)",
         f"({n} {n} 1)"),
        ("system/controlDict", "deltaT          0.001;",
         f"deltaT          {DAMBREAK_BIG_DT};")], mesh=False)


def dambreak_big(spmv, here, root, n=DAMBREAK_BIG_N, trials=2):
    """(b) the same case at n x n cells: set-up and two warm-up steps
    through the application, then its own step (the config and state the
    application built) in three timed chunks and one profiled chunk."""
    from foamtpu_torch.apps.cli import main as cli
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.solvers import interfoam
    from foamtpu_torch.solvers.apps import _inter_config, run

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = premeshed("dambreak") if n == DAMBREAK_BIG_N else None
    if got:
        # meshed and set up by the premesh process: its case directory
        # and the mesh it read there
        pm, premesh = got
        dst = premesh["case_dir"]
        case = Case(dst, device="cuda")
        case._poly = pm
    else:
        premesh = {}
        dst = dambreak_big_case(here, root, n)
        with quiet():
            check(cli(["blockMesh", "-case", dst]) == 0, "blockMesh failed")
            check(cli(["setFields", "-case", dst]) == 0, "setFields failed")
        case = Case(dst, device="cuda")
    mesh = case.mesh
    check(mesh.n_cells == n * n, mesh.n_cells)
    # the mesh and the setFields start, for utilities_headline's angle
    HEAD_KEEP.update(dambreak_dir=dst, dambreak_pm=case.poly_mesh)
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
    if n == DAMBREAK_BIG_N:
        # the left column's fill after the warm-up and the trials, for
        # utilities_headline's run with the contact angle
        HEAD_KEEP["dambreak_fill"] = (
            DAMBREAK_BIG_WARMUP + DAMBREAK_BIG_CHUNK * trials,
            dambreak_invariants(mesh, alpha0, state)[0]["left_column_fill"])
    n_profile = 3

    def profiled(state):
        state, diags = chunk(state, n_profile)
        return state, diags[-1]

    state, prof = profile_chunk(spmv, "dambreak_profile", mesh, profiled,
                                state, n_profile, sec)
    inv, checks = dambreak_invariants(mesh, alpha0, state)
    out = {"n_cells": mesh.n_cells, "dtype": str(mesh.v.dtype),
           "delta_t": dt, "st_deltas": list(mesh.st_deltas),
           "setup_s": setup_s, "premesh": premesh,
           "warmup_steps": DAMBREAK_BIG_WARMUP,
           "warmup_s": warm_s, "sec_per_step": sec,
           "trial_sec_per_step": times, "cells_per_sec": mesh.n_cells / sec,
           "steps": (DAMBREAK_BIG_WARMUP + DAMBREAK_BIG_CHUNK * trials + 1
                     + n_profile),
           "p_rgh_solves_per_step": len(p_iters)
           / (DAMBREAK_BIG_CHUNK * trials),
           "p_rgh_iterations_per_solve": statistics.mean(p_iters),
           "p_rgh_iterations_max": max(p_iters),
           "p_rgh_solves_at_max_iter": sum(
               i >= max_iter(cfg.p_controls) for i in p_iters),
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


def cross_case(here, root):
    """crossCavity at CROSS_N^2 with GAMG p, deltaT CROSS_DT and the
    CROSS_FUNCS objects, as case files without a polyMesh (see
    memory_mesh)."""
    dst = copy_case(here, BASIC_CASES["nonNewtonianIcoFoam"][0], root,
                    f"cross{CROSS_N}", edits=[
                        ("system/blockMeshDict", "(20 20 1)",
                         f"({CROSS_N} {CROSS_N} 1)"),
                        ("system/controlDict", "deltaT 0.0005;",
                         f"deltaT {CROSS_DT!r};"),
                        ("system/fvSolution", "p { solver PCG;",
                         "p { solver GAMG;")], mesh=False)
    with open(os.path.join(dst, "system", "controlDict"), "a") as f:
        f.write(CROSS_FUNCS)
    return dst


def phase_cross_headline(spmv, here, root, trials=2, n_profile=5):
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
    # meshed in memory (memory_mesh: by the background process)
    dst = cross_case(here, root)
    case = memory_mesh(Case(dst, device="cuda"))
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


def heated_edits():
    return [("system/blockMeshDict", "(20 20 1)",
             f"({HEATED_N} {HEATED_N} 1)")]


def phase_heated(spmv, here, root, flush, n_profile=2):
    """heatedBlock at HEATED_N^2, meshed in memory: one step through
    run(case), then
    HEATED_STEPS of the application's step timed, one profiled chunk,
    and the SpMV kernel at the T operand held to its plain version and
    timed."""
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.ops import stencil
    from foamtpu_torch.solvers.apps import basic_step, run

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # meshed in memory (memory_mesh): the ascii polyMesh write and read of
    # 1,048,576 cells took 30-40 s of host time (PR 6-9)
    dst = copy_case(here, BASIC_CASES["laplacianFoam"][0], root,
                    f"heated{HEATED_N}", edits=heated_edits(), mesh=False)
    case = memory_mesh(Case(dst, device="cuda"))
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


def mixer_big_case(here, root):
    """mixerVessel2D copied under root with every block at MRF_HEAD_SCALE
    x per side (not meshed, see memory_mesh)."""
    k = MRF_HEAD_SCALE
    return copy_case(here, ROTATING_CASES["MRFSimpleFoam"][0], root,
                     f"mixer{k}", edits=[
                         ("constant/polyMesh/blockMeshDict", "(12 24 1)",
                          f"({12 * k} {24 * k} 1)")], mesh=False)


def phase_mrf_headline(spmv, here, root, flush, trials=2):
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
    dst = mixer_big_case(here, root)
    case = memory_mesh(Case(dst, device="cuda"))
    blockmesh_s = time.perf_counter() - t0
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
# 10 steps (20 until the utilities slice cut it for the script's time
# limit; RAS_GOLDEN regenerated)
RAS_CHANNEL_STEPS = 10
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
# the RAS models of ras2.py to ras5.py on the same channel: model ->
# (the fields its family carries, the nut wall BC). The wall BCs follow
# the JAX package's tests: tests/test_turbulence2.py::_lowre_fields (k = 0
# and epsilon zeroGradient at the walls; with v2 = f = 0 there for v2f),
# ::_rstm_fields (R kqRWallFunction, epsilon and k their wall functions)
# and tests/test_turbulence4.py::_kklomega_fields (kt = kl = 0, omega
# zeroGradient)
RAS2_CHANNEL_MODELS = {
    "LamBremhorstKE": ("lowRe", "nutLowReWallFunction"),
    "qZeta": ("lowRe", "nutLowReWallFunction"),
    "v2f": ("v2f", "nutLowReWallFunction"),
    "LRR": ("stress", "nutkWallFunction"),
    "LaunderGibsonRSTM": ("stress", "nutkWallFunction"),
    "kOmegaSSTSAS": ("omega", "nutkWallFunction"),
    "NonlinearKEShih": ("lowRe", "nutLowReWallFunction"),
    "LienCubicKE": ("lowRe", "nutLowReWallFunction"),
    "LienCubicKELowRe": ("lowRe", "nutLowReWallFunction"),
    "LienLeschzinerLowRe": ("lowRe", "nutLowReWallFunction"),
    "SpalartAllmarasIDDES": ("nuTilda", "nutUSpaldingWallFunction"),
    "kkLOmega": ("kkL", "nutLowReWallFunction"),
}
CHANNEL395_CASE = os.path.join("tutorials", "incompressible", "channelFoam",
                               "channel395")
BOUNDARY_CASE = os.path.join("tutorials", "incompressible", "boundaryFoam",
                             "boundaryLaunderSharma")
BOUNDARY_STEPS = 100          # the tutorial's endTime 100 / deltaT 1
LES_MODELS = ("Smagorinsky", "oneEqEddy", "homogeneousDynSmagorinsky",
              "dynOneEqEddy", "scaleSimilarity", "mixedSmagorinsky")
LES_K_MODELS = ("oneEqEddy", "dynOneEqEddy")
# the LES models of les3.py and les4.py: model -> the fields its case
# carries besides U, p and nut (tests/test_turbulence4.py::_with_k and
# ::_with_B; dynLagrangian's flm and fmm)
LES2_MODELS = {"dynLagrangian": ("flm", "fmm"), "locDynOneEqEddy": ("k",),
               "dynMixedSmagorinsky": (), "DeardorffDiffStress": ("B", "k"),
               "LRDDiffStress": ("B", "k"), "spectEddyVisc": ()}
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
# the card's p controls for the RAS channel (turbulence_models and its
# goldens): GAMG to the same tolerance as the PCG p of the parity tests,
# which takes 248-268 iterations per solve for 300 cells (40 s of host
# time over the seven models on the card; GAMG's 113-117 cycles take 25 s
# less)
RAS_CHANNEL_CARD_P = ("solver GAMG; smoother GaussSeidel; tolerance 1e-07; "
                      "relTol 0;")
RAS_GOLDEN = {
    'RNGkEpsilon': {
        'ke': 0.504836916923523,
        'ux_centre_out': 0.7992271184921265,
        'ux_centre_row': 1.0000249147415161,
        'ux_wall_row': 0.9979389309883118,
        'k_max': 0.06814098358154297,
        'k_mean': 0.013465684838593006,
        'epsilon_max': 1.3119637966156006,
        'epsilon_mean': 0.16698546707630157,
        'nut_max': 0.0008736493182368577,
        'nut_mean': 0.0001904910895973444,
    },
    'realizableKE': {
        'ke': 0.5050485134124756,
        'ux_centre_out': 0.7950829267501831,
        'ux_centre_row': 1.0000333786010742,
        'ux_wall_row': 0.9980272054672241,
        'k_max': 0.06780942529439926,
        'k_mean': 0.013230474665760994,
        'epsilon_max': 1.3773481845855713,
        'epsilon_mean': 0.17551164329051971,
        'nut_max': 0.002476600930094719,
        'nut_mean': 0.00036841005203314126,
    },
    'LaunderSharmaKE': {
        'ke': 0.5022549033164978,
        'ux_centre_out': 0.8775296211242676,
        'ux_centre_row': 0.9999940395355225,
        'ux_wall_row': 0.9979272484779358,
        'k_max': 1.0847196578979492,
        'k_mean': 0.21144264936447144,
        'epsilon_max': 21.803876876831055,
        'epsilon_mean': 3.7717158794403076,
        'nut_max': 0.004739429336041212,
        'nut_mean': 0.000970332941506058,
    },
    'kOmega': {
        'ke': 0.5063043832778931,
        'ux_centre_out': 0.7696352005004883,
        'ux_centre_row': 1.000041127204895,
        'ux_wall_row': 0.9977454543113708,
        'k_max': 0.025976920500397682,
        'k_mean': 0.006718837656080723,
        'omega_max': 362.7242126464844,
        'omega_mean': 92.9617691040039,
        'nut_max': 0.000332593364873901,
        'nut_mean': 0.00018276437185704708,
    },
    'SpalartAllmaras': {
        'ke': 0.5071530342102051,
        'ux_centre_out': 0.7542719841003418,
        'ux_centre_row': 1.0000611543655396,
        'ux_wall_row': 0.9976623058319092,
        'nuTilda_max': 0.0009350361651740968,
        'nuTilda_mean': 0.00024548821966163814,
        'nut_max': 0.0006503178155981004,
        'nut_mean': 2.17989509110339e-05,
    },
    'SpalartAllmarasDES': {
        'ke': 0.5065832138061523,
        'ux_centre_out': 0.764504611492157,
        'ux_centre_row': 1.0000600814819336,
        'ux_wall_row': 0.9978342652320862,
        'nuTilda_max': 0.00026099217939190567,
        'nuTilda_mean': 0.00011446862481534481,
        'nut_max': 1.235041236213874e-05,
        'nut_mean': 9.032108323481225e-07,
    },
    'SpalartAllmarasDDES': {
        'ke': 0.5071516633033752,
        'ux_centre_out': 0.754269540309906,
        'ux_centre_row': 1.0000592470169067,
        'ux_wall_row': 0.9976624250411987,
        'nuTilda_max': 0.0009350363397970796,
        'nuTilda_mean': 0.0002454882487654686,
        'nut_max': 0.0006503180484287441,
        'nut_mean': 2.179895636800211e-05,
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


def field_values(a, kind):
    """`nonuniform List<kind> n (...)` of per-cell or per-face values
    ([n] or [n, width]), written exactly with repr."""
    a = np.asarray(a, dtype=np.float64)
    rows = (("(" + " ".join(repr(float(x)) for x in r) + ")" for r in a)
            if a.ndim == 2 else (repr(float(x)) for x in a))
    return (f"nonuniform List<{kind}> {a.shape[0]}\n(\n"
            + "\n".join(rows) + "\n)")


def write_field(case_dir, name, dims, internal, boundary):
    """0/<name> with `internal` a scalar, a 3-vector, or per-cell values
    ([n], [n,3] or a symmetric tensor's [n,6], written exactly with repr)
    and `boundary` the text of the boundaryField entries."""
    a = np.asarray(internal, dtype=np.float64)
    vec = a.shape[-1:] == (3,)
    symm = a.ndim == 2 and a.shape[1] == 6
    cls = ("volSymmTensorField" if symm else
           "volVectorField" if vec else "volScalarField")
    if a.ndim == (1 if vec else 0):
        body = ("uniform (" + " ".join(repr(float(x)) for x in a) + ")"
                if vec else f"uniform {float(a)!r}")
    else:
        body = field_values(a, "symmTensor" if symm else
                            "vector" if vec else "scalar")
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
                     nx=30, ny=10, p_solver=None):
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
    second, nut_wall = RAS_CHANNEL_MODELS.get(model, (None, None))
    if model in RAS2_CHANNEL_MODELS:
        nut_wall = RAS2_CHANNEL_MODELS[model][1]
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
    p { %s }
    U { solver PBiCGStab; preconditioner DILU; tolerance 1e-07; relTol 0; }
    "(k|epsilon|omega|nuTilda)"
    { solver PBiCGStab; preconditioner DILU; tolerance 1e-08; relTol 0.01; }
}
PISO { nCorrectors 2; nNonOrthogonalCorrectors 0; pRefCell 0; pRefValue 0; }
""" % (p_solver or "solver PCG; preconditioner DIC; tolerance 1e-07; "
          "relTol 0;"))
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
    if model in RAS2_CHANNEL_MODELS:
        _ras2_channel_fields(dst, RAS2_CHANNEL_MODELS[model][0], rng, n)
    else:
        _ras_channel_fields(dst, model, second, rng, n)
    empty = "frontAndBack { type empty; }"
    write_field(dst, "nut", "[0 2 -1 0 0 0 0]", 0.0, _rows([
        "inlet { type calculated; value uniform 0; }",
        "outlet { type calculated; value uniform 0; }",
        f"walls {{ type {nut_wall}; value uniform 0; }}", empty]))
    return dst


_DIMS = {"k": "[0 2 -2 0 0 0 0]", "epsilon": "[0 2 -3 0 0 0 0]",
         "omega": "[0 0 -1 0 0 0 0]", "nuTilda": "[0 2 -1 0 0 0 0]",
         "R": "[0 2 -2 0 0 0 0]", "B": "[0 2 -2 0 0 0 0]",
         "v2": "[0 2 -2 0 0 0 0]", "f": "[0 0 -1 0 0 0 0]",
         "kt": "[0 2 -2 0 0 0 0]", "kl": "[0 2 -2 0 0 0 0]",
         "flm": "[0 4 -4 0 0 0 0]", "fmm": "[0 4 -4 0 0 0 0]"}


def _ras_channel_fields(dst, model, second, rng, n):
    """The turbulence fields of the models of RAS_CHANNEL_MODELS."""
    empty = "frontAndBack { type empty; }"
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
    names = ("nuTilda",) if second is None else ("k", second)
    for name in names:
        v0 = scales[name]
        write_field(dst, name, _DIMS[name], v0 * (1.0 + 0.2 * rng.random(n)),
                    _rows([
                        f"inlet {{ type fixedValue; value uniform {v0!r}; }}",
                        "outlet { type inletOutlet; inletValue uniform 0; "
                        "value uniform 0; }", walls[name], empty]))


def _ras2_channel_fields(dst, family, rng, n):
    """The turbulence fields of a RAS2_CHANNEL_MODELS family on the
    channel: each its inlet value times 1 + 0.2u cell by cell (R the
    isotropic (2/3) k of the seeded k), fixed at the inlet, inletOutlet
    at the outlet (R and f zeroGradient at both), the family's wall
    BCs."""
    sc = ras_channel_scales()
    k0, eps0 = sc["k"], sc["epsilon"]
    empty = "frontAndBack { type empty; }"
    outlet = ("outlet { type inletOutlet; inletValue uniform 0; "
              "value uniform 0; }")

    def scalar(name, v0, wall, inlet=None, outlet=outlet, base=None):
        vals = (v0 if base is None else base) * (1.0 + 0.2 * rng.random(n))
        inlet = inlet or f"inlet {{ type fixedValue; value uniform {v0!r}; }}"
        write_field(dst, name, _DIMS[name], vals,
                    _rows([inlet, outlet, wall, empty]))
        return vals

    fixed0 = "walls { type fixedValue; value uniform 0; }"
    if family in ("lowRe", "v2f"):
        scalar("k", k0, fixed0)
        scalar("epsilon", eps0, "walls { type zeroGradient; }")
        if family == "v2f":
            scalar("v2", (2.0 / 3.0) * k0, fixed0)
            write_field(dst, "f", _DIMS["f"], 0.0, _rows([
                "inlet { type zeroGradient; }",
                "outlet { type zeroGradient; }", fixed0, empty]))
    elif family in ("stress", "omega"):
        k = scalar("k", k0, f"walls {{ type kqRWallFunction; value uniform "
                            f"{k0!r}; }}")
        if family == "omega":
            scalar("omega", sc["omega"], f"walls {{ type omegaWallFunction; "
                                         f"value uniform {sc['omega']!r}; }}")
        else:
            scalar("epsilon", eps0, f"walls {{ type epsilonWallFunction; "
                                    f"value uniform {eps0!r}; }}")
            # zeroGradient at the inlet: neither package reads a
            # symmTensor fixedValue patch (ROADMAP Queue 3)
            R = np.zeros((n, 6))
            R[:, [0, 3, 5]] = (2.0 / 3.0) * k[:, None]
            write_field(dst, "R", _DIMS["R"], R, _rows([
                "inlet { type zeroGradient; }",
                "outlet { type zeroGradient; }",
                "walls { type kqRWallFunction; }", empty]))
    elif family == "nuTilda":
        scalar("nuTilda", sc["nuTilda"], fixed0)
    elif family == "kkL":
        w0 = k0 ** 0.5 / 0.01
        scalar("kt", k0, fixed0)
        scalar("kl", k0, fixed0, base=1e-8)
        scalar("omega", w0, "walls { type zeroGradient; }")


def les_channel_case(here, dst, model, blocks=(24, 16, 8), steps=LES_STEPS,
                     seed=2, funcs=""):
    """channelFoam's channel395 copied to dst with its block cut to
    `blocks`, LESProperties naming `model`, endTime `steps` deltaT, and
    a well-posed start: U = Ubar + 0.1 |Ubar| n per component and, for
    the models that carry k (LES_K_MODELS, LES2_MODELS), 0/k = k0 (1 +
    0.2u) with k0 = 1.5 (0.05 Ubar)^2, fixed at 0 on the walls (the stress
    models: B = (2/3) k I, both zeroGradient there); dynLagrangian's
    fmm = 1e-7 (1 + 0.2u) and flm = 0.02 fmm (1 + 0.2u); u and n from
    numpy's generator at `seed`. Returns dst; mesh it with blockMesh."""
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
    k0 = 1.5 * (0.05 * 0.1335) ** 2
    carried = LES2_MODELS.get(model, ("k",) if model in LES_K_MODELS else ())
    if "k" in carried:
        k = k0 * (1.0 + 0.2 * rng.random(n))
        # the stress models' k is tr(B)/2, zeroGradient at the walls as B
        wall = ("walls { type zeroGradient; }" if "B" in carried else
                "walls { type fixedValue; value uniform 0; }")
        write_field(dst, "k", "[0 2 -2 0 0 0 0]", k, cyclic + "\n" + wall)
    if "B" in carried:
        # the tutorial's divSchemes hold div(phi,U) alone (default none):
        # the stress transport takes limitedLinear, as OpenFOAM's LES
        # tutorials give div(phi,B)
        edit("system/fvSchemes", "div(phi,U) Gauss linear;",
             "div(phi,U) Gauss linear; div(phi,k) Gauss limitedLinear 1; "
             "div(phi,B) Gauss limitedLinear 1;")
        B = np.zeros((n, 6))
        B[:, [0, 3, 5]] = (2.0 / 3.0) * k[:, None]
        write_field(dst, "B", _DIMS["B"], B, cyclic + "\n"
                    "walls { type zeroGradient; }")
    if "fmm" in carried:
        # a subgrid coefficient flm/fmm of 0.02 about the reference's
        # starting fmm of 1e-7
        fmm = 1e-7 * (1.0 + 0.2 * rng.random(n))
        for name, vals in (("flm", 0.02 * fmm * (1.0 + 0.2 * rng.random(n))),
                           ("fmm", fmm)):
            write_field(dst, name, _DIMS[name], vals, cyclic + "\n"
                        "walls { type zeroGradient; }")
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
        dst = ras_channel_case(os.path.join(root, "ras", model), model,
                               p_solver=RAS_CHANNEL_CARD_P)
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


def les_head_edits():
    return [("system/blockMeshDict", "(24 16 8)",
             "({} {} {})".format(*LES_HEAD_BLOCKS))]


def phase_les_headline(spmv, here, root, flush, trials=2):
    """channel395 with its block refined to LES_HEAD_BLOCKS (786,432
    cells; geometry, cyclic pairs, schemes and deltaT as shipped),
    Smagorinsky, U = Ubar plus a 10% perturbation drawn on the card with
    a torch.Generator: blockMesh in memory, Case, LES_HEAD_WARMUP steps
    through run(case) (the tutorial's PCG p; bench.py's GAMG controls if a p
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
    # meshed in memory (memory_mesh), without the ascii polyMesh write and
    # read (24 s of PR 8-9's 38 s set-up)
    dst = copy_case(here, CHANNEL395_CASE, root, "channel_big",
                    edits=les_head_edits(), mesh=False)
    case = memory_mesh(Case(dst, device="cuda"))
    # kept for diffstress_headline, which runs on the same mesh
    HEAD_POLY["poly"] = case._poly
    blockmesh_s = time.perf_counter() - t0
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
# the rest of turbulence: ras2.py to ras5.py, les3.py, les4.py and
# compressible2.py
# ---------------------------------------------------------------------------

RAS2_STEPS = 5                # pisoFoam steps on the RAS channel
# qZeta diverges on the channel in both packages (ROADMAP Queue 3): two
# steps
RAS2_DEPTH = {"qZeta": 2}
LES2_STEPS = 10               # channelFoam steps on channel395
# buoyantPimpleFoam steps on hotCavity: under the LES models (whose mut
# is near the molecular mu here) T leaves the walls' 270-330 K at step 4,
# in both packages
COMP2_STEPS = 3
# the stress-transport models: R or B positive on the diagonal and
# k = tr/2 (tests/test_turbulence2.py::test_rstm_channel,
# tests/test_turbulence4.py::test_les_batch4_channel)
STRESS_MODELS = {"LRR": "R", "LaunderGibsonRSTM": "R",
                 "DeardorffDiffStress": "B", "LRDDiffStress": "B"}
# the fields whose volume mean and largest value join a run's golden
# scalars (R and B: the mean of xx, of yy and of |xy|)
TURB2_FIELDS = ("R", "B", "v2", "f", "kt", "kl", "flm", "fmm")
COMP2_FIELDS = ("k", "epsilon", "nuTilda", "mut") + TURB2_FIELDS
# the golden tolerance: TURB2_TOL_SPREAD times the runs' spread under
# round-off (TURB2_SPREAD: the largest of |f32 - f64|, |f32 - f32 from a
# start perturbed by 1e-7| and |f32 - the port's f32 on the CPU|,
# relative), at least TURB_GOLDEN_TOL
TURB2_TOL_SPREAD = 10.0
# the least magnitude an error is taken relative to where a model sets a
# field to 0 or near it (lowReOneEqEddy's mut, 2D shear components); on
# hotCavity with COMP_FLOOR's pressure and velocity floors besides
TURB2_FLOOR = {"nut_mean": 1e-7, "nut_max": 1e-7, "mut_mean": 1e-9,
               "mut_max": 1e-9, "flm_mean": 1e-12, "flm_max": 1e-12,
               "R_xy_abs_mean": 1e-7, "B_xy_abs_mean": 1e-9,
               "f_mean": 1e-3, "f_max": 1e-3}
# the constant-rho twins of tests/test_turbulence_compressible2.py and
# their tolerance there (the dynamic LES twins recompute Ck through a
# long filter chain whose float32 rounding differs between the mu and nu
# forms)
RHO_PAIRS = {"RNGkEpsilon": ("k", "epsilon"), "realizableKE":
             ("k", "epsilon"), "SpalartAllmaras": ("nuTilda",),
             "LRR": ("R", "epsilon", "k"), "LaunderGibsonRSTM":
             ("R", "epsilon", "k"), "v2f": ("k", "epsilon", "v2", "f"),
             "dynOneEqEddy": ("k",), "DeardorffDiffStress": ("B", "k")}
RHO_PAIR_TOL = {"RAS": 2e-4, "LES": 1e-3}
# from tests/test_torch_turbulence2.py::reference_goldens2 (the JAX
# package on the CPU in float32, on the cases written above); the spread
# from the same in float64, from a start perturbed by 1e-7 and through the
# port on the CPU (`goldens`, `goldens --perturb`, `goldens --port`, then
# `spread`). On hotCavity the spread reaches 0.97 (the pressure level):
# its goldens bind loosely, its oracles and the constant-rho twins hold
RAS2_GOLDEN = {'LamBremhorstKE': {'ke': 0.5021829605102539,
                    'ux_centre_out': 0.8743416666984558,
                    'ux_centre_row': 0.999822199344635,
                    'ux_wall_row': 0.9989502429962158,
                    'k_max': 0.009814666584134102,
                    'k_mean': 0.0027856682427227497,
                    'epsilon_max': 1.1365177631378174,
                    'epsilon_mean': 0.15511611104011536,
                    'nut_max': 0.00028050621040165424,
                    'nut_mean': 3.189265407854691e-05},
 'qZeta': {'ke': 0.49740859866142273,
           'ux_centre_out': 0.944360077381134,
           'ux_centre_row': 0.999849259853363,
           'ux_wall_row': 1.0017273426055908,
           'k_max': 0.06071271002292633,
           'k_mean': 0.006314180325716734,
           'epsilon_max': 0.10348209738731384,
           'epsilon_mean': 0.00794132985174656,
           'nut_max': 0.0029272164683789015,
           'nut_mean': 0.00015058125427458435},
 'v2f': {'ke': 0.5016792416572571,
         'ux_centre_out': 0.8876482844352722,
         'ux_centre_row': 0.9998471736907959,
         'ux_wall_row': 0.9989718794822693,
         'k_max': 0.16891448199748993,
         'k_mean': 0.02501649223268032,
         'epsilon_max': 0.7954250574111938,
         'epsilon_mean': 0.09835562855005264,
         'nut_max': 0.0009247264242731035,
         'nut_mean': 0.00026844756212085485,
         'v2_mean': 0.002109622634726126,
         'v2_max': 0.004919618368148804,
         'f_mean': 1.3613387683182128,
         'f_max': 1.7212146520614624},
 'LRR': {'ke': 0.5022546648979187,
         'ux_centre_out': 0.872272253036499,
         'ux_centre_row': 0.999851644039154,
         'ux_wall_row': 0.9985864758491516,
         'k_max': 0.020789368078112602,
         'k_mean': 0.007285806350409985,
         'epsilon_max': 0.14835180342197418,
         'epsilon_mean': 0.033312760293483734,
         'nut_max': 0.00039260031189769506,
         'nut_mean': 0.00026456135674379766,
         'R_xx_mean': 0.006734890151910431,
         'R_yy_mean': 0.0039184358203592055,
         'R_xy_abs_mean': 0.0018962668202729051},
 'LaunderGibsonRSTM': {'ke': 0.5023019313812256,
                       'ux_centre_out': 0.8708764910697937,
                       'ux_centre_row': 0.9998546242713928,
                       'ux_wall_row': 0.9984880685806274,
                       'k_max': 0.024995852261781693,
                       'k_mean': 0.008214839734137058,
                       'epsilon_max': 0.22285626828670502,
                       'epsilon_mean': 0.048680633306503296,
                       'nut_max': 0.0003888242063112557,
                       'nut_mean': 0.00025274287327192724,
                       'R_xx_mean': 0.008471360989227433,
                       'R_yy_mean': 0.00289380291835889,
                       'R_xy_abs_mean': 0.001872878442216219},
 'kOmegaSSTSAS': {'ke': 0.50197833776474,
                  'ux_centre_out': 0.8795025944709778,
                  'ux_centre_row': 0.999836266040802,
                  'ux_wall_row': 0.9989757537841797,
                  'k_max': 0.020025234669446945,
                  'k_mean': 0.006165164057165384,
                  'omega_max': 340.7214050292969,
                  'omega_mean': 87.57526397705078,
                  'nut_max': 0.0003441799490246922,
                  'nut_mean': 0.00019509853154886514},
 'NonlinearKEShih': {'ke': 0.5017892718315125,
                     'ux_centre_out': 0.8856166005134583,
                     'ux_centre_row': 0.9998829960823059,
                     'ux_wall_row': 0.9990835189819336,
                     'k_max': 0.015211916528642178,
                     'k_mean': 0.004753149580210447,
                     'epsilon_max': 0.023631222546100616,
                     'epsilon_mean': 0.005346212536096573,
                     'nut_max': 0.0034311951603740454,
                     'nut_mean': 0.000864831730723381},
 'LienCubicKE': {'ke': 0.5018132328987122,
                 'ux_centre_out': 0.8842873573303223,
                 'ux_centre_row': 0.9998743534088135,
                 'ux_wall_row': 0.999049961566925,
                 'k_max': 0.015173223800957203,
                 'k_mean': 0.0047430722042918205,
                 'epsilon_max': 0.02358950860798359,
                 'epsilon_mean': 0.005333790089935064,
                 'nut_max': 0.003406885080039501,
                 'nut_mean': 0.0008309625554829836},
 'LienCubicKELowRe': {'ke': 0.5021131038665771,
                      'ux_centre_out': 0.8754370212554932,
                      'ux_centre_row': 0.9998348355293274,
                      'ux_wall_row': 0.9989916682243347,
                      'k_max': 0.00985657423734665,
                      'k_mean': 0.0039785271510481834,
                      'epsilon_max': 0.010501147247850895,
                      'epsilon_mean': 0.003919382579624653,
                      'nut_max': 0.0015285629779100418,
                      'nut_mean': 0.00021388317691162229},
 'LienLeschzinerLowRe': {'ke': 0.5020593404769897,
                         'ux_centre_out': 0.8773593902587891,
                         'ux_centre_row': 0.9998251795768738,
                         'ux_wall_row': 0.9989604949951172,
                         'k_max': 0.01516090426594019,
                         'k_mean': 0.004628403577953577,
                         'epsilon_max': 0.02373412996530533,
                         'epsilon_mean': 0.0051794275641441345,
                         'nut_max': 0.00044696262921206653,
                         'nut_mean': 8.999153214972466e-05},
 'SpalartAllmarasIDDES': {'ke': 0.5023717880249023,
                          'ux_centre_out': 0.8678877353668213,
                          'ux_centre_row': 0.9998213648796082,
                          'ux_wall_row': 0.9988359212875366,
                          'nuTilda_max': 0.000796761189121753,
                          'nuTilda_mean': 0.00026633660309016705,
                          'nut_max': 0.0004665958695113659,
                          'nut_mean': 2.5092633222811855e-05},
 'kkLOmega': {'ke': 0.5021536946296692,
              'ux_centre_out': 0.8751527070999146,
              'ux_centre_row': 0.9998247027397156,
              'ux_wall_row': 0.9989513754844666,
              'omega_max': 8.638101577758789,
              'omega_mean': 4.3495001792907715,
              'nut_max': 4.6105509682092816e-05,
              'nut_mean': 2.7850892365677282e-05,
              'kt_mean': 0.002429175189218659,
              'kt_max': 0.0051182531751692295,
              'kl_mean': 0.00018390228035213338,
              'kl_max': 0.003075466025620699}}

LES2_GOLDEN = {
    'dynLagrangian': {'ke': 0.009160135872662067, 'ux_mean':
        0.1339830607175827, 'ux_wall_layers': 0.13304370641708374,
        'ux_centre_layers': 0.134132519364357, 'nut_mean': 5.436476203612983e-05,
        'yplus_min': 17.7088, 'yplus_max': 23.3668, 'yplus_avg': 20.5764,
        'wall_shear_min': 3.21128e-05, 'wall_shear_max': 5.59109e-05, 'flm_mean':
        3.938948644472128e-09, 'flm_max': 1.4107982337918656e-07, 'fmm_mean':
        1.4257666780567633e-06, 'fmm_max': 2.4455646780552343e-05},
    'locDynOneEqEddy': {'ke': 0.009161747992038727, 'ux_mean':
        0.13398142158985138, 'ux_wall_layers': 0.13303960859775543,
        'ux_centre_layers': 0.1341322511434555, 'nut_mean':
        2.1021416614530608e-05, 'yplus_min': 19.4028, 'yplus_max': 25.6962,
        'yplus_avg': 22.6124, 'wall_shear_min': 3.85503e-05, 'wall_shear_max':
        6.76143e-05, 'k_mean': 7.269453635672107e-05},
    'dynMixedSmagorinsky': {'ke': 0.009162926115095615, 'ux_mean':
        0.13398145139217377, 'ux_wall_layers': 0.1330329179763794,
        'ux_centre_layers': 0.13413403928279877, 'nut_mean': 0.0, 'yplus_min':
        17.6912, 'yplus_max': 23.3357, 'yplus_avg': 20.5768, 'wall_shear_min':
        3.20491e-05, 'wall_shear_max': 5.57624e-05},
    'DeardorffDiffStress': {'ke': 0.009162983857095242, 'ux_mean':
        0.1339821219444275, 'ux_wall_layers': 0.13304132223129272,
        'ux_centre_layers': 0.13413208723068237, 'nut_mean': 8.73807366588153e-05,
        'yplus_min': 19.4763, 'yplus_max': 25.7482, 'yplus_avg': 22.615,
        'wall_shear_min': 3.8843e-05, 'wall_shear_max': 6.78881e-05, 'k_mean':
        7.250346970977262e-05, 'B_xx_mean': 4.8504745886538706e-05, 'B_yy_mean':
        4.8263542919782924e-05, 'B_xy_abs_mean': 1.7393178704576365e-06},
    'LRDDiffStress': {'ke': 0.009163088165223598, 'ux_mean':
        0.13398267328739166, 'ux_wall_layers': 0.13304275274276733,
        'ux_centre_layers': 0.13413208723068237, 'nut_mean':
        8.731765410630032e-05, 'yplus_min': 19.4478, 'yplus_max': 25.6908,
        'yplus_avg': 22.5773, 'wall_shear_min': 3.87292e-05, 'wall_shear_max':
        6.75859e-05, 'k_mean': 7.239884143928066e-05, 'B_xx_mean':
        4.829277569441745e-05, 'B_yy_mean': 4.825436940668801e-05,
        'B_xy_abs_mean': 6.97148156925233e-07},
    'spectEddyVisc': {'ke': 0.009158104658126831, 'ux_mean':
        0.13397084176540375, 'ux_wall_layers': 0.13301266729831696,
        'ux_centre_layers': 0.13413245975971222, 'nut_mean': 7.38329763407819e-05,
        'yplus_min': 26.3248, 'yplus_max': 42.3177, 'yplus_avg': 34.5993,
        'wall_shear_min': 7.09628e-05, 'wall_shear_max': 0.000183377},
}
COMP2_GOLDEN = {
    'RNGkEpsilon': {'U_mean': 0.012204513606576406, 'U_max':
        0.038655154505787125, 'T_mean': 301.3330490875244, 'T_min':
        275.9452209472656, 'T_max': 324.74951171875, 'p_mean': -287.7857470703125,
        'p_min': -287.8359375, 'p_max': -287.71875, 'k_mean':
        0.0010396913926903487, 'k_max': 0.003910318482667208, 'epsilon_mean':
        0.003494601587896145, 'epsilon_max': 0.027776913717389107, 'mut_mean':
        0.0005192619488615939, 'mut_max': 0.0016705828020349145},
    'realizableKE': {'U_mean': 0.025989455591032065, 'U_max':
        0.07483598078021994, 'T_mean': 301.32643964767453, 'T_min':
        275.76025390625, 'T_max': 325.0207214355469, 'p_mean': -296.546865234375,
        'p_min': -296.6171875, 'p_max': -296.4765625, 'k_mean':
        0.0012294868438941882, 'k_max': 0.0052091502584517, 'epsilon_mean':
        0.0042951561731605714, 'epsilon_max': 0.035561952739953995, 'mut_mean':
        0.00037169615499216794, 'mut_max': 0.0035291274543851614},
    'SpalartAllmaras': {'U_mean': 0.00455112552260575, 'U_max':
        0.01826061027047831, 'T_mean': 301.33143314361575, 'T_min':
        275.92083740234375, 'T_max': 324.7738037109375, 'p_mean':
        -490.4001513671875, 'p_min': -490.46875, 'p_max': -490.3125,
        'nuTilda_mean': 0.0003139085979599047, 'nuTilda_max':
        0.0007992331520654261, 'mut_mean': 3.6906329721070666e-05, 'mut_max':
        0.0002496341767255217},
    'LRR': {'U_mean': 0.00995556398828655, 'U_max': 0.03858749527905331,
        'T_mean': 301.357085609436, 'T_min': 275.9010009765625, 'T_max':
        324.9721984863281, 'p_mean': -293.728515625, 'p_min': -293.7734375,
        'p_max': -293.671875, 'k_mean': 0.0007191814027924105, 'k_max':
        0.0008240420720539987, 'epsilon_mean': 0.0009545340958656168,
        'epsilon_max': 0.004477839916944504, 'mut_mean': 0.0006879279384287798,
        'mut_max': 0.0016089818673208356, 'R_xx_mean': 0.00047931596908924235,
        'R_yy_mean': 0.0004795592476689321, 'R_xy_abs_mean':
        5.382712852608655e-06},
    'LaunderGibsonRSTM': {'U_mean': 0.010538205297848512, 'U_max':
        0.03935536965931561, 'T_mean': 301.3592337608337, 'T_min':
        275.8684997558594, 'T_max': 324.8792419433594, 'p_mean':
        -301.7566259765625, 'p_min': -301.796875, 'p_max': -301.6953125, 'k_mean':
        0.000707817924143983, 'k_max': 0.0008158661657944322, 'epsilon_mean':
        0.0009377086796979056, 'epsilon_max': 0.004402178339660168, 'mut_mean':
        0.0006694041049258958, 'mut_max': 0.0015763860428705812, 'R_xx_mean':
        0.0004570669940093972, 'R_yy_mean': 0.00045767602076351695,
        'R_xy_abs_mean': 1.0825403959665495e-05},
    'v2f': {'U_mean': 0.004852924051966671, 'U_max': 0.008826375075442107,
        'T_mean': 300.9123433113098, 'T_min': 273.20111083984375, 'T_max':
        326.7885437011719, 'p_mean': -449.86935546875, 'p_min': -449.9609375,
        'p_max': -449.765625, 'k_mean': 0.0008488609455923979, 'k_max':
        0.000930126232560724, 'epsilon_mean': 4.569990024766726e-05,
        'epsilon_max': 5.264738138066605e-05, 'mut_mean': 0.0015588323532916837,
        'mut_max': 0.0018078283173963428, 'v2_mean': 0.0004567235281386489,
        'v2_max': 0.0005903505370952189, 'f_mean': 0.001055842920214291, 'f_max':
        0.0019961579237133265},
    'dynOneEqEddy': {'U_mean': 0.005613267188206018, 'U_max':
        0.02397281494160085, 'T_mean': 301.34077547073366, 'T_min':
        273.627197265625, 'T_max': 326.63299560546875, 'p_mean':
        -3127.86177734375, 'p_min': -3127.9375, 'p_max': -3127.7578125, 'k_mean':
        0.00038652998988113836, 'k_max': 0.0004714821989182383, 'mut_mean':
        1.7470439517885015e-06, 'mut_max': 1.999843334488105e-06},
    'lowReOneEqEddy': {'U_mean': 0.005056174101082636, 'U_max':
        0.021073255292172775, 'T_mean': 301.3542510604858, 'T_min':
        274.3309020996094, 'T_max': 325.7226867675781, 'p_mean':
        -2596.5058935546876, 'p_min': -2596.5625, 'p_max': -2596.40625, 'k_mean':
        0.00038013164234346566, 'k_max': 0.00042775573092512786, 'mut_mean': 0.0,
        'mut_max': 0.0},
    'DeardorffDiffStress': {'U_mean': 0.005009397650457543, 'U_max':
        0.019650416600968588, 'T_mean': 301.3500489997864, 'T_min':
        273.9051818847656, 'T_max': 325.56402587890625, 'p_mean':
        -2719.7767187500003, 'p_min': -2719.84375, 'p_max': -2719.6796875,
        'k_mean': 0.0005287230972884406, 'k_max': 0.0005738565814681351,
        'mut_mean': 9.648100206055886e-06, 'mut_max': 1.0516697329876479e-05,
        'B_xx_mean': 0.0003526865787055718, 'B_yy_mean': 0.00035289574976475125,
        'B_xy_abs_mean': 5.921266040078804e-06},
}
TURB2_SPREAD = {'ras': {'LamBremhorstKE': {'ke': 7.12e-07,
                            'ux_centre_out': 1.5e-06,
                            'ux_centre_row': 2.7e-07,
                            'ux_wall_row': 2.98e-07,
                            'k_max': 3.51e-06,
                            'k_mean': 8.36e-07,
                            'epsilon_max': 1.68e-05,
                            'epsilon_mean': 3.85e-06,
                            'nut_max': 7.89e-06,
                            'nut_mean': 5.7e-07},
         'qZeta': {'ke': 5.03e-06,
                   'ux_centre_out': 7.74e-06,
                   'ux_centre_row': 3.96e-06,
                   'ux_wall_row': 1.31e-06,
                   'k_max': 5.55e-05,
                   'k_mean': 3.24e-06,
                   'epsilon_max': 6.08e-05,
                   'epsilon_mean': 4.81e-06,
                   'nut_max': 5.83e-05,
                   'nut_mean': 7.34e-06},
         'v2f': {'ke': 1.78e-06,
                 'ux_centre_out': 3.02e-06,
                 'ux_centre_row': 1.07e-06,
                 'ux_wall_row': 1.95e-07,
                 'k_max': 1.68e-05,
                 'k_mean': 1.18e-05,
                 'epsilon_max': 1.47e-05,
                 'epsilon_mean': 2.47e-06,
                 'nut_max': 4.34e-05,
                 'nut_mean': 4.86e-05,
                 'v2_mean': 1.28e-05,
                 'v2_max': 1.06e-05,
                 'f_mean': 2.25e-05,
                 'f_max': 6.37e-06},
         'LRR': {'ke': 2.72e-06,
                 'ux_centre_out': 1.57e-06,
                 'ux_centre_row': 1.64e-06,
                 'ux_wall_row': 6.57e-07,
                 'k_max': 1.32e-05,
                 'k_mean': 7.66e-07,
                 'epsilon_max': 1.88e-05,
                 'epsilon_mean': 1.16e-06,
                 'nut_max': 9.04e-06,
                 'nut_mean': 2.77e-07,
                 'R_xx_mean': 9.97e-07,
                 'R_yy_mean': 5.95e-07,
                 'R_xy_abs_mean': 8.17e-07},
         'LaunderGibsonRSTM': {'ke': 1.56e-06,
                               'ux_centre_out': 2.99e-06,
                               'ux_centre_row': 5.58e-07,
                               'ux_wall_row': 5.37e-07,
                               'k_max': 6.19e-06,
                               'k_mean': 1.15e-06,
                               'epsilon_max': 8.42e-06,
                               'epsilon_mean': 2.74e-06,
                               'nut_max': 1.09e-05,
                               'nut_mean': 3.98e-07,
                               'R_xx_mean': 1.38e-06,
                               'R_yy_mean': 6.97e-07,
                               'R_xy_abs_mean': 1.11e-06},
         'kOmegaSSTSAS': {'ke': 4.98e-06,
                          'ux_centre_out': 1.9e-06,
                          'ux_centre_row': 2.97e-06,
                          'ux_wall_row': 5.39e-07,
                          'k_max': 1.13e-05,
                          'k_mean': 8.64e-07,
                          'omega_max': 8.06e-07,
                          'omega_mean': 4.36e-07,
                          'nut_max': 7.61e-07,
                          'nut_mean': 8.93e-07},
         'NonlinearKEShih': {'ke': 1.28e-06,
                             'ux_centre_out': 2.56e-06,
                             'ux_centre_row': 5.84e-07,
                             'ux_wall_row': 1.79e-07,
                             'k_max': 1.59e-06,
                             'k_mean': 4.71e-07,
                             'epsilon_max': 2.13e-06,
                             'epsilon_mean': 6.7e-07,
                             'nut_max': 0.000104,
                             'nut_mean': 1.22e-05},
         'LienCubicKE': {'ke': 1.41e-06,
                         'ux_centre_out': 5.06e-06,
                         'ux_centre_row': 6.15e-07,
                         'ux_wall_row': 5.97e-08,
                         'k_max': 2.09e-06,
                         'k_mean': 5.89e-07,
                         'epsilon_max': 2.37e-06,
                         'epsilon_mean': 8.73e-07,
                         'nut_max': 9.66e-05,
                         'nut_mean': 2.29e-05},
         'LienCubicKELowRe': {'ke': 3.32e-06,
                              'ux_centre_out': 4.43e-06,
                              'ux_centre_row': 2.03e-06,
                              'ux_wall_row': 2.67e-07,
                              'k_max': 5.01e-06,
                              'k_mean': 2.73e-07,
                              'epsilon_max': 1.6e-06,
                              'epsilon_mean': 3.55e-07,
                              'nut_max': 6.34e-05,
                              'nut_mean': 2.43e-05},
         'LienLeschzinerLowRe': {'ke': 1.31e-06,
                                 'ux_centre_out': 3.29e-06,
                                 'ux_centre_row': 3.3e-07,
                                 'ux_wall_row': 2.39e-07,
                                 'k_max': 4.91e-06,
                                 'k_mean': 2.33e-07,
                                 'epsilon_max': 2.52e-06,
                                 'epsilon_mean': 2.44e-07,
                                 'nut_max': 3.17e-06,
                                 'nut_mean': 1.62e-07},
         'SpalartAllmarasIDDES': {'ke': 2.97e-06,
                                  'ux_centre_out': 9.61e-07,
                                  'ux_centre_row': 1.67e-06,
                                  'ux_wall_row': 3.58e-07,
                                  'nuTilda_max': 1.59e-05,
                                  'nuTilda_mean': 2.51e-06,
                                  'nut_max': 3.57e-05,
                                  'nut_mean': 8.81e-06},
         'kkLOmega': {'ke': 2.01e-06,
                      'ux_centre_out': 2.52e-06,
                      'ux_centre_row': 1.17e-06,
                      'ux_wall_row': 1.19e-07,
                      'omega_max': 3.75e-06,
                      'omega_mean': 2.17e-07,
                      'nut_max': 2.63e-05,
                      'nut_mean': 1.83e-06,
                      'kt_mean': 2.33e-07,
                      'kt_max': 2.73e-06,
                      'kl_mean': 4.83e-07,
                      'kl_max': 2.5e-06}},
 'les': {'dynLagrangian': {'ke': 4.29e-07,
                           'ux_mean': 3.76e-07,
                           'ux_wall_layers': 2.42e-07,
                           'ux_centre_layers': 1.35e-07,
                           'nut_mean': 2.6e-07,
                           'yplus_min': 0.0,
                           'yplus_max': 4.28e-06,
                           'yplus_avg': 0.0,
                           'wall_shear_min': 0.0,
                           'wall_shear_max': 1.79e-06,
                           'flm_mean': 1.31e-06,
                           'flm_max': 1.81e-06,
                           'fmm_mean': 1.25e-06,
                           'fmm_max': 1.04e-06},
         'locDynOneEqEddy': {'ke': 3.47e-07,
                             'ux_mean': 3.14e-07,
                             'ux_wall_layers': 1.49e-07,
                             'ux_centre_layers': 1.56e-07,
                             'nut_mean': 6.29e-07,
                             'yplus_min': 0.0,
                             'yplus_max': 0.0,
                             'yplus_avg': 0.0,
                             'wall_shear_min': 0.0,
                             'wall_shear_max': 1.48e-06,
                             'k_mean': 2.25e-07},
         'dynMixedSmagorinsky': {'ke': 4.52e-07,
                                 'ux_mean': 2.1e-07,
                                 'ux_wall_layers': 1.4e-07,
                                 'ux_centre_layers': 4.35e-07,
                                 'nut_mean': 0.0,
                                 'yplus_min': 0.0,
                                 'yplus_max': 0.0,
                                 'yplus_avg': 0.0,
                                 'wall_shear_min': 0.0,
                                 'wall_shear_max': 1.79e-06},
         'DeardorffDiffStress': {'ke': 4.13e-07,
                                 'ux_mean': 2.95e-07,
                                 'ux_wall_layers': 2.17e-07,
                                 'ux_centre_layers': 1.11e-07,
                                 'nut_mean': 1.9e-07,
                                 'yplus_min': 0.0,
                                 'yplus_max': 0.0,
                                 'yplus_avg': 0.0,
                                 'wall_shear_min': 0.0,
                                 'wall_shear_max': 0.0,
                                 'k_mean': 6.16e-07,
                                 'B_xx_mean': 6.12e-07,
                                 'B_yy_mean': 6.22e-07,
                                 'B_xy_abs_mean': 6.75e-07},
         'LRDDiffStress': {'ke': 3.37e-07,
                           'ux_mean': 3.24e-07,
                           'ux_wall_layers': 1.94e-07,
                           'ux_centre_layers': 1.36e-07,
                           'nut_mean': 1.91e-07,
                           'yplus_min': 5.14e-06,
                           'yplus_max': 0.0,
                           'yplus_avg': 0.0,
                           'wall_shear_min': 0.0,
                           'wall_shear_max': 0.0,
                           'k_mean': 6.73e-07,
                           'B_xx_mean': 6.12e-07,
                           'B_yy_mean': 6.12e-07,
                           'B_xy_abs_mean': 7.07e-07},
         'spectEddyVisc': {'ke': 3.93e-07,
                           'ux_mean': 3.56e-07,
                           'ux_wall_layers': 1.31e-07,
                           'ux_centre_layers': 1.46e-07,
                           'nut_mean': 2.94e-07,
                           'yplus_min': 0.0,
                           'yplus_max': 2.36e-06,
                           'yplus_avg': 0.0,
                           'wall_shear_min': 1.41e-06,
                           'wall_shear_max': 0.0}},
 'comp': {'RNGkEpsilon': {'U_mean': 0.433,
                          'U_max': 0.291,
                          'T_mean': 1.64e-05,
                          'T_min': 0.00106,
                          'T_max': 0.00333,
                          'p_mean': 0.668,
                          'p_min': 0.668,
                          'p_max': 0.669,
                          'k_mean': 0.0758,
                          'k_max': 0.261,
                          'epsilon_mean': 0.255,
                          'epsilon_max': 0.391,
                          'mut_mean': 0.00184,
                          'mut_max': 0.0948},
          'realizableKE': {'U_mean': 0.308,
                           'U_max': 0.395,
                           'T_mean': 1.49e-05,
                           'T_min': 0.00198,
                           'T_max': 0.00188,
                           'p_mean': 0.674,
                           'p_min': 0.673,
                           'p_max': 0.674,
                           'k_mean': 0.186,
                           'k_max': 0.254,
                           'epsilon_mean': 0.212,
                           'epsilon_max': 0.512,
                           'mut_mean': 0.192,
                           'mut_max': 0.305},
          'SpalartAllmaras': {'U_mean': 0.101,
                              'U_max': 0.0206,
                              'T_mean': 4.15e-05,
                              'T_min': 0.00238,
                              'T_max': 0.00242,
                              'p_mean': 0.8,
                              'p_min': 0.8,
                              'p_max': 0.801,
                              'nuTilda_mean': 0.00236,
                              'nuTilda_max': 0.00095,
                              'mut_mean': 0.0115,
                              'mut_max': 0.0153},
          'LRR': {'U_mean': 0.449,
                  'U_max': 0.329,
                  'T_mean': 7.34e-05,
                  'T_min': 0.00178,
                  'T_max': 0.00219,
                  'p_mean': 0.68,
                  'p_min': 0.68,
                  'p_max': 0.681,
                  'k_mean': 0.00135,
                  'k_max': 0.000394,
                  'epsilon_mean': 0.0015,
                  'epsilon_max': 0.00581,
                  'mut_mean': 0.00173,
                  'mut_max': 0.00114,
                  'R_xx_mean': 0.0019,
                  'R_yy_mean': 0.00104,
                  'R_xy_abs_mean': 0.243},
          'LaunderGibsonRSTM': {'U_mean': 0.339,
                                'U_max': 0.278,
                                'T_mean': 7.91e-05,
                                'T_min': 0.00183,
                                'T_max': 0.00189,
                                'p_mean': 0.689,
                                'p_min': 0.689,
                                'p_max': 0.689,
                                'k_mean': 0.00244,
                                'k_max': 0.0019,
                                'epsilon_mean': 0.00158,
                                'epsilon_max': 0.00754,
                                'mut_mean': 0.00438,
                                'mut_max': 0.00422,
                                'R_xx_mean': 0.00321,
                                'R_yy_mean': 0.00488,
                                'R_xy_abs_mean': 0.192},
          'v2f': {'U_mean': 0.051,
                  'U_max': 0.0701,
                  'T_mean': 0.00012,
                  'T_min': 2.85e-05,
                  'T_max': 9.94e-05,
                  'p_mean': 0.342,
                  'p_min': 0.342,
                  'p_max': 0.343,
                  'k_mean': 0.0035,
                  'k_max': 0.00645,
                  'epsilon_mean': 0.00517,
                  'epsilon_max': 0.0175,
                  'mut_mean': 0.00231,
                  'mut_max': 0.0069,
                  'v2_mean': 0.000889,
                  'v2_max': 0.00132,
                  'f_mean': 0.0147,
                  'f_max': 0.0291},
          'dynOneEqEddy': {'U_mean': 0.13,
                           'U_max': 0.24,
                           'T_mean': 0.000179,
                           'T_min': 0.0104,
                           'T_max': 0.00727,
                           'p_mean': 0.965,
                           'p_min': 0.965,
                           'p_max': 0.965,
                           'k_mean': 0.0572,
                           'k_max': 0.21,
                           'mut_mean': 0.00601,
                           'mut_max': 0.0569},
          'lowReOneEqEddy': {'U_mean': 0.0645,
                             'U_max': 0.132,
                             'T_mean': 0.00022,
                             'T_min': 0.00789,
                             'T_max': 0.00452,
                             'p_mean': 0.958,
                             'p_min': 0.958,
                             'p_max': 0.958,
                             'k_mean': 0.0418,
                             'k_max': 0.13,
                             'mut_mean': 0.0,
                             'mut_max': 0.0},
          'DeardorffDiffStress': {'U_mean': 0.388,
                                  'U_max': 0.256,
                                  'T_mean': 0.000226,
                                  'T_min': 0.00919,
                                  'T_max': 0.00388,
                                  'p_mean': 0.959,
                                  'p_min': 0.959,
                                  'p_max': 0.959,
                                  'k_mean': 0.0185,
                                  'k_max': 0.0853,
                                  'mut_mean': 0.0181,
                                  'mut_max': 0.0319,
                                  'B_xx_mean': 0.0192,
                                  'B_yy_mean': 0.0197,
                                  'B_xy_abs_mean': 0.175}}}
DIFF_HEAD_K0 = 1.8e-5         # m^2/s^2, 1e-3 |Ubar|^2
DIFF_HEAD_WARMUP = 2
DIFF_HEAD_TRIALS = 2
DIFF_HEAD_CHUNK = 3
DIFF_HEAD_PROFILE = 1
HEAD_POLY = {}                # les_headline's host mesh, for diffstress


def turb2_scalars(a, v, names=TURB2_FIELDS):
    """The golden scalars of the fields `names` of a run's arrays: volume
    mean and largest value; of a symmetric tensor (R, B) the volume means
    of xx, of yy and of |xy|."""
    w = np.asarray(v, np.float64) / np.sum(v)
    out = {}
    for name in names:
        if name not in a:
            continue
        x = np.asarray(a[name], np.float64)
        if x.ndim == 2:
            out.update({f"{name}_xx_mean": float(x[:, 0] @ w),
                        f"{name}_yy_mean": float(x[:, 3] @ w),
                        f"{name}_xy_abs_mean": float(np.abs(x[:, 1]) @ w)})
        else:
            out.update({f"{name}_mean": float(x @ w),
                        f"{name}_max": float(x.max())})
    return out


def turb2_run_scalars(kind, final_state, v, case_dir, host):
    """A turbulence_models2 run's golden scalars from its final state:
    the RAS channel's (ras_channel_scalars), channel395's
    (les_channel_scalars) or hotCavity's (comp_scalars), with
    turb2_scalars of the fields the models carry."""
    a = turbulence_arrays(final_state, host)
    if kind == "ras":
        return dict(ras_channel_scalars(a, v), **turb2_scalars(a, v))
    if kind == "les":
        return dict(les_channel_scalars(a, v, case_dir),
                    **turb2_scalars(a, v))
    c = comp_arrays(final_state, host)
    return dict(comp_scalars(c, v), **turb2_scalars(a, v, COMP2_FIELDS))


def turb2_tolerance(key, spread):
    return max(TURB_GOLDEN_TOL, TURB2_TOL_SPREAD * spread.get(key, 0.0))


def stress_oracles(name, a):
    """The stress-transport oracles: positive normal components and
    k = tr/2 to 1e-5 (relative)."""
    if name not in STRESS_MODELS:
        return {}
    T = a[STRESS_MODELS[name]]
    k = a["k"]
    return {"normal stresses > 0": bool((T[:, [0, 3, 5]] > 0).all()),
            "k = tr/2 (1e-5)": bool(np.allclose(
                k, 0.5 * T[:, [0, 3, 5]].sum(axis=1), rtol=1e-5, atol=0.0))}


def turbulence2_oracles(name, a, nu):
    """turbulence_oracles (nut >= 0 or mut >= 0, positive k, epsilon,
    omega, nuTilda; here also kt, kl and v2), the stress oracles, and nut
    above nu somewhere for the RAS stress models alone (as
    test_rstm_channel)."""
    b = dict(a)
    if "mut" in b:
        b["nut"] = b["mut"]
    ck = turbulence_oracles(name, b, nu)
    ck.pop("nut > nu somewhere", None)
    if name in ("LRR", "LaunderGibsonRSTM") and "mut" not in a:
        ck["nut > nu somewhere"] = bool(a["nut"].max() > nu)
    for f in ("kt", "kl", "v2"):
        if f in a:
            ck[f"{f} > 0"] = bool(a[f].min() > 0.0)
    ck.update(stress_oracles(name, a))
    return ck


class StressLog(SolveLog):
    """A SolveLog for the stress-transport models, whose k carries the
    dimensions of R (B) and is not solved: the solve whose unknown has six
    columns is named `wide`, every other by its dimensions, and one of
    other dimensions (a PISO start's pcorr) "other"."""

    def __init__(self, state, wide, fence=False, ranges=False):
        turb = {k: f for k, f in state["turb"].items()
                if k not in ("k", wide)}
        super().__init__(dict(state, turb=turb), fence, ranges)
        self.wide = wide
        for name in (wide, "other"):
            self.calls[name], self.seconds[name] = 0, 0.0
            self.iterations[name] = []

    def _name(self, mat):
        if mat.source.ndim == 2 and mat.source.shape[1] == 6:
            return self.wide
        return self.names.get(mat.dims, "other")


def constant_rho_pairs(root, device="cuda"):
    """tests/test_turbulence_compressible2.py::test_constant_rho_parity on
    the port: on the RAS channel with that test's state
    (tests/test_turbulence.py::channel_fields: U = (1 0 0), k, epsilon
    their inlet values, nut 0, everywhere; mut = nut, nuTilda 1e-3, R and
    B = (2/3) k I, v2 = (2/3) k and f = 0 beside them) with rho = 1 and
    the solenoidal flux of U, one correct_rho of each compressible twin
    of RHO_PAIRS against one correct of its incompressible model: every
    transported field, and mut against nut, at RHO_PAIR_TOL (atol 1e-10;
    mut 1e-12). The state is that test's: the incompressible oneEqEddy
    family convects k with the default face weights and its compressible
    twins with div(phi,k)'s, so where k varies, a seeded k or an outlet
    fixed at 0, the dynOneEqEddy pair differs past 1e-3 in both packages
    (ROADMAP Queue 3). Returns {model: {field: max relative error}, ...}
    with each model's "ok"."""
    from foamtpu_torch.apps.cli import main as cli
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.core.dictionary import parse_string
    from foamtpu_torch.models.turbulence import base
    from foamtpu_torch.solvers import piso

    dst = ras_channel_case(os.path.join(root, "rho_pairs"), "RNGkEpsilon",
                           steps=1)
    with open(os.path.join(dst, "0", "nut")) as f:
        nut_text = f.read()
    _write_text(dst, "0/mut", nut_text.replace("object nut;", "object mut;"))
    n = 300
    empty = "frontAndBack { type empty; }"
    zero_g = _rows(f"{p} {{ type zeroGradient; }}"
                   for p in ("inlet", "outlet", "walls")) + "\n" + empty
    fixed = _rows(["inlet { type fixedValue; value uniform %r; }",
                   "outlet { type zeroGradient; }",
                   "walls { type fixedValue; value uniform 0; }", empty])
    sc = ras_channel_scales()
    set_internal(dst, "U", np.tile([1.0, 0.0, 0.0], (n, 1)))
    for name in ("k", "epsilon"):
        set_internal(dst, name, np.full(n, sc[name]))
        # that test's outlet: inletOutlet on outflow (valueFraction 0);
        # read from a file it starts fixed at its inletValue
        _edit(os.path.join(dst, "0", name), r"outlet \{[^}]*\}",
              "outlet { type zeroGradient; }")
    write_field(dst, "nuTilda", _DIMS["nuTilda"], 1e-3, fixed % 1e-3)
    with quiet():
        check(cli(["blockMesh", "-case", dst]) == 0, "blockMesh failed")
    case = Case(dst, device=device)
    mesh = case.mesh
    k = case.read_field("k").data.double().cpu().numpy()
    T6 = np.zeros((n, 6))
    T6[:, [0, 3, 5]] = (2.0 / 3.0) * k[:, None]
    for name in ("R", "B"):
        write_field(dst, name, _DIMS[name], T6, zero_g)
    v20 = (2.0 / 3.0) * float(k[0])
    write_field(dst, "v2", _DIMS["v2"], v20, fixed % v20)
    write_field(dst, "f", _DIMS["f"], 0.0, _rows([
        "inlet { type zeroGradient; }", "outlet { type zeroGradient; }",
        "walls { type fixedValue; value uniform 0; }", empty]))
    fields = {f: case.read_field(f) for f in (
        "U", "p", "k", "epsilon", "nut", "mut", "nuTilda", "R", "B", "v2",
        "f")}
    U = fields["U"]
    phi = piso.initial_state(mesh, U, fields["p"])["phi"]
    rho = torch.ones_like(mesh.v)
    out = {}
    for name, solved in RHO_PAIRS.items():
        kind = "LES" if name in ("dynOneEqEddy",
                                 "DeardorffDiffStress") else "RAS"
        props = parse_string(f"{kind}Model {name}; turbulence on;")
        inc = base.select(props, RAS_CHANNEL_NU, kind=kind)
        comp = base.select(props, RAS_CHANNEL_NU, kind=kind,
                           compressible=True)
        for m in (inc, comp):
            if hasattr(m, "init_wall_distance"):
                m.init_wall_distance(case.poly_mesh, mesh.v.dtype,
                                     device=device)
        ti = {f: fields[f] for f in solved}
        tc = dict(ti, mut=fields["mut"])
        ti["nut"] = fields["nut"]
        new_i, _ = inc.correct(mesh, ti, U, phi, 0.01)
        new_c, _ = comp.correct_rho(mesh, tc, U, phi, rho, 0.01)
        tol = RHO_PAIR_TOL[kind]
        rec, ok = {}, comp.name == f"compressible::{name}"
        for f, other, atol in [(f, f, 1e-10) for f in solved] + [
                ("mut", "nut", 1e-12)]:
            a, b = new_c[f].data, new_i[other].data
            ok = ok and bool(torch.isfinite(a).all()) and bool(
                torch.allclose(a, b, rtol=tol, atol=atol))
            rec[f] = float(((a - b).abs() / (b.abs() + atol)).max())
        rec["ok"] = ok
        out[name] = rec
    return out


def phase_turbulence_models2(spmv, here, root, flush):
    """The 27 models of ras2.py to ras5.py, les3.py, les4.py and
    compressible2.py, each from case files through run(case) on the card
    (float32), the counts set to 0 before each run: the twelve RAS models
    on the RAS channel (ras_channel_case, RAS_CHANNEL_CARD_P's GAMG p,
    RAS2_STEPS pisoFoam steps), the six LES models on channel395
    (les_channel_case, LES2_STEPS channelFoam steps, yPlus and
    wallShearStress) and the nine compressible models on hotCavity
    (comp2_case, COMP2_STEPS buoyantPimpleFoam steps). Each held to
    goldens from the JAX package (RAS2_GOLDEN, LES2_GOLDEN, COMP2_GOLDEN
    at turb2_tolerance) and to the reference tests' oracles
    (turbulence2_oracles, continuity < 1e-3 per unit step on the
    incompressible cases, comp_invariants on hotCavity); the constant-rho
    twins (constant_rho_pairs); and the SpMV kernel held to its plain
    version at LRR's R operand [300, 6] (float32, float64) and timed
    there."""
    from foamtpu_torch.apps.cli import main as cli
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.core.dictionary import dimensioned_scalar

    def host(t):
        return t.double().cpu().numpy()

    results, checks = {}, {}
    launches_total = fb_total = 0
    lrr = {}
    runs = ([("ras", m) for m in RAS2_CHANNEL_MODELS]
            + [("les", m) for m in LES2_MODELS]
            + [("comp", m) for m in COMP2_MODELS])
    for kind, model in runs:
        dst = os.path.join(root, kind, model)
        if kind == "ras":
            steps = RAS2_DEPTH.get(model, RAS2_STEPS)
            ras_channel_case(dst, model, steps=steps,
                             p_solver=RAS_CHANNEL_CARD_P)
            golden = RAS2_GOLDEN[model]
        elif kind == "les":
            les_channel_case(here, dst, model, steps=LES2_STEPS,
                             funcs=LES_FUNCS)
            steps, golden = LES2_STEPS, LES2_GOLDEN[model]
        else:
            comp2_case(here, dst, model, cli)
            steps, golden = COMP2_STEPS, COMP2_GOLDEN[model]
        if kind != "comp":
            with quiet():
                check(cli(["blockMesh", "-case", dst]) == 0,
                      "blockMesh failed")
        case = Case(dst, device="cuda")
        log = contextlib.nullcontext()
        if (kind, model) == ("ras", "LRR"):
            # keeps the first R matrix, the kernel's [300, 6] operand
            fields = {f: case.read_field(f) for f in ("U", "p", "R",
                                                      "epsilon", "nut")}
            log = StressLog({"U": fields.pop("U"), "p": fields.pop("p"),
                             "turb": fields}, "R")
        with log:
            run_s, text, launches, fb = app_run(spmv, case, steps)
        if (kind, model) == ("ras", "LRR"):
            lrr.update(mesh=case.mesh, mat=log.matrices["R"])
        launches_total += launches
        fb_total += fb
        st = case.final_state
        v = host(case.mesh.v)
        a = turbulence_arrays(st, host)
        if kind == "comp":
            nu = 0.0          # (no "nut > nu" oracle on hotCavity)
            ck = comp_invariants("buoyantPimpleFoam",
                                 comp_arrays(st, host), None, v, text)
        else:
            _, nu = dimensioned_scalar(case.transport_properties()["nu"])
            dt = RAS_CHANNEL_DT if kind == "ras" else 0.02
            cont = max(log_continuity(text)) / dt
            ck = {"continuity < 1e-3": cont < 1e-3}
        ck.update(turbulence2_oracles(model, a, nu))
        if kind == "les":
            ck["|U| < 3"] = bool(np.abs(a["U"]).max() < 3.0)
        got = turb2_run_scalars(kind, st, v, dst, host)
        spread = TURB2_SPREAD[kind][model]
        floor = (dict(COMP_FLOOR, **TURB2_FLOOR) if kind == "comp"
                 else TURB2_FLOOR)
        rel = golden_rel_err(got, golden, floor)
        tol = {k: turb2_tolerance(k, spread) for k in golden}
        ck.update({f"golden {k}": rel[k] <= tol[k] for k in golden})
        ck["steps"] = case.time.index == steps
        ck["spmv launched"] = launches > 0
        results[f"{kind}/{model}"] = {
            "n_cells": case.mesh.n_cells, "steps": case.time.index,
            "run_s": run_s, "sec_per_step": run_s / max(case.time.index, 1),
            "spmv_launches": launches, "spmv_fb_launches": fb,
            "iterations_max": {k: max(x) for k, x in
                               solve_iterations(text).items()},
            "scalars": got, "golden_rel_err": rel,
            "golden_share_of_tol": max(rel[k] / tol[k] for k in golden)}
        checks.update({f"{kind}/{model} {k}": x for k, x in ck.items()})
        progress("turbulence_models2", f"{kind}/{model}: {run_s:.1f} s, "
                 f"{launches} SpMV launches")

    pairs = constant_rho_pairs(os.path.join(root, "pairs"))
    checks.update({f"constant rho: compressible::{m} = {m}": r["ok"]
                   for m, r in pairs.items()})

    # the kernel at LRR's R operand: one matrix, six columns
    mesh, mat = lrr["mesh"], lrr["mat"]
    ops = [("ras_channel_R6", mat.soff, mat.diag_eff(mesh), mat.sfb)]
    deltas = tuple(mesh.st_deltas)
    cases, max_err = [], 0.0
    for dtype in (torch.float32, torch.float64):
        err = check_operands(spmv, ops, mesh, deltas, dtype,
                             np.random.default_rng(141), cases)
        if dtype == torch.float32:
            max_err = err
    _, soff, diag_r, _ = ops[0]
    checks["R operand is [300, 6]"] = tuple(diag_r.shape) == (300, 6)
    timings = time_shape(spmv, "ras_channel_R6", diag_r.contiguous(),
                         operand_x(diag_r, 142), soff.contiguous(), deltas,
                         flush)
    out = {"phase": "turbulence_models2", "dtype": "torch.float32",
           "runs": results, "constant_rho_pairs": pairs,
           "kernel_cases": cases, "max_abs_err_f32": max_err,
           "timings": timings, "spmv_launches_total": launches_total,
           "spmv_fb_launches_total": fb_total, "checks": checks}
    emit(out)
    for name, ok in checks.items():
        check(ok, f"turbulence_models2 check {name}: {out}")
    return out, max_err, timings


def write_binary_field(case_dir, name, cls, dims, internal, boundary):
    """0/<name> in binary format: the internal field's float64 values as
    one List (a field of 786,432 cells reads in a fraction of a second)."""
    a = np.ascontiguousarray(internal, dtype="<f8")
    kind = {1: "scalar", 3: "vector", 6: "symmTensor"}[
        1 if a.ndim == 1 else a.shape[1]]
    head = ("FoamFile { version 2.0; format binary; "
            f"class {cls}; object {name}; }}\n"
            f"dimensions {dims};\ninternalField nonuniform List<{kind}> "
            f"{a.shape[0]}(")
    with open(os.path.join(case_dir, "0", name), "wb") as f:
        f.write(head.encode() + a.tobytes() + b");\n"
                + f"boundaryField\n{{\n{boundary}\n}}\n".encode())


def diffstress_case(here, root, blocks=None, seed=None):
    """channel395 with its block at `blocks` (LES_HEAD_BLOCKS where None)
    under DeardorffDiffStress, as
    case files: 0/B = (2/3) k0 I (binary) and 0/k = k0 with
    k0 = DIFF_HEAD_K0, zeroGradient walls as
    tests/test_turbulence4.py::_with_B; B and k take the tutorial's U
    controls (fvSolution "(B|k)"); div(phi,k) and div(phi,B)
    limitedLinear 1; endTime for the headline's steps, writeFormat
    binary. With `seed`, meshed by blockMesh and U = Ubar plus
    les_headline's 10% perturbation drawn by numpy at `seed` (the CPU
    rehearsal); without, no polyMesh (the headline gives the Case
    les_headline's host mesh and draws U on the card)."""
    blocks = blocks or LES_HEAD_BLOCKS
    solver_u = ("U      { solver PBiCGStab; tolerance 1e-06; relTol 0.1; "
                "maxIter 300; }")
    edits = [("system/blockMeshDict", "(24 16 8)",
              "({} {} {})".format(*blocks)),
             ("constant/LESProperties", "LESModel        Smagorinsky;",
              "LESModel        DeardorffDiffStress;"),
             ("system/fvSchemes", "div(phi,U) Gauss linear;",
              "div(phi,U) Gauss linear; div(phi,k) Gauss limitedLinear 1; "
              "div(phi,B) Gauss limitedLinear 1;"),
             ("system/fvSolution", solver_u, solver_u
              + '\n    "(B|k)" { solver PBiCGStab; tolerance 1e-06; '
              "relTol 0.1; maxIter 300; }"),
             # room for the headline's 12 steps; its fields (B: 37.7 MB)
             # written in binary
             ("system/controlDict", "endTime         0.2;",
              "endTime         {!r};".format(0.02 * (
                  DIFF_HEAD_WARMUP + DIFF_HEAD_TRIALS * DIFF_HEAD_CHUNK
                  + DIFF_HEAD_PROFILE))),
             ("system/controlDict", "writeFormat     ascii;",
              "writeFormat     binary;")]
    dst = copy_case(here, CHANNEL395_CASE, root,
                    "channel_diffstress_{}x{}x{}".format(*blocks),
                    edits=edits, mesh=seed is not None)
    n = blocks[0] * blocks[1] * blocks[2]
    cyclic = _rows(f"{p} {{ type cyclic; }}"
                   for p in ("inlet", "outlet", "front", "back"))
    walls = cyclic + "\nwalls { type zeroGradient; }"
    B = np.zeros((n, 6))
    B[:, [0, 3, 5]] = (2.0 / 3.0) * DIFF_HEAD_K0
    write_binary_field(dst, "B", "volSymmTensorField", _DIMS["B"], B, walls)
    write_field(dst, "k", _DIMS["k"], DIFF_HEAD_K0, walls)
    if seed is not None:
        ubar = np.array([0.1335, 0.0, 0.0])
        U = ubar + 0.1 * np.linalg.norm(ubar) * np.random.default_rng(
            seed).standard_normal((n, 3))
        write_binary_field(dst, "U", "volVectorField", "[0 1 -1 0 0 0 0]",
                           U, cyclic + "\nwalls { type fixedValue; value "
                           "uniform (0 0 0); }")
    return dst


def phase_diffstress_headline(spmv, here, root, flush):
    """channel395 at LES_HEAD_BLOCKS (786,432 cells) under
    DeardorffDiffStress: the geometry, cyclic pairs, schemes and deltaT
    as shipped, U = Ubar plus les_headline's 10% perturbation drawn on the
    card from a torch.Generator, B and k as `diffstress_case` writes
    them, the Case on les_headline's host mesh (no second blockMesh):
    DIFF_HEAD_WARMUP steps through run(case), DIFF_HEAD_TRIALS timed
    chunks of DIFF_HEAD_CHUNK steps of the application's step (the B
    solve fenced for its host ms), the SpMV kernel held to its plain
    version at the B operand [786432, 6] (float32, float64) and timed
    there, and last one profiled step (the B solve's device ms). Held to
    the oracles of tests/test_turbulence4.py::test_les_batch4_channel:
    finite, nut >= 0, |U| < 3, B's normal components > 0, k = tr(B)/2,
    continuity < 1e-3 after every step."""
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.core.dictionary import dimensioned_scalar
    from foamtpu_torch.solvers import apps, pimple
    from foamtpu_torch.solvers.apps import run

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dst = diffstress_case(here, root)
    case = Case(dst, device="cuda")
    case._poly = HEAD_POLY.pop("poly")
    mesh = case.mesh
    n = LES_HEAD_BLOCKS[0] * LES_HEAD_BLOCKS[1] * LES_HEAD_BLOCKS[2]
    check(mesh.n_cells == n, mesh.n_cells)
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
    progress("diffstress_headline", f"set-up {setup_s:.1f} s, {n} cells")
    spmv.LAUNCHES = spmv.FB_LAUNCHES = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        run(case, max_steps=DIFF_HEAD_WARMUP)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_text = log.getvalue()
    warm_its = solve_iterations(warm_text)
    progress("diffstress_headline", f"warm-up {warm_s:.1f} s, iterations "
             f"{warm_its}")
    _, nu = dimensioned_scalar(case.transport_properties()["nu"])
    model, _ = apps._load_turbulence(case, nu)
    cfg = apps._pimple_config(case, nu, model)
    step = pimple.make_step(mesh, cfg)
    state = case.final_state
    dt = case.time.delta_t
    conts = [float(x) / dt for x in log_continuity(warm_text)]

    def chunk_of(k):
        def chunk(st):
            diag = None
            for _ in range(k):
                st, diag = step(st, dt)
                conts.append(float(diag["continuity"]))
            return st, diag
        return chunk

    chunk = chunk_of(DIFF_HEAD_CHUNK)
    secs = []
    l0 = spmv.LAUNCHES
    with StressLog(state, "B", fence=True) as tlog:
        for _ in range(DIFF_HEAD_TRIALS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, diag = chunk(state)
            torch.cuda.synchronize()
            secs.append((time.perf_counter() - t0) / DIFF_HEAD_CHUNK)
    steps_timed = DIFF_HEAD_TRIALS * DIFF_HEAD_CHUNK
    launches_per_step = (spmv.LAUNCHES - l0) / steps_timed
    sec = statistics.median(secs)
    progress("diffstress_headline", f"timed chunks {secs}")
    launches, fb_launches = spmv.LAUNCHES, spmv.FB_LAUNCHES
    bmat = tlog.matrices["B"]
    ops = [("channel_B6", bmat.soff, bmat.diag_eff(mesh), bmat.sfb)]
    deltas = tuple(mesh.st_deltas)
    cases, max_err = [], 0.0
    for dtype in (torch.float32, torch.float64):
        err = check_operands(spmv, ops, mesh, deltas, dtype,
                             np.random.default_rng(143), cases)
        if dtype == torch.float32:
            max_err = err
    _, soff, diag_b, sfb = ops[0]
    timings = time_shape(
        spmv, "channel_B6", diag_b.contiguous(), operand_x(diag_b, 144),
        soff.contiguous(), deltas, flush,
        fb=mesh_remainder(spmv, mesh, sfb, diag_b.dtype))
    l1, f1 = spmv.LAUNCHES, spmv.FB_LAUNCHES
    _, prof = profile_chunk(spmv, "diffstress_headline_profile", mesh,
                            chunk_of(DIFF_HEAD_PROFILE), state,
                            DIFF_HEAD_PROFILE, sec,
                            log=StressLog(state, "B", ranges=True))
    launches += spmv.LAUNCHES - l1
    fb_launches += spmv.FB_LAUNCHES - f1
    turb = state["turb"]
    u = state["U"].data
    B = turb["B"].data
    k = turb["k"].data
    nut = turb["nut"].data
    n_fb = int(mesh.fb_cells.shape[0])
    b_its = [int(i) for i in tlog.iterations["B"]]
    out = {"phase": "diffstress_headline",
           "case": f"channelFoam channel395, block {LES_HEAD_BLOCKS}: the "
                   "tutorial's geometry, cyclic pairs, schemes and deltaT "
                   "under DeardorffDiffStress",
           "n_cells": n, "dtype": str(mesh.v.dtype), "coo_entries": n_fb,
           "setup_s": setup_s, "warmup_s": warm_s,
           "warmup_iterations": warm_its,
           "sec_per_step": sec, "sec_per_step_trials": secs,
           "m_cells_per_sec": n / sec / 1e6,
           "spmv_launches_per_step": launches_per_step,
           "cuda_launch_kernel_per_step": prof["cuda_launch_kernel_per_iter"],
           "device_ms_per_step": prof["device_ms_per_iter"],
           "device_busy_share": prof["device_busy_share_unprofiled"],
           "spmv_device_ms_per_step": prof["spmv_device_ms_per_iter"],
           "B_iterations": b_its,
           "B_host_ms_per_solve": 1e3 * tlog.seconds["B"]
           / max(tlog.calls["B"], 1),
           "B_solve_profile": prof["solves"].get("B"),
           "p_iterations": [int(i) for i in tlog.iterations["p"]],
           "continuity_per_step": conts,
           "u_max": float(torch.linalg.norm(u, dim=1).max()),
           "nut_mean": float(nut.mean()), "k_mean": float(k.mean()),
           "spmv_launches_total": launches,
           "spmv_fb_launches_total": fb_launches,
           "kernel_cases": cases, "max_abs_err_f32": max_err,
           "timings": timings,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    normals = B[:, [0, 3, 5]]
    checks = {"finite": bool(torch.isfinite(u).all()
                             and torch.isfinite(B).all()
                             and torch.isfinite(nut).all()),
              "nut >= 0": bool(nut.min() >= 0),
              "|U| < 3": bool(u.abs().max() < 3.0),
              "B normal components > 0": bool(normals.min() > 0),
              "k = tr(B)/2 (1e-5)": bool(torch.allclose(
                  k, 0.5 * normals.sum(dim=1), rtol=1e-5, atol=0.0)),
              "continuity < 1e-3 every step": max(conts) < 1e-3,
              "B operand is [786432, 6]": tuple(diag_b.shape) == (n, 6),
              "the remainder carries the wrap faces": n_fb > 0
              and fb_launches > 0,
              "B solved every step": tlog.calls["B"] == steps_timed,
              "spmv launched": launches > 0}
    out["checks"] = checks
    emit(out)
    for name, ok in checks.items():
        check(ok, f"diffstress_headline check {name}: {out}")
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
# the compressible family: its tutorials and their case writer
# ---------------------------------------------------------------------------

COMP_TUTORIALS = {
    "rhoPimpleFoam": ("compressible", "rhoPimpleFoam", "heatedDuct"),
    "rhoSimpleFoam": ("compressible", "rhoSimpleFoam", "heatedDuct"),
    "rhoSimplecFoam": ("compressible", "rhoSimplecFoam", "heatedDuct"),
    "rhoPimplecFoam": ("compressible", "rhoPimplecFoam", "heatedDuct"),
    "rhoPorousSimpleFoam": ("compressible", "rhoPorousSimpleFoam",
                            "porousDuct"),
    "rhoPorousMRFSimpleFoam": ("compressible", "rhoPorousMRFSimpleFoam",
                               "porousDuct"),
    "rhoPorousMRFPimpleFoam": ("compressible", "rhoPorousMRFPimpleFoam",
                               "porousDuct"),
    "rhoPorousMRFLTSPimpleFoam": ("compressible",
                                  "rhoPorousMRFLTSPimpleFoam", "porousDuct"),
    "sonicFoam": ("compressible", "sonicFoam", "forwardStep"),
    "rhoCentralFoam": ("compressible", "rhoCentralFoam", "forwardStep"),
    "rhoCentralDyMFoam": ("compressible", "rhoCentralDyMFoam", "movingStep"),
    "buoyantSimpleFoam": ("heatTransfer", "buoyantSimpleFoam",
                          "buoyantCavity"),
    "buoyantPimpleFoam": ("heatTransfer", "buoyantPimpleFoam", "hotCavity"),
    "LTSInterFoam": ("multiphase", "LTSInterFoam", "damBreak"),
}
COMP_SEED = 5
COMP_SEED_U = 0.05            # of the shipped |U| (0.01 m/s at rest)
COMP_SEED_T = 0.01            # of the shipped T


def _edit(path, pattern, repl, count=0):
    """A regex edit of a case file that must change it."""
    with open(path) as f:
        text = f.read()
    new = re.sub(pattern, repl, text, count=count)
    check(new != text, f"{path}: no match for {pattern!r}")
    with open(path, "w") as f:
        f.write(new)


def compressible_case(here, dst, app, cli, seed=None, scale=None,
                      delta_t=None, write_precision=None, max_delta_t=None,
                      device=()):
    """The tutorial of `app` (COMP_TUTORIALS) copied to dst and meshed by
    `cli`'s blockMesh (cli None: not meshed, see `memory_mesh`);
    LTSInterFoam's damBreak also gets setFields (`device` passed on).
    `scale` multiplies the x and y cell counts of every block (0.25
    coarsens forwardStep 4x per direction, 32 refines heatedDuct);
    `delta_t` replaces the controlDict's deltaT, `write_precision` and
    `max_delta_t` set its writePrecision and maxDeltaT; `seed` starts U
    from
    U0 + COMP_SEED_U max(|U0|, 0.01) n (x and y) and T from
    T0 (1 + COMP_SEED_T u), n and u drawn cell by cell from numpy's
    generator: the tutorials ship uniform U and T, where a TVD limiter
    (limitedLinear) is a ratio of round-off and upwind weights take the
    sign of round-off. Returns dst."""
    shutil.copytree(os.path.join(here, "tutorials", *COMP_TUTORIALS[app]),
                    dst)
    if scale not in (None, 1):
        def blocks(m):
            nx, ny, nz = (int(x) for x in m.group(2).split())
            return (f"{m.group(1)}({max(int(round(nx * scale)), 1)} "
                    f"{max(int(round(ny * scale)), 1)} {nz})")
        _edit(os.path.join(dst, "constant", "polyMesh", "blockMeshDict"),
              r"(hex\s*\([^)]*\)\s*)\(([^)]*)\)", blocks)
    if delta_t is not None:
        _edit(os.path.join(dst, "system", "controlDict"),
              r"deltaT\s+[^;]+;", f"deltaT {delta_t!r};", count=1)
    for key, val in (("writePrecision", write_precision),
                     ("maxDeltaT", max_delta_t)):
        if val is not None:
            with open(os.path.join(dst, "system", "controlDict"), "a") as f:
                f.write(f"\n{key} {val!r};\n")
    if cli is not None:
        with quiet():
            check(cli(["blockMesh", "-case", dst]) == 0, "blockMesh failed")
            if app == "LTSInterFoam":
                check(cli(["setFields", "-case", dst, *device]) == 0,
                      "setFields failed")
    if seed is not None:
        from foamtpu_torch.core.case import Case

        case = Case(dst, device="cpu")
        n = case.mesh.n_cells
        rng = np.random.default_rng(seed)
        u0 = case.read_field("U").data.double().numpy()
        u = u0.copy()
        u[:, :2] += (COMP_SEED_U * max(float(np.abs(u0).max()), 0.01)
                     * rng.standard_normal((n, 2)))
        set_internal(dst, "U", u)
        t0 = case.read_field("T").data.double().numpy()
        set_internal(dst, "T", t0 * (1.0 + COMP_SEED_T * rng.random(n)))
    return dst


# the cases of the slice's f64 parity tests (tests/test_torch_rho*.py,
# test_torch_buoyantrho.py, test_torch_interfoam.py): name -> (app,
# compressible_case options)
SLICE10_CASES = {
    "rhoPimpleFoam": ("rhoPimpleFoam", {"seed": COMP_SEED}),
    "rhoSimpleFoam": ("rhoSimpleFoam", {"seed": COMP_SEED}),
    "rhoPimplecFoam": ("rhoPimplecFoam", {"seed": COMP_SEED}),
    "rhoPorousSimpleFoam": ("rhoPorousSimpleFoam", {"seed": COMP_SEED}),
    "rhoPorousMRFPimpleFoam": ("rhoPorousMRFPimpleFoam",
                               {"seed": COMP_SEED}),
    # forwardStep coarsened 4x per direction (1,008 cells)
    "sonicFoam": ("sonicFoam", {"seed": COMP_SEED, "scale": 0.25}),
    "rhoCentralFoam": ("rhoCentralFoam", {"scale": 0.25}),
    "rhoCentralDyMFoam": ("rhoCentralDyMFoam", {"scale": 0.25}),
    "buoyantSimpleFoam": ("buoyantSimpleFoam", {"seed": COMP_SEED}),
    "buoyantPimpleFoam": ("buoyantPimpleFoam", {"seed": COMP_SEED}),
    # the tutorial as shipped sets no maxDeltaT, so the local time step of
    # the still water is 1e6 s and |U| reaches 3e11 in the first step, in
    # both packages: the parity case caps it at the tutorial's deltaT
    "LTSInterFoam": ("LTSInterFoam", {"max_delta_t": 0.001}),
}


def slice10_case(here, dst, name, cli, device=()):
    """The case `name` of SLICE10_CASES, fields written with 17 digits."""
    app, opts = SLICE10_CASES[name]
    return compressible_case(here, dst, app, cli, device=device,
                             write_precision=17, **opts)


# the models of compressible2.py and the dictionary that names each
COMP2_MODELS = {"RNGkEpsilon": "RAS", "realizableKE": "RAS",
                "SpalartAllmaras": "RAS", "LRR": "RAS",
                "LaunderGibsonRSTM": "RAS", "v2f": "RAS",
                "dynOneEqEddy": "LES", "lowReOneEqEddy": "LES",
                "DeardorffDiffStress": "LES"}
COMP2_WALLS = ("hotWall", "coldWall", "adiabatic")   # the cavities' walls


def comp2_fields(dst, model, seed=14):
    """Turn a cavity case (hotCavity, buoyantCavity: k, epsilon, mut and
    alphat under 0/) into one of compressible::`model`: RASProperties or
    LESProperties (delta cubeRootVol) naming it, and the fields it
    carries besides, as tests/test_turbulence_compressible2.py::_states_for
    seeds them: nuTilda 1e-3 (fixed at 0 on the walls), R or B the
    isotropic (2/3) k of the case's k (zeroGradient walls), v2 = (2/3) k
    and f = 0 (both fixed at 0 on the walls); nuTilda and v2 times
    1 + 0.2u cell by cell, u from numpy's generator at `seed`."""
    from foamtpu_torch.core.case import Case

    kind = COMP2_MODELS[model]
    for f in ("RASProperties", "LESProperties"):
        path = os.path.join(dst, "constant", f)
        if os.path.exists(path):
            os.remove(path)
    extra = "delta cubeRootVol;\n" if kind == "LES" else ""
    _write_text(dst, f"constant/{kind}Properties", _foam_header(
        "dictionary", f"{kind}Properties")
        + f"{kind}Model {model};\nturbulence on;\n{extra}")
    k = Case(dst, device="cpu").read_field("k").data.double().numpy()
    n = k.shape[0]
    rng = np.random.default_rng(seed)
    empty = "frontAndBack { type empty; }"

    def walls(text):
        return _rows([f"{w} {{ {text} }}" for w in COMP2_WALLS] + [empty])

    fixed0 = walls("type fixedValue; value uniform 0;")
    if model == "SpalartAllmaras":
        write_field(dst, "nuTilda", _DIMS["nuTilda"],
                    1e-3 * (1.0 + 0.2 * rng.random(n)), fixed0)
    if model in ("LRR", "LaunderGibsonRSTM", "DeardorffDiffStress"):
        T6 = np.zeros((n, 6))
        T6[:, [0, 3, 5]] = (2.0 / 3.0) * k[:, None]
        name = "B" if model == "DeardorffDiffStress" else "R"
        write_field(dst, name, _DIMS[name], T6, walls("type zeroGradient;"))
    if model == "v2f":
        write_field(dst, "v2", _DIMS["v2"],
                    (2.0 / 3.0) * k * (1.0 + 0.2 * rng.random(n)), fixed0)
        write_field(dst, "f", _DIMS["f"], 0.0, fixed0)
    return dst


def comp2_case(here, dst, model, cli, device=()):
    """buoyantPimpleFoam's hotCavity under compressible::`model`, from a
    well-posed start: U and T seeded as SLICE10_CASES seeds them
    (COMP_SEED), k and epsilon their shipped values times 1 + 0.2u cell by
    cell, then `comp2_fields`; fields written with 17 digits. (The
    buoyant cavity amplifies round-off: after 5 steps the JAX package's
    float32 scalars move by up to 31% under a 1e-7 perturbation of U and
    differ from float64 by up to 97%, the pressure level most; the Euler
    ddt and converged solves leave it so. Its goldens are loose, its
    oracles and constant_rho_pairs bind.)"""
    from foamtpu_torch.core.case import Case

    compressible_case(here, dst, "buoyantPimpleFoam", cli, seed=COMP_SEED,
                      write_precision=17, device=device)

    n = Case(dst, device="cpu").mesh.n_cells
    rng = np.random.default_rng(COMP_SEED + 1)
    for name, v0 in (("k", 7.5e-4), ("epsilon", 4e-5)):
        set_internal(dst, name, v0 * (1.0 + 0.2 * rng.random(n)))
    return comp2_fields(dst, model)


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
    case's blockMeshDict), without the ascii polyMesh files: the premesh
    process's where it made that dictionary's mesh."""
    from foamtpu_torch.core.dictionary import parse_file
    from foamtpu_torch.mesh import blockmesh

    path = blockmesh_dict(case.dir)
    got = premeshed(dict_key(path))
    case._poly = got[0] if got else blockmesh.generate(parse_file(path))
    return case


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


def phase_boussinesq_headline(spmv, here, root, flush, trials=2):
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


def box_big_case(here, dst):
    """The oscillatingBox tutorial copied to dst with its block at
    BOX_HEAD_N^2 (not meshed, see memory_mesh)."""
    shutil.copytree(os.path.join(here, BOX_CASE), dst)
    path = os.path.join(dst, "system", "blockMeshDict")
    with open(path) as f:
        text = f.read()
    check("(20 20 1)" in text, path)
    with open(path, "w") as f:
        f.write(text.replace("(20 20 1)", f"({BOX_HEAD_N} {BOX_HEAD_N} 1)"))
    return dst


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
    dst = box_big_case(here, os.path.join(root, "box_big"))
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


# ---------------------------------------------------------------------------
# the phases of the compressible family
# ---------------------------------------------------------------------------

# name -> (app, compressible_case options, steps). Depths cut from the
# tutorials' own (each phase's time on the card): heatedDuct and porousDuct
# 10 of 100 steps (PIMPLE; 50 iterations SIMPLE), sonicFoam 20 of 4,000,
# rhoCentralFoam 200 of 4,000 (t = 0.2: the bow shock stands off the step),
# rhoCentralDyMFoam 50 of 4,000, buoyantCavity 60 of 1,000 iterations,
# hotCavity all 10 steps; LTSInterFoam 20 of 1,000 steps with its local
# time step capped at the tutorial's deltaT, and 1 step as shipped
# (the depths halved for room, from 10, 20, 200, 50, 60, 10 and 20)
COMP_RUNS = {
    "rhoPimpleFoam": ("rhoPimpleFoam", {}, 5),
    "rhoSimpleFoam": ("rhoSimpleFoam", {}, 5),
    "rhoSimplecFoam": ("rhoSimplecFoam", {}, 5),
    "rhoPimplecFoam": ("rhoPimplecFoam", {}, 5),
    "rhoPorousSimpleFoam": ("rhoPorousSimpleFoam", {}, 5),
    "rhoPorousMRFSimpleFoam": ("rhoPorousMRFSimpleFoam", {}, 5),
    "rhoPorousMRFPimpleFoam": ("rhoPorousMRFPimpleFoam", {}, 5),
    "sonicFoam": ("sonicFoam", {}, 10),
    "rhoCentralFoam": ("rhoCentralFoam", {}, 100),
    "rhoCentralDyMFoam": ("rhoCentralDyMFoam", {}, 25),
    "buoyantSimpleFoam": ("buoyantSimpleFoam", {}, 30),
    "buoyantPimpleFoam": ("buoyantPimpleFoam", {}, 5),
    "LTSInterFoam": ("LTSInterFoam", {"max_delta_t": 0.001}, 10),
    "LTSInterFoam_shipped": ("LTSInterFoam", {}, 1),
}
# the runs held to invariants only: the buoyant cavities start from U = 0
# under a heated wall (round-off decides the first fluxes' upwind weights,
# ROADMAP Queue 3); the shipped LTSInterFoam diverges in its first step in
# the JAX package too (|U| ~3e11, its local step 1e6 s)
COMP_INVARIANTS_ONLY = ("buoyantSimpleFoam", "buoyantPimpleFoam",
                        "LTSInterFoam_shipped")
# the golden scalars of COMP_RUNS from the JAX package on the CPU in
# float32 (JAX_PLATFORMS=cpu PYTHONPATH=.:tests python
# tests/test_torch_rhopimple.py goldens), and their spread in that
# package: the larger of |f32 - f64| (the same with FOAMTPU_X64=1
# JAX_ENABLE_X64=1) and |f32 - f32 from a start perturbed by 1e-7 cell by
# cell| (`goldens --perturb`), over max(|value|, COMP_FLOOR) (`... spread
# f32.json f64.json perturbed.json`). A scalar is held at comp_tolerance
COMP_GOLDEN = {'rhoPimpleFoam': {'U_mean': 10.001137041972967,
                   'U_max': 10.002620698783852,
                   'T_mean': 300.00262355804443,
                   'T_min': 299.99951171875,
                   'T_max': 300.0231628417969,
                   'p_mean': 0.17864990234375,
                   'p_min': 0.0,
                   'p_max': 0.328125},
 'rhoSimpleFoam': {'U_mean': 10.000567596982856,
                   'U_max': 10.003322601467142,
                   'T_mean': 300.01058427492774,
                   'T_min': 299.99993896484375,
                   'T_max': 300.1065368652344,
                   'p_mean': 0.025533040364583336,
                   'p_min': -0.0078125,
                   'p_max': 0.078125},
 'rhoSimplecFoam': {'U_mean': 10.000520051959324,
                    'U_max': 10.00332737293298,
                    'T_mean': 300.01041066646576,
                    'T_min': 299.99993896484375,
                    'T_max': 300.1047058105469,
                    'p_mean': 0.0770263671875,
                    'p_min': 0.0,
                    'p_max': 0.171875},
 'rhoPimplecFoam': {'U_mean': 10.001138666221065,
                    'U_max': 10.002658845586378,
                    'T_mean': 300.0026259819666,
                    'T_min': 299.99957275390625,
                    'T_max': 300.02325439453125,
                    'p_mean': 0.173095703125,
                    'p_min': 0.0,
                    'p_max': 0.3203125},
 'rhoPorousSimpleFoam': {'U_mean': 10.015905780342056,
                         'U_max': 10.1189498129392,
                         'T_mean': 300.00896398226416,
                         'T_min': 299.9994201660156,
                         'T_max': 300.101318359375,
                         'p_mean': 1.0439961751302085,
                         'p_min': -1.6953125,
                         'p_max': 7.8671875},
 'rhoPorousMRFSimpleFoam': {'U_mean': 10.01717489965882,
                            'U_max': 11.09986038843319,
                            'T_mean': 299.98233127593994,
                            'T_min': 277.4250793457031,
                            'T_max': 326.74798583984375,
                            'p_mean': 0.7188720703124998,
                            'p_min': -14.40625,
                            'p_max': 7.25},
 'rhoPorousMRFPimpleFoam': {'U_mean': 9.993635672049301,
                            'U_max': 10.67601999927766,
                            'T_mean': 299.9901581207911,
                            'T_min': 273.2088317871094,
                            'T_max': 320.31451416015625,
                            'p_mean': -0.27525838216145826,
                            'p_min': -13.53125,
                            'p_max': 5.1171875},
 'sonicFoam': {'U_mean': 2.9565233119169334,
               'U_max': 7.327136999468309,
               'T_mean': 1.004497579557614,
               'T_min': 1.0,
               'T_max': 1.3343217372894287,
               'p_mean': 100.47002689422126,
               'p_min': 100.0,
               'p_max': 460.578125},
 'rhoCentralFoam': {'U_mean': 2.9772475635536977,
                    'U_max': 3.104289071562629,
                    'T_mean': 1.0296002708094578,
                    'T_min': 0.9999986886978149,
                    'T_max': 3.87187123298645,
                    'p_mean': 1.1095112328388033,
                    'p_min': 0.7267947196960449,
                    'p_max': 16.1778507232666,
                    'mass': 0.18060066394846275,
                    'rho_max': 5.874434471130371},
 'rhoCentralDyMFoam': {'U_mean': 2.9966772005683864,
                       'U_max': 3.0263391055911337,
                       'T_mean': 1.0042756625990723,
                       'T_min': 0.9999989867210388,
                       'T_max': 3.6194002628326416,
                       'p_mean': 1.0252481207125894,
                       'p_min': 0.9999995827674866,
                       'p_max': 23.375988006591797,
                       'mass': 0.17750960814020558,
                       'rho_max': 9.041969299316406},
 'LTSInterFoam': {'U_mean': 0.041131051928713615,
                  'U_max': 0.5203023255602393,
                  'p_mean': 218.06001560592716,
                  'p_min': -1.2178990840911865,
                  'p_max': 2771.438720703125,
                  'mass': 1.3076374855909816,
                  'rho_max': 1000.0,
                  'water_volume': 0.0012989776342879184}}
COMP_SPREAD = {'rhoPimpleFoam': {'U_mean': 5.830574997426032e-07,
                   'U_max': 4.180124793657825e-06,
                   'T_mean': 5.6822597761260855e-08,
                   'T_min': 8.783117574543644e-07,
                   'T_max': 4.068696274772893e-07,
                   'p_mean': 0.008360238138304055,
                   'p_min': 0.001692056204774417,
                   'p_max': 0.01572003267938271},
 'rhoSimpleFoam': {'U_mean': 1.444085554145738e-05,
                   'U_max': 6.935763317761347e-05,
                   'T_mean': 9.583631346521078e-06,
                   'T_min': 1.6932510785474622e-07,
                   'T_max': 6.89497849184809e-05,
                   'p_mean': 0.036133355641027244,
                   'p_min': 0.007658850256120786,
                   'p_max': 0.07199160421441775},
 'rhoSimplecFoam': {'U_mean': 2.335261107693027e-05,
                    'U_max': 8.777643270795422e-05,
                    'T_mean': 9.004518088336352e-06,
                    'T_min': 1.735775826958294e-07,
                    'T_max': 6.345441567991152e-05,
                    'p_mean': 0.004994710286458343,
                    'p_min': 0.000325654138578102,
                    'p_max': 0.0078125},
 'rhoPimplecFoam': {'U_mean': 1.2515726973493167e-07,
                    'U_max': 3.153906382350114e-06,
                    'T_mean': 4.5166680033157185e-08,
                    'T_min': 5.248368347139038e-07,
                    'T_max': 9.15456382470353e-07,
                    'p_mean': 0.004756934733488094,
                    'p_min': 0.0016352794045815244,
                    'p_max': 0.009897391064441763},
 'rhoPorousSimpleFoam': {'U_mean': 1.7682404215953475e-05,
                         'U_max': 0.0001672064140819328,
                         'T_mean': 3.1858641424433176e-06,
                         'T_min': 1.017254570295902e-07,
                         'T_max': 5.308265844461709e-05,
                         'p_mean': 0.056052004145349645,
                         'p_min': 0.08282528269160454,
                         'p_max': 0.011216964315560156},
 'rhoPorousMRFSimpleFoam': {'U_mean': 9.746906849463645e-05,
                            'U_max': 0.001041177384419892,
                            'T_mean': 7.880767738490372e-05,
                            'T_min': 0.018350802719053008,
                            'T_max': 0.005349168348056356,
                            'p_mean': 0.18699500120537027,
                            'p_min': 0.028667499130458414,
                            'p_max': 0.040806495536375664},
 'rhoPorousMRFPimpleFoam': {'U_mean': 1.9587255758532917e-05,
                            'U_max': 0.0009763348799414383,
                            'T_mean': 1.450162354284932e-06,
                            'T_min': 0.00033666547258773434,
                            'T_max': 0.00032078685480826816,
                            'p_mean': 0.1580098470052083,
                            'p_min': 0.008660508083140877,
                            'p_max': 0.04732824427480916},
 'sonicFoam': {'U_mean': 4.3708085784288976e-05,
               'U_max': 5.170553846337095e-05,
               'T_mean': 8.418553255900928e-06,
               'T_min': 0.0,
               'T_max': 5.90646296669481e-05,
               'p_mean': 2.119486627531296e-05,
               'p_min': 0.0,
               'p_max': 0.00013569901957458357},
 'rhoCentralFoam': {'U_mean': 7.75955931143116e-08,
                    'U_max': 1.532182276902679e-07,
                    'T_mean': 1.2388714243048013e-07,
                    'T_min': 1.311303902575865e-06,
                    'T_max': 7.74954788584487e-08,
                    'p_mean': 7.722803522754177e-08,
                    'p_min': 2.7074184827391434e-07,
                    'p_max': 2.8906835930494253e-08,
                    'mass': 6.81803784463753e-08,
                    'rho_max': 1.6234317040951552e-07},
 'rhoCentralDyMFoam': {'U_mean': 7.028564468408834e-08,
                       'U_max': 1.570502127092313e-07,
                       'T_mean': 1.4357849394488172e-07,
                       'T_min': 1.0132799859185306e-06,
                       'T_max': 2.075581925063405e-06,
                       'p_mean': 1.2971297120662714e-07,
                       'p_min': 4.172325107631991e-07,
                       'p_max': 2.588769960933067e-06,
                       'mass': 6.164924547339408e-08,
                       'rho_max': 3.6752602483811786e-07},
 'LTSInterFoam': {'U_mean': 2.049469839322884e-05,
                  'U_max': 6.085134771366893e-05,
                  'p_mean': 2.7264419277297836e-05,
                  'p_min': 0.002229467371882416,
                  'p_max': 1.5708763804278752e-06,
                  'mass': 1.1980924151772177e-07,
                  'rho_max': 0.0,
                  'water_volume': 1.1590265878012206e-07}}
COMP_TOL_FLOOR = 1e-4
COMP_TOL_SPREAD = 10.0
# the least magnitude a scalar's error is taken relative to
COMP_FLOOR = {"U_mean": 1e-3, "U_max": 1e-3, "p_mean": 1.0, "p_min": 1.0,
              "p_max": 1.0}
COMP_P_OP = 1e5               # the pRefValue the pressure-based cases shift by

# the pressure-based cases keep p absolute in float32, whose resolution at
# 1e5 Pa is 2^-7 Pa, so their p scalars also get COMP_P_ULPS of it: an
# extreme of p a cell moves by one ulp where the spreads, taken from
# quantised values, can read 0 (rhoPimpleFoam's p_min: the port on the CPU
# one ulp from the JAX package, f32 against f64 and perturbed 6e-4 of 1 Pa)
COMP_P_ULPS = 4


def comp_tolerance(name, key, golden, spread):
    """The bound a golden scalar of COMP_RUNS is held to on the card:
    COMP_TOL_SPREAD times the JAX package's own spread, at least
    COMP_TOL_FLOOR, and for the absolute pressure's scalars at least
    COMP_P_ULPS of its float32 resolution. (The f32-vs-f64 spread alone,
    5.2e-4 at rhoPorousMRFSimpleFoam's p_max after 20 iterations, was one
    draw of the round-off its relTol 0.05 p solves amplify: the card read
    7.8e-3 there in my chip runs 1 and 2, the perturbed start 9.7e-3.)"""
    tol = max(COMP_TOL_FLOOR, COMP_TOL_SPREAD * spread)
    if (key.startswith("p_") and name.startswith("rho")
            and "Central" not in name):
        tol = max(tol, COMP_P_ULPS * 2.0 ** -7
                  / max(abs(golden), COMP_FLOOR[key]))
    return tol

# tests/test_rhopimple.py's box and channel, tests/test_buoyantrho.py's
# cavity (copied: this script imports nothing of the JAX package's tests)
RHO_BOX = """
convertToMeters 1;
vertices ( (0 0 0) (1 0 0) (1 1 0) (0 1 0)
           (0 0 0.1) (1 0 0.1) (1 1 0.1) (0 1 0.1) );
blocks ( hex (0 1 2 3 4 5 6 7) (20 20 1) simpleGrading (1 1 1) );
boundary
(
    walls { type wall; faces ((0 4 7 3) (2 6 5 1) (1 5 4 0) (3 7 6 2)); }
    frontAndBack { type empty; faces ((0 3 2 1) (4 5 6 7)); }
);
"""
RHO_CHANNEL = """
convertToMeters 1;
vertices ( (0 0 0) (2 0 0) (2 0.5 0) (0 0.5 0)
           (0 0 0.1) (2 0 0.1) (2 0.5 0.1) (0 0.5 0.1) );
blocks ( hex (0 1 2 3 4 5 6 7) (24 8 1) simpleGrading (1 1 1) );
boundary
(
    inlet { type patch; faces ((0 4 7 3)); }
    outlet { type patch; faces ((2 6 5 1)); }
    walls { type wall; faces ((1 5 4 0) (3 7 6 2)); }
    frontAndBack { type empty; faces ((0 3 2 1) (4 5 6 7)); }
);
"""
BUOY_BOX = """
convertToMeters 0.1;
vertices ( (0 0 0) (1 0 0) (1 1 0) (0 1 0)
           (0 0 0.1) (1 0 0.1) (1 1 0.1) (0 1 0.1) );
blocks ( hex (0 1 2 3 4 5 6 7) (16 16 1) simpleGrading (1 1 1) );
boundary
(
    hotWall  { type wall; faces ((0 4 7 3)); }
    coldWall { type wall; faces ((2 6 5 1)); }
    adiabatic { type wall; faces ((1 5 4 0) (3 7 6 2)); }
    frontAndBack { type empty; faces ((0 3 2 1) (4 5 6 7)); }
);
"""
COMP_HEAD_SCALE = 32          # heatedDuct 1536 x 512 = 786,432 cells
COMP_HEAD_DT = 0.002 / 32     # the shipped Courant number
COMP_HEAD_WARMUP = 1
COMP_HEAD_TRIALS = 3
COMP_HEAD_CHUNK = 5           # 3 x 5 = 15 timed steps
# bench.py's GAMG p, where the shipped PCG's final solve sits at its cap:
# one warm-up and two timed steps (it diverges, in the JAX package too:
# continuity 0.42, 86, 2,740 over three steps of heatedDuct at 96 x 32)
COMP_HEAD_GAMG_TRIALS = 2
COMP_HEAD_GAMG_CHUNK = 1
RC_HEAD_SCALE = 8             # forwardStep: 1,032,192 cells
RC_HEAD_DT = 1.25e-4
RC_HEAD_CHUNK = 10
RC_HEAD_TRIALS = 2            # + a warm-up chunk and a profiled one: 40


def comp_arrays(state, host):
    """The fields of a compressible-family state as numpy float64."""
    out = {}
    for k in ("U", "T", "p", "p_rgh", "alpha", "rho"):
        if k in state:
            x = state[k]
            out[k] = np.asarray(host(getattr(x, "data", x)), np.float64)
    return out


def comp_scalars(a, v):
    """The golden scalars of a state's arrays: |U| (volume mean, max), T
    (mean, min, max), the pressure (p or p_rgh, less COMP_P_OP where it is
    absolute: mean, min, max) and, with rho (rhoCentralFoam), the mass
    and rho's maximum."""
    v = np.asarray(v, np.float64)
    w = v / v.sum()
    mag = np.sqrt((a["U"] ** 2).sum(axis=1))
    out = {"U_mean": float((mag * w).sum()), "U_max": float(mag.max())}
    if "T" in a:
        out.update(T_mean=float((a["T"] * w).sum()),
                   T_min=float(a["T"].min()), T_max=float(a["T"].max()))
    p = a.get("p", a.get("p_rgh"))
    if float(np.abs(p).mean()) > 1e4:
        p = p - COMP_P_OP
    out.update(p_mean=float((p * w).sum()), p_min=float(p.min()),
               p_max=float(p.max()))
    if "rho" in a:
        out.update(mass=float((a["rho"] * v).sum()),
                   rho_max=float(a["rho"].max()))
    if "alpha" in a:
        out["water_volume"] = float((a["alpha"] * v).sum())
    return out


def comp_invariants(name, a, c, v, text):
    """Each run's invariants: finite fields and what its physics bounds
    (the reference tests' oracles where they apply)."""
    finite = all(bool(np.isfinite(x).all()) for x in a.values())
    ck = {"finite": finite}
    if not finite:
        return ck
    T = a.get("T")
    if name.startswith("rho") and "Central" not in name:
        # heatedDuct / porousDuct: T between the inlet's 300 K and the
        # walls' 350 K, the absolute pressure positive; in the MRF rotor
        # the gas cools below 300 K (280 K after 20 steps of
        # rhoPorousMRFPimpleFoam in the JAX package, float32 and float64)
        if "MRF" in name:
            ck["250 <= T <= 350 (+-0.5)"] = bool(
                T.min() >= 250.0 and T.max() <= 350.5)
        else:
            ck["300 <= T <= 350 (+-0.5)"] = bool(
                T.min() >= 299.5 and T.max() <= 350.5)
        ck["p > 0"] = bool(a["p"].min() > 0.0)
    if name == "sonicFoam":
        ck["p, T > 0"] = bool(a["p"].min() > 0.0 and T.min() > 0.0)
    if name == "rhoCentralFoam":
        # tests/test_rhocentral.py: stable and bounded, the bow shock
        # ahead of the step, the undisturbed inflow, the mean density
        rho, p = a["rho"], a["p"]
        probe = (c[:, 0] > 0.5) & (c[:, 0] < 0.6) & (c[:, 1] < 0.2)
        probe_in = (c[:, 0] < 0.1) & (c[:, 1] > 0.6)
        rho_mean = float((rho * v).sum() / v.sum())
        ck.update({
            "rho > 0.1": bool(rho.min() > 0.1),
            "rho < 11.2": bool(rho.max() < 8.0 * 1.4),
            "T > 0.1": bool(T.min() > 0.1),
            "bow shock: p ahead of the step > 3": bool(p[probe].max() > 3.0),
            "inflow p = 1 (20%)": bool(np.allclose(p[probe_in], 1.0,
                                                   rtol=0.2)),
            "1 < mean rho < 4": 1.0 < rho_mean < 4.0})
        co = re.findall(r"Courant = (\S+)", text)
        ck["Courant < 1"] = bool(co) and max(float(x) for x in co) < 1.0
    if name == "rhoCentralDyMFoam":
        ck["rho, T > 0"] = bool(a["rho"].min() > 0.0 and T.min() > 0.0)
    if name.startswith("buoyant"):
        # tests/test_buoyantrho.py: T within the walls' 270-330 K, |U|
        # plausible
        ck["270 <= T <= 330 (+-0.1)"] = bool(T.min() > 269.9
                                             and T.max() < 330.1)
        ck["|U| < 2"] = bool(np.abs(a["U"]).max() < 2.0)
    if name == "LTSInterFoam":
        al = a["alpha"]
        ck["alpha within [-1e-6, 1 + 1e-3]"] = bool(
            al.min() > -1e-6 and al.max() < 1.0 + 1e-3)
    return ck


def unit_setup(kind, device="cuda"):
    """tests/test_rhopimple.py's closed box with a pressure bump ("box") or
    heated channel ("channel"), or tests/test_buoyantrho.py's
    differentially heated cavity ("cavity"), built through the port:
    (mesh, U, p or p_rgh, T)."""
    from foamtpu_torch.bc import patchfields as pf
    from foamtpu_torch.core.dictionary import parse_string
    from foamtpu_torch.core.dimensions import DimensionSet, dimVelocity
    from foamtpu_torch.core.fields import vol_scalar, vol_vector
    from foamtpu_torch.mesh import blockmesh, to_device

    text = {"box": RHO_BOX, "channel": RHO_CHANNEL, "cavity": BUOY_BOX}[kind]
    mesh = to_device(blockmesh.generate(parse_string(text)), device=device)
    zeros = torch.zeros(3, dtype=mesh.v.dtype, device=mesh.device)
    ub, pb, tb = [], [], []
    for pt in mesh.patches:
        if pt.type == "empty":
            for lst in (ub, pb, tb):
                lst.append(pf.PatchField(kind="empty", vfrac=0.0))
        elif kind == "channel" and pt.name == "inlet":
            ub.append(pf.fixed_value(zeros + torch.tensor(
                [10.0, 0.0, 0.0], dtype=zeros.dtype, device=zeros.device)))
            pb.append(pf.zero_gradient())
            tb.append(pf.fixed_value(300.0))
        elif kind == "channel" and pt.name == "outlet":
            ub.append(pf.zero_gradient())
            pb.append(pf.fixed_value(1e5))
            tb.append(pf.zero_gradient())
        else:
            ub.append(pf.fixed_value(zeros))
            pb.append(pf.zero_gradient())
            tb.append(pf.fixed_value(330.0) if kind == "channel"
                      or pt.name == "hotWall" else
                      pf.fixed_value(270.0) if pt.name == "coldWall"
                      else pf.zero_gradient())
    u0 = (10.0, 0.0, 0.0) if kind == "channel" else (0.0, 0.0, 0.0)
    U = vol_vector(mesh, u0, name="U", dims=dimVelocity, bcs=tuple(ub))
    pdims = DimensionSet.of(1, -1, -2)
    p = vol_scalar(mesh, 1e5, name="p_rgh" if kind == "cavity" else "p",
                   dims=pdims, bcs=tuple(pb))
    if kind == "box":
        c = mesh.c.double()
        r2 = ((c[:, 0] - 0.5) ** 2 + (c[:, 1] - 0.5) ** 2) / 0.05 ** 2
        p = p.with_data((1e5 * (1.0 + 0.01 * torch.exp(-r2))).to(
            mesh.v.dtype))
    T = vol_scalar(mesh, 300.0, name="T", dims=DimensionSet.of(0, 0, 0, 1),
                   bcs=tuple(tb))
    return mesh, U, p, T


def unit_oracles(spmv):
    """The oracles of tests/test_rhopimple.py and tests/test_buoyantrho.py
    on their own setups through the port on the card (float32): the
    acoustic box conserves mass (20 PIMPLE steps), rhoSimpleFoam converges
    on the heated channel (80 iterations), the transonic pressure
    equation runs stably (10 steps), SIMPLEC matches SIMPLE (80 iterations
    each), the steady cavity circulates (150 iterations) and the
    transient one conserves mass (25 steps). Returns (record, checks,
    SpMV launches, remainder launches)."""
    from foamtpu_torch.models.thermo import PerfectGas
    from foamtpu_torch.solvers import buoyantrho, rhopimple

    rec, ck = {}, {}
    spmv.LAUNCHES = spmv.FB_LAUNCHES = 0
    t0 = time.perf_counter()
    th = PerfectGas(R=287.0, Cv=717.5, mu=1.8e-5)
    box_dt = 0.2 * 0.05 / 350.0

    def steps(mesh, state, cfg, n, dt, step_fn=rhopimple.rhopimple_step):
        first, diag = None, None
        for i in range(n):
            state, diag = step_fn(mesh, state, dt, cfg)
            if i == 0:
                first = diag
        return state, first, diag

    def host(x):
        return x.double().cpu().numpy()

    # the acoustic box: mass to 1e-4, p and T bounded, a wave launched
    mesh, U, p, T = unit_setup("box")
    v = host(mesh.v)
    m0 = float((host(th.rho(p.data, T.data)) * v).sum())
    cfg = rhopimple.RhoPimpleConfig(thermo=th, n_outer=2, n_correctors=2,
                                    div_scheme="linear")
    st, _, _ = steps(mesh, rhopimple.initial_state(mesh, U, p, T, th), cfg,
                     20, box_dt)
    pd, Td = host(st["p"].data), host(st["T"].data)
    m1 = float((host(th.rho(st["p"].data, st["T"].data)) * v).sum())
    rec["acoustic_box"] = {"mass_rel_change": abs(m1 - m0) / m0,
                           "p_range": [pd.min(), pd.max()],
                           "T_range": [Td.min(), Td.max()],
                           "u_max": float(host(st["U"].data).max())}
    ck.update({"acoustic box mass to 1e-4": abs(m1 - m0) / m0 < 1e-4,
               "acoustic box 0.98e5 < p < 1.03e5": bool(
                   0.98e5 < pd.min() and pd.max() < 1.03e5),
               "acoustic box 295 < T < 305": bool(295.0 < Td.min()
                                                  and Td.max() < 305.0),
               "acoustic box wave launched": float(np.abs(host(
                   st["U"].data)).max()) > 0.05})

    # the heated channel, SIMPLE and SIMPLEC
    thv = PerfectGas(R=287.0, Cv=717.5, mu=0.116)

    def channel(consistent, alpha_p):
        mesh, U, p, T = unit_setup("channel")
        cfg = rhopimple.RhoPimpleConfig(
            thermo=thv, steady=True, consistent=consistent, alpha_u=0.7,
            alpha_p=alpha_p, alpha_e=0.7)
        st, first, last = steps(
            mesh, rhopimple.initial_state(mesh, U, p, T, thv, steady=True),
            cfg, 80, 1.0)
        nif = mesh.n_internal_faces
        phib = host(st["phi"])[nif:] * host(mesh.face_active)[nif:]
        m_in, m_out = -phib[phib < 0].sum(), phib[phib > 0].sum()
        return (mesh, st, float(first["p_initial"]),
                float(last["p_initial"]), abs(m_out - m_in) / m_in)

    mesh, st_s, p_first, p_last, imb = channel(False, 0.3)
    Td = host(st_s["T"].data)
    # the reference test's reshape and rows, as it writes them
    Tg = Td.reshape(24, 8)
    rec["channel"] = {"p_initial": [p_first, p_last], "mass_imbalance": imb,
                      "T_range": [Td.min(), Td.max()]}
    ck.update({"channel converging (p residual < 0.3 x first)":
               p_last < 0.3 * p_first,
               "channel mass in = out (2e-3)": imb < 2e-3,
               "channel 299 < T < 331": bool(299.0 < Td.min()
                                             and Td.max() < 331.0),
               "channel heated downstream (the test's rows)": bool(
                   Tg[-1].mean() > Tg[0].mean())})
    _, st_c, _, _, imb_c = channel(True, 1.0)
    du = float(np.abs(host(st_c["U"].data) - host(st_s["U"].data)).max())
    rec["simplec"] = {"du_vs_simple": du, "mass_imbalance": imb_c}
    ck.update({"SIMPLEC matches SIMPLE (du < 0.35)": du < 0.35,
               "SIMPLEC mass in = out (5e-3)": imb_c < 5e-3})

    # the transonic pressure equation on the box
    mesh, U, p, T = unit_setup("box")
    cfg = rhopimple.RhoPimpleConfig(thermo=th, transonic=True, n_outer=1,
                                    n_correctors=2)
    st, _, _ = steps(mesh, rhopimple.initial_state(mesh, U, p, T, th), cfg,
                     10, box_dt)
    pd = host(st["p"].data)
    rec["transonic"] = {"p_range": [pd.min(), pd.max()]}
    ck["transonic box runs (0.9e5 < p < 1.1e5)"] = bool(
        np.isfinite(pd).all() and 0.9e5 < pd.min() and pd.max() < 1.1e5)

    # tests/test_buoyantrho.py: the steady cavity circulates, the
    # transient one conserves mass
    thb = PerfectGas(R=287.0, Cv=717.5, mu=1.8e-4)
    mesh, U, p_rgh, T = unit_setup("cavity")
    cfg = buoyantrho.BuoyantRhoConfig(thermo=thb, steady=True, alpha_u=0.3,
                                      alpha_p=0.7, alpha_e=0.3)
    st, first, last = steps(
        mesh, buoyantrho.initial_state(mesh, U, p_rgh, T, thb, steady=True),
        cfg, 150, 1.0, buoyantrho.buoyantrho_step)
    Ud, Td, c = host(st["U"].data), host(st["T"].data), host(mesh.c)
    left, right = c[:, 0] < 0.025, c[:, 0] > 0.075
    r0 = float(first["Ux"].initial_residual.max())
    r1 = float(last["Ux"].initial_residual.max())
    rec["buoyant_cavity"] = {"Ux_residual": [r0, r1],
                             "uy_left": float(Ud[left, 1].mean()),
                             "uy_right": float(Ud[right, 1].mean()),
                             "T_range": [Td.min(), Td.max()]}
    ck.update({"buoyant cavity converging": np.isfinite(r1) and r1 < 0.5 * r0,
               "buoyant cavity 269.9 < T < 330.1": bool(
                   269.9 < Td.min() and Td.max() < 330.1),
               "buoyant cavity left warmer by 10 K": bool(
                   Td[left].mean() > Td[right].mean() + 10.0),
               "buoyant cavity circulates": bool(
                   Ud[left, 1].mean() > 0.005
                   and Ud[right, 1].mean() < -0.005),
               "buoyant cavity |U| < 2": bool(np.abs(Ud).max() < 2.0)})
    mesh, U, p_rgh, T = unit_setup("cavity")
    cfg = buoyantrho.BuoyantRhoConfig(thermo=thb, steady=False, n_outer=2,
                                      n_correctors=2)
    st0 = buoyantrho.initial_state(mesh, U, p_rgh, T, thb, steady=False)
    v = host(mesh.v)
    m0 = float((host(st0["rho0"]) * v).sum())
    st, _, _ = steps(mesh, st0, cfg, 25, 2e-3, buoyantrho.buoyantrho_step)
    m1 = float((host(st["rho0"]) * v).sum())
    Td = host(st["T"].data)
    rec["buoyant_transient"] = {"mass_rel_change": abs(m1 - m0) / m0,
                                "T_range": [Td.min(), Td.max()]}
    ck.update({"buoyant transient mass to 2e-3": abs(m1 - m0) / m0 < 2e-3,
               "buoyant transient 269 < T < 331": bool(
                   269.0 < Td.min() and Td.max() < 331.0),
               "buoyant transient convects": float(np.abs(host(
                   st["U"].data)).max()) > 1e-3})
    torch.cuda.synchronize()
    rec["seconds"] = time.perf_counter() - t0
    return rec, ck, spmv.LAUNCHES, spmv.FB_LAUNCHES


def nonsymmetric_share(spmv, mat, mesh):
    """|x.(A z) - z.(A x)| / |x.(A z)| of an operator's off-diagonal slot
    part (plus its COO remainder) for seeded x, z: 0 for a symmetric
    matrix, O(1) where its lower and upper coefficients differ."""
    rng = np.random.default_rng(17)
    x, z = (torch.tensor(rng.standard_normal(mesh.n_cells),
                         dtype=mat.soff.dtype, device=mat.soff.device)
            for _ in range(2))
    fb = mesh_remainder(spmv, mesh, mat.sfb, mat.soff.dtype)
    deltas = tuple(mesh.st_deltas)
    az = spmv.plain(None, z, mat.soff.contiguous(), deltas, fb)
    ax = spmv.plain(None, x, mat.soff.contiguous(), deltas, fb)
    a, b = float(torch.dot(x, az)), float(torch.dot(z, ax))
    return abs(a - b) / max(abs(a), 1e-30)


def comp_operands(spmv, here, root, app):
    """The pressure and momentum matrices of the first step of `app`'s
    tutorial (the application's config and first state, one step of its
    step under SolveLog), with the mesh."""
    from foamtpu_torch.apps.cli import main as cli
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.solvers import apps, rhopimple

    dst = compressible_case(here, os.path.join(root, "ops_" + app), app,
                            cli)
    case = Case(dst, device="cuda")
    th = apps._thermo(case)
    cfg = apps._rho_pimple_config(case, th, False, app == "sonicFoam")
    state = apps._rho_pimple_state(case, cfg)
    with SolveLog(state) as log:
        rhopimple.make_step(case.mesh, cfg)(state, case.time.delta_t)
    return case.mesh, cfg, log


def phase_compressible(spmv, here, root, flush):
    """The compressible family's tutorials through run(case) on the card
    (COMP_RUNS, float32): each held to goldens from the JAX package
    (COMP_GOLDEN, at comp_tolerance: COMP_TOL_SPREAD times the JAX
    package's own spread under round-off, at least COMP_TOL_FLOOR, and
    COMP_P_ULPS of the absolute pressure's float32 resolution) and to its
    invariants
    (comp_invariants; the COMP_INVARIANTS_ONLY runs to those alone); the
    oracles of tests/test_rhopimple.py and tests/test_buoyantrho.py on
    their own setups (unit_oracles); and the SpMV kernel held to its plain
    version at rhoPimpleFoam's p and U and sonicFoam's non-symmetric p
    (float32 and float64), and timed at sonicFoam's p."""
    from foamtpu_torch.apps.cli import main as cli
    from foamtpu_torch.core.case import Case

    results, checks = {}, {}
    launches_total = fb_total = 0
    for name, (app, opts, steps) in COMP_RUNS.items():
        dst = compressible_case(here, os.path.join(root, "comp", name), app,
                                cli, **opts)
        case = Case(dst, device="cuda")
        run_s, text, launches, fb = app_run(spmv, case, steps)
        launches_total += launches
        fb_total += fb
        st = case.final_state
        a = comp_arrays(st, lambda t: t.double().cpu().numpy())
        v = case.mesh.v.double().cpu().numpy()
        c = case.mesh.c.double().cpu().numpy()
        ck = ({"finite": True} if name == "LTSInterFoam_shipped"
              else comp_invariants(name, a, c, v, text))
        got = comp_scalars(a, v) if ck["finite"] else {}
        rec = {"app": app, "n_cells": case.mesh.n_cells,
               "steps": case.time.index, "run_s": run_s,
               "sec_per_step": run_s / max(case.time.index, 1),
               "scalars": got, "iterations_max": {
                   k: max(x) for k, x in solve_iterations(text).items()},
               "spmv_launches": launches, "spmv_fb_launches": fb}
        ck["steps"] = case.time.index == steps
        if app in ("rhoCentralFoam", "rhoCentralDyMFoam"):
            ck["explicit: no SpMV launch"] = launches == 0
        else:
            ck["spmv launched"] = launches > 0
        if name == "LTSInterFoam_shipped":
            # as in the JAX package: |U| ~3e11 after the first step
            rec["u_abs_max"] = float(np.abs(a["U"]).max())
            ck.pop("finite")
            ck["diverging, as in the JAX package (|U| > 1e6)"] = bool(
                not np.isfinite(a["U"]).all() or rec["u_abs_max"] > 1e6)
        elif name not in COMP_INVARIANTS_ONLY and ck["finite"]:
            gold = COMP_GOLDEN[name]
            rel = golden_rel_err(got, gold, COMP_FLOOR)
            tol = {k: comp_tolerance(name, k, gold[k], COMP_SPREAD[name][k])
                   for k in gold}
            rec.update(golden_rel_err=rel, golden_tol=tol)
            ck.update({f"golden {k}": rel[k] <= tol[k] for k in gold})
        results[name] = rec
        checks.update({f"{name} {k}": x for k, x in ck.items()})
        progress("compressible", f"{name}: {run_s:.1f} s, {launches} SpMV "
                 "launches")

    rec, ck, l_u, f_u = unit_oracles(spmv)
    launches_total += l_u
    fb_total += f_u
    results["reference_tests"] = rec
    checks.update(ck)
    progress("compressible", f"reference tests' oracles {rec['seconds']:.1f}"
             " s")

    # the kernel against its plain version at the new operands; sonicFoam's
    # transonic p is the first non-symmetric pressure operator
    cases, max_err, timings, nonsym = [], 0.0, [], {}
    for app, prefix in (("rhoPimpleFoam", "heatedDuct"),
                        ("sonicFoam", "forwardStep_sonic")):
        mesh, cfg, log = comp_operands(spmv, here, root, app)
        pmat = log.matrices["p"]
        nonsym[prefix] = nonsymmetric_share(spmv, pmat, mesh)
        ops = solve_operands(log, mesh, prefix)
        deltas = tuple(mesh.st_deltas)
        for dtype in (torch.float32, torch.float64):
            err = check_operands(spmv, ops, mesh, deltas, dtype,
                                 np.random.default_rng(93), cases)
            if dtype == torch.float32:
                max_err = max(max_err, err)
        if app == "sonicFoam":
            checks["sonicFoam p matrix non-symmetric"] = (
                not pmat.symmetric and nonsym[prefix] > 1e-3)
            _, soff, diag_p, sfb = ops[0]
            timings = time_shape(spmv, "sonic_p", diag_p.contiguous(),
                                 operand_x(diag_p, 94), soff.contiguous(),
                                 deltas, flush, fb=mesh_remainder(
                                     spmv, mesh, sfb, diag_p.dtype))
        else:
            checks["rhoPimpleFoam p matrix symmetric"] = (
                pmat.symmetric and nonsym[prefix] < 1e-5)
    out = {"phase": "compressible", "dtype": "torch.float32",
           "runs": results, "nonsymmetric_share": nonsym,
           "kernel_cases": cases, "max_abs_err_f32": max_err,
           "timings": timings, "spmv_launches_total": launches_total,
           "spmv_fb_launches_total": fb_total, "checks": checks}
    emit(out)
    for name, ok in checks.items():
        check(ok, f"compressible check {name}: {out}")
    return out, max_err, timings


def _p_split(its, per_step):
    """The first and the final p solve of each step of a run of p solves,
    `per_step` solves a step."""
    its = [int(i) for i in its]
    return its[0::per_step], its[per_step - 1::per_step]


def phase_compressible_headline(spmv, here, root, flush):
    """rhoPimpleFoam on heatedDuct refined COMP_HEAD_SCALE per direction
    (1536 x 512 = 786,432 cells) meshed in memory, deltaT COMP_HEAD_DT (the
    shipped Courant number), everything else as shipped (PCG p, pFinal
    relTol 0, 2 outer x 2 correctors): the application's config, state and
    step for COMP_HEAD_WARMUP steps, then COMP_HEAD_TRIALS timed chunks of
    COMP_HEAD_CHUNK steps with the p iterations of every solve; where the
    final p solve sits at its cap, the same with bench.py's GAMG p
    controls (pFinal relTol 0), from the same state, recorded and not held
    (it diverges, as it does in the JAX package: GAMG.prepare coarsens the
    pressure Laplacian before the psi V/dt diagonal joins it); the SpMV
    kernel held to its plain version and timed at the p operand; one
    profiled step of the shipped controls last."""
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.solvers import apps, rhopimple
    from foamtpu_torch.solvers.linear.gamg import GAMG

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dst = compressible_case(here, os.path.join(root, "duct_big"),
                            "rhoPimpleFoam", None, scale=COMP_HEAD_SCALE,
                            delta_t=COMP_HEAD_DT)
    case = memory_mesh(Case(dst, device="cuda"))
    mesh = case.mesh
    n = 768 * COMP_HEAD_SCALE ** 2    # the tutorial's 48 x 16 block
    check(mesh.n_cells == n, mesh.n_cells)
    th = apps._thermo(case)
    cfg = apps._rho_pimple_config(case, th, False, False)
    state = apps._rho_pimple_state(case, cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    progress("compressible_headline", f"set-up {setup_s:.1f} s, {n} cells")
    per_step = cfg.n_outer * cfg.n_correctors
    p_cap = int((cfg.p_controls_final or cfg.p_controls).get("maxIter",
                                                             1000))

    def chunk_of(cfg, k):
        step = rhopimple.make_step(mesh, cfg)

        def chunk(st):
            diag = None
            for _ in range(k):
                st, diag = step(st, COMP_HEAD_DT)
            return st, diag
        return chunk

    def timed(cfg, state, warm, trials, k):
        t0 = time.perf_counter()
        state, diag = chunk_of(cfg, warm)(state)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        secs = []
        l0 = spmv.LAUNCHES
        with SolveLog(state) as log:
            for _ in range(trials):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, diag = chunk_of(cfg, k)(state)
                torch.cuda.synchronize()
                secs.append((time.perf_counter() - t0) / k)
        sec = statistics.median(secs)
        first, final = _p_split(log.iterations["p"], per_step)
        return state, diag, log, {
            "warmup_s": warm_s, "sec_per_step": sec,
            "sec_per_step_trials": secs, "m_cells_per_sec": n / sec / 1e6,
            "spmv_launches_per_step": (spmv.LAUNCHES - l0) / (trials * k),
            "p_iterations_first": first, "p_iterations_final": final,
            "p_iterations_first_mean": statistics.mean(first),
            "p_iterations_final_mean": statistics.mean(final),
            "p_final_at_cap": max(final) >= p_cap,
            "iterations_per_solve": {k_: statistics.mean(v) for k_, v in
                                     log.iterations.items() if v},
            "continuity": float(diag["continuity"]),
            "courant_max": float(diag["courant_max"])}

    spmv.LAUNCHES = spmv.FB_LAUNCHES = 0
    state, diag, tlog, shipped = timed(cfg, state, COMP_HEAD_WARMUP,
                                       COMP_HEAD_TRIALS, COMP_HEAD_CHUNK)
    progress("compressible_headline", f"shipped PCG: {shipped}")
    launches, fb_launches = spmv.LAUNCHES, spmv.FB_LAUNCHES
    gamg_rec = None
    if shipped["p_final_at_cap"]:
        gamg = {"solver": "GAMG", "preconditioner": "polynomial",
                "tolerance": 1e-7, "relTol": 0.01, "maxIter": 1000,
                "_gamg": GAMG(mesh)}
        gcfg = cfg._replace(p_controls=gamg,
                            p_controls_final=dict(gamg, relTol=0.0))
        l0, f0 = spmv.LAUNCHES, spmv.FB_LAUNCHES
        _, _, _, gamg_rec = timed(gcfg, state, 1, COMP_HEAD_GAMG_TRIALS,
                                  COMP_HEAD_GAMG_CHUNK)
        gamg_rec["p_controls"] = ("bench.py's GAMG: tolerance 1e-7, relTol "
                                  "0.01, pFinal relTol 0")
        launches += spmv.LAUNCHES - l0
        fb_launches += spmv.FB_LAUNCHES - f0
        progress("compressible_headline", f"GAMG p: {gamg_rec}")
    ops = solve_operands(tlog, mesh, "heatedDuct_big")
    deltas = tuple(mesh.st_deltas)
    cases, max_err = [], 0.0
    for dtype in (torch.float32, torch.float64):
        err = check_operands(spmv, ops, mesh, deltas, dtype,
                             np.random.default_rng(95), cases)
        if dtype == torch.float32:
            max_err = err
    _, soff, diag_p, sfb = ops[0]
    timings = time_shape(spmv, "heatedDuct_p", diag_p.contiguous(),
                         operand_x(diag_p, 96), soff.contiguous(), deltas,
                         flush, fb=mesh_remainder(spmv, mesh, sfb,
                                                  diag_p.dtype))
    l1, f1 = spmv.LAUNCHES, spmv.FB_LAUNCHES
    state, prof = profile_chunk(spmv, "compressible_headline_profile", mesh,
                                chunk_of(cfg, 1), state, 1,
                                shipped["sec_per_step"])
    launches += spmv.LAUNCHES - l1
    fb_launches += spmv.FB_LAUNCHES - f1
    a = comp_arrays(state, lambda t: t.double().cpu().numpy())
    finite = all(bool(np.isfinite(x).all()) for x in a.values())
    out = {"phase": "compressible_headline",
           "case": "rhoPimpleFoam heatedDuct, block (1536 512 1), deltaT "
                   f"{COMP_HEAD_DT}: the tutorial's BCs, thermo, schemes "
                   "and PIMPLE/solver controls",
           "n_cells": n, "dtype": str(mesh.v.dtype), "setup_s": setup_s,
           "shipped_pcg": shipped, "gamg": gamg_rec,
           "cuda_launch_kernel_per_step": prof["cuda_launch_kernel_per_iter"],
           "device_ms_per_step": prof["device_ms_per_iter"],
           "device_busy_share": prof["device_busy_share_unprofiled"],
           "spmv_device_ms_per_step": prof["spmv_device_ms_per_iter"],
           "top_kernels_ms_per_step": prof["top_kernels_ms_per_iter"][:8],
           "scalars": comp_scalars(a, mesh.v.double().cpu().numpy())
           if finite else {},
           "spmv_launches_total": launches,
           "spmv_fb_launches_total": fb_launches,
           "kernel_cases": cases, "max_abs_err_f32": max_err,
           "timings": timings,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    checks = {"finite": finite, "spmv launched": launches > 0,
              "300 <= T <= 350 (+-0.5)": finite and bool(
                  a["T"].min() >= 299.5 and a["T"].max() <= 350.5)}
    out["checks"] = checks
    emit(out)
    for name, ok in checks.items():
        check(ok, f"compressible_headline check {name}: {out}")
    return out, max_err, timings


def rc_mass_balance(mesh, cfg, state, dt):
    """The mass balance of one rhoCentralFoam SSP-RK2 step: the step's
    mass change against -dt/2 (B(u) + B(u1)), B the net boundary outflow
    of the mass fluxes of a state and u1 the step's first stage, rebuilt
    from knp_fluxes and the face-to-cell sum (internal faces cancel in a
    conservative sum). Returns (the step's state and the defect over the
    mass)."""
    from foamtpu_torch.ops import surface
    from foamtpu_torch.solvers import rhocentral

    th, nif = cfg.thermo, mesh.n_internal_faces

    def rhs(rho, rhoU, rhoE):
        U = rhoU / rho[:, None]
        e = rhoE / rho - 0.5 * torch.sum(U * U, dim=1)
        T = th.T_from_e(torch.clamp(e, min=1e-10))
        f = rhocentral.knp_fluxes(
            mesh, cfg, rho, U, T,
            state["rho"].with_data(rho).boundary_values(mesh),
            state["U"].with_data(U).boundary_values(mesh),
            state["T"].with_data(T).boundary_values(mesh),
            cfg.second_order)
        ks = [-surface.surface_sum(mesh, f[0]) / mesh.v,
              -surface.surface_sum(mesh, f[1]) / mesh.v[:, None],
              -surface.surface_sum(mesh, f[2]) / mesh.v]
        return ks, torch.sum(f[0][nif:].double())

    u = (state["rho"].data, state["rhoU"], state["rhoE"])
    k1, b0 = rhs(*u)
    _, b1 = rhs(*(x + dt * k for x, k in zip(u, k1)))
    m0 = torch.sum(u[0].double() * mesh.v.double())
    new, _ = rhocentral.rhocentral_step(mesh, state, dt, cfg)
    m1 = torch.sum(new["rho"].data.double() * mesh.v.double())
    return new, float(torch.abs(m1 - m0 + 0.5 * dt * (b0 + b1)) / m0)


def phase_rhocentral_headline(spmv, here, root):
    """rhoCentralFoam on forwardStep refined RC_HEAD_SCALE per direction
    (384x128, 1536x512 and 384x512 blocks: 1,032,192 cells) meshed in
    memory, deltaT RC_HEAD_DT, in chunks of RC_HEAD_CHUNK: one warm-up
    chunk, RC_HEAD_TRIALS timed chunks, one profiled chunk (50
    steps), then one step whose mass change is held to its boundary
    fluxes (rc_mass_balance); held to the mean density of
    tests/test_rhocentral.py, its bounds, the bow shock's rise ahead of
    the step and the undisturbed inflow."""
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.solvers import apps, rhocentral

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dst = compressible_case(here, os.path.join(root, "step_big"),
                            "rhoCentralFoam", None, scale=RC_HEAD_SCALE,
                            delta_t=RC_HEAD_DT)
    case = memory_mesh(Case(dst, device="cuda"))
    mesh = case.mesh
    n = 16128 * RC_HEAD_SCALE ** 2    # the tutorial's three blocks
    check(mesh.n_cells == n, mesh.n_cells)
    cfg, rho, U, T = apps._rho_central_setup(case)
    state = rhocentral.initial_state(mesh, rho, U, T, cfg)
    chunk = rhocentral.make_chunk(mesh, cfg, RC_HEAD_CHUNK)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    progress("rhocentral_headline", f"set-up {setup_s:.1f} s, {n} cells")
    spmv.LAUNCHES = spmv.FB_LAUNCHES = 0
    t0 = time.perf_counter()
    state, diag = chunk(state, RC_HEAD_DT)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    mass0 = float(diag["mass"])
    secs = []
    for _ in range(RC_HEAD_TRIALS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, diag = chunk(state, RC_HEAD_DT)
        torch.cuda.synchronize()
        secs.append((time.perf_counter() - t0) / RC_HEAD_CHUNK)
    sec = statistics.median(secs)
    mass1 = float(diag["mass"])
    state, prof = profile_chunk(
        spmv, "rhocentral_headline_profile", mesh,
        lambda st: chunk(st, RC_HEAD_DT), state, RC_HEAD_CHUNK, sec,
        solves=False)
    launches = spmv.LAUNCHES
    # one more step, its mass change against its boundary fluxes (a float32
    # sum over 1,032,192 cells of values ~1.4: defects ~1e-7 of the mass)
    state, defect = rc_mass_balance(mesh, cfg, state, RC_HEAD_DT)
    a = comp_arrays(state, lambda t: t.double().cpu().numpy())
    v = mesh.v.double().cpu().numpy()
    c = mesh.c.double().cpu().numpy()
    ck = comp_invariants("rhoCentralFoam", a, c, v, "")
    ck.pop("Courant < 1", None)
    ck["Courant < 1"] = float(diag["courant_max"]) < 1.0
    ck["mass balance of a step < 1e-5 of the mass"] = defect < 1e-5
    out = {"phase": "rhocentral_headline",
           "case": "rhoCentralFoam forwardStep, blocks (384 128), (384 512), "
                   f"(1536 512), deltaT {RC_HEAD_DT}, first-order KNP",
           "n_cells": n, "dtype": str(mesh.v.dtype), "setup_s": setup_s,
           "warmup_s": warm_s, "sec_per_step": sec,
           "sec_per_step_trials": secs, "steps_per_sec": 1.0 / sec,
           "m_cells_per_sec": n / sec / 1e6,
           "steps": RC_HEAD_CHUNK * (RC_HEAD_TRIALS + 2) + 1,
           "mass_balance_defect": defect,
           "mass": [mass0, mass1, float(diag["mass"])],
           "cuda_launch_kernel_per_step": prof["cuda_launch_kernel_per_iter"],
           "device_ms_per_step": prof["device_ms_per_iter"],
           "device_busy_share": prof["device_busy_share_unprofiled"],
           "top_kernels_ms_per_step": prof["top_kernels_ms_per_iter"][:8],
           "top_ops_device_ms_per_step": prof["top_ops_device_ms_per_iter"][
               :8],
           "courant_max": float(diag["courant_max"]),
           "scalars": comp_scalars(a, v) if ck["finite"] else {},
           "spmv_launches_total": launches, "spmv_fb_launches_total": 0,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    ck["explicit: no SpMV launch"] = launches == 0
    out["checks"] = ck
    emit(out)
    for name, ok in ck.items():
        check(ok, f"rhocentral_headline check {name}: {out}")
    return out


# ---------------------------------------------------------------------------
# the single-equation applications and fanDuct
# ---------------------------------------------------------------------------

SLICE11_TUTORIALS = {
    "electrostaticFoam": ("electromagnetics", "electrostaticFoam",
                          "chargedPlate"),
    "magneticFoam": ("electromagnetics", "magneticFoam", "barMagnet"),
    "mhdFoam": ("electromagnetics", "mhdFoam", "hartmann"),
    "financialFoam": ("financial", "financialFoam", "europeanCall"),
    "shallowWaterFoam": ("shallowWater", "shallowWaterFoam", "squareBump"),
    "solidEquilibriumDisplacementFoam": ("stressAnalysis",
                                         "solidDisplacementFoam",
                                         "plateTension"),
    "potentialFreeSurfaceFoam": ("multiphase", "potentialFreeSurfaceFoam",
                                 "movingOscillatingBox"),
    "adjointShapeOptimizationFoam": ("incompressible",
                                     "adjointShapeOptimizationFoam",
                                     "pitzDaily"),
    "dnsFoam": ("DNS", "dnsFoam", "boxTurb16"),
    "fanDuct": ("incompressible", "pimpleFoam", "fanDuct"),
}
# the commands of each tutorial's Allrun after blockMesh
SLICE11_COMMANDS = {"dnsFoam": ("boxTurb",),
                    "fanDuct": ("topoSet", "createBaffles")}
SLICE11_SEED = 11
# per tutorial, the fields a seeded start perturbs: (field, velocity
# scale of the perturbation of x and y, or None for a scalar's relative
# scale); uniform starts under upwind weights follow the sign of
# round-off, and a start at rest goes nowhere
SLICE11_SEEDS = {
    "shallowWaterFoam": (("hU", 0.05), ("h", 0.01)),
    "potentialFreeSurfaceFoam": (("U", 0.01),),
    "adjointShapeOptimizationFoam": (("U", 0.5),),
}
# solver controls that converge each solve of a parity case: a Krylov
# solve stopped early by relTol amplifies round-off of 1e-14 (the two
# packages' summation orders) into 1e-6 of the field within a step in
# either package. fanDuct's shipped GAMG (which a cyclicAMI coupling turns
# into polynomial BiCGStab, relTol 0.01) does so from 1e-21, hartmann's
# polynomial PCG (relTol 0.01, ~110 iterations on the 20 x 20 mesh of
# 1 x 0.1 cells) from 4e-14
TIGHT_CONTROLS = {
    "fanDuct": {"p": "solver GAMG; tolerance 1e-11; relTol 0; maxIter 500;"},
    "mhdFoam": {k: "solver PCG; preconditioner polynomial; tolerance 1e-11; "
                   "relTol 0; maxIter 2000;" for k in ("p", "pB")},
}


# adjoint fields for pitzDaily, which ships none (the application then
# starts Ua and pa at zero with zeroGradient BCs, and they stay zero): the
# BCs of tests/test_adjoint.py, Ua = -U on the inlet (the power-dissipation
# objective) and 0 on the walls, pa fixed at the outlet
ADJOINT_FIELDS = {
    "Ua": ("volVectorField", "[0 1 -1 0 0 0 0]", "(0 0 0)", {
        "inlet": "type fixedValue; value uniform (-10 0 0);",
        "outlet": "type zeroGradient;",
        "upperWall": "type fixedValue; value uniform (0 0 0);",
        "lowerWall": "type fixedValue; value uniform (0 0 0);",
        "frontAndBack": "type empty;"}),
    "pa": ("volScalarField", "[0 2 -2 0 0 0 0]", "0", {
        "inlet": "type zeroGradient;",
        "outlet": "type fixedValue; value uniform 0;",
        "upperWall": "type zeroGradient;",
        "lowerWall": "type zeroGradient;",
        "frontAndBack": "type empty;"}),
}


def slice11_case(here, dst, name, cli, device=(), app=None, seed=None,
                 scale=None, write_precision=None, write_interval=None,
                 controls=None, adjoint_fields=False):
    """The tutorial `name` of SLICE11_TUTORIALS copied to dst, meshed by
    `cli`'s blockMesh and the Allrun's other commands (SLICE11_COMMANDS;
    boxTurb gets `device`; cli None: not meshed). `app` replaces the
    controlDict's application (solidDisplacementFoam on plateTension),
    `scale` multiplies the x and y cell counts of every block,
    `write_precision` and `write_interval` set the controlDict's,
    `controls` ({field: entry}) replaces fields'
    fvSolution solver entries, `adjoint_fields` writes ADJOINT_FIELDS
    into 0/, and `seed` perturbs the fields of SLICE11_SEEDS from numpy's
    generator. Returns dst."""
    shutil.copytree(os.path.join(here, "tutorials",
                                 *SLICE11_TUTORIALS[name]), dst)
    control = os.path.join(dst, "system", "controlDict")
    if app is not None:
        _edit(control, r"application\s+\w+;", f"application {app};")
    if write_precision is not None:
        with open(control, "a") as f:
            f.write(f"\nwritePrecision {write_precision};\n")
    if write_interval is not None:
        _edit(control, r"writeInterval\s+[^;]+;",
              f"writeInterval {write_interval};")
    if adjoint_fields:
        for field, (cls, dims, value, bf) in ADJOINT_FIELDS.items():
            body = "".join(f"    {k} {{ {v} }}\n" for k, v in bf.items())
            _write_text(dst, os.path.join("0", field),
                        _foam_header(cls, field)
                        + f"dimensions {dims};\ninternalField uniform "
                        f"{value};\nboundaryField\n{{\n{body}}}\n")
    for field, entry in (controls or {}).items():
        _edit(os.path.join(dst, "system", "fvSolution"),
              rf"(\s){field}\s*\{{[^}}]*\}}",
              lambda m: f"{m.group(1)}{field} {{ {entry} }}", count=1)
    if scale not in (None, 1):
        def blocks(m):
            nx, ny, nz = (int(x) for x in m.group(2).split())
            return (f"{m.group(1)}({max(int(round(nx * scale)), 1)} "
                    f"{max(int(round(ny * scale)), 1)} {nz})")
        bm = os.path.join(dst, "constant", "polyMesh", "blockMeshDict")
        if not os.path.exists(bm):
            bm = os.path.join(dst, "system", "blockMeshDict")
        _edit(bm, r"(hex\s*\([^)]*\)\s*)\(([^)]*)\)", blocks)
    if cli is not None:
        with quiet():
            check(cli(["blockMesh", "-case", dst]) == 0, "blockMesh failed")
            for cmd in SLICE11_COMMANDS.get(name, ()):
                extra = device if cmd == "boxTurb" else ()
                check(cli([cmd, "-case", dst, *extra]) == 0,
                      f"{cmd} failed")
    if seed is not None:
        from foamtpu_torch.core.case import Case

        case = Case(dst, device="cpu")
        n = case.mesh.n_cells
        rng = np.random.default_rng(seed)
        for field, s in SLICE11_SEEDS[name]:
            a = case.read_field(field).data.double().numpy().copy()
            if a.ndim == 2:
                a[:, :2] += s * rng.standard_normal((n, 2))
            else:
                a = a * (1.0 + s * rng.random(n))
            set_internal(dst, field, a)
    return dst


# the cases of the slice's f64 parity tests (tests/test_torch_*.py of the
# single-equation applications and fanDuct): name -> (tutorial,
# slice11_case options)
SLICE11_CASES = {
    "electrostaticFoam": ("electrostaticFoam", {}),
    "magneticFoam": ("magneticFoam", {}),
    "financialFoam": ("financialFoam", {}),
    "shallowWaterFoam": ("shallowWaterFoam", {"seed": SLICE11_SEED}),
    "solidEquilibriumDisplacementFoam": ("solidEquilibriumDisplacementFoam",
                                         {}),
    "solidDisplacementFoam": ("solidEquilibriumDisplacementFoam",
                              {"app": "solidDisplacementFoam"}),
    "potentialFreeSurfaceFoam": ("potentialFreeSurfaceFoam",
                                 {"seed": SLICE11_SEED}),
    # pitzDaily coarsened 2x per direction (3,056 cells)
    "adjointShapeOptimizationFoam": ("adjointShapeOptimizationFoam",
                                     {"seed": SLICE11_SEED, "scale": 0.5,
                                      "adjoint_fields": True,
                                      "write_interval": 1}),
    "dnsFoam": ("dnsFoam", {}),
    "mhdFoam": ("mhdFoam", {"controls": TIGHT_CONTROLS["mhdFoam"]}),
    "fanDuct": ("fanDuct", {"controls": TIGHT_CONTROLS["fanDuct"]}),
}


def slice11_parity_case(here, dst, name, cli, device=()):
    """The case `name` of SLICE11_CASES, fields written with 17 digits."""
    tut, opts = SLICE11_CASES[name]
    return slice11_case(here, dst, tut, cli, device=device,
                        write_precision=17, **opts)


# The physics oracles of the reference tests, each on its own setup
# through the port (the case writers copy those tests' dictionaries):
# tests/test_misc_solvers.py::test_electrostatic_capacitor,
# test_solver_batch4.py::test_magnetic_foam_bar_magnet,
# test_mhd.py::test_hartmann_profile,
# test_financial.py::test_black_scholes_european_call,
# test_shallowwater.py (the seiche, the lake at rest),
# test_soliddisplacement.py::test_uniaxial_tension_plane_stress,
# test_potentialfreesurface.py (the sloshing wave, the flat surface at
# rest), test_adjoint.py::test_adjoint_optimization_converges_and_bounds_
# alpha, test_randomprocesses.py (boxTurb, the forced box) and
# test_fanduct.py. Each returns (record, {check: bool}).

def _case_files(dst, blockmesh, files, cli):
    """A case of `files` ({rel: (body, class)}) with `blockmesh` as
    constant/polyMesh/blockMeshDict, meshed by `cli`'s blockMesh."""
    for rel, (body, cls) in dict(
            files, **{"constant/polyMesh/blockMeshDict":
                      (blockmesh, "dictionary")}).items():
        _write_text(dst, rel, _foam_header(cls, os.path.basename(rel))
                    + body)
    with quiet():
        check(cli(["blockMesh", "-case", dst]) == 0, "blockMesh failed")
    return dst


ORACLE_CHANNEL = """
convertToMeters 1;
vertices
(
    (0 0 0) (1 0 0) (1 0.1 0) (0 0.1 0)
    (0 0 0.01) (1 0 0.01) (1 0.1 0.01) (0 0.1 0.01)
);
blocks ( hex (0 1 2 3 4 5 6 7) (40 1 1) simpleGrading (1 1 1) );
boundary
(
    left  { type patch; faces ((0 4 7 3)); }
    right { type patch; faces ((2 6 5 1)); }
    walls { type wall; faces ((1 5 4 0) (3 7 6 2)); }
    frontAndBack { type empty; faces ((0 3 2 1) (4 5 6 7)); }
);
"""
ORACLE_CONTROL = """
application     {app};
startFrom       startTime;
startTime       0;
stopAt          endTime;
endTime         {end};
deltaT          {dt};
writeControl    timeStep;
writeInterval   1000;
writeFormat     ascii;
"""
ORACLE_SCHEMES = """
ddtSchemes {{ default {ddt}; }}
gradSchemes {{ default Gauss linear; }}
divSchemes {{ default none; div(phi,U) Gauss upwind; div(rhoFlux,rho) Gauss upwind; }}
laplacianSchemes {{ default Gauss linear corrected; }}
interpolationSchemes {{ default linear; }}
snGradSchemes {{ default corrected; }}
"""


def oracle_capacitor(root, cli, device):
    """Uniform space charge between grounded plates: phi follows the 1D
    Poisson parabola rho/(2 eps0) x (x - L) to 2% of its extreme."""
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.solvers.apps import run

    eps0, rho0, L = 8.85418782e-12, 1e-8, 1.0
    d = _case_files(os.path.join(root, "capacitor"), ORACLE_CHANNEL, {
        "system/controlDict": (ORACLE_CONTROL.format(
            app="electrostaticFoam", end=1, dt=1), "dictionary"),
        "system/fvSchemes": (ORACLE_SCHEMES.format(ddt="Euler"),
                             "dictionary"),
        "system/fvSolution": ("solvers { phi { solver PCG; preconditioner "
                              "DIC; tolerance 1e-10; relTol 0; } rho { "
                              "solver PBiCGStab; preconditioner DILU; "
                              "tolerance 1e-10; relTol 0; } }\n",
                              "dictionary"),
        "constant/physicalProperties": (
            "epsilon0 epsilon0 [ -1 -3 4 0 0 2 0 ] 8.85418782e-12;\n"
            "k k [ -1 0 2 0 0 1 0 ] 0;\n", "dictionary"),
        "0/phi": ("dimensions [1 2 -3 0 0 -1 0];\ninternalField uniform 0;\n"
                  "boundaryField { left { type fixedValue; value uniform 0; }"
                  " right { type fixedValue; value uniform 0; } walls { type "
                  "zeroGradient; } frontAndBack { type empty; } }\n",
                  "volScalarField"),
        "0/rho": ("dimensions [0 -3 1 0 0 1 0];\ninternalField uniform 1e-8;\n"
                  "boundaryField { left { type zeroGradient; } right { type "
                  "zeroGradient; } walls { type zeroGradient; } frontAndBack "
                  "{ type empty; } }\n", "volScalarField")}, cli)
    case = Case(d, device=device)
    with quiet():
        run(case, max_steps=1)
    phi = case.final_state["phi"].data.double().cpu().numpy()
    x = case.mesh.c[:, 0].double().cpu().numpy()
    exact = rho0 / (2 * eps0) * x * (x - L)
    err = float(np.abs(phi - exact).max() / np.abs(exact).max())
    return {"phi_rel_err": err}, {"phi on the Poisson parabola (< 2%)":
                                  err < 0.02}


ORACLE_MAGNET_BM = """
convertToMeters 1;
vertices
(
    (-1 -1 0) (1 -1 0) (1 1 0) (-1 1 0)
    (-1 -1 0.1) (1 -1 0.1) (1 1 0.1) (-1 1 0.1)
);
blocks ( hex (0 1 2 3 4 5 6 7) (40 40 1) simpleGrading (1 1 1) );
boundary
(
    sides { type patch; faces ((0 4 7 3) (2 6 5 1) (1 5 4 0) (3 7 6 2)); }
    frontAndBack { type empty; faces ((0 3 2 1) (4 5 6 7)); }
);
"""


def oracle_bar_magnet(root, cli, device):
    """A bar magnet magnetised along +x: B along +x inside it (more than
    5% of mu0 Mr), the return field above and below it opposing."""
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.solvers.apps import run

    mu0, Mr = 4e-7 * np.pi, 8e5
    d = _case_files(os.path.join(root, "magnet"), ORACLE_MAGNET_BM, {
        "system/controlDict": (ORACLE_CONTROL.format(
            app="magneticFoam", end=1, dt=1), "dictionary"),
        "system/fvSchemes": (ORACLE_SCHEMES.format(ddt="steadyState"),
                             "dictionary"),
        "system/fvSolution": ("solvers { psi { solver PCG; preconditioner "
                              "DIC; tolerance 1e-8; relTol 0; maxIter 2000; "
                              "} }\nSIMPLE { nNonOrthogonalCorrectors 0; }\n",
                              "dictionary"),
        "constant/transportProperties": (
            "magnets ( { box ((-0.25 -0.1 -1) (0.25 0.1 1)); mur 1; "
            "Mr 8e5; orientation (1 0 0); } );\n", "dictionary"),
        "0/psi": ("dimensions [0 1 0 0 0 1 0];\ninternalField uniform 0;\n"
                  "boundaryField { sides { type zeroGradient; } "
                  "frontAndBack { type empty; } }\n", "volScalarField")},
        cli)
    case = Case(d, device=device)
    with quiet():
        run(case)
    B = case.final_state["B"].double().cpu().numpy()
    c = case.mesh.c.double().cpu().numpy()
    inside = (np.abs(c[:, 0]) < 0.2) & (np.abs(c[:, 1]) < 0.08)
    side = (np.abs(c[:, 0]) < 0.2) & (np.abs(c[:, 1]) > 0.5)
    bx_in, bx_side = float(B[inside, 0].mean()), float(B[side, 0].mean())
    return {"bx_inside": bx_in, "bx_return": bx_side}, {
        "B finite": bool(np.isfinite(B).all()),
        "Bx inside > 0.05 mu0 Mr": bx_in > 0.05 * mu0 * Mr,
        "return field opposes": bx_side < 0.0}


ORACLE_HARTMANN = """
convertToMeters 1;
vertices (
    (0 -1 0) (20 -1 0) (20 1 0) (0 1 0)
    (0 -1 0.1) (20 -1 0.1) (20 1 0.1) (0 1 0.1)
);
blocks ( hex (0 1 2 3 4 5 6 7) (20 24 1) simpleGrading (1 1 1) );
boundary (
    inlet  { type patch; faces ((0 4 7 3)); }
    outlet { type patch; faces ((2 6 5 1)); }
    walls  { type wall; faces ((1 5 4 0) (3 7 6 2)); }
    frontAndBack { type empty; faces ((0 3 2 1) (4 5 6 7)); }
);
"""
# tests/test_mhd.py runs 150 steps; the profile is developed after 30
# (profile error 0.0064 at 30 steps, 0.0055 at 40, 0.00528 at 60, 0.00530
# at 100, on the CPU; cut from 60 for the script's time limit)
HARTMANN_STEPS = 30


def hartmann_fields(mesh, By=20.0):
    """U, p, B, pB of tests/test_mhd.py's Hartmann channel (U = 1 at the
    inlet, no slip on the walls, p fixed at the outlet, B = (0 By 0)
    everywhere on the boundary, pB fixed on the walls)."""
    from foamtpu_torch.bc import patchfields as pf
    from foamtpu_torch.core.dimensions import DimensionSet, dimVelocity
    from foamtpu_torch.core.fields import vol_scalar, vol_vector

    def vec(*v):
        return torch.tensor(v, dtype=mesh.v.dtype, device=mesh.device)

    ubcs, pbcs, bbcs, pbbcs = [], [], [], []
    for p in mesh.patches:
        if p.type == "empty":
            for lst in (ubcs, pbcs, bbcs, pbbcs):
                lst.append(pf.PatchField(kind="empty", vfrac=0.0))
            continue
        bbcs.append(pf.fixed_value(vec(0.0, By, 0.0)))
        if p.name == "inlet":
            ubcs.append(pf.fixed_value(vec(1.0, 0.0, 0.0)))
            pbcs.append(pf.zero_gradient())
            pbbcs.append(pf.zero_gradient())
        elif p.name == "outlet":
            ubcs.append(pf.zero_gradient())
            pbcs.append(pf.fixed_value(0.0))
            pbbcs.append(pf.zero_gradient())
        else:
            ubcs.append(pf.fixed_value(vec(0.0, 0.0, 0.0)))
            pbcs.append(pf.zero_gradient())
            pbbcs.append(pf.fixed_value(0.0))
    kin = DimensionSet.of(0, 2, -2)
    return (vol_vector(mesh, vec(1.0, 0.0, 0.0), name="U", dims=dimVelocity,
                       bcs=tuple(ubcs)),
            vol_scalar(mesh, 0.0, name="p", dims=kin, bcs=tuple(pbcs)),
            vol_vector(mesh, vec(0.0, By, 0.0), name="B", dims=dimVelocity,
                       bcs=tuple(bbcs)),
            vol_scalar(mesh, 0.0, name="pB", dims=kin, bcs=tuple(pbbcs)))


def oracle_hartmann(root, cli, device, steps=HARTMANN_STEPS):
    """Fully developed MHD channel flow with a transverse B at Ha = 20
    (HARTMANN_STEPS steps): past the development length the core profile
    follows (cosh Ha -
    cosh(Ha y/L)) / (cosh Ha - 1) to 0.1, the core is flat (> 0.9), and
    div(B) stays below 1e-3."""
    from foamtpu_torch.core.dictionary import parse_string
    from foamtpu_torch.mesh import blockmesh, to_device
    from foamtpu_torch.solvers import mhd

    mesh = to_device(blockmesh.generate(parse_string(ORACLE_HARTMANN)),
                     device)
    Ha = 20.0
    cfg = mhd.MhdConfig(nu=1.0, rho=1.0, mu_mag=1.0, sigma_c=1.0,
                        n_correctors=2)
    state = mhd.initial_state(mesh, *hartmann_fields(mesh))
    step = mhd.make_step(mesh, cfg)
    diag = None
    for _ in range(steps):
        state, diag = step(state, 0.005)
    u = state["U"].data.double().cpu().numpy()
    c = mesh.c.double().cpu().numpy()
    sel = np.abs(c[:, 0] - 15.5) < 0.5
    order = np.argsort(c[sel, 1])
    y, ux = c[sel, 1][order], u[sel, 0][order]
    prof = ux / ux.max()
    exact = (np.cosh(Ha) - np.cosh(Ha * y)) / (np.cosh(Ha) - 1.0)
    core = np.abs(y) < 0.8
    err = float(np.abs(prof[core] - exact[core]).max())
    div_b = float(diag["divB"])
    return {"profile_err": err, "divB": div_b,
            "core_min": float(prof[np.abs(y) < 0.5].min())}, {
        "U finite": bool(np.isfinite(u).all()), "div(B) < 1e-3": div_b < 1e-3,
        "cosh profile to 0.1": err < 0.1,
        "flat core > 0.9": float(prof[np.abs(y) < 0.5].min()) > 0.9}


def oracle_black_scholes(root, cli, device):
    """A European call (K 50, r 0.05, sigma 0.2, tau 0.5) on 300 cells:
    V within 0.15 of Black-Scholes for 25 < S < 100, 0.05 on average."""
    import math

    from foamtpu_torch.core.case import Case
    from foamtpu_torch.solvers.apps import run

    K, r, sigma, tau = 50.0, 0.05, 0.2, 0.5
    S = 1.0 + (np.arange(300) + 0.5) * (149.0 / 300.0)
    bm = """
convertToMeters 1;
vertices ( (1 0 0) (150 0 0) (150 1 0) (1 1 0)
           (1 0 1) (150 0 1) (150 1 1) (1 1 1) );
blocks ( hex (0 1 2 3 4 5 6 7) (300 1 1) simpleGrading (1 1 1) );
boundary (
  low  { type patch; faces ((0 4 7 3)); }
  high { type patch; faces ((2 6 5 1)); }
  empty1 { type empty; faces ((1 5 4 0) (3 7 6 2) (0 3 2 1) (4 5 6 7)); }
);
"""
    payoff = "\n".join(repr(float(max(s - K, 0.0))) for s in S)
    d = _case_files(os.path.join(root, "call"), bm, {
        "system/controlDict": (
            f"application financialFoam; startFrom startTime; startTime 0;"
            f"\nstopAt endTime; endTime {tau}; deltaT 0.005;\nwriteControl "
            "timeStep; writeInterval 1000; writeFormat ascii;\n",
            "dictionary"),
        "system/fvSchemes": (
            "ddtSchemes { default Euler; } gradSchemes { default Gauss "
            "linear; }\ndivSchemes { default none; div(phi,V) Gauss linear; "
            "}\nlaplacianSchemes { default Gauss linear orthogonal; }\n"
            "interpolationSchemes { default linear; } snGradSchemes { "
            "default orthogonal; }\n", "dictionary"),
        "system/fvSolution": ("solvers { V { solver PBiCGStab; tolerance "
                              "1e-10; relTol 0; maxIter 500; } }\n",
                              "dictionary"),
        "constant/financialProperties": (f"sigma {sigma};\nr {r};\n",
                                         "dictionary"),
        "0/V": ("dimensions [0 0 0 0 0 0 0];\ninternalField nonuniform "
                f"List<scalar>\n300\n(\n{payoff}\n)\n;\nboundaryField\n{{\n"
                "    low { type fixedValue; value uniform 0; }\n"
                "    high { type fixedValue; value uniform "
                f"{150.0 - K * math.exp(-r * tau)}; }}\n"
                "    empty1 { type empty; }\n}\n", "volScalarField")}, cli)
    case = Case(d, device=device)
    with quiet():
        run(case)

    def bs(s):
        d1 = ((math.log(s / K) + (r + 0.5 * sigma ** 2) * tau)
              / (sigma * math.sqrt(tau)))
        d2 = d1 - sigma * math.sqrt(tau)
        n = lambda x: 0.5 * (1.0 + math.erf(x / math.sqrt(2)))  # noqa: E731
        return s * n(d1) - K * math.exp(-r * tau) * n(d2)

    V = case.final_state["V"].data.double().cpu().numpy()
    exact = np.array([bs(s) for s in S])
    sel = (S > 25) & (S < 100)
    err = np.abs(V[sel] - exact[sel])
    return {"err_max": float(err.max()), "err_mean": float(err.mean())}, {
        "|V - BS| < 0.15": float(err.max()) < 0.15,
        "mean |V - BS| < 0.05": float(err.mean()) < 0.05}


ORACLE_BASIN_SW = """
convertToMeters 1;
vertices
(
    (0 0 0) (10 0 0) (10 1 0) (0 1 0)
    (0 0 1) (10 0 1) (10 1 1) (0 1 1)
);
blocks ( hex (0 1 2 3 4 5 6 7) (40 4 1) simpleGrading (1 1 1) );
boundary
(
    sides { type wall; faces ((0 4 7 3) (2 6 5 1) (1 5 4 0) (3 7 6 2)); }
    frontAndBack { type empty; faces ((0 3 2 1) (4 5 6 7)); }
);
"""


def _sw_setup(device, h_init, h0):
    from foamtpu_torch.bc import patchfields as pf
    from foamtpu_torch.core.dictionary import parse_string
    from foamtpu_torch.core.dimensions import DimensionSet
    from foamtpu_torch.core.fields import vol_scalar, vol_vector
    from foamtpu_torch.mesh import blockmesh, to_device

    mesh = to_device(blockmesh.generate(parse_string(ORACLE_BASIN_SW)),
                     device)
    c = mesh.c.double().cpu().numpy()
    hb, ub = [], []
    for patch in mesh.patches:
        if patch.type == "empty":
            hb.append(pf.PatchField(kind="empty", vfrac=0.0))
            ub.append(pf.PatchField(kind="empty", vfrac=0.0))
        else:
            hb.append(pf.zero_gradient())
            ub.append(pf.PatchField(kind="slip", vfrac=0.0))
    h = vol_scalar(mesh, 1.0, name="h", dims=DimensionSet.of(0, 1, 0),
                   bcs=tuple(hb)).with_data(torch.tensor(
                       h_init(c), dtype=mesh.v.dtype, device=mesh.device))
    hU = vol_vector(mesh, (0.0, 0.0, 0.0), name="hU",
                    dims=DimensionSet.of(0, 2, -1), bcs=tuple(ub))
    return mesh, c, h, hU, h0(c)


def oracle_shallow_water(root, cli, device):
    """The seiche: a cosine surface in a closed flat basin flips sign
    after half a period L/sqrt(gH) (correlation < -0.6, amplitude kept
    above 30%) and conserves volume to 1e-4; the lake at rest: a bed bump
    under a flat surface stays at rest (|U| < 5e-3 after 50 steps, the
    surface within 2e-3)."""
    import math

    from foamtpu_torch.solvers import shallowwater as sw

    amp, H, L = 0.01, 1.0, 10.0
    mesh, c, h, hU, h0 = _sw_setup(
        device, lambda c: H + amp * np.cos(math.pi * c[:, 0] / L),
        lambda c: np.zeros(c.shape[0]))
    pert0 = amp * np.cos(math.pi * c[:, 0] / L)
    cfg = sw.ShallowWaterConfig(n_outer=2, n_correctors=2,
                                div_scheme="linear")
    state = sw.initial_state(mesh, h, hU, torch.tensor(
        h0, dtype=mesh.v.dtype, device=mesh.device))
    v = mesh.v.double().cpu().numpy()
    vol0 = float((h.data.double().cpu().numpy() * v).sum())
    step = sw.make_step(mesh, cfg)
    for _ in range(int(round(L / math.sqrt(9.81 * H) / 0.02))):
        state, _ = step(state, 0.02)
    hd = state["h"].data.double().cpu().numpy()
    pert1 = hd - H
    corr = float((pert0 * pert1).sum()
                 / max(np.linalg.norm(pert0) * np.linalg.norm(pert1), 1e-30))
    dvol = abs(float((hd * v).sum()) - vol0) / vol0
    rec = {"seiche_corr": corr, "seiche_dvol": dvol,
           "seiche_amp": float(np.abs(pert1).max())}
    ck = {"seiche finite": bool(np.isfinite(hd).all()),
          "seiche volume to 1e-4": dvol < 1e-4,
          "seiche phase flip (corr < -0.6)": corr < -0.6,
          "seiche not over-damped": rec["seiche_amp"] > 0.3 * amp}

    bump = lambda c: 0.3 * np.exp(-((c[:, 0] - 5.0) / 1.5) ** 2)  # noqa
    mesh, c, h, hU, h0 = _sw_setup(device, lambda c: 1.0 - bump(c), bump)
    cfg = sw.ShallowWaterConfig(n_outer=1, n_correctors=2,
                                div_scheme="linear")
    state = sw.initial_state(mesh, h, hU, torch.tensor(
        h0, dtype=mesh.v.dtype, device=mesh.device))
    step = sw.make_step(mesh, cfg)
    for _ in range(50):
        state, _ = step(state, 0.02)
    U = state["U"].data.double().cpu().numpy()
    surf = state["h"].data.double().cpu().numpy() + h0
    rec.update(lake_u_max=float(np.abs(U).max()),
               lake_surface_dev=float(np.abs(surf - 1.0).max()))
    ck.update({"lake finite": bool(np.isfinite(U).all()),
               "lake at rest (|U| < 5e-3)": rec["lake_u_max"] < 5e-3,
               "lake surface flat to 2e-3": rec["lake_surface_dev"] < 2e-3})
    return rec, ck


ORACLE_PLATE = """
convertToMeters 1;
vertices
(
    (0 0 0) (1 0 0) (1 0.5 0) (0 0.5 0)
    (0 0 0.01) (1 0 0.01) (1 0.5 0.01) (0 0.5 0.01)
);
blocks ( hex (0 1 2 3 4 5 6 7) (20 10 1) simpleGrading (1 1 1) );
boundary
(
    left   { type symmetryPlane; faces ((0 4 7 3)); }
    right  { type patch; faces ((2 6 5 1)); }
    bottom { type symmetryPlane; faces ((1 5 4 0)); }
    top    { type patch; faces ((3 7 6 2)); }
    frontAndBack { type empty; faces ((0 3 2 1) (4 5 6 7)); }
);
"""


def oracle_tension(root, cli, device):
    """A quarter plate under uniaxial tension (plane stress, 1 MPa, steel)
    after 6 outer blocks of 20 corrections: Dx = (S/E) x and Dy =
    -(nu S/E) y to 5% of S/E, sigma_xx = S to 2% on average and 10%
    everywhere, sigma_yy below 10% of S."""
    from foamtpu_torch.bc import patchfields as pf
    from foamtpu_torch.core.dictionary import parse_string
    from foamtpu_torch.core.dimensions import DimensionSet
    from foamtpu_torch.core.fields import vol_vector
    from foamtpu_torch.mesh import blockmesh, to_device
    from foamtpu_torch.solvers import soliddisplacement as sd

    E, NU, RHO, SIGMA = 2e11, 0.3, 7854.0, 1e6
    mesh = to_device(blockmesh.generate(parse_string(ORACLE_PLATE)), device)
    zero3 = torch.zeros(3, dtype=mesh.v.dtype, device=mesh.device)
    bcs, traction = [], []
    for patch in mesh.patches:
        if patch.type == "empty":
            bcs.append(pf.PatchField(kind="empty", vfrac=0.0))
            traction.append(None)
        elif patch.name in ("left", "bottom"):
            bcs.append(pf.PatchField(kind="symmetryPlane", vfrac=0.0))
            traction.append(None)
        else:
            bcs.append(pf.fixed_gradient(zero3))
            traction.append((np.array([SIGMA if patch.name == "right"
                                       else 0.0, 0.0, 0.0]) / RHO, 0.0))
    D = vol_vector(mesh, zero3, name="D", dims=DimensionSet.of(0, 1, 0),
                   bcs=tuple(bcs))
    cfg = sd.SolidConfig(rho=RHO, E=E, nu=NU, plane_stress=True,
                         steady=True, n_corr=20, traction=tuple(traction))
    state = sd.initial_state(mesh, D, steady=True)
    step = sd.make_step(mesh, cfg)
    for _ in range(6):
        state, _ = step(state, 1.0)
    Dd = state["D"].data.double().cpu().numpy()
    c = mesh.c.double().cpu().numpy()
    eps = SIGMA / E
    sig = sd.sigma_of(mesh, state["D"], cfg).double().cpu().numpy()
    rec = {"dx_err": float(np.abs(Dd[:, 0] - eps * c[:, 0]).max() / eps),
           "dy_err": float(np.abs(Dd[:, 1] + NU * eps * c[:, 1]).max() / eps),
           "sxx_mean_err": abs(float(sig[:, 0, 0].mean()) - SIGMA) / SIGMA,
           "sxx_max_err": float(np.abs(sig[:, 0, 0] - SIGMA).max()) / SIGMA,
           "syy_max": float(np.abs(sig[:, 1, 1]).max()) / SIGMA}
    return rec, {"Dx linear to 5%": rec["dx_err"] < 0.05,
                 "Dy linear to 5%": rec["dy_err"] < 0.05,
                 "sigma_xx mean to 2%": rec["sxx_mean_err"] < 0.02,
                 "sigma_xx to 10%": rec["sxx_max_err"] < 0.1,
                 "sigma_yy < 10%": rec["syy_max"] < 0.1}


ORACLE_BASIN_PFS = """
convertToMeters 1;
vertices
(
    (0 0 0) (1 0 0) (1 0.5 0) (0 0.5 0)
    (0 0 0.05) (1 0 0.05) (1 0.5 0.05) (0 0.5 0.05)
);
blocks ( hex (0 1 2 3 4 5 6 7) (20 10 1) simpleGrading (1 1 1) );
boundary
(
    freeSurface { type patch; faces ((3 7 6 2)); }
    walls { type wall; faces ((2 6 5 1) (0 4 7 3) (1 5 4 0)); }
    frontAndBack { type empty; faces ((0 3 2 1) (4 5 6 7)); }
);
"""


def _pfs_setup(device, zeta_amp):
    from foamtpu_torch.core.dictionary import parse_string
    from foamtpu_torch.core.fields import vol_scalar, vol_vector
    from foamtpu_torch.mesh import blockmesh, to_device
    from foamtpu_torch.solvers import piso
    from foamtpu_torch.solvers import potentialfreesurface as pfs

    mesh = to_device(blockmesh.generate(parse_string(ORACLE_BASIN_PFS)),
                     device)
    fs = next(i for i, p in enumerate(mesh.patches)
              if p.name == "freeSurface")
    cfg = pfs.FreeSurfaceConfig(
        flow=piso.PisoConfig(nu=1e-6, n_correctors=2,
                             momentum_predictor=False),
        fs_patch=fs, g_mag=9.81)
    xf = mesh.cf[mesh.patches[fs].slice, 0].double().cpu().numpy()
    state = pfs.initial_state(
        mesh, vol_vector(mesh, (0.0, 0.0, 0.0), name="U"),
        vol_scalar(mesh, 0.0, name="p"), cfg,
        zeta0=zeta_amp * np.cos(np.pi * xf))
    return mesh, state, cfg, xf


def oracle_free_surface(root, cli, device):
    """A tilted surface sloshes: in 80 steps of 0.01 s the elevation at
    the left end falls below -10% of its start (a sign flip), stays below
    3x its start, and the surface volume stays at zero (< 1e-8); a flat
    surface stays at rest (|U| < 1e-6, |zeta| < 1e-8 after 5 steps)."""
    from foamtpu_torch.solvers import potentialfreesurface as pfs

    mesh, state, cfg, xf = _pfs_setup(device, 0.01)
    step = pfs.make_step(mesh, cfg)
    i0 = int(np.argmin(xf))
    left0 = float(state["zeta"][i0])
    z = []
    for _ in range(80):
        state, _ = step(state, 0.01)
        z.append(float(state["zeta"][i0]))
    z = np.asarray(z)
    w = mesh.mag_sf[mesh.patches[cfg.fs_patch].slice].double()
    vol = abs(float((state["zeta"].double() * w).sum()))
    rec = {"left0": left0, "left_min": float(z.min()),
           "left_abs_max": float(np.abs(z).max()), "surface_volume": vol}
    ck = {"wave: sign flip": left0 > 0 and rec["left_min"] < -0.1 * left0,
          "wave: bounded (< 3x)": rec["left_abs_max"] < 3.0 * left0,
          "surface volume < 1e-8": vol < 1e-8}
    mesh, state, cfg, _ = _pfs_setup(device, 0.0)
    step = pfs.make_step(mesh, cfg)
    for _ in range(5):
        state, _ = step(state, 0.01)
    rec["rest_u_max"] = float(torch.abs(state["U"].data).max())
    rec["rest_zeta_max"] = float(torch.abs(state["zeta"]).max())
    ck.update({"flat surface at rest (|U| < 1e-6)": rec["rest_u_max"] < 1e-6,
               "flat surface stays (< 1e-8)": rec["rest_zeta_max"] < 1e-8})
    return rec, ck


ORACLE_DUCT = """
convertToMeters 1;
vertices
(
    (0 0 0) (1 0 0) (1 0.2 0) (0 0.2 0)
    (0 0 0.02) (1 0 0.02) (1 0.2 0.02) (0 0.2 0.02)
);
blocks ( hex (0 1 2 3 4 5 6 7) (25 10 1) simpleGrading (1 1 1) );
boundary
(
    inlet  { type patch; faces ((0 4 7 3)); }
    outlet { type patch; faces ((2 6 5 1)); }
    walls  { type wall; faces ((1 5 4 0) (3 7 6 2)); }
    frontAndBack { type empty; faces ((0 3 2 1) (4 5 6 7)); }
);
"""


def oracle_adjoint(root, cli, device, sweeps=30):
    """30 optimisation sweeps of tests/test_adjoint.py's duct: the primal
    p residual halves, alpha stays in [0, 200] and at zero in the inlet
    cells, the adjoint velocity responds and the objective is finite (it
    is recorded: as alpha fills the pocket its alpha U^2 term grows)."""
    from foamtpu_torch.bc import patchfields as pf
    from foamtpu_torch.core.dictionary import parse_string
    from foamtpu_torch.core.fields import vol_scalar, vol_vector
    from foamtpu_torch.mesh import blockmesh, to_device
    from foamtpu_torch.solvers import adjoint
    from foamtpu_torch.solvers import simple as simple_mod

    mesh = to_device(blockmesh.generate(parse_string(ORACLE_DUCT)), device)

    def vec(*v):
        return torch.tensor(v, dtype=mesh.v.dtype, device=mesh.device)

    ub, pb, uab, pab = [], [], [], []
    for pt in mesh.patches:
        if pt.type == "empty":
            for lst in (ub, pb, uab, pab):
                lst.append(pf.PatchField(kind="empty", vfrac=0.0))
        elif pt.name == "inlet":
            ub.append(pf.fixed_value(vec(1.0, 0.0, 0.0)))
            pb.append(pf.zero_gradient())
            uab.append(pf.fixed_value(vec(-1.0, 0.0, 0.0)))
            pab.append(pf.zero_gradient())
        elif pt.name == "outlet":
            ub.append(pf.zero_gradient())
            pb.append(pf.fixed_value(0.0))
            uab.append(pf.zero_gradient())
            pab.append(pf.fixed_value(0.0))
        else:
            ub.append(pf.fixed_value(vec(0.0, 0.0, 0.0)))
            pb.append(pf.zero_gradient())
            uab.append(pf.fixed_value(vec(0.0, 0.0, 0.0)))
            pab.append(pf.zero_gradient())
    U = vol_vector(mesh, (1.0, 0.0, 0.0), name="U", bcs=tuple(ub))
    p = vol_scalar(mesh, 0.0, name="p", bcs=tuple(pb))
    Ua = vol_vector(mesh, (0.0, 0.0, 0.0), name="Ua", bcs=tuple(uab))
    pa = vol_scalar(mesh, 0.0, name="pa", bcs=tuple(pab))
    inlet = mesh.patch("inlet")
    inlet_cells = torch.unique(mesh.owner[inlet.slice])
    cfg = adjoint.AdjointConfig(
        flow=simple_mod.SimpleConfig(nu=1e-3, alpha_u=0.7, alpha_p=0.3),
        lam=1e3, alpha_max=200.0, alpha_relax=0.1,
        zero_alpha_cells=inlet_cells)
    state = adjoint.initial_state(mesh, U, p, Ua, pa, cfg)
    step = adjoint.make_step(mesh, cfg)
    objectives, first = [], None
    for i in range(sweeps):
        state, diag = step(state)
        objectives.append(float(diag["objective"]))
        if i == 0:
            first = float(torch.max(torch.as_tensor(diag["p_initial"])))
    last = float(torch.max(torch.as_tensor(diag["p_initial"])))
    a = state["alpha"].double().cpu().numpy()
    rec = {"p_initial_first": first, "p_initial_last": last,
           "objective_first": objectives[0], "objective_last": objectives[-1],
           "alpha_max": float(a.max()),
           "ua_max": float(torch.abs(state["Ua"].data).max())}
    return rec, {
        "primal converging (p residual halves)": last < 0.5 * first,
        "0 <= alpha <= alphaMax": bool(a.min() >= 0.0 and a.max() <= 200.0),
        "alpha 0 at the inlet": float(np.abs(
            a[inlet_cells.cpu().numpy()]).max()) == 0.0,
        "adjoint responds": rec["ua_max"] > 1e-6,
        "objective finite": bool(np.isfinite(objectives).all())}


def _dns_box(dst, cli, device):
    """tests/test_randomprocesses.py::test_dnsfoam_forced_box's 16^3 box,
    meshed and filled by boxTurb (Ea 0.5, k0 12, seed 2)."""
    box = ("convertToMeters 1;\nvertices ( (0 0 0) (1 0 0) (1 1 0) (0 1 0) "
           "(0 0 1) (1 0 1) (1 1 1) (0 1 1) );\nblocks ( hex (0 1 2 3 4 5 6 "
           "7) (16 16 16) simpleGrading (1 1 1) );\nboundary ( walls { type "
           "wall;\n  faces ((0 4 7 3) (2 6 5 1) (1 5 4 0) (3 7 6 2) (0 3 2 "
           "1) (4 5 6 7)); } );\n")
    _case_files(dst, box, {
        "system/controlDict": (
            "application dnsFoam; startFrom startTime; startTime 0;\nstopAt "
            "endTime; endTime 1; deltaT 0.005;\nwriteControl timeStep; "
            "writeInterval 1000; writeFormat ascii;\n", "dictionary"),
        "system/fvSchemes": (
            "ddtSchemes { default Euler; } gradSchemes { default Gauss "
            "linear; }\ndivSchemes { default none; div(phi,U) Gauss linear; "
            "}\nlaplacianSchemes { default Gauss linear corrected; }\n"
            "interpolationSchemes { default linear; } snGradSchemes { "
            "default corrected; }\n", "dictionary"),
        "system/fvSolution": (
            "solvers\n{\n    p { solver PCG; preconditioner DIC; tolerance "
            "1e-6; relTol 0.05; }\n    U { solver smoothSolver; smoother "
            "GaussSeidel; tolerance 1e-6; relTol 0; nSweeps 2; }\n}\nPISO "
            "{ nCorrectors 2; }\n", "dictionary"),
        "constant/transportProperties": (
            "transportModel Newtonian;\nnu nu [0 2 -1 0 0 0 0] 0.0025;\n",
            "dictionary"),
        "constant/boxTurbDict": ("Ea 0.5; k0 12; seed 2;\n", "dictionary"),
        "0/U": ("dimensions [0 1 -1 0 0 0 0];\ninternalField uniform (0 0 0)"
                ";\nboundaryField { walls { type slip; } }\n",
                "volVectorField"),
        "0/p": ("dimensions [0 2 -2 0 0 0 0];\ninternalField uniform 0;\n"
                "boundaryField { walls { type zeroGradient; } }\n",
                "volScalarField")}, cli)
    with quiet():
        check(cli(["boxTurb", "-case", dst, "-device", device]) == 0,
              "boxTurb failed")
    return dst


def oracle_dns(root, cli, device, steps=20):
    """boxTurb on a 32^3 grid (Ea 2, k0 8 pi, seed 3) is divergence-free
    to 1e-10 with k = 3 to 1e-6 and isotropic within 1.6; the boxTurb
    command writes k = 0.75 to 1e-3 on the 16^3 box; the forced box
    through run(case) for 20 steps stays finite with 0.05 < k < 5."""
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.models import randomprocesses as rp
    from foamtpu_torch.solvers.apps import run

    u = rp.box_turb((32, 32, 32), (1.0, 1.0, 1.0), Ea=2.0, k0=8 * np.pi,
                    seed=3)
    tke = 0.5 * float(np.mean(np.sum(u * u, axis=-1)))
    e = np.mean(u ** 2, axis=(0, 1, 2))
    div = rp.div_rms(u, (1.0, 1.0, 1.0))
    case = Case(_dns_box(os.path.join(root, "dns"), cli, device),
                device=device)
    U0 = case.read_field("U").data.double().cpu().numpy()
    k0 = 0.5 * float(np.mean(np.sum(U0 * U0, axis=1)))
    with quiet():
        run(case, max_steps=steps)
    U = case.final_state["U"].data.double().cpu().numpy()
    k1 = 0.5 * float(np.mean(np.sum(U * U, axis=1)))
    rec = {"boxturb_k": tke, "boxturb_div_rms": div,
           "boxturb_anisotropy": float(e.max() / e.min()),
           "cli_k": k0, "forced_k": k1, "steps": case.time.index}
    return rec, {"boxTurb k = 3": abs(tke - 3.0) < 1e-6,
                 "boxTurb div-free": div < 1e-10,
                 "boxTurb isotropic": rec["boxturb_anisotropy"] < 1.6,
                 "boxTurb command k = 0.75 to 1e-3":
                 abs(k0 - 0.75) / 0.75 < 1e-3,
                 "forced box finite": bool(np.isfinite(U).all()),
                 "forced box alive (0.05 < k < 5)": 0.05 < k1 < 5.0}


FANDUCT_STEPS = 60


def oracle_fanduct(root, cli, device, steps=FANDUCT_STEPS):
    """fanDuct as its Allrun makes it (blockMesh, topoSet, createBaffles)
    through run(case) for 60 steps: the fan (jump 0.05 - Q) blows +x
    (mean Ux > 1e-3) and the pressure downstream exceeds upstream by
    0.01."""
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.solvers.apps import run

    case = Case(slice11_case(REPO_DIR,
                             os.path.join(root, "fanDuct"), "fanDuct", cli),
                device=device)
    with quiet():
        run(case, max_steps=steps)
    U = case.final_state["U"].data.double().cpu().numpy()
    p = case.final_state["p"].data.double().cpu().numpy()
    x = case.mesh.c[:, 0].double().cpu().numpy()
    rec = {"ux_mean": float(U[:, 0].mean()),
           "dp": float(p[x > 1.0].mean() - p[x < 1.0].mean()),
           "steps": case.time.index}
    return rec, {"finite": bool(np.isfinite(U).all() and np.isfinite(p).all()),
                 "mean Ux > 1e-3": rec["ux_mean"] > 1e-3,
                 "p downstream > upstream + 0.01": rec["dp"] > 0.01}


SLICE11_ORACLES = {
    "electrostaticFoam": oracle_capacitor,
    "magneticFoam": oracle_bar_magnet,
    "mhdFoam": oracle_hartmann,
    "financialFoam": oracle_black_scholes,
    "shallowWaterFoam": oracle_shallow_water,
    "solidEquilibriumDisplacementFoam": oracle_tension,
    "potentialFreeSurfaceFoam": oracle_free_surface,
    "adjointShapeOptimizationFoam": oracle_adjoint,
    "dnsFoam": oracle_dns,
    "fanDuct": oracle_fanduct,
}
# held on the CPU only (tests/test_torch_freesurface.py), since the
# Lagrangian slice: 5.6 s and 5.3 s of the card's script
CPU_ONLY_ORACLES = ("shallowWaterFoam", "potentialFreeSurfaceFoam")


# The runs of the solvers_small phase: name -> (tutorial, slice11_case
# options, steps; None runs the tutorial's own endTime). Cut: hartmann
# 200 -> 20 steps (as shipped it returns NaN at step 33 in the JAX
# package), squareBump 500 -> 50, movingOscillatingBox 100 -> 20 (it
# ships water at rest), adjoint's pitzDaily 2000 -> 5 sweeps (its primal
# runs linear convection in both packages, |U| 1709 m/s after 5 sweeps
# from an inlet of 10), fanDuct 100 -> 60 (tests/test_fanduct.py's
# depth; its oracle runs 60) and, for the room of the turbulence slice,
# -> 30, plateTension 100 -> 20 iterations (in float32 the D residual
# stays above its 1e-6 tolerance in both packages, so it would run all
# 100, 32 s on the card; in float64 it stops after 2) and, for that room,
# -> 10. For the Lagrangian slice's room: hartmann 10 steps, fanDuct 15,
# plateTension 5 (goldens regenerated at those depths).
SMALL_RUNS = {
    "electrostaticFoam": ("electrostaticFoam", {}, None),
    "magneticFoam": ("magneticFoam", {}, None),
    "mhdFoam": ("mhdFoam", {}, 10),
    "financialFoam": ("financialFoam", {}, None),
    "shallowWaterFoam": ("shallowWaterFoam", {}, 50),
    "solidEquilibriumDisplacementFoam": ("solidEquilibriumDisplacementFoam",
                                         {}, 5),
    "potentialFreeSurfaceFoam": ("potentialFreeSurfaceFoam", {}, 20),
    "adjointShapeOptimizationFoam": ("adjointShapeOptimizationFoam", {}, 5),
    "dnsFoam": ("dnsFoam", {}, None),
    "fanDuct": ("fanDuct", {}, FANDUCT_STEPS // 4),
}
# the fields each run's scalars read from its final state
SMALL_FIELDS = {
    "electrostaticFoam": ("phi", "rho"), "magneticFoam": ("psi", "B"),
    "mhdFoam": ("U", "p", "B", "pB"), "financialFoam": ("V",),
    "shallowWaterFoam": ("h", "hU"),
    "solidEquilibriumDisplacementFoam": ("D",),
    "potentialFreeSurfaceFoam": ("U", "p"),
    "adjointShapeOptimizationFoam": ("U", "p", "Ua", "alpha"),
    "dnsFoam": ("U", "p"), "fanDuct": ("U", "p"),
}


def small_arrays(name, final_state, host):
    """SMALL_FIELDS[name] of a run's final state as float64 numpy."""
    st = final_state.get("state", final_state)
    if not isinstance(st, dict):
        st = final_state
    return {k: np.asarray(host(getattr(st[k], "data", st[k])),
                          dtype=np.float64) for k in SMALL_FIELDS[name]}


def small_scalars(a, v):
    """Per field: the volume mean and the extremes (scalars), the volume
    mean of the x component and of the magnitude and the largest
    magnitude (vectors)."""
    out, vol = {}, v.sum()
    for k, x in a.items():
        if x.ndim == 2:
            mag = np.linalg.norm(x, axis=1)
            out.update({f"{k}x_mean": float((x[:, 0] * v).sum() / vol),
                        f"{k}_mag_mean": float((mag * v).sum() / vol),
                        f"{k}_mag_max": float(mag.max())})
        else:
            out.update({f"{k}_mean": float((x * v).sum() / vol),
                        f"{k}_min": float(x.min()), f"{k}_max": float(x.max())})
    return out


# goldens from the JAX package (CPU, float32) and its spread under
# round-off (the larger of |float32 - float64| and the change a 1e-7
# perturbation of the start makes in float32): `python
# tests/test_torch_electromagnetics.py goldens [--perturb]`
SMALL_GOLDEN = {
    'electrostaticFoam': {
        'phi_mean': -44.58802816227079,
        'phi_min': -95.85265350341797,
        'phi_max': 83.38238525390625,
        'rho_mean': 9.99999993922529e-09,
        'rho_min': 9.99999993922529e-09,
        'rho_max': 9.99999993922529e-09,
    },
    'magneticFoam': {
        'psi_mean': -5.802154541459714e-05,
        'psi_min': -7835.83447265625,
        'psi_max': 7835.83447265625,
        'Bx_mean': -0.33590922954081176,
        'B_mag_mean': 0.3552082484288425,
        'B_mag_max': 9.75567840490065,
    },
    'mhdFoam': {
        'Ux_mean': 1.003910579327494,
        'U_mag_mean': 1.032593617516307,
        'U_mag_max': 2.694297736907777,
        'p_mean': 122.80906175374986,
        'p_min': -189.6042938232422,
        'p_max': 438.309814453125,
        'Bx_mean': -6.165355443954468e-08,
        'B_mag_mean': 20.136872868984966,
        'B_mag_max': 23.353456435728383,
        'pB_mean': 0.6590078040867229,
        'pB_min': -0.0006286835996434093,
        'pB_max': 1.3796888589859009,
    },
    'financialFoam': {
        'V_mean': 34.5950642263326,
        'V_min': -2.0335225391027745e-36,
        'V_max': 100.99732208251953,
    },
    'shallowWaterFoam': {
        'h_mean': 1.0000009163618087,
        'h_min': 0.6866312623023987,
        'h_max': 1.3611342906951904,
        'hUx_mean': 0.3610961887985468,
        'hU_mag_mean': 0.38387707337174487,
        'hU_mag_max': 0.9948621392250149,
    },
    'solidEquilibriumDisplacementFoam': {
        'Dx_mean': 5.000088052895535e-06,
        'D_mag_mean': 5.128229674130983e-06,
        'D_mag_max': 9.982882280291286e-06,
    },
    'potentialFreeSurfaceFoam': {
        'Ux_mean': 0.0,
        'U_mag_mean': 0.0,
        'U_mag_max': 0.0,
        'p_mean': 0.0,
        'p_min': 0.0,
        'p_max': 0.0,
    },
    'adjointShapeOptimizationFoam': {
        'Ux_mean': 7.681876345360851,
        'U_mag_mean': 9.848587126886002,
        'U_mag_max': 1709.203669176814,
        'p_mean': 58.87727890948244,
        'p_min': -405557.5625,
        'p_max': 32941.95703125,
        'Uax_mean': 0.0,
        'Ua_mag_mean': 0.0,
        'Ua_mag_max': 0.0,
        'alpha_mean': 0.0,
        'alpha_min': 0.0,
        'alpha_max': 0.0,
    },
    'dnsFoam': {
        'Ux_mean': 0.00037524018917878266,
        'U_mag_mean': 0.925445573142785,
        'U_mag_max': 2.9641292813455546,
        'p_mean': -0.5116129353163608,
        'p_min': -2.72687029838562,
        'p_max': 1.445785403251648,
    },
    'fanDuct': {
        'Ux_mean': 0.0018694896381930446,
        'U_mag_mean': 0.0018694896387665906,
        'U_mag_max': 0.002138913150438451,
        'p_mean': 5.28496373750191e-05,
        'p_min': -0.024396954104304314,
        'p_max': 0.02448314055800438,
    },
}
SMALL_SPREAD = {
    'electrostaticFoam': {
        'phi_mean': 1.8844288170782875e-05,
        'phi_min': 4.040143694794551e-05,
        'phi_max': 2.1514920973686458e-06,
        'rho_mean': 2.2066521607176687e-15,
        'rho_min': 2.2066482878580407e-15,
        'rho_max': 2.206655050886729e-15,
    },
    'magneticFoam': {
        'psi_mean': 5.802154427772876e-05,
        'psi_min': 0.0009233767250407254,
        'psi_max': 0.0009233767359546619,
        'Bx_mean': 2.35080488408812e-08,
        'B_mag_mean': 2.5285150306864068e-08,
        'B_mag_max': 1.8848828329254275e-06,
    },
    'mhdFoam': {
        'Ux_mean': 6.14013522848289e-06,
        'U_mag_mean': 5.707912485108935e-06,
        'U_mag_max': 0.00013475053993428077,
        'p_mean': 0.04489642083646572,
        'p_min': 0.1021881103515625,
        'p_max': 0.04779052734375,
        'Bx_mean': 3.7699937820434574e-08,
        'B_mag_mean': 7.4337149982284245e-06,
        'B_mag_max': 8.843777330014291e-05,
        'pB_mean': 8.697611439856257e-05,
        'pB_min': 4.981353413313627e-06,
        'pB_max': 3.819886995803934e-05,
    },
    'financialFoam': {
        'V_mean': 0.0003212748666783227,
        'V_min': 3.3789918376792634e-36,
        'V_max': 9.362864591366815e-05,
    },
    'shallowWaterFoam': {
        'h_mean': 9.073993720853935e-07,
        'h_min': 5.45424545972395e-07,
        'h_max': 1.6115710366193525e-06,
        'hUx_mean': 2.2032810370609113e-07,
        'hU_mag_mean': 1.8995141953803696e-07,
        'hU_mag_max': 1.6512602296625545e-06,
    },
    'solidEquilibriumDisplacementFoam': {
        'Dx_mean': 9.021508390791278e-11,
        'D_mag_mean': 9.185475718360796e-11,
        'D_mag_max': 2.2020141056568318e-10,
    },
    'potentialFreeSurfaceFoam': {
        'Ux_mean': 0.0,
        'U_mag_mean': 0.0,
        'U_mag_max': 0.0,
        'p_mean': 0.0,
        'p_min': 0.0,
        'p_max': 0.0,
    },
    'adjointShapeOptimizationFoam': {
        'Ux_mean': 0.0001021645825698414,
        'U_mag_mean': 5.9341467625984023e-05,
        'U_mag_max': 0.0001617418058685871,
        'p_mean': 0.013986476394293845,
        'p_min': 0.714139455172699,
        'p_max': 0.8401605588660459,
        'Uax_mean': 0.0,
        'Ua_mag_mean': 0.0,
        'Ua_mag_max': 0.0,
        'alpha_mean': 0.0,
        'alpha_min': 0.0,
        'alpha_max': 0.0,
    },
    'dnsFoam': {
        'Ux_mean': 1.2791360759012785e-08,
        'U_mag_mean': 3.217327567694994e-07,
        'U_mag_max': 5.406649616901404e-07,
        'p_mean': 0.0001547031288967604,
        'p_min': 0.0001526983909760915,
        'p_max': 0.00015781691545235788,
    },
    'fanDuct': {
        'Ux_mean': 4.830876486599384e-10,
        'U_mag_mean': 4.830818186880165e-10,
        'U_mag_max': 2.5432446192161923e-07,
        'p_mean': 3.788582132888618e-09,
        'p_min': 2.494601646536865e-07,
        'p_max': 1.3483842517536537e-07,
    },
}
SMALL_TOL_SPREAD = 10.0       # the golden tolerance: 10x the spread,
SMALL_TOL_FLOOR = 1e-4        # at least 1e-4 of the golden
SMALL_FLOOR_SCALE = 1e-4      # and 1e-4 of the field's largest value


def small_golden_errs(got, gold, spread, scales):
    """(|error|, tolerance) of each golden scalar: the tolerance is
    SMALL_TOL_SPREAD times the JAX package's spread under round-off (the
    larger of |float32 - float64| and the change a 1e-7 perturbation of
    the start makes in float32), at least SMALL_TOL_FLOOR of the golden
    and SMALL_FLOOR_SCALE of its field's largest value (a mean of a
    signed field, or a field at rest, is near zero, and two float32
    summation orders move a mean of fanDuct's p, +-0.024, by 8.4e-7 and
    of barMagnet's psi, +-7836, by 0.058, where float32 against float64
    moves them by 3.4e-8 and 5.8e-5)."""
    out = {}
    for k, g in gold.items():
        field = k.split("_")[0]
        field = field if field in scales else field[:-1]
        out[k] = (abs(got[k] - g),
                  max(SMALL_TOL_SPREAD * spread[k], SMALL_TOL_FLOOR * abs(g),
                      SMALL_FLOOR_SCALE * scales.get(field, 0.0)))
    return out


def field_scales(a):
    return {k: float(np.abs(x).max()) for k, x in a.items()}


def mat_operand(mesh, mat, name):
    """(name, slot coefficients, diag_eff, remainder coefficients) of a
    kept matrix: its own slot form, or, for a flat one, the stencil the
    solver builds from it (stencil.mesh_stencil)."""
    if mat.soff is not None:
        return (name, mat.soff, mat.diag_eff(mesh), mat.sfb)
    from foamtpu_torch.ops import stencil

    st = stencil.mesh_stencil(mesh, mat.upper, mat.lower)
    return (name, st.off, mat.diag_eff(mesh), st.fb_coeffs)


# each run's solves in the order of a step, for its StepLog, after its
# lead solves (fanDuct's state projects its initial flux: one pcorr solve)
SMALL_CYCLES = {"mhdFoam": ("U", "p", "p", "B", "pB"),
                "solidEquilibriumDisplacementFoam": ("D",),
                "fanDuct": ("U", "p", "p", "U", "p", "p")}
SMALL_LEAD = {"fanDuct": ("pcorr",)}


def phase_solvers_small(spmv, here, root, flush):
    """The single-equation applications and fanDuct from their tutorials
    through run(case) on the card (SMALL_RUNS, float32; blockMesh and the
    Allrun's other commands first), each held to goldens from the JAX
    package (SMALL_GOLDEN, at small_golden_errs) and finite; the reference
    tests' oracles on their own setups (SLICE11_ORACLES but
    CPU_ONLY_ORACLES; fanDuct's on its run here); and the SpMV kernel held to its plain version at
    plateTension's D and fanDuct's p (whose AMI term is plain torch
    beside it), timed there."""
    from foamtpu_torch.apps.cli import main as cli
    from foamtpu_torch.core.case import Case

    results, checks = {}, {}
    launches_total = fb_total = 0
    logs = {}
    for name, (tut, opts, steps) in SMALL_RUNS.items():
        dst = slice11_case(here, os.path.join(root, "small", name), tut, cli,
                           device=("-device", "cuda"), **opts)
        case = Case(dst, device="cuda")
        cycle = SMALL_CYCLES.get(name)
        with (StepLog(cycle, lead=SMALL_LEAD.get(name, ())) if cycle
              else contextlib.nullcontext()) as log:
            run_s, text, launches, fb = app_run(spmv, case, steps)
        logs[name] = (case, log)
        launches_total += launches
        fb_total += fb
        a = small_arrays(name, case.final_state,
                         lambda t: t.double().cpu().numpy())
        v = case.mesh.v.double().cpu().numpy()
        finite = all(bool(np.isfinite(x).all()) for x in a.values())
        got = small_scalars(a, v) if finite else {}
        rec = {"tutorial": "/".join(SLICE11_TUTORIALS[tut]),
               "n_cells": case.mesh.n_cells, "steps": case.time.index,
               "run_s": run_s,
               "sec_per_step": run_s / max(case.time.index, 1),
               "scalars": got, "iterations_max": {
                   k: max(x) for k, x in solve_iterations(text).items()},
               "spmv_launches": launches, "spmv_fb_launches": fb}
        ck = {"finite": finite, "spmv launched": launches > 0}
        if steps is not None:
            ck["steps"] = case.time.index == steps
        if finite:
            errs = small_golden_errs(got, SMALL_GOLDEN[name],
                                     SMALL_SPREAD[name], field_scales(a))
            rec["golden_err_tol"] = errs
            ck.update({f"golden {k}": e <= t for k, (e, t) in errs.items()})
        results[name] = rec
        checks.update({f"{name} {k}": x for k, x in ck.items()})
        progress("solvers_small", f"{name}: {run_s:.1f} s, {launches} SpMV "
                 "launches")

    t0 = time.perf_counter()
    oracles = {}
    for name, fn in SLICE11_ORACLES.items():
        if name in CPU_ONLY_ORACLES:
            continue
        l0, f0 = spmv.LAUNCHES, spmv.FB_LAUNCHES
        t1 = time.perf_counter()
        if name == "fanDuct":
            case = logs["fanDuct"][0]
            U = case.final_state["U"].data.double().cpu().numpy()
            p = case.final_state["p"].data.double().cpu().numpy()
            x = case.mesh.c[:, 0].double().cpu().numpy()
            rec = {"ux_mean": float(U[:, 0].mean()),
                   "dp": float(p[x > 1.0].mean() - p[x < 1.0].mean())}
            ck = {"mean Ux > 1e-3": rec["ux_mean"] > 1e-3,
                  "p downstream > upstream + 0.01": rec["dp"] > 0.01}
        else:
            rec, ck = fn(os.path.join(root, "oracles"), cli, "cuda")
        launches_total += spmv.LAUNCHES - l0
        fb_total += spmv.FB_LAUNCHES - f0
        rec["seconds"] = time.perf_counter() - t1
        oracles[name] = rec
        checks.update({f"oracle {name}: {k}": x for k, x in ck.items()})
    results["reference_tests"] = {"seconds": time.perf_counter() - t0,
                                  "records": oracles}
    progress("solvers_small", f"oracles {time.perf_counter() - t0:.1f} s")

    cases, max_err, timings = [], 0.0, []
    for name, kind, prefix in (
            ("solidEquilibriumDisplacementFoam", "D", "plateTension_D"),
            ("fanDuct", "p", "fanDuct_p")):
        case, log = logs[name]
        mesh = case.mesh
        op = mat_operand(mesh, log.matrices[kind], prefix)
        deltas = tuple(mesh.st_deltas)
        for dtype in (torch.float32, torch.float64):
            err = check_operands(spmv, [op], mesh, deltas, dtype,
                                 np.random.default_rng(111), cases)
            if dtype == torch.float32:
                max_err = max(max_err, err)
        _, soff, diag, sfb = op
        timings += time_shape(spmv, prefix, diag.contiguous(),
                              operand_x(diag, 112), soff.contiguous(),
                              deltas, flush,
                              fb=mesh_remainder(spmv, mesh, sfb, diag.dtype)
                              if mesh.fb_cells.shape[0] else None)
        checks[f"{prefix} operand's columns"] = (
            diag.ndim == (2 if kind == "D" else 1))
        if name == "fanDuct":
            checks["fanDuct p matrix AMI-coupled"] = (
                log.matrices["p"].ami_coef is not None and mesh.has_ami)
    out = {"phase": "solvers_small", "dtype": "torch.float32",
           "runs": results, "kernel_cases": cases, "max_abs_err_f32": max_err,
           "timings": timings, "spmv_launches_total": launches_total,
           "spmv_fb_launches_total": fb_total, "checks": checks}
    emit(out)
    for name, ok in checks.items():
        check(ok, f"solvers_small check {name}: {out}")
    return out, max_err, timings


MHD_HEAD_BLOCKS = (1536, 512)     # 786,432 cells on hartmann's 20 x 2
# hartmann as shipped (sigma 500, Ha = 447) returns NaN at step 33 in the
# JAX package at its 20 x 20 (step 41 in float64), and within 20 steps at
# any finer mesh tried (40 x 20 to 192 x 64): the headline takes the
# Ha = 20 of tests/test_mhd.py (sigma 1). The explicit Lorentz force and
# stretching term carry Alfven waves (|B| = 20 in velocity units), whose
# Courant number at the tutorial's deltaT 0.005 grows with the cell
# height: 1 at 20 x 20, 25.6 at this mesh, where the port on the CPU
# returns NaN within 5 steps (and at 384 x 128 within 10). deltaT is
# scaled with the cell height to an Alfven Courant number of 0.5 (the
# flow's 0.008): at 1, which holds for 30 steps at 384 x 128 and 15 at
# 768 x 256 on the card, this mesh's continuity error reaches 5 in the
# second step on the card (and U 20), with GAMG or with PCG p
MHD_HEAD_DT = 0.005 * 20 / MHD_HEAD_BLOCKS[1] / 2
MHD_HEAD_SIGMA = 1.0
MHD_HEAD_WARMUP = 1
MHD_HEAD_TRIALS = 2
MHD_HEAD_CHUNK = 2
MHD_HEAD_PROFILE = 1
# bench.py's tight GAMG controls (its bench_tight row), for p where the
# shipped polynomial PCG reaches its cap of 1000 iterations at this width
# (p and pB, in the first step, on the card). A p solve stopped early
# (PCG at its cap, or GAMG at relTol 0.01) leaves a continuity error that
# grows step by step until the run diverges, in 10 steps at 768 x 256 on
# the CPU; converged it stays at ~1e-4. pB keeps the shipped PCG: it
# only cleans div(B), and GAMG there stalls at its cap of 1000 cycles
MHD_HEAD_GAMG = {"solver": "GAMG", "tolerance": 1e-6, "relTol": 0.0,
                 "maxIter": 1000}


def hartmann_big_case(here, dst):
    """hartmann copied to dst with its block at MHD_HEAD_BLOCKS (not
    meshed, see memory_mesh)."""
    dst = slice11_case(here, dst, "mhdFoam", None)
    _edit(os.path.join(dst, "system", "blockMeshDict"), r"\(20 20 1\)",
          "({} {} 1)".format(*MHD_HEAD_BLOCKS))
    return dst


def phase_mhd_headline(spmv, here, root, flush):
    """mhdFoam's hartmann at MHD_HEAD_BLOCKS (786,432 cells) meshed in
    memory, deltaT MHD_HEAD_DT (an Alfven Courant number of 0.5), the
    tutorial's BCs, schemes, controls and properties but sigma
    (MHD_HEAD_SIGMA: Ha = 20, as tests/test_mhd.py):
    the application's config and first state, one warm-up
    step; where a p solve of it reaches the cap of 1000 polynomial PCG
    iterations, bench.py's tight GAMG p controls (MHD_HEAD_GAMG) and the
    warm-up again from the first state; then
    MHD_HEAD_TRIALS timed chunks of MHD_HEAD_CHUNK steps with every
    solve's iterations, the SpMV kernel held to its plain version and
    timed at the p and B operands, and one profiled chunk of
    MHD_HEAD_PROFILE steps last; held to finiteness, the continuity error
    of a step (sum |div phi| deltaT / V, the log's "sum local") below
    1e-3 and max |div B| V below 1e-2 of the largest face flux of B."""
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.solvers import apps, mhd
    from foamtpu_torch.solvers.linear.gamg import GAMG

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dst = hartmann_big_case(here, os.path.join(root, "hartmann_big"))
    _edit(os.path.join(dst, "constant", "transportProperties"),
          r"(sigma\s+sigma\s+\[[^]]*\])\s*[^;]+;",
          lambda m: f"{m.group(1)} {MHD_HEAD_SIGMA!r};")
    case = memory_mesh(Case(dst, device="cuda"))
    mesh = case.mesh
    n = MHD_HEAD_BLOCKS[0] * MHD_HEAD_BLOCKS[1]
    check(mesh.n_cells == n, mesh.n_cells)
    tp = case.transport_properties()
    cdict = case.pimple_controls("PISO")
    cfg = mhd.MhdConfig(
        nu=apps._dim_scalar_of(tp, "nu", 1e-6),
        rho=apps._dim_scalar_of(tp, "rho", 1.0),
        mu_mag=apps._dim_scalar_of(tp, "mu", 1.0),
        sigma_c=apps._dim_scalar_of(tp, "sigma", 1.0),
        n_correctors=int(cdict.get("nCorrectors", 2)),
        corrected=case.laplacian_corrected(),
        p_controls=case.solver_controls("p"),
        u_controls=case.solver_controls("U"),
        pb_controls=case.solver_controls("pB"))
    def first_state():
        return mhd.initial_state(mesh, case.read_field("U"),
                                 case.read_field("p"), case.read_field("B"),
                                 case.read_field("pB"))

    state = first_state()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    progress("mhd_headline", f"set-up {setup_s:.1f} s, {n} cells")
    cycle = SMALL_CYCLES["mhdFoam"]
    cap = int(cfg.p_controls.get("maxIter", 1000))

    def chunk_of(cfg, k):
        step = mhd.make_step(mesh, cfg)

        def chunk(st):
            diag = None
            for _ in range(k):
                st, diag = step(st, MHD_HEAD_DT)
            return st, diag
        return chunk

    spmv.LAUNCHES = spmv.FB_LAUNCHES = 0
    t0 = time.perf_counter()
    with StepLog(cycle) as wlog:
        state, diag = chunk_of(cfg, MHD_HEAD_WARMUP)(state)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_its = {k: [int(i) for i in v] for k, v in wlog.iterations.items()}
    at_cap = max(warm_its["p"]) >= cap
    controls = "shipped polynomial PCG"
    if at_cap:
        # from the first state again: a step whose p solves stopped at
        # the cap leaves a flux that is not divergence-free
        cfg = cfg._replace(p_controls=dict(MHD_HEAD_GAMG, _gamg=GAMG(mesh)))
        controls = ("p: bench.py's tight GAMG (tolerance 1e-6, relTol 0), "
                    "the shipped PCG having reached its cap in the warm-up "
                    "step; pB: the shipped PCG")
        state, diag = chunk_of(cfg, MHD_HEAD_WARMUP)(first_state())
    progress("mhd_headline", f"warm-up {warm_s:.1f} s, iterations "
             f"{warm_its}; {controls}")
    secs = []
    l_timed = spmv.LAUNCHES
    with StepLog(cycle) as log:
        for _ in range(MHD_HEAD_TRIALS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, diag = chunk_of(cfg, MHD_HEAD_CHUNK)(state)
            torch.cuda.synchronize()
            secs.append((time.perf_counter() - t0) / MHD_HEAD_CHUNK)
            progress("mhd_headline", f"chunk {secs[-1]:.3f} s/step, "
                     f"divB {float(diag['divB']):.3g}, iterations "
                     f"{ {k: v[-5:] for k, v in log.iterations.items()} }")
    sec = statistics.median(secs)
    timed_steps = MHD_HEAD_TRIALS * MHD_HEAD_CHUNK
    launches = spmv.LAUNCHES
    per_step = (launches - l_timed) / timed_steps
    cont, div_b = float(diag["continuity"]), float(diag["divB"])
    cases, max_err, timings = [], 0.0, []
    deltas = tuple(mesh.st_deltas)
    for kind in ("p", "B"):
        op = mat_operand(mesh, log.matrices[kind], f"hartmann_{kind}")
        for dtype in (torch.float32, torch.float64):
            err = check_operands(spmv, [op], mesh, deltas, dtype,
                                 np.random.default_rng(113), cases)
            if dtype == torch.float32:
                max_err = max(max_err, err)
        _, soff, dg, sfb = op
        timings += time_shape(spmv, f"hartmann_{kind}", dg.contiguous(),
                              operand_x(dg, 114), soff.contiguous(), deltas,
                              flush)
    b_mat = log.matrices["B"]
    l1, f1 = spmv.LAUNCHES, spmv.FB_LAUNCHES
    state, prof = profile_chunk(spmv, "mhd_headline_profile", mesh,
                                chunk_of(cfg, MHD_HEAD_PROFILE), state,
                                MHD_HEAD_PROFILE, sec,
                                log=StepLog(cycle, ranges=True))
    launches += spmv.LAUNCHES - l1
    fb_launches = spmv.FB_LAUNCHES
    a = {k: state[k].data.double().cpu().numpy() for k in ("U", "p", "B")}
    finite = all(bool(np.isfinite(x).all()) for x in a.values())
    from foamtpu_torch.ops import surface

    # max over cells of |div B| V (the net B flux out of a cell), against
    # the largest face flux of B
    div_bv = surface.surface_sum(mesh, state["phiB"]).abs()
    phib_max = float(state["phiB"].abs().max())
    its = {k: [int(i) for i in v] for k, v in log.iterations.items()}
    out = {"phase": "mhd_headline",
           "case": "mhdFoam hartmann, block ({} {} 1), deltaT {}, sigma {} "
                   "(Ha 20): the tutorial's BCs, schemes and controls".format(
                       *MHD_HEAD_BLOCKS, MHD_HEAD_DT, MHD_HEAD_SIGMA),
           "n_cells": n, "dtype": str(mesh.v.dtype), "setup_s": setup_s,
           "warmup_s": warm_s, "warmup_iterations": warm_its,
           "p_controls": controls, "sec_per_step": sec,
           "sec_per_step_trials": secs, "m_cells_per_sec": n / sec / 1e6,
           "iterations_per_solve": {k: statistics.mean(v)
                                    for k, v in its.items() if v},
           "iterations_max": {k: max(v) for k, v in its.items() if v},
           "spmv_launches_per_step": per_step,
           "continuity": cont, "divB": div_b,
           "max_divB_times_V": float(div_bv.max()),
           "max_face_flux_B": phib_max,
           "courant_max": float(diag["courant_max"]),
           "b_matrix_symmetric": bool(b_mat.symmetric),
           "cuda_launch_kernel_per_step": prof["cuda_launch_kernel_per_iter"],
           "device_ms_per_step": prof["device_ms_per_iter"],
           "device_busy_share": prof["device_busy_share_unprofiled"],
           "spmv_device_ms_per_step": prof["spmv_device_ms_per_iter"],
           "spmv_launches_per_step_profiled": prof["spmv_launches_per_iter"],
           "top_kernels_ms_per_step": prof["top_kernels_ms_per_iter"][:8],
           "spmv_launches_total": launches,
           "spmv_fb_launches_total": fb_launches,
           "kernel_cases": cases, "max_abs_err_f32": max_err,
           "timings": timings,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    checks = {"finite": finite, "spmv launched": launches > 0,
              "continuity of a step < 1e-3": cont * MHD_HEAD_DT < 1e-3,
              "max|div B| V < 1e-2 of the largest face flux of B":
              out["max_divB_times_V"] < 1e-2 * phib_max,
              "B operand non-symmetric": not b_mat.symmetric,
              "Courant < 1": out["courant_max"] < 1.0}
    out["checks"] = checks
    emit(out)
    for name, ok in checks.items():
        check(ok, f"mhd_headline check {name}: {out}")
    return out, max_err, timings


# ---------------------------------------------------------------------------
# snappyHexMesh and multi-region conjugate heat transfer
# ---------------------------------------------------------------------------

SLICE12_TUTORIALS = {
    "bluffBody": ("incompressible", "simpleFoam", "bluffBody"),
    "openTerrain": ("incompressible", "windSimpleFoam", "openTerrain"),
    "heatedSlabs": ("heatTransfer", "chtMultiRegionFoam", "heatedSlabs"),
    "heatedSlabsSimple": ("heatTransfer", "chtMultiRegionSimpleFoam",
                          "heatedSlabs"),
}
SNAPPY_TUTORIALS = ("bluffBody", "openTerrain")
# bluffBody and openTerrain run 60 of their 300 SIMPLE iterations: the
# checks are the goldens and the body force, which need no converged
# wake, and the run stops at the tutorial's residualControl in neither
# package by then; heatedSlabs runs as shipped (40 steps, 200 iterations)
SNAPPY_ITERS = 60
SLICE12_RUNS = {
    "bluffBody": ("bluffBody", SNAPPY_ITERS),
    "openTerrain": ("openTerrain", SNAPPY_ITERS),
    "chtMultiRegionFoam": ("heatedSlabs", None),
    "chtMultiRegionSimpleFoam": ("heatedSlabsSimple", None),
}
CHT_APPS = ("chtMultiRegionFoam", "chtMultiRegionSimpleFoam")
CHT_REGIONS = ("heater", "sink")
SNAPPY_SEED_U = 0.05          # of the inlet's 5 m/s, the seeded start


def slice12_case(here, dst, name, cli, blocks=None, seed=None,
                 write_precision=None, write_interval=None):
    """The tutorial `name` of SLICE12_TUTORIALS copied to dst; bluffBody
    and openTerrain with their background's cell counts set to `blocks`
    where given and meshed as their Allruns mesh them (`cli`'s blockMesh,
    then snappyHexMesh; cli None: not meshed), `seed` adding a seeded
    perturbation of SNAPPY_SEED_U times the inlet speed to U's x and y
    components; `write_precision` and `write_interval` set the
    controlDict's. heatedSlabs ships its two regions' meshes. Returns
    dst."""
    shutil.copytree(os.path.join(here, "tutorials",
                                 *SLICE12_TUTORIALS[name]), dst)
    control = os.path.join(dst, "system", "controlDict")
    if write_precision is not None:
        with open(control, "a") as f:
            f.write(f"\nwritePrecision {write_precision};\n")
    if write_interval is not None:
        _edit(control, r"writeInterval\s+[^;]+;",
              f"writeInterval {write_interval};")
    if name not in SNAPPY_TUTORIALS:
        return dst
    if blocks is not None and tuple(blocks) != (48, 12, 12):
        _edit(os.path.join(dst, "constant", "polyMesh", "blockMeshDict"),
              r"\(48 12 12\)", "({} {} {})".format(*blocks))
    if cli is not None:
        with quiet():
            check(cli(["blockMesh", "-case", dst]) == 0, "blockMesh failed")
            check(cli(["snappyHexMesh", "-case", dst]) == 0,
                  "snappyHexMesh failed")
    if seed is not None:
        from foamtpu_torch.core.case import Case

        case = Case(dst, device="cpu")
        a = case.read_field("U").data.double().numpy().copy()
        rng = np.random.default_rng(seed)
        a[:, :2] += SNAPPY_SEED_U * 5.0 * rng.standard_normal(
            (a.shape[0], 2))
        set_internal(dst, "U", a)
    return dst


def slice12_arrays(name, final_state, host):
    """The fields of a run's final state as float64 numpy: per region
    T<region> of the cht runs; U, p, k, epsilon and nut of simpleFoam."""
    if name in CHT_APPS:
        return {f"T{r}": np.asarray(host(final_state[r]["T"].data),
                                    np.float64) for r in CHT_REGIONS}
    turb = final_state["turb"]
    out = {k: final_state[k] for k in ("U", "p")}
    out.update({k: turb[k] for k in ("k", "epsilon", "nut")})
    return {k: np.asarray(host(getattr(v, "data", v)), np.float64)
            for k, v in out.items()}


def slice12_scalars(name, final_state, mesh_v, host):
    """small_scalars of slice12_arrays, each region's over its own
    volumes (`mesh_v`: name -> cell volumes, or one array)."""
    a = slice12_arrays(name, final_state, host)
    if name not in CHT_APPS:
        return small_scalars(a, mesh_v)
    out = {}
    for k, x in a.items():
        out.update(small_scalars({k: x}, mesh_v[k[1:]]))
    return out


def body_force(case_dir):
    """The last row of bluffBody's forces file: (time, pressure force,
    viscous force)."""
    path = os.path.join(case_dir, "postProcessing", "bodyForces",
                        "forces.dat")
    with open(path) as f:
        rows = [r for r in f.read().splitlines()
                if r.strip() and not r.startswith("#")]
    nums = [float(x) for x in re.findall(
        r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?", rows[-1])]
    return nums[0], nums[1:4], nums[4:7]


# goldens from the JAX package (CPU, float32) and its spread under
# round-off (the larger of |float32 - float64| and the change a 1e-7
# perturbation of the start makes in float32): `python
# tests/test_torch_snappy.py goldens [--perturb]`
SLICE12_GOLDEN = {'bluffBody': {'Fx': 3.87879694,
               'U_mag_max': 6.80385862993321,
               'U_mag_mean': 5.2129801345394755,
               'Ux_mean': 5.174845740508468,
               'epsilon_max': 5.98886775970459,
               'epsilon_mean': 0.5132512936076533,
               'epsilon_min': 0.035694669932127,
               'k_max': 1.0043952465057373,
               'k_mean': 0.145714737010221,
               'k_min': 0.03296602517366409,
               'nut_max': 0.016878686845302582,
               'nut_mean': 0.0044205712361026425,
               'nut_min': 0.001298803836107254,
               'p_max': 17.708229064941406,
               'p_mean': -0.27624301422601527,
               'p_min': -24.133712768554688},
 'chtMultiRegionFoam': {'Theater_max': 373.9373474121094,
                        'Theater_mean': 351.81950855255127,
                        'Theater_min': 349.99993896484375,
                        'Tsink_max': 350.0,
                        'Tsink_mean': 349.7543067932129,
                        'Tsink_min': 346.1495056152344},
 'chtMultiRegionSimpleFoam': {'Theater_max': 399.7160949707031,
                              'Theater_mean': 395.45630121231073,
                              'Theater_min': 391.19500732421875,
                              'Tsink_max': 388.0707702636719,
                              'Tsink_mean': 345.45576000213623,
                              'Tsink_min': 302.84100341796875},
 'openTerrain': {'Fx': 3.87879694,
                 'U_mag_max': 6.80385862993321,
                 'U_mag_mean': 5.2129801345394755,
                 'Ux_mean': 5.174845740508468,
                 'epsilon_max': 5.98886775970459,
                 'epsilon_mean': 0.5132512936076533,
                 'epsilon_min': 0.035694669932127,
                 'k_max': 1.0043952465057373,
                 'k_mean': 0.145714737010221,
                 'k_min': 0.03296602517366409,
                 'nut_max': 0.016878686845302582,
                 'nut_mean': 0.0044205712361026425,
                 'nut_min': 0.001298803836107254,
                 'p_max': 17.708229064941406,
                 'p_mean': -0.27624301422601527,
                 'p_min': -24.133712768554688}}
SLICE12_SPREAD = {'bluffBody': {'Fx': 2.4899999999661304e-06,
               'U_mag_max': 7.1221947273159e-07,
               'U_mag_mean': 2.4265233022902066e-07,
               'Ux_mean': 2.0080295559665728e-07,
               'epsilon_max': 0.0001010894775390625,
               'epsilon_mean': 2.630473984188697e-07,
               'epsilon_min': 1.9744038581848145e-07,
               'k_max': 1.1759699049651573e-05,
               'k_mean': 1.3025738732075354e-07,
               'k_min': 5.706670570815309e-08,
               'nut_max': 7.869630065313049e-08,
               'nut_mean': 4.7399415269502865e-09,
               'nut_min': 1.522284455955647e-08,
               'p_max': 2.09808349609375e-05,
               'p_mean': 1.4328710782662846e-05,
               'p_min': 3.0517578125e-05},
 'chtMultiRegionFoam': {'Theater_max': 0.000152587890625,
                        'Theater_mean': 2.384185791015625e-05,
                        'Theater_min': 6.103515625e-05,
                        'Tsink_max': 3.0517578125e-05,
                        'Tsink_mean': 1.52587890625e-05,
                        'Tsink_min': 0.0005774588548206339},
 'chtMultiRegionSimpleFoam': {'Theater_max': 0.00018589175272154534,
                              'Theater_mean': 0.0017559222347358627,
                              'Theater_min': 0.001825810763023128,
                              'Tsink_max': 0.002588852399867392,
                              'Tsink_mean': 0.0012149600670454674,
                              'Tsink_min': 9.437010373858357e-05},
 'openTerrain': {'Fx': 2.4899999999661304e-06,
                 'U_mag_max': 7.1221947273159e-07,
                 'U_mag_mean': 2.4265233022902066e-07,
                 'Ux_mean': 2.0080295559665728e-07,
                 'epsilon_max': 0.0001010894775390625,
                 'epsilon_mean': 2.630473984188697e-07,
                 'epsilon_min': 1.9744038581848145e-07,
                 'k_max': 1.1759699049651573e-05,
                 'k_mean': 1.3025738732075354e-07,
                 'k_min': 5.706670570815309e-08,
                 'nut_max': 7.869630065313049e-08,
                 'nut_mean': 4.7399415269502865e-09,
                 'nut_min': 1.522284455955647e-08,
                 'p_max': 2.09808349609375e-05,
                 'p_mean': 1.4328710782662846e-05,
                 'p_min': 3.0517578125e-05}}


def sphere_tris(center, r, n_theta=12, n_phi=24):
    """The UV sphere of tests/test_snappy.py::_sphere_tris."""
    cx, cy, cz = center
    th = np.linspace(0, np.pi, n_theta + 1)
    ph = np.linspace(0, 2 * np.pi, n_phi + 1)
    tris = []
    for i in range(n_theta):
        for j in range(n_phi):
            p = []
            for (a, b) in ((th[i], ph[j]), (th[i + 1], ph[j]),
                           (th[i + 1], ph[j + 1]), (th[i], ph[j + 1])):
                p.append([cx + r * np.sin(a) * np.cos(b),
                          cy + r * np.sin(a) * np.sin(b),
                          cz + r * np.cos(a)])
            if i > 0:
                tris.append([p[0], p[1], p[2]])
            if i < n_theta - 1:
                tris.append([p[0], p[2], p[3]])
    return np.asarray(tris)


SPHERE_BOX = """
convertToMeters 1;
vertices ( (0 0 0) (1 0 0) (1 1 0) (0 1 0)
           (0 0 1) (1 0 1) (1 1 1) (0 1 1) );
blocks ( hex (0 1 2 3 4 5 6 7) (8 8 8) simpleGrading (1 1 1) );
boundary (
  inlet  { type patch; faces ((0 4 7 3)); }
  outlet { type patch; faces ((2 6 5 1)); }
  walls  { type wall; faces ((1 5 4 0) (3 7 6 2) (0 3 2 1) (4 5 6 7)); }
);
"""


def sphere_octree(snappy, blockmesh, parse_string):
    """tests/test_snappy.py::test_octree_refine_and_snap_sphere's chain
    through the given package: the 8^3 box refined to level 2 around a
    sphere of radius 0.25, castellated and snapped. Returns (refined,
    castellated, snapped, leaves)."""
    pm = blockmesh.generate(parse_string(SPHERE_BOX))
    tris = sphere_tris((0.5, 0.5, 0.5), 0.25)
    bb_min, bb_max, base_n, side_patches, two_d = snappy._background_box(pm)
    leaves = snappy.octree_refine(bb_min, bb_max, base_n, tris, 2)
    ref = snappy.octree_mesh(bb_min, bb_max, base_n, leaves, side_patches)
    out = snappy.castellate(ref, tris, (0.02, 0.02, 0.02))
    snapped = snappy.snap(out, tris, "body", n_iter=6)
    return ref, out, snapped, leaves


def sphere_oracles(chain=None):
    """The oracles of tests/test_snappy.py:208-274 on the port's host
    copy (`chain`: its sphere_octree result, else made here): the refined
    box keeps its volume, the snapped body points lie on the sphere (at
    most one fine cell off, 0.006 on average), the carved volume is
    within 2% of the exact one and snapping moved the staircase. Returns
    (record, checks)."""
    from foamtpu_torch.core.dictionary import parse_string
    from foamtpu_torch.mesh import blockmesh, snappy

    t0 = time.perf_counter()
    ref, out, snapped, leaves = chain or sphere_octree(snappy, blockmesh,
                                                       parse_string)
    b = snapped.patch("body")
    valid = (np.arange(snapped.face_pts.shape[1])[None, :]
             < snapped.face_npts[b.slice][:, None]) \
        & (snapped.face_pts[b.slice] >= 0)
    pids = np.unique(snapped.face_pts[b.slice][valid])
    r = np.linalg.norm(snapped.points[pids] - 0.5, axis=1)
    vol_exact = 1.0 - 4.0 / 3.0 * np.pi * 0.25 ** 3
    rec = {"seconds": time.perf_counter() - t0, "levels": sorted(
        {int(c[0]) for c in leaves}), "refined_cells": ref.n_cells,
        "snapped_cells": snapped.n_cells,
        "refined_volume": float(ref.v.sum()),
        "max_dist": float(np.abs(r - 0.25).max()),
        "mean_dist": float(np.abs(r - 0.25).mean()),
        "volume_rel_err": float(abs(snapped.v.sum() - vol_exact)
                                / vol_exact),
        "staircase_max_dist": float(np.abs(np.linalg.norm(
            out.points[pids] - 0.5, axis=1) - 0.25).max())}
    checks = {"levels 0-2": rec["levels"] == [0, 1, 2],
              "refined volume 1": abs(rec["refined_volume"] - 1.0) < 1e-9,
              "body on the sphere within 1/32": rec["max_dist"] < 1 / 32,
              "mean distance < 0.006": rec["mean_dist"] < 0.006,
              "carved volume within 2%": rec["volume_rel_err"] < 0.02,
              "snap moved the staircase": rec["staircase_max_dist"] > 0.02}
    return rec, checks


def cht_oracle(case):
    """chtMultiRegionSimpleFoam's heatedSlabs against the analytic linear
    profiles through T_i = (400*10 + 300*1)/11 = 390.909 K, within 1 K, as
    tests/test_chtmultiregion.py:206-210 holds them."""
    regions = case.final_state
    ti = (400.0 * 10 + 300.0 * 1) / 11.0
    th = regions["heater"]["T"].data.double().cpu().numpy()
    ts = regions["sink"]["T"].data.double().cpu().numpy()
    xh = regions["heater"]["mesh"].c[:, 0].double().cpu().numpy()
    xs = regions["sink"]["mesh"].c[:, 0].double().cpu().numpy()
    rec = {"T_interface": ti,
           "heater_max_err": float(np.abs(th - (400 + (ti - 400) * xh
                                                / 0.5)).max()),
           "sink_max_err": float(np.abs(ts - (ti + (300 - ti)
                                              * (xs - 0.5) / 0.5)).max())}
    checks = {"heater profile within 1 K": rec["heater_max_err"] < 1.0,
              "sink profile within 1 K": rec["sink_max_err"] < 1.0}
    return rec, checks


def simple_log(case):
    """A SolveLog of a simpleFoam case's solves, named from its start
    fields (U, p and the kEpsilon fields), with the initial flux
    projection's pcorr (piso.project_initial_flux, laplacian(1, pcorr))."""
    from foamtpu_torch.core.dimensions import DimensionSet

    log = SolveLog({"U": case.read_field("U"), "p": case.read_field("p"),
                    "turb": {k: case.read_field(k)
                             for k in ("k", "epsilon", "nut")}})
    log.names[DimensionSet.of(0, 3, -2)] = "pcorr"
    log.calls["pcorr"], log.seconds["pcorr"] = 0, 0.0
    log.iterations["pcorr"] = []
    return log


def phase_snappy_cht(spmv, here, root, flush):
    """bluffBody (simpleFoam) and openTerrain (windSimpleFoam) as their
    Allruns make them (blockMesh, snappyHexMesh, then the solver through
    run(case), SNAPPY_ITERS iterations) and heatedSlabs under
    chtMultiRegionFoam (40 steps) and chtMultiRegionSimpleFoam (200
    iterations), on the card in float32: each held to goldens from the
    JAX package (SLICE12_GOLDEN at small_golden_errs) and finite; the
    oracles: the steady slabs' analytic profile (cht_oracle), the
    snapped sphere of tests/test_snappy.py on the port's host copy
    (sphere_oracles) and a finite body force; the SpMV kernel held to its
    plain version and timed at bluffBody's p (whole operator, remainder
    included) and at the heater's T."""
    from foamtpu_torch.apps.cli import main as cli
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.core.dimensions import DimensionSet

    results, checks, logs = {}, {}, {}
    launches_total = fb_total = 0
    for name, (tut, steps) in SLICE12_RUNS.items():
        t0 = time.perf_counter()
        dst = slice12_case(here, os.path.join(root, "slice12", name), tut,
                           cli)
        mesh_s = time.perf_counter() - t0
        case = Case(dst, device="cuda")
        cht = name in CHT_APPS
        with SolveLog({"T": types.SimpleNamespace(dims=DimensionSet.of(
                0, 0, 0, 1))}) if cht else simple_log(case) as log:
            run_s, text, launches, fb = app_run(spmv, case, steps)
        logs[name] = (case, log)
        launches_total += launches
        fb_total += fb
        fs = case.final_state
        host = lambda t: t.double().cpu().numpy()  # noqa: E731
        if cht:
            v = {r: host(fs[r]["mesh"].v) for r in CHT_REGIONS}
            n_cells = sum(fs[r]["mesh"].n_cells for r in CHT_REGIONS)
        else:
            v, n_cells = host(case.mesh.v), case.mesh.n_cells
        a = slice12_arrays(name, fs, host)
        finite = all(bool(np.isfinite(x).all()) for x in a.values())
        got = slice12_scalars(name, fs, v, host) if finite else {}
        rec = {"tutorial": "/".join(SLICE12_TUTORIALS[tut]),
               "n_cells": n_cells, "steps": case.time.index,
               "mesh_s": mesh_s, "run_s": run_s,
               "sec_per_step": run_s / max(case.time.index, 1),
               "scalars": got, "iterations_max": {
                   k: max(x) for k, x in solve_iterations(text).items()},
               "spmv_launches": launches, "spmv_fb_launches": fb}
        ck = {"finite": finite, "spmv launched": launches > 0,
              "steps": case.time.index == (steps or (40 if name ==
                                                     "chtMultiRegionFoam"
                                                     else 200))}
        if not cht:
            rec["st_deltas"] = list(case.mesh.st_deltas)
            rec["coo_entries"] = int(case.mesh.fb_cells.shape[0])
            t_f, fp, fv = body_force(dst)
            rec["body_force"] = {"iteration": t_f, "pressure": fp,
                                 "viscous": fv}
            ck["body force finite"] = bool(np.isfinite(fp + fv).all())
            ck["remainder launched"] = fb > 0
            got["Fx"] = fp[0] + fv[0]
        if finite:
            errs = small_golden_errs(got, SLICE12_GOLDEN[name],
                                     SLICE12_SPREAD[name], field_scales(a))
            rec["golden_err_tol"] = errs
            ck.update({f"golden {k}": e <= t for k, (e, t) in errs.items()})
        if name == "chtMultiRegionSimpleFoam":
            rec["oracle"], ok = cht_oracle(case)
            ck.update(ok)
        results[name] = rec
        checks.update({f"{name} {k}": x for k, x in ck.items()})
        progress("snappy_cht", f"{name}: mesh {mesh_s:.1f} s, run "
                 f"{run_s:.1f} s, {launches} SpMV launches")
    results["sphere"], ok = sphere_oracles()
    checks.update({f"sphere {k}": x for k, x in ok.items()})

    cases, max_err, timings = [], 0.0, []
    for name, kind, prefix in (("bluffBody", "p", "bluffBody_p"),
                               ("chtMultiRegionFoam", "T", "heatedSlabs_T")):
        case, log = logs[name]
        mesh = (case.final_state["heater"]["mesh"] if name in CHT_APPS
                else case.mesh)
        op = mat_operand(mesh, log.matrices[kind], prefix)
        deltas = tuple(mesh.st_deltas)
        for dtype in (torch.float32, torch.float64):
            err = check_operands(spmv, [op], mesh, deltas, dtype,
                                 np.random.default_rng(121), cases)
            if dtype == torch.float32:
                max_err = max(max_err, err)
        _, soff, diag, sfb = op
        timings += time_shape(spmv, prefix, diag.contiguous(),
                              operand_x(diag, 122), soff.contiguous(),
                              deltas, flush,
                              fb=mesh_remainder(spmv, mesh, sfb, diag.dtype)
                              if mesh.fb_cells.shape[0] else None)
    checks["bluffBody p whole operator timed"] = any(
        t["shape"] == "bluffBody_p_whole" for t in timings)
    out = {"phase": "snappy_cht", "dtype": "torch.float32",
           "runs": results, "kernel_cases": cases, "max_abs_err_f32": max_err,
           "timings": timings, "spmv_launches_total": launches_total,
           "spmv_fb_launches_total": fb_total, "checks": checks}
    emit(out)
    for name, ok in checks.items():
        check(ok, f"snappy_cht check {name}: {out}")
    return out, max_err, timings


# The host meshing of the large phases (blockMesh of the headlines, the
# duct's tets, the snapped bluffBody, the slabs: about 250 s of numpy)
# runs in a process of its own (start_premesh) beside the earlier phases,
# in the order the phases need it; each mesh is pickled as soon as it is
# made, and the phase takes it (premeshed; memory_mesh finds a
# blockMesh by its dictionary's text) or, where none was started or the
# text differs, meshes it itself.

def premesh_cases(here, src):
    """The cases of the headlines meshed by memory_mesh, written under
    `src` as their phases write theirs (without meshing): their
    blockMeshDict paths, in the order the phases run."""
    dsts = [
        cross_case(here, src),
        copy_case(here, BASIC_CASES["laplacianFoam"][0], src,
                  f"heated{HEATED_N}", edits=heated_edits(), mesh=False),
        mixer_big_case(here, src),
        copy_case(here, CHANNEL395_CASE, src, "channel_big",
                  edits=les_head_edits(), mesh=False),
        hotroom_case(here, os.path.join(src, "hotroom_big"),
                     "buoyantBoussinesqSimpleFoam", None, blocks=BOUSS_HEAD),
        box_big_case(here, os.path.join(src, "box_big")),
        compressible_case(here, os.path.join(src, "duct_big"),
                          "rhoPimpleFoam", None, scale=COMP_HEAD_SCALE,
                          delta_t=COMP_HEAD_DT),
        compressible_case(here, os.path.join(src, "step_big"),
                          "rhoCentralFoam", None, scale=RC_HEAD_SCALE,
                          delta_t=RC_HEAD_DT),
        hartmann_big_case(here, os.path.join(src, "hartmann_big"))]
    return [blockmesh_dict(d) for d in dsts]


def blockmesh_dict(case_dir):
    for rel in ("constant/polyMesh/blockMeshDict", "system/blockMeshDict"):
        path = os.path.join(case_dir, rel)
        if os.path.exists(path):
            return path
    check(False, f"{case_dir}: no blockMeshDict")


def dict_key(path):
    import hashlib

    with open(path, "rb") as f:
        return "blockMesh-" + hashlib.sha1(f.read()).hexdigest()


def premesh_main(jobs_file, out_dir):
    """Make the meshes of `jobs_file` ([key, kind, argument] in order: a
    blockMeshDict path, the duct's cell counts, the snapped bluffBody's
    background, the slabs' cells, the mesh chain's case directory), each
    pickled to out_dir/<key>.pkl with its seconds as soon as it is made
    (the chain: the directory and its commands' records)."""
    from foamtpu_torch.core.dictionary import parse_file, parse_string
    from foamtpu_torch.mesh import blockmesh
    from foamtpu_torch.mesh.tetmesh import tet_box

    with open(jobs_file) as f:
        jobs = json.load(f)
    root = tempfile.mkdtemp(prefix="chip_smoke_premesh_")
    try:
        for key, kind, arg in jobs:
            t0 = time.perf_counter()
            if kind == "blockMesh":
                res = (blockmesh.generate(parse_file(arg)), {})
            elif kind == "tet":
                res = (tet_box(*arg, size=(4.0, 1.0, 1.0)), {})
            elif kind == "setFields":
                # dambreak's case: blockMesh and setFields on its files, the
                # mesh read back for the phase
                from foamtpu_torch.apps.cli import main as cli
                from foamtpu_torch.core.case import Case

                with contextlib.redirect_stdout(sys.stderr):
                    check(cli(["blockMesh", "-case", arg]) == 0,
                          "blockMesh failed")
                    check(cli(["setFields", "-case", arg, "-device", "cpu"])
                          == 0, "setFields failed")
                res = (Case(arg, device="cpu").poly_mesh, {"case_dir": arg})
            elif kind == "snappy":
                res = snapped_bluff(here_of(jobs_file), root, tuple(arg))
            elif kind == "amr":
                res = amr_premesh(arg)
            elif kind == "rcm":
                res = duct_rcm_premesh(arg)
            elif kind == "chain":
                # mesh_utilities' case: its commands in processes of their
                # own, the case directory kept for the phase
                res = (arg, {"commands": mesh_chain_run(arg)})
            else:
                res = (cht_slabs(blockmesh, parse_string, tuple(arg)), {})
            res[1]["mesh_s"] = time.perf_counter() - t0
            out = os.path.join(out_dir, key + ".pkl")
            with open(out + ".part", "wb") as f:
                pickle.dump(res, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(out + ".part", out)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def here_of(jobs_file):
    with open(os.path.join(os.path.dirname(jobs_file), "here")) as f:
        return f.read()


PREMESH = {}


def start_premesh(here, root):
    """Write the premesh cases and job list under root/premesh and start
    premesh_main in a process of its own, on the host's CPU only (no CUDA
    device visible to it)."""
    top = os.path.join(root, "premesh")
    out_dir = os.path.join(top, "out")
    os.makedirs(out_dir)
    jobs = [["duct", "tet", list(DUCT)],
            ["dambreak_small", "setFields", copy_case(
                here, DAMBREAK_CASE, os.path.join(top, "src"), "damBreak",
                mesh=False)],
            ["dambreak", "setFields", dambreak_big_case(
                here, os.path.join(top, "src"), DAMBREAK_BIG_N)]]
    jobs += [[dict_key(p), "blockMesh", p]
             for p in premesh_cases(here, os.path.join(top, "src"))]
    jobs += [["bluff", "snappy", list(SNAPPY_HEAD_BLOCKS)],
             ["slabs", "slabs", list(CHT_HEAD_CELLS)]]
    # multiphase_headline's column, after the meshes of the earlier phases
    bubble = blockmesh_dict(bubble_big_case(here, os.path.join(
        top, "src", "bubble_big")))
    jobs += [[dict_key(bubble), "blockMesh", bubble]]
    # fire_headline's pool, last
    fire = blockmesh_dict(fire_big_case(here, os.path.join(top, "src",
                                                           "fire_big")))
    jobs += [[dict_key(fire), "blockMesh", fire]]
    # amr_headline's box and its octree, after the pool
    jobs += [["amr", "amr", blockmesh_dict(amr_big_case(
        here, os.path.join(top, "src", "amr_big")))]]
    # lagrangian_headline's boxes
    for name, fn in (("rpf_big", rpf_mesh_case), ("fall_big", fall_mesh_case),
                     ("dsmc_big", dsmc_big_case)):
        path = blockmesh_dict(fn(here, os.path.join(top, "src", name)))
        jobs += [[dict_key(path), "blockMesh", path]]
    # mesh_utilities' chain, last
    jobs += [["mesh_chain", "chain", mesh_chain_case(
        here, os.path.join(top, "src", "mesh_chain"), MESH_CHAIN_HEAD)]]
    jobs_file = os.path.join(top, "jobs.json")
    with open(jobs_file, "w") as f:
        json.dump(jobs, f)
    with open(os.path.join(top, "here"), "w") as f:
        f.write(here)
    # the renumbered duct's GAMG hierarchy (minutes of host numpy) in a
    # second process
    rcm_file = os.path.join(top, "jobs_rcm.json")
    with open(rcm_file, "w") as f:
        json.dump([["duct_rcm", "rcm", list(DUCT)]], f)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    procs = {}
    for jf, keys in ((jobs_file, [k for k, _, _ in jobs]),
                     (rcm_file, ["duct_rcm"])):
        code = (f"import sys; sys.path.insert(0, {here!r}); import "
                f"chip_smoke; chip_smoke.premesh_main({jf!r}, {out_dir!r})")
        # its output goes to stderr: stdout keeps one JSON line per phase
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=here,
                                env=env, stdout=sys.stderr)
        procs.update(dict.fromkeys(keys, proc))
    PREMESH.update(procs=procs, keys=set(procs), out_dir=out_dir,
                   started=time.perf_counter(), waits={})


def stop_premesh():
    for proc in set(PREMESH.get("procs", {}).values()):
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def premeshed(key):
    """(mesh, seconds) of premesh job `key`, waiting for it, or None when
    no premesh process was started or it has no such job. The seconds
    are the job's own, with premesh_wait_s, the seconds the caller waited
    for it."""
    if key not in PREMESH.get("keys", ()):
        return None
    path = os.path.join(PREMESH["out_dir"], key + ".pkl")
    t0 = time.perf_counter()
    while not os.path.exists(path):
        rc = PREMESH["procs"][key].poll()
        check(rc is None or os.path.exists(path),
              f"the premesh process exited with {rc} before {key}")
        time.sleep(0.05)
    with open(path, "rb") as f:
        mesh, secs = pickle.load(f)
    os.remove(path)
    wait = time.perf_counter() - t0
    PREMESH["waits"][key] = wait
    return mesh, dict(secs, premeshed_in_background=True,
                      premesh_wait_s=wait)


def snapped_bluff(here, root, blocks):
    """bluffBody with its background at `blocks` meshed in memory by the
    port's blockMesh and snappy (mesh/snappy.py::from_dict): (PolyMesh,
    seconds)."""
    from foamtpu_torch.core.dictionary import parse_file
    from foamtpu_torch.mesh import blockmesh, snappy

    t0 = time.perf_counter()
    dst = slice12_case(here, os.path.join(root, "bluff_mesh"), "bluffBody",
                       None, blocks=blocks)
    pm0 = blockmesh.generate(parse_file(os.path.join(
        dst, "constant", "polyMesh", "blockMeshDict")))
    t1 = time.perf_counter()
    pm = snappy.from_dict(dst, parse_file(os.path.join(
        dst, "system", "snappyHexMeshDict")), pm0)
    return pm, {"blockmesh_s": t1 - t0, "snappy_s": time.perf_counter() - t1}


SNAPPY_HEAD_BLOCKS = (192, 48, 48)   # the background; 443,180 cells snapped
SNAPPY_HEAD_CELLS = 443180
SNAPPY_HEAD_WARMUP = 5
SNAPPY_HEAD_TRIALS = 2
SNAPPY_HEAD_CHUNK = 5
SNAPPY_HEAD_PROFILE = 1


def phase_snappy_headline(spmv, here, root, flush):
    """bluffBody with its background at SNAPPY_HEAD_BLOCKS (443,180 cells
    after castellating and snapping), meshed in memory by the port's
    blockMesh and snappy (mesh/snappy.py::from_dict, host numpy), the
    tutorial's SIMPLE controls (GAMG p, PBiCGStab U/k/epsilon, kEpsilon,
    upwind): set-up split into blockMesh + snappy, to_device and the
    config (GAMG hierarchy), SNAPPY_HEAD_WARMUP iterations, then
    SNAPPY_HEAD_TRIALS timed chunks of SNAPPY_HEAD_CHUNK iterations with
    every solve's iterations, the SpMV kernel held to its plain version
    and timed at the snapped p (whole operator and slot part), and one
    profiled chunk of SNAPPY_HEAD_PROFILE iterations last; held to
    finiteness, the continuity error and a launch with the remainder."""
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.core.dictionary import dimensioned_scalar
    from foamtpu_torch.solvers import apps, piso, simple

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dst = slice12_case(here, os.path.join(root, "bluff_big"), "bluffBody",
                       None, blocks=SNAPPY_HEAD_BLOCKS)
    pm, mesh_secs = premeshed("bluff") or snapped_bluff(
        here, root, SNAPPY_HEAD_BLOCKS)
    t2 = time.perf_counter()
    case = Case(dst, device="cuda")
    case._poly = pm
    mesh = case.mesh
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    n = mesh.n_cells
    check(n == SNAPPY_HEAD_CELLS, f"snapped cells {n}")
    _, nu = dimensioned_scalar(case.transport_properties()["nu"])
    model, tstate = apps._load_turbulence(case, nu)
    cfg = apps._simple_config(case, nu, model)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    state = piso.initial_state(mesh, case.read_field("U"),
                               case.read_field("p"), turb_state=tstate)
    torch.cuda.synchronize()
    setup = dict(mesh_secs, to_device_s=t3 - t2, config_gamg_s=t4 - t3,
                 setup_s=time.perf_counter() - t0)
    progress("snappy_headline", f"set-up {setup}, {n} cells")
    spmv.LAUNCHES = spmv.FB_LAUNCHES = 0
    t0 = time.perf_counter()
    state, diag = simple.make_chunk(mesh, cfg, SNAPPY_HEAD_WARMUP)(state)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    progress("snappy_headline", f"warm-up {warm_s:.1f} s")
    chunk = simple.make_chunk(mesh, cfg, SNAPPY_HEAD_CHUNK)
    secs = []
    l0 = spmv.LAUNCHES
    with SolveLog(state) as log:
        for _ in range(SNAPPY_HEAD_TRIALS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, diag = chunk(state)
            torch.cuda.synchronize()
            secs.append((time.perf_counter() - t0) / SNAPPY_HEAD_CHUNK)
    sec = statistics.median(secs)
    timed = SNAPPY_HEAD_TRIALS * SNAPPY_HEAD_CHUNK
    per_iter = (spmv.LAUNCHES - l0) / timed
    its = {k: [int(i) for i in v] for k, v in log.iterations.items()}
    progress("snappy_headline", f"chunks {secs}, iterations "
             f"{ {k: v[-5:] for k, v in its.items()} }")
    launches, fb_launches = spmv.LAUNCHES, spmv.FB_LAUNCHES
    deltas = tuple(mesh.st_deltas)
    op = mat_operand(mesh, log.matrices["p"], "snapped_p")
    cases, max_err = [], 0.0
    for dtype in (torch.float32, torch.float64):
        err = check_operands(spmv, [op], mesh, deltas, dtype,
                             np.random.default_rng(123), cases)
        if dtype == torch.float32:
            max_err = err
    _, soff, dg, sfb = op
    timings = time_shape(spmv, "snapped_p", dg.contiguous(),
                         operand_x(dg, 124), soff.contiguous(), deltas,
                         flush, fb=mesh_remainder(spmv, mesh, sfb, dg.dtype))
    l1, f1 = spmv.LAUNCHES, spmv.FB_LAUNCHES
    state, prof = profile_chunk(
        spmv, "snappy_headline_profile", mesh,
        simple.make_chunk(mesh, cfg, SNAPPY_HEAD_PROFILE), state,
        SNAPPY_HEAD_PROFILE, sec)
    launches += spmv.LAUNCHES - l1
    fb_launches += spmv.FB_LAUNCHES - f1
    u = state["U"].data
    n_fb = int(mesh.fb_cells.shape[0])
    nbrs = np.bincount(np.concatenate([
        mesh.owner[:mesh.n_internal_faces].cpu().numpy(),
        mesh.neighbour.cpu().numpy()]), minlength=n)
    out = {"phase": "snappy_headline",
           "case": "simpleFoam bluffBody, background ({} {} {}), the "
                   "tutorial's snappyHexMeshDict, schemes, controls and "
                   "kEpsilon".format(*SNAPPY_HEAD_BLOCKS),
           "n_cells": n, "dtype": str(mesh.v.dtype),
           "st_deltas": list(deltas), "coo_entries": n_fb,
           "coo_fraction": n_fb / (2 * mesh.n_internal_faces),
           "face_neighbour_histogram": np.bincount(nbrs).tolist(),
           **setup, "warmup_s": warm_s, "sec_per_iter": sec,
           "sec_per_iter_trials": secs, "m_cells_per_sec": n / sec / 1e6,
           "iterations_per_solve": {k: statistics.mean(v)
                                    for k, v in its.items() if v},
           "iterations_max": {k: max(v) for k, v in its.items() if v},
           "spmv_launches_per_iter": per_iter,
           "continuity": float(diag["continuity"]),
           "u_max": float(torch.linalg.norm(u, dim=1).max()),
           "cuda_launch_kernel_per_iter": prof["cuda_launch_kernel_per_iter"],
           "device_ms_per_iter": prof["device_ms_per_iter"],
           "device_busy_share": prof["device_busy_share_unprofiled"],
           "spmv_device_ms_per_iter": prof["spmv_device_ms_per_iter"],
           "spmv_fb_launches_per_iter_profiled":
               prof["spmv_fb_launches_per_iter"],
           "top_kernels_ms_per_iter": prof["top_kernels_ms_per_iter"][:8],
           "spmv_launches_total": launches,
           "spmv_fb_launches_total": fb_launches,
           "kernel_cases": cases, "max_abs_err_f32": max_err,
           "timings": timings,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    checks = {"finite": bool(torch.isfinite(u).all()),
              "continuity < 1": out["continuity"] < 1.0,
              "spmv launched": launches > 0,
              "the remainder launched": n_fb > 0 and fb_launches > 0,
              "whole operator timed": any(
                  t["shape"] == "snapped_p_whole" for t in timings)}
    out["checks"] = checks
    emit(out)
    for name, ok in checks.items():
        check(ok, f"snappy_headline check {name}: {out}")
    return out, max_err, timings


CHT_HEAD_CELLS = (1024, 384)     # per slab: 786,432 cells in the two
CHT_HEAD_WARMUP = 1
CHT_HEAD_TRIALS = 2
CHT_HEAD_CHUNK = 3               # 1 + 2 x 3 = 7 transient steps
CHT_HEAD_PROFILE = 1
CHT_SLAB = """
convertToMeters 1;
vertices
(
    ({x0} 0 0) ({x1} 0 0) ({x1} 1 0) ({x0} 1 0)
    ({x0} 0 0.1) ({x1} 0 0.1) ({x1} 1 0.1) ({x0} 1 0.1)
);
blocks ( hex (0 1 2 3 4 5 6 7) ({nx} {ny} 1) simpleGrading (1 1 1) );
boundary
(
    {left}  {{ type wall; faces ((0 4 7 3)); }}
    {right} {{ type wall; faces ((2 6 5 1)); }}
    sides {{ type wall; faces ((1 5 4 0) (3 7 6 2)); }}
    frontAndBack {{ type empty; faces ((0 3 2 1) (4 5 6 7)); }}
);
"""


def cht_slabs(blockmesh, parse_string, cells):
    """The two slabs of tests/test_chtmultiregion.py::
    test_cht_app_two_regions (x in [0, 0.5] and [0.5, 1], y in [0, 1])
    at `cells` = (nx, ny) each, as {region: PolyMesh}."""
    nx, ny = cells
    return {"heater": blockmesh.generate(parse_string(CHT_SLAB.format(
        x0=0.0, x1=0.5, nx=nx, ny=ny, left="hot", right="heater_to_sink"))),
        "sink": blockmesh.generate(parse_string(CHT_SLAB.format(
            x0=0.5, x1=1.0, nx=nx, ny=ny, left="sink_to_heater",
            right="cold")))}


def phase_cht_headline(spmv, here, root, flush):
    """chtMultiRegionFoam on heatedSlabs with each slab at CHT_HEAD_CELLS
    (786,432 cells in the two regions), meshed in memory; the tutorial's
    properties, fields and deltaT, and the reference's solid controls
    (polynomial PCG, relTol 0.01: the driver reads no region fvSolution):
    set-up (ChtRun, the interface matched on the host), one warm-up
    step, CHT_HEAD_TRIALS timed chunks of CHT_HEAD_CHUNK steps with
    every PCG count, the exchange alone fenced, the SpMV kernel held to
    its plain version and timed at the heater's T, and one profiled
    chunk of CHT_HEAD_PROFILE steps last; held to finiteness and to T
    within the boundary temperatures."""
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.core.dictionary import parse_string
    from foamtpu_torch.mesh import blockmesh
    from foamtpu_torch.solvers import chtmultiregion as cht

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dst = slice12_case(here, os.path.join(root, "slabs_big"), "heatedSlabs",
                       None)
    pms, mesh_secs = premeshed("slabs") or (
        cht_slabs(blockmesh, parse_string, CHT_HEAD_CELLS),
        {"mesh_s": time.perf_counter() - t0})
    case = Case(dst, device="cuda")
    sim = cht.ChtRun(case, poly_meshes=pms)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    meshes = {r: sim.regions[r]["mesh"] for r in CHT_REGIONS}
    n = sum(m.n_cells for m in meshes.values())
    check(n == 2 * CHT_HEAD_CELLS[0] * CHT_HEAD_CELLS[1], n)
    progress("cht_headline", f"set-up {setup_s:.1f} s, {n} cells")
    dt = torch.tensor(case.time.delta_t, dtype=meshes["heater"].v.dtype,
                      device=meshes["heater"].device)
    cycle = CHT_REGIONS

    def chunk_of(k):
        def chunk(st):
            for _ in range(k):
                sim.step(dt)
            return st, {}
        return chunk

    spmv.LAUNCHES = spmv.FB_LAUNCHES = 0
    t0 = time.perf_counter()
    chunk_of(CHT_HEAD_WARMUP)(None)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    secs = []
    l0 = spmv.LAUNCHES
    with StepLog(cycle) as log:
        for _ in range(CHT_HEAD_TRIALS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            chunk_of(CHT_HEAD_CHUNK)(None)
            torch.cuda.synchronize()
            secs.append((time.perf_counter() - t0) / CHT_HEAD_CHUNK)
    sec = statistics.median(secs)
    steps = CHT_HEAD_WARMUP + CHT_HEAD_TRIALS * CHT_HEAD_CHUNK
    per_step = (spmv.LAUNCHES - l0) / (CHT_HEAD_TRIALS * CHT_HEAD_CHUNK)
    its = {k: [int(i) for i in v] for k, v in log.iterations.items()}
    progress("cht_headline", f"chunks {secs}, PCG {its}")
    # the exchange alone (idempotent: it recomputes the BCs from T)
    ex = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.exchange()
        torch.cuda.synchronize()
        ex.append((time.perf_counter() - t0) * 1e3)
    launches = spmv.LAUNCHES
    mesh = meshes["heater"]
    op = mat_operand(mesh, log.matrices["heater"], "slab_T")
    deltas = tuple(mesh.st_deltas)
    cases, max_err = [], 0.0
    for dtype in (torch.float32, torch.float64):
        err = check_operands(spmv, [op], mesh, deltas, dtype,
                             np.random.default_rng(125), cases)
        if dtype == torch.float32:
            max_err = err
    _, soff, dg, _ = op
    timings = time_shape(spmv, "slab_T", dg.contiguous(), operand_x(dg, 126),
                         soff.contiguous(), deltas, flush)
    l1 = spmv.LAUNCHES
    _, prof = profile_chunk(spmv, "cht_headline_profile", mesh,
                            chunk_of(CHT_HEAD_PROFILE), None,
                            CHT_HEAD_PROFILE, sec,
                            log=StepLog(cycle, ranges=True))
    launches += spmv.LAUNCHES - l1
    steps += CHT_HEAD_PROFILE
    T = {r: sim.get_T(r).data for r in CHT_REGIONS}
    out = {"phase": "cht_headline",
           "case": "chtMultiRegionFoam heatedSlabs, two slabs of ({} {} 1) "
                   "cells, the tutorial's properties, fields and deltaT, "
                   "the reference's solid controls".format(*CHT_HEAD_CELLS),
           "n_cells": n, "dtype": str(mesh.v.dtype), "steps": steps,
           "st_deltas": list(deltas), **mesh_secs, "setup_s": setup_s,
           "warmup_s": warm_s, "sec_per_step": sec,
           "sec_per_step_trials": secs, "m_cells_per_sec": n / sec / 1e6,
           "pcg_iterations": its,
           "pcg_iterations_mean": {k: statistics.mean(v)
                                   for k, v in its.items() if v},
           "exchange_host_ms": ex,
           "exchange_host_ms_median": statistics.median(ex),
           "interface_faces": int(sim.interfaces[0].a_to_b.shape[0]),
           "spmv_launches_per_step": per_step,
           "cuda_launch_kernel_per_step": prof["cuda_launch_kernel_per_iter"],
           "device_ms_per_step": prof["device_ms_per_iter"],
           "device_busy_share": prof["device_busy_share_unprofiled"],
           "spmv_device_ms_per_step": prof["spmv_device_ms_per_iter"],
           "top_kernels_ms_per_step": prof["top_kernels_ms_per_iter"][:8],
           "T_range": {r: [float(t.min()), float(t.max())]
                       for r, t in T.items()},
           "spmv_launches_total": launches,
           "spmv_fb_launches_total": spmv.FB_LAUNCHES,
           "kernel_cases": cases, "max_abs_err_f32": max_err,
           "timings": timings,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    checks = {"finite": all(bool(torch.isfinite(t).all())
                            for t in T.values()),
              "T within 300-400 K": all(
                  299.999 <= lo and hi <= 400.001
                  for lo, hi in out["T_range"].values()),
              "one interface": len(sim.interfaces) == 1,
              "spmv launched": launches > 0,
              "no remainder on the slabs": mesh.fb_cells.shape[0] == 0}
    out["checks"] = checks
    emit(out)
    for name, ok in checks.items():
        check(ok, f"cht_headline check {name}: {out}")
    return out, max_err, timings


# ---------------------------------------------------------------------------
# the multiphase family
# ---------------------------------------------------------------------------

# application -> (tutorial path, its Allrun runs setFields)
SLICE13_TUTORIALS = {
    "twoLiquidMixingFoam": (("multiphase", "twoLiquidMixingFoam",
                             "mixingColumn"), True),
    "interMixingFoam": (("multiphase", "interMixingFoam", "damBreak3phase"),
                        True),
    "interPhaseChangeFoam": (("multiphase", "interPhaseChangeFoam",
                              "cavitatingBox"), False),
    "multiphaseInterFoam": (("multiphase", "multiphaseInterFoam",
                             "damBreak4phase"), True),
    # damBreak4phase under MRFMultiphaseInterFoam, with the MRFZones of
    # MRFInterFoam's damBreak (the same tank): the tutorial has none
    "MRFMultiphaseInterFoam": (("multiphase", "multiphaseInterFoam",
                                "damBreak4phase"), True),
    "compressibleInterFoam": (("multiphase", "compressibleInterFoam",
                               "depthCharge2D"), True),
    "settlingFoam": (("multiphase", "settlingFoam", "tank"), False),
    "cavitatingFoam": (("multiphase", "cavitatingFoam", "throttle2D"), False),
    "sonicLiquidFoam": (("compressible", "sonicLiquidFoam",
                         "decompressionTank"), False),
    "twoPhaseEulerFoam": (("multiphase", "twoPhaseEulerFoam",
                           "bubbleColumn"), False),
    "bubbleFoam": (("multiphase", "bubbleFoam", "bubbleColumn"), False),
    "multiphaseEulerFoam": (("multiphase", "multiphaseEulerFoam",
                             "threePhaseColumn"), True),
}
MRF_DAMBREAK_ZONES = os.path.join("tutorials", "multiphase", "MRFInterFoam",
                                  "damBreak", "constant", "MRFZones")
DAMBREAK4_PHASES = ("alphawater", "alphaoil", "alphaair")
# the fourth phase of the N = 4 variant of damBreak4phase (the tutorial
# here carries three): mercury, from the water column's left half
MERCURY = "mercury { nu nu [0 2 -1 0 0 0 0] 1.125e-07; " \
          "rho rho [1 -3 0 0 0 0 0] 13529; }"
SLICE13_SEED = 13
# per tutorial, the perturbations of a seeded start, from numpy's
# generator: ("vec", field, s) adds s N(0, 1) to the x and y components;
# ("frac", field, s) mixes a fraction with s of a uniform draw, (1 - s) a
# + s u; ("fractions", fields, s) mixes the N fractions with s of a random
# point of the simplex (their sum stays 1); ("split", a1, a2, s) sets
# alpha2 to a share 0.5 +- s/2 of the liquid 1 - alpha1 (interMixingFoam:
# the D23 exchange then acts, damBreak3phase ships alpha2 = 0);
# ("around", field, c, s) sets c + s (u - 1/2) (cavitatingBox's p_rgh
# about pSat: condensation and vaporisation both act); ("rel", field,
# s) multiplies by 1 + s u. Uniform starts under the vanLeer weights
# follow the sign of round-off, and a start at rest goes nowhere
SLICE13_SEEDS = {
    "twoLiquidMixingFoam": (("vec", "U", 0.01), ("frac", "alpha1", 0.1)),
    "interMixingFoam": (("vec", "U", 0.01), ("frac", "alpha1", 0.1),
                        ("split", "alpha1", "alpha2", 0.5)),
    "interPhaseChangeFoam": (("vec", "U", 0.01), ("frac", "alpha1", 0.3),
                             ("around", "p_rgh", 2300.0, 2000.0)),
    "multiphaseInterFoam": (("vec", "U", 0.01),
                            ("fractions", DAMBREAK4_PHASES, 0.1)),
    "MRFMultiphaseInterFoam": (("vec", "U", 0.01),
                               ("fractions", DAMBREAK4_PHASES, 0.1)),
    "compressibleInterFoam": (("vec", "U", 0.01), ("frac", "alpha1", 0.1),
                              ("rel", "T", 0.01)),
    # the tank as shipped is at rest with a uniform alpha: its U is
    # round-off (1e-10 m/s)
    "settlingFoam": (("vec", "U", 0.001), ("frac", "alpha", 0.2)),
}
# converged p controls for the parity cases whose shipped solve stops at
# relTol 0.01-0.05 where round-off of 1e-14 moves the fields by 1e-9 to
# 1e-8 within three steps (cavitatingBox's p_rgh 1.7e-8, throttle2D's p
# 2.2e-9, the tank's U 2.9e-10, measured in float64)
SLICE13_TIGHT = {
    "interPhaseChangeFoam": {"p_rgh": "solver PCG; preconditioner "
                             "polynomial; tolerance 1e-12; relTol 0; "
                             "maxIter 2000;"},
    "settlingFoam": {"p_rgh": "solver PCG; preconditioner polynomial; "
                     "tolerance 1e-12; relTol 0; maxIter 2000;"},
    "cavitatingFoam": {"p": "solver PCG; preconditioner polynomial; "
                       "tolerance 1e-12; relTol 0; maxIter 2000;"},
}


def _seed_slice13(dst, ops, seed):
    from foamtpu_torch.core.case import Case

    case = Case(dst, device="cpu")
    n = case.mesh.n_cells
    rng = np.random.default_rng(seed)

    def get(f):
        return case.read_field(f).data.double().numpy().copy()

    for op in ops:
        kind = op[0]
        if kind == "vec":
            a = get(op[1])
            a[:, :2] += op[2] * rng.standard_normal((n, 2))
            set_internal(dst, op[1], a)
        elif kind == "frac":
            set_internal(dst, op[1], (1.0 - op[2]) * get(op[1])
                         + op[2] * rng.random(n))
        elif kind == "fractions":
            A = np.stack([get(f) for f in op[1]], axis=1)
            R = rng.random(A.shape)
            A = (1.0 - op[2]) * A + op[2] * R / R.sum(axis=1, keepdims=True)
            for i, f in enumerate(op[1]):
                set_internal(dst, f, A[:, i])
        elif kind == "split":
            liquid = np.clip(1.0 - get(op[1]), 0.0, 1.0)
            share = 0.5 + op[3] * (rng.random(n) - 0.5)
            set_internal(dst, op[2], liquid * share)
        elif kind == "around":
            set_internal(dst, op[1], op[2] + op[3] * (rng.random(n) - 0.5))
        else:
            set_internal(dst, op[1], get(op[1]) * (1.0 + op[2]
                                                   * rng.random(n)))


def _four_phases(dst):
    """damBreak4phase with mercury as a fourth phase (before setFields):
    its transportProperties entry, 0/alphamercury and the setFields
    default."""
    tp = os.path.join(dst, "constant", "transportProperties")
    _edit(tp, r"phases\s*\(([^)]*)\);",
          lambda m: f"phases ({m.group(1).strip()} mercury);\n\n{MERCURY}")
    with open(os.path.join(dst, "0", "alphaoil")) as f:
        text = f.read()
    _write_text(dst, os.path.join("0", "alphamercury"),
                text.replace("alphaoil", "alphamercury"))
    _edit(os.path.join(dst, "system", "setFieldsDict"),
          r"(volScalarFieldValue alphaair 1)",
          lambda m: m.group(1) + "\n    volScalarFieldValue alphamercury 0")


def _mercury_column(dst):
    """After setFields: the left half of the water column is mercury."""
    from foamtpu_torch.core.case import Case

    case = Case(dst, device="cpu")
    x = case.mesh.c[:, 0].double().numpy()
    water = case.read_field("alphawater").data.double().numpy()
    hg = np.where(x < 0.0731, water, 0.0)
    set_internal(dst, "alphawater", water - hg)
    set_internal(dst, "alphamercury", hg)


def slice13_case(here, dst, name, cli, device=(), seed=None, model=None,
                 four_phases=False, controls=None, write_precision=None,
                 blocks=None):
    """The tutorial of application `name` (SLICE13_TUTORIALS) copied to
    dst, meshed by `cli`'s blockMesh and setFields where its Allrun runs
    it (setFields gets `device`; cli None: not meshed). MRFMultiphaseInter
    Foam gets MRF_DAMBREAK_ZONES as constant/MRFZones; `model` replaces
    interPhaseChangeFoam's phaseChangeTwoPhaseMixture (Kunz, Merkle);
    `four_phases` adds mercury (damBreak4phase, N = 4); `controls`
    ({field: entry}) replaces fvSolution solver entries; `blocks` sets the
    block's cell counts; `write_precision` the controlDict's; `seed`
    perturbs the start (SLICE13_SEEDS, four phases with mercury). Returns
    dst."""
    rel, set_fields = SLICE13_TUTORIALS[name]
    shutil.copytree(os.path.join(here, "tutorials", *rel), dst)
    control = os.path.join(dst, "system", "controlDict")
    if name == "MRFMultiphaseInterFoam":
        _edit(control, r"application\s+\w+;",
              "application MRFMultiphaseInterFoam;")
        shutil.copy(os.path.join(here, MRF_DAMBREAK_ZONES),
                    os.path.join(dst, "constant", "MRFZones"))
    if write_precision is not None:
        with open(control, "a") as f:
            f.write(f"\nwritePrecision {write_precision};\n")
    if model is not None:
        _edit(os.path.join(dst, "constant", "transportProperties"),
              r"phaseChangeTwoPhaseMixture\s+\w+;",
              f"phaseChangeTwoPhaseMixture {model};")
    if four_phases:
        _four_phases(dst)
    for field, entry in (controls or {}).items():
        _edit(os.path.join(dst, "system", "fvSolution"),
              rf"(\s){field}\s*\{{[^}}]*\}}",
              lambda m: f"{m.group(1)}{field} {{ {entry} }}", count=1)
    if blocks is not None:
        _edit(blockmesh_dict(dst), r"(hex\s*\([^)]*\)\s*)\(([^)]*)\)",
              lambda m: "{}({} {} 1)".format(m.group(1), *blocks))
    if cli is None:
        return dst
    with quiet():
        check(cli(["blockMesh", "-case", dst]) == 0, "blockMesh failed")
        if set_fields:
            check(cli(["setFields", "-case", dst, *device]) == 0,
                  "setFields failed")
    if four_phases:
        _mercury_column(dst)
    if seed is not None:
        ops = SLICE13_SEEDS[name]
        if four_phases:
            ops = tuple(op if op[0] != "fractions" else
                        ("fractions", op[1] + ("alphamercury",), op[2])
                        for op in ops)
        _seed_slice13(dst, ops, seed)
    return dst


# the cases of the slice's f64 parity tests (tests/test_torch_multiphase_
# vof.py, _euler.py, test_torch_settling_cavitating.py): name ->
# (application, slice13_case options). Seeded where a vanLeer limiter
# meets a uniform start; the Euler-Euler, settling and barotropic steps
# weigh U upwind and start as shipped
SLICE13_CASES = {
    "twoLiquidMixingFoam": ("twoLiquidMixingFoam", {"seed": SLICE13_SEED}),
    "interMixingFoam": ("interMixingFoam", {"seed": SLICE13_SEED}),
    "interPhaseChangeFoam": ("interPhaseChangeFoam", {
        "seed": SLICE13_SEED, "controls": SLICE13_TIGHT[
            "interPhaseChangeFoam"]}),
    "interPhaseChangeFoam_Kunz": ("interPhaseChangeFoam", {
        "seed": SLICE13_SEED, "model": "Kunz",
        "controls": SLICE13_TIGHT["interPhaseChangeFoam"]}),
    "interPhaseChangeFoam_Merkle": ("interPhaseChangeFoam", {
        "seed": SLICE13_SEED, "model": "Merkle",
        "controls": SLICE13_TIGHT["interPhaseChangeFoam"]}),
    "multiphaseInterFoam": ("multiphaseInterFoam", {"seed": SLICE13_SEED}),
    "multiphaseInterFoam_4": ("multiphaseInterFoam", {
        "seed": SLICE13_SEED, "four_phases": True}),
    "MRFMultiphaseInterFoam": ("MRFMultiphaseInterFoam",
                               {"seed": SLICE13_SEED}),
    "compressibleInterFoam": ("compressibleInterFoam",
                              {"seed": SLICE13_SEED}),
    "settlingFoam": ("settlingFoam",
                     {"seed": SLICE13_SEED,
                      "controls": SLICE13_TIGHT["settlingFoam"]}),
    "cavitatingFoam": ("cavitatingFoam",
                       {"controls": SLICE13_TIGHT["cavitatingFoam"]}),
    "sonicLiquidFoam": ("sonicLiquidFoam", {}),
    "twoPhaseEulerFoam": ("twoPhaseEulerFoam", {}),
    "bubbleFoam": ("bubbleFoam", {}),
    "multiphaseEulerFoam": ("multiphaseEulerFoam", {}),
}


def slice13_parity_case(here, dst, name, cli, device=()):
    """The case `name` of SLICE13_CASES, fields written with 17 digits."""
    app, opts = SLICE13_CASES[name]
    return slice13_case(here, dst, app, cli, device=device,
                        write_precision=17, **opts)


# the `multiphase` phase's runs of the tutorials as shipped: name ->
# (application, slice13_case options, steps): 20-50 of their 20-1000
# steps (PERF.md §4)
SLICE13_RUNS = {
    "twoLiquidMixingFoam": ("twoLiquidMixingFoam", {}, 20),
    "interMixingFoam": ("interMixingFoam", {}, 20),
    "interPhaseChangeFoam": ("interPhaseChangeFoam", {}, 20),
    "multiphaseInterFoam": ("multiphaseInterFoam", {}, 20),
    "MRFMultiphaseInterFoam": ("MRFMultiphaseInterFoam", {}, 20),
    "compressibleInterFoam": ("compressibleInterFoam", {}, 20),
    "settlingFoam": ("settlingFoam", {}, 20),
    "cavitatingFoam": ("cavitatingFoam", {}, 20),
    "sonicLiquidFoam": ("sonicLiquidFoam", {}, 20),
    # the rising band of tests/test_tutorial_cases.py needs its 50 steps
    "twoPhaseEulerFoam": ("twoPhaseEulerFoam", {}, 50),
    "bubbleFoam": ("bubbleFoam", {}, 20),
    "multiphaseEulerFoam": ("multiphaseEulerFoam", {}, 20),
}


def slice13_arrays(name, final_state, host):
    """The fields of a run's final state as float64 numpy, named without
    underscores (small_golden_errs reads a golden key's field from its
    first word): the N-phase fractions one array per phase (alpha0...),
    multiphaseEulerFoam's velocities U0..."""
    st = final_state.get("state", final_state)

    def f(k):
        return np.asarray(host(getattr(st[k], "data", st[k])),
                          dtype=np.float64)

    out = {}
    for k, alias in (("U", "U"), ("p", "p"), ("p_rgh", "prgh"),
                     ("alpha", "alpha"), ("alpha1", "alpha1"),
                     ("alpha2", "alpha2"), ("T", "T"), ("p_abs", "pabs"),
                     ("rho", "rho"), ("Ua", "Ua"), ("Ub", "Ub")):
        if k in st and not (k == "rho" and "p" not in st):
            out[alias] = f(k)
    if "alphas" in st:
        A = f("alphas")
        out.update({f"alpha{i}": A[:, i] for i in range(A.shape[1])})
    if "phis" in st:
        out.update({f"U{i}": f(f"U{i}") for i in range(
            np.asarray(host(st["phis"])).shape[1])})
        out.pop("U", None)
    return out


def slice13_start_arrays(name, case):
    """The fractions of a case's start time under the names of
    slice13_arrays (the oracles' a0)."""
    from foamtpu_torch.solvers import apps

    def read(*names):
        for n in names:
            if os.path.exists(os.path.join(case.dir, "0", n)):
                return case.read_field(n).data.double().cpu().numpy()
        check(False, f"{case.dir}: none of {names} at the start time")

    tp = case.transport_properties()
    if name in ("multiphaseInterFoam", "MRFMultiphaseInterFoam",
                "multiphaseEulerFoam"):
        names = ([str(x) for x in tp.get("phases", [])]
                 if name != "multiphaseEulerFoam"
                 else apps.multiphase_euler_phases(tp)[0])
        return {f"alpha{i}": read(f"alpha{n}") for i, n in enumerate(names)}
    if name == "interMixingFoam":
        return {"alpha1": read("alpha1"), "alpha2": read("alpha2")}
    if name in ("cavitatingFoam", "sonicLiquidFoam"):
        return {}
    return {"alpha": read("alpha", "alpha1")}


def slice13_oracles(name, a0, a, v, c):
    """The reference tests' oracles on a run of `name` from the arrays of
    its first (a0) and final state (a) (slice13_arrays), with the cell
    volumes and centres: bounded fractions that sum to 1, each phase's
    volume conserved where the tank is sealed or barely open (1e-2, as
    tests/test_tutorial_cases.py holds damBreak), the rising bubble band
    (tests/test_tutorial_cases.py:147-167), depthCharge2D's pressure range
    (:128-145), cavitatingBox's liquid vaporising below pSat, the
    settling tank's dispersed mass."""
    checks = {"finite": all(bool(np.isfinite(x).all()) for x in a.values())}
    if not checks["finite"]:
        return checks

    def vol(x):
        return float((x * v).sum())

    def conserved(key, tol=1e-2):
        checks[f"{key} volume conserved to {tol:g}"] = (
            abs(vol(a[key]) - vol(a0[key])) <= tol * max(vol(a0[key]), 1e-30))

    def bounded(key, eps=1e-6):
        checks[f"{key} in [0, 1]"] = bool(a[key].min() >= -eps
                                          and a[key].max() <= 1.0 + eps)

    fracs = sorted(k for k in a if re.fullmatch(r"alpha\d", k)
                   and name != "interMixingFoam")
    if fracs:
        s = sum(a[k] for k in fracs)
        checks["fractions sum to 1"] = float(np.abs(s - 1.0).max()) < 1e-5
        for k in fracs:
            bounded(k)
            conserved(k)
    if name == "twoLiquidMixingFoam":
        bounded("alpha")
        conserved("alpha")
    elif name == "interMixingFoam":
        bounded("alpha1")
        bounded("alpha2")
        checks["alpha3 = 1 - alpha1 - alpha2 >= 0"] = bool(
            (1.0 - a["alpha1"] - a["alpha2"]).min() >= -1e-6)
        conserved("alpha1")
    elif name == "interPhaseChangeFoam":
        bounded("alpha")
        # p_rgh starts at 500 Pa, below pSat 2300: the liquid vaporises
        checks["alpha falls below its start"] = vol(a["alpha"]) < vol(
            a0["alpha"]) and a["alpha"].min() < a0["alpha"].min()
        # and the box stays at rest (SLICE13_GOLDEN_FIELDS)
        checks["at rest: |U| < 1e-5"] = float(
            np.linalg.norm(a["U"], axis=1).max()) < 1e-5
        checks["at rest: |p_rgh| < 1e-4 pSat"] = float(
            np.abs(a["prgh"]).max()) < 0.23
    elif name == "compressibleInterFoam":
        bounded("alpha", 1e-4)
        checks["p_abs max > 2e5 (the charge)"] = float(a["pabs"].max()) > 2e5
        checks["p_abs min < 2e5 (the far field)"] = (
            float(a["pabs"].min()) < 2e5)
    elif name == "settlingFoam":
        bounded("alpha")
        rho = 1.0 / (a["alpha"] / 1042.0 + (1.0 - a["alpha"]) / 1000.0)
        rho0 = 1.0 / (a0["alpha"] / 1042.0 + (1.0 - a0["alpha"]) / 1000.0)
        checks["dispersed mass conserved to 1e-3"] = abs(
            vol(rho * a["alpha"]) - vol(rho0 * a0["alpha"])) <= 1e-3 * vol(
                rho0 * a0["alpha"])
    elif name in ("twoPhaseEulerFoam", "bubbleFoam"):
        bounded("alpha", 1e-5)
        # the reference test's thresholds after its 50 steps; bubbleFoam's
        # 20-step run: the air has entered (alpha 0.04 at the inlet rows)
        lim = 0.05 if name == "twoPhaseEulerFoam" else 0.01
        checks[f"air entered: max alpha > {lim}"] = float(
            a["alpha"].max()) > lim
        low = c[:, 1] < 0.2
        checks[f"air low in the column > {lim}"] = float(
            a["alpha"][low].max()) > lim
        if name == "twoPhaseEulerFoam":
            sel = a["alpha"] > 0.01
            checks["the band rises: mean Ua_y > 0.01"] = bool(
                sel.any() and float(a["Ua"][sel, 1].mean()) > 0.01)
    elif name == "multiphaseEulerFoam":
        # phases (air oil water): the air band rises
        y0 = vol(a0["alpha0"] * c[:, 1]) / vol(a0["alpha0"])
        y1 = vol(a["alpha0"] * c[:, 1]) / vol(a["alpha0"])
        checks["the air band's centroid rises"] = y1 > y0
    elif name in ("cavitatingFoam", "sonicLiquidFoam"):
        checks["rho > 0"] = float(a["rho"].min()) > 0.0
    return checks



# goldens from the JAX package (CPU, float32) and its spread under
# round-off (the larger of |float32 - float64| and the change a 1e-7
# perturbation of the start makes in float32): `python
# tests/test_torch_multiphase_vof.py goldens [--perturb]`; held at
# small_golden_errs
SLICE13_GOLDEN = {'twoLiquidMixingFoam': {'Ux_mean': -2.417502057323712e-05,
                         'U_mag_mean': 0.0002965625253235643,
                         'U_mag_max': 0.0020630310498871303,
                         'prgh_mean': -3.741903741019115,
                         'prgh_min': -26.361228942871094,
                         'prgh_max': 3.738689422607422,
                         'alpha_mean': 0.13043475356339515,
                         'alpha_min': 0.0,
                         'alpha_max': 1.0},
 'interMixingFoam': {'Ux_mean': -2.4215522713500482e-05,
                     'U_mag_mean': 0.00029234849662299425,
                     'U_mag_max': 0.0020566908012448547,
                     'prgh_mean': -3.6982529376867284,
                     'prgh_min': -25.088834762573242,
                     'prgh_max': 3.884824275970459,
                     'alpha1_mean': 0.13043478303087205,
                     'alpha1_min': -3.2389958236605307e-25,
                     'alpha1_max': 1.0,
                     'alpha2_mean': 0.0,
                     'alpha2_min': 0.0,
                     'alpha2_max': 0.0},
 'interPhaseChangeFoam': {'Ux_mean': -2.0101563677488165e-11,
                          'U_mag_mean': 2.1624834646898492e-09,
                          'U_mag_max': 4.607637513934535e-09,
                          'prgh_mean': -2.890363851282274e-06,
                          'prgh_min': -6.0303209465928376e-05,
                          'prgh_max': 4.909422204946168e-05,
                          'alpha_mean': 0.9897187352180479,
                          'alpha_min': 0.9897187352180481,
                          'alpha_max': 0.9897187352180481},
 'multiphaseInterFoam': {'Ux_mean': 0.008407356458967837,
                         'U_mag_mean': 0.08190947209541366,
                         'U_mag_max': 1.2302079134275001,
                         'prgh_mean': 204.62489650224734,
                         'prgh_min': -20.862686157226562,
                         'prgh_max': 2401.508056640625,
                         'alpha0_mean': 0.0680346863585042,
                         'alpha0_min': -7.872985516831809e-20,
                         'alpha0_max': 1.0,
                         'alpha1_mean': 0.06238060944012422,
                         'alpha1_min': -6.443380767136805e-19,
                         'alpha1_max': 1.0,
                         'alpha2_mean': 0.8695847041747684,
                         'alpha2_min': -6.307427533006697e-17,
                         'alpha2_max': 1.0},
 'MRFMultiphaseInterFoam': {'Ux_mean': 0.008617802621754048,
                            'U_mag_mean': 0.0825061842230732,
                            'U_mag_max': 1.2302080539865496,
                            'prgh_mean': 204.62461578093684,
                            'prgh_min': -20.86286163330078,
                            'prgh_max': 2401.50537109375,
                            'alpha0_mean': 0.06803468402504231,
                            'alpha0_min': 0.0,
                            'alpha0_max': 1.0,
                            'alpha1_mean': 0.06238061084171647,
                            'alpha1_min': -1.0215912837345897e-16,
                            'alpha1_max': 1.0,
                            'alpha2_mean': 0.8695847052290278,
                            'alpha2_min': -8.31648118426731e-14,
                            'alpha2_max': 1.0},
 'compressibleInterFoam': {'Ux_mean': -3.783125430313009e-07,
                           'U_mag_mean': 0.6367074638961742,
                           'U_mag_max': 5.0639446825806615,
                           'prgh_mean': 575673.8917529297,
                           'prgh_min': 130776.953125,
                           'prgh_max': 989933.5625,
                           'alpha_mean': 0.04025102751418259,
                           'alpha_min': 0.0,
                           'alpha_max': 1.0,
                           'T_mean': 296.72589264869686,
                           'T_min': 95.31182098388672,
                           'T_max': 300.26556396484375,
                           'pabs_mean': 570961.3256396485,
                           'pabs_min': 121139.765625,
                           'pabs_max': 989481.8125},
 'settlingFoam': {'Ux_mean': -4.812853080848888e-08,
                  'U_mag_mean': 1.267253883018881e-07,
                  'U_mag_max': 2.512090359067079e-07,
                  'prgh_mean': -0.15222898650801656,
                  'prgh_min': -1.6090004444122314,
                  'prgh_max': 3.7152050936128944e-05,
                  'alpha_mean': 0.19999999895691878,
                  'alpha_min': 0.1799684315919876,
                  'alpha_max': 0.2188965231180191},
 'cavitatingFoam': {'Ux_mean': 9.995788439114888,
                    'U_mag_mean': 9.995788680065779,
                    'U_mag_max': 10.010177007071999,
                    'p_mean': 101283.23757595487,
                    'p_min': 100014.140625,
                    'p_max': 103089.46875,
                    'rho_mean': 830.0459828694662,
                    'rho_min': 830.04541015625,
                    'rho_max': 830.0468139648438},
 'sonicLiquidFoam': {'Ux_mean': 2.9998783732187886,
                     'U_mag_mean': 2.999878414262274,
                     'U_mag_max': 3.0102251776011526,
                     'p_mean': 100069.60625590975,
                     'p_min': 99997.4453125,
                     'p_max': 125187.359375,
                     'rho_mean': 1000.0000310852415,
                     'rho_min': 1000.0,
                     'rho_max': 1000.0114135742188},
 'twoPhaseEulerFoam': {'p_mean': 4946.640925811767,
                       'p_min': 90.55675506591797,
                       'p_max': 9841.53515625,
                       'alpha_mean': 0.0025000000509215817,
                       'alpha_min': 0.0,
                       'alpha_max': 0.07537192851305008,
                       'Uax_mean': -3.7850934401095766e-07,
                       'Ua_mag_mean': 0.2982247809984562,
                       'Ua_mag_max': 0.3358653784336193,
                       'Ubx_mean': -2.0789087693910225e-09,
                       'Ub_mag_mean': 0.010872646109555646,
                       'Ub_mag_max': 0.09689070291440847},
 'bubbleFoam': {'p_mean': 4989.663258799235,
                'p_min': 89.5479507446289,
                'p_max': 9933.048828125,
                'alpha_mean': 0.0010000000304918736,
                'alpha_min': 0.0,
                'alpha_max': 0.04032937437295914,
                'Uax_mean': 1.4653881489525842e-06,
                'Ua_mag_mean': 0.29742458940162936,
                'Ua_mag_max': 0.32829862869441534,
                'Ubx_mean': 2.983870917394605e-08,
                'Ub_mag_mean': 0.005571309331409529,
                'Ub_mag_max': 0.04963014647809068},
 'multiphaseEulerFoam': {'p_mean': -1418.5739433858294,
                         'p_min': -2832.44921875,
                         'p_max': 3.369572877883911,
                         'alpha0_mean': 0.016713509447261198,
                         'alpha0_min': 0.0,
                         'alpha0_max': 0.10106303542852402,
                         'alpha1_mean': 0.16666664165821435,
                         'alpha1_min': -3.2212507211538147e-27,
                         'alpha1_max': 1.0,
                         'alpha2_mean': 0.8166198502744758,
                         'alpha2_min': 6.821224764501019e-14,
                         'alpha2_max': 1.0,
                         'U0x_mean': -2.7581787912084443e-05,
                         'U0_mag_mean': 0.19943498274067073,
                         'U0_mag_max': 0.28135865935043547,
                         'U1x_mean': -9.795174973703524e-07,
                         'U1_mag_mean': 0.02984935935936038,
                         'U1_mag_max': 0.0481509753713395,
                         'U2x_mean': 1.149838686029556e-06,
                         'U2_mag_mean': 0.013598047700981929,
                         'U2_mag_max': 0.047986705142350206}}
SLICE13_SPREAD = {'twoLiquidMixingFoam': {'Ux_mean': 4.5110916699914335e-10,
                         'U_mag_mean': 5.650370530079114e-10,
                         'U_mag_max': 4.4281955402861173e-10,
                         'prgh_mean': 0.0004084460617517216,
                         'prgh_min': 0.0003592842322142076,
                         'prgh_max': 0.00039080872056818095,
                         'alpha_mean': 2.8924940775887364e-08,
                         'alpha_min': 0.0,
                         'alpha_max': 0.0},
 'interMixingFoam': {'Ux_mean': 3.7507000960325344e-10,
                     'U_mag_mean': 2.6992534417477274e-10,
                     'U_mag_max': 4.078942357488291e-10,
                     'prgh_mean': 0.000354162892248322,
                     'prgh_min': 0.0003190166074737988,
                     'prgh_max': 0.0002605515824161131,
                     'alpha1_mean': 6.2824412616624414e-09,
                     'alpha1_min': 1.7266635178935936e-20,
                     'alpha1_max': 1.1920928955078125e-07,
                     'alpha2_mean': 0.0,
                     'alpha2_min': 0.0,
                     'alpha2_max': 0.0},
 'interPhaseChangeFoam': {'Ux_mean': 5.737861639500108e-13,
                          'U_mag_mean': 7.099183380645157e-12,
                          'U_mag_max': 2.2975396350215307e-11,
                          'prgh_mean': 1.719346646742866e-06,
                          'prgh_min': 1.7707667845062494e-06,
                          'prgh_max': 1.6943487537015374e-06,
                          'alpha_mean': 4.947185550108202e-08,
                          'alpha_min': 2.8254442896447074e-08,
                          'alpha_max': 1.1920928955078125e-07},
 'multiphaseInterFoam': {'Ux_mean': 8.621336729200402e-06,
                         'U_mag_mean': 5.5841973388814914e-05,
                         'U_mag_max': 1.1723333299684668e-06,
                         'prgh_mean': 0.014560805960911694,
                         'prgh_min': 0.04910960658578034,
                         'prgh_max': 0.01354053518116416,
                         'alpha0_mean': 1.1857809179005585e-09,
                         'alpha0_min': 7.872985516831809e-20,
                         'alpha0_max': 0.0,
                         'alpha1_mean': 4.978883505479814e-08,
                         'alpha1_min': 6.443298757475406e-19,
                         'alpha1_max': 0.0,
                         'alpha2_mean': 4.862965730101365e-08,
                         'alpha2_min': 6.307427533006697e-17,
                         'alpha2_max': 0.0},
 'MRFMultiphaseInterFoam': {'Ux_mean': 8.563301591430275e-06,
                            'U_mag_mean': 5.461883283509883e-05,
                            'U_mag_max': 1.1050195123374351e-06,
                            'prgh_mean': 0.014833896850717565,
                            'prgh_min': 0.04920469282201978,
                            'prgh_max': 0.01460408795173862,
                            'alpha0_mean': 3.098450038208078e-09,
                            'alpha0_min': 8.642319679349662e-29,
                            'alpha0_max': 0.0,
                            'alpha1_mean': 5.195817928682622e-08,
                            'alpha1_min': 1.0215912837345897e-16,
                            'alpha1_max': 0.0,
                            'alpha2_mean': 4.876394266162265e-08,
                            'alpha2_min': 8.31648118426731e-14,
                            'alpha2_max': 0.0},
 'compressibleInterFoam': {'Ux_mean': 4.940066719477171e-07,
                           'U_mag_mean': 1.296870026923358e-07,
                           'U_mag_max': 3.506544769926734e-05,
                           'prgh_mean': 0.04917138325981796,
                           'prgh_min': 0.034180953836767,
                           'prgh_max': 0.3125,
                           'alpha_mean': 1.3130669676564288e-09,
                           'alpha_min': 0.0,
                           'alpha_max': 0.0,
                           'T_mean': 0.00012627357625660807,
                           'T_min': 0.002166748046875,
                           'T_max': 0.00013990752893278113,
                           'pabs_mean': 0.049627228756435215,
                           'pabs_min': 0.030200622757547535,
                           'pabs_max': 0.20160895853769034},
 'settlingFoam': {'Ux_mean': 2.3880445565450845e-10,
                  'U_mag_mean': 2.2692886669219966e-08,
                  'U_mag_max': 6.795292847423347e-08,
                  'prgh_mean': 2.5658185222598995e-06,
                  'prgh_min': 0.0001934777194652071,
                  'prgh_max': 2.1609266696032137e-06,
                  'alpha_mean': 9.68575467052979e-09,
                  'alpha_min': 3.09688510946593e-09,
                  'alpha_max': 1.4901161193847656e-08},
 'cavitatingFoam': {'Ux_mean': 0.00017411226249386402,
                    'U_mag_mean': 0.00017411185712745691,
                    'U_mag_max': 0.0001442906380226816,
                    'p_mean': 6.332964409739361,
                    'p_min': 0.900022570262081,
                    'p_max': 90.22103149000031,
                    'rho_mean': 3.475613198133942e-06,
                    'rho_min': 4.145016532675072e-06,
                    'rho_max': 2.9614317099913023e-05},
 'sonicLiquidFoam': {'Ux_mean': 1.184782081331548e-07,
                     'U_mag_mean': 1.1761237272978065e-07,
                     'U_mag_max': 0.00012441506094607035,
                     'p_mean': 7.130130164849106,
                     'p_min': 2.5546874957944965,
                     'p_max': 37.46685665476252,
                     'rho_mean': 2.721080363699002e-06,
                     'rho_min': 0.0,
                     'rho_max': 4.476984599932621e-06},
 'twoPhaseEulerFoam': {'p_mean': 0.35228512683534063,
                       'p_min': 0.3111640144370966,
                       'p_max': 0.6639272934698965,
                       'alpha_mean': 5.0921581621482526e-11,
                       'alpha_min': 9.757088195221898e-96,
                       'alpha_max': 1.887852526596956e-06,
                       'Uax_mean': 3.78509353929659e-07,
                       'Ua_mag_mean': 0.0001385056477661295,
                       'Ua_mag_max': 3.6664507842010252e-06,
                       'Ubx_mean': 2.078914716690174e-09,
                       'Ub_mag_mean': 1.0437597869478177e-06,
                       'Ub_mag_max': 1.9588833080619317e-07},
 'bubbleFoam': {'p_mean': 0.6714673002634299,
                'p_min': 0.11099346491657514,
                'p_max': 1.141510808844032,
                'alpha_mean': 3.04918735660048e-11,
                'alpha_min': 0.0,
                'alpha_max': 7.791935318773868e-07,
                'Uax_mean': 1.4653881153097821e-06,
                'Ua_mag_mean': 1.1709685759364596e-05,
                'Ua_mag_max': 9.411336255316094e-06,
                'Ubx_mean': 2.983870778542348e-08,
                'Ub_mag_mean': 1.0762453438372885e-06,
                'Ub_mag_max': 9.95693586886004e-08},
 'multiphaseEulerFoam': {'p_mean': 0.09508279896886052,
                         'p_min': 0.11417691892665971,
                         'p_max': 0.08387612568667935,
                         'alpha0_mean': 2.138059521095137e-10,
                         'alpha0_min': 0.0,
                         'alpha0_max': 1.1072116987143055e-08,
                         'alpha1_mean': 3.544461030235979e-09,
                         'alpha1_min': 9.064351374522795e-13,
                         'alpha1_max': 6.894484982922222e-14,
                         'alpha2_mean': 2.3783155445045168e-09,
                         'alpha2_min': 7.512724549691355e-16,
                         'alpha2_max': 0.0,
                         'U0x_mean': 7.211011457181493e-07,
                         'U0_mag_mean': 2.9851137768877045e-06,
                         'U0_mag_max': 2.0861928085036396e-07,
                         'U1x_mean': 7.04920272751886e-08,
                         'U1_mag_mean': 6.141793264247131e-08,
                         'U1_mag_max': 9.685448135871022e-08,
                         'U2x_mean': 7.1978081038636045e-09,
                         'U2_mag_mean': 5.3416798222530315e-08,
                         'U2_mag_max': 1.7292979259050933e-06}}
# the fields whose goldens a run is held to, where not all: cavitatingBox
# as shipped is a box at rest (U 0, p_rgh 500 Pa below pSat 2300) whose
# liquid vaporises; its U and p_rgh stay round-off. With p_rgh converged,
# float64 leaves |U| 5.6e-16 m/s and p_rgh 4e-11 Pa from its reference,
# float32 |U| 2e-7 and p_rgh 0.017 Pa (round-off of the 2300 Pa terms of
# the cavitation sink, the port's on the CPU), and the shipped relTol 0.05
# stop adds its own 4.6e-9 m/s (float64, both packages): no golden holds
# them (the port's float32 run on the CPU is 40x the JAX package's
# float32 there); slice13_oracles holds them at rest instead
SLICE13_GOLDEN_FIELDS = {"interPhaseChangeFoam": ("alpha",)}


def slice13_golden_errs(name, got, a):
    """small_golden_errs of run `name` on SLICE13_GOLDEN, over the fields
    of SLICE13_GOLDEN_FIELDS where it names them."""
    keep = SLICE13_GOLDEN_FIELDS.get(name)
    gold = {k: g for k, g in SLICE13_GOLDEN[name].items()
            if keep is None or k.split("_")[0] in keep}
    return small_golden_errs(got, gold, SLICE13_SPREAD[name],
                             field_scales(a))


# each run's solves in the order of a step (StepLog), where the phase
# holds the SpMV at an operand of it: mixingColumn's implicit alpha
# (ddt + vanLeer div + laplacian(Dab): non-symmetric), U, three p_rgh;
# cavitatingBox's U and two p_rgh with the cavitation sink on the diagonal
SLICE13_CYCLES = {"twoLiquidMixingFoam": ("alpha", "U", "p", "p", "p"),
                  "interPhaseChangeFoam": ("U", "p", "p")}


def phase_multiphase(spmv, here, root, flush):
    """The multiphase family's tutorials as shipped through run(case) on
    the card (SLICE13_RUNS, float32; blockMesh and setFields where the
    Allrun runs it), each held to goldens from the JAX package
    (SLICE13_GOLDEN at small_golden_errs) and to the reference tests'
    oracles (slice13_oracles: bounded fractions summing to 1, phase
    volumes, the rising bubble band, depthCharge2D's pressure range,
    cavitatingBox's vaporisation, the tank's dispersed mass); the SpMV
    kernel held to its plain version, in float32 and float64, and timed at
    mixingColumn's alpha operator (non-symmetric) and cavitatingBox's
    p_rgh (the cavitation sink on its diagonal)."""
    from foamtpu_torch.apps.cli import main as cli
    from foamtpu_torch.core.case import Case

    results, checks, logs = {}, {}, {}
    launches_total = fb_total = 0
    for name, (app, opts, steps) in SLICE13_RUNS.items():
        dst = slice13_case(here, os.path.join(root, "multiphase", name), app,
                           cli, device=("-device", "cuda"), **opts)
        case = Case(dst, device="cuda")
        a0 = slice13_start_arrays(name, case)
        cycle = SLICE13_CYCLES.get(name)
        with (StepLog(cycle) if cycle else contextlib.nullcontext()) as log:
            run_s, text, launches, fb = app_run(spmv, case, steps)
        logs[name] = (case, log)
        launches_total += launches
        fb_total += fb
        a = slice13_arrays(name, case.final_state,
                           lambda t: t.double().cpu().numpy())
        v = case.mesh.v.double().cpu().numpy()
        ck = slice13_oracles(name, a0, a, v,
                             case.mesh.c.double().cpu().numpy())
        got = small_scalars(a, v) if ck["finite"] else {}
        rec = {"tutorial": "/".join(SLICE13_TUTORIALS[app][0]),
               "n_cells": case.mesh.n_cells, "steps": case.time.index,
               "run_s": run_s,
               "sec_per_step": run_s / max(case.time.index, 1),
               "scalars": got, "iterations_max": {
                   k: max(x) for k, x in solve_iterations(text).items()},
               "spmv_launches": launches, "spmv_fb_launches": fb}
        ck.update({"steps": case.time.index == steps,
                   "spmv launched": launches > 0})
        if got:
            errs = slice13_golden_errs(name, got, a)
            rec["golden_err_tol"] = errs
            ck.update({f"golden {k}": e <= t for k, (e, t) in errs.items()})
        results[name] = rec
        checks.update({f"{name} {k}": x for k, x in ck.items()})
        progress("multiphase", f"{name}: {run_s:.1f} s, {launches} SpMV "
                 "launches")

    cases, max_err, timings = [], 0.0, []
    for name, kind, prefix in (
            ("twoLiquidMixingFoam", "alpha", "mixingColumn_alpha"),
            ("interPhaseChangeFoam", "p", "cavitatingBox_p_rgh")):
        case, log = logs[name]
        mesh = case.mesh
        mat = log.matrices[kind]
        op = mat_operand(mesh, mat, prefix)
        deltas = tuple(mesh.st_deltas)
        for dtype in (torch.float32, torch.float64):
            err = check_operands(spmv, [op], mesh, deltas, dtype,
                                 np.random.default_rng(131), cases)
            if dtype == torch.float32:
                max_err = max(max_err, err)
        _, soff, diag, sfb = op
        timings += time_shape(spmv, prefix, diag.contiguous(),
                              operand_x(diag, 132), soff.contiguous(),
                              deltas, flush,
                              fb=mesh_remainder(spmv, mesh, sfb, diag.dtype)
                              if mesh.fb_cells.shape[0] else None)
        checks[f"{prefix} operand is [n]"] = diag.ndim == 1
        if kind == "alpha":
            checks[f"{prefix} non-symmetric"] = not mat.symmetric
    out = {"phase": "multiphase", "dtype": "torch.float32",
           "runs": results, "kernel_cases": cases, "max_abs_err_f32": max_err,
           "timings": timings, "spmv_launches_total": launches_total,
           "spmv_fb_launches_total": fb_total, "checks": checks}
    emit(out)
    for name, ok in checks.items():
        check(ok, f"multiphase check {name}: {out}")
    return out, max_err, timings


MP_HEAD_BLOCKS = (480, 1600)   # bubbleColumn's 15 x 50 refined 32x: 768,000
MP_HEAD_WARMUP = 2
MP_HEAD_TRIALS = 2
MP_HEAD_CHUNK = 10
MP_HEAD_PCG_STEPS = 2
MP_HEAD_PROFILE = 1
# the shipped p controls (PCG, polynomial, relTol 0.01, maxIter 1000)
# reach their cap at 240 x 800 (192,000 cells) on the CPU in the JAX
# package, with continuity 0.14-0.56; GAMG held 3.5e-3 to 5.0e-3 in 17-27
# cycles there: the headline takes GAMG for p, its smoother GaussSeidel
# mapped to Jacobi 4+4 as Case.solver_controls maps it, the shipped
# tolerance and relTol
MP_HEAD_GAMG = {"solver": "GAMG", "smoother": "GaussSeidel",
                "tolerance": 1e-8, "relTol": 0.01, "maxIter": 1000}


def bubble_big_case(here, dst):
    """bubbleColumn copied to dst with its block at MP_HEAD_BLOCKS (not
    meshed, see memory_mesh)."""
    return slice13_case(here, dst, "twoPhaseEulerFoam", None,
                        blocks=MP_HEAD_BLOCKS)


def phase_multiphase_headline(spmv, here, root, flush):
    """twoPhaseEulerFoam on bubbleColumn at MP_HEAD_BLOCKS (768,000 cells),
    meshed in the background process, the tutorial's deltaT, BCs, schemes
    and properties: set-up split into blockMesh, to_device and the GAMG
    hierarchy; MP_HEAD_PCG_STEPS steps with the shipped PCG p from the
    first state (its iterations and continuity); then from the first state
    again with GAMG p (MP_HEAD_GAMG) MP_HEAD_WARMUP steps, MP_HEAD_TRIALS
    timed chunks of MP_HEAD_CHUNK steps with every solve's iterations, the
    SpMV kernel held to its plain version and timed at the two-fluid p and
    the Ub operator, and one profiled step last; held to finiteness,
    bounded alpha, the continuity error and a Courant number below 1."""
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.solvers import apps, twophaseeuler
    from foamtpu_torch.solvers.linear.gamg import GAMG

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dst = bubble_big_case(here, os.path.join(root, "bubble_big"))
    case = Case(dst, device="cuda")
    got = premeshed(dict_key(blockmesh_dict(dst)))
    if got:
        case._poly, mesh_secs = got
    else:
        memory_mesh(case)
        mesh_secs = {}
    t2 = time.perf_counter()
    mesh = case.mesh
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    n = MP_HEAD_BLOCKS[0] * MP_HEAD_BLOCKS[1]
    check(mesh.n_cells == n, mesh.n_cells)
    cfg_pcg = apps.two_phase_euler_config(case)
    gamg = dict(MP_HEAD_GAMG, _gamg=GAMG(mesh, smoother="Jacobi", n_pre=4,
                                         n_post=4))
    cfg = cfg_pcg._replace(p_controls=gamg)
    torch.cuda.synchronize()
    t4 = time.perf_counter()

    def first_state():
        return twophaseeuler.initial_state(
            mesh, case.read_field("Ua"), case.read_field("Ub"),
            case.read_field("p"), case.read_field("alpha"))

    dt = torch.tensor(case.time.delta_t, dtype=mesh.v.dtype,
                      device=mesh.device)
    state = first_state()
    torch.cuda.synchronize()
    setup = dict(mesh_secs, to_device_s=t3 - t2, gamg_hierarchy_s=t4 - t3,
                 setup_s=time.perf_counter() - t0)
    progress("multiphase_headline", f"set-up {setup}, {n} cells")
    cycle = ("Ua", "Ub", "p")

    def chunk_of(cfg, k):
        step = twophaseeuler.make_step(mesh, cfg)

        def chunk(st):
            diag = None
            for _ in range(k):
                st, diag = step(st, dt)
            return st, diag
        return chunk

    spmv.LAUNCHES = spmv.FB_LAUNCHES = 0
    t0 = time.perf_counter()
    with StepLog(cycle) as plog:
        pst, pdiag = chunk_of(cfg_pcg, MP_HEAD_PCG_STEPS)(state)
    torch.cuda.synchronize()
    pcg = {"steps": MP_HEAD_PCG_STEPS, "seconds": time.perf_counter() - t0,
           "p_iterations": [int(i) for i in plog.iterations["p"]],
           "cap": int(cfg_pcg.p_controls.get("maxIter", 1000)),
           "continuity": float(pdiag["continuity"]),
           "continuity_of_a_step": float(pdiag["continuity"])
           * case.time.delta_t}
    del pst, pdiag
    progress("multiphase_headline", f"shipped PCG p: {pcg}")
    t0 = time.perf_counter()
    state, diag = chunk_of(cfg, MP_HEAD_WARMUP)(first_state())
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    secs, courant = [], []
    l_timed = spmv.LAUNCHES
    with StepLog(cycle) as log:
        for _ in range(MP_HEAD_TRIALS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, diag = chunk_of(cfg, MP_HEAD_CHUNK)(state)
            torch.cuda.synchronize()
            secs.append((time.perf_counter() - t0) / MP_HEAD_CHUNK)
            courant.append(float(diag["courant_max"]))
            progress("multiphase_headline", f"chunk {secs[-1]:.3f} s/step, "
                     f"Courant {courant[-1]:.3g}, iterations "
                     f"{ {k: v[-3:] for k, v in log.iterations.items()} }")
    sec = statistics.median(secs)
    timed_steps = MP_HEAD_TRIALS * MP_HEAD_CHUNK
    per_step = (spmv.LAUNCHES - l_timed) / timed_steps
    cont = float(diag["continuity"])
    cases, max_err, timings = [], 0.0, []
    deltas = tuple(mesh.st_deltas)
    for kind, prefix in (("p", "bubbleColumn_p"), ("Ub", "bubbleColumn_Ub")):
        op = mat_operand(mesh, log.matrices[kind], prefix)
        for dtype in (torch.float32, torch.float64):
            err = check_operands(spmv, [op], mesh, deltas, dtype,
                                 np.random.default_rng(133), cases)
            if dtype == torch.float32:
                max_err = max(max_err, err)
        _, soff, dg, sfb = op
        timings += time_shape(spmv, prefix, dg.contiguous(),
                              operand_x(dg, 134), soff.contiguous(), deltas,
                              flush)
    l1 = spmv.LAUNCHES
    state, prof = profile_chunk(spmv, "multiphase_headline_profile", mesh,
                                chunk_of(cfg, MP_HEAD_PROFILE), state,
                                MP_HEAD_PROFILE, sec,
                                log=StepLog(cycle, ranges=True))
    launches = spmv.LAUNCHES
    a = state["alpha"].data
    its = {k: [int(i) for i in v] for k, v in log.iterations.items()}
    out = {"phase": "multiphase_headline",
           "case": "twoPhaseEulerFoam bubbleColumn, block ({} {} 1), deltaT "
                   "{}: the tutorial's BCs, schemes, properties and U "
                   "controls, p by GAMG".format(*MP_HEAD_BLOCKS,
                                                case.time.delta_t),
           "n_cells": n, "dtype": str(mesh.v.dtype), **setup,
           "shipped_pcg": pcg, "p_controls": {
               k: v for k, v in MP_HEAD_GAMG.items()},
           "warmup_s": warm_s, "sec_per_step": sec,
           "sec_per_step_trials": secs, "m_cells_per_sec": n / sec / 1e6,
           "courant_max_per_chunk": courant,
           "iterations_per_solve": {k: statistics.mean(v)
                                    for k, v in its.items() if v},
           "iterations_max": {k: max(v) for k, v in its.items() if v},
           "spmv_launches_per_step": per_step,
           "continuity": cont, "continuity_of_a_step":
               cont * case.time.delta_t,
           "alpha_min": float(a.min()), "alpha_max": float(a.max()),
           "cuda_launch_kernel_per_step": prof["cuda_launch_kernel_per_iter"],
           "device_ms_per_step": prof["device_ms_per_iter"],
           "device_busy_share": prof["device_busy_share_unprofiled"],
           "spmv_device_ms_per_step": prof["spmv_device_ms_per_iter"],
           "spmv_launches_per_step_profiled": prof["spmv_launches_per_iter"],
           "top_kernels_ms_per_step": prof["top_kernels_ms_per_iter"][:8],
           "spmv_launches_total": launches,
           "spmv_fb_launches_total": spmv.FB_LAUNCHES,
           "kernel_cases": cases, "max_abs_err_f32": max_err,
           "timings": timings,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    checks = {"finite": bool(torch.isfinite(a).all())
              and bool(torch.isfinite(state["Ua"].data).all()),
              "alpha in [0, 1]": out["alpha_min"] > -1e-5
              and out["alpha_max"] < 1.0 + 1e-5,
              "spmv launched": launches > 0,
              "continuity of a step < 1e-3":
                  out["continuity_of_a_step"] < 1e-3,
              "Courant < 1": max(courant) < 1.0,
              "GAMG p below its cap": max(its["p"]) < MP_HEAD_GAMG["maxIter"]}
    out["checks"] = checks
    emit(out)
    for name, ok in checks.items():
        check(ok, f"multiphase_headline check {name}: {out}")
    return out, max_err, timings


# ---------------------------------------------------------------------------
# slice 15: radiation and the combustion family
# ---------------------------------------------------------------------------

SLICE15_TUTORIALS = {
    "chemFoam": ("combustion", "chemFoam", "h2"),
    "reactingFoam": ("combustion", "reactingFoam", "counterFlowFlame2D"),
    "XiFoam": ("combustion", "XiFoam", "moriyoshiHomogeneous"),
    "PDRFoam": ("combustion", "PDRFoam", "flamePropagation"),
    "fireFoam": ("combustion", "fireFoam", "smallPoolFire2D"),
}
SLICE15_SEED = 15
# the radiationProperties of the cases with radiation: constantAbsorption-
# Emission (absorptivity = emissivity, 0.5 1/m by default: the reference's
# defaults, apps.py:1520-1523), fvDOM at 2 x 2 rays per octant (16 rays,
# radiation.py's defaults)
RADIATION_PROPS = """FoamFile { version 2.0; format ascii; class dictionary;
           object radiationProperties; }
radiation       on;
radiationModel  %(model)s;
fvDOMCoeffs { nTheta 2; nPhi 2; }
constantAbsorptionEmissionCoeffs
{
    absorptivity absorptivity [0 -1 0 0 0 0 0] %(a)r;
    emissivity   emissivity [0 -1 0 0 0 0 0] %(a)r;
    E            E [1 -1 -3 0 0 0 0] 0;
}
"""
# an fvDOM ray is an upwind transport solve; in an optically thin medium
# its BiCGStab takes 50-130 iterations whose count moves by up to 4 under a
# 1e-15 change of the source (round-off decides it), and in float32 a few
# of its solves return an iterate of |I| up to 1e12 while the recurrence's
# residual reports convergence (the JAX package and the port alike, for
# absorptivity 0.5 to 10: ROADMAP Queue 3). In a thick medium (a h = 1.25
# on hotCavity's 40 x 40) its count holds under round-off and no such
# iterate comes: the f64 parity case and the card's run take that.
THICK_ABSORPTIVITY = 50.0
# the radiative source a G - 4 e sigma T^4 enters the T equation
# explicitly: its time scale rho Cp / (16 e sigma T^3) is 0.010 s at
# 1000 K when e = THICK_ABSORPTIVITY, so hotCavity's deltaT of 0.05 s
# amplifies a change of T about fourfold a step. The card's thick run
# steps below it.
THICK_DT = 0.005
# the pyrolysis region of tests/test_firefoam.py::
# test_pyrolysis_region_feeds_the_fire (hot gas over a pyrolysing base)
PYRO_PROPS = """FoamFile { version 2.0; format ascii; class dictionary;
           object pyrolysisProperties; }
patches ( base );
reactingOneDimCoeffs
{
    nLayers 6; thickness 0.005; k 0.2; rho 500; rhoChar 50;
    Cp 1500; A 1e5; Ta 8000; h 200; T0 600;
}
"""
# a thermoSingleLayer water film on the side walls beside it
FILM_PROPS = """FoamFile { version 2.0; format ascii; class dictionary;
           object surfaceFilmProperties; }
patches ( sides );
thermoSingleLayerCoeffs { nu 1e-6; rho 1000; Tsat 373.15; evapCoeff 1e-3; }
"""


def _seed_u_t(dst, seed, u_scale=COMP_SEED_U, t_scale=COMP_SEED_T):
    """U0 + u_scale max(|U0|, 0.01) n (x and y), T0 (1 + t_scale u) and,
    where the case has them, k and epsilon scaled the same way, n and u
    drawn cell by cell from numpy's generator: the tutorials ship uniform
    fields, where a TVD limiter is a ratio of round-off."""
    from foamtpu_torch.core.case import Case

    case = Case(dst, device="cpu")
    n = case.mesh.n_cells
    rng = np.random.default_rng(seed)
    u0 = case.read_field("U").data.double().numpy()
    u = u0.copy()
    u[:, :2] += (u_scale * max(float(np.abs(u0).max()), 0.01)
                 * rng.standard_normal((n, 2)))
    set_internal(dst, "U", u)
    for name in ("T", "k", "epsilon"):
        if os.path.exists(os.path.join(dst, "0", name)):
            f0 = case.read_field(name).data.double().numpy()
            set_internal(dst, name, f0 * (1.0 + t_scale * rng.random(n)))


def slice15_case(here, dst, name, cli, device=(), seed=None, radiation=None,
                 absorptivity=0.5, regions=False, blocks=None,
                 write_precision=None, delta_t=None, hot=False):
    """The tutorial of `name` (SLICE15_TUTORIALS, or buoyantPimpleFoam's
    hotCavity) copied to dst, `blocks` = (nx, ny) replacing its block's
    cell counts, meshed by `cli`'s blockMesh (XiFoam and PDRFoam then
    setFields; `device` passed on). `radiation` ("P1" / "fvDOM") writes
    constant/radiationProperties (absorptivity and emissivity
    `absorptivity`); `regions` makes smallPoolFire2D the
    pyrolysis case of tests/test_firefoam.py (gas at 900 K, the base a
    still pyrolysing wall) with a water film on its sides; `hot` gives
    hotCavity the walls and gas of tests/test_radiation.py's coupled case
    (1000 K and 500 K, 750 K); `seed` seeds U and T (`_seed_u_t`).
    `write_precision` and `delta_t` edit the controlDict. Returns dst."""
    if name == "buoyantPimpleFoam":
        compressible_case(here, dst, name, cli, device=device)
    else:
        shutil.copytree(os.path.join(here, "tutorials",
                                     *SLICE15_TUTORIALS[name]), dst)
    sysd, const, zero = (os.path.join(dst, d)
                         for d in ("system", "constant", "0"))
    if blocks is not None:
        path = os.path.join(sysd, "blockMeshDict")
        text = open(path).read()
        pat = r"(hex\s*\([^)]*\)\s*)\((\d+)\s+(\d+)\s+(\d+)\)"
        check(re.search(pat, text) is not None, f"{path}: no block")
        with open(path, "w") as f:
            f.write(re.sub(pat, lambda m: f"{m.group(1)}({blocks[0]} "
                           f"{blocks[1]} {m.group(4)})", text, count=1))
    if delta_t is not None:
        _edit(os.path.join(sysd, "controlDict"), r"deltaT\s+[^;]+;",
              f"deltaT {delta_t!r};", count=1)
    if write_precision is not None:
        with open(os.path.join(sysd, "controlDict"), "a") as f:
            f.write(f"\nwritePrecision {write_precision!r};\n")
    if hot:
        for pat, new in ((r"value uniform 330;", "value uniform 1000;"),
                         (r"value uniform 270;", "value uniform 500;"),
                         (r"internalField\s+uniform 300;",
                          "internalField   uniform 750;")):
            _edit(os.path.join(zero, "T"), pat, new)
    if radiation is not None:
        with open(os.path.join(const, "radiationProperties"), "w") as f:
            f.write(RADIATION_PROPS % {"model": radiation,
                                       "a": float(absorptivity)})
    if regions:
        _edit(os.path.join(zero, "T"), r"internalField\s+uniform 300",
              "internalField   uniform 900")
        _edit(os.path.join(zero, "U"),
              r"type flowRateInletVelocity; massFlowRate 0.001; "
              r"value uniform \(0 0.05 0\);",
              "type fixedValue; value uniform (0 0 0);")
        _edit(os.path.join(zero, "CH4"),
              r"base \{ type fixedValue; value uniform 1; \}",
              "base { type zeroGradient; }")
        with open(os.path.join(const, "pyrolysisProperties"), "w") as f:
            f.write(PYRO_PROPS)
        with open(os.path.join(const, "surfaceFilmProperties"), "w") as f:
            f.write(FILM_PROPS)
    if cli is not None and name not in ("chemFoam", "buoyantPimpleFoam"):
        with quiet():
            check(cli(["blockMesh", "-case", dst]) == 0, "blockMesh failed")
            if name in ("XiFoam", "PDRFoam"):
                check(cli(["setFields", "-case", dst, *device]) == 0,
                      "setFields failed")
    if seed is not None:
        _seed_u_t(dst, seed)
    return dst


# the cases of the slice's f64 parity tests (tests/test_torch_radiation.py,
# test_torch_reacting.py, test_torch_firefoam.py): name -> (tutorial,
# slice15_case options). Every start is seeded: the limitedLinear schemes
# meet uniform fields, and counterFlowFlame2D's Uy is 0 (its first Uy solve
# measures round-off).
SLICE15_CASES = {
    "reactingFoam": ("reactingFoam", {"seed": SLICE15_SEED}),
    "XiFoam": ("XiFoam", {"seed": SLICE15_SEED}),
    "PDRFoam": ("PDRFoam", {"seed": SLICE15_SEED}),
    "fireFoam": ("fireFoam", {"seed": SLICE15_SEED}),
    "fireFoamP1": ("fireFoam", {"seed": SLICE15_SEED, "radiation": "P1"}),
    "fireFoamRegions": ("fireFoam", {"seed": SLICE15_SEED,
                                     "regions": True}),
    "hotCavityP1": ("buoyantPimpleFoam", {"seed": SLICE15_SEED,
                                          "radiation": "P1"}),
    "hotCavityFvDOM": ("buoyantPimpleFoam", {
        "seed": SLICE15_SEED, "radiation": "fvDOM",
        "absorptivity": THICK_ABSORPTIVITY}),
}


def slice15_parity_case(here, dst, name, cli, device=()):
    """The case `name` of SLICE15_CASES, fields written with 17 digits."""
    tut, opts = SLICE15_CASES[name]
    return slice15_case(here, dst, tut, cli, device=device,
                        write_precision=17, **opts)


# smallPoolFire2D at its own cell size (20 mm) over a pool 20 times wider
# and taller (12 m x 20 m): 600 x 1000 = 600,000 cells. At 1 mm (the
# tutorial's 0.6 m x 1 m refined 20x) the cells by the base's corners,
# where the fuel inlet meets the sides' entrainment, swing between steps
# until the step breaks down in both packages (a 1 mm patch of the base:
# Courant 19.8, |U| 337 m/s and T 79 K at step 12; at 2.5 mm T 24-3,725 K
# by step 12): infinitelyFastChemistry burns 1/C of the deficient
# reactant each step whatever the step, so finer steps burn faster. At
# 20 mm the swing stays bounded (continuity 5.4e-7 a step over 12 steps
# on 2.4 m x 4 m and 4.8 m x 8 m), but the base's corner cells pass the
# adiabatic flame: after 12 steps the JAX package's corner cell reaches
# 3,386 K on 4.8 m x 8 m (1,229 K off the 10 x 10 corner cells), and on
# this 12 m x 20 m 609, 1,354, 1,985 and 2,342 K at 100, 50, 40 and 33 mm;
# the port on the CPU within 11 K of it at 20 mm, 0.2 K at 33-100 mm
# (tests/test_torch_firefoam.py rehearse). fire_big_oracles holds those
# cells finite only.
FIRE_HEAD_BLOCKS = (600, 1000)
FIRE_HEAD_SCALE = 20.0           # convertToMeters: 0.6 m x 1 m -> 12 x 20
FIRE_HEAD_DT = 1e-3              # the tutorial's deltaT, fixed
FIRE_HEAD_WARMUP = 2
FIRE_HEAD_TRIALS = 2
FIRE_HEAD_CHUNK = 3
FIRE_HEAD_PROFILE = 1
# fire_step's solves in the order of a step (one outer corrector, two
# pressure correctors, P1's G before T, kEpsilon's epsilon and k, then the
# five species as one Y solve)
FIRE_CYCLE = ("U", "G", "T", "p", "p", "epsilon", "k", "Y")


# p_rgh at the headline's width: the shipped polynomial PCG caps at its
# maxIter 500 there, and GAMG is no way out: the transient compressible
# p_rgh solve prepares GAMG's hierarchy from the Laplacian alone
# (buoyantrho.py's prepare_controls on pEqn0, as the reference's), so the
# solve drops psi V/dt from the diagonal; at 120 x 200 its continuity error
# grows to 0.6 a step and the run returns NaN at step 5-6 in both packages
# (ROADMAP Queue 3). The headline keeps PCG and raises its maxIter.
FIRE_HEAD_P_MAXITER = 2000


def fire_pcg_edits(dst):
    """p_rgh and p_rghFinal as shipped (polynomial PCG) with maxIter
    FIRE_HEAD_P_MAXITER."""
    path = os.path.join(dst, "system", "fvSolution")
    for key in ("p_rgh", "p_rghFinal"):
        _edit(path, r"(\n\s*%s\s*\{[^}]*)maxIter 500;" % key,
              r"\1maxIter %d;" % FIRE_HEAD_P_MAXITER, count=1)


def fire_big_case(here, dst, blocks=None, scale=None, delta_t=None):
    """smallPoolFire2D copied to dst with its block at `blocks` and its
    convertToMeters `scale` (not meshed, see memory_mesh), P1 radiation at
    the reference's defaults (absorptivity and emissivity 0.5), p_rgh's
    maxIter raised (fire_pcg_edits), deltaT `delta_t` without
    adjustTimeStep (FIRE_HEAD_BLOCKS, FIRE_HEAD_SCALE, FIRE_HEAD_DT by
    default)."""
    blocks = blocks or FIRE_HEAD_BLOCKS
    scale = FIRE_HEAD_SCALE if scale is None else scale
    delta_t = FIRE_HEAD_DT if delta_t is None else delta_t
    slice15_case(here, dst, "fireFoam", None, radiation="P1", blocks=blocks,
                 delta_t=delta_t)
    if scale != 1:
        _edit(os.path.join(dst, "system", "blockMeshDict"),
              r"convertToMeters\s+1;", f"convertToMeters {scale!r};")
    _edit(os.path.join(dst, "system", "controlDict"),
          r"adjustTimeStep\s+yes;", "adjustTimeStep  no;")
    fire_pcg_edits(dst)
    return dst


# the combustion phase's runs through run(case) on the card, as shipped:
# name -> (tutorial, slice15_case options, steps; None: the controlDict's)
SLICE15_RUNS = {
    # chemFoam: the h2 tutorial's first 50 of its 100 steps (cut for the
    # script's time limit)
    "chemFoam": ("chemFoam", {}, 50),
    "reactingFoam": ("reactingFoam", {}, 10),
    "XiFoam": ("XiFoam", {}, 10),
    "PDRFoam": ("PDRFoam", {}, 10),
    # tests/test_firefoam.py's horizons: 40 and 30 steps
    "fireFoam": ("fireFoam", {}, 40),
    "fireFoamPyrolysis": ("fireFoam", {"regions": True}, 30),
    # hotCavity with tests/test_radiation.py's walls and gas (1000 K, 500 K,
    # 750 K: radiation heats the gas), dark, with P1 and with fvDOM, 5 steps
    "hotCavity": ("buoyantPimpleFoam", {"hot": True}, 5),
    "hotCavityP1": ("buoyantPimpleFoam", {"hot": True, "radiation": "P1"},
                    5),
    # fvDOM in the thick medium at THICK_DT, beside a dark run of the same
    # steps: at a = 0.5 the card's f32 ray solves are the ones that return
    # |I| ~ 1e12 as converged (PERF.md, PR 15), and the first p_rgh PCG
    # after them runs to its cap and the step to NaN
    "hotCavityShort": ("buoyantPimpleFoam", {"hot": True,
                                             "delta_t": THICK_DT}, 5),
    "hotCavityFvDOM": ("buoyantPimpleFoam", {
        "hot": True, "radiation": "fvDOM",
        "absorptivity": THICK_ABSORPTIVITY, "delta_t": THICK_DT}, 5),
}
# goldens from the JAX package (CPU, float32) of SLICE15_RUNS, and their
# spread under round-off (the largest of |float32 - float64|, |float32 -
# float32 from a start whose T is perturbed by 1e-7| and |float32 - the
# port's float32 on the CPU|): `python tests/test_torch_reacting.py goldens
# [--perturb] [--port]` (and with FOAMTPU_X64=1 JAX_ENABLE_X64=1), then
# `... spread f32.json f64.json perturbed.json port.json`. The fires' and
# the cavities' signed means of U sit near zero and round-off sets them:
# their tolerance is SMALL_FLOOR_SCALE of the field's largest value
SLICE15_GOLDEN = {'chemFoam': {'T': 3693.16064453125,
              'YO2': 0.020541071787252174,
              'YH2O': 0.11229525228265838,
              'YCH4': -3.034664109394581e-13,
              'YCO2': 0.137164356212769,
              'YN2': 0.7299999922467262},
 'reactingFoam': {'Ux_mean': 4.288749275747687,
                  'U_mag_mean': 7.668140104940491,
                  'U_mag_max': 86.12055689848847,
                  'p_mean': 100224.34924804686,
                  'p_min': 99307.484375,
                  'p_max': 102920.40625,
                  'T_mean': 2019.8887756347656,
                  'T_min': 1868.850341796875,
                  'T_max': 2881.54736328125,
                  'YO2_mean': 0.2234201381384628,
                  'YO2_min': 0.0,
                  'YO2_max': 0.23000027239322662,
                  'YH2O_mean': 0.0034810553111308457,
                  'YH2O_min': 7.078557990206438e-16,
                  'YH2O_max': 0.12122058123350143,
                  'YCH4_mean': 0.00019651665581952023,
                  'YCH4_min': -1.1150684325542115e-12,
                  'YCH4_max': 0.018443068489432335,
                  'YCO2_mean': 0.004251976026801597,
                  'YCO2_min': 8.646190453051941e-16,
                  'YCO2_max': 0.14806625247001648,
                  'YN2_mean': 0.768650326654315,
                  'YN2_min': 0.7122700810432434,
                  'YN2_max': 0.7700000405311584},
 'XiFoam': {'Ux_mean': 0.10888280851528975,
            'U_mag_mean': 0.31339734540671066,
            'U_mag_max': 10.854854587282954,
            'p_mean': 100450.82808593751,
            'p_min': 99551.734375,
            'p_max': 112502.8359375,
            'T_mean': 316.47909173965456,
            'T_min': 300.0631103515625,
            'T_max': 2121.40771484375,
            'b_mean': 0.9890857826804859,
            'b_min': 0.0,
            'b_max': 1.0,
            'Xi_mean': 1.0497202420979739,
            'Xi_min': 1.0,
            'Xi_max': 7.831552505493164},
 'PDRFoam': {'Ux_mean': 0.10888280851528975,
             'U_mag_mean': 0.31339734540671066,
             'U_mag_max': 10.854854587282954,
             'p_mean': 100450.82808593751,
             'p_min': 99551.734375,
             'p_max': 112502.8359375,
             'T_mean': 316.47909173965456,
             'T_min': 300.0631103515625,
             'T_max': 2121.40771484375,
             'b_mean': 0.9890857826804859,
             'b_min': 0.0,
             'b_max': 1.0,
             'Xi_mean': 1.0497202420979739,
             'Xi_min': 1.0,
             'Xi_max': 7.831552505493164},
 'fireFoam': {'Ux_mean': -4.931110887980523e-07,
              'U_mag_mean': 4.588298448524477,
              'U_mag_max': 73.98218276255756,
              'prgh_mean': 100189.07702604168,
              'prgh_min': 96764.828125,
              'prgh_max': 102682.421875,
              'T_mean': 331.0190065917969,
              'T_min': 294.2890319824219,
              'T_max': 1589.4100341796875,
              'YCH4_mean': 2.9595421415047715e-05,
              'YCH4_min': 0.0,
              'YCH4_max': 0.0015667594270780683,
              'YO2_mean': 0.23020660311977068,
              'YO2_min': 0.1435256153345108,
              'YO2_max': 0.23300106823444366,
              'YCO2_mean': 0.001917333605089151,
              'YCO2_min': 0.0,
              'YCO2_max': 0.06718143075704575,
              'YH2O_mean': 0.0015697032603509064,
              'YH2O_min': 0.0,
              'YH2O_max': 0.05500084161758423,
              'YN2_mean': 0.7662767723798751,
              'YN2_min': 0.7233057022094727,
              'YN2_max': 0.7669999003410339},
 'fireFoamPyrolysis': {'Ux_mean': -8.873624734742997e-05,
                       'U_mag_mean': 50.04861262847559,
                       'U_mag_max': 1924.2491008841025,
                       'prgh_mean': 102891.33414062501,
                       'prgh_min': 70241.0078125,
                       'prgh_max': 150734.671875,
                       'T_mean': 1084.4940402425132,
                       'T_min': 785.9558715820312,
                       'T_max': 10350.197265625,
                       'YCH4_mean': 0.0031460488186103464,
                       'YCH4_min': 0.0,
                       'YCH4_max': 0.3041715919971466,
                       'YO2_mean': 0.21658065068481178,
                       'YO2_min': 0.0,
                       'YO2_max': 0.23300069570541382,
                       'YCO2_mean': 0.01150556540121095,
                       'YCO2_min': 0.0,
                       'YCO2_max': 0.4604784846305847,
                       'YH2O_mean': 0.009419501259683386,
                       'YH2O_min': 0.0,
                       'YH2O_max': 0.3769894242286682,
                       'YN2_mean': 0.7593482375343641,
                       'YN2_min': 0.0,
                       'YN2_max': 0.7670002579689026},
 'hotCavity': {'Ux_mean': 0.006302635559602549,
               'U_mag_mean': 0.05197272208592334,
               'U_mag_max': 0.17169690766309786,
               'prgh_mean': 97742.12236816405,
               'prgh_min': 97742.0390625,
               'prgh_max': 97742.203125,
               'T_mean': 749.4498561859132,
               'T_min': 516.5631103515625,
               'T_max': 980.9027099609375},
 'hotCavityP1': {'Ux_mean': 0.005743639190214368,
                 'U_mag_mean': 0.035241412054968876,
                 'U_mag_max': 0.12074317524438939,
                 'prgh_mean': 98597.8049609375,
                 'prgh_min': 98597.7421875,
                 'prgh_max': 98597.9375,
                 'T_mean': 753.3713131332396,
                 'T_min': 518.473388671875,
                 'T_max': 976.7770385742188,
                 'G_mean': 118339.60258789062,
                 'G_min': 114597.8828125,
                 'G_max': 122136.0390625},
 'hotCavityShort': {'Ux_mean': 0.037577850165253036,
                    'U_mag_mean': 0.0380318053767583,
                    'U_mag_max': 0.08190911727238577,
                    'prgh_mean': 99634.20415039062,
                    'prgh_min': 99633.9296875,
                    'prgh_max': 99634.390625,
                    'T_mean': 749.7391594696045,
                    'T_min': 578.755615234375,
                    'T_max': 927.3758544921875},
 'hotCavityFvDOM': {'Ux_mean': 0.06461409060575533,
                    'U_mag_mean': 0.06518045279324182,
                    'U_mag_max': 0.13018742486766155,
                    'prgh_mean': 100602.01633789064,
                    'prgh_min': 100601.5390625,
                    'prgh_max': 100602.3984375,
                    'T_mean': 757.9795051193237,
                    'T_min': 576.2789916992188,
                    'T_max': 945.5418701171875,
                    'G_mean': 79255.04492675781,
                    'G_min': 37326.50390625,
                    'G_max': 158790.84375}}
SLICE15_SPREAD = {'chemFoam': {'T': 0.000732,
              'YO2': 3.77e-08,
              'YH2O': 3.59e-08,
              'YCH4': 3.05e-14,
              'YCO2': 4.39e-08,
              'YN2': 1.43e-08},
 'reactingFoam': {'Ux_mean': 1.47e-05,
                  'U_mag_mean': 8.49e-05,
                  'U_mag_max': 0.000397,
                  'p_mean': 0.0392,
                  'p_min': 0.0469,
                  'p_max': 0.0309,
                  'T_mean': 0.000291,
                  'T_min': 0.00775,
                  'T_max': 0.00177,
                  'YO2_mean': 1.36e-07,
                  'YO2_min': 1.24e-33,
                  'YO2_max': 2.72e-07,
                  'YH2O_mean': 7.19e-10,
                  'YH2O_min': 1.33e-20,
                  'YH2O_max': 2.71e-08,
                  'YCH4_mean': 7.57e-10,
                  'YCH4_min': 1.74e-15,
                  'YCH4_max': 1.33e-07,
                  'YCO2_mean': 9.67e-10,
                  'YCO2_min': 1.6e-20,
                  'YCO2_max': 8.94e-08,
                  'YN2_mean': 1.24e-07,
                  'YN2_min': 1.08e-07,
                  'YN2_max': 1.19e-07},
 'XiFoam': {'Ux_mean': 1.46e-05,
            'U_mag_mean': 9.22e-06,
            'U_mag_max': 0.00145,
            'p_mean': 0.107,
            'p_min': 0.125,
            'p_max': 2.02,
            'T_mean': 0.000509,
            'T_min': 0.000362,
            'T_max': 0.00354,
            'b_mean': 1e-07,
            'b_min': 0.0,
            'b_max': 0.0,
            'Xi_mean': 7.96e-07,
            'Xi_min': 0.0,
            'Xi_max': 2.29e-05},
 'PDRFoam': {'Ux_mean': 1.46e-05,
             'U_mag_mean': 9.22e-06,
             'U_mag_max': 0.00145,
             'p_mean': 0.107,
             'p_min': 0.125,
             'p_max': 2.02,
             'T_mean': 0.000509,
             'T_min': 0.000362,
             'T_max': 0.00354,
             'b_mean': 1e-07,
             'b_min': 0.0,
             'b_max': 0.0,
             'Xi_mean': 7.96e-07,
             'Xi_min': 0.0,
             'Xi_max': 2.29e-05},
 'fireFoam': {'Ux_mean': 5.64e-06,
              'U_mag_mean': 0.000141,
              'U_mag_max': 0.00797,
              'prgh_mean': 0.163,
              'prgh_min': 0.367,
              'prgh_max': 0.117,
              'T_mean': 0.0024,
              'T_min': 0.000275,
              'T_max': 0.0433,
              'YCH4_mean': 2.86e-09,
              'YCH4_min': 3.75e-93,
              'YCH4_max': 1.51e-07,
              'YO2_mean': 4.97e-07,
              'YO2_min': 4.19e-06,
              'YO2_max': 1.07e-06,
              'YCO2_mean': 1.1e-07,
              'YCO2_min': 6.51e-89,
              'YCO2_max': 3.4e-06,
              'YH2O_mean': 8.98e-08,
              'YH2O_min': 5.33e-89,
              'YH2O_max': 2.82e-06,
              'YN2_mean': 5.26e-07,
              'YN2_min': 3.22e-06,
              'YN2_max': 3.58e-07},
 'fireFoamPyrolysis': {'Ux_mean': 0.000826,
                       'U_mag_mean': 0.00335,
                       'U_mag_max': 0.624,
                       'prgh_mean': 1.07,
                       'prgh_min': 7.63,
                       'prgh_max': 16.7,
                       'T_mean': 0.0117,
                       'T_min': 0.0234,
                       'T_max': 3.31,
                       'YCH4_mean': 2.07e-05,
                       'YCH4_min': 1.08e-141,
                       'YCH4_max': 0.00167,
                       'YO2_mean': 3.73e-07,
                       'YO2_min': 0.0,
                       'YO2_max': 6.96e-07,
                       'YCO2_mean': 3.77e-06,
                       'YCO2_min': 1.98e-138,
                       'YCO2_max': 0.000171,
                       'YH2O_mean': 3.09e-06,
                       'YH2O_min': 1.62e-138,
                       'YH2O_max': 0.00014,
                       'YN2_mean': 1.35e-05,
                       'YN2_min': 0.0,
                       'YN2_max': 2.58e-07},
 'hotCavity': {'Ux_mean': 0.00336,
               'U_mag_mean': 0.0182,
               'U_mag_max': 0.0705,
               'prgh_mean': 857.0,
               'prgh_min': 857.0,
               'prgh_max': 857.0,
               'T_mean': 1.31,
               'T_min': 6.45,
               'T_max': 4.67},
 'hotCavityP1': {'Ux_mean': 0.00223,
                 'U_mag_mean': 0.00225,
                 'U_mag_max': 0.022,
                 'prgh_mean': 877.0,
                 'prgh_min': 877.0,
                 'prgh_max': 877.0,
                 'T_mean': 1.33,
                 'T_min': 1.79,
                 'T_max': 2.31,
                 'G_mean': 77.3,
                 'G_min': 75.1,
                 'G_max': 78.1},
 'hotCavityShort': {'Ux_mean': 0.000345,
                    'U_mag_mean': 0.000352,
                    'U_mag_max': 0.000452,
                    'prgh_mean': 3.63,
                    'prgh_min': 3.63,
                    'prgh_max': 3.63,
                    'T_mean': 0.0453,
                    'T_min': 0.162,
                    'T_max': 0.21},
 'hotCavityFvDOM': {'Ux_mean': 0.00112,
                    'U_mag_mean': 0.00113,
                    'U_mag_max': 0.00319,
                    'prgh_mean': 19.3,
                    'prgh_min': 19.3,
                    'prgh_max': 19.3,
                    'T_mean': 0.108,
                    'T_min': 0.154,
                    'T_max': 0.358,
                    'G_mean': 13.5,
                    'G_min': 9.87,
                    'G_max': 23.6}}


# counterFlowFlame2D refined 8x per side: the batched ODE at width, at the
# tutorial's Courant number (deltaT 1e-6 / 8: with the shipped deltaT the
# fuel inlet's first cells fall to the T floor of 1 K in the first step
# on the CPU)
REACT_BIG_BLOCKS = (320, 160)   # 51,200 cells
REACT_BIG_DT = 1e-6 / 8
REACT_BIG_STEPS = 3


def slice15_golden_arrays(name, final_state, host):
    """The fields of a run's final state as float64 numpy, named without
    underscores (small_golden_errs reads a key's field from its first
    word): U, p or p_rgh (prgh), T, G, b, Xi and one Y<species> per
    species; chemFoam's reactor T and Y<species> as one-cell arrays."""
    if name == "chemFoam":
        out = {"T": np.array([final_state["T"]])}
        out.update({f"Y{s}": np.array([y]) for s, y in zip(
            final_state["species"], final_state["Y"])})
        return out

    def f(x):
        return np.asarray(host(getattr(x, "data", x)), dtype=np.float64)

    out = {}
    for k, alias in (("U", "U"), ("p", "p"), ("p_rgh", "prgh"), ("T", "T"),
                     ("G", "G"), ("b", "b"), ("Xi", "Xi")):
        if k in final_state:
            out[alias] = f(final_state[k])
    return out


def slice15_species_arrays(case, final_state, host):
    """Y<species> per species of a run with a [n, nS] Y."""
    if "Y" not in final_state:
        return {}
    from foamtpu_torch.core.dictionary import parse_file

    species = [str(s) for s in parse_file(
        case.const_path("reactions"))["species"]]
    Y = np.asarray(host(final_state["Y"].data), dtype=np.float64)
    return {f"Y{s}": Y[:, i] for i, s in enumerate(species)}


def slice15_scalars(name, case, final_state, host):
    """The golden scalars of a run (small_scalars of its arrays)."""
    a = slice15_golden_arrays(name, final_state, host)
    if name == "chemFoam":
        return {k: float(x[0]) for k, x in a.items()}, a
    a.update(slice15_species_arrays(case, final_state, host))
    v = np.asarray(host(case.mesh.v), dtype=np.float64)
    return small_scalars(a, v), a


def adiabatic_flame_T(chem, W, cp, T0=300.0):
    """The stoichiometric methane-air adiabatic flame temperature of a
    mechanism's thermo: complete combustion of CH4 + 2 O2 (+ the N2 of air,
    0.767/0.233 by mass) releasing -sum hf dn at constant Cp `cp` (the
    case's 1100 J/kg/K puts it at ~2,810 K, real Cp at ~2,226 K)."""
    sp = list(chem.species)
    W = np.asarray(W, dtype=np.float64)
    hf = chem.hf.double().cpu().numpy()
    n0 = np.zeros(len(sp))
    n0[sp.index("CH4")], n0[sp.index("O2")] = 1.0, 2.0
    n0[sp.index("N2")] = 2.0 * (0.767 / W[sp.index("N2")]) / (
        0.233 / W[sp.index("O2")])
    n1 = n0.copy()
    n1[sp.index("CH4")] = n1[sp.index("O2")] = 0.0
    n1[sp.index("CO2")], n1[sp.index("H2O")] = 1.0, 2.0
    q = -(hf * (n1 - n0)).sum() / (n0 * W).sum()      # J/kg of mixture
    return T0 + q / cp


def fire_oracles(case, st, steps):
    """tests/test_firefoam.py's oracles of the pool fire: finite T and U,
    ignition (T max above 700 K), the plume rising (mean Uy above 0.05 m/s
    at |x| < 0.1, 0.3 < y < 0.7), Y in [0, 1] summing to 1 at 1e-3, CO2
    produced."""
    T = st["T"].data.double().cpu().numpy()
    U = st["U"].data.double().cpu().numpy()
    Y = st["Y"].data.double().cpu().numpy()
    cc = case.mesh.c.double().cpu().numpy()
    plume = (np.abs(cc[:, 0]) < 0.1) & (cc[:, 1] > 0.3) & (cc[:, 1] < 0.7)
    return {"finite": bool(np.isfinite(T).all() and np.isfinite(U).all()),
            "ignites (T max > 700 K)": float(T.max()) > 700.0,
            "plume rises": float(U[plume, 1].mean()) > 0.05,
            "Y in [0, 1]": float(Y.min()) >= -1e-6
            and float(Y.max()) <= 1.0 + 1e-6,
            "sum Y = 1": float(np.abs(Y.sum(axis=1) - 1.0).max()) < 1e-3,
            "CO2 produced": float(Y[:, 2].max()) > 1e-3}


def pyrolysis_oracles(case, st):
    """tests/test_firefoam.py::test_pyrolysis_region_feeds_the_fire: the
    solid loses mass, fuel gas leaves it and shows in the gas by the base,
    T finite."""
    Y = st["Y"].data.double().cpu().numpy()
    cc = case.mesh.c.double().cpu().numpy()
    near = cc[:, 1] < 0.05
    return {"solid loses mass": float(st["pyro"]["rho_s"].min())
            < 500.0 - 1e-3,
            "fuel gas released": float(st["pyro_m_gas"].max()) > 0.0,
            "fuel in the gas by the base": float(Y[near, 0].max()) > 1e-5,
            "finite": bool(torch.isfinite(st["T"].data).all()),
            "film finite": bool(torch.isfinite(st["film"]["delta"]).all())}


def xi_oracles(a0, st, v, R):
    """tests/test_combustion_models.py::test_xifoam_flame_propagates:
    finite b and T, the burnt volume grows, 400 K < T max < 300 + qComb/
    1100 + 300, the mass held to 2%."""
    b = st["b"].data.double().cpu().numpy()
    T = st["T"].data.double().cpu().numpy()
    p = st["p"].data.double().cpu().numpy()
    rho = p / (R * T)
    burnt0 = float(((1.0 - a0["b"]) * v).sum())
    burnt = float(((1.0 - b) * v).sum())
    mass0 = float((a0["p"] / (R * a0["T"]) * v).sum())
    return {"finite": bool(np.isfinite(b).all() and np.isfinite(T).all()),
            "flame grows": burnt > burnt0,
            "T max in (400, 300 + qComb/1100 + 300)": 400.0 < float(T.max())
            < 300.0 + 1.8e6 / 1100.0 + 300.0,
            "mass within 2%": abs(float((rho * v).sum()) - mass0)
            / mass0 < 0.02}


def chem_oracles(st, y0):
    """The reactor burns: the fuel (CH4) goes, T rises by more than 1000 K,
    sum(Y) = 1 at 1e-3 (tests/test_chemistry.py::
    test_chemfoam_adiabatic_reactor's form)."""
    sp = list(st["species"])
    Y = np.asarray(st["Y"], dtype=np.float64)
    i = sp.index("CH4")
    return {"fuel consumed": Y[i] < 0.25 * y0[i],
            "T rises": st["T"] > 1500.0 + 1000.0,
            "sum Y = 1": abs(Y.sum() - 1.0) < 1e-3,
            "finite": bool(np.isfinite(Y).all() and np.isfinite(st["T"]))}


def reacting_oracles(st):
    """counterFlowFlame2D: finite, Y in [0, 1] summing to 1, T between the
    inlets' 293 K and the methane-air flame, CO2 produced."""
    T = st["T"].data.double().cpu().numpy()
    Y = st["Y"].data.double().cpu().numpy()
    return {"finite": bool(np.isfinite(T).all() and np.isfinite(Y).all()),
            "Y in [0, 1]": float(Y.min()) >= -1e-6
            and float(Y.max()) <= 1.0 + 1e-6,
            "sum Y = 1": float(np.abs(Y.sum(axis=1) - 1.0).max()) < 1e-3,
            "T in (250, 3500)": 250.0 < float(T.min())
            and float(T.max()) < 3500.0,
            "CO2 produced": float(Y[:, 3].max()) > 1e-4}


def radiation_oracles(st, t_mean_dark):
    """tests/test_radiation.py::test_buoyant_with_radiation_couples: G in
    [0, 4 sigma Tmax^4], the gas heated beyond the run without radiation
    over the same steps, T within 0.95 of the cold wall's 500 K and 1.05
    of the hot wall's 1000 K (slice15_case's `hot`)."""
    from foamtpu_torch.models.radiation import SIGMA

    G = st["G"].data.double().cpu().numpy()
    T = st["T"].data.double().cpu().numpy()
    return {"finite": bool(np.isfinite(G).all() and np.isfinite(T).all()),
            "G in [0, 4 sigma Tmax^4]": float(G.min()) >= 0.0
            and float(G.max()) <= 4.0 * SIGMA * float(T.max()) ** 4,
            "heated beyond the dark run": float(T.mean()) > t_mean_dark,
            "T within the walls' bounds": float(T.max()) < 1.05 * 1000.0
            and float(T.min()) > 0.95 * 500.0}


def ode_record(stats, steps):
    """The batched ODE's counters per chemistry call and per step."""
    calls = max(stats["calls"], 1)
    return {"calls": stats["calls"],
            "attempts_per_lane_mean": stats["lane_attempts"]
            / max(stats["lanes"], 1),
            "attempts_max": stats["max_passes"],
            "host_syncs": stats["syncs"],
            "host_syncs_per_call": stats["syncs"] / calls,
            "host_syncs_per_step": stats["syncs"] / max(steps, 1)}


def react_big(spmv, here, root):
    """reactingFoam on counterFlowFlame2D at REACT_BIG_BLOCKS through
    run(case), REACT_BIG_STEPS steps of REACT_BIG_DT: per step the ODE's
    attempts per lane
    (mean, most), its host reads, the SpMV launches and s/step; held to
    reacting_oracles."""
    from foamtpu_torch import ode
    from foamtpu_torch.apps.cli import main as cli
    from foamtpu_torch.core.case import Case

    t0 = time.perf_counter()
    dst = slice15_case(here, os.path.join(root, "combustion", "react_big"),
                       "reactingFoam", cli, blocks=REACT_BIG_BLOCKS,
                       delta_t=REACT_BIG_DT)
    case = Case(dst, device="cuda")
    n = case.mesh.n_cells
    setup_s = time.perf_counter() - t0
    ode.reset_stats()
    run_s, text, launches, fb = app_run(spmv, case, REACT_BIG_STEPS)
    stats = dict(ode.STATS)
    steps = case.time.index
    rec = {"n_cells": n, "steps": steps, "setup_s": setup_s, "run_s": run_s,
           "sec_per_step": run_s / max(steps, 1),
           "spmv_launches": launches, "spmv_launches_per_step":
               launches / max(steps, 1),
           "ode": ode_record(stats, steps),
           "T_range": [float(case.final_state["T"].data.min()),
                       float(case.final_state["T"].data.max())],
           "iterations_max": {k: max(x) for k, x in
                              solve_iterations(text).items()}}
    checks = reacting_oracles(case.final_state)
    checks.update({"steps": steps == REACT_BIG_STEPS,
                   "one ODE call a step": stats["calls"] == steps,
                   "spmv launched": launches > 0})
    progress("combustion", f"counterFlowFlame2D {n} cells: {rec}")
    return rec, checks, launches, fb


class PickLog(SolveLog):
    """A SolveLog that names each solve by `pick(mat)`, "other" where it
    returns None (its first matrix per name kept)."""

    def __init__(self, pick):
        self.pick, self.fence, self.ranges = pick, False, False
        self.calls = collections.defaultdict(int)
        self.seconds = collections.defaultdict(float)
        self.iterations = collections.defaultdict(list)
        self.matrices = {}

    def _name(self, mat):
        return self.pick(mat) or "other"


def _mass_flow_matrix(mat):
    """Whether an equation's source is in kg/s: the compressible pressure
    equation (symmetric) and the mass-weighted transport of a
    dimensionless field (Y, b; convection makes it non-symmetric)."""
    from foamtpu_torch.core.dimensions import DimensionSet

    return mat.dims == DimensionSet.of(1, 0, -1)


# the operands the combustion phase keeps from a run as shipped, for the
# SpMV's check and timing: reactingFoam's pressure matrix and XiFoam's b
SLICE15_OPERANDS = {
    "reactingFoam": lambda m: "p" if _mass_flow_matrix(m) and m.symmetric
    else None,
    "XiFoam": lambda m: "b" if _mass_flow_matrix(m) and not m.symmetric
    and m.source.ndim == 1 else None,
}


def phase_combustion(spmv, here, root, flush):
    """The combustion family's tutorials and radiation through run(case) on
    the card (SLICE15_RUNS, float32): chemFoam h2, reactingFoam
    counterFlowFlame2D, XiFoam moriyoshiHomogeneous and PDRFoam
    flamePropagation after setFields, fireFoam smallPoolFire2D and its
    pyrolysis case, buoyantPimpleFoam hotCavity dark and with P1, dark
    and with fvDOM at THICK_DT; each held to goldens from the JAX package
    (SLICE15_GOLDEN at small_golden_errs) and to the reference tests'
    oracles; counterFlowFlame2D at 51,200 cells (react_big); the SpMV held
    to its plain version and timed at an fvDOM ray's operand
    (non-symmetric upwind), at the species' Y [n, 5], at reactingFoam's p
    and at XiFoam's b."""
    from foamtpu_torch import ode
    from foamtpu_torch.apps.cli import main as cli
    from foamtpu_torch.core.case import Case

    results, checks, logs = {}, {}, {}
    launches_total = fb_total = 0
    dark_T = {}      # the dark hotCavity runs' mean T by their deltaT
    for name, (tut, opts, steps) in SLICE15_RUNS.items():
        dst = slice15_case(here, os.path.join(root, "combustion", name), tut,
                           cli, device=("-device", "cuda"), **opts)
        case = Case(dst, device="cuda")
        a0 = None
        if tut in ("XiFoam", "PDRFoam"):
            a0 = {k: case.read_field(k).data.double().cpu().numpy()
                  for k in ("b", "p", "T")}
        ode.reset_stats()
        # (smallPoolFire2D as shipped has no radiation: no G solve)
        with (StepLog(FIRE_CYCLE[:1] + FIRE_CYCLE[2:]) if name == "fireFoam"
              else PickLog(SLICE15_OPERANDS[name])
              if name in SLICE15_OPERANDS
              else contextlib.nullcontext()) as log:
            run_s, text, launches, fb = app_run(spmv, case, steps)
        logs[name] = (case, log)
        launches_total += launches
        fb_total += fb
        st = case.final_state
        n_steps = case.time.index
        got, a = slice15_scalars(name, case, st,
                                 lambda t: t.double().cpu().numpy()
                                 if isinstance(t, torch.Tensor) else t)
        rec = {"tutorial": "/".join(SLICE15_TUTORIALS[tut][1:])
               if tut in SLICE15_TUTORIALS else "buoyantPimpleFoam/hotCavity",
               "options": opts, "steps": n_steps, "run_s": run_s,
               "sec_per_step": run_s / max(n_steps, 1), "scalars": got,
               "iterations_max": {k: max(x) for k, x in
                                  solve_iterations(text).items()},
               "spmv_launches": launches, "spmv_fb_launches": fb,
               "ode": ode_record(dict(ode.STATS), n_steps)}
        if name == "chemFoam":
            from foamtpu_torch.core.dictionary import parse_file

            ic = parse_file(case.const_path("initialConditions"))
            y0 = np.array([float(ic["fractions"].get(s, 0.0))
                           for s in st["species"]])
            y0 = y0 / y0.sum()
            ck = chem_oracles(st, y0)
        elif tut == "reactingFoam":
            ck = reacting_oracles(st)
        elif tut in ("XiFoam", "PDRFoam"):
            from foamtpu_torch.solvers.apps import _thermo

            ck = xi_oracles(a0, st, case.mesh.v.double().cpu().numpy(),
                            _thermo(case).R)
        elif name == "fireFoam":
            ck = fire_oracles(case, st, n_steps)
        elif name == "fireFoamPyrolysis":
            ck = pyrolysis_oracles(case, st)
        elif "radiation" not in opts:
            dark_T[opts.get("delta_t")] = float(st["T"].data.double().mean())
            ck = {"finite": bool(torch.isfinite(st["T"].data).all())}
        else:
            ck = radiation_oracles(st, dark_T[opts.get("delta_t")])
        ck["steps"] = n_steps == (steps or n_steps)
        if name != "chemFoam":
            ck["spmv launched"] = launches > 0
        gold = SLICE15_GOLDEN.get(name)
        if gold is not None:
            scales = field_scales(a)
            errs = small_golden_errs(got, gold, SLICE15_SPREAD[name], scales)
            rec["golden_err_tol"] = errs
            ck.update({f"golden {k}": e <= t for k, (e, t) in errs.items()})
        else:
            ck["goldens present"] = False
        results[name] = rec
        checks.update({f"{name} {k}": x for k, x in ck.items()})
        progress("combustion", f"{name}: {run_s:.1f} s, {n_steps} steps, "
                 f"{launches} SpMV launches, ODE {rec['ode']}")
    big, ck, launches, fb = react_big(spmv, here, root)
    results["reactingFoam_51200"] = big
    checks.update({f"reactingFoam_51200 {k}": x for k, x in ck.items()})
    launches_total += launches
    fb_total += fb

    # the SpMV at an fvDOM ray's operand, at the species' [n, 5], at
    # reactingFoam's p and at XiFoam's b
    cases, max_err, timings = [], 0.0, []
    ops = []
    case, _ = logs["hotCavityFvDOM"]
    mesh = case.mesh
    from foamtpu_torch.models import radiation as rad_mod

    with StepLog(("ray",)) as cap:
        rad_mod.solve_fvdom(mesh, case.final_state["G"],
                            case.final_state["T"].data,
                            rad_mod.FvDOMConfig(n_theta=1, n_phi=1),
                            T_bcs=case.final_state["T"].bcs)
    ray = cap.matrices["ray"]
    ops.append((mesh, mat_operand(mesh, ray, "hotCavity_fvDOM_ray"), ray))
    for run, kind, shape in (("fireFoam", "Y", "smallPoolFire2D_Y5"),
                             ("reactingFoam", "p", "counterFlowFlame2D_p"),
                             ("XiFoam", "b", "moriyoshiHomogeneous_b")):
        case, log = logs[run]
        mat = log.matrices[kind]
        ops.append((case.mesh, mat_operand(case.mesh, mat, shape), mat))
    for mesh, op, mat in ops:
        deltas = tuple(mesh.st_deltas)
        for dtype in (torch.float32, torch.float64):
            err = check_operands(spmv, [op], mesh, deltas, dtype,
                                 np.random.default_rng(151), cases)
            if dtype == torch.float32:
                max_err = max(max_err, err)
        name, soff, diag, sfb = op
        timings += time_shape(spmv, name, diag.contiguous(),
                              operand_x(diag, 152), soff.contiguous(), deltas,
                              flush)
        if name.endswith("_p"):
            checks[f"{name} symmetric"] = mat.symmetric
        else:
            checks[f"{name} non-symmetric"] = not mat.symmetric
    checks["Y operand is [n, 5]"] = tuple(ops[1][1][2].shape[1:]) == (5,)
    out = {"phase": "combustion", "dtype": "torch.float32",
           "runs": results, "kernel_cases": cases, "max_abs_err_f32": max_err,
           "timings": timings, "spmv_launches_total": launches_total,
           "spmv_fb_launches_total": fb_total, "checks": checks}
    emit(out)
    for name, ok in checks.items():
        check(ok, f"combustion check {name}: {out}")
    return out, max_err, timings


def fire_big_oracles(case, st, cont, t_ad):
    """The headline's oracles: every field finite; T between 290 K and
    1.1 times the mechanism's adiabatic flame temperature off the 10 x 10
    cells at each of the base's corners (the fuel inlet against the
    sides' entrainment: there T swings between steps in both packages and
    is held finite only); Y in [0, 1] summing to 1 at 1e-3; G in
    [0, 4 sigma Tmax^4]; CO2 produced; the continuity error of every step
    below 1e-3."""
    from foamtpu_torch.models.radiation import SIGMA

    T = st["T"].data.double().cpu().numpy()
    Y = st["Y"].data.double().cpu().numpy()
    G = st["G"].data.double().cpu().numpy()
    cc = case.mesh.c.double().cpu().numpy()
    dx = 0.6 * FIRE_HEAD_SCALE / FIRE_HEAD_BLOCKS[0]
    dy = 1.0 * FIRE_HEAD_SCALE / FIRE_HEAD_BLOCKS[1]
    corner = ((0.3 * FIRE_HEAD_SCALE - np.abs(cc[:, 0]) < 10 * dx)
              & (cc[:, 1] < 10 * dy))
    fields = [st["U"].data, st["T"].data, st["p_rgh"].data, st["Y"].data,
              st["G"].data] + [f.data for f in st["turb"].values()]
    Ti = T[~corner]
    return {"finite": all(bool(torch.isfinite(f).all()) for f in fields),
            "T in [290, 1.1 T_ad] off the base corners": float(Ti.min())
            >= 290.0 and float(Ti.max()) <= 1.1 * t_ad,
            "Y in [0, 1]": float(Y.min()) >= -1e-6
            and float(Y.max()) <= 1.0 + 1e-6,
            "sum Y = 1": float(np.abs(Y.sum(axis=1) - 1.0).max()) < 1e-3,
            "G in [0, 4 sigma Tmax^4]": float(G.min()) >= 0.0
            and float(G.max()) <= 4.0 * SIGMA * float(T.max()) ** 4,
            "CO2 produced": float(Y[:, 2].max()) > 1e-3,
            "continuity of every step < 1e-3": max(cont) < 1e-3,
            "200 corner cells": int(corner.sum()) == 200}, {
                "T_min_off_corners": float(Ti.min()),
                "T_max_off_corners": float(Ti.max()),
                "T_range": [float(T.min()), float(T.max())],
                "T_corner_range": [float(T[corner].min()),
                                   float(T[corner].max())],
                "G_range": [float(G.min()), float(G.max())],
                "CO2_max": float(Y[:, 2].max())}


def phase_fire_headline(spmv, here, root, flush):
    """fireFoam on smallPoolFire2D scaled by FIRE_HEAD_SCALE (12 m x 20 m)
    at FIRE_HEAD_BLOCKS (600,000 cells of 20 mm) with P1 radiation, meshed
    in the background process, the tutorial's BCs, schemes and
    infinitelyFastChemistry, p_rgh by the shipped PCG with maxIter
    FIRE_HEAD_P_MAXITER, deltaT FIRE_HEAD_DT fixed: set-up split into
    blockMesh, to_device and the config; FIRE_HEAD_WARMUP steps, FIRE_HEAD_TRIALS timed chunks of
    FIRE_HEAD_CHUNK steps with every solve's iterations (p_rgh's PCG, G's
    PCG, Y's BiCGStab) and each step's continuity, the SpMV kernel held to
    its plain version and timed at p_rgh [n], G [n] and Y [n, 5], one
    profiled step last; held to fire_big_oracles."""
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.solvers import apps, firefoam

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dst = fire_big_case(here, os.path.join(root, "fire_big"))
    case = Case(dst, device="cuda")
    got = premeshed(dict_key(blockmesh_dict(dst)))
    if got:
        case._poly, mesh_secs = got
    else:
        memory_mesh(case)
        mesh_secs = {}
    t2 = time.perf_counter()
    mesh = case.mesh
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    n = FIRE_HEAD_BLOCKS[0] * FIRE_HEAD_BLOCKS[1]
    check(mesh.n_cells == n, mesh.n_cells)
    cfg, Y, _, tstate = apps.fire_config(case)
    state = apps.fire_state(case, cfg, Y, tstate)
    step = firefoam.make_step(mesh, cfg)
    t_ad = adiabatic_flame_T(cfg.chem, cfg.W, cfg.flow.thermo.Cp)
    torch.cuda.synchronize()
    setup = dict(mesh_secs, to_device_s=t3 - t2,
                 config_state_s=time.perf_counter() - t3,
                 setup_s=time.perf_counter() - t0)
    progress("fire_headline", f"set-up {setup}, {n} cells")
    dt = torch.tensor(FIRE_HEAD_DT, dtype=mesh.v.dtype, device=mesh.device)
    cont = []

    def chunk_of(k):
        def chunk(st):
            diag = None
            for _ in range(k):
                st, diag = step(st, dt)
                cont.append(float(diag["continuity"]) * FIRE_HEAD_DT)
            return st, diag
        return chunk

    # the main path's SpMV launches: the steps' (warm-up, timed, profiled),
    # not those of the kernel's checks and timings between them
    spmv.LAUNCHES = spmv.FB_LAUNCHES = 0
    t0 = time.perf_counter()
    state, diag = chunk_of(FIRE_HEAD_WARMUP)(state)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    secs, courant = [], []
    l_timed = spmv.LAUNCHES
    with StepLog(FIRE_CYCLE) as log:
        for _ in range(FIRE_HEAD_TRIALS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, diag = chunk_of(FIRE_HEAD_CHUNK)(state)
            torch.cuda.synchronize()
            secs.append((time.perf_counter() - t0) / FIRE_HEAD_CHUNK)
            courant.append(float(diag["courant_max"]))
            progress("fire_headline", f"chunk {secs[-1]:.3f} s/step, "
                     f"Courant {courant[-1]:.3g}, continuity {cont[-3:]}, "
                     f"iterations "
                     f"{ {k: v[-3:] for k, v in log.iterations.items()} }")
    sec = statistics.median(secs)
    timed_steps = FIRE_HEAD_TRIALS * FIRE_HEAD_CHUNK
    per_step = (spmv.LAUNCHES - l_timed) / timed_steps
    main_launches, main_fb = spmv.LAUNCHES, spmv.FB_LAUNCHES
    cases, max_err, timings = [], 0.0, []
    deltas = tuple(mesh.st_deltas)
    for kind, prefix in (("p", "fire_p_rgh"), ("G", "fire_G"),
                         ("Y", "fire_Y5")):
        op = mat_operand(mesh, log.matrices[kind], prefix)
        for dtype in (torch.float32, torch.float64):
            err = check_operands(spmv, [op], mesh, deltas, dtype,
                                 np.random.default_rng(153), cases)
            if dtype == torch.float32:
                max_err = max(max_err, err)
        _, soff, dg, sfb = op
        timings += time_shape(spmv, prefix, dg.contiguous(),
                              operand_x(dg, 154), soff.contiguous(), deltas,
                              flush)
    l_prof, f_prof = spmv.LAUNCHES, spmv.FB_LAUNCHES
    state, prof = profile_chunk(spmv, "fire_headline_profile", mesh,
                                chunk_of(FIRE_HEAD_PROFILE), state,
                                FIRE_HEAD_PROFILE, sec,
                                log=StepLog(FIRE_CYCLE, ranges=True))
    launches = main_launches + spmv.LAUNCHES - l_prof
    fb_launches = main_fb + spmv.FB_LAUNCHES - f_prof
    its = {k: [int(i) for i in v] for k, v in log.iterations.items()}
    checks, extremes = fire_big_oracles(case, state, cont, t_ad)
    out = {"phase": "fire_headline",
           "case": "fireFoam smallPoolFire2D, block ({} {} 1), deltaT {}, "
                   "P1 radiation (a = e = 0.5): the tutorial's BCs, schemes "
                   "and combustion, p_rgh by the shipped polynomial PCG with "
                   "maxIter {}".format(*FIRE_HEAD_BLOCKS, FIRE_HEAD_DT,
                                       FIRE_HEAD_P_MAXITER),
           "n_cells": n, "dtype": str(mesh.v.dtype), **setup,
           "warmup_s": warm_s, "sec_per_step": sec,
           "sec_per_step_trials": secs, "m_cells_per_sec": n / sec / 1e6,
           "courant_max_per_chunk": courant,
           "continuity_per_step": cont,
           "iterations": its,
           "iterations_per_solve": {k: statistics.mean(v)
                                    for k, v in its.items() if v},
           "iterations_max": {k: max(v) for k, v in its.items() if v},
           "T_adiabatic": t_ad, **extremes,
           "spmv_launches_per_step": per_step,
           "cuda_launch_kernel_per_step": prof["cuda_launch_kernel_per_iter"],
           "device_ms_per_step": prof["device_ms_per_iter"],
           "device_busy_share": prof["device_busy_share_unprofiled"],
           "spmv_device_ms_per_step": prof["spmv_device_ms_per_iter"],
           "spmv_launches_per_step_profiled": prof["spmv_launches_per_iter"],
           "top_kernels_ms_per_step": prof["top_kernels_ms_per_iter"][:8],
           "spmv_launches_total": launches,
           "spmv_fb_launches_total": fb_launches,
           "kernel_cases": cases, "max_abs_err_f32": max_err,
           "timings": timings,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    checks.update({"spmv launched": launches > 0,
                   "p_rgh below its cap": max(its["p"]) < FIRE_HEAD_P_MAXITER,
                   "G below its cap": max(its["G"]) < 2000,
                   "Y operand is [n, 5]": tuple(
                       log.matrices["Y"].diag_eff(mesh).shape[1:]) == (5,)})
    out["checks"] = checks
    emit(out)
    for name, ok in checks.items():
        check(ok, f"fire_headline check {name}: {out}")
    return out, max_err, timings


def slice15_arrays(final_state, host):
    """The combustion family's state beyond U, p, p_rgh, T and phi: G, Y,
    b, Xi, and the region states."""
    out = {}
    for n in ("G", "Y", "b", "Xi", "pyro_m_gas"):
        if n in final_state:
            out[n] = host(getattr(final_state[n], "data", final_state[n]))
    for reg in ("pyro", "film"):
        for k, v in (final_state.get(reg) or {}).items():
            out[f"{reg}_{k}"] = host(v)
    return out


# ---------------------------------------------------------------------------
# slice 16: the case-directory entry and topology-changing meshes
# ---------------------------------------------------------------------------

SLICE16_TUTORIALS = {
    "attachDuct": os.path.join("tutorials", "incompressible",
                               "pimpleDyMFoam", "attachDuct"),
    "damBreakWithObstacle": os.path.join("tutorials", "multiphase",
                                         "interDyMFoam",
                                         "damBreakWithObstacle"),
    "movingStep": os.path.join("tutorials", "compressible", "sonicDyMFoam",
                               "movingStep"),
    "compression": os.path.join("tutorials", "combustion", "coldEngineFoam",
                                "compression"),
    "layeredCylinder": os.path.join("tutorials", "combustion",
                                    "coldEngineFoam", "layeredCylinder"),
    "firingCylinder": os.path.join("tutorials", "combustion", "engineFoam",
                                   "firingCylinder"),
}
# firingCylinder's spark as the runs take it: the reference reads the
# ignition's `start` (the tutorial writes `ignitionStart`, which neither
# package reads) and burns the cells within diameter/2 of `location` (the
# tutorial's (0 0 0.06) lies outside its 5 mm thick mesh): the tutorial's
# 3 mm spark on the centre of the cylinder's cell (4, 12), lit 2 CAD
# after the start
FIRING_IGNITION = """ignition
{
    start           -178;
    ignitionStart   -178;
    location        (0.028125 0.0520833 0.0025);
    diameter        0.003;
}
"""
# tests/test_engine.py's ignition case's flame (the tutorial's Su 0.43 and
# qComb 2.5e6 blow up 5 steps after the spark in both packages, ROADMAP
# Queue 3)
FIRING_FLAME = (("Su", "Su [0 1 -1 0 0 0 0] 0.15"),
                ("qComb", "qComb [0 2 -2 0 0 0 0] 2e5"),
                ("Tu", "Tu [0 0 0 1 0 0 0] 300"))
# the floating body of tests/test_floating.py::test_pimpledym_sixdof_case
FLOAT_TANK = """
convertToMeters 1;
vertices
(
    (0 0 0)     (0.4 0 0)   (0.6 0 0)   (1 0 0)
    (0 0.4 0)   (0.4 0.4 0) (0.6 0.4 0) (1 0.4 0)
    (0 0.6 0)   (0.4 0.6 0) (0.6 0.6 0) (1 0.6 0)
    (0 1 0)     (0.4 1 0)   (0.6 1 0)   (1 1 0)
    (0 0 0.05)     (0.4 0 0.05)   (0.6 0 0.05)   (1 0 0.05)
    (0 0.4 0.05)   (0.4 0.4 0.05) (0.6 0.4 0.05) (1 0.4 0.05)
    (0 0.6 0.05)   (0.4 0.6 0.05) (0.6 0.6 0.05) (1 0.6 0.05)
    (0 1 0.05)     (0.4 1 0.05)   (0.6 1 0.05)   (1 1 0.05)
);
blocks
(
    hex (0 1 5 4 16 17 21 20) (6 6 1) simpleGrading (1 1 1)
    hex (1 2 6 5 17 18 22 21) (4 6 1) simpleGrading (1 1 1)
    hex (2 3 7 6 18 19 23 22) (6 6 1) simpleGrading (1 1 1)
    hex (4 5 9 8 20 21 25 24) (6 4 1) simpleGrading (1 1 1)
    hex (6 7 11 10 22 23 27 26) (6 4 1) simpleGrading (1 1 1)
    hex (8 9 13 12 24 25 29 28) (6 6 1) simpleGrading (1 1 1)
    hex (9 10 14 13 25 26 30 29) (4 6 1) simpleGrading (1 1 1)
    hex (10 11 15 14 26 27 31 30) (6 6 1) simpleGrading (1 1 1)
);
boundary
(
    body { type wall; faces ((5 6 22 21) (9 5 21 25)
                             (6 10 26 22) (10 9 25 26)); }
    walls { type wall; faces ((0 1 17 16) (1 2 18 17) (2 3 19 18)
                              (0 16 20 4) (4 20 24 8) (8 24 28 12)
                              (3 7 23 19) (7 11 27 23) (11 15 31 27)
                              (12 28 29 13) (13 29 30 14)
                              (14 30 31 15)); }
    frontAndBack { type empty; faces (
        (0 4 5 1) (1 5 6 2) (2 6 7 3) (4 8 9 5) (6 10 11 7)
        (8 12 13 9) (9 13 14 10) (10 14 15 11)
        (16 17 21 20) (17 18 22 21) (18 19 23 22) (20 21 25 24)
        (22 23 27 26) (24 25 29 28) (25 26 30 29) (26 27 31 30)); }
);
"""
FLOAT_FILES = {
    "system/controlDict": """
application     pimpleDyMFoam;
startFrom       startTime;
startTime       0;
stopAt          endTime;
endTime         0.05;
deltaT          0.01;
writeControl    timeStep;
writeInterval   100;
writeFormat     ascii;
""",
    "system/fvSchemes": """
ddtSchemes { default Euler; }
gradSchemes { default Gauss linear; }
divSchemes { default none; div(phi,U) Gauss linear; }
laplacianSchemes { default Gauss linear corrected; }
interpolationSchemes { default linear; }
snGradSchemes { default corrected; }
""",
    "system/fvSolution": """
solvers
{
    p { solver PCG; preconditioner polynomial; tolerance 1e-7; relTol 0.01; }
    U { solver PBiCGStab; tolerance 1e-6; relTol 0.1; maxIter 200; }
}
PIMPLE { nCorrectors 2; }
""",
    "constant/transportProperties": "nu nu [0 2 -1 0 0 0 0] 1e-3;\n",
    "constant/dynamicMeshDict": """
motionSolver sixDoFRigidBodyMotion;
sixDoFRigidBodyMotionCoeffs
{
    patch body;
    mass 5.0;
    momentOfInertia (0.1 0.1 0.1);
    centreOfMass (0.5 0.5 0.025);
    innerDistance 0.18;
    outerDistance 0.38;
    rhoInf 1000;
    restraints
    {
        spring
        {
            sixDoFRigidBodyMotionRestraint linearSpring;
            anchor (0.5 0.5 0.025);
            refAttachmentPt (0 0 0);
            stiffness 400;
            damping 5;
            restLength 0;
        }
    }
}
""",
    "0/U": """
dimensions [0 1 -1 0 0 0 0];
internalField uniform (0 0 0);
boundaryField
{
    body { type fixedValue; value uniform (0 0 0); }
    walls { type fixedValue; value uniform (0 0 0); }
    frontAndBack { type empty; }
}
""",
    "0/p": """
dimensions [0 2 -2 0 0 0 0];
internalField uniform 0;
boundaryField
{
    body { type zeroGradient; }
    walls { type zeroGradient; }
    frontAndBack { type empty; }
}
"""}


def floating_case(dst, cli):
    """The floating body of tests/test_floating.py's case (pimpleDyMFoam
    with sixDoFRigidBodyMotion, a spring-held square body in a 1 m tank)
    written and meshed at dst."""
    classes = {"0/U": "volVectorField", "0/p": "volScalarField"}
    for rel, body in dict(FLOAT_FILES, **{
            "constant/polyMesh/blockMeshDict": FLOAT_TANK}).items():
        path = os.path.join(dst, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(_foam_header(classes.get(rel, "dictionary"),
                                 os.path.basename(rel)) + body)
    with contextlib.redirect_stdout(io.StringIO()):
        check(cli(["blockMesh", "-case", dst]) == 0, "blockMesh failed")
    return dst


ENGINE_CASES = ("compression", "layeredCylinder", "firingCylinder")
SLICE16_SEED = 16
# attachDuct's p converged for the parity runs: stopped by relTol 0.01,
# its PCG turns a 1e-15 difference of the source into 1e-6 of p in f64;
# at 1e-8, 1e-10, 1e-11 and 1e-12 one or two of its 24 PCG counts differ
# by one between the packages (the residual crosses the tolerance within
# the runs' 1e-11 difference), at 1e-9 none
ATTACH_TIGHT_P = ("solver PCG; preconditioner polynomial; tolerance 1e-9; "
                  "relTol 0; maxIter 2000;")
# movingStep's pressure scaled by 1e5: the same Mach-3 flow (c depends on
# T alone) above the engine step's p_min of 1000 Pa, which clamps the
# shipped p = 1 (ROADMAP Queue 3)
MOVING_STEP_P_SCALE = 1e5
# movingStep's blocks cut 4x per direction for the parity runs (1,008
# cells of the shipped 16,128)
MOVING_STEP_PARITY_BLOCKS = (("(48 16 1)", "(12 4 1)"),
                             ("(48 64 1)", "(12 16 1)"),
                             ("(192 64 1)", "(48 16 1)"))
# layeredCylinder where a layer event comes within 3 steps: the mesh at
# 120 CAD before TDC, 4 CAD a step
LAYER_EVENT_EDITS = (("constant/engineGeometry", r"theta0\s+[^;]+;",
                      "theta0 -120;"),
                     ("system/controlDict", r"deltaT\s+[^;]+;",
                      "deltaT 4;"))


def slice16_case(here, dst, name, cli, device=(), end_time=None,
                 parity=False, p_scale=None, flame=False):
    """Slice 16's cases at dst: the tutorials of SLICE16_TUTORIALS as
    shipped (compression ships its polyMesh; the others are meshed by
    `cli`'s blockMesh), firingCylinder with FIRING_IGNITION, and
    "floating", the body of floating_case. `end_time` rewrites the
    controlDict's endTime, `p_scale` multiplies movingStep's p, `flame`
    gives firingCylinder FIRING_FLAME. With
    `parity` the well-posed variants of the float64 comparisons: the
    engine cases and movingStep seeded (_seed_u_t: a uniform start under
    upwind weighs round-off), movingStep's p scaled by
    MOVING_STEP_P_SCALE and its blocks cut (MOVING_STEP_PARITY_BLOCKS),
    attachDuct's p converged (ATTACH_TIGHT_P) and layeredCylinder at
    LAYER_EVENT_EDITS."""
    if name == "floating":
        floating_case(dst, cli)
    else:
        shutil.copytree(os.path.join(here, SLICE16_TUTORIALS[name]), dst)
        if parity and name == "movingStep":
            for a, b in MOVING_STEP_PARITY_BLOCKS:
                _edit(os.path.join(dst, "constant", "polyMesh",
                                   "blockMeshDict"), re.escape(a), b)
        if name == "firingCylinder":
            path = os.path.join(dst, "constant", "combustionProperties")
            _edit(path, r"ignition\s*\{[^}]*\}", FIRING_IGNITION)
            for key, entry in FIRING_FLAME if flame else ():
                _edit(path, rf"\n{key}\s+[^;]+;", f"\n{key} {entry};")
        if not os.path.exists(os.path.join(dst, "constant", "polyMesh",
                                           "faces")):
            with contextlib.redirect_stdout(io.StringIO()):
                check(cli(["blockMesh", "-case", dst]) == 0,
                      "blockMesh failed")
    if parity and name == "movingStep":
        p_scale = MOVING_STEP_P_SCALE
    if p_scale is not None:
        _edit(os.path.join(dst, "0", "p"), r"uniform 1;",
              f"uniform {p_scale!r};")
    if parity:
        if name in ENGINE_CASES or name == "movingStep":
            _seed_u_t(dst, SLICE16_SEED)
        if name == "attachDuct":
            for key in ("p", "pFinal"):
                _edit(os.path.join(dst, "system", "fvSolution"),
                      rf"(\n\s*{key}\s*\{{)[^}}]*\}}",
                      rf"\1 {ATTACH_TIGHT_P} }}")
        if name == "layeredCylinder":
            for rel, pattern, repl in LAYER_EVENT_EDITS:
                _edit(os.path.join(dst, rel), pattern, repl)
    if end_time is not None:
        _edit(os.path.join(dst, "system", "controlDict"),
              r"endTime\s+[^;]+;", f"endTime {end_time};")
    return dst


def slice16_arrays(state, host):
    """Slice 16's state beyond U, p, p_rgh, T, alpha and phi: b, the
    moved points and the rigid body (x, q, v, L in one array)."""
    out = {}
    if "b" in state:
        out["b"] = host(state["b"].data)
    if "body" in state:
        out["body"] = np.concatenate([np.ravel(host(a))
                                      for a in state["body"]])
    if "points" in state:
        out["points"] = host(state["points"])
    return out


# the topo phase: each case through `python -m foamtpu_torch run` for
# these steps (layeredCylinder past its first layer removal, at 33 CAD
# from BDC; movingStep with its p in Pa, above the step's p_min;
# firingCylinder with FIRING_FLAME; the floating body to 0.2 s)
TOPO_RUNS = {
    "attachDuct": (12, {}),
    "damBreakWithObstacle": (10, {}),
    "movingStep": (20, {"p_scale": MOVING_STEP_P_SCALE}),
    "compression": (20, {}),
    "layeredCylinder": (35, {}),
    "firingCylinder": (20, {"flame": True}),
    "floating": (20, {"end_time": 0.2}),
}
# the command in a process of its own, as `python -m foamtpu_torch run
# -case <dir> -steps <n>` runs it (runpy, as -m does), its run_case
# watched for the final case's summary (topo_summary, or the function
# CHIP_SMOKE_SUMMARY names), its SpMV launches written at exit
TOPO_RUNNER = r"""
import atexit, json, os, runpy, sys
here, case_dir, steps, out = sys.argv[1:5]
sys.path.insert(0, here)
import chip_smoke
from foamtpu_torch.core import case as case_mod
from foamtpu_torch.ops import spmv
rec = {}
run_case = case_mod.run_case


def watched(*args, **kw):
    case = run_case(*args, **kw)
    summary = os.environ.get("CHIP_SMOKE_SUMMARY", "topo_summary")
    rec["summary"] = getattr(chip_smoke, summary)(case)
    return case


def done():
    rec.update(launches=spmv.LAUNCHES, fb_launches=spmv.FB_LAUNCHES)
    with open(out, "w") as f:
        json.dump(rec, f)


case_mod.run_case = watched
atexit.register(done)
sys.argv = ["foamtpu_torch", "run", "-case", case_dir, "-steps", steps,
            *sys.argv[5:]]
runpy.run_module("foamtpu_torch", run_name="__main__", alter_sys=True)
"""


def topo_summary(case):
    """Host scalars of a slice-16 run's final case: the step count, the
    mesh's cells, faces and volume, volume-weighted means (and extremes)
    of p, p_rgh, T, alpha and b, U's means and largest magnitude, the
    water volume, the body's centre of mass, the engine's mass and mean
    pressure, the layer events, and whether every field is finite."""
    st = case.final_state
    diag = st.get("diag") if isinstance(st.get("state"), dict) else None
    events = st.get("n_events")
    if isinstance(st.get("state"), dict):
        st = st["state"]
    mesh = case.mesh
    v = mesh.v.double()
    V = float(v.sum())
    out = {"steps": case.time.index, "n_cells": mesh.n_cells,
           "n_faces": mesh.n_faces,
           "n_internal_faces": mesh.n_internal_faces, "volume": V}
    finite = True
    for name in ("p", "p_rgh", "T", "alpha", "b"):
        if name in st:
            d = st[name].data.double()
            finite &= bool(torch.isfinite(d).all())
            out[f"{name}_mean"] = float((d * v).sum()) / V
            out[f"{name}_min"] = float(d.min())
            out[f"{name}_max"] = float(d.max())
    U = st["U"].data.double()
    finite &= bool(torch.isfinite(U).all())
    out["Ux_mean"] = float((U[:, 0] * v).sum()) / V
    out["Uy_mean"] = float((U[:, 1] * v).sum()) / V
    out["U_max"] = float(torch.linalg.norm(U, dim=1).max())
    if "alpha" in st:
        out["water_volume"] = float((st["alpha"].data.double() * v).sum())
    if "body" in st:
        out["body_y"] = float(st["body"].x[1])
        out["body_vy"] = float(st["body"].v[1])
    for key, name in (("mass", "mass"), ("V_total", "V_total"),
                      ("p_mean", "p_mean_diag")):
        if diag is not None and key in diag:
            out[name] = float(diag[key])
    if events is not None:
        out["layer_events"] = int(events)
    out["finite"] = finite
    return out


def perturb_case(dst, seed, rel=1e-7):
    """A perturbed start: U, p, p_rgh and T of 0/ times (1 + rel n), plus
    rel^1.3 n' absolute (the fields that start at zero), n and n' drawn
    cell by cell from numpy's generator."""
    from foamtpu_torch.core.case import Case

    case = Case(dst, device="cpu")
    rng = np.random.default_rng(seed)
    for name in ("U", "p", "p_rgh", "T"):
        if os.path.exists(os.path.join(dst, "0", name)):
            f = case.read_field(name).data.double().numpy()
            set_internal(dst, name, f * (1.0 + rel * rng.standard_normal(
                f.shape)) + rel ** 1.3 * rng.standard_normal(f.shape))


def topo_runs_cpu(here, root, perturb=False):
    """TOPO_RUNS through the port's run_case on the CPU, in process (the
    goldens of TOPO_GOLDEN: float64 with FOAMTPU_X64=1, float32 without,
    and with `perturb` from perturb_case's start): {name: topo_summary}."""
    from foamtpu_torch.apps.cli import main as cli
    from foamtpu_torch.core.case import run_case

    out = {}
    for name, (steps, kw) in TOPO_RUNS.items():
        d = slice16_case(here, os.path.join(root, name), name, cli, **kw)
        if perturb:
            perturb_case(d, SLICE16_SEED)
        with quiet():
            out[name] = topo_summary(run_case(d, max_steps=steps,
                                              device="cpu"))
    return out


# goldens from the port on the CPU in float64 of TOPO_RUNS, and their spread
# under round-off (the largest of |float32 - float64|, |float64 from
# perturb_case's start - float64| and |float32 from that start -
# float32|): `python tests/test_torch_topo.py goldens [--perturb]` (with
# FOAMTPU_X64=1 for float64), then `... spread f64.json f32.json
# f64_perturbed.json f32_perturbed.json`. The f32 runs' own sensitivity
# counts: compression starts uniform, and p's float32 quantum at 1e5 Pa
# drives its first steps' U
TOPO_GOLDEN = {
    'attachDuct': {'steps': 12, 'n_cells': 400, 'n_faces': 1660,
        'n_internal_faces': 740, 'volume': 0.10000000000000002,
        'p_mean': 0.500056817073474, 'p_min': -0.035797021771099585,
        'p_max': 1.035856626359172, 'Ux_mean': 0.00014053461952763099,
        'Uy_mean': -1.2477078404124663e-09, 'U_max': 0.006076825467361081,
        'finite': True},
    'damBreakWithObstacle': {'steps': 10, 'n_cells': 364, 'n_faces': 1509,
        'n_internal_faces': 711, 'volume': 0.05,
        'p_rgh_mean': -1800.8903758577953, 'p_rgh_min': -2272.7871538979207,
        'p_rgh_max': 2418.481045100216, 'alpha_mean': 0.15625000000000003,
        'alpha_min': -7.109085735751495e-25, 'alpha_max': 1.0011635844747784,
        'Ux_mean': -0.00022594575327142665, 'Uy_mean': 0.0004065885249752804,
        'U_max': 0.8246785722111691, 'water_volume': 0.007812500000000002,
        'finite': True},
    'movingStep': {'steps': 20, 'n_cells': 16128, 'n_faces': 64832,
        'n_internal_faces': 31936, 'volume': 0.126,
        'p_mean': 101795.18751611609, 'p_min': 99999.99999999722,
        'p_max': 1536904.1656373497, 'T_mean': 1.0043363369595575,
        'T_min': 1.0, 'T_max': 2.9577450149122844,
        'Ux_mean': 2.997245559180361, 'Uy_mean': 0.0003358340144699351,
        'U_max': 3.014882108124055, 'mass': 17729.112628668798,
        'V_total': 0.126, 'p_mean_diag': 101795.1875161161, 'finite': True},
    'compression': {'steps': 20, 'n_cells': 192, 'n_faces': 800,
        'n_internal_faces': 352, 'volume': 2.5000000000000005e-05,
        'p_mean': 102527.59497771441, 'p_min': 102527.57182920437,
        'p_max': 102527.64021185531, 'T_mean': 302.0859396689283,
        'T_min': 302.08590569469806, 'T_max': 302.08599891662755,
        'Ux_mean': -6.107251763832084e-11, 'Uy_mean': 0.031815807232657936,
        'U_max': 0.06911891661113129, 'mass': 2.9025702580092497e-05,
        'V_total': 2.455322229199197e-05, 'p_mean_diag': 102527.59497771438,
        'finite': True},
    'layeredCylinder': {'steps': 35, 'n_cells': 54, 'n_faces': 231,
        'n_internal_faces': 93, 'volume': 2.371076545660198e-05,
        'p_mean': 108113.99134141734, 'p_min': 108111.68937636679,
        'p_max': 108114.51449358246, 'T_mean': 306.5405446717428,
        'T_min': 306.47121829553356, 'T_max': 306.55463856834336,
        'Ux_mean': 1.7610013640178605e-09, 'Uy_mean': 0.057460498861141164,
        'U_max': 0.10819797535307825, 'mass': 2.893589541867951e-05,
        'V_total': 2.3554806889133405e-05, 'p_mean_diag': 108114.00657542402,
        'layer_events': 1, 'finite': True},
    'firingCylinder': {'steps': 20, 'n_cells': 192, 'n_faces': 800,
        'n_internal_faces': 352, 'volume': 2.5000000000000005e-05,
        'p_mean': 102529.67873847653, 'p_min': 102218.35558836331,
        'p_max': 103257.47105826043, 'T_mean': 337.73955852036335,
        'T_min': 305.6684203687727, 'T_max': 502.5538021388512,
        'b_mean': 0.8143664180594429, 'b_min': 0.0,
        'b_max': 0.9821079692515056, 'Ux_mean': -5.599642322972228e-05,
        'Uy_mean': 0.03181970009749808, 'U_max': 0.07021118400843691,
        'mass': 2.659731756720079e-05, 'V_total': 2.455322229199197e-05,
        'p_mean_diag': 102529.67873847653, 'finite': True},
    'floating': {'steps': 20, 'n_cells': 240, 'n_faces': 1000,
        'n_internal_faces': 440, 'volume': 0.04800000000000001,
        'p_mean': -0.9532283002892905, 'p_min': -70.36333119569936,
        'p_max': 106.36944043522057, 'Ux_mean': 0.024890242415377767,
        'Uy_mean': 0.23671455605005226, 'U_max': 90.15791550073624,
        'body_y': 0.3514988106017187, 'body_vy': -1.2198403462363,
        'finite': True},
}
TOPO_SPREAD = {
    'attachDuct': {'volume': 4.7497451111100375e-09,
        'p_mean': 2.1218042820514427e-06, 'p_min': 2.7492642402648926e-06,
        'p_max': 3.836480326757652e-06, 'Ux_mean': 7.193975256079626e-09,
        'Uy_mean': 1.0063060618439161e-09, 'U_max': 8.864394585661808e-07},
    'damBreakWithObstacle': {'volume': 7.450580569168253e-10,
        'p_rgh_mean': 25.078656697296537, 'p_rgh_min': 25.55810546875,
        'p_rgh_max': 25.55126953125, 'alpha_mean': 1.8806153301298423e-09,
        'alpha_min': 2.810788831103664e-16,
        'alpha_max': 4.698586060980503e-05,
        'Ux_mean': 1.5247999539892178e-05, 'Uy_mean': 1.6204659971209108e-05,
        'U_max': 4.46055667756573e-05,
        'water_volume': 1.6019745252560114e-10},
    'movingStep': {'volume': 5.9846788635908865e-09,
        'p_mean': 0.10389478420256637, 'p_min': 1.2656249972205842,
        'p_max': 4.665637349709868, 'T_mean': 1.2368044306487747e-06,
        'T_min': 0.0, 'T_max': 3.0391279826069706e-06,
        'Ux_mean': 2.4181149171909055e-07, 'Uy_mean': 2.2609312847051907e-08,
        'U_max': 1.7910222815942234e-06, 'mass': 0.0013005437976971734,
        'V_total': 1.2874603272372553e-08,
        'p_mean_diag': 0.11717138389940374},
    'compression': {'volume': 2.779415762756317e-13,
        'p_mean': 1.0944010416424135, 'p_min': 1.09375, 'p_max': 1.078125,
        'T_mean': 0.0010515848795762395, 'T_min': 0.001129150390625,
        'T_max': 0.00103759765625, 'Ux_mean': 8.532928389411629e-05,
        'Uy_mean': 0.00010136904499328386, 'U_max': 0.0001878584999298466,
        'mass': 2.0554580260068178e-10, 'V_total': 5.371347829952015e-13,
        'p_mean_diag': 1.1171875},
    'layeredCylinder': {'volume': 1.8008303995144942e-13,
        'p_mean': 8.378635982749984, 'p_min': 8.390625, 'p_max': 8.3828125,
        'T_mean': 0.006399132091132742, 'T_min': 0.006256103515625,
        'T_max': 0.00634765625, 'Ux_mean': 1.5905296362921763e-05,
        'Uy_mean': 5.821351423816734e-06, 'U_max': 0.000230808493453305,
        'mass': 1.6370904631912708e-09, 'V_total': 1.8777613233040506e-12,
        'p_mean_diag': 8.375},
    'firingCylinder': {'volume': 2.779415762756317e-13,
        'p_mean': 9.420463997419574, 'p_min': 28.6953125, 'p_max': 23.125,
        'T_mean': 0.03837316985271855, 'T_min': 0.11104732189767219,
        'T_max': 0.020447128726914343, 'b_mean': 0.00016105911949904073,
        'b_min': 0.0, 'b_max': 0.0005988159505208035,
        'Ux_mean': 2.423619077115981e-05, 'Uy_mean': 0.000384608319715575,
        'U_max': 0.0008802239334838036, 'mass': 1.145902195404298e-09,
        'V_total': 5.371347829952015e-13, 'p_mean_diag': 9.422824023466092},
    'floating': {'volume': 1.8440186183577012e-10,
        'p_mean': 0.1606582833755562, 'p_min': 0.75421142578125,
        'p_max': 0.8751907348632812, 'Ux_mean': 0.0013182205772104272,
        'Uy_mean': 0.0086289917637202, 'U_max': 1.5617589402239673,
        'body_y': 2.8908252716064453e-06, 'body_vy': 0.0005707740783691406},
}
TOPO_TOL_SPREAD = 10.0
TOPO_TOL_FLOOR = 1e-4         # of the golden, or of its field's size
TOPO_EXACT = ("steps", "n_cells", "n_faces", "n_internal_faces",
              "layer_events", "finite")


def topo_golden_errs(name, got):
    """{key: (error, tolerance)} of a run's summary against its golden:
    the counts exactly, the rest within TOPO_TOL_SPREAD times the spread,
    at least TOPO_TOL_FLOOR of the golden or of its field's size (a signed
    mean near zero sits at round-off)."""
    gold, spread = TOPO_GOLDEN.get(name, {}), TOPO_SPREAD.get(name, {})

    def field_scale(k):
        # a signed mean or an extreme near zero sits at round-off: its
        # floor is the field's own size
        if k in ("Ux_mean", "Uy_mean"):
            return abs(gold["U_max"])
        f = k.rsplit("_", 1)[0]
        return max(abs(gold.get(f"{f}_{x}", 0.0))
                   for x in ("mean", "min", "max"))

    out = {}
    for k, g in gold.items():
        if k not in got:
            out[k] = (float("inf"), 0.0)
        elif k in TOPO_EXACT:
            out[k] = (0.0 if got[k] == g else float("inf"), 0.0)
        else:
            tol = max(TOPO_TOL_SPREAD * spread.get(k, 0.0),
                      TOPO_TOL_FLOOR * max(abs(g), field_scale(k)))
            out[k] = (abs(got[k] - g), tol)
    return out


def topo_oracles(name, rec, before, log_text):
    """The physics each run must show (tests/test_amr.py,
    tests/test_engine.py, tests/test_attachdetach.py and
    tests/test_floating.py's oracles)."""
    s = rec["summary"]
    steps = TOPO_RUNS[name][0]
    c = {"finite": s["finite"], "steps": s["steps"] == steps,
         "spmv launched": rec["launches"] > 0}
    if name == "attachDuct":
        # the detach event (0.05 s, step 10): the same cells, the gate's
        # internal faces become a wall pair
        nb = before["n_internal_faces"] - s["n_internal_faces"]
        c.update({"detach logged": "DETACH" in log_text,
                  "same cells": s["n_cells"] == before["n_cells"],
                  "gate detached": nb > 0
                  and s["n_faces"] == before["n_faces"] + nb})
    elif name == "damBreakWithObstacle":
        m0, m1 = before["water_volume"], s["water_volume"]
        c.update({"refined": s["n_cells"] > before["n_cells"],
                  "3 or more events": log_text.count("Refined mesh:")
                  >= 3,
                  "water volume within 2%": abs(m1 - m0) / m0 < 0.02,
                  "alpha bounded": s["alpha_min"] > -1e-3
                  and s["alpha_max"] < 1.0 + 2.5e-3})
    elif name in ENGINE_CASES:
        gamma, m0 = before["gamma"], before["mass"]
        pv0 = before["p_mean"] * before["volume"] ** gamma
        pv = s["p_mean_diag"] * s["V_total"] ** gamma
        c["volume shrinks"] = s["V_total"] < before["volume"]
        if name != "firingCylinder":
            # mass and the isentrope (tests/test_engine.py's tolerances;
            # layered, tests/test_topochange.py's 5e-3; the flame's heat
            # release re-evaluates rho at the new T)
            tol = 5e-3 if name == "layeredCylinder" else 1e-3
            c["mass conserved"] = abs(s["mass"] - m0) / m0 < tol
            c["p V^gamma within 5%"] = abs(pv / pv0 - 1.0) < 0.05
        if name == "layeredCylinder":
            c["layer removed"] = (s.get("layer_events", 0) >= 1
                                  and s["n_cells"] < before["n_cells"])
        if name == "firingCylinder":
            c.update({"ignited": "Ignition at theta" in log_text,
                      "burnt kernel": s["b_min"] < 0.05,
                      "heat released": s["T_mean"] > 305.0})
    elif name == "movingStep":
        c["p above p_min"] = s["p_min"] >= 1e3
    elif name == "floating":
        c["body moved"] = s["body_y"] < 0.5
    return c


def phase_topo(spmv, here, root, device=()):
    """The case-directory entry end to end: each case of TOPO_RUNS
    through `python -m foamtpu_torch run -case <copy> -steps N`
    (TOPO_RUNNER), one process each, all at once on the card (`device`
    adds its flags to the command: ("-device", "cpu") rehearses the phase
    on the CPU): the runs' summaries against TOPO_GOLDEN, their oracles
    (topo_oracles), their SpMV launches; attachDuct's cells and faces
    before and after its detach event."""
    from foamtpu_torch.apps.cli import main as cli
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.models import thermo

    top = os.path.join(root, "topo")
    os.makedirs(top)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs, before = {}, {}
    t0 = time.perf_counter()
    try:
        for name, (steps, kw) in TOPO_RUNS.items():
            d = slice16_case(here, os.path.join(top, name), name, cli, **kw)
            case = Case(d, device="cpu")
            pm = case.poly_mesh
            before[name] = {"n_cells": pm.n_cells, "n_faces": pm.n_faces,
                            "n_internal_faces": pm.n_internal_faces,
                            "volume": float(pm.v.sum())}
            if name == "damBreakWithObstacle":
                a0 = case.read_field("alpha1").data.double().numpy()
                before[name]["water_volume"] = float((a0 * pm.v).sum())
            if name in ENGINE_CASES:
                th = thermo.from_dict(case.properties(
                    "thermophysicalProperties"))
                p0 = case.read_field("p").data.double()
                rho = th.rho(p0, case.read_field("T").data.double())
                v = torch.tensor(pm.v)
                before[name].update(
                    gamma=th.gamma, mass=float((rho * v).sum()),
                    p_mean=float((p0 * v).sum() / v.sum()))
            out = os.path.join(top, name + ".json")
            procs[name] = (subprocess.Popen(
                [sys.executable, "-c", TOPO_RUNNER, here, d, str(steps),
                 out, *device], cwd=here, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True), out)
        runs = {}
        for name, (proc, out) in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            check(proc.returncode == 0 and os.path.exists(out),
                  f"topo {name}: exit {proc.returncode}: {stderr[-2000:]}")
            with open(out) as f:
                runs[name] = dict(json.load(f), log=stdout)
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    checks, worst = {}, {}
    for name, rec in runs.items():
        check("summary" in rec, f"topo {name}: no summary")
        for k, ok in topo_oracles(name, rec, before[name],
                                  rec["log"]).items():
            checks[f"{name}: {k}"] = bool(ok)
        errs = topo_golden_errs(name, rec["summary"])
        checks[f"{name}: goldens"] = bool(TOPO_GOLDEN.get(name)) and all(
            e <= t for e, t in errs.values())
        worst[name] = max(((e / t if t else (0.0 if e == 0 else
                                              float("inf")), k)
                           for k, (e, t) in errs.items()), default=None)
    out = {"phase": "topo", "wall_s": wall,
           "runs": {n: {"steps": TOPO_RUNS[n][0], "before": before[n],
                        "summary": r["summary"], "launches": r["launches"],
                        "fb_launches": r["fb_launches"],
                        "worst_golden_share": worst[n]}
                    for n, r in runs.items()},
           "spmv_launches_total": sum(r["launches"] for r in runs.values()),
           "spmv_fb_launches_total": sum(r["fb_launches"]
                                         for r in runs.values()),
           "checks": checks}
    emit(out)
    for k, ok in checks.items():
        check(ok, f"topo check {k}: {out}")
    return out


AMR_HEAD_N = 384                 # 147,456 cells on the tutorial's 1 m box
AMR_HEAD_DT = 0.002 * 16 / AMR_HEAD_N   # the tutorial's Courant number
# refineInterval 2: three events (8 steps and four events cut to 6 and
# three for the script's time limit)
AMR_HEAD_STEPS = 6
AMR_HEAD_MAX_CELLS = 2000000
AMR_HEAD_WATER = (0.5, 0.3125)   # the tutorial's 8 x 5 of 16 x 16 cells
# alpha's overshoot held at 384^2: tests/test_amr.py holds 16^2 to 2.5e-3
# and expects "a transient O(1e-3) overshoot right after a remap event";
# at 384^2 the port on the CPU reaches 3.2e-3 after three events (3.6e-3
# with p_rgh converged to 1e-9, so not the solver's relTol 0.05), in the
# reference's code (ROADMAP Queue 3)
AMR_HEAD_ALPHA_OVER = 5e-3


def amr_big_case(here, dst):
    """damBreakWithObstacle at AMR_HEAD_N^2 with maxCells
    AMR_HEAD_MAX_CELLS and deltaT AMR_HEAD_DT; alpha1 uniform 0, the
    water set by the phase on the blockMesh order."""
    shutil.copytree(os.path.join(here,
                                 SLICE16_TUTORIALS["damBreakWithObstacle"]),
                    dst)
    _edit(os.path.join(dst, "constant", "polyMesh", "blockMeshDict"),
          r"\(16 16 1\)", f"({AMR_HEAD_N} {AMR_HEAD_N} 1)")
    _edit(os.path.join(dst, "system", "controlDict"), r"deltaT\s+[^;]+;",
          f"deltaT {AMR_HEAD_DT!r};")
    _edit(os.path.join(dst, "constant", "dynamicMeshDict"),
          r"maxCells\s+[^;]+;", f"maxCells {AMR_HEAD_MAX_CELLS};")
    _edit(os.path.join(dst, "0", "alpha1"),
          r"internalField\s+nonuniform[^;]*;", "internalField uniform 0;")
    return dst


def amr_premesh(path):
    """(blockMesh mesh, octree, octree mesh) of amr_big_case's
    blockMeshDict, and the seconds of each (the premesh job "amr")."""
    from foamtpu_torch.core.dictionary import parse_file
    from foamtpu_torch.mesh import blockmesh, refine

    t0 = time.perf_counter()
    pm0 = blockmesh.generate(parse_file(path))
    t1 = time.perf_counter()
    amr, pm = refine.amr_init(pm0)
    return (pm0, amr, pm), {"blockmesh_s": t1 - t0,
                            "amr_init_s": time.perf_counter() - t1}


def phase_amr_headline(spmv, here, root, flush):
    """interDyMFoam with dynamicRefineFvMesh on damBreakWithObstacle's 1 m
    box at AMR_HEAD_N^2 (blockMesh and amr_init in the background
    process), the water where x < 0.5 m and y < 0.3125 m, the tutorial's
    coefficients with maxCells AMR_HEAD_MAX_CELLS, deltaT AMR_HEAD_DT:
    AMR_HEAD_STEPS steps through the application's pieces
    (solvers/apps.py::amr_start, the step, amr_adapt every refineInterval
    steps), each step fenced by torch.cuda.synchronize with its host
    seconds, stream ms (CUDA events) and SpMV launches, each event with
    whether the mesh changed and the host seconds of its parts; one step
    after the last event (a solve at its cap, not profiled) whose p_rgh on
    the refined mesh holds the SpMV to its plain version (f32, f64; whole
    and slot part) and times it; one quiet step profiled last; held to
    tests/test_amr.py's oracles (alpha's overshoot to
    AMR_HEAD_ALPHA_OVER)."""
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.solvers import apps

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dst = amr_big_case(here, os.path.join(root, "amr_big"))
    dict_path = blockmesh_dict(dst)
    got = premeshed("amr")
    if got:
        (pm0, amr, pm), mesh_secs = got
    else:
        (pm0, amr, pm), mesh_secs = amr_premesh(dict_path)
    water = ((pm0.c[:, 0] < AMR_HEAD_WATER[0])
             & (pm0.c[:, 1] < AMR_HEAD_WATER[1])).astype(float)
    set_internal(dst, "alpha1", water)
    m0 = float((water * pm0.v).sum())
    case = Case(dst, device="cuda")
    case._poly = pm0
    t1 = time.perf_counter()
    run = apps.amr_start(case, apps._inter_config(case),
                         case.properties("dynamicMeshDict"),
                         init=(amr, pm))
    torch.cuda.synchronize()
    setup = dict(mesh_secs, amr_start_s=time.perf_counter() - t1,
                 setup_s=time.perf_counter() - t0)
    n0 = run["mesh"].n_cells
    check(n0 == AMR_HEAD_N ** 2 and run["interval"] == 2, (n0, run))
    progress("amr_headline", f"set-up {setup}, {n0} cells")
    dt = torch.tensor(AMR_HEAD_DT, dtype=run["mesh"].v.dtype,
                      device=run["mesh"].device)

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    steps, events = [], []
    spmv.LAUNCHES = spmv.FB_LAUNCHES = 0
    for k in range(1, AMR_HEAD_STEPS + 1):
        l0, f0 = spmv.LAUNCHES, spmv.FB_LAUNCHES
        mesh = run["mesh"]
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = clock()
        e0.record()
        run["state"], diag = run["step"](run["state"], dt)
        e1.record()
        host_s = clock() - t0
        steps.append({"step": k, "n_cells": mesh.n_cells,
                      "host_s": host_s, "stream_ms": e0.elapsed_time(e1),
                      "spmv_launches": spmv.LAUNCHES - l0,
                      "spmv_fb_launches": spmv.FB_LAUNCHES - f0,
                      "courant_max": float(diag["courant_max"]),
                      "alpha_min": float(diag["alpha_min"]),
                      "alpha_max": float(diag["alpha_max"])})
        if k % run["interval"] == 0:
            t0 = clock()
            rec = apps.amr_adapt(case, run, clock=clock)
            rec.update(step=k, event_s=clock() - t0)
            events.append(rec)
            progress("amr_headline", f"step {k}: {steps[-1]}, event {rec}")
    # the step after the last event (its first p_rgh PCG can run to its cap
    # of 1,000: not profiled), its matrices kept
    op_mesh = run["mesh"]
    t0 = clock()
    with SolveLog(run["state"]) as log:
        run["state"], _ = run["step"](run["state"], dt)
    settle_s = clock() - t0
    main_launches, main_fb = spmv.LAUNCHES, spmv.FB_LAUNCHES
    # the SpMV at that step's p_rgh: the refined mesh's hanging faces in
    # the COO remainder
    cases, max_err = [], 0.0
    deltas = tuple(op_mesh.st_deltas)
    op = mat_operand(op_mesh, log.matrices["p"], "amr_p_rgh")
    for dtype in (torch.float32, torch.float64):
        err = check_operands(spmv, [op], op_mesh, deltas, dtype,
                             np.random.default_rng(161), cases)
        if dtype == torch.float32:
            max_err = max(max_err, err)
    _, soff, dg, sfb = op
    timings = time_shape(spmv, "amr_p_rgh", dg.contiguous(),
                         operand_x(dg, 162), soff.contiguous(), deltas,
                         flush, fb=mesh_remainder(spmv, op_mesh, sfb,
                                                  dg.dtype))
    sec = statistics.median(s["host_s"] for s in steps)
    l_prof, f_prof = spmv.LAUNCHES, spmv.FB_LAUNCHES

    def one_step(st):
        return run["step"](st, dt)

    run["state"], prof = profile_chunk(spmv, "amr_headline_profile",
                                       run["mesh"], one_step, run["state"],
                                       1, sec)
    launches = main_launches + spmv.LAUNCHES - l_prof
    fb_launches = main_fb + spmv.FB_LAUNCHES - f_prof
    st = run["state"]
    mesh = run["mesh"]
    a = st["alpha"].data.double()
    m1 = float((a * mesh.v.double()).sum())
    finite = all(bool(torch.isfinite(st[k].data).all())
                 for k in ("U", "p_rgh", "alpha"))
    host_steps = sum(s["host_s"] for s in steps)
    host_events = sum(e["event_s"] for e in events)
    out = {"phase": "amr_headline",
           "case": "interDyMFoam damBreakWithObstacle, block ({0} {0} 1), "
                   "dynamicRefineFvMesh (refineInterval 2, maxRefinement "
                   "1, nBufferLayers 1, maxCells {1}), deltaT {2}".format(
                       AMR_HEAD_N, AMR_HEAD_MAX_CELLS, AMR_HEAD_DT),
           "dtype": str(mesh.v.dtype), **setup, "n_cells_start": n0,
           "n_cells_end": mesh.n_cells, "fb_entries_end":
           int(mesh.fb_cells.shape[0]), "steps": steps, "events": events,
           "sec_per_step_without_events": host_steps / len(steps),
           "sec_per_step_with_events": (host_steps + host_events)
           / len(steps),
           "sec_per_step_median": sec,
           "step_after_last_event_s": settle_s,
           "water_volume": [m0, m1], "alpha_range": [float(a.min()),
                                                     float(a.max())],
           "spmv_launches_per_step_profiled": prof["spmv_launches_per_iter"],
           "device_ms_per_step": prof["device_ms_per_iter"],
           "device_busy_share": prof["device_busy_share_unprofiled"],
           "cuda_launch_kernel_per_step": prof["cuda_launch_kernel_per_iter"],
           "top_kernels_ms_per_step": prof["top_kernels_ms_per_iter"][:8],
           "spmv_launches_total": launches,
           "spmv_fb_launches_total": fb_launches,
           "kernel_cases": cases, "max_abs_err_f32": max_err,
           "timings": timings,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    # an event that finds the band's cells unchanged leaves the mesh as it
    # is (dynamicRefineFvMesh's update returns false)
    changed = [e for e in events if e["changed"]]
    after = [s for s in steps if changed and s["step"] > changed[0]["step"]]
    checks = {"3 adaptation events": len(events) == AMR_HEAD_STEPS // 2,
              "the mesh changed": len(changed) >= 1,
              "refined": mesh.n_cells > n0,
              "finite": finite,
              "water volume within 2%": abs(m1 - m0) / m0 < 0.02,
              "alpha bounded": float(a.min()) > -1e-3
              and float(a.max()) < 1.0 + AMR_HEAD_ALPHA_OVER,
              "spmv launched every step": all(s["spmv_launches"] > 0
                                              for s in steps),
              "the remainder launched after each event": all(
                  s["spmv_fb_launches"] > 0 for s in after),
              "operand has a remainder": op[3].shape[0] > 0}
    out["checks"] = checks
    emit(out)
    for name, ok in checks.items():
        check(ok, f"amr_headline check {name}: {out}")
    return out, max_err, timings


# ---------------------------------------------------------------------------
# slice 17: the Lagrangian family and the discrete methods
# ---------------------------------------------------------------------------

SLICE17_TUTORIALS = {
    "icoUncoupledKinematicParcelFoam": (
        "lagrangian", "icoUncoupledKinematicParcelFoam", "fallingCloud"),
    "uncoupledKinematicParcelFoam": (
        "lagrangian", "uncoupledKinematicParcelFoam", "fallingCloud"),
    "reactingParcelFoam": ("lagrangian", "reactingParcelFoam",
                           "evaporationBox"),
    "LTSReactingParcelFoam": ("lagrangian", "LTSReactingParcelFoam",
                              "parcelBox"),
    "porousExplicitSourceReactingParcelFoam": (
        "lagrangian", "porousExplicitSourceReactingParcelFoam", "parcelBox"),
    "coalChemistryFoam": ("lagrangian", "coalChemistryFoam", "parcelBox"),
    "sprayFoam": ("lagrangian", "sprayFoam", "aachenBomb"),
    "reactingParcelFilmFoam": ("lagrangian", "reactingParcelFilmFoam",
                               "parcelBox"),
    "sprayEngineFoam": ("lagrangian", "sprayEngineFoam", "sprayChamber"),
    "dsmcFoam": ("discreteMethods", "dsmcFoam", "dsmcBox"),
    "mdFoam": ("discreteMethods", "mdFoam", "nveBox"),
    "mdEquilibrationFoam": ("discreteMethods", "mdEquilibrationFoam",
                            "periodicBox"),
}
SLICE17_SEED = 17
# the carrier-coupled parcel applications (their starts are uniform, U = 0:
# the first steps' U is the round-off of the pressure solve, so the f64
# parity starts are seeded)
PARCEL_APPS = ("reactingParcelFoam", "LTSReactingParcelFoam",
               "porousExplicitSourceReactingParcelFoam", "coalChemistryFoam",
               "sprayFoam", "reactingParcelFilmFoam", "sprayEngineFoam")


# aachenBomb as shipped steps 1 s and returns NaN in both packages (its
# parcels cross the 0.1 m box in a step and strand outside it): the
# lagrangian phase's run steps 1e-4 s, as its parity variant does
# LTSReactingParcelFoam's parcelBox sets no maxDeltaT, so its local steps
# reach the default 1 s, 1000 global steps, where the closed box's pressure
# level rests on psi V/dt alone: float32 round-off sets it (the JAX
# package's U reaches 1e-3 m/s in 5 steps, 5e-8 in float64; the port's
# float32 run diverges by step 5): both runs cap it at 0.01 s
LAG_EDITS = {"sprayFoam": (("system/controlDict", r"deltaT\s+1;",
                            "deltaT 1e-4;"),),
             "LTSReactingParcelFoam": (
                 ("system/controlDict", r"writeFormat\s+ascii;",
                  "writeFormat ascii;\nmaxDeltaT 0.01;"),)}

# the parity variants' edits. LTSReactingParcelFoam's local steps at 1 s
# carry p's round-off (1e-12 of p after one step in float64) into U at
# 2e-9 through U = HbyA - rAU grad(p); at 0.01 s (LAG_EDITS) they stay 10
# global steps. sprayFoam's
# aachenBomb steps 1 s: its parcels leave the 0.1 m box at 50 m/s and the
# walk's last free advance strands them, so the variant steps 1e-4 s. The
# coal case names no coalCloud1Properties and so burns nothing in 3 steps
# at 300 K (its Yvapour stays at 1e-15, round-off): the variant is
# tests/test_reactingcloud.py's hot coal (1200 K parcels and gas)
SLICE17_TIGHT = {
    "LTSReactingParcelFoam": LAG_EDITS["LTSReactingParcelFoam"],
    "sprayFoam": LAG_EDITS["sprayFoam"],
    "coalChemistryFoam": (
        ("0/T", r"internalField\s+uniform\s+[^;]+;",
         "internalField uniform 1200;"),
        ("constant/coalCloud1Properties", None,
         "FoamFile { version 2.0; format ascii; class dictionary; "
         "object coalCloud1Properties; }\nconstantProperties { rho0 1400; "
         "d0 1e-4; T0 1200; Cp0 1500; Yvolatile 0.4; }\n"),),
}


def slice17_case(here, dst, name, cli, seed=None, write_precision=None,
                 blocks=None, edits=()):
    """The tutorial of `name` (SLICE17_TUTORIALS) copied to dst, `blocks`
    replacing its block's cell counts, `edits` ((file, pattern,
    replacement), ...) applied (a pattern None writes the file), meshed by `cli`'s blockMesh; `seed` seeds
    U and T (`_seed_u_t`), `write_precision` edits the controlDict.
    Returns dst."""
    shutil.copytree(os.path.join(here, "tutorials",
                                 *SLICE17_TUTORIALS[name]), dst)
    if blocks is not None:
        path = blockmesh_dict(dst)
        text = open(path).read()
        pat = r"(hex\s*\([^)]*\)\s*)\((\d+)\s+(\d+)\s+(\d+)\)"
        check(re.search(pat, text) is not None, f"{path}: no block")
        with open(path, "w") as f:
            f.write(re.sub(pat, lambda m: f"{m.group(1)}({blocks[0]} "
                           f"{blocks[1]} {blocks[2]})", text, count=1))
    for rel, pat, new in edits:
        if pat is None:
            with open(os.path.join(dst, rel), "w") as f:
                f.write(new)
        else:
            _edit(os.path.join(dst, rel), pat, new, count=1)
    if write_precision is not None:
        with open(os.path.join(dst, "system", "controlDict"), "a") as f:
            f.write(f"\nwritePrecision {write_precision!r};\n")
    if cli is not None:
        with quiet():
            check(cli(["blockMesh", "-case", dst]) == 0, "blockMesh failed")
    if seed is not None:
        _seed_u_t(dst, seed)
    return dst


# the lagrangian phase's runs: each tutorial as shipped through `python -m
# foamtpu_torch run -steps N` (TOPO_RUNNER with lagrangian_case_summary):
# name -> steps. The tutorials' own endTimes but the reacting family's
# (50 steps of 1 ms each; 25 here) and dsmcBox's 50 us (25 steps)
LAG_RUNS = {
    "icoUncoupledKinematicParcelFoam": 100,
    "uncoupledKinematicParcelFoam": 100,
    "reactingParcelFoam": 25,
    "LTSReactingParcelFoam": 25,
    "porousExplicitSourceReactingParcelFoam": 25,
    "coalChemistryFoam": 25,
    "sprayFoam": 30,
    "reactingParcelFilmFoam": 25,
    "sprayEngineFoam": 30,
    "dsmcFoam": 25,
    "mdFoam": 300,
    "mdEquilibrationFoam": 300,
}
# its random stream differs from the reference's: held to oracles only
LAG_RANDOM = ("dsmcFoam",)


def lagrangian_summary(st, v, host):
    """Host float64 scalars of a slice-17 application's final state, in
    either package (`host` makes numpy of an array): volume means and
    extremes of p and T, U's means and largest magnitude, Yvapour's mean
    and largest value, the cloud's active count and the means of its
    active parcels' x, u, d and T, the coal's volatile fraction, the
    film's volume, DSMC's sampled T and number density (over occupied
    cells) and kinetic sum, MD's T and E; whether every array is
    finite."""
    out, finite = {}, True
    v = np.asarray(v, dtype=np.float64)
    V = float(v.sum())

    def arr(x):
        nonlocal finite
        a = np.asarray(host(x.data if hasattr(x, "bcs") else x),
                       dtype=np.float64)
        finite &= bool(np.isfinite(a).all())
        return a

    fields = st["state"] if isinstance(st.get("state"), dict) else {}
    for name in ("p", "T"):
        if name in fields:
            a = arr(fields[name])
            out.update({f"{name}_mean": float((a * v).sum()) / V,
                        f"{name}_min": float(a.min()),
                        f"{name}_max": float(a.max())})
    if "U" in fields:
        U = arr(fields["U"])
        out.update({"Ux_mean": float((U[:, 0] * v).sum()) / V,
                    "Uy_mean": float((U[:, 1] * v).sum()) / V,
                    "U_max": float(np.linalg.norm(U, axis=1).max())})
    yv = st.get("Yv", fields.get("Yv"))
    if yv is not None:
        a = arr(yv)
        out.update({"Yv_mean": float((a * v).sum()) / V,
                    "Yv_max": float(a.max())})
    cloud = st.get("cloud", fields.get("cloud"))
    if cloud is not None:
        act = np.asarray(host(cloud.active)).astype(bool)
        out["n_active"] = int(act.sum())
        if act.any():
            x, u = arr(cloud.x)[act], arr(cloud.u)[act]
            for i, c in enumerate("xyz"):
                out[f"x{c}_mean"] = float(x[:, i].mean())
                out[f"u{c}_mean"] = float(u[:, i].mean())
            if hasattr(cloud, "d"):
                out["d_mean"] = float(arr(cloud.d)[act].mean())
            if getattr(cloud, "T", None) is not None:
                out["Tp_mean"] = float(arr(cloud.T)[act].mean())
            if hasattr(cloud, "sigma_cr_max"):
                out["ke_sum"] = float((u * u).sum())
                if st.get("species") is not None:
                    # the gas temperature from every particle's peculiar
                    # velocity (the cells' sampled T is biased by (N-1)/N)
                    m = arr(st["species"].mass)[
                        np.asarray(host(cloud.typ)).astype(np.int64)[act]]
                    c = u - u.mean(axis=0)
                    out["dsmc_T_gas"] = float(
                        (m * (c * c).sum(axis=1)).sum()
                        / (3.0 * 1.380649e-23 * act.sum()))
    if st.get("coal") is not None:
        act = np.asarray(host(st["coal"].base.active)).astype(bool)
        if act.any():
            out["yvol_mean"] = float(arr(st["coal"].yvol)[act].mean())
    if st.get("film") is not None:
        out["film_delta_sum"] = float(arr(st["film"]["delta"]).sum())
    if "fields" in st:
        n = arr(st["fields"]["N"])
        occ = n > 0
        T = np.asarray(host(st["fields"]["T"]), dtype=np.float64)[occ]
        finite &= bool(np.isfinite(T).all())
        out.update({"dsmc_T_mean": float(T.mean()),
                    "rhoN_mean": float(arr(st["fields"]["rhoN"]).mean()),
                    "occupied_share": float(occ.mean())})
    for k in ("T", "E"):
        if isinstance(st.get(k), float):
            out[f"md_{k}"] = st[k]
            finite &= bool(np.isfinite(st[k]))
    out["finite"] = finite
    return out


def lagrangian_case_summary(case):
    """lagrangian_summary of a port run's final case, with its step
    count (TOPO_RUNNER's summary for the lagrangian phase)."""
    out = lagrangian_summary(case.final_state, case.mesh.v.double().cpu(),
                             lambda t: t.detach().double().cpu().numpy()
                             if isinstance(t, torch.Tensor) else t)
    out["steps"] = case.time.index
    return out


LAG_TOL_SPREAD = 10.0
LAG_TOL_FLOOR = 1e-4          # of the golden, or of its field's size
LAG_EXACT = ("steps", "finite")
# goldens from the JAX package on the CPU (float32) of LAG_RUNS but
# LAG_RANDOM, and their spread under round-off (the larger of |float32 -
# float64| and |float32 from a start perturbed by 1e-7 - float32|): `python
# tests/test_torch_lagrangian.py goldens [--perturb]` (FOAMTPU_X64=1
# JAX_ENABLE_X64=1 for float64), then `... spread f32.json f64.json
# perturbed.json`
LAG_GOLDEN = {    'icoUncoupledKinematicParcelFoam': {
        'n_active': 16,
        'xx_mean': 0.25000000558793545,
        'ux_mean': 0.0,
        'xy_mean': 0.3596118092536926,
        'uy_mean': -1.4023489952087402,
        'xz_mean': 0.25000000558793545,
        'uz_mean': 0.0,
        'd_mean': 0.00019999999494757503,
        'Tp_mean': 300.0,
        'finite': True,
        'steps': 100,
    },    'uncoupledKinematicParcelFoam': {
        'n_active': 16,
        'xx_mean': 0.25000000558793545,
        'ux_mean': 0.0,
        'xy_mean': 0.3596118092536926,
        'uy_mean': -1.4023489952087402,
        'xz_mean': 0.25000000558793545,
        'uz_mean': 0.0,
        'd_mean': 0.00019999999494757503,
        'Tp_mean': 300.0,
        'finite': True,
        'steps': 100,
    },    'reactingParcelFoam': {
        'p_mean': 99999.4140625,
        'p_min': 99999.4140625,
        'p_max': 99999.4140625,
        'T_mean': 399.99764823913574,
        'T_min': 399.9964294433594,
        'T_max': 399.9991149902344,
        'Ux_mean': 1.916784553301909e-07,
        'Uy_mean': -5.599939280238885e-07,
        'U_max': 1.1989420974928484e-05,
        'Yv_mean': 4.779021356859852e-07,
        'Yv_max': 9.5580446668464e-07,
        'n_active': 32,
        'xx_mean': 0.09999999942374416,
        'ux_mean': 2.450693267763704e-08,
        'xy_mean': 0.08623952785274014,
        'uy_mean': -0.06465121847577393,
        'xz_mean': 0.009999999776482582,
        'uz_mean': 0.0,
        'd_mean': 4.7196479954436654e-05,
        'Tp_mean': 356.8490800857544,
        'finite': True,
        'steps': 25,
    },    'LTSReactingParcelFoam': {
        'p_mean': 100000.0,
        'p_min': 100000.0,
        'p_max': 100000.0,
        'T_mean': 400.0567517280579,
        'T_min': 392.8041687011719,
        'T_max': 415.487548828125,
        'Ux_mean': 1.908166115072155e-05,
        'Uy_mean': 1.9059832766288343e-05,
        'U_max': 0.0223132225367539,
        'Yv_mean': 4.778855968063816e-07,
        'Yv_max': 9.675190995039884e-07,
        'n_active': 32,
        'xx_mean': 0.09999983894522302,
        'ux_mean': -0.00012899272519462102,
        'xy_mean': 0.08623762923525646,
        'uy_mean': -0.06496047379914671,
        'xz_mean': 0.009999999776482582,
        'uz_mean': 0.0,
        'd_mean': 4.719663195373869e-05,
        'Tp_mean': 356.86915493011475,
        'finite': True,
        'steps': 25,
    },    'porousExplicitSourceReactingParcelFoam': {
        'p_mean': 99999.4140625,
        'p_min': 99999.4140625,
        'p_max': 99999.4140625,
        'T_mean': 399.99764823913574,
        'T_min': 399.9964294433594,
        'T_max': 399.9991149902344,
        'Ux_mean': 1.916784553301909e-07,
        'Uy_mean': -5.599939280238885e-07,
        'U_max': 1.1989420974928484e-05,
        'Yv_mean': 4.779021356859852e-07,
        'Yv_max': 9.5580446668464e-07,
        'n_active': 32,
        'xx_mean': 0.09999999942374416,
        'ux_mean': 2.450693267763704e-08,
        'xy_mean': 0.08623952785274014,
        'uy_mean': -0.06465121847577393,
        'xz_mean': 0.009999999776482582,
        'uz_mean': 0.0,
        'd_mean': 4.7196479954436654e-05,
        'Tp_mean': 356.8490800857544,
        'finite': True,
        'steps': 25,
    },    'coalChemistryFoam': {
        'p_mean': 99999.96875,
        'p_min': 99999.96875,
        'p_max': 99999.96875,
        'T_mean': 399.99975776672363,
        'T_min': 399.9996643066406,
        'T_max': 399.99993896484375,
        'Ux_mean': -5.293221416734797e-11,
        'Uy_mean': -1.5847583545447458e-07,
        'U_max': 5.213847386132772e-06,
        'Yv_mean': 0.0,
        'Yv_max': 0.0,
        'n_active': 32,
        'xx_mean': 0.099999999278225,
        'ux_mean': -4.8256478674124637e-11,
        'xy_mean': 0.08492464519804344,
        'uy_mean': -0.17938644997775555,
        'xz_mean': 0.009999999776482582,
        'uz_mean': 0.0,
        'd_mean': 9.999999747378752e-05,
        'Tp_mean': 314.38084411621094,
        'yvol_mean': 0.4000000059604645,
        'finite': True,
        'steps': 25,
    },    'sprayFoam': {
        'p_mean': 99995.6102701823,
        'p_min': 99995.5859375,
        'p_max': 99995.6484375,
        'T_mean': 299.98656272888184,
        'T_min': 299.9493408203125,
        'T_max': 299.9937744140625,
        'Ux_mean': -2.139299581142377e-05,
        'Uy_mean': -0.00045734521087574076,
        'U_max': 0.07401999080405323,
        'Yv_mean': 3.0131859428952866e-06,
        'Yv_max': 2.1166140868444927e-05,
        'n_active': 35,
        'xx_mean': 0.023028586422359304,
        'ux_mean': -0.22664158426751974,
        'xy_mean': 0.03913042905873486,
        'uy_mean': 2.7352443808955806,
        'xz_mean': 0.002508166152983904,
        'uz_mean': 0.13394761766706195,
        'd_mean': 9.642680670367554e-05,
        'Tp_mean': 299.99940011160714,
        'finite': True,
        'steps': 30,
    },    'reactingParcelFilmFoam': {
        'p_mean': 99999.4140625,
        'p_min': 99999.4140625,
        'p_max': 99999.4140625,
        'T_mean': 399.99764823913574,
        'T_min': 399.9964294433594,
        'T_max': 399.9991149902344,
        'Ux_mean': 1.916784553301909e-07,
        'Uy_mean': -5.599939280238885e-07,
        'U_max': 1.1989420974928484e-05,
        'Yv_mean': 4.779021356859852e-07,
        'Yv_max': 9.5580446668464e-07,
        'n_active': 32,
        'xx_mean': 0.09999999942374416,
        'ux_mean': 2.450693267763704e-08,
        'xy_mean': 0.08623952785274014,
        'uy_mean': -0.06465121847577393,
        'xz_mean': 0.009999999776482582,
        'uz_mean': 0.0,
        'd_mean': 4.7196479954436654e-05,
        'Tp_mean': 356.8490800857544,
        'film_delta_sum': 0.0,
        'finite': True,
        'steps': 25,
    },    'sprayEngineFoam': {
        'p_mean': 105875.91682942708,
        'p_min': 105859.7265625,
        'p_max': 105877.6640625,
        'T_mean': 304.8218542734782,
        'T_min': 304.2165832519531,
        'T_max': 304.83062744140625,
        'Ux_mean': -8.351345186774495e-05,
        'Uy_mean': 0.04785264167488398,
        'U_max': 0.10355260033758111,
        'Yv_mean': 2.656182809203473e-05,
        'Yv_max': 0.0023043868131935596,
        'n_active': 3,
        'xx_mean': 0.0345742783198754,
        'ux_mean': 0.1880247164517641,
        'xy_mean': 0.03757340461015701,
        'uy_mean': -1.6322033057610195,
        'xz_mean': 3.915854419271151e-05,
        'uz_mean': -0.33188377879559994,
        'd_mean': 2.2145587839380216e-05,
        'Tp_mean': 303.86036173502606,
        'finite': True,
        'steps': 30,
    },    'mdFoam': {
        'md_T': 77.4251937866211,
        'md_E': -3.7265925114297915e-19,
        'finite': True,
        'steps': 300,
    },    'mdEquilibrationFoam': {
        'md_T': 119.23794555664062,
        'finite': True,
        'steps': 300,
    },    'icoUncoupledKinematicParcelFoam': {
        'n_active': 16,
        'xx_mean': 0.25000000558793545,
        'ux_mean': 0.0,
        'xy_mean': 0.3596118092536926,
        'uy_mean': -1.4023489952087402,
        'xz_mean': 0.25000000558793545,
        'uz_mean': 0.0,
        'd_mean': 0.00019999999494757503,
        'Tp_mean': 300.0,
        'finite': True,
        'steps': 100,
    },    'uncoupledKinematicParcelFoam': {
        'n_active': 16,
        'xx_mean': 0.25000000558793545,
        'ux_mean': 0.0,
        'xy_mean': 0.3596118092536926,
        'uy_mean': -1.4023489952087402,
        'xz_mean': 0.25000000558793545,
        'uz_mean': 0.0,
        'd_mean': 0.00019999999494757503,
        'Tp_mean': 300.0,
        'finite': True,
        'steps': 100,
    },    'reactingParcelFoam': {
        'p_mean': 99999.4140625,
        'p_min': 99999.4140625,
        'p_max': 99999.4140625,
        'T_mean': 399.99764823913574,
        'T_min': 399.9964294433594,
        'T_max': 399.9991149902344,
        'Ux_mean': 1.916784553301909e-07,
        'Uy_mean': -5.599939280238885e-07,
        'U_max': 1.1989420974928484e-05,
        'Yv_mean': 4.779021356859852e-07,
        'Yv_max': 9.5580446668464e-07,
        'n_active': 32,
        'xx_mean': 0.09999999942374416,
        'ux_mean': 2.450693267763704e-08,
        'xy_mean': 0.08623952785274014,
        'uy_mean': -0.06465121847577393,
        'xz_mean': 0.009999999776482582,
        'uz_mean': 0.0,
        'd_mean': 4.7196479954436654e-05,
        'Tp_mean': 356.8490800857544,
        'finite': True,
        'steps': 25,
    },    'LTSReactingParcelFoam': {
        'p_mean': 99999.4296875,
        'p_min': 99999.4296875,
        'p_max': 99999.4296875,
        'T_mean': 399.9975857734681,
        'T_min': 399.9961853027344,
        'T_max': 399.9990234375,
        'Ux_mean': 9.523761019375986e-08,
        'Uy_mean': -1.3683053219637475e-07,
        'U_max': 1.4749846068071615e-06,
        'Yv_mean': 4.779024733620932e-07,
        'Yv_max': 9.558054898661794e-07,
        'n_active': 32,
        'xx_mean': 0.099999999278225,
        'ux_mean': 1.9519031113635066e-08,
        'xy_mean': 0.08623956245719455,
        'uy_mean': -0.0646494161337614,
        'xz_mean': 0.009999999776482582,
        'uz_mean': 0.0,
        'd_mean': 4.71964776806999e-05,
        'Tp_mean': 356.84876918792725,
        'finite': True,
        'steps': 25,
    },    'porousExplicitSourceReactingParcelFoam': {
        'p_mean': 99999.4140625,
        'p_min': 99999.4140625,
        'p_max': 99999.4140625,
        'T_mean': 399.99764823913574,
        'T_min': 399.9964294433594,
        'T_max': 399.9991149902344,
        'Ux_mean': 1.916784553301909e-07,
        'Uy_mean': -5.599939280238885e-07,
        'U_max': 1.1989420974928484e-05,
        'Yv_mean': 4.779021356859852e-07,
        'Yv_max': 9.5580446668464e-07,
        'n_active': 32,
        'xx_mean': 0.09999999942374416,
        'ux_mean': 2.450693267763704e-08,
        'xy_mean': 0.08623952785274014,
        'uy_mean': -0.06465121847577393,
        'xz_mean': 0.009999999776482582,
        'uz_mean': 0.0,
        'd_mean': 4.7196479954436654e-05,
        'Tp_mean': 356.8490800857544,
        'finite': True,
        'steps': 25,
    },    'coalChemistryFoam': {
        'p_mean': 99999.96875,
        'p_min': 99999.96875,
        'p_max': 99999.96875,
        'T_mean': 399.99975776672363,
        'T_min': 399.9996643066406,
        'T_max': 399.99993896484375,
        'Ux_mean': -5.293221416734797e-11,
        'Uy_mean': -1.5847583545447458e-07,
        'U_max': 5.213847386132772e-06,
        'Yv_mean': 0.0,
        'Yv_max': 0.0,
        'n_active': 32,
        'xx_mean': 0.099999999278225,
        'ux_mean': -4.8256478674124637e-11,
        'xy_mean': 0.08492464519804344,
        'uy_mean': -0.17938644997775555,
        'xz_mean': 0.009999999776482582,
        'uz_mean': 0.0,
        'd_mean': 9.999999747378752e-05,
        'Tp_mean': 314.38084411621094,
        'yvol_mean': 0.4000000059604645,
        'finite': True,
        'steps': 25,
    },    'sprayFoam': {
        'p_mean': 99995.6102701823,
        'p_min': 99995.5859375,
        'p_max': 99995.6484375,
        'T_mean': 299.98656272888184,
        'T_min': 299.9493408203125,
        'T_max': 299.9937744140625,
        'Ux_mean': -2.139299581142377e-05,
        'Uy_mean': -0.00045734521087574076,
        'U_max': 0.07401999080405323,
        'Yv_mean': 3.0131859428952866e-06,
        'Yv_max': 2.1166140868444927e-05,
        'n_active': 35,
        'xx_mean': 0.023028586422359304,
        'ux_mean': -0.22664158426751974,
        'xy_mean': 0.03913042905873486,
        'uy_mean': 2.7352443808955806,
        'xz_mean': 0.002508166152983904,
        'uz_mean': 0.13394761766706195,
        'd_mean': 9.642680670367554e-05,
        'Tp_mean': 299.99940011160714,
        'finite': True,
        'steps': 30,
    },    'reactingParcelFilmFoam': {
        'p_mean': 99999.4140625,
        'p_min': 99999.4140625,
        'p_max': 99999.4140625,
        'T_mean': 399.99764823913574,
        'T_min': 399.9964294433594,
        'T_max': 399.9991149902344,
        'Ux_mean': 1.916784553301909e-07,
        'Uy_mean': -5.599939280238885e-07,
        'U_max': 1.1989420974928484e-05,
        'Yv_mean': 4.779021356859852e-07,
        'Yv_max': 9.5580446668464e-07,
        'n_active': 32,
        'xx_mean': 0.09999999942374416,
        'ux_mean': 2.450693267763704e-08,
        'xy_mean': 0.08623952785274014,
        'uy_mean': -0.06465121847577393,
        'xz_mean': 0.009999999776482582,
        'uz_mean': 0.0,
        'd_mean': 4.7196479954436654e-05,
        'Tp_mean': 356.8490800857544,
        'film_delta_sum': 0.0,
        'finite': True,
        'steps': 25,
    },    'sprayEngineFoam': {
        'p_mean': 105875.91682942708,
        'p_min': 105859.7265625,
        'p_max': 105877.6640625,
        'T_mean': 304.8218542734782,
        'T_min': 304.2165832519531,
        'T_max': 304.83062744140625,
        'Ux_mean': -8.351345186774495e-05,
        'Uy_mean': 0.04785264167488398,
        'U_max': 0.10355260033758111,
        'Yv_mean': 2.656182809203473e-05,
        'Yv_max': 0.0023043868131935596,
        'n_active': 3,
        'xx_mean': 0.0345742783198754,
        'ux_mean': 0.1880247164517641,
        'xy_mean': 0.03757340461015701,
        'uy_mean': -1.6322033057610195,
        'xz_mean': 3.915854419271151e-05,
        'uz_mean': -0.33188377879559994,
        'd_mean': 2.2145587839380216e-05,
        'Tp_mean': 303.86036173502606,
        'finite': True,
        'steps': 30,
    },    'mdFoam': {
        'md_T': 77.4251937866211,
        'md_E': -3.7265925114297915e-19,
        'finite': True,
        'steps': 300,
    },    'mdEquilibrationFoam': {
        'md_T': 119.23794555664062,
        'finite': True,
        'steps': 300,
    },
}
LAG_SPREAD = {    'icoUncoupledKinematicParcelFoam': {
        'xx_mean': 5.587935447692871e-09,
        'ux_mean': 1.0730708856210303e-10,
        'xy_mean': 9.653815008503486e-08,
        'uy_mean': 4.5534389347956505e-07,
        'xz_mean': 5.587935447692871e-09,
        'uz_mean': 4.4517161007853745e-11,
        'd_mean': 5.052424976873318e-12,
        'Tp_mean': 0.0,
    },    'uncoupledKinematicParcelFoam': {
        'xx_mean': 5.587935447692871e-09,
        'ux_mean': 1.0730708856210303e-10,
        'xy_mean': 9.653815008503486e-08,
        'uy_mean': 4.5534389347956505e-07,
        'xz_mean': 5.587935447692871e-09,
        'uz_mean': 4.4517161007853745e-11,
        'd_mean': 5.052424976873318e-12,
        'Tp_mean': 0.0,
    },    'reactingParcelFoam': {
        'p_mean': 0.06946934422012419,
        'p_min': 0.06944257915893104,
        'p_max': 0.0694961169938324,
        'T_mean': 0.00024360297510384044,
        'T_min': 0.0003801870956294806,
        'T_max': 0.000152587890625,
        'Ux_mean': 1.0499022938814662e-06,
        'Uy_mean': 3.5857536569809667e-06,
        'U_max': 5.1588284853196714e-06,
        'Yv_mean': 5.290523066269536e-13,
        'Yv_max': 7.822475096755361e-13,
        'xx_mean': 5.762551547050521e-10,
        'ux_mean': 3.827741745787705e-08,
        'xy_mean': 3.039599044685204e-09,
        'uy_mean': 2.223532646894455e-07,
        'xz_mean': 2.2351741638115818e-10,
        'uz_mean': 5.418474452760155e-11,
        'd_mean': 5.181557331639108e-12,
        'Tp_mean': 0.00024333220710559544,
    },    'LTSReactingParcelFoam': {
        'p_mean': 0.5149058414244791,
        'p_min': 0.5149058415991021,
        'p_max': 0.5149058412498562,
        'T_mean': 0.05885363869742832,
        'T_min': 7.193025758559827,
        'T_max': 15.488950342882674,
        'Ux_mean': 0.0001313646667995273,
        'Uy_mean': 0.00021053188436326306,
        'U_max': 0.022313172087179076,
        'Yv_mean': 3.7263371581353285e-11,
        'Yv_max': 1.1714691016958936e-08,
        'xx_mean': 3.428140189498663e-07,
        'ux_mean': 0.00012899272503773493,
        'xy_mean': 1.9287544384405386e-06,
        'uy_mean': 0.00031124481770480883,
        'xz_mean': 2.2351741638115818e-10,
        'uz_mean': 5.6831157123772135e-11,
        'd_mean': 1.484221580681051e-10,
        'Tp_mean': 0.0215606689453125,
    },    'porousExplicitSourceReactingParcelFoam': {
        'p_mean': 0.06946934422012419,
        'p_min': 0.06944257915893104,
        'p_max': 0.0694961169938324,
        'T_mean': 0.00024360297510384044,
        'T_min': 0.0003801870956294806,
        'T_max': 0.000152587890625,
        'Ux_mean': 1.0499022938814662e-06,
        'Uy_mean': 3.5857536569809667e-06,
        'U_max': 5.1588284853196714e-06,
        'Yv_mean': 5.290523066269536e-13,
        'Yv_max': 7.822475096755361e-13,
        'xx_mean': 5.762551547050521e-10,
        'ux_mean': 3.827741745787705e-08,
        'xy_mean': 3.039599044685204e-09,
        'uy_mean': 2.223532646894455e-07,
        'xz_mean': 2.2351741638115818e-10,
        'uz_mean': 5.418474452760155e-11,
        'd_mean': 5.181557331639108e-12,
        'Tp_mean': 0.00024333220710559544,
    },    'coalChemistryFoam': {
        'p_mean': 0.03125026889028959,
        'p_min': 0.031250268875737675,
        'p_max': 0.031250268904841505,
        'T_mean': 0.0002422343927150905,
        'T_min': 0.00033569388085652463,
        'T_max': 0.00018310546875,
        'Ux_mean': 9.504748046951228e-07,
        'Uy_mean': 3.5527586622618985e-08,
        'U_max': 4.896958579240136e-06,
        'Yv_mean': 1.936942196500906e-14,
        'Yv_max': 3.8738843929990015e-14,
        'xx_mean': 7.217750147558988e-10,
        'ux_mean': 2.598208330775731e-08,
        'xy_mean': 9.022187441587448e-10,
        'uy_mean': 1.4901161193847656e-08,
        'xz_mean': 2.2351741638115818e-10,
        'uz_mean': 2.5976161136366874e-11,
        'd_mean': 2.526212488436659e-12,
        'Tp_mean': 0.00020083876199805673,
        'yvol_mean': 6.535684493602645e-09,
    },    'sprayFoam': {
        'p_mean': 0.06062364057288505,
        'p_min': 0.04962386809347663,
        'p_max': 0.04779589411919005,
        'T_mean': 0.00020759109338541748,
        'T_min': 0.005298332610834677,
        'T_max': 0.00013208021965738226,
        'Ux_mean': 1.5013718640337925e-06,
        'Uy_mean': 0.00038036867180526253,
        'U_max': 0.07309430709754688,
        'Yv_mean': 1.9356725784608963e-08,
        'Yv_max': 1.464148325074189e-06,
        'xx_mean': 0.0006087294124944298,
        'ux_mean': 0.16621983783587763,
        'xy_mean': 0.0009279712282612013,
        'uy_mean': 1.267257557413323,
        'xz_mean': 1.3548256315303996e-05,
        'uz_mean': 0.17410483139894545,
        'd_mean': 1.0622995822215901e-06,
        'Tp_mean': 1.6566685246743873e-05,
    },    'reactingParcelFilmFoam': {
        'p_mean': 0.06946934422012419,
        'p_min': 0.06944257915893104,
        'p_max': 0.0694961169938324,
        'T_mean': 0.00024360297510384044,
        'T_min': 0.0003801870956294806,
        'T_max': 0.000152587890625,
        'Ux_mean': 1.0499022938814662e-06,
        'Uy_mean': 3.5857536569809667e-06,
        'U_max': 5.1588284853196714e-06,
        'Yv_mean': 5.290523066269536e-13,
        'Yv_max': 7.822475096755361e-13,
        'xx_mean': 5.762551547050521e-10,
        'ux_mean': 3.827741745787705e-08,
        'xy_mean': 3.039599044685204e-09,
        'uy_mean': 2.223532646894455e-07,
        'xz_mean': 2.2351741638115818e-10,
        'uz_mean': 5.418474452760155e-11,
        'd_mean': 5.181557331639108e-12,
        'Tp_mean': 0.00024333220710559544,
        'film_delta_sum': 0.0,
    },    'sprayEngineFoam': {
        'p_mean': 16.643102320667822,
        'p_min': 21.781456441851333,
        'p_max': 15.345675766497152,
        'T_mean': 0.009608806577489304,
        'T_min': 0.11037538041125572,
        'T_max': 0.00985949928235641,
        'Ux_mean': 8.356234643356655e-05,
        'Uy_mean': 9.435793128995812e-05,
        'U_max': 0.0005933006280559872,
        'Yv_mean': 1.363272986244348e-07,
        'Yv_max': 0.0005161045507612008,
        'xx_mean': 1.1526048183441162e-05,
        'ux_mean': 0.0028206227561215214,
        'xy_mean': 0.00011186596892128614,
        'uy_mean': 0.015568197432595854,
        'xz_mean': 4.940591015013124e-06,
        'uz_mean': 0.0033690065606067354,
        'd_mean': 2.630625268918273e-08,
        'Tp_mean': 0.07471258081210408,
    },    'mdFoam': {
        'md_T': 0.0008501505386107056,
        'md_E': 7.150613090230145e-25,
    },    'mdEquilibrationFoam': {
        'md_T': 0.0016027687267978763,
    },    'icoUncoupledKinematicParcelFoam': {
        'xx_mean': 5.587935447692871e-09,
        'ux_mean': 1.0730708856210303e-10,
        'xy_mean': 9.653815008503486e-08,
        'uy_mean': 4.5534389347956505e-07,
        'xz_mean': 5.587935447692871e-09,
        'uz_mean': 4.4517161007853745e-11,
        'd_mean': 5.052424976873318e-12,
        'Tp_mean': 0.0,
    },    'uncoupledKinematicParcelFoam': {
        'xx_mean': 5.587935447692871e-09,
        'ux_mean': 1.0730708856210303e-10,
        'xy_mean': 9.653815008503486e-08,
        'uy_mean': 4.5534389347956505e-07,
        'xz_mean': 5.587935447692871e-09,
        'uz_mean': 4.4517161007853745e-11,
        'd_mean': 5.052424976873318e-12,
        'Tp_mean': 0.0,
    },    'reactingParcelFoam': {
        'p_mean': 0.06946934422012419,
        'p_min': 0.06944257915893104,
        'p_max': 0.0694961169938324,
        'T_mean': 0.00024360297510384044,
        'T_min': 0.0003801870956294806,
        'T_max': 0.000152587890625,
        'Ux_mean': 1.0499022938814662e-06,
        'Uy_mean': 3.5857536569809667e-06,
        'U_max': 5.1588284853196714e-06,
        'Yv_mean': 5.290523066269536e-13,
        'Yv_max': 7.822475096755361e-13,
        'xx_mean': 5.762551547050521e-10,
        'ux_mean': 3.827741745787705e-08,
        'xy_mean': 3.039599044685204e-09,
        'uy_mean': 2.223532646894455e-07,
        'xz_mean': 2.2351741638115818e-10,
        'uz_mean': 5.418474452760155e-11,
        'd_mean': 5.181557331639108e-12,
        'Tp_mean': 0.00024333220710559544,
    },    'LTSReactingParcelFoam': {
        'p_mean': 0.053844240290345624,
        'p_min': 0.05384223825240042,
        'p_max': 0.05384624232829083,
        'T_mean': 0.00030606837776758766,
        'T_min': 0.0006371654417876016,
        'T_max': 9.1552734375e-05,
        'Ux_mean': 3.655002763227558e-07,
        'Uy_mean': 3.3148093477042284e-07,
        'U_max': 7.999892906268617e-07,
        'Yv_mean': 6.292794535917067e-13,
        'Yv_max': 1.7289255119476871e-12,
        'xx_mean': 7.217747510779304e-10,
        'ux_mean': 1.9518990519944416e-08,
        'xy_mean': 7.74538290448934e-09,
        'uy_mean': 3.050081431865692e-08,
        'xz_mean': 2.2351741638115818e-10,
        'uz_mean': 5.454001215498411e-11,
        'd_mean': 6.0055881302050265e-12,
        'Tp_mean': 0.000274658203125,
    },    'porousExplicitSourceReactingParcelFoam': {
        'p_mean': 0.06946934422012419,
        'p_min': 0.06944257915893104,
        'p_max': 0.0694961169938324,
        'T_mean': 0.00024360297510384044,
        'T_min': 0.0003801870956294806,
        'T_max': 0.000152587890625,
        'Ux_mean': 1.0499022938814662e-06,
        'Uy_mean': 3.5857536569809667e-06,
        'U_max': 5.1588284853196714e-06,
        'Yv_mean': 5.290523066269536e-13,
        'Yv_max': 7.822475096755361e-13,
        'xx_mean': 5.762551547050521e-10,
        'ux_mean': 3.827741745787705e-08,
        'xy_mean': 3.039599044685204e-09,
        'uy_mean': 2.223532646894455e-07,
        'xz_mean': 2.2351741638115818e-10,
        'uz_mean': 5.418474452760155e-11,
        'd_mean': 5.181557331639108e-12,
        'Tp_mean': 0.00024333220710559544,
    },    'coalChemistryFoam': {
        'p_mean': 0.03125026889028959,
        'p_min': 0.031250268875737675,
        'p_max': 0.031250268904841505,
        'T_mean': 0.0002422343927150905,
        'T_min': 0.00033569388085652463,
        'T_max': 0.00018310546875,
        'Ux_mean': 9.504748046951228e-07,
        'Uy_mean': 3.5527586622618985e-08,
        'U_max': 4.896958579240136e-06,
        'Yv_mean': 1.936942196500906e-14,
        'Yv_max': 3.8738843929990015e-14,
        'xx_mean': 7.217750147558988e-10,
        'ux_mean': 2.598208330775731e-08,
        'xy_mean': 9.022187441587448e-10,
        'uy_mean': 1.4901161193847656e-08,
        'xz_mean': 2.2351741638115818e-10,
        'uz_mean': 2.5976161136366874e-11,
        'd_mean': 2.526212488436659e-12,
        'Tp_mean': 0.00020083876199805673,
        'yvol_mean': 6.535684493602645e-09,
    },    'sprayFoam': {
        'p_mean': 0.06062364057288505,
        'p_min': 0.04962386809347663,
        'p_max': 0.04779589411919005,
        'T_mean': 0.00020759109338541748,
        'T_min': 0.005298332610834677,
        'T_max': 0.00013208021965738226,
        'Ux_mean': 1.5013718640337925e-06,
        'Uy_mean': 0.00038036867180526253,
        'U_max': 0.07309430709754688,
        'Yv_mean': 1.9356725784608963e-08,
        'Yv_max': 1.464148325074189e-06,
        'xx_mean': 0.0006087294124944298,
        'ux_mean': 0.16621983783587763,
        'xy_mean': 0.0009279712282612013,
        'uy_mean': 1.267257557413323,
        'xz_mean': 1.3548256315303996e-05,
        'uz_mean': 0.17410483139894545,
        'd_mean': 1.0622995822215901e-06,
        'Tp_mean': 1.6566685246743873e-05,
    },    'reactingParcelFilmFoam': {
        'p_mean': 0.06946934422012419,
        'p_min': 0.06944257915893104,
        'p_max': 0.0694961169938324,
        'T_mean': 0.00024360297510384044,
        'T_min': 0.0003801870956294806,
        'T_max': 0.000152587890625,
        'Ux_mean': 1.0499022938814662e-06,
        'Uy_mean': 3.5857536569809667e-06,
        'U_max': 5.1588284853196714e-06,
        'Yv_mean': 5.290523066269536e-13,
        'Yv_max': 7.822475096755361e-13,
        'xx_mean': 5.762551547050521e-10,
        'ux_mean': 3.827741745787705e-08,
        'xy_mean': 3.039599044685204e-09,
        'uy_mean': 2.223532646894455e-07,
        'xz_mean': 2.2351741638115818e-10,
        'uz_mean': 5.418474452760155e-11,
        'd_mean': 5.181557331639108e-12,
        'Tp_mean': 0.00024333220710559544,
        'film_delta_sum': 0.0,
    },    'sprayEngineFoam': {
        'p_mean': 16.643102320667822,
        'p_min': 21.781456441851333,
        'p_max': 15.345675766497152,
        'T_mean': 0.009608806577489304,
        'T_min': 0.11037538041125572,
        'T_max': 0.00985949928235641,
        'Ux_mean': 8.356234643356655e-05,
        'Uy_mean': 9.435793128995812e-05,
        'U_max': 0.0005933006280559872,
        'Yv_mean': 1.363272986244348e-07,
        'Yv_max': 0.0005161045507612008,
        'xx_mean': 1.1526048183441162e-05,
        'ux_mean': 0.0028206227561215214,
        'xy_mean': 0.00011186596892128614,
        'uy_mean': 0.015568197432595854,
        'xz_mean': 4.940591015013124e-06,
        'uz_mean': 0.0033690065606067354,
        'd_mean': 2.630625268918273e-08,
        'Tp_mean': 0.07471258081210408,
    },    'mdFoam': {
        'md_T': 0.0008501505386107056,
        'md_E': 7.150613090230145e-25,
    },    'mdEquilibrationFoam': {
        'md_T': 0.0016027687267978763,
    },    'icoUncoupledKinematicParcelFoam': {
        'xx_mean': 5.587935447692871e-09,
        'ux_mean': 1.4194654322395237e-10,
        'xy_mean': 9.653815008503486e-08,
        'uy_mean': 4.5534389347956505e-07,
        'xz_mean': 5.587935447692871e-09,
        'uz_mean': 1.4958707287172218e-10,
        'd_mean': 5.052424976873318e-12,
        'Tp_mean': 0.0,
    },    'uncoupledKinematicParcelFoam': {
        'xx_mean': 5.587935447692871e-09,
        'ux_mean': 1.4194654322395237e-10,
        'xy_mean': 9.653815008503486e-08,
        'uy_mean': 4.5534389347956505e-07,
        'xz_mean': 5.587935447692871e-09,
        'uz_mean': 1.4958707287172218e-10,
        'd_mean': 5.052424976873318e-12,
        'Tp_mean': 0.0,
    },    'reactingParcelFoam': {
        'p_mean': 0.06946934422012419,
        'p_min': 0.06944257915893104,
        'p_max': 0.0694961169938324,
        'T_mean': 0.00024360297510384044,
        'T_min': 0.0003801870956294806,
        'T_max': 0.000152587890625,
        'Ux_mean': 1.3806846150821173e-06,
        'Uy_mean': 3.8999385979336665e-06,
        'U_max': 5.1588284853196714e-06,
        'Yv_mean': 5.290523066269536e-13,
        'Yv_max': 1.2505552149377763e-12,
        'xx_mean': 5.762551547050521e-10,
        'ux_mean': 1.7352155897570887e-07,
        'xy_mean': 3.039599044685204e-09,
        'uy_mean': 2.684537321329117e-07,
        'xz_mean': 2.2351741638115818e-10,
        'uz_mean': 3.013953593536227e-10,
        'd_mean': 5.181557331639108e-12,
        'Tp_mean': 0.00033473968505859375,
    },    'LTSReactingParcelFoam': {
        'p_mean': 0.053844240290345624,
        'p_min': 0.05384223825240042,
        'p_max': 0.05384624232829083,
        'T_mean': 0.00030606837776758766,
        'T_min': 0.0006371654417876016,
        'T_max': 9.1552734375e-05,
        'Ux_mean': 5.076736971849124e-07,
        'Uy_mean': 4.967821236184777e-07,
        'U_max': 9.763682618105598e-07,
        'Yv_mean': 6.292794535917067e-13,
        'Yv_max': 1.7289255119476871e-12,
        'xx_mean': 7.217747510779304e-10,
        'ux_mean': 4.656806645506051e-08,
        'xy_mean': 7.74538290448934e-09,
        'uy_mean': 3.050081431865692e-08,
        'xz_mean': 2.2351741638115818e-10,
        'uz_mean': 2.9787622824080373e-10,
        'd_mean': 6.0055881302050265e-12,
        'Tp_mean': 0.0005159378051757812,
    },    'porousExplicitSourceReactingParcelFoam': {
        'p_mean': 0.06946934422012419,
        'p_min': 0.06944257915893104,
        'p_max': 0.0694961169938324,
        'T_mean': 0.00024360297510384044,
        'T_min': 0.0003801870956294806,
        'T_max': 0.000152587890625,
        'Ux_mean': 1.3806846150821173e-06,
        'Uy_mean': 3.8999385979336665e-06,
        'U_max': 5.1588284853196714e-06,
        'Yv_mean': 5.290523066269536e-13,
        'Yv_max': 1.2505552149377763e-12,
        'xx_mean': 5.762551547050521e-10,
        'ux_mean': 1.7352155897570887e-07,
        'xy_mean': 3.039599044685204e-09,
        'uy_mean': 2.684537321329117e-07,
        'xz_mean': 2.2351741638115818e-10,
        'uz_mean': 3.013953593536227e-10,
        'd_mean': 5.181557331639108e-12,
        'Tp_mean': 0.00033473968505859375,
    },    'coalChemistryFoam': {
        'p_mean': 0.03125026889028959,
        'p_min': 0.031250268875737675,
        'p_max': 0.031250268904841505,
        'T_mean': 0.0002422343927150905,
        'T_min': 0.00033569388085652463,
        'T_max': 0.00018310546875,
        'Ux_mean': 1.278649638392082e-06,
        'Uy_mean': 2.31717700439546e-06,
        'U_max': 4.896958579240136e-06,
        'Yv_mean': 1.936942196500906e-14,
        'Yv_max': 3.8738843929990015e-14,
        'xx_mean': 7.217750147558988e-10,
        'ux_mean': 4.93096436425533e-08,
        'xy_mean': 9.022187441587448e-10,
        'uy_mean': 7.729977369308472e-08,
        'xz_mean': 2.2351741638115818e-10,
        'uz_mean': 1.4456084070822934e-10,
        'd_mean': 2.526212488436659e-12,
        'Tp_mean': 0.00020083876199805673,
        'yvol_mean': 6.535684493602645e-09,
    },    'sprayFoam': {
        'p_mean': 0.06062364057288505,
        'p_min': 0.04962386809347663,
        'p_max': 0.04779589411919005,
        'T_mean': 0.00020759109338541748,
        'T_min': 0.005298332610834677,
        'T_max': 0.00013208021965738226,
        'Ux_mean': 2.1343307602765086e-06,
        'Uy_mean': 0.00038036867180526253,
        'U_max': 0.07309430709754688,
        'Yv_mean': 1.9356725784608963e-08,
        'Yv_max': 1.464148325074189e-06,
        'xx_mean': 0.0006087294124944298,
        'ux_mean': 0.16621983783587763,
        'xy_mean': 0.0009279712282612013,
        'uy_mean': 1.267257557413323,
        'xz_mean': 1.3548256315303996e-05,
        'uz_mean': 0.17410483139894545,
        'd_mean': 1.0622995822215901e-06,
        'Tp_mean': 4.2724609386368684e-05,
    },    'reactingParcelFilmFoam': {
        'p_mean': 0.06946934422012419,
        'p_min': 0.06944257915893104,
        'p_max': 0.0694961169938324,
        'T_mean': 0.00024360297510384044,
        'T_min': 0.0003801870956294806,
        'T_max': 0.000152587890625,
        'Ux_mean': 1.3806846150821173e-06,
        'Uy_mean': 3.8999385979336665e-06,
        'U_max': 5.1588284853196714e-06,
        'Yv_mean': 5.290523066269536e-13,
        'Yv_max': 1.2505552149377763e-12,
        'xx_mean': 5.762551547050521e-10,
        'ux_mean': 1.7352155897570887e-07,
        'xy_mean': 3.039599044685204e-09,
        'uy_mean': 2.684537321329117e-07,
        'xz_mean': 2.2351741638115818e-10,
        'uz_mean': 3.013953593536227e-10,
        'd_mean': 5.181557331639108e-12,
        'Tp_mean': 0.00033473968505859375,
        'film_delta_sum': 0.0,
    },    'sprayEngineFoam': {
        'p_mean': 23.222371419265983,
        'p_min': 23.34375,
        'p_max': 23.2421875,
        'T_mean': 0.017819245656312432,
        'T_min': 0.11037538041125572,
        'T_max': 0.01776123046875,
        'Ux_mean': 0.00025898857881460446,
        'Uy_mean': 0.0002292557413359833,
        'U_max': 0.0006402576968457113,
        'Yv_mean': 2.8893963211747974e-07,
        'Yv_max': 0.0005161045726745923,
        'xx_mean': 1.1526048183441162e-05,
        'ux_mean': 0.0028206227561215214,
        'xy_mean': 0.00011186596892128614,
        'uy_mean': 0.015568197432595854,
        'xz_mean': 4.940591015013124e-06,
        'uz_mean': 0.0033690106269602116,
        'd_mean': 2.630625268918273e-08,
        'Tp_mean': 0.07471827706422118,
    },    'mdFoam': {
        'md_T': 0.0008501505386107056,
        'md_E': 7.150613090230145e-25,
    },    'mdEquilibrationFoam': {
        'md_T': 0.0016027687267978763,
    },
}


def lag_golden_errs(name, got):
    """{key: (error, tolerance)} of a run's summary against its golden:
    the step count, finiteness and the active parcel count exactly where
    the golden's spread leaves it unmoved, the rest within LAG_TOL_SPREAD
    times the spread, at least LAG_TOL_FLOOR of the golden or of its
    field's size (a signed mean near zero sits at round-off)."""
    gold, spread = LAG_GOLDEN.get(name, {}), LAG_SPREAD.get(name, {})

    def field_scale(k):
        if k in ("Ux_mean", "Uy_mean"):
            return abs(gold.get("U_max", 0.0))
        if k[0] in "xu" and k.endswith("_mean") and len(k) == 7:
            return max(abs(gold.get(f"{k[0]}{c}_mean", 0.0)) for c in "xyz")
        f = k.rsplit("_", 1)[0]
        return max(abs(gold.get(f"{f}_{x}", 0.0))
                   for x in ("mean", "min", "max"))

    out = {}
    for k, g in gold.items():
        if k not in got:
            out[k] = (float("inf"), 0.0)
        elif k in LAG_EXACT or isinstance(g, bool):
            out[k] = (0.0 if got[k] == g else float("inf"), 0.0)
        else:
            tol = max(LAG_TOL_SPREAD * spread.get(k, 0.0),
                      LAG_TOL_FLOOR * max(abs(g), field_scale(k)))
            out[k] = (abs(got[k] - g), tol)
    return out


def stokes_terminal(rho_p, d, rho_f, mu, g=9.81):
    """The settling speed with the Schiller-Naumann drag the parcels use
    (tests/test_lagrangian.py's fixed point)."""
    tau = rho_p * d ** 2 / (18 * mu)
    g_eff = (1 - rho_f / rho_p) * g
    ut = g_eff * tau
    for _ in range(100):
        ut = g_eff * tau / (1 + 0.15 * (rho_f * ut * d / mu) ** 0.687)
    return ut


def fall_replay(dt, steps, rho_p=2500.0, d=2e-4, rho_f=1.2, mu=1.8e-5,
                g=9.81):
    """The settling speed after `steps` of the parcels' own semi-implicit
    Schiller-Naumann update from rest in still air (lagrangian/
    __init__.py::_drag_update, in float64): fallingCloud's parcels all
    follow it until they meet a wall."""
    u, g_eff = 0.0, (1.0 - rho_f / rho_p) * g
    for _ in range(steps):
        Re = max(rho_f * u * d / mu, 1e-10)
        cd_re = 0.424 * Re if Re > 1000.0 else 24.0 * (1 + 0.15 * Re ** 0.687)
        tau_inv = 18.0 * mu / (rho_p * d * d) * cd_re / 24.0
        u = (u + dt * g_eff) / (1.0 + dt * tau_inv)
    return u


def lag_oracles(name, rec, log_text):
    """What each tutorial's run must show beside its golden: finite
    fields and the step count; the kinematic clouds' 16 parcels falling at
    the speed of their drag law's own integration (fall_replay, 1e-4), which
    settles at the Schiller-Naumann terminal velocity (1e-6 after 1,000
    steps); the parcel applications' Yvapour in [0, 1]; dsmcBox's particle
    count conserved every step, its gas temperature the initial 300 K (5%)
    and its number density the initialised 1e20 (5%) (tests/
    test_discretemethods.py); nveBox's total energy drift under 1% of the
    kinetic energy, periodicBox at its 120 K target (12 K)."""
    s = rec["summary"]
    c = {"finite": s["finite"], "steps": s["steps"] == LAG_RUNS[name]}
    if "Kinematic" in name:
        ut = stokes_terminal(2500.0, 2e-4, 1.2, 1.5e-5 * 1.2)
        u = fall_replay(0.005, LAG_RUNS[name])
        c.update({"16 parcels": s["n_active"] == 16,
                  "the drag law's fall 1e-4": abs(-s["uy_mean"] - u) / u
                  < 1e-4,
                  "it settles at the terminal velocity":
                  abs(fall_replay(0.005, 1000) - ut) / ut < 1e-6})
    elif name == "dsmcFoam":
        n = [int(x) for x in re.findall(
            r"Number of dsmc particles = (\d+)", log_text)]
        n0 = re.search(r"dsmcFoam, (\d+) parcels", log_text)
        c.update({"count conserved": bool(n0) and n == [int(n0.group(1))]
                  * LAG_RUNS[name],
                  "T near 300 K": abs(s["dsmc_T_gas"] - 300.0) < 15.0,
                  "number density 1e20": abs(s["rhoN_mean"] - 1e20)
                  < 0.05e20})
    elif name == "mdFoam":
        T = [float(x) for x in re.findall(r"temperature = (\S+) K",
                                          log_text)]
        E = [float(x) for x in re.findall(r"total energy = (\S+) J",
                                          log_text)]
        n = int(re.search(r"mdFoam, (\d+) molecules", log_text).group(1))
        ke0 = 1.5 * n * 1.380649e-23 * T[0]
        c["energy drift < 1% of KE"] = abs(E[-1] - E[0]) < 0.01 * ke0
    elif name == "mdEquilibrationFoam":
        c["at 120 K"] = abs(s["md_T"] - 120.0) < 12.0
    else:
        c["Yvapour in [0, 1]"] = (s.get("Yv_max", 0.0) <= 1.0
                                  and s.get("Yv_mean", 0.0) >= 0.0)
    return c


def lag_unit_oracles(device="cuda"):
    """tests/test_lagrangian.py's, tests/test_reactingcloud.py's and
    tests/test_discretemethods.py's oracles on their own small setups, on
    `device`: the ballistic parabola with the tracked cell holding the
    parcel, the Stokes terminal velocity (2%), the d^2 law (d^2 falls by
    K dt a step; the lost mass is the vapour source), DSMC's collisions
    (momentum and kinetic energy of 20 collision steps to round-off, the
    anisotropy relaxing), the NVE Lennard-Jones energy drift (1% of the
    kinetic energy over 200 steps) and the equilibration to 120 K. (rec,
    checks)."""
    from foamtpu_torch import lagrangian as lag
    from foamtpu_torch.core.dictionary import parse_string
    from foamtpu_torch.lagrangian import dsmc, md, reactingcloud as rc
    from foamtpu_torch.mesh import blockmesh, to_device

    def box(n, walls_only=False):
        text = (ORACLE_WALL_BOX if walls_only else ORACLE_LAG_BOX).replace(
            "(10 10 10)", f"({n} {n} {n})")
        return to_device(blockmesh.generate(parse_string(text)),
                         device=device)

    rec, ck = {}, {}
    mesh = box(10)
    dt_ = mesh.v.dtype
    bt = torch.tensor(lag.face_boundary_types(mesh), device=device)
    zeros = torch.zeros((mesh.n_cells, 3), dtype=dt_, device=device)

    def t(v):
        return torch.tensor(v, dtype=dt_, device=device)

    # the ballistic parabola
    cfg = lag.CloudConfig(drag=False, g=(0.0, -1.0, 0.0))
    c = lag.make_cloud(mesh, [[0.15, 0.85, 0.5]], [0.5, 0.0, 0.0], 1e-3,
                       1000.0)
    cc = mesh.c.double().cpu().numpy()
    err, inside = 0.0, True
    for i in range(10):
        c = lag.evolve(mesh, c, zeros, t(0.05), bt, cfg)
        k, tt = i + 1, 0.05 * (i + 1)
        x = c.x[0].double().cpu().numpy()
        err = max(err, abs(x[0] - (0.15 + 0.5 * tt)),
                  abs(x[1] - (0.85 - 0.05 * 0.05 * k * (k + 1) / 2)))
        inside &= bool(np.max(np.abs(x - cc[int(c.cell[0])])) < 0.051)
    rec["ballistic_err"] = err
    ck.update({"ballistic parabola 1e-5": err < 1e-5,
               "tracked cell holds the parcel": inside})
    # the Stokes terminal velocity
    rho_p, d, mu = 2000.0, 50e-6, 1.8e-5
    tau = rho_p * d ** 2 / (18 * mu)
    cfg = lag.CloudConfig(rho_f=1.2, mu_f=mu, g=(0.0, -9.81, 0.0))
    c = lag.make_cloud(mesh, [[0.5, 0.9, 0.5]], [0.0, 0.0, 0.0], d, rho_p)
    for _ in range(60):
        c = lag.evolve(mesh, c, zeros, t(tau / 4), bt, cfg)
    ut = stokes_terminal(rho_p, d, 1.2, mu)
    rec["stokes_rel_err"] = abs(-float(c.u[0, 1]) - ut) / ut
    ck["Stokes terminal velocity 2%"] = rec["stokes_rel_err"] < 0.02
    # the d^2 law
    small = box(4, walls_only=True)
    rng = np.random.default_rng(0)
    c = lag.make_cloud(small, 0.2 + 0.6 * rng.random((20, 3)),
                       [0.0, 0.0, 0.0], 1e-4, 1000.0)
    cfg = lag.CloudConfig(rho_f=1.0, mu_f=1.8e-5)
    ecfg = rc.EvapConfig(K_evap=1e-8)
    u_f = torch.zeros((small.n_cells, 3), dtype=dt_, device=device)
    T_f = torch.full((small.n_cells,), 400.0, dtype=dt_, device=device)

    def mass(cl):
        return float(torch.sum(torch.where(
            cl.active, cl.rho * torch.pi / 6 * cl.d ** 3,
            torch.zeros_like(cl.d))).double())

    m0, d2_0, vap = mass(c), float(c.d[0].double()) ** 2, 0.0
    for _ in range(10):
        c, v, _ = rc.evaporate(c, u_f, T_f, t(1e-2), cfg, ecfg,
                               small.n_cells)
        vap += float(v.double().sum())
    d2 = float(c.d[0].double()) ** 2
    rec.update(d2_err=abs(d2 - (d2_0 - 10 * 1e-2 * 1e-8)),
               mass_gap=abs((m0 - mass(c)) - vap) / m0)
    ck.update({"d^2 law": rec["d2_err"] < 1e-12 + 1e-6 * d2_0,
               "evaporated mass is the vapour source":
               rec["mass_gap"] < 1e-5 and vap > 0})
    # DSMC: 20 collision steps of the anisotropic gas
    mesh6 = box(6, walls_only=True)
    ar = dsmc.Species(*(torch.tensor([x], dtype=dt_, device=device)
                        for x in (6.63e-26, 4.17e-10, 0.81)), T_ref=273.0)
    nd = 1e20
    vc = float(mesh6.v[0])
    fn = nd * vc / 20.0
    cl = dsmc.initialise(mesh6, ar, nd, 600.0, (0.0, 0.0, 0.0), fn, seed=3)
    n = cl.active.shape[0]
    m = 6.63e-26
    rng = np.random.default_rng(4)
    sx, syz = (np.sqrt(dsmc.K_BOLTZ * T / m) for T in (600.0, 150.0))
    u = np.stack([sx * rng.standard_normal(n), syz * rng.standard_normal(n),
                  syz * rng.standard_normal(n)], axis=1)
    cl = cl._replace(u=torch.tensor(u, dtype=dt_, device=device))
    act = cl.active

    def moments(cl):
        uu = cl.u[act].double()
        cm = uu - uu.mean(0)
        return (uu.sum(0).cpu().numpy(), float((uu * uu).sum()),
                (m * (cm * cm).mean(0) / dsmc.K_BOLTZ).cpu().numpy())

    p0, e0, T0 = moments(cl)
    cfg6 = dsmc.DsmcConfig(nEquivalentParticles=fn, n_rounds=8)
    dp = de = 0.0
    for _ in range(20):
        cl = dsmc._collide(mesh6, cl, t(5e-6), cfg6, ar)
        p1, e1, T1 = moments(cl)
        dp = max(dp, float(np.abs(p1 - p0).max()) / np.sqrt(e0))
        de = max(de, abs(e1 - e0) / e0)
    rec.update(dsmc_momentum=dp, dsmc_energy=de, dsmc_T0=T0.tolist(),
               dsmc_T20=T1.tolist())
    ck.update({"DSMC momentum to round-off": dp < 1e-5,
               "DSMC energy to round-off": de < 1e-5,
               "DSMC anisotropy relaxes": (T1.max() - T1.min())
               < 0.8 * (T0.max() - T0.min())})
    # MD: NVE in reduced units, then the equilibration
    mcfg = md.MdConfig(epsilon=1.0, sigma=1.0, mass=1.0, box=(6.3,) * 3,
                       r_cut=2.5)
    x, u = md.lattice_fill(mcfg.box, 5, mass=1.0, T0=0.8 / md.K_BOLTZ,
                           seed=1)
    s = md.make_state(x, u, mcfg, dtype=dt_, device=device)
    _, pot0 = md._pair_forces(s.x, mcfg)
    ke0 = float(md.kinetic_energy(s, mcfg))
    e0 = ke0 + float(pot0)
    for _ in range(200):
        s, pot = md.verlet_step(s, 0.005, mcfg)
    rec["md_drift"] = abs(float(md.kinetic_energy(s, mcfg)) + float(pot)
                          - e0) / ke0
    ck["MD energy drift < 1% of KE"] = rec["md_drift"] < 0.01
    ecfg = md.MdConfig(epsilon=1.656e-21, sigma=3.4e-10, mass=6.63e-26,
                       box=(2.14e-9,) * 3, r_cut=8.5e-10)
    x, u = md.lattice_fill(ecfg.box, 5, mass=ecfg.mass, T0=60.0, seed=2)
    s = md.make_state(x, u, ecfg, dtype=dt_, device=device)
    for _ in range(300):
        s, _ = md.equilibrate_step(s, 1e-14, ecfg, 120.0, relax=0.1)
    rec["md_T"] = float(md.temperature(s, ecfg))
    ck["MD equilibrates to 120 K"] = abs(rec["md_T"] - 120.0) < 12.0
    return rec, ck


ORACLE_LAG_BOX = """
convertToMeters 1;
vertices
(
    (0 0 0) (1 0 0) (1 1 0) (0 1 0)
    (0 0 1) (1 0 1) (1 1 1) (0 1 1)
);
blocks ( hex (0 1 2 3 4 5 6 7) (10 10 10) simpleGrading (1 1 1) );
boundary
(
    outlet { type patch; faces ((2 6 5 1)); }
    walls { type wall; faces ((0 4 7 3) (1 5 4 0) (3 7 6 2)
                              (0 3 2 1) (4 5 6 7)); }
);
"""


# tests/test_reactingcloud.py's and tests/test_discretemethods.py's box
ORACLE_WALL_BOX = ORACLE_LAG_BOX.replace(
    "    outlet { type patch; faces ((2 6 5 1)); }\n", "").replace(
    "walls { type wall; faces ((0 4 7 3)",
    "walls { type wall; faces ((2 6 5 1) (0 4 7 3)")


def phase_lagrangian(spmv, here, root, device=()):
    """The twelve tutorials of the Lagrangian slice as shipped, each
    through `python -m foamtpu_torch run -case <copy> -steps N` (LAG_RUNS,
    TOPO_RUNNER with lagrangian_case_summary), one process each, all at
    once (`device` ("-device", "cpu") rehearses on the CPU): their
    summaries against LAG_GOLDEN (the JAX package's; DSMC's random stream
    differs, so it is held to oracles), lag_oracles, their SpMV launches;
    then lag_unit_oracles in this process."""
    from foamtpu_torch.apps.cli import main as cli

    top = os.path.join(root, "lagrangian")
    os.makedirs(top)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               CHIP_SMOKE_SUMMARY="lagrangian_case_summary")
    procs = {}
    t0 = time.perf_counter()
    try:
        for name, steps in LAG_RUNS.items():
            d = slice17_case(here, os.path.join(top, name), name, cli,
                             edits=LAG_EDITS.get(name, ()))
            out = os.path.join(top, name + ".json")
            procs[name] = (subprocess.Popen(
                [sys.executable, "-c", TOPO_RUNNER, here, d, str(steps),
                 out, *device], cwd=here, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True), out)
        runs = {}
        for name, (proc, out) in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            check(proc.returncode == 0 and os.path.exists(out),
                  f"lagrangian {name}: exit {proc.returncode}: "
                  f"{stderr[-2000:]}")
            with open(out) as f:
                runs[name] = dict(json.load(f), log=stdout)
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    checks, worst = {}, {}
    for name, rec in runs.items():
        check("summary" in rec, f"lagrangian {name}: no summary")
        for k, ok in lag_oracles(name, rec, rec["log"]).items():
            checks[f"{name}: {k}"] = bool(ok)
        checks[f"{name}: spmv launched"] = (rec["launches"] > 0) == (
            name in PARCEL_APPS)
        if name in LAG_RANDOM:
            continue
        errs = lag_golden_errs(name, rec["summary"])
        checks[f"{name}: goldens"] = bool(LAG_GOLDEN.get(name)) and all(
            e <= t for e, t in errs.values())
        worst[name] = max(((e / t if t else (0.0 if e == 0 else
                                              float("inf")), k)
                           for k, (e, t) in errs.items()), default=None)
    t1 = time.perf_counter()
    unit, ck = lag_unit_oracles("cpu" if "cpu" in device else "cuda")
    checks.update({f"oracle: {k}": bool(v) for k, v in ck.items()})
    out = {"phase": "lagrangian", "wall_s": wall,
           "unit_oracles_s": time.perf_counter() - t1,
           "runs": {n: {"steps": LAG_RUNS[n], "summary": r["summary"],
                        "launches": r["launches"],
                        "fb_launches": r["fb_launches"],
                        "worst_golden_share": worst.get(n)}
                    for n, r in runs.items()},
           "unit_oracles": unit,
           "spmv_launches_total": sum(r["launches"] for r in runs.values()),
           "spmv_fb_launches_total": sum(r["fb_launches"]
                                         for r in runs.values()),
           "checks": checks}
    emit(out)
    for k, ok in checks.items():
        check(ok, f"lagrangian check {k}: {out}")
    return out


# lagrangian_headline: the paths at a size users run
LAG_HEAD_RPF = 512            # evaporationBox 512 x 512 = 262,144 cells
LAG_HEAD_RPF_STEPS = (2, 3, 1)   # warm-up, timed, profiled
LAG_HEAD_FALL = (64, 128, 64)    # fallingCloud: 524,288 cells
LAG_HEAD_FALL_PARCELS = 1 << 20
# 1.4 m/s at the terminal velocity is 7.2 cells of 7.8 mm in a step of
# 0.04 s: within the walk's 8 hops; 10 steps (0.4 s) are 2.7 settling times
LAG_HEAD_FALL_DT = 0.04
LAG_HEAD_FALL_STEPS = (2, 7, 1)
LAG_HEAD_DSMC = 64            # dsmcBox 64^3 = 262,144 cells
LAG_HEAD_DSMC_PER_CELL = 20   # ~5.2 million particles
LAG_HEAD_DSMC_STEPS = (1, 3, 1)
LAG_HEAD_MD_NSIDE = 32        # 32,768 molecules
LAG_HEAD_MD_STEPS = (2, 17, 1)
LAG_HEAD_SEED = 17


def rpf_big_case(here, dst, seed=LAG_HEAD_SEED):
    """evaporationBox at LAG_HEAD_RPF^2 (2D as shipped) with one parcel a
    cell, jittered within its cell from numpy's generator, in
    constant/reactingCloudPositions (the application sizes the cloud from
    it); the tutorial's constants. Not meshed. Returns dst."""
    n = LAG_HEAD_RPF
    slice17_case(here, dst, "reactingParcelFoam", None, blocks=(n, n, 1))
    rng = np.random.default_rng(seed)
    h = 0.2 / n
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    pos = np.stack([(i.ravel() + 0.5 + 0.8 * (rng.random(n * n) - 0.5)) * h,
                    (j.ravel() + 0.5 + 0.8 * (rng.random(n * n) - 0.5)) * h,
                    np.full(n * n, 0.01)], axis=1)
    write_positions(os.path.join(dst, "constant", "reactingCloudPositions"),
                    pos)
    return dst


def rpf_mesh_case(here, dst):
    """rpf_big_case's mesh alone (its blockMeshDict), for the premesh
    process."""
    return slice17_case(here, dst, "reactingParcelFoam", None,
                        blocks=(LAG_HEAD_RPF, LAG_HEAD_RPF, 1))


def fall_mesh_case(here, dst):
    """fall_big_case's mesh alone, for the premesh process."""
    return slice17_case(here, dst, "icoUncoupledKinematicParcelFoam", None,
                        blocks=LAG_HEAD_FALL)


def write_positions(path, pos):
    with open(path, "w") as f:
        f.write(_foam_header("vectorField", os.path.basename(path)))
        f.write(f"{len(pos)}\n(\n")
        np.savetxt(f, pos, fmt="(%.9g %.9g %.9g)")
        f.write(")\n")


def fall_big_case(here, dst, seed=LAG_HEAD_SEED):
    """fallingCloud at LAG_HEAD_FALL with LAG_HEAD_FALL_PARCELS parcels
    spread uniformly over the box above y = 0.6 m (they fall 0.35 m in
    the headline's 10 steps), deltaT LAG_HEAD_FALL_DT.
    Not meshed. Returns dst."""
    slice17_case(here, dst, "icoUncoupledKinematicParcelFoam", None,
                 blocks=LAG_HEAD_FALL,
                 edits=(("system/controlDict", r"deltaT 0\.005;",
                         f"deltaT {LAG_HEAD_FALL_DT!r};"),))
    rng = np.random.default_rng(seed)
    n = LAG_HEAD_FALL_PARCELS
    lo, hi = np.array([0.02, 0.6, 0.02]), np.array([0.48, 0.95, 0.48])
    write_positions(os.path.join(dst, "constant", "kinematicCloudPositions"),
                    lo + (hi - lo) * rng.random((n, 3)))
    return dst


def dsmc_big_case(here, dst):
    """dsmcBox at LAG_HEAD_DSMC^3 with nEquivalentParticles for
    LAG_HEAD_DSMC_PER_CELL particles a cell. Not meshed. Returns dst."""
    n = LAG_HEAD_DSMC
    fn = 1e20 / n ** 3 / LAG_HEAD_DSMC_PER_CELL
    return slice17_case(here, dst, "dsmcFoam", None, blocks=(n, n, n),
                        edits=(("constant/dsmcProperties",
                                r"nEquivalentParticles\s+[^;]+;",
                                f"nEquivalentParticles {fn!r};"),))


def md_big_case(here, dst):
    """nveBox with nSide LAG_HEAD_MD_NSIDE, the box scaled by nSide/5 to
    keep the tutorial's density. Returns dst (meshed by `cli` None: the
    caller's blockMesh)."""
    k = LAG_HEAD_MD_NSIDE
    return slice17_case(here, dst, "mdFoam", None, edits=(
        ("constant/polyMesh/blockMeshDict", r"convertToMeters\s+[^;]+;",
         f"convertToMeters {2.14e-9 * k / 5!r};"),
        ("system/mdInitialiseDict", r"nSide\s+5;", f"nSide {k};")))


class StepClock:
    """Times a run(case) from the inside: the set-up (run's start to its
    time loop's first step), each step from the loop's yield to the
    step's `Time = ` log line (after that step's host read), the SpMV
    launches per step, and one step under torch.profiler; `timed` names
    module attributes (module, name, key) whose calls are timed as set-up
    parts, their last results kept by name in `outputs`; every solve's
    iteration count is kept, and with `keep_matrices` the first step's
    matrices (dims, solver, matrix) in order; the log lines of MD's total
    energy in `energies`."""

    def __init__(self, spmv, case, profile_step, timed=(),
                 keep_matrices=False):
        self.spmv, self.case, self.profile_step = spmv, case, profile_step
        self.timed, self.keep = timed, keep_matrices
        self.starts, self.ends, self.parts, self.outputs = [], [], {}, {}
        self.matrices, self.solves, self.energies = [], [], []
        self.prof = None

    def __enter__(self):
        from foamtpu_torch.solvers import linear
        from foamtpu_torch.utils import logging as flog

        self._saved = [(flog, "info", flog.info),
                       (linear, "solve", linear.solve),
                       (self.case.time, "loop", self.case.time.loop)]
        for mod, name, key in self.timed:
            self._saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, self._timer(getattr(mod, name), name, key))
        orig_info, orig_solve = flog.info, linear.solve
        orig_loop = self.case.time.loop

        def info(msg, *a, **k):
            if isinstance(msg, str) and "total energy" in msg:
                self.energies.append(msg)
            if isinstance(msg, str) and msg.startswith("Time = ") and \
                    len(self.ends) < len(self.starts):
                torch.cuda.synchronize()
                self.ends.append((time.perf_counter(), self.spmv.LAUNCHES))
                if self.prof is not None and len(self.ends) == \
                        self.profile_step + 1:
                    self.prof.__exit__(None, None, None)
            return orig_info(msg, *a, **k)

        def solve(mesh, mat, psi, controls):
            data, perf = orig_solve(mesh, mat, psi, controls)
            if self.keep and len(self.starts) == 1:
                self.matrices.append((str(mat.dims),
                                      str(controls.get("solver")), mat))
            self.solves.append((len(self.starts), str(mat.dims),
                                perf.n_iterations))
            return data, perf

        def loop():
            from torch.profiler import ProfilerActivity, profile

            for t in orig_loop():
                torch.cuda.synchronize()
                self.starts.append((time.perf_counter(), self.spmv.LAUNCHES))
                if len(self.starts) == self.profile_step + 1:
                    self.prof = profile(activities=[ProfilerActivity.CPU,
                                                    ProfilerActivity.CUDA])
                    self.prof.__enter__()
                yield t

        flog.info, linear.solve, self.case.time.loop = info, solve, loop
        self.t0 = time.perf_counter()
        return self

    def _timer(self, fn, name, key):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            self.parts[key] = self.parts.get(key, 0.0) + (
                time.perf_counter() - t0)
            self.outputs[name] = out
            return out
        return wrapped

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)

    def record(self, warmup, n_parcels):
        """s/step of the timed steps (after `warmup`, before the
        profiled one), parcels per second, the set-up split, SpMV
        launches per step, and the profiled step's kernel launches,
        device ms and busy share."""
        secs = [e[0] - s[0] for s, e in zip(self.starts, self.ends)]
        lau = [e[1] - s[1] for s, e in zip(self.starts, self.ends)]
        timed = secs[warmup:self.profile_step]
        sps = float(np.median(timed))
        rec = {"steps": len(secs), "timed_steps": len(timed),
               "sec_per_step": sps,
               "sec_per_step_each": secs,
               "parcels_per_s": n_parcels / sps,
               "setup_s": self.starts[0][0] - self.t0,
               "setup_parts_s": dict(self.parts),
               "after_loop_s": self.t1 - self.ends[-1][0],
               "spmv_launches_per_step": lau,
               "krylov": {}}
        for i, dims, n in self.solves:
            rec["krylov"].setdefault(dims, []).append(int(n))
        if self.prof is not None:
            raw = RawProfile(self.prof)
            dev_ms, top, launches = raw.device_ms(), raw.top(8), raw.launches
            rec.update(profiled_step_s=secs[self.profile_step],
                       device_ms_per_step=dev_ms,
                       kernel_launches_per_step=launches,
                       busy_share=dev_ms / 1e3 / sps,
                       top_kernels_ms=top)
        return rec


def phase_lagrangian_headline(spmv, here, root, flush):
    """The Lagrangian paths at a size users run, each through run(case)
    (StepClock: warm-up, timed and one profiled step): reactingParcelFoam
    on evaporationBox at 512^2 with 262,144 parcels (the SpMV held to its
    plain version and timed at its p and its non-symmetric Yvapour
    operator), icoUncoupledKinematicParcelFoam on fallingCloud at
    64 x 128 x 64 with 1,048,576 parcels (held to the terminal velocity),
    dsmcFoam on dsmcBox at 64^3 with ~5.2 million particles (the DSMC
    oracles) and mdFoam with 32,768 molecules (the NVE drift). Meshes
    from the background process."""
    from foamtpu_torch import lagrangian as lag
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.core.dimensions import DimensionSet
    from foamtpu_torch.lagrangian import dsmc as ldsmc, md as lmd
    from foamtpu_torch.solvers import parcels
    from foamtpu_torch.solvers.apps import run

    top = os.path.join(root, "lag_head")
    runs, checks, cases = {}, {}, []
    max_err, timings = 0.0, []
    launches_total = fb_total = 0
    plan = (("reactingParcelFoam", rpf_big_case, LAG_HEAD_RPF_STEPS),
            ("icoUncoupledKinematicParcelFoam", fall_big_case,
             LAG_HEAD_FALL_STEPS),
            ("dsmcFoam", dsmc_big_case, LAG_HEAD_DSMC_STEPS),
            ("mdFoam", md_big_case, LAG_HEAD_MD_STEPS))
    for name, make_case, (warm, n_timed, n_prof) in plan:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        dst = make_case(here, os.path.join(top, name))
        t1 = time.perf_counter()
        case = Case(dst, device="cuda")
        got = premeshed(dict_key(blockmesh_dict(dst)))
        if got:
            case._poly, mesh_secs = got
        else:
            memory_mesh(case)
            mesh_secs = {}
        t2 = time.perf_counter()
        mesh = case.mesh
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        steps = warm + n_timed + n_prof
        clock = StepClock(spmv, case, warm + n_timed, keep_matrices=(
            name == "reactingParcelFoam"), timed=(
            (parcels, "_read_positions", "positions_parse_s"),
            (lag, "make_cloud", "cloud_init_s"),
            (ldsmc, "initialise", "cloud_init_s"),
            (lmd, "make_state", "cloud_init_s")))
        spmv.LAUNCHES = spmv.FB_LAUNCHES = 0
        progress("lagrangian_headline", f"{name}: files {t1 - t0:.1f} s, "
                 f"mesh {t2 - t1:.1f} s, to_device {t3 - t2:.1f} s")
        with quiet(), clock:
            run(case, max_steps=steps)
        progress("lagrangian_headline", f"{name}: run {clock.t1 - clock.t0:.1f}"
                 " s")
        launches_total += spmv.LAUNCHES
        fb_total += spmv.FB_LAUNCHES
        st = case.final_state
        host = (lambda t: t.detach().double().cpu().numpy()
                if isinstance(t, torch.Tensor) else t)
        summ = lagrangian_summary(st, mesh.v.double().cpu(), host)
        if name == "mdFoam":
            n_par = st["state"].x.shape[0]
        elif name == "dsmcFoam":
            c0 = clock.outputs["initialise"]
            n_par = int(c0.n_active)
        else:
            n_par = int(st["cloud"].active.shape[0])
        t4 = time.perf_counter()
        rec = clock.record(warm, n_par)
        progress("lagrangian_headline", f"{name}: summary "
                 f"{t4 - clock.t1:.1f} s, record {time.perf_counter() - t4:.1f} s")
        rec.update(n_cells=mesh.n_cells, n_parcels=n_par, summary=summ,
                   spmv_launches=spmv.LAUNCHES,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        rec["setup_parts_s"].update(mesh_secs, case_files_s=t1 - t0,
                                    mesh_s=t2 - t1, to_device_s=t3 - t2)
        ck = {"finite": summ["finite"], "steps": case.time.index == steps}
        if name == "reactingParcelFoam":
            ck.update({"262,144 parcels": n_par == LAG_HEAD_RPF ** 2,
                       "parcels alive": summ["n_active"] == n_par,
                       "Yvapour in (0, 1]": 0.0 < summ["Yv_max"] <= 1.0,
                       "latent heat cools the gas": summ["T_mean"] < 400.0,
                       "spmv launched": rec["spmv_launches"] > 0})
            # the first step's solves: p's PCG ones (the pressure matrix's
            # dimensions, kg/s, are Yvapour's too) and last Yvapour's
            mass = str(DimensionSet.of(1, 0, -1))
            mats = clock.matrices
            p_mat = next((m for d, sv, m in mats
                          if d == mass and sv == "PCG"), None)
            yv_mat = mats[-1][2] if mats and mats[-1][0] == mass else None
            ck["p and Yvapour matrices kept"] = (
                p_mat is not None and yv_mat is not None)
            check(ck["p and Yvapour matrices kept"],
                  f"rpf matrices: {[(d, sv) for d, sv, _ in mats]}")
            ops = [mat_operand(mesh, p_mat, "rpf_p"),
                   mat_operand(mesh, yv_mat, "rpf_Yv")]
            deltas = tuple(mesh.st_deltas)
            for dtype in (torch.float32, torch.float64):
                err = check_operands(spmv, ops, mesh, deltas, dtype,
                                     np.random.default_rng(171), cases)
                if dtype == torch.float32:
                    max_err = max(max_err, err)
            for i, (opname, soff, diag, sfb) in enumerate(ops):
                timings += time_shape(
                    spmv, opname, diag.contiguous(),
                    operand_x(diag, 172 + i), soff.contiguous(), deltas,
                    flush, fb=mesh_remainder(spmv, mesh, sfb, diag.dtype)
                    if mesh.fb_cells.shape[0] else None)
            ck["Yvapour operator non-symmetric"] = not yv_mat.symmetric
            ck["p operator symmetric"] = p_mat.symmetric
        elif name == "icoUncoupledKinematicParcelFoam":
            ut = stokes_terminal(2500.0, 2e-4, 1.2, 1.5e-5 * 1.2)
            ur = fall_replay(LAG_HEAD_FALL_DT, steps)
            u = st["cloud"].u[:, 1].double()
            rec["terminal"] = {"ut": ut, "replay": ur,
                               "share_of_ut": ur / ut,
                               "uy_mean": float(u.mean()),
                               "uy_min": float(u.min()),
                               "uy_max": float(u.max())}
            ck.update({"all parcels in": summ["n_active"] == n_par
                       == LAG_HEAD_FALL_PARCELS,
                       "every parcel at its drag law's fall 1e-4": float(
                           (u + ur).abs().max()) < 1e-4 * ur,
                       "it settles at the terminal velocity":
                       abs(fall_replay(LAG_HEAD_FALL_DT, 1000) - ut) / ut
                       < 1e-6})
        elif name == "dsmcFoam":
            ke0 = float((c0.u[c0.active].double() ** 2).sum())
            n_log = case.final_state["cloud"].n_active
            rec["ke_rel_change"] = abs(summ["ke_sum"] - ke0) / ke0
            ck.update({"count conserved": int(n_log) == n_par,
                       "~20 particles a cell": abs(n_par / mesh.n_cells
                                                   - 20.0) < 1.0,
                       "energy conserved 1e-4": rec["ke_rel_change"] < 1e-4,
                       "T near 300 K": abs(summ["dsmc_T_gas"] - 300.0)
                       < 15.0})
        else:
            E = [float(x) for x in re.findall(r"total energy = (\S+) J",
                                              "".join(clock.energies))]
            T = [float(x) for x in re.findall(r"temperature = (\S+) K",
                                              "".join(clock.energies))]
            ke0 = 1.5 * n_par * lmd.K_BOLTZ * T[0]
            rec["energy_drift_of_ke"] = abs(E[-1] - E[0]) / ke0
            ck.update({"32,768 molecules": n_par == LAG_HEAD_MD_NSIDE ** 3,
                       "energy drift < 1% of KE":
                       rec["energy_drift_of_ke"] < 0.01})
        runs[name] = rec
        checks.update({f"{name}: {k}": bool(v) for k, v in ck.items()})
        progress("lagrangian_headline", f"{name}: {rec['sec_per_step']:.4f}"
                 f" s/step, {n_par} parcels, set-up {rec['setup_s']:.1f} s")
        del case, st, mesh
    out = {"phase": "lagrangian_headline", "runs": runs,
           "kernel_cases": cases, "max_abs_err_f32": max_err,
           "timings": timings, "spmv_launches_total": launches_total,
           "spmv_fb_launches_total": fb_total, "checks": checks}
    emit(out)
    for k, ok in checks.items():
        check(ok, f"lagrangian_headline check {k}: {out}")
    return out, max_err, timings


# ---------------------------------------------------------------------------
# the boundary-condition layer and the solver-side utilities
# ---------------------------------------------------------------------------

BCU_TUTORIALS = {
    "pitz": PITZ_CASE,
    "cavity": os.path.join("tutorials", "incompressible", "icoFoam",
                           "cavity"),
    "dam": DAMBREAK_CASE,
    "dam_fine": DAMBREAK_CASE,
}
# pitzDaily's SIMPLE iterations from rest spread by 3.6% after 10
# between float32 and float64 (U_max); after 400 most of its scalars
# spread by well under 1%, p's by 1-2%: its run takes 400
BCU_STEPS = {"pitz": 400, "cavity": 20, "dam_fine": 20}
BCU_THETA0 = 45.0            # degrees, on damBreak's three walls
BCU_FINE_N = 92              # mapFields' target: damBreak at 92 x 92
BCU_FINE_DT = 0.0005         # its deltaT: the tutorial's Courant number
BCU_SEED = 18
_BCU_WALLS = r"(leftWall|rightWall|lowerWall)(\s*\{\s*type\s+)"


def bcu_contact_angle(d, p_rgh=False):
    """damBreak's three walls: constantAlphaContactAngle at BCU_THETA0 on
    0/alpha1 over their zeroGradient (or over the kind name the JAX
    package's writer leaves there: its setFields and mapFields write
    `alphaContactAngle` without its angle, ROADMAP Queue 3), and with
    `p_rgh` fixedFluxPressure on 0/p_rgh."""
    _edit(os.path.join(d, "0", "alpha1"),
          _BCU_WALLS + r"(zeroGradient|alphaContactAngle);",
          r"\1\2constantAlphaContactAngle; theta0 %r; limit gradient; "
          r"value uniform 0;" % BCU_THETA0)
    if p_rgh:
        _edit(os.path.join(d, "0", "p_rgh"), _BCU_WALLS + r"zeroGradient;",
              r"\1\2fixedFluxPressure; value uniform 0;")


def bcu_boundary_data(d, seed=BCU_SEED):
    """constant/boundaryData/movingWall of the cavity: its face centres as
    the sample points (read from the case's polyMesh on the host) and two
    rows of U, at 0 and 1 s, near (1 0 0), drawn from `seed`."""
    from foamtpu_torch.io import polymesh as mesh_io

    pm = mesh_io.read(os.path.join(d, "constant", "polyMesh"))
    wall = next(p for p in pm.patches if p.name == "movingWall")
    cf = pm.cf[wall.start:wall.start + wall.size]
    root = os.path.join(d, "constant", "boundaryData", "movingWall")
    rng = np.random.default_rng(seed)
    for tname, base in (("0", 1.0), ("1", 1.5)):
        os.makedirs(os.path.join(root, tname))
        vals = np.stack([base + 0.1 * rng.standard_normal(wall.size),
                         0.05 * rng.standard_normal(wall.size),
                         np.zeros(wall.size)], axis=1)
        with open(os.path.join(root, tname, "U"), "w") as f:
            f.write(f"{wall.size}\n(" + "\n".join(
                "(%r %r %r)" % tuple(map(float, v)) for v in vals) + ")\n")
    with open(os.path.join(root, "points"), "w") as f:
        f.write(f"{wall.size}\n(" + "\n".join(
            "(%r %r %r)" % tuple(map(float, p)) for p in cf) + ")\n")


def bcu_case(here, d, name, cli, device=()):
    """The cases of the `bc_utilities` phase, written to d and meshed by
    `cli` (the port's command line or the JAX package's), the same for
    the card and for the goldens:
    - pitz: simpleFoam's pitzDaily with the derived2 kinds: a
      uniformFixedValue inlet (U `constant`, k a `table`) and partialSlip
      walls;
    - cavity: icoFoam's cavity with a timeVaryingMappedFixedValue lid
      (bcu_boundary_data), a fieldMinMax function and a sampleDict;
    - dam: interFoam's damBreak (setFields) with the contact angle and
      fixedFluxPressure walls (bcu_contact_angle);
    - dam_fine: damBreak at BCU_FINE_N^2, its walls as dam's, the target
      of mapFields."""
    shutil.copytree(os.path.join(here, BCU_TUTORIALS[name]), d)
    if name == "pitz":
        _edit(os.path.join(d, "0", "U"),
              r"inlet\s*\{[^}]*\}", "inlet { type uniformFixedValue; "
              "uniformValue constant (10 0 0); }")
        _edit(os.path.join(d, "0", "U"), r"(upperWall|lowerWall)\s*\{[^}]*\}",
              r"\1 { type partialSlip; valueFraction uniform 0.5; }")
        _edit(os.path.join(d, "0", "k"), r"inlet\s*\{[^}]*\}",
              "inlet { type uniformFixedValue; uniformValue table "
              "((0 0.375) (2000 0.5)); }")
    if name == "cavity":
        _edit(os.path.join(d, "0", "U"), r"movingWall\s*\{[^}]*\}",
              "movingWall { type timeVaryingMappedFixedValue; "
              "value uniform (1 0 0); }")
        _edit(os.path.join(d, "system", "controlDict"),
              r"writeInterval\s+[^;]+;", "writeInterval 10;")
        with open(os.path.join(d, "system", "controlDict"), "a") as f:
            f.write("\nfunctions { minmax { type fieldMinMax; "
                    "fields (U p); } }\n")
        with open(os.path.join(d, "system", "sampleDict"), "w") as f:
            f.write("FoamFile { version 2.0; format ascii; class "
                    "dictionary; object sampleDict; }\nfields (U p);\n"
                    "sets\n(\n    centreline { type uniform; axis "
                    "distance; start (0.0025 0.0525 0.005); end (0.0975 "
                    "0.0525 0.005); nPoints 20; }\n);\n")
    if name == "dam_fine":
        _edit(os.path.join(d, "constant", "polyMesh", "blockMeshDict"),
              r"\(46 46 1\)", f"({BCU_FINE_N} {BCU_FINE_N} 1)")
        _edit(os.path.join(d, "system", "controlDict"),
              r"deltaT\s+[^;]+;", f"deltaT {BCU_FINE_DT!r};")
    with quiet():
        check(cli(["blockMesh", "-case", d]) == 0, f"{name}: blockMesh")
        if name == "dam":
            check(cli(["setFields", "-case", d, *device]) == 0,
                  f"{name}: setFields")
    if name == "cavity":
        bcu_boundary_data(d)
    if name in ("dam", "dam_fine"):
        bcu_contact_angle(d, p_rgh=True)
    return d


def bcu_chains(dirs):
    """The commands of each process, each a `python -m foamtpu_torch`
    command line, in the order a user runs them: checkMesh, the run, the
    post-processing; for damBreak checkMesh, mapFields onto the finer
    case (which writes its walls' angle back), its run and vorticity."""
    p, c, d, f = (dirs[k] for k in ("pitz", "cavity", "dam", "dam_fine"))
    return {
        "pitz": [["checkMesh", "-case", p],
                 ["run", "-case", p, "-steps", str(BCU_STEPS["pitz"])],
                 ["yPlusRAS", "-case", p], ["wallShearStress", "-case", p]],
        "cavity": [["run", "-case", c, "-steps", str(BCU_STEPS["cavity"])],
                   ["postProcess", "-case", c], ["vorticity", "-case", c],
                   ["Q", "-case", c], ["Lambda2", "-case", c],
                   ["sample", "-case", c], ["foamToVTK", "-case", c]],
        "dam": [["checkMesh", "-case", d],
                ["mapFields", d, "-case", f, "-sourceTime", "0"],
                ["run", "-case", f, "-steps", str(BCU_STEPS["dam_fine"])],
                ["vorticity", "-case", f]]}


# one case's chain in a process of its own, each command as `python -m
# foamtpu_torch <command>` runs it (runpy, as -m does) with its stdout
# kept; then the chain's summary (bcu_summary) and the SpMV launches
BCU_RUNNER = r"""
import contextlib, io, json, runpy, sys
here, name, chain_file, out = sys.argv[1:5]
device = sys.argv[5:]
sys.path.insert(0, here)
import chip_smoke
from foamtpu_torch.ops import spmv
with open(chain_file) as f:
    dirs, chain = json.load(f)
logs, rcs = [], []
for step in chain:
    buf = io.StringIO()
    sys.argv = ["foamtpu_torch", *step, *device]
    with contextlib.redirect_stdout(buf):
        try:
            runpy.run_module("foamtpu_torch", run_name="__main__",
                             alter_sys=True)
            rc = 0
        except SystemExit as e:
            rc = e.code or 0
    logs.append(buf.getvalue())
    rcs.append(rc)
rec = {"rcs": rcs, "summary": chip_smoke.bcu_summary(name, dirs, logs),
       "launches": spmv.LAUNCHES, "fb_launches": spmv.FB_LAUNCHES,
       "log_tail": logs[-1][-2000:]}
with open(out, "w") as f:
    json.dump(rec, f)
"""


def _bcu_internal(path, n):
    """A written field's internal values as float64 numpy ([n] or [n, 3]),
    read on the host by the port's dictionary parser (whatever its
    boundary kinds)."""
    from foamtpu_torch.io.fields import load_field_dict

    entry = load_field_dict(path)["internalField"]
    items = entry if isinstance(entry, list) else [entry]
    a = np.asarray([x for x in items if isinstance(
        x, (int, float, np.ndarray))][-1], dtype=np.float64)
    if any(str(x) == "uniform" for x in items):
        a = np.broadcast_to(a, (n,) + a.shape)
    return a


def _bcu_field_stats(out, d, t, name, v, tag=None):
    """min, max and volume-weighted mean of a written field (its
    magnitude for a vector, and its x mean)."""
    path = os.path.join(d, t, name)
    a = _bcu_internal(path, v.shape[0])
    tag = tag or name
    if a.ndim == 2:
        out[f"{tag}_xmean"] = float((a[:, 0] * v).sum() / v.sum())
        a = np.linalg.norm(a, axis=1)
    out[f"{tag}_min"] = float(a.min())
    out[f"{tag}_max"] = float(a.max())
    out[f"{tag}_mean"] = float((a * v).sum() / v.sum())


def _bcu_latest(d):
    times = [x for x in os.listdir(d)
             if re.fullmatch(r"[0-9.eE+-]+", x) and os.path.isdir(
                 os.path.join(d, x))]
    return max(times, key=float)


def _bcu_check_stats(out, log, tag):
    for key in ("nCells", "totalVolume", "maxNonOrtho", "maxSkewness"):
        m = re.search(rf"^\s+{key}: (\S+)", log, re.M)
        if m:
            out[f"{tag}_{key}"] = float(m.group(1))
    out[f"{tag}_ok"] = "Mesh OK." in log


def _bcu_log_stats(out, log):
    """foamLog (utils/foamlog.py) on the run's log: the number of series
    and the last initial residual of p (or p_rgh) and Ux."""
    from foamtpu_torch.utils import foamlog

    series = foamlog.parse(log)
    out["foamlog_series"] = len(series)
    for key in ("p", "p_rgh", "Ux"):
        if key in series:
            out[f"foamlog_{key}_last"] = float(series[key][-1][1])


def bcu_summary(name, dirs, logs):
    """The host scalars of a chain (bcu_chains) from what it wrote and
    printed: checkMesh's statistics, the run's final fields, each derived
    field's statistics, fieldMinMax's and sample's numbers, foamToVTK's
    fields and foamLog's series. The same for both packages' files."""
    from foamtpu_torch.io import polymesh as mesh_io

    out = {}
    if name == "pitz":
        d = dirs["pitz"]
        v = mesh_io.read(os.path.join(d, "constant", "polyMesh")).v
        _bcu_check_stats(out, logs[0], "checkMesh")
        t = _bcu_latest(d)
        out["time"] = float(t)
        for f in ("U", "p", "k", "nut", "yPlus", "wallShearStress"):
            _bcu_field_stats(out, d, t, f, v)
        _bcu_log_stats(out, logs[1])
    elif name == "cavity":
        d = dirs["cavity"]
        v = mesh_io.read(os.path.join(d, "constant", "polyMesh")).v
        t = _bcu_latest(d)
        out["time"] = float(t)
        for f in ("U", "p", "vorticity", "Q", "Lambda2"):
            _bcu_field_stats(out, d, t, f, v)
        rows = np.loadtxt(os.path.join(d, "postProcessing", "minmax",
                                       "fieldMinMax.dat"),
                          usecols=(0, 2, 3), ndmin=2)
        out["minmax_rows"] = int(rows.shape[0])
        out["minmax_last_sum"] = float(np.abs(rows[-4:, 1:]).sum())
        xy = os.path.join(d, "postProcessing", "sample", t,
                          "centreline_U_p.xy")
        s = np.loadtxt(xy, ndmin=2)
        out["sample_rows"] = int(s.shape[0])
        for j, k in enumerate(("Ux", "Uy", "p"), start=1):
            col = s[:, j] if k != "p" else s[:, -1]
            out[f"sample_{k}_sum"] = float(col.sum())
            out[f"sample_{k}_absmax"] = float(np.abs(col).max())
        with open(os.path.join(d, "VTK", f"cavity_{t}.vtk")) as fh:
            vtk = fh.read()
        names = re.findall(r"^(?:SCALARS|VECTORS) (\S+)", vtk, re.M)
        out["vtk_fields"] = " ".join(names)
        data = [ln for ln in vtk.split("CELL_DATA", 1)[1].splitlines()[1:]
                if ln and not ln[0].isalpha()]
        out["vtk_sum"] = float(np.abs(np.array(
            " ".join(data).split(), dtype=float)).sum())
        _bcu_log_stats(out, logs[0])
    else:
        d, f = dirs["dam"], dirs["dam_fine"]
        v = mesh_io.read(os.path.join(f, "constant", "polyMesh")).v
        _bcu_check_stats(out, logs[0], "checkMesh")
        for fld in ("alpha1", "U", "p_rgh"):
            _bcu_field_stats(out, f, "0", fld, v, f"mapped_{fld}")
        out["mapped_water"] = float((_bcu_internal(
            os.path.join(f, "0", "alpha1"), v.shape[0]) * v).sum())
        t = _bcu_latest(f)
        out["time"] = float(t)
        for fld in ("alpha1", "U", "p_rgh", "vorticity"):
            _bcu_field_stats(out, f, t, fld, v)
        out["water"] = float((_bcu_internal(
            os.path.join(f, t, "alpha1"), v.shape[0]) * v).sum())
        _bcu_log_stats(out, logs[2])
    return out


def bcu_perturb(d, seed=BCU_SEED, rel=1e-7, fields=("U", "p", "p_rgh")):
    """perturb_case's start for the 2D cases: `fields` of 0/ times (1 +
    rel n), plus rel^1.3 n' absolute, U's x and y only (a z component on
    a 2D mesh is not damped)."""
    from foamtpu_torch.core.case import Case

    case = Case(d, device="cpu")
    rng = np.random.default_rng(seed)
    for name in fields:
        if os.path.exists(os.path.join(d, "0", name)):
            f = case.read_field(name).data.double().numpy()
            g = f * (1.0 + rel * rng.standard_normal(f.shape)) \
                + rel ** 1.3 * rng.standard_normal(f.shape)
            if g.ndim == 2:
                g[:, 2] = f[:, 2]
            set_internal(d, name, g)


BCU_EXACT = ("time", "checkMesh_nCells", "checkMesh_ok", "foamlog_series",
             "minmax_rows", "sample_rows", "vtk_fields")
BCU_TOL_SPREAD = 10.0
BCU_TOL_FLOOR = 1e-4          # of the golden, or of its field's size
# a key whose tolerance passes this share of its field's size would let
# a fault of that size through: it is reported, and not held
BCU_HELD_SHARE = 0.05


def bcu_golden_errs(name, got):
    """({key: (error, tolerance)}, [keys reported and not held]) of a
    chain's summary against BCU_GOLDEN: the exact keys exactly, the rest
    within BCU_TOL_SPREAD times the JAX package's spread (BCU_SPREAD), at
    least BCU_TOL_FLOOR of the golden or of its field's largest value;
    a key whose tolerance is above BCU_HELD_SHARE of that (a field that
    is not zero) goes to the second list instead."""
    gold, spread = BCU_GOLDEN.get(name, {}), BCU_SPREAD.get(name, {})

    def field_scale(k):
        f = k.rsplit("_", 1)[0]
        return max((abs(gold.get(f"{f}_{x}", 0.0))
                    for x in ("min", "max", "mean")), default=0.0)

    out, loose = {}, []
    for k, g in gold.items():
        if k not in got:
            out[k] = (float("inf"), 0.0)
        elif k in BCU_EXACT or isinstance(g, (bool, str)):
            out[k] = (0.0 if got[k] == g else float("inf"), 0.0)
        else:
            size = max(abs(g), field_scale(k))
            tol = max(BCU_TOL_SPREAD * spread.get(k, 0.0),
                      BCU_TOL_FLOOR * size)
            if size > 0 and tol > BCU_HELD_SHARE * size:
                loose.append(k)
            else:
                out[k] = (abs(got[k] - g), tol)
    return out, loose


# goldens from the JAX package on the CPU (float32) of bcu_chains, and
# their spread under round-off (the larger of |float32 - float64| and
# |float32 from bcu_perturb's start - float32|): `PYTHONPATH=. python
# tests/test_torch_bc_derived.py goldens [--perturb]` (with FOAMTPU_X64=1
# JAX_ENABLE_X64=1 for float64), then `... spread f32.json f64.json
# perturbed.json`
BCU_GOLDEN = {
    'pitz': {
        'checkMesh_nCells': 4160.0,
        'checkMesh_totalVolume': 1.4700839999999998e-05,
        'checkMesh_maxNonOrtho': 5.75269297198271,
        'checkMesh_maxSkewness': 0.1005860461368241,
        'checkMesh_ok': True,
        'time': 400.0,
        'U_xmean': 5.3669443369318355,
        'U_min': 0.10417872749501414,
        'U_max': 11.007641955857048,
        'U_mean': 5.893179989941084,
        'p_min': -23.74430274963379,
        'p_max': 11.055577278137207,
        'p_mean': -4.409927571798231,
        'k_min': 0.0428609624505043,
        'k_max': 9.588323593139648,
        'k_mean': 1.6178841016114485,
        'nut_min': 3.486941568553448e-05,
        'nut_max': 0.007471128366887569,
        'nut_mean': 0.0017342880894922062,
        'yPlus_min': 0.0,
        'yPlus_max': 99.68775939941406,
        'yPlus_mean': 4.7740689202344555,
        'wallShearStress_xmean': 0.024329485125238512,
        'wallShearStress_min': 0.0,
        'wallShearStress_max': 1.4740411660790609,
        'wallShearStress_mean': 0.042159289319195645,
        'foamlog_series': 20,
        'foamlog_p_last': 0.0353329,
        'foamlog_Ux_last': 0.00124108,
    },
    'cavity': {
        'time': 0.1,
        'U_xmean': 0.0014125749972572004,
        'U_min': 0.0001865584608823564,
        'U_max': 0.9850099515980048,
        'U_mean': 0.19702422346027487,
        'p_min': -4.247920989990234,
        'p_max': 5.255427360534668,
        'p_mean': 0.02563273243937545,
        'vorticity_xmean': 0.0,
        'vorticity_min': 0.022891998291015625,
        'vorticity_max': 171.9424591064453,
        'vorticity_mean': 18.539212966514746,
        'Q_min': -8493.783203125,
        'Q_max': 644.4951171875,
        'Q_mean': -25.93608398714219,
        'Lambda2_min': -409.4146728515625,
        'Lambda2_max': 4917.82958984375,
        'Lambda2_mean': 9.408224978783101,
        'minmax_rows': 46,
        'minmax_last_sum': 20.97612288626,
        'sample_rows': 20,
        'sample_Ux_sum': -2.5245239810999998,
        'sample_Ux_absmax': 0.21670039,
        'sample_Uy_sum': -0.000222448999999951,
        'sample_Uy_absmax': 0.212129,
        'sample_p_sum': 0.322060471,
        'sample_p_absmax': 0.18510962,
        'vtk_fields': 'Lambda2 Q U p vorticity',
        'vtk_sum': 84734.7478165899,
        'foamlog_series': 16,
        'foamlog_p_last': 0.00050688,
        'foamlog_Ux_last': 0.000282989,
    },
    'dam': {
        'checkMesh_nCells': 2116.0,
        'checkMesh_totalVolume': 0.009958835199999998,
        'checkMesh_maxNonOrtho': 0.0,
        'checkMesh_maxSkewness': 1.7498352636180094e-14,
        'checkMesh_ok': True,
        'mapped_alpha1_min': 0.0,
        'mapped_alpha1_max': 1.0,
        'mapped_alpha1_mean': 0.13043478260869568,
        'mapped_U_xmean': 0.0,
        'mapped_U_min': 0.0,
        'mapped_U_max': 0.0,
        'mapped_U_mean': 0.0,
        'mapped_p_rgh_min': 0.0,
        'mapped_p_rgh_max': 0.0,
        'mapped_p_rgh_mean': 0.0,
        'mapped_water': 0.001298978504347826,
        'time': 0.01,
        'alpha1_min': -1.1005058843382987e-11,
        'alpha1_max': 1.0000228881835938,
        'alpha1_mean': 0.13043478319302768,
        'U_xmean': 0.0036176940678753857,
        'U_min': 0.00019708276107236033,
        'U_max': 0.46789611091828803,
        'U_mean': 0.03680135063658961,
        'p_rgh_min': -1.1742023229599,
        'p_rgh_max': 2762.38671875,
        'p_rgh_mean': 217.95562582397667,
        'vorticity_xmean': 0.0,
        'vorticity_min': 0.0,
        'vorticity_max': 108.5613021850586,
        'vorticity_mean': 0.4149162066002647,
        'water': 0.0012989785101670923,
        'foamlog_series': 3,
        'foamlog_p_rgh_last': 0.00274512,
    },
}
BCU_SPREAD = {
    'pitz': {
        'checkMesh_totalVolume': 0.0,
        'checkMesh_maxNonOrtho': 0.0,
        'checkMesh_maxSkewness': 0.0,
        'U_xmean': 6.90232037303673e-06,
        'U_min': 0.0027901762369763744,
        'U_max': 0.02394244985979377,
        'U_mean': 0.003323846898333649,
        'p_min': 0.3222989208923721,
        'p_max': 0.15926003696383617,
        'p_mean': 0.24982326364119345,
        'k_min': 0.0007755343994159183,
        'k_max': 0.035093223877607826,
        'k_mean': 0.004799652015487821,
        'nut_min': 3.055902197957039e-10,
        'nut_max': 2.4307375075207326e-05,
        'nut_mean': 4.6292901898956854e-06,
        'yPlus_min': 0.0,
        'yPlus_max': 0.15442310170230655,
        'yPlus_mean': 0.0025351232882755426,
        'wallShearStress_xmean': 2.438162568363378e-05,
        'wallShearStress_min': 0.0,
        'wallShearStress_max': 0.00012871499658895225,
        'wallShearStress_mean': 4.165499404713835e-05,
        'foamlog_p_last': 0.0008208000000000035,
        'foamlog_Ux_last': 6.379999999999841e-06,
    },
    'cavity': {
        'U_xmean': 1.9094022676337252e-08,
        'U_min': 1.4556872314906602e-07,
        'U_max': 4.0865304251624934e-08,
        'U_mean': 1.9060938966086738e-08,
        'p_min': 1.239776611328125e-05,
        'p_max': 1.2044196409100039e-05,
        'p_mean': 1.0731113856441571e-05,
        'vorticity_xmean': 0.0,
        'vorticity_min': 7.3909759521484375e-06,
        'vorticity_max': 1.0130112571005156e-06,
        'vorticity_mean': 7.052875972135553e-07,
        'Q_min': 0.002088306409859797,
        'Q_max': 0.00146484375,
        'Q_mean': 7.08844162389255e-06,
        'Lambda2_min': 0.0007686869290637333,
        'Lambda2_max': 0.0010586730995783,
        'Lambda2_mean': 1.9686130489304787e-05,
        'minmax_last_sum': 1.748670001688879e-06,
        'sample_Ux_sum': 7.270000010883848e-07,
        'sample_Ux_absmax': 7.000000001866624e-08,
        'sample_Uy_sum': 1.29999999980146e-07,
        'sample_Uy_absmax': 6.00000000239298e-08,
        'sample_p_sum': 0.0002185699999999735,
        'sample_p_absmax': 1.1979999999994773e-05,
        'vtk_sum': 0.011302315702778287,
        'foamlog_p_last': 2.386999999999962e-06,
        'foamlog_Ux_last': 3.299999999997749e-08,
    },
    'dam': {
        'checkMesh_totalVolume': 0.0,
        'checkMesh_maxNonOrtho': 0.0,
        'checkMesh_maxSkewness': 0.0,
        'mapped_alpha1_min': 0.0,
        'mapped_alpha1_max': 0.0,
        'mapped_alpha1_mean': 0.0,
        'mapped_U_xmean': 1.9754053536159073e-11,
        'mapped_U_min': 9.810848336813713e-12,
        'mapped_U_max': 3.2626522515562737e-09,
        'mapped_U_mean': 1.0207170492019927e-09,
        'mapped_p_rgh_min': 2.4549298149878496e-09,
        'mapped_p_rgh_max': 2.572163593228538e-09,
        'mapped_p_rgh_mean': 1.3824675596927825e-11,
        'mapped_water': 0.0,
        'alpha1_min': 1.1005058843382772e-11,
        'alpha1_max': 1.5040423064771602e-06,
        'alpha1_mean': 5.843320272092001e-10,
        'U_xmean': 1.0012222740062287e-05,
        'U_min': 6.236708305370079e-05,
        'U_max': 1.3321977354208148e-05,
        'U_mean': 7.639449993365743e-07,
        'p_rgh_min': 0.001247906595940984,
        'p_rgh_max': 0.0016284404091493343,
        'p_rgh_mean': 0.0013809755313900496,
        'vorticity_xmean': 0.0,
        'vorticity_min': 6.299111579566308e-11,
        'vorticity_max': 0.005061203115943158,
        'vorticity_mean': 0.00021643826882433714,
        'water': 5.8192665096379326e-12,
        'foamlog_p_rgh_last': 5.070000000000248e-06,
    },
}


def phase_bc_utilities(spmv, here, root, device=()):
    """The boundary-condition layer and the utilities end to end: the
    cases of bcu_case, each chain of bcu_chains in a process of its own
    (BCU_RUNNER), all at once on the card (`device` adds its flags to
    every command: ("-device", "cpu") rehearses the phase on the CPU);
    each summary against BCU_GOLDEN, every command's exit code, the
    SpMV launches of the runs."""
    from foamtpu_torch.apps.cli import main as cli

    top = os.path.join(root, "bcu")
    os.makedirs(top)
    dirs = {n: os.path.join(top, n) for n in BCU_TUTORIALS}
    t0 = time.perf_counter()
    for n, d in dirs.items():
        bcu_case(here, d, n, cli, device)
    setup_s = time.perf_counter() - t0
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {}
    t0 = time.perf_counter()
    try:
        for name, chain in bcu_chains(dirs).items():
            chain_file = os.path.join(top, name + ".chain.json")
            with open(chain_file, "w") as f:
                json.dump([dirs, chain], f)
            out = os.path.join(top, name + ".json")
            procs[name] = (subprocess.Popen(
                [sys.executable, "-c", BCU_RUNNER, here, name, chain_file,
                 out, *device], cwd=here, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True), out)
        runs = {}
        for name, (proc, out) in procs.items():
            _, stderr = proc.communicate(timeout=600)
            check(proc.returncode == 0 and os.path.exists(out),
                  f"bc_utilities {name}: exit {proc.returncode}: "
                  f"{stderr[-2000:]}")
            with open(out) as f:
                runs[name] = json.load(f)
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    checks, worst, loose = {}, {}, {}
    for name, rec in runs.items():
        checks[f"{name}: every command exits 0"] = all(
            rc == 0 for rc in rec["rcs"])
        errs, loose[name] = bcu_golden_errs(name, rec["summary"])
        checks[f"{name}: goldens"] = bool(BCU_GOLDEN.get(name)) and all(
            e <= t for e, t in errs.values())
        checks[f"{name}: spmv launched"] = rec["launches"] > 0
        worst[name] = max(((e / t if t else (0.0 if e == 0 else
                                              float("inf")), k)
                           for k, (e, t) in errs.items()), default=None)
    out = {"phase": "bc_utilities", "setup_s": setup_s, "wall_s": wall,
           "runs": {n: {"commands": bcu_chains(dirs)[n],
                        "rcs": r["rcs"], "summary": r["summary"],
                        "launches": r["launches"],
                        "fb_launches": r["fb_launches"],
                        "worst_golden_share": worst[n],
                        "reported_not_held": loose[n]}
                    for n, r in runs.items()},
           "spmv_launches_total": sum(r["launches"] for r in runs.values()),
           "spmv_fb_launches_total": sum(r["fb_launches"]
                                         for r in runs.values()),
           "checks": checks}
    emit(out)
    for k, ok in checks.items():
        check(ok, f"bc_utilities check {k}: {out}")
    return out


# phase_duct's host mesh and its state after the timed iterations, and
# phase_dambreak's 736^2 mesh and case directory, kept for
# utilities_headline
HEAD_KEEP = {}
# the renumbered duct's fields against the duct's after the same
# DUCT_CHUNK * (DUCT_TRIALS + 1) = 20 iterations, relative to each
# field's largest value: each p solve stops at relTol 0.01 and the two
# orderings build different GAMG hierarchies (pairwise agglomeration
# follows the cell order), so the iterates differ by what a p solve
# leaves, which shrinks as the runs converge. p on an H100 at the full
# 96 x 32 x 32 x 6: 3.9e-2 after 5 iterations, 5.2e-3 after 20; on the
# CPU at 48 x 16 x 16 x 6, `python tests/test_torch_utilities.py rcm 48
# 16 16 20`. A wrong order or mapping moves a field by its own size
DUCT_RCM_TOL = 1e-2
DAMBREAK_ANGLE_PROFILE = 2
DAMBREAK_ANGLE_TRIALS = 2     # phase_dambreak's trials at 736^2
# the corrected interface normals at the wall faces of the contact line
# against theta0: the rotation of _correct_contact_angle is exact up to
# its clip of nHat.n_wall at 1 - 1e-6 and float32 round-off
DAMBREAK_ANGLE_TOL = 1e-3   # radians


def duct_rcm_premesh(dims):
    """The premesh job "duct_rcm": bench.py's duct renumbered as
    duct_rcm renumbers it and the GAMG hierarchy of the result (minutes of
    host numpy: RCM leaves the pairwise agglomeration 24 slowly coarsening
    levels), built on the host's CPU: ((order, levels), seconds)."""
    from foamtpu_torch.mesh import renumber, to_device
    from foamtpu_torch.mesh.tetmesh import tet_box
    from foamtpu_torch.solvers.linear.gamg import hierarchy_for_mesh

    new, order = renumber.renumber(tet_box(*dims, size=(4.0, 1.0, 1.0)))
    t0 = time.perf_counter()
    levels = hierarchy_for_mesh(to_device(new, "cpu"))
    return (order, levels), {"gamg_hierarchy_s": time.perf_counter() - t0}


def duct_rcm(spmv, flush):
    """(a) bench.py's duct renumbered by reverse Cuthill-McKee in process
    (mesh/renumber.py::renumber on phase_duct's host mesh), checked
    (mesh/check.py), through duct_setup and the same iterations as
    phase_duct; its p operand held to the plain version and timed."""
    from foamtpu_torch.mesh import renumber
    from foamtpu_torch.mesh.check import check as check_mesh
    from foamtpu_torch.mesh.tetmesh import coo_fraction
    from foamtpu_torch.solvers import simple

    from foamtpu_torch.convert import levels_from_numpy

    pm = HEAD_KEEP.pop("duct_pm")
    ref = HEAD_KEEP.pop("duct_fields")
    t0 = time.perf_counter()
    bw0 = renumber.bandwidth(pm)
    new, order = renumber.renumber(pm)
    rcm_s = time.perf_counter() - t0
    bw1 = renumber.bandwidth(new)
    t0 = time.perf_counter()
    stats = check_mesh(new)
    check_s = time.perf_counter() - t0
    del pm
    # the hierarchy of the same renumbering, built in the background
    # process (or here, without one)
    pre = premeshed("duct_rcm")
    levels = None
    if pre:
        (order_bg, levels), bg = pre
        check(np.array_equal(order_bg, order),
              "the background renumbering differs from the process's")
        levels = levels_from_numpy(levels, "cuda")
    torch.cuda.reset_peak_memory_stats()
    launches0, fb0 = spmv.LAUNCHES, spmv.FB_LAUNCHES
    t0 = time.perf_counter()
    mesh, cfg, state, setup = duct_setup(*DUCT, device="cuda", pm=new,
                                         levels=levels)
    setup_s = time.perf_counter() - t0
    if pre:
        setup.update(gamg_hierarchy_background=bg["gamg_hierarchy_s"],
                     premesh_wait=bg["premesh_wait_s"])
    step = simple.make_step(mesh, cfg)
    # phase_duct's iterations: a warm-up chunk whose first iteration goes
    # to SolveLog, then DUCT_TRIALS timed chunks
    with SolveLog(state) as log:
        state, diags = run_iterations(step, state, 1)
    state, more = run_iterations(step, state, DUCT_CHUNK - 1)
    diags += more
    torch.cuda.synchronize()
    la, fa = spmv.LAUNCHES, spmv.FB_LAUNCHES
    times = []
    for _ in range(DUCT_TRIALS):
        t0 = time.perf_counter()
        state, more = run_iterations(step, state, DUCT_CHUNK)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / DUCT_CHUNK)
        diags += more
    records = [iteration_record(d) for d in diags]
    n_timed = DUCT_CHUNK * DUCT_TRIALS
    got = duct_fields(state)
    o = torch.as_tensor(order, device=mesh.device)
    errs = {}
    for k, a in got.items():
        back = torch.empty_like(a)
        back[o] = a
        errs[k] = float(torch.max(torch.abs(back - ref[k]))
                        / torch.max(torch.abs(ref[k])))
    del ref
    # the kernel at the renumbered p operand
    ops = [op for op in solve_operands(log, mesh, "duct_rcm")
           if op[0] == "duct_rcm_p"]
    deltas = tuple(mesh.st_deltas)
    cases = []
    max_err = 0.0
    for dtype in (torch.float32, torch.float64):
        err = check_operands(spmv, ops, mesh, deltas, dtype,
                             np.random.default_rng(4), cases)
        if dtype == torch.float32:
            max_err = err
    name, soff, diag, sfb = ops[0]
    soff, diag = soff.contiguous(), diag.contiguous()
    timings = time_shape(spmv, name, diag, operand_x(diag, 31), soff,
                         deltas, flush,
                         fb=mesh_remainder(spmv, mesh, sfb, diag.dtype))
    p_iters = [r["iters"]["p"] for r in records]
    out = {"rcm_s": rcm_s, "bandwidth": [bw0, bw1],
           "check_s": check_s, "check": stats,
           "coo_fraction": coo_fraction(mesh),
           "n_coo": int(mesh.fb_cells.shape[0]),
           "st_deltas": list(mesh.st_deltas),
           "gamg_level_sizes": [mesh.n_cells] + [
               lv.n_coarse for lv in cfg.p_controls["_gamg"].levels],
           "setup_s": setup_s, "setup_split_s": setup,
           "sec_per_iter": statistics.median(times),
           "trial_sec_per_iter": times, "iterations": len(records),
           "p_gamg_cycles": p_iters,
           "spmv_launches_per_iter": (spmv.LAUNCHES - la) / n_timed,
           "spmv_fb_launches_per_iter": (spmv.FB_LAUNCHES - fa) / n_timed,
           "field_rel_err_vs_duct": errs,
           "field_tolerance": DUCT_RCM_TOL,
           "continuity": records[-1]["continuity"],
           "kernel_cases": cases, "timings": timings,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    checks = {"checkMesh totals": stats["nCells"] == mesh.n_cells
              and stats["maxCellOpenness"] < 1e-8,
              "bandwidth falls": bw1 < bw0,
              "finite": all(bool(torch.isfinite(a).all())
                            for a in got.values()),
              "p converged": all(i < cfg.p_controls["maxIter"]
                                 for i in p_iters),
              "fields as the duct's (DUCT_RCM_TOL)": all(
                  e <= DUCT_RCM_TOL for e in errs.values()),
              "spmv launched": out["spmv_launches_per_iter"] > 0,
              "remainder fused": out["spmv_fb_launches_per_iter"] > 0}
    return out, checks, (mesh, cfg, state), max_err, timings, \
        (spmv.LAUNCHES - launches0, spmv.FB_LAUNCHES - fb0)


def postutils_at_width(mesh, state, flush):
    """(c) the postutils commands' fields (vorticity, Q, Lambda2) on the
    renumbered duct's U at width: device ms a command (torch.profiler,
    L2 flushed), checked finite."""
    from foamtpu_torch.apps import postutils
    from foamtpu_torch.ops import fvc

    U = state["U"]
    fns = {"vorticity": lambda: fvc.curl(mesh, U),
           "Q": lambda: postutils.q_field(mesh, U),
           "Lambda2": lambda: postutils.lambda2_field(mesh, U)}
    out = {}
    for name, fn in fns.items():
        f = fn()
        torch.cuda.synchronize()
        out[name] = {"device_ms": device_ms(fn, flush, reps=5, trials=1),
                     "finite": bool(torch.isfinite(f).all()),
                     "absmax": float(torch.max(torch.abs(f)))}
    return out


def dambreak_angle(spmv, here, root):
    """(b) phase_dambreak's 736^2 case (its mesh and setFields start) with
    constantAlphaContactAngle at BCU_THETA0 on its walls and nothing else
    changed, so that phase_dambreak's run is its control: a warm-up
    through the application, phase_dambreak's timed chunks of its own
    step and one profiled chunk (the phase's one profile, last); alpha's
    bounds and the water volume (dambreak_invariants), the left column's
    fill against the control's after the same steps, and the corrected
    interface normals at the contact line against theta0."""
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.models import interface as iface
    from foamtpu_torch.ops import fvc, surface
    from foamtpu_torch.solvers import interfoam
    from foamtpu_torch.solvers.apps import _inter_config, run

    src, pm = HEAD_KEEP.pop("dambreak_dir"), HEAD_KEEP.pop("dambreak_pm")
    n = int(round(pm.n_cells ** 0.5))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dst = os.path.join(root, f"damBreakAngle{n}")
    os.makedirs(os.path.join(dst, "constant"))
    for sub in ("0", "system"):
        shutil.copytree(os.path.join(src, sub), os.path.join(dst, sub))
    for f in os.listdir(os.path.join(src, "constant")):
        s = os.path.join(src, "constant", f)
        if f == "polyMesh":
            os.symlink(s, os.path.join(dst, "constant", f))
        else:
            shutil.copy(s, os.path.join(dst, "constant", f))
    bcu_contact_angle(dst)
    case = Case(dst, device="cuda")
    case._poly = pm
    mesh = case.mesh
    alpha0 = case.read_field("alpha1").data.clone()
    kinds = [bc.kind for bc in case.read_field("alpha1").bcs]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    launches0, fb0 = spmv.LAUNCHES, spmv.FB_LAUNCHES
    t0 = time.perf_counter()
    with quiet():
        run(case, max_steps=DAMBREAK_BIG_WARMUP)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    dt = case.time.delta_t
    cfg = _inter_config(case)
    step = interfoam.make_step(mesh, cfg)
    state = case.final_state

    def chunk(state, n_steps):
        diags = []
        for _ in range(n_steps):
            state, diag = step(state, dt)
            diags.append(diag)
        return state, diags

    # phase_dambreak's timed chunks, the same steps from the same start
    la = spmv.LAUNCHES
    times = []
    with SolveLog(state) as log:
        for _ in range(DAMBREAK_ANGLE_TRIALS):
            t0 = time.perf_counter()
            state, diags = chunk(state, DAMBREAK_BIG_CHUNK)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) / DAMBREAK_BIG_CHUNK)
    sec = statistics.median(times)
    launches_timed = spmv.LAUNCHES - la
    p_iters = [int(i) for i in log.iterations["p"]]
    # the left column's fill here and in phase_dambreak's run without the
    # angle, after the same steps
    steps_plain, fill_plain = HEAD_KEEP.pop("dambreak_fill")
    steps = DAMBREAK_BIG_WARMUP + DAMBREAK_BIG_CHUNK * DAMBREAK_ANGLE_TRIALS
    fill = dambreak_invariants(mesh, alpha0, state)[0]["left_column_fill"]

    def profiled(state):
        state, diags = chunk(state, DAMBREAK_ANGLE_PROFILE)
        return state, diags[-1]

    state, prof = profile_chunk(spmv, "dambreak_angle_profile", mesh,
                                profiled, state, DAMBREAK_ANGLE_PROFILE, sec)
    inv, checks = dambreak_invariants(mesh, alpha0, state)
    # the wall faces of the contact line: the corrected normals there
    alpha = state["alpha"]
    g = fvc.grad(mesh, alpha)
    gb = surface.owner_to_b(mesh, g)
    gf = torch.cat([surface.interpolate_internal(mesh, g), gb], dim=0)
    nhat = gf / (torch.linalg.vector_norm(gf, dim=1)
                 + 1e-8 / torch.mean(torch.pow(mesh.v, 1.0 / 3.0)))[:, None]
    turned = iface._correct_contact_angle(mesh, alpha, nhat)
    dev, before, faces = [], [], 0
    # the contact line: wall faces whose cell lies in the interface band
    # (|grad alpha| above a tenth of its largest value)
    gn = torch.linalg.vector_norm(g, dim=1)
    band = gn > 0.1 * gn.max()
    for p, bc in zip(mesh.patches, alpha.bcs):
        if bc.kind != "alphaContactAngle":
            continue
        sl = p.slice
        line = band[mesh.owner[sl]]
        nf = mesh.sf[sl] / mesh.mag_sf[sl][:, None]
        cos_t = torch.clamp(torch.sum(turned[sl] * nf, dim=1), -1, 1)
        cos_0 = torch.clamp(torch.sum(nhat[sl] * nf, dim=1), -1, 1)
        dev.append(torch.abs(torch.arccos(cos_t[line])
                             - np.radians(BCU_THETA0)))
        before.append(torch.abs(torch.arccos(cos_0[line])
                                - np.radians(BCU_THETA0)))
        faces += int(line.sum())
    dev, before = torch.cat(dev), torch.cat(before)
    n_timed = DAMBREAK_BIG_CHUNK * DAMBREAK_ANGLE_TRIALS
    out = {"n_cells": mesh.n_cells, "setup_s": setup_s, "warmup_s": warm_s,
           "alpha1_wall_kinds": kinds, "sec_per_step": sec,
           "trial_sec_per_step": times, "chunk_steps": DAMBREAK_BIG_CHUNK,
           "spmv_launches_per_step": launches_timed / n_timed,
           "cuda_launch_kernel_per_step": prof["cuda_launch_kernel_per_iter"],
           "device_ms_per_step": prof["device_ms_per_iter"],
           "device_busy_share": prof["device_busy_share_unprofiled"],
           "p_rgh_iterations": p_iters,
           "p_rgh_solves_at_max_iter": sum(
               i >= max_iter(cfg.p_controls) for i in p_iters),
           "left_column_fill": {"steps": steps, "with_angle": fill,
                                "without_angle": fill_plain,
                                "without_angle_steps": steps_plain},
           "contact_line_faces": faces,
           "angle_err_max_rad": float(dev.max()) if faces else None,
           "angle_err_uncorrected_max_rad":
               float(before.max()) if faces else None,
           "invariants": inv,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    # a wall at theta0 < 90 degrees wets: the water climbs the left wall,
    # so the column's first cells fill above the run's without the angle
    # (90 degrees leaves them as that run does, 135 below it:
    # tests/test_torch_bc_derived.py::test_contact_angle_moves_the_left_column_fill)
    del checks["column falls"]
    checks["the left wall wets (fill above the run's without the angle)"] \
        = steps == steps_plain and fill > fill_plain
    checks["the walls carry the angle"] = kinds.count(
        "alphaContactAngle") == 3
    checks["contact line found"] = faces > 0
    checks["normals at theta0 (DAMBREAK_ANGLE_TOL)"] = faces > 0 and \
        float(dev.max()) <= DAMBREAK_ANGLE_TOL
    checks["spmv launched"] = out["spmv_launches_per_step"] > 0
    return out, checks, (spmv.LAUNCHES - launches0,
                         spmv.FB_LAUNCHES - fb0)


def phase_utilities_headline(spmv, here, root, flush, duct):
    """The utilities at full width: (a) bench.py's duct renumbered
    (duct_rcm), beside phase_duct's run (`duct`: its record); (c) the
    postutils fields on its state; (b) damBreak's contact angle at 736^2
    (dambreak_angle, whose profile comes last)."""
    spmv.LAUNCHES = spmv.FB_LAUNCHES = 0
    rcm, checks, (mesh, cfg, state), max_err, timings, _ = duct_rcm(
        spmv, flush)
    # the duct over the same iterations: s/iter of its timed chunks
    rcm["duct"] = {k: duct[k] for k in ("coo_fraction", "n_coo",
                                        "sec_per_iter",
                                        "trial_sec_per_iter")}
    rcm["duct"]["p_gamg_cycles"] = [r["iters"]["p"]
                                    for r in duct["per_iteration"]]
    post = postutils_at_width(mesh, state, flush)
    for name, r in post.items():
        checks[f"{name} finite"] = r["finite"]
    del mesh, cfg, state
    torch.cuda.empty_cache()
    dam, dam_checks, _ = dambreak_angle(spmv, here, root)
    checks.update({f"damBreak {k}": v for k, v in dam_checks.items()})
    out = {"phase": "utilities_headline",
           "duct_rcm": rcm,
           "postutils": post, "dambreak_angle": dam,
           "spmv_launches_total": spmv.LAUNCHES,
           "spmv_fb_launches_total": spmv.FB_LAUNCHES,
           "max_abs_err_f32": max_err, "checks": checks}
    emit(out)
    for k, ok in checks.items():
        check(ok, f"utilities_headline check {k}: {out}")
    return out, max_err, timings


# ---------------------------------------------------------------------------
# slice 20: the reference's own cli.py table (mesh manipulation, importers,
# surface and thermo tools) and corrected non-orthogonal PISO
# ---------------------------------------------------------------------------

CAVITY_CASE = os.path.join("tutorials", "incompressible", "icoFoam", "cavity")
MESH_CHAIN_HEAD = (192, 384)      # the left half: 368,640 cells in the end
MESH_CHAIN_STEPS = 20             # a warm-up chunk of 10 and a timed one
MESH_CHAIN_CHUNK = 10
MESH_CHAIN_LID = 0.5              # m/s, the lid
# the cavity at convertToMeters 1 (1 m), 10x the tutorial's: refineMesh
# reads a uniform box with cells under ~1 mm as graded and refuses it, in
# both packages (ROADMAP Queue 3). Re as at 0.1 m with nu 0.005
MESH_CHAIN_NU = 0.05              # changeDictionary's nu: Re 10, as shipped
# Co ~0.19 in the finest cells at the lid: at ~0.4 (deltaT 1e-3) an odd-even
# oscillation grows from the first steps in the JAX package, float32 and
# float64, to |U| 3 m/s under the 0.5 m/s lid by step 20 (ROADMAP Queue 3)
MESH_CHAIN_DT = 5e-4
MESH_CHAIN_CMDS = (["blockMesh"], ["topoSet"], ["refineMesh"],
                   ["mirrorMesh"], ["changeDictionary"], ["checkMesh"])
_CHAIN_DICTS = {
    "topoSetDict": "actions\n(\n    { name fine; type cellSet; action new; "
                   "source boxToCell;\n      sourceInfo { box (-1 0.5 -1) "
                   "(2 2 2); } }\n);\n",
    "refineMeshDict": "set fine;\n",
    "mirrorMeshDict": "planeType pointAndNormal;\npointAndNormalDict\n{\n"
                      "    basePoint (0.5 0 0);\n    normalVector (1 0 0);"
                      "\n}\n",
    # the reference's changeDictionary writes every file it changes as a
    # volScalarField or a dictionary, so a changed 0/U no longer reads back
    # as a vector field in either package (ROADMAP Queue 3): the chain
    # changes transportProperties' nu instead, and the case sets the lid
    "changeDictionaryDict": "dictionaryReplacement\n{\n"
                            "    transportProperties\n    {\n"
                            "        nu nu [0 2 -1 0 0 0 0] %r;\n    }\n}\n"
                            % MESH_CHAIN_NU}


# the shipped p controls (PCG with DIC, which both packages take as
# diagonal, at 1e-6) stop at their 1,000 iterations from the first step at
# 368,640 cells, 0.01-0.35 of the initial residual, and the JAX package's
# run diverges by step 20: the card's case takes bench.py's GAMG controls
MESH_CHAIN_GAMG = ("p { solver GAMG; preconditioner polynomial; "
                   "tolerance 1e-7; relTol 0.01; maxIter 1000; }")


def mesh_chain_case(here, dst, blocks=MESH_CHAIN_HEAD, gamg=True):
    """The icoFoam cavity at convertToMeters 1 cut to its left half (x
    in [0, 0.5] m) at `blocks`, with the dictionaries of the mesh chain
    (MESH_CHAIN_CMDS): topoSet's cellSet `fine` over the top half (y > 0.5
    m), refineMesh of that set, mirrorMesh about x = 0.5 m,
    changeDictionary's nu
    MESH_CHAIN_NU; the lid at MESH_CHAIN_LID, corrected laplacian and
    snGrad schemes, PISO with one non-orthogonal corrector, deltaT
    MESH_CHAIN_DT, p by MESH_CHAIN_GAMG (with `gamg`; else the shipped
    PCG). Returns dst (not meshed)."""
    shutil.copytree(os.path.join(here, CAVITY_CASE), dst)
    bmd = os.path.join(dst, "constant", "polyMesh", "blockMeshDict")
    for a, b in (("(1 0 0)", "(0.5 0 0)"), ("(1 1 0)", "(0.5 1 0)"),
                 ("(1 0 0.1)", "(0.5 0 0.1)"), ("(1 1 0.1)", "(0.5 1 0.1)"),
                 ("(20 20 1)", f"({blocks[0]} {blocks[1]} 1)"),
                 ("convertToMeters 0.1;", "convertToMeters 1;")):
        _edit(bmd, re.escape(a), b)
    for name, body in _CHAIN_DICTS.items():
        _write_text(dst, os.path.join("system", name),
                    _foam_header("dictionary", name) + body)
    _edit(os.path.join(dst, "0", "U"),
          r"(movingWall\s*\{\s*type\s+fixedValue;\s*value\s+uniform )"
          r"\(1 0 0\);", rf"\g<1>({MESH_CHAIN_LID!r} 0 0);")
    schemes = os.path.join(dst, "system", "fvSchemes")
    _edit(schemes, r"default\s+Gauss linear orthogonal;",
          "default         Gauss linear corrected;")
    _edit(schemes, r"(snGradSchemes\s*\{\s*default\s+)orthogonal;",
          r"\1corrected;")
    solution = os.path.join(dst, "system", "fvSolution")
    _edit(solution, r"nNonOrthogonalCorrectors\s+0;",
          "nNonOrthogonalCorrectors 1;")
    if gamg:
        _edit(solution, r"\bp\s*\{[^}]*\}", MESH_CHAIN_GAMG, count=1)
    _edit(os.path.join(dst, "system", "controlDict"), r"deltaT\s+[^;]+;",
          f"deltaT          {MESH_CHAIN_DT!r};")
    return dst


# checkMesh's statistics the mesh goldens hold: counts exactly, the rest at
# MESH_CHAIN_CHECK_TOL of the golden (checkMesh reports no count of
# non-orthogonal faces)
MESH_CHAIN_EXACT = ("nCells", "nFaces", "nInternalFaces", "nPoints")
MESH_CHAIN_CLOSE = ("totalVolume", "maxNonOrtho", "avgNonOrtho")
MESH_CHAIN_CHECK_TOL = 1e-12
_CONTINUITY = re.compile(r"time step continuity errors : sum local = (\S+),")


def mesh_chain_check(text):
    """checkMesh's printed statistics of MESH_CHAIN_EXACT and
    MESH_CHAIN_CLOSE, by name."""
    out = {}
    for name in MESH_CHAIN_EXACT + MESH_CHAIN_CLOSE:
        m = re.search(rf"^\s*{name}:\s*(\S+)\s*$", text, re.M)
        check(m is not None, f"checkMesh printed no {name}")
        out[name] = (int(m.group(1)) if name in MESH_CHAIN_EXACT
                     else float(m.group(1)))
    return out


def mesh_chain_scalars(U, p, v):
    """The field scalars the mesh chain's run is held to (host float64):
    |U|'s largest and volume-weighted mean, p's extremes and
    volume-weighted mean."""
    mag = np.sqrt((U * U).sum(axis=1))
    V = v.sum()
    return {"U_max": float(mag.max()), "U_mean": float((mag * v).sum() / V),
            "p_min": float(p.min()), "p_max": float(p.max()),
            "p_mean": float((p * v).sum() / V)}


def last_continuity(log_text):
    """The last step's continuity error of a run's log (its `sum
    local`)."""
    errs = _CONTINUITY.findall(log_text)
    check(bool(errs), "the run logged no continuity error")
    return float(errs[-1])


def mesh_chain_run(case_dir):
    """MESH_CHAIN_CMDS through `python -m foamtpu_torch <command> -case
    case_dir`, one process each, in order (host commands: no device),
    until one fails: each command's return code, seconds and printed
    lines."""
    out = []
    for argv in MESH_CHAIN_CMDS:
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "foamtpu_torch", *argv,
                            "-case", case_dir], cwd=REPO_DIR,
                           capture_output=True, text=True)
        out.append({"argv": argv, "rc": r.returncode,
                    "seconds": time.perf_counter() - t0,
                    "stdout": r.stdout[-4000:], "stderr": r.stderr[-2000:]})
        if r.returncode:
            break
    return out


# the run of the mesh chain's case in a process of its own, as `python -m
# foamtpu_torch run -case <dir> -steps <n>` runs it (runpy, as -m does),
# the PISO step fenced by torch.cuda.synchronize after each step (its host
# clock, SpMV launches and laplacian_correction calls); after the run, in
# the same process: the field scalars, one step more under a SolveLog whose
# p matrix holds the SpMV to its plain version and is timed, then one step
# profiled; written as JSON at `out`
MESH_RUNNER = r"""
import json, runpy, sys, time
here, case_dir, steps, out = sys.argv[1:5]
sys.path.insert(0, here)
import numpy as np
import torch
import chip_smoke as cs
from foamtpu_torch.core import case as case_mod
from foamtpu_torch.ops import slot, spmv
from foamtpu_torch.solvers import piso
rec, marks, calls = {}, [], [0]
correction, make_step, run_case = (slot.laplacian_correction,
                                   piso.make_step, case_mod.run_case)


def counted(*args, **kw):
    calls[0] += 1
    return correction(*args, **kw)


def mark():
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    marks.append([time.perf_counter(), spmv.LAUNCHES, spmv.FB_LAUNCHES,
                  calls[0]])


def fenced_make_step(mesh, cfg):
    step = make_step(mesh, cfg)

    def fenced(state, dt):
        if not marks:
            mark()
        rec["step"], rec["dt"] = step, dt
        out = step(state, dt)
        mark()
        return out
    return fenced


def watched(*args, **kw):
    case = run_case(*args, **kw)
    st, mesh = case.final_state, case.mesh
    res = {"marks": marks, "launches": spmv.LAUNCHES,
           "fb_launches": spmv.FB_LAUNCHES, "corrections": calls[0],
           "steps": case.time.index, "n_cells": mesh.n_cells,
           "fb_entries": int(mesh.fb_cells.shape[0]),
           "scalars": cs.mesh_chain_scalars(
               st["U"].data.double().cpu().numpy(),
               st["p"].data.double().cpu().numpy(),
               mesh.v.double().cpu().numpy()),
           "finite": all(bool(torch.isfinite(st[k].data).all())
                         for k in ("U", "p"))}
    if mesh.device.type == "cuda":
        res.update(cs.mesh_chain_kernel(spmv, mesh, st, rec["step"],
                                        rec["dt"], marks))
    with open(out, "w") as f:
        json.dump(res, f, default=lambda o: o.item())
    return case


slot.laplacian_correction = counted
piso.make_step = fenced_make_step
case_mod.run_case = watched
sys.argv = ["foamtpu_torch", "run", "-case", case_dir, "-steps", steps,
            *sys.argv[5:]]
runpy.run_module("foamtpu_torch", run_name="__main__", alter_sys=True)
"""


def mesh_chain_kernel(spmv, mesh, state, step, dt, marks):
    """After the mesh chain's run (in MESH_RUNNER's process): one step more
    under a SolveLog, its p matrix (the octree's hanging faces in the COO
    remainder) held to the plain version (f32, f64) and timed
    (time_shape); then one step profiled (profile_chunk, its SpMV launches
    counted with the run's)."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    with SolveLog(state) as log:
        state, _ = step(state, dt)
    op = mat_operand(mesh, log.matrices["p"], "mesh_chain_p")
    cases, max_err = [], 0.0
    deltas = tuple(mesh.st_deltas)
    for dtype in (torch.float32, torch.float64):
        err = check_operands(spmv, [op], mesh, deltas, dtype,
                             np.random.default_rng(201), cases)
        if dtype == torch.float32:
            max_err = err
    _, soff, dg, sfb = op
    timings = time_shape(spmv, "mesh_chain_p", dg.contiguous(),
                         operand_x(dg, 202), soff.contiguous(), deltas,
                         flush, fb=mesh_remainder(spmv, mesh, sfb, dg.dtype))
    del flush
    timed = (marks[-1][0] - marks[MESH_CHAIN_CHUNK][0]) / (
        len(marks) - 1 - MESH_CHAIN_CHUNK)
    l0, f0 = spmv.LAUNCHES, spmv.FB_LAUNCHES
    _, prof = profile_chunk(spmv, "mesh_utilities_profile", mesh,
                            lambda st: step(st, dt), state, 1, timed)
    return {"kernel_cases": cases, "max_abs_err_f32": max_err,
            "timings": timings, "operand_fb_entries": int(sfb.shape[0]),
            "profile": prof, "profile_launches": spmv.LAUNCHES - l0,
            "profile_fb_launches": spmv.FB_LAUNCHES - f0,
            "incomplete_profiles": INCOMPLETE_PROFILES,
            "profiler_fallbacks": PROFILER_FALLBACKS}


# goldens from the JAX package on the CPU: the mesh chain through `python
# -m foamtpu` and MESH_CHAIN_STEPS icoFoam steps in float32, and the flow
# scalars' spread under round-off (the larger of |float32 - float64| and
# |float32 from perturb_case's start - float32|): `PYTHONPATH=. python
# tests/test_torch_piso_nonorth.py goldens [--perturb]` (with FOAMTPU_X64=1
# JAX_ENABLE_X64=1 for float64), then `... spread f32.json f64.json
# perturbed.json`
MESH_CHAIN_GOLDEN = {
    "mesh": {"nCells": 368640, "nFaces": 1475904, "nInternalFaces": 736320,
             "nPoints": 739970, "totalVolume": 0.1,
             "maxNonOrtho": 18.434948822932235,
             "avgNonOrtho": 0.0192281082898791},
    "flow": {"U_max": 0.490945190191269, "U_mean": 0.023531837659645546,
             "p_min": -47.57964324951172, "p_max": 47.96591567993164,
             "p_mean": 0.07053666797614581, "continuity": 4.58066e-10}}
MESH_CHAIN_SPREAD = {"U_max": 4.850614394036334e-07,
                     "U_mean": 4.421948899928363e-07,
                     "p_min": 8.001984350869407e-05,
                     "p_max": 0.00035931280084611217,
                     "p_mean": 0.00011883190933284493,
                     "continuity": 2.8554300000000006e-10}
MESH_CHAIN_TOL_SPREAD = 10.0
MESH_CHAIN_TOL_FLOOR = 1e-4    # of the key's field size
# a key whose tolerance passes this share of its field's size is reported,
# not held (as BCU_HELD_SHARE)
MESH_CHAIN_HELD_SHARE = 0.05


def mesh_chain_golden_errs(got):
    """{key: (error, tolerance)} of the run's flow scalars against
    MESH_CHAIN_GOLDEN["flow"] at MESH_CHAIN_TOL_SPREAD times the JAX
    package's spread (MESH_CHAIN_SPREAD), at least MESH_CHAIN_TOL_FLOOR of
    the key's field size (the golden, or the largest of that field's
    goldens), and the keys whose tolerance passes MESH_CHAIN_HELD_SHARE of
    that size: reported, not held."""
    gold = MESH_CHAIN_GOLDEN["flow"]
    out, loose = {}, []
    for k, g in gold.items():
        f = k.split("_")[0]
        size = max([abs(g)] + [abs(v) for kk, v in gold.items()
                               if kk.split("_")[0] == f])
        tol = max(MESH_CHAIN_TOL_SPREAD * MESH_CHAIN_SPREAD[k],
                  MESH_CHAIN_TOL_FLOOR * size)
        if tol > MESH_CHAIN_HELD_SHARE * size:
            loose.append(k)
        else:
            out[k] = (abs(got[k] - g), tol)
    return out, loose


def phase_mesh_utilities(spmv, here, root, device=()):
    """The mesh chain as a user runs it: mesh_chain_case's cavity through
    MESH_CHAIN_CMDS, each `python -m foamtpu_torch <command> -case <dir>`
    in a process of its own (in the background premesh process when it
    was started), then `python -m foamtpu_torch run -case <dir> -steps
    MESH_CHAIN_STEPS` on the card (MESH_RUNNER; `device` ("-device", "cpu")
    rehearses it on the CPU): checkMesh's statistics against
    MESH_CHAIN_GOLDEN's mesh (counts exactly, the rest at
    MESH_CHAIN_CHECK_TOL), the flow scalars against its flow
    (mesh_chain_golden_errs), 2 x 2 non-orthogonal passes a step through
    laplacian_correction, the timed chunk (s/step, SpMV launches a step),
    the p operand against its plain version and timed, one profiled
    step."""
    t0 = time.perf_counter()
    got = premeshed("mesh_chain")
    if got:
        case_dir, chain = got
    else:
        case_dir = mesh_chain_case(here, os.path.join(root, "mesh_chain"),
                                   MESH_CHAIN_HEAD)
        chain = {"commands": mesh_chain_run(case_dir)}
    t1 = time.perf_counter()
    cmds = chain["commands"]
    check(len(cmds) == len(MESH_CHAIN_CMDS) and all(
        c["rc"] == 0 for c in cmds), f"mesh chain failed: {cmds[-1]}")
    stats = mesh_chain_check(cmds[-1]["stdout"])
    gold = MESH_CHAIN_GOLDEN["mesh"]
    checks = {f"checkMesh {k}": stats[k] == gold[k]
              for k in MESH_CHAIN_EXACT}
    checks.update({f"checkMesh {k}": abs(stats[k] - gold[k])
                   <= MESH_CHAIN_CHECK_TOL * abs(gold[k])
                   for k in MESH_CHAIN_CLOSE})
    out_json = os.path.join(root, "mesh_chain_run.json")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-c", MESH_RUNNER, here, case_dir,
         str(MESH_CHAIN_STEPS), out_json, *device], cwd=here, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        log, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0 and os.path.exists(out_json),
          f"mesh_utilities run: exit {proc.returncode}: {err[-3000:]}")
    with open(out_json) as f:
        run = json.load(f)
    run_s = time.perf_counter() - t1
    flow = dict(run["scalars"], continuity=last_continuity(log))
    errs, loose = mesh_chain_golden_errs(flow)
    marks, k = run["marks"], MESH_CHAIN_CHUNK
    timed_steps = len(marks) - 1 - k
    per_step = {"warmup_s": marks[k][0] - marks[0][0],
                "timed_s": marks[-1][0] - marks[k][0],
                "sec_per_step": (marks[-1][0] - marks[k][0]) / timed_steps,
                "spmv_launches_per_step": (marks[-1][1] - marks[k][1])
                / timed_steps,
                "spmv_fb_launches_per_step": (marks[-1][2] - marks[k][2])
                / timed_steps}
    n_pass = MESH_CHAIN_STEPS * 2 * 2
    checks.update({
        "finite": run["finite"], "steps": run["steps"] == MESH_CHAIN_STEPS,
        "n_cells": run["n_cells"] == gold["nCells"],
        f"{n_pass} non-orthogonal passes": run["corrections"] == n_pass,
        "spmv launched": run["launches"] > 0,
        "the remainder launched": run["fb_launches"] > 0,
        "goldens": all(e <= t for e, t in errs.values())})
    prof = run.get("profile", {})
    out = {"phase": "mesh_utilities",
           "card": None if device else nvidia_smi(),
           "case": "icoFoam cavity at 1 m, left half {0} x {1}, top half "
                   "refined, mirrored; Gauss linear corrected, "
                   "nNonOrthogonalCorrectors 1, deltaT {2}".format(
                       *MESH_CHAIN_HEAD, MESH_CHAIN_DT),
           "chain": [{k2: c[k2] for k2 in ("argv", "rc", "seconds")}
                     for c in cmds],
           "chain_s": sum(c["seconds"] for c in cmds),
           "premeshed_in_background": bool(got),
           "premesh_wait_s": chain.get("premesh_wait_s"),
           "setup_s": t1 - t0, "run_process_s": run_s,
           "checkMesh": stats, "n_cells": run["n_cells"],
           "fb_entries": run["fb_entries"], **per_step,
           "corrections": run["corrections"], "scalars": flow,
           "golden_errs": errs, "reported_not_held": {
               k2: [flow[k2], MESH_CHAIN_GOLDEN["flow"][k2]] for k2 in loose},
           "solver_iterations_max": {
               k2: max(x) for k2, x in solve_iterations(log).items()},
           "device_ms_per_step": prof.get("device_ms_per_iter"),
           "device_busy_share": prof.get("device_busy_share_unprofiled"),
           "spmv_launches_per_step_profiled": prof.get(
               "spmv_launches_per_iter"),
           "top_kernels_ms_per_step": prof.get(
               "top_kernels_ms_per_iter", [])[:8],
           "kernel_cases": run.get("kernel_cases", []),
           "max_abs_err_f32": run.get("max_abs_err_f32", 0.0),
           "timings": run.get("timings", []),
           "operand_fb_entries": run.get("operand_fb_entries"),
           "incomplete_profiles": run.get("incomplete_profiles"),
           "spmv_launches_total": run["launches"]
           + run.get("profile_launches", 0),
           "spmv_fb_launches_total": run["fb_launches"]
           + run.get("profile_fb_launches", 0),
           "checks": checks}
    checks["operand has a remainder"] = bool(out["operand_fb_entries"])
    emit(out)
    for name, ok in checks.items():
        check(ok, f"mesh_utilities check {name}: {out}")
    return out, out["max_abs_err_f32"], out["timings"]


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
        # the host meshing of snappy_headline and cht_headline (about 100 s
        # of numpy) runs in a process of its own beside the earlier phases
        start_premesh(here, root)
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
        bcu = phase_bc_utilities(spmv, here, root)
        stamp("bc_utilities")
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
        turb2, err_t2, t_t2 = phase_turbulence_models2(
            spmv, here, os.path.join(root, "turbulence2"), flush)
        stamp("turbulence_models2")
        dsh, err_dsh, t_dsh = phase_diffstress_headline(spmv, here, root,
                                                        flush)
        stamp("diffstress_headline")
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
        comp, err_comp, t_comp = phase_compressible(spmv, here, root, flush)
        stamp("compressible")
        chead, err_ch, t_ch = phase_compressible_headline(spmv, here, root,
                                                          flush)
        stamp("compressible_headline")
        rch = phase_rhocentral_headline(spmv, here, root)
        stamp("rhocentral_headline")
        small, err_small, t_small = phase_solvers_small(spmv, here, root,
                                                        flush)
        stamp("solvers_small")
        mhdh, err_mhd, t_mhd = phase_mhd_headline(spmv, here, root, flush)
        stamp("mhd_headline")
        snc, err_snc, t_snc = phase_snappy_cht(spmv, here, root, flush)
        stamp("snappy_cht")
        snh, err_snh, t_snh = phase_snappy_headline(spmv, here, root, flush)
        stamp("snappy_headline")
        chth, err_chth, t_chth = phase_cht_headline(spmv, here, root, flush)
        stamp("cht_headline")
        mph, err_mph, t_mph = phase_multiphase(spmv, here, root, flush)
        stamp("multiphase")
        mphh, err_mphh, t_mphh = phase_multiphase_headline(spmv, here, root,
                                                           flush)
        stamp("multiphase_headline")
        comb, err_comb, t_comb = phase_combustion(spmv, here, root, flush)
        stamp("combustion")
        fire, err_fire, t_fire = phase_fire_headline(spmv, here, root, flush)
        stamp("fire_headline")
        topo = phase_topo(spmv, here, root)
        stamp("topo")
        amrh, err_amr, t_amr = phase_amr_headline(spmv, here, root, flush)
        stamp("amr_headline")
        lagr = phase_lagrangian(spmv, here, root)
        stamp("lagrangian")
        lagh, err_lag, t_lag = phase_lagrangian_headline(spmv, here, root,
                                                         flush)
        stamp("lagrangian_headline")
        # its chain meshed by the background premesh process
        mchain, err_mc, t_mc = phase_mesh_utilities(spmv, here, root)
        stamp("mesh_utilities")
        # last: the renumbered duct's hierarchy is built in the background
        uhead, err_uh, t_uh = phase_utilities_headline(spmv, here, root,
                                                       flush, duct)
        stamp("utilities_headline")
    finally:
        stop_premesh()
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "timeline", "seconds": TIMELINE,
          "premesh_wait_s": PREMESH.get("waits"),
          "total_s": time.perf_counter() - T_START,
          "incomplete_profiles": INCOMPLETE_PROFILES,
          "profiler_fallbacks": PROFILER_FALLBACKS})

    # the kernels line: device ms per call (torch.profiler) with L2
    # flushed before every call, beside the HBM bound, of the whole
    # operator at the duct's pressure operand (one launch, remainder
    # included), the largest call the main path makes; the warm-L2 time
    # apart, and every timed shape beside it
    main_shape = next(t for t in t_duct if t["shape"] == "duct_p_whole")
    paths = (head, pitz, duct, ras, pras, phead, dam, bcu, uhead, basic,
             cross, heated,
             rot, mrf, turb, les, turb2, dsh, thermal, bouss, dym, dymh, surf, comp,
             chead, rch, small, mhdh, snc, snh, chth, mph, mphh, comb, fire,
             topo, amrh, lagr, lagh, mchain)
    emit({"kernels": [{
        "name": "spmv_stencil", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": sum(p["spmv_launches_total"] for p in paths),
        "fb_launches": sum(p["spmv_fb_launches_total"] for p in paths),
        "max_abs_err": max(max_err, err_duct, err_dam, err_uh, err_heat,
                           err_mrf,
                           err_les, err_t2, err_dsh, err_bh, err_dh, err_comp, err_ch,
                           err_small, err_mhd, err_snc, err_snh,
                           err_chth, err_mph, err_mphh, err_comb, err_fire,
                           err_amr, err_lag, err_mc),
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
            for t in timings + t_duct + t_dam + t_uh + t_heat + t_mrf + t_les
            + t_t2 + t_dsh + t_bh + t_dh + t_comp + t_ch + t_small + t_mhd + t_snc
            + t_snh + t_chth + t_mph + t_mphh + t_comb + t_fire + t_amr
            + t_lag + t_mc]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
