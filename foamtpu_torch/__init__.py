"""foamtpu_torch — the PyTorch/CUDA port of foamtpu (openfoam-2.2.x_tpu).

Module paths mirror the JAX package's, so each module names its twin:
``foamtpu_torch/ops/stencil.py`` ports ``openfoam-2.2.x_tpu/ops/stencil.py``.
The package imports torch and numpy, never jax. The JAX package stays
the reference; ``tests/test_torch_*.py`` hold each module against it.

The slices ported so far: the icoFoam lid-driven cavity PISO step
(``apps.cases.make_cavity`` -> ``solvers.piso.make_chunk``) with PCG,
BiCGStab and GAMG pressure/momentum solves; and simpleFoam with kEpsilon
and wall functions on a case directory (``apps.cli`` blockMesh ->
``core.case.Case`` -> ``solvers.apps._load_turbulence`` ->
``solvers.simple.make_chunk``), as on the pitzDaily tutorial. The
offset-stencil SpMV runs as a hand-written CUDA kernel
(``csrc/spmv_stencil.cu``) on CUDA tensors and as its plain torch
version on CPU tensors.
"""

__version__ = "0.1.0"
