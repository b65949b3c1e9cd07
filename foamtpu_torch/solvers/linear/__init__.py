"""Linear solver dispatch from fvSolution controls (port of
openfoam-2.2.x_tpu/solvers/linear/__init__.py).

Every matrix-vector product goes through the offset-stencil operator
(ops/stencil.py), i.e. the CUDA kernel on the card. A matrix with a
cyclicAMI coupling (FvMatrix.ami_coef, on a mesh with AMI interfaces)
adds its coupled term beside the kernel in every product: a gather of
the interpolation entries and a scatter-add into their owner rows, as
the reference computes it outside its Pallas kernel. Vector equations
solve as one multi-RHS system. The reference's explicit-halo and
transposed-layout branches are outside the ported slice.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ...ops import stencil as stencil_mod
from . import krylov
from .krylov import SolverPerf

_SOLVERS = {
    "PCG": krylov.pcg,
    "PBiCG": krylov.bicgstab,
    "PBiCGStab": krylov.bicgstab,
    "smoothSolver": krylov.smooth_solver,
    "diagonal": krylov.diagonal_solver,
}


def prep_pressure(mat, needs_ref: bool, ctl: Dict, ref_cell: int,
                  ref_value: float):
    """Apply the pressure reference for an all-Neumann system: cell
    pinning for point solvers, null-space deflation for GAMG."""
    ctl2 = dict(ctl)
    if needs_ref:
        if str(ctl.get("solver", "")) == "GAMG":
            ctl2["_singular"] = True
            ctl2["_ref"] = (ref_cell, ref_value)
        else:
            mat = mat.set_reference(ref_cell, ref_value)
    return mat, ctl2


def prepare_controls(mesh, mat, *controls_list):
    """For GAMG controls: build the coefficient-dependent prep (Galerkin
    hierarchy, stencils, coarsest dense inverse) once and share it across
    the given control dicts (valid while the matrix coefficients stay
    the same, as for the PISO pressure matrix across correctors)."""
    out = []
    prep = None
    for ctl in controls_list:
        if ctl is None:
            out.append(None)
            continue
        ctl2 = dict(ctl)
        if (str(ctl2.get("solver", "")) == "GAMG" and "_gamg" in ctl2
                and mat.ami_coef is None):
            # (an AMI-coupled matrix is solved by Krylov, see `solve`)
            if prep is None:
                prep = ctl2["_gamg"].prepare(mesh, mat)
            ctl2["_prep"] = prep
        out.append(ctl2)
    return out[0] if len(out) == 1 else tuple(out)


def solve(mesh, mat, psi: Any, controls: Dict) -> Tuple[Any, SolverPerf]:
    """Solve mat*psi = source for the field data psi [nC,(3)]; returns
    (new_psi, perf)."""
    name = str(controls.get("solver", "PCG"))
    if name == "GAMG" and mat.ami_coef is not None:
        # the Galerkin coarsening does not carry the AMI interface:
        # polynomial-preconditioned BiCGStab sees the whole coupled
        # operator through its products, as in the reference
        name = "PBiCGStab"
        controls = dict(controls)
        controls.setdefault("preconditioner", "polynomial")
    if name == "GAMG":
        from .gamg import solve_gamg

        return solve_gamg(mesh, mat, psi, controls)
    fn = _SOLVERS.get(name)
    if fn is None:
        raise NotImplementedError(
            f"linear solver {name!r} is not ported to foamtpu_torch yet")
    kw = dict(
        tol=float(controls.get("tolerance", 1e-6)),
        rel_tol=float(controls.get("relTol", 0.0)),
        max_iter=int(controls.get("maxIter", 1000)),
    )
    if name in ("PCG", "PBiCG", "PBiCGStab"):
        kw["precond"] = str(controls.get("preconditioner", "diagonal"))
    if name == "smoothSolver":
        kw["n_sweeps"] = int(controls.get("nSweeps", 1))

    if mat.soff is not None:
        st = stencil_mod.StencilOp(tuple(mesh.st_deltas), mat.soff,
                                   mesh.fb_cells, mesh.fb_nbrs, mat.sfb,
                                   mesh.fb_layout)
    else:
        st = stencil_mod.mesh_stencil(mesh, mat.upper, mat.lower)
    row_off = st.off.sum(dim=1)
    if st.fb_cells.shape[0]:
        row_off = row_off.index_add(0, st.fb_cells, st.fb_coeffs)
    apply_off = st.apply_off
    ami_ce = mat.ami_entry_coeffs(mesh)
    if ami_ce is not None:
        rows, cells = mesh.ami_entry_row, mesh.ami_entry_cell

        def apply_off(x):
            contrib = (ami_ce[:, None] * x[cells] if x.ndim == 2
                       else ami_ce * x[cells])
            return st.apply_off(x).index_add(0, rows, contrib)

        row_off = row_off.index_add(0, rows, ami_ce)

    if name == "smoothSolver":
        if mat.symmetric:
            # Gershgorin bound on D^-1 A for the Chebyshev smoother
            row_abs = torch.sum(torch.abs(st.off), dim=1)
            if st.fb_cells.shape[0]:
                row_abs = row_abs.index_add(0, st.fb_cells,
                                            torch.abs(st.fb_coeffs))
            d_for_lam = mat.diag_eff(mesh)
            if d_for_lam.ndim == 2:
                row_abs = row_abs[:, None]
            kw["lam_max"] = torch.max(1.0 + row_abs / torch.abs(d_for_lam))
        else:
            # convection-bearing matrix: Jacobi-preconditioned BiCGStab
            # (the reference's documented deviation)
            fn = krylov.bicgstab
            kw.pop("n_sweeps", None)
            kw["precond"] = "diagonal"

    d = mat.diag_eff(mesh)        # [nC] or [nC,C]
    b = mat.source_eff(mesh)

    if ami_ce is not None:
        def amul(x):
            return d * x + apply_off(x)
    else:
        def amul(x):
            return st.matvec(d, x)

    rs = d + (row_off if psi.ndim == 1 else row_off[:, None])
    return fn(amul, psi, b, d, row_sum=rs, amul_off=apply_off, **kw)
