"""Programmatic construction of the benchmark cases (port of
openfoam-2.2.x_tpu/apps/cases.py::make_cavity)."""

from __future__ import annotations

from typing import Dict, Tuple

from ..bc import patchfields as pf
from ..core.dictionary import parse_string
from ..core.dimensions import DimensionSet, dimVelocity
from ..core.fields import vol_scalar, vol_vector
from ..mesh import blockmesh, to_device
from ..solvers import piso

CAVITY3D_BLOCKMESH = """
convertToMeters 0.1;
vertices
(
    (0 0 0) (1 0 0) (1 1 0) (0 1 0)
    (0 0 1) (1 0 1) (1 1 1) (0 1 1)
);
blocks ( hex (0 1 2 3 4 5 6 7) ({n} {n} {n}) simpleGrading (1 1 1) );
boundary
(
    movingWall { type wall; faces ((3 7 6 2)); }
    fixedWalls { type wall; faces ((0 4 7 3) (2 6 5 1) (1 5 4 0)
                                   (0 3 2 1) (4 5 6 7)); }
);
"""

CAVITY_BLOCKMESH = """
convertToMeters 0.1;
vertices
(
    (0 0 0) (1 0 0) (1 1 0) (0 1 0)
    (0 0 0.1) (1 0 0.1) (1 1 0.1) (0 1 0.1)
);
blocks ( hex (0 1 2 3 4 5 6 7) ({n} {n} 1) simpleGrading (1 1 1) );
boundary
(
    movingWall { type wall; faces ((3 7 6 2)); }
    fixedWalls { type wall; faces ((0 4 7 3) (2 6 5 1) (1 5 4 0)); }
    frontAndBack { type empty; faces ((0 3 2 1) (4 5 6 7)); }
);
"""


def cavity_polymesh(n: int, three_d: bool = False):
    """Host PolyMesh of the n^2 (or n^3) lid-driven cavity."""
    src = CAVITY3D_BLOCKMESH if three_d else CAVITY_BLOCKMESH
    return blockmesh.generate(parse_string(src.replace("{n}", str(n))))


def cavity_fields(mesh):
    """U and p of the icoFoam cavity: lid velocity (1,0,0) on movingWall,
    no-slip on fixedWalls, zeroGradient p, empty front and back."""
    ubcs, pbcs = [], []
    for patch in mesh.patches:
        if patch.type == "empty":
            ubcs.append(pf.PatchField(kind="empty", vfrac=0.0))
            pbcs.append(pf.PatchField(kind="empty", vfrac=0.0))
        elif patch.name == "movingWall":
            ubcs.append(pf.fixed_value([1.0, 0.0, 0.0]))
            pbcs.append(pf.zero_gradient())
        else:
            ubcs.append(pf.fixed_value([0.0, 0.0, 0.0]))
            pbcs.append(pf.zero_gradient())
    U = vol_vector(mesh, [0.0, 0.0, 0.0], name="U", dims=dimVelocity,
                   bcs=tuple(ubcs))
    p = vol_scalar(mesh, 0.0, name="p", dims=DimensionSet.of(0, 2, -2),
                   bcs=tuple(pbcs))
    return U, p


def make_cavity(n: int = 20, nu: float = 0.01, p_solver: Dict | None = None,
                three_d: bool = False, device="cpu") -> Tuple:
    """icoFoam cavity (tutorials/incompressible/icoFoam/cavity) on
    `device`: returns (mesh, initial_state, PisoConfig). A GAMG p-solver
    gets GAMG(mesh) with the reference defaults."""
    mesh = to_device(cavity_polymesh(n, three_d), device)

    if p_solver and str(p_solver.get("solver")) == "GAMG" \
            and "_gamg" not in p_solver:
        from ..solvers.linear.gamg import GAMG

        p_solver = dict(p_solver)
        p_solver["_gamg"] = GAMG(mesh)

    U, p = cavity_fields(mesh)
    cfg = piso.PisoConfig(
        nu=nu,
        n_correctors=2,
        n_non_orth=0,
        p_controls=p_solver or {
            "solver": "PCG", "preconditioner": "diagonal",
            "tolerance": 1e-6, "relTol": 0.0, "maxIter": 5000,
        },
        u_controls={"solver": "smoothSolver", "tolerance": 1e-5,
                    "relTol": 0.0, "maxIter": 500, "nSweeps": 2},
    )
    state = piso.initial_state(mesh, U, p)
    return mesh, state, cfg
