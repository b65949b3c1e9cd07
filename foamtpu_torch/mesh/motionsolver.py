"""fvMotionSolver: Laplacian point-displacement mesh motion (port of
openfoam-2.2.x_tpu/mesh/motionsolver.py; src/fvMotionSolver/
fvMotionSolvers/displacementLaplacian/ with volPointInterpolation):
solve

    laplacian(diffusivity, cellDisplacement) = 0

with the prescribed boundary displacement as fixedValue BCs, interpolate
the cell displacement to the points (inverse-distance weights) with the
boundary points pinned to their prescribed motion, and hand the points
to mesh/moving.py::update_geometry.

Diffusivity: uniform or inverseDistance (1/d^2 from the moving patches,
the reference's quadratic inverseDistance), which stiffens the region
next to the moving wall so its cells deform least. The tables are built
once on the host (numpy, as the reference); the solve and the point
interpolation run on the mesh's device, the solve through the SpMV.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..bc import patchfields as pf
from ..core.dimensions import dimless
from ..core.fields import VolField
from ..ops import fvm
from ..solvers import linear


class DisplacementLaplacian:
    """A motion solver bound to one mesh topology (pm: the host PolyMesh,
    mesh: its FvMesh)."""

    def __init__(self, pm, mesh, moving_patches: Iterable[str],
                 diffusivity: str = "inverseDistance"):
        self.pm = pm
        self.mesh = mesh
        self.moving = tuple(moving_patches)
        dtype, dev = mesh.v.dtype, mesh.device
        # point <- cell inverse-distance weights and the boundary points
        nP = pm.n_points
        pt_cells = [[] for _ in range(nP)]
        for f in range(pm.n_faces):
            k = pm.face_npts[f]
            for pt in pm.face_pts[f, :k]:
                pt_cells[pt].append(pm.owner[f])
                if f < pm.n_internal_faces:
                    pt_cells[pt].append(pm.neighbour[f])
        rows, cols, wts = [], [], []
        for p_, cl in enumerate(pt_cells):
            cl = list(set(int(x) for x in cl))
            d = np.linalg.norm(pm.c[cl] - pm.points[p_], axis=1)
            w = 1.0 / np.maximum(d, 1e-12)
            w /= w.sum()
            rows += [p_] * len(cl)
            cols += cl
            wts += list(w)
        self._rows = torch.tensor(rows, dtype=torch.int64, device=dev)
        self._cols = torch.tensor(cols, dtype=torch.int64, device=dev)
        self._wts = torch.tensor(np.asarray(wts), dtype=dtype, device=dev)

        # boundary points per patch (moving ones pinned to the prescribed
        # motion, the other boundary points to zero displacement)
        mov_pts, fix_pts = set(), set()
        for p_ in pm.patches:
            if p_.type == "empty":
                continue
            tgt = mov_pts if p_.name in self.moving else fix_pts
            for f in range(p_.start, p_.start + p_.size):
                k = pm.face_npts[f]
                for pt in pm.face_pts[f, :k]:
                    tgt.add(int(pt))
        fix_pts -= mov_pts
        self._mov_pts = torch.tensor(sorted(mov_pts), dtype=torch.int64,
                                     device=dev)
        self._fix_pts = torch.tensor(sorted(fix_pts), dtype=torch.int64,
                                     device=dev)

        # diffusivity (a face field): inverseDistance^2 from the moving
        # patches
        if diffusivity == "inverseDistance" and mov_pts:
            from scipy.spatial import cKDTree

            tree = cKDTree(pm.points[sorted(mov_pts)])
            d_f = tree.query(pm.cf)[0]
            gamma = 1.0 / np.maximum(d_f, 1e-6) ** 2
        else:
            gamma = np.ones(pm.n_faces)
        self._gamma = torch.tensor(gamma, dtype=dtype, device=dev)

        # the BC template of the cell-displacement solve
        zero = torch.zeros(3, dtype=dtype, device=dev)
        bcs = [pf.PatchField(kind="empty", vfrac=0.0)
               if p_.type == "empty" else pf.fixed_value(zero)
               for p_ in mesh.patches]
        self._bcs = pf.normalize_bcs(mesh, tuple(bcs), rank=1)
        self._patch_index = {p_.name: i
                             for i, p_ in enumerate(mesh.patches)}

    def solve_points(self, boundary_disp: Dict[str, torch.Tensor],
                     controls: Optional[Dict] = None) -> torch.Tensor:
        """New point positions for prescribed per-moving-patch face
        displacements [size, 3] (or a single [3] vector)."""
        mesh = self.mesh
        dtype, dev = mesh.v.dtype, mesh.device
        ctl = controls or {"solver": "PBiCGStab",
                           "preconditioner": "polynomial",
                           "tolerance": 1e-7, "relTol": 0.0,
                           "maxIter": 500}
        bcs = list(self._bcs)
        for name, val in boundary_disp.items():
            i = self._patch_index[name]
            v = torch.broadcast_to(torch.as_tensor(val, dtype=dtype,
                                                   device=dev),
                                   (mesh.patches[i].size, 3))
            bcs[i] = bcs[i].replace(ref_value=v)
        D = VolField(data=torch.zeros((mesh.n_cells, 3), dtype=dtype,
                                      device=dev),
                     bcs=tuple(bcs), name="cellDisplacement", dims=dimless)
        eqn = -fvm.laplacian(mesh, self._gamma, D, corrected=False,
                             gamma_dims=dimless)
        disp, _ = linear.solve(mesh, eqn, D.data, ctl)

        # volPointInterpolation, then the pinned boundary points
        pdisp = torch.zeros((self.pm.n_points, 3), dtype=dtype, device=dev)
        pdisp = pdisp.index_add(0, self._rows,
                                self._wts[:, None] * disp[self._cols])
        if self._fix_pts.shape[0]:
            pdisp[self._fix_pts] = 0.0
        # the moving patches' points take the mean prescribed displacement
        # of their faces: exact for a rigid or uniform patch motion
        for name, val in boundary_disp.items():
            v = torch.as_tensor(val, dtype=dtype, device=dev)
            v = v if v.ndim == 1 else torch.mean(v, dim=0)
            pdisp[self._mov_pts] = v
        pts0 = torch.tensor(self.pm.points, dtype=dtype, device=dev)
        return pts0 + pdisp
