"""simpleFoam pieces used by the PISO slice (port of
openfoam-2.2.x_tpu/solvers/simple.py::adjust_phi)."""

from __future__ import annotations

from typing import Any

import torch

from ..bc import patchfields as pf
from ..core.fields import VolField


def adjust_phi(mesh, phi_b: Any, U: VolField) -> Any:
    """Global flux balance over adjustable boundaries
    (cfdTools/general/adjustPhi): scale the outflow on non-fixed-value
    patches so the net boundary flux vanishes."""
    adjustable = []
    for patch, bc in zip(mesh.patches, U.bcs):
        fixed = pf.is_value_bc(bc) or bc.kind in ("empty", "symmetry",
                                                  "symmetryPlane", "slip")
        adjustable.append(torch.full((patch.size,), 0.0 if fixed else 1.0,
                                     dtype=mesh.v.dtype, device=mesh.device))
    adj = torch.cat(adjustable)
    fixed_flux = torch.sum(phi_b * (1.0 - adj))
    out = torch.sum(torch.clamp(phi_b, min=0.0) * adj)
    inn = torch.sum(torch.clamp(phi_b, max=0.0) * adj)
    mass_in = -(fixed_flux + inn)
    big = torch.abs(out) > 1e-30
    scale = mass_in / torch.where(big, out, torch.ones_like(out))
    scale = torch.where(big, scale, torch.ones_like(scale))
    return torch.where((phi_b > 0) & (adj > 0), phi_b * scale, phi_b)
