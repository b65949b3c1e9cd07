"""Field-statistics function objects: fieldMinMax and fieldAverage, and
the derived-field helpers `vorticity` and `q_criterion` (port of
openfoam-2.2.x_tpu/functionobjects/field.py;
src/postProcessing/functionObjects/{field,utilities}/).

fieldMinMax reduces on the device and fetches the extrema of all its
fields at once (one fetch per execute); fieldAverage keeps its running
means on the device and fetches nothing.
"""

from __future__ import annotations

import os

import torch

from ..ops import fvc
from .base import FunctionObject, data_of, field_of, register


class FieldMinMax(FunctionObject):
    def __init__(self, name, spec, case):
        super().__init__(name, spec, case)
        self.fields = [str(f) for f in spec.get("fields", [])]
        self.path = os.path.join(self.out_dir, "fieldMinMax.dat")
        if not os.path.exists(self.path):
            with open(self.path, "w") as f:
                f.write("# Time field min max\n")

    def execute(self, time_name, state):
        names, ext = [], []
        for name in self.fields:
            src = field_of(state, name)
            if src is None:
                continue
            d = data_of(src)
            if d.ndim == 2:
                d = torch.linalg.vector_norm(d, dim=1)
            names.append(name)
            ext.append(torch.stack([d.min(), d.max()]))
        vals = self.host(torch.stack(ext)) if ext else ()
        with open(self.path, "a") as f:
            for name, (lo, hi) in zip(names, vals):
                f.write(f"{time_name} {name} {lo:.8g} {hi:.8g}\n")


class FieldAverage(FunctionObject):
    """Running time-average of fields (fieldAverage), kept on the
    device in `means`."""

    def __init__(self, name, spec, case):
        super().__init__(name, spec, case)
        self.fields = [str(f) for f in spec.get("fields", [])
                       if not isinstance(f, dict)]
        self.means = {}
        self.n = 0

    def execute(self, time_name, state):
        self.n += 1
        w = 1.0 / self.n
        for name in self.fields:
            src = field_of(state, name)
            if src is None:
                continue
            d = data_of(src)
            if name not in self.means:
                self.means[name] = d.clone()
            else:
                self.means[name] = (1 - w) * self.means[name] + w * d


def vorticity(mesh, U_field):
    """curl(U) [nC,3] (functionObjects/utilities/vorticity), on the
    device."""
    g = fvc.grad(mesh, U_field)  # g[i,j] = d_i u_j
    return torch.stack([g[:, 1, 2] - g[:, 2, 1],
                        g[:, 2, 0] - g[:, 0, 2],
                        g[:, 0, 1] - g[:, 1, 0]], dim=1)


def q_criterion(mesh, U_field):
    """Q = 0.5(|Omega|^2 - |S|^2) (utilities/Q), on the device."""
    g = fvc.grad(mesh, U_field)
    s = 0.5 * (g + torch.transpose(g, 1, 2))
    w = 0.5 * (g - torch.transpose(g, 1, 2))
    return 0.5 * (torch.sum(w * w, dim=(1, 2)) - torch.sum(s * s,
                                                          dim=(1, 2)))


register("fieldMinMax", FieldMinMax)
register("fieldAverage", FieldAverage)
