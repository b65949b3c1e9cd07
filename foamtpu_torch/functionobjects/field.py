"""Field-statistics function objects: fieldMinMax and fieldAverage (port
of openfoam-2.2.x_tpu/functionobjects/field.py;
src/postProcessing/functionObjects/field/).

fieldMinMax reduces on the device and fetches the extrema of all its
fields at once (one fetch per execute); fieldAverage keeps its running
means on the device and fetches nothing.
"""

from __future__ import annotations

import os

import torch

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


register("fieldMinMax", FieldMinMax)
register("fieldAverage", FieldAverage)
