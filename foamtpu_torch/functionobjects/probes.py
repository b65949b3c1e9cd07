"""probes: point sampling of fields over time (port of
openfoam-2.2.x_tpu/functionobjects/probes.py; src/sampling/probes/).

The nearest cell of each probe is found once, on a host copy of the
cell centres; each execute gathers the probed values of all its fields
on the device and fetches them in one copy.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .base import FunctionObject, data_of, field_of, register


class Probes(FunctionObject):
    def __init__(self, name, spec, case):
        super().__init__(name, spec, case)
        pts = np.asarray(spec.get("probeLocations", []), dtype=float)
        self.points = pts.reshape(-1, 3)
        self.fields = [str(f) for f in spec.get("fields", [])]
        # nearest cell per probe (the reference's probes find the
        # containing cell; nearest-centre is the same on well-formed
        # probes)
        c = case.mesh.c.cpu().numpy()
        self.cells = np.array([
            int(np.argmin(((c - p) ** 2).sum(axis=1))) for p in self.points
        ], dtype=np.int64)
        self.cells_t = torch.as_tensor(self.cells, device=case.mesh.device)
        self._opened = set()

    def _path(self, field: str) -> str:
        """The field's series file; on its first use by this object, the
        header, unless the file already has rows (a continued run)."""
        path = os.path.join(self.out_dir, field)
        if field not in self._opened:
            self._opened.add(field)
            if not os.path.exists(path) or os.path.getsize(path) == 0:
                with open(path, "w") as f:
                    for i, p in enumerate(self.points):
                        f.write(f"# Probe {i} ({p[0]} {p[1]} {p[2]})\n")
                    f.write("# Time\n")
        return path

    def execute(self, time_name, state):
        names, vals = [], []
        for fname in self.fields:
            src = field_of(state, fname)
            if src is None:
                continue
            d = data_of(src)[self.cells_t]
            names.append((fname, d.ndim == 1))
            vals.append(d.reshape(len(self.cells), -1))
        if not names:
            return
        flat = self.host(torch.cat(vals, dim=1))
        col = 0
        for (fname, scalar), v in zip(names, vals):
            rows = flat[:, col:col + v.shape[1]]
            col += v.shape[1]
            if scalar:
                row = " ".join(f"{x:.8g}" for x in rows[:, 0])
            else:
                row = " ".join("(" + " ".join(f"{x:.8g}" for x in r) + ")"
                               for r in rows)
            with open(self._path(fname), "a") as f:
                f.write(f"{time_name} {row}\n")


register("probes", Probes)
