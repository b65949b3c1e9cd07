"""Miscellaneous function objects (port of
openfoam-2.2.x_tpu/functionobjects/misc.py;
src/postProcessing/functionObjects/{field,utilities}/):

  readFields                      load fields from the time directory
                                  into the state
  surfaceInterpolateFields        internal-face values written per execute
  regionSizeDistribution          volume histogram of the connected
                                  regions above a threshold (host
                                  union-find, as in the reference)
  fieldCoordinateSystemTransform  vector fields in a local frame
  CourantNo                       mean and max Courant number
  writeDictionary                 the named dictionaries' entries
  timeActivatedFileUpdate         swap a file in once a time passes

Host fetches per execute: surfaceInterpolateFields and
fieldCoordinateSystemTransform one per field (they write whole fields),
regionSizeDistribution one (its union-find runs on the host), CourantNo
one (two numbers); the others none. `coded` is not ported (its user code
is written against numpy and jax.numpy): functionobjects/base.py
refuses it.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from .base import FunctionObject, data_of, field_of, register


class ReadFields(FunctionObject):
    """Load the named fields from the current time directory into the
    state, for the objects after it."""

    def __init__(self, name, spec, case):
        super().__init__(name, spec, case)
        self.fields = [str(f) for f in spec.get("fields", [])]

    def execute(self, time_name, state):
        for nm in self.fields:
            if nm in state:
                continue
            try:
                state[nm] = self.case.read_field(nm, time=time_name)
            except Exception:
                pass


class SurfaceInterpolateFields(FunctionObject):
    """Internal-face interpolates of vol fields, one file per execute
    (postProcessing/<name>/<out>_<time>.dat)."""

    def __init__(self, name, spec, case):
        super().__init__(name, spec, case)
        # accepts (U phi) or ((U Unear) (p pNear)) forms
        self.fields = []
        for f in spec.get("fields", []):
            if isinstance(f, (list, tuple)):
                self.fields.append((str(f[0]), str(f[-1])))
            else:
                self.fields.append((str(f), str(f) + "Near"))

    def execute(self, time_name, state):
        from ..ops import surface

        for src_name, out_name in self.fields:
            src = field_of(state, src_name)
            if src is None:
                continue
            arr = self.host(surface.interpolate_internal(self.case.mesh,
                                                         data_of(src)))
            out = os.path.join(self.out_dir, f"{out_name}_{time_name}.dat")
            with open(out, "w") as f:
                f.write(f"# {out_name}: internal-face interpolate of "
                        f"{src_name} at t={time_name}\n")
                np.savetxt(f, arr.reshape(arr.shape[0], -1), fmt="%.8g")


class RegionSizeDistribution(FunctionObject):
    """Volume histogram of the connected regions where field > threshold
    (regionSizeDistribution; its FaceCellWave regionSplit is a host
    union-find here, as in the reference)."""

    def __init__(self, name, spec, case):
        super().__init__(name, spec, case)
        self.field = str(spec.get("field", "alpha1"))
        self.threshold = float(spec.get("threshold", 0.5))
        self.n_bins = int(spec.get("nBins", 10))
        self.path = os.path.join(self.out_dir, "distribution.dat")
        mesh = case.mesh
        nif = mesh.n_internal_faces
        self.owner = mesh.owner[:nif].cpu().numpy()
        self.nei = mesh.neighbour[:nif].cpu().numpy()
        self.V = mesh.v.cpu().numpy()

    def execute(self, time_name, state):
        src = field_of(state, self.field)
        if src is None:
            return
        keep = self.host(data_of(src)) > self.threshold
        parent = np.arange(keep.size)

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for o, m in zip(self.owner, self.nei):
            if keep[o] and keep[m]:
                a, b = find(int(o)), find(int(m))
                if a != b:
                    parent[max(a, b)] = min(a, b)
        vols = {}
        for c in np.nonzero(keep)[0]:
            r = find(int(c))
            vols[r] = vols.get(r, 0.0) + float(self.V[c])
        sizes = np.asarray(sorted(vols.values()))
        with open(self.path, "a") as f:
            if sizes.size == 0:
                f.write(f"{time_name} 0\n")
                return
            hist, edges = np.histogram(sizes, bins=self.n_bins)
            f.write(f"{time_name} {sizes.size} "
                    + " ".join(f"{e:.6g}:{h}" for e, h in
                               zip(edges[:-1], hist)) + "\n")


class FieldCoordinateSystemTransform(FunctionObject):
    """Vector fields rotated into a local (e1, e3) frame, one file per
    field and execute."""

    def __init__(self, name, spec, case):
        super().__init__(name, spec, case)
        self.fields = [str(f) for f in spec.get("fields", ["U"])]
        cs = spec.get("coordinateSystem", spec)
        e1 = np.asarray(cs.get("e1", (1.0, 0.0, 0.0)),
                        dtype=float).reshape(-1)[-3:]
        e3 = np.asarray(cs.get("e3", (0.0, 0.0, 1.0)),
                        dtype=float).reshape(-1)[-3:]
        e1 = e1 / np.linalg.norm(e1)
        e3 = e3 - e1 * (e3 @ e1)
        e3 = e3 / np.linalg.norm(e3)
        e2 = np.cross(e3, e1)
        self.R = np.stack([e1, e2, e3])      # rows: the local axes
        self.RT = torch.as_tensor(self.R.T, device=case.mesh.device)

    def execute(self, time_name, state):
        for nm in self.fields:
            src = field_of(state, nm)
            if src is None:
                continue
            d = data_of(src)
            if d.ndim != 2:
                continue
            loc = self.host(d.to(torch.float64) @ self.RT)
            out = os.path.join(self.out_dir,
                               f"{nm}Transformed_{time_name}.dat")
            with open(out, "w") as f:
                f.write(f"# {nm} in local frame (rows e1 e2 e3 = "
                        f"{self.R.tolist()})\n")
                np.savetxt(f, loc, fmt="%.8g")


class CourantNo(FunctionObject):
    """Mean and max Courant number from the face flux (CourantNo)."""

    def __init__(self, name, spec, case):
        super().__init__(name, spec, case)
        self.path = os.path.join(self.out_dir, "CourantNo.dat")
        if not os.path.exists(self.path):
            with open(self.path, "w") as f:
                f.write("# Time mean max\n")

    def execute(self, time_name, state):
        phi = state.get("phi")
        if phi is None:
            return
        dt = state.get("dt", self.case.time.delta_t)
        mesh = self.case.mesh
        # float64 sums, as the reference's numpy accumulator
        a = torch.abs(data_of(phi)).to(torch.float64)
        nif = mesh.n_internal_faces
        acc = torch.zeros(mesh.n_cells, dtype=torch.float64,
                          device=mesh.device)
        acc = acc.index_add(0, mesh.owner[:nif], a[:nif])
        acc = acc.index_add(0, mesh.neighbour[:nif], a[:nif])
        acc = acc.index_add(0, mesh.owner[nif:], a[nif:])
        co = 0.5 * acc / mesh.v * float(dt)
        mean, mx = self.host(torch.stack([co.mean(), co.max()]))
        with open(self.path, "a") as f:
            f.write(f"{time_name} {mean:.8g} {mx:.8g}\n")


class WriteDictionary(FunctionObject):
    """The named dictionaries' entries appended at every execute
    (writeDictionary)."""

    def __init__(self, name, spec, case):
        super().__init__(name, spec, case)
        self.names = [str(d) for d in spec.get("dictNames", [])]
        self.path = os.path.join(self.out_dir, "dictionaries.log")

    def execute(self, time_name, state):
        from ..core.dictionary import parse_file

        with open(self.path, "a") as f:
            for nm in self.names:
                for sub in ("system", "constant"):
                    p = os.path.join(self.case.dir, sub, nm)
                    if os.path.exists(p):
                        f.write(f"--- {nm} @ t={time_name}\n")
                        for k, v in parse_file(p).items():
                            f.write(f"    {k} {v}\n")
                        break


class TimeActivatedFileUpdate(FunctionObject):
    """Copy the staged file over fileToUpdate once its time has passed
    (timeActivatedFileUpdate, with runTimeModifiable)."""

    def __init__(self, name, spec, case):
        super().__init__(name, spec, case)
        self.target = str(spec.get("fileToUpdate", ""))
        self.table = [(float(r[0]), str(r[1]))
                      for r in spec.get("timeVsFile", [])
                      if isinstance(r, (list, tuple)) and len(r) >= 2]
        self.applied = -1

    def execute(self, time_name, state):
        try:
            t = float(time_name)
        except ValueError:
            return
        tgt = self.target.replace("$FOAM_CASE", self.case.dir)
        for i, (ti, src) in enumerate(self.table):
            if t >= ti and i > self.applied:
                s = src.replace("$FOAM_CASE", self.case.dir)
                if os.path.exists(s):
                    shutil.copyfile(s, tgt)
                    self.applied = i
                    print(f"timeActivatedFileUpdate: {s} -> {tgt} "
                          f"at t={time_name}")


register("readFields", ReadFields)
register("surfaceInterpolateFields", SurfaceInterpolateFields)
register("regionSizeDistribution", RegionSizeDistribution)
register("fieldCoordinateSystemTransform", FieldCoordinateSystemTransform)
register("CourantNo", CourantNo)
register("writeDictionary", WriteDictionary)
register("timeActivatedFileUpdate", TimeActivatedFileUpdate)
