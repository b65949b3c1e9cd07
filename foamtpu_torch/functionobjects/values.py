"""fieldValues and run-control function objects (port of
openfoam-2.2.x_tpu/functionobjects/values.py;
src/postProcessing/functionObjects/field/fieldValues/{cellSource,
faceSource}, utilities/systemCall, jobControl/abortCalculation,
field/nearWallFields).

cellSource / faceSource reduce on the device and fetch their results in
one copy per execute. nearWallFields writes a field, so it fetches that
field. systemCall runs its commands in the process's working directory,
as the reference does.
"""

from __future__ import annotations

import os
import subprocess

import numpy as np
import torch

from .base import FunctionObject, data_of, field_of, register


def _weighted_sum(v, w):
    return (v * w[:, None] if v.ndim == 2 else v * w).sum(dim=0)


def _op(op: str, v, w, w_sum: float):
    """The reduction `op` of the selected values v [n(,C)] with weights w
    [n] whose sum is w_sum (computed once on the host)."""
    if op in ("sum", "volIntegrate", "areaIntegrate"):
        return _weighted_sum(v, w)
    if op in ("average", "weightedAverage", "volAverage", "areaAverage"):
        return _weighted_sum(v, w) / max(w_sum, 1e-300)
    if op == "min":
        return torch.amin(v, dim=0)
    if op == "max":
        return torch.amax(v, dim=0)
    if op == "none":
        return v.new_zeros(())
    raise KeyError(op)


def _fmt(x) -> str:
    x = np.asarray(x)
    if x.ndim == 0:
        return f"{float(x):.8g}"
    return "(" + " ".join(f"{float(v):.8g}" for v in x) + ")"


def _reduce_and_write(fo, path, time_name, results):
    """One fetch for all the results ([] or [C] tensors, None for a
    missing field), one row of the series file."""
    have = [r.reshape(-1) for r in results if r is not None]
    flat = fo.host(torch.cat(have)) if have else np.zeros(0)
    vals, i = [], 0
    for r in results:
        if r is None:
            vals.append("n/a")
            continue
        k = r.numel()
        vals.append(_fmt(flat[i] if r.ndim == 0 else flat[i:i + k]))
        i += k
    with open(path, "a") as f:
        f.write(f"{time_name} " + " ".join(vals) + "\n")


class FieldValueCell(FunctionObject):
    """fieldValues cellSource: reduce fields over a cellZone, a box or
    all cells with volume weights."""

    def __init__(self, name, spec, case):
        super().__init__(name, spec, case)
        self.fields = [str(f) for f in spec.get("fields", [])]
        self.op = str(spec.get("operation", "volAverage"))
        mesh = case.mesh
        src = str(spec.get("source", spec.get("regionType", "all")))
        c = mesh.c.cpu().numpy()
        if src in ("cellZone", "cellZoneToCell"):
            zname = str(spec.get("sourceName", spec.get("name", "")))
            masks = getattr(mesh, "cell_zone_masks", None) or {}
            mask = np.asarray(masks.get(zname, np.ones(mesh.n_cells)))
        elif src == "box":
            box = np.asarray(spec.get("box"), float).reshape(2, 3)
            mask = np.all((c >= box[0]) & (c <= box[1]),
                          axis=1).astype(float)
        else:
            mask = np.ones(mesh.n_cells)
        w = mesh.v.cpu().numpy() * mask
        sel = np.nonzero(mask > 0)[0]
        self.sel = torch.as_tensor(sel, device=mesh.device)
        self.w = torch.as_tensor(w[sel], device=mesh.device)
        self.w_sum = float(w[sel].sum())
        self.path = os.path.join(self.out_dir, "fieldValue.dat")
        if not os.path.exists(self.path):
            with open(self.path, "w") as f:
                f.write(f"# Time {self.op} " + " ".join(self.fields) + "\n")

    def execute(self, time_name, state):
        results = []
        for name in self.fields:
            srcf = field_of(state, name)
            results.append(None if srcf is None else _op(
                self.op, data_of(srcf)[self.sel], self.w, self.w_sum))
        _reduce_and_write(self, self.path, time_name, results)


class FieldValueFace(FunctionObject):
    """fieldValues faceSource: reduce fields over one patch with area
    weights."""

    def __init__(self, name, spec, case):
        super().__init__(name, spec, case)
        self.fields = [str(f) for f in spec.get("fields", [])]
        self.op = str(spec.get("operation", "areaAverage"))
        pname = str(spec.get("sourceName", spec.get("name", "")))
        mesh = case.mesh
        self.patch = next((p for p in mesh.patches if p.name == pname), None)
        if self.patch is None:
            raise ValueError(f"fieldValues {name!r}: no patch {pname!r}")
        self.w = mesh.mag_sf[self.patch.slice]
        self.w_sum = float(self.w.cpu().numpy().sum())
        nif = mesh.n_internal_faces
        self.bslice = slice(self.patch.slice.start - nif,
                            self.patch.slice.stop - nif)
        self.path = os.path.join(self.out_dir, "faceSource.dat")
        if not os.path.exists(self.path):
            with open(self.path, "w") as f:
                f.write(f"# Time {self.op}({pname}) "
                        + " ".join(self.fields) + "\n")

    def execute(self, time_name, state):
        mesh = self.case.mesh
        results = []
        for name in self.fields:
            srcf = field_of(state, name)
            if srcf is None or not hasattr(srcf, "boundary_values"):
                results.append(None)
                continue
            bv = srcf.boundary_values(mesh)[self.bslice]
            results.append(_op(self.op, bv, self.w, self.w_sum))
        _reduce_and_write(self, self.path, time_name, results)


def _field_values(name, spec, case):
    t = str(spec.get("type", ""))
    src = str(spec.get("source", spec.get("regionType", "all")))
    if t == "faceSource" or src in ("faceSource", "patch", "patchToFace"):
        return FieldValueFace(name, spec, case)
    return FieldValueCell(name, spec, case)


class SystemCall(FunctionObject):
    """systemCall: run shell commands at every execute (executeCalls, or
    writeCalls, at the same hook)."""

    def __init__(self, name, spec, case):
        super().__init__(name, spec, case)
        calls = spec.get("executeCalls", spec.get("writeCalls", []))
        self.calls = [str(x) for x in
                      (calls if isinstance(calls, list) else [calls])]

    def execute(self, time_name, state):
        for cmd in self.calls:
            subprocess.run(cmd, shell=True, check=False)  # noqa: S602


class AbortCalculation(FunctionObject):
    """abortCalculation: stop the run at the next step boundary once the
    trigger file exists (sets Time.stop_now)."""

    def __init__(self, name, spec, case):
        super().__init__(name, spec, case)
        self.file = str(spec.get("fileName",
                                 os.path.join(case.dir, "ABORT")))
        if not os.path.isabs(self.file):
            self.file = os.path.join(case.dir, self.file)

    def execute(self, time_name, state):
        if os.path.exists(self.file):
            self.case.time.stop_now = True
            print(f"abortCalculation: trigger {self.file} found — stopping")


class NearWallFields(FunctionObject):
    """nearWallFields: the wall-adjacent cell values of fields, zero
    elsewhere, written as <field>Near volFields at every execute (the
    reference samples the wall-adjacent cell)."""

    def __init__(self, name, spec, case):
        super().__init__(name, spec, case)
        items = spec.get("fields", [])
        flat = []
        for x in (items if isinstance(items, list) else [items]):
            flat.extend(np.asarray(x, dtype=object).reshape(-1)
                        if isinstance(x, (list, tuple, np.ndarray)) else [x])
        self.pairs = [(str(flat[i]), str(flat[i + 1]))
                      for i in range(0, len(flat) - 1, 2)] or [("U", "UNear")]
        self.patches = [str(x) for x in spec.get("patches", [])]
        mesh = case.mesh
        own = [mesh.owner[p.slice] for p in mesh.patches
               if (not self.patches and p.type == "wall")
               or p.name in self.patches]
        self.own = torch.cat(own) if own else None

    def execute(self, time_name, state):
        from ..core.fields import vol_scalar, vol_vector
        from ..io import fields as field_io

        if self.own is None:
            return
        mesh = self.case.mesh
        for src_name, dst_name in self.pairs:
            srcf = field_of(state, src_name)
            if srcf is None:
                continue
            d = data_of(srcf)
            out = torch.zeros_like(d)
            out[self.own] = d[self.own]
            mk = vol_vector if d.ndim == 2 else vol_scalar
            f = mk(mesh, (0.0, 0.0, 0.0) if d.ndim == 2 else 0.0,
                   name=dst_name).with_data(out)
            self.fetches += 1        # write_field copies the data out
            field_io.write_field(f, mesh, self.case.dir, time_name)


register("fieldValues", _field_values)
register("cellSource", _field_values)
register("faceSource", _field_values)
register("systemCall", SystemCall)
register("abortCalculation", AbortCalculation)
register("nearWallFields", NearWallFields)
