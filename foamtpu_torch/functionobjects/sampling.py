"""Sampling and wall post-processing function objects (port of
openfoam-2.2.x_tpu/functionobjects/sampling.py: `_nu_of`,
`_wall_patches`, `_wall_shear`, yPlus / yPlusRAS, wallShearStress, sets
and streamLine; src/sampling/ and
src/postProcessing/functionObjects/{utilities,field}/).

The wall terms are computed on the state's device: the wall shear
tau_w = (nu + nut_w) dU/dn per wall face, with nut_w the nut field's wall
value (its wall-function BC) and nu from transportProperties; yPlus and
wallShearStress reduce it per patch there and fetch one small table per
call. sets and streamLine work on the host, as the reference does: the
nearest-cell lookups are made once (a KD-tree on the cell centres),
sets gathers the sampled values of all its sets and fields on the device
and fetches them in one copy, and streamLine fetches U once per call and
integrates its tracks in numpy. Files go under postProcessing/<name>/ in
the reference's layout.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

import numpy as np
import torch

from ..bc import patchfields as pfm
from .base import FunctionObject, data_of, field_of, register


def _nu_of(case) -> float:
    from ..core.dictionary import dimensioned_scalar

    try:
        _, nu = dimensioned_scalar(case.transport_properties()["nu"])
        return float(nu)
    except Exception:
        return 0.0


def _wall_patches(mesh, spec):
    pats = spec.get("patches")
    if pats is not None:
        names = {str(p) for p in (pats if isinstance(pats, list) else [pats])}
        return [p for p in mesh.patches if p.name in names]
    return [p for p in mesh.patches if p.type == "wall"]


def _wall_shear(mesh, state, nu) -> Dict[str, torch.Tensor]:
    """Per wall patch, the shear stress tau_w = (nu + nut_w) dU/dn
    [nPf,3] on the state's device."""
    U = state["U"]
    turb = state.get("turb") or {}
    nut_f = turb.get("nut")
    out = {}
    for p, bc in zip(mesh.patches, U.bcs):
        if p.type != "wall":
            continue
        cells = mesh.owner[p.slice]
        dc = mesh.delta_coeffs[p.slice]
        ub = pfm.evaluate(bc, mesh, p, U.data)
        dudn = (ub - U.data[cells]) * dc[:, None]
        nue = nu
        if nut_f is not None:
            for pp, nbc in zip(mesh.patches, nut_f.bcs):
                if pp.name == p.name:
                    nue = nu + pfm.evaluate(nbc, mesh, pp, nut_f.data)
        out[p.name] = (nue[:, None] if torch.is_tensor(nue) else nue) * dudn
    return out


def _patch_table(fo, rows):
    """Fetch the per-patch rows [(patch, tensor [k]), ...] in one copy."""
    if not rows:
        return []
    vals = fo.host(torch.stack([r for _, r in rows]))
    return [(p, v) for (p, _), v in zip(rows, vals)]


class YPlus(FunctionObject):
    """yPlus / yPlusRAS: y+ per wall patch from the wall shear
    (u_tau = sqrt(|tau_w|)); min, max and average written per step
    (utilities yPlusRAS and the yPlus functionObject)."""

    def __init__(self, name, spec, case):
        super().__init__(name, spec, case)
        self.path = os.path.join(self.out_dir, "yPlus.dat")
        if not os.path.exists(self.path):
            with open(self.path, "w") as f:
                f.write("# Time patch min max average\n")

    def execute(self, time_name, state):
        mesh = self.case.mesh
        nu = _nu_of(self.case)
        taus = _wall_shear(mesh, state, nu)
        rows = []
        for p in _wall_patches(mesh, self.spec):
            tau = taus.get(p.name)
            if tau is None:
                continue
            y = 1.0 / torch.clamp(mesh.delta_coeffs[p.slice], min=1e-30)
            utau = torch.sqrt(torch.linalg.norm(tau, dim=1))
            ypl = utau * y / max(nu, 1e-30)
            rows.append((p, torch.stack([ypl.min(), ypl.max(),
                                         ypl.mean()])))
        lines = [f"{time_name} {p.name} {v[0]:.6g} {v[1]:.6g} {v[2]:.6g}\n"
                 for p, v in _patch_table(self, rows)]
        with open(self.path, "a") as f:
            f.writelines(lines)


class WallShearStress(FunctionObject):
    """wallShearStress (functionObjects/utilities/wallShearStress): per
    wall patch, the min and max of the shear vector's magnitude."""

    def __init__(self, name, spec, case):
        super().__init__(name, spec, case)
        self.path = os.path.join(self.out_dir, "wallShearStress.dat")
        if not os.path.exists(self.path):
            with open(self.path, "w") as f:
                f.write("# Time patch min max\n")

    def execute(self, time_name, state):
        mesh = self.case.mesh
        taus = _wall_shear(mesh, state, _nu_of(self.case))
        rows = []
        for p in _wall_patches(mesh, self.spec):
            tau = taus.get(p.name)
            if tau is None:
                continue
            mag = torch.linalg.norm(tau, dim=1)
            rows.append((p, torch.stack([mag.min(), mag.max()])))
        lines = [f"{time_name} {p.name} {v[0]:.6g} {v[1]:.6g}\n"
                 for p, v in _patch_table(self, rows)]
        with open(self.path, "a") as f:
            f.writelines(lines)


class SampledSets(FunctionObject):
    """sets: line and cloud sampling of fields by nearest cell
    (src/sampling/sampledSet/ and the `sets` functionObject). Set types:
    uniform (start, end, nPoints; also lineUniform, midPoint,
    midPointAndFace, face) and cloud (points). Writes
    <time>/<setName>_<fields>.xy in the raw format."""

    def __init__(self, name, spec, case):
        super().__init__(name, spec, case)
        from scipy.spatial import cKDTree

        self.fields = [str(f) for f in spec.get("fields", ["U", "p"])]
        self.sets: List[Dict[str, Any]] = []
        sets = spec.get("sets", {})
        items = (sets.items() if hasattr(sets, "items")
                 else [(s.get("name", f"set{i}"), s)
                       for i, s in enumerate(sets)])
        mesh = case.mesh
        tree = cKDTree(self.host(mesh.c))
        for sname, sd in items:
            stype = str(sd.get("type", "uniform"))
            if stype in ("uniform", "lineUniform", "midPoint",
                         "midPointAndFace", "face"):
                start = np.asarray(sd.get("start"), dtype=float).reshape(3)
                end = np.asarray(sd.get("end"), dtype=float).reshape(3)
                n = int(sd.get("nPoints", 100))
                pts = start[None, :] + (end - start)[None, :] * \
                    np.linspace(0.0, 1.0, n)[:, None]
            elif stype == "cloud":
                pts = np.asarray(sd.get("points"), dtype=float).reshape(-1, 3)
            else:
                raise ValueError(f"unknown set type {stype!r}")
            _, idx = tree.query(pts)
            self.sets.append({"name": str(sname),
                              "idx": torch.as_tensor(idx, device=mesh.device),
                              "dist": np.linalg.norm(pts - pts[0], axis=1)})

    def execute(self, time_name, state):
        tdir = os.path.join(self.out_dir, time_name)
        os.makedirs(tdir, exist_ok=True)
        present = [(f, field_of(state, f)) for f in self.fields]
        present = [(f, src) for f, src in present if src is not None]
        # every set's values of every field, gathered on the device
        parts = []
        for s in self.sets:
            for _, src in present:
                parts.append(data_of(src)[s["idx"]].reshape(-1))
        flat = self.host(torch.cat(parts)) if parts else None
        off = 0
        for s in self.sets:
            n = s["idx"].shape[0]
            cols = [s["dist"]]
            for _, src in present:
                w = 1 if data_of(src).ndim == 1 else data_of(src).shape[1]
                vals = flat[off:off + n * w].reshape(n, w)
                off += n * w
                if w == 1:
                    cols.append(vals[:, 0])
                else:
                    cols.extend(vals.T)
            arr = np.column_stack(cols)
            names = "_".join(f for f, _ in present)
            np.savetxt(os.path.join(tdir, f"{s['name']}_{names}.xy"), arr,
                       fmt="%.8g")


class StreamLine(FunctionObject):
    """streamLine (functionObjects/field/streamLine): trajectories
    through the cell-centred velocity (RK2, nearest-cell lookup) from
    seed points; writes <time>/tracks.xy."""

    def __init__(self, name, spec, case):
        super().__init__(name, spec, case)
        from scipy.spatial import cKDTree

        sd = spec.get("seedSampleSet", spec)
        if "points" in sd:
            self.seeds = np.asarray(sd.get("points"),
                                    dtype=float).reshape(-1, 3)
        else:
            start = np.asarray(sd.get("start", (0, 0, 0)),
                               dtype=float).reshape(3)
            end = np.asarray(sd.get("end", (1, 0, 0)),
                             dtype=float).reshape(3)
            n = int(sd.get("nPoints", 10))
            self.seeds = start[None, :] + (end - start)[None, :] * \
                np.linspace(0.0, 1.0, n)[:, None]
        self.n_steps = int(spec.get("lifeTime", 200))
        mesh = case.mesh
        c = self.host(mesh.c)
        self._tree = cKDTree(c)
        # step length ~ half a cell size
        self._h = 0.5 * float(np.mean(np.cbrt(self.host(mesh.v))))
        self._lo, self._hi = c.min(axis=0), c.max(axis=0)

    def execute(self, time_name, state):
        U = self.host(state["U"].data)

        def vel(p):
            _, i = self._tree.query(p)
            return U[i]

        tdir = os.path.join(self.out_dir, time_name)
        os.makedirs(tdir, exist_ok=True)
        rows = []
        for si, seed in enumerate(self.seeds):
            p = seed.copy()
            rows.append((si, *p))
            for _ in range(self.n_steps):
                u1 = vel(p)
                sp = np.linalg.norm(u1)
                if sp < 1e-12:
                    break
                h = self._h / sp
                mid = p + 0.5 * h * u1
                u2 = vel(mid)
                p = p + h * u2
                if np.any(p < self._lo - self._h * 4) or \
                        np.any(p > self._hi + self._h * 4):
                    break
                rows.append((si, *p))
        np.savetxt(os.path.join(tdir, "tracks.xy"), np.asarray(rows),
                   fmt="%d %.8g %.8g %.8g")


register("yPlus", YPlus)
register("yPlusRAS", YPlus)
register("wallShearStress", WallShearStress)
register("sets", SampledSets)
register("streamLine", StreamLine)
