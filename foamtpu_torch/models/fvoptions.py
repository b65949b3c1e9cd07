"""fvOptions — run-time-selectable sources and constraints injected into
equations (port of openfoam-2.2.x_tpu/models/fvoptions.py; OpenFOAM's
src/fvOptions, fv::option and fv::optionList, read from system/fvOptions,
constant/fvOptions and constant/porousZones).

Option types:

- semiImplicitSource        explicit Su + implicit Sp volume sources
- meanVelocityForce /       body force adjusted every corrector to hold
  pressureGradientExplicitSource  a prescribed bulk velocity Ubar
- explicitPorositySource /  Darcy-Forchheimer porous sink
  DarcyForchheimer          -(nu d + |U|/2 f) U on the zone, d and f
                            rotated by the zone's coordinateSystem
- actuationDiskSource       actuator disk, T = 2 A a (1-a) Uo^2 over the zone
- radialActuationDiskSource the same thrust with a radial profile
- rotorDiskSource           blade-element rotor: thrust and swirl per cell
                            from twist/chord blade tables and a cl/cd
                            lookup profile (trimModel fixed)
- codedSource               a Python `codeAddSup` snippet run once at parse
                            (np, and jnp as utils/tnp.py)
- fixedTemperatureConstraint, temperatureLimitsConstraint
- MRFSource                 the MRF zone's Coriolis term -(omega x U)

Zone selection (selectionMode): `all`, `box` on cell centres, or a mesh
`cellZone`. Option data is built on the host once; per-corrector state
(meanVelocityForce's pressure gradient, a 0-d tensor, so that no corrector
waits on the host) lives in the solver state under state["fvopt"].
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.dictionary import FoamDict, parse_file
from ..ops.matrix import FvMatrix


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _dev(mesh, a) -> torch.Tensor:
    """A host array (or number) as a tensor in the mesh's dtype and
    device."""
    return torch.as_tensor(np.asarray(a, dtype=float), dtype=mesh.v.dtype,
                           device=mesh.device)


def _zone_mask(mesh, spec: FoamDict) -> torch.Tensor:
    """The option's [nC] 1/0 cell mask."""
    mode = str(spec.get("selectionMode", "all"))
    if mode == "all":
        return torch.ones_like(mesh.v)
    if mode in ("box", "boxToCell"):
        c = _host(mesh.c)
        box = np.asarray(spec.get("box")).reshape(2, 3)
        m = np.all((c >= box[0]) & (c <= box[1]), axis=1)
        return _dev(mesh, m.astype(float))
    if mode == "cellZone":
        name = str(spec.get("cellZone", spec.get("zoneName", "")))
        masks = getattr(mesh, "cell_zone_masks", None) or {}
        if name not in masks:
            raise KeyError(
                f"cellZone {name!r} not found in mesh cellZones "
                f"(have: {sorted(masks)})")
        return masks[name].to(mesh.v.dtype)
    raise ValueError(f"unknown selectionMode {mode!r}")


def _vec(v) -> np.ndarray:
    return np.asarray(v, dtype=float).reshape(3)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor
           ) -> torch.Tensor:
    """Piecewise-linear interpolation of the table (xp, fp) at x, held at
    the end values outside the table (numpy's and jnp.interp's rule,
    computed as jnp.interp computes it)."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = np.spacing(np.finfo(str(xp.dtype).split(".")[-1]).eps)
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


@dataclasses.dataclass
class Option:
    name: str
    kind: str
    mask: Any                  # [nC] 1/0 zone mask
    fields: Tuple[str, ...]
    data: Dict[str, Any]       # host numbers and arrays, as parsed
    dev: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def t(self, mesh, key) -> torch.Tensor:
        """data[key] on the mesh's device, converted once."""
        if key not in self.dev:
            self.dev[key] = _dev(mesh, self.data[key])
        return self.dev[key]

    # ---- equation hooks -----------------------------------------------------
    def add_to(self, mesh, eqn: FvMatrix, field_name: str, field,
               U=None, fvopt_state=None, rho=None, mu=None) -> FvMatrix:
        """rho/mu: given for mass-weighted equations (interFoam's
        porousInterFoam); the porous drag is then mu d + rho/2 |U| f."""
        if field_name not in self.fields:
            return eqn
        k, d, m = self.kind, self.data, self.mask
        v = mesh.v
        if k == "semiImplicitSource":
            su, sp = d["Su"].get(field_name), d["Sp"].get(field_name)
            if su is not None:
                su_v = _dev(mesh, su)
                vm = v * m
                add = (vm[:, None] * su_v[None, :] if np.ndim(su) == 1
                       else vm * su_v)
                eqn = eqn.replace_fields(source=eqn.source + add)
            if sp is not None:
                # implicit sp*psi: diag -= V*sp (sp < 0 stabilises)
                eqn = eqn.replace_fields(diag=eqn.diag - v * m * float(sp))
            return eqn
        if k == "codedSource":
            src = self.t(mesh, "source")
            vm = v * m
            add = vm[:, None] * src if src.ndim == 2 else vm * src
            return eqn.replace_fields(source=eqn.source + add)
        if k == "meanVelocityForce":
            gradp = (fvopt_state or {}).get(f"gradP_{self.name}")
            if gradp is None:
                gradp = v.new_zeros(())
            fdir = self.t(mesh, "flowDir")
            add = (v * m)[:, None] * gradp * fdir[None, :]
            return eqn.replace_fields(source=eqn.source + add)
        if k == "explicitPorositySource":
            nu = float(d.get("nu", 0.0))
            magU = torch.linalg.norm(U.data, dim=1)
            # anisotropic Darcy-Forchheimer: C = visc D + rho/2 |U| F in
            # mesh axes (D, F = R diag(d, f) R^T); the isotropic part
            # tr(C)/3 on the diagonal, the rest an explicit source
            Dm, Fm = self.t(mesh, "D"), self.t(mesh, "F")
            if rho is not None:
                visc = mu if mu is not None else nu * rho
                half_f = 0.5 * magU * rho
            else:
                visc = torch.as_tensor(nu, dtype=v.dtype, device=v.device)
                half_f = 0.5 * magU
            C = (torch.broadcast_to(visc, magU.shape)[:, None, None]
                 * Dm[None] + half_f[:, None, None] * Fm[None])
            iso = torch.diagonal(C, dim1=1, dim2=2).sum(dim=1) / 3.0
            aniso = C - iso[:, None, None] * torch.eye(
                3, dtype=C.dtype, device=C.device)
            src = (-torch.einsum("cij,cj->ci", aniso, U.data)
                   * (v * m)[:, None])
            return eqn.replace_fields(diag=eqn.diag + v * m * iso,
                                      source=eqn.source + src)
        if k == "actuationDiskSource":
            a = 1.0 - float(d["Cp"]) / max(float(d["Ct"]), 1e-30)
            ddir = _vec(d["diskDir"])
            ddir = ddir / max(np.linalg.norm(ddir), 1e-30)
            upstream = _dev(mesh, d.get("upstreamU", 1.0))
            vol_zone = torch.clamp(torch.sum(v * m), min=1e-30)
            T = 2.0 * float(d["diskArea"]) * upstream ** 2 * a * (1.0 - a)
            f = -(T / vol_zone) * _dev(mesh, ddir)
            return eqn.replace_fields(
                source=eqn.source + (v * m)[:, None] * f[None, :])
        if k == "rotorDiskSource":
            # blade-element rotor (OpenFOAM's rotorDiskSource with
            # trimModel fixed). A zone cell at radius r sees the relative
            # wind (u_ax, u_th - omega r) in (axis, tangent) axes; with
            # the inflow angle phi = atan2(-u_ax, omega r - u_th) and the
            # angle of attack twist(r) - phi, the profile's cl/cd give the
            # force on the fluid per unit span, spread over the annulus
            # volume by nB/(2 pi r dz)
            axis_v, e_t = self.t(mesh, "axis"), self.t(mesh, "e_t")
            r = self.t(mesh, "r_cell")
            omega = float(d["omega"])
            u_ax = U.data @ axis_v
            u_th = torch.sum(U.data * e_t, dim=1)
            w_t = omega * r - u_th
            phi_i = torch.arctan2(-u_ax, torch.where(
                torch.abs(w_t) > 1e-12, w_t, torch.full_like(w_t, 1e-12)))
            alpha = self.t(mesh, "twist_cell") - phi_i
            aoa = self.t(mesh, "aoa_tab")
            cl = interp(alpha, aoa, self.t(mesh, "cl_tab"))
            cd = interp(alpha, aoa, self.t(mesh, "cd_tab"))
            V2 = u_ax ** 2 + w_t ** 2
            # q in kinematic units for the incompressible U equation (the
            # rhoRef of OpenFOAM's form divides back out: parsed, unused);
            # the local rho for mass-weighted rows
            q = 0.5 * V2 * self.t(mesh, "chord_cell") * (
                rho if rho is not None else 1.0)
            cphi, sphi = torch.cos(phi_i), torch.sin(phi_i)
            f_a = -(cl * cphi - cd * sphi) * q
            f_t = (cl * sphi + cd * cphi) * q
            dens = self.t(mesh, "dens")
            fvec = ((f_a * dens)[:, None] * axis_v[None, :]
                    + (f_t * dens)[:, None] * e_t)
            return eqn.replace_fields(
                source=eqn.source + (v * m)[:, None] * fvec)
        if k == "MRFSource":
            omega = self.t(mesh, "omega_vec")
            wxu = torch.linalg.cross(omega.expand_as(U.data), U.data, dim=1)
            return eqn.replace_fields(
                source=eqn.source - (v * m)[:, None] * wxu)
        if k == "fixedTemperatureConstraint":
            # exact row replacement in the zone
            tset = torch.full_like(v, float(d["temperature"]))
            return eqn.set_values(m, tset, mesh)
        if k == "temperatureLimitsConstraint":
            # constrain only the cells now outside the limits to the
            # clipped value (OpenFOAM applies it after the solve; the
            # in-matrix form converges to the same fixed point)
            tmin, tmax = float(d["Tmin"]), float(d["Tmax"])
            cur = field.data if hasattr(field, "data") else field
            viol = m * ((cur < tmin) | (cur > tmax)).to(v.dtype)
            return eqn.set_values(viol, torch.clamp(cur, tmin, tmax), mesh)
        if k == "radialActuationDiskSource":
            a = 1.0 - float(d["Cp"]) / max(float(d["Ct"]), 1e-30)
            ddir = _vec(d["diskDir"])
            ddir = ddir / max(np.linalg.norm(ddir), 1e-30)
            upstream = _dev(mesh, d.get("upstreamU", 1.0))
            T = 2.0 * float(d["diskArea"]) * upstream ** 2 * a * (1.0 - a)
            # radial profile T (c0 + c1 r^2 + c2 r^4), normalised so the
            # zone-integrated thrust is T
            r = self.t(mesh, "r_cell")
            c0, c1, c2 = (float(x) for x in d["coeffs"])
            prof = c0 + c1 * r ** 2 + c2 * r ** 4
            wsum = torch.clamp(torch.sum(v * m * prof), min=1e-30)
            f_mag = T * prof / wsum
            add = -(v * m * f_mag)[:, None] * _dev(mesh, ddir)[None, :]
            return eqn.replace_fields(source=eqn.source + add)
        return eqn

    # ---- after the correctors: meanVelocityForce's gradient -----------------
    def correct(self, mesh, U, rAU, fvopt_state: Dict) -> Tuple[Any, Dict]:
        if self.kind != "meanVelocityForce":
            return U, fvopt_state
        m, v = self.mask, mesh.v
        fdir = self.t(mesh, "flowDir")
        ubar = float(self.data["Ubar_mag"])
        vz = torch.clamp(torch.sum(v * m), min=1e-30)
        ubar_now = torch.sum(v * m * (U.data @ fdir)) / vz
        rAU_bar = torch.sum(v * m * rAU) / vz
        dgrad = (ubar - ubar_now) / torch.clamp(rAU_bar, min=1e-30)
        # U nudged at once (U += rAU dGradP dir); gradP accumulated for
        # the next corrector's source
        Unew = U.with_data(U.data + (m * rAU * dgrad)[:, None] * fdir[None, :])
        key = f"gradP_{self.name}"
        st = dict(fvopt_state)
        old = st.get(key)
        st[key] = (v.new_zeros(()) if old is None else old) + dgrad
        return Unew, st


class OptionList:
    """fv::optionList — applies every active option to an equation."""

    def __init__(self, options: List[Option]):
        self.options = options

    def __bool__(self):
        return bool(self.options)

    def add_to(self, mesh, eqn, field_name, field, U=None,
               fvopt_state=None, rho=None, mu=None):
        for o in self.options:
            eqn = o.add_to(mesh, eqn, field_name, field, U=U,
                           fvopt_state=fvopt_state, rho=rho, mu=mu)
        return eqn

    def correct_U(self, mesh, U, rAU, fvopt_state: Optional[Dict]):
        st = dict(fvopt_state or {})
        for o in self.options:
            U, st = o.correct(mesh, U, rAU, st)
        return U, st

    def init_state(self, mesh) -> Dict:
        return {f"gradP_{o.name}": mesh.v.new_zeros(())
                for o in self.options if o.kind == "meanVelocityForce"}


def _coord_rotation(spec: FoamDict) -> np.ndarray:
    """coordinateSystem { coordinateRotation { e1 (..); e2/e3 (..); } }
    -> the rotation R whose columns are the local axes (axesRotation)."""
    cs = spec.get("coordinateSystem", spec)
    rot = cs.get("coordinateRotation", cs) if hasattr(cs, "get") else cs
    if not hasattr(rot, "get"):
        return np.eye(3)
    e1 = rot.get("e1")
    if e1 is None:
        return np.eye(3)
    e1 = _vec(e1)
    e1 = e1 / max(np.linalg.norm(e1), 1e-30)
    if rot.get("e2") is not None:
        e2 = _vec(rot.get("e2"))
        e2 = e2 - (e2 @ e1) * e1
        e2 = e2 / max(np.linalg.norm(e2), 1e-30)
        e3 = np.cross(e1, e2)
    else:
        e3 = _vec(rot.get("e3", (0.0, 0.0, 1.0)))
        e3 = e3 - (e3 @ e1) * e1
        e3 = e3 / max(np.linalg.norm(e3), 1e-30)
        e2 = np.cross(e3, e1)
    return np.stack([e1, e2, e3], axis=1)


def _rotated_tensor(vec3: np.ndarray, R: np.ndarray) -> np.ndarray:
    """R diag(v) R^T — the principal-axis tensor in mesh axes."""
    return R @ np.diag(np.asarray(vec3, float)) @ R.T


def _porosity(name, mask, dvec, fvec, nu, R) -> Option:
    return Option(name, "explicitPorositySource", mask, ("U",),
                  {"d": dvec, "f": fvec, "nu": nu,
                   "D": _rotated_tensor(dvec, R),
                   "F": _rotated_tensor(fvec, R)})


def _coded_source(mesh, name: str, code: str) -> np.ndarray:
    """Run a codedSource snippet once with np, jnp (the port's jax.numpy
    subset over torch, utils/tnp.py), C [nC,3] (cell centres) and V [nC]
    in scope; it assigns `source` ([nC] or [nC,3], per volume)."""
    from ..utils import tnp

    ns = {"np": np, "jnp": tnp, "C": _host(mesh.c), "V": _host(mesh.v),
          "source": None}
    exec(compile(str(code), f"<codedSource:{name}>", "exec"), ns)  # noqa: S102
    src = ns.get("source")
    if src is None:
        raise ValueError(f"codedSource {name!r}: the snippet must "
                         "assign `source`")
    if isinstance(src, torch.Tensor):
        src = src.detach().cpu().numpy()
    return np.asarray(src, dtype=float)


def _rotor_disk(mesh, name, sub, mask) -> Option:
    """rotorDiskSource: origin/axis (geometryMode specified); blade rows
    (profileName (r twist_deg chord)) or (r (twist chord)); one lookup
    profile { data ((aoa_deg (cd cl)) ...) }."""
    origin = _vec(sub.get("origin", (0.0, 0.0, 0.0)))
    axis = _vec(sub.get("axis", (0.0, 0.0, 1.0)))
    axis = axis / max(np.linalg.norm(axis), 1e-30)
    omega = float(sub.get("rpm", 0.0)) * 2.0 * np.pi / 60.0
    n_blades = float(sub.get("nBlades", 2))
    tip = float(sub.get("tipEffect", 1.0))
    rs, tws, chs = [], [], []
    for row in (sub.get("blade", FoamDict()) or FoamDict()).get("data", []):
        row = list(row)
        if row and isinstance(row[0], str):   # (name (r tw ch))
            row = list(np.asarray(row[1], float).reshape(-1))
        else:
            row = [y for x in row for y in np.asarray(x, float).reshape(-1)]
        rs.append(row[0])
        tws.append(row[1])
        chs.append(row[2])
    if not rs:
        rs, tws, chs = [0.0, 1.0], [8.0, 8.0], [0.1, 0.1]
    rs, tws, chs = (np.asarray(rs, float), np.asarray(tws, float),
                    np.asarray(chs, float))
    aoa, cdt, clt = [], [], []
    for _, pspec in (sub.get("profiles", FoamDict()) or FoamDict()).items():
        if not hasattr(pspec, "get"):
            continue
        for prow in pspec.get("data", []):
            prow = list(prow)
            vals = (list(np.asarray(prow[-1], float).reshape(-1))
                    if isinstance(prow[-1], (list, tuple, np.ndarray))
                    else prow[1:])
            aoa.append(float(np.asarray(prow[0], float).reshape(-1)[0]))
            cdt.append(float(vals[0]))
            clt.append(float(vals[1]))
        break   # one profile, as the reference reads it
    if not aoa:   # flat-plate-ish default: cl = 0.1/deg, cd = 0.02
        aoa, cdt, clt = [-90.0, 0.0, 90.0], [0.02] * 3, [-2.0, 0.0, 2.0]
    order = np.argsort(aoa)
    c, v = _host(mesh.c), _host(mesh.v)
    rel = c - origin
    r_vec = rel - np.outer(rel @ axis, axis)
    r_cell = np.linalg.norm(r_vec, axis=1)
    e_r = r_vec / np.maximum(r_cell, 1e-30)[:, None]
    e_t = np.cross(np.broadcast_to(axis, e_r.shape), e_r)
    r_min, r_max = float(rs.min()), float(rs.max())
    mnp = _host(mask) * ((r_cell >= r_min) & (r_cell <= tip * r_max))
    vol_zone = float(np.sum(v * mnp))
    dz = max(vol_zone / max(np.pi * (r_max ** 2 - r_min ** 2), 1e-30), 1e-9)
    fields = tuple(str(f) for f in sub.get("fields", ["U"]))
    return Option(name, "rotorDiskSource", _dev(mesh, mnp), fields or ("U",), {
        "axis": axis, "origin": origin, "omega": omega, "e_t": e_t,
        "r_cell": r_cell, "twist_cell": np.deg2rad(np.interp(r_cell, rs, tws)),
        "chord_cell": np.interp(r_cell, rs, chs),
        "aoa_tab": np.deg2rad(np.asarray(aoa, float)[order]),
        "cl_tab": np.asarray(clt, float)[order],
        "cd_tab": np.asarray(cdt, float)[order],
        "dens": n_blades / (2.0 * np.pi * np.maximum(r_cell, 1e-6) * dz),
        # parsed and unused, as in the reference (its q is kinematic)
        "rhoRef": float(sub.get("rhoRef", 1.0))})


def _parse_option(mesh, name: str, spec: FoamDict, nu: float) -> Option:
    kind = str(spec.get("type"))
    sub = spec.get(f"{kind}Coeffs", spec)
    mask = _zone_mask(mesh, sub if "selectionMode" in sub else spec)
    if kind == "semiImplicitSource":
        su: Dict[str, Any] = {}
        sp: Dict[str, Any] = {}
        for fname, pair in sub.get("injectionRateSuSp", FoamDict()).items():
            fname = str(fname)
            arr = (list(pair) if isinstance(pair, (list, tuple))
                   else list(np.asarray(pair, dtype=object).reshape(-1)))
            su[fname] = np.asarray(arr[0], dtype=float)
            sp[fname] = float(arr[1]) if len(arr) > 1 else 0.0
        return Option(name, kind, mask, tuple(su), {"Su": su, "Sp": sp})
    if kind in ("meanVelocityForce", "pressureGradientExplicitSource",
                "patchMeanVelocityForce"):
        ub = _vec(sub.get("Ubar"))
        mag = float(np.linalg.norm(ub))
        fields = tuple(str(f) for f in sub.get("fieldNames", ["U"]))
        return Option(name, "meanVelocityForce", mask, fields or ("U",),
                      {"Ubar_mag": mag, "flowDir": ub / max(mag, 1e-30)})
    if kind in ("explicitPorositySource", "DarcyForchheimer"):
        dtab = sub.get("DarcyForchheimerCoeffs", sub)
        dvec = _vec(sub["d"] if "d" in sub else dtab.get("d", (0.0, 0.0, 0.0)))
        fvec = _vec(sub["f"] if "f" in sub else dtab.get("f", (0.0, 0.0, 0.0)))
        R = _coord_rotation(dtab if hasattr(dtab, "get") else sub)
        return _porosity(name, mask, dvec, fvec, nu, R)
    if kind in ("actuationDiskSource", "radialActuationDiskSource"):
        data = {"Cp": float(sub.get("Cp", 0.386)),
                "Ct": float(sub.get("Ct", 0.58)),
                "diskArea": float(sub.get("diskArea", 1.0)),
                "diskDir": _vec(sub.get("diskDir", (1.0, 0.0, 0.0))),
                "upstreamU": float(sub.get("upstreamU", 1.0))}
        if kind == "radialActuationDiskSource":
            ddir = data["diskDir"] / max(np.linalg.norm(data["diskDir"]),
                                         1e-30)
            c = _host(mesh.c)
            zone_c = c[_host(mask) > 0]
            centre = zone_c.mean(axis=0) if zone_c.size else c.mean(axis=0)
            rel = c - centre
            data.update(
                diskDir=ddir,
                r_cell=np.linalg.norm(rel - np.outer(rel @ ddir, ddir),
                                      axis=1),
                coeffs=tuple(np.asarray(sub.get("coeffs", (0.1, 0.5, 0.01)),
                                        dtype=float).reshape(-1)[:3]))
        return Option(name, kind, mask, ("U",), data)
    if kind in ("codedSource", "scalarCodedSource", "vectorCodedSource"):
        # the dynamicCode analogue: the snippet runs once, here
        fields = tuple(str(f) for f in sub.get(
            "fields", sub.get("fieldNames", ["U"])))
        src = _coded_source(mesh, name, sub.get("codeAddSup", sub.get("code")))
        return Option(name, "codedSource", mask, fields, {"source": src})
    if kind == "fixedTemperatureConstraint":
        t_ent = sub.get("temperature", 300.0)
        if isinstance(t_ent, (list, tuple)):
            t_ent = t_ent[-1]
        fields = tuple(str(f) for f in sub.get("fieldNames", ["T"]))
        return Option(name, kind, mask, fields or ("T",), {
            "temperature": float(np.asarray(t_ent, float).reshape(-1)[-1])})
    if kind in ("temperatureLimitsConstraint", "limitTemperature"):
        return Option(name, "temperatureLimitsConstraint", mask, ("T",), {
            "Tmin": float(sub.get("Tmin", sub.get("min", 0.0))),
            "Tmax": float(sub.get("Tmax", sub.get("max", 5000.0)))})
    if kind == "rotorDiskSource":
        return _rotor_disk(mesh, name, sub, mask)
    if kind in ("MRFSource", "MRF"):
        axis = _vec(sub.get("axis", (0.0, 0.0, 1.0)))
        axis = axis / max(np.linalg.norm(axis), 1e-30)
        return Option(name, "MRFSource", mask, ("U",), {
            "omega_vec": float(sub.get("omega", 0.0)) * axis})
    raise ValueError(f"unknown fvOption type {kind!r}")


def from_dict(mesh, d: FoamDict, nu: float = 0.0) -> OptionList:
    opts = []
    for name, spec in d.items():
        if not isinstance(spec, FoamDict) or "type" not in spec:
            continue
        if str(spec.get("active", "true")) not in ("true", "yes", "on", "1",
                                                   "True"):
            continue
        opts.append(_parse_option(mesh, str(name), spec, nu))
    return OptionList(opts)


def _dimensioned_vec(v):
    """`d d [dims] (..)` -> its vector; a plain vector as it is."""
    if isinstance(v, list) and v and isinstance(
            v[-1], (list, tuple, np.ndarray)):
        return v[-1]
    return v


def from_porous_zones(mesh, d: FoamDict, nu: float) -> List[Option]:
    """constant/porousZones (the 2.2 list of zone dicts with Darcy { d; f; })
    -> explicitPorositySource options (porousZone.C; the coordinateSystem
    rotation applied; cellZone selection as selectionMode box/all)."""
    opts: List[Option] = []

    def one(name, spec: FoamDict):
        sub = spec.get("Darcy", spec.get("DarcyForchheimerCoeffs", spec))
        dv = _vec(_dimensioned_vec(sub.get("d", (0.0, 0.0, 0.0))))
        fv = _vec(_dimensioned_vec(sub.get("f", (0.0, 0.0, 0.0))))
        sel = spec if "selectionMode" in spec else FoamDict(
            {"selectionMode": "all"})
        opts.append(_porosity(str(name), _zone_mask(mesh, sel), dv, fv, nu,
                              _coord_rotation(spec)))

    def walk(obj, name="porousZone"):
        if isinstance(obj, FoamDict):
            if "Darcy" in obj or "DarcyForchheimerCoeffs" in obj:
                one(name, obj)
            else:
                for k, v in obj.items():
                    walk(v, str(k))
        elif isinstance(obj, (list, tuple)):
            pending = name
            for item in obj:
                if isinstance(item, str):
                    pending = item
                else:
                    walk(item, pending)

    walk(d)
    return opts


def from_case(case, nu: float = 0.0) -> Optional[OptionList]:
    """system/fvOptions or else constant/fvOptions (OpenFOAM's lookup
    order), plus constant/porousZones (porousSimpleFoam and
    porousInterFoam read it directly); None when the case has none."""
    opts: List[Option] = []
    for cand in (case.sys_path("fvOptions"), case.const_path("fvOptions")):
        if os.path.exists(cand):
            opts += from_dict(case.mesh, parse_file(cand), nu).options
            break
    pz = case.const_path("porousZones")
    if os.path.exists(pz):
        opts += from_porous_zones(case.mesh, parse_file(pz), nu)
    return OptionList(opts) if opts else None
