"""MRF — multiple rotating reference frame zones (port of
openfoam-2.2.x_tpu/models/mrf.py; OpenFOAM's cfdTools/general/MRF,
MRFZone.C and MRFZones.C, read from constant/MRFZones; SRF cases become
one zone over the whole mesh, see solvers/apps.py::_load_mrf).

The absolute velocity formulation: U is solved in the absolute frame, the
flux phi is the relative flux, and a zone contributes

  - the Coriolis source  : Usource -= V (omega x U)        (addCoriolis)
  - the relative flux    : phi_f -= (omega x (Cf - o)) . Sf (relativeFlux)
  - rotating wall BCs    : U_wall = omega x (Cf - o)   (correctBoundaryVelocity)

Zone selection: selectionMode all, box, cylinder or cellZone on cell
centres (an entry named after a mesh cellZone selects it when no
selectionMode is given). Face membership follows MRFZone::setMRFFaces:
internal faces with both cells in the zone take the relative-flux
correction, and so do boundary faces owned by zone cells (empty patches
aside, nonRotatingPatches included: only the wall velocity skips them).

Every geometric quantity is computed on the host once, at parse time, and
kept on the mesh's device: the hooks are elementwise tensor code, one
cross product and a masked product per call.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..bc import patchfields as pf
from ..core.dictionary import FoamDict, parse_file
from ..ops import slot as slot_mod
from ..ops.matrix import FvMatrix


def _vec(v) -> np.ndarray:
    return np.asarray(v, dtype=float).reshape(3)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _cell_mask(mesh, spec: FoamDict, name: str = "") -> np.ndarray:
    """The zone's [nC] bool cell mask."""
    mode = str(spec.get("selectionMode", "all"))
    c = _host(mesh.c)
    masks = getattr(mesh, "cell_zone_masks", None) or {}
    if mode == "all":
        # 2.2.x MRFZones name their entries after a mesh cellZone
        # (`rotor { origin ...; omega ...; }`): that zone when it exists
        # and no selection was given
        zname = str(spec.get("cellZone", name))
        if "selectionMode" not in spec and zname in masks:
            return _host(masks[zname]) > 0.5
        return np.ones(c.shape[0], dtype=bool)
    if mode in ("box", "boxToCell"):
        box = np.asarray(spec.get("box"), dtype=float).reshape(2, 3)
        return np.all((c >= box[0]) & (c <= box[1]), axis=1)
    if mode in ("cylinder", "cylinderToCell"):
        o = _vec(spec.get("origin", (0, 0, 0)))
        ax = _vec(spec.get("axis", (0, 0, 1)))
        ax = ax / max(np.linalg.norm(ax), 1e-30)
        d = c - o
        axial = d @ ax
        rad = np.linalg.norm(d - axial[:, None] * ax[None, :], axis=1)
        m = rad <= float(spec.get("radius"))
        if "zMin" in spec or "zMax" in spec:
            m &= axial >= float(spec.get("zMin", -1e30))
            m &= axial <= float(spec.get("zMax", 1e30))
        return m
    if mode == "cellZone":
        zname = str(spec.get("cellZone", spec.get("zoneName", "")))
        if zname not in masks:
            raise KeyError(
                f"MRF cellZone {zname!r} not found in mesh cellZones "
                f"(have: {sorted(masks)})")
        return _host(masks[zname]) > 0.5
    raise ValueError(f"unknown MRF selectionMode {mode!r}")


@dataclasses.dataclass(frozen=True)
class MRFZone:
    name: str
    origin: np.ndarray           # [3]
    omega_vec: np.ndarray        # [3] omega * axis
    cell_mask: np.ndarray        # [nC] bool
    face_corr: np.ndarray        # [nF] (omega x (Cf-o)).Sf on member faces
    patch_rotating: Tuple[bool, ...]  # per patch: walls whose U = omega x r


class MRFZones:
    """The MRFZones list, with the per-face relative-flux correction
    summed over the zones (zones must not share faces), in flat and slot
    form on the mesh's device."""

    def __init__(self, mesh, zones: List[MRFZone]):
        self.zones = zones
        n_cells = mesh.n_cells
        corr = np.zeros(mesh.n_faces)
        cm = np.zeros(n_cells)
        om = np.zeros((n_cells, 3))
        for z in zones:
            corr += z.face_corr
            cm = np.maximum(cm, z.cell_mask.astype(float))
            om[z.cell_mask] = z.omega_vec
        self._corr_flat = corr

        def dev(a):
            return torch.as_tensor(a, dtype=mesh.v.dtype, device=mesh.device)

        self.corr = dev(corr)
        self.corr_slot = slot_mod.from_flat(mesh, self.corr)
        self.cell_mask = dev(cm)
        self.omega_cell = dev(om)

    def __bool__(self):
        return bool(self.zones)

    # ---- equation hook -------------------------------------------------------
    def add_coriolis(self, mesh, eqn: FvMatrix, U, rho=None) -> FvMatrix:
        """Usource -= V (omega x U) on zone cells (MRFZone::addCoriolis;
        rho-weighted for MRFInterFoam)."""
        w = mesh.v * self.cell_mask
        if rho is not None:
            w = w * rho
        wxu = torch.linalg.cross(self.omega_cell, U.data, dim=1)
        return eqn.replace_fields(source=eqn.source - w[:, None] * wxu)

    # ---- flux hooks ----------------------------------------------------------
    def _corr(self, rho_slot: Optional[slot_mod.SlotFace]
              ) -> slot_mod.SlotFace:
        c = self.corr_slot
        if rho_slot is not None:    # rho_f for mass fluxes
            c = slot_mod.SlotFace(c.sv * rho_slot.sv, c.fb * rho_slot.fb,
                                  c.bv * rho_slot.bv)
        return c

    def make_relative(self, mesh, phi_slot: slot_mod.SlotFace,
                      rho_slot: Optional[slot_mod.SlotFace] = None
                      ) -> slot_mod.SlotFace:
        c = self._corr(rho_slot)
        return slot_mod.SlotFace(phi_slot.sv - c.sv, phi_slot.fb - c.fb,
                                 phi_slot.bv - c.bv)

    def make_absolute(self, mesh, phi_slot: slot_mod.SlotFace,
                      rho_slot: Optional[slot_mod.SlotFace] = None
                      ) -> slot_mod.SlotFace:
        c = self._corr(rho_slot)
        return slot_mod.SlotFace(phi_slot.sv + c.sv, phi_slot.fb + c.fb,
                                 phi_slot.bv + c.bv)

    def make_relative_flat(self, mesh, phi):
        """make_relative of a flat [nF] volumetric flux (the interFoam
        family's face layout)."""
        return phi - self.corr

    def relative_flux_b(self, mesh, phi_b):
        """The boundary faces' part alone (phiHbyA's boundary values)."""
        return phi_b - self.corr[mesh.n_internal_faces:]

    # ---- BC hook (host, once) -------------------------------------------------
    def correct_boundary_velocity(self, mesh, U):
        """U = omega x (Cf - origin) on the value-BC faces of rotating
        patches that zone cells own (MRFZone::correctBoundaryVelocity).
        Run once after the fields are read."""
        cf = _host(mesh.cf)
        owner = _host(mesh.owner)
        bcs = list(U.bcs)
        for z in self.zones:
            for ip, patch in enumerate(mesh.patches):
                bc = bcs[ip]
                if not z.patch_rotating[ip] or not pf.is_value_bc(bc):
                    continue
                s, e = patch.start, patch.start + patch.size
                in_zone = z.cell_mask[owner[s:e]]
                r = cf[s:e] - z.origin
                urot = np.cross(np.broadcast_to(z.omega_vec, r.shape), r)
                old = np.broadcast_to(_host(bc.ref_value),
                                      (patch.size, 3)).copy()
                old[in_zone] = urot[in_zone]
                bcs[ip] = bc.replace(ref_value=torch.as_tensor(
                    old, dtype=mesh.v.dtype, device=mesh.device))
        return dataclasses.replace(U, bcs=tuple(bcs))


def _build_zone(mesh, name: str, spec: FoamDict) -> MRFZone:
    origin = _vec(spec.get("origin", (0.0, 0.0, 0.0)))
    axis = _vec(spec.get("axis", (0.0, 0.0, 1.0)))
    axis = axis / max(np.linalg.norm(axis), 1e-30)
    om = spec.get("omega", 0.0)
    if isinstance(om, (list, tuple)):        # dimensionedScalar form
        om = om[-1]
    omega_vec = float(om) * axis
    cmask = _cell_mask(mesh, spec, name=name)
    non_rot = {str(s) for s in (spec.get("nonRotatingPatches") or [])}

    owner, neighbour = _host(mesh.owner), _host(mesh.neighbour)
    nif = mesh.n_internal_faces
    cf, sf = _host(mesh.cf), _host(mesh.sf)
    fmask = np.zeros(mesh.n_faces, dtype=bool)
    fmask[:nif] = cmask[owner[:nif]] & cmask[neighbour[:nif]]
    patch_rotating = []
    for patch in mesh.patches:
        s, e = patch.start, patch.start + patch.size
        patch_rotating.append(patch.name not in non_rot
                              and patch.type != "empty")
        # MRFZone::relativeFlux corrects the included (rotating) and the
        # excluded (nonRotatingPatches) faces that zone cells own; only
        # empty patches are skipped, and patch_rotating alone gates the
        # wall velocity (as the reference does)
        if patch.type != "empty":
            fmask[s:e] = cmask[owner[s:e]]
    urot_f = np.cross(np.broadcast_to(omega_vec, cf.shape), cf - origin)
    face_corr = np.where(fmask, np.einsum("fd,fd->f", urot_f, sf), 0.0)
    return MRFZone(name=name, origin=origin, omega_vec=omega_vec,
                   cell_mask=cmask, face_corr=face_corr,
                   patch_rotating=tuple(patch_rotating))


def from_dict(mesh, d) -> MRFZones:
    """An MRFZones dictionary: the 2.2.x list form N ( rotor { ... } ... )
    as the dictionary parser flattens it, or a plain dict of zones."""
    zones: List[MRFZone] = []

    def walk(obj, name="zone"):
        if isinstance(obj, FoamDict):
            if "omega" in obj or "axis" in obj or "origin" in obj:
                zones.append(_build_zone(mesh, name, obj))
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
    return MRFZones(mesh, zones)


def make_relative_state(mesh, mrf: MRFZones, state: Dict) -> Dict:
    """The initial absolute flux of a solver state made relative
    (createPhi, then relativeFlux, at start-up)."""
    sl = mrf.make_relative(mesh, slot_mod.from_flat(mesh, state["phi"]))
    st = dict(state)
    st["phi"] = slot_mod.to_flat(mesh, sl)
    st["phi_slot"] = (sl.sv, sl.fb)
    return st


def from_case(case) -> Optional[MRFZones]:
    """constant/MRFZones, or None when the case has none (or it names no
    zone)."""
    path = case.const_path("MRFZones")
    if not os.path.exists(path):
        return None
    z = from_dict(case.mesh, parse_file(path))
    return z if z else None
