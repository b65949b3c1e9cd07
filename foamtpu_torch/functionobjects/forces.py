"""forces / forceCoeffs: pressure and viscous force integrated over
patches (port of openfoam-2.2.x_tpu/functionobjects/forces.py;
src/postProcessing/functionObjects/forces/).

The sums run on the device; one fetch per execute brings the six
numbers that are written. The molecular nu is read from
transportProperties once, when the object is built (the reference reads
it at every execute; the solver reads it once too).
"""

from __future__ import annotations

import os

import torch

from ..bc import patchfields as pf
from ..core.dictionary import dimensioned_scalar
from .base import FunctionObject, data_of, register


def patch_forces(mesh, U_field, p_data, nu_eff, patch_names, rho_ref=1.0):
    """(F_pressure, F_viscous) [3] integrated over the named patches.
    Incompressible convention: p is kinematic, so both are scaled by
    rhoRef."""
    Fp = mesh.v.new_zeros(3)
    Fv = mesh.v.new_zeros(3)
    for i, p in enumerate(mesh.patches):
        if p.name not in patch_names:
            continue
        sl = p.slice
        cells = mesh.owner[sl]
        # pressure force: p Sf (outward)
        Fp = Fp + torch.sum(p_data[cells][:, None] * mesh.sf[sl], dim=0)
        # viscous force: -nu_eff dU/dn |Sf| (wall shear)
        ub = pf.evaluate(U_field.bcs[i], mesh, p, U_field.data)
        dudn = (ub - U_field.data[cells]) * mesh.delta_coeffs[sl][:, None]
        Fv = Fv - torch.sum(nu_eff[cells][:, None] * dudn
                            * mesh.mag_sf[sl][:, None], dim=0)
    return Fp * rho_ref, Fv * rho_ref


class Forces(FunctionObject):
    def __init__(self, name, spec, case):
        super().__init__(name, spec, case)
        pats = spec.get("patches", [])
        self.patches = {str(p) for p in
                        (pats if isinstance(pats, list) else [pats])}
        self.rho_ref = float(spec.get("rhoInf", spec.get("rhoRef", 1.0)))
        try:
            _, self.nu0 = dimensioned_scalar(
                case.transport_properties()["nu"])
        except Exception:
            self.nu0 = 0.0
        self.path = os.path.join(self.out_dir, "forces.dat")
        if not os.path.exists(self.path):
            with open(self.path, "w") as f:
                f.write("# Time Fp(x y z) Fv(x y z)\n")

    def execute(self, time_name, state):
        mesh = self.case.mesh
        U = state["U"]
        p = state.get("p", state.get("p_rgh"))
        turb = state.get("turb")
        if turb and "nut" in turb:
            nu_eff = turb["nut"].data + self.nu0
        else:
            nu_eff = torch.full((mesh.n_cells,), self.nu0,
                                dtype=mesh.v.dtype, device=mesh.device)
        Fp, Fv = patch_forces(mesh, U, data_of(p), nu_eff, self.patches,
                              self.rho_ref)
        F = self.host(torch.cat([Fp, Fv]))
        with open(self.path, "a") as f:
            f.write(f"{time_name} ({F[0]:.8g} {F[1]:.8g} {F[2]:.8g}) "
                    f"({F[3]:.8g} {F[4]:.8g} {F[5]:.8g})\n")


register("forces", Forces)
register("forceCoeffs", Forces)
