"""VOF interface properties: surface tension and interface compression
(port of openfoam-2.2.x_tpu/models/interface.py).

Curvature by the CSF model (Brackbill): kappa = -div(n_f) with n_f the
interpolated, normalised alpha gradient; the interface-compression flux
phir uses cAlpha (interfaceProperties::correct and the phir term of
interFoam's alphaEqn.H). The contact-angle correction of wall patches
(alphaContactAngle BCs) is outside the ported slice and raises.
"""

from __future__ import annotations

from typing import Any

import torch

from ..core.fields import VolField
from ..ops import fvc, surface


def _correct_contact_angle(mesh, alpha: VolField, nhat, U=None):
    """Rotate the boundary interface normals of wall patches whose alpha
    BC is an alphaContactAngle kind (interfaceProperties::
    correctContactAngle). Without such a BC the normals stand."""
    if not any(bc.kind == "alphaContactAngle" for bc in alpha.bcs):
        return nhat
    raise NotImplementedError(
        "the alphaContactAngle boundary condition is not ported to "
        "foamtpu_torch yet")


def interface_normals(mesh, alpha: VolField, U=None):
    """Face unit normal flux nHatf = (grad alpha)_f . Sf / |grad alpha|_f."""
    g = fvc.grad(mesh, alpha)  # [nC,3]
    gf = surface.interpolate_internal(mesh, g)
    gf_all = torch.cat([gf, surface.owner_to_b(mesh, g)], dim=0)
    # deltaN stabiliser: 1e-8 / average cell dimension
    # (interfaceProperties deltaN_)
    delta_n = 1e-8 / torch.mean(torch.pow(mesh.v, 1.0 / 3.0))
    mag = torch.linalg.vector_norm(gf_all, dim=1) + delta_n
    nhat = gf_all / mag[:, None]
    nhat = _correct_contact_angle(mesh, alpha, nhat, U=U)
    return torch.sum(nhat * mesh.sf, dim=1) * mesh.face_active


def curvature(mesh, alpha: VolField, U=None) -> Any:
    """kappa = -div(nHat) [nC]."""
    nhatf = interface_normals(mesh, alpha, U=U)
    return -fvc.div_surface(mesh, nhatf)


def surface_tension_flux(mesh, alpha: VolField, sigma: float, U=None) -> Any:
    """sigma*kappa*snGrad(alpha)*|Sf| at faces: the face form of the CSF
    force used in interFoam's pEqn."""
    kappa = curvature(mesh, alpha, U=U)
    kf = surface.interpolate_internal(mesh, kappa)
    kf_all = torch.cat([kf, surface.owner_to_b(mesh, kappa)], dim=0)
    sng = fvc.sn_grad(mesh, alpha)
    return sigma * kf_all * sng * mesh.mag_sf * mesh.face_active


def compression_flux(mesh, phi: Any, alpha: VolField, c_alpha: float,
                     U=None) -> Any:
    """phir = cAlpha*|phi|/|Sf| * nHatf: the artificial interface
    compression flux (interFoam/alphaEqn.H)."""
    nhatf = interface_normals(mesh, alpha, U=U)
    phic = torch.abs(phi) / torch.clamp(mesh.mag_sf, min=1e-30)
    # cap by the max face speed as the reference does
    phic = torch.clamp(c_alpha * phic, max=torch.max(phic))
    return phic * nhatf
