"""VOF interface properties: surface tension and interface compression
(port of openfoam-2.2.x_tpu/models/interface.py).

Curvature by the CSF model (Brackbill): kappa = -div(n_f) with n_f the
interpolated, normalised alpha gradient; the interface-compression flux
phir uses cAlpha (interfaceProperties::correct and the phir term of
interFoam's alphaEqn.H). Wall patches whose alpha BC is an
alphaContactAngle kind (constantAlphaContactAngle,
dynamicAlphaContactAngle: bc/derived4.py) turn the boundary normals to
their contact angle first (`_correct_contact_angle`).
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ..bc.patchfields import evaluate as bc_evaluate
from ..core.fields import VolField
from ..ops import fvc, surface


def _correct_contact_angle(mesh, alpha: VolField, nhat, U=None):
    """Rotate the boundary interface normals of wall patches whose alpha
    BC is an alphaContactAngle kind so that nHat . n_wall = cos(theta)
    (interfaceProperties::correctContactAngle: the a/b rotation in the
    (nHat, n_wall) plane). A constant theta0 is exact; when the BC
    carries uTheta/thetaA/thetaR and the velocity is supplied, the
    velocity-dependent dynamic angle
        theta = theta0 + (thetaA - thetaR) * tanh(u_wall / uTheta)
    is used, with u_wall the wall-tangential fluid speed along the
    wall-projected interface normal
    (dynamicAlphaContactAngleFvPatchScalarField::theta). Without such a
    BC the normals stand."""
    if not any(bc.kind == "alphaContactAngle" for bc in alpha.bcs):
        return nhat
    nhat = nhat.clone()
    for i, (p, bc) in enumerate(zip(mesh.patches, alpha.bcs)):
        if bc.kind != "alphaContactAngle":
            continue
        theta0 = float(bc.opt("theta0", math.pi / 2))
        u_theta = float(bc.opt("uTheta", 0.0) or 0.0)
        sl = p.slice
        nf = mesh.sf[sl] / torch.clamp(mesh.mag_sf[sl], min=1e-30)[:, None]
        nhatp = nhat[sl]
        if U is not None and u_theta > 0.0:
            u_wall_bc = bc_evaluate(U.bcs[i], mesh, p, U.data)
            u_rel = U.data[mesh.owner[sl]] - u_wall_bc
            u_rel = u_rel - torch.sum(u_rel * nf, dim=1)[:, None] * nf
            n_wall = nhatp - torch.sum(nhatp * nf, dim=1)[:, None] * nf
            n_wall = n_wall / (torch.linalg.vector_norm(n_wall, dim=1)
                               + 1e-30)[:, None]
            uw = torch.sum(n_wall * u_rel, dim=1)
            theta_a = float(bc.opt("thetaA", theta0))
            theta_r = float(bc.opt("thetaR", theta0))
            theta = theta0 + (theta_a - theta_r) * torch.tanh(uw / u_theta)
        else:
            theta = torch.as_tensor(theta0, dtype=nhat.dtype,
                                    device=nhat.device)
        a12 = torch.clamp(torch.sum(nhatp * nf, dim=1), -1 + 1e-6,
                          1 - 1e-6)
        b1 = torch.cos(theta) * torch.ones_like(a12)
        b2 = torch.cos(torch.arccos(a12) - theta)
        det = 1.0 - a12 * a12
        a = (b1 - a12 * b2) / det
        b = (b2 - a12 * b1) / det
        corr = a[:, None] * nf + b[:, None] * nhatp
        corr = corr / torch.clamp(
            torch.linalg.vector_norm(corr, dim=1), min=1e-30)[:, None]
        nhat[sl] = corr
    return nhat


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
