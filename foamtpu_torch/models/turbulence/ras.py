"""RAS turbulence models (port of
openfoam-2.2.x_tpu/models/turbulence/ras.py: the nutk and nutU
wall-function updates, the wall-function helpers, and the nine models
kEpsilon, RNGkEpsilon, realizableKE, kOmegaSST, kOmega, SpalartAllmaras,
LaunderSharmaKE, SpalartAllmarasDES and SpalartAllmarasDDES).

Wall functions: nut's wall value comes from the log law through the BC
update registry; the epsilon and omega wall functions fix the
wall-adjacent cell values by exact row replacement
(FvMatrix.set_values), and the wall production G takes the log-law
shear with the wall-face nut. The closures are the standard published
ones (Launder-Spalding 1974; Menter 2003). The models that need the
wall distance (kOmegaSST and the Spalart-Allmaras family) take it from
the host mesh's KD-tree (mesh/walldist.py) through
`init_wall_distance`, once, onto the mesh's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ...bc import patchfields as pf
from ...core.dimensions import dimViscosity
from ...core.fields import VolField
from ...core.precision import DEFAULT_DEVICE
from ...ops import fvc, fvm, schemes
from ...ops import slot as slot_mod
from ...ops import surface
from ...solvers import linear
from .base import TurbulenceModel, bound_below, production, register

_KAPPA = 0.41
_E = 9.8
_CMU = 0.09

K_MIN = 1e-10
EPS_MIN = 1e-10
OMEGA_MIN = 1e-10


# ---------------------------------------------------------------------------
# Wall-function nut BC update (registered into the BC update registry)
# ---------------------------------------------------------------------------


def _nutk_wall(bc, mesh, patch, internal, *, k=None, nu=None, **ctx):
    """nutkWallFunction: nut from the log law using k at the wall cell
    (nutkWallFunctionFvPatchScalarField). nu may be per cell [nC]."""
    if k is None or nu is None:
        return bc
    cells = mesh.owner[patch.slice]
    if getattr(nu, "ndim", 0) == 1:
        nu = nu[cells]
    y = 1.0 / torch.clamp(mesh.delta_coeffs[patch.slice], min=1e-30)
    kc = torch.clamp(k[cells], min=K_MIN)
    ypl = (_CMU ** 0.25) * torch.sqrt(kc) * y / nu
    ypl_lam = 11.0  # intersection of linear/log laws for kappa=0.41, E=9.8
    nutw = nu * (ypl * _KAPPA / torch.log(torch.clamp(_E * ypl, min=1.001))
                 - 1.0)
    nutw = torch.where(ypl > ypl_lam, torch.clamp(nutw, min=0.0),
                       torch.zeros_like(nutw))
    return bc.replace(ref_value=nutw, vfrac=torch.ones_like(nutw))


def _nutU_wall(bc, mesh, patch, internal, *, U=None, nu=None, **ctx):
    """nutUWallFunction: nut from the log law using the tangential cell
    velocity (nutUWallFunctionFvPatchScalarField): u+ = ln(E y+)/kappa
    solved by four fixed-point sweeps for u_tau."""
    if U is None or nu is None:
        return bc
    cells = mesh.owner[patch.slice]
    if getattr(nu, "ndim", 0) == 1:
        nu = nu[cells]
    y = 1.0 / torch.clamp(mesh.delta_coeffs[patch.slice], min=1e-30)
    n = mesh.sf[patch.slice] / torch.clamp(mesh.mag_sf[patch.slice],
                                           min=1e-30)[:, None]
    Uc = U[cells]
    Ut = Uc - n * torch.sum(n * Uc, dim=1, keepdim=True)
    magU = torch.clamp(torch.linalg.norm(Ut, dim=1), min=1e-12)
    utau = torch.sqrt(magU * nu / y)  # laminar guess
    for _ in range(4):
        ypl = utau * y / nu
        upl = torch.where(
            ypl > 11.0, torch.log(torch.clamp(_E * ypl, min=1.001)) / _KAPPA,
            ypl)
        utau = magU / torch.clamp(upl, min=1e-6)
    nutw = torch.clamp(utau * utau * y / magU / nu - 1.0, min=0.0) * nu
    return bc.replace(ref_value=nutw, vfrac=torch.ones_like(nutw))


pf.register_update("nutkWallFunction", _nutk_wall)
pf.register_update("nutUWallFunction", _nutU_wall)


def _wall_data(mesh):
    """Wall-adjacency arrays (mask [nC], average wall distance y [nC]),
    precomputed on the mesh at load."""
    return mesh.wall_mask, mesh.wall_y


def _has_wall_fn(field: VolField, kinds) -> bool:
    return any(bc.kind in kinds for bc in field.bcs)


def _wall_face_nut(mesh, nut_field: VolField):
    """Per-cell wall-FACE nut (averaged over a cell's wall faces): the
    G override uses the wall-function value, not the cell nut
    (epsilonWallFunctionFvPatchScalarField::calculate). mesh.wall_cnt is
    clamped to >= 1 at load, and non-wall cells are masked by the caller."""
    acc = mesh.v.new_zeros((mesh.n_cells,))
    for p, bc in zip(mesh.patches, nut_field.bcs):
        if p.type != "wall":
            continue
        vals = pf.evaluate(bc, mesh, p, nut_field.data)
        acc = acc.index_add(0, mesh.owner[p.slice], vals)
    return acc / mesh.wall_cnt


def _div_weights(mesh, phi, field, scheme="upwind"):
    """The convection scheme's face weights of `field` on the flat flux."""
    return schemes.weights(mesh, phi, scheme, field)


def _phi_slotform(mesh, phi, phi_slot):
    """Slot-form flux: reuse the solver's, else derive it."""
    if phi_slot is not None:
        return phi_slot
    return slot_mod.from_flat(mesh, phi)


def _gamma_forms(mesh, nu, nut_f: VolField, sigma=1.0):
    """Effective diffusivity nu + nut/sigma as (flat [nF], SlotFace)."""
    bv = nu + nut_f.boundary_values(mesh) / sigma
    f = slot_mod.interpolate(mesh, nut_f.data / sigma)
    gs = slot_mod.SlotFace(nu + f.sv, nu + f.fb, bv)
    return slot_mod.to_flat(mesh, gs), gs


def _transport_ops(mesh, phi, phi_sl, field, div_scheme, gamma_flat,
                   gamma_slot, corrected, corr_limit):
    """div(phi, psi) - laplacian(gammaEff, psi) with slot assembly."""
    ws = schemes.weights_slot(mesh, phi_sl, div_scheme, field)
    return (fvm.div(mesh, phi, field, phi_slot=phi_sl, slot_weights=ws)
            - fvm.laplacian(mesh, gamma_flat, field, corrected=corrected,
                            gamma_dims=dimViscosity, limit=corr_limit,
                            gamma_slot=gamma_slot))


def _solve_transport(mesh, field, mat, controls, default_tol=1e-8):
    ctl = dict(controls or {})
    ctl.setdefault("solver", "PBiCGStab")
    ctl.setdefault("tolerance", default_tol)
    ctl.setdefault("relTol", 0.1)
    ctl.setdefault("maxIter", 200)
    return linear.solve(mesh, mat, field.data, ctl)


class KEpsilon(TurbulenceModel):
    """Standard k-epsilon (RAS/kEpsilon/kEpsilon.C)."""

    name = "kEpsilon"
    field_names = ("k", "epsilon", "nut")

    Cmu = _CMU
    C1 = 1.44
    C2 = 1.92
    sigma_k = 1.0
    sigma_eps = 1.3
    prod_limit = 10.0   # G <= prod_limit*eps (stagnation-point fix)

    def __init__(self, nu, coeffs=None):
        super().__init__(nu, coeffs)
        c = self.coeffs or {}
        self.Cmu = float(c.get("Cmu", self.Cmu))
        self.C1 = float(c.get("C1", self.C1))
        self.C2 = float(c.get("C2", self.C2))
        self.sigma_k = float(c.get("sigmak", self.sigma_k))
        self.sigma_eps = float(c.get("sigmaEps", self.sigma_eps))

    def nut(self, mesh, tstate):
        return tstate["nut"].data

    def _nut_from(self, k, eps):
        return self.Cmu * k * k / torch.clamp(eps, min=EPS_MIN)

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, c1_field=None, phi_slot=None,
                c2_field=None, fmu_field=None, extra_eps_src=None,
                G_extra=None):
        """c1_field: a per-cell C1 in place of the constant (RNG's
        strain-dependent C1eff), passed in rather than set on the model.
        c2_field / fmu_field: per-cell C2 and nut damping factor (the
        low-Re variants). extra_eps_src: an explicit epsilon source [nC].
        G_extra: production added before the limiter (the nonlinear-stress
        models' -(nonlinearStress && grad U))."""
        k_f: VolField = tstate["k"]
        eps_f: VolField = tstate["epsilon"]
        nut_f: VolField = tstate["nut"]
        k, eps, nut = k_f.data, eps_f.data, nut_f.data
        rdt = 1.0 / dt
        diag = {}
        phi_sl = _phi_slotform(mesh, phi, phi_slot)

        G, _ = production(mesh, nut, U)
        if G_extra is not None:
            G = G + G_extra
        # production limiter (the reference's documented deviation from
        # plain kEpsilon): bounds the spike at singular corners and
        # stagnation points, inactive where G ~= eps
        G = torch.minimum(G, self.prod_limit * torch.clamp(eps, min=EPS_MIN))
        wall_fn = _has_wall_fn(eps_f, ("epsilonWallFunction",))
        if wall_fn:
            mask, y = _wall_data(mesh)
            sqrtk = torch.sqrt(torch.clamp(k, min=K_MIN))
            eps_wall = (self.Cmu ** 0.75) * sqrtk ** 3 / (_KAPPA * y)
            # wall production from the log-law shear with the wall-FACE
            # nut (the wall-function value)
            nutw = _wall_face_nut(mesh, nut_f)
            magUp = torch.linalg.norm(U.data, dim=1) / y
            G_wall = ((nutw + self.nu) * magUp
                      * (self.Cmu ** 0.25) * sqrtk / (_KAPPA * y))
            G = torch.where(mask > 0, G_wall, G)

        eps_flat, eps_slot = _gamma_forms(mesh, self.nu, nut_f,
                                          self.sigma_eps)
        ddt_op = (fvm.ddt(mesh, eps_f, eps, rdt) if not steady
                  else fvm.ddt_steady(mesh, eps_f))
        eps_eqn = (
            ddt_op
            + _transport_ops(mesh, phi, phi_sl, eps_f, self.div_scheme,
                             eps_flat, eps_slot, self.corrected,
                             self.corr_limit)
            + fvm.Sp(mesh, (self.C2 if c2_field is None else c2_field)
                     * eps / torch.clamp(k, min=K_MIN), eps_f)
        )
        c1 = self.C1 if c1_field is None else c1_field
        eps_eqn = eps_eqn.add_source(
            c1 * G * eps / torch.clamp(k, min=K_MIN), mesh)
        if extra_eps_src is not None:
            eps_eqn = eps_eqn.add_source(extra_eps_src, mesh)
        if steady and relax < 1.0:
            eps_eqn = eps_eqn.relax(mesh, relax, eps)
        if wall_fn:
            eps_eqn = eps_eqn.set_values(mask, eps_wall, mesh)
        eps_new, perf_e = _solve_transport(mesh, eps_f, eps_eqn, controls)
        eps_new = bound_below(eps_new, EPS_MIN)
        diag["epsilon"] = perf_e

        k_flat, k_slot = _gamma_forms(mesh, self.nu, nut_f, self.sigma_k)
        ddt_op = (fvm.ddt(mesh, k_f, k, rdt) if not steady
                  else fvm.ddt_steady(mesh, k_f))
        k_eqn = (
            ddt_op
            + _transport_ops(mesh, phi, phi_sl, k_f, self.div_scheme,
                             k_flat, k_slot, self.corrected,
                             self.corr_limit)
            + fvm.Sp(mesh, eps_new / torch.clamp(k, min=K_MIN), k_f)
        )
        k_eqn = k_eqn.add_source(G, mesh)
        if steady and relax < 1.0:
            k_eqn = k_eqn.relax(mesh, relax, k)
        k_new, perf_k = _solve_transport(mesh, k_f, k_eqn, controls)
        k_new = bound_below(k_new, K_MIN)
        diag["k"] = perf_k

        nut_new = self._nut_from(k_new, eps_new)
        if fmu_field is not None:
            nut_new = fmu_field * nut_new
        new_nut_f = nut_f.with_data(nut_new).correct_boundary_conditions(
            mesh, k=k_new, nu=self.nu, U=U.data)
        new = dict(tstate)
        new.update(k=k_f.with_data(k_new), epsilon=eps_f.with_data(eps_new),
                   nut=new_nut_f)
        return new, diag


class RNGkEpsilon(KEpsilon):
    """RNG k-epsilon (RAS/RNGkEpsilon/): standard kEpsilon with the
    strain-dependent C1, passed to KEpsilon.correct as a field."""

    name = "RNGkEpsilon"
    Cmu = 0.0845
    C1 = 1.42
    C2 = 1.68
    # RNGkEpsilon.C: sigmak = sigmaEps = 0.71942
    sigma_k = 0.71942
    sigma_eps = 0.71942
    eta0 = 4.38
    beta = 0.012

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, c1_field=None, phi_slot=None):
        k = tstate["k"].data
        eps = tstate["epsilon"].data
        nut = tstate["nut"].data
        _, S2 = production(mesh, nut, U)
        eta = torch.sqrt(S2) * k / torch.clamp(eps, min=EPS_MIN)
        c1_eff = self.C1 - eta * (1.0 - eta / self.eta0) / (
            1.0 + self.beta * eta ** 3)
        return super().correct(mesh, tstate, U, phi, dt, steady, relax,
                               controls, c1_field=c1_eff,
                               phi_slot=phi_slot)


class RealizableKE(KEpsilon):
    """Realizable k-epsilon (RAS/realizableKE/): variable Cmu and the
    Shih production form of the epsilon equation."""

    name = "realizableKE"
    A0 = 4.0
    C2r = 1.9

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, phi_slot=None):
        k_f = tstate["k"]
        eps_f = tstate["epsilon"]
        nut_f = tstate["nut"]
        k, eps, nut = k_f.data, eps_f.data, nut_f.data
        rdt = 1.0 / dt
        diag = {}
        phi_sl = _phi_slotform(mesh, phi, phi_slot)

        g = fvc.grad(mesh, U)
        s = 0.5 * (g + torch.transpose(g, 1, 2))
        w = 0.5 * (g - torch.transpose(g, 1, 2))
        s2 = 2.0 * torch.sum(s * s, dim=(1, 2))
        magS = torch.sqrt(s2)
        G = nut * s2

        # realizable Cmu (Shih et al.); the 1e-12 floor keeps the 0/0 of
        # a zero-strain cell out of arccos
        ksum = torch.sum(s * s, dim=(1, 2))
        wsum = torch.sum(w * w, dim=(1, 2))
        Ustar = torch.sqrt(ksum + wsum)
        sss = torch.einsum("cij,cjk,cki->c", s, s, s)
        As = np.sqrt(6.0) * torch.cos(
            (1.0 / 3.0) * torch.arccos(torch.clamp(
                np.sqrt(6.0) * sss / torch.clamp(ksum, min=1e-12) ** 1.5,
                -1.0, 1.0)))
        cmu_r = 1.0 / (self.A0 + As * Ustar * k
                       / torch.clamp(eps, min=EPS_MIN))

        eta = magS * k / torch.clamp(eps, min=EPS_MIN)
        C1r = torch.clamp(eta / (eta + 5.0), min=0.43)

        wall_fn = _has_wall_fn(eps_f, ("epsilonWallFunction",))
        if wall_fn:
            mask, y = _wall_data(mesh)
            sqrtk = torch.sqrt(torch.clamp(k, min=K_MIN))
            eps_wall = (_CMU ** 0.75) * sqrtk ** 3 / (_KAPPA * y)
            nutw = _wall_face_nut(mesh, nut_f)
            magUp = torch.linalg.norm(U.data, dim=1) / y
            G = torch.where(mask > 0,
                            (nutw + self.nu) * magUp * (_CMU ** 0.25)
                            * sqrtk / (_KAPPA * y), G)

        eps_flat, eps_slot = _gamma_forms(mesh, self.nu, nut_f,
                                          self.sigma_eps)
        ddt_e = (fvm.ddt(mesh, eps_f, eps, rdt) if not steady
                 else fvm.ddt_steady(mesh, eps_f))
        eps_eqn = (
            ddt_e
            + _transport_ops(mesh, phi, phi_sl, eps_f, self.div_scheme,
                             eps_flat, eps_slot, self.corrected,
                             self.corr_limit)
            + fvm.Sp(mesh, self.C2r * eps / (
                k + torch.sqrt(self.nu * torch.clamp(eps, min=EPS_MIN))),
                eps_f)
        )
        eps_eqn = eps_eqn.add_source(C1r * magS * eps, mesh)
        if steady and relax < 1.0:
            eps_eqn = eps_eqn.relax(mesh, relax, eps)
        if wall_fn:
            eps_eqn = eps_eqn.set_values(mask, eps_wall, mesh)
        eps_new, perf_e = _solve_transport(mesh, eps_f, eps_eqn, controls)
        eps_new = bound_below(eps_new, EPS_MIN)
        diag["epsilon"] = perf_e

        k_flat, k_slot = _gamma_forms(mesh, self.nu, nut_f, self.sigma_k)
        ddt_k = (fvm.ddt(mesh, k_f, k, rdt) if not steady
                 else fvm.ddt_steady(mesh, k_f))
        k_eqn = (
            ddt_k
            + _transport_ops(mesh, phi, phi_sl, k_f, self.div_scheme,
                             k_flat, k_slot, self.corrected,
                             self.corr_limit)
            + fvm.Sp(mesh, eps_new / torch.clamp(k, min=K_MIN), k_f)
        )
        k_eqn = k_eqn.add_source(G, mesh)
        if steady and relax < 1.0:
            k_eqn = k_eqn.relax(mesh, relax, k)
        k_new, perf_k = _solve_transport(mesh, k_f, k_eqn, controls)
        k_new = bound_below(k_new, K_MIN)
        diag["k"] = perf_k

        nut_new = cmu_r * k_new * k_new / torch.clamp(eps_new, min=EPS_MIN)
        new_nut = nut_f.with_data(nut_new).correct_boundary_conditions(
            mesh, k=k_new, nu=self.nu, U=U.data)
        new = dict(tstate)
        new.update(k=k_f.with_data(k_new), epsilon=eps_f.with_data(eps_new),
                   nut=new_nut)
        return new, diag


def _wall_distance_on(poly_mesh, dtype, device):
    """The host mesh's wall distance [nC] as a tensor of `dtype` on
    `device` (no wall in reach: 1e10; floored at 1e-10)."""
    from ...mesh.walldist import wall_distance

    y = wall_distance(poly_mesh)
    y = np.where(np.isfinite(y), y, 1e10)
    return torch.tensor(np.maximum(y, 1e-10), dtype=dtype, device=device)


class KOmegaSST(TurbulenceModel):
    """Menter k-omega SST (the 2003 form, RAS/kOmegaSST/kOmegaSST.C).
    Needs the wall-distance field: `init_wall_distance` before the
    first `correct`."""

    name = "kOmegaSST"
    field_names = ("k", "omega", "nut")

    alphaK1, alphaK2 = 0.85, 1.0
    alphaOmega1, alphaOmega2 = 0.5, 0.856
    beta1, beta2 = 0.075, 0.0828
    betaStar = 0.09
    gamma1, gamma2 = 5.0 / 9.0, 0.44
    a1, b1, c1 = 0.31, 1.0, 10.0

    def __init__(self, nu, coeffs=None, y_wall=None):
        super().__init__(nu, coeffs)
        self.y_wall = y_wall  # [nC] tensor on the mesh's device

    def init_wall_distance(self, poly_mesh, dtype, device=DEFAULT_DEVICE):
        """y_wall from the host mesh's KD-tree wall distance, in the
        mesh's dtype on its device (cells with no wall in reach get
        1e10; distances are floored at 1e-10)."""
        self.y_wall = _wall_distance_on(poly_mesh, dtype, device)

    def nut(self, mesh, tstate):
        return tstate["nut"].data

    def _blend(self, mesh, k, omega, grad_k_grad_w):
        """The blending functions F1, F2 and the cross-diffusion CDkw."""
        y = self.y_wall
        sqrtk = torch.sqrt(torch.clamp(k, min=K_MIN))
        w = torch.clamp(omega, min=OMEGA_MIN)
        cd = torch.clamp(2.0 * self.alphaOmega2 * grad_k_grad_w / w,
                         min=1e-10)
        arg1 = torch.minimum(
            torch.maximum(sqrtk / (self.betaStar * w * y),
                          500.0 * self.nu / (y * y * w)),
            4.0 * self.alphaOmega2 * k / (cd * y * y),
        )
        F1 = torch.tanh(torch.clamp(arg1, max=10.0) ** 4)
        arg2 = torch.maximum(2.0 * sqrtk / (self.betaStar * w * y),
                             500.0 * self.nu / (y * y * w))
        F2 = torch.tanh(torch.clamp(arg2, max=10.0) ** 2)
        return F1, F2, cd

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, phi_slot=None, extra_omega_src=None):
        """extra_omega_src: an explicit omega source [nC] (SST-SAS's
        QSAS)."""
        if self.y_wall is None:
            raise ValueError("KOmegaSST needs init_wall_distance before "
                             "correct")
        k_f, w_f, nut_f = tstate["k"], tstate["omega"], tstate["nut"]
        k, omega, nut = k_f.data, w_f.data, nut_f.data
        rdt = 1.0 / dt
        diag = {}
        phi_sl = _phi_slotform(mesh, phi, phi_slot)

        gk = fvc.grad(mesh, k_f)
        gw = fvc.grad(mesh, w_f)
        gkgw = torch.sum(gk * gw, dim=1)
        F1, F2, cd = self._blend(mesh, k, omega, gkgw)

        def mix(a, b):
            return F1 * a + (1.0 - F1) * b

        G, S2 = production(mesh, nut, U)
        S = torch.sqrt(S2)
        gamma = mix(self.gamma1, self.gamma2)
        beta = mix(self.beta1, self.beta2)

        wall_fn = _has_wall_fn(w_f, ("omegaWallFunction",))
        if wall_fn:
            mask, y1 = _wall_data(mesh)
            sqrtk = torch.sqrt(torch.clamp(k, min=K_MIN))
            w_vis = 6.0 * self.nu / (self.beta1 * y1 * y1)
            w_log = sqrtk / ((_CMU ** 0.25) * _KAPPA * y1)
            omega_wall = torch.sqrt(w_vis ** 2 + w_log ** 2)
            nutw = _wall_face_nut(mesh, nut_f)
            magUp = torch.linalg.norm(U.data, dim=1) / y1
            G_wall = ((nutw + self.nu) * magUp
                      * (_CMU ** 0.25) * sqrtk / (_KAPPA * y1))
            G = torch.where(mask > 0, G_wall, G)

        # omega equation
        w_flat, w_slot = _gamma_forms(
            mesh, self.nu,
            nut_f.with_data(mix(self.alphaOmega1, self.alphaOmega2) * nut))
        ddt_w = (fvm.ddt(mesh, w_f, omega, rdt) if not steady
                 else fvm.ddt_steady(mesh, w_f))
        w_eqn = (
            ddt_w
            + _transport_ops(mesh, phi, phi_sl, w_f, self.div_scheme,
                             w_flat, w_slot, False, self.corr_limit)
            + fvm.Sp(mesh, beta * omega, w_f)
        )
        src_w = gamma * S2 + (1.0 - F1) * cd
        if extra_omega_src is not None:
            src_w = src_w + extra_omega_src
        w_eqn = w_eqn.add_source(src_w, mesh)
        if steady and relax < 1.0:
            w_eqn = w_eqn.relax(mesh, relax, omega)
        if wall_fn:
            w_eqn = w_eqn.set_values(mask, omega_wall, mesh)
        w_new, perf_w = _solve_transport(mesh, w_f, w_eqn, controls)
        w_new = bound_below(w_new, OMEGA_MIN)
        diag["omega"] = perf_w

        # k equation with limited production
        Gk = torch.minimum(G, self.c1 * self.betaStar * k * w_new)
        k_flat, k_slot = _gamma_forms(
            mesh, self.nu,
            nut_f.with_data(mix(self.alphaK1, self.alphaK2) * nut))
        ddt_k = (fvm.ddt(mesh, k_f, k, rdt) if not steady
                 else fvm.ddt_steady(mesh, k_f))
        k_eqn = (
            ddt_k
            + _transport_ops(mesh, phi, phi_sl, k_f, self.div_scheme,
                             k_flat, k_slot, self.corrected,
                             self.corr_limit)
            + fvm.Sp(mesh, self.betaStar * w_new, k_f)
        )
        k_eqn = k_eqn.add_source(Gk, mesh)
        if steady and relax < 1.0:
            k_eqn = k_eqn.relax(mesh, relax, k)
        k_new, perf_k = _solve_transport(mesh, k_f, k_eqn, controls)
        k_new = bound_below(k_new, K_MIN)
        diag["k"] = perf_k

        nut_new = self.a1 * k_new / torch.maximum(
            self.a1 * torch.clamp(w_new, min=OMEGA_MIN), self.b1 * F2 * S)
        new_nut = nut_f.with_data(nut_new).correct_boundary_conditions(
            mesh, k=k_new, nu=self.nu, U=U.data)
        new = dict(tstate)
        new.update(k=k_f.with_data(k_new), omega=w_f.with_data(w_new),
                   nut=new_nut)
        return new, diag


class KOmega(TurbulenceModel):
    """Wilcox k-omega (RAS/kOmega/kOmega.C; alpha 0.52, beta 0.072,
    betaStar = Cmu = 0.09, alphaK = alphaOmega = 0.5)."""

    name = "kOmega"
    field_names = ("k", "omega", "nut")

    alpha = 0.52
    beta = 0.072
    betaStar = 0.09
    alphaK = 0.5
    alphaOmega = 0.5

    def __init__(self, nu, coeffs=None):
        super().__init__(nu, coeffs)
        c = self.coeffs or {}
        self.alpha = float(c.get("alpha", self.alpha))
        self.beta = float(c.get("beta", self.beta))
        self.betaStar = float(c.get("betaStar", c.get("Cmu", self.betaStar)))

    def nut(self, mesh, tstate):
        return tstate["nut"].data

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, phi_slot=None):
        k_f, w_f, nut_f = tstate["k"], tstate["omega"], tstate["nut"]
        k, omega, nut = k_f.data, w_f.data, nut_f.data
        rdt = 1.0 / dt
        diag = {}
        phi_sl = _phi_slotform(mesh, phi, phi_slot)

        G, S2 = production(mesh, nut, U)
        wall_fn = _has_wall_fn(w_f, ("omegaWallFunction",))
        if wall_fn:
            mask, y1 = _wall_data(mesh)
            sqrtk = torch.sqrt(torch.clamp(k, min=K_MIN))
            w_vis = 6.0 * self.nu / (self.beta * y1 * y1)
            w_log = sqrtk / ((self.betaStar ** 0.25) * _KAPPA * y1)
            omega_wall = torch.sqrt(w_vis ** 2 + w_log ** 2)
            nutw = _wall_face_nut(mesh, nut_f)
            magUp = torch.linalg.norm(U.data, dim=1) / y1
            G = torch.where(mask > 0,
                            (nutw + self.nu) * magUp
                            * (self.betaStar ** 0.25) * sqrtk
                            / (_KAPPA * y1), G)

        # omega equation: alpha G omega/k explicit, Sp(beta omega) implicit
        w_flat, w_slot = _gamma_forms(
            mesh, self.nu, nut_f.with_data(self.alphaOmega * nut))
        ddt_w = (fvm.ddt(mesh, w_f, omega, rdt) if not steady
                 else fvm.ddt_steady(mesh, w_f))
        w_eqn = (
            ddt_w
            + _transport_ops(mesh, phi, phi_sl, w_f, self.div_scheme,
                             w_flat, w_slot, self.corrected,
                             self.corr_limit)
            + fvm.Sp(mesh, self.beta * omega, w_f)
        )
        w_eqn = w_eqn.add_source(
            self.alpha * G * omega / torch.clamp(k, min=K_MIN), mesh)
        if steady and relax < 1.0:
            w_eqn = w_eqn.relax(mesh, relax, omega)
        if wall_fn:
            w_eqn = w_eqn.set_values(mask, omega_wall, mesh)
        w_new, perf_w = _solve_transport(mesh, w_f, w_eqn, controls)
        w_new = bound_below(w_new, OMEGA_MIN)
        diag["omega"] = perf_w

        k_flat, k_slot = _gamma_forms(
            mesh, self.nu, nut_f.with_data(self.alphaK * nut))
        ddt_k = (fvm.ddt(mesh, k_f, k, rdt) if not steady
                 else fvm.ddt_steady(mesh, k_f))
        k_eqn = (
            ddt_k
            + _transport_ops(mesh, phi, phi_sl, k_f, self.div_scheme,
                             k_flat, k_slot, self.corrected,
                             self.corr_limit)
            + fvm.Sp(mesh, self.betaStar * w_new, k_f)
        )
        k_eqn = k_eqn.add_source(G, mesh)
        if steady and relax < 1.0:
            k_eqn = k_eqn.relax(mesh, relax, k)
        k_new, perf_k = _solve_transport(mesh, k_f, k_eqn, controls)
        k_new = bound_below(k_new, K_MIN)
        diag["k"] = perf_k

        nut_new = k_new / torch.clamp(w_new, min=OMEGA_MIN)
        new_nut = nut_f.with_data(nut_new).correct_boundary_conditions(
            mesh, k=k_new, nu=self.nu, U=U.data)
        new = dict(tstate)
        new.update(k=k_f.with_data(k_new), omega=w_f.with_data(w_new),
                   nut=new_nut)
        return new, diag


class SpalartAllmaras(TurbulenceModel):
    """Spalart-Allmaras, the 2.2 fv3 formulation
    (RAS/SpalartAllmaras/SpalartAllmaras.C): transport of nuTilda with
    the fv1/fv2/fv3 damping, Stilda from the vorticity magnitude and the
    fw destruction. Needs `init_wall_distance` before the first
    `correct`."""

    name = "SpalartAllmaras"
    field_names = ("nuTilda", "nut")

    sigmaNut = 0.66666
    kappa = 0.41
    Cb1 = 0.1355
    Cb2 = 0.622
    Cv1 = 7.1
    Cv2 = 5.0
    Cw2 = 0.3
    Cw3 = 2.0

    def __init__(self, nu, coeffs=None, y_wall=None):
        super().__init__(nu, coeffs)
        c = self.coeffs or {}
        self.sigmaNut = float(c.get("sigmaNut", self.sigmaNut))
        self.Cb1 = float(c.get("Cb1", self.Cb1))
        self.Cb2 = float(c.get("Cb2", self.Cb2))
        self.Cv1 = float(c.get("Cv1", self.Cv1))
        self.Cw1 = (self.Cb1 / self.kappa ** 2
                    + (1.0 + self.Cb2) / self.sigmaNut)
        self.y_wall = y_wall  # [nC] tensor on the mesh's device

    def init_wall_distance(self, poly_mesh, dtype, device=DEFAULT_DEVICE):
        self.y_wall = _wall_distance_on(poly_mesh, dtype, device)

    def nut(self, mesh, tstate):
        return tstate["nut"].data

    def _fv1(self, chi):
        c3 = chi ** 3
        return c3 / (c3 + self.Cv1 ** 3)

    def d_tilda(self, mesh, U, nuT_f):
        """The destruction term's length scale: the wall distance for
        RANS SA; the DES variants shrink it away from walls."""
        return self.y_wall

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, phi_slot=None):
        if self.y_wall is None:
            raise ValueError(f"{self.name} needs init_wall_distance before "
                             "correct")
        nuT_f: VolField = tstate["nuTilda"]
        nut_f: VolField = tstate["nut"]
        nuT = nuT_f.data
        rdt = 1.0 / dt
        diag = {}
        phi_sl = _phi_slotform(mesh, phi, phi_slot)
        y = self.d_tilda(mesh, U, nuT_f)
        nu = self.nu

        chi = nuT / nu
        fv1 = self._fv1(chi)
        fv2 = torch.pow(1.0 + chi / self.Cv2, -3.0)
        fv3 = ((1.0 + chi * fv1) * (1.0 - fv2)
               / torch.clamp(chi, min=1e-10))
        g = fvc.grad(mesh, U)
        w = 0.5 * (g - torch.transpose(g, 1, 2))
        Omega = torch.sqrt(2.0 * torch.sum(w * w, dim=(1, 2)))
        ky2 = (self.kappa * y) ** 2
        Stilda = fv3 * Omega + fv2 * nuT / ky2
        Stilda = torch.clamp(Stilda, min=1e-10)

        r = torch.clamp(nuT / (Stilda * ky2), max=10.0)
        gw = r + self.Cw2 * (r ** 6 - r)
        fw = gw * torch.pow(
            (1.0 + self.Cw3 ** 6) / (gw ** 6 + self.Cw3 ** 6), 1.0 / 6.0)

        # DnuTildaEff = (nuTilda + nu)/sigmaNut
        dcoef = (nuT + nu) / self.sigmaNut
        d_b = surface.owner_to_b(mesh, dcoef)
        d_slot = slot_mod.interpolate(mesh, dcoef, bv=d_b)
        d_flat = slot_mod.to_flat(mesh, d_slot)
        wself = schemes.weights_slot(mesh, phi_sl, self.div_scheme, nuT_f)
        gnt = fvc.grad_component(mesh, nuT, nuT_f.boundary_values(mesh))
        mag2_gnt = torch.sum(gnt * gnt, dim=1)
        ddt_op = (fvm.ddt(mesh, nuT_f, nuT, rdt) if not steady
                  else fvm.ddt_steady(mesh, nuT_f))
        eqn = (
            ddt_op
            + fvm.div(mesh, phi, nuT_f, phi_slot=phi_sl, slot_weights=wself)
            - fvm.laplacian(mesh, d_flat, nuT_f, corrected=self.corrected,
                            gamma_dims=dimViscosity, limit=self.corr_limit,
                            gamma_slot=d_slot)
            + fvm.Sp(mesh, self.Cw1 * fw * nuT / (y * y), nuT_f)
        )
        eqn = eqn.add_source(
            self.Cb1 * Stilda * nuT + (self.Cb2 / self.sigmaNut) * mag2_gnt,
            mesh)
        if steady and relax < 1.0:
            eqn = eqn.relax(mesh, relax, nuT)
        nuT_new, perf = _solve_transport(mesh, nuT_f, eqn, controls)
        nuT_new = bound_below(nuT_new, 0.0)
        diag["nuTilda"] = perf

        chi_n = nuT_new / nu
        nut_new = nuT_new * self._fv1(chi_n)
        new_nut = nut_f.with_data(nut_new).correct_boundary_conditions(
            mesh, nu=self.nu, U=U.data)
        new = dict(tstate)
        new.update(nuTilda=nuT_f.with_data(nuT_new), nut=new_nut)
        return new, diag


class LaunderSharmaKE(KEpsilon):
    """Launder-Sharma low-Reynolds k-epsilon
    (RAS/LaunderSharmaKE/LaunderSharmaKE.C): the damping functions
    fMu = exp(-3.4/(1+Rt/50)^2) and f2 = 1 - 0.3 exp(-Rt^2), with
    D = 2 nu |grad sqrt(k)|^2 and E = 2 nu nut |grad grad U|^2 (the
    second velocity gradient as the Gauss gradient of the nine grad U
    components). It integrates to the wall: no wall functions."""

    name = "LaunderSharmaKE"
    sigma_eps = 1.3

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, c1_field=None, phi_slot=None):
        k_f: VolField = tstate["k"]
        eps_f: VolField = tstate["epsilon"]
        nut_f: VolField = tstate["nut"]
        k, eps, nut = k_f.data, eps_f.data, nut_f.data
        rdt = 1.0 / dt
        diag = {}
        phi_sl = _phi_slotform(mesh, phi, phi_slot)
        nu = self.nu

        Rt = torch.clamp(k, min=K_MIN) ** 2 / (
            nu * torch.clamp(eps, min=EPS_MIN))
        f2 = 1.0 - 0.3 * torch.exp(-torch.clamp(Rt * Rt, max=50.0))
        G, S2 = production(mesh, nut, U)
        sqrtk = torch.sqrt(torch.clamp(k, min=K_MIN))
        gsk = fvc.grad_component(mesh, sqrtk, surface.owner_to_b(mesh, sqrtk))
        D = 2.0 * nu * torch.sum(gsk * gsk, dim=1)
        gU = fvc.grad_component(mesh, U.data, U.boundary_values(mesh))
        gU9 = gU.reshape(gU.shape[0], 9)
        ggU = fvc.grad_component(mesh, gU9, surface.owner_to_b(mesh, gU9))
        E = 2.0 * nu * nut * torch.sum(ggU * ggU, dim=(1, 2))

        eps_flat, eps_slot = _gamma_forms(mesh, nu, nut_f, self.sigma_eps)
        ddt_e = (fvm.ddt(mesh, eps_f, eps, rdt) if not steady
                 else fvm.ddt_steady(mesh, eps_f))
        eps_eqn = (
            ddt_e
            + _transport_ops(mesh, phi, phi_sl, eps_f, self.div_scheme,
                             eps_flat, eps_slot, self.corrected,
                             self.corr_limit)
            + fvm.Sp(mesh, self.C2 * f2 * eps / torch.clamp(k, min=K_MIN),
                     eps_f)
        )
        eps_eqn = eps_eqn.add_source(
            self.C1 * G * eps / torch.clamp(k, min=K_MIN) + E, mesh)
        if steady and relax < 1.0:
            eps_eqn = eps_eqn.relax(mesh, relax, eps)
        eps_new, perf_e = _solve_transport(mesh, eps_f, eps_eqn, controls)
        eps_new = bound_below(eps_new, EPS_MIN)
        diag["epsilon"] = perf_e

        k_flat, k_slot = _gamma_forms(mesh, nu, nut_f, self.sigma_k)
        ddt_k = (fvm.ddt(mesh, k_f, k, rdt) if not steady
                 else fvm.ddt_steady(mesh, k_f))
        k_eqn = (
            ddt_k
            + _transport_ops(mesh, phi, phi_sl, k_f, self.div_scheme,
                             k_flat, k_slot, self.corrected,
                             self.corr_limit)
            + fvm.Sp(mesh, (eps_new + D) / torch.clamp(k, min=K_MIN), k_f)
        )
        k_eqn = k_eqn.add_source(G, mesh)
        if steady and relax < 1.0:
            k_eqn = k_eqn.relax(mesh, relax, k)
        k_new, perf_k = _solve_transport(mesh, k_f, k_eqn, controls)
        k_new = bound_below(k_new, K_MIN)
        diag["k"] = perf_k

        Rt_n = k_new ** 2 / (nu * torch.clamp(eps_new, min=EPS_MIN))
        fMu = torch.exp(-3.4 / (1.0 + Rt_n / 50.0) ** 2)
        nut_new = self.Cmu * fMu * k_new ** 2 / torch.clamp(eps_new,
                                                            min=EPS_MIN)
        new_nut = nut_f.with_data(nut_new).correct_boundary_conditions(
            mesh, k=k_new, nu=nu, U=U.data)
        new = dict(tstate)
        new.update(k=k_f.with_data(k_new), epsilon=eps_f.with_data(eps_new),
                   nut=new_nut)
        return new, diag


def _cdes_delta(poly_mesh, cdes, dtype, device):
    """CDES times the cube-root-volume filter width, computed on the host
    in float64 (np.cbrt) and rounded once to `dtype`."""
    delta = np.cbrt(np.asarray(poly_mesh.v))
    return torch.tensor(cdes * delta, dtype=dtype, device=device)


class SpalartAllmarasDES(SpalartAllmaras):
    """Detached-eddy simulation SA-DES (LES/SpalartAllmarasDES):
    dTilda = min(y_wall, CDES delta) with delta = cubeRootVol. Both are
    mesh geometry, so the min is folded into y_wall at init."""

    name = "SpalartAllmarasDES"
    CDES = 0.65

    def __init__(self, nu, coeffs=None, y_wall=None):
        super().__init__(nu, coeffs, y_wall)
        c = self.coeffs or {}
        self.CDES = float(c.get("CDES", self.CDES))

    def init_wall_distance(self, poly_mesh, dtype, device=DEFAULT_DEVICE):
        super().init_wall_distance(poly_mesh, dtype, device)
        self.y_wall = torch.minimum(
            self.y_wall, _cdes_delta(poly_mesh, self.CDES, dtype, device))


class SpalartAllmarasDDES(SpalartAllmarasDES):
    """Delayed DES (LES/SpalartAllmarasDDES): the shield function
    fd = 1 - tanh((8 rd)^3) keeps the RANS length scale inside attached
    boundary layers; dTilda = y - fd max(0, y - CDES delta), evaluated
    every step from the velocity gradient."""

    name = "SpalartAllmarasDDES"

    def init_wall_distance(self, poly_mesh, dtype, device=DEFAULT_DEVICE):
        # the plain wall distance; the DES scale is kept apart
        SpalartAllmaras.init_wall_distance(self, poly_mesh, dtype, device)
        self._cdes_delta = _cdes_delta(poly_mesh, self.CDES, dtype, device)

    def d_tilda(self, mesh, U, nuT_f):
        y = self.y_wall
        g = fvc.grad(mesh, U)
        mag_gu = torch.sqrt(torch.clamp(torch.sum(g * g, dim=(1, 2)),
                                        min=1e-20))
        rd = torch.clamp(
            (nuT_f.data + self.nu)
            / (mag_gu * (self.kappa * y) ** 2 + 1e-20), max=10.0)
        fd = 1.0 - torch.tanh((8.0 * rd) ** 3)
        return y - fd * torch.clamp(y - self._cdes_delta, min=0.0)


register("kEpsilon", KEpsilon)
register("RNGkEpsilon", RNGkEpsilon)
register("realizableKE", RealizableKE)
register("kOmegaSST", KOmegaSST)
register("kOmega", KOmega)
register("SpalartAllmaras", SpalartAllmaras)
register("LaunderSharmaKE", LaunderSharmaKE)
register("SpalartAllmarasDES", SpalartAllmarasDES)
register("SpalartAllmarasDDES", SpalartAllmarasDDES)
