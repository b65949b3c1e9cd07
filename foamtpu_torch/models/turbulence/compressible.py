"""Compressible RAS/LES turbulence models (port of
openfoam-2.2.x_tpu/models/turbulence/compressible.py: the helpers
`_rho_ddt_q`, `_rho_ddt_steady`, `_dyn_gamma_forms`,
`_rho_transport_ops` and `_div_u`, `CompressibleRASBase`, and the five
models compressible::kEpsilon, LaunderSharmaKE, kOmegaSST, Smagorinsky
and oneEqEddy).

The rho-weighted twins of the incompressible models
(turbulenceModels/compressible/{RAS,LES}/):

  * transport equations in conservative form,
      ddt(rho, q) + div(phi_mass, q) - laplacian(muEff_q, q) = rho*S;
  * the -(2/3) rho divU q compressibility terms (fvm::SuSp) in the k and
    epsilon/omega equations;
  * mut = rho * Cmu k^2/eps is a dynamic viscosity field (0/mut) and
    alphat = mut/Prt (0/alphat) a field of its own; the mut* wall
    functions are the nut* formulas on nu = mu/rho, scaled by rho at the
    wall cells;
  * the molecular viscosity is the dynamic mu.

`base.select(props, mu, compressible=True)` takes a model from here when
the compressible name is registered, else the incompressible one.
"""

from __future__ import annotations

from typing import Any

import torch

from ...core.dimensions import DimensionSet
from ...core.fields import VolField
from ...ops import fvc, fvm, schemes
from ...ops import slot as slot_mod
from ...ops import surface
from ...ops.matrix import zero_matrix
from .base import TurbulenceModel, bound_below, production, register
from .les import cube_root_vol
from .ras import (_CMU, _KAPPA, EPS_MIN, K_MIN, OMEGA_MIN, KOmegaSST,
                  _has_wall_fn, _phi_slotform, _solve_transport, _wall_data,
                  _wall_face_nut)

_MASS_FLUX = DimensionSet.of(1, 0, -1)       # kg/s
_DYN_VISC = DimensionSet.of(1, -1, -1)       # kg/(m s)
_RHO_RATE = DimensionSet.of(1, -3, -1)       # rho/s (rho-weighted Sp)


def _rho_ddt_q(mesh, field: VolField, rho, rho0, old, rdt):
    """fvm::ddt(rho, q), Euler: diag = V rho/dt, source = V rho0 q0/dt
    (q a scalar or a [nC,k] field)."""
    m = zero_matrix(mesh, fvm._ncmp(field), dims=field.dims * _MASS_FLUX)
    return m.replace_fields(
        diag=mesh.v * rho * rdt,
        source=fvm._colv(mesh.v * rho0 * rdt, field.data) * old)


def _rho_ddt_steady(mesh, field: VolField):
    """steadyState ddt with rho-weighted row dimensions."""
    return zero_matrix(mesh, fvm._ncmp(field), dims=field.dims * _MASS_FLUX)


def _dyn_gamma_forms(mesh, mu, rho, mut_f: VolField, sigma=1.0):
    """The effective dynamic diffusivity mu + mut/sigma as (flat,
    SlotFace)."""
    bv = mu + mut_f.boundary_values(mesh) / sigma
    f = slot_mod.interpolate(mesh, mut_f.data / sigma)
    gs = slot_mod.SlotFace(mu + f.sv, mu + f.fb, bv)
    return slot_mod.to_flat(mesh, gs), gs


def _rho_transport_ops(mesh, phi_mass, phi_sl, field, div_scheme,
                       gamma_flat, gamma_slot, corrected, corr_limit):
    """div(phi_mass, q) - laplacian(muEff_q, q), conservative form."""
    ws = schemes.weights_slot(mesh, phi_sl, div_scheme, field)
    return (fvm.div(mesh, phi_mass, field, phi_slot=phi_sl,
                    slot_weights=ws, phi_dims=_MASS_FLUX)
            - fvm.laplacian(mesh, gamma_flat, field, corrected=corrected,
                            gamma_dims=_DYN_VISC, limit=corr_limit,
                            gamma_slot=gamma_slot))


def _div_u(mesh, phi_mass, rho_slot):
    """divU = fvc::div(phi/interpolate(rho)) [1/s] (signed face sum)."""
    phi_sl = slot_mod.from_flat(mesh, phi_mass)
    vol = slot_mod.SlotFace(phi_sl.sv / rho_slot.sv,
                            phi_sl.fb / rho_slot.fb,
                            phi_sl.bv / rho_slot.bv)
    return slot_mod.surface_sum(mesh, vol) / mesh.v


def _rho_slot_and_div_u(mesh, phi_mass, rho):
    rho_slot = slot_mod.interpolate(mesh, rho,
                                    bv=surface.owner_to_b(mesh, rho))
    return _div_u(mesh, phi_mass, rho_slot)


class CompressibleRASBase:
    """Mixin marking a model as rho-weighted, with the mut/alphat
    handling the compressible family shares."""

    compressible_form = True
    optional_fields = ("alphat",)
    Prt = 1.0

    def mut_of(self, tstate) -> Any:
        return tstate["mut"].data

    def alphat_of(self, mesh, tstate) -> Any:
        if "alphat" in tstate:
            return tstate["alphat"].data
        return self.mut_of(tstate) / self.Prt

    def _update_mut_alphat(self, mesh, tstate, mut_new, rho, k_new, U):
        """The mut BCs: the mut* wall functions are the nut* formulas on
        nu = mu/rho, evaluated in kinematic space and scaled by rho at
        the patch's cells (every BC whose value is per face)."""
        mut_f: VolField = tstate["mut"]
        cells_nu = self.mu / torch.clamp(rho, min=1e-10)
        nut_eq = mut_f.with_data(mut_new / torch.clamp(rho, min=1e-10))
        nut_eq = nut_eq.correct_boundary_conditions(
            mesh, k=k_new, nu=cells_nu, U=U.data)
        bcs = []
        for p, bc in zip(mesh.patches, nut_eq.bcs):
            rv = getattr(bc, "ref_value", None)
            if rv is not None and getattr(rv, "ndim", 0) >= 1 \
                    and rv.shape[0] == p.size:
                rho_w = rho[mesh.owner[p.slice]]
                bc = bc.replace(ref_value=rv * rho_w)
            bcs.append(bc)
        new_mut = mut_f.with_data(mut_new).replace(bcs=tuple(bcs))
        out = {"mut": new_mut}
        if "alphat" in tstate:
            at: VolField = tstate["alphat"]
            out["alphat"] = at.with_data(mut_new / self.Prt)
        return out


class CompressibleKEpsilon(CompressibleRASBase, TurbulenceModel):
    """compressible::kEpsilon (compressible/RAS/kEpsilon/):

      epsEqn: ddt(rho,eps)+div(phi,eps)-laplacian(DepsEff,eps)
              == C1 G eps/k - SuSp(((2/3)C1+C3) rho divU, eps)
                 - Sp(C2 rho eps/k, eps)
      kEqn:   ddt(rho,k)+div(phi,k)-laplacian(DkEff,k)
              == G - SuSp((2/3) rho divU, k) - Sp(rho eps/k, k)
      mut = rho Cmu k^2/eps;  alphat = mut/Prt
    """

    name = "compressible::kEpsilon"
    field_names = ("k", "epsilon", "mut")

    Cmu = _CMU
    C1 = 1.44
    C2 = 1.92
    C3 = -0.33
    sigma_k = 1.0
    sigma_eps = 1.3
    prod_limit = 10.0

    def __init__(self, mu, coeffs=None):
        # the molecular DYNAMIC viscosity rides in the base's nu slot
        super().__init__(mu, coeffs)
        self.mu = mu
        c = self.coeffs or {}
        self.Cmu = float(c.get("Cmu", self.Cmu))
        self.C1 = float(c.get("C1", self.C1))
        self.C2 = float(c.get("C2", self.C2))
        self.C3 = float(c.get("C3", self.C3))
        self.sigma_k = float(c.get("sigmak", self.sigma_k))
        self.sigma_eps = float(c.get("sigmaEps", self.sigma_eps))
        self.Prt = float(c.get("Prt", self.Prt))

    def correct_rho(self, mesh, tstate, U, phi_mass, rho, dt,
                    rho0=None, steady=False, relax=1.0, controls=None,
                    phi_slot=None, c1_field=None, c2_field=None,
                    fmu_field=None):
        """c1_field/c2_field/fmu_field: per-cell coefficients in place of
        the constants (RNG's strain-dependent C1, low-Re damping), passed
        in as KEpsilon.correct's c1_field is."""
        k_f: VolField = tstate["k"]
        eps_f: VolField = tstate["epsilon"]
        k, eps = k_f.data, eps_f.data
        mut = self.mut_of(tstate)
        rho0 = rho if rho0 is None else rho0
        rdt = 1.0 / dt
        diag = {}
        phi_sl = _phi_slotform(mesh, phi_mass, phi_slot)
        divU = _rho_slot_and_div_u(mesh, phi_mass, rho)

        # G = mut 2|symm(grad U)|^2 (the divU part of the reference's
        # production is the explicit SuSp terms below)
        _, S2 = production(mesh, torch.ones_like(k), U)
        G = mut * S2  # [kg/(m s^3)]
        G = torch.minimum(G, self.prod_limit * rho
                          * torch.clamp(eps, min=EPS_MIN))
        wall_fn = _has_wall_fn(eps_f, ("epsilonWallFunction",))
        if wall_fn:
            mask, y = _wall_data(mesh)
            sqrtk = torch.sqrt(torch.clamp(k, min=K_MIN))
            eps_wall = (self.Cmu ** 0.75) * sqrtk ** 3 / (_KAPPA * y)
            mutw = _wall_face_nut(mesh, tstate["mut"])
            magUp = torch.linalg.norm(U.data, dim=1) / y
            G_wall = ((mutw + self.mu) * magUp
                      * (self.Cmu ** 0.25) * sqrtk / (_KAPPA * y))
            G = torch.where(mask > 0, G_wall, G)

        kq = torch.clamp(k, min=K_MIN)

        # -- epsilon ---------------------------------------------------------
        eps_flat, eps_slot = _dyn_gamma_forms(mesh, self.mu, rho,
                                              tstate["mut"], self.sigma_eps)
        ddt_op = (_rho_ddt_q(mesh, eps_f, rho, rho0, eps, rdt)
                  if not steady else _rho_ddt_steady(mesh, eps_f))
        eps_eqn = (
            ddt_op
            + _rho_transport_ops(mesh, phi_mass, phi_sl, eps_f,
                                 self.div_scheme, eps_flat, eps_slot,
                                 self.corrected, self.corr_limit)
            + fvm.SuSp(mesh, ((2.0 / 3.0) * self.C1 + self.C3)
                       * rho * divU, eps_f, susp_dims=_RHO_RATE)
            + fvm.Sp(mesh, (self.C2 if c2_field is None else c2_field)
                     * rho * eps / kq, eps_f, sp_dims=_RHO_RATE)
        )
        c1 = self.C1 if c1_field is None else c1_field
        eps_eqn = eps_eqn.add_source(c1 * G * eps / kq, mesh)
        if steady and relax < 1.0:
            eps_eqn = eps_eqn.relax(mesh, relax, eps)
        if wall_fn:
            eps_eqn = eps_eqn.set_values(mask, eps_wall, mesh)
        eps_new, perf_e = _solve_transport(mesh, eps_f, eps_eqn, controls)
        eps_new = bound_below(eps_new, EPS_MIN)
        diag["epsilon"] = perf_e

        # -- k ----------------------------------------------------------------
        k_flat, k_slot = _dyn_gamma_forms(mesh, self.mu, rho,
                                          tstate["mut"], self.sigma_k)
        ddt_op = (_rho_ddt_q(mesh, k_f, rho, rho0, k, rdt)
                  if not steady else _rho_ddt_steady(mesh, k_f))
        k_eqn = (
            ddt_op
            + _rho_transport_ops(mesh, phi_mass, phi_sl, k_f,
                                 self.div_scheme, k_flat, k_slot,
                                 self.corrected, self.corr_limit)
            + fvm.SuSp(mesh, (2.0 / 3.0) * rho * divU, k_f,
                       susp_dims=_RHO_RATE)
            + fvm.Sp(mesh, rho * eps_new / kq, k_f, sp_dims=_RHO_RATE)
        )
        k_eqn = k_eqn.add_source(G, mesh)
        if steady and relax < 1.0:
            k_eqn = k_eqn.relax(mesh, relax, k)
        k_new, perf_k = _solve_transport(mesh, k_f, k_eqn, controls)
        k_new = bound_below(k_new, K_MIN)
        diag["k"] = perf_k

        mut_new = rho * self.Cmu * k_new * k_new / torch.clamp(eps_new,
                                                               min=EPS_MIN)
        if fmu_field is not None:
            mut_new = fmu_field * mut_new
        new = dict(tstate)
        new.update(k=k_f.with_data(k_new), epsilon=eps_f.with_data(eps_new))
        new.update(self._update_mut_alphat(mesh, tstate, mut_new, rho,
                                           k_new, U))
        return new, diag


class CompressibleLaunderSharmaKE(CompressibleKEpsilon):
    """compressible::LaunderSharmaKE (compressible/RAS/LaunderSharmaKE/):
    the kEpsilon step, then mut damped by fMu = exp(-3.4/(1 + Ret/50)^2)
    of the updated k and epsilon (the reference's mesh-resolved form: no
    E/D wall terms)."""

    name = "compressible::LaunderSharmaKE"

    def correct_rho(self, mesh, tstate, U, phi_mass, rho, dt,
                    rho0=None, steady=False, relax=1.0, controls=None,
                    phi_slot=None):
        nu_c = self.mu / torch.clamp(rho, min=1e-10)
        new, diag = super().correct_rho(
            mesh, tstate, U, phi_mass, rho, dt, rho0=rho0, steady=steady,
            relax=relax, controls=controls, phi_slot=phi_slot)
        # re-damp mut with fMu of the updated fields (the reference also
        # evaluates fMu and f2 of the old fields, and uses neither)
        k_n = new["k"].data
        e_n = torch.clamp(new["epsilon"].data, min=EPS_MIN)
        Ret_n = k_n * k_n / (nu_c * e_n)
        fMu_n = torch.exp(-3.4 / (1.0 + Ret_n / 50.0) ** 2)
        mut_damped = fMu_n * rho * self.Cmu * k_n * k_n / e_n
        new.update(self._update_mut_alphat(mesh, tstate, mut_damped, rho,
                                           k_n, U))
        return new, diag


class CompressibleKOmegaSST(CompressibleRASBase, KOmegaSST):
    """compressible::kOmegaSST (compressible/RAS/kOmegaSST/): Menter SST
    in rho-weighted form with the (2/3) rho divU compressibility terms;
    mut = rho a1 k / max(a1 omega, b1 F2 S). Needs init_wall_distance
    before the first correct_rho."""

    name = "compressible::kOmegaSST"
    field_names = ("k", "omega", "mut")

    def __init__(self, mu, coeffs=None, y_wall=None):
        KOmegaSST.__init__(self, mu, coeffs, y_wall=y_wall)
        self.mu = mu
        c = self.coeffs or {}
        self.Prt = float(c.get("Prt", self.Prt))

    def correct_rho(self, mesh, tstate, U, phi_mass, rho, dt,
                    rho0=None, steady=False, relax=1.0, controls=None,
                    phi_slot=None):
        if self.y_wall is None:
            raise ValueError("compressible::kOmegaSST needs "
                             "init_wall_distance before correct_rho")
        k_f: VolField = tstate["k"]
        w_f: VolField = tstate["omega"]
        mut_f: VolField = tstate["mut"]
        k, omega = k_f.data, w_f.data
        mut = mut_f.data
        rho0 = rho if rho0 is None else rho0
        rdt = 1.0 / dt
        diag = {}
        nu_c = self.mu / torch.clamp(rho, min=1e-10)
        phi_sl = _phi_slotform(mesh, phi_mass, phi_slot)
        divU = _rho_slot_and_div_u(mesh, phi_mass, rho)

        gk = fvc.grad(mesh, k_f)
        gw = fvc.grad(mesh, w_f)
        gkgw = torch.sum(gk * gw, dim=1)
        # the blending with nu = mu/rho per cell
        y = self.y_wall
        sqrtk = torch.sqrt(torch.clamp(k, min=K_MIN))
        w = torch.clamp(omega, min=OMEGA_MIN)
        cd = torch.clamp(2.0 * self.alphaOmega2 * gkgw / w, min=1e-10)
        arg1 = torch.minimum(
            torch.maximum(sqrtk / (self.betaStar * w * y),
                          500.0 * nu_c / (y * y * w)),
            4.0 * self.alphaOmega2 * k / (cd * y * y))
        F1 = torch.tanh(torch.clamp(arg1, max=10.0) ** 4)
        arg2 = torch.maximum(2.0 * sqrtk / (self.betaStar * w * y),
                             500.0 * nu_c / (y * y * w))
        F2 = torch.tanh(torch.clamp(arg2, max=10.0) ** 2)

        def mix(a, b):
            return F1 * a + (1.0 - F1) * b

        _, S2 = production(mesh, torch.ones_like(k), U)
        S = torch.sqrt(S2)
        G = mut * S2
        gamma = mix(self.gamma1, self.gamma2)
        beta = mix(self.beta1, self.beta2)

        wall_fn = _has_wall_fn(w_f, ("omegaWallFunction",))
        if wall_fn:
            mask, y1 = _wall_data(mesh)
            w_vis = 6.0 * nu_c / (self.beta1 * y1 * y1)
            w_log = sqrtk / ((_CMU ** 0.25) * _KAPPA * y1)
            omega_wall = torch.sqrt(w_vis ** 2 + w_log ** 2)
            mutw = _wall_face_nut(mesh, mut_f)
            magUp = torch.linalg.norm(U.data, dim=1) / y1
            G_wall = ((mutw + self.mu) * magUp
                      * (_CMU ** 0.25) * sqrtk / (_KAPPA * y1))
            G = torch.where(mask > 0, G_wall, G)

        # -- omega -------------------------------------------------------------
        w_flat, w_slot = _dyn_gamma_forms(
            mesh, self.mu, rho,
            mut_f.with_data(mix(self.alphaOmega1, self.alphaOmega2) * mut))
        ddt_w = (_rho_ddt_q(mesh, w_f, rho, rho0, omega, rdt)
                 if not steady else _rho_ddt_steady(mesh, w_f))
        w_eqn = (
            ddt_w
            + _rho_transport_ops(mesh, phi_mass, phi_sl, w_f,
                                 self.div_scheme, w_flat, w_slot, False,
                                 self.corr_limit)
            + fvm.SuSp(mesh, (2.0 / 3.0) * gamma * rho * divU, w_f,
                       susp_dims=_RHO_RATE)
            + fvm.Sp(mesh, beta * rho * omega, w_f, sp_dims=_RHO_RATE)
        )
        w_eqn = w_eqn.add_source(
            rho * gamma * S2 + rho * (1.0 - F1) * cd, mesh)
        if steady and relax < 1.0:
            w_eqn = w_eqn.relax(mesh, relax, omega)
        if wall_fn:
            w_eqn = w_eqn.set_values(mask, omega_wall, mesh)
        w_new, perf_w = _solve_transport(mesh, w_f, w_eqn, controls)
        w_new = bound_below(w_new, OMEGA_MIN)
        diag["omega"] = perf_w

        # -- k -------------------------------------------------------------------
        Gk = torch.minimum(G, self.c1 * self.betaStar * rho * k * w_new)
        k_flat, k_slot = _dyn_gamma_forms(
            mesh, self.mu, rho,
            mut_f.with_data(mix(self.alphaK1, self.alphaK2) * mut))
        ddt_k = (_rho_ddt_q(mesh, k_f, rho, rho0, k, rdt)
                 if not steady else _rho_ddt_steady(mesh, k_f))
        k_eqn = (
            ddt_k
            + _rho_transport_ops(mesh, phi_mass, phi_sl, k_f,
                                 self.div_scheme, k_flat, k_slot,
                                 self.corrected, self.corr_limit)
            + fvm.SuSp(mesh, (2.0 / 3.0) * rho * divU, k_f,
                       susp_dims=_RHO_RATE)
            + fvm.Sp(mesh, self.betaStar * rho * w_new, k_f,
                     sp_dims=_RHO_RATE)
        )
        k_eqn = k_eqn.add_source(Gk, mesh)
        if steady and relax < 1.0:
            k_eqn = k_eqn.relax(mesh, relax, k)
        k_new, perf_k = _solve_transport(mesh, k_f, k_eqn, controls)
        k_new = bound_below(k_new, K_MIN)
        diag["k"] = perf_k

        mut_new = rho * self.a1 * k_new / torch.maximum(
            self.a1 * torch.clamp(w_new, min=OMEGA_MIN), self.b1 * F2 * S)
        new = dict(tstate)
        new.update(k=k_f.with_data(k_new), omega=w_f.with_data(w_new))
        new.update(self._update_mut_alphat(mesh, tstate, mut_new, rho,
                                           k_new, U))
        return new, diag


# -- compressible LES ---------------------------------------------------------


class CompressibleSmagorinsky(CompressibleRASBase, TurbulenceModel):
    """compressible::Smagorinsky (compressible/LES/Smagorinsky/):
    muSgs = rho ck sqrt(k) delta with the local-equilibrium
    k = (2 ck/ce) delta^2 |symm(grad U)|^2, delta = cbrt(V)."""

    name = "compressible::Smagorinsky"
    field_names = ("mut",)
    ck = 0.094
    ce = 1.048

    def __init__(self, mu, coeffs=None):
        super().__init__(mu, coeffs)
        self.mu = mu
        c = self.coeffs or {}
        self.ck = float(c.get("ck", self.ck))
        self.ce = float(c.get("ce", self.ce))
        self.Prt = float(c.get("Prt", self.Prt))
        self._delta_cache = {}

    def correct_rho(self, mesh, tstate, U, phi_mass, rho, dt,
                    rho0=None, steady=False, relax=1.0, controls=None,
                    phi_slot=None):
        delta = cube_root_vol(mesh, self._delta_cache)
        _, S2 = production(mesh, mesh.v.new_ones((mesh.n_cells,)), U)
        k_sgs = (2.0 * self.ck / self.ce) * delta * delta * (S2 / 2.0)
        mut_new = rho * self.ck * torch.sqrt(
            torch.clamp(k_sgs, min=0.0)) * delta
        new = dict(tstate)
        new.update(self._update_mut_alphat(
            mesh, tstate, mut_new, rho, torch.clamp(k_sgs, min=K_MIN), U))
        return new, {}


class CompressibleOneEqEddy(CompressibleRASBase, TurbulenceModel):
    """compressible::oneEqEddy (compressible/LES/oneEqEddy/): the SGS k
    transported in rho-weighted form,
      ddt(rho,k)+div(phi,k)-laplacian(muEff,k)
        == G - (2/3) rho divU k - ce rho k^1.5/delta
    muSgs = rho ck sqrt(k) delta."""

    name = "compressible::oneEqEddy"
    field_names = ("k", "mut")
    ck = 0.094
    ce = 1.048

    def __init__(self, mu, coeffs=None):
        super().__init__(mu, coeffs)
        self.mu = mu
        c = self.coeffs or {}
        self.ck = float(c.get("ck", self.ck))
        self.ce = float(c.get("ce", self.ce))
        self.Prt = float(c.get("Prt", self.Prt))
        self._delta_cache = {}

    def correct_rho(self, mesh, tstate, U, phi_mass, rho, dt,
                    rho0=None, steady=False, relax=1.0, controls=None,
                    phi_slot=None):
        k_f: VolField = tstate["k"]
        k = k_f.data
        mut = self.mut_of(tstate)
        rho0 = rho if rho0 is None else rho0
        rdt = 1.0 / dt
        delta = cube_root_vol(mesh, self._delta_cache)
        phi_sl = _phi_slotform(mesh, phi_mass, phi_slot)
        divU = _rho_slot_and_div_u(mesh, phi_mass, rho)
        _, S2 = production(mesh, torch.ones_like(k), U)
        G = mut * S2

        k_flat, k_slot = _dyn_gamma_forms(mesh, self.mu, rho,
                                          tstate["mut"], 1.0)
        ddt_op = (_rho_ddt_q(mesh, k_f, rho, rho0, k, rdt)
                  if not steady else _rho_ddt_steady(mesh, k_f))
        k_eqn = (
            ddt_op
            + _rho_transport_ops(mesh, phi_mass, phi_sl, k_f,
                                 self.div_scheme, k_flat, k_slot,
                                 self.corrected, self.corr_limit)
            + fvm.SuSp(mesh, (2.0 / 3.0) * rho * divU, k_f,
                       susp_dims=_RHO_RATE)
            + fvm.Sp(mesh, self.ce * rho
                     * torch.sqrt(torch.clamp(k, min=K_MIN)) / delta, k_f,
                     sp_dims=_RHO_RATE)
        )
        k_eqn = k_eqn.add_source(G, mesh)
        k_new, perf_k = _solve_transport(mesh, k_f, k_eqn, controls)
        k_new = bound_below(k_new, K_MIN)
        mut_new = rho * self.ck * torch.sqrt(k_new) * delta
        new = dict(tstate)
        new["k"] = k_f.with_data(k_new)
        new.update(self._update_mut_alphat(mesh, tstate, mut_new, rho,
                                           k_new, U))
        return new, {"k": perf_k}


register("compressible::kEpsilon", CompressibleKEpsilon)
register("compressible::LaunderSharmaKE", CompressibleLaunderSharmaKE)
register("compressible::kOmegaSST", CompressibleKOmegaSST)
register("compressible::Smagorinsky", CompressibleSmagorinsky)
register("compressible::oneEqEddy", CompressibleOneEqEddy)
