"""The rest of the compressible turbulence models (port of
openfoam-2.2.x_tpu/models/turbulence/compressible2.py: `_rho_slot`,
`_cell_gamma_forms` and the nine models compressible::RNGkEpsilon,
realizableKE, SpalartAllmaras, LRR, LaunderGibsonRSTM, v2f, dynOneEqEddy,
lowReOneEqEddy and DeardorffDiffStress).

The design of compressible.py: conservative (rho-weighted) transport, the
-(2/3) rho divU compressibility terms, mut and alphat as dynamic-viscosity
fields. R and B stay kinematic [m^2/s^2] and are transported as rho R
(rho B) with every source rho-weighted; their six components solve
against one matrix. compressible::v2f has no twin in the C++ 2.2.x tree;
the reference package provides it as the rho-weighted Lien-Kalitzin
closure, and so does the port.
"""

from __future__ import annotations

import torch

from ...core.dimensions import dimViscosity
from ...core.fields import VolField
from ...core.precision import DEFAULT_DEVICE
from ...ops import fvc, fvm, schemes
from ...ops import slot as slot_mod
from ...ops import surface
from .base import TurbulenceModel, bound_below, production, register
from .compressible import (_DYN_VISC, _MASS_FLUX, _RHO_RATE,
                           CompressibleKEpsilon, CompressibleOneEqEddy,
                           CompressibleRASBase, _div_u, _dyn_gamma_forms,
                           _rho_ddt_q, _rho_ddt_steady, _rho_transport_ops)
from .les import cube_root_vol
from .les2 import _dev, _filter_tensor, _sym_grad, _vavg, simple_filter
from .ras import (_CMU, _KAPPA, EPS_MIN, K_MIN, _has_wall_fn, _phi_slotform,
                  _solve_transport, _wall_data, _wall_distance_on,
                  _wall_face_nut)
from .ras2 import _cell_gamma as _cell_gamma_forms
from .ras2 import (_WallDistance, _div_symm_tensor, dev6, eye6,
                   floor_normals, half_trace, stress_production,
                   wall_reflection)


def _rho_slot(mesh, rho):
    """rho interpolated to the faces, owner values on the boundary."""
    return slot_mod.interpolate(mesh, rho, bv=surface.owner_to_b(mesh, rho))


class CompressibleRNGKEpsilon(CompressibleKEpsilon):
    """compressible::RNGkEpsilon (compressible/RAS/RNGkEpsilon/): the
    rho-weighted kEpsilon with C1eff = C1 - eta(1 - eta/eta0)/(1 + beta
    eta^3), eta = |S| k/eps of the kinematic strain."""

    name = "compressible::RNGkEpsilon"
    Cmu = 0.0845
    C1 = 1.42
    C2 = 1.68
    C3 = -0.33
    sigma_k = 0.71942
    sigma_eps = 0.71942
    eta0 = 4.38
    beta = 0.012

    def correct_rho(self, mesh, tstate, U, phi_mass, rho, dt,
                    rho0=None, steady=False, relax=1.0, controls=None,
                    phi_slot=None):
        k = tstate["k"].data
        eps = tstate["epsilon"].data
        nut = self.mut_of(tstate) / torch.clamp(rho, min=1e-10)
        _, S2 = production(mesh, nut, U)
        eta = torch.sqrt(S2) * k / torch.clamp(eps, min=EPS_MIN)
        c1_eff = self.C1 - eta * (1.0 - eta / self.eta0) / (
            1.0 + self.beta * eta ** 3)
        return super().correct_rho(
            mesh, tstate, U, phi_mass, rho, dt, rho0=rho0, steady=steady,
            relax=relax, controls=controls, phi_slot=phi_slot,
            c1_field=c1_eff)


class CompressibleRealizableKE(CompressibleRASBase, TurbulenceModel):
    """compressible::realizableKE (compressible/RAS/realizableKE/): the
    Shih variable-Cmu realizable k-epsilon in conservative form,

      epsEqn: ddt(rho,eps)+div(phi,eps)-lap(DepsEff,eps)
              == C1r rho |S| eps - Sp(C2r rho eps/(k+sqrt(nu eps)))
      kEqn:   ddt(rho,k)+div(phi,k)-lap(DkEff,k)
              == G - SuSp((2/3) rho divU, k) - Sp(rho eps/k, k)
      mut = rho Cmu(S,W,k/eps) k^2/eps."""

    name = "compressible::realizableKE"
    field_names = ("k", "epsilon", "mut")

    A0 = 4.0
    C2r = 1.9
    sigma_k = 1.0
    sigma_eps = 1.2

    def __init__(self, mu, coeffs=None):
        super().__init__(mu, coeffs)
        self.mu = mu
        c = self.coeffs or {}
        self.A0 = float(c.get("A0", self.A0))
        self.C2r = float(c.get("C2", self.C2r))
        self.sigma_k = float(c.get("sigmak", self.sigma_k))
        self.sigma_eps = float(c.get("sigmaEps", self.sigma_eps))
        self.Prt = float(c.get("Prt", self.Prt))

    def correct_rho(self, mesh, tstate, U, phi_mass, rho, dt,
                    rho0=None, steady=False, relax=1.0, controls=None,
                    phi_slot=None):
        k_f: VolField = tstate["k"]
        eps_f: VolField = tstate["epsilon"]
        k, eps = k_f.data, eps_f.data
        mut = self.mut_of(tstate)
        rho0 = rho if rho0 is None else rho0
        rdt = 1.0 / dt
        diag = {}
        nu_c = self.mu / torch.clamp(rho, min=1e-10)
        phi_sl = _phi_slotform(mesh, phi_mass, phi_slot)
        divU = _div_u(mesh, phi_mass, _rho_slot(mesh, rho))

        g = fvc.grad(mesh, U)
        s = 0.5 * (g + torch.transpose(g, 1, 2))
        w = 0.5 * (g - torch.transpose(g, 1, 2))
        s2 = 2.0 * torch.sum(s * s, dim=(1, 2))
        magS = torch.sqrt(s2)
        G = mut * s2

        # the 1e-12 floor keeps the 0/0 of a zero-strain cell out of arccos
        ksum = torch.sum(s * s, dim=(1, 2))
        wsum = torch.sum(w * w, dim=(1, 2))
        Ustar = torch.sqrt(ksum + wsum)
        sss = torch.einsum("cij,cjk,cki->c", s, s, s)
        As = 6.0 ** 0.5 * torch.cos(
            (1.0 / 3.0) * torch.arccos(torch.clamp(
                6.0 ** 0.5 * sss / torch.clamp(ksum, min=1e-12) ** 1.5,
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
            mutw = _wall_face_nut(mesh, tstate["mut"])
            magUp = torch.linalg.norm(U.data, dim=1) / y
            G = torch.where(mask > 0,
                            (mutw + self.mu) * magUp * (_CMU ** 0.25)
                            * sqrtk / (_KAPPA * y), G)

        kq = torch.clamp(k, min=K_MIN)

        eps_flat, eps_slot = _dyn_gamma_forms(mesh, self.mu, rho,
                                              tstate["mut"], self.sigma_eps)
        ddt_e = (_rho_ddt_q(mesh, eps_f, rho, rho0, eps, rdt)
                 if not steady else _rho_ddt_steady(mesh, eps_f))
        eps_eqn = (
            ddt_e
            + _rho_transport_ops(mesh, phi_mass, phi_sl, eps_f,
                                 self.div_scheme, eps_flat, eps_slot,
                                 self.corrected, self.corr_limit)
            + fvm.Sp(mesh, self.C2r * rho * eps / (
                k + torch.sqrt(nu_c * torch.clamp(eps, min=EPS_MIN))),
                eps_f, sp_dims=_RHO_RATE)
        )
        eps_eqn = eps_eqn.add_source(C1r * rho * magS * eps, mesh)
        if steady and relax < 1.0:
            eps_eqn = eps_eqn.relax(mesh, relax, eps)
        if wall_fn:
            eps_eqn = eps_eqn.set_values(mask, eps_wall, mesh)
        eps_new, perf_e = _solve_transport(mesh, eps_f, eps_eqn, controls)
        eps_new = bound_below(eps_new, EPS_MIN)
        diag["epsilon"] = perf_e

        k_flat, k_slot = _dyn_gamma_forms(mesh, self.mu, rho,
                                          tstate["mut"], self.sigma_k)
        ddt_k = (_rho_ddt_q(mesh, k_f, rho, rho0, k, rdt)
                 if not steady else _rho_ddt_steady(mesh, k_f))
        k_eqn = (
            ddt_k
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

        mut_new = rho * cmu_r * k_new * k_new / torch.clamp(eps_new,
                                                            min=EPS_MIN)
        new = dict(tstate)
        new.update(k=k_f.with_data(k_new), epsilon=eps_f.with_data(eps_new))
        new.update(self._update_mut_alphat(mesh, tstate, mut_new, rho,
                                           k_new, U))
        return new, diag


class CompressibleSpalartAllmaras(CompressibleRASBase, TurbulenceModel):
    """compressible::SpalartAllmaras (compressible/RAS/SpalartAllmaras/):
    rho-weighted nuTilda transport (the 2.2 fv3 form),

      ddt(rho,nuTilda) + div(phi,nuTilda) - lap(DnuTildaEff,nuTilda)
        == Cb1 rho Stilda nuTilda
           + (Cb2/sigmaNut) rho |grad nuTilda|^2
           - Sp(Cw1 fw rho nuTilda / y^2, nuTilda)
      DnuTildaEff = (rho nuTilda + mu)/sigmaNut;  mut = rho nuTilda fv1."""

    name = "compressible::SpalartAllmaras"
    field_names = ("nuTilda", "mut")

    sigmaNut = 0.66666
    kappa = 0.41
    Cb1 = 0.1355
    Cb2 = 0.622
    Cv1 = 7.1
    Cv2 = 5.0
    Cw2 = 0.3
    Cw3 = 2.0

    def __init__(self, mu, coeffs=None, y_wall=None):
        super().__init__(mu, coeffs)
        self.mu = mu
        c = self.coeffs or {}
        self.sigmaNut = float(c.get("sigmaNut", self.sigmaNut))
        self.Cb1 = float(c.get("Cb1", self.Cb1))
        self.Cb2 = float(c.get("Cb2", self.Cb2))
        self.Cv1 = float(c.get("Cv1", self.Cv1))
        self.Prt = float(c.get("Prt", self.Prt))
        self.Cw1 = (self.Cb1 / self.kappa ** 2
                    + (1.0 + self.Cb2) / self.sigmaNut)
        self.y_wall = y_wall

    def init_wall_distance(self, poly_mesh, dtype, device=DEFAULT_DEVICE):
        self.y_wall = _wall_distance_on(poly_mesh, dtype, device)

    def _fv1(self, chi):
        c3 = chi ** 3
        return c3 / (c3 + self.Cv1 ** 3)

    def correct_rho(self, mesh, tstate, U, phi_mass, rho, dt,
                    rho0=None, steady=False, relax=1.0, controls=None,
                    phi_slot=None):
        nuT_f: VolField = tstate["nuTilda"]
        nuT = nuT_f.data
        rho0 = rho if rho0 is None else rho0
        rdt = 1.0 / dt
        phi_sl = _phi_slotform(mesh, phi_mass, phi_slot)
        y = self.y_wall
        nu_c = self.mu / torch.clamp(rho, min=1e-10)

        chi = nuT / nu_c
        fv1 = self._fv1(chi)
        fv2 = torch.pow(1.0 + chi / self.Cv2, -3.0)
        fv3 = ((1.0 + chi * fv1) * (1.0 - fv2)
               / torch.clamp(chi, min=1e-10))
        g = fvc.grad(mesh, U)
        w = 0.5 * (g - torch.transpose(g, 1, 2))
        Omega = torch.sqrt(2.0 * torch.sum(w * w, dim=(1, 2)))
        ky2 = (self.kappa * y) ** 2
        Stilda = torch.clamp(fv3 * Omega + fv2 * nuT / ky2, min=1e-10)

        r = torch.clamp(nuT / (Stilda * ky2), max=10.0)
        gw = r + self.Cw2 * (r ** 6 - r)
        fw = gw * torch.pow(
            (1.0 + self.Cw3 ** 6) / (gw ** 6 + self.Cw3 ** 6), 1.0 / 6.0)

        # the dynamic diffusivity
        d_flat, d_slot = _cell_gamma_forms(
            mesh, (rho * nuT + self.mu) / self.sigmaNut)
        wself = schemes.weights_slot(mesh, phi_sl, self.div_scheme, nuT_f)
        gnt = fvc.grad_component(mesh, nuT, nuT_f.boundary_values(mesh))
        mag2_gnt = torch.sum(gnt * gnt, dim=1)
        ddt_op = (_rho_ddt_q(mesh, nuT_f, rho, rho0, nuT, rdt)
                  if not steady else _rho_ddt_steady(mesh, nuT_f))
        eqn = (
            ddt_op
            + fvm.div(mesh, phi_mass, nuT_f, phi_slot=phi_sl,
                      slot_weights=wself, phi_dims=_MASS_FLUX)
            - fvm.laplacian(mesh, d_flat, nuT_f, corrected=self.corrected,
                            gamma_dims=_DYN_VISC, limit=self.corr_limit,
                            gamma_slot=d_slot)
            + fvm.Sp(mesh, self.Cw1 * fw * rho * nuT / (y * y), nuT_f,
                     sp_dims=_RHO_RATE)
        )
        eqn = eqn.add_source(
            self.Cb1 * rho * Stilda * nuT
            + (self.Cb2 / self.sigmaNut) * rho * mag2_gnt, mesh)
        if steady and relax < 1.0:
            eqn = eqn.relax(mesh, relax, nuT)
        nuT_new, perf = _solve_transport(mesh, nuT_f, eqn, controls)
        nuT_new = bound_below(nuT_new, 0.0)

        chi_n = nuT_new / nu_c
        mut_new = rho * nuT_new * self._fv1(chi_n)
        new = dict(tstate)
        new["nuTilda"] = nuT_f.with_data(nuT_new)
        # nuTilda stands in for k where a mut BC kind would read one
        new.update(self._update_mut_alphat(mesh, tstate, mut_new, rho,
                                           nuT_new, U))
        return new, {"nuTilda": perf}


class CompressibleLRR(CompressibleRASBase, TurbulenceModel):
    """compressible::LRR (compressible/RAS/LRR/): rho-weighted
    Reynolds-stress transport; R stays kinematic and is transported as
    rho R, every source rho-weighted, the compressibility SuSp terms on R
    and epsilon:

        REqn: ddt(rho,R)+div(phi,R)-lap(DREff,R)
              + Sp(Clrr1 rho eps/k) + SuSp((2/3) rho divU)
              == rho [P + (2/3)(Clrr1-1) eps I - Clrr2 dev(P)]
        DREff = mu + Cs rho k^2/eps."""

    name = "compressible::LRR"
    field_names = ("R", "epsilon", "k", "mut")

    Cmu = _CMU
    Clrr1 = 1.8
    Clrr2 = 0.6
    C1 = 1.44
    C2 = 1.92
    C3 = -0.33
    Cs = 0.25
    Ceps = 0.15

    def __init__(self, mu, coeffs=None):
        super().__init__(mu, coeffs)
        self.mu = mu
        c = self.coeffs or {}
        for key in ("Cmu", "Clrr1", "Clrr2", "C1", "C2", "Cs", "Ceps"):
            setattr(self, key, float(c.get(key, getattr(self, key))))
        self.Prt = float(c.get("Prt", self.Prt))

    def _pressure_strain_extra(self, mesh, tstate, U, R6, P6, k, eps):
        return None

    def div_dev_reff(self, mesh, tstate, U: VolField):
        """The generic form over nut (the compressible solvers couple
        through mut)."""
        return TurbulenceModel.div_dev_reff(self, mesh, tstate, U)

    def correct_rho(self, mesh, tstate, U, phi_mass, rho, dt,
                    rho0=None, steady=False, relax=1.0, controls=None,
                    phi_slot=None):
        R_f, eps_f = tstate["R"], tstate["epsilon"]
        k_fld = tstate["k"]
        R6 = R_f.data
        eps = torch.clamp(eps_f.data, min=EPS_MIN)
        rho0 = rho if rho0 is None else rho0
        rdt = 1.0 / dt
        diag = {}
        phi_sl = _phi_slotform(mesh, phi_mass, phi_slot)
        divU = _div_u(mesh, phi_mass, _rho_slot(mesh, rho))

        k = half_trace(R6)
        P6 = stress_production(R6, fvc.grad(mesh, U))
        G = torch.clamp(0.5 * (P6[:, 0] + P6[:, 3] + P6[:, 5]), min=0.0)

        wall_fn = _has_wall_fn(eps_f, ("epsilonWallFunction",))
        if wall_fn:
            mask, y1 = _wall_data(mesh)
            sqrtk = torch.sqrt(k)
            eps_wall = (self.Cmu ** 0.75) * sqrtk ** 3 / (_KAPPA * y1)
            mutw = _wall_face_nut(mesh, tstate["mut"])
            magUp = torch.linalg.norm(U.data, dim=1) / y1
            G_wall = ((mutw + self.mu) / torch.clamp(rho, min=1e-10)
                      * magUp * (self.Cmu ** 0.25) * sqrtk / (_KAPPA * y1))
            G = torch.where(mask > 0, G_wall, G)

        # epsilon (rho-weighted, the divU SuSp as in kEpsilon)
        deps_flat, deps_slot = _cell_gamma_forms(
            mesh, self.mu + self.Ceps * rho * k * k / eps)
        ddt_e = (_rho_ddt_q(mesh, eps_f, rho, rho0, eps_f.data, rdt)
                 if not steady else _rho_ddt_steady(mesh, eps_f))
        e_eqn = (
            ddt_e
            + _rho_transport_ops(mesh, phi_mass, phi_sl, eps_f,
                                 self.div_scheme, deps_flat, deps_slot,
                                 self.corrected, self.corr_limit)
            + fvm.SuSp(mesh, ((2.0 / 3.0) * self.C1 + self.C3)
                       * rho * divU, eps_f, susp_dims=_RHO_RATE)
            + fvm.Sp(mesh, self.C2 * rho * eps / k, eps_f,
                     sp_dims=_RHO_RATE)
        )
        e_eqn = e_eqn.add_source(self.C1 * rho * G * eps / k, mesh)
        if steady and relax < 1.0:
            e_eqn = e_eqn.relax(mesh, relax, eps_f.data)
        if wall_fn:
            e_eqn = e_eqn.set_values(mask, eps_wall, mesh)
        eps_new, perf_e = _solve_transport(mesh, eps_f, e_eqn, controls)
        eps_new = bound_below(eps_new, EPS_MIN)
        diag["epsilon"] = perf_e

        # R (six components, one matrix)
        dR_flat, dR_slot = _cell_gamma_forms(
            mesh, self.mu + self.Cs * rho * k * k / eps_new)
        ddt_R = (_rho_ddt_q(mesh, R_f, rho, rho0, R6, rdt)
                 if not steady else _rho_ddt_steady(mesh, R_f))
        R_eqn = (
            ddt_R
            + _rho_transport_ops(mesh, phi_mass, phi_sl, R_f,
                                 self.div_scheme, dR_flat, dR_slot,
                                 self.corrected, self.corr_limit)
            + fvm.SuSp(mesh, (2.0 / 3.0) * rho * divU, R_f,
                       susp_dims=_RHO_RATE)
            + fvm.Sp(mesh, self.Clrr1 * rho * eps_new / k, R_f,
                     sp_dims=_RHO_RATE)
        )
        iso = ((2.0 / 3.0) * (self.Clrr1 - 1.0) * eps_new)[:, None] \
            * eye6(R6)
        srcR = rho[:, None] * (P6 + iso - self.Clrr2 * dev6(P6))
        extra = self._pressure_strain_extra(mesh, tstate, U, R6, P6,
                                            k, eps_new)
        if extra is not None:
            srcR = srcR + rho[:, None] * extra
        R_eqn = R_eqn.add_source(srcR, mesh)
        if steady and relax < 1.0:
            R_eqn = R_eqn.relax(mesh, relax, R6)
        R_new, perf_R = _solve_transport(mesh, R_f, R_eqn, controls)
        diag["R"] = perf_R

        R_new = floor_normals(R_new)
        k_new = half_trace(R_new)
        mut_new = rho * self.Cmu * k_new * k_new / eps_new
        new = dict(tstate)
        new.update(R=R_f.with_data(R_new), epsilon=eps_f.with_data(eps_new),
                   k=k_fld.with_data(k_new))
        new.update(self._update_mut_alphat(mesh, tstate, mut_new, rho,
                                           k_new, U))
        return new, diag


class CompressibleLaunderGibsonRSTM(_WallDistance, CompressibleLRR):
    """compressible::LaunderGibsonRSTM
    (compressible/RAS/LaunderGibsonRSTM/): compressible LRR plus the
    Gibson-Launder wall reflection, the kinematic tensor algebra of the
    incompressible model (ras2.wall_reflection), rho-weighted where
    CompressibleLRR assembles its source."""

    name = "compressible::LaunderGibsonRSTM"
    C1Ref = 0.5
    C2Ref = 0.3

    def __init__(self, mu, coeffs=None):
        super().__init__(mu, coeffs)
        c = self.coeffs or {}
        self.C1Ref = float(c.get("C1Ref", self.C1Ref))
        self.C2Ref = float(c.get("C2Ref", self.C2Ref))

    def _pressure_strain_extra(self, mesh, tstate, U, R6, P6, k, eps):
        return wall_reflection(self, mesh, R6, P6, k, eps)


class CompressibleV2F(CompressibleRASBase, TurbulenceModel):
    """compressible::v2f: the rho-weighted Lien-Kalitzin v2-f of the
    reference package (no 2.2.x C++ twin): k, epsilon and v2 in
    conservative form with the (2/3) rho divU term on k, the elliptic f
    relaxation kinematic, mut = rho min(Cmu v2 T, CmuKEps k^2/eps)."""

    name = "compressible::v2f"
    field_names = ("k", "epsilon", "v2", "f", "mut")

    Cmu = 0.22
    CmuKEps = 0.09
    C1 = 1.4
    C2 = 0.3
    CL = 0.23
    Ceta = 70.0
    Ceps2 = 1.9
    sigmaK = 1.0
    sigmaEps = 1.3
    N = 6.0

    def __init__(self, mu, coeffs=None):
        super().__init__(mu, coeffs)
        self.mu = mu
        c = self.coeffs or {}
        for key in ("Cmu", "CmuKEps", "C1", "C2", "CL", "Ceta", "Ceps2",
                    "sigmaK", "sigmaEps"):
            setattr(self, key, float(c.get(key, getattr(self, key))))
        self.Prt = float(c.get("Prt", self.Prt))

    def _scales(self, nu_c, k, eps):
        T = torch.maximum(k / eps, 6.0 * torch.sqrt(nu_c / eps))
        L = self.CL * torch.maximum(
            k ** 1.5 / eps, self.Ceta * (nu_c ** 3 / eps) ** 0.25)
        return T, L

    def correct_rho(self, mesh, tstate, U, phi_mass, rho, dt,
                    rho0=None, steady=False, relax=1.0, controls=None,
                    phi_slot=None):
        k_f, eps_f = tstate["k"], tstate["epsilon"]
        v2_f, f_f = tstate["v2"], tstate["f"]
        k = torch.clamp(k_f.data, min=K_MIN)
        eps = torch.clamp(eps_f.data, min=EPS_MIN)
        v2 = torch.clamp(v2_f.data, min=K_MIN)
        mut = self.mut_of(tstate)
        rho0 = rho if rho0 is None else rho0
        rdt = 1.0 / dt
        diag = {}
        nu_c = self.mu / torch.clamp(rho, min=1e-10)
        phi_sl = _phi_slotform(mesh, phi_mass, phi_slot)
        divU = _div_u(mesh, phi_mass, _rho_slot(mesh, rho))

        nut = mut / torch.clamp(rho, min=1e-10)
        G, _ = production(mesh, nut, U)     # kinematic [m^2/s^3]
        T, L = self._scales(nu_c, k, eps)

        ceps1 = 1.4 * (1.0 + 0.05 * torch.clamp(torch.sqrt(k / v2),
                                                max=100.0))
        e_flat, e_slot = _dyn_gamma_forms(mesh, self.mu, rho,
                                          tstate["mut"], self.sigmaEps)
        ddt_e = (_rho_ddt_q(mesh, eps_f, rho, rho0, eps_f.data, rdt)
                 if not steady else _rho_ddt_steady(mesh, eps_f))
        e_eqn = (
            ddt_e
            + _rho_transport_ops(mesh, phi_mass, phi_sl, eps_f,
                                 self.div_scheme, e_flat, e_slot,
                                 self.corrected, self.corr_limit)
            + fvm.Sp(mesh, self.Ceps2 * rho / T, eps_f,
                     sp_dims=_RHO_RATE)
        )
        e_eqn = e_eqn.add_source(ceps1 * rho * G / T, mesh)
        if steady and relax < 1.0:
            e_eqn = e_eqn.relax(mesh, relax, eps_f.data)
        eps_new, perf_e = _solve_transport(mesh, eps_f, e_eqn, controls)
        eps_new = bound_below(eps_new, EPS_MIN)
        diag["epsilon"] = perf_e

        k_flat, k_slot = _dyn_gamma_forms(mesh, self.mu, rho,
                                          tstate["mut"], self.sigmaK)
        ddt_k = (_rho_ddt_q(mesh, k_f, rho, rho0, k_f.data, rdt)
                 if not steady else _rho_ddt_steady(mesh, k_f))
        k_eqn = (
            ddt_k
            + _rho_transport_ops(mesh, phi_mass, phi_sl, k_f,
                                 self.div_scheme, k_flat, k_slot,
                                 self.corrected, self.corr_limit)
            + fvm.SuSp(mesh, (2.0 / 3.0) * rho * divU, k_f,
                       susp_dims=_RHO_RATE)
            + fvm.Sp(mesh, rho * eps_new / k, k_f, sp_dims=_RHO_RATE)
        )
        k_eqn = k_eqn.add_source(rho * G, mesh)
        if steady and relax < 1.0:
            k_eqn = k_eqn.relax(mesh, relax, k)
        k_new, perf_k = _solve_transport(mesh, k_f, k_eqn, controls)
        k_new = bound_below(k_new, K_MIN)
        diag["k"] = perf_k

        # the elliptic relaxation, kinematic
        L2_flat, L2_slot = _cell_gamma_forms(mesh, L * L)
        f_eqn = (
            -fvm.laplacian(mesh, L2_flat, f_f, corrected=self.corrected,
                           gamma_dims=dimViscosity,
                           limit=self.corr_limit, gamma_slot=L2_slot)
            + fvm.Sp(mesh, torch.ones_like(k), f_f)
        )
        rhs_f = (self.C2 * G / k_new
                 - ((self.C1 - self.N) * v2 / k_new
                    - (2.0 / 3.0) * (self.C1 - 1.0)) / T)
        f_eqn = f_eqn.add_source(rhs_f, mesh)
        f_new, perf_f = _solve_transport(mesh, f_f, f_eqn, controls)
        f_new = torch.clamp(f_new, min=0.0)
        diag["f"] = perf_f

        v_flat, v_slot = _dyn_gamma_forms(mesh, self.mu, rho,
                                          tstate["mut"], self.sigmaK)
        ddt_v = (_rho_ddt_q(mesh, v2_f, rho, rho0, v2_f.data, rdt)
                 if not steady else _rho_ddt_steady(mesh, v2_f))
        v_eqn = (
            ddt_v
            + _rho_transport_ops(mesh, phi_mass, phi_sl, v2_f,
                                 self.div_scheme, v_flat, v_slot,
                                 self.corrected, self.corr_limit)
            + fvm.Sp(mesh, self.N * rho * eps_new / k_new, v2_f,
                     sp_dims=_RHO_RATE)
        )
        v_eqn = v_eqn.add_source(rho * k_new * f_new, mesh)
        if steady and relax < 1.0:
            v_eqn = v_eqn.relax(mesh, relax, v2)
        v2_new, perf_v = _solve_transport(mesh, v2_f, v_eqn, controls)
        v2_new = torch.minimum(torch.clamp(v2_new, min=K_MIN),
                               (2.0 / 3.0) * k_new * 1.5)
        diag["v2"] = perf_v

        T_new, _ = self._scales(nu_c, k_new, eps_new)
        mut_new = rho * torch.minimum(self.Cmu * v2_new * T_new,
                                      self.CmuKEps * k_new * k_new / eps_new)
        new = dict(tstate)
        new.update(k=k_f.with_data(k_new), epsilon=eps_f.with_data(eps_new),
                   v2=v2_f.with_data(v2_new), f=f_f.with_data(f_new))
        new.update(self._update_mut_alphat(mesh, tstate, mut_new, rho,
                                           k_new, U))
        return new, diag


class CompressibleDynOneEqEddy(CompressibleOneEqEddy):
    """compressible::dynOneEqEddy (compressible/LES/dynOneEqEddy/): the
    rho-weighted k-equation SGS model with Ck from the Germano identity,
    volume-averaged as the incompressible twin's."""

    name = "compressible::dynOneEqEddy"

    def correct_rho(self, mesh, tstate, U, phi_mass, rho, dt,
                    rho0=None, steady=False, relax=1.0, controls=None,
                    phi_slot=None):
        k = torch.clamp(tstate["k"].data, min=K_MIN)
        delta = cube_root_vol(mesh, self._delta_cache)
        S = _sym_grad(mesh, U)
        Uf = simple_filter(mesh, U.data)
        UU = torch.einsum("ci,cj->cij", U.data, U.data)
        Lt = _dev(_filter_tensor(mesh, UU)
                  - torch.einsum("ci,cj->cij", Uf, Uf))
        KK = torch.clamp(
            0.5 * (simple_filter(mesh, torch.sum(U.data ** 2, dim=1))
                   - torch.sum(Uf ** 2, dim=1)), min=0.0)
        kf = torch.clamp(simple_filter(mesh, k), min=K_MIN)
        Sf = _filter_tensor(mesh, S)
        M = delta[:, None, None] * (
            _filter_tensor(mesh, torch.sqrt(k)[:, None, None] * S)
            - 2.0 * torch.sqrt(kf + KK)[:, None, None] * Sf)
        ck = -_vavg(mesh, torch.sum(Lt * M, dim=(1, 2))) / torch.clamp(
            2.0 * _vavg(mesh, torch.sum(M * M, dim=(1, 2))), min=1e-30)
        ck = torch.clamp(ck, 0.02, 0.3)
        new, diag = super().correct_rho(
            mesh, tstate, U, phi_mass, rho, dt, rho0=rho0, steady=steady,
            relax=relax, controls=controls, phi_slot=phi_slot)
        k_new = torch.clamp(new["k"].data, min=K_MIN)
        mut_new = ck * rho * delta * torch.sqrt(k_new)
        new.update(self._update_mut_alphat(mesh, tstate, mut_new, rho,
                                           k_new, U))
        return new, diag


class CompressibleLowReOneEqEddy(CompressibleOneEqEddy):
    """compressible::lowReOneEqEddy (compressible/LES/lowReOneEqEddy/, a
    model of the compressible LES tree only): the one-equation SGS model
    less the molecular contribution,

        muSgs = ck rho sqrt(k) delta
                - (mu/beta) (1 - exp(-beta delta sqrt(k) rho / mu))."""

    name = "compressible::lowReOneEqEddy"
    beta = 0.01

    def __init__(self, mu, coeffs=None):
        super().__init__(mu, coeffs)
        c = self.coeffs or {}
        self.beta = float(c.get("beta", self.beta))

    def correct_rho(self, mesh, tstate, U, phi_mass, rho, dt,
                    rho0=None, steady=False, relax=1.0, controls=None,
                    phi_slot=None):
        new, diag = super().correct_rho(
            mesh, tstate, U, phi_mass, rho, dt, rho0=rho0, steady=steady,
            relax=relax, controls=controls, phi_slot=phi_slot)
        k_new = torch.clamp(new["k"].data, min=K_MIN)
        delta = cube_root_vol(mesh, self._delta_cache)
        mut_hi = self.ck * rho * torch.sqrt(k_new) * delta
        mut_new = torch.clamp(
            mut_hi - (self.mu / self.beta)
            * (1.0 - torch.exp(-self.beta * delta * torch.sqrt(k_new) * rho
                               / self.mu)), min=0.0)
        new.update(self._update_mut_alphat(mesh, tstate, mut_new, rho,
                                           k_new, U))
        return new, diag


class CompressibleDeardorffDiffStress(CompressibleRASBase,
                                      TurbulenceModel):
    """compressible::DeardorffDiffStress
    (compressible/LES/DeardorffDiffStress/): rho-weighted SGS stress
    transport,

        BEqn: ddt(rho,B)+div(phi,B)-lap(DBEff,B)
              + Sp(Cm rho sqrt(k)/delta)
              == rho [P + (2/3)(Cm sqrt(k)/delta) k I - (2/3) eps I]
        DBEff = mu + Cs rho k^2/eps;  muSgs = Ck rho delta sqrt(k)."""

    name = "compressible::DeardorffDiffStress"
    field_names = ("B", "k", "mut")

    Ck = 0.094
    Cm = 4.13
    Ce = 1.048
    Cs = 0.25

    def __init__(self, mu, coeffs=None):
        super().__init__(mu, coeffs)
        self.mu = mu
        c = self.coeffs or {}
        for key in ("Ck", "Cm", "Ce", "Cs"):
            setattr(self, key, float(c.get(
                key, c.get(key.lower(), getattr(self, key)))))
        self.Prt = float(c.get("Prt", self.Prt))
        self._delta_cache = {}

    def correct_rho(self, mesh, tstate, U, phi_mass, rho, dt,
                    rho0=None, steady=False, relax=1.0, controls=None,
                    phi_slot=None):
        B_f: VolField = tstate["B"]
        k_fld: VolField = tstate["k"]
        B6 = B_f.data
        rho0 = rho if rho0 is None else rho0
        delta = cube_root_vol(mesh, self._delta_cache)
        rdt = 1.0 / dt
        phi_sl = _phi_slotform(mesh, phi_mass, phi_slot)

        k = half_trace(B6)
        sqrtk = torch.sqrt(k)
        eps = self.Ce * sqrtk ** 3 / delta
        P6 = stress_production(B6, fvc.grad(mesh, U))

        dB_flat, dB_slot = _cell_gamma_forms(
            mesh, self.mu + self.Cs * rho * k * k / torch.clamp(eps,
                                                                min=1e-20))
        rotta = self.Cm * sqrtk / delta
        ddt_B = (_rho_ddt_q(mesh, B_f, rho, rho0, B6, rdt)
                 if not steady else _rho_ddt_steady(mesh, B_f))
        B_eqn = (
            ddt_B
            + _rho_transport_ops(mesh, phi_mass, phi_sl, B_f,
                                 self.div_scheme, dB_flat, dB_slot,
                                 self.corrected, self.corr_limit)
            + fvm.Sp(mesh, rho * rotta, B_f, sp_dims=_RHO_RATE)
        )
        I6 = eye6(B6)
        srcB = rho[:, None] * (P6
                               + ((2.0 / 3.0) * rotta * k)[:, None] * I6
                               - ((2.0 / 3.0) * eps)[:, None] * I6)
        B_eqn = B_eqn.add_source(srcB, mesh)
        B_new, perf = _solve_transport(mesh, B_f, B_eqn, controls)
        B_new = floor_normals(B_new)
        k_new = half_trace(B_new)
        mut_new = self.Ck * rho * delta * torch.sqrt(k_new)
        new = dict(tstate)
        new.update(B=B_f.with_data(B_new), k=k_fld.with_data(k_new))
        new.update(self._update_mut_alphat(mesh, tstate, mut_new, rho,
                                           k_new, U))
        return new, {"B": perf}

    def div_dev_reff(self, mesh, tstate, U: VolField):
        """fvc::div(dev(B)) explicit, as the incompressible Deardorff's
        divDevBeff (the solver brings the rho factor)."""
        nu_slot = self.nu_eff_slot(mesh, tstate)
        mat = -fvm.laplacian(mesh, slot_mod.to_flat(mesh, nu_slot), U,
                             corrected=self.corrected,
                             gamma_dims=dimViscosity,
                             limit=self.corr_limit, gamma_slot=nu_slot)
        div_B = _div_symm_tensor(mesh, dev6(tstate["B"].data))
        nut_face = self.nu_eff_face(mesh, tstate) - self.nu
        lap_U = fvc.laplacian(mesh, nut_face, U, corrected=False)
        return mat, div_B + lap_U


register("compressible::RNGkEpsilon", CompressibleRNGKEpsilon)
register("compressible::realizableKE", CompressibleRealizableKE)
register("compressible::SpalartAllmaras", CompressibleSpalartAllmaras)
register("compressible::LRR", CompressibleLRR)
register("compressible::LaunderGibsonRSTM", CompressibleLaunderGibsonRSTM)
register("compressible::v2f", CompressibleV2F)
register("compressible::dynOneEqEddy", CompressibleDynOneEqEddy)
register("compressible::lowReOneEqEddy", CompressibleLowReOneEqEddy)
register("compressible::DeardorffDiffStress", CompressibleDeardorffDiffStress)
