"""More RAS closures (port of openfoam-2.2.x_tpu/models/turbulence/ras2.py:
the symmetric-tensor helpers `symm_to_full`, `full_to_symm` and
`_div_symm_tensor`, and the models LamBremhorstKE, qZeta, v2f, LRR,
LaunderGibsonRSTM and kOmegaSSTSAS).

The Reynolds-stress models transport R as one [nC, 6] field (xx, xy, xz,
yy, yz, zz): its six components solve against one matrix, so the SpMV
sees an [n, 6] operand. The low-Re models and the wall reflection read
the wall distance from the host mesh (mesh/walldist.py) through
`init_wall_distance`, as KOmegaSST does; kOmegaSSTSAS takes its filter
width from les.cube_root_vol. The closures are the published ones (Lam &
Bremhorst 1981; Gibson & Dafa'Alla 1995; Lien & Kalitzin 2001; Launder,
Reece & Rodi 1975; Gibson & Launder 1978; Menter & Egorov 2010).
"""

from __future__ import annotations

from typing import Any

import torch

from ...core.dimensions import dimViscosity
from ...core.fields import VolField
from ...core.precision import DEFAULT_DEVICE
from ...ops import fvc, fvm
from ...ops import slot as slot_mod
from ...ops import surface
from .base import TurbulenceModel, bound_below, production, register
from .les import cube_root_vol
from .ras import (_CMU, _KAPPA, EPS_MIN, K_MIN, OMEGA_MIN, KEpsilon,
                  KOmegaSST, _gamma_forms, _has_wall_fn, _phi_slotform,
                  _solve_transport, _transport_ops, _wall_data,
                  _wall_distance_on, _wall_face_nut)

# the identity in the symmetric-tensor component order
_I6 = (1.0, 0.0, 0.0, 1.0, 0.0, 1.0)


def symm_to_full(R6: Any) -> Any:
    """[nC,6] (xx,xy,xz,yy,yz,zz) -> [nC,3,3]."""
    xx, xy, xz, yy, yz, zz = (R6[:, i] for i in range(6))
    row0 = torch.stack([xx, xy, xz], dim=1)
    row1 = torch.stack([xy, yy, yz], dim=1)
    row2 = torch.stack([xz, yz, zz], dim=1)
    return torch.stack([row0, row1, row2], dim=1)


def full_to_symm(T: Any) -> Any:
    """[nC,3,3] (taken as symmetric) -> [nC,6]."""
    return torch.stack([T[:, 0, 0], T[:, 0, 1], T[:, 0, 2],
                        T[:, 1, 1], T[:, 1, 2], T[:, 2, 2]], dim=1)


def _div_symm_tensor(mesh, R6: Any) -> Any:
    """(1/V) sum_f Sf . R_f for a cell symmTensor field -> [nC,3]
    (zero-gradient extrapolation on boundaries, as fvc::div(R) with the
    calculated patch evaluation), assembled in slot form."""
    T = symm_to_full(R6)                             # [nC,3,3]
    tf = slot_mod.interpolate(mesh, T.reshape(-1, 9))
    sv = tf.sv.reshape(tf.sv.shape[:2] + (3, 3))
    flux_sv = torch.einsum("cmi,cmij->cmj", mesh.st_sf, sv)
    div_t = torch.sum(flux_sv * mesh.st_valid[:, :, None], dim=1)
    if mesh.fb_cells.shape[0]:
        fbt = tf.fb.reshape(-1, 3, 3)
        flux_fb = torch.einsum("fi,fij->fj", mesh.fb_sf, fbt)
        div_t = div_t.index_add(0, mesh.fb_cells, flux_fb)
    flux_b = torch.einsum("fi,fij->fj", mesh.ab_sf, T[mesh.ab_owner])
    div_t = div_t.index_add(0, mesh.ab_owner, flux_b)
    return div_t / mesh.v[:, None]


def eye6(like: Any) -> Any:
    """The identity as a [1, 6] row of `like`'s dtype and device."""
    return torch.tensor(_I6, dtype=like.dtype, device=like.device)[None, :]


def dev6(T6: Any) -> Any:
    """dev of a [nC, 6] symmetric tensor."""
    tr = T6[:, 0] + T6[:, 3] + T6[:, 5]
    return T6 - (tr / 3.0)[:, None] * eye6(T6)


def floor_normals(R6: Any) -> Any:
    """The normal components (xx, yy, zz) floored at K_MIN, the shear
    components as they are."""
    lo = torch.tensor([K_MIN, -float("inf"), -float("inf"), K_MIN,
                       -float("inf"), K_MIN], dtype=R6.dtype,
                      device=R6.device)
    return torch.maximum(R6, lo)


def half_trace(R6: Any) -> Any:
    """k = tr(R)/2, floored at K_MIN."""
    return torch.clamp(0.5 * (R6[:, 0] + R6[:, 3] + R6[:, 5]), min=K_MIN)


def stress_production(R6: Any, g: Any) -> Any:
    """P = -twoSymm(R & grad U) as [nC, 6] ((R & gradU)_ij = R_ik d_k U_j)."""
    RgU = torch.einsum("cik,ckj->cij", symm_to_full(R6), g)
    return full_to_symm(-(RgU + torch.transpose(RgU, 1, 2)))


def _cell_gamma(mesh, gamma):
    """A per-cell diffusivity with owner-extrapolated boundary values as
    (flat, SlotFace)."""
    sl = slot_mod.interpolate(mesh, gamma, bv=surface.owner_to_b(mesh, gamma))
    return slot_mod.to_flat(mesh, sl), sl


class _WallDistance:
    """init_wall_distance of the models that read y but have no other
    use of KOmegaSST's: the host mesh's wall distance on the mesh's
    device."""

    y_wall = None

    def init_wall_distance(self, poly_mesh, dtype, device=DEFAULT_DEVICE):
        self.y_wall = _wall_distance_on(poly_mesh, dtype, device)


class LamBremhorstKE(_WallDistance, KEpsilon):
    """Lam-Bremhorst low-Re k-epsilon (RAS/LamBremhorstKE/): damping
    functions fMu (on nut), f1 (on C1), f2 (on C2) of Rt = k^2/(nu eps)
    and Ry = sqrt(k) y / nu. It integrates to the wall: no wall
    functions."""

    name = "LamBremhorstKE"

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, phi_slot=None, **kw):
        k = tstate["k"].data
        eps = tstate["epsilon"].data
        Rt = k * k / (self.nu * torch.clamp(eps, min=EPS_MIN))
        Ry = torch.sqrt(torch.clamp(k, min=K_MIN)) * self.y_wall / self.nu
        fmu = (1.0 - torch.exp(-0.0165 * Ry)) ** 2 \
            * (1.0 + 20.5 / torch.clamp(Rt, min=1e-3))
        fmu = torch.clamp(fmu, 1e-4, 1.0)
        f1 = 1.0 + (0.05 / fmu) ** 3
        f2 = 1.0 - torch.exp(-Rt * Rt)
        return super().correct(
            mesh, tstate, U, phi, dt, steady, relax, controls,
            c1_field=self.C1 * f1, phi_slot=phi_slot,
            c2_field=self.C2 * f2, fmu_field=fmu)


class QZeta(TurbulenceModel):
    """q-zeta low-Re k-epsilon (RAS/qZeta/): q = sqrt(k) and
    zeta = eps/(2q) transported, with fMu = exp(-6/(1+Rt/50)^2) and
    f2 = 1 - 0.3 exp(-Rt^2). The state stays (k, epsilon)."""

    name = "qZeta"
    field_names = ("k", "epsilon", "nut")

    Cmu = _CMU
    C1 = 1.44
    C2 = 1.92
    sigmaZeta = 1.3

    def __init__(self, nu, coeffs=None):
        super().__init__(nu, coeffs)
        c = self.coeffs or {}
        self.C1 = float(c.get("C1", self.C1))
        self.C2 = float(c.get("C2", self.C2))
        self.sigmaZeta = float(c.get("sigmaZeta", self.sigmaZeta))

    def nut(self, mesh, tstate):
        return tstate["nut"].data

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, phi_slot=None):
        k_f, eps_f, nut_f = tstate["k"], tstate["epsilon"], tstate["nut"]
        k = torch.clamp(k_f.data, min=K_MIN)
        eps = torch.clamp(eps_f.data, min=EPS_MIN)
        nut = nut_f.data
        rdt = 1.0 / dt
        diag = {}
        phi_sl = _phi_slotform(mesh, phi, phi_slot)

        q = torch.sqrt(k)
        zeta = eps / (2.0 * q)
        q_f = k_f.with_data(q)          # k's BCs
        zeta_f = eps_f.with_data(zeta)

        Rt = k * k / (self.nu * eps)
        f2 = 1.0 - 0.3 * torch.exp(-(Rt ** 2))
        G, _ = production(mesh, nut, U)

        # zeta: (2C1-1) G zeta/(2k) explicit, Sp((2 C2 f2 - 1) zeta/q)
        z_flat, z_slot = _gamma_forms(mesh, self.nu, nut_f, self.sigmaZeta)
        ddt_z = (fvm.ddt(mesh, zeta_f, zeta, rdt) if not steady
                 else fvm.ddt_steady(mesh, zeta_f))
        z_eqn = (
            ddt_z
            + _transport_ops(mesh, phi, phi_sl, zeta_f, self.div_scheme,
                             z_flat, z_slot, self.corrected, self.corr_limit)
            + fvm.Sp(mesh, (2.0 * self.C2 * f2 - 1.0) * zeta / q, zeta_f)
        )
        z_eqn = z_eqn.add_source((2.0 * self.C1 - 1.0) * G * zeta
                                 / (2.0 * k), mesh)
        if steady and relax < 1.0:
            z_eqn = z_eqn.relax(mesh, relax, zeta)
        zeta_new, perf_z = _solve_transport(mesh, zeta_f, z_eqn, controls)
        zeta_new = bound_below(zeta_new, EPS_MIN)
        diag["zeta"] = perf_z

        # q: G/(2q) explicit, Sp(zeta/q)
        q_flat, q_slot = _gamma_forms(mesh, self.nu, nut_f, 1.0)
        ddt_q = (fvm.ddt(mesh, q_f, q, rdt) if not steady
                 else fvm.ddt_steady(mesh, q_f))
        q_eqn = (
            ddt_q
            + _transport_ops(mesh, phi, phi_sl, q_f, self.div_scheme,
                             q_flat, q_slot, self.corrected, self.corr_limit)
            + fvm.Sp(mesh, zeta_new / q, q_f)
        )
        q_eqn = q_eqn.add_source(G / (2.0 * q), mesh)
        if steady and relax < 1.0:
            q_eqn = q_eqn.relax(mesh, relax, q)
        q_new, perf_q = _solve_transport(mesh, q_f, q_eqn, controls)
        q_new = bound_below(q_new, 1e-5)
        diag["q"] = perf_q

        k_new = q_new * q_new
        eps_new = 2.0 * q_new * zeta_new
        Rt_new = k_new * k_new / (self.nu * torch.clamp(eps_new,
                                                        min=EPS_MIN))
        fmu_new = torch.exp(-6.0 / (1.0 + Rt_new / 50.0) ** 2)
        nut_new = self.Cmu * fmu_new * k_new * k_new \
            / torch.clamp(eps_new, min=EPS_MIN)
        new_nut = nut_f.with_data(nut_new).correct_boundary_conditions(
            mesh, k=k_new, nu=self.nu, U=U.data)
        new = dict(tstate)
        new.update(k=k_f.with_data(k_new), epsilon=eps_f.with_data(eps_new),
                   nut=new_nut)
        return new, diag


class V2F(TurbulenceModel):
    """v2-f, the Lien-Kalitzin (2001) N = 6 form (RAS/v2f/):
        nut  = min(Cmu v2 T, CmuKEps k^2/eps)
        T    = max(k/eps, 6 sqrt(nu/eps))
        L    = CL max(k^1.5/eps, Ceta (nu^3/eps)^0.25)
        f    from the elliptic relaxation L^2 lap(f) - f = rhs
    It integrates to the wall; the case carries 0/v2 and 0/f."""

    name = "v2f"
    field_names = ("k", "epsilon", "v2", "f", "nut")

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

    def __init__(self, nu, coeffs=None):
        super().__init__(nu, coeffs)
        c = self.coeffs or {}
        for key in ("Cmu", "CmuKEps", "C1", "C2", "CL", "Ceta", "Ceps2",
                    "sigmaK", "sigmaEps"):
            setattr(self, key, float(c.get(key, getattr(self, key))))

    def nut(self, mesh, tstate):
        return tstate["nut"].data

    def _scales(self, k, eps):
        T = torch.maximum(k / eps, 6.0 * torch.sqrt(self.nu / eps))
        L = self.CL * torch.maximum(
            k ** 1.5 / eps, self.Ceta * (self.nu ** 3 / eps) ** 0.25)
        return T, L

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, phi_slot=None):
        k_f, eps_f = tstate["k"], tstate["epsilon"]
        v2_f, f_f, nut_f = tstate["v2"], tstate["f"], tstate["nut"]
        k = torch.clamp(k_f.data, min=K_MIN)
        eps = torch.clamp(eps_f.data, min=EPS_MIN)
        v2 = torch.clamp(v2_f.data, min=K_MIN)
        nut = nut_f.data
        rdt = 1.0 / dt
        diag = {}
        phi_sl = _phi_slotform(mesh, phi, phi_slot)

        G, _ = production(mesh, nut, U)
        T, L = self._scales(k, eps)

        # epsilon (Ceps1 grows near the wall through sqrt(k/v2))
        ceps1 = 1.4 * (1.0 + 0.05 * torch.clamp(torch.sqrt(k / v2),
                                                max=100.0))
        e_flat, e_slot = _gamma_forms(mesh, self.nu, nut_f, self.sigmaEps)
        ddt_e = (fvm.ddt(mesh, eps_f, eps, rdt) if not steady
                 else fvm.ddt_steady(mesh, eps_f))
        e_eqn = (
            ddt_e
            + _transport_ops(mesh, phi, phi_sl, eps_f, self.div_scheme,
                             e_flat, e_slot, self.corrected, self.corr_limit)
            + fvm.Sp(mesh, self.Ceps2 / T, eps_f)
        )
        e_eqn = e_eqn.add_source(ceps1 * G / T, mesh)
        if steady and relax < 1.0:
            e_eqn = e_eqn.relax(mesh, relax, eps)
        eps_new, perf_e = _solve_transport(mesh, eps_f, e_eqn, controls)
        eps_new = bound_below(eps_new, EPS_MIN)
        diag["epsilon"] = perf_e

        # k
        k_flat, k_slot = _gamma_forms(mesh, self.nu, nut_f, self.sigmaK)
        ddt_k = (fvm.ddt(mesh, k_f, k, rdt) if not steady
                 else fvm.ddt_steady(mesh, k_f))
        k_eqn = (
            ddt_k
            + _transport_ops(mesh, phi, phi_sl, k_f, self.div_scheme,
                             k_flat, k_slot, self.corrected, self.corr_limit)
            + fvm.Sp(mesh, eps_new / k, k_f)
        )
        k_eqn = k_eqn.add_source(G, mesh)
        if steady and relax < 1.0:
            k_eqn = k_eqn.relax(mesh, relax, k)
        k_new, perf_k = _solve_transport(mesh, k_f, k_eqn, controls)
        k_new = bound_below(k_new, K_MIN)
        diag["k"] = perf_k

        # elliptic relaxation: -lap(L^2, f) + f = C2 G/k
        #   - (1/T) [(C1 - N) v2/k - (2/3)(C1 - 1)]
        L2_flat, L2_slot = _cell_gamma(mesh, L * L)
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

        # v2: k f source, N eps/k destruction
        v_flat, v_slot = _gamma_forms(mesh, self.nu, nut_f, self.sigmaK)
        ddt_v = (fvm.ddt(mesh, v2_f, v2, rdt) if not steady
                 else fvm.ddt_steady(mesh, v2_f))
        v_eqn = (
            ddt_v
            + _transport_ops(mesh, phi, phi_sl, v2_f, self.div_scheme,
                             v_flat, v_slot, self.corrected, self.corr_limit)
            + fvm.Sp(mesh, self.N * eps_new / k_new, v2_f)
        )
        v_eqn = v_eqn.add_source(k_new * f_new, mesh)
        if steady and relax < 1.0:
            v_eqn = v_eqn.relax(mesh, relax, v2)
        v2_new, perf_v = _solve_transport(mesh, v2_f, v_eqn, controls)
        v2_new = torch.minimum(torch.clamp(v2_new, min=K_MIN),
                               (2.0 / 3.0) * k_new * 1.5)
        diag["v2"] = perf_v

        T_new, _ = self._scales(k_new, eps_new)
        nut_new = torch.minimum(self.Cmu * v2_new * T_new,
                                self.CmuKEps * k_new * k_new / eps_new)
        new_nut = nut_f.with_data(nut_new).correct_boundary_conditions(
            mesh, k=k_new, nu=self.nu, U=U.data)
        new = dict(tstate)
        new.update(k=k_f.with_data(k_new), epsilon=eps_f.with_data(eps_new),
                   v2=v2_f.with_data(v2_new), f=f_f.with_data(f_new),
                   nut=new_nut)
        return new, diag


class LRR(TurbulenceModel):
    """Launder-Reece-Rodi Reynolds-stress transport (RAS/LRR/): R [nC,6]
    with one matrix and six right-hand sides, and the epsilon equation:

        P_ij = -(R_ik dU_j/dx_k + R_jk dU_i/dx_k)
        REqn: ddt(R) + div(phi,R) - lap(DREff) + Sp(Clrr1 eps/k)
              == P + (2/3)(Clrr1 - 1) eps I - Clrr2 dev(P)
        DREff = nu + Cs k^2/eps;  DepsEff = nu + Ceps k^2/eps
        k = tr(R)/2;  nut = Cmu k^2/eps

    divDevReff(U) = fvc::div(R) + fvc::laplacian(nut, U)
                  - fvm::laplacian(nuEff, U)."""

    name = "LRR"
    field_names = ("R", "epsilon", "k", "nut")

    Cmu = _CMU
    Clrr1 = 1.8
    Clrr2 = 0.6
    C1 = 1.44
    C2 = 1.92
    Cs = 0.25
    Ceps = 0.15

    def __init__(self, nu, coeffs=None):
        super().__init__(nu, coeffs)
        c = self.coeffs or {}
        for key in ("Cmu", "Clrr1", "Clrr2", "C1", "C2", "Cs", "Ceps"):
            setattr(self, key, float(c.get(key, getattr(self, key))))

    def nut(self, mesh, tstate):
        return tstate["nut"].data

    def _pressure_strain_extra(self, mesh, tstate, U, R6, P6, k, eps):
        """LaunderGibsonRSTM's wall-reflection terms; none here."""
        return None

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, phi_slot=None):
        R_f, eps_f = tstate["R"], tstate["epsilon"]
        k_f, nut_f = tstate["k"], tstate["nut"]
        R6 = R_f.data                                 # [nC,6]
        eps = torch.clamp(eps_f.data, min=EPS_MIN)
        rdt = 1.0 / dt
        diag = {}
        phi_sl = _phi_slotform(mesh, phi, phi_slot)

        k = half_trace(R6)
        g = fvc.grad(mesh, U)                         # g[c,i,j] = d_i u_j
        P6 = stress_production(R6, g)
        G = torch.clamp(0.5 * (P6[:, 0] + P6[:, 3] + P6[:, 5]), min=0.0)

        # the kEpsilon wall overrides where epsilon has its wall function
        wall_fn = _has_wall_fn(eps_f, ("epsilonWallFunction",))
        if wall_fn:
            mask, y1 = _wall_data(mesh)
            sqrtk = torch.sqrt(k)
            eps_wall = (self.Cmu ** 0.75) * sqrtk ** 3 / (_KAPPA * y1)
            nutw = _wall_face_nut(mesh, nut_f)
            magUp = torch.linalg.norm(U.data, dim=1) / y1
            G_wall = ((nutw + self.nu) * magUp
                      * (self.Cmu ** 0.25) * sqrtk / (_KAPPA * y1))
            G = torch.where(mask > 0, G_wall, G)

        # epsilon
        deps_flat, deps_slot = _cell_gamma(mesh,
                                           self.nu + self.Ceps * k * k / eps)
        ddt_e = (fvm.ddt(mesh, eps_f, eps, rdt) if not steady
                 else fvm.ddt_steady(mesh, eps_f))
        e_eqn = (
            ddt_e
            + _transport_ops(mesh, phi, phi_sl, eps_f, self.div_scheme,
                             deps_flat, deps_slot, self.corrected,
                             self.corr_limit)
            + fvm.Sp(mesh, self.C2 * eps / k, eps_f)
        )
        e_eqn = e_eqn.add_source(self.C1 * G * eps / k, mesh)
        if steady and relax < 1.0:
            e_eqn = e_eqn.relax(mesh, relax, eps)
        if wall_fn:
            e_eqn = e_eqn.set_values(mask, eps_wall, mesh)
        eps_new, perf_e = _solve_transport(mesh, eps_f, e_eqn, controls)
        eps_new = bound_below(eps_new, EPS_MIN)
        diag["epsilon"] = perf_e

        # R (six components, one matrix)
        dR_flat, dR_slot = _cell_gamma(mesh,
                                       self.nu + self.Cs * k * k / eps_new)
        ddt_R = (fvm.ddt(mesh, R_f, R6, rdt) if not steady
                 else fvm.ddt_steady(mesh, R_f))
        R_eqn = (
            ddt_R
            + _transport_ops(mesh, phi, phi_sl, R_f, self.div_scheme,
                             dR_flat, dR_slot, self.corrected,
                             self.corr_limit)
            + fvm.Sp(mesh, self.Clrr1 * eps_new / k, R_f)
        )
        iso = ((2.0 / 3.0) * (self.Clrr1 - 1.0) * eps_new)[:, None] \
            * eye6(R6)
        srcR = P6 + iso - self.Clrr2 * dev6(P6)
        extra = self._pressure_strain_extra(mesh, tstate, U, R6, P6,
                                            k, eps_new)
        if extra is not None:
            srcR = srcR + extra
        R_eqn = R_eqn.add_source(srcR, mesh)
        if steady and relax < 1.0:
            R_eqn = R_eqn.relax(mesh, relax, R6)
        R_new, perf_R = _solve_transport(mesh, R_f, R_eqn, controls)
        diag["R"] = perf_R

        # realizability: positive normal stresses
        R_new = floor_normals(R_new)
        k_new = half_trace(R_new)
        nut_new = self.Cmu * k_new * k_new / eps_new
        new_nut = nut_f.with_data(nut_new).correct_boundary_conditions(
            mesh, k=k_new, nu=self.nu, U=U.data)
        new = dict(tstate)
        new.update(R=R_f.with_data(R_new), epsilon=eps_f.with_data(eps_new),
                   k=k_f.with_data(k_new), nut=new_nut)
        return new, diag

    def div_dev_reff(self, mesh, tstate, U: VolField):
        """fvc::div(R) + fvc::laplacian(nut, U) - fvm::laplacian(nuEff, U)
        (LRR::divDevReff)."""
        nu_slot = self.nu_eff_slot(mesh, tstate)
        mat = -fvm.laplacian(mesh, slot_mod.to_flat(mesh, nu_slot), U,
                             corrected=self.corrected,
                             gamma_dims=dimViscosity,
                             limit=self.corr_limit, gamma_slot=nu_slot)
        div_R = _div_symm_tensor(mesh, tstate["R"].data)
        nut_face = self.nu_eff_face(mesh, tstate) - self.nu
        lap_U = fvc.laplacian(mesh, nut_face, U, corrected=False)
        return mat, div_R + lap_U


def wall_reflection(model, mesh, R6, P6, k, eps):
    """The Gibson-Launder (1978) wall terms of LaunderGibsonRSTM, with the
    wall normal n = grad(y)/|grad(y)| (pointing away from the wall):

        f_w = Cmu^0.75 k^1.5 / (eps kappa y)       (at most 100)
        phi_w1 = C1Ref (eps/k) [(R:nn) I - 3/2 (R.nn + nn.R)] f_w
        phi_w2 = C2Ref [(phi2:nn) I - 3/2 (phi2.nn + nn.phi2)] f_w
        phi2   = -Clrr2 dev(P)."""
    y = model.y_wall
    gy = fvc.grad_component(mesh, y, y[mesh.ab_owner])
    n = gy / torch.clamp(torch.linalg.norm(gy, dim=1, keepdim=True),
                         min=1e-12)
    fw = (model.Cmu ** 0.75) * k ** 1.5 \
        / (torch.clamp(eps, min=EPS_MIN) * _KAPPA * y)
    fw = torch.clamp(fw, max=100.0)
    eye = torch.eye(3, dtype=R6.dtype, device=R6.device)[None, :, :]

    def reflect(S6, coef):
        S = symm_to_full(S6)
        Snn = torch.einsum("ci,cij,cj->c", n, S, n)    # S : nn
        Sn = torch.einsum("cij,cj->ci", S, n)          # S . n
        term = (Snn[:, None, None] * eye
                - 1.5 * (torch.einsum("ci,cj->cij", Sn, n)
                         + torch.einsum("ci,cj->cij", n, Sn)))
        return coef * full_to_symm(term) * fw[:, None]

    phi1 = reflect(R6, model.C1Ref) * (eps / k)[:, None]
    phi2 = reflect(-model.Clrr2 * dev6(P6), model.C2Ref)
    return phi1 + phi2


class LaunderGibsonRSTM(_WallDistance, LRR):
    """Launder-Gibson RSTM (RAS/LaunderGibsonRSTM/): LRR with the
    Gibson-Launder wall reflection (`wall_reflection`)."""

    name = "LaunderGibsonRSTM"
    C1Ref = 0.5
    C2Ref = 0.3

    def __init__(self, nu, coeffs=None):
        super().__init__(nu, coeffs)
        c = self.coeffs or {}
        self.C1Ref = float(c.get("C1Ref", self.C1Ref))
        self.C2Ref = float(c.get("C2Ref", self.C2Ref))

    def _pressure_strain_extra(self, mesh, tstate, U, R6, P6, k, eps):
        return wall_reflection(self, mesh, R6, P6, k, eps)


class KOmegaSSTSAS(KOmegaSST):
    """Scale-adaptive SST (RAS/kOmegaSSTSAS/, Menter-Egorov): the QSAS
    source in the omega equation,

        L    = sqrt(k) / (Cmu^0.25 omega)
        LvK  = max(kappa |S| / |lap U|, Cs sqrt(kappa zeta2 /
                   (beta/Cmu - gamma)) * delta)
        QSAS = max(zeta2 kappa S2 (L/LvK)^2
                   - C 2k/sigmaPhi max(|grad w|^2/w^2, |grad k|^2/k^2), 0)

    with delta = cbrt(V) (les.cube_root_vol)."""

    name = "kOmegaSSTSAS"
    zetaTilde2 = 3.51
    sigmaPhi = 2.0 / 3.0
    Csas = 0.262
    C_ = 2.0

    def __init__(self, nu, coeffs=None, y_wall=None):
        super().__init__(nu, coeffs, y_wall)
        self._delta_cache = {}

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, phi_slot=None):
        k_f, w_f = tstate["k"], tstate["omega"]
        k = torch.clamp(k_f.data, min=K_MIN)
        omega = torch.clamp(w_f.data, min=OMEGA_MIN)
        nut = tstate["nut"].data

        _, S2 = production(mesh, nut, U)
        S2 = torch.clamp(S2, min=1e-20)
        # |lap U| from the explicit unit-diffusivity vector laplacian
        ones_f = mesh.v.new_ones((mesh.n_faces,))
        lapU = fvc.laplacian(mesh, ones_f, U, corrected=False)
        mag_lapU = torch.clamp(torch.linalg.norm(lapU, dim=1), min=1e-20)

        L = torch.sqrt(k) / ((_CMU ** 0.25) * omega)
        delta = cube_root_vol(mesh, self._delta_cache)
        # the high-wavenumber floor of the von Karman length scale
        lvk_floor = self.Csas * (
            _KAPPA * self.zetaTilde2
            / (self.beta1 / _CMU - self.gamma1)) ** 0.5 * delta
        LvK = torch.maximum(_KAPPA * torch.sqrt(S2) / mag_lapU, lvk_floor)

        gk = fvc.grad(mesh, k_f)
        gw = fvc.grad(mesh, w_f)
        grad_term = torch.maximum(
            torch.sum(gw * gw, dim=1) / (omega * omega),
            torch.sum(gk * gk, dim=1) / (k * k))
        qsas = torch.clamp(
            self.zetaTilde2 * _KAPPA * S2 * (L / LvK) ** 2
            - self.C_ * 2.0 * k / self.sigmaPhi * grad_term, min=0.0)
        return super().correct(mesh, tstate, U, phi, dt, steady, relax,
                               controls, phi_slot=phi_slot,
                               extra_omega_src=qsas)


register("LamBremhorstKE", LamBremhorstKE)
register("qZeta", QZeta)
register("v2f", V2F)
register("LRR", LRR)
register("LaunderGibsonRSTM", LaunderGibsonRSTM)
register("kOmegaSSTSAS", KOmegaSSTSAS)
