"""solidThermo: the solid-region thermophysical property library (port of
openfoam-2.2.x_tpu/models/solidthermo.py; the reference's
src/thermophysicalModels/solidThermo/ and solidSpecie/).

Each model is a function of the cell temperature T [nC] (a torch tensor
on the mesh's device) to a property [nC], evaluated per cell:

  transport:  constIso        kappa
              constAnIso      kappa (k1 k2 k3) [+ coordinateSystem]
              exponential     kappa0 * (T/Tref)^n
              polynomial      kappaCoeffs<8> (c0 c1 ...)
  thermo:     hConst          Cp
              hPolynomial     CpCoeffs<8> (c0 c1 ...)
              hPower          C0 * (T/Tref)^n0
  EOS:        rhoConst        rho

Both the heSolidThermo dictionary layout (`thermoType { transport
constIso; thermo hConst; ... }` + `mixture { transport { kappa ...; } ...
}`) and the legacy flat `rho/Cp/kappa` layout are accepted. The
dictionary parsing (`_num`, `_axes_from_csys`, `from_dict`) is a host
copy of the reference's, unchanged in behaviour.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


def _num(x, default=None):
    if x is None:
        return default
    if isinstance(x, (list, tuple, np.ndarray)):
        return [_num(v) for v in x]
    try:
        return float(x)
    except (TypeError, ValueError):
        return default


def _poly(coeffs: Sequence[float], T):
    """c0 + c1*T + c2*T^2 + ... (reference: Polynomial<8>::value)."""
    acc = torch.zeros_like(T) + float(coeffs[-1])
    for c in reversed(list(coeffs)[:-1]):
        acc = acc * T + float(c)
    return acc


class SolidThermo(NamedTuple):
    """Solid thermo as functions of T [nC] -> [nC] (torch)."""

    transport: str          # constIso|constAnIso|exponential|polynomial
    thermo: str             # hConst|hPolynomial|hPower
    rho0: float             # rhoConst
    kappa_c: Tuple[float, ...]   # meaning depends on `transport`
    cp_c: Tuple[float, ...]      # meaning depends on `thermo`
    Tref: float = 1.0
    n_exp: float = 0.0      # exponential transport / hPower exponent
    aniso_axes: Optional[Tuple[Tuple[float, ...], ...]] = None

    # -- properties ---------------------------------------------------------
    def rho(self, T) -> Any:
        return torch.full_like(T, self.rho0)

    def cp(self, T) -> Any:
        if self.thermo == "hPolynomial":
            return _poly(self.cp_c, T)
        if self.thermo == "hPower":
            # Cp = C0 * (T/Tref)^n0 (reference: hPowerThermo::cp)
            return float(self.cp_c[0]) * (T / self.Tref) ** self.n_exp
        return torch.full_like(T, float(self.cp_c[0]))

    def kappa(self, T) -> Any:
        """Isotropic (effective) conductivity per cell [nC]."""
        if self.transport == "polynomial":
            return _poly(self.kappa_c, T)
        if self.transport == "exponential":
            # kappa0 * (T/Tref)^n (reference:
            # exponentialSolidTransport::kappa)
            return float(self.kappa_c[0]) * (T / self.Tref) ** self.n_exp
        if self.transport == "constAnIso":
            # isotropic fallback = mean principal value
            return torch.full_like(T, float(np.mean(self.kappa_c)))
        return torch.full_like(T, float(self.kappa_c[0]))

    def kappa_tensor(self) -> Optional[Any]:
        """constAnIso: the 3x3 conductivity tensor in global axes
        (reference: constAnIsoSolidTransport::KappaLocal rotated by the
        coordinateSystem; identity axes when none given), as a float64
        numpy array: its nine entries scale the face products of
        `kappa_face`."""
        if self.transport != "constAnIso":
            return None
        kdiag = np.diag([float(k) for k in self.kappa_c[:3]])
        if self.aniso_axes is not None:
            R = np.asarray(self.aniso_axes, dtype=np.float64)
            kdiag = R.T @ kdiag @ R
        return kdiag

    def kappa_face(self, mesh, T) -> Any:
        """Effective face conductivity [nF] for fvm.laplacian:
        isotropic -> interpolated cell kappa; constAnIso ->
        n_f . K . n_f (the normal-projected tensor, the same reduction
        gaussLaplacianScheme applies to a tensor gamma)."""
        from ..ops import surface

        K = self.kappa_tensor()
        if K is not None:
            nf = mesh.sf / torch.clamp_min(mesh.mag_sf, 1e-300)[:, None]
            # the reference's einsum fi,ij,fj->f as elementwise products
            kf = torch.zeros_like(nf[:, 0])
            for i in range(3):
                for j in range(3):
                    kf = kf + float(K[i, j]) * nf[:, i] * nf[:, j]
            return kf
        kc = self.kappa(T)
        kf = surface.interpolate_internal(mesh, kc)
        kb = surface.owner_to_b(mesh, kc)
        return torch.cat([kf, kb], dim=0)

    def rho_cp(self, T) -> Any:
        return self.rho(T) * self.cp(T)


def _axes_from_csys(csys) -> Optional[Tuple[Tuple[float, ...], ...]]:
    """coordinateSystem { coordinateRotation { e1 (..); e2|e3 (..) } }
    -> row-orthonormal rotation matrix (rows = local axes in global
    coords), reference: axesRotation."""
    if not hasattr(csys, "get"):
        return None
    rot = csys.get("coordinateRotation", csys)
    e1 = _num(rot.get("e1")) if hasattr(rot, "get") else None
    if e1 is None:
        return None
    e1 = np.asarray(e1, dtype=np.float64)
    e1 /= np.linalg.norm(e1)
    other = _num(rot.get("e2")) if rot.get("e2") is not None \
        else _num(rot.get("e3"))
    if other is None:
        return None
    v = np.asarray(other, dtype=np.float64)
    if rot.get("e2") is not None:
        e3 = np.cross(e1, v)
        e3 /= np.linalg.norm(e3)
        e2 = np.cross(e3, e1)
    else:
        e2 = np.cross(v, e1)
        e2 /= np.linalg.norm(e2)
        e3 = np.cross(e1, e2)
    return tuple(tuple(float(x) for x in e) for e in (e1, e2, e3))


def from_dict(tp) -> SolidThermo:
    """Build a SolidThermo from constant/<region>/
    thermophysicalProperties — either the reference heSolidThermo form
    or the legacy flat rho/Cp/kappa entries."""
    tt = tp.get("thermoType")
    if hasattr(tt, "get"):  # reference dict form
        transport = str(tt.get("transport", "constIso"))
        thermo = str(tt.get("thermo", "hConst"))
        mix = tp.get("mixture", tp)
        tr = mix.get("transport", {}) if hasattr(mix, "get") else {}
        th = mix.get("thermodynamics", {}) if hasattr(mix, "get") else {}
        eos = mix.get("equationOfState", {}) if hasattr(mix, "get") else {}
        rho0 = _num(eos.get("rho"), 8000.0) if hasattr(eos, "get") \
            else 8000.0
        Tref, n_exp = 1.0, 0.0
        aniso = None
        if transport == "constAnIso":
            kap = tuple(_num(tr.get("kappa"), [80.0, 80.0, 80.0]))
            aniso = _axes_from_csys(tp.get("coordinateSystem",
                                           tr.get("coordinateSystem", {})))
        elif transport == "exponential":
            kap = (_num(tr.get("kappa0"), 80.0),)
            Tref = _num(tr.get("Tref"), 300.0)
            n_exp = _num(tr.get("n0", tr.get("n")), 0.0)
        elif transport == "polynomial":
            for k in tr.keys() if hasattr(tr, "keys") else ():
                if str(k).startswith("kappaCoeffs"):
                    kap = tuple(_num(tr.get(k)))
                    break
            else:
                kap = (_num(tr.get("kappa"), 80.0), 0.0)
            transport = "polynomial"
        else:
            transport = "constIso"
            kap = (_num(tr.get("kappa"), 80.0),)
        if thermo == "hPolynomial":
            cp_c = (450.0,)
            for k in th.keys() if hasattr(th, "keys") else ():
                if str(k).startswith("CpCoeffs"):
                    cp_c = tuple(_num(th.get(k)))
                    break
        elif thermo == "hPower":
            cp_c = (_num(th.get("C0"), 450.0),)
            Tref = _num(th.get("Tref"), Tref)
            n_exp = _num(th.get("n0"), n_exp)
        else:
            thermo = "hConst"
            cp_c = (_num(th.get("Cp"), 450.0),)
        return SolidThermo(transport=transport, thermo=thermo,
                           rho0=rho0, kappa_c=kap, cp_c=cp_c,
                           Tref=Tref, n_exp=n_exp, aniso_axes=aniso)
    # legacy flat form
    from ..core.dictionary import dimensioned_scalar

    def ds(key, default):
        v = tp.get(key)
        if v is None:
            return default
        try:
            return dimensioned_scalar(v)[1]
        except Exception:
            return _num(v, default)

    rho0 = ds("rho", ds("rho0", 8000.0))
    cp0 = ds("Cp", ds("cp0", 450.0))
    kap = ds("kappa", ds("K", ds("k0", 80.0)))
    return SolidThermo(transport="constIso", thermo="hConst",
                       rho0=float(rho0), kappa_c=(float(kap),),
                       cp_c=(float(cp0),))
