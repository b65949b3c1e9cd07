"""Post-processing field utilities (port of
openfoam-2.2.x_tpu/apps/postutils.py; applications/utilities/
postProcessing/{velocityField,pressureField,wall,turbulence,patch,
stressField,miscellaneous}/ and preProcessing/applyBoundaryLayer/).

Each command reads the requested (default: the latest) time onto the
case's device (`-device`, the card by default), derives its field
there, and fetches it once to write it into the same time directory
(io/fields.py::write_field), the read/derive/write contract of the
reference's one-shot utilities. Printed numbers are fetched together,
once per command. Symmetric tensors are written as six scalar component
fields (xx, xy, xz, yy, yz, zz), as the reference writes them. Lambda2
takes the eigenvalues of [n, 3, 3] symmetric matrices in closed form on
the device (`eigvalsh3`), ascending as numpy's eigvalsh gives them.
pdfPlot and engineCompRatio work on the host: the first bins one fetched
field with numpy's histogram, the second reads only the engine
geometry.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np
import torch

_COMPONENTS = ((0, 0, "xx"), (0, 1, "xy"), (0, 2, "xz"), (1, 1, "yy"),
               (1, 2, "yz"), (2, 2, "zz"))


def _open_case(argv, extra=()):
    from ..core.case import Case
    from ..core.precision import DEFAULT_DEVICE

    ap = argparse.ArgumentParser()
    for name, kw in extra:
        ap.add_argument(name, **kw)
    ap.add_argument("-case", default=".")
    ap.add_argument("-time", default=None)
    ap.add_argument("-device", default=None)
    args = ap.parse_args(argv)
    case = Case(args.case, device=args.device or DEFAULT_DEVICE)
    t = args.time or case.latest_time_name()
    return args, case, case.mesh, t


def _write(case, mesh, t, name, data, dims=None):
    """Write the device tensor `data` as the field `name` at time t."""
    from ..core.dimensions import dimless
    from ..core.fields import vol_scalar, vol_vector
    from ..io import fields as field_io

    if data.ndim == 2:
        out = vol_vector(mesh, (0.0, 0.0, 0.0), name=name,
                         dims=dims or dimless)
    else:
        out = vol_scalar(mesh, 0.0, name=name, dims=dims or dimless)
    field_io.write_field(out.with_data(data.to(mesh.v.dtype)), mesh,
                         case.dir, t)
    print(f"{name}: wrote {name} at time {t}")


def _host(*xs):
    """Fetch device scalars or tensors together (one transfer)."""
    flat = torch.cat([torch.as_tensor(x).reshape(-1).to(torch.float64)
                      for x in xs])
    return flat.cpu().numpy()


def _sym_grad(mesh, U):
    """grad U [nC,3,3] -> its symmetric and antisymmetric parts."""
    from ..ops import fvc

    g = fvc.grad(mesh, U)          # g[c,i,j] = d(u_j)/d(x_i)
    gt = torch.transpose(g, 1, 2)
    return 0.5 * (g + gt), 0.5 * (g - gt)


def _nu(case):
    from ..core.dictionary import dimensioned_scalar

    _, nu = dimensioned_scalar(case.transport_properties().get("nu", 1e-6))
    return float(nu)


def _nut_or_zero(case, t, mesh):
    try:
        return case.read_field("nut", time=t).data
    except Exception:
        return torch.zeros(mesh.n_cells, dtype=mesh.v.dtype,
                           device=mesh.device)


# ---------------------------------------------------------------------------
# velocityField
# ---------------------------------------------------------------------------

def vorticity_cmd(argv) -> int:
    """vorticity = curl(U) (postProcessing/velocityField/vorticity)."""
    args, case, mesh, t = _open_case(argv)
    from ..core.dimensions import DimensionSet
    from ..ops import fvc

    U = case.read_field("U", time=t)
    _write(case, mesh, t, "vorticity", fvc.curl(mesh, U),
           dims=DimensionSet.of(0, 0, -1))
    return 0


def enstrophy_cmd(argv) -> int:
    """enstrophy = 0.5 |curl U|^2 (postProcessing/velocityField/
    enstrophy)."""
    args, case, mesh, t = _open_case(argv)
    from ..core.dimensions import DimensionSet
    from ..ops import fvc

    w = fvc.curl(mesh, case.read_field("U", time=t))
    _write(case, mesh, t, "enstrophy", 0.5 * (w * w).sum(dim=1),
           dims=DimensionSet.of(0, 0, -2))
    return 0


def q_field(mesh, U):
    """Q = 0.5 (|Omega|^2 - |S|^2) [nC] on U's device."""
    S, W = _sym_grad(mesh, U)
    return 0.5 * ((W * W).sum(dim=(1, 2)) - (S * S).sum(dim=(1, 2)))


def eigvalsh3(M):
    """The eigenvalues of symmetric [n, 3, 3] matrices, ascending, as
    numpy's eigvalsh gives them, in closed form on the matrices' device
    (torch.linalg.eigvalsh on the H100 refuses such a batch: cuSOLVER's
    batched syev returns CUSOLVER_STATUS_INVALID_VALUE from its
    buffer-size query, at 589,824 and at 32,768 matrices). The
    trigonometric roots of the characteristic cubic (Smith, 1961) lose
    half the digits of a nearly double pair, so only the root farthest
    from the other two is taken from it; the pair comes from the 2 x 2
    matrix on the plane normal to that root's eigenvector."""
    a = 0.5 * (M + torch.transpose(M, 1, 2))
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    q = torch.diagonal(a, dim1=1, dim2=2).mean(dim=1)
    b = a - q[:, None, None] * eye
    p = torch.sqrt((b * b).sum(dim=(1, 2)) / 6.0)
    det = (b[:, 0, 0] * (b[:, 1, 1] * b[:, 2, 2] - b[:, 1, 2] * b[:, 2, 1])
           - b[:, 0, 1] * (b[:, 1, 0] * b[:, 2, 2] - b[:, 1, 2] * b[:, 2, 0])
           + b[:, 0, 2] * (b[:, 1, 0] * b[:, 2, 1] - b[:, 1, 1] * b[:, 2, 0]))
    r = det / (2.0 * torch.where(p > 0, p, 1.0) ** 3)
    phi = torch.arccos(torch.clamp(r, -1.0, 1.0)) / 3.0
    # r >= 0: the largest root stands apart, else the smallest
    far = q + 2.0 * p * torch.where(r >= 0, torch.cos(phi),
                                   torch.cos(phi + 2.0 * math.pi / 3.0))
    # its eigenvector: the longest cross product of two rows of a - far
    c = a - far[:, None, None] * eye
    vs = torch.stack([torch.linalg.cross(c[:, i], c[:, j])
                      for i, j in ((0, 1), (0, 2), (1, 2))], dim=1)
    nv = torch.linalg.vector_norm(vs, dim=2)
    nb, best = nv.max(dim=1)
    v = vs[torch.arange(a.shape[0], device=a.device), best]
    v = torch.where(nb[:, None] > 0,
                    v / torch.where(nb > 0, nb, 1.0)[:, None], eye[0])
    u = torch.linalg.cross(v, eye[torch.abs(v).argmin(dim=1)])
    u = u / torch.linalg.vector_norm(u, dim=1, keepdim=True)
    w = torch.linalg.cross(v, u)
    au, aw = torch.einsum("cij,cj->ci", a, u), torch.einsum("cij,cj->ci", a,
                                                            w)
    x, y, z = (u * au).sum(dim=1), (u * aw).sum(dim=1), (w * aw).sum(dim=1)
    m, h = 0.5 * (x + z), torch.hypot(0.5 * (x - z), y)
    return torch.sort(torch.stack([far, m - h, m + h], dim=1), dim=1).values


def lambda2_field(mesh, U):
    """The second eigenvalue of S^2 + Omega^2 [nC] on U's device."""
    S, W = _sym_grad(mesh, U)
    M = torch.einsum("cij,cjk->cik", S, S) \
        + torch.einsum("cij,cjk->cik", W, W)
    M = 0.5 * (M + torch.transpose(M, 1, 2))     # symmetrise
    return eigvalsh3(M)[:, 1]                    # ascending


def q_cmd(argv) -> int:
    """Q = 0.5 (|Omega|^2 - |S|^2) (postProcessing/velocityField/Q)."""
    args, case, mesh, t = _open_case(argv)
    from ..core.dimensions import DimensionSet

    _write(case, mesh, t, "Q", q_field(mesh, case.read_field("U", time=t)),
           dims=DimensionSet.of(0, 0, -2))
    return 0


def lambda2_cmd(argv) -> int:
    """Lambda2 = the second eigenvalue of S^2 + Omega^2
    (postProcessing/velocityField/Lambda2)."""
    args, case, mesh, t = _open_case(argv)
    from ..core.dimensions import DimensionSet

    _write(case, mesh, t, "Lambda2",
           lambda2_field(mesh, case.read_field("U", time=t)),
           dims=DimensionSet.of(0, 0, -2))
    return 0


def flowtype_cmd(argv) -> int:
    """flowType = (|D| - |Omega|)/(|D| + |Omega|): -1 rotation, 0 shear,
    +1 extension (postProcessing/velocityField/flowType)."""
    args, case, mesh, t = _open_case(argv)
    S, W = _sym_grad(mesh, case.read_field("U", time=t))
    magS = torch.sqrt((S * S).sum(dim=(1, 2)))
    magW = torch.sqrt((W * W).sum(dim=(1, 2)))
    _write(case, mesh, t, "flowType",
           (magS - magW) / torch.clamp(magS + magW, min=1e-30))
    return 0


def co_cmd(argv) -> int:
    """The Courant number from the flux of U and controlDict's deltaT
    (postProcessing/velocityField/Co)."""
    args, case, mesh, t = _open_case(argv)
    from ..ops import fvc

    phi = fvc.flux(mesh, case.read_field("U", time=t))
    dt = float(case.control_dict.get("deltaT", 1.0))
    sum_phi = torch.abs(phi)[mesh.cface] * torch.abs(mesh.csign)
    co = 0.5 * dt * sum_phi.sum(dim=1) / mesh.v
    _write(case, mesh, t, "Co", co)
    mx, mean = _host(co.max(), co.mean())
    print(f"Co: max = {mx:.6g}, mean = {mean:.6g}")
    return 0


def pe_cmd(argv) -> int:
    """The face Peclet number |phi_f| / (|Sf| deltaCoeffs nuEff), reduced
    to each cell's maximum (postProcessing/velocityField/Pe writes the
    surface field; the cell maximum here, as in the reference)."""
    args, case, mesh, t = _open_case(argv)
    from ..ops import fvc

    U = case.read_field("U", time=t)
    nu = _nu(case)
    try:
        nut = case.read_field("nut", time=t).data
    except Exception:
        nut = 0.0
    phi = fvc.flux(mesh, U)
    pe_f = torch.abs(phi) / (mesh.mag_sf * mesh.delta_coeffs + 1e-300)
    valid = torch.abs(mesh.csign) > 0
    pe_c = torch.where(valid, pe_f[mesh.cface],
                       torch.zeros_like(mesh.csign)).max(dim=1).values \
        / (nu + nut + 1e-300)
    _write(case, mesh, t, "Pe", pe_c)
    print(f"Pe: max = {_host(pe_c.max())[0]:.6g}")
    return 0


def uprime_cmd(argv) -> int:
    """uprime = sqrt(2k/3) (postProcessing/velocityField/uprime)."""
    args, case, mesh, t = _open_case(argv)
    from ..core.dimensions import DimensionSet

    k = case.read_field("k", time=t).data
    _write(case, mesh, t, "uprime", torch.sqrt(2.0 * k / 3.0),
           dims=DimensionSet.of(0, 1, -1))
    return 0


def mach_cmd(argv) -> int:
    """Ma = |U| / sqrt(gamma R T) (postProcessing/compressible/Mach)."""
    args, case, mesh, t = _open_case(argv)
    from ..models import thermo as thermo_mod

    th = thermo_mod.from_dict(case.properties("thermophysicalProperties"))
    U = case.read_field("U", time=t).data
    T = case.read_field("T", time=t).data
    cp = th.Cp_of(T)
    gamma = cp / torch.clamp(cp - th.R, min=1e-30)
    c = torch.sqrt(gamma * th.R * torch.clamp(T, min=1.0))
    _write(case, mesh, t, "Ma", torch.linalg.vector_norm(U, dim=1) / c)
    return 0


def ptot_cmd(argv) -> int:
    """The total pressure. Kinematic p [m^2/s^2]: ptot = p + 0.5|U|^2;
    absolute p with a readable T: ptot = p + 0.5 rho |U|^2
    (postProcessing/miscellaneous/ptot)."""
    args, case, mesh, t = _open_case(argv)
    p = case.read_field("p", time=t)
    U = case.read_field("U", time=t).data
    k = 0.5 * (U * U).sum(dim=1)
    try:
        from ..models import thermo as thermo_mod

        th = thermo_mod.from_dict(
            case.properties("thermophysicalProperties"))
        T = case.read_field("T", time=t).data
        ptot = p.data + th.rho(p.data, T) * k
    except Exception:
        ptot = p.data + k
    _write(case, mesh, t, "ptot", ptot, dims=p.dims)
    return 0


# ---------------------------------------------------------------------------
# wall
# ---------------------------------------------------------------------------

def _wall_patches(mesh):
    nif = mesh.n_internal_faces
    for p in mesh.patches:
        if p.type == "wall":
            yield p, mesh.owner[p.slice], \
                slice(p.slice.start - nif, p.slice.stop - nif)


def wallgradu_cmd(argv) -> int:
    """wallGradU: snGrad(U) on the wall patches, summed into the
    wall-adjacent cells (zero elsewhere; the reference's utility writes
    patch fields) (postProcessing/wall/wallGradU)."""
    args, case, mesh, t = _open_case(argv)
    from ..core.dimensions import DimensionSet

    U = case.read_field("U", time=t)
    bv = U.boundary_values(mesh)
    out = torch.zeros_like(U.data)
    for p, own, bsl in _wall_patches(mesh):
        g = (bv[bsl] - U.data[own]) * mesh.delta_coeffs[p.slice][:, None]
        out.index_add_(0, own, g)
    _write(case, mesh, t, "wallGradU", out, dims=DimensionSet.of(0, 0, -1))
    return 0


def wallheatflux_cmd(argv) -> int:
    """wallHeatFlux: q = kappa snGrad(T), integrated per wall patch
    (postProcessing/wall/wallHeatFlux)."""
    args, case, mesh, t = _open_case(argv)
    from ..models import thermo as thermo_mod

    th = thermo_mod.from_dict(case.properties("thermophysicalProperties"))
    T = case.read_field("T", time=t)
    bv = T.boundary_values(mesh)
    kappa_c = th.mu * th.Cp_of(T.data) / th.Pr         # [W/m/K]
    names, stats = [], []
    for p, own, bsl in _wall_patches(mesh):
        q = kappa_c[own] * (bv[bsl] - T.data[own]) \
            * mesh.delta_coeffs[p.slice]
        names.append(p.name)
        stats.append(torch.stack([(q * mesh.mag_sf[p.slice]).sum(),
                                  q.min(), q.max()]))
    total = 0.0
    for name, (Q, lo, hi) in zip(names, _host(*stats).reshape(-1, 3)
                                 if stats else ()):
        total += Q
        print(f"wallHeatFlux: patch {name}: integral = {Q:.6g} W, "
              f"min = {lo:.6g}, max = {hi:.6g} W/m^2")
    print(f"wallHeatFlux: total = {total:.6g} W")
    return 0


def yplus_cmd(argv) -> int:
    """yPlusRAS / yPlusLES: u_tau from the wall velocity gradient,
    y+ = u_tau y_c / nu per wall patch (postProcessing/wall/
    {yPlusRAS,yPlusLES})."""
    args, case, mesh, t = _open_case(argv)
    U = case.read_field("U", time=t)
    nu = _nu(case)
    nut = _nut_or_zero(case, t, mesh)
    bv = U.boundary_values(mesh)
    dc = mesh.delta_coeffs
    out = torch.zeros(mesh.n_cells, dtype=mesh.v.dtype, device=mesh.device)
    names, stats = [], []
    for p, own, bsl in _wall_patches(mesh):
        dU = torch.linalg.vector_norm(bv[bsl] - U.data[own], dim=1) \
            * dc[p.slice]
        utau = torch.sqrt((nu + nut[own]) * dU)
        yp = utau / (dc[p.slice] * nu + 1e-300)
        out = out.scatter_reduce(0, own, yp, reduce="amax")
        names.append(p.name)
        stats.append(torch.stack([yp.min(), yp.max(), yp.mean()]))
    for name, (lo, hi, avg) in zip(names, _host(*stats).reshape(-1, 3)
                                   if stats else ()):
        print(f"yPlus: patch {name}: min = {lo:.6g}, max = {hi:.6g}, "
              f"avg = {avg:.6g}")
    _write(case, mesh, t, "yPlus", out)
    return 0


# ---------------------------------------------------------------------------
# turbulence / stress
# ---------------------------------------------------------------------------

def r_cmd(argv) -> int:
    """R = 2/3 k I - nut (grad U + grad U^T): the Boussinesq Reynolds
    stress, as six component fields (postProcessing/turbulence/R)."""
    args, case, mesh, t = _open_case(argv)
    from ..core.dimensions import DimensionSet

    k = case.read_field("k", time=t).data
    nut = case.read_field("nut", time=t).data
    S, _ = _sym_grad(mesh, case.read_field("U", time=t))
    R = -2.0 * nut[:, None, None] * S
    for i in range(3):
        R[:, i, i] += 2.0 / 3.0 * k
    for i, j, tag in _COMPONENTS:
        _write(case, mesh, t, f"R{tag}", R[:, i, j],
               dims=DimensionSet.of(0, 2, -2))
    return 0


def stresscomponents_cmd(argv) -> int:
    """sigma = 2 nu symm(grad U) (kinematic, incompressible), as six
    component fields (postProcessing/stressField/stressComponents)."""
    args, case, mesh, t = _open_case(argv)
    from ..core.dimensions import DimensionSet

    nu = _nu(case)
    S, _ = _sym_grad(mesh, case.read_field("U", time=t))
    sig = 2.0 * nu * S
    for i, j, tag in _COMPONENTS:
        _write(case, mesh, t, f"sigma{tag}", sig[:, i, j],
               dims=DimensionSet.of(0, 2, -2))
    return 0


# ---------------------------------------------------------------------------
# patch
# ---------------------------------------------------------------------------

def patchintegrate_cmd(argv) -> int:
    """patchIntegrate <field> <patch>: the area integral of a field over
    one patch (postProcessing/patch/patchIntegrate)."""
    args, case, mesh, t = _open_case(
        argv, extra=[("field", {}), ("patch", {})])
    f = case.read_field(args.field, time=t)
    bv = f.boundary_values(mesh)
    nif = mesh.n_internal_faces
    for p in mesh.patches:
        if p.name == args.patch:
            vals = bv[p.slice.start - nif:p.slice.stop - nif]
            area = mesh.mag_sf[p.slice]
            if vals.ndim == 2:
                got = _host((vals * area[:, None]).sum(dim=0), area.sum())
                print(f"patchIntegrate: {args.field} over {p.name} = "
                      f"({got[0]:.6g} {got[1]:.6g} {got[2]:.6g})"
                      f", area = {got[3]:.6g}")
            else:
                got = _host((vals * area).sum(), area.sum())
                print(f"patchIntegrate: {args.field} over {p.name} = "
                      f"{got[0]:.6g}, area = {got[1]:.6g}")
            return 0
    print(f"patchIntegrate: no patch {args.patch!r}", file=sys.stderr)
    return 1


# ---------------------------------------------------------------------------
# preProcessing
# ---------------------------------------------------------------------------

def applyboundarylayer_cmd(argv) -> int:
    """applyBoundaryLayer [-ybl <m>]: a 1/7th power-law velocity profile
    inside the given boundary-layer thickness, with consistent k and
    epsilon where present (preProcessing/applyBoundaryLayer). The wall
    distance is the host one of mesh/walldist.py, as in the reference."""
    args, case, mesh, t = _open_case(
        argv, extra=[("-ybl", {"type": float, "default": 0.05})])
    from ..io import fields as field_io
    from ..mesh.walldist import wall_distance

    y = torch.tensor(wall_distance(case.poly_mesh), dtype=mesh.v.dtype,
                     device=mesh.device)
    U = case.read_field("U", time=t)
    scale = torch.clamp((torch.clamp(y, min=1e-12) / args.ybl)
                        ** (1.0 / 7.0), max=1.0)
    Unew = U.data * scale[:, None]
    field_io.write_field(U.with_data(Unew), mesh, case.dir, t)
    print(f"applyBoundaryLayer: scaled U inside ybl={args.ybl}")
    mag = torch.linalg.vector_norm(Unew, dim=1)
    try:
        kf = case.read_field("k", time=t)
        Cmu = 0.09
        kbl = torch.clamp(1.5 * (0.05 * mag) ** 2, min=1e-10)
        field_io.write_field(kf.with_data(kbl), mesh, case.dir, t)
        ef = case.read_field("epsilon", time=t)
        ebl = Cmu ** 0.75 * kbl ** 1.5 / (0.4 * torch.clamp(
            torch.clamp(y, max=args.ybl), min=1e-6))
        field_io.write_field(ef.with_data(ebl), mesh, case.dir, t)
        print("applyBoundaryLayer: rewrote k/epsilon")
    except Exception:
        pass
    return 0


def wallshearstress_cmd(argv) -> int:
    """wallShearStress: tau_w = -(nu+nut) snGrad(U) per wall patch
    (postProcessing/wall/wallShearStress, the utility twin of the
    function object)."""
    args, case, mesh, t = _open_case(argv)
    from ..core.dimensions import DimensionSet

    U = case.read_field("U", time=t)
    nu = _nu(case)
    nut = _nut_or_zero(case, t, mesh)
    bv = U.boundary_values(mesh)
    out = torch.zeros_like(U.data)
    names, stats = [], []
    for p, own, bsl in _wall_patches(mesh):
        tau = -(nu + nut[own])[:, None] * (bv[bsl] - U.data[own]) \
            * mesh.delta_coeffs[p.slice][:, None]
        mag = torch.linalg.vector_norm(tau, dim=1)
        names.append(p.name)
        stats.append(torch.stack([mag.min(), mag.max()]))
        out.index_add_(0, own, tau)
    for name, (lo, hi) in zip(names, _host(*stats).reshape(-1, 2)
                              if stats else ()):
        print(f"wallShearStress: patch {name}: min = {lo:.6g}, "
              f"max = {hi:.6g} m^2/s^2")
    _write(case, mesh, t, "wallShearStress", out,
           dims=DimensionSet.of(0, 2, -2))
    return 0


def engine_comp_ratio_cmd(argv) -> int:
    """engineCompRatio: (Vbdc = Vc + Vs) / Vtdc from
    constant/engineGeometry (postProcessing/miscellaneous/
    engineCompRatio; there from meshed volumes, here from the
    slider-crank geometry of the engine mesh motion, as the reference)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("-case", default=".")
    ap.add_argument("-device", default=None)
    a = ap.parse_args(argv)
    from ..core.case import Case
    from ..core.precision import DEFAULT_DEVICE
    from ..mesh import engine as eng_mod

    case = Case(a.case, device=a.device or DEFAULT_DEVICE)
    geom = eng_mod.from_dict(case.properties("engineGeometry"))
    eps = (geom.clearance + geom.stroke) / geom.clearance
    print(f"engineCompRatio: clearance = {geom.clearance} m, "
          f"stroke = {geom.stroke} m")
    print(f"Geometric compression ratio: {eps:.6g}")
    return 0


def pdf_plot_cmd(argv) -> int:
    """pdfPlot <field> [-nBins N]: the volume-weighted histogram of a
    scalar field (the magnitude of a vector) ->
    postProcessing/pdfPlot/<t>/<field>.xy (postProcessing/
    miscellaneous/pdfPlot)."""
    args, case, mesh, t = _open_case(
        argv, extra=[("field", {}),
                     ("-nBins", {"type": int, "default": 32})])
    f = case.read_field(args.field, time=t)
    data = f.data
    if data.ndim == 2:
        data = torch.linalg.vector_norm(data, dim=1)
    n = mesh.n_cells
    both = _host(data, mesh.v)
    data, v = both[:n], both[n:]
    hist, edges = np.histogram(data, bins=args.nBins, weights=v)
    hist = hist / (v.sum() * np.diff(edges))
    out_dir = os.path.join(case.dir, "postProcessing", "pdfPlot", t)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{args.field}.xy")
    with open(path, "w") as fh:
        fh.write(f"# {args.field} pdf (volume-weighted)\n")
        for c, h in zip(0.5 * (edges[:-1] + edges[1:]), hist):
            fh.write(f"{c:.8g} {h:.8g}\n")
    print(f"pdfPlot: wrote {path}")
    return 0


def probe_locations_cmd(argv) -> int:
    """probeLocations: the fields of system/probesDict at its points, at
    the chosen time (postProcessing/sampling/probeLocations); the
    nearest cell of each point found on the device."""
    args, case, mesh, t = _open_case(argv)
    from ..core.dictionary import parse_file

    d = parse_file(os.path.join(args.case, "system", "probesDict"))
    pts = np.asarray(d.get("probeLocations", []),
                     dtype=float).reshape(-1, 3)
    fields = [str(x) for x in d.get("fields", [])]
    p = torch.tensor(pts, dtype=mesh.v.dtype, device=mesh.device)
    cells = torch.argmin(((mesh.c[None, :, :] - p[:, None, :]) ** 2)
                         .sum(dim=2), dim=1)
    for name in fields:
        f = case.read_field(name, time=t)
        vals = f.data[cells]
        got = _host(vals).reshape(vals.shape)
        for pt, val in zip(pts, got):
            s = (f"({val[0]:.6g} {val[1]:.6g} {val[2]:.6g})"
                 if got.ndim == 2 else f"{val:.6g}")
            print(f"probeLocations: {name} @ ({pt[0]:g} {pt[1]:g} "
                  f"{pt[2]:g}) = {s}")
    return 0


COMMANDS = {
    "vorticity": vorticity_cmd,
    "enstrophy": enstrophy_cmd,
    "Q": q_cmd,
    "Lambda2": lambda2_cmd,
    "flowType": flowtype_cmd,
    "Co": co_cmd,
    "Pe": pe_cmd,
    "uprime": uprime_cmd,
    "Mach": mach_cmd,
    "ptot": ptot_cmd,
    "wallGradU": wallgradu_cmd,
    "wallHeatFlux": wallheatflux_cmd,
    "yPlusRAS": yplus_cmd,
    "yPlusLES": yplus_cmd,
    "R": r_cmd,
    "stressComponents": stresscomponents_cmd,
    "patchIntegrate": patchintegrate_cmd,
    "applyBoundaryLayer": applyboundarylayer_cmd,
    "wallShearStress": wallshearstress_cmd,
    "engineCompRatio": engine_comp_ratio_cmd,
    "pdfPlot": pdf_plot_cmd,
    "probeLocations": probe_locations_cmd,
}
