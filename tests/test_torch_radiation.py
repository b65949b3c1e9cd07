"""foamtpu_torch's radiation (models/radiation.py: P1, fvDOM, viewFactor)
and its coupling into buoyantSimpleFoam / buoyantPimpleFoam
(solvers/buoyantrho.py, solvers/apps.py::_load_radiation) against the JAX
package.

In float64 (one process, FOAMTPU_X64=1 JAX_ENABLE_X64=1):
  - both packages' `run(case)` take 3 PIMPLE steps of hotCavity with a
    constant/radiationProperties, once P1 and once fvDOM (16 rays), from a
    seeded start (chip_smoke.SLICE15_CASES): U, p_rgh, T, phi, G and the
    turbulence fields at rtol 1e-9, every solve's iteration count equal,
    the log lines and the written fields. The fvDOM case takes an
    optically thick medium (a = 50 1/m): in a thin one a ray's BiCGStab
    count moves with round-off (chip_smoke.THICK_ABSORPTIVITY);
  - on tests/test_radiation.py's 20 x 20 box (empty front and back):
    `make_G`'s Marshak BCs (kinds, refValue, valueFraction), `solve_G`
    (G and its PCG count), `Sh`, `fvdom_directions` bit for bit,
    `solve_fvdom` (G, the last ray's count, and the mesh's face_active
    branch, which zeroes the rays' d.Sf on the empty faces), the view
    factors, heat flux and cell source
    of two enclosures at 1e-12, 5 steady `buoyantrho_step` iterations
    with P1 from a seeded start, and `_load_radiation` for P1, fvDOM,
    radiation off and a model neither package knows.

As a script (`thin`, `witness`, see the end of the file) it reads the
thin medium's fvDOM rays in either package, on the CPU or the card.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.models import radiation as trad
from foamtpu_torch.solvers import apps as tapps

import chip_smoke
from test_torch_ras_models import assert_parity, parity
from test_torch_simple import REPO

torch.set_num_threads(2)

STEPS = 3
CASES = ("hotCavityP1", "hotCavityFvDOM")

UNITS = r'''
import dataclasses
import jax
import jax.numpy as jnp
from foamtpu.bc import patchfields as jpf
from foamtpu.core.dictionary import parse_string as jps
from foamtpu.core.fields import vol_scalar as jvs, vol_vector as jvv
from foamtpu.core.dimensions import DimensionSet as JD
from foamtpu.mesh import blockmesh as jbm, to_device as jtd
from foamtpu.models import radiation as jr
from foamtpu.models.thermo import PerfectGas as JGas
from foamtpu.solvers import buoyantrho as jbr
from foamtpu.solvers.apps import _load_radiation as jload
from foamtpu.core.case import Case as JCase
from foamtpu_torch.bc import patchfields as tpf
from foamtpu_torch.core.dictionary import parse_string as tps
from foamtpu_torch.core.fields import vol_scalar as tvs, vol_vector as tvv
from foamtpu_torch.core.dimensions import DimensionSet as TD
from foamtpu_torch.mesh import blockmesh as tbm, to_device as ttd
from foamtpu_torch.models import radiation as trd
from foamtpu_torch.models.thermo import PerfectGas as TGas
from foamtpu_torch.solvers import buoyantrho as tbr
from foamtpu_torch.solvers.apps import _load_radiation as tload

def host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

def rel(a, b):
    a, b = np.asarray(host(a), float), np.asarray(host(b), float)
    if a.shape != b.shape:
        return float("inf")
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))

BOX = """
convertToMeters 1;
vertices ( (0 0 0) (1 0 0) (1 1 0) (0 1 0)
           (0 0 0.1) (1 0 0.1) (1 1 0.1) (0 1 0.1) );
blocks ( hex (0 1 2 3 4 5 6 7) (20 20 1) simpleGrading (1 1 1) );
boundary
(
    hot  { type wall; faces ((0 4 7 3)); }
    cold { type wall; faces ((2 6 5 1)); }
    other { type wall; faces ((1 5 4 0) (3 7 6 2)); }
    frontAndBack { type empty; faces ((0 3 2 1) (4 5 6 7)); }
);
"""
jm = jtd(jbm.generate(jps(BOX)))
tm = ttd(tbm.generate(tps(BOX)), device="cpu")
n = tm.n_cells
rng = np.random.default_rng(15)

def T_bcs(pf, mesh, Th, Tc):
    out = []
    for p in mesh.patches:
        if p.type == "empty":
            out.append(pf.PatchField(kind="empty", vfrac=0.0))
        elif p.name == "hot":
            out.append(pf.fixed_value(Th))
        elif p.name == "cold":
            out.append(pf.fixed_value(Tc))
        else:
            out.append(pf.zero_gradient())
    return tuple(out)

TDIM_J, TDIM_T = JD.of(0, 0, 0, 1), TD.of(0, 0, 0, 1)
Tj = jvs(jm, 750.0, name="T", dims=TDIM_J, bcs=T_bcs(jpf, jm, 1000.0, 500.0))
Tt = tvs(tm, 750.0, name="T", dims=TDIM_T, bcs=T_bcs(tpf, tm, 1000.0, 500.0))
Tc = 600.0 + 300.0 * rng.random(n)
units = {}
# -- P1 -------------------------------------------------------------------
cj = jr.P1Config(a=1.0, e=1.0, emissivity=0.8)
ct = trd.P1Config(a=1.0, e=1.0, emissivity=0.8)
Gj, Gt = jr.make_G(jm, cj, Tj.bcs), trd.make_G(tm, ct, Tt.bcs)
units["make_G"] = {
    "kinds": [[b.kind for b in Gj.bcs], [b.kind for b in Gt.bcs]],
    "ref": max(rel(jnp.broadcast_to(a.ref_value, (p.size,)), b.ref_value)
               for a, b, p in zip(Gj.bcs, Gt.bcs, tm.patches) if a.kind == "mixed"),
    "vfrac": max(rel(jnp.broadcast_to(a.vfrac, (p.size,)), b.vfrac)
                 for a, b, p in zip(Gj.bcs, Gt.bcs, tm.patches) if a.kind == "mixed")}
gj, pj = jr.solve_G(jm, Gj, jnp.asarray(Tc), cj)
gt, pt = trd.solve_G(tm, Gt, torch.tensor(Tc), ct)
units["solve_G"] = {"G": rel(gj.data, gt.data),
                    "iters": [int(pj.n_iterations), int(pt.n_iterations)],
                    "bvals": rel(gj.boundary_values(jm), gt.boundary_values(tm))}
units["Sh"] = rel(jr.Sh(jm, gj, jnp.asarray(Tc), cj), trd.Sh(tm, gt, torch.tensor(Tc), ct))
# -- fvDOM ----------------------------------------------------------------
dirs = {}
for nt, nph in ((2, 2), (3, 1), (4, 3)):
    dj, wj = jr.fvdom_directions(jr.FvDOMConfig(n_theta=nt, n_phi=nph))
    dt_, wt = trd.fvdom_directions(trd.FvDOMConfig(n_theta=nt, n_phi=nph))
    dirs[f"{nt}x{nph}"] = bool(np.array_equal(dj, dt_) and np.array_equal(wj, wt))
units["directions"] = dirs
fj = jr.FvDOMConfig(a=50.0, e=50.0, emissivity=0.9)
ft = trd.FvDOMConfig(a=50.0, e=50.0, emissivity=0.9)
Gj0, Gt0 = jr.make_G(jm, fj, Tj.bcs), trd.make_G(tm, ft, Tt.bcs)
gj, pj = jr.solve_G(jm, Gj0, jnp.asarray(Tc), fj, T_bcs=Tj.bcs)
gt, pt = trd.solve_G(tm, Gt0, torch.tensor(Tc), ft, T_bcs=Tt.bcs)
unmasked = dataclasses.replace(tm, face_active=torch.ones_like(tm.face_active))
gu, _ = trd.solve_fvdom(unmasked, Gt0, torch.tensor(Tc), ft, T_bcs=Tt.bcs)
d0 = torch.tensor(trd.fvdom_directions(ft)[0][0])
empty = [p for p in tm.patches if p.type == "empty"][0]
units["fvdom"] = {"G": rel(gj.data, gt.data),
                  "iters": [int(pj.n_iterations), int(pt.n_iterations)],
                  "unmasked": rel(gt.data, gu.data),
                  "face_active": [hasattr(jm, "face_active"), hasattr(tm, "face_active")],
                  "raw_empty_flux": float(torch.abs(tm.sf[empty.slice] @ d0).max()),
                  "masked_empty_flux": float(torch.abs((tm.sf @ d0 * tm.face_active)[empty.slice]).max()),
                  "kinds": [[b.kind for b in Gj0.bcs], [b.kind for b in Gt0.bcs]]}
# -- viewFactor -------------------------------------------------------------
PLATES = """
convertToMeters 1;
vertices ( (0 0 0) (1 0 0) (1 1 0) (0 1 0)
           (0 0 0.01) (1 0 0.01) (1 1 0.01) (0 1 0.01) );
blocks ( hex (0 1 2 3 4 5 6 7) (16 16 1) simpleGrading (1 1 1) );
boundary
(
    bottom { type wall; faces ((0 3 2 1)); }
    top    { type wall; faces ((4 5 6 7)); }
    sides  { type patch; faces ((2 6 5 1) (0 4 7 3) (1 5 4 0) (3 7 6 2)); }
);
"""
CUBE = """
convertToMeters 1;
vertices ( (0 0 0) (1 0 0) (1 1 0) (0 1 0) (0 0 1) (1 0 1) (1 1 1) (0 1 1) );
blocks ( hex (0 1 2 3 4 5 6 7) (4 4 4) simpleGrading (1 1 1) );
boundary
(
    walls { type wall; faces ((2 6 5 1) (0 4 7 3) (1 5 4 0)
                              (3 7 6 2) (0 3 2 1) (4 5 6 7)); }
);
"""
vfu = {}
for tag, bm, names, eps in (("plates", PLATES, ("bottom", "top"), 0.7),
                            ("cube", CUBE, ("wall",), 0.6)):
    mj = jtd(jbm.generate(jps(bm)))
    mt = ttd(tbm.generate(tps(bm)), device="cpu")
    vj, vt = jr.make_viewfactor(mj, names, eps), trd.make_viewfactor(mt, names, eps)
    nf = vj.faces.shape[0]
    Tf = 300.0 + 500.0 * rng.random(nf)
    Tcell = 300.0 + 500.0 * rng.random(mt.n_cells)
    vfu[tag] = {"faces": bool(np.array_equal(np.asarray(vj.faces), host(vt.faces))),
                "owners": bool(np.array_equal(np.asarray(vj.owners), host(vt.owners))),
                "F": rel(vj.F, vt.F), "areas": rel(vj.areas, vt.areas),
                "eps": rel(vj.emissivity, vt.emissivity),
                "q": rel(jr.viewfactor_heat_flux(vj, jnp.asarray(Tf)),
                         trd.viewfactor_heat_flux(vt, torch.tensor(Tf))),
                "source": rel(jr.viewfactor_source(mj, vj, jnp.asarray(Tcell)),
                              trd.viewfactor_source(mt, vt, torch.tensor(Tcell))),
                "n": int(nf)}
units["viewfactor"] = vfu
# -- buoyantrho_step with P1, steady, 5 iterations from a seeded start -------
ub, pb = [], []
for p in jm.patches:
    if p.type == "empty":
        ub.append("empty"); pb.append("empty")
    else:
        ub.append("fixed"); pb.append("zg")
def bcs_of(pf, kinds, zero):
    return tuple(pf.PatchField(kind="empty", vfrac=0.0) if k == "empty" else
                 (pf.fixed_value(zero) if k == "fixed" else pf.zero_gradient())
                 for k in kinds)
U0 = np.zeros((n, 3)); U0[:, :2] = 1e-3 * rng.standard_normal((n, 2))
T0 = 750.0 * (1.0 + 0.01 * rng.random(n))
Uj = jvv(jm, jnp.asarray(U0), name="U", bcs=bcs_of(jpf, ub, jnp.zeros(3)))
Ut = tvv(tm, torch.tensor(U0), name="U", bcs=bcs_of(tpf, ub, torch.zeros(3, dtype=torch.float64)))
Pj = jvs(jm, 1e5, name="p_rgh", dims=JD.of(1, -1, -2), bcs=bcs_of(jpf, pb, 0.0))
Pt = tvs(tm, 1e5, name="p_rgh", dims=TD.of(1, -1, -2), bcs=bcs_of(tpf, pb, 0.0))
Tj2 = Tj.with_data(jnp.asarray(T0)); Tt2 = Tt.with_data(torch.tensor(T0))
thj, tht = JGas(R=287.0, Cv=717.5, mu=5e-4), TGas(R=287.0, Cv=717.5, mu=5e-4)
kw = dict(steady=True, g=(0.0, 0.0, 0.0), alpha_u=0.5, alpha_p=0.7, alpha_e=0.5)
cfgj = jbr.BuoyantRhoConfig(thermo=thj, radiation=jr.P1Config(a=5.0, e=5.0), **kw)
cfgt = tbr.BuoyantRhoConfig(thermo=tht, radiation=trd.P1Config(a=5.0, e=5.0), **kw)
sj = jbr.initial_state(jm, Uj, Pj, Tj2, thj, g=cfgj.g, steady=True)
st = tbr.initial_state(tm, Ut, Pt, Tt2, tht, g=cfgt.g, steady=True)
sj["G"] = jr.make_G(jm, cfgj.radiation, Tj.bcs)
st["G"] = trd.make_G(tm, cfgt.radiation, Tt.bcs)
one_j, one_t = jnp.asarray(1.0), torch.tensor(1.0, dtype=torch.float64)
iters = [[], []]
for _ in range(5):
    sj, dj = jbr.buoyantrho_step(jm, sj, one_j, cfgj)
    st, dt2 = tbr.buoyantrho_step(tm, st, one_t, cfgt)
    for k2, lst in ((0, dj), (1, dt2)):
        iters[k2].append([int(lst["G"].n_iterations), int(lst["T"].n_iterations),
                          int(lst["p_iters"])])
units["buoyantrho_P1"] = {f: rel(getattr(sj[f], "data", sj[f]), getattr(st[f], "data", st[f]))
                          for f in ("U", "p_rgh", "T", "G", "phi")}
units["buoyantrho_P1"]["iters"] = iters
units["buoyantrho_P1"]["T_mean"] = float(np.mean(host(st["T"].data)))
# -- _load_radiation ------------------------------------------------------
RP = """FoamFile { version 2.0; format ascii; class dictionary; object radiationProperties; }
radiation %s;
radiationModel %s;
fvDOMCoeffs { nTheta 3; nPhi 1; }
constantAbsorptionEmissionCoeffs { absorptivity absorptivity [0 -1 0 0 0 0 0] 0.3;
    emissivity emissivity [0 -1 0 0 0 0 0] 0.4; scatter 0.1; }
"""
cav = os.path.join(root, "cavity")
cs.compressible_case(os.getcwd(), cav, "buoyantPimpleFoam", None)
loads = {}
for tag, on, model in (("P1", "on", "P1"), ("fvDOM", "on", "fvDOM"),
                       ("off", "off", "P1"), ("unknown", "on", "opaqueSolid")):
    with open(os.path.join(cav, "constant", "radiationProperties"), "w") as f:
        f.write(RP % (on, model))
    a, b = jload(JCase(cav)), tload(TCase(cav, device="cpu"))
    loads[tag] = [None if a is None else [type(a).__name__, list(a)],
                  None if b is None else [type(b).__name__, list(b)]]
units["load_radiation"] = loads
print(json.dumps({"units": units}))
'''


@pytest.fixture(scope="module")
def runs():
    return parity("slice15", STEPS, CASES, tail=UNITS, lines=2)


@pytest.fixture(scope="module")
def units(runs):
    return runs[1]["units"]


@pytest.mark.parametrize("name", CASES)
def test_hot_cavity_with_radiation_matches_reference_f64(runs, name):
    rec = runs[0][name]
    assert_parity(rec, STEPS, name, files_scaled=True)
    assert {"U", "p_rgh", "T", "phi", "G", "k", "epsilon", "mut",
            "alphat"} == set(rec["errs"])
    assert rec["errs"]["G"]["scale"] > 100.0


def test_make_g_marshak_bcs_match_reference(units):
    u = units["make_G"]
    assert u["kinds"][0] == u["kinds"][1] == ["mixed", "mixed",
                                              "zeroGradient", "empty"]
    assert u["ref"] < 1e-15 and u["vfrac"] < 1e-15, u


def test_solve_g_matches_reference(units):
    u = units["solve_G"]
    assert u["G"] < 1e-9 and u["bvals"] < 1e-9, u
    assert u["iters"][0] == u["iters"][1] > 1


def test_sh_matches_reference(units):
    assert units["Sh"] < 1e-9


def test_fvdom_directions_match_reference_exactly(units):
    assert units["directions"] == {"2x2": True, "3x1": True, "4x3": True}


def test_solve_fvdom_masks_empty_faces_as_reference(units):
    u = units["fvdom"]
    assert u["G"] < 1e-9, u
    assert u["iters"][0] == u["iters"][1], u
    assert u["kinds"][0] == u["kinds"][1]
    # both meshes take the face_active branch: the rays have a z component,
    # so d.Sf on the empty faces is not zero until it is masked
    assert u["face_active"] == [True, True]
    assert u["raw_empty_flux"] > 1e-3 and u["masked_empty_flux"] == 0.0
    # (the empty BC keeps the faces out of the matrix as well: the result
    # does not move without the mask)
    assert u["unmasked"] < 1e-12, u


@pytest.mark.parametrize("tag", ["plates", "cube"])
def test_viewfactor_matches_reference(units, tag):
    u = units["viewfactor"][tag]
    assert u["faces"] and u["owners"] and u["n"] > 90
    for key in ("F", "areas", "eps", "q", "source"):
        assert u[key] < 1e-12, (key, u)


def test_buoyantrho_step_with_p1_matches_reference(units):
    u = units["buoyantrho_P1"]
    for f in ("U", "p_rgh", "T", "G", "phi"):
        assert u[f] < 1e-9, (f, u)
    assert u["iters"][0] == u["iters"][1], u["iters"]
    assert 600.0 < u["T_mean"] < 1000.0


@pytest.mark.parametrize("tag", ["P1", "fvDOM", "off", "unknown"])
def test_load_radiation_matches_reference(units, tag):
    a, b = units["load_radiation"][tag]
    assert a == b, (a, b)
    if tag in ("off", "unknown"):
        assert a is None
    else:
        assert a[0] == {"P1": "P1Config", "fvDOM": "FvDOMConfig"}[tag]
        assert a[1][:4] == [0.3, 0.1, 0.4, 1.0]


def test_radiation_models_are_registered(tmp_path):
    """buoyantPimpleFoam reads constant/radiationProperties: its state
    carries G, bounded by the black-body limit of the hottest wall."""
    from foamtpu_torch.apps.cli import main as tcli

    d = chip_smoke.slice15_case(REPO, str(tmp_path / "cav"),
                                "buoyantPimpleFoam", tcli, radiation="P1")
    case = TCase(d, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        tapps.run(case, max_steps=1)
    G = case.final_state["G"].data
    T = case.final_state["T"].data
    assert os.path.exists(os.path.join(d, "constant", "radiationProperties"))
    assert float(G.min()) >= 0.0
    assert float(G.max()) <= 4.0 * trad.SIGMA * float(T.max()) ** 4 * 1.01


def _thin_case(which, root, a, device="cpu"):
    """chip_smoke's hot hotCavity (tests/test_radiation.py's walls and gas)
    with fvDOM at absorptivity `a`, meshed by `which` package's
    blockMesh; (case dir, that package's Case, linear and radiation
    modules, a host reader)."""
    import tempfile

    d = tempfile.mkdtemp(dir=root) + "/cav"
    if which == "jax":
        from foamtpu.apps.cli import main as cli
        from foamtpu.core.case import Case
        from foamtpu.models import radiation as rad
        from foamtpu.solvers import linear

        dev = ()
    else:
        from foamtpu_torch.apps.cli import main as cli
        from foamtpu_torch.solvers import linear

        Case, rad, dev = TCase, trad, ("-device", device)
    with contextlib.redirect_stdout(io.StringIO()):
        chip_smoke.slice15_case(REPO, d, "buoyantPimpleFoam", cli,
                                device=dev, hot=True, radiation="fvDOM",
                                absorptivity=a)
    case = Case(d) if which == "jax" else Case(d, device=device)
    return d, case, linear, rad, lambda t: np.asarray(
        t.double().cpu() if isinstance(t, torch.Tensor) else t, np.float64)


def thin_fvdom_run(which, root, steps=5, a=0.5, device="cpu"):
    """The hot hotCavity with fvDOM at absorptivity `a` (0.5: the
    reference's default, an optically thin medium) for `steps` steps
    through `which` package's run(case) ("port" on `device`), in the
    precision the environment sets: the final T and G ranges, each fvDOM
    call's G range, and per ray solve its iterations, reported residual
    and largest |I|; on the card each ray's system also solved on the CPU
    from the same inputs (its largest |I| beside). The JAX package's
    step is jitted: only its final fields are read."""
    import dataclasses

    d, case, linear, rad, host = _thin_case(which, root, a, device)
    cpu_mesh = TCase(d, device="cpu").mesh if device != "cpu" else None
    orig, orig_dom = linear.solve, rad.solve_fvdom
    rays, gs, inside = [], [], [False]

    def solve(mesh, mat, psi, ctl):
        out = orig(mesh, mat, psi, ctl)
        if inside[0]:
            rec = [int(host(out[1].n_iterations).max()),
                   float(host(out[1].final_residual).max()),
                   float(np.abs(host(out[0])).max())]
            if cpu_mesh is not None:
                cpu = dataclasses.replace(mat, **{
                    f.name: getattr(mat, f.name).cpu()
                    for f in dataclasses.fields(mat)
                    if isinstance(getattr(mat, f.name), torch.Tensor)})
                rec.append(float(np.abs(host(
                    orig(cpu_mesh, cpu, psi.cpu(), ctl)[0])).max()))
            rays.append(rec)
        return out

    def solve_fvdom(*args, **kw):
        inside[0] = True
        try:
            G, perf = orig_dom(*args, **kw)
        finally:
            inside[0] = False
        g = host(G.data)
        gs.append([float(g.min()), float(g.max())])
        return G, perf

    if which != "jax":
        linear.solve, rad.solve_fvdom = solve, solve_fvdom
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            if which == "jax":
                from foamtpu.core.case import run_case

                case = run_case(d, max_steps=steps)
            else:
                tapps.run(case, max_steps=steps)
    finally:
        linear.solve, rad.solve_fvdom = orig, orig_dom
    T, G = host(case.final_state["T"].data), host(case.final_state["G"].data)
    return {"package": which, "device": device, "a": a, "steps": steps,
            "dtype": str(case.final_state["T"].data.dtype),
            "finite": bool(np.isfinite(T).all() and np.isfinite(G).all()),
            "T": [float(T.min()), float(T.max())],
            "G": [float(G.min()), float(G.max())], "G_per_call": gs,
            "rays_over_1e6": sum(r[2] > 1e6 for r in rays), "rays": rays}


def fvdom_ray_witness(which, root, draws=10, a=0.5):
    """The hot hotCavity's first fvDOM call (T as read, G from make_G)
    through `which` package on the CPU, in the precision the environment
    sets; each ray's system solved again `draws` times with its source
    scaled by 1 + 1e-7 u (u standard normal per cell, a numpy seed): per
    ray its own iterations and largest |I|, and over the draws the
    largest |I| and the reported residuals of those above 1e6 (the exact
    intensity stays below 2e4 W/m^2/sr)."""
    d, case, linear, rad, host = _thin_case(which, root, a)
    mesh, Tf = case.mesh, case.read_field("T")
    if which == "jax":
        import jax.numpy as jnp

        def arr(x):
            return jnp.asarray(x, mesh.v.dtype)
    else:
        def arr(x):
            return torch.as_tensor(x, dtype=mesh.v.dtype)
    cfg = rad.FvDOMConfig(a=a, e=a)
    rng = np.random.default_rng(7)
    orig, rays = linear.solve, []

    def solve(m, eqn, psi, ctl):
        out = orig(m, eqn, psi, ctl)
        src = host(eqn.source)
        tops, over = [], []
        for _ in range(draws):
            u = rng.standard_normal(src.shape)
            x, p = orig(m, eqn.replace_fields(
                source=arr(src * (1.0 + 1e-7 * u))), psi, ctl)
            tops.append(float(np.abs(host(x)).max()))
            if tops[-1] > 1e6:
                over.append(float(host(p.final_residual).max()))
        rays.append({"iterations": int(host(out[1].n_iterations).max()),
                     "I_max": float(np.abs(host(out[0])).max()),
                     "draws_I_max": max(tops), "draws_over_1e6": len(over),
                     "their_residuals": over})
        return out

    linear.solve = solve
    try:
        rad.solve_fvdom(mesh, rad.make_G(mesh, cfg, Tf.bcs), Tf.data, cfg,
                        T_bcs=Tf.bcs)
    finally:
        linear.solve = orig
    return {"package": which, "dtype": str(Tf.data.dtype),
            "a": a, "draws_per_ray": draws,
            "draws_over_1e6": sum(r["draws_over_1e6"] for r in rays),
            "rays": rays}


if __name__ == "__main__":
    # python tests/test_torch_radiation.py thin jax|port [a] [steps]
    # [--cuda]: thin_fvdom_run's JSON; ... witness jax|port [draws] [a]:
    # fvdom_ray_witness's (the environment sets the precision: float64
    # with FOAMTPU_X64=1 JAX_ENABLE_X64=1)
    import json
    import sys
    import tempfile

    args = [x for x in sys.argv[1:] if not x.startswith("--")]
    root = tempfile.mkdtemp()
    if args[:1] == ["thin"]:
        print(json.dumps(thin_fvdom_run(
            args[1], root, steps=int(args[3]) if len(args) > 3 else 5,
            a=float(args[2]) if len(args) > 2 else 0.5,
            device="cuda" if "--cuda" in sys.argv else "cpu")))
    elif args[:1] == ["witness"]:
        print(json.dumps(fvdom_ray_witness(
            args[1], root, draws=int(args[2]) if len(args) > 2 else 10,
            a=float(args[3]) if len(args) > 3 else 0.5)))
