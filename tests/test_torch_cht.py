"""Multi-region conjugate heat transfer in foamtpu_torch against the JAX
package: Case regions, the turbulentTemperatureCoupledBaffleMixed alias,
models/solidthermo.py and solvers/chtmultiregion.py (parse_regions,
match_interface, update_coupled_bcs, solid_step, chtMultiRegionFoam and
chtMultiRegionSimpleFoam through run(case)).

In this process: `Case(dir, region=...)` reads system/<region>/,
constant/<region>/ and 0/<region>/ as the reference's does and writes
<time>/<region>/, the top-level Case of heatedSlabs (no
constant/polyMesh) constructs; both coupled-baffle names map to `mixed`
while another unknown kind still raises; parse_regions gives the
reference's lists.

In float64 (one process, FOAMTPU_X64=1 JAX_ENABLE_X64=1), each at rtol
1e-12 unless said: every solid transport and thermo the reference parses
(the legacy flat form, constIso/hConst, constAnIso with and without a
coordinateSystem, exponential/hPower, polynomial/hPolynomial): the parsed
model, rho, cp, kappa, rho_cp and kappa_face (the anisotropic n.K.n on a
sheared mesh); match_interface's face maps, equal; update_coupled_bcs'
refValue and valueFraction on seeded fields; solid_step with a
variable-property model, transient and steady, at rtol 1e-9 with equal
PCG counts; heatedSlabs under chtMultiRegionFoam (40 steps) and
chtMultiRegionSimpleFoam (200 iterations) through both packages'
run(case): T of each region at rtol 1e-9, the same log lines with every
PCG count equal, and the written fields; a fluid region (hotCavity's
air) beside a solid one, 16 x 8 cells each, 3 chtMultiRegionFoam steps:
U, p_rgh and T of the fluid and T of the solid at rtol 1e-9, so the fluid
branch through buoyantrho is held.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from foamtpu_torch.bc import factory as tfac
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.core.dictionary import FoamDict as TFD
from foamtpu_torch.core.dictionary import parse_string as tps
from foamtpu_torch.solvers import chtmultiregion as tcht
from test_torch_simple import REPO

torch.set_num_threads(2)

SLABS = os.path.join(REPO, "tutorials", "heatTransfer", "chtMultiRegionFoam",
                     "heatedSlabs")


def test_case_regions_read_and_write_as_the_reference(tmp_path):
    from foamtpu.core.case import Case as JCase

    d = str(tmp_path / "slabs")
    shutil.copytree(SLABS, d)
    top = TCase(d, device="cpu")
    assert top.region == "" and top.application == "chtMultiRegionFoam"
    assert not os.path.exists(top.const_path("polyMesh"))
    for r in ("heater", "sink"):
        got, ref = TCase(d, device="cpu", region=r), JCase(d, region=r)
        assert got.sys_path("fvSolution") == ref.sys_path("fvSolution") \
            == os.path.join(d, "system", r, "fvSolution")
        assert got.const_path("polyMesh") == ref.const_path("polyMesh")
        assert got.fv_solution.subdict("solvers")["T"]["solver"] == "PCG"
        assert got.mesh.n_cells == ref.mesh.n_cells == 64
        tg, tr = got.read_field("T"), ref.read_field("T")
        assert np.array_equal(tg.data.numpy(), np.asarray(tr.data))
        assert [b.kind for b in tg.bcs] == [b.kind for b in tr.bcs]
        assert "mixed" in [b.kind for b in tg.bcs]
        got.write_fields([tg.with_data(tg.data + 1.0)], time_name="0.5")
        path = os.path.join(d, "0.5", r, "T")
        assert os.path.exists(path)
        back = ref.read_field("T", time="0.5")
        assert np.array_equal(np.asarray(back.data), tg.data.numpy() + 1.0)
        assert np.array_equal(
            TCase(d, device="cpu", region=r).read_field(
                "T", time="0.5").data.numpy(), np.asarray(back.data))


@pytest.mark.parametrize("kind", [
    "compressible::turbulentTemperatureCoupledBaffleMixed",
    "turbulentTemperatureCoupledBaffleMixed"])
def test_coupled_baffle_is_mixed_as_in_the_reference(kind):
    from foamtpu.bc import factory as jfac
    from foamtpu.core.dictionary import FoamDict as JFD

    class P:
        size = 4
        name = "heater_to_sink"
        neighbour_patch = None

    spec = [("type", kind), ("value", ["uniform", 350.0]), ("Tnbr", "T"),
            ("kappa", "solidThermo")]
    got = tfac.from_dict(TFD(spec), P, 0, torch.float64)
    ref = jfac.from_dict(JFD(spec), P, 0, np.float64)
    assert got.kind == ref.kind == "mixed"
    for k in ("ref_value", "ref_grad", "vfrac"):
        assert np.array_equal(np.asarray(getattr(got, k)),
                              np.asarray(getattr(ref, k))), k


def test_other_unknown_kinds_still_raise():
    class P:
        size = 4
        name = "w"
        neighbour_patch = None

    with pytest.raises(NotImplementedError, match="solidWallMixed"):
        tfac.from_dict(TFD([("type", "solidWallMixedTemperatureCoupled")]),
                       P, 0, torch.float64)


@pytest.mark.parametrize("text", [
    "regions ( solid (heater sink) );",
    "regions ( fluid (bottomAir topAir) solid (heater leftSolid) );",
    "regions ( solid (a) fluid (b c) solid (d) );",
    "regions ( fluid b );",
    "other 1;"])
def test_parse_regions_as_the_reference(text):
    from foamtpu.core.dictionary import parse_string as jps
    from foamtpu.solvers import chtmultiregion as jcht

    assert tcht.parse_regions(tps(text)) == jcht.parse_regions(jps(text))


F64_BODY = r"""
import contextlib, io, json, os, re, shutil, sys, tempfile
import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke
import jax.numpy as jnp
from foamtpu.core.case import run_case as jrun
from foamtpu.core.dictionary import parse_string as jps
from foamtpu.core.fields import vol_scalar as jvs
from foamtpu.core.dimensions import DimensionSet as JDS
from foamtpu.io import polymesh as jio
from foamtpu.mesh import blockmesh as jbm, to_device as jtd
from foamtpu.models import solidthermo as jst
from foamtpu.solvers import chtmultiregion as jcht
from foamtpu.bc import patchfields as jpf

from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.core.dictionary import parse_string as tps
from foamtpu_torch.core.fields import vol_scalar as tvs
from foamtpu_torch.core.dimensions import DimensionSet as TDS
from foamtpu_torch.mesh import blockmesh as tbm, to_device as ttd
from foamtpu_torch.models import solidthermo as tst
from foamtpu_torch.solvers import apps as tapps
from foamtpu_torch.solvers import chtmultiregion as tcht
from foamtpu_torch.bc import patchfields as tpf

root = tempfile.mkdtemp()
res = {}


def rel(g, r):
    g = g.numpy() if torch.is_tensor(g) else np.asarray(g, np.float64)
    r = np.asarray(r, np.float64)
    if g.shape != r.shape:
        return float("inf")
    return float(np.abs(g - r).max() / max(np.abs(r).max(), 1e-300))


def slabs(bm, ps, cells, names=("hot", "heater_to_sink", "sink_to_heater",
                                "cold"), shear=0.0):
    # chip_smoke.CHT_SLAB's two slabs; `shear` moves their top edge in x,
    # so that the faces are no longer axis-aligned (for n.K.n)
    txt = chip_smoke.CHT_SLAB.replace(
        "({x1} 1 0) ({x0} 1 0)", "({x1t} 1 0) ({x0t} 1 0)").replace(
        "({x1} 1 0.1) ({x0} 1 0.1)", "({x1t} 1 0.1) ({x0t} 1 0.1)")
    return [bm.generate(ps(txt.format(
        x0=x0, x1=x1, x0t=x0 + shear, x1t=x1 + shear, nx=cells[0],
        ny=cells[1], left=left, right=right)))
        for x0, x1, left, right in ((0.0, 0.5, names[0], names[1]),
                                    (0.5, 1.0, names[2], names[3]))]


# -- solidthermo: every transport and thermo the reference parses
THERMO = {
    "flat": "rho 1000; Cp 500; kappa 10;",
    "constIso": "thermoType { transport constIso; thermo hConst; } "
                "mixture { transport { kappa 45; } thermodynamics { Cp 460; }"
                " equationOfState { rho 7800; } }",
    "constAnIso": "thermoType { transport constAnIso; thermo hConst; } "
                  "mixture { transport { kappa (10 2 5); } "
                  "thermodynamics { Cp 460; } equationOfState { rho 7800; } }"
                  " coordinateSystem { coordinateRotation { e1 (1 1 0); "
                  "e2 (0 0 1); } }",
    "constAnIso_e3": "thermoType { transport constAnIso; thermo hConst; } "
                     "mixture { transport { kappa (10 2 5); } "
                     "thermodynamics { Cp 460; } equationOfState "
                     "{ rho 7800; } } coordinateSystem { coordinateRotation "
                     "{ e1 (2 1 0); e3 (0 0 1); } }",
    "constAnIso_axes": "thermoType { transport constAnIso; thermo hConst; } "
                       "mixture { transport { kappa (10 2 5); } }",
    "exponential": "thermoType { transport exponential; thermo hPower; } "
                   "mixture { transport { kappa0 40; Tref 300; n0 1.5; } "
                   "thermodynamics { C0 400; Tref 300; n0 0.5; } "
                   "equationOfState { rho 2700; } }",
    "polynomial": "thermoType { transport polynomial; thermo hPolynomial; } "
                  "mixture { transport { kappaCoeffs<8> (20 0.05 -1e-5 0 0 0"
                  " 0 0); } thermodynamics { CpCoeffs<8> (300 0.2 0 0 0 0 0"
                  " 0); } equationOfState { rho 2000; } }",
}
jm, _ = [jtd(p) for p in slabs(jbm, jps, (16, 4), shear=0.2)]
tm, _ = [ttd(p, "cpu") for p in slabs(tbm, tps, (16, 4), shear=0.2)]
rng = np.random.default_rng(7)
T_np = 300.0 + 100.0 * rng.random(jm.n_cells)
thermo = {}
for name, text in THERMO.items():
    j, t = jst.from_dict(jps(text)), tst.from_dict(tps(text))
    thermo[name] = (j, t)
    Tj, Tt = jnp.asarray(T_np), torch.tensor(T_np)
    rec = {"fields": [list(map(str, t)) == list(map(str, j))],
           "transport": [t.transport, j.transport],
           "thermo": [t.thermo, j.thermo]}
    for f in ("rho", "cp", "kappa", "rho_cp"):
        rec[f] = rel(getattr(t, f)(Tt), getattr(j, f)(Tj))
    rec["kappa_face"] = rel(t.kappa_face(tm, Tt), j.kappa_face(jm, Tj))
    res[f"solidthermo {name}"] = rec

# -- match_interface and update_coupled_bcs on the 16 x 4 slabs
jpa, jpb = [jtd(p) for p in slabs(jbm, jps, (16, 4))]
tpa, tpb = [ttd(p, "cpu") for p in slabs(tbm, tps, (16, 4))]
ji = jcht.match_interface(jpa, "heater_to_sink", jpb, "sink_to_heater",
                          "heater", "sink")
ti = tcht.match_interface(tpa, "heater_to_sink", tpb, "sink_to_heater",
                          "heater", "sink")
res["match_interface"] = {
    "equal": bool(np.array_equal(ti.a_to_b, ji.a_to_b)
                  and np.array_equal(ti.b_to_a, ji.b_to_a)
                  and ti[:4] == ji[:4]),
    "dtype": [str(ti.a_to_b.dtype), str(ji.a_to_b.dtype)]}

T_DIM = (0, 0, 0, 1)


def fields(mesh, vs, pf, hot, cold_fixed, data):
    bcs = []
    for p in mesh.patches:
        if p.type == "empty":
            bcs.append(pf.PatchField(kind="empty", vfrac=0.0))
        elif p.name in (hot, cold_fixed):
            bcs.append(pf.fixed_value(400.0 if p.name == "hot" else 300.0))
        elif "_to_" in p.name:
            bcs.append(pf.mixed(350.0, 0.0, 0.5))
        else:
            bcs.append(pf.zero_gradient())
    return bcs


def both_fields(seed):
    r = np.random.default_rng(seed)
    out = []
    for m_j, m_t, hot in ((jpa, tpa, "hot"), (jpb, tpb, "cold")):
        d = 350.0 + 10.0 * r.random(m_j.n_cells)
        fj = jvs(m_j, 350.0, name="T", dims=JDS.of(*T_DIM),
                 bcs=tuple(fields(m_j, jvs, jpf, hot, None, d)))
        ft = tvs(m_t, 350.0, name="T", dims=TDS.of(*T_DIM),
                 bcs=tuple(fields(m_t, tvs, tpf, hot, None, d)))
        out.append((fj.with_data(jnp.asarray(d)),
                    ft.with_data(torch.tensor(d))))
    return out


(ja, ta), (jb, tb) = both_fields(8)
ka = 10.0 + rng.random(jpa.n_cells)
kb = 1.0 + rng.random(jpb.n_cells)
Ja, Jb = jcht.update_coupled_bcs(jpa, ja, jnp.asarray(ka), jpb, jb,
                                 jnp.asarray(kb), ji)
Ta, Tb = tcht.update_coupled_bcs(tpa, ta, torch.tensor(ka), tpb, tb,
                                 torch.tensor(kb), ti)
rec = {}
for side, (g, r), mesh, pname in (("a", (Ta, Ja), tpa, "heater_to_sink"),
                                  ("b", (Tb, Jb), tpb, "sink_to_heater")):
    ip = [i for i, p in enumerate(mesh.patches) if p.name == pname][0]
    for k in ("ref_value", "vfrac", "ref_grad"):
        rec[f"{side} {k}"] = rel(getattr(g.bcs[ip], k),
                                 getattr(r.bcs[ip], k))
    rec[f"{side} kind"] = [g.bcs[ip].kind, r.bcs[ip].kind]
# and a scalar kappa, as the fluid side passes its constant
Ja, _ = jcht.update_coupled_bcs(jpa, ja, 10.0, jpb, jb, 1.0, ji)
Ta, _ = tcht.update_coupled_bcs(tpa, ta, 10.0, tpb, tb, 1.0, ti)
ip = [i for i, p in enumerate(tpa.patches) if p.name == "heater_to_sink"][0]
rec["scalar kappa vfrac"] = rel(Ta.bcs[ip].vfrac, Ja.bcs[ip].vfrac)
res["update_coupled_bcs"] = rec

# -- solid_step with a variable-property model, transient and steady
for steady in (False, True):
    j_, t_ = thermo["polynomial"]
    jc = jcht.SolidConfig(rho=2000.0, cp=300.0, kappa=20.0, steady=steady,
                          thermo=j_)
    tc = tcht.SolidConfig(rho=2000.0, cp=300.0, kappa=20.0, steady=steady,
                          thermo=t_)
    Jn, jp = jcht.solid_step(jpa, ja, ja.data, jnp.asarray(0.5), jc)
    Tn, tp = tcht.solid_step(tpa, ta, ta.data, torch.tensor(0.5), tc)
    res[f"solid_step steady={steady}"] = {
        "T": rel(Tn.data, Jn.data),
        "iterations": [int(tp.n_iterations), int(jp.n_iterations)]}

# -- heatedSlabs through run(case), both applications
SOLVE = re.compile(r"Solving for (\w+), Initial residual = (\S+), "
                   r"Final residual = (\S+), No Iterations (\d+)")


def app_parity(name, src, steps=None, regions=("heater", "sink"),
               fluid=()):
    out = {}
    runs = {}
    for tag in ("port", "ref"):
        d = os.path.join(root, name, tag)
        shutil.copytree(src, d)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if tag == "port":
                c = tapps.run(TCase(d, device="cpu"), max_steps=steps)
            else:
                c = jrun(d, max_steps=steps)
        fs = c.final_state
        a = {}
        for r in regions:
            if r in fluid:
                for k in ("U", "p_rgh", "T"):
                    a[f"{r}.{k}"] = fs[r]["state"][k].data
            else:
                a[f"{r}.T"] = fs[r]["T"].data
        a = {k: np.asarray(v.numpy() if torch.is_tensor(v) else v,
                           np.float64) for k, v in a.items()}
        text = buf.getvalue()
        written = {}
        for dp, _, files in os.walk(d):
            rel_dir = os.path.relpath(dp, d)
            if rel_dir.split(os.sep)[0] in ("0", "constant", "system"):
                continue
            for f in files:
                if re.match(r"^[0-9.e+-]+$", rel_dir.split(os.sep)[0]):
                    with open(os.path.join(dp, f)) as fh:
                        written[os.path.join(rel_dir, f)] = fh.read()
        runs[tag] = (a, SOLVE.findall(text), c.time.index, text, written)
    (ga, gs, gi, gt, gw), (ra, rs, ri, rt, rw) = runs["port"], runs["ref"]
    num = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")

    def numbers(text):
        return np.array([float(x) for x in num.findall(text)] or [0.0])

    other = lambda t: [num.sub("#", l) for l in t.splitlines()  # noqa
                       if l.strip() and not l.startswith("Solving")]
    wf = {}
    for k in sorted(set(gw) | set(rw)):
        if k in gw and k in rw:
            a_, b_ = numbers(gw[k]), numbers(rw[k])
            wf[k] = (rel(a_, b_) if a_.shape == b_.shape else float("inf"))
        else:
            wf[k] = None
    out.update({
        "steps": [gi, ri],
        "errs": {k: rel(ga[k], ra[k]) for k in ra},
        "solves": [[(n, int(i)) for n, _, _, i in gs],
                   [(n, int(i)) for n, _, _, i in rs]],
        "residuals": [[(float(x), float(y)) for _, x, y, _ in gs],
                      [(float(x), float(y)) for _, x, y, _ in rs]],
        "other_lines": [other(gt) == other(rt)],
        "written": wf})
    return out


for app in ("chtMultiRegionFoam", "chtMultiRegionSimpleFoam"):
    tut = "heatedSlabs" if app == "chtMultiRegionFoam" else \
        "heatedSlabsSimple"
    src = chip_smoke.slice12_case(os.getcwd(), os.path.join(root, app),
                                  tut, None, write_precision=17,
                                  write_interval=20)
    res[app] = app_parity(app, src)

# -- a fluid region (hotCavity's air) beside a solid, 16 x 8 cells each
src = os.path.join(root, "fluid_solid_src")
shutil.copytree(chip_smoke.slice12_case(
    os.getcwd(), os.path.join(root, "fs0"), "heatedSlabs", None), src)
shutil.rmtree(os.path.join(src, "constant"))
shutil.rmtree(os.path.join(src, "0"))
for sub in ("heater", "sink"):
    shutil.rmtree(os.path.join(src, "system", sub))
pf_, ps_ = slabs(jbm, jps, (16, 8), names=("hotWall", "fluid_to_solid",
                                           "solid_to_fluid", "cold"))
jio.write(pf_, os.path.join(src, "constant", "fluid", "polyMesh"))
jio.write(ps_, os.path.join(src, "constant", "solid", "polyMesh"))
hc = os.path.join(os.getcwd(), "tutorials", "heatTransfer",
                  "buoyantPimpleFoam", "hotCavity")
for r in ("fluid", "solid"):
    os.makedirs(os.path.join(src, "system", r))
    for f in ("fvSchemes", "fvSolution"):
        shutil.copy(os.path.join(SLABS_SYSTEM, f),
                    os.path.join(src, "system", r, f))
shutil.copy(os.path.join(hc, "constant", "thermophysicalProperties"),
            os.path.join(src, "constant", "fluid"))
shutil.copy(os.path.join(hc, "constant", "g"),
            os.path.join(src, "constant", "fluid"))
with open(os.path.join(src, "constant", "solid",
                       "thermophysicalProperties"), "w") as f:
    f.write(chip_smoke._foam_header("dictionary", "thermophysicalProperties")
            + "rho 1000;\nCp 500;\nkappa 1;\n")
with open(os.path.join(src, "constant", "regionProperties"), "w") as f:
    f.write(chip_smoke._foam_header("dictionary", "regionProperties")
            + "regions\n(\n    fluid (fluid)\n    solid (solid)\n);\n")
BC = {"T": {"hotWall": "type fixedValue; value uniform 330;",
            "fluid_to_solid": "type compressible::turbulentTemperature"
                              "CoupledBaffleMixed; value uniform 300; "
                              "Tnbr T; kappa fluidThermo;",
            "solid_to_fluid": "type compressible::turbulentTemperature"
                              "CoupledBaffleMixed; value uniform 300; "
                              "Tnbr T; kappa solidThermo;",
            "cold": "type fixedValue; value uniform 270;",
            "sides": "type zeroGradient;", "frontAndBack": "type empty;"},
      "U": {"*": "type fixedValue; value uniform (0 0 0);",
            "frontAndBack": "type empty;"},
      "p_rgh": {"*": "type zeroGradient;", "frontAndBack": "type empty;"}}
DIMS = {"T": "[0 0 0 1 0 0 0]", "U": "[0 1 -1 0 0 0 0]",
        "p_rgh": "[1 -1 -2 0 0 0 0]"}
for r, names, flds in (("fluid", ("hotWall", "fluid_to_solid"),
                        ("U", "p_rgh", "T")),
                       ("solid", ("solid_to_fluid", "cold"), ("T",))):
    os.makedirs(os.path.join(src, "0", r))
    for fld in flds:
        body = ""
        for p in names + ("sides", "frontAndBack"):
            spec = BC[fld].get(p, BC[fld].get("*"))
            body += f"    {p} {{ {spec} }}\n"
        val = {"T": "300", "U": "(0 0 0)", "p_rgh": "100000"}[fld]
        cls = "volVectorField" if fld == "U" else "volScalarField"
        with open(os.path.join(src, "0", r, fld), "w") as f:
            f.write(chip_smoke._foam_header(cls, fld)
                    + f"dimensions {DIMS[fld]};\ninternalField uniform "
                    f"{val};\nboundaryField\n{{\n{body}}}\n")
chip_smoke._edit(os.path.join(src, "system", "controlDict"),
                 r"deltaT\s+[^;]+;", "deltaT 0.05;")
res["fluid_solid"] = app_parity("fluid_solid", src, steps=3,
                                regions=("fluid", "solid"),
                                fluid=("fluid",))
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def f64_run():
    env = dict(os.environ)
    env.update(FOAMTPU_X64="1", JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu")
    body = F64_BODY.replace("SLABS_SYSTEM", repr(os.path.join(SLABS,
                                                              "system",
                                                              "heater")))
    r = subprocess.run([sys.executable, "-c", body], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["flat", "constIso", "constAnIso",
                                  "constAnIso_e3", "constAnIso_axes",
                                  "exponential", "polynomial"])
def test_solidthermo_matches_reference_f64(f64_run, name):
    rec = f64_run[f"solidthermo {name}"]
    assert rec["fields"] == [True], rec
    assert rec["transport"][0] == rec["transport"][1], rec
    assert rec["thermo"][0] == rec["thermo"][1], rec
    for k in ("rho", "cp", "kappa", "rho_cp", "kappa_face"):
        assert rec[k] <= 1e-12, (k, rec)


def test_match_interface_matches_reference(f64_run):
    rec = f64_run["match_interface"]
    assert rec["equal"], rec
    assert rec["dtype"] == ["int64", "int64"]


def test_update_coupled_bcs_matches_reference_f64(f64_run):
    rec = f64_run["update_coupled_bcs"]
    for k, v in rec.items():
        if k.endswith("kind"):
            assert v == ["mixed", "mixed"], (k, v)
        else:
            assert v <= 1e-12, (k, v)


@pytest.mark.parametrize("steady", [False, True])
def test_solid_step_matches_reference_f64(f64_run, steady):
    rec = f64_run[f"solid_step steady={steady}"]
    assert rec["T"] <= 1e-9, rec
    assert rec["iterations"][0] == rec["iterations"][1] > 0, rec


def assert_cht_parity(rec, steps):
    assert rec["steps"] == [steps, steps], rec["steps"]
    for k, e in rec["errs"].items():
        assert e <= 1e-9, (k, e)
    got, ref = rec["solves"]
    assert got == ref, (got, ref)
    assert np.allclose(rec["residuals"][0], rec["residuals"][1], rtol=1e-6,
                       atol=1e-12)
    assert rec["other_lines"] == [True]
    assert rec["written"], rec
    for k, e in rec["written"].items():
        assert e is not None and e <= 1e-9, (k, e)


@pytest.mark.parametrize("app,steps", [("chtMultiRegionFoam", 40),
                                       ("chtMultiRegionSimpleFoam", 200)])
def test_heatedslabs_matches_reference_f64(f64_run, app, steps):
    assert_cht_parity(f64_run[app], steps)


def test_fluid_beside_solid_matches_reference_f64(f64_run):
    rec = f64_run["fluid_solid"]
    assert set(rec["errs"]) == {"fluid.U", "fluid.p_rgh", "fluid.T",
                                "solid.T"}
    assert_cht_parity(rec, 3)
