"""fanDuct's fan on jump cyclics in foamtpu_torch against the JAX package:
mesh/ami.py, the AMI tables of to_device, FvMatrix.ami_coef / ami_mul, the
coupled term of every linear-solver product, the jump-cyclic BC family
(cyclicAMI, fixedJump, fan: ami_values, jump_signed, _up_fan),
Case._retain_jump_cyclics, and the topoSet and createBaffles commands.

On the host (float32 tables built in float64, as both packages do):
fanDuct through each package's blockMesh, topoSet and createBaffles gives
the same polyMesh files and sets, and the same device mesh, AMI tables
included, to 0 ulp; so do tests/test_cyclicami.py's two meshes (a
planar non-conformal pair and a rotational annulus pair).

In float64 (one process, FOAMTPU_X64=1 JAX_ENABLE_X64=1): both packages'
`run(case)` take 3 pimpleFoam steps of fanDuct with its p solves
converged to 1e-11 (chip_smoke.SLICE11_CASES: the shipped GAMG, which an
AMI coupling turns into polynomial BiCGStab, stops at relTol 0.01, and
there turns round-off of 1e-21 into 2e-6 of p within a step in either
package): U, p and phi at rtol 1e-9, every solve's iteration count equal,
the log lines and the written files. In the same process, module by
module: tests/test_jumpcyclic.py's Poisson solves (fixedJump, a constant
fan) and fan update, tests/test_cyclicami.py's diffusion solves (planar
and rotational, and the planar one through GAMG controls, which dispatch
to polynomial BiCGStab), three PISO steps with MRF of its annulus mixer,
and the FvMatrix AMI algebra, each at rtol 1e-9 with equal iteration
counts.

Then the oracle of tests/test_fanduct.py through the port on the CPU (60
steps of the shipped tutorial: the fan blows +x and lifts the pressure
downstream).
"""

import os
import re

import numpy as np
import pytest
import torch

from foamtpu_torch.apps.cli import main as tcli
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.mesh.core import ARRAY_FIELDS

import chip_smoke
from test_torch_electromagnetics import assert_app_parity
from test_torch_ras_models import parity

torch.set_num_threads(2)

STEPS = 3
NUM = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")

MODULE_TAIL = r"""
import dataclasses
import test_cyclicami as TC
import test_jumpcyclic as TJ
from foamtpu.apps.meshutils3 import create_baffles as jcb
from foamtpu.bc import factory as jfac, patchfields as jpf
from foamtpu.core.dictionary import FoamDict as JFD, parse_string as jps
from foamtpu.core.dimensions import DimensionSet as JDS
from foamtpu.core.fields import vol_scalar as jvs, vol_vector as jvv
from foamtpu.mesh import blockmesh as jbm, to_device as jtd
from foamtpu.ops import fvm as jfvm
from foamtpu.solvers import linear as jlin
from foamtpu_torch.apps.meshutils3 import create_baffles as tcb
from foamtpu_torch.bc import factory as tfac, patchfields as tpf
from foamtpu_torch.core.dictionary import FoamDict as TFD, parse_string as tps
from foamtpu_torch.core.dimensions import DimensionSet as TDS
from foamtpu_torch.core.fields import vol_scalar as tvs, vol_vector as tvv
from foamtpu_torch.mesh import blockmesh as tbm, to_device as ttd
from foamtpu_torch.ops import fvm as tfvm
from foamtpu_torch.solvers import linear as tlin
import jax.numpy as jnp

res = {}


def rel(g, r):
    g = g.numpy() if hasattr(g, "numpy") else np.asarray(g)
    r = np.asarray(r)
    return float(np.abs(g - r).max() / max(np.abs(r).max(), 1e-300))


def duct(bm, cb, td, ps):
    pm = bm.generate(ps(TJ.DUCT))
    fids = np.nonzero(np.abs(pm.cf[:pm.n_internal_faces, 0] - 1.0)
                      < 1e-6)[0]
    pm = cb(pm, fids, "fan", "cyclic")
    patches = [dataclasses.replace(p, type="cyclicAMI")
               if p.name in ("fan_master", "fan_slave") else p
               for p in pm.patches]
    return td(dataclasses.replace(pm, patches=patches))


jm = duct(jbm, jcb, jtd, jps)
tm = duct(tbm, tcb, lambda pm: ttd(pm, "cpu"), tps)
PCG = {"solver": "PCG", "preconditioner": "diagonal", "tolerance": 1e-9,
       "relTol": 0.0, "maxIter": 500}


def jump_bcs(spec, constant=None):
    jb, tb = [], []
    for jp_, tp_ in zip(jm.patches, tm.patches):
        s = spec.get(jp_.name)
        if s is None:
            jb.append(jpf.zero_gradient())
            tb.append(tpf.zero_gradient())
            continue
        j = jfac.from_dict(JFD(s), jp_, 0, np.float64, mesh=jm)
        t = tfac.from_dict(TFD(s), tp_, 0, torch.float64, mesh=tm)
        if constant is not None and j.kind == "fan":
            j, t = j.replace(ref_value=constant), t.replace(
                ref_value=constant)
        jb.append(j)
        tb.append(t)
    return tuple(jb), tuple(tb)


def poisson(jb, tb):
    jp = jvs(jm, 0.0, name="p", dims=JDS.of(0, 2, -2), bcs=jb)
    tp = tvs(tm, 0.0, name="p", dims=TDS.of(0, 2, -2), bcs=tb)
    je = jfvm.laplacian(jm, jnp.ones(jm.n_faces, jm.v.dtype), jp,
                        corrected=False)
    te = tfvm.laplacian(tm, torch.ones(tm.n_faces, dtype=torch.float64), tp,
                        corrected=False)
    a, pa = jlin.solve(jm, je, jp.data, PCG)
    b, pb = tlin.solve(tm, te, tp.data, PCG)
    return a, b, pa, pb, je, te


x = np.asarray(jm.c)[:, 0]
J = TJ.JUMP
for name, spec, constant, exact in (
        ("fixedJump", {
            "left": [("type", "fixedValue"), ("value", ["uniform", 0.0])],
            "right": [("type", "fixedValue"), ("value", ["uniform", 1.0])],
            "fan_master": [("type", "fixedJump"), ("patchType", "cyclic"),
                           ("jump", ["uniform", J])],
            "fan_slave": [("type", "fixedJump"), ("patchType", "cyclic"),
                          ("jump", ["uniform", J])]}, None,
         np.where(x < 1.0, (1 - J) / 2 * x, (1 - J) / 2 * x + J)),
        ("fan", {
            "left": [("type", "fixedValue"), ("value", ["uniform", 0.0])],
            "right": [("type", "fixedValue"), ("value", ["uniform", 0.0])],
            "fan_master": [("type", "fan"), ("f", [J])],
            "fan_slave": [("type", "fan"), ("f", [J])]}, J,
         np.where(x < 1.0, -J * x / 2.0, -J * (x - 2.0) / 2.0))):
    jb, tb = jump_bcs(spec, constant)
    a, b, pa, pb, je, te = poisson(jb, tb)
    res["poisson_" + name] = {
        "rel": rel(b, a), "iters": [int(pb.n_iterations),
                                    int(pa.n_iterations)],
        "exact_err": float(np.abs(b.numpy() - exact).max()),
        "master": [[bc.opt("master") for bc in tb if bc.kind == name],
                   [bc.opt("master") for bc in jb if bc.kind == name]],
        "matrix": {k: rel(getattr(te, k), getattr(je, k))
                   for k in ("diag", "source", "ic", "bc", "ami_coef")}}

# the fan curve at a flow rate: jump(Q) = 1 - 2 Q, on both sides
spec = [("type", "fan"), ("patchType", "cyclic"), ("f", [1.0, -2.0])]
out_fan = {}
for pname in ("fan_master", "fan_slave"):
    jp_, tp_ = jm.patch(pname), tm.patch(pname)
    jbc = jfac.from_dict(JFD(spec), jp_, 0, np.float64, mesh=jm)
    tbc = tfac.from_dict(TFD(spec), tp_, 0, torch.float64, mesh=tm)
    area = float(np.asarray(jm.mag_sf)[jp_.slice].sum())
    phi = np.zeros(jm.n_faces)
    phi[jp_.slice] = 0.1 * np.asarray(jm.mag_sf)[jp_.slice] / area
    j2 = jpf.update(jbc, jm, jp_, jnp.zeros(jm.n_cells), phi=jnp.asarray(phi))
    t2 = tpf.update(tbc, tm, tp_, torch.zeros(tm.n_cells, dtype=torch.float64),
                    phi=torch.tensor(phi))
    out_fan[pname] = {"rel": rel(t2.ref_value, j2.ref_value),
                      "value": float(t2.ref_value[0]),
                      "master": [tbc.opt("master"), jbc.opt("master")]}
res["fan_update"] = out_fan

# tests/test_cyclicami.py: the planar pair and the rotational annulus
ANN = TC.ANNULUS.replace("{nt_r}", "6").replace("{nt_s}", "4")
for mname, text, fixed in (("two_block", TC.TWO_BLOCK,
                            {"leftIn": 0.0, "rightOut": 1.0}),
                           ("annulus", ANN,
                            {"innerWall": 0.0, "outerWall": 1.0})):
    jmm = jtd(jbm.generate(jps(text)))
    tmm = ttd(tbm.generate(tps(text)), "cpu")
    jb, tb = [], []
    for p in jmm.patches:
        if p.type == "empty":
            jb.append(jpf.PatchField(kind="empty", vfrac=0.0))
            tb.append(tpf.PatchField(kind="empty", vfrac=0.0))
        elif p.name in fixed:
            jb.append(jpf.fixed_value(fixed[p.name]))
            tb.append(tpf.fixed_value(fixed[p.name]))
        elif p.type == "cyclicAMI":
            jb.append(jpf.PatchField(kind="cyclicAMI", vfrac=0.0))
            tb.append(tpf.PatchField(kind="cyclicAMI", vfrac=0.0))
        else:
            jb.append(jpf.zero_gradient())
            tb.append(tpf.zero_gradient())
    jT = jvs(jmm, 0.0, name="T", bcs=tuple(jb))
    tT = tvs(tmm, 0.0, name="T", bcs=tuple(tb))
    je = -jfvm.laplacian(jmm, jnp.asarray(1.0, jmm.v.dtype), jT,
                         corrected=False)
    te = -tfvm.laplacian(tmm, torch.tensor(1.0, dtype=torch.float64), tT,
                         corrected=False)
    rec = {"matrix": {k: rel(getattr(te, k), getattr(je, k))
                      for k in ("diag", "source", "ic", "bc", "ami_coef")}}
    for cname, ctl in (
            ("bicgstab", {"solver": "PBiCGStab",
                          "preconditioner": "polynomial",
                          "tolerance": 1e-10, "relTol": 0.0,
                          "maxIter": 3000}),
            ("gamg", {"solver": "GAMG", "tolerance": 1e-10, "relTol": 0.0,
                      "maxIter": 3000})):
        a, pa = jlin.solve(jmm, je, jT.data, ctl)
        b, pb = tlin.solve(tmm, te, tT.data, ctl)
        rec[cname] = {"rel": rel(b, a), "iters": [int(pb.n_iterations),
                                                  int(pa.n_iterations)]}
    rng = np.random.default_rng(5)
    psi = rng.standard_normal(jmm.n_cells)
    psv = rng.standard_normal((jmm.n_cells, 3))
    jps_, tps_ = jnp.asarray(psi), torch.tensor(psi)
    alg = {
        "ami_mul": (te.ami_mul(tmm, tps_), je.ami_mul(jmm, jps_)),
        "ami_mul_vector": (te.ami_mul(tmm, torch.tensor(psv)),
                           je.ami_mul(jmm, jnp.asarray(psv))),
        "off_mul": (te.off_mul(tmm, tps_), je.off_mul(jmm, jps_)),
        "row_sum": (te.row_sum(tmm), je.row_sum(jmm)),
        "off_abs_sum": (te.off_abs_sum(tmm), je.off_abs_sum(jmm)),
        "flux": (te.flux(tmm, tps_), je.flux(jmm, jps_)),
        "H": (te.H(tmm, tps_), je.H(jmm, jps_)),
        "relax_diag": (te.relax(tmm, 0.7, tps_).diag,
                       je.relax(jmm, 0.7, jps_).diag),
        "sum_ami_coef": ((te + te).ami_coef, (je + je).ami_coef),
        "neg_ami_coef": ((-te).ami_coef, (-je).ami_coef),
        "ami_values": (tpf.ami_values(tmm, torch.tensor(psv)),
                       jpf.ami_values(jmm, jnp.asarray(psv))),
    }
    rec["algebra"] = {k: rel(g, r) for k, (g, r) in alg.items()}
    res[mname] = rec

# the annulus mixer of tests/test_cyclicami.py: 3 PISO steps with MRF
from foamtpu.models import mrf as jmrf
from foamtpu.solvers import piso as jpiso
from foamtpu_torch.models import mrf as tmrf
from foamtpu_torch.solvers import piso as tpiso

zones_text = ("rotor { selectionMode cylinder; origin (0 0 0); "
              "axis (0 0 1); radius 0.1; omega 10; }")
jmm = jtd(jbm.generate(jps(ANN)))
tmm = ttd(tbm.generate(tps(ANN)), "cpu")
states = []
for pkg, mesh, pf_, vs, vv, mrfm, piso, ps_ in (
        ("j", jmm, jpf, jvs, jvv, jmrf, jpiso, jps),
        ("t", tmm, tpf, tvs, tvv, tmrf, tpiso, tps)):
    zones = mrfm.from_dict(mesh, ps_(zones_text))
    ub, pb = [], []
    for p in mesh.patches:
        if p.type in ("empty", "cyclicAMI"):
            ub.append(pf_.PatchField(kind=p.type, vfrac=0.0))
            pb.append(pf_.PatchField(kind=p.type, vfrac=0.0))
        else:
            ub.append(pf_.fixed_value((0.0, 0.0, 0.0) if pkg == "t"
                                      else jnp.zeros(3)))
            pb.append(pf_.zero_gradient())
    U = vv(mesh, (0.0, 0.0, 0.0), name="U", bcs=tuple(ub))
    p = vs(mesh, 0.0, name="p", bcs=tuple(pb))
    cfg = piso.PisoConfig(
        nu=2e-3, n_correctors=2, mrf=zones,
        p_controls={"solver": "PBiCGStab", "preconditioner": "polynomial",
                    "tolerance": 1e-10, "relTol": 0.0, "maxIter": 2000},
        u_controls={"solver": "PBiCGStab", "tolerance": 1e-10,
                    "relTol": 0.0, "maxIter": 500})
    U = zones.correct_boundary_velocity(mesh, U)
    st = piso.initial_state(mesh, U, p)
    st = mrfm.make_relative_state(mesh, zones, st)
    iters = []
    for _ in range(3):
        st, dg = piso.piso_step(mesh, st, 5e-4, cfg)
        iters.append([int(dg["Ux"].n_iterations), int(dg["p_iters"])])
    states.append((st, iters, float(dg["continuity"])))
(js_, ji, jc_), (ts_, ti, tc_) = states
res["mixer"] = {"U": rel(ts_["U"].data, js_["U"].data),
                "p": rel(ts_["p"].data, js_["p"].data),
                "phi": rel(ts_["phi"], js_["phi"]),
                "iters": [ti, ji], "continuity": [tc_, jc_]}
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def runs():
    recs = parity("slice11", STEPS, ("fanDuct",), tail=MODULE_TAIL, lines=2,
                  env={"PYTHONPATH": os.path.dirname(__file__)})
    return recs[0]["fanDuct"], recs[1]


def test_fanduct_matches_reference_f64(runs):
    rec, _ = runs
    # the p solves converge to 1e-11, U to the shipped 1e-7
    assert_app_parity(rec, STEPS, "fanDuct", tight={"p": 1e-11,
                                                    "U": 1e-7})
    assert set(rec["errs"]) == {"U", "p", "phi"}


@pytest.mark.parametrize("name", ["fixedJump", "fan"])
def test_jump_poisson_matches_reference(runs, name):
    r = runs[1]["poisson_" + name]
    assert r["rel"] < 1e-9 and r["iters"][0] == r["iters"][1], r
    assert all(v < 1e-12 for v in r["matrix"].values()), r
    # the analytic piecewise-linear profile with its jump at x = 1
    assert r["exact_err"] < 2e-4, r
    assert r["master"][0] == r["master"][1] == [True, False], r


def test_fan_update_matches_reference(runs):
    r = runs[1]["fan_update"]
    # jump(0.1) = 1 - 2 (0.1) measured through the master side
    assert r["fan_master"]["rel"] < 1e-12
    assert abs(r["fan_master"]["value"] - 0.8) < 1e-12
    assert r["fan_master"]["master"] == [True, True]
    assert r["fan_slave"]["master"] == [False, False]
    assert r["fan_slave"]["rel"] < 1e-12


@pytest.mark.parametrize("mesh", ["two_block", "annulus"])
@pytest.mark.parametrize("solver", ["bicgstab", "gamg"])
def test_ami_diffusion_matches_reference(runs, mesh, solver):
    r = runs[1][mesh]
    assert all(v < 1e-12 for v in r["matrix"].values()), r["matrix"]
    s = r[solver]
    assert s["rel"] < 1e-9 and s["iters"][0] == s["iters"][1], s


@pytest.mark.parametrize("mesh", ["two_block", "annulus"])
def test_ami_matrix_algebra_matches_reference(runs, mesh):
    alg = runs[1][mesh]["algebra"]
    assert all(v < 1e-12 for v in alg.values()), alg


def test_ami_mixer_piso_matches_reference(runs):
    r = runs[1]["mixer"]
    assert r["iters"][0] == r["iters"][1], r
    assert max(r["U"], r["p"], r["phi"]) < 1e-9, r
    assert r["continuity"][0] < 1e-4


def _fan_duct(root, cli, tag):
    return chip_smoke.slice11_case(chip_smoke.REPO_DIR,
                                   os.path.join(root, tag), "fanDuct", cli)


def test_fanduct_mesh_matches_reference(tmp_path):
    """blockMesh, topoSet and createBaffles of both packages write the
    same polyMesh and set files; both Cases retain the fan pair as
    cyclicAMI patches and build the same device mesh, AMI tables
    included, to 0 ulp."""
    from foamtpu.apps.cli import main as jcli
    from foamtpu.core.case import Case as JCase

    td, jd = _fan_duct(str(tmp_path), tcli, "port"), _fan_duct(
        str(tmp_path), jcli, "ref")
    for rel in ("boundary", "faces", "owner", "neighbour", "points",
                "sets/fanFaces"):
        texts = []
        for d in (td, jd):
            with open(os.path.join(d, "constant", "polyMesh", rel)) as f:
                texts.append(f.read().split("*/", 1)[-1])
        # the same words and the same numbers (the writers format floats
        # differently: 0.1 against 0.10000000000000001)
        words = [NUM.sub("#", t).split() for t in texts]
        assert words[0] == words[1], rel
        assert [float(x) for x in NUM.findall(texts[0])] == \
            [float(x) for x in NUM.findall(texts[1])], rel
    tm, jm = TCase(td, device="cpu").mesh, JCase(jd).mesh
    assert tm.has_ami and jm.has_ami
    assert [(p.name, p.type, p.neighbour_patch) for p in tm.patches] == \
        [(p.name, p.type, p.neighbour_patch) for p in jm.patches]
    assert [p.type for p in tm.patches][-2:] == ["cyclicAMI"] * 2
    for k in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                      np.asarray(getattr(jm, k)), err_msg=k)


@pytest.mark.parametrize("mesh", ["two_block", "annulus"])
def test_cyclicami_mesh_matches_reference(mesh):
    from foamtpu.core.dictionary import parse_string as jparse
    from foamtpu.mesh import blockmesh as jbm
    from foamtpu.mesh import to_device as jtd
    from foamtpu_torch.core.dictionary import parse_string
    from foamtpu_torch.mesh import blockmesh, to_device

    import test_cyclicami as tc

    text = (tc.TWO_BLOCK if mesh == "two_block" else
            tc.ANNULUS.replace("{nt_r}", "6").replace("{nt_s}", "4"))
    tm = to_device(blockmesh.generate(parse_string(text)), "cpu")
    jm = jtd(jbm.generate(jparse(text)))
    assert tm.has_ami and jm.has_ami
    assert tm.ami_entry_w.shape[0] > 0
    for k in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                      np.asarray(getattr(jm, k)), err_msg=k)


def test_jump_bcs_retain_the_pair_and_others_internalise(tmp_path):
    """With its fan BCs fanDuct's baffle pair stays (cyclicAMI); with
    the fan replaced by plain cyclic BCs the pair is internalised as any
    cyclic pair is, as in the JAX package."""
    d = _fan_duct(str(tmp_path), tcli, "fan")
    assert TCase(d, device="cpu").mesh.has_ami
    path = os.path.join(d, "0", "p")
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text.replace("type fan; patchType cyclic; f ( 0.05 -1.0 );",
                             "type cyclic;"))
    mesh = TCase(d, device="cpu").mesh
    assert not mesh.has_ami
    assert all(p.type != "cyclic" for p in mesh.patches)


def test_fanduct_oracle_holds_on_the_cpu(tmp_path):
    rec, checks = chip_smoke.SLICE11_ORACLES["fanDuct"](str(tmp_path), tcli,
                                                        "cpu")
    assert all(checks.values()), (checks, rec)


def test_commands_are_registered():
    from foamtpu_torch.apps import cli

    assert {"topoSet", "createBaffles", "boxTurb"} <= set(cli.COMMANDS)
    # snappyHexMesh is ported since the snappyHexMesh and cht slice
    # (tests/test_torch_snappy.py), checkMesh since the utilities slice
    # (tests/test_torch_utilities.py); decomposePar is not
    assert "snappyHexMesh" in cli.COMMANDS and "checkMesh" in cli.COMMANDS
    # and run since the topology-change slice (tests/test_torch_case_run.py)
    assert cli.COMMANDS["run"] is cli.run
    with pytest.raises(NotImplementedError, match="decomposePar"):
        cli.main(["decomposePar", "-case", "."])
