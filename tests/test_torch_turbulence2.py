"""foamtpu_torch's turbulence models of ras2.py to ras5.py, les3.py and
les4.py against the JAX package.

- The twelve RAS models (LamBremhorstKE, qZeta, v2f, LRR,
  LaunderGibsonRSTM, kOmegaSSTSAS, NonlinearKEShih, LienCubicKE,
  LienCubicKELowRe, LienLeschzinerLowRe, SpalartAllmarasIDDES, kkLOmega)
  on the 2D channel of chip_smoke.ras_channel_case, each with the fields
  and wall BCs its family takes (chip_smoke.RAS2_CHANNEL_MODELS), and the
  six LES models (dynLagrangian, locDynOneEqEddy, dynMixedSmagorinsky,
  DeardorffDiffStress, LRDDiffStress, spectEddyVisc) on channel395 cut to
  12x8x4 by chip_smoke.les_channel_case (chip_smoke.LES2_MODELS), from
  seeded starts. In float64 (tests/test_torch_ras_models.py's
  PARITY_BODY, a process per group) each package's `run(case)` takes 3
  steps: fields at rtol 1e-9, every solve's iteration count equal, the
  log lines, written fields and postProcessing files the same.
- `ras._div_weights`, `ras2.symm_to_full` / `full_to_symm` and
  `les4._dev6` on seeded data against the JAX package's, to 1e-12.
- `select` takes every name the JAX package registers (47, 27 more than
  before this slice), and refuses an unknown one as the JAX package does.
- Two faults of the JAX package that the port's runs meet: its
  solver_line raises at the six components of an R or B solve (the port
  names them Rxx ... Rzz, and the parity processes log the JAX package's
  runs through the port's), and neither package reads a symmTensor
  field's fixedValue patch (ROADMAP Queue 3).
- The goldens of chip_smoke.py's turbulence_models2 phase (RAS2_GOLDEN,
  LES2_GOLDEN, COMP2_GOLDEN, TURB2_SPREAD) come from `reference_goldens2`:
  `JAX_PLATFORMS=cpu PYTHONPATH=.:tests python
  tests/test_torch_turbulence2.py goldens [--perturb]` (and with
  FOAMTPU_X64=1 JAX_ENABLE_X64=1); a test re-derives one of each table.
"""

import contextlib
import io
import json
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

from foamtpu_torch.apps.cli import main as tcli
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.core.dictionary import parse_string as tparse
from foamtpu_torch.models.turbulence import base as tbase
from foamtpu_torch.solvers import apps as tapps

import chip_smoke
from test_torch_ras_models import assert_parity, parity
from test_torch_simple import REPO

torch.set_num_threads(2)

STEPS = 3
RAS_GROUPS = (("LamBremhorstKE", "qZeta", "v2f", "LRR"),
              ("LaunderGibsonRSTM", "kOmegaSSTSAS", "NonlinearKEShih",
               "LienCubicKE"),
              ("LienCubicKELowRe", "LienLeschzinerLowRe",
               "SpalartAllmarasIDDES", "kkLOmega"))
LES_GROUPS = (("dynLagrangian", "locDynOneEqEddy", "dynMixedSmagorinsky"),
              ("DeardorffDiffStress", "LRDDiffStress", "spectEddyVisc"))
assert sum(RAS_GROUPS, ()) == tuple(chip_smoke.RAS2_CHANNEL_MODELS)
assert sum(LES_GROUPS, ()) == tuple(chip_smoke.LES2_MODELS)

# the fields each family's case carries, and the solves each step logs
# (the applications log the model's field_names but the last: qZeta
# solves q and zeta, and dynLagrangian's fmm is its last name, so neither
# package logs those; spectEddyVisc and dynMixedSmagorinsky solve nothing)
RAS_FIELDS = {"lowRe": {"k", "epsilon"}, "v2f": {"k", "epsilon", "v2", "f"},
              "stress": {"R", "k", "epsilon"}, "omega": {"k", "omega"},
              "nuTilda": {"nuTilda"}, "kkL": {"kt", "kl", "omega"}}
SIX = tuple("R" + c for c in ("xx", "xy", "xz", "yy", "yz", "zz"))
RAS_SOLVES = {"lowRe": ("k", "epsilon"), "v2f": ("k", "epsilon", "v2", "f"),
              "stress": SIX + ("epsilon",), "omega": ("k", "omega"),
              "nuTilda": ("nuTilda",), "kkL": ("kt", "kl", "omega")}
LES_SOLVES = {"dynLagrangian": ("flm",), "locDynOneEqEddy": ("k",),
              "dynMixedSmagorinsky": (),
              "DeardorffDiffStress": tuple("B" + s[1:] for s in SIX),
              "LRDDiffStress": tuple("B" + s[1:] for s in SIX),
              "spectEddyVisc": ()}

# the helpers on seeded data, in the first RAS group's process
HELPERS_TAIL = r"""
from foamtpu.models.turbulence import les4 as jles4, ras as jras
from foamtpu.models.turbulence import ras2 as jras2
from foamtpu_torch.models.turbulence import les4 as tles4, ras as tras
from foamtpu_torch.models.turbulence import ras2 as tras2
rng = np.random.default_rng(12)
errs = {}
R6 = rng.standard_normal((tc.mesh.n_cells, 6))
full = np.asarray(jras2.symm_to_full(R6))
tfull = tras2.symm_to_full(torch.tensor(R6)).numpy()
errs["symm_to_full"] = float(np.abs(tfull - full).max())
errs["round_trip"] = float(np.abs(
    tras2.full_to_symm(tras2.symm_to_full(torch.tensor(R6))).numpy()
    - R6).max())
T = rng.standard_normal((tc.mesh.n_cells, 3, 3))
T = T + np.transpose(T, (0, 2, 1))
errs["full_to_symm"] = float(np.abs(
    tras2.full_to_symm(torch.tensor(T)).numpy()
    - np.asarray(jras2.full_to_symm(T))).max())
errs["dev6"] = float(np.abs(tles4._dev6(torch.tensor(R6)).numpy()
                            - np.asarray(jles4._dev6(R6))).max())
errs["dev6_trace"] = float(np.abs(
    tles4._dev6(torch.tensor(R6)).numpy()[:, [0, 3, 5]].sum(1)).max())
phi_t = tc.final_state["phi"]
phi_j = np.asarray(jc.final_state["phi"])
k_t = tc.final_state["turb"]["k"]
k_j = jc.final_state["turb"]["k"]
errs["div_weights"] = float(np.abs(
    tras._div_weights(tc.mesh, phi_t, k_t).numpy()
    - np.asarray(jras._div_weights(jc.mesh, phi_j, k_j))).max())
errs["div_weights_limitedLinear"] = float(np.abs(
    tras._div_weights(tc.mesh, phi_t, k_t, "limitedLinear 1").numpy()
    - np.asarray(jras._div_weights(jc.mesh, phi_j, k_j,
                                   "limitedLinear 1"))).max())
print(json.dumps(errs))
"""


@pytest.fixture(scope="module")
def ras_runs():
    """The three RAS groups, each in a process of its own; the first also
    runs HELPERS_TAIL on its last case."""
    out = {}
    for i, group in enumerate(RAS_GROUPS):
        if i == 0:
            rec, helpers = parity("ras", STEPS, group, tail=HELPERS_TAIL,
                                  lines=2)
            out.update(rec)
            out["_helpers"] = helpers
        else:
            out.update(parity("ras", STEPS, group))
    return out


@pytest.fixture(scope="module")
def les_runs():
    out = {}
    for group in LES_GROUPS:
        out.update(parity("les", STEPS, group))
    return out


@pytest.mark.parametrize("model", list(chip_smoke.RAS2_CHANNEL_MODELS))
def test_ras2_models_match_reference_f64(ras_runs, model):
    rec = ras_runs[model]
    family = chip_smoke.RAS2_CHANNEL_MODELS[model][0]
    assert_parity(rec, STEPS, model, files_scaled=True)
    assert set(rec["errs"]) == {"U", "p", "phi", "nut"} | RAS_FIELDS[family]
    names = [n for n, _ in rec["solves"][0]]
    expected = () if model == "qZeta" else RAS_SOLVES[family]
    for n in expected:
        assert names.count(n) == STEPS, (model, n, names)
    assert len(names) == STEPS * (len(expected) + 4), names  # Ux Uy Uz p


@pytest.mark.parametrize("model", list(chip_smoke.LES2_MODELS))
def test_les2_models_match_reference_f64(les_runs, model):
    rec = les_runs[model]
    assert_parity(rec, STEPS, model, files_scaled=True)
    carried = set(chip_smoke.LES2_MODELS[model])
    assert set(rec["errs"]) == {"U", "p", "phi", "nut"} | carried
    names = [n for n, _ in rec["solves"][0]]
    for n in LES_SOLVES[model]:
        assert names.count(n) == STEPS, (model, n, names)
    post = rec["files"]["postProcessing"]
    assert post["names"][0] == ["shear1/wallShearStress.dat",
                                "yPlus1/yPlus.dat"]


@pytest.mark.parametrize("name,tol", [
    ("symm_to_full", 1e-12), ("round_trip", 1e-12), ("full_to_symm", 1e-12),
    ("dev6", 1e-12), ("dev6_trace", 1e-12), ("div_weights", 1e-12),
    # limitedLinear's limiter is a ratio of gradient differences: at the
    # fields' parity tolerance (measured 5.8e-12)
    ("div_weights_limitedLinear", 1e-9)])
def test_helpers_match_reference_f64(ras_runs, name, tol):
    """The helpers on seeded data, and `_div_weights` on LRR's final k
    and flux, against the JAX package's (absolute, O(1) values)."""
    assert ras_runs["_helpers"][name] <= tol, ras_runs["_helpers"]


def test_select_takes_every_reference_model():
    """The port's registry is the JAX package's: 47 names, the 27 of this
    slice among them; an unregistered name raises ValueError listing the
    models, in both packages."""
    from foamtpu.core.dictionary import parse_string as jparse
    from foamtpu.models.turbulence import base as jbase

    tbase.select(tparse("RASModel kEpsilon;"), 1e-5)
    jbase.select(jparse("RASModel kEpsilon;"), 1e-5)
    assert sorted(tbase._REGISTRY) == sorted(jbase._REGISTRY)
    assert len(tbase._REGISTRY) == 47
    new = (set(chip_smoke.RAS2_CHANNEL_MODELS) | set(chip_smoke.LES2_MODELS)
           | {f"compressible::{m}" for m in chip_smoke.COMP2_MODELS})
    assert len(new) == 27 and new <= set(tbase._REGISTRY)
    for sel, parse in ((tbase.select, tparse), (jbase.select, jparse)):
        with pytest.raises(ValueError, match="unknown turbulence model "
                           "'noSuchModel'.*kkLOmega"):
            sel(parse("RASModel noSuchModel;"), 1e-5)


@pytest.mark.parametrize("model", list(chip_smoke.RAS2_CHANNEL_MODELS)
                         + list(chip_smoke.LES2_MODELS))
def test_load_turbulence_builds_the_model_from_case_files(tmp_path, model):
    """`_load_turbulence` builds the model the JAX package builds, with
    the fields it reads (R and B as [n, 6]) and, where the model reads
    it, the JAX package's wall distance on the mesh's device."""
    from foamtpu.core.case import Case as JCase
    from foamtpu.solvers.apps import _load_turbulence as jload
    from foamtpu_torch.solvers.apps import _load_turbulence as tload

    d = str(tmp_path / model)
    if model in chip_smoke.RAS2_CHANNEL_MODELS:
        chip_smoke.ras_channel_case(d, model, steps=1)
        nu = chip_smoke.RAS_CHANNEL_NU
    else:
        chip_smoke.les_channel_case(REPO, d, model, blocks=(6, 4, 2),
                                    steps=1)
        nu = 2e-5
    with contextlib.redirect_stdout(io.StringIO()):
        assert tcli(["blockMesh", "-case", d]) == 0
    tc = TCase(d, device="cpu")
    tm, ts = tload(tc, nu)
    jm, js = jload(JCase(d), nu)
    assert type(tm).__name__ == type(jm).__name__ and tm.name == model
    assert sorted(ts) == sorted(js) == sorted(tm.field_names)
    for name, f in ts.items():
        assert tuple(f.data.shape) == tuple(np.asarray(js[name].data).shape)
        assert [b.kind for b in f.bcs] == [b.kind for b in js[name].bcs]
    for name in ("R", "B"):
        if name in ts:
            assert tuple(ts[name].data.shape) == (tc.mesh.n_cells, 6)
    if getattr(jm, "y_wall", None) is not None:
        assert tm.y_wall.dtype == tc.mesh.v.dtype
        np.testing.assert_array_equal(tm.y_wall.numpy(),
                                      np.asarray(jm.y_wall))


def test_solver_line_names_the_six_components():
    """The port logs a symmetric tensor's solve component by component;
    the JAX package's solver_line raises there (ROADMAP Queue 3), which is
    why the parity processes log its runs through the port's."""
    from foamtpu.utils import logging as jlog
    from foamtpu_torch.utils import logging as tlog

    class Perf:
        initial_residual = np.arange(6) * 0.1
        final_residual = np.arange(6) * 0.01
        n_iterations = np.array([2, 3, 3, 2, 2, 2])

    lines = tlog.solver_line("R", Perf).splitlines()
    assert [x.split(",")[0] for x in lines] == [
        f"Solving for {n}" for n in SIX]
    assert lines[3] == ("Solving for Ryy, Initial residual = 0.3, "
                        "Final residual = 0.03, No Iterations 3")
    with pytest.raises(IndexError):
        jlog.solver_line("R", Perf)
    # three components as before, in both packages
    Perf.initial_residual = Perf.initial_residual[:3]
    Perf.final_residual = Perf.final_residual[:3]
    assert tlog.solver_line("U", Perf) == jlog.solver_line("U", Perf)


def test_symm_tensor_fixed_value_patch_is_refused_as_the_reference(
        tmp_path):
    """A volSymmTensorField whose patch is fixedValue: both packages read
    the field as rank 0 and fail to broadcast the patch's six values
    (ROADMAP Queue 3); the cases give R and B zeroGradient inlets."""
    from foamtpu.core.case import Case as JCase

    d = chip_smoke.ras_channel_case(str(tmp_path / "LRR"), "LRR", steps=1)
    with contextlib.redirect_stdout(io.StringIO()):
        assert tcli(["blockMesh", "-case", d]) == 0
    assert TCase(d, device="cpu").read_field("R").data.shape == (300, 6)
    R0 = np.zeros((10, 6))
    R0[:, [0, 3, 5]] = 0.002
    path = os.path.join(d, "0", "R")
    text = open(path).read().replace(
        "inlet { type zeroGradient; }", "inlet { type fixedValue; value "
        + chip_smoke.field_values(R0, "symmTensor") + "; }")
    open(path, "w").write(text)
    with pytest.raises(RuntimeError, match="expand"):
        TCase(d, device="cpu").read_field("R")
    with pytest.raises(ValueError, match="broadcast"):
        JCase(d).read_field("R")


def test_writer_writes_a_large_symm_tensor_field(tmp_path):
    """A field of six components over 20,001 cells in ascii: the port
    writes it as a volSymmTensorField that both packages read back; the
    JAX package's writer labels it a vector and formats three columns, and
    raises (ROADMAP Queue 3: diffstress_headline's B is 786,432 cells)."""
    from foamtpu.core.fields import VolField as JField
    from foamtpu.io import fields as jfields
    from foamtpu_torch.core.fields import VolField as TField
    from foamtpu_torch.io import fields as tfields

    class Mesh:
        patches = ()

    n = 20001
    R = np.random.default_rng(5).standard_normal((n, 6))
    tfields.write_field(TField(data=torch.tensor(R), bcs=(), name="R"),
                        Mesh, str(tmp_path), "0")
    text = open(tmp_path / "0" / "R").read()
    assert "class       volSymmTensorField;" in text
    assert f"List<symmTensor>\n{n}\n(" in text
    from foamtpu_torch.bc import factory

    d = tfields.load_field_dict(str(tmp_path / "0" / "R"))
    got = factory.parse_value(d["internalField"], n, 0, torch.float64)
    np.testing.assert_array_equal(got.numpy(), R)
    with pytest.raises(ValueError):
        jfields.write_field(JField(data=R, bcs=(), name="R"), Mesh,
                            str(tmp_path / "jax"), "0")


# -- the goldens of chip_smoke.py's turbulence_models2 phase -------------


def reference_goldens2(root, names=None, perturb=0.0, port=False):
    """The golden scalars (chip_smoke.turb2_run_scalars) of the 27 runs of
    turbulence_models2 from the JAX package's run_case on the CPU, in the
    precision the environment gives it (float32; FOAMTPU_X64=1
    JAX_ENABLE_X64=1 for float64); `names` limits them ("kind/model").
    `perturb` multiplies the start's U cell by cell by 1 + perturb u, u
    from a numpy seed. Its R and B solves log through the port's
    solver_line (the JAX package's raises there). With `port`, the same
    runs through the port's run(case) on the CPU in float32: another
    summation order, as the card's."""
    import foamtpu.utils.logging as jlog
    from foamtpu.apps.cli import main as jcli
    from foamtpu.core.case import Case as JCase
    from foamtpu.core.case import run_case as jrun
    from foamtpu_torch.utils.logging import solver_line

    jlog.solver_line = solver_line
    device = ()
    if port:
        device = ("-device", "cpu")

        def jcli(argv):  # noqa: F811
            return tcli(list(argv) + (list(device) if argv[0] != "blockMesh"
                                      else []))

        def jrun(d, max_steps):  # noqa: F811
            case = TCase(d, device="cpu")
            tapps.run(case, max_steps=max_steps)
            return case
    cs = chip_smoke
    runs = ([("ras", m) for m in cs.RAS2_CHANNEL_MODELS]
            + [("les", m) for m in cs.LES2_MODELS]
            + [("comp", m) for m in cs.COMP2_MODELS])
    out = {"ras": {}, "les": {}, "comp": {}}
    for kind, model in runs:
        if names is not None and f"{kind}/{model}" not in names:
            continue
        d = os.path.join(str(root), kind, model)
        if kind == "ras":
            steps = cs.RAS2_DEPTH.get(model, cs.RAS2_STEPS)
            cs.ras_channel_case(d, model, steps=steps,
                                p_solver=cs.RAS_CHANNEL_CARD_P)
        elif kind == "les":
            cs.les_channel_case(REPO, d, model, steps=cs.LES2_STEPS,
                                funcs=cs.LES_FUNCS)
            steps = cs.LES2_STEPS
        else:
            cs.comp2_case(REPO, d, model, jcli, device=device)
            steps = cs.COMP2_STEPS
        with contextlib.redirect_stdout(io.StringIO()):
            if kind != "comp":
                assert jcli(["blockMesh", "-case", d]) == 0
            if perturb:
                x = np.asarray(JCase(d).read_field("U").data, np.float64)
                u = np.random.default_rng(21).random(x.shape[0])
                cs.set_internal(d, "U", x * (1.0 + perturb * u[:, None]))
            jc = jrun(d, max_steps=steps)
        host = ((lambda t: t.double().numpy()) if port else np.asarray)
        out[kind][model] = cs.turb2_run_scalars(
            kind, jc.final_state, host(jc.mesh.v), d, host)
    return out


def golden_spread(f32, others):
    """TURB2_SPREAD from reference_goldens2's JSON: per scalar the largest
    |f32 - other| over the other runs (float64, the perturbed start, the
    port on the CPU), over max(|f32|, the floor), to 3 digits."""
    floor = dict(chip_smoke.COMP_FLOOR, **chip_smoke.TURB2_FLOOR)
    out = {}
    for kind, runs in f32.items():
        out[kind] = {}
        for model, sc in runs.items():
            out[kind][model] = {
                k: float("%.3g" % (max(abs(v - o[kind][model][k])
                                       for o in others)
                                   / max(abs(v), floor.get(k, 0.0))))
                for k, v in sc.items()}
    return out


@pytest.mark.parametrize("run", ["ras/LRR", "les/DeardorffDiffStress",
                                 "comp/LaunderGibsonRSTM"])
def test_goldens_come_from_the_reference(tmp_path, run):
    """One golden of each table re-derived from the JAX package (float32,
    CPU), within 1e-4 (another CPU's vector width; 0 measured here)."""
    kind, model = run.split("/")
    got = reference_goldens2(tmp_path, names=(run,))[kind][model]
    table = {"ras": chip_smoke.RAS2_GOLDEN, "les": chip_smoke.LES2_GOLDEN,
             "comp": chip_smoke.COMP2_GOLDEN}[kind]
    floor = dict(chip_smoke.COMP_FLOOR, **chip_smoke.TURB2_FLOOR)
    rel = chip_smoke.golden_rel_err(got, table[model], floor)
    assert set(got) == set(table[model])
    assert max(rel.values()) <= 1e-4, rel


if __name__ == "__main__":
    # python tests/test_torch_turbulence2.py goldens [--perturb] [run ...]:
    # the JSON of reference_goldens2 (the environment sets float32 or
    # float64; --perturb perturbs the start by 1e-7)
    # python tests/test_torch_turbulence2.py goldens --port: the port's
    # float32 CPU runs; ... spread F32 OTHER...: TURB2_SPREAD from those
    # JSON files
    if len(sys.argv) > 1 and sys.argv[1] == "goldens":
        args = sys.argv[2:]
        eps = 1e-7 if "--perturb" in args else 0.0
        names = [a for a in args if a not in ("--perturb", "--port")]
        print(json.dumps(reference_goldens2(tempfile.mkdtemp(),
                                            names or None, perturb=eps,
                                            port="--port" in args)))
    if len(sys.argv) > 1 and sys.argv[1] == "spread":
        f32, *others = (json.load(open(f)) for f in sys.argv[2:])
        print(json.dumps(golden_spread(f32, others)))


def rehearse_diffstress(steps=12):
    """diffstress_headline's run rehearsed in the JAX package on the CPU
    (float32): channel395 under DeardorffDiffStress at its shipped block
    (24x16x8) and at 12x8x4 (chip_smoke.diffstress_case, U seeded by
    numpy), `steps` steps of the shipped deltaT (the headline's 2 + 3x3 +
    1): per step the continuity error and max |U|; at the end B's smallest
    normal component and k against tr(B)/2."""
    import re

    import foamtpu.utils.logging as jlog
    from foamtpu.core.case import run_case as jrun
    from foamtpu_torch.utils.logging import solver_line

    jlog.solver_line = solver_line
    out = {}
    for blocks in ((24, 16, 8), (12, 8, 4)):
        d = chip_smoke.diffstress_case(REPO, tempfile.mkdtemp(), blocks,
                                       seed=395)
        with contextlib.redirect_stdout(io.StringIO()) as log:
            jc = jrun(d, max_steps=steps)
        text = log.getvalue()
        st = jc.final_state
        B = np.asarray(st["turb"]["B"].data, np.float64)
        k = np.asarray(st["turb"]["k"].data, np.float64)
        out["{}x{}x{}".format(*blocks)] = {
            "steps": jc.time.index,
            "continuity_per_step": [float(x) / 0.02 for x in re.findall(
                r"continuity errors : sum local = (\S+),", text)],
            "u_max": float(np.linalg.norm(np.asarray(st["U"].data),
                                          axis=1).max()),
            "B_normal_min": float(B[:, [0, 3, 5]].min()),
            "k_vs_half_trace": float(np.abs(
                k - 0.5 * B[:, [0, 3, 5]].sum(1)).max() / k.max()),
            "B_iterations": [int(m) for m in re.findall(
                r"Solving for Bxx, .*No Iterations (\d+)", text)],
            "finite": bool(all(np.isfinite(np.asarray(f.data)).all()
                               for f in st["turb"].values()))}
    return out


if __name__ == "__main__" and sys.argv[1:2] == ["rehearse"]:
    # python tests/test_torch_turbulence2.py rehearse
    print(json.dumps(rehearse_diffstress(), indent=1))
