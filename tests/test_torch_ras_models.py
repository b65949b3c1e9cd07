"""foamtpu_torch's RAS models of ras.py against the JAX package.

RNGkEpsilon, realizableKE, LaunderSharmaKE, kOmega, SpalartAllmaras,
SpalartAllmarasDES and SpalartAllmarasDDES, each from case files: the 2D
channel of tests/test_turbulence.py (30x10, U = 1 at the inlet, walls top
and bottom) written by chip_smoke.ras_channel_case for pisoFoam, one
model per case, each with the nut wall BC that chip_smoke's
RAS_CHANNEL_MODELS gives it (nutk, nutU, nutUSpalding, nutLowRe: the BC
kinds ported with the models). The start is well-posed: U and the
turbulence fields perturbed cell by cell from a numpy seed (on a uniform
field the limitedLinear limiter is a ratio of round-off).

In float64 (one subprocess per group, FOAMTPU_X64=1 JAX_ENABLE_X64=1) each
package's blockMesh meshes its own copy, `select` builds the model
through `_load_turbulence`, and each package's `run(case)` takes 3 steps:
the final U, p, phi and turbulence fields agree at rtol 1e-9 (atol 1e-9 of
each field's scale), every "Solving for" log line names the same field
with the same iteration count (residuals at rtol 1e-6, atol 1e-12), the
other log lines agree in their words and numbers (the execution and
clock times aside), and the written fields hold the same numbers. The
subprocess body (PARITY_BODY) serves the LES, channel and sampling tests
too.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from foamtpu_torch.apps.cli import main as tcli
from foamtpu_torch.bc import factory
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.core.dictionary import parse_string as tparse
from foamtpu_torch.models.turbulence import base as tbase

import chip_smoke
from test_torch_simple import REPO

torch.set_num_threads(2)

PARITY_BODY = r"""
import contextlib, io, json, os, re, shutil, sys, tempfile
import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from foamtpu.apps.cli import main as jcli
from foamtpu.core.case import run_case as jrun
from foamtpu_torch.apps.cli import main as tcli
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.solvers import apps as tapps

torch.set_num_threads(2)
# the JAX package's solver_line names a vector's three components only and
# raises at a symmetric tensor's six (ROADMAP Queue 3): its runs log
# through the port's, which names them as OpenFOAM does
import foamtpu.utils.logging as _jlog
from foamtpu_torch.utils.logging import solver_line as _solver_line
_jlog.solver_line = _solver_line
kind, steps, names = sys.argv[1], int(sys.argv[2]), sys.argv[3:]
# a name "kind:name" runs under its own kind
KIND = {None: kind}
for i, n in enumerate(names):
    if ":" in n:
        k, names[i] = n.split(":")
        KIND[names[i]] = k
NUM = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")
SAMPLE_FUNCS = '''
functions
{
    yp { type yPlus; }
    ypRAS { type yPlusRAS; patches (walls); }
    shear { type wallShearStress; }
    lines
    {
        type sets; fields (U p k nut);
        sets
        {
            across { type uniform; start (1.5 0 0.005);
                     end (1.5 0.1 0.005); nPoints 11; }
            dots { type cloud; points ((0.3 0.05 0.005) (1.7 0.02 0.005)); }
        }
    }
    tracks { type streamLine; lifeTime 40;
             seedSampleSet { type uniform; start (0.05 0.02 0.005);
                             end (0.05 0.08 0.005); nPoints 3; } }
}
'''


def make(tag, name, cli):
    dst = os.path.join(root, name, tag)
    kind = KIND.get(name, KIND[None])
    if kind == "ras":
        cs.ras_channel_case(dst, name, steps=steps)
    elif kind == "les":
        cs.les_channel_case(os.getcwd(), dst, name, blocks=(12, 8, 4),
                            steps=steps, funcs=cs.LES_FUNCS)
    elif kind == "channel395":
        cs.les_channel_case(os.getcwd(), dst, "Smagorinsky", steps=steps)
        # the tutorial's own endTime and writeInterval
        for key, val in (("endTime", "0.2"), ("writeInterval", "10")):
            path = os.path.join(dst, "system", "controlDict")
            text = re.sub(rf"{key}\s+[^;]+;", f"{key} {val};",
                          open(path).read())
            open(path, "w").write(text)
    elif kind == "boundary":
        shutil.copytree(os.path.join(os.getcwd(), cs.BOUNDARY_CASE), dst)
    elif kind == "sampling":
        cs.ras_channel_case(dst, "kOmega", steps=steps)
        with open(os.path.join(dst, "system", "controlDict"), "a") as f:
            f.write(SAMPLE_FUNCS)
    elif kind == "hotroom":
        # seeded, the PIMPLE tutorial with the Euler ddt
        return cs.hotroom_case(os.getcwd(), dst, cs.HOTROOM_APPS[name], cli,
                               seed=cs.HOTROOM_SEED, euler=name == "pimple",
                               write_precision=17)
    elif kind == "slice11":
        # the single-equation applications and fanDuct
        # (chip_smoke.SLICE11_CASES: seeded, coarsened where named)
        return cs.slice11_parity_case(
            os.getcwd(), dst, name, cli,
            device=("-device", "cpu") if cli is tcli else ())
    elif kind == "slice13":
        # the multiphase family (chip_smoke.SLICE13_CASES: seeded where a
        # vanLeer limiter meets a uniform start, converged p controls
        # where a relTol stop amplifies round-off)
        return cs.slice13_parity_case(
            os.getcwd(), dst, name, cli,
            device=("-device", "cpu") if cli is tcli else ())
    elif kind == "slice15":
        # radiation and the combustion family (chip_smoke.SLICE15_CASES:
        # seeded where a limiter meets a uniform start)
        return cs.slice15_parity_case(
            os.getcwd(), dst, name, cli,
            device=("-device", "cpu") if cli is tcli else ())
    elif kind == "slice16":
        # the topology-changing meshes and the engine family
        # (chip_smoke.slice16_case: its well-posed parity variants)
        return cs.slice16_case(os.getcwd(), dst, name, cli, parity=True)
    elif kind == "slice10":
        # the compressible family's tutorials and LTSInterFoam
        # (chip_smoke.SLICE10_CASES: seeded, coarsened where named)
        return cs.slice10_case(
            os.getcwd(), dst, name, cli,
            device=("-device", "cpu") if cli is tcli else ())
    elif kind in ("box", "interdym", "surfaces"):
        # oscillatingBox, damBreak with a dynamicMeshDict, the
        # cavity with a sampledSurfaces object
        return cs.SLICE9_CASES[kind](
            os.getcwd(), dst, cli,
            device=("-device", "cpu") if cli is tcli else ())
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli(["blockMesh", "-case", dst]) == 0
    return dst


# the fields of the single-equation applications' states
SLICE11_FIELDS = ("V", "psi", "H", "B", "pB", "phiB", "h", "hU", "D", "Ua",
                  "pa", "zeta", "rho")


def arrays(state, host):
    if isinstance(state.get("state"), dict):
        # potentialFreeSurfaceFoam and adjointShapeOptimizationFoam keep
        # {"state": ..., "diag": ...}
        state = state["state"]
    out = {n: host(getattr(state[n], "data", state[n]))
           for n in ("U", "p", "p_rgh", "T", "alpha") if n in state}
    if kind == "slice11":
        out.update({n: host(getattr(state[n], "data", state[n]))
                    for n in SLICE11_FIELDS if n in state})
    if kind == "slice13":
        # every field and array of the multiphase states (Ua, Ub, alphas,
        # alpha1, alpha2, p_abs, dgdt, phia, phib, phis, U{i}, ...)
        for n, v in state.items():
            if n not in out:
                out[n] = host(getattr(v, "data", v))
    if kind == "slice15":
        out.update(cs.slice15_arrays(state, host))
    if kind == "slice16":
        out.update(cs.slice16_arrays(state, host))
    if "rhoE" in state:
        # rhoCentralFoam's conservative state (its p is a plain array)
        out.update(rho=host(state["rho"].data), rhoU=host(state["rhoU"]),
                   rhoE=host(state["rhoE"]))
    if "phi" in state:
        # (electrostaticFoam's phi is the potential, a field)
        out["phi"] = host(getattr(state["phi"], "data", state["phi"]))
    for n, f in (state.get("turb") or {}).items():
        out[n] = host(f.data)
    if "gradP" in state:
        out["gradP"] = np.atleast_1d(host(state["gradP"]))
    return out


def close(a, b, rtol, atol):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return bool(a.shape == b.shape and np.allclose(a, b, rtol=rtol,
                                                   atol=atol))


def log_parts(text):
    solves, other = [], []
    for line in text.splitlines():
        if not line.strip() or line.startswith(("ExecutionTime",
                                                "Starting")):
            continue
        m = re.match(r"Solving for (\w+), Initial residual = (\S+), "
                     r"Final residual = (\S+), No Iterations (\d+)", line)
        if m:
            solves.append((m.group(1), float(m.group(2)),
                           float(m.group(3)), int(m.group(4))))
        else:
            other.append((NUM.sub("#", line),
                          [float(x) for x in NUM.findall(line)]))
    return solves, other


def numbers_of_dir(d):
    out = {}
    for dirpath, _, files in os.walk(d):
        for f in files:
            path = os.path.join(dirpath, f)
            out[os.path.relpath(path, d)] = [
                float(x) for x in NUM.findall(open(path).read())]
    return out


root = tempfile.mkdtemp()
out = {}
for name in names:
    jd, td = make("ref", name, jcli), make("port", name, tcli)
    with contextlib.redirect_stdout(io.StringIO()) as jlog:
        jc = jrun(jd, max_steps=steps)
    tc = TCase(td, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()) as tlog:
        assert tapps.run(tc, max_steps=steps) is tc
    assert tc.mesh.v.dtype == torch.float64
    rec = {"time": [tc.time.index, jc.time.index, tc.time.name,
                    jc.time.name], "errs": {}}
    ref = arrays(jc.final_state, np.asarray)
    got = arrays(tc.final_state, lambda t: t.numpy())
    rec["fields"] = [sorted(got), sorted(ref)]
    for n, r in ref.items():
        scale = float(np.abs(r).max())
        rec["errs"][n] = {"ok": close(got.get(n), r, 1e-9, 1e-9 * scale),
                          "max_abs": float(np.abs(got[n] - r).max()),
                          "scale": scale}
    js, jo = log_parts(jlog.getvalue())
    ts, to = log_parts(tlog.getvalue())
    rec["solves"] = [[(s[0], s[3]) for s in ts], [(s[0], s[3]) for s in js]]
    rec["residuals_ok"] = close([s[1:3] for s in ts], [s[1:3] for s in js],
                                1e-6, 1e-12)
    rec["residuals"] = [[s[1:3] for s in ts], [s[1:3] for s in js]]
    rec["other_lines"] = [[o[0] for o in to], [o[0] for o in jo]]
    rec["other_numbers_ok"] = all(
        close(a[1], b[1], 1e-6, 1e-12) for a, b in zip(to, jo))
    # the written fields, and any postProcessing files
    files = {}
    for sub in (tc.time.name, "postProcessing"):
        a, b = os.path.join(td, sub), os.path.join(jd, sub)
        if not os.path.isdir(b):
            continue
        na, nb = numbers_of_dir(a), numbers_of_dir(b)
        files[sub] = {"names": [sorted(na), sorted(nb)],
                      "ok": {f: close(na.get(f, []), nb[f], 1e-9, 1e-12)
                             for f in nb},
                      # the largest difference over the file's largest
                      # number (or inf when the counts differ)
                      "scaled": {f: float(np.abs(np.subtract(
                          na[f], nb[f])).max() / max(np.abs(nb[f]).max(),
                                                     1e-300))
                                 if len(na.get(f, [])) == len(nb[f])
                                 and nb[f] else
                                 (0.0 if na.get(f) == nb[f] else
                                  float("inf"))
                                 for f in nb}}
    rec["files"] = files
    if KIND.get(name, kind) == "les" and name == names[0]:
        # the test filter alone on seeded random fields of this mesh
        from foamtpu.models.turbulence.les2 import simple_filter as jfilt
        from foamtpu_torch.models.turbulence.les2 import simple_filter as tf
        rng = np.random.default_rng(7)
        errs = {}
        for shape in ((tc.mesh.n_cells,), (tc.mesh.n_cells, 3)):
            x = rng.standard_normal(shape)
            r = np.asarray(jfilt(jc.mesh, x))
            g = tf(tc.mesh, torch.tensor(x)).numpy()
            errs[str(len(shape))] = float(np.abs(g - r).max()
                                          / np.abs(r).max())
        rec["filter_rel_err"] = errs
    if KIND.get(name, kind) == "sampling":
        # the wall shear itself, from both packages, on the final state
        from foamtpu.functionobjects.sampling import _wall_shear as jws
        from foamtpu_torch.functionobjects.sampling import _wall_shear as tws
        r = jws(jc.mesh, jc.final_state, 1e-4)
        g = tws(tc.mesh, tc.final_state, 1e-4)
        rec["wall_shear"] = {p: {"ok": close(g[p].numpy(), np.asarray(r[p]),
                                             1e-9, 1e-15),
                                 "scale": float(np.abs(np.asarray(r[p])).max())}
                             for p in r}
    if KIND.get(name, kind) in ("sampling", "surfaces"):
        rec["fetches"] = tc.function_objects.fetches()
        rec["executes"] = tc.function_objects.executes
        rec["failures"] = tc.function_objects.failures
    out[name] = rec
print(json.dumps(out))
"""


def parity(kind, steps, names, timeout=600, env=None, tail="", lines=1):
    """Both packages' run(case) on `kind`'s case for each of `names` (a
    name "other:name" on the case of kind `other`), in float64, in a
    process of its own; the comparison record per name. `env` adds
    variables, `tail` code run after the body (each printing one JSON
    line), and `lines` > 1 returns the last `lines` records."""
    full = dict(os.environ)
    full.update(FOAMTPU_X64="1", JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu")
    full.update(env or {})
    r = subprocess.run([sys.executable, "-c", PARITY_BODY + tail, kind,
                        str(steps), *names], env=full, cwd=REPO,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    recs = [json.loads(x) for x in r.stdout.strip().splitlines()[-lines:]]
    return recs[0] if lines == 1 else recs


def assert_parity(rec, steps, what, files_scaled=False):
    """What every parity record must show (see the module docstring).
    With `files_scaled`, written numbers are held as the fields are: at
    1e-9 of the file's largest number."""
    assert rec["time"][0] == rec["time"][1] == steps, (what, rec["time"])
    assert rec["time"][2] == rec["time"][3], (what, rec["time"])
    assert rec["fields"][0] == rec["fields"][1], (what, rec["fields"])
    for name, e in rec["errs"].items():
        assert e["ok"], (what, name, e)
    assert rec["solves"][0] == rec["solves"][1], (what, rec["solves"])
    assert len(rec["solves"][0]) >= steps, (what, rec["solves"])
    assert rec["residuals_ok"], what
    assert rec["other_lines"][0] == rec["other_lines"][1], what
    assert rec["other_numbers_ok"], what
    assert rec["files"], what
    for sub, f in rec["files"].items():
        assert f["names"][0] == f["names"][1], (what, sub, f["names"])
        if files_scaled:
            bad = [n for n, e in f["scaled"].items() if not e <= 1e-9]
        else:
            bad = [n for n, ok in f["ok"].items() if not ok]
        assert not bad, (what, sub, bad)


STEPS = 3
# processes of 15-25 s each (the JAX package compiles each model's step,
# ~4-6 s)
GROUP_KE = ("RNGkEpsilon", "realizableKE")
GROUP_KO = ("LaunderSharmaKE", "kOmega")
GROUP_SA = ("SpalartAllmaras", "SpalartAllmarasDES", "SpalartAllmarasDDES")


@pytest.fixture(scope="module")
def ke_runs():
    return parity("ras", STEPS, GROUP_KE)


@pytest.fixture(scope="module")
def ko_runs():
    return parity("ras", STEPS, GROUP_KO)


@pytest.fixture(scope="module")
def sa_runs():
    return parity("ras", STEPS, GROUP_SA)


@pytest.mark.parametrize("model", GROUP_KE + GROUP_KO)
def test_ke_and_komega_models_match_reference_f64(request, model):
    runs = request.getfixturevalue("ke_runs" if model in GROUP_KE
                                   else "ko_runs")
    rec = runs[model]
    assert_parity(rec, STEPS, model)
    second = chip_smoke.RAS_CHANNEL_MODELS[model][0]
    # U, p, then the model's two transport solves, every step
    names = [n for n, _ in rec["solves"][0]]
    assert names.count(second) == names.count("k") == STEPS
    assert {"U", "p", "phi", "k", second, "nut"} == set(rec["errs"])


@pytest.mark.parametrize("model", GROUP_SA)
def test_spalart_allmaras_models_match_reference_f64(sa_runs, model):
    rec = sa_runs[model]
    assert_parity(rec, STEPS, model)
    names = [n for n, _ in rec["solves"][0]]
    assert names.count("nuTilda") == STEPS
    assert {"U", "p", "phi", "nuTilda", "nut"} == set(rec["errs"])


def _load(tmp_path, model, cli=tcli):
    d = chip_smoke.ras_channel_case(str(tmp_path / model), model, steps=1)
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli(["blockMesh", "-case", d]) == 0
    return d


@pytest.mark.parametrize("model", list(chip_smoke.RAS_CHANNEL_MODELS))
def test_select_builds_the_model_from_case_files(tmp_path, model):
    """`_load_turbulence` on the case files builds the model the
    reference builds, with the fields it reads and, for the
    Spalart-Allmaras family, the reference's wall distance (the DES length
    scale folded in) on the mesh's device."""
    from foamtpu.core.case import Case as JCase
    from foamtpu.solvers.apps import _load_turbulence as jload
    from foamtpu_torch.solvers.apps import _load_turbulence as tload

    d = _load(tmp_path, model)
    tc, jc = TCase(d, device="cpu"), JCase(d)
    tm, ts = tload(tc, chip_smoke.RAS_CHANNEL_NU)
    jm, js = jload(jc, chip_smoke.RAS_CHANNEL_NU)
    assert type(tm).__name__ == type(jm).__name__
    assert tm.name == model and sorted(ts) == sorted(js)
    assert tm.div_scheme == jm.div_scheme == "limitedLinear 1"
    for name in ts:
        assert [b.kind for b in ts[name].bcs] == \
            [b.kind for b in js[name].bcs], name
    if hasattr(jm, "y_wall"):
        assert tm.y_wall.dtype == tc.mesh.v.dtype
        np.testing.assert_array_equal(tm.y_wall.numpy(),
                                      np.asarray(jm.y_wall))
    if model == "SpalartAllmarasDDES":
        np.testing.assert_array_equal(tm._cdes_delta.numpy(),
                                      np.asarray(jm._cdes_delta))


def test_wall_function_updates_match_reference(tmp_path):
    """nutU and nutUSpalding on the same wall-cell velocities (float32, the
    tests' default): the wall nut of each package's update at rtol 1e-4
    (two libraries' float32 log and exp through the fixed-point and Newton
    sweeps; measured within 1e-5 here); nutLowRe is a fixed value of 0."""
    import jax.numpy as jnp
    from foamtpu.bc import derived2 as jderived2  # noqa: F401
    from foamtpu.bc import patchfields as jpf
    from foamtpu.core.case import Case as JCase
    from foamtpu.models.turbulence import ras as jras  # noqa: F401
    from foamtpu_torch.bc import patchfields as tpf
    from foamtpu_torch.models.turbulence import ras as tras  # noqa: F401

    d = _load(tmp_path, "realizableKE")
    tc, jc = TCase(d, device="cpu"), JCase(d)
    rng = np.random.default_rng(3)
    # wall-cell Reynolds numbers of 5e3-2e4: y+ in the log layer
    U = rng.standard_normal((tc.mesh.n_cells, 3)) * 5.0 + [20.0, 0.0, 0.0]
    wall = next(i for i, p in enumerate(tc.mesh.patches) if p.name == "walls")
    for kind in ("nutUWallFunction", "nutUSpaldingWallFunction"):
        tb = tpf.make(kind, ref_value=0.0, vfrac=1.0)
        jb = jpf.make(kind, ref_value=0.0, vfrac=1.0)
        got = tpf.update(tb, tc.mesh, tc.mesh.patches[wall], None,
                         U=torch.tensor(U, dtype=torch.float32),
                         nu=chip_smoke.RAS_CHANNEL_NU).ref_value
        ref = jpf.update(jb, jc.mesh, jc.mesh.patches[wall], None,
                         U=jnp.asarray(U, jnp.float32),
                         nu=chip_smoke.RAS_CHANNEL_NU).ref_value
        ref = np.asarray(ref)
        assert ref.min() > 0.5 * chip_smoke.RAS_CHANNEL_NU, kind
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                   err_msg=kind)
    spec = tparse("type nutLowReWallFunction; value uniform 0.3;")
    bc = factory.from_dict(spec, tc.mesh.patches[wall], 0, torch.float32)
    assert bc.kind == "fixedValue" and float(bc.ref_value) == 0.0


def test_unported_models_and_bc_kinds_raise(tmp_path):
    # every model of the JAX package is ported since the slice of
    # ras2.py to ras5.py, les3.py, les4.py and compressible2.py: a name
    # neither package registers raises ValueError, as the JAX package's
    # select does, and the message lists the models
    with pytest.raises(ValueError,
                       match="unknown turbulence model 'noSuchModel'") as e:
        tbase.select(tparse("RASModel noSuchModel; turbulence on;"), 1e-5)
    for name in list(chip_smoke.RAS_CHANNEL_MODELS) + list(
            chip_smoke.LES_MODELS) + ["kEpsilon", "kOmegaSST",
                                      "LamBremhorstKE"]:
        assert repr(name) in str(e.value), name
    d = _load(tmp_path, "kOmega")
    tc = TCase(d, device="cpu")
    # nutkRoughWallFunction is built since the boundary-condition slice
    # (tests/test_torch_bc_derived.py); a name the reference does not
    # map is refused
    spec = tparse("type nutkRoughWallFunction; value uniform 0;")
    bc = factory.from_dict(spec, tc.mesh.patches[0], 0, torch.float32)
    assert bc.kind == "nutkRoughWallFunction"
    with pytest.raises(NotImplementedError, match="nutkRoughnessWall"):
        factory.from_dict(tparse("type nutkRoughnessWallFunction; value "
                                 "uniform 0;"), tc.mesh.patches[0], 0,
                          torch.float32)
