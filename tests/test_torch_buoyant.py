"""foamtpu_torch's buoyantBoussinesq{Simple,Pimple}Foam against the JAX
package.

In float64 (one subprocess, FOAMTPU_X64=1 JAX_ENABLE_X64=1, FOAMTPU_CHUNK=1
so that every iteration logs its solves) both packages' `run(case)` take 3
SIMPLE iterations and 3 PIMPLE steps of the hotRoom tutorials (40x30,
kEpsilon with wall functions, the shipped GAMG p_rgh controls): the final
U, p_rgh, T, phi and turbulence fields at rtol 1e-9 (atol 1e-9 of each
field's scale), every "Solving for" line with the same iteration count,
the written fields at 1e-9 of each file's largest number
(tests/test_torch_ras_models.py's PARITY_BODY; writePrecision 17 in place
of the shipped 7, whose last digit rounds either way). Two departures from the
shipped cases make the comparison well-posed (chip_smoke.hotroom_case):
- a seeded start (U = 0.01 n, T = 300 + u K): from the shipped U = 0 every
  face flux is round-off, the upwind weights take its sign, and 1e-15 of
  difference grows to 1e-6 in four SIMPLE iterations in f64, in either
  package against itself alike;
- the PIMPLE tutorial with the Euler ddt: it ships steadyState, runs its
  one outer iteration unrelaxed, and diverges in both packages (|U| 1e8 at
  step 10 in the JAX package, float32), as the MRF and SRF PIMPLE
  tutorials do (ROADMAP Queue 3).

In process: the hotRoom p_rgh controls (GAMG, GaussSeidel smoother mapped
to damped Jacobi) built as the reference builds them, and the
Rayleigh-Benard onset of tests/test_buoyant.py through the port in
float32. `python tests/test_torch_buoyant.py` prints the goldens of
chip_smoke.py's thermal phase (the JAX package, CPU, float32).
"""

import contextlib
import io
import os
import sys

import numpy as np
import pytest
import torch

from foamtpu_torch.apps.cli import main as tcli
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.solvers import apps as tapps

import chip_smoke
from test_torch_ras_models import assert_parity, parity
from test_torch_simple import REPO

torch.set_num_threads(2)

STEPS = 3


@pytest.fixture(scope="module")
def runs():
    return parity("hotroom", STEPS, ["simple", "pimple"],
                  env={"FOAMTPU_CHUNK": "1"})


@pytest.mark.parametrize("name", ["simple", "pimple"])
def test_hotroom_run_matches_reference_f64(runs, name):
    rec = runs[name]
    # the SIMPLE transient takes U from 0.01 to ~3 m/s in 3 iterations
    # and round-off with it: written numbers near zero differ by more than
    # 1e-9 of themselves, so they are held as the fields are, at 1e-9 of
    # scale
    assert_parity(rec, STEPS, name, files_scaled=True)
    assert {"U", "p_rgh", "T", "phi", "k", "epsilon", "nut"} == set(
        rec["errs"])
    names = [n for n, _ in rec["solves"][0]]
    # U, p_rgh (logged as p, as the reference), T and the model's two
    # transport solves, every iteration; two correctors in PIMPLE
    for field in ("T", "k", "epsilon"):
        assert names.count(field) == STEPS, (name, names)
    assert names.count("p") == STEPS, (name, names)
    its = [i for n, i in rec["solves"][0] if n == "p"]
    assert all(i >= 1 for i in its[1:]), its


def test_hotroom_written_fields_match_reference(runs):
    for name in ("simple", "pimple"):
        files = runs[name]["files"][str(STEPS) if name == "simple"
                                   else "0.3"]
        assert {"U", "p_rgh", "T", "k", "epsilon", "nut"} <= set(
            files["names"][0]), (name, files["names"])
        assert all(e <= 1e-9 for e in files["scaled"].values()), (
            name, files["scaled"])


def _hotroom(tmp_path, app="buoyantBoussinesqSimpleFoam"):
    return chip_smoke.hotroom_case(REPO, str(tmp_path / "hotRoom"), app,
                                   tcli)


def test_hotroom_gamg_controls_map_as_the_reference(tmp_path):
    """The shipped p_rgh controls (GAMG, smoother GaussSeidel, relTol 0.01,
    tolerance 1e-8) become the same GAMG object in both packages: damped
    Jacobi for GaussSeidel, the same levels."""
    from foamtpu.core.case import Case as JCase

    d = _hotroom(tmp_path)
    tc, jc = TCase(d, device="cpu"), JCase(d)
    t, j = tc.solver_controls("p_rgh"), jc.solver_controls("p_rgh")
    assert {k: v for k, v in t.items() if k != "_gamg"} == {
        k: v for k, v in j.items() if k != "_gamg"}
    assert str(t["smoother"]) == "GaussSeidel"
    tg, jg = t["_gamg"], j["_gamg"]
    assert tg.smoother == jg.smoother == "Jacobi"
    assert len(tg.levels) == len(jg.levels) >= 1
    for a, b in zip(tg.levels, jg.levels):
        assert (a.n_fine, a.n_coarse) == (b.n_fine, b.n_coarse)


def test_boussinesq_applications_are_registered():
    assert tapps.APPLICATIONS["buoyantBoussinesqSimpleFoam"] is \
        tapps.buoyant_boussinesq_simplefoam
    assert tapps.APPLICATIONS["buoyantBoussinesqPimpleFoam"] is \
        tapps.buoyant_boussinesq_pimplefoam


def test_compressible_buoyant_solvers_are_refused(tmp_path):
    """buoyantSimpleFoam (compressible, models/thermo.py) is not ported:
    run raises naming it before the first iteration."""
    d = _hotroom(tmp_path)
    path = os.path.join(d, "system", "controlDict")
    text = open(path).read()
    open(path, "w").write(text.replace("buoyantBoussinesqSimpleFoam",
                                       "buoyantSimpleFoam"))
    case = TCase(d, device="cpu")
    with pytest.raises(NotImplementedError, match="buoyantSimpleFoam"):
        tapps.run(case, max_steps=1)
    assert not hasattr(case, "final_state")


# ---------------------------------------------------------------------------
# Rayleigh-Benard onset (tests/test_buoyant.py), through the port, float32
# ---------------------------------------------------------------------------


def test_rayleigh_benard_onset_f32():
    """Ra ~ 3.2e5 >> 1708 on the 32x8 slab cyclic in x
    (chip_smoke.rb_setup): heated from below a convective roll grows;
    heated from above the slab stays quiescent (tests/test_buoyant.py)."""
    v_unstable, cont, finite_u = chip_smoke.run_rb(10.0, device="cpu")
    v_stable, _, finite_s = chip_smoke.run_rb(-10.0, device="cpu")
    assert finite_u and finite_s
    assert v_unstable > 50.0 * max(v_stable, 1e-12)
    assert v_unstable > 1e-3
    assert cont < 1e-4


# ---------------------------------------------------------------------------
# the goldens of chip_smoke.py's thermal phase
# ---------------------------------------------------------------------------


def reference_thermal(root):
    """The thermal phase's runs in the JAX package (CPU, float32): each
    entry of chip_smoke.THERMAL_RUNS through run_case, its scalars."""
    from foamtpu.apps.cli import main as jcli
    from foamtpu.core.case import run_case as jrun

    out = {}
    for tag, (app, steps, seed, euler) in chip_smoke.THERMAL_RUNS.items():
        d = chip_smoke.hotroom_case(REPO, os.path.join(root, tag), app,
                                    jcli, seed=seed, euler=euler)
        with contextlib.redirect_stdout(io.StringIO()):
            case = jrun(d, max_steps=steps)
        st = case.final_state
        a = {k: np.asarray(st[k].data) for k in ("U", "p_rgh", "T")}
        out[tag] = chip_smoke.thermal_scalars(a, np.asarray(case.mesh.v))
    return out


def shipped_start_sensitivity(root):
    """Why the shipped hotRoom starts are not parity starts, measured on
    the CPU: (a) in float64 (run under FOAMTPU_X64=1 JAX_ENABLE_X64=1),
    the largest difference between the packages over each field's scale
    after each of 4 SIMPLE iterations from the shipped U = 0 and from the
    seeded start; (b) in float32, chip_smoke.thermal_scalars of both
    packages after 200 SIMPLE iterations from the shipped start; (c) max
    |U| of the JAX package's PIMPLE tutorial as shipped after 3, 5, 7 and
    10 steps (a step per chunk)."""
    from foamtpu.apps.cli import main as jcli
    from foamtpu.core.case import run_case as jrun

    simple, pimple = chip_smoke.HOTROOM_CASES
    x64 = os.environ.get("FOAMTPU_X64") == "1"
    out = {}

    def both(tag, app, steps, seed=None):
        got = {}
        for pkg, cli in (("port", tcli), ("ref", jcli)):
            d = chip_smoke.hotroom_case(REPO, os.path.join(root, tag, pkg),
                                        app, cli, seed=seed)
            with contextlib.redirect_stdout(io.StringIO()):
                if pkg == "port":
                    case = TCase(d, device="cpu")
                    tapps.run(case, max_steps=steps)
                    st = {k: case.final_state[k].data.numpy()
                          for k in ("U", "p_rgh", "T")}
                else:
                    case = jrun(d, max_steps=steps)
                    st = {k: np.asarray(case.final_state[k].data)
                          for k in ("U", "p_rgh", "T")}
            got[pkg] = (st, np.asarray(case.mesh.v))
        return got

    if x64:
        os.environ["FOAMTPU_CHUNK"] = "1"
        for tag, seed in (("shipped", None),
                          ("seeded", chip_smoke.HOTROOM_SEED)):
            rows = []
            for n in range(1, 5):
                g = both(f"{tag}{n}", simple, n, seed)
                rows.append({k: float(np.abs(g["port"][0][k] - g["ref"][0][k])
                                      .max() / np.abs(g["ref"][0][k]).max())
                             for k in ("U", "p_rgh", "T")})
            out[f"f64_{tag}"] = rows
        return out
    os.environ["FOAMTPU_CHUNK"] = "10"
    g = both("f32", simple, 200)
    out["f32_200"] = {pkg: chip_smoke.thermal_scalars(*g[pkg])
                      for pkg in g}
    os.environ["FOAMTPU_CHUNK"] = "1"
    traj = {}
    for n in (3, 5, 7, 10):
        d = chip_smoke.hotroom_case(REPO, os.path.join(root, f"pimple{n}"),
                                    pimple, jcli)
        with contextlib.redirect_stdout(io.StringIO()):
            case = jrun(d, max_steps=n)
        traj[n] = float(np.abs(np.asarray(case.final_state["U"].data)).max())
    out["pimple_shipped_u_max"] = traj
    return out


if __name__ == "__main__":
    import tempfile

    import jax

    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:] == ["sensitivity"]:
        sys.stdout.write(repr(shipped_start_sensitivity(tempfile.mkdtemp()))
                         + "\n")
    else:
        os.environ.setdefault("FOAMTPU_CHUNK", "10")
        sys.stdout.write(repr(reference_thermal(tempfile.mkdtemp())) + "\n")
