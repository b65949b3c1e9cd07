"""foamtpu_torch's fireFoam (solvers/firefoam.py, solvers/apps.py::
fire_foam) with its region models (regionmodels/) against the JAX package,
and the flowRateInletVelocity kind of its smallPoolFire2D.

In float64 (one process, FOAMTPU_X64=1 JAX_ENABLE_X64=1) both packages'
`run(case)` take 3 steps of smallPoolFire2D (the buoyant step, Y as one
[n, 5] field solved multi-RHS, infinitelyFastChemistry, kEpsilon), of the
same with P1 radiation, and of the pyrolysis case of
tests/test_firefoam.py with a water film on its sides
(chip_smoke.SLICE15_CASES, seeded starts): fields at rtol 1e-9 (U, p_rgh,
T, phi, Y, G, k, epsilon, nut, the pyrolysis columns Ts and rho_s, the
released gas, the film's delta, Uf and Tf), every solve's iteration count
equal, the log lines and the written fields, the time step adjusted to
maxCo as in the reference. The JAX package's last state converts into
the port's (convert.state_from_numpy: Y, G and the region states).

In the same process, alone: `build_film_mesh` on a 3D box's wall and on
smallPoolFire2D's base and sides (every array equal), 20 `film_step`s of
a thermo film with impingement, surface shear, wall heat and evaporation,
60 `pyro_step`s of heated columns (at 1e-12), and flowRateInletVelocity:
smallPoolFire2D's base patch of U read by both packages (its `value`
fixed, massFlowRate read nowhere) with equal face values.

In this process: the kind keeps its name, is no value BC for
`is_value_bc` (as in the reference), and any other unknown kind still
raises in the port.
"""

import json
import sys

import numpy as np
import pytest
import torch

from foamtpu_torch.bc import factory, patchfields as tpf
from foamtpu_torch.core.dictionary import parse_string as tparse
from foamtpu_torch.regionmodels import pyro_init
from foamtpu_torch.solvers import apps as tapps

from test_torch_ras_models import assert_parity, parity

torch.set_num_threads(2)

STEPS = 3
CASES = ("fireFoam", "fireFoamP1", "fireFoamRegions")

UNITS = r'''
import jax.numpy as jnp
from foamtpu.core.dictionary import parse_string as jps
from foamtpu.mesh import blockmesh as jbm
from foamtpu.regionmodels import (FilmConfig as JFC, PyrolysisConfig as JPC,
                                  build_film_mesh as jbfm, film_init as jfi,
                                  film_step as jfs, pyro_init as jpi,
                                  pyro_step as jps_)
from foamtpu.core.case import Case as JCase
from foamtpu_torch import convert
from foamtpu_torch.core.dictionary import parse_string as tps
from foamtpu_torch.mesh import blockmesh as tbm
from foamtpu_torch.regionmodels import (FilmConfig as TFC, PyrolysisConfig as TPC,
                                        build_film_mesh as tbfm, film_init as tfi,
                                        film_step as tfs, pyro_init as tpi,
                                        pyro_step as tps_)

def host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

def rel(a, b):
    a, b = np.asarray(host(a), float), np.asarray(host(b), float)
    if a.shape != b.shape:
        return float("inf")
    if a.size == 0:
        return 0.0
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))

units = {}
rng = np.random.default_rng(15)
BOX = """
convertToMeters 1;
vertices ( (0 0 0) (1 0 0) (1 0.2 0) (0 0.2 0)
           (0 0 0.5) (1 0 0.5) (1 0.2 0.5) (0 0.2 0.5) );
blocks ( hex (0 1 2 3 4 5 6 7) (20 4 10) simpleGrading (1 1 1) );
boundary
(
    bottom { type wall; faces ((0 1 5 4)); }
    top    { type wall; faces ((3 7 6 2)); }
    sides  { type patch; faces ((0 4 7 3) (1 2 6 5) (0 3 2 1) (4 5 6 7)); }
);
"""
FIELDS = ("cf", "area", "n", "e_own", "e_nbr", "e_m", "e_dc", "face_ids",
          "owner_cells", "b_rel")
meshes = {}
pool_dir = os.path.join(root, "fireFoamRegions", "port")
pool_j = JCase(os.path.join(root, "fireFoamRegions", "ref")).poly_mesh
pool_t = TCase(pool_dir, device="cpu").poly_mesh
for tag, pj, pt, names in (
        ("box_bottom", jbm.generate(jps(BOX)), tbm.generate(tps(BOX)), ["bottom"]),
        ("pool_base", pool_j, pool_t, ["base"]),
        ("pool_sides", pool_j, pool_t, ["sides"])):
    fj, ft = jbfm(pj, names), tbfm(pt, names, device="cpu")
    meshes[tag] = {"exact": {f: bool(np.array_equal(np.asarray(getattr(fj, f)),
                                                    host(getattr(ft, f))))
                             for f in FIELDS},
                   "n": [ft.n_faces, ft.n_edges]}
    if tag == "box_bottom":
        fmj, fmt = fj, ft
units["film_mesh"] = meshes
# -- film_step alone ----------------------------------------------------------
cfg_j = JFC(nu=1e-6, rho=1000.0, g=(0.3, -9.81, 0.0), thermo=True,
            T_sat=373.15, evap_coeff=1e-3)
cfg_t = TFC(nu=1e-6, rho=1000.0, g=(0.3, -9.81, 0.0), thermo=True,
            T_sat=373.15, evap_coeff=1e-3)
nf = fmt.n_faces
d0 = 1e-4 * (1 + rng.random(nf))
T0 = 360.0 + 40.0 * rng.random(nf)
sj = jfi(fmj, cfg_j, delta0=jnp.asarray(d0), T0=jnp.asarray(T0))
st = tfi(fmt, cfg_t, delta0=0.0, T0=0.0)
st["delta"], st["Tf"] = torch.tensor(d0), torch.tensor(T0)
S_mass = 1e-3 * rng.random(nf)
S_mom = 1e-2 * rng.standard_normal((nf, 3))
q_wall = 1e3 * rng.random(nf)
for _ in range(20):
    sj, dj = jfs(fmj, sj, 1e-3, cfg_j, S_mass=jnp.asarray(S_mass),
                 S_mom=jnp.asarray(S_mom), q_wall=jnp.asarray(q_wall))
    st, dt_ = tfs(fmt, st, 1e-3, cfg_t, S_mass=torch.tensor(S_mass),
                  S_mom=torch.tensor(S_mom), q_wall=torch.tensor(q_wall))
units["film_step"] = {k: rel(sj[k], st[k]) for k in ("delta", "Uf", "Tf")}
units["film_step"].update({"diag_" + k: rel(dj[k], dt_[k]) for k in dj})
units["film_step"]["umax"] = float(torch.abs(st["Uf"]).max())
# -- pyro_step alone --------------------------------------------------------
pc_j = JPC(n_layers=8, thickness=0.008, A=1e6, Ta=10000.0, n_sub=8)
pc_t = TPC(n_layers=8, thickness=0.008, A=1e6, Ta=10000.0, n_sub=8)
q = 3e4 + 4e4 * rng.random(7)
pj_ = jpi(7, pc_j, T0=300.0, dtype=jnp.float64)
pt_ = tpi(7, pc_t, T0=300.0, dtype=torch.float64, device="cpu")
for _ in range(60):
    pj_, pdj = jps_(pj_, 0.05, pc_j, jnp.asarray(q))
    pt_, pdt = tps_(pt_, 0.05, pc_t, torch.tensor(q))
units["pyro_step"] = {k: rel(pj_[k], pt_[k]) for k in ("Ts", "rho_s")}
units["pyro_step"].update({"diag_" + k: rel(pdj[k], pdt[k]) for k in pdj})
units["pyro_step"]["lost"] = float(500.0 * 0 + (700.0 - host(pt_["rho_s"])).sum())
# -- flowRateInletVelocity: the U field of smallPoolFire2D -------------------
fire = os.path.join(root, "fireFoam", "ref")
Uj, Ut = JCase(fire).read_field("U"), TCase(fire, device="cpu").read_field("U")
jm_, tm_ = JCase(fire).mesh, TCase(fire, device="cpu").mesh
ib = [p.name for p in tm_.patches].index("base")
bj, bt = Uj.bcs[ib], Ut.bcs[ib]
units["flow_rate"] = {"kind": [bj.kind, bt.kind],
                      "ref": rel(jnp.broadcast_to(bj.ref_value, (tm_.patches[ib].size, 3)), bt.ref_value),
                      "vfrac": [float(np.asarray(bj.vfrac).min()), float(bt.vfrac.min())],
                      "bvals": rel(Uj.boundary_values(jm_), Ut.boundary_values(tm_)),
                      "base": host(bt.ref_value)[0].tolist()}
# -- GAMG prepared from another matrix (buoyantrho.py's pEqn0) ----------------
# both packages' transient compressible p_rgh solves prepare GAMG from the
# Laplacian (pEqn0) and solve pEqn0 - psi V/dt: the solve takes the
# prepared matrix, so the transient diagonal drops out
from foamtpu.ops import fvm as jfvm
from foamtpu.solvers import linear as jlinear
from foamtpu.solvers.linear.gamg import GAMG as JGAMG
from foamtpu_torch.ops import fvm as tfvm
from foamtpu_torch.solvers import linear as tlinear
from foamtpu_torch.solvers.linear.gamg import GAMG as TGAMG
gam = {}
for tag, mesh, P, fvm_, lin, G, arr in (
        ("ref", jm_, JCase(fire).read_field("p_rgh"), jfvm, jlinear, JGAMG, jnp.asarray),
        ("port", tm_, TCase(fire, device="cpu").read_field("p_rgh"), tfvm, tlinear, TGAMG, torch.tensor)):
    lap = fvm_.laplacian(mesh, arr(1.0), P, corrected=False)
    b = arr(np.random.default_rng(3).standard_normal(mesh.n_cells))
    A0 = lap.replace_fields(source=lap.source + b)
    A1 = A0.replace_fields(diag=A0.diag - 50.0 * mesh.v)
    tight = {"solver": "PCG", "preconditioner": "diagonal", "tolerance": 1e-14,
             "relTol": 0.0, "maxIter": 5000}
    x0 = host(lin.solve(mesh, A0, P.data, tight)[0])
    x1 = host(lin.solve(mesh, A1, P.data, tight)[0])
    g = G(mesh)
    ctl = {"solver": "GAMG", "tolerance": 1e-12, "relTol": 0.0, "maxIter": 200,
           "_gamg": g}
    ctl0 = lin.prepare_controls(mesh, A0, ctl)
    xg = host(lin.solve(mesh, A1, P.data, ctl0)[0])
    xs = host(lin.solve(mesh, A1, P.data, ctl)[0])
    gam[tag] = {"prepared_from_A0_vs_A0": rel(x0, xg), "prepared_from_A0_vs_A1": rel(x1, xg),
                "own_prep_vs_A1": rel(x1, xs)}
units["gamg_prep"] = gam
# -- convert: the JAX package's last state into the port's -------------------
conv = convert.state_from_numpy(jc.final_state, device="cpu")
ts_ = tc.final_state
cv = {}
for k in ("Y", "T", "U", "p_rgh"):
    cv[k] = rel(ts_[k].data, conv[k].data)
for reg in ("pyro", "film"):
    for k in ts_[reg]:
        cv[f"{reg}_{k}"] = rel(ts_[reg][k], conv[reg][k])
cv["keys"] = sorted(set(jc.final_state) - set(conv))
units["convert"] = cv
print(json.dumps({"units": units}))
'''


@pytest.fixture(scope="module")
def runs():
    return parity("slice15", STEPS, CASES, tail=UNITS, lines=2)


@pytest.fixture(scope="module")
def units(runs):
    return runs[1]["units"]


@pytest.mark.parametrize("name", CASES)
def test_fire_foam_matches_reference_f64(runs, name):
    rec = runs[0][name]
    assert_parity(rec, STEPS, name)
    want = {"U", "p_rgh", "T", "phi", "Y", "k", "epsilon", "nut"}
    if name == "fireFoamP1":
        want |= {"G"}
    if name == "fireFoamRegions":
        want |= {"pyro_Ts", "pyro_rho_s", "pyro_m_gas", "film_delta",
                 "film_Uf", "film_Tf"}
    assert want == set(rec["errs"]), rec["errs"].keys()
    # the time step adapts to maxCo (0.001 from the start)
    assert rec["time"][2] != "0.003", rec["time"]


@pytest.mark.parametrize("tag", ["box_bottom", "pool_base", "pool_sides"])
def test_build_film_mesh_matches_reference(units, tag):
    u = units["film_mesh"][tag]
    assert all(u["exact"].values()), u
    assert u["n"][0] > 0 and u["n"][1] > 0


def test_film_step_matches_reference(units):
    u = units["film_step"]
    assert u["umax"] > 0.0
    for k, e in u.items():
        if k != "umax":
            assert e < 1e-12, (k, u)


def test_pyro_step_matches_reference(units):
    u = units["pyro_step"]
    assert u["lost"] > 0.0
    for k, e in u.items():
        if k != "lost":
            assert e < 1e-12, (k, u)


def test_convert_carries_the_fire_state(units):
    u = units["convert"]
    assert u.pop("keys") == []
    for k, e in u.items():
        assert e < 1e-9, (k, u)


def test_gamg_prepared_from_the_laplacian_drops_the_diagonal_as_reference(
        units):
    """A fault of the reference, mirrored (ROADMAP Queue 3): a GAMG solve
    whose controls were prepared from another matrix solves that one.
    buoyantrho.py (and rhopimple.py) prepare p's GAMG from the Laplacian
    pEqn0 and solve pEqn0 - psi V/dt, so the transient diagonal drops out;
    at fire_headline's width this made the run return NaN at step 5-6 in
    both packages (chip_smoke.FIRE_HEAD_P_MAXITER)."""
    for tag in ("ref", "port"):
        u = units["gamg_prep"][tag]
        assert u["prepared_from_A0_vs_A0"] < 1e-6, (tag, u)
        assert u["prepared_from_A0_vs_A1"] > 1e-2, (tag, u)
        assert u["own_prep_vs_A1"] < 1e-6, (tag, u)


def test_flow_rate_inlet_velocity_matches_reference(units):
    u = units["flow_rate"]
    assert u["kind"] == ["flowRateInletVelocity"] * 2
    assert u["ref"] == 0.0 and u["vfrac"] == [1.0, 1.0]
    assert u["bvals"] == 0.0
    assert u["base"] == [0.0, 0.05, 0.0]


def test_flow_rate_inlet_velocity_keeps_its_name_and_others_raise():
    class _P:
        size = 3
        name = "inlet"

    spec = tparse("type flowRateInletVelocity; massFlowRate 0.001; "
                  "value uniform (0 0.05 0);")
    bc = factory.from_dict(spec, _P(), 1, torch.float64)
    assert bc.kind == "flowRateInletVelocity"
    assert float(bc.vfrac) == 1.0
    assert bc.ref_value.tolist() == [[0.0, 0.05, 0.0]] * 3
    # as in the reference, it is no value BC for is_value_bc (which lists
    # fixedValue, noSlip and calculated)
    assert not tpf.is_value_bc(bc)
    for kind in ("surfaceNormalFixedValue", "fixedMeanValue"):
        with pytest.raises(NotImplementedError, match=kind):
            factory.from_dict(tparse(f"type {kind}; value uniform (0 0 0);"),
                              _P(), 1, torch.float64)


def test_fire_foam_is_registered_and_defaults_to_the_card():
    import inspect

    from foamtpu_torch.core.precision import DEFAULT_DEVICE
    from foamtpu_torch.regionmodels import build_film_mesh

    assert tapps.APPLICATIONS["fireFoam"] is tapps.fire_foam
    for fn in (pyro_init, build_film_mesh):
        assert inspect.signature(fn).parameters["device"].default == \
            DEFAULT_DEVICE


# fire_headline's rehearsals: (nx, ny, convertToMeters) on the headline's
# 12 m x 20 m at 100, 50, 40 and 33 mm, and its 20 mm on pools of 2.4 m x
# 4 m and 4.8 m x 8 m
FIRE_REHEARSALS = ((120, 200, 20.0), (240, 400, 20.0), (300, 500, 20.0),
                   (360, 600, 20.0), (120, 200, 4.0), (240, 400, 8.0))


def rehearse_fire(steps=12, runs=FIRE_REHEARSALS, port=False):
    """fire_headline's case (chip_smoke.fire_big_case: smallPoolFire2D
    with P1 radiation, p_rgh by PCG with maxIter 2000, deltaT 1e-3 fixed)
    at each (nx, ny, convertToMeters) of `runs` for `steps` steps, in the
    JAX package on the CPU (float32), or the port on the CPU with `port`:
    T's range, where it peaks, its range in the 10 x 10 cells at each of
    the base's corners (fire_big_oracles' cells) and off them, G's range
    against 4 sigma Tmax^4, sum(Y)'s range, the largest CO2, each step's
    continuity error and each solve's iterations (from the log)."""
    import contextlib
    import io
    import re
    import tempfile

    import chip_smoke

    from test_torch_simple import REPO

    out = {}
    for nx, ny, scale in runs:
        d = chip_smoke.fire_big_case(REPO, tempfile.mkdtemp() + "/fire",
                                     blocks=(nx, ny), scale=scale)
        with contextlib.redirect_stdout(io.StringIO()) as log:
            if port:
                from foamtpu_torch.apps.cli import main as tcli
                from foamtpu_torch.core.case import Case

                assert tcli(["blockMesh", "-case", d]) == 0
                case = Case(d, device="cpu")
                tapps.run(case, max_steps=steps)
            else:
                from foamtpu.apps.cli import main as jcli
                from foamtpu.core.case import run_case as jrun

                assert jcli(["blockMesh", "-case", d]) == 0
                case = jrun(d, max_steps=steps)
        text = log.getvalue()
        st = case.final_state

        def host(x):
            x = getattr(x, "data", x)
            return np.asarray(x.double().cpu() if isinstance(x, torch.Tensor)
                              else x, np.float64)

        T, G, Y = host(st["T"]), host(st["G"]), host(st["Y"])
        cc = host(case.mesh.c)
        W, H = 0.6 * scale, 1.0 * scale
        corner = ((W / 2 - np.abs(cc[:, 0]) < 10 * W / nx)
                  & (cc[:, 1] < 10 * H / ny))
        its = {}
        for name, n in re.findall(
                r"Solving for (\w+),.*No Iterations (\d+)", text):
            its.setdefault(name, []).append(int(n))
        out[f"{nx}x{ny}@{scale:g}"] = {
            "cell_mm": 1e3 * W / nx, "steps": case.time.index,
            "T": [float(T.min()), float(T.max())],
            "T_max_at": cc[int(np.argmax(T)), :2].tolist(),
            "T_corners": [float(T[corner].min()), float(T[corner].max())],
            "T_off_corners": [float(T[~corner].min()),
                              float(T[~corner].max())],
            "G": [float(G.min()), float(G.max())],
            "G_bound": float(4 * 5.670374419e-8 * T.max() ** 4),
            "Y_sum": [float(Y.sum(1).min()), float(Y.sum(1).max())],
            "CO2_max": float(Y[:, 2].max()),
            "continuity_of_a_step": [float(x) for x in re.findall(
                r"continuity errors : sum local = (\S+),", text)],
            "iterations": {k: [min(v), max(v)] for k, v in its.items()}}
    return out


if __name__ == "__main__" and sys.argv[1:2] == ["rehearse"]:
    # python tests/test_torch_firefoam.py rehearse [--port] [NXxNY@SCALE
    # ...]: rehearse_fire's JSON (FIRE_REHEARSALS by default)
    picked = [tuple(float(v) for v in a.replace("@", "x").split("x"))
              for a in sys.argv[2:] if not a.startswith("--")]
    print(json.dumps(rehearse_fire(
        runs=[(int(a), int(b), c) for a, b, c in picked] or FIRE_REHEARSALS,
        port="--port" in sys.argv), indent=1))
