"""foamtpu_torch's rhoCentralFoam against the JAX package's
(solvers/rhocentral.py and the applications rhoCentralFoam and
rhoCentralDyMFoam).

In float64 (one process, FOAMTPU_X64=1 JAX_ENABLE_X64=1):

  * `knp_fluxes` (Kurganov and Tadmor, first and second order, and with a
    mesh velocity) on seeded cell and boundary values of forwardStep
    coarsened 4x per direction: the mass, momentum and energy fluxes and
    amaxSf agree at rtol 1e-12 (atol 1e-12 of each flux's scale);
  * `run(case)` on forwardStep coarsened 4x per direction (1,008 cells) for
    20 steps, two chunks of 10, and rhoCentralDyMFoam on movingStep
    coarsened alike for 3 steps, as shipped (first order: no limiter to
    follow round-off): rho, rhoU, rhoE, U, T and p at 1e-9, the log lines
    and the written fields (tests/test_torch_ras_models.py's PARITY_BODY).

Then, through the port alone, tests/test_rhocentral.py's free-stream
preservation on a translating mesh (float32).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from foamtpu_torch.solvers import apps as tapps

from test_torch_ras_models import assert_parity, parity
from test_torch_simple import REPO

FLUX_BODY = r"""
import json, os, sys, tempfile
import numpy as np
import torch
import jax.numpy as jnp
import chip_smoke as cs
from foamtpu.core.case import Case as JCase
from foamtpu.solvers import rhocentral as J
from foamtpu_torch.apps.cli import main as tcli
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.models.thermo import PerfectGas as TGas
from foamtpu.models.thermo import PerfectGas as JGas
from foamtpu_torch.solvers import rhocentral as P

d = cs.compressible_case(os.getcwd(), os.path.join(tempfile.mkdtemp(), "s"),
                         "rhoCentralFoam", tcli, scale=0.25)
jm, tm = JCase(d).mesh, TCase(d, device="cpu").mesh
n, nb = tm.n_cells, tm.n_faces - tm.n_internal_faces
rng = np.random.default_rng(12)
rho = 1.4 * (1.0 + 0.3 * rng.random(n))
U = np.stack([3.0 + rng.standard_normal(n), rng.standard_normal(n),
              np.zeros(n)], axis=1)
T = 1.0 + 0.5 * rng.random(n)
rho_b = 1.4 * (1.0 + 0.3 * rng.random(nb))
U_b = np.stack([3.0 + rng.standard_normal(nb), rng.standard_normal(nb),
                np.zeros(nb)], axis=1)
T_b = 1.0 + 0.5 * rng.random(nb)
mesh_un = 0.1 * rng.standard_normal(tm.n_faces)
args = (rho, U, T, rho_b, U_b, T_b)
out = {}
for scheme in ("Kurganov", "Tadmor"):
    for second in (False, True):
        for moving in (False, True):
            key = f"{scheme}_{'second' if second else 'first'}" + (
                "_moving" if moving else "")
            jc = J.RhoCentralConfig(JGas(R=0.714286, Cv=1.78571),
                                    flux_scheme=scheme)
            tc = P.RhoCentralConfig(TGas(R=0.714286, Cv=1.78571),
                                    flux_scheme=scheme)
            r = J.knp_fluxes(jm, jc, *[jnp.asarray(a) for a in args],
                             second, mesh_un=jnp.asarray(mesh_un)
                             if moving else None)
            g = P.knp_fluxes(tm, tc, *[torch.tensor(a) for a in args],
                             second, mesh_un=torch.tensor(mesh_un)
                             if moving else None)
            errs = {}
            for name, a, b in zip(("mass", "mom", "ener", "amax"), g, r):
                a, b = a.numpy(), np.asarray(b)
                scale = float(np.abs(b).max())
                errs[name] = {"ok": bool(a.shape == b.shape and np.allclose(
                    a, b, rtol=1e-12, atol=1e-12 * scale)),
                    "max_rel": float(np.abs(a - b).max() / scale),
                    "dtype": str(a.dtype)}
            out[key] = errs
print(json.dumps(out))
"""

KEYS = [f"{s}_{o}{m}" for s in ("Kurganov", "Tadmor")
        for o in ("first", "second") for m in ("", "_moving")]


@pytest.fixture(scope="module")
def flux_run():
    env = dict(os.environ)
    env.update(FOAMTPU_X64="1", JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", FLUX_BODY], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("key", KEYS)
def test_knp_fluxes_match_reference_f64(flux_run, key):
    for name, e in flux_run[key].items():
        assert e["dtype"] == "torch.float64" or e["dtype"] == "float64"
        assert e["ok"], (key, name, e)


@pytest.fixture(scope="module")
def step_runs():
    return parity("slice10", 20, ["rhoCentralFoam"]) | parity(
        "slice10", 3, ["rhoCentralDyMFoam"])


@pytest.mark.parametrize("app,steps", [("rhoCentralFoam", 20),
                                       ("rhoCentralDyMFoam", 3)])
def test_application_matches_reference_f64(step_runs, app, steps):
    rec = step_runs[app]
    assert_parity_explicit(rec, steps, app)
    assert {"U", "p", "T", "rho", "rhoU", "rhoE"} == set(rec["errs"])


def assert_parity_explicit(rec, steps, what):
    """assert_parity for an explicit solver: no linear solve to count."""
    rec = dict(rec)
    assert rec["solves"] == [[], []], rec["solves"]
    rec["solves"] = [[("none", 0)] * steps] * 2
    assert_parity(rec, steps, what, files_scaled=True)


def test_applications_are_registered():
    assert tapps.APPLICATIONS["rhoCentralFoam"] is tapps.rhocentralfoam_app
    assert tapps.APPLICATIONS["rhoCentralDyMFoam"] is \
        tapps.rhocentral_dym_foam


def test_translating_freestream_is_preserved():
    """tests/test_rhocentral.py::test_rhocentraldym_translating_freestream
    through the port (float32): a still uniform gas on a rigidly
    translating 12x12 mesh stays still, at its temperature, with its
    mass."""
    from foamtpu_torch.bc import patchfields as pf
    from foamtpu_torch.core.dictionary import parse_string
    from foamtpu_torch.core.fields import vol_scalar, vol_vector
    from foamtpu_torch.mesh import blockmesh, moving, to_device
    from foamtpu_torch.models.thermo import PerfectGas
    from foamtpu_torch.solvers import rhocentral as rc

    pm = blockmesh.generate(parse_string("""
vertices ( (0 0 0) (1 0 0) (1 1 0) (0 1 0)
           (0 0 0.1) (1 0 0.1) (1 1 0.1) (0 1 0.1) );
blocks ( hex (0 1 2 3 4 5 6 7) (12 12 1) simpleGrading (1 1 1) );
boundary
(
    walls { type slip; faces ((2 6 5 1) (0 4 7 3) (1 5 4 0) (3 7 6 2)); }
    frontAndBack { type empty; faces ((0 3 2 1) (4 5 6 7)); }
);
"""))
    mesh = to_device(pm, device="cpu")
    th = PerfectGas(R=287.0, Cv=717.5, mu=0.0)
    bu, bs = [], []
    for p in mesh.patches:
        kind = "empty" if p.type == "empty" else "slip"
        bu.append(pf.PatchField(kind=kind, vfrac=0.0))
        bs.append(pf.PatchField(kind="empty", vfrac=0.0)
                  if kind == "empty" else pf.zero_gradient())
    rho0 = 1e5 / (287.0 * 300.0)
    state = rc.initial_state(
        mesh, vol_scalar(mesh, rho0, name="rho", bcs=tuple(bs)),
        vol_vector(mesh, (0.0, 0.0, 0.0), name="U", bcs=tuple(bu)),
        vol_scalar(mesh, 300.0, name="T", bcs=tuple(bs)),
        rc.RhoCentralConfig(thermo=th))
    state["topo"] = moving.topo_from_poly(pm, mesh.v.dtype, "cpu")
    state["points0"] = torch.tensor(pm.points, dtype=mesh.v.dtype)
    state["t"] = mesh.v.new_zeros(())
    pts_fn, umesh_fn = moving.linear_motion((5.0, 0.0, 0.0))
    for _ in range(20):
        state, diag = rc.rhocentraldym_step(
            mesh, state, torch.tensor(5e-5), rc.RhoCentralConfig(thermo=th),
            pts_fn, umesh_fn)
    assert float(torch.max(torch.abs(state["U"].data))) < 1e-4
    assert float(torch.max(torch.abs(state["T"].data - 300.0))) < 1e-2
    assert abs(float(diag["mass"]) - rho0 * 0.1) < 1e-5 * rho0
    assert np.isfinite(float(diag["courant_max"]))
