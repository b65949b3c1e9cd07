"""foamtpu_torch kEpsilon and wall functions against the JAX package.

On the pitzDaily mesh with the tutorial's k/epsilon/nut BCs
(kqRWallFunction, epsilonWallFunction, nutkWallFunction) and seeded
random fields (tests/test_torch_simple.py::random_fields): the
nutkWallFunction update, production G, the momentum coupling
div_dev_reff (corrected laplacian of U plus the explicit
div(nuEff dev(grad(U)^T))), and one steady, relaxed KEpsilon.correct
with its epsilon and k solves. float32 at rtol 1e-5 and atol 1e-6 of
each array's scale for the operators; the solved fields at rtol 1e-4
(a few BiCGStab iterations in float32 summed in a different order) with
equal iteration counts. The model loads from the tutorial through
_load_turbulence in both packages, and the port's solver modules import
without jax.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foamtpu.core.case import Case as JCase
from foamtpu.models.turbulence import base as jbase
from foamtpu.models.turbulence import ras as jras
from foamtpu.ops import slot as jslot
from foamtpu.solvers.apps import _load_turbulence as jload

from foamtpu_torch.convert import field_from_numpy, mesh_from_numpy
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.models.turbulence import base as tbase
from foamtpu_torch.models.turbulence import ras as tras
from foamtpu_torch.ops import slot
from foamtpu_torch.solvers.apps import _load_turbulence as tload

from test_torch_simple import REPO, close, close_matrix, pitz_case, \
    random_fields

torch.set_num_threads(2)
NU = 1e-5


@pytest.fixture(scope="module")
def pitz(tmp_path_factory):
    dst = pitz_case(tmp_path_factory.mktemp("pitzturb"))
    jc = JCase(dst)
    jm = jc.mesh
    jf, phi = random_fields(jc, seed=11)
    return dict(dir=dst, jc=jc, jm=jm, tm=mesh_from_numpy(jm, device="cpu"),
                jf=jf,
                tf={k: field_from_numpy(v, device="cpu") for k,
                    v in jf.items()}, phi=phi)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _tstate(fields):
    return {k: fields[k] for k in ("k", "epsilon", "nut")}


def test_load_turbulence_from_the_tutorial(pitz):
    jmodel, jts = jload(pitz["jc"], NU)
    tmodel, tts = tload(TCase(pitz["dir"], device="cpu"), NU)
    assert type(tmodel).__name__ == type(jmodel).__name__ == "KEpsilon"
    for attr in ("Cmu", "C1", "C2", "sigma_k", "sigma_eps", "div_scheme",
                 "corrected", "corr_limit", "nu"):
        assert getattr(tmodel, attr) == getattr(jmodel, attr), attr
    assert tmodel.div_scheme == "limitedLinear 1" and tmodel.corrected
    assert sorted(tts) == sorted(jts) == ["epsilon", "k", "nut"]
    for name in tts:
        np.testing.assert_array_equal(tts[name].data.numpy(),
                                      np.asarray(jts[name].data))
        assert [b.kind for b in tts[name].bcs] == \
            [b.kind for b in jts[name].bcs]


def test_nutk_wall_function_update(pitz):
    jm, tm = pitz["jm"], pitz["tm"]
    jn, tn = pitz["jf"]["nut"], pitz["tf"]["nut"]
    jk, tk = pitz["jf"]["k"], pitz["tf"]["k"]
    jn2 = jn.correct_boundary_conditions(jm, k=jk.data, nu=NU)
    tn2 = tn.correct_boundary_conditions(tm, k=tk.data, nu=NU)
    walls = [i for i, b in enumerate(tn2.bcs)
             if b.kind == "nutkWallFunction"]
    assert walls == [2, 3]
    for i in walls:
        close(tn2.bcs[i].ref_value, jn2.bcs[i].ref_value, f"nutw {i}")
        assert float(tn2.bcs[i].ref_value.max()) > 0.0
    close(tn2.boundary_values(tm), jn2.boundary_values(jm), "nut_b")
    close(tras._wall_face_nut(tm, tn2), jras._wall_face_nut(jm, jn2),
          "wall-face nut")


def test_production_and_div_dev_reff(pitz):
    jm, tm = pitz["jm"], pitz["tm"]
    jU, tU = pitz["jf"]["U"], pitz["tf"]["U"]
    close(tbase.production(tm, pitz["tf"]["nut"].data, tU),
          jbase.production(jm, pitz["jf"]["nut"].data, jU), "production")
    jmodel, _ = jload(pitz["jc"], NU)
    tmodel, _ = tload(TCase(pitz["dir"], device="cpu"), NU)
    jmat, jexpl = jmodel.div_dev_reff(jm, _tstate(pitz["jf"]), jU)
    tmat, texpl = tmodel.div_dev_reff(tm, _tstate(pitz["tf"]), tU)
    assert tmat.fcorr is not None and tmat.fcorr.shape == (tm.n_faces, 3)
    close_matrix(tmat, jmat, "div_dev_reff matrix")
    close(texpl, jexpl, "div_dev_reff explicit")


def test_kepsilon_correct(pitz):
    """One steady, relaxed (0.5) KEpsilon.correct: epsilon fixed at the
    wall cells, both transport solves, nut and its wall values."""
    jm, tm, phi = pitz["jm"], pitz["tm"], pitz["phi"]
    jmodel, _ = jload(pitz["jc"], NU)
    tmodel, _ = tload(TCase(pitz["dir"], device="cpu"), NU)
    phi_j, phi_t = jnp.asarray(phi), _t(phi)
    jnew, jd = jmodel.correct(
        jm, _tstate(pitz["jf"]), pitz["jf"]["U"], phi_j,
        jnp.asarray(1.0, jnp.float32), steady=True, relax=0.5,
        phi_slot=jslot.from_flat(jm, phi_j))
    tnew, td = tmodel.correct(
        tm, _tstate(pitz["tf"]), pitz["tf"]["U"], phi_t, torch.tensor(1.0),
        steady=True, relax=0.5, phi_slot=slot.from_flat(tm, phi_t))
    for name in ("epsilon", "k"):
        assert int(td[name].n_iterations) == int(jd[name].n_iterations) > 0
    for name in ("k", "epsilon", "nut"):
        close(tnew[name].data, jnew[name].data, name, rtol=1e-4,
              atol_rel=1e-5)
        assert bool(torch.isfinite(tnew[name].data).all())
    assert float(tnew["k"].data.min()) > 0.0
    for tb, jb in zip(tnew["nut"].bcs, jnew["nut"].bcs):
        close(tb.ref_value, jb.ref_value, f"nut bc {tb.kind}", rtol=1e-4,
              atol_rel=1e-5)
    # the wall function pins epsilon in the wall-adjacent cells
    wall = tm.wall_mask.numpy() > 0
    k0 = np.clip(pitz["tf"]["k"].data.numpy(), 1e-10, None)
    eps_wall = (0.09 ** 0.75) * np.sqrt(k0) ** 3 / (0.41
                                                   * tm.wall_y.numpy())
    np.testing.assert_allclose(tnew["epsilon"].data.numpy()[wall],
                               eps_wall[wall], rtol=1e-4)


def test_port_solvers_import_without_jax():
    code = ("import sys; import foamtpu_torch.solvers.simple, "
            "foamtpu_torch.models.turbulence.ras, foamtpu_torch.core.case, "
            "foamtpu_torch.solvers.apps, foamtpu_torch.apps.cli; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'foamtpu.', 'openfoam'))"
            " or m == 'foamtpu']; print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]
