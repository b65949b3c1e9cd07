"""foamtpu_torch's case-directory entry (`python -m foamtpu_torch run
-case <dir>`: __main__.py, apps/cli.py::run, core/case.py::run_case)
against the JAX package's, and the interpolation-scheme error.

- The icoFoam cavity cut to 16 x 16 runs 3 steps through the command in
  a process of its own (`-device cpu`) and through `run(Case(...))` in
  this one: the written fields hold the same numbers, and the command
  logs the application's lines.
- An application that neither package registers raises the reference's
  ValueError from both packages' run_case; one the reference registers
  but the port has not ported (sprayEngineFoam, the parcels on the engine
  mesh) raises the port's NotImplementedError, which lists what is
  ported; `-parallel` raises NotImplementedError naming the parallel
  layer.
- An unknown interpolation scheme raises ValueError("unknown
  interpolation scheme ...") in both packages, from the flat and the
  slot weights alike.
"""

import contextlib
import io
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from foamtpu_torch.apps.cli import main as tcli
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.core.case import run_case as trun_case
from foamtpu_torch.solvers import apps as tapps

from test_torch_simple import REPO

torch.set_num_threads(2)

CAVITY = os.path.join(REPO, "tutorials", "incompressible", "icoFoam",
                      "cavity")
NUM = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")


def cavity16(dst):
    shutil.copytree(CAVITY, dst)
    path = os.path.join(dst, "constant", "polyMesh", "blockMeshDict")
    if not os.path.exists(path):
        path = os.path.join(dst, "system", "blockMeshDict")
    text = open(path).read()
    new = re.sub(r"\(\s*20\s+20\s+1\s*\)", "(16 16 1)", text)
    assert new != text
    open(path, "w").write(new)
    with contextlib.redirect_stdout(io.StringIO()):
        assert tcli(["blockMesh", "-case", dst]) == 0
    return dst


def numbers(case_dir, time_name):
    d = os.path.join(case_dir, time_name)
    return {f: [float(x) for x in NUM.findall(open(os.path.join(d, f)).read())]
            for f in sorted(os.listdir(d))
            if os.path.isfile(os.path.join(d, f))}


@pytest.fixture(scope="module")
def command_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("case_run")
    a = cavity16(str(root / "command"))
    b = cavity16(str(root / "in_process"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-m", "foamtpu_torch", "run",
                        "-case", a, "-steps", "3", "-device", "cpu"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    case = TCase(b, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        assert tapps.run(case, max_steps=3) is case
    return r, a, b, case


def test_run_command_writes_the_fields_of_run_case(command_run):
    r, a, b, case = command_run
    assert r.returncode == 0, r.stderr[-2000:]
    assert case.time.index == 3
    name = case.time.name
    got, ref = numbers(a, name), numbers(b, name)
    assert sorted(got) == sorted(ref) and {"U", "p"} <= set(ref)
    for f in ref:
        assert got[f] == ref[f], f


def test_run_command_logs_the_application(command_run):
    r = command_run[0]
    assert "Starting time loop" in r.stdout
    assert r.stdout.count("Solving for p") >= 3
    assert r.stdout.rstrip().endswith("End")


def test_run_command_is_registered():
    from foamtpu_torch.apps import cli

    assert cli.COMMANDS["run"] is cli.run


def _with_application(src, dst, app):
    shutil.copytree(src, dst)
    path = os.path.join(dst, "system", "controlDict")
    text = open(path).read()
    open(path, "w").write(re.sub(r"application\s+\w+;",
                                 f"application {app};", text))
    return dst


def test_unknown_application_raises_value_error_in_both(command_run,
                                                        tmp_path):
    from foamtpu.core.case import run_case as jrun_case

    d = _with_application(command_run[2], str(tmp_path / "c"),
                          "dieselFoam")
    with pytest.raises(ValueError, match="unknown application 'dieselFoam'"):
        jrun_case(d, max_steps=1)
    with pytest.raises(ValueError, match="unknown application 'dieselFoam'"):
        trun_case(d, max_steps=1, device="cpu")
    with pytest.raises(ValueError, match="unknown application"):
        tcli(["run", "-case", d, "-device", "cpu"])


def test_reference_only_application_is_not_ported(command_run, tmp_path):
    """Every application the reference registers is ported since the
    Lagrangian slice: REFERENCE_ONLY is empty and APPLICATIONS holds each
    name of the JAX package's registry."""
    import foamtpu.core.case as jcase_mod
    import foamtpu.solvers.apps  # noqa: F401 - populates the registry

    assert tapps.REFERENCE_ONLY == ()
    assert set(jcase_mod._APPLICATIONS) <= set(tapps.APPLICATIONS)
    assert len(jcase_mod._APPLICATIONS) == len(tapps.APPLICATIONS) == 82


def test_parallel_names_the_parallel_layer(command_run):
    with pytest.raises(NotImplementedError, match="item 8"):
        tcli(["run", "-case", command_run[2], "-parallel", "-device",
              "cpu"])


@pytest.mark.parametrize("scheme", ["none", "Gauss bogusLimiter"])
def test_unknown_scheme_raises_value_error_in_both(command_run, scheme):
    import jax.numpy as jnp
    from foamtpu.core.case import Case as JCase
    from foamtpu.ops import schemes as jschemes
    from foamtpu_torch.ops import schemes as tschemes
    from foamtpu_torch.ops import slot as tslot

    name = scheme.split()[-1]
    text = f"unknown interpolation scheme '{name}'"
    jc = JCase(command_run[2])
    U = jc.read_field("U")
    phi = jnp.zeros(jc.mesh.n_faces, jc.mesh.v.dtype)
    with pytest.raises(ValueError, match=text):
        jschemes.weights(jc.mesh, phi, name, U)
    tc = TCase(command_run[2], device="cpu")
    tU = tc.read_field("U")
    tphi = torch.zeros(tc.mesh.n_faces, dtype=tc.mesh.v.dtype)
    with pytest.raises(ValueError, match=text):
        tschemes.weights(tc.mesh, tphi, name, tU)
    with pytest.raises(ValueError, match=text):
        tschemes.weights_slot(tc.mesh, tslot.from_flat(tc.mesh, tphi), name,
                              tU)
