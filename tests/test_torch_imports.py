"""The port stands alone: no source file under foamtpu_torch/ and no line
of chip_smoke.py imports jax or the JAX package (`foamtpu`, or
openfoam-2.2.x_tpu by path), and importing every module of the port
loads neither."""

import os
import re
import subprocess
import sys

from test_torch_simple import REPO

IMPORT = re.compile(
    r"^\s*(import\s+(jax|foamtpu|openfoam)\b(?!_torch)"
    r"|from\s+(jax|foamtpu|openfoam)\b(?!_torch)[\w.]*\s+import)"
    r"|__import__\(\s*['\"](jax|foamtpu)\b(?!_torch)"
    r"|import_module\(\s*['\"](jax|foamtpu)\b(?!_torch)",
    re.M)


def _sources():
    root = os.path.join(REPO, "foamtpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_source_imports_jax_or_the_reference():
    bad = []
    n = 0
    for path in _sources():
        n += 1
        with open(path) as f:
            text = f.read()
        bad += [f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}"
                for m in IMPORT.finditer(text)]
    assert n > 50 and bad == [], bad
    sources = {os.path.relpath(p, REPO) for p in _sources()}
    assert {"foamtpu_torch/models/fvoptions.py",
            "foamtpu_torch/models/mrf.py",
            "foamtpu_torch/models/turbulence/les.py",
            "foamtpu_torch/models/turbulence/les2.py",
            "foamtpu_torch/functionobjects/sampling.py",
            "foamtpu_torch/bc/derived2.py",
            "foamtpu_torch/solvers/buoyant.py",
            "foamtpu_torch/solvers/pimpledym.py",
            "foamtpu_torch/mesh/moving.py",
            "foamtpu_torch/functionobjects/surfaces.py",
            "foamtpu_torch/utils/tnp.py"} <= sources
    # the pattern does catch the imports it is there for
    assert IMPORT.search("import jax.numpy as jnp")
    assert IMPORT.search("    from foamtpu.ops import fvc")
    assert not IMPORT.search("from foamtpu_torch.ops import fvc")


BODY = """
import importlib, pkgutil, sys
import foamtpu_torch
names = [m.name for m in pkgutil.walk_packages(foamtpu_torch.__path__,
                                               "foamtpu_torch.")]
# the rotating-frame and porous slice's modules, the turbulence slice's
# and the moving-mesh slice's are among them
assert {"foamtpu_torch.models.fvoptions", "foamtpu_torch.models.mrf",
        "foamtpu_torch.models.turbulence.les",
        "foamtpu_torch.models.turbulence.les2",
        "foamtpu_torch.functionobjects.sampling",
        "foamtpu_torch.bc.derived2", "foamtpu_torch.solvers.buoyant",
        "foamtpu_torch.solvers.pimpledym", "foamtpu_torch.mesh.moving",
        "foamtpu_torch.functionobjects.surfaces",
        "foamtpu_torch.utils.tnp"} <= set(names), names
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "foamtpu" or m.startswith("foamtpu."))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 50 else 0)
"""


def test_every_port_module_imports_without_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", BODY], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]
