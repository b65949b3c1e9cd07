"""foamtpu_torch's coded function object, the codedSource fvOption's jnp
snippets, and the jax.numpy subset they run on (utils/tnp.py), against the
JAX package.

In process (float32, both packages): the coded object of
tests/test_fo_coded.py in the icoFoam cavity through each package's
`run(case)` for 4 steps: the same .dat rows at 1e-6 (the snippet prints
9 significant digits; at the test's 6 the last digit rounds either way).
A snippet that raises does not stop the run, as in the reference (its
silent failure); the port's list counts it. A jnp name outside the subset
raises NotImplementedError naming itself.

In a float64 subprocess: codedSource snippets written against jnp (the
one of tests/test_fvoptions.py with jnp.where, and vector ones over the
subset's names with axis=) give the reference's sources at 1e-12.
"""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from foamtpu_torch.apps.cli import main as tcli
from foamtpu_torch.core.case import Case as TCase
from foamtpu_torch.solvers import apps as tapps
from foamtpu_torch.utils import tnp

from test_torch_simple import REPO

torch.set_num_threads(2)

FUNCS = """
functions
{
    maxU
    {
        type coded;
        name maxU;
        codeExecute #{
umax = float(jnp.max(jnp.linalg.norm(state["U"].data, axis=1)))
store["n"] = store.get("n", 0) + 1
output(f"{time_name}\\t{umax:.9g}")
        #};
    }
}
"""


def _cavity(root, cli, funcs=FUNCS):
    d = os.path.join(str(root), "cavity")
    shutil.copytree(os.path.join(REPO, "tutorials", "incompressible",
                                 "icoFoam", "cavity"), d)
    with open(os.path.join(d, "system", "controlDict"), "a") as f:
        f.write(funcs)
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli(["blockMesh", "-case", d]) == 0
    return d


def _rows(d):
    path = os.path.join(d, "postProcessing", "maxU", "0", "maxU.dat")
    return [ln.split("\t") for ln in open(path).read().splitlines() if ln]


def test_coded_function_object_matches_reference(tmp_path):
    from foamtpu.apps.cli import main as jcli
    from foamtpu.core.case import run_case as jrun

    td, jd = _cavity(tmp_path / "port", tcli), _cavity(tmp_path / "ref", jcli)
    case = TCase(td, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        tapps.run(case, max_steps=4)
        jrun(jd, max_steps=4)
    got, ref = _rows(td), _rows(jd)
    assert len(got) == len(ref) == 4
    assert [r[0] for r in got] == [r[0] for r in ref]
    np.testing.assert_allclose([float(r[1]) for r in got],
                               [float(r[1]) for r in ref], rtol=1e-6)
    # tests/test_fo_coded.py's oracle: |U|max approaches the lid speed
    assert 0.5 < float(got[-1][1]) <= 1.2
    fol = case.function_objects
    assert fol.failures == 0 and fol.executes == 4
    assert fol.objects[0].store == {"n": 4}


def test_a_failing_snippet_is_counted_and_the_run_goes_on(tmp_path,
                                                          monkeypatch):
    bad = FUNCS.replace("jnp.max(", "jnp.cumsum(")
    d = _cavity(tmp_path, tcli, bad)
    monkeypatch.chdir(tmp_path)
    case = TCase(d, device="cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tapps.run(case, max_steps=2)
    assert case.time.index == 2
    assert case.function_objects.failed == {"maxU": 2}
    assert "functionObject maxU: jnp.cumsum" in out.getvalue()


@pytest.mark.parametrize("name", ["cumsum", "argmax", "fft"])
def test_names_outside_the_subset_raise_naming_themselves(name):
    with pytest.raises(NotImplementedError, match=f"jnp.{name}"):
        getattr(tnp, name)
    with pytest.raises(NotImplementedError, match="jnp.linalg.inv"):
        tnp.linalg.inv
    # dunder lookups stay AttributeErrors (copy, pickle, inspect)
    assert not hasattr(tnp, "__wrapped__")


X = np.random.default_rng(3).standard_normal((7, 3))


@pytest.mark.parametrize("expr,ref", [
    ("jnp.sum(x, axis=0)", lambda x: x.sum(axis=0)),
    ("jnp.sum(x)", lambda x: x.sum()),
    ("jnp.max(x, axis=1)", lambda x: x.max(axis=1)),
    ("jnp.min(x, axis=(0, 1))", lambda x: x.min()),
    ("jnp.mean(x, axis=0)", lambda x: x.mean(axis=0)),
    ("jnp.sqrt(jnp.abs(x))", lambda x: np.sqrt(np.abs(x))),
    ("jnp.where(x > 0, x, 0.0)", lambda x: np.where(x > 0, x, 0.0)),
    ("jnp.maximum(x, 0.1)", lambda x: np.maximum(x, 0.1)),
    ("jnp.minimum(x, 0.5 - x)", lambda x: np.minimum(x, 0.5 - x)),
    ("jnp.einsum('ij,ij->i', x, x)", lambda x: np.einsum("ij,ij->i", x, x)),
    ("jnp.stack([x[:, 0], x[:, 1]], axis=1)", lambda x: x[:, :2]),
    ("jnp.concatenate([x, x], axis=0)", lambda x: np.concatenate([x, x])),
    ("jnp.linalg.norm(x, axis=1)", lambda x: np.linalg.norm(x, axis=1)),
    ("jnp.linalg.norm(x)", lambda x: np.linalg.norm(x)),
    ("jnp.zeros((3, 2)) + jnp.ones(2)", lambda x: np.ones((3, 2))),
    ("jnp.zeros_like(x) + jnp.asarray(x)", lambda x: x),
])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_subset_computes_as_numpy(expr, ref, as_tensor):
    """Each name on a tensor (or a numpy array) computes what numpy does
    with the same axis=, in torch, on the CPU here; a tensor comes back
    for a tensor, a numpy array for numpy arrays and numbers."""
    x = torch.tensor(X) if as_tensor else X
    got = eval(expr, {"jnp": tnp, "x": x})  # noqa: S307 (test expressions)
    tensor_in = as_tensor and "x" in expr
    assert isinstance(got, torch.Tensor if tensor_in else np.ndarray)
    np.testing.assert_allclose(np.asarray(got), ref(X), rtol=1e-6,
                               atol=1e-7)


CODED_BODY = r"""
import json, sys
import numpy as np
import torch
from foamtpu.core.dictionary import parse_string as jparse
from foamtpu.mesh import blockmesh as jbm, to_device as jto
from foamtpu.models import fvoptions as jfvo
from foamtpu_torch.core.dictionary import parse_string as tparse
from foamtpu_torch.mesh import blockmesh as tbm, to_device as tto
from foamtpu_torch.models import fvoptions as tfvo

BM = '''
convertToMeters 1;
vertices ((0 0 0) (2 0 0) (2 1 0) (0 1 0) (0 0 0.1) (2 0 0.1) (2 1 0.1)
          (0 1 0.1));
blocks ( hex (0 1 2 3 4 5 6 7) (16 10 1) simpleGrading (1 1 1) );
boundary ( walls { type wall; faces ((3 7 6 2) (1 5 4 0) (0 4 7 3)
                                     (2 6 5 1)); }
           frontAndBack { type empty; faces ((0 3 2 1) (4 5 6 7)); } );
'''
SNIPPETS = json.loads(sys.argv[1])
mt, mj = tto(tbm.generate(tparse(BM)), "cpu"), jto(jbm.generate(jparse(BM)))
out = {}
for name, (kind, field, code) in SNIPPETS.items():
    text = ("src { type %s; selectionMode all; fields (%s); codeAddSup #{\n"
            "%s\n#}; }" % (kind, field, code))
    t = tfvo.from_dict(mt, tparse(text), nu=1e-5)
    j = jfvo.from_dict(mj, jparse(text), nu=1e-5)
    a = np.asarray(t.options[0].data["source"], dtype=float)
    b = np.asarray(j.options[0].data["source"], dtype=float)
    out[name] = {"shape": [list(a.shape), list(b.shape)],
                 "err": float(np.abs(a - b).max() / max(np.abs(b).max(),
                                                        1e-300)),
                 "scale": float(np.abs(b).max())}
print(json.dumps(out))
"""

SNIPPETS = {
    # tests/test_fvoptions.py's heater, with jnp.where
    "where": ("scalarCodedSource", "T",
              "source = jnp.where(C[:, 0] > 1.0, 5.0, 0.0)"),
    "radial": ("scalarCodedSource", "T",
               "r = jnp.linalg.norm(C - jnp.mean(C, axis=0), axis=1)\n"
               "source = jnp.maximum(1.0 - r, 0.0) * jnp.sqrt(V / "
               "jnp.max(V))"),
    "swirl": ("vectorCodedSource", "U",
              "x = C - jnp.asarray([1.0, 0.5, 0.05])\n"
              "w = jnp.stack([-x[:, 1], x[:, 0], jnp.zeros_like(V)], axis=1)\n"
              "source = w / jnp.maximum(jnp.einsum('ij,ij->i', x, x), "
              "0.01)[:, None]"),
    "stacked": ("vectorCodedSource", "U",
                "h = jnp.concatenate([C[:, :1], jnp.ones((V.shape[0], 2))], "
                "axis=1)\n"
                "source = h * jnp.sum(V) / jnp.min(V) - jnp.abs(C)"),
}


@pytest.fixture(scope="module")
def coded_sources():
    env = dict(os.environ)
    env.update(FOAMTPU_X64="1", JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", CODED_BODY,
                        json.dumps(SNIPPETS)], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_jnp_coded_source_matches_reference_f64(coded_sources, name):
    rec = coded_sources[name]
    assert rec["shape"][0] == rec["shape"][1]
    assert rec["scale"] > 0 and rec["err"] <= 1e-12, rec
