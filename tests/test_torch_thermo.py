"""foamtpu_torch's models/thermo.py against the JAX package's.

Every class's methods (p, rho, e, T_from_e, c, psi, Cp_of, mu_T, kappa,
h, T_from_h, and the properties Cp, Cv, gamma) on seeded T and p in
float64, in a process of its own (FOAMTPU_X64=1 JAX_ENABLE_X64=1), at
rtol 1e-12; JanafGas on temperatures across T_common and outside
[T_low, T_high] (the clip) and with Sutherland transport. `from_dict` on
every compressible and buoyant tutorial's constant/thermophysicalProperties
and on the janaf, one-line-mixture and equation-of-state dictionaries
builds the same dataclass with the same constants (host code, compared in
this process). Then the physics of tests/test_thermo_janaf.py through the
port: Cp of N2, T_from_h's round trip and the Newton loop's order of
update and clip.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from foamtpu_torch.core.dictionary import parse_string as tparse
from foamtpu_torch.models import thermo as tthermo

from test_torch_simple import REPO

JANAF = """
thermoType hePsiThermo<pureMixture<sutherland<janaf<perfectGas<specie>>,sensibleEnthalpy>>>;
mixture
{
    specie { nMoles 1; molWeight 28.0134; }
    thermodynamics
    {
        Tlow 200; Thigh 6000; Tcommon 1000;
        highCpCoeffs ( 2.92664 1.4879768e-3 -5.68476e-7 1.0097038e-10
                       -6.753351e-15 -922.7977 5.980528 );
        lowCpCoeffs  ( 3.298677 1.4082404e-3 -3.963222e-6 5.641515e-9
                       -2.444854e-12 -1020.8999 3.950372 );
    }
    transport { As 1.4792e-06; Ts 116; }
}
"""

# the other parse paths of from_dict: the 2.2 one-line mixture and the
# four thermoType-selected equations of state
DICTS = {
    "janaf": JANAF,
    "one_line": """
thermoType hPsiThermo<pureMixture<constTransport<specieThermo<hConstThermo<perfectGas>>>>>;
mixture air 1 28.9 1007 0 1.8e-05 0.7;
""",
    "incompressiblePerfectGas": """
thermoType heRhoThermo<pureMixture<const<hConst<incompressiblePerfectGas<specie>>,sensibleEnthalpy>>>;
mixture
{
    specie { nMoles 1; molWeight 28.9; }
    equationOfState { pRef 1e5; }
    thermodynamics { Cp 1000; Hf 0; }
    transport { mu 1.8e-05; Pr 0.7; }
}
""",
    "rhoConst": """
thermoType heRhoThermo<pureMixture<const<hConst<rhoConst<specie>>,sensibleEnthalpy>>>;
mixture
{
    specie { nMoles 1; molWeight 18; }
    equationOfState { rho 998; }
    thermodynamics { Cp 4195; Hf 0; }
    transport { mu 3.6e-4; Pr 2.289; }
}
""",
    "icoPolynomial": """
thermoType heRhoThermo<pureMixture<polynomial<hPolynomial<icoPolynomial<specie>>,sensibleEnthalpy>>>;
mixture
{
    specie { nMoles 1; molWeight 18; }
    equationOfState { rhoCoeffs<8> ( 1000 -0.05 -0.003 0 0 0 0 0 ); }
    thermodynamics { Cp 4195; Hf 0; }
    transport { mu 3.6e-4; Pr 2.289; }
}
""",
    "adiabaticPerfectFluid": """
thermoType heRhoThermo<pureMixture<const<hConst<adiabaticPerfectFluid<specie>>,sensibleEnthalpy>>>;
mixture
{
    specie { nMoles 1; molWeight 18; }
    equationOfState { rho0 1027; p0 1e5; B 3e8; gamma 7.1; }
    thermodynamics { Cp 4195; Hf 0; }
    transport { mu 3.6e-4; Pr 2.289; }
}
""",
}

TUTORIAL_DICTS = sorted(
    glob.glob(os.path.join(REPO, "tutorials", "compressible", "*", "*",
                           "constant", "thermophysicalProperties"))
    + glob.glob(os.path.join(REPO, "tutorials", "heatTransfer", "buoyant*",
                             "*", "constant", "thermophysicalProperties")))


def _fields(g):
    import dataclasses

    return {f.name: getattr(g, f.name) for f in dataclasses.fields(g)}


@pytest.mark.parametrize("path", TUTORIAL_DICTS,
                         ids=lambda p: os.path.relpath(p, REPO).split(
                             os.sep)[2])
def test_from_dict_reads_each_tutorial_as_the_reference(path):
    from foamtpu.core.dictionary import parse_file as jparse_file
    from foamtpu.models import thermo as jthermo
    from foamtpu_torch.core.dictionary import parse_file

    g, r = (tthermo.from_dict(parse_file(path)),
            jthermo.from_dict(jparse_file(path)))
    assert type(g).__name__ == type(r).__name__ == "PerfectGas"
    assert _fields(g) == _fields(r)
    assert (g.Cp, g.Cv, g.gamma) == (r.Cp, r.Cv, r.gamma)


@pytest.mark.parametrize("name", list(DICTS))
def test_from_dict_parse_paths_match_reference(name):
    from foamtpu.core.dictionary import parse_string as jparse
    from foamtpu.models import thermo as jthermo

    g, r = (tthermo.from_dict(tparse(DICTS[name])),
            jthermo.from_dict(jparse(DICTS[name])))
    assert type(g).__name__ == type(r).__name__
    got, ref = _fields(g), _fields(r)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k], dtype=float),
                                      np.asarray(ref[k], dtype=float),
                                      err_msg=f"{name} {k}")
    base = tthermo.from_dict_perfect(tparse(DICTS[name]))
    assert type(base).__name__ in ("PerfectGas", "JanafGas")


# -- the methods in float64 against the reference --------------------------

F64_BODY = r"""
import json, sys
import numpy as np
import torch
import jax.numpy as jnp
from foamtpu.core.dictionary import parse_string as jparse
from foamtpu.models import thermo as J
from foamtpu_torch.core.dictionary import parse_string as tparse
from foamtpu_torch.models import thermo as P
sys.path.insert(0, "tests")
from test_torch_thermo import DICTS

rng = np.random.default_rng(11)
# T across T_common, below T_low and above T_high (the clip), p ~ 1 bar
T = np.concatenate([rng.uniform(150.0, 7000.0, 60),
                    [199.0, 200.0, 999.999, 1000.0, 1000.001, 6000.0,
                     6001.0]])
p = 1e5 * (1.0 + 0.2 * rng.standard_normal(T.shape))
rho = p / (287.0 * T)
e = 717.5 * T


def pairs():
    yield "PerfectGas", J.PerfectGas(), P.PerfectGas()
    yield ("PerfectGas_sutherland",
           J.PerfectGas(mu=1e-5, sutherland_As=1.458e-6),
           P.PerfectGas(mu=1e-5, sutherland_As=1.458e-6))
    yield "JanafGas", J.JanafGas(), P.JanafGas()
    for name, text in DICTS.items():
        yield name, J.from_dict(jparse(text)), P.from_dict(tparse(text))


out = {}
for name, jg, tg in pairs():
    errs = {}
    calls = {"p": (rho, T), "rho": (p, T), "c": (T,), "psi": (T,),
             "Cp_of": (T,), "mu_T": (T,)}
    if hasattr(jg, "e"):
        calls.update(e=(T,), T_from_e=(e,), kappa=(T,))
    if hasattr(jg, "h"):
        calls.update(h=(T,))
    for meth, args in calls.items():
        r = np.asarray(getattr(jg, meth)(*[jnp.asarray(a) for a in args]))
        g = getattr(tg, meth)(*[torch.tensor(a) for a in args])
        g = np.asarray(g.numpy() if isinstance(g, torch.Tensor) else g)
        r = np.broadcast_to(r, np.broadcast_shapes(r.shape, g.shape))
        scale = max(float(np.abs(r).max()), 1e-300)
        errs[meth] = {"dtype": str(g.dtype), "shape": [list(g.shape),
                                                       list(r.shape)],
                      "err": float(np.abs(g - r).max() / scale)}
    if hasattr(jg, "T_from_h"):
        h = np.asarray(jg.h(jnp.asarray(T)))
        r = np.asarray(jg.T_from_h(jnp.asarray(h)))
        g = tg.T_from_h(torch.tensor(h)).numpy()
        errs["T_from_h"] = {"dtype": str(g.dtype), "shape": [[], []],
                            "err": float(np.abs(g - r).max() / 7000.0)}
        r = np.asarray(jg.T_from_h(jnp.asarray(h), jnp.asarray(T * 0.9)))
        g = tg.T_from_h(torch.tensor(h), torch.tensor(T * 0.9)).numpy()
        errs["T_from_h_guess"] = {"dtype": str(g.dtype), "shape": [[], []],
                                  "err": float(np.abs(g - r).max() / 7000.0)}
    props = {k: [getattr(tg, k), getattr(jg, k)]
             for k in ("Cp", "Cv", "gamma") if hasattr(jg, k)}
    out[name] = {"errs": errs, "props": props}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def f64_run():
    env = dict(os.environ)
    env.update(FOAMTPU_X64="1", JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", F64_BODY], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["PerfectGas", "PerfectGas_sutherland",
                                  "JanafGas", *DICTS])
def test_methods_match_reference_f64(f64_run, name):
    rec = f64_run[name]
    assert len(rec["errs"]) >= 9, rec
    for meth, e in rec["errs"].items():
        assert e["dtype"] == "float64", (name, meth, e)
        assert e["shape"][0] == e["shape"][1] or not e["shape"][0], (
            name, meth, e)
        assert e["err"] <= 1e-12, (name, meth, e)
    for k, (g, r) in rec["props"].items():
        assert g == r, (name, k, g, r)


# -- tests/test_thermo_janaf.py's physics through the port -----------------


def test_janaf_values_and_round_trip():
    """N2's Cp at 300 and 2000 K, the branch continuity at Tcommon, and
    T_from_h(h(T)) == T (float32, the tests' default dtype); the Newton
    loop clips after each update, so a start far outside [T_low, T_high]
    still converges."""
    g = tthermo.JanafGas(R=8314.47 / 28.0134)
    cp = g.Cp_of(torch.tensor([300.0, 2000.0, 999.99, 1000.01]))
    assert abs(float(cp[0]) - 1040.0) < 15.0
    assert abs(float(cp[1]) - 1280.0) < 30.0
    assert abs(float(cp[2]) - float(cp[3])) < 2.0
    g = tthermo.JanafGas()
    T0 = torch.tensor([250.0, 600.0, 1500.0, 3000.0])
    T = g.T_from_h(g.h(T0))
    assert T.dtype == torch.float32
    assert float(torch.max(torch.abs(T - T0))) < 0.5
    T = g.T_from_h(g.h(T0), T_guess=torch.full_like(T0, 1e5))
    assert float(torch.max(torch.abs(T - T0))) < 0.5


def test_constant_properties_keep_the_tensor_device_and_dtype():
    g = tthermo.PerfectGas(R=287.0, Cv=717.5, mu=1.8e-5)
    T = torch.tensor([300.0, 400.0], dtype=torch.float64)
    assert float(g.Cp_of(T)) == g.Cp and g.Cp_of(T).dtype == torch.float64
    assert float(g.mu_T(T)) == 1.8e-5 and g.mu_T(T).dtype == torch.float64
    assert g.psi(T).dtype == torch.float64
