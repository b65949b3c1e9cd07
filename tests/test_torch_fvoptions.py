"""foamtpu_torch fvOptions (models/fvoptions.py) against the JAX package.

float64 parity, in one subprocess (FOAMTPU_X64=1 JAX_ENABLE_X64=1), with
the reference's calls jitted where they are traced:
- every option kind that the parser builds, from the same dictionary text
  through both packages' `from_dict`, then `OptionList.add_to` on the same
  matrix (converted from the reference's) with a seeded U and T, on the
  periodic channel of tests/test_fvoptions.py: semiImplicitSource (scalar
  and vector), meanVelocityForce (with a seeded gradient in the state),
  explicitPorositySource (rotated d and f, with and without a mixture
  rho/mu), DarcyForchheimer, actuationDiskSource,
  radialActuationDiskSource, codedSource and scalarCodedSource,
  fixedTemperatureConstraint, temperatureLimitsConstraint and MRFSource:
  source, diagonal and (for the constraints) every coefficient at rtol
  1e-12; `correct_U` (meanVelocityForce's gradient) and `init_state` too;
- meanVelocityForce driving the channel through 3 PISO steps (GAMG p,
  smoothSolver U): U, p and phi at rtol 1e-9, gradP equal at 1e-12, the
  Krylov and GAMG iteration counts equal;
- the rotated anisotropic porosity of tests/test_fvoptions.py (4^3 box)
  and the rotor disk of tests/test_rotordisk.py (32x32x2 box) with a
  seeded U large enough that the angle of attack leaves the profile
  table on both ends (the port's searchsorted interpolation against
  jnp.interp, end values included) and a three-row table, at 1e-12;
  rhoRef is parsed (as the reference parses it) and changes nothing;
- porousZones: the repair. A 40x8 channel whose controlDict names
  simpleFoam and that ships constant/porousZones, 3 SIMPLE iterations
  through both packages' `simplefoam(case)`: fields at rtol 1e-9 and the
  porous drag seen (the same run without the file differs by far more).
  Before the port read constant/porousZones it ran this case without the
  drag, silently.

In process: the codedSource snippet gives the same source as the
reference's test, written with np and with jnp (the port's subset,
utils/tnp.py; tests/test_torch_coded.py holds more jnp snippets against
the reference), and a jnp name outside the subset raises
NotImplementedError naming itself.
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

from foamtpu_torch.core.dictionary import parse_string as tparse
from foamtpu_torch.mesh import blockmesh as tblockmesh, to_device as tto

from test_torch_simple import REPO

torch.set_num_threads(2)

KINDS = """
semi { type semiImplicitSource; active true;
       semiImplicitSourceCoeffs { selectionMode all; volumeMode specific;
           injectionRateSuSp { T (5.0 -0.5); U ((1.5 -2.0 0) -0.25); } } }
mvf { type meanVelocityForce; active true;
      meanVelocityForceCoeffs { selectionMode all; fieldNames (U);
                                Ubar (1 0.2 0); } }
poro { type explicitPorositySource; active true;
       explicitPorositySourceCoeffs { selectionMode box;
           box ((0.5 0.1 -1) (1.5 0.8 1)); type DarcyForchheimer;
           DarcyForchheimerCoeffs { d (5e3 2e3 1e3); f (20 5 1);
               coordinateSystem { coordinateRotation {
                   e1 (0.8 0.6 0); e2 (-0.6 0.8 0); } } } } }
darcy { type DarcyForchheimer; active true; selectionMode all;
        d (100 100 100); f (0 0 0); }
disk { type actuationDiskSource; active true;
       actuationDiskSourceCoeffs { selectionMode box;
           box ((0.8 -1 -1) (1.2 2 2)); diskDir (1 0.5 0); Cp 0.386;
           Ct 0.58; diskArea 0.04; upstreamU 1.3; } }
rdisk { type radialActuationDiskSource; active true;
        radialActuationDiskSourceCoeffs { selectionMode box;
            box ((0.8 -1 -1) (1.2 2 2)); diskDir (1 0 0); Cp 0.3; Ct 0.6;
            diskArea 0.05; upstreamU 1.1; coeffs (0.1 0.5 0.01); } }
coded { type vectorCodedSource; selectionMode all; fields (U);
        codeAddSup #{
source = np.stack([np.sin(C[:, 0]), C[:, 1] ** 2, 0 * V], axis=1)
        #}; }
scoded { type scalarCodedSource; selectionMode all; fields (T);
         codeAddSup #{
source = np.where(C[:, 0] > 1.0, 5.0, -1.0) * V / V.mean()
         #}; }
mrf { type MRFSource; active true;
      MRFSourceCoeffs { selectionMode all; axis (0 0 2); omega 3.5; } }
fixT { type fixedTemperatureConstraint; active true;
       fixedTemperatureConstraintCoeffs { selectionMode box;
           box ((0.8 -1 -1) (1.2 2 2)); temperature 400; fieldNames (T); } }
limT { type temperatureLimitsConstraint; active true;
       temperatureLimitsConstraintCoeffs { selectionMode all; Tmin 280;
                                           Tmax 320; } }
off { type semiImplicitSource; active false;
      semiImplicitSourceCoeffs { selectionMode all;
          injectionRateSuSp { T (1e9 0); } } }
"""
KIND_NAMES = ["semi", "mvf", "poro", "poro_rho", "darcy", "disk", "rdisk",
              "coded", "scoded", "mrf", "fixT", "limT"]

ROTOR_TABLE = [[-30.0, (0.05, -1.2)], [0.0, (0.01, 0.1)], [25.0, (0.04, 1.4)]]

F64_BODY = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp
import numpy as np
import torch
import test_torch_fvoptions as T
print(json.dumps(getattr(T, sys.argv[2])()))
"""


def _rel(got, ref):
    g = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    r = np.asarray(ref)
    assert g.dtype == r.dtype == np.float64 and g.shape == r.shape
    if r.size == 0:
        return 0.0
    return float(np.abs(g - r).max() / max(np.abs(r).max(), 1e-300))


def _matrix_pair(jm, tm, field, kind):
    """The same matrix in both packages: the reference's (ddt + laplacian
    for T, ddt for U) and the port's conversion of it."""
    from foamtpu.core.dimensions import dimViscosity
    from foamtpu.ops import fvm as jfvm
    from foamtpu_torch.convert import matrix_from_numpy

    jeq = jfvm.ddt(jm, field, field.data, 10.0)
    if kind == "T":
        jeq = jeq - jfvm.laplacian(jm, 0.3, field, gamma_dims=dimViscosity)
    return jeq, matrix_from_numpy(jeq, device="cpu")


def _matrix_errs(teq, jeq):
    out = {}
    for name in ("diag", "source", "upper", "lower", "ic", "bc", "soff",
                 "sfb"):
        r = getattr(jeq, name)
        if r is None:
            continue
        out[name] = _rel(getattr(teq, name), r)
    return out


def kinds_parity():
    """Every kind through both packages' from_dict + add_to, and
    meanVelocityForce's correct_U and init_state."""
    from foamtpu_torch.models import fvoptions as tfvo
    import jax
    import jax.numpy as jnp

    from foamtpu.core.dictionary import parse_string as jparse
    from foamtpu.core.fields import vol_scalar as jvs
    from foamtpu.models import fvoptions as jfvo
    from foamtpu_torch.convert import field_from_numpy, mesh_from_numpy
    from test_fvoptions import T_bcs, _channel

    jm, jU, _ = _channel()
    tm = mesh_from_numpy(jm, device="cpu")
    rng = np.random.default_rng(7)
    n = jm.n_cells
    jU = jU.with_data(jnp.asarray(rng.standard_normal((n, 3))
                                  * [1.0, 0.5, 0.0] + [1.0, 0.0, 0.0]))
    jT = jvs(jm, 300.0, name="T", bcs=T_bcs(jm)).with_data(
        jnp.asarray(300.0 + 40.0 * rng.standard_normal(n)))
    tU = field_from_numpy(jU, device="cpu")
    tT = field_from_numpy(jT, device="cpu")
    rho = rng.uniform(1.0, 1000.0, n)
    mu = rng.uniform(1e-5, 1e-3, n)
    jd, td = jparse(KINDS), tparse(KINDS)
    out = {}
    for name in KIND_NAMES:
        key = "poro" if name == "poro_rho" else name
        jo = jfvo.OptionList([o for o in jfvo.from_dict(
            jm, jd, nu=1e-3).options if o.name == key])
        to = tfvo.OptionList([o for o in tfvo.from_dict(
            tm, td, nu=1e-3).options if o.name == key])
        assert len(jo.options) == len(to.options) == 1, name
        assert jo.options[0].kind == to.options[0].kind
        fname = "T" if name in ("scoded", "fixT", "limT") else "U"
        jf, tf = (jT, tT) if fname == "T" else (jU, tU)
        jeq, teq = _matrix_pair(jm, tm, jf, fname)
        kw_j, kw_t = {}, {}
        if name == "mvf":
            kw_j["fvopt_state"] = {"gradP_mvf": jnp.asarray(0.37)}
            kw_t["fvopt_state"] = {"gradP_mvf": torch.tensor(0.37,
                                                             dtype=torch.float64)}
        if name == "poro_rho":
            kw_j.update(rho=jnp.asarray(rho), mu=jnp.asarray(mu))
            kw_t.update(rho=torch.tensor(rho), mu=torch.tensor(mu))
        j2 = jo.add_to(jm, jeq, fname, jf, U=jU, **kw_j)
        t2 = to.add_to(tm, teq, fname, tf, U=tU, **kw_t)
        errs = _matrix_errs(t2, j2)
        # the option did change the equation
        changed = float(np.abs(np.asarray(j2.source - jeq.source)).max()
                        + np.abs(np.asarray(j2.diag - jeq.diag)).max())
        out[name] = {"errs": errs, "changed": changed,
                     "mask_err": _rel(to.options[0].mask,
                                      jo.options[0].mask)}
        if name == "mvf":
            rAU = rng.uniform(0.5, 2.0, n)
            jU2, jst = jo.correct_U(jm, jU, jnp.asarray(rAU),
                                    jo.init_state(jm))
            tU2, tst = to.correct_U(tm, tU, torch.tensor(rAU),
                                    to.init_state(tm))
            out[name]["correct_U"] = _rel(tU2.data, jU2.data)
            out[name]["gradP"] = _rel(tst["gradP_mvf"], jst["gradP_mvf"])
            out[name]["gradP_0d"] = tst["gradP_mvf"].ndim == 0
    # inactive options are skipped, by both
    out["n_active"] = [len(jfvo.from_dict(jm, jd).options),
                       len(tfvo.from_dict(tm, td).options)]
    return out


def mean_velocity_piso():
    """The channel driven by meanVelocityForce, 3 PISO steps."""
    from foamtpu_torch.models import fvoptions as tfvo
    import jax
    import jax.numpy as jnp

    from foamtpu.core.dictionary import parse_string as jparse
    from foamtpu.models import fvoptions as jfvo
    from foamtpu.solvers import piso as jpiso
    from foamtpu.solvers.linear.gamg import GAMG as JGAMG
    from foamtpu_torch.convert import field_from_numpy, mesh_from_numpy
    from foamtpu_torch.solvers import piso as tpiso
    from foamtpu_torch.solvers.linear.gamg import GAMG as TGAMG
    from test_fvoptions import _channel

    text = """momentumSource { type meanVelocityForce; active true;
        meanVelocityForceCoeffs { selectionMode all; fieldNames (U);
                                  Ubar (1 0 0); } }"""
    jm, jU, jp = _channel()
    tm = mesh_from_numpy(jm, device="cpu")
    # a seeded disturbance, so that p and Uy are flow and not round-off
    # (on the uniform start both stay at 1e-15 and their solves' counts
    # are decided by round-off)
    rng = np.random.default_rng(5)
    jU = jU.with_data(jU.data + jnp.asarray(
        0.2 * rng.standard_normal((jm.n_cells, 3)) * [1.0, 1.0, 0.0]))
    jo, to = jfvo.from_dict(jm, jparse(text)), tfvo.from_dict(tm, tparse(text))
    ctl = {"solver": "GAMG", "tolerance": 1e-8, "relTol": 0.0}
    uctl = {"solver": "smoothSolver", "tolerance": 1e-9, "relTol": 0.0,
            "maxIter": 1000, "nSweeps": 2}
    jcfg = jpiso.PisoConfig(nu=0.01, n_correctors=2, fv_options=jo,
                            p_controls=dict(ctl, _gamg=JGAMG(jm)),
                            u_controls=uctl)
    tcfg = tpiso.PisoConfig(nu=0.01, n_correctors=2, fv_options=to,
                            p_controls=dict(ctl, _gamg=TGAMG(tm)),
                            u_controls=uctl)
    js = jpiso.initial_state(jm, jU, jp, project=False)
    js["fvopt"] = jo.init_state(jm)
    ts = tpiso.initial_state(tm, field_from_numpy(jU, device="cpu"),
                             field_from_numpy(jp, device="cpu"),
                             project=False)
    ts["fvopt"] = to.init_state(tm)
    jstep = jax.jit(lambda s, d_: jpiso.piso_step(jm, s, d_, jcfg))
    iters = {"ref": [], "port": []}
    for _ in range(3):
        js, jd = jstep(js, jnp.asarray(0.05))
        ts, td = tpiso.piso_step(tm, ts, 0.05, tcfg)
        for tag, d in (("ref", jd), ("port", td)):
            iters[tag].append(np.atleast_1d(np.asarray(d["Ux"].n_iterations)).tolist()
                              + [int(np.asarray(d["p_iters"]))])
    return {"U": _rel(ts["U"].data, js["U"].data),
            "p": _rel(ts["p"].data, js["p"].data),
            "phi": _rel(ts["phi"], js["phi"]),
            "gradP": _rel(ts["fvopt"]["gradP_momentumSource"],
                          js["fvopt"]["gradP_momentumSource"]),
            "gradP_value": float(ts["fvopt"]["gradP_momentumSource"]),
            "iters": iters}


def porosity_and_rotor():
    """The rotated porosity of test_fvoptions and the rotor disk of
    test_rotordisk, through both packages."""
    from foamtpu_torch.models import fvoptions as tfvo
    import jax
    import jax.numpy as jnp

    from foamtpu.core.dictionary import FoamDict as JDict
    from foamtpu.core.dictionary import parse_string as jparse
    from foamtpu.core.dimensions import DimensionSet
    from foamtpu.core.fields import vol_vector as jvv
    from foamtpu.mesh import blockmesh as jbm, to_device as jto
    from foamtpu.models import fvoptions as jfvo
    from foamtpu.ops.matrix import zero_matrix as jzero
    from foamtpu_torch.convert import field_from_numpy, mesh_from_numpy
    from foamtpu_torch.core.dictionary import FoamDict as TDict
    from foamtpu_torch.ops.matrix import zero_matrix as tzero
    import test_rotordisk as R

    out = {}
    box4 = """convertToMeters 1;
vertices ((0 0 0) (1 0 0) (1 1 0) (0 1 0) (0 0 1) (1 0 1) (1 1 1) (0 1 1));
blocks ( hex (0 1 2 3 4 5 6 7) (4 4 4) simpleGrading (1 1 1) );
boundary ( walls { type wall; faces ((2 6 5 1) (0 4 7 3) (1 5 4 0)
    (3 7 6 2) (0 3 2 1) (4 5 6 7)); } );"""
    spec = """porosity { type explicitPorositySource; active true;
  explicitPorositySourceCoeffs { selectionMode all;
    DarcyForchheimerCoeffs { d (100 1 1); f (0 0 0);
      coordinateSystem { coordinateRotation {
        e1 (0.7071067811865476 0.7071067811865476 0); e3 (0 0 1); } } } } }"""
    jm = jto(jbm.generate(jparse(box4)))
    tm = mesh_from_numpy(jm, device="cpu")
    jU = jvv(jm, (1.0, 0.0, 0.0), name="U")
    tU = field_from_numpy(jU, device="cpu")
    dims = DimensionSet.of(0, 4, -2)
    jeq = jfvo.from_dict(jm, jparse(spec), nu=1.0).add_to(
        jm, jzero(jm, 3, dims=dims), "U", jU, U=jU)
    teq = tfvo.from_dict(tm, tparse(spec), nu=1.0).add_to(
        tm, tzero(tm, 3), "U", tU, U=tU)
    v0 = float(np.asarray(jm.v)[0])
    out["aniso"] = {"diag": _rel(teq.diag, jeq.diag),
                    "source": _rel(teq.source, jeq.source),
                    # the analytic numbers of tests/test_fvoptions.py
                    "iso_per_v": float(teq.diag[0]) / v0,
                    "src_per_v": (teq.source[0] / v0).tolist()}

    jm = R._mesh_U()[0]
    tm = mesh_from_numpy(jm, device="cpu")
    rng = np.random.default_rng(11)
    n = jm.n_cells
    # |U| up to ~3x the tip speed: inflow angles on both sides of the
    # table's ends
    u = rng.standard_normal((n, 3)) * [40.0, 40.0, 60.0]
    jU = jvv(jm, jnp.zeros(3), name="U").with_data(jnp.asarray(u))
    tU = field_from_numpy(jU, device="cpu")
    rot = {}
    for tag, over in (("default", {}), ("table3", {"rhoRef": 1000.0}),
                      ("rhoRef", {"rhoRef": 1000.0})):
        jspec, tspec = R._rotor_spec(**over), _rotor_spec_port()
        tspec.update(over)
        if tag == "table3":
            for spec, D in ((jspec, JDict), (tspec, TDict)):
                spec["profiles"] = D([("profile1", D([
                    ("type", "lookup"), ("data", ROTOR_TABLE)]))])
        jo = jfvo.from_dict(jm, JDict([("rotor", jspec)]))
        to = tfvo.from_dict(tm, TDict([("rotor", tspec)]))
        jeq = jo.add_to(jm, jzero(jm, 3, dims=dims), "U", jU, U=jU)
        teq = to.add_to(tm, tzero(tm, 3), "U", tU, U=tU)
        d = to.options[0].data
        # the angle of attack each zone cell sees (the port's own numbers)
        m = to.options[0].mask.numpy() > 0
        axis, e_t = d["axis"], d["e_t"]
        w_t = d["omega"] * d["r_cell"] - np.sum(u * e_t, axis=1)
        phi = np.arctan2(-(u @ axis), np.where(np.abs(w_t) > 1e-12, w_t,
                                               1e-12))
        alpha = (d["twist_cell"] - phi)[m]
        rot[tag] = {"source": _rel(teq.source, jeq.source),
                    "below": int(np.sum(alpha < d["aoa_tab"][0])),
                    "above": int(np.sum(alpha > d["aoa_tab"][-1])),
                    "inside": int(np.sum((alpha > d["aoa_tab"][0])
                                         & (alpha < d["aoa_tab"][-1]))),
                    "n_table": int(len(d["aoa_tab"])),
                    "rhoRef": [float(d["rhoRef"]),
                               float(jo.options[0].data["rhoRef"])],
                    "norm": float(np.abs(teq.source.numpy()).max())}
    out["rotor"] = rot
    return out


def _rotor_spec_port():
    """tests/test_rotordisk.py::_rotor_spec in the port's FoamDict."""
    import test_rotordisk as R
    from foamtpu_torch.core.dictionary import FoamDict as TDict

    return TDict([
        ("type", "rotorDiskSource"), ("selectionMode", "all"),
        ("fields", ["U"]), ("rpm", R.RPM), ("nBlades", 3),
        ("tipEffect", 1.0), ("origin", [(0.0, 0.0, 0.1)]),
        ("axis", [(0.0, 0.0, 1.0)]),
        ("blade", TDict([("data", [[R.R1, (R.TWIST, R.CHORD)],
                                   [R.R2, (R.TWIST, R.CHORD)]])])),
        ("profiles", TDict([("profile1", TDict([
            ("type", "lookup"),
            ("data", [[-90.0, (R.CD0, -R.CL_PER_RAD * np.pi / 2)],
                      [90.0, (R.CD0, R.CL_PER_RAD * np.pi / 2)]])]))]))])


# ---------------------------------------------------------------------------
# porousZones in a simpleFoam case: the repair
# ---------------------------------------------------------------------------

CHANNEL = {
    "system/controlDict": """FoamFile { version 2.0; format ascii;
    class dictionary; object controlDict; }
application simpleFoam; startFrom startTime; startTime 0; stopAt endTime;
endTime 3; deltaT 1; writeControl timeStep; writeInterval 100;
writeFormat ascii;
""",
    "system/fvSchemes": """FoamFile { version 2.0; format ascii;
    class dictionary; object fvSchemes; }
ddtSchemes { default steadyState; }
gradSchemes { default Gauss linear; }
divSchemes { default none; div(phi,U) Gauss upwind; }
laplacianSchemes { default Gauss linear corrected; }
interpolationSchemes { default linear; }
snGradSchemes { default corrected; }
""",
    "system/fvSolution": """FoamFile { version 2.0; format ascii;
    class dictionary; object fvSolution; }
solvers
{
    p { solver PCG; preconditioner DIC; tolerance 1e-10; relTol 0; }
    U { solver PBiCGStab; preconditioner DILU; tolerance 1e-10;
        relTol 0; }
}
SIMPLE { nNonOrthogonalCorrectors 0; }
relaxationFactors { fields { p 0.3; } equations { U 0.7; } }
""",
    "constant/transportProperties": """FoamFile { version 2.0;
    format ascii; class dictionary; object transportProperties; }
transportModel Newtonian;
nu nu [0 2 -1 0 0 0 0] 0.01;
""",
    "constant/polyMesh/blockMeshDict": """FoamFile { version 2.0;
    format ascii; class dictionary; object blockMeshDict; }
convertToMeters 1;
vertices ((0 0 0) (4 0 0) (4 1 0) (0 1 0)
          (0 0 0.1) (4 0 0.1) (4 1 0.1) (0 1 0.1));
blocks ( hex (0 1 2 3 4 5 6 7) (40 8 1) simpleGrading (1 1 1) );
boundary
(
    inlet { type patch; faces ((0 4 7 3)); }
    outlet { type patch; faces ((2 6 5 1)); }
    walls { type wall; faces ((3 7 6 2) (1 5 4 0)); }
    frontAndBack { type empty; faces ((0 3 2 1) (4 5 6 7)); }
);
""",
    "constant/porousZones": """FoamFile { version 2.0; format ascii;
    class dictionary; object porousZones; }
1
(
    filter
    {
        selectionMode   box;
        box             (1.5 0 -1) (2.5 0.6 1);
        coordinateSystem { coordinateRotation {
            e1 (0.8 0.6 0); e3 (0 0 1); } }
        Darcy
        {
            d   d [0 -2 0 0 0 0 0] (400 100 100);
            f   f [0 -1 0 0 0 0 0] (2 1 1);
        }
    }
)
""",
    "0/U": """FoamFile { version 2.0; format ascii; class volVectorField;
    object U; }
dimensions [0 1 -1 0 0 0 0];
internalField uniform (0 0 0);
boundaryField
{
    inlet { type fixedValue; value uniform (1 0 0); }
    outlet { type zeroGradient; }
    walls { type fixedValue; value uniform (0 0 0); }
    frontAndBack { type empty; }
}
""",
    "0/p": """FoamFile { version 2.0; format ascii; class volScalarField;
    object p; }
dimensions [0 2 -2 0 0 0 0];
internalField uniform 0;
boundaryField
{
    inlet { type zeroGradient; }
    outlet { type fixedValue; value uniform 0; }
    walls { type zeroGradient; }
    frontAndBack { type empty; }
}
""",
}


def write_channel(root, porous=True):
    for rel, text in CHANNEL.items():
        if rel == "constant/porousZones" and not porous:
            continue
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
    return root


def porous_channel(root):
    """3 SIMPLE iterations of the channel through both packages'
    simplefoam(case), and the port's run without the porousZones file."""
    from foamtpu.apps.cli import main as jcli
    from foamtpu.core.case import Case as JCase
    from foamtpu.solvers.apps import simplefoam as jsimple
    from foamtpu_torch.apps.cli import main as tcli
    from foamtpu_torch.core.case import Case as TCase
    from foamtpu_torch.solvers.apps import simplefoam as tsimple

    os.environ["FOAMTPU_CHUNK"] = "3"
    cases = {}
    for tag, cli, porous in (("ref", jcli, True), ("port", tcli, True),
                             ("bare", tcli, False)):
        d = write_channel(os.path.join(root, tag), porous)
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli(["blockMesh", "-case", d]) == 0
            case = JCase(d) if tag == "ref" else TCase(d, device="cpu")
            (jsimple if tag == "ref" else tsimple)(case)
        cases[tag] = case
    ref, port, bare = (cases[k].final_state for k in ("ref", "port", "bare"))
    out = {"index": [cases[k].time.index for k in ("ref", "port")]}
    for name in ("U", "p"):
        out[name] = _rel(port[name].data, ref[name].data)
        out["bare_" + name] = _rel(bare[name].data, ref[name].data)
    out["phi"] = _rel(port["phi"], ref["phi"])
    return out


def f64_results():
    return {"kinds": kinds_parity(), "piso": mean_velocity_piso(),
            "geometry": porosity_and_rotor()}


def porous_results():
    import tempfile

    return porous_channel(tempfile.mkdtemp())


def run_f64(fn):
    env = dict(os.environ)
    env.update(FOAMTPU_X64="1", JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", F64_BODY, os.path.dirname(__file__), fn],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def f64():
    return run_f64("f64_results")


@pytest.mark.parametrize("kind", KIND_NAMES)
def test_option_kind_matches_reference_f64(f64, kind):
    res = f64["kinds"][kind]
    assert res["changed"] > 0, kind
    assert res["mask_err"] == 0.0
    assert {"diag", "source"} <= set(res["errs"])
    for name, err in res["errs"].items():
        assert err <= 1e-12, (kind, name, err)
    if kind == "mvf":
        assert res["correct_U"] <= 1e-12 and res["gradP"] <= 1e-12
        assert res["gradP_0d"]
    if kind in ("fixT", "limT"):        # the constraints edit the rows
        assert {"upper", "lower"} <= set(res["errs"])
    assert f64["kinds"]["n_active"] == [11, 11]     # "off" is inactive


def test_mean_velocity_force_piso_matches_reference_f64(f64):
    res = f64["piso"]
    for name in ("U", "p", "phi"):
        assert res[name] <= 1e-9, (name, res[name])
    assert res["gradP"] <= 1e-12 and res["gradP_value"] > 0
    assert res["iters"]["port"] == res["iters"]["ref"]


def test_rotated_porosity_matches_reference_f64(f64):
    res = f64["geometry"]["aniso"]
    assert res["diag"] <= 1e-12 and res["source"] <= 1e-12
    # C = R diag(100,1,1) R^T, iso = tr/3 = 34, source -(C - iso I) U
    np.testing.assert_allclose(res["iso_per_v"], 34.0, rtol=1e-12)
    np.testing.assert_allclose(res["src_per_v"], [-16.5, -49.5, 0.0],
                               atol=1e-10)


@pytest.mark.parametrize("table", ["default", "table3", "rhoRef"])
def test_rotor_disk_matches_reference_f64(f64, table):
    rot = f64["geometry"]["rotor"]
    res = rot[table]
    assert res["source"] <= 1e-12, res
    # the seeded inflow reaches both ends of the table and its inside
    assert res["below"] > 0 and res["above"] > 0 and res["inside"] > 0
    assert res["n_table"] == (3 if table == "table3" else 2)
    # rhoRef is parsed as the reference parses it, and changes nothing
    assert res["rhoRef"][0] == res["rhoRef"][1]
    if table == "rhoRef":
        assert res["rhoRef"][0] == 1000.0
        assert res["norm"] == rot["default"]["norm"]


def test_porous_zones_in_a_simplefoam_case_f64():
    """The repair: constant/porousZones of a simpleFoam case is read (a
    process of its own, so that it fails alone where the port ignores
    the file)."""
    res = run_f64("porous_results")
    assert res["index"] == [3, 3]
    for name in ("U", "p", "phi"):
        assert res[name] <= 1e-9, (name, res[name])
    # without the file the port's channel is another flow
    assert res["bare_U"] > 1e-3 and res["bare_p"] > 1e-2


# ---------------------------------------------------------------------------
# codedSource, in process
# ---------------------------------------------------------------------------

CHANNEL_BM = """
convertToMeters 1;
vertices ((0 0 0) (2 0 0) (2 1 0) (0 1 0) (0 0 0.1) (2 0 0.1) (2 1 0.1)
          (0 1 0.1));
blocks ( hex (0 1 2 3 4 5 6 7) (16 10 1) simpleGrading (1 1 1) );
boundary ( walls { type wall; faces ((3 7 6 2) (1 5 4 0) (0 4 7 3)
                                     (2 6 5 1)); }
           frontAndBack { type empty; faces ((0 3 2 1) (4 5 6 7)); } );
"""


def test_coded_source_snippet():
    """tests/test_fvoptions.py's snippet gives its source with np and with
    jnp; a jnp name outside the port's subset is refused by name."""
    from foamtpu_torch.models import fvoptions as tfvo
    from foamtpu_torch.core.fields import vol_scalar
    from foamtpu_torch.ops import fvm

    mesh = tto(tblockmesh.generate(tparse(CHANNEL_BM)), device="cpu")
    c0 = float(mesh.c[:, 0].mean())
    code = ("heater { type scalarCodedSource; selectionMode all; "
            "fields (T); codeAddSup #{\nsource = np.where(C[:, 0] > %r, "
            "5.0, 0.0)\n#}; }" % c0)
    opts = tfvo.from_dict(mesh, tparse(code), nu=1e-5)
    T = vol_scalar(mesh, 0.0, name="T")
    eqn = fvm.ddt(mesh, T, T.data, 1.0 / 0.1)
    ds = (opts.add_to(mesh, eqn, "T", T).source - eqn.source).numpy()
    c, v = mesh.c.numpy(), mesh.v.numpy()
    hot = c[:, 0] > c0
    assert hot.any() and (~hot).any()
    np.testing.assert_allclose(ds[hot], 5.0 * v[hot], rtol=1e-6)
    np.testing.assert_allclose(ds[~hot], 0.0)
    with_jnp = tfvo.from_dict(mesh, tparse(code.replace("np.where",
                                                        "jnp.where")))
    ds_jnp = (with_jnp.add_to(mesh, eqn, "T", T).source - eqn.source).numpy()
    np.testing.assert_array_equal(ds_jnp, ds)
    bad = code.replace("np.where", "jnp.select")
    with pytest.raises(NotImplementedError, match="jnp.select"):
        tfvo.from_dict(mesh, tparse(bad))


def test_options_are_read_from_the_case(tmp_path):
    """from_case: system/fvOptions, then constant/porousZones; None
    without either."""
    from foamtpu_torch.models import fvoptions as tfvo
    from foamtpu_torch.apps.cli import main as tcli
    from foamtpu_torch.core.case import Case as TCase

    d = write_channel(str(tmp_path / "c"))
    with contextlib.redirect_stdout(io.StringIO()):
        assert tcli(["blockMesh", "-case", d]) == 0
    opts = tfvo.from_case(TCase(d, device="cpu"), nu=0.01)
    assert [(o.name, o.kind) for o in opts.options] == [
        ("filter", "explicitPorositySource")]
    zone = opts.options[0].mask.numpy()
    assert 0 < zone.sum() < zone.size
    with open(os.path.join(d, "system", "fvOptions"), "w") as f:
        f.write("src { type semiImplicitSource; semiImplicitSourceCoeffs "
                "{ selectionMode all; injectionRateSuSp { U ((1 0 0) 0); }"
                " } }\n")
    opts = tfvo.from_case(TCase(d, device="cpu"), nu=0.01)
    assert [o.name for o in opts.options] == ["src", "filter"]
    os.remove(os.path.join(d, "system", "fvOptions"))
    os.remove(os.path.join(d, "constant", "porousZones"))
    assert tfvo.from_case(TCase(d, device="cpu")) is None
    shutil.rmtree(d)
