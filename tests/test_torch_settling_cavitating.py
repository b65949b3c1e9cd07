"""foamtpu_torch's settlingFoam (solvers/settling.py), cavitatingFoam and
sonicLiquidFoam (solvers/cavitating.py) against the JAX package, and the
registration and state conversion of the whole multiphase family.

In float64 (one process, FOAMTPU_X64=1 JAX_ENABLE_X64=1) both packages'
`run(case)` take 3 steps of the tank and throttle2D
(chip_smoke.SLICE13_CASES): the tank from a seeded start (as shipped it is
at rest with a uniform alpha, so its U is round-off of 1e-10 m/s), the
tank's p_rgh and throttle2D's p converged (stopped at relTol 0.05 and
0.01 they turn 1e-14 of round-off into 3e-10 and 2e-9 of the fields
within three steps). Fields at rtol 1e-9, every solve's iteration count
equal, the log lines and the written files
(tests/test_torch_ras_models.py's PARITY_BODY). sonicLiquidFoam runs
cavitatingFoam's step: its driver's config is held to the reference's
(the step's parity is throttle2D's; a JAX run of the 16,128-cell
decompressionTank would add 10 s to Tier-1).

Then (float32, this process): the tank and decompressionTank as shipped
through the port held to the oracles and the card's goldens; the twelve
application names
mapped as the reference registers them; `convert.state_from_numpy` on
every state key of the family, and `config_from_reference` on the nine
configs.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from foamtpu_torch import convert
from foamtpu_torch.solvers import apps as tapps

from test_torch_electromagnetics import assert_app_parity
from test_torch_multiphase_vof import assert_oracles_and_goldens
from test_torch_ras_models import parity

torch.set_num_threads(2)

STEPS = 3
CASES = ("settlingFoam", "cavitatingFoam")
# the solves whose final residual is round-off of a converged solve:
# throttle2D's p at the converged controls
TIGHT = {"cavitatingFoam": {"p": 1e-12}}


@pytest.fixture(scope="module")
def runs():
    return parity("slice13", STEPS, CASES)


@pytest.mark.parametrize("name", CASES)
def test_application_matches_reference_f64(runs, name):
    rec = runs[name]
    # converged solves end in round-off: their final residuals are held
    # below their tolerances in both packages; settlingFoam logs no solve,
    # as the reference's
    assert_app_parity(rec, STEPS, name, tight=TIGHT.get(name),
                      logs_solves=name != "settlingFoam")
    want = {"settlingFoam": {"U", "p_rgh", "alpha", "phi", "rho", "U0"},
            "cavitatingFoam": {"U", "p", "rho", "phi", "U0"}}[name]
    assert want == set(rec["errs"]), rec["errs"]


def _config_of(apps_mod, cav_mod, case):
    """The CavitatingConfig a package's cavitating_foam builds for
    sonicLiquidFoam, caught where the driver makes its step."""
    class Built(Exception):
        pass

    got = {}

    def make_step(mesh, cfg):
        got["cfg"] = cfg
        raise Built

    saved = cav_mod.make_step
    cav_mod.make_step = make_step
    try:
        apps_mod.cavitating_foam(case, sonic_liquid=True)
    except Built:
        pass
    finally:
        cav_mod.make_step = saved
    return got["cfg"]


def test_sonic_liquid_config_matches_reference(tmp_path):
    """sonicLiquidFoam is cavitatingFoam's step (held above on
    throttle2D) in its single-phase limit: the driver's config from
    decompressionTank (rhol0 = rho0 - psi p0, pSat -1e8, the PISO dict's
    correctors, the p and U controls) equals the reference's."""
    from foamtpu.core.case import Case as JCase
    from foamtpu.solvers import apps as japps
    from foamtpu.solvers import cavitating as jcav

    from foamtpu_torch.apps.cli import main as tcli
    from foamtpu_torch.core.case import Case as TCase
    from foamtpu_torch.solvers import cavitating as tcav

    import chip_smoke

    # the tank's blocks coarsened 8x per side (252 cells): the config does
    # not depend on the mesh, and the JAX package builds its mesh first
    d = chip_smoke.slice13_case(chip_smoke.REPO_DIR, str(tmp_path / "tank"),
                                "sonicLiquidFoam", None)
    chip_smoke._edit(chip_smoke.blockmesh_dict(d),
                     r"(hex\s*\([^)]*\)\s*)\((\d+) (\d+) 1\)",
                     lambda m: "{}({} {} 1)".format(m.group(1),
                                                    int(m.group(2)) // 8,
                                                    int(m.group(3)) // 8))
    with contextlib.redirect_stdout(io.StringIO()):
        assert tcli(["blockMesh", "-case", d]) == 0
    got = _config_of(tapps, tcav, TCase(d, device="cpu"))
    ref = _config_of(japps, jcav, JCase(d))
    assert got._fields == ref._fields
    for name in got._fields:
        a, b = getattr(got, name), getattr(ref, name)
        if isinstance(b, dict):
            a, b = ({k: v for k, v in x.items() if not k.startswith("_")}
                    for x in (a, b))
        assert a == b, (name, a, b)
    assert got.p_sat == -1e8 and got.psil == got.psiv


@pytest.mark.parametrize("name", ["settlingFoam", "sonicLiquidFoam"])
def test_tutorial_meets_oracles_and_card_goldens(tmp_path, name):
    """The tank as shipped (its parity above starts seeded) and
    decompressionTank through the port at the card's depth: the oracles
    and the goldens. throttle2D starts its parity as shipped; its oracles
    and goldens are the card's (chip_smoke.py's `multiphase` phase)."""
    assert_oracles_and_goldens(tmp_path, name)


REGISTERED = {
    "cavitatingFoam": "cavitating_foam",
    "compressibleInterFoam": "compressible_inter_foam",
    "twoPhaseEulerFoam": "two_phase_euler_foam",
    "bubbleFoam": "two_phase_euler_foam",
    "multiphaseEulerFoam": "multiphase_euler_foam",
    "twoLiquidMixingFoam": "two_liquid_mixing_foam",
    "MRFMultiphaseInterFoam": "multiphase_inter_foam",
    "multiphaseInterFoam": "multiphase_inter_foam",
    "interPhaseChangeFoam": "inter_phase_change_foam",
    "interMixingFoam": "inter_mixing_foam",
    "settlingFoam": "settling_foam",
}


def test_applications_are_registered_as_the_reference():
    """The twelve names of the slice, mapped as
    openfoam-2.2.x_tpu/solvers/apps.py registers them (sonicLiquidFoam:
    cavitating_foam with sonic_liquid=True); 82 names in all since the
    combustion slice's six, the topology-change slice's three and the
    Lagrangian slice's twelve."""
    import inspect

    for name, fn in REGISTERED.items():
        assert tapps.APPLICATIONS[name] is getattr(tapps, fn), name
    sonic = tapps.APPLICATIONS["sonicLiquidFoam"]
    assert "sonic_liquid=True" in inspect.getsource(sonic)
    assert len(tapps.APPLICATIONS) == 82


def _ref_field(data, kind="zeroGradient"):
    """A stand-in for the reference's VolField: data, one BC, a name and
    dimensions, as convert.field_from_numpy reads them."""
    from types import SimpleNamespace

    from foamtpu_torch.core.dimensions import dimless

    bc = SimpleNamespace(ref_value=np.zeros(1), ref_grad=np.zeros(1),
                         vfrac=np.ones(1), kind=kind, opts=())
    return SimpleNamespace(data=data, bcs=(bc,), name="f", dims=dimless)


def test_state_from_numpy_carries_every_multiphase_key():
    rng = np.random.default_rng(3)
    n, nf = 12, 30

    def draw(*shape):
        # the port's scalar type (float32 unless FOAMTPU_X64=1)
        return rng.random(shape).astype(np.float32)

    fields = {k: _ref_field(draw(*((n, 3) if k in ("Ua", "Ub", "U0", "U1",
                                                   "U2")
                                   else (n, 4) if k == "alphas" else (n,))))
              for k in ("Ua", "Ub", "alphas", "alpha1", "alpha2", "T",
                        "U0", "U1", "U2")}
    arrays = {k: draw(nf if k.startswith("phi") else n)
              for k in ("phia", "phib", "Ua0", "Ub0", "alpha0", "T0",
                        "p_abs", "dgdt")}
    arrays["phis"] = draw(nf, 3)
    arrays.update({f"U0_{i}": draw(n, 3) for i in range(3)})
    out = convert.state_from_numpy(dict(fields, **arrays), device="cpu")
    assert set(out) == set(fields) | set(arrays)
    for k, f in fields.items():
        np.testing.assert_array_equal(out[k].data.numpy(), f.data)
        assert out[k].bcs[0].kind == "zeroGradient"
    for k, a in arrays.items():
        assert torch.is_tensor(out[k])
        np.testing.assert_array_equal(out[k].numpy(), a)
    with pytest.raises(NotImplementedError, match="Ub1"):
        convert.state_from_numpy({"Ub1": draw(n)}, device="cpu")


def test_config_from_reference_takes_the_nine_configs():
    """Each of the nine configs of the family from the reference's
    NamedTuple of the same fields; InterMixingConfig's and
    PhaseChangeConfig's nested InterConfig converted too."""
    from foamtpu.solvers import (cavitating, compressibleinter, interfoam,
                                 intermixing, interphasechange,
                                 multiphaseeuler, multiphaseinter, settling,
                                 twoliquidmixing, twophaseeuler)

    from foamtpu_torch.solvers import cavitating as tcav
    from foamtpu_torch.solvers import compressibleinter as tci
    from foamtpu_torch.solvers import interfoam as tif
    from foamtpu_torch.solvers import intermixing as timx
    from foamtpu_torch.solvers import interphasechange as tipc
    from foamtpu_torch.solvers import multiphaseeuler as tmpe
    from foamtpu_torch.solvers import multiphaseinter as tmpi
    from foamtpu_torch.solvers import settling as tset
    from foamtpu_torch.solvers import twoliquidmixing as ttlm
    from foamtpu_torch.solvers import twophaseeuler as ttpe

    flow = interfoam.InterConfig(rho1=1.0, rho2=1000.0, nu1=1.5e-5,
                                 nu2=1e-6, sigma=0.07,
                                 p_controls={"solver": "PCG"})
    pairs = [
        (ttlm.TwoLiquidConfig, twoliquidmixing.TwoLiquidConfig(Dab=2e-6)),
        (timx.InterMixingConfig, intermixing.InterMixingConfig(flow=flow,
                                                               D23=1e-8)),
        (tipc.PhaseChangeConfig, interphasechange.PhaseChangeConfig(
            flow=flow, model="Kunz")),
        (tmpi.MultiphaseConfig, multiphaseinter.MultiphaseConfig(
            rhos=(1000.0, 1.0), nus=(1e-6, 1.5e-5), sigmas={(0, 1): 0.07})),
        (tci.CompIntConfig, compressibleinter.CompIntConfig(R1=290.0)),
        (tset.SettlingConfig, settling.SettlingConfig(vdj_model="general")),
        (tcav.CavitatingConfig, cavitating.CavitatingConfig(p_sat=2000.0)),
        (ttpe.TwoPhaseConfig, twophaseeuler.TwoPhaseConfig(d_a=1e-3)),
        (tmpe.MultiphaseEulerConfig, multiphaseeuler.MultiphaseEulerConfig(
            rhos=(1.2, 1000.0), nus=(1.5e-5, 1e-6), ds=(3e-3, 1e-3))),
    ]
    for cls, ref in pairs:
        got = convert.config_from_reference(cls, ref)
        assert type(got) is cls and got._fields == ref._fields
        for name in cls._fields:
            a, b = getattr(got, name), getattr(ref, name)
            if name == "flow":
                assert type(a) is tif.InterConfig
                assert a._asdict() == b._asdict()
                assert a.p_controls is not b.p_controls
            else:
                assert a == b, (cls.__name__, name)
