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


# the multiphase slice's step modules and applications
MULTIPHASE = ("twoliquidmixing", "intermixing", "interphasechange",
              "multiphaseinter", "compressibleinter", "settling",
              "cavitating", "twophaseeuler", "multiphaseeuler")
MULTIPHASE_APPS = ("cavitatingFoam", "sonicLiquidFoam",
                   "compressibleInterFoam", "twoPhaseEulerFoam",
                   "bubbleFoam", "multiphaseEulerFoam",
                   "twoLiquidMixingFoam", "MRFMultiphaseInterFoam",
                   "multiphaseInterFoam", "interPhaseChangeFoam",
                   "interMixingFoam", "settlingFoam")
# the combustion slice's modules (radiation, the ODE, chemistry and its
# closures, the region models), step modules and applications
COMBUSTION = ("models.radiation", "models.chemistry", "models.combustion",
              "models.flamespeed", "ode", "regionmodels",
              "regionmodels.filmmesh", "regionmodels.film",
              "regionmodels.pyrolysis", "solvers.reacting",
              "solvers.xifoam", "solvers.firefoam")
COMBUSTION_STEPS = ("reacting", "xifoam", "firefoam")
COMBUSTION_APPS = ("chemFoam", "reactingFoam", "rhoReactingFoam", "XiFoam",
                   "PDRFoam", "fireFoam")
# the topology-change slice's modules, the case-directory entry and its
# applications
TOPOCHANGE = ("mesh.topo", "mesh.refine", "mesh.motionsolver",
              "mesh.engine", "models.sixdof", "solvers.floating",
              "solvers.engine", "__main__")
TOPOCHANGE_APPS = ("sonicDyMFoam", "coldEngineFoam", "engineFoam")
# the Lagrangian slice's modules and applications
LAGRANGIAN = ("lagrangian", "lagrangian.reactingcloud", "lagrangian.dsmc",
              "lagrangian.md", "models.liquids", "solvers.parcels")
LAGRANGIAN_APPS = ("icoUncoupledKinematicParcelFoam",
                   "uncoupledKinematicParcelFoam", "reactingParcelFoam",
                   "LTSReactingParcelFoam",
                   "porousExplicitSourceReactingParcelFoam",
                   "coalChemistryFoam", "sprayFoam",
                   "reactingParcelFilmFoam", "sprayEngineFoam", "dsmcFoam",
                   "mdFoam", "mdEquilibrationFoam")

# the boundary-condition and utilities slice's modules
BC_UTILITIES = ("bc.derived3", "bc.derived4", "apps.postutils",
                "mesh.check", "mesh.renumber", "mesh.wave", "io.vtk",
                "utils.foamlog")


def _module_file(m):
    """foamtpu_torch/<m>.py, or its package's __init__.py."""
    rel = m.replace(".", "/")
    if os.path.isdir(os.path.join(REPO, "foamtpu_torch", rel)):
        rel += "/__init__"
    return f"foamtpu_torch/{rel}.py"


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
            "foamtpu_torch/utils/tnp.py",
            "foamtpu_torch/models/thermo.py",
            "foamtpu_torch/models/turbulence/compressible.py",
            "foamtpu_torch/solvers/rhopimple.py",
            "foamtpu_torch/solvers/rhocentral.py",
            "foamtpu_torch/solvers/buoyantrho.py",
            "foamtpu_torch/solvers/mhd.py",
            "foamtpu_torch/solvers/shallowwater.py",
            "foamtpu_torch/solvers/soliddisplacement.py",
            "foamtpu_torch/solvers/potentialfreesurface.py",
            "foamtpu_torch/solvers/adjoint.py",
            "foamtpu_torch/models/randomprocesses.py",
            "foamtpu_torch/mesh/ami.py",
            "foamtpu_torch/apps/meshutils.py",
            "foamtpu_torch/apps/meshutils3.py",
            "foamtpu_torch/mesh/snappy.py",
            "foamtpu_torch/mesh/layers.py",
            "foamtpu_torch/models/solidthermo.py",
            "foamtpu_torch/solvers/chtmultiregion.py"} | {
                f"foamtpu_torch/solvers/{m}.py" for m in MULTIPHASE} | {
                "foamtpu_torch/" + ("ode/__init__" if m == "ode" else
                                    "regionmodels/__init__"
                                    if m == "regionmodels" else
                                    m.replace(".", "/")) + ".py"
                for m in COMBUSTION} | {
                "foamtpu_torch/" + m.replace(".", "/") + ".py"
                for m in TOPOCHANGE} | {
                _module_file(m) for m in LAGRANGIAN + BC_UTILITIES} <= sources
    # the pattern does catch the imports it is there for
    assert IMPORT.search("import jax.numpy as jnp")
    assert IMPORT.search("    from foamtpu.ops import fvc")
    assert not IMPORT.search("from foamtpu_torch.ops import fvc")


BODY = """
import importlib, pkgutil, sys
import foamtpu_torch
names = [m.name for m in pkgutil.walk_packages(foamtpu_torch.__path__,
                                               "foamtpu_torch.")]
# the rotating-frame and porous slice's modules, the turbulence slice's,
# the moving-mesh slice's, the compressible slice's, the single-equation
# slice's, the snappyHexMesh and conjugate-heat-transfer slice's and the
# multiphase slice's are among them
MULTIPHASE = {MULTIPHASE!r}
COMBUSTION = {COMBUSTION!r}
TOPOCHANGE = {TOPOCHANGE!r}
LAGRANGIAN = {LAGRANGIAN!r}
BC_UTILITIES = {BC_UTILITIES!r}
assert {"foamtpu_torch.models.fvoptions", "foamtpu_torch.models.mrf",
        "foamtpu_torch.models.turbulence.les",
        "foamtpu_torch.models.turbulence.les2",
        "foamtpu_torch.functionobjects.sampling",
        "foamtpu_torch.bc.derived2", "foamtpu_torch.solvers.buoyant",
        "foamtpu_torch.solvers.pimpledym", "foamtpu_torch.mesh.moving",
        "foamtpu_torch.functionobjects.surfaces",
        "foamtpu_torch.utils.tnp", "foamtpu_torch.models.thermo",
        "foamtpu_torch.models.turbulence.compressible",
        "foamtpu_torch.solvers.rhopimple", "foamtpu_torch.solvers.rhocentral",
        "foamtpu_torch.solvers.buoyantrho", "foamtpu_torch.solvers.mhd",
        "foamtpu_torch.solvers.shallowwater",
        "foamtpu_torch.solvers.soliddisplacement",
        "foamtpu_torch.solvers.potentialfreesurface",
        "foamtpu_torch.solvers.adjoint",
        "foamtpu_torch.models.randomprocesses", "foamtpu_torch.mesh.ami",
        "foamtpu_torch.apps.meshutils",
        "foamtpu_torch.apps.meshutils3", "foamtpu_torch.mesh.snappy",
        "foamtpu_torch.mesh.layers", "foamtpu_torch.models.solidthermo",
        "foamtpu_torch.solvers.chtmultiregion"} | {
            f"foamtpu_torch.solvers.{m}" for m in MULTIPHASE} | {
            f"foamtpu_torch.{m}" for m in COMBUSTION} | {
            f"foamtpu_torch.{m}" for m in TOPOCHANGE} | {
            f"foamtpu_torch.{m}" for m in LAGRANGIAN + BC_UTILITIES} <= \
    set(names), \
    names
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
    body = BODY.replace("{MULTIPHASE!r}", repr(MULTIPHASE)).replace(
        "{COMBUSTION!r}", repr(COMBUSTION)).replace(
        "{TOPOCHANGE!r}", repr(TOPOCHANGE)).replace(
        "{LAGRANGIAN!r}", repr(LAGRANGIAN)).replace(
        "{BC_UTILITIES!r}", repr(BC_UTILITIES))
    r = subprocess.run([sys.executable, "-c", body], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]


def test_entry_points_default_to_the_card():
    """Every function that builds port objects from outside data takes
    `device` defaulting to DEFAULT_DEVICE ("cuda"): convert.py's helpers
    (the JAX package's arrays), Case, to_device and make_cavity; boxTurb
    and setFields take `-device`, defaulting to the same. A region of a
    multi-region case is a Case on the device of the case it belongs to
    (chtmultiregion.ChtRun), and the snappyHexMesh command meshes on the
    host, with no device at all. The combustion slice's constructors
    (the mechanism, the film mesh, the pyrolysis columns) default to the
    card, and its steps and applications name no host device; the port
    registers 82 applications, every one the reference registers. The
    Lagrangian slice's clouds, liquids and MD state are made on the
    mesh's device, or convert.py's on `device`."""
    import inspect

    from foamtpu_torch import convert
    from foamtpu_torch.apps import cases, cli
    from foamtpu_torch.core.case import Case
    from foamtpu_torch.core.precision import DEFAULT_DEVICE
    from foamtpu_torch.mesh import to_device

    assert DEFAULT_DEVICE == "cuda"
    fns = [getattr(convert, n) for n in (
        "tensor", "mesh_from_numpy", "levels_from_numpy", "field_from_numpy",
        "matrix_from_numpy", "state_from_numpy", "cloud_from_numpy",
        "coal_from_numpy", "dsmc_from_numpy", "md_state_from_numpy")]
    fns += [Case.__init__, to_device, cases.make_cavity]
    for fn in fns:
        dev = inspect.signature(fn).parameters["device"].default
        assert dev == DEFAULT_DEVICE, fn.__qualname__
    for cmd in (cli.box_turb, cli.set_fields):
        src = inspect.getsource(cmd)
        assert "args.device or DEFAULT_DEVICE" in src, cmd.__name__
    from foamtpu_torch.solvers import chtmultiregion

    assert inspect.signature(Case.__init__).parameters["region"].default \
        == ""
    src = inspect.getsource(chtmultiregion.ChtRun.__init__)
    assert "Case(case.dir, device=case.device, region=name)" in src
    src = inspect.getsource(cli.snappy_hex_mesh)
    assert "device" not in src and "mesh_io.write" in src
    # the multiphase family: every step builds its tensors on the mesh's
    # device and every driver on its Case's; none names the host
    import importlib

    from foamtpu_torch.solvers import apps

    for m in MULTIPHASE:
        mod = importlib.import_module(f"foamtpu_torch.solvers.{m}")
        src = inspect.getsource(mod)
        assert '"cpu"' not in src and "device=mesh.device" in src, m
        step = inspect.signature(mod.make_step)
        assert list(step.parameters)[0] == "mesh" and "device" not in \
            step.parameters, m
    for name in (MULTIPHASE_APPS + COMBUSTION_APPS + TOPOCHANGE_APPS
                 + LAGRANGIAN_APPS):
        fn = apps.APPLICATIONS[name]
        assert list(inspect.signature(fn).parameters)[0] == "case", name
        src = inspect.getsource(fn)
        assert '"cpu"' not in src, name
    from foamtpu_torch.models import chemistry
    from foamtpu_torch.regionmodels import build_film_mesh, pyro_init

    for fn in (chemistry.ChemistryModel.build, chemistry.from_foam_files,
               build_film_mesh, pyro_init):
        dev = inspect.signature(fn).parameters["device"].default
        assert dev == DEFAULT_DEVICE, fn.__qualname__
    for m in COMBUSTION_STEPS:
        mod = importlib.import_module(f"foamtpu_torch.solvers.{m}")
        assert '"cpu"' not in inspect.getsource(mod), m
        step = inspect.signature(mod.make_step)
        assert list(step.parameters)[0] == "mesh", m
    # the case-directory entry: run_case and the run command take the
    # card unless asked for the CPU, as the topology-change slice's
    # moving-mesh modules do
    from foamtpu_torch.core.case import run_case

    assert inspect.signature(run_case).parameters["device"].default \
        == DEFAULT_DEVICE
    assert "args.device or DEFAULT_DEVICE" in inspect.getsource(cli.run)
    for m in ("solvers.floating", "solvers.engine", "mesh.motionsolver",
              "mesh.engine"):
        mod = importlib.import_module(f"foamtpu_torch.{m}")
        assert '"cpu"' not in inspect.getsource(mod), m
    assert len(apps.APPLICATIONS) == 82 and apps.REFERENCE_ONLY == ()
    from foamtpu_torch.lagrangian import md

    assert inspect.signature(md.make_state).parameters["device"].default \
        == DEFAULT_DEVICE
    for m in LAGRANGIAN:
        assert '"cpu"' not in inspect.getsource(
            importlib.import_module(f"foamtpu_torch.{m}")), m
