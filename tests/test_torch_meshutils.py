"""The 33 commands of the reference's own cli.py table that the port took
last (apps/{meshutils,meshutils2,meshutils3,fluent,thermoutils}.py,
mesh/gmsh.py's readers and apps/cli.py's commands), held to the JAX
package.

Each command runs in both packages, through each one's `main`, on twin
copies of the same inputs: those of the reference's own tests
(tests/test_meshutils.py, tests/test_utilities2.py but its two decompose
tests, tests/test_utilities3.py and tests/test_thermoutils.py), in order.
Then every file the two runs leave is compared: a written polyMesh read
back (points, faces, owner, neighbour and patches) bit for bit, every
other file exactly (the writers' banner lines apart, which name their
package); their printed lines with their numbers at 1e-12 of the line's
largest (tutorials' wall-clock seconds and ExecutionTime lines apart).
The commands that read fields run on the CPU (`-device cpu`). It all
runs in one float64 process (FOAMTPU_X64=1 JAX_ENABLE_X64=1), and each
test reads its record. The 6-tet twin of
tests/test_meshutils.py::test_tet_mesh_icofoam_runs runs the gmsh mesh
through both packages' run_case.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BODY = r'''
import contextlib, io, itertools, json, os, re, shutil, sys, tempfile
import numpy as np

from foamtpu.apps.cli import main as jmain
from foamtpu.core.case import run_case as jrun_case
from foamtpu_torch.apps.cli import COMMANDS as TCOMMANDS, main as tmain
from foamtpu_torch.core.case import run_case as trun_case
from foamtpu_torch.io import polymesh as mesh_io

REPO = os.getcwd()
TMP = tempfile.mkdtemp()
NUM = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")
OUT = {"commands": {}, "files": {}}
HDR = "FoamFile { version 2.0; format ascii; class %s; object %s; }\n"
# the commands that read fields: the port's run takes -device cpu
DEVICE = {"foamToEnsight", "foamFormatConvert", "deformedGeom",
          "postChannel", "temporalInterpolate", "tutorials"}
MESH_FILES = ("points", "faces", "owner", "neighbour", "boundary")


def quiet(fn, argv):
    """(return code, or the name of the exception raised; stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            rc = fn(argv)
        except Exception as e:
            rc = type(e).__name__
    return rc, buf.getvalue()


def unbannered(text):
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith("|"))


def close_text(a, b):
    """0 when equal; else the numbers' largest difference over the
    largest number (inf when the text between them differs)."""
    if a == b:
        return 0.0
    sa, sb = NUM.sub("#", a), NUM.sub("#", b)
    na = np.array([float(x) for x in NUM.findall(a)])
    nb = np.array([float(x) for x in NUM.findall(b)])
    if sa != sb or na.shape != nb.shape:
        return float("inf")
    scale = max(float(np.abs(na).max(initial=0.0)), 1e-300)
    return float(np.abs(na - nb).max(initial=0.0) / scale)


def write(path, text):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def twins(name, setup):
    """Twin copies of a case made by setup(dir) (host files only)."""
    base = os.path.join(TMP, "base", name)
    os.makedirs(base)
    setup(base)
    jd, td = os.path.join(TMP, "j", name), os.path.join(TMP, "t", name)
    shutil.copytree(base, jd)
    shutil.copytree(base, td)
    return jd, td


def both(jd, td, argv, label=None, norm=None):
    """One command in both packages on the twin dirs ('@' the dir)."""
    targs = argv + (["-device", "cpu"] if argv[0] in DEVICE else [])
    jrc, jout = quiet(jmain, [a.replace("@", jd) for a in argv])
    trc, tout = quiet(tmain, [a.replace("@", td) for a in targs])
    if jd:
        jout, tout = jout.replace(jd, "@"), tout.replace(td, "@")
    if norm:
        jout, tout = norm(jout), norm(tout)
    OUT["commands"][label or argv[0]] = {
        "rc": [jrc, trc], "stdout": close_text(jout, tout),
        "lines": len(tout.splitlines())}


def compare_trees(name, jd, td):
    """Per file: 0.0 when equal (a polyMesh read back, array for array;
    anything else as text without banner lines, or as bytes), else inf;
    a file in one tree only is inf."""
    def files(d):
        out = set()
        for root, _, fs in os.walk(d):
            out |= {os.path.relpath(os.path.join(root, f), d) for f in fs}
        return out

    a, b = files(jd), files(td)
    res = {}
    meshes = set()
    for rel in sorted(a | b):
        mdir, base = os.path.split(rel)
        if base in MESH_FILES and mdir.endswith(os.path.join("constant",
                                                             "polyMesh")):
            meshes.add(mdir)
            continue
        if rel not in a or rel not in b:
            res[rel] = float("inf")
            continue
        with open(os.path.join(jd, rel), "rb") as f:
            x = f.read()
        with open(os.path.join(td, rel), "rb") as f:
            y = f.read()
        if x != y:
            x, y = unbannered(x.decode("latin-1")), unbannered(
                y.decode("latin-1"))
        res[rel] = 0.0 if x == y else float("inf")
    for mdir in sorted(meshes):
        try:
            pj = mesh_io.read(os.path.join(jd, mdir))
            pt = mesh_io.read(os.path.join(td, mdir))
        except Exception as e:
            res[mdir] = float("inf")
            continue
        same = all(np.array_equal(getattr(pj, k), getattr(pt, k))
                   for k in ("points", "face_pts", "face_npts", "owner",
                             "neighbour"))
        same &= [(p.name, p.type, p.start, p.size) for p in pj.patches] \
            == [(p.name, p.type, p.start, p.size) for p in pt.patches]
        res[mdir] = 0.0 if same else float("inf")
    OUT["files"][name] = res


def block(d, text):
    write(os.path.join(d, "constant", "polyMesh", "blockMeshDict"),
          HDR % ("dictionary", "blockMeshDict") + text)
    quiet(jmain, ["blockMesh", "-case", d])


def dict_file(d, name, body, where="system"):
    write(os.path.join(d, where, name), HDR % ("dictionary", name) + body)


# ---- tests/test_meshutils.py ----------------------------------------------
BOX8 = """
convertToMeters 1;
vertices ( (0 0 0) (1 0 0) (1 1 0) (0 1 0)
           (0 0 1) (1 0 1) (1 1 1) (0 1 1) );
blocks ( hex (0 1 2 3 4 5 6 7) (8 8 8) simpleGrading (1 1 1) );
boundary (
  inlet  { type patch; faces ((0 4 7 3)); }
  outlet { type patch; faces ((2 6 5 1)); }
  walls  { type wall; faces ((1 5 4 0) (3 7 6 2) (0 3 2 1) (4 5 6 7)); }
);
"""


def run_case(name, setup, cmds, norm=None):
    jd, td = twins(name, setup)
    for argv in cmds:
        label = " ".join(a for a in argv if a not in ("-case", "@")) \
            if argv[0] in LABELLED else None
        both(jd, td, argv, label, norm)
    compare_trees(name, jd, td)
    return jd, td


LABELLED = {"foamFormatConvert", "surfaceConvert"}


def create_patch_setup(d):
    block(d, BOX8)
    dict_file(d, "topoSetDict", """actions
( { name lowWall; type faceSet; action new; source boxToFace;
    sourceInfo { box (-0.1 -0.1 -0.1) (1.1 0.001 1.1); } } );
""")
    dict_file(d, "createPatchDict", """patches
( { name lowerWall; patchInfo { type wall; }
    constructFrom set; set lowWall; } );
""")


run_case("createPatch", create_patch_setup,
         [["topoSet", "-case", "@"], ["createPatch", "-case", "@"]])


def extrude_setup(d):
    block(d, BOX8)
    dict_file(d, "extrudeMeshDict", """constructFrom patch;
sourcePatch outlet; extrudeModel linearNormal; nLayers 4;
linearNormalCoeffs { thickness 0.2; }
""")


run_case("extrudeMesh", extrude_setup, [["extrudeMesh", "-case", "@"]])


def refine_setup(d):
    block(d, BOX8)
    dict_file(d, "topoSetDict", """actions
( { name fine; type cellSet; action new; source sphereToCell;
    sourceInfo { centre (0.5 0.5 0.5); radius 0.3; } } );
""")


run_case("refineMesh", refine_setup,
         [["topoSet", "-case", "@"],
          ["refineMesh", "-set", "fine", "-case", "@"]])


def change_dict_setup(d):
    block(d, BOX8)
    write(os.path.join(d, "0", "U"), HDR % ("volVectorField", "U") + """
dimensions [0 1 -1 0 0 0 0];
internalField uniform (0 0 0);
boundaryField
{
    inlet  { type fixedValue; value uniform (1 0 0); }
    outlet { type zeroGradient; }
    walls  { type fixedValue; value uniform (0 0 0); }
}
""")
    dict_file(d, "changeDictionaryDict", """dictionaryReplacement
{ U { boundaryField { inlet { type fixedValue; value uniform (2 0 0); }
                      walls { type slip; } } } }
""")


run_case("changeDictionary", change_dict_setup,
         [["changeDictionary", "-case", "@"]])


def gmsh_box(path):
    """Hand-built MSH2 file: the unit cube split into 6 tets."""
    pts = [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
           (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]
    tets = [(0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6),
            (0, 7, 4, 6), (0, 4, 5, 6), (0, 5, 1, 6)]
    cnt = {}
    for t in tets:
        for tri in itertools.combinations(t, 3):
            k = tuple(sorted(tri))
            cnt[k] = cnt.get(k, 0) + 1
    btris = [k for k, v in cnt.items() if v == 1]
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$PhysicalNames",
             "1", '2 1 "walls"', "$EndPhysicalNames", "$Nodes",
             str(len(pts))]
    lines += [f"{i + 1} {p[0]} {p[1]} {p[2]}" for i, p in enumerate(pts)]
    lines += ["$EndNodes", "$Elements", str(len(tets) + len(btris))]
    eid = 1
    for tri in btris:
        lines.append(f"{eid} 2 2 1 1 " + " ".join(str(i + 1) for i in tri))
        eid += 1
    for t in tets:
        lines.append(f"{eid} 4 2 0 1 " + " ".join(str(i + 1) for i in t))
        eid += 1
    write(path, "\n".join(lines + ["$EndElements"]) + "\n")


def gmsh_setup(d):
    gmsh_box(os.path.join(d, "box.msh"))
    os.makedirs(os.path.join(d, "system"))


run_case("gmshToFoam", gmsh_setup,
         [["gmshToFoam", "@/box.msh", "-case", "@"]])


def regions_setup(d):
    block(d, """
convertToMeters 1;
vertices ( (0 0 0) (1 0 0) (1 1 0) (0 1 0)
           (0 0 1) (1 0 1) (1 1 1) (0 1 1)
           (2 0 0) (3 0 0) (3 1 0) (2 1 0)
           (2 0 1) (3 0 1) (3 1 1) (2 1 1) );
blocks ( hex (0 1 2 3 4 5 6 7) (4 4 4) simpleGrading (1 1 1)
         hex (8 9 10 11 12 13 14 15) (3 3 3) simpleGrading (1 1 1) );
boundary ( walls { type wall; faces (
  (0 4 7 3) (2 6 5 1) (1 5 4 0) (3 7 6 2) (0 3 2 1) (4 5 6 7)
  (8 12 15 11) (10 14 13 9) (9 13 12 8) (11 15 14 10) (8 11 10 9)
  (12 13 14 15) ); } );
""")


run_case("splitMeshRegions", regions_setup,
         [["splitMeshRegions", "-case", "@"]])

# ---- tests/test_utilities2.py ---------------------------------------------
BOX4 = """
convertToMeters 1;
vertices ( (0 0 0) (1 0 0) (1 1 0) (0 1 0) (0 0 1) (1 0 1) (1 1 1) (0 1 1) );
blocks ( hex (0 1 2 3 4 5 6 7) (4 4 4) simpleGrading (1 1 1) );
boundary
(
    right { type patch; faces ((2 6 5 1)); }
    left  { type wall; faces ((0 4 7 3)); }
    rest  { type wall; faces ((1 5 4 0) (3 7 6 2) (0 3 2 1)
                              (4 5 6 7)); }
);
"""


def mirror_setup(d):
    block(d, BOX4)
    dict_file(d, "mirrorMeshDict", """planeType pointAndNormal;
pointAndNormalDict { basePoint (1 0 0); normalVector (1 0 0); }
""")


run_case("mirrorMesh", mirror_setup, [["mirrorMesh", "-case", "@"]])


def subset_setup(d):
    block(d, BOX4)
    dict_file(d, "topoSetDict", """actions
( { name half; type cellSet; action new; source boxToCell;
    sourceInfo { box (0 0 0) (0.5 1 1); } } );
""")


run_case("subsetMesh", subset_setup,
         [["topoSet", "-case", "@"], ["subsetMesh", "half", "-case", "@"]])


def merge_setup(d):
    block(d, BOX4)
    block(os.path.join(d, "add"), BOX4.replace(
        "(0 0 0) (1 0 0) (1 1 0) (0 1 0) (0 0 1) (1 0 1) (1 1 1) (0 1 1)",
        "(2 0 0) (3 0 0) (3 1 0) (2 1 0) (2 0 1) (3 0 1) (3 1 1) (2 1 1)"))


run_case("mergeMeshes", merge_setup, [["mergeMeshes", "@", "@/add"]])

TWO_D = BOX4.replace("(4 4 4)", "(4 4 1)").replace(
    """    right { type patch; faces ((2 6 5 1)); }
    left  { type wall; faces ((0 4 7 3)); }
    rest  { type wall; faces ((1 5 4 0) (3 7 6 2) (0 3 2 1)
                              (4 5 6 7)); }""",
    """    sides { type wall; faces ((2 6 5 1) (0 4 7 3)
                              (1 5 4 0) (3 7 6 2)); }
    frontAndBack { type empty; faces ((0 3 2 1) (4 5 6 7)); }""")


def flatten_setup(d):
    block(d, TWO_D)
    # the empty direction's points off their planes by up to 1e-3
    pm = mesh_io.read(os.path.join(d, "constant", "polyMesh"))
    rng = np.random.default_rng(20)
    pm.points[:, 2] += 1e-3 * rng.uniform(-1, 1, pm.n_points)
    mesh_io.write(pm, os.path.join(d, "constant", "polyMesh"))


run_case("flattenMesh", flatten_setup, [["flattenMesh", "-case", "@"]])
run_case("autoPatch", lambda d: block(d, BOX4),
         [["autoPatch", "45", "-case", "@"]])


def box_stl(path):
    from foamtpu_torch.mesh.snappy import write_stl

    v = np.array([[x, y, z] for z in (0, 1) for y in (0, 1)
                  for x in (0, 1)], float)
    tris = []
    for a, b, c, e in [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
                       (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]:
        tris += [[v[a], v[b], v[c]], [v[a], v[c], v[e]]]
    write_stl(path, np.asarray(tris))


def surface_setup(d):
    from foamtpu_torch.mesh.snappy import write_stl

    box_stl(os.path.join(d, "box.stl"))
    write_stl(os.path.join(d, "sq.stl"), np.asarray(
        [[[0, 0, 0], [1, 0, 0], [0, 1, 0]],
         [[1, 0, 0], [1, 1, 0], [0, 1, 0]]], float))
    write(os.path.join(d, "t.obj"), "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")


run_case("surface", surface_setup, [
    ["surfaceCheck", "@/box.stl"],
    ["surfaceConvert", "@/box.stl", "@/box.obj"],
    ["surfaceConvert", "@/box.obj", "@/box2.stl"],
    ["surfaceConvert", "@/box.stl", "@/box.vtk"],
    ["surfaceTransformPoints", "@/box.stl", "@/moved.stl", "-translate",
     "(1 2 3)", "-scale", "(2 2 2)", "-rollPitchYaw", "(10 20 30)"],
    ["surfaceSubset", "@/sq.stl", "@/half.stl", "-box", "0 0 -1 0.5 0.5 1"],
    ["objToVTK", "@/t.obj", "@/t.vtk"]])


def fluent_setup(d):
    """tests/test_utilities2.py's Fluent hex box: BOX4 in the Fluent
    section format."""
    from foamtpu_torch.core.dictionary import parse_string
    from foamtpu_torch.mesh import blockmesh

    pm = blockmesh.generate(parse_string(BOX4))
    out = ['(0 "fluent box")', "(2 3)"]
    np_, nc, nf = pm.n_points, pm.n_cells, pm.n_faces
    nif = pm.n_internal_faces
    out += [f"(10 (0 1 {np_:x} 0))", f"(10 (1 1 {np_:x} 1 3)("]
    out += [f"{p[0]:.10g} {p[1]:.10g} {p[2]:.10g}" for p in pm.points]
    out += ["))", f"(12 (0 1 {nc:x} 0))", f"(12 (2 1 {nc:x} 1 4))",
            f"(13 (0 1 {nf:x} 0))", f"(13 (3 1 {nif:x} 2 0)("]
    for fc in range(nif):
        pts = pm.face_pts[fc, :pm.face_npts[fc]]
        out.append(f"{len(pts):x} " + " ".join(f"{p + 1:x}" for p in pts)
                   + f" {pm.owner[fc] + 1:x} {pm.neighbour[fc] + 1:x}")
    out.append("))")
    zid, start = 4, nif + 1
    for p in pm.patches:
        out.append(f"(13 ({zid:x} {start:x} {start + p.size - 1:x} 3 0)(")
        for fc in range(p.start, p.start + p.size):
            pts = pm.face_pts[fc, :pm.face_npts[fc]]
            out.append(f"{len(pts):x} " + " ".join(f"{q + 1:x}" for q in pts)
                       + f" {pm.owner[fc] + 1:x} 0")
        out += ["))", f"(39 ({zid} wall {p.name})())"]
        start += p.size
        zid += 1
    write(os.path.join(d, "box.msh"), "\n".join(out) + "\n")
    os.makedirs(os.path.join(d, "c"))


run_case("fluentMeshToFoam", fluent_setup,
         [["fluentMeshToFoam", "@/box.msh", "-case", "@/c"]])

# ---- tests/test_utilities3.py ---------------------------------------------
BOX6 = """
convertToMeters 1;
vertices ( (0 0 0) (1 0 0) (1 1 0) (0 1 0) (0 0 1) (1 0 1) (1 1 1) (0 1 1) );
blocks ( hex (0 1 2 3 4 5 6 7) (6 4 4) simpleGrading (1 1 1) );
boundary
(
    walls { type wall; faces ((2 6 5 1) (0 4 7 3) (1 5 4 0)
                              (3 7 6 2) (0 3 2 1) (4 5 6 7)); }
);
"""


def zones_setup(d):
    block(d, BOX6)
    dict_file(d, "topoSetDict", """actions
( { name leftCells; type cellSet; action new; source boxToCell;
    sourceInfo { box (-1 -1 -1) (0.5 2 2); } } );
""")


run_case("setsToZones", zones_setup,
         [["topoSet", "-case", "@"], ["setsToZones", "-case", "@"]])


def stitch_setup(d):
    block(d, BOX6)
    dict_file(d, "topoSetDict", """actions
( { name baffleFaces; type faceSet; action new; source boxToFace;
    sourceInfo { box (0.49 -1 -1) (0.51 2 2); } } );
""")
    dict_file(d, "createBafflesDict", """internalFacesOnly true;
baffles { b1 { type faceSet; set baffleFaces; patchName baffle;
               patchType wall; } }
""")


run_case("stitchMesh", stitch_setup,
         [["topoSet", "-case", "@"], ["createBaffles", "-case", "@"],
          ["stitchMesh", "baffle_master", "baffle_slave", "-case", "@"]])


def set_set_setup(d):
    block(d, BOX6)
    write(os.path.join(d, "batch.setSet"), """
cellSet left new boxToCell (-1 -1 -1) (0.5 2 2)
cellSet left add boxToCell (-1 -1 -1) (0.7 2 2)
cellSet left subtract boxToCell (-1 -1 -1) (0.2 2 2)
cellSet ball new sphereToCell (0.5 0.5 0.5) 0.3
faceSet low new boxToFace (-1 -1 -1) (2 0.01 2)
cellSet right new boxToCell (-1 -1 -1) (2 2 2)
cellSet right invert
quit
""")


run_case("setSet", set_set_setup,
         [["setSet", "-case", "@", "-batch", "@/batch.setSet"]])


def neu_setup(d):
    pts = [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
           (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]
    tets = [(1, 2, 3, 7), (1, 3, 4, 7), (1, 4, 8, 7),
            (1, 8, 5, 7), (1, 5, 6, 7), (1, 6, 2, 7)]
    faces = [(1, 2, 3), (1, 3, 4), (5, 6, 7), (5, 7, 8), (1, 2, 6),
             (1, 6, 5), (3, 4, 8), (3, 8, 7), (1, 4, 8), (1, 8, 5),
             (2, 3, 7), (2, 7, 6)]
    lines = [str(len(pts))] + [f"{p[0]} {p[1]} {p[2]}" for p in pts]
    lines += [str(len(tets))] + ["1 " + " ".join(map(str, t)) for t in tets]
    lines += [str(len(faces))] + [f"{1 + i // 2} " + " ".join(map(str, t))
                                  for i, t in enumerate(faces)]
    write(os.path.join(d, "cube.neu"), "\n".join(lines) + "\n")
    os.makedirs(os.path.join(d, "constant"))


run_case("netgenNeutralToFoam", neu_setup,
         [["netgenNeutralToFoam", "@/cube.neu", "-case", "@"]])
run_case("writeMeshObj", lambda d: block(d, BOX6),
         [["writeMeshObj", "-case", "@"], ["foamDebugSwitches"]])


def cavity_setup(d):
    """The icoFoam cavity after 3 steps (tests/test_utilities3.py's
    cavity_done), written by the JAX package."""
    os.rmdir(d)
    shutil.copytree(os.path.join(
        REPO, "tutorials/incompressible/icoFoam/cavity"), d)
    quiet(jmain, ["blockMesh", "-case", d])
    with contextlib.redirect_stdout(io.StringIO()):
        jrun_case(d, max_steps=3)


run_case("cavity", cavity_setup, [
    ["foamToEnsight", "-case", "@"],
    ["foamFormatConvert", "-format", "binary", "-case", "@"],
    ["foamFormatConvert", "-format", "ascii", "-case", "@"],
    ["postChannel", "-case", "@"],
    ["temporalInterpolate", "-time", "0.0075", "-fields", "(U p)",
     "-case", "@"],
    ["deformedGeom", "0.001", "-case", "@"]])


def falling_setup(d):
    """fallingCloud after 4 steps written every 2 (positions and origId
    at 0.01 and 0.02), by the port."""
    os.rmdir(d)
    shutil.copytree(os.path.join(
        REPO, "tutorials/lagrangian/icoUncoupledKinematicParcelFoam/"
        "fallingCloud"), d)
    path = os.path.join(d, "system", "controlDict")
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text.replace("writeInterval 50;", "writeInterval 2;"))
    quiet(tmain, ["blockMesh", "-case", d])
    with contextlib.redirect_stdout(io.StringIO()):
        trun_case(d, max_steps=4, device="cpu")


run_case("particleTracks", falling_setup,
         [["particleTracks", "-case", "@"]])

# ---- tests/test_thermoutils.py --------------------------------------------
from test_thermoutils import (CHEMKIN_MECH, CHEMKIN_THERMO_HEADER, THERMO,
                              _nasa_line)


def thermo_setup(d):
    write(os.path.join(d, "constant", "thermo.compressibleGas"),
          HDR % ("dictionary", "thermo") + THERMO)
    write(os.path.join(d, "flameT"), "T0 298.15;\n"
          "reactants { CH4 1; O2 2; N2 7.52; }\n"
          "products { CO2 1; H2O 2; N2 7.52; }\n")
    write(os.path.join(d, "mixtureT"), "T0 300;\n"
          "reactants { CH4 0.055; O2 0.22; N2 0.725; }\n"
          "products { CO2 0.151; H2O 0.124; N2 0.725; }\n")
    write(os.path.join(d, "chem.inp"), CHEMKIN_MECH)
    hi = [7.48514950E-02, 1.33909467E-02, -5.73285809E-06, 1.22292535E-09,
          -1.01815230E-13, -9.46834459E+03, 1.84373180E+01]
    lo = [5.14987613E+00, -1.36709788E-02, 4.91800599E-05,
          -4.84743026E-08, 1.66693956E-11, -1.02466476E+04,
          -4.64130376E+00]
    write(os.path.join(d, "therm.dat"), CHEMKIN_THERMO_HEADER
          + f"{'CH4':<18}{'':6}{'C 1H 4':<20}G{200.0:>10.3f}"
            f"{3500.0:>10.3f}{1000.0:>8.2f}{'':6}1\n"
          + _nasa_line(hi[:5], 2) + _nasa_line(hi[5:7] + lo[:3], 3)
          + _nasa_line(lo[3:7], 4) + "END\n")


run_case("thermo", thermo_setup, [
    ["adiabaticFlameT", "flameT", "-case", "@"],
    ["mixtureAdiabaticFlameT", "mixtureT", "-case", "@"],
    ["chemkinToFoam", "@/chem.inp", "@/therm.dat", "@/reactions",
     "@/thermo"]])

# ---- the Alltest harness on the icoFoam cavity -----------------------------


def no_clock(text):
    """tutorials' output without its wall-clock seconds and the names of
    its scratch directories."""
    text = re.sub(r"\(\d+\.\ds\)", "(#s)", text)
    text = re.sub(r"foamtpu-tut-\w+", "foamtpu-tut-@", text)
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith("ExecutionTime"))


both("", "", ["tutorials", "-test", "-filter", "incompressible/icoFoam/"
              "cavity", "-steps", "2"], norm=no_clock)

# ---- the 6-tet twin of tests/test_meshutils.py::test_tet_mesh_icofoam_runs
jd, td = twins("tet", gmsh_setup)
for d, fn in ((jd, jmain), (td, tmain)):
    quiet(fn, ["gmshToFoam", os.path.join(d, "box.msh"), "-case", d])
    dict_file(d, "controlDict", """application icoFoam; startFrom startTime;
startTime 0; stopAt endTime; endTime 1; deltaT 0.01; writeControl timeStep;
writeInterval 1000; writeFormat ascii;
""")
    dict_file(d, "fvSchemes", """ddtSchemes { default Euler; }
gradSchemes { default Gauss linear; }
divSchemes { default none; div(phi,U) Gauss upwind; }
laplacianSchemes { default Gauss linear orthogonal; }
interpolationSchemes { default linear; } snGradSchemes { default orthogonal; }
""")
    dict_file(d, "fvSolution", """solvers {
  p { solver PCG; preconditioner diagonal; tolerance 1e-7; relTol 0; }
  U { solver PBiCGStab; tolerance 1e-7; relTol 0; maxIter 200; }
}
PISO { nCorrectors 2; }
""")
    write(os.path.join(d, "0", "U"), HDR % ("volVectorField", "U") + """
dimensions [0 1 -1 0 0 0 0];
internalField uniform (0 0 0);
boundaryField { walls { type fixedValue; value uniform (0 0 0); } }
""")
    write(os.path.join(d, "0", "p"), HDR % ("volScalarField", "p") + """
dimensions [0 2 -2 0 0 0 0];
internalField uniform 0;
boundaryField { walls { type zeroGradient; } }
""")
    dict_file(d, "transportProperties",
              "nu nu [0 2 -1 0 0 0 0] 0.01;\n", where="constant")
with contextlib.redirect_stdout(io.StringIO()):
    jc = jrun_case(jd, max_steps=3)
    tc = trun_case(td, max_steps=3, device="cpu")
tet = {}
for k in ("U", "p"):
    a = np.asarray(jc.final_state[k].data, dtype=float)
    b = tc.final_state[k].data.numpy()
    tet[k] = {"err": float(np.abs(a - b).max()),
              "scale": float(np.abs(a).max()),
              "finite": bool(np.isfinite(b).all())}
tet["n_cells"] = tc.mesh.n_cells
OUT["tet"] = tet
OUT["ported"] = sorted(k for k in TCOMMANDS)
print(json.dumps(OUT))
'''

# the 33 commands, each the first case that runs it
COMMANDS_33 = (
    "createPatch", "extrudeMesh", "refineMesh", "changeDictionary",
    "gmshToFoam", "splitMeshRegions", "mirrorMesh", "subsetMesh",
    "mergeMeshes", "flattenMesh", "autoPatch", "adiabaticFlameT",
    "mixtureAdiabaticFlameT", "chemkinToFoam", "foamToEnsight",
    "surfaceCheck", "surfaceConvert", "objToVTK", "surfaceTransformPoints",
    "surfaceSubset", "tutorials", "fluentMeshToFoam", "setsToZones",
    "foamFormatConvert", "deformedGeom", "postChannel",
    "netgenNeutralToFoam", "writeMeshObj", "foamDebugSwitches",
    "particleTracks", "setSet", "stitchMesh", "temporalInterpolate")
# the case whose files each command's test holds
CASE_OF = {"adiabaticFlameT": "thermo", "mixtureAdiabaticFlameT": "thermo",
           "chemkinToFoam": "thermo", "foamToEnsight": "cavity",
           "foamFormatConvert": "cavity", "deformedGeom": "cavity",
           "postChannel": "cavity", "temporalInterpolate": "cavity",
           "surfaceCheck": "surface", "surfaceConvert": "surface",
           "objToVTK": "surface", "surfaceTransformPoints": "surface",
           "surfaceSubset": "surface", "foamDebugSwitches": "writeMeshObj",
           "tutorials": None}
# the output files each command must leave in both trees
OUTPUTS = {
    "createPatch": ("constant/polyMesh",),
    "extrudeMesh": ("constant/polyMesh",),
    "refineMesh": ("constant/polyMesh",),
    "changeDictionary": ("0/U",),
    "gmshToFoam": ("constant/polyMesh",),
    "splitMeshRegions": ("constant/polyMesh/sets/region0",
                         "constant/polyMesh/sets/region1"),
    "mirrorMesh": ("constant/polyMesh",), "subsetMesh": ("constant/polyMesh",),
    "mergeMeshes": ("constant/polyMesh",),
    "flattenMesh": ("constant/polyMesh",), "autoPatch": ("constant/polyMesh",),
    "chemkinToFoam": ("reactions", "thermo"),
    "foamToEnsight": ("EnSight/geometry", "EnSight/case.case",
                      "EnSight/U.0001", "EnSight/p.0000"),
    "surfaceConvert": ("box.obj", "box2.stl", "box.vtk"),
    "objToVTK": ("t.vtk",), "surfaceTransformPoints": ("moved.stl",),
    "surfaceSubset": ("half.stl",),
    "fluentMeshToFoam": ("c/constant/polyMesh",),
    "setsToZones": ("constant/polyMesh",),
    "foamFormatConvert": ("0.015/U", "0.015/p"),
    "deformedGeom": ("constant/polyMesh",),
    "postChannel": ("postProcessing/channel/0.015/Uf.xy",),
    "netgenNeutralToFoam": ("constant/polyMesh",),
    "writeMeshObj": ("meshBoundary.obj",),
    "particleTracks": ("postProcessing/particleTracks/tracks.vtk",),
    "setSet": ("constant/polyMesh/sets/left", "constant/polyMesh/sets/ball",
               "constant/polyMesh/sets/low", "constant/polyMesh/sets/right"),
    "stitchMesh": ("constant/polyMesh",),
    "temporalInterpolate": ("0.0075/U", "0.0075/p")}


@pytest.fixture(scope="module")
def rec():
    env = dict(os.environ)
    env.update(FOAMTPU_X64="1", JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [REPO, os.path.join(REPO, "tests"),
                    env.get("PYTHONPATH", "")]))
    r = subprocess.run([sys.executable, "-c", BODY], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", COMMANDS_33)
def test_command_matches_reference(rec, name):
    """The command's return code and printed lines in both packages, and
    every file its case leaves: meshes bit for bit, the rest exactly."""
    cmds = {k: v for k, v in rec["commands"].items()
            if k.split()[0] == name}
    assert cmds, name
    for label, r in cmds.items():
        assert r["rc"] == [0, 0], (label, r)
        assert r["stdout"] <= 1e-12 and r["lines"] > 0, (label, r)
    case = CASE_OF.get(name, name)
    if case is None:
        return
    files = rec["files"][case]
    for rel in OUTPUTS.get(name, ()):
        assert rel in files, (name, rel, sorted(files))
    bad = {k: v for k, v in files.items() if v != 0.0}
    assert not bad, (name, bad)


def test_the_33_commands_are_ported(rec):
    from foamtpu_torch.apps import cli as tcli

    assert set(COMMANDS_33) <= set(rec["ported"])
    assert not set(COMMANDS_33) & set(tcli.REFERENCE_ONLY)


def test_tet_mesh_icofoam_runs(rec):
    """An unstructured tet mesh from gmshToFoam runs icoFoam in the port:
    3 steps, U and p within 1e-9 of the JAX package's, relative to their
    largest values."""
    r = rec["tet"]
    assert r["n_cells"] == 6
    for k in ("U", "p"):
        assert r[k]["finite"], r
        assert r[k]["err"] <= 1e-9 * max(r[k]["scale"], 1e-30), r


# -- faults of the reference that the port mirrors (ROADMAP Queue 3) ----------

FINE_BOX = """
convertToMeters 0.1;
vertices ( (0 0 0) (0.5 0 0) (0.5 1 0) (0 1 0)
           (0 0 0.1) (0.5 0 0.1) (0.5 1 0.1) (0 1 0.1) );
blocks ( hex (0 1 2 3 4 5 6 7) (4 192 1) simpleGrading (1 1 1) );
boundary ( walls { type wall; faces ((0 4 7 3) (2 6 5 1) (1 5 4 0)
                                     (3 7 6 2)); }
           frontAndBack { type empty; faces ((0 3 2 1) (4 5 6 7)); } );
"""


def _both_packages(tmp_path, setup, argv):
    """argv in each package's main on its own copy made by setup(dir):
    {package: (the exception's type name or the return code, dir)}."""
    from foamtpu.apps.cli import main as jmain
    from foamtpu_torch.apps.cli import main as tmain

    out = {}
    for pkg, main in (("j", jmain), ("t", tmain)):
        d = str(tmp_path / pkg)
        os.makedirs(os.path.join(d, "system"))
        setup(d)
        try:
            rc = main(argv + ["-case", d])
        except Exception as e:       # noqa: BLE001 - the outcome compared
            rc = type(e).__name__
        out[pkg] = (rc, d)
    return out


def test_refine_mesh_refuses_a_uniform_box_of_fine_cells(tmp_path):
    """refineMesh's uniform-box test rounds the points to 1e-12 and holds
    the spacings to 1e-9 of the largest, so a uniform box of 0.52 mm
    cells (the 0.1 m cavity's left half at 4 x 192) reads as graded and
    is refused, in both packages (the mesh chain of chip_smoke.py runs at
    1 m for it)."""
    from foamtpu_torch.apps.cli import main as tmain

    def setup(d):
        with open(os.path.join(d, "system", "blockMeshDict"), "w") as f:
            f.write(FINE_BOX)
        with open(os.path.join(d, "system", "refineMeshDict"), "w") as f:
            f.write("FoamFile { version 2.0; format ascii; class "
                    "dictionary; object refineMeshDict; }\n")
        tmain(["blockMesh", "-case", d])

    out = _both_packages(tmp_path, setup, ["refineMesh"])
    assert out["j"][0] == out["t"][0] == "ValueError", out


def test_change_dictionary_writes_a_vector_field_as_scalar(tmp_path):
    """changeDictionary writes every field it changes with class
    volScalarField, so a changed 0/U no longer reads back as a vector
    field, in both packages (the mesh chain changes transportProperties'
    nu instead)."""
    from foamtpu_torch.core.case import Case

    def setup(d):
        shutil.copytree(os.path.join(
            REPO, "tutorials", "incompressible", "icoFoam", "cavity"), d,
            dirs_exist_ok=True)
        with open(os.path.join(d, "system", "changeDictionaryDict"),
                  "w") as f:
            f.write("FoamFile { version 2.0; format ascii; class "
                    "dictionary; object changeDictionaryDict; }\n"
                    "dictionaryReplacement { U { boundaryField { movingWall"
                    " { type fixedValue; value uniform (0.5 0 0); } } } }\n")

    out = _both_packages(tmp_path, setup, ["changeDictionary"])
    for pkg, (rc, d) in out.items():
        assert rc == 0, out
        with open(os.path.join(d, "0", "U")) as f:
            assert "class volScalarField;" in f.read(), pkg
    from foamtpu_torch.apps.cli import main as tmain

    d = out["t"][1]
    tmain(["blockMesh", "-case", d])
    with pytest.raises(TypeError):
        Case(d, device="cpu").read_field("U")
