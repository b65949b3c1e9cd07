"""constant/polyMesh reader/writer (port of the numpy path of
openfoam-2.2.x_tpu/io/polymesh.py: `read` and `write`).

The five files points/faces/owner/neighbour/boundary (plus cellZones),
ASCII or gzipped. The reference hands big lists to its native helper
when one is built; this copy always parses and formats with numpy,
which gives the same numbers (the helper parses the same decimal text).
"""

from __future__ import annotations

import gzip
import os
import re
from typing import List, Tuple

import numpy as np

from ..core.dictionary import FoamDict, parse_string
from ..mesh.core import Patch, PolyMesh


def _read_text(path: str) -> str:
    if not os.path.exists(path) and os.path.exists(path + ".gz"):
        path = path + ".gz"
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            return f.read()
    with open(path) as f:
        return f.read()


def _strip_header(text: str) -> str:
    """Remove comments and the FoamFile block, return the data part."""
    if len(text) > 1 << 20:
        # big data files: the banner and the FoamFile block live in the
        # first few KB and list bodies carry no comments
        head = text[:8192]
        head = re.sub(r"/\*.*?\*/", " ", head, flags=re.S)
        head = re.sub(r"//[^\n]*", " ", head)
        m = re.search(r"FoamFile\s*\{[^}]*\}", head, flags=re.S)
        if m:
            head = head[m.end():]
        return head + text[8192:]
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    text = re.sub(r"//[^\n]*", " ", text)
    m = re.search(r"FoamFile\s*\{[^}]*\}", text, flags=re.S)
    if m:
        text = text[m.end():]
    return text


def _numbers(body: str) -> np.ndarray:
    return np.array(body.replace("(", " ").replace(")", " ").split(),
                    dtype=np.float64)


def _parse_scalar_list(text: str) -> np.ndarray:
    """Parse `N ( v v v ... )` (flat numbers)."""
    return _numbers(text[text.index("(") + 1: text.rindex(")")])


def _parse_vector_list(text: str) -> np.ndarray:
    return _numbers(text[text.index("(") + 1: text.rindex(")")]).reshape(-1, 3)


def _parse_face_list(text: str) -> Tuple[np.ndarray, np.ndarray]:
    """faces file: `N ( 4(a b c d) 3(a b c) ... )` -> padded array."""
    body = text[text.index("(") + 1: text.rindex(")")]
    nums = _numbers(body).astype(np.int64)
    # the headers' positions: each face is [npts, p0..pn-1]
    lst, starts, i = nums.tolist(), [], 0
    while i < len(lst):
        starts.append(i)
        i += lst[i] + 1
    starts = np.asarray(starts, dtype=np.int64)
    counts = nums[starts]
    max_pts = int(counts.max()) if counts.shape[0] else 3
    cols = np.arange(max_pts)
    take = starts[:, None] + 1 + cols
    real = cols < counts[:, None]
    out = np.where(real, nums[np.where(real, take, 0)], -1)
    return out, counts


def read(mesh_dir: str) -> PolyMesh:
    """Read constant/polyMesh/{points,faces,owner,neighbour,boundary}."""
    def data(name):
        return _strip_header(_read_text(os.path.join(mesh_dir, name)))

    points = _parse_vector_list(data("points"))
    face_pts, face_npts = _parse_face_list(data("faces"))
    owner = _parse_scalar_list(data("owner")).astype(np.int64)
    neighbour = _parse_scalar_list(data("neighbour")).astype(np.int64)

    bdict = parse_string(data("boundary"))
    patches: List[Patch] = []
    # boundary file: N ( name { type ...; nFaces N; startFace N; } ... )
    items = None
    for v in bdict.values():
        if isinstance(v, list):
            items = v
            break
    if items is None:
        # a single name{...} group may parse as plain entries
        items = []
        for k, v in bdict.items():
            if isinstance(v, FoamDict):
                items += [k, v]
    i = 0
    while i < len(items) - 1:
        name = str(items[i])
        spec = items[i + 1]
        if isinstance(spec, FoamDict):
            extras = []
            for key in ("transform", "rotationAxis", "rotationCentre",
                        "separationVector"):
                if key in spec:
                    val = spec[key]
                    if isinstance(val, (list, tuple)) or hasattr(
                            val, "tolist"):
                        val = " ".join(str(float(x)) for x in
                                       (val.tolist() if hasattr(
                                           val, "tolist") else val))
                    extras.append((key, str(val)))
            patches.append(Patch(
                name=name, type=str(spec["type"]),
                start=int(spec["startFace"]), size=int(spec["nFaces"]),
                neighbour_patch=(str(spec["neighbourPatch"])
                                 if "neighbourPatch" in spec else None),
                attrs=tuple(extras)))
            i += 2
        else:
            i += 1
    cell_zones = {}
    cz_path = os.path.join(mesh_dir, "cellZones")
    if os.path.exists(cz_path) or os.path.exists(cz_path + ".gz"):
        cell_zones = _read_cell_zones(_strip_header(_read_text(cz_path)))

    return PolyMesh(points=points, face_pts=face_pts, face_npts=face_npts,
                    owner=owner, neighbour=neighbour, patches=patches,
                    cell_zones=cell_zones)


def _read_cell_zones(text: str) -> dict:
    """Parse a polyMesh/cellZones file: `N ( name { type cellZone;
    cellLabels List<label> M ( ... ); } ... )`."""
    zones = {}
    for m in re.finditer(
            r"(\w+)\s*\{[^{}]*?cellLabels[^(]*\(([-\d\s]*)\)\s*;",
            text, flags=re.S):
        zones[m.group(1)] = np.array(m.group(2).split(), dtype=np.int64)
    return zones


def _fmt_big_scalar_list(a: np.ndarray, as_int=False) -> str:
    vals = np.asarray(a, np.int64 if as_int else np.float64).tolist()
    body = "\n".join(map(str if as_int else repr, vals))
    return f"{a.shape[0]}\n(\n{body}\n)\n"


def _fmt_rows(fmt: str, a: np.ndarray) -> str:
    """One `fmt % row` line per row of a, formatted by the % operator in
    one call (%r of a Python float is its repr)."""
    return ((fmt + "\n") * a.shape[0] % tuple(a.ravel().tolist()))[:-1]


def _fmt_big_vector_list(a: np.ndarray) -> str:
    body = _fmt_rows("(%r %r %r)", np.asarray(a, np.float64))
    return f"{a.shape[0]}\n(\n{body}\n)\n"


_FILE_HEADER = """FoamFile
{{
    version     2.0;
    format      ascii;
    class       {cls};
    location    "constant/polyMesh";
    object      {obj};
}}
"""


def write(mesh: PolyMesh, mesh_dir: str) -> None:
    os.makedirs(mesh_dir, exist_ok=True)

    def emit(obj, cls, body):
        with open(os.path.join(mesh_dir, obj), "w") as f:
            f.write(_FILE_HEADER.format(cls=cls, obj=obj))
            f.write(body)

    emit("points", "vectorField",
         _fmt_big_vector_list(np.asarray(mesh.points, np.float64)))
    # one formatted block per point count, each line put back in its place
    npts = np.asarray(mesh.face_npts, np.int64)
    pts = np.asarray(mesh.face_pts, np.int64)
    lines = np.empty(npts.shape[0], dtype=object)
    for k in np.unique(npts).tolist():
        sel = np.nonzero(npts == k)[0]
        lines[sel] = _fmt_rows(f"{k}(" + " ".join(["%d"] * k) + ")",
                               pts[sel, :k]).split("\n")
    body = "\n".join(lines.tolist())
    emit("faces", "faceList", f"{mesh.n_faces}\n(\n" + body + "\n)\n")
    for obj, arr in (("owner", mesh.owner), ("neighbour", mesh.neighbour)):
        emit(obj, "labelList", _fmt_big_scalar_list(arr, as_int=True))

    plines = [f"{len(mesh.patches)}", "("]
    for p in mesh.patches:
        plines += [
            f"    {p.name}",
            "    {",
            f"        type            {p.type};",
            f"        nFaces          {p.size};",
            f"        startFace       {p.start};",
        ]
        if p.neighbour_patch:
            plines.append(f"        neighbourPatch  {p.neighbour_patch};")
        plines.append("    }")
    plines += [")"]
    emit("boundary", "polyBoundaryMesh", "\n".join(plines) + "\n")

    if mesh.cell_zones:
        zlines = [f"{len(mesh.cell_zones)}", "("]
        for name, ids in mesh.cell_zones.items():
            ids = np.asarray(ids, dtype=np.int64)
            body = " ".join(str(int(x)) for x in ids)
            zlines += [
                f"{name}",
                "{",
                "    type cellZone;",
                f"    cellLabels      List<label> {ids.shape[0]} ( {body} );",
                "}",
            ]
        zlines += [")"]
        emit("cellZones", "regIOobject", "\n".join(zlines) + "\n")
