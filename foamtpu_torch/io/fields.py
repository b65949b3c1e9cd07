"""Field file reader and writer (port of openfoam-2.2.x_tpu/io/fields.py:
`load_field_dict`, `_debinarize`, `_fast_internal_field`, `read_field`,
`write_field` and its formatters).

A field file is a FoamFile header + dimensions + internalField +
boundaryField, ascii or `format binary` (raw little-endian float64
List payloads), plain or gzipped.
"""

from __future__ import annotations

import gzip
import os
import re
from fractions import Fraction
from typing import Optional

import numpy as np

from ..bc import factory
from ..bc import patchfields as pf
from ..bc.patchfields import normalize_bcs
from ..core.dictionary import FoamDict, Word, parse_string
from ..core.dimensions import DimensionSet
from ..core.fields import VolField

_NCOMP = {"scalar": 1, "vector": 3, "symmTensor": 6, "tensor": 9, "label": 1}
_BLOB_RE = re.compile(rb"List<(scalar|vector|symmTensor|tensor)>\s*(\d+)\s*\(")


def _debinarize(raw: bytes):
    """Replace binary List payloads with placeholder words; returns
    (ascii_text, arrays)."""
    parts = []
    arrays = []
    i = 0
    while True:
        m = _BLOB_RE.search(raw, i)
        if not m:
            break
        kind = m.group(1).decode()
        n = int(m.group(2))
        nc = _NCOMP[kind]
        start = m.end()
        nbytes = n * nc * 8
        arr = np.frombuffer(raw[start:start + nbytes], dtype="<f8",
                            count=n * nc)
        if nc > 1:
            arr = arr.reshape(n, nc)
        if raw[start + nbytes:start + nbytes + 1] != b")":
            raise ValueError(
                f"binary List<{kind}> {n}: expected ')' after payload")
        parts.append(raw[i:m.start()].decode("latin-1"))
        parts.append(f"List<{kind}> {n} __BLOB{len(arrays)}__")
        arrays.append(arr)
        i = start + nbytes + 1
    parts.append(raw[i:].decode("latin-1"))
    return "".join(parts), arrays


_BLOB_WORD = re.compile(r"__BLOB(\d+)__$")


def _subst_blobs(node, arrays):
    if isinstance(node, FoamDict):
        for k in list(node.keys()):
            node[k] = _subst_blobs(node[k], arrays)
        return node
    if isinstance(node, list):
        return [_subst_blobs(x, arrays) for x in node]
    if isinstance(node, (Word, str)):
        m = _BLOB_WORD.match(str(node))
        if m:
            return arrays[int(m.group(1))]
    return node


def load_field_dict(path: str) -> FoamDict:
    """parse_file that also understands `format binary` field files
    (plain or gzipped)."""
    if not os.path.exists(path) and os.path.exists(str(path) + ".gz"):
        path = str(path) + ".gz"
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    src_dir = os.path.dirname(os.path.abspath(path))
    if re.search(rb"format\s+binary", raw[:4096]):
        text, arrays = _debinarize(raw)
        return _subst_blobs(parse_string(text, src_dir=src_dir), arrays)
    text = raw.decode("latin-1")
    # big ASCII fields: cut the internalField list out of the text and
    # parse its numbers in one pass instead of through the dictionary
    # tokenizer
    if len(text) > 1 << 20:
        fast = _fast_internal_field(text)
        if fast is not None:
            text2, arr = fast
            d = parse_string(text2, src_dir=src_dir)
            d["internalField"] = [Word("nonuniform"), arr]
            return d
    return parse_string(text, src_dir=src_dir)


_IF_RE = re.compile(
    r"internalField\s+nonuniform\s+List<(scalar|vector)>"
    r"\s*(\d+)\s*\(", re.S)


def _fast_internal_field(text):
    """-> (text with the internalField list replaced, np array) or None
    when the format is unexpected. The reference parses the numbers
    with its native helper; this copy uses numpy on the same text."""
    m = _IF_RE.search(text)
    if m is None:
        return None
    kind, n = m.group(1), int(m.group(2))
    per = 3 if kind == "vector" else 1
    # the entry terminates at the first ';' after the list body
    end = text.find(";", m.end())
    if end < 0:
        return None
    body = text[m.end():end]
    body = body[:body.rfind(")")]
    vals = np.array(body.replace("(", " ").replace(")", " ").split(),
                    dtype=np.float64)
    if vals.shape[0] != n * per:
        return None
    arr = vals.reshape(-1, 3) if per == 3 else vals
    return (text[:m.start()] + "internalField uniform 0;"
            + text[end + 1:], arr)


def read_field(path: str, mesh, name: Optional[str] = None) -> VolField:
    d = load_field_dict(path)
    name = name or os.path.basename(path)
    dims = d.get("dimensions", DimensionSet.of())
    if not isinstance(dims, DimensionSet):
        dims = DimensionSet.of()
    cls = str(d.get("FoamFile", {}).get("class", "volScalarField"))
    rank = 1 if "Vector" in cls else 0
    dtype, device = mesh.v.dtype, mesh.device

    internal = factory.parse_value(d["internalField"], mesh.n_cells, rank,
                                   dtype, device)
    if internal.ndim == 1 and rank == 1:
        internal = internal[None, :].expand(mesh.n_cells, 3).clone()

    bf = d["boundaryField"]
    bcs = [factory.from_dict(bf.match(p.name), p, rank, dtype, device,
                             mesh=mesh)
           for p in mesh.patches]
    return VolField(data=internal, bcs=normalize_bcs(mesh, tuple(bcs), rank),
                    name=name, dims=dims)


_HEADER = """/*--------------------------------*- C++ -*----------------------------------*\\
| foamtpu_torch: finite-volume framework      | Version: 2.2.x-torch          |
\\*---------------------------------------------------------------------------*/
FoamFile
{{
    version     2.0;
    format      {fmt};
    class       {cls};
    location    "{loc}";
    object      {obj};
}}
// * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * //

"""


def _host(x) -> np.ndarray:
    """Tensor on any device (or a number) -> float64 numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


# a field's value type by its width, and its field class
_KIND = {1: "scalar", 3: "vector", 6: "symmTensor", 9: "tensor"}
_CLASS = {"scalar": "volScalarField", "vector": "volVectorField",
          "symmTensor": "volSymmTensorField", "tensor": "volTensorField"}


def _kind(arr: np.ndarray) -> str:
    return _KIND[1 if arr.ndim == 1 else arr.shape[1]]


def _list_parts(arr: np.ndarray, binary: bool):
    """`List<kind> N (payload)` as a list of str/bytes parts. A symmetric
    tensor's six components are written as such (the reference's writer
    labels every non-scalar a vector and formats three columns, so it
    cannot write an R or B field of more than 20,000 cells)."""
    kind = _kind(arr)
    n = arr.shape[0]
    if binary:
        raw = np.ascontiguousarray(arr, dtype="<f8").tobytes()
        return [f"List<{kind}> {n}(", raw, ")"]
    if n > 20000:
        # vectorised %.17g formatting (round-trips exactly like repr)
        import io as _io

        buf = _io.StringIO()
        if arr.ndim == 1:
            np.savetxt(buf, arr, fmt="%.17g")
            body = buf.getvalue()
        else:
            np.savetxt(buf, arr,
                       fmt="(" + " ".join(["%.17g"] * arr.shape[1]) + ")")
            body = buf.getvalue()
        return [f"List<{kind}>\n{n}\n(\n{body})"]
    if arr.ndim == 1:
        body = "\n".join(repr(float(x)) for x in arr)
    else:
        body = "\n".join(
            "(" + " ".join(repr(float(x)) for x in row) + ")" for row in arr
        )
    return [f"List<{kind}>\n{n}\n(\n{body}\n)"]


def _fmt_dims(dims: DimensionSet) -> str:
    def fmt(x: Fraction) -> str:
        return str(int(x)) if x.denominator == 1 else str(float(x))

    return "[" + " ".join(fmt(e) for e in dims.exponents()) + "]"


def _fmt_internal(data: np.ndarray, binary: bool = False):
    return (["internalField   nonuniform "]
            + _list_parts(data, binary) + [";\n"])


def _fmt_bvalue(vals: np.ndarray, binary: bool = False):
    if vals.ndim == 1:
        u = np.unique(np.round(vals, 12))
        if u.shape[0] == 1:
            return [f"uniform {repr(float(u[0]))}"]
    elif np.allclose(vals, vals[0:1], atol=0.0):
        return ["uniform (" + " ".join(repr(float(x)) for x in vals[0]) + ")"]
    return ["nonuniform "] + _list_parts(vals, binary) + ["\n"]


def write_field(field: VolField, mesh, case_dir: str, time_name: str,
                fmt: str = "ascii", compress: bool = False) -> str:
    """Write in OpenFOAM format under <case>/<time>/<name>.
    fmt: 'ascii' | 'binary' (controlDict writeFormat); compress: gzip
    (controlDict writeCompression), both readable back by read_field,
    by the reference package's reader and by reference tooling."""
    data = _host(field.data)
    binary = fmt == "binary"
    cls = _CLASS[_kind(data)]
    out_dir = os.path.join(case_dir, time_name)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, field.name)

    parts = [_HEADER.format(fmt=fmt, cls=cls, loc=time_name, obj=field.name)]
    parts.append(f"dimensions      {_fmt_dims(field.dims)};\n\n")
    parts.extend(_fmt_internal(data, binary))
    parts.append("\nboundaryField\n{\n")
    for p, bc in zip(mesh.patches, field.bcs):
        parts.append(f"    {p.name}\n    {{\n")
        kind = bc.kind
        out_type = {
            "fixedValue": "fixedValue",
            "zeroGradient": "zeroGradient",
            "empty": "empty",
            "symmetry": "symmetry",
            "symmetryPlane": "symmetryPlane",
            "slip": "slip",
            "calculated": "calculated",
            "mixed": "mixed",
            "fixedGradient": "fixedGradient",
            "inletOutlet": "inletOutlet",
        }.get(kind, kind)
        parts.append(f"        type            {out_type};\n")
        if kind in ("fixedValue", "calculated") or kind.endswith("WallFunction"):
            vals = _host(pf.evaluate(bc, mesh, p, field.data))
            parts.append("        value           ")
            parts.extend(_fmt_bvalue(vals, binary))
            parts.append(";\n")
        elif kind == "inletOutlet":
            iv = np.broadcast_to(_host(bc.ref_value),
                                 (p.size,) + data.shape[1:])
            parts.append("        inletValue      ")
            parts.extend(_fmt_bvalue(iv, binary))
            parts.append(";\n")
            vals = _host(pf.evaluate(bc, mesh, p, field.data))
            parts.append("        value           ")
            parts.extend(_fmt_bvalue(vals, binary))
            parts.append(";\n")
        parts.append("    }\n")
    parts.append("}\n")
    blob = b"".join(
        x if isinstance(x, bytes) else x.encode("latin-1") for x in parts
    )
    if compress:
        path = path + ".gz"
        with gzip.open(path, "wb") as f:
            f.write(blob)
    else:
        with open(path, "wb") as f:
            f.write(blob)
    return path
