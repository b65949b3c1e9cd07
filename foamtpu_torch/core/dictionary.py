"""Copy of openfoam-2.2.x_tpu/core/dictionary.py.

Host-side numpy. The JAX package cannot be imported without jax, so
the port carries its own copy.

OpenFOAM dictionary-format parser / writer.

The reference's universal config language (reference:
src/OpenFOAM/db/dictionary/, src/OpenFOAM/db/IOstreams/) — C-like nested
dictionaries with ``key value;`` entries, ``( ... )`` lists,
``[0 2 -1 0 0 0 0]`` dimension sets, ``$macro`` expansion, ``#include``,
and regex patch keys. This parser ingests unmodified OpenFOAM case files
(controlDict, fvSchemes, fvSolution, blockMeshDict, field files,
polyMesh components) into plain Python/NumPy structures.

Host-side only; never traced by JAX.
"""

from __future__ import annotations

import gzip
import os
import re
from fractions import Fraction
from typing import Any, Iterator, List, Optional, Tuple, Union

import numpy as np

from .dimensions import DimensionSet

# ---------------------------------------------------------------------------
# Tokens
# ---------------------------------------------------------------------------


class Word(str):
    """A bare (unquoted) OpenFOAM word, e.g. ``div(phi,U)`` or ``uniform``."""

    __slots__ = ()


class Macro(str):
    """A ``$name`` macro reference, resolved against enclosing scopes."""

    __slots__ = ()


_PUNCT = "{};()[]"
_NUM_RE = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")


def _tokenize(text: str) -> Iterator[Union[str, float, int, Word, Macro]]:
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c in " \t\r\n":
            i += 1
            continue
        if c == "/" and i + 1 < n:
            if text[i + 1] == "/":
                j = text.find("\n", i)
                i = n if j < 0 else j + 1
                continue
            if text[i + 1] == "*":
                j = text.find("*/", i + 2)
                i = n if j < 0 else j + 2
                continue
        if c == '"':
            j = i + 1
            while j < n and text[j] != '"':
                j += 2 if text[j] == "\\" else 1
            yield text[i + 1 : j]  # plain str == quoted string/regex
            i = j + 1
            continue
        if c == "#" and text.startswith("#{", i):
            # verbatim code block #{ ... #} (reference: dynamicCode /
            # coded BCs) — yielded as one plain string token
            j = text.find("#}", i + 2)
            j = n if j < 0 else j
            yield text[i + 2:j]
            i = j + 2
            continue
        if c in _PUNCT:
            yield c
            i += 1
            continue
        if c == "$":
            j = i + 1
            if j < n and text[j] == "{":
                k = text.find("}", j)
                yield Macro(text[j + 1 : k])
                i = k + 1
            else:
                k = j
                while k < n and (text[k].isalnum() or text[k] in "_:.!/"):
                    k += 1
                yield Macro(text[j:k])
                i = k
            continue
        # word / number: read until whitespace or punct, allowing balanced
        # parens and angle brackets *inside* the word (div(phi,U), List<scalar>)
        j = i
        depth = 0
        while j < n:
            ch = text[j]
            if depth == 0 and (ch in " \t\r\n" or ch in "{};[]\"$"):
                break
            if ch == "(":
                depth += 1
            elif ch == ")":
                if depth == 0:
                    break
                depth -= 1
            elif ch == "<":
                depth += 1
            elif ch == ">":
                depth -= 1
            j += 1
        tok = text[i:j]
        i = j
        if _NUM_RE.match(tok):
            f = float(tok)
            if "." not in tok and "e" not in tok and "E" not in tok:
                yield int(tok)
            else:
                yield f
        else:
            yield Word(tok)


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------


class FoamDict(dict):
    """A parsed OpenFOAM dictionary. Keys are str; values are numbers,
    Word, str (quoted), list, np.ndarray, DimensionSet, or FoamDict."""

    parent: Optional["FoamDict"] = None

    # -- scoped lookup ------------------------------------------------------
    def lookup(self, key: str, default: Any = KeyError) -> Any:
        d: Optional[FoamDict] = self
        while d is not None:
            if key in d:
                return d[key]
            d = d.parent
        if default is KeyError:
            raise KeyError(key)
        return default

    def subdict(self, key: str) -> "FoamDict":
        v = self[key]
        if not isinstance(v, FoamDict):
            raise TypeError(f"entry {key!r} is not a dictionary")
        return v

    def get_or(self, key: str, default: Any) -> Any:
        return self.get(key, default)

    # regex patch-key matching (reference: keyType wildcard entries)
    def match(self, name: str) -> Any:
        if name in self:
            return self[name]
        for k, v in self.items():
            if not isinstance(k, Word) and isinstance(k, str):
                # quoted keys are regexes in OpenFOAM
                try:
                    if re.fullmatch(k, name):
                        return v
                except re.error:
                    pass
        raise KeyError(name)


class _TokStream:
    def __init__(self, toks: List[Any]):
        self.toks = toks
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def expect(self, tok):
        t = self.next()
        if t != tok:
            raise ValueError(f"expected {tok!r}, got {t!r} at token {self.i}")


def _parse_list(ts: _TokStream) -> Any:
    """Parse ``( ... )`` into a Python list; homogeneous numeric content
    becomes an np.ndarray (covers big point/face/label lists)."""
    items = []
    while True:
        t = ts.peek()
        if t is None:
            raise ValueError("unterminated list")
        if t == ")":
            ts.next()
            break
        items.append(_parse_value(ts))
    if items and all(isinstance(x, (int, float)) and not isinstance(x, bool) for x in items):
        if all(isinstance(x, int) for x in items):
            return np.asarray(items, dtype=np.int64)
        return np.asarray(items, dtype=np.float64)
    if items and all(isinstance(x, np.ndarray) for x in items):
        try:
            return np.stack(items)
        except ValueError:
            pass
    return items


def _parse_dimensions(ts: _TokStream) -> DimensionSet:
    exps = []
    while True:
        t = ts.next()
        if t == "]":
            break
        exps.append(Fraction(t).limit_denominator(1000) if isinstance(t, float) else Fraction(t))
    return DimensionSet.of(*exps)


def _eval_calc(expr: str) -> Any:
    """#calc "<expr>" / inline #codeStream value: evaluate an
    arithmetic expression with the math namespace (reference:
    functionEntries::calcEntry compiles a C++ snippet; the expressions
    reference dictionaries actually write are plain arithmetic, which
    evaluates directly — degree* helpers and pi included)."""
    import math

    ns = {k: getattr(math, k) for k in ("pi", "sin", "cos", "tan",
                                        "sqrt", "exp", "log", "atan2",
                                        "pow", "fabs", "floor",
                                        "ceil")}
    ns["degToRad"] = math.radians
    ns["radToDeg"] = math.degrees
    ns["mag"] = abs
    expr = expr.strip().strip('"')
    return eval(expr, {"__builtins__": {}}, ns)   # noqa: S307


def _parse_value(ts: _TokStream) -> Any:
    t = ts.next()
    if t == "(":
        return _parse_list(ts)
    if t == "[":
        return _parse_dimensions(ts)
    if t == "{":
        return _parse_dict_body(ts, FoamDict())
    if isinstance(t, Word) and t == "#calc":
        return _eval_calc(str(ts.next()))
    if isinstance(t, Word) and t == "#codeStream":
        # value-position #codeStream: evaluate a `code #{ return-less
        # expression #}` block when it is a plain expression; else the
        # block is skipped and the entry reads as absent
        blk = _parse_value(ts)
        if isinstance(blk, FoamDict):
            code = str(blk.get("code", "")).strip()
            code = code.strip("#{}").strip()
            # the common pattern writes `os << <expr>;`
            if code.startswith("os"):
                code = code.split("<<", 1)[-1].rstrip("; ")
            try:
                return _eval_calc(code)
            except Exception:
                return None
        return None
    return t


def _parse_entry_tokens(ts: _TokStream) -> List[Any]:
    """Values of one entry up to ';' (handles sized lists: ``N ( ... )``)."""
    vals: List[Any] = []
    while True:
        t = ts.peek()
        if t is None:
            break  # EOF terminates the last entry (e.g. polyMesh/boundary)
        if t == ";":
            ts.next()
            break
        if t == "}":  # tolerate missing ';' before '}'
            break
        vals.append(_parse_value(ts))
    return vals


def _simplify(vals: List[Any]) -> Any:
    # drop ``N`` size prefixes in ``N ( ... )`` sized lists
    out: List[Any] = []
    for i, v in enumerate(vals):
        if (
            isinstance(v, int)
            and i + 1 < len(vals)
            and isinstance(vals[i + 1], (list, np.ndarray))
            and len(vals[i + 1]) == v
        ):
            continue
        out.append(v)
    if len(out) == 1:
        return out[0]
    return out


def _parse_dict_body(ts: _TokStream, d: FoamDict) -> FoamDict:
    while True:
        t = ts.peek()
        if t is None or t == "}":
            if t == "}":
                ts.next()
            return d
        t = ts.next()
        if isinstance(t, Word) and t.startswith("#"):
            _handle_directive(t, ts, d)
            continue
        if isinstance(t, Macro):
            # bare $other; — inherit entries from another dictionary
            src = _resolve_macro(d, str(t))
            ts.expect(";")
            if isinstance(src, FoamDict):
                for k, v in src.items():
                    d.setdefault(k, v)
            continue
        key = t if isinstance(t, (Word, str)) else str(t)
        nxt = ts.peek()
        if nxt == "{":
            ts.next()
            sub = FoamDict()
            sub.parent = d
            d[key] = _parse_dict_body(ts, sub)
        else:
            d[key] = _simplify(_parse_entry_tokens(ts))
    return d


def _handle_directive(t: Word, ts: _TokStream, d: FoamDict) -> None:
    name = t[1:]
    if name in ("include", "includeIfPresent", "includeEtc"):
        fname = ts.next()
        base = d
        while base.parent is not None:
            base = base.parent
        src_dir = getattr(base, "_src_dir", None)
        path = os.path.join(src_dir, str(fname)) if src_dir else str(fname)
        path = os.path.expandvars(path)
        if os.path.exists(path) or os.path.exists(path + ".gz"):
            inc = parse_file(path)
            for k, v in inc.items():
                d[k] = v
        elif name == "include":
            raise FileNotFoundError(f"#include {fname!r} not found ({path})")
    elif name == "inputMode":
        ts.next()  # merge/overwrite/etc — we always merge
    elif name == "remove":
        key = ts.next()
        d.pop(str(key), None)
        if ts.peek() == ";":
            ts.next()
    else:
        # #codeStream and friends: skip the balanced block gracefully
        depth = 0
        while True:
            x = ts.next()
            if x is None:
                return
            if x == "{":
                depth += 1
            elif x == "}":
                depth -= 1
            elif x == ";" and depth == 0:
                return


def _resolve_macro(scope: FoamDict, name: str) -> Any:
    name = name.lstrip(":")
    d: Optional[FoamDict] = scope
    while d is not None:
        cur: Any = d
        ok = True
        for part in name.split("/"):
            if isinstance(cur, FoamDict) and part in cur:
                cur = cur[part]
            else:
                ok = False
                break
        if ok:
            return cur
        d = d.parent
    raise KeyError(f"macro ${name} not found in any enclosing scope")


def _expand_macros(d: FoamDict) -> None:
    for k, v in list(d.items()):
        d[k] = _expand_value(d, v)


def _expand_value(scope: FoamDict, v: Any) -> Any:
    if isinstance(v, Macro):
        return _expand_value(scope, _resolve_macro(scope, str(v)))
    if isinstance(v, FoamDict):
        _expand_macros(v)
        return v
    if isinstance(v, list):
        return [_expand_value(scope, x) for x in v]
    return v


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def parse_string(text: str, src_dir: Optional[str] = None) -> FoamDict:
    ts = _TokStream(list(_tokenize(text)))
    root = FoamDict()
    if src_dir:
        root._src_dir = src_dir  # type: ignore[attr-defined]
    _parse_dict_body(ts, root)
    _expand_macros(root)
    return root


def parse_file(path: str) -> FoamDict:
    if not os.path.exists(path) and os.path.exists(str(path) + ".gz"):
        path = str(path) + ".gz"
    if str(path).endswith(".gz"):
        with gzip.open(path, "rt") as f:
            text = f.read()
    else:
        with open(path) as f:
            text = f.read()
    d = parse_string(text, src_dir=os.path.dirname(os.path.abspath(path)))
    return d


# ---------------------------------------------------------------------------
# Helpers for typed extraction
# ---------------------------------------------------------------------------


def dimensioned_scalar(v: Any) -> Tuple[DimensionSet, float]:
    """Extract (dims, value) from entry forms ``[dims] v``,
    ``name [dims] v`` or bare ``v`` (dimless)."""
    if isinstance(v, (int, float)):
        from .dimensions import dimless

        return dimless, float(v)
    vals = v if isinstance(v, list) else [v]
    dims = None
    num = None
    for x in vals:
        if isinstance(x, DimensionSet):
            dims = x
        elif isinstance(x, (int, float)):
            num = float(x)
    if num is None:
        raise ValueError(f"no numeric value in dimensioned entry: {v!r}")
    from .dimensions import dimless

    return (dims or dimless), num


def dimensioned_vector(v: Any) -> Tuple[DimensionSet, np.ndarray]:
    vals = v if isinstance(v, list) else [v]
    dims = None
    vec = None
    for x in vals:
        if isinstance(x, DimensionSet):
            dims = x
        elif isinstance(x, np.ndarray):
            vec = np.asarray(x, dtype=np.float64)
    if vec is None:
        raise ValueError(f"no vector value in entry: {v!r}")
    from .dimensions import dimless

    return (dims or dimless), vec


# ---------------------------------------------------------------------------
# Writer (OpenFOAM-format output so reference tooling can read our files)
# ---------------------------------------------------------------------------

_HEADER = """/*--------------------------------*- C++ -*----------------------------------*\\
| =========                 |                                                 |
| \\\\      /  F ield         | foamtpu: TPU-native finite-volume framework     |
|  \\\\    /   O peration     | Version:  2.2.x-tpu                             |
|   \\\\  /    A nd           |                                                 |
|    \\\\/     M anipulation  |                                                 |
\\*---------------------------------------------------------------------------*/
"""


def _fmt_value(v: Any, indent: int) -> str:
    pad = "    " * indent
    if isinstance(v, FoamDict):
        inner = "".join(_fmt_entry(k, x, indent + 1) for k, x in v.items())
        return "\n" + pad + "{\n" + inner + pad + "}\n"
    if isinstance(v, DimensionSet):
        return " " + str(v)
    if isinstance(v, Word):
        return " " + str(v)
    if isinstance(v, str):
        return f' "{v}"'
    if isinstance(v, bool):
        return " true" if v else " false"
    if isinstance(v, (int, np.integer)):
        return f" {int(v)}"
    if isinstance(v, (float, np.floating)):
        return f" {_fmt_scalar(float(v))}"
    if isinstance(v, np.ndarray):
        return " " + _fmt_array(v, indent)
    if isinstance(v, (list, tuple)):
        return "".join(_fmt_value(x, indent) for x in v)
    return f" {v}"


def _fmt_scalar(x: float) -> str:
    if x == int(x) and abs(x) < 1e15:
        return str(int(x))
    return repr(x)


def _fmt_array(a: np.ndarray, indent: int) -> str:
    if a.ndim == 1:
        if a.size <= 10:
            return "(" + " ".join(_fmt_scalar(float(x)) for x in a) + ")"
        body = "\n".join(_fmt_scalar(float(x)) for x in a)
        return f"{a.shape[0]}\n(\n{body}\n)\n"
    if a.ndim == 2:
        rows = ["(" + " ".join(_fmt_scalar(float(x)) for x in r) + ")" for r in a]
        if a.shape[0] <= 4:
            return "(" + " ".join(rows) + ")"
        return f"{a.shape[0]}\n(\n" + "\n".join(rows) + "\n)\n"
    raise ValueError(f"cannot format array of ndim {a.ndim}")


def _fmt_entry(k: str, v: Any, indent: int) -> str:
    pad = "    " * indent
    key = k if isinstance(k, Word) or re.fullmatch(r"[\w.:()|,<>*]+", k) else f'"{k}"'
    if isinstance(v, FoamDict):
        return pad + str(key) + _fmt_value(v, indent)
    return pad + str(key) + _fmt_value(v, indent) + ";\n"


def write_string(d: FoamDict, foamfile: Optional[dict] = None) -> str:
    out = [_HEADER]
    if foamfile:
        ff = FoamDict()
        ff[Word("version")] = 2.0
        ff[Word("format")] = Word("ascii")
        for k, v in foamfile.items():
            ff[Word(k)] = Word(v) if isinstance(v, str) else v
        out.append(_fmt_entry(Word("FoamFile"), ff, 0))
        out.append(
            "// * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * //\n\n"
        )
    for k, v in d.items():
        if k == "FoamFile":
            continue
        out.append(_fmt_entry(k, v, 0))
        out.append("\n")
    out.append(
        "\n// ************************************************************************* //\n"
    )
    return "".join(out)


def write_file(path: str, d: FoamDict, foamfile: Optional[dict] = None) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(write_string(d, foamfile))
