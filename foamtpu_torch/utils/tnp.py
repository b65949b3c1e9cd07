"""A small `jax.numpy` namespace over torch tensors, for user snippets.

The coded function object and the codedSource fvOption run Python
snippets written against `np` and `jnp` (functionobjects/misc.py::Coded
and models/fvoptions.py of the JAX package). The port binds `jnp` to this
module: each name below takes torch tensors (on any device), numpy arrays
or Python numbers, computes with torch on the device of the tensors it is
given (the CPU for numpy arrays and numbers), and takes numpy's `axis=`.
The result is a tensor when a tensor was given, and a numpy array when
none was (so that it mixes with the snippet's numpy arrays, as jax.numpy's
results do: `C - jnp.mean(C, axis=0)` in a codedSource). Numpy arrays and
Python numbers of a float kind become the scalar dtype (core/precision.py),
as jax.numpy makes them float32 unless x64 is on.

Any other name raises NotImplementedError naming itself.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import Any

import numpy as np
import torch

from ..core.precision import scalar_dtype

__all__ = ["asarray", "zeros", "zeros_like", "ones", "sum", "max", "min",
           "mean", "abs", "sqrt", "where", "maximum", "minimum", "einsum",
           "stack", "concatenate", "linalg"]


def _has_tensor(xs) -> bool:
    return any(isinstance(x, torch.Tensor)
               or (isinstance(x, (list, tuple)) and _has_tensor(x))
               for x in xs)


def _host_out(fn):
    """The result as numpy when no argument holds a tensor."""
    @functools.wraps(fn)
    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        if _has_tensor(args) or _has_tensor(kw.values()):
            return out
        return out.numpy()

    return wrapped


def _device_of(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def _t(x, device=None, dtype=None) -> torch.Tensor:
    """x as a tensor: tensors stay where they are (moved to `device` if
    one is named), numpy arrays and numbers land on `device` (default
    the CPU), float ones in the scalar dtype."""
    if isinstance(x, torch.Tensor):
        out = x if device is None else x.to(device)
        return out if dtype is None else out.to(dtype)
    a = np.ascontiguousarray(x)
    if dtype is None and a.dtype.kind == "f":
        dtype = scalar_dtype()
    if a.dtype.kind == "b":
        return torch.as_tensor(a, device=device)
    return torch.as_tensor(a, dtype=dtype, device=device)


def _all(*xs):
    dev = _device_of(*xs)
    return [_t(x, dev) for x in xs]


def _dim(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


@_host_out
def asarray(x, dtype=None) -> torch.Tensor:
    return _t(x, dtype=dtype)



def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


@_host_out
def zeros(shape, dtype=None) -> torch.Tensor:
    return torch.zeros(_shape(shape), dtype=dtype or scalar_dtype())


@_host_out
def ones(shape, dtype=None) -> torch.Tensor:
    return torch.ones(_shape(shape), dtype=dtype or scalar_dtype())


@_host_out
def zeros_like(x, dtype=None) -> torch.Tensor:
    return torch.zeros_like(_t(x), dtype=dtype)


@_host_out
def sum(x, axis=None) -> torch.Tensor:  # noqa: A001 (jnp's name)
    x = _t(x)
    return torch.sum(x) if axis is None else torch.sum(x, dim=_dim(axis))


@_host_out
def max(x, axis=None) -> torch.Tensor:  # noqa: A001
    x = _t(x)
    return torch.amax(x) if axis is None else torch.amax(x, dim=_dim(axis))


@_host_out
def min(x, axis=None) -> torch.Tensor:  # noqa: A001
    x = _t(x)
    return torch.amin(x) if axis is None else torch.amin(x, dim=_dim(axis))


@_host_out
def mean(x, axis=None) -> torch.Tensor:
    x = _t(x)
    return torch.mean(x) if axis is None else torch.mean(x, dim=_dim(axis))


@_host_out
def abs(x) -> torch.Tensor:  # noqa: A001
    return torch.abs(_t(x))


@_host_out
def sqrt(x) -> torch.Tensor:
    return torch.sqrt(_t(x))


@_host_out
def where(cond, x, y) -> torch.Tensor:
    c, a, b = _all(cond, x, y)
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.where(c.to(torch.bool), a.to(dt), b.to(dt))


@_host_out
def maximum(x, y) -> torch.Tensor:
    a, b = _all(x, y)
    return torch.maximum(a, b.to(a.dtype) if b.dim() == 0 else b)


@_host_out
def minimum(x, y) -> torch.Tensor:
    a, b = _all(x, y)
    return torch.minimum(a, b.to(a.dtype) if b.dim() == 0 else b)


@_host_out
def einsum(subscripts: str, *operands) -> torch.Tensor:
    return torch.einsum(subscripts, *_all(*operands))


@_host_out
def stack(arrays, axis=0) -> torch.Tensor:
    return torch.stack(_all(*arrays), dim=axis)


@_host_out
def concatenate(arrays, axis=0) -> torch.Tensor:
    return torch.cat(_all(*arrays), dim=axis)


@_host_out
def _norm(x, ord=None, axis=None) -> torch.Tensor:
    """jnp.linalg.norm: the 2-norm over `axis` (the Frobenius norm of a
    matrix when axis is None); other orders raise."""
    if ord not in (None, 2, "fro"):
        raise NotImplementedError(
            f"jnp.linalg.norm(ord={ord!r}) is not in the port's jnp subset "
            "(foamtpu_torch/utils/tnp.py)")
    return torch.linalg.vector_norm(_t(x), dim=_dim(axis))


class _Linalg(SimpleNamespace):
    def __getattr__(self, name: str) -> Any:
        if name.startswith("__"):
            raise AttributeError(name)
        raise NotImplementedError(
            f"jnp.linalg.{name} is not in the port's jnp subset "
            "(foamtpu_torch/utils/tnp.py)")


linalg = _Linalg(norm=_norm)


def __getattr__(name: str) -> Any:
    """Any other jax.numpy name raises, naming itself."""
    if name.startswith("__"):
        raise AttributeError(name)
    raise NotImplementedError(
        f"jnp.{name} is not in the port's jnp subset "
        "(foamtpu_torch/utils/tnp.py)")
