"""functionObjects: per-step hooks driven by the controlDict `functions`
block (port of openfoam-2.2.x_tpu/functionobjects/base.py;
src/OpenFOAM/db/functionObjects/ and
src/postProcessing/functionObjects/).

Each object reduces or gathers the solver state on the state's device
and fetches only the numbers it writes, under postProcessing/<name>/ in
the reference's layout. `FunctionObject.host` is the one way an object
fetches a tensor to the host, so `fetches` counts the copies an object
makes.

As in the reference, `FunctionObjectList.execute` keeps the run alive
when an object raises: it prints `functionObject <name>: <error>`. The
port also counts those failures per object (`failed`, summed in
`failures`), and the host time each object takes (`seconds_by_object`,
summed in `seconds`).

Ported types: fieldMinMax, fieldAverage (field.py); fieldValues,
cellSource, faceSource, systemCall, abortCalculation, nearWallFields
(values.py); forces, forceCoeffs (forces.py); probes (probes.py);
readFields, surfaceInterpolateFields, regionSizeDistribution,
fieldCoordinateSystemTransform, CourantNo, writeDictionary,
timeActivatedFileUpdate (misc.py); yPlus, yPlusRAS, wallShearStress,
sets, streamLine (sampling.py). The reference's other types (surfaces,
sampledSurfaces, coded) raise
NotImplementedError naming themselves when the list is built; a type
neither package knows is skipped with a message, as the reference does.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from ..core.dictionary import FoamDict

_TYPES: Dict[str, Callable] = {}

# the reference's types that the port does not carry, by where they live
NOT_PORTED = {
    "surfaces": "functionobjects/surfaces.py",
    "sampledSurfaces": "functionobjects/surfaces.py",
    # the user's code is written against numpy and jax.numpy
    "coded": "functionobjects/misc.py (coded)",
    "codedFunctionObject": "functionobjects/misc.py (coded)",
}


def register(name: str, cls) -> None:
    _TYPES[name] = cls


class FunctionObject:
    def __init__(self, name: str, spec: FoamDict, case):
        self.name = name
        self.spec = spec
        self.case = case
        self.fetches = 0
        self.out_dir = os.path.join(case.dir, "postProcessing", name)
        os.makedirs(self.out_dir, exist_ok=True)

    def host(self, x) -> np.ndarray:
        """The tensor's values on the host, counted in `fetches`."""
        self.fetches += 1
        return x.detach().cpu().numpy()

    def execute(self, time_name: str, state: Dict) -> None:  # pragma: no cover
        raise NotImplementedError


class FunctionObjectList:
    def __init__(self, objects: List[FunctionObject]):
        self.objects = objects
        self.failed: Dict[str, int] = {}
        self.executes = 0
        self.seconds_by_object = {obj.name: 0.0 for obj in objects}

    @property
    def failures(self) -> int:
        return sum(self.failed.values())

    @property
    def seconds(self) -> float:
        return sum(self.seconds_by_object.values())

    def execute(self, time_name: str, state: Dict) -> None:
        for obj in self.objects:
            t0 = time.perf_counter()
            try:
                obj.execute(time_name, state)
            except Exception as e:  # keep the run alive, as the reference does
                self.failed[obj.name] = self.failed.get(obj.name, 0) + 1
                print(f"functionObject {obj.name}: {e}")
            self.seconds_by_object[obj.name] += time.perf_counter() - t0
        self.executes += 1

    def fetches(self) -> Dict[str, int]:
        """Host fetches so far, per object."""
        return {obj.name: obj.fetches for obj in self.objects}


def make_function_objects(case) -> FunctionObjectList:
    """Build from the controlDict `functions {}` block (functionObjectList)."""
    from . import field, forces, misc, probes, sampling, values  # noqa: F401

    objs: List[FunctionObject] = []
    fns = case.control_dict.get("functions")
    if isinstance(fns, FoamDict):
        for name, spec in fns.items():
            if not isinstance(spec, FoamDict):
                continue
            t = str(spec.get("type", ""))
            if t in NOT_PORTED:
                raise NotImplementedError(
                    f"functionObject type {t!r} ({name}; "
                    f"{NOT_PORTED[t]}) is not ported to foamtpu_torch yet")
            if t in _TYPES:
                objs.append(_TYPES[t](str(name), spec, case))
            else:
                print(f"functionObjects: unknown type {t!r} for {name!r} "
                      "(skipped)")
    return FunctionObjectList(objs)


def field_of(state, name):
    """A field of the state by name, looked up in the turbulence fields
    too (functionobjects/field.py::_get)."""
    src = state.get(name)
    if src is None and "turb" in state and state["turb"]:
        src = state["turb"].get(name)
    return src


def data_of(src) -> torch.Tensor:
    return src.data if hasattr(src, "data") else src
