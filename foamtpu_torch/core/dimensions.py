"""Copy of openfoam-2.2.x_tpu/core/dimensions.py.

Host-side numpy. The JAX package cannot be imported without jax, so
the port carries its own copy.

Runtime SI dimension checking.

TPU-native equivalent of the reference's 7-exponent dimension system
(reference: src/OpenFOAM/dimensionSet/dimensionSet.H — the exponents are
[mass length time temperature moles current luminousIntensity]).

Dimensions are static Python metadata carried alongside jnp arrays; all
checks happen at trace time, so they cost nothing inside jit — strictly
better than the reference's per-operation runtime checks.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction


@dataclasses.dataclass(frozen=True)
class DimensionSet:
    """SI dimension exponents [kg m s K mol A cd]."""

    mass: Fraction = Fraction(0)
    length: Fraction = Fraction(0)
    time: Fraction = Fraction(0)
    temperature: Fraction = Fraction(0)
    moles: Fraction = Fraction(0)
    current: Fraction = Fraction(0)
    luminous: Fraction = Fraction(0)

    _NAMES = ("mass", "length", "time", "temperature", "moles", "current", "luminous")

    @staticmethod
    def of(*exps) -> "DimensionSet":
        exps = tuple(Fraction(e) for e in exps)
        exps = exps + (Fraction(0),) * (7 - len(exps))
        return DimensionSet(*exps)

    def exponents(self):
        return tuple(getattr(self, n) for n in self._NAMES)

    def __mul__(self, other: "DimensionSet") -> "DimensionSet":
        return DimensionSet(*(a + b for a, b in zip(self.exponents(), other.exponents())))

    def __truediv__(self, other: "DimensionSet") -> "DimensionSet":
        return DimensionSet(*(a - b for a, b in zip(self.exponents(), other.exponents())))

    def __pow__(self, p) -> "DimensionSet":
        p = Fraction(p)
        return DimensionSet(*(a * p for a in self.exponents()))

    def sqrt(self) -> "DimensionSet":
        return self ** Fraction(1, 2)

    def __add__(self, other: "DimensionSet") -> "DimensionSet":
        if self != other:
            raise DimensionError(f"dimension mismatch in sum: {self} vs {other}")
        return self

    __sub__ = __add__

    def is_dimensionless(self) -> bool:
        return all(e == 0 for e in self.exponents())

    def __str__(self) -> str:
        def fmt(x: Fraction) -> str:
            return str(int(x)) if x.denominator == 1 else str(x)

        return "[" + " ".join(fmt(e) for e in self.exponents()) + "]"

    __repr__ = __str__


class DimensionError(TypeError):
    """Raised when an operation mixes incompatible dimensions
    (reference behavior: FatalError in dimensionSet checking)."""


# Canonical dimension constants (reference: src/OpenFOAM/dimensionSet/dimensionSets.C)
dimless = DimensionSet.of(0, 0, 0)
dimMass = DimensionSet.of(1, 0, 0)
dimLength = DimensionSet.of(0, 1, 0)
dimTime = DimensionSet.of(0, 0, 1)
dimTemperature = DimensionSet.of(0, 0, 0, 1)
dimMoles = DimensionSet.of(0, 0, 0, 0, 1)
dimCurrent = DimensionSet.of(0, 0, 0, 0, 0, 1)

dimArea = dimLength ** 2
dimVolume = dimLength ** 3
dimVelocity = dimLength / dimTime
dimAcceleration = dimVelocity / dimTime
dimDensity = dimMass / dimVolume
dimForce = dimMass * dimAcceleration
dimEnergy = dimForce * dimLength
dimPower = dimEnergy / dimTime
dimPressure = dimForce / dimArea
dimViscosity = dimArea / dimTime          # kinematic
dimDynamicViscosity = dimMass / dimLength / dimTime
dimFlux = dimVolume / dimTime             # volumetric face flux (phi) for incompressible
dimGasConstant = dimEnergy / dimMass / dimTemperature
dimSpecificHeatCapacity = dimGasConstant
