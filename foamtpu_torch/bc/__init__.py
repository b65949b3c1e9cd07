"""Boundary conditions (port of openfoam-2.2.x_tpu/bc/): importing the
package registers the derived batches, as the reference's does."""

from . import derived2, derived3, derived4  # noqa: F401
