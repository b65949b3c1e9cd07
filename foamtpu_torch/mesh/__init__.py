from .core import FvMesh, Patch, PolyMesh, to_device  # noqa: F401
from . import blockmesh  # noqa: F401
