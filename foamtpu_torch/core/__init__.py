from . import dimensions  # noqa: F401
from . import dictionary  # noqa: F401
