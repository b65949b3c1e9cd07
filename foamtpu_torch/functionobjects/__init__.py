from .base import FunctionObjectList, make_function_objects  # noqa: F401
