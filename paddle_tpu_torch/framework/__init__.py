from . import bridge, enforce, flags, place, random  # noqa: F401
from .flags import get_flags, set_flags  # noqa: F401
from .place import resolve_device  # noqa: F401
