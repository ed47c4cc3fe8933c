from . import models  # noqa: F401
from .generation import Generator, generate  # noqa: F401
