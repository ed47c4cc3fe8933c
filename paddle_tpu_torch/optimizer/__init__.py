from . import lr  # noqa: F401
from .optimizer import Adam, AdamW, Momentum, Optimizer  # noqa: F401
