"""The eager/static switch.

Counterpart of ``paddle_tpu/framework/core.py`` (``in_dygraph_mode``,
``in_static_mode``, ``enable_static``, ``disable_static``), kept to the
mode flag: gradients are torch's own (``torch.is_grad_enabled``).  The
flag is per thread, as in the JAX package: while it is on, a registered
op (``framework/primitive.py``) called on a static ``Variable`` records
itself into the current ``Program`` instead of running.
"""
from __future__ import annotations

import threading


class _State(threading.local):
    def __init__(self):
        self.static_mode = False


_state = _State()


def in_dygraph_mode() -> bool:
    return not _state.static_mode


def in_static_mode() -> bool:
    return _state.static_mode


def enable_static():
    _state.static_mode = True


def disable_static():
    _state.static_mode = False
