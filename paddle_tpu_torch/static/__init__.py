"""paddle.static, as far as the port needs it: ``InputSpec``.

Counterpart of ``InputSpec`` in ``paddle_tpu/static/__init__.py``: the
signature ``jit.save`` and ``serving.export_for_serving`` export against
(a shape with ``None`` for a dynamic dim, a dtype, a name).  The static
graph itself (``Program``, ``Executor``, ``save_inference_model``) is not
ported (ROADMAP A13).
"""
from __future__ import annotations

__all__ = ["InputSpec"]


class InputSpec:
    """paddle.static.InputSpec parity (signature for jit.save)."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = list(shape)
        self.dtype = dtype
        self.name = name

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")
