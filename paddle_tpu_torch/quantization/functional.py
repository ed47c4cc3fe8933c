"""Fake-quantization primitives (the QAT simulation ops).

Counterpart of ``paddle_tpu/quantization/functional.py``: symmetric
abs-max quant-dequant per tensor, per channel and by moving average,
the moving-average out-scale tracker, and true int8 weight storage.
The operations run in the JAX package's order, so that the int8 codes
agree bit for bit: ``round(clip(x / s, -1, 1) * qmax)`` and
``round((w / s) * qmax)``, each scale floored at 1e-9 (``jnp.round`` and
``torch.round`` both round half to even).

The straight-through estimator is one ``torch.autograd.Function``
(JAX's ``custom_vjp``): the gradient passes where ``|x| <= scale`` and
the scale gets a zero gradient.  The moving-average ops return the new
``(scale, accum, state)`` as the JAX ones do; the QAT layers write them
into their buffers.
"""
from __future__ import annotations

import torch

__all__ = ["fake_quantize_dequantize_abs_max",
           "fake_channel_wise_quantize_dequantize_abs_max",
           "fake_quantize_dequantize_moving_average_abs_max",
           "moving_average_abs_max_scale", "quantize_weight_int8",
           "dequantize_weight"]


def _qmax(bit_length):
    return float(2 ** (int(bit_length) - 1) - 1)


def _qdq(x, scale, qmax):
    s = torch.clamp_min(scale, 1e-9)
    return torch.round(torch.clamp(x / s, -1.0, 1.0) * qmax) * (s / qmax)


class _QdqSTE(torch.autograd.Function):
    """Quant-dequant with FakeQuantDequantGradOp's straight-through
    gradient: ``g`` inside the clip range, 0 outside; none to the
    scale."""

    @staticmethod
    def forward(ctx, x, scale, qmax):
        ctx.save_for_backward(x, scale)
        return _qdq(x, scale, qmax)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        mask = (x.abs() <= torch.clamp_min(scale, 1e-9)).to(g.dtype)
        return g * mask, torch.zeros_like(scale), None


def _qdq_ste(x, scale, qmax):
    return _QdqSTE.apply(x, scale, qmax)


def fake_quantize_dequantize_abs_max(x, bit_length=8):
    """Per-tensor abs-max quant-dequant; returns (out, scale)."""
    scale = x.abs().amax()
    return _qdq_ste(x, scale, _qmax(bit_length)), scale


def fake_channel_wise_quantize_dequantize_abs_max(x, bit_length=8,
                                                  quant_axis=0):
    """Per-channel abs-max quant-dequant along ``quant_axis``; returns
    (out, scales[C])."""
    axes = tuple(i for i in range(x.ndim) if i != quant_axis)
    scale = x.abs().amax(dim=axes, keepdim=True)
    return _qdq_ste(x, scale, _qmax(bit_length)), scale.reshape(-1)


def fake_quantize_dequantize_moving_average_abs_max(
        x, scale, accum, state, moving_rate=0.9, bit_length=8,
        is_test=False):
    """Moving-average abs-max quant-dequant.  Returns (out, new_scale,
    new_accum, new_state); with ``is_test`` the given scale quantizes and
    the state passes through."""
    qmax = _qmax(bit_length)
    if is_test:
        return _qdq_ste(x, scale, qmax), scale, accum, state
    cur = x.detach().abs().amax()
    state = state * moving_rate + 1.0
    accum = accum * moving_rate + cur
    scale = accum / state
    return _qdq_ste(x, scale, qmax), scale, accum, state


def moving_average_abs_max_scale(x, accum, state, moving_rate=0.9,
                                 is_test=False):
    """Track an activation's moving-average abs-max (the out-scale
    collector).  Returns (scale, accum, state)."""
    if is_test:
        return accum / torch.clamp_min(state, 1e-9), accum, state
    cur = x.detach().abs().amax()
    state = state * moving_rate + 1.0
    accum = accum * moving_rate + cur
    return accum / state, accum, state


def quantize_weight_int8(w, quant_axis=0, bit_length=8):
    """True int8 weight quantization: (int8 codes, f32 scales), per
    channel along ``quant_axis`` or per tensor when ``quant_axis`` is
    None; the scales keep the reduced dims (size 1)."""
    w = w.detach().float()
    qmax = _qmax(bit_length)
    axes = tuple(range(w.ndim)) if quant_axis is None else \
        tuple(i for i in range(w.ndim) if i != quant_axis)
    scale = torch.clamp_min(w.abs().amax(dim=axes, keepdim=True), 1e-9)
    return torch.round(w / scale * qmax).to(torch.int8), scale


def dequantize_weight(q, scale, bit_length=8, dtype=torch.float32):
    """int8 codes back to ``dtype`` (DequantizeMaxAbs)."""
    return q.to(dtype) * (scale / _qmax(bit_length))
