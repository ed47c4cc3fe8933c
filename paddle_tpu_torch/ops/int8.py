"""Int8 inference primitives: integer products with an int32 accumulator.

Counterpart of ``paddle_tpu/ops/int8.py`` (``linear_int8``,
``conv2d_int8``, ``matmul_int8``, ``_quantize_act`` and the one
``_epilogue``).  The JAX package computes the products with
``lax.dot_general``/``lax.conv_general_dilated`` at
``preferred_element_type=int32``; the port computes every one as one
``torch._int_mm`` (cuBLASLt's i8 x i8 -> i32 GEMM on CUDA, ATen's on the
CPU): a conv is im2col (``Tensor.unfold``, which takes any dtype) and
the same GEMM.  The integer sum is exact, so the accumulator equals the
JAX package's at any shape.  No site falls back to a float product.

cuBLASLt's ``_int_mm`` takes more than 16 rows and K and N that are
multiples of 8.  :func:`int8_mm` pads for every rule with zero codes,
which add nothing to an integer sum: 16 zero rows always (no branch on
the batch size, which ``torch.export`` would turn into a guard), and K
and N up to a multiple of 8 when the weight's static shape asks for it.

Quantization convention (``quantization/functional.py``'s): symmetric,
qmax = 2^(bits-1) - 1; activations clip to [-scale, scale] and round
half to even.  The epilogue dequantizes as ``acc * (s_x / qmax) *
(s_w / qmax)`` in that order, adds the bias and, when a site's
out-scale is folded, requantizes onto its int8 grid.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..nn.functional.conv import _pads, _pair

QMAX_INT8 = 127.0
ROW_PAD = 16            # zero rows appended: cuBLASLt takes > 16 rows


def _qmax(bits):
    return float(2 ** (int(bits) - 1) - 1)


def _f32(t):
    """``t`` in f32; an f32 tensor as it is, so that an exported program
    holds no conversion node for it."""
    return t if t.dtype == torch.float32 else t.float()


def _per_channel(s_w):
    """Weight scales as a 1-D f32 vector over the output channels."""
    s_w = _f32(s_w)
    return s_w if s_w.ndim == 1 else s_w.reshape(-1)


def _quantize_act(x, scale, qmax):
    """Float activations to int8 codes at ``scale``: clip to the
    calibrated range and round half to even, as the fake-QDQ ops do.
    Returns (codes, the f32 scale used)."""
    s = torch.clamp_min(_f32(scale), 1e-9)
    q = torch.round(torch.clamp(_f32(x) / s, -1.0, 1.0) * qmax)
    return q.to(torch.int8), s


def _epilogue(acc, s_x, s_w, qmax, bias, out_scale, out_dtype):
    """Dequantize the int32 accumulator by (s_x/qmax)*(s_w/qmax), add the
    bias and, with an ``out_scale``, requantize onto its int8 grid.
    ``s_w`` and ``bias`` broadcast over the last dim."""
    deq = acc.float() * (s_x / qmax) * (s_w / qmax)
    if bias is not None:
        deq = deq + _f32(bias)
    if out_scale is not None:
        so = torch.clamp_min(_f32(out_scale).reshape(()), 1e-9)
        deq = torch.round(torch.clamp(deq / so, -1.0, 1.0) * qmax) \
            * (so / qmax)
    return deq if deq.dtype == out_dtype else deq.to(out_dtype)


def int8_mm(a, w):
    """``a @ w.T`` for int8 ``a`` [M, K] and ``w`` [N, K]: an exact int32
    [M, N], computed by one ``torch._int_mm`` over operands padded with
    zero codes to cuBLASLt's rules."""
    m, k = a.shape
    n = w.shape[0]
    kp, np_ = -k % 8, -n % 8
    a = F.pad(a, (0, kp, 0, ROW_PAD))
    if kp or np_:
        w = F.pad(w, (0, kp, 0, np_))
    acc = torch._int_mm(a, w.t())[:m]
    return acc[:, :n] if np_ else acc


def linear_int8(x, w_q, s_x, s_w, bias=None, out_scale=None, bits=8,
                dynamic=False):
    """A frozen linear site: ``x`` [..., in] float, ``w_q`` [out, in]
    int8 (torch's layout; the JAX package's is [in, out]), ``s_w`` [out]
    or [1], ``s_x`` a scalar, or the batch's abs-max when ``dynamic``."""
    qmax = _qmax(bits)
    if dynamic:
        s_x = x.abs().amax()
    x_q, s_x = _quantize_act(x, s_x, qmax)
    acc = int8_mm(x_q.reshape(-1, x_q.shape[-1]), w_q)
    acc = acc.reshape(*x.shape[:-1], w_q.shape[0])
    return _epilogue(acc, s_x, _per_channel(s_w), qmax, bias, out_scale,
                     x.dtype)


def _im2col(x_q, kernel, stride, padding, dilation):
    """NHWC int8 codes to the patch rows [B * Ho * Wo, C * kh * kw],
    columns ordered (c, i, j) as an OIHW weight flattens; zero codes
    pad.  Returns (rows, (Ho, Wo))."""
    b, h, w, c = x_q.shape
    (kh, kw), (sh, sw), (dh, dw) = kernel, stride, dilation
    (pt, pb), (pl, pr) = _pads(padding, (h, w), kernel, stride, dilation)
    x_q = F.pad(x_q, (0, 0, pl, pr, pt, pb))
    eh, ew = (kh - 1) * dh + 1, (kw - 1) * dw + 1
    p = x_q.unfold(1, eh, sh).unfold(2, ew, sw)[..., ::dh, ::dw]
    ho, wo = p.shape[1], p.shape[2]
    return p.reshape(b * ho * wo, c * kh * kw), (ho, wo)


def conv2d_int8(x, w_q, s_x, s_w, bias=None, out_scale=None, bits=8,
                dynamic=False, stride=(1, 1), padding=0, dilation=(1, 1),
                groups=1, channel_last=False):
    """A frozen conv2d site: ``x`` NCHW (NHWC with ``channel_last``)
    float, ``w_q`` OIHW int8, ``s_w`` [O] or [1].  ``padding`` takes
    Paddle's forms (``nn.functional.conv``).  Groups multiply a
    block-diagonal weight, so that a site is one GEMM."""
    qmax = _qmax(bits)
    if dynamic:
        s_x = x.abs().amax()
    x_q, s_x = _quantize_act(x, s_x, qmax)
    if not channel_last:
        x_q = x_q.permute(0, 2, 3, 1)
    o, _, kh, kw = w_q.shape
    rows, (ho, wo) = _im2col(x_q, (kh, kw), _pair(stride), padding,
                             _pair(dilation))
    w2 = w_q.reshape(o, -1) if groups == 1 else torch.block_diag(
        *w_q.reshape(groups, o // groups, -1).unbind(0))
    acc = int8_mm(rows, w2).reshape(x_q.shape[0], ho, wo, o)
    out = _epilogue(acc, s_x, _per_channel(s_w), qmax, bias, out_scale,
                    x.dtype)
    return out if channel_last else out.permute(0, 3, 1, 2)


def matmul_int8(a_q, b_q):
    """Raw int8 x int8 -> int32 product of ``a_q`` [..., K] and ``b_q``
    [K, N], no epilogue."""
    acc = int8_mm(a_q.reshape(-1, a_q.shape[-1]), b_q.t().contiguous())
    return acc.reshape(*a_q.shape[:-1], b_q.shape[1])
