"""Fused conv+BN(+ReLU): kernel B7, the op, and the space-to-depth stem.

Counterpart of ``paddle_tpu/ops/pallas/fused_conv.py``.  The chain of one
ResNet site, NHWC, Paddle OIHW weight, bias-free:

* forward: :func:`conv_stats` (kernel B7, ``csrc/fused_conv.cu``): the
  conv with f32 accumulation, its output stored once in x's dtype, and
  the per-channel mean and var taken from the f32 accumulator before the
  store (bf16 on the tensor cores, over the weight :func:`weight_kmajor`
  lays out; f32 on FMAs); then B5's apply (``fused_bn.bn_apply``)
  normalizes, shifts and applies the ReLU in one pass;
* backward: B6 on the saved conv output (reduce, coefficients, dx: the
  conv output's cotangent, the ReLU gate recomputed), then the conv's own
  dX and dW through the library convolution backward, as the JAX package
  differentiates ``lax.conv`` there.

:func:`fused_conv_bn_act` is a ``torch.autograd.Function`` returning
``(y, mean, var)``.  On CUDA tensors :func:`conv_stats` launches B7 and
counts it in ``conv_stats.launches``, or raises; on CPU tensors it
computes its plain version :func:`conv_stats_plain`.

:func:`supports` is the JAX gate without its two TPU-only clauses: the
VMEM working-set cap and the single-device condition (the kernel tiles
its own working set in shared memory, and the port runs on one card).
The JAX kernel's extra high-side pad row/col for stride 2 is a Mosaic
workaround and is not carried over: the CUDA kernel bounds-checks its
loads.
"""
from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from . import _build
from . import fused_bn

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_COUNT_LOCK = threading.Lock()
STEM_BLOCK = 2


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def out_hw(h, w, kh, kw, stride, padding):
    return ((h + 2 * padding - kh) // stride + 1,
            (w + 2 * padding - kw) // stride + 1)


def supports(x_shape, w_shape, stride=1, padding=0, dilation=1, groups=1,
             channel_last=True) -> bool:
    """Static eligibility of a conv+BN(+ReLU) site for the fused kernel:
    NHWC, groups 1, dilation 1, stride 1 or 2, symmetric int padding,
    taps up to 5x5 (the 7x7 stem goes through the s2d reorg), and N·Ho·Wo
    a multiple of 8 (the apply and backward passes' contract)."""
    if not channel_last or groups != 1 or len(x_shape) != 4:
        return False
    if _pair(dilation) != (1, 1):
        return False
    s = _pair(stride)
    if s[0] != s[1] or s[0] not in (1, 2):
        return False
    if not isinstance(padding, int):
        if isinstance(padding, (tuple, list)) and len(padding) == 2 and \
                all(isinstance(p, int) for p in padding) and \
                padding[0] == padding[1]:
            padding = padding[0]
        else:
            return False
    n, h, w, cin = x_shape
    cout, cin_w, kh, kw = w_shape
    if cin_w != cin or kh > 5 or kw > 5:
        return False
    ho, wo = out_hw(h, w, kh, kw, s[0], padding)
    if ho <= 0 or wo <= 0:
        return False
    return (n * ho * wo) % 8 == 0


# -- plain version ------------------------------------------------------------

def conv_stats_plain(x, w, stride, padding):
    """B7's function in f32: the conv of NHWC ``x`` with OIHW ``w``, its
    per-channel (mean, var) from the f32 result, and the result in x's
    dtype."""
    yf = F.conv2d(x.float().permute(0, 3, 1, 2), w.float(), None, stride,
                  padding).permute(0, 2, 3, 1)
    mean, var = fused_bn.moments_plain(yf.reshape(-1, yf.shape[-1]))
    return yf.to(x.dtype), mean, var


# -- kernel wrapper -----------------------------------------------------------

K_STEP = 64       # the bf16 kernel's K elements per stage
CIN_ALIGN = 8     # its channel slot of a tap: Cin rounded up to this


def weight_kmajor(w):
    """The bf16 kernel's weight operand: OIHW ``w`` as [Cout, kpad],
    K-major in the kernel's K order, k = (u·kw + v)·cpad + c, with the
    channel slot cpad = Cin rounded up to CIN_ALIGN and kpad = kh·kw·cpad
    rounded up to K_STEP; zero in every padded place."""
    cout, cin, kh, kw = w.shape
    cpad = -(-cin // CIN_ALIGN) * CIN_ALIGN
    ktot = kh * kw * cpad
    wk = F.pad(w.permute(0, 2, 3, 1), (0, cpad - cin)).reshape(cout, ktot)
    return F.pad(wk, (0, -(-ktot // K_STEP) * K_STEP - ktot)).contiguous()


def _check(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")


def conv_stats(x, w, stride=1, padding=0):
    """Kernel B7: (y [N, Ho, Wo, Cout] in x's dtype, f32 mean, f32 var) of
    the conv of NHWC ``x`` with OIHW ``w``; on CPU tensors the plain
    version.  Taps up to 5x5, stride 1 or 2, symmetric padding."""
    if x.ndim != 4 or w.ndim != 4 or x.shape[-1] != w.shape[1]:
        raise ValueError(f"conv_stats takes NHWC x and OIHW w, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    stride, padding = int(stride), int(padding)
    if x.device.type == "cpu":
        return conv_stats_plain(x, w, stride, padding)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"conv_stats: dtype {x.dtype} is not one the kernel "
                        f"takes {tuple(_DTYPE_CODE)}")
    if x.device.index != torch.cuda.current_device() \
            or w.device != x.device:
        raise ValueError("conv_stats: tensors must be on the current CUDA "
                         "device")
    n, h, wd, cin = x.shape
    cout, _, kh, kw = w.shape
    if kh > 5 or kw > 5 or stride not in (1, 2) or padding < 0:
        raise ValueError(f"conv_stats: {kh}x{kw} taps, stride {stride}, "
                         f"padding {padding} are not what the kernel takes "
                         "(taps up to 5x5, stride 1 or 2)")
    ho, wo = out_hw(h, wd, kh, kw, stride, padding)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"conv_stats: empty output {ho}x{wo}")
    x = x.contiguous()
    if x.dtype == torch.bfloat16:                 # tensor cores: [O, kpad]
        wk = weight_kmajor(w.to(x.dtype))
    else:                                         # f32 FMAs: [kh, kw, Cin, O]
        wk = w.to(x.dtype).permute(2, 3, 1, 0).contiguous()
    lib = _build.library("fused_conv")
    m = n * ho * wo
    work = torch.empty((2, lib.conv_tiles(m), cout), dtype=torch.float32,
                       device=x.device)
    y = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)
    mean = torch.empty(cout, dtype=torch.float32, device=x.device)
    var = torch.empty_like(mean)
    dims = (ctypes.c_longlong * 11)(n, h, wd, cin, cout, kh, kw, stride,
                                    padding, ho, wo)
    _check("conv_stats", lib.conv_stats_launch(
        x.data_ptr(), wk.data_ptr(), y.data_ptr(), work[0].data_ptr(),
        work[1].data_ptr(), mean.data_ptr(), var.data_ptr(),
        ctypes.addressof(dims), _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream().cuda_stream))
    with _COUNT_LOCK:
        conv_stats.launches += 1
    return y, mean, var


conv_stats.launches = 0


# -- the op -------------------------------------------------------------------

def _nchw(t):
    """The NCHW view of an NHWC tensor (channels-last memory, no copy)."""
    return t.permute(0, 3, 1, 2)


class _FusedConvBnAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, gamma, beta, stride, padding, eps, relu):
        y_conv, mean, var = conv_stats(x, w, stride, padding)
        inv, scale, shift = fused_bn.scale_shift(gamma, beta, mean, var, eps)
        n, ho, wo, cout = y_conv.shape
        out = fused_bn.bn_apply(y_conv.view(-1, cout), scale, shift, relu)
        ctx.save_for_backward(x, w, gamma, y_conv, mean, inv, scale, shift)
        ctx.conf = (stride, padding, relu, beta.dtype)
        ctx.set_materialize_grads(False)
        return out.view(n, ho, wo, cout), mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x, w, gamma, y_conv, mean, inv, scale, shift = ctx.saved_tensors
        stride, padding, relu, beta_dtype = ctx.conf
        cout = y_conv.shape[-1]
        y2d = y_conv.view(-1, cout)
        dy2d = torch.zeros_like(y2d) if dy is None else dy.reshape(-1, cout)
        dyc, dgamma, dbeta = fused_bn.bn_backward(
            y2d, dy2d, gamma, mean, inv, scale, shift, relu, dmean, dvar)
        # the conv's own transposes through the library convolution
        # backward (compute-bound), on channels-last views
        dx, dw, _ = torch.ops.aten.convolution_backward(
            _nchw(dyc.view(y_conv.shape)), _nchw(x), w.to(x.dtype), None,
            [stride, stride], [padding, padding], [1, 1], False, [0, 0], 1,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        dx = None if dx is None else dx.permute(0, 2, 3, 1)
        dw = None if dw is None else dw.to(w.dtype)
        return (dx, dw, dgamma.to(gamma.dtype), dbeta.to(beta_dtype), None,
                None, None, None)


def fused_conv_bn_act(x, w, gamma, beta, stride=1, padding=0, eps=1e-5,
                      relu=True):
    """NHWC conv (OIHW weight, bias-free, groups 1, dilation 1) + train-
    mode BN over N·H·W + optional fused ReLU.  Returns (y, f32 mean, f32
    var), the batch_norm_train contract, so the running-stat update is
    shared with the plain path.  N·Ho·Wo must be a multiple of 8."""
    n, h, wd, _ = x.shape
    ho, wo = out_hw(h, wd, w.shape[2], w.shape[3], int(stride), int(padding))
    fused_bn.check_rows("fused_conv_bn_act", n * ho * wo)
    return _FusedConvBnAct.apply(x, w, gamma, beta, int(stride),
                                 int(padding), float(eps), bool(relu))


# -- space-to-depth stem reorg ------------------------------------------------

def stem_s2d_input(x):
    """[N, H, W, C] → pad 3 → space-to-depth(2) → [N, (H+6)/2, (W+6)/2, 4C].
    Channel order (dh, dw, c), matching :func:`stem_s2d_weight`."""
    n, h, w, c = x.shape
    b = STEM_BLOCK
    xp = F.pad(x, (0, 0, 3, 3, 3, 3))
    hp, wp = h + 6, w + 6
    x2 = xp.reshape(n, hp // b, b, wp // b, b, c).permute(0, 1, 3, 2, 4, 5)
    return x2.reshape(n, hp // b, wp // b, b * b * c)


def stem_s2d_weight(w):
    """7x7/s2 OIHW weights [O, C, 7, 7] → the equivalent 4x4/s1 kernel over
    the s2d(2) channel layout, [O, 4C, 4, 4]: tap (2k+dh, 2l+dw) lands at
    tap (k, l), channel (dh·2+dw)·C+c; the 8th tap row/col is zero."""
    o, c, kh, kw = w.shape
    b = STEM_BLOCK
    wp = F.pad(w, (0, 1, 0, 1))                                # 8x8 taps
    wr = wp.reshape(o, c, (kh + 1) // b, b, (kw + 1) // b, b)
    w2 = wr.permute(0, 3, 5, 1, 2, 4)              # [o, dh, dw, c, k, l]
    return w2.reshape(o, b * b * c, (kh + 1) // b, (kw + 1) // b)


def stem_supported(x_shape, w_shape) -> bool:
    """The s2d reorg applies to the canonical 7x7/s2/p3 NHWC stem with an
    even input size, and only when the reorged conv passes
    :func:`supports` (s2d without the fused kernel is not shipped)."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    n, h, w, c = x_shape
    cout, cin, kh, kw = w_shape
    if (kh, kw) != (7, 7) or cin != c or h % 2 != 0 or w % 2 != 0:
        return False
    s2d_x = (n, (h + 6) // 2, (w + 6) // 2, 4 * c)
    s2d_w = (cout, 4 * c, 4, 4)
    return supports(s2d_x, s2d_w, stride=1, padding=0)
