"""Fused train-mode batch norm (+ReLU): kernels B5 and B6, and the op.

Counterpart of ``paddle_tpu/ops/pallas/fused_bn.py``.  Over a [M, C]
channels-last activation (N·H·W flattened into M), four streaming passes:

    B5 stats       mean, var = Σx / M, max(Σx² / M − mean², 0)
    B5 apply       y = x·scale + shift  (+ReLU)
    B6 reduce      Σdy'·x, Σdy'         (dy' = dy gated by x·scale+shift > 0)
    B6 dx          dx = a·dy' + b·x + c

with scale = γ·rsqrt(var + eps) and shift = β − mean·scale, and the
coefficients a, b, c of :func:`bn_dx_coeffs`.  :func:`fused_bn_act` chains
them into a ``torch.autograd.Function`` returning ``(y, mean, var)``, with
gradients through all three (a loss on the batch statistics gets the same
dx as through the plain formulas).

On CUDA tensors each wrapper (:func:`bn_moments`, :func:`bn_apply`,
:func:`bn_bwd_reduce`, :func:`bn_bwd_dx`) launches its kernel of
``csrc/fused_bn.cu`` and counts the launch in its ``launches`` attribute;
a dtype other than f32/bf16, a tensor on another device or a failed
build or launch raises.  On CPU tensors each computes its plain version
(``*_plain``), which is also what the kernels are held against.  The
kernels take any M; :func:`fused_bn_act` keeps the TPU kernel's contract
that M be a multiple of 8 (``ValueError`` otherwise).
"""
from __future__ import annotations

import threading

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_COUNT_LOCK = threading.Lock()   # counters' += is a read-modify-write


# -- plain versions -----------------------------------------------------------

def _gate(xf, scale, shift, relu, dy):
    """dy' = dy where x·scale + shift > 0 (the ReLU's gate, recomputed
    from x), else dy itself."""
    if not relu:
        return dy
    return torch.where(xf * scale + shift > 0.0, dy, torch.zeros_like(dy))


def moments_plain(x2d):
    """B5 stats: f32 (mean, var) of each column of ``x2d``."""
    xf = x2d.float()
    m = x2d.shape[0]
    mean = xf.sum(0) / m
    var = torch.clamp_min(((xf * xf).sum(0)) / m - mean * mean, 0.0)
    return mean, var


def apply_plain(x2d, scale, shift, relu):
    """B5 apply: x·scale + shift (+ReLU) in f32, stored in x's dtype."""
    y = x2d.float() * scale + shift
    if relu:
        y = torch.where(y < 0.0, torch.zeros_like(y), y)
    return y.to(x2d.dtype)


def bwd_reduce_plain(x2d, dy, scale, shift, relu):
    """B6 reduce: f32 (Σdy'·x, Σdy') per column."""
    xf = x2d.float()
    d = _gate(xf, scale, shift, relu, dy.float())
    return (d * xf).sum(0), d.sum(0)


def bwd_dx_plain(x2d, dy, scale, shift, a, b, c, relu):
    """B6 dx: a·dy' + b·x + c in f32, stored in x's dtype."""
    xf = x2d.float()
    d = _gate(xf, scale, shift, relu, dy.float())
    return (a * d + b * xf + c).to(x2d.dtype)


def bn_dx_coeffs(gamma, inv, mean, dbeta, sum_dyx, m, dmean=None, dvar=None):
    """(dgamma, a, b, c) of the coefficient-form BN backward.

    dx = γ·inv·dy' − γ·inv/M·dbeta − γ·inv/M·x̂·dgamma  =  a·dy' + b·x + c
      a = γ·inv,  b = −γ·inv²·dgamma/M,  c = −γ·inv·dbeta/M − b·mean
    Cotangents through the returned statistics (∂mean/∂x = 1/M,
    ∂var/∂x = 2(x − mean)/M) fold into the same coefficient form."""
    dgamma = inv * (sum_dyx - mean * dbeta)
    g = gamma.float()
    a = g * inv
    b = -(g * inv) * (inv * dgamma) / m
    cc = -(g * inv) * (dbeta / m) - b * mean
    if dvar is not None:
        dvar = dvar.float()
        b = b + 2.0 * dvar / m
        cc = cc - 2.0 * dvar * mean / m
    if dmean is not None:
        cc = cc + dmean.float() / m
    return dgamma, a, b, cc


# -- kernel wrappers ----------------------------------------------------------

def _check(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _prepare(name, x2d, *others):
    """Validate a [M, C] activation (and ``others`` of its shape and
    dtype) for the kernels; returns them contiguous, with (M, C) and the
    dtype code."""
    if x2d.ndim != 2:
        raise ValueError(f"{name} takes a [M, C] activation, got "
                         f"{tuple(x2d.shape)}")
    if x2d.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x2d.dtype} is not one the kernels "
                        f"take {tuple(_DTYPE_CODE)}")
    if x2d.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors must be on the current CUDA "
                         "device")
    out = [x2d.contiguous()]
    for t in others:
        if tuple(t.shape) != tuple(x2d.shape) or t.device != x2d.device:
            raise ValueError(f"{name}: {tuple(t.shape)} on {t.device} does "
                             f"not match x {tuple(x2d.shape)}")
        out.append(t.to(x2d.dtype).contiguous())
    return out, x2d.shape[0], x2d.shape[1], _DTYPE_CODE[x2d.dtype]


def _vec(name, v, C, device):
    """A per-channel vector as the kernels read it: f32, contiguous, [C]."""
    if v.numel() != C or v.device != device:
        raise ValueError(f"{name}: per-channel vector {tuple(v.shape)} on "
                         f"{v.device}, want [{C}] on {device}")
    return v.reshape(C).float().contiguous()


def _partials(M, C, code, device):
    chunks = _build.library("fused_bn").bn_chunks(M, C, code)
    if chunks <= 0:
        raise ValueError(f"fused_bn: no launch plan for M={M}, C={C}")
    return torch.empty((2, chunks, C), dtype=torch.float32, device=device)


def _count(fn):
    with _COUNT_LOCK:
        fn.launches += 1


def bn_moments(x2d):
    """Kernel B5 stats: f32 (mean, var) over the rows of ``x2d`` [M, C];
    on CPU tensors the plain version."""
    if x2d.device.type == "cpu":
        return moments_plain(x2d)
    (x,), M, C, code = _prepare("bn_moments", x2d)
    work = _partials(M, C, code, x.device)
    mean = torch.empty(C, dtype=torch.float32, device=x.device)
    var = torch.empty_like(mean)
    _check("bn_moments", _build.library("fused_bn").bn_stats_launch(
        x.data_ptr(), work[0].data_ptr(), work[1].data_ptr(),
        mean.data_ptr(), var.data_ptr(), M, C, code, _stream()))
    _count(bn_moments)
    return mean, var


def bn_apply(x2d, scale, shift, relu):
    """Kernel B5 apply: x·scale + shift (+ReLU) in x's dtype; on CPU
    tensors the plain version."""
    if x2d.device.type == "cpu":
        return apply_plain(x2d, scale, shift, relu)
    (x,), M, C, code = _prepare("bn_apply", x2d)
    sc, sh = (_vec("bn_apply", v, C, x.device) for v in (scale, shift))
    y = torch.empty_like(x)
    _check("bn_apply", _build.library("fused_bn").bn_apply_launch(
        x.data_ptr(), sc.data_ptr(), sh.data_ptr(), y.data_ptr(), M, C,
        int(bool(relu)), code, _stream()))
    _count(bn_apply)
    return y


def bn_bwd_reduce(x2d, dy, scale, shift, relu):
    """Kernel B6 reduce: f32 (Σdy'·x, Σdy') per column, dy' masked by the
    ReLU gate recomputed from x; on CPU tensors the plain version."""
    if x2d.device.type == "cpu":
        return bwd_reduce_plain(x2d, dy, scale, shift, relu)
    (x, d), M, C, code = _prepare("bn_bwd_reduce", x2d, dy)
    sc, sh = (_vec("bn_bwd_reduce", v, C, x.device) for v in (scale, shift))
    work = _partials(M, C, code, x.device)
    sum_dyx = torch.empty(C, dtype=torch.float32, device=x.device)
    sum_dy = torch.empty_like(sum_dyx)
    _check("bn_bwd_reduce", _build.library("fused_bn").bn_bwd_reduce_launch(
        x.data_ptr(), d.data_ptr(), sc.data_ptr(), sh.data_ptr(),
        work[0].data_ptr(), work[1].data_ptr(), sum_dyx.data_ptr(),
        sum_dy.data_ptr(), M, C, int(bool(relu)), code, _stream()))
    _count(bn_bwd_reduce)
    return sum_dyx, sum_dy


def bn_bwd_dx(x2d, dy, scale, shift, a, b, c, relu):
    """Kernel B6 dx: a·dy' + b·x + c in x's dtype; on CPU tensors the
    plain version."""
    if x2d.device.type == "cpu":
        return bwd_dx_plain(x2d, dy, scale, shift, a, b, c, relu)
    (x, d), M, C, code = _prepare("bn_bwd_dx", x2d, dy)
    vecs = [_vec("bn_bwd_dx", v, C, x.device) for v in (scale, shift, a, b,
                                                         c)]
    dx = torch.empty_like(x)
    _check("bn_bwd_dx", _build.library("fused_bn").bn_bwd_dx_launch(
        x.data_ptr(), d.data_ptr(), *(v.data_ptr() for v in vecs),
        dx.data_ptr(), M, C, int(bool(relu)), code, _stream()))
    _count(bn_bwd_dx)
    return dx


bn_moments.launches = 0
bn_apply.launches = 0
bn_bwd_reduce.launches = 0
bn_bwd_dx.launches = 0


def launch_counts(reset=False):
    """Every launch count of this module (and reset them to 0)."""
    fns = (bn_moments, bn_apply, bn_bwd_reduce, bn_bwd_dx)
    with _COUNT_LOCK:
        out = {f.__name__: f.launches for f in fns}
        if reset:
            for f in fns:
                f.launches = 0
    return out


# -- the op -------------------------------------------------------------------

def scale_shift(gamma, beta, mean, var, eps):
    """(inv, scale, shift) of the normalize pass, in f32."""
    inv = torch.rsqrt(var + eps)
    scale = inv * gamma.float()
    return inv, scale, beta.float() - mean * scale


def bn_backward(x2d, dy, gamma, mean, inv, scale, shift, relu, dmean=None,
                dvar=None):
    """(dx, dgamma, dbeta) of train-mode BN(+ReLU) over ``x2d``: B6 reduce,
    the coefficients, B6 dx.  Shared with the fused conv's backward."""
    sum_dyx, dbeta = bn_bwd_reduce(x2d, dy, scale, shift, relu)
    dgamma, a, b, cc = bn_dx_coeffs(gamma, inv, mean, dbeta, sum_dyx,
                                    x2d.shape[0], dmean, dvar)
    return bn_bwd_dx(x2d, dy, scale, shift, a, b, cc, relu), dgamma, dbeta


class _FusedBnAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, gamma, beta, eps, relu):
        mean, var = bn_moments(x2d)
        inv, scale, shift = scale_shift(gamma, beta, mean, var, eps)
        y = bn_apply(x2d, scale, shift, relu)
        ctx.save_for_backward(x2d, gamma, mean, inv, scale, shift)
        ctx.relu = relu
        ctx.beta_dtype = beta.dtype
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x2d, gamma, mean, inv, scale, shift = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x2d)
        dx, dgamma, dbeta = bn_backward(x2d, dy, gamma, mean, inv, scale,
                                        shift, ctx.relu, dmean, dvar)
        return (dx, dgamma.to(gamma.dtype), dbeta.to(ctx.beta_dtype), None,
                None)


def check_rows(name, m):
    """The TPU kernel's tiling contract: M a multiple of 8."""
    if m % 8:
        raise ValueError(f"{name}: M={m} has no tile; pad M to a multiple "
                         f"of 8")


def fused_bn_act(x2d, gamma, beta, eps=1e-5, relu=True):
    """Train-mode BN over axis 0 of a [M, C] activation with an optional
    fused ReLU.  Returns (y in x's dtype, f32 mean, f32 var), the contract
    of the batch_norm_train primitive after flattening N·spatial → M
    (NHWC).  M must be a multiple of 8."""
    check_rows("fused_bn_act", x2d.shape[0])
    return _FusedBnAct.apply(x2d, gamma, beta, float(eps), bool(relu))
