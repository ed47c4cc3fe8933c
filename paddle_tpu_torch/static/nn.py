"""paddle.static.nn: the static layer functions fc, conv2d and pool2d.

Counterpart of those three in ``paddle_tpu/static/nn.py``.  Each
declares its parameters in the current main program
(``Block.create_parameter``: a persistable var whose initializer runs
as an ``@init`` op of the startup program, on the Executor's device and
from its generator) and calls the same functionals that eager code
calls, which record themselves.  The JAX functions make eager parameters
and seed the scope when the program is built; the recorded main
programs are the same.  The other layer functions of the JAX module raise
:class:`UnimplementedError`.
"""
from __future__ import annotations

from ..framework.enforce import UnimplementedError
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.layer.layers import ParamAttr
from ..ops import manipulation
from .program import default_main_program


def _make_param(shape, attr, default_init, dtype="float32"):
    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    return default_main_program().global_block().create_parameter(
        name=attr.name, shape=list(shape), dtype=dtype,
        initializer=attr.initializer or default_init,
        trainable=attr.trainable)


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    """fluid.layers.fc parity: ``x`` flattened after ``num_flatten_dims``
    dims, times an [in, size] weight (Xavier-uniform), plus a zero
    bias."""
    in_dim = 1
    for d in x.shape[num_flatten_dims:]:
        in_dim *= d
    if len(x.shape) > num_flatten_dims + 1:
        lead = [-1 if (d is None or d < 0) else d
                for d in x.shape[:num_flatten_dims]]
        x = manipulation.reshape(x, lead + [in_dim])
    w = _make_param([in_dim, size], weight_attr, I.XavierUniform())
    b = _make_param([size], bias_attr, I.Constant(0.0))
    out = F.linear(x, w, b)
    return getattr(F, activation)(out) if activation else out


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None,
           data_format="NCHW", name=None):
    """fluid.layers.conv2d parity: an OIHW weight (Xavier-uniform) and a
    zero bias."""
    in_ch = input.shape[1] if data_format == "NCHW" else input.shape[-1]
    ks = filter_size if isinstance(filter_size, (list, tuple)) \
        else [filter_size, filter_size]
    w = _make_param([num_filters, in_ch // groups] + list(ks), param_attr,
                    I.XavierUniform())
    b = _make_param([num_filters], bias_attr, I.Constant(0.0))
    out = F.conv2d(input, w, b, stride=stride, padding=padding,
                   dilation=dilation, groups=groups, data_format=data_format)
    return getattr(F, act)(out) if act else out


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, ceil_mode=False,
           exclusive=True, data_format="NCHW", name=None):
    """fluid.layers.pool2d parity, max pooling (average pooling is not
    ported: ROADMAP A9)."""
    if pool_type != "max":
        raise UnimplementedError(
            f"static.nn.pool2d(pool_type={pool_type!r}) is not ported "
            "(ROADMAP A9)")
    if global_pooling:
        sp = input.shape[2:] if data_format == "NCHW" else input.shape[1:3]
        pool_size, pool_padding, pool_stride = list(sp), 0, 1
    return F.max_pool2d(input, pool_size, pool_stride, pool_padding,
                        ceil_mode=ceil_mode, data_format=data_format)


def _unported(name):
    def layer(*args, **kwargs):
        raise UnimplementedError(
            f"static.nn.{name} is not ported: the port's static layers "
            "are fc, conv2d and pool2d (ROADMAP A13)")
    layer.__name__ = name
    return layer


for _name in ("embedding", "batch_norm", "layer_norm", "dropout",
              "conv2d_transpose", "prelu", "lstm", "gru_unit",
              "spectral_norm", "group_norm", "instance_norm", "conv3d",
              "bilinear_tensor_product", "row_conv", "sequence_conv", "nce"):
    globals()[_name] = _unported(_name)
del _name
