"""``Layer``, the base of Paddle models, and ``ParamAttr``.

Counterpart of ``paddle_tpu/nn/layer/layers.py``.  ``Layer`` is a
``torch.nn.Module`` that answers to Paddle's names over torch's own
machinery: sublayers are torch submodules, parameters ``nn.Parameter``s
and buffers torch buffers, so ``torch.export``, ``functional_call``,
``torch.func`` and the optimizers see a ``Layer`` as any module.
``__call__`` is torch's: forward pre-hooks, ``forward``, forward hooks,
which are Paddle's pre- and post-hooks with the same contracts.

Names are the JAX package's: a sublayer's parameter is
``<sublayer>.<name>`` and ``state_dict`` lists every parameter (in
``named_parameters`` order) before the persistable buffers, so a JAX
layer's ``state_dict`` keys and the port's are the same list.

``ParamAttr``: ``Layer.create_parameter`` reads its initializer and
``trainable``, the static builders (``static/nn.py``) its name too;
``learning_rate``, ``regularizer`` and ``need_clip`` are kept for the
signature and not read.
"""
from __future__ import annotations

import collections

import numpy as np
import torch
from torch import nn

from ...framework.dtype import convert_dtype
from ...framework.place import DeviceLike, resolve_device
from .. import initializer as I


class ParamAttr:
    """python/paddle/fluid/param_attr.py parity."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """``None`` → defaults, a string → a name, an initializer → that
        initializer, ``False`` → no parameter (returns False)."""
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, bool):
            return ParamAttr() if attr else False
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        raise TypeError(f"cannot convert {attr!r} to ParamAttr")


def _dtype_arg(value):
    """A Paddle dtype name as torch takes it ("bfloat16" →
    torch.bfloat16); anything else (a device string, a tensor) as it
    is."""
    if not isinstance(value, str):
        return value
    try:
        return convert_dtype(value)
    except TypeError:
        return value


class Layer(nn.Module):
    """dygraph/layers.py:76 parity over ``torch.nn.Module``."""

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = dtype
        self._full_name = name_scope or self.__class__.__name__.lower()

    # -- construction --------------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, *,
                         device: DeviceLike = None):
        """A new ``nn.Parameter`` of ``shape`` drawn by ``attr``'s
        initializer, else ``default_initializer``, else zeros for a bias
        and Xavier-uniform for a weight, on ``device`` (CUDA unless the
        caller passes ``device="cpu"``); None when ``attr`` is False.  It
        is not registered: assign it to an attribute or pass it to
        :meth:`add_parameter`."""
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        init = attr.initializer or default_initializer or \
            (I.Constant(0.0) if is_bias else I.XavierUniform())
        value = init(list(shape), convert_dtype(dtype or self._dtype),
                     resolve_device(device))
        return nn.Parameter(value, requires_grad=bool(attr.trainable))

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def add_parameter(self, name, parameter):
        self.register_parameter(str(name), parameter)
        return parameter

    def register_buffer(self, name, tensor, persistable=True, *,
                        persistent=None):
        """Paddle's ``persistable`` is torch's ``persistent`` (either
        keyword is taken); a non-tensor value becomes a tensor."""
        if tensor is not None and not torch.is_tensor(tensor):
            tensor = torch.as_tensor(np.asarray(tensor))
        super().register_buffer(
            name, tensor,
            persistent=persistable if persistent is None else persistent)

    # -- traversal -----------------------------------------------------------
    def parameters(self, include_sublayers=True, *, recurse=None):
        """A list, as Paddle returns it."""
        return list(super().parameters(
            include_sublayers if recurse is None else recurse))

    def named_parameters(self, prefix="", include_sublayers=True,
                         remove_duplicate=True, *, recurse=None):
        return super().named_parameters(
            prefix, include_sublayers if recurse is None else recurse,
            remove_duplicate)

    def buffers(self, include_sublayers=True, *, recurse=None):
        return list(super().buffers(
            include_sublayers if recurse is None else recurse))

    def named_buffers(self, prefix="", include_sublayers=True,
                      remove_duplicate=True, *, recurse=None):
        return super().named_buffers(
            prefix, include_sublayers if recurse is None else recurse,
            remove_duplicate)

    def sublayers(self, include_self=False):
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False):
        for name, layer in self.named_modules(prefix=prefix):
            if layer is not self or include_self:
                yield name, layer

    def full_name(self):
        return self._full_name

    # -- state ---------------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, *, prefix="",
                   keep_vars=False):
        """Parameters, then persistable buffers, each under its dotted
        name.  A parent module's ``state_dict`` reaches this with its own
        ``destination`` and gets torch's behaviour."""
        if destination is not None:
            return super().state_dict(destination=destination,
                                      prefix=prefix, keep_vars=keep_vars)
        pre = structured_name_prefix or prefix
        if include_sublayers:
            sd = super().state_dict(prefix=pre, keep_vars=keep_vars)
        else:
            sd = collections.OrderedDict()
            self._save_to_state_dict(sd, pre, keep_vars)
        params = {pre + n for n, _ in self.named_parameters(
            include_sublayers=include_sublayers, remove_duplicate=False)}
        out = collections.OrderedDict(
            [(k, v) for k, v in sd.items() if k in params]
            + [(k, v) for k, v in sd.items() if k not in params])
        out._metadata = getattr(sd, "_metadata", None)
        return out

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy ``state_dict``'s values (tensors or arrays) into the
        parameters and buffers of the same names, cast to their dtypes;
        returns (missing names, unexpected names)."""
        own = self.state_dict(keep_vars=True)
        unexpected = [n for n in state_dict if n not in own]
        for name, value in state_dict.items():
            if name not in own:
                continue
            if not torch.is_tensor(value):
                arr = np.asarray(value.numpy() if hasattr(value, "numpy")
                                 else value)
                if arr.dtype.name == "bfloat16":
                    arr = arr.astype(np.float32)
                value = torch.from_numpy(np.array(arr))
            if tuple(value.shape) != tuple(own[name].shape):
                raise ValueError(
                    f"set_state_dict: {name} has shape "
                    f"{tuple(value.shape)}, the layer's is "
                    f"{tuple(own[name].shape)}")
            own[name].copy_(value)
        return [n for n in own if n not in state_dict], unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    # -- dtype and device ----------------------------------------------------
    def to(self, *args, **kwargs):
        """torch's ``to``, also taking Paddle's dtype names."""
        return super().to(*[_dtype_arg(a) for a in args],
                          **{k: _dtype_arg(v) for k, v in kwargs.items()})

    def astype(self, dtype):
        return self.to(dtype=dtype)

    # -- hooks and gradients -------------------------------------------------
    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)``; a value it returns replaces
        the outputs.  Returns a handle with ``remove()``."""
        return self.register_forward_hook(hook)

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None
