"""paddle.inference of the port: the Predictor over a ``jit.save`` program
or a static inference model.

Counterpart of ``paddle_tpu/inference/__init__.py`` (``Config``,
``PredictorTensor``, ``Predictor``, ``create_predictor``).  The Predictor
loads its model once, on the Config's device (CUDA unless
``disable_gpu()``):

- a ``jit.save`` program (``jit.load``) runs at any batch size its
  symbolic dims allow;
- a ``static.save_inference_model`` directory (``__model__`` and
  ``__params__``, the port's own format) loads into the Predictor's own
  ``Scope``, as Paddle's AnalysisPredictor has one (the port's var names
  are process-wide counters, so a directory saved by another process
  can name a var of a live program), and runs through a static
  ``Executor``: each new batch size is one new cache entry, eager on its
  first run and captured on its second.  ``Config.set_quant_signature``
  reaches that Executor's cache key as ``quant:<sig>``.

``clone()`` shares the loaded program and its weights (and, on the
static branch, the Executor and its scope) and keeps its own feed and
result buffers, one clone per serving thread.  ``run`` returns numpy
arrays; ``run_async`` returns the device tensors without waiting for
them (a bf16 output reaches numpy as float32, exactly: numpy has no
bfloat16).

Frozen int8 programs (``quantization.save_int8_model``): under
``FLAGS_use_int8_inference`` a model whose prefix has a ``.int8``
sibling loads that one; a ``.int8`` prefix, or a directory or prefix
holding only an int8 export, loads as such.  ``quant_info()`` is then
the ``quant.json`` sidecar, and None on the float path.

Not ported, and raising :class:`UnimplementedError` with its ROADMAP
item: the persistent compile cache (``set_optim_cache_dir``, A4).
"""
from __future__ import annotations

import copy
import glob
import os
from typing import Dict, List

import numpy as np
import torch

from ..framework import flags as _flags
from ..framework.enforce import (InvalidArgumentError, NotFoundError,
                                 UnimplementedError)
from ..framework.place import resolve_device

__all__ = ["Config", "PredictorTensor", "Predictor", "create_predictor"]


class Config:
    """AnalysisConfig parity, the model-path part and the device."""

    def __init__(self, prog_file=None, params_file=None):
        if prog_file and os.path.isdir(prog_file):
            self._model_dir, self._prog_file = prog_file, None
        else:
            self._model_dir, self._prog_file = None, prog_file
        self._params_file = params_file
        self._device = None             # None: CUDA
        self._quant_signature = None

    def set_model(self, prog_file, params_file=None):
        device, sig = self._device, self._quant_signature
        self.__init__(prog_file, params_file)
        self._device, self._quant_signature = device, sig

    def set_quant_signature(self, signature):
        """The quantization signature a static program's Executor folds
        into its cache key (``quant:<signature>``)."""
        self._quant_signature = signature

    def quant_signature(self):
        return self._quant_signature

    def model_dir(self):
        return self._model_dir

    def prog_file(self):
        return self._prog_file

    def params_file(self):
        return self._params_file

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._device = f"cuda:{int(device_id)}"

    def disable_gpu(self):
        self._device = "cpu"

    def device(self):
        return self._device

    def set_optim_cache_dir(self, path):
        raise UnimplementedError(
            "Config.set_optim_cache_dir: the persistent compile cache is "
            "not ported (ROADMAP A4); a served program's CUDA graphs are "
            "captured at Server.start()")


def _numpy(t):
    """A device tensor as numpy (bf16 widened to f32, exactly)."""
    if torch.is_tensor(t):
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


class PredictorTensor:
    """ZeroCopyTensor parity: a named feed or fetch slot."""

    def __init__(self, predictor, name, is_input):
        self._p = predictor
        self.name = name
        self._is_input = is_input

    def copy_from_cpu(self, arr):
        if not self._is_input:
            raise InvalidArgumentError(
                f"copy_from_cpu on fetch {self.name!r}: only feed handles "
                "accept input data (use copy_to_cpu to read outputs)")
        arr = np.asarray(arr)
        declared = self._p._declared_shapes.get(self.name)
        if declared is not None and tuple(arr.shape) != declared:
            raise InvalidArgumentError(
                f"feed {self.name!r}: copy_from_cpu got shape "
                f"{list(arr.shape)} but reshape() declared "
                f"{list(declared)}")
        self._p._feeds[self.name] = arr

    def copy_to_cpu(self):
        if self._is_input:
            if self.name not in self._p._feeds:
                raise NotFoundError(
                    f"feed {self.name!r} has no value yet — "
                    "copy_from_cpu() it first")
            return _numpy(self._p._feeds[self.name])
        if self.name not in self._p._results:
            raise NotFoundError(
                f"fetch {self.name!r} has no value yet — call run() "
                "before copy_to_cpu()")
        return _numpy(self._p._results[self.name])

    def reshape(self, shape):
        """ZeroCopyTensor::Reshape parity: declare the shape the next
        copy_from_cpu must carry; a mismatching copy raises."""
        if not self._is_input:
            raise InvalidArgumentError(
                f"reshape on fetch {self.name!r}: output shapes are "
                "decided by the program")
        dims = []
        for d in shape:
            d = int(d)
            if d <= 0:
                raise InvalidArgumentError(
                    f"feed {self.name!r}: reshape dims must be concrete "
                    f"positive ints, got {list(shape)} (dynamic batch is "
                    "declared at export via InputSpec([None, ...]))")
            dims.append(d)
        self._p._declared_shapes[self.name] = tuple(dims)

    def shape(self):
        if self._is_input:
            declared = self._p._declared_shapes.get(self.name)
            if declared is not None:
                return list(declared)
            if self.name not in self._p._feeds:
                raise NotFoundError(
                    f"feed {self.name!r} has no shape yet — reshape() or "
                    "copy_from_cpu() it first")
            return list(self._p._feeds[self.name].shape)
        if self.name not in self._p._results:
            raise NotFoundError(
                f"fetch {self.name!r} has no shape yet — call run() "
                "before shape()")
        return list(self._p._results[self.name].shape)


class Predictor:
    """AnalysisPredictor parity over a ``jit.save`` program or a static
    inference model."""

    def __init__(self, config: Config):
        d = config.model_dir() or config.prog_file()
        if d is None:
            raise ValueError("Config needs a model dir or a jit.save "
                             "prefix")
        self.device = resolve_device(config.device())
        self._translated = None
        self._quant_info = None
        self._feeds: Dict[str, object] = {}
        self._results: Dict[str, object] = {}
        self._declared_shapes: Dict[str, tuple] = {}
        prefix = self._jit_prefix(d)
        if prefix is None:
            self._load_static(config, d)
        else:
            self._load_jit(prefix)

    def _load_static(self, config, d):
        from ..static import Executor, Scope, load_inference_model
        self._scope = Scope()
        self._program, self._feed_names, fetch_vars = load_inference_model(
            d, scope=self._scope)
        self._fetch_names = [v.name for v in fetch_vars]
        self._exe = Executor(self.device)
        sig = config.quant_signature()
        if sig is not None:
            self._exe.set_cache_extra_key(f"quant:{sig}")

    def _load_jit(self, prefix):
        from .. import jit as _jit
        from ..quantization.freeze import load_quant_sidecar
        # the int8 sibling is chosen by the flag; a '.int8' prefix (or an
        # int8-only export) is int8 whatever the flag says
        if _flags.flag("use_int8_inference") \
                and not prefix.endswith(".int8") \
                and os.path.isfile(prefix + ".int8.pdmodel"):
            prefix += ".int8"
        if prefix.endswith(".int8"):
            self._quant_info = load_quant_sidecar(prefix[:-len(".int8")])
        self._translated = _jit.load(prefix, device=self.device)
        self._feed_names = [f"x{i}" for i in range(
            self._translated.num_inputs)]
        self._fetch_names = [f"out{i}" for i in range(
            self._translated.num_outputs)]

    def quant_info(self):
        """The served model's quantization sidecar (``quant.json``) when
        the int8 program was loaded; None on the float path."""
        return self._quant_info

    def clone(self):
        """AnalysisPredictor::Clone parity: a predictor sharing this one's
        loaded program and weights (the same TranslatedLayer; on the
        static branch the same program, Executor and scope), with its own
        feed and result buffers."""
        c = copy.copy(self)
        c._feeds, c._results, c._declared_shapes = {}, {}, {}
        return c

    @staticmethod
    def _jit_prefix(d):
        if d.endswith(".pdmodel"):
            return d[:-len(".pdmodel")]
        if os.path.isfile(d + ".pdmodel"):
            return d
        if os.path.isfile(d + ".int8.pdmodel"):
            return d + ".int8"
        if os.path.isdir(d) and not os.path.exists(
                os.path.join(d, "__model__")):
            pdm = sorted(p for p in glob.glob(os.path.join(d, "*.pdmodel"))
                         if not p.endswith(".int8.pdmodel"))
            if pdm:
                return pdm[0][:-len(".pdmodel")]
            pdm = sorted(glob.glob(os.path.join(d, "*.int8.pdmodel")))
            if pdm:
                return pdm[0][:-len(".pdmodel")]
        return None

    def get_input_names(self) -> List[str]:
        return list(self._feed_names)

    def get_output_names(self) -> List[str]:
        return list(self._fetch_names)

    def get_input_handle(self, name):
        return PredictorTensor(self, name, True)

    def get_output_handle(self, name):
        return PredictorTensor(self, name, False)

    def run_async(self, inputs=None):
        """Run the program on the feeds (or ``inputs``, positional) and
        return its outputs as device tensors, without waiting for the
        device; results land in the buffers ``copy_to_cpu`` reads."""
        return self._run(inputs, False)

    def run(self, inputs=None):
        """ZeroCopyRun parity; also takes positional arrays like the 2.x
        predictor.run(list).  Returns numpy arrays."""
        return self._run(inputs, True)

    def _run(self, inputs, to_numpy):
        if inputs is not None:
            for name, arr in zip(self._feed_names, inputs):
                self._feeds[name] = arr
        if self._translated is None:
            # the Executor's numpy copy is the fence of a synchronous run
            outs = self._exe.run(self._program, feed=dict(self._feeds),
                                 fetch_list=self._fetch_names,
                                 scope=self._scope, return_numpy=to_numpy)
        else:
            out = self._translated(*[self._feeds[n]
                                     for n in self._feed_names])
            outs = out if isinstance(out, (list, tuple)) else [out]
            if to_numpy:
                outs = [_numpy(o) for o in outs]
        self._results = dict(zip(self._fetch_names, outs))
        return [self._results[n] for n in self._fetch_names]


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)
