"""Post-training quantization.

Counterpart of ``paddle_tpu/quantization/ptq.py``:
``PostTrainingQuantization`` (activation scales calibrated over sample
batches: abs_max, avg, or hist/KL/mse as a quantile of the batches'
abs-max) and ``WeightQuantization`` (weight-only int8).  Calibration runs
the model in eval mode on its own device, each batch moved there, with
``register_forward_hook`` observers on every Conv2D and Linear site; the
observed abs-max stays on the device until the reduction.  The observed
output scale of each site is recorded as ``_frozen_out_scale``, which
the freeze pass folds into the site's epilogue.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..framework.place import module_device
from ..nn.layer.conv import Conv2D
from . import functional as QF
from .qat import ImperativeQuantAware
from .quant_layers import (FakeQuantMovingAverage, QuantizedConv2D,
                           QuantizedLinear)

_SITES = (Conv2D, nn.Linear)


def _first(v):
    return v[0] if isinstance(v, (tuple, list)) else v


class PostTrainingQuantization:
    """Calibrate activation scales on sample data, then swap in the
    fake-quantized layers with those scales (post_training_quantization.py
    parity, dygraph form): ``quantize()`` runs ``batch_nums`` batches of
    ``data_loader`` through ``model`` and returns it quantized, with its
    weights quantized per channel."""

    def __init__(self, model=None, data_loader=None, batch_nums=10,
                 algo="abs_max", hist_percent=0.99999,
                 quantizable_op_type=("conv2d", "linear"),
                 weight_bits=8, activation_bits=8,
                 weight_quantize_type="channel_wise_abs_max",
                 executor=None, scope=None, model_dir=None, **kwargs):
        if algo not in ("abs_max", "avg", "hist", "KL", "mse"):
            raise ValueError(f"unknown algo {algo}")
        self._model = model
        self._loader = data_loader
        self._batch_nums = batch_nums
        self._algo = algo
        self._hist_percent = hist_percent
        self._weight_bits = weight_bits
        self._activation_bits = activation_bits
        self._weight_quantize_type = weight_quantize_type
        self._observed = {}
        self._observed_out = {}

    def _observe(self, name):
        store = self._observed.setdefault(name, [])
        store_out = self._observed_out.setdefault(name, [])

        def hook(layer, inputs, output):
            store.append(_first(inputs).detach().abs().amax().float())
            y = _first(output)
            if torch.is_tensor(y):
                store_out.append(y.detach().abs().amax().float())

        return hook

    def _reduce(self, obs):
        a = torch.stack(obs).cpu().double().numpy()
        if self._algo == "avg":
            return float(a.mean())
        if self._algo in ("hist", "KL", "mse"):
            return float(np.quantile(a, self._hist_percent))
        return float(a.max())

    @torch.no_grad()
    def quantize(self):
        """Calibrate, then swap in the quantized layers with the
        calibrated scales set."""
        model = self._model
        device = module_device(model) or torch.device("cpu")
        hooks = [sub.register_forward_hook(self._observe(name))
                 for name, sub in model.named_modules()
                 if name and isinstance(sub, _SITES)]
        model.eval()
        try:
            for i, batch in enumerate(self._loader):
                if i >= self._batch_nums:
                    break
                model(torch.as_tensor(_first(batch), device=device))
        finally:
            for h in hooks:
                h.remove()
        self._scales = {n: self._reduce(o) for n, o in self._observed.items()
                        if o}
        self._out_scales = {n: self._reduce(o)
                            for n, o in self._observed_out.items() if o}
        ImperativeQuantAware(
            weight_bits=self._weight_bits,
            activation_bits=self._activation_bits,
            weight_quantize_type=self._weight_quantize_type).quantize(model)
        for name, sub in model.named_modules():
            if not isinstance(sub, (QuantizedConv2D, QuantizedLinear)):
                continue
            fq, s = sub._fake_quant_input, self._scales.get(name)
            if isinstance(fq, FakeQuantMovingAverage) and s is not None:
                fq.scale.fill_(s)
                fq.accum.fill_(s)
                fq.state.fill_(1.0)
            if name in self._out_scales:
                sub._frozen_out_scale = self._out_scales[name]
        model.eval()
        return model

    def save_quantized_model(self, save_model_path, **config):
        from .. import jit
        jit.save(self._model, save_model_path, **config)


class WeightQuantization:
    """Weight-only int8 quantization (post_training_quantization.py:884):
    each Conv2D and Linear weight to int8 codes and per-output-channel
    scales, and back, in place."""

    def __init__(self, model):
        self._model = model

    @torch.no_grad()
    def quantize_weight_to_int8(self, weight_bits=8,
                                quantizable_op_type=("conv2d", "linear")):
        """Returns {site name: (int8 codes, scales)}."""
        packed = {}
        for name, sub in self._model.named_modules():
            if not name or not isinstance(sub, _SITES):
                continue
            # the output channel is axis 0 of both OIHW and torch's
            # [out, in] linear weight
            q, s = QF.quantize_weight_int8(sub.weight, quant_axis=0,
                                           bit_length=weight_bits)
            packed[name] = (q, s)
            sub.weight.copy_(QF.dequantize_weight(q, s, weight_bits)
                             .to(sub.weight.dtype))
        return packed
