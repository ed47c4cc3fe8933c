"""Quantization: QAT (fake-quant simulation), PTQ (calibration and
weight-only int8) and the freeze pass to int8 programs.

Counterpart of ``paddle_tpu/quantization/`` (the slim quantization
stack: imperative/qat.py, imperative/quant_nn.py,
post_training_quantization.py and quantization_pass.py's freeze), with
the JAX package's exported names.  A frozen site computes its product
with ``ops/int8.py``; ``save_int8_model`` exports the frozen model that
``serving.export_for_serving(int8=True)`` serves.
"""
from .functional import (  # noqa: F401
    fake_quantize_dequantize_abs_max,
    fake_channel_wise_quantize_dequantize_abs_max,
    fake_quantize_dequantize_moving_average_abs_max,
    moving_average_abs_max_scale, quantize_weight_int8, dequantize_weight,
)
from .quant_layers import (  # noqa: F401
    FakeQuantAbsMax, FakeQuantMovingAverage,
    FakeChannelWiseQuantDequantAbsMax, MovingAverageAbsMaxScale,
    QuantizedConv2D, QuantizedLinear,
)
from .qat import ImperativeQuantAware, ImperativeCalcOutScale  # noqa: F401
from .ptq import PostTrainingQuantization, WeightQuantization  # noqa: F401
from .freeze import (  # noqa: F401
    QuantizationFreezePass, FrozenQuantizedLinear, FrozenQuantizedConv2D,
    freeze, save_int8_model, quant_signature, load_quant_sidecar,
)
