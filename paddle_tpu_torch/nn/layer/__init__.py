from .activation import ReLU  # noqa: F401
from .common import Dropout  # noqa: F401
from .conv import Conv2D  # noqa: F401
from .loss import CrossEntropyLoss  # noqa: F401
from .norm import BatchNorm2D  # noqa: F401
from .pooling import AdaptiveAvgPool2D, MaxPool2D  # noqa: F401
from .transformer import (  # noqa: F401
    MultiHeadAttention, TransformerEncoder, TransformerEncoderLayer,
    dequantize_kv_rows, quantize_kv_rows, ring_block_write)
