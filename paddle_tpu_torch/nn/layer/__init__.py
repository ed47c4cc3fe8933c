from .common import Dropout  # noqa: F401
from .transformer import (  # noqa: F401
    MultiHeadAttention, TransformerEncoder, TransformerEncoderLayer,
    dequantize_kv_rows, quantize_kv_rows, ring_block_write)
