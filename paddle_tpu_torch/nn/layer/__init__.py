from .activation import ReLU  # noqa: F401
from .common import Dropout, Embedding, Linear  # noqa: F401
from .container import (LayerDict, LayerList, ParameterList,  # noqa: F401
                        Sequential)
from .conv import Conv2D  # noqa: F401
from .layers import Layer, ParamAttr  # noqa: F401
from .loss import CrossEntropyLoss  # noqa: F401
from .norm import BatchNorm2D, LayerNorm  # noqa: F401
from .pooling import AdaptiveAvgPool2D, MaxPool2D  # noqa: F401
from .transformer import (  # noqa: F401
    MultiHeadAttention, Transformer, TransformerDecoder,
    TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer,
    dequantize_kv_rows, quantize_kv_rows, ring_block_write)
from .moe import ExpertFFN, MoEEncoderLayer, MoELayer  # noqa: F401
