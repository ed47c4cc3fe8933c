from . import functional, initializer  # noqa: F401
from .clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue, clip_grad_norm_)
from .layer import (  # noqa: F401
    AdaptiveAvgPool2D, BatchNorm2D, Conv2D, CrossEntropyLoss, Dropout,
    Embedding, Layer, LayerDict, LayerList, LayerNorm, Linear, MaxPool2D,
    MultiHeadAttention, ParamAttr, ParameterList, ReLU, Sequential,
    Transformer, TransformerDecoder, TransformerDecoderLayer,
    TransformerEncoder, TransformerEncoderLayer)
