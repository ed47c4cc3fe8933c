from . import functional  # noqa: F401
from .layer import (  # noqa: F401
    AdaptiveAvgPool2D, BatchNorm2D, Conv2D, CrossEntropyLoss, Dropout,
    MaxPool2D, MultiHeadAttention, ReLU, TransformerEncoder,
    TransformerEncoderLayer)
