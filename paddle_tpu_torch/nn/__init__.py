from . import functional  # noqa: F401
from .layer import (  # noqa: F401
    Dropout, MultiHeadAttention, TransformerEncoder, TransformerEncoderLayer)
