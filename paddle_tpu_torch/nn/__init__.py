from . import functional  # noqa: F401
from .layer import (  # noqa: F401
    MultiHeadAttention, TransformerEncoder, TransformerEncoderLayer)
