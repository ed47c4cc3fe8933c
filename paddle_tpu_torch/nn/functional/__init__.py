from .attention import (attention_bnsh, cached_attention,  # noqa: F401
                        scaled_dot_product_attention)
from .common import dropout  # noqa: F401
from .loss import cross_entropy  # noqa: F401
