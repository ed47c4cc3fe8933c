from .activation import relu  # noqa: F401
from .attention import (attention_bnsh, cached_attention,  # noqa: F401
                        scaled_dot_product_attention)
from .common import (batch_invariant_linear, dropout,  # noqa: F401
                     embedding, label_smooth, linear, one_hot, pad_rows,
                     rows_linear)
from .conv import conv2d, conv_bn_act, conv_bn_fusable  # noqa: F401
from .loss import cross_entropy  # noqa: F401
from .norm import batch_norm  # noqa: F401
from .pooling import adaptive_avg_pool2d, max_pool2d  # noqa: F401
