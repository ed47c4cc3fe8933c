from .bert import (BertConfig, BertForPretraining, BertModel,  # noqa: F401
                   BertPretrainingHeads)
from .gpt import GPTConfig, GPTModel  # noqa: F401
