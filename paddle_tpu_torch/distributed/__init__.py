"""paddle.distributed of the port, kept to the parameter-server stack and
the file datasets.

Counterpart of ``paddle_tpu/distributed``.  The collectives, fleet,
launch and spawn over ``torch.distributed`` are not ported (ROADMAP A12).
"""
from . import ps  # noqa: F401
from .dataset import (  # noqa: F401
    DatasetBase, InMemoryDataset, QueueDataset,
)
