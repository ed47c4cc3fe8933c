"""Parameter-server stack: host sparse tables + RPC + distributed embedding.

Counterpart of ``paddle_tpu/distributed/ps``.  Reference parity map:
  table.py        ≙ paddle/fluid/distributed/table/table.h:32 + large_scale_kv.h
  service.py      ≙ distributed/service/server.h:50, operators/distributed/ RPC
  embedding.py    ≙ parameter_prefetch/parameter_send sparse pull/push
  device_cache.py ≙ framework/fleet/ps_gpu_wrapper.h (HeterPS/PSGPU)
Sparse tables live on hosts, the dense compute and the hot rows on the
card (BASELINE workload 5, Wide&Deep CTR).

Quick start (single process):
    client = LocalPsEndpoint()
    emb = DistributedEmbedding(client, table_id=0, dim=16)
Multi-process:
    server = PsServer(port=0).start()
    client = PsClient(server.endpoint)
"""
from .table import SparseTable, DenseTable  # noqa: F401
from .service import PsServer, PsClient, LocalPsEndpoint  # noqa: F401
from .embedding import DistributedEmbedding  # noqa: F401
from .sharded import (  # noqa: F401
    ShardedPsClient, Communicator, GeoCommunicator,
)
from .device_cache import DeviceEmbeddingCache  # noqa: F401

__all__ = ["SparseTable", "DenseTable", "PsServer", "PsClient",
           "LocalPsEndpoint", "DistributedEmbedding", "ShardedPsClient",
           "Communicator", "GeoCommunicator", "DeviceEmbeddingCache"]
