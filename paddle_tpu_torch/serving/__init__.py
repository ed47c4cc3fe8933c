"""Serving engine of the port: dense models and decode models behind a
continuous batcher, with the slot loop's parked sessions and the
prefill -> decode KV handoff (``cluster``)."""
from . import cluster  # noqa: F401
from .bucketing import BucketLadder, pad_to_bucket  # noqa: F401
from .cluster.handoff import (KVHandoff, deserialize_kv,  # noqa: F401
                              deserialize_session, serialize_kv,
                              serialize_session)
from .decode import DecodeModelSpec, DecodeRequest  # noqa: F401
from .scheduler import Batch, Request, RequestQueue, pack_fifo  # noqa: F401
from .server import (ModelSpec, Server, ServingConfig,  # noqa: F401
                     export_for_serving)
from .sessions import SessionSnapshot, SessionStore  # noqa: F401

__all__ = [
    "BucketLadder", "pad_to_bucket", "Batch", "Request", "RequestQueue",
    "pack_fifo", "ModelSpec", "Server", "ServingConfig",
    "export_for_serving", "DecodeModelSpec", "DecodeRequest", "cluster",
    "KVHandoff", "serialize_kv", "deserialize_kv", "serialize_session",
    "deserialize_session", "SessionSnapshot", "SessionStore",
]
