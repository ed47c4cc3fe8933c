"""Disaggregated serving of the port: the prefill -> decode KV handoff
(``handoff.py``).  The router, replicas and sharding of the JAX
package's ``serving/cluster/`` are not ported yet (ROADMAP A4)."""
from .handoff import (KVHandoff, deserialize_kv,  # noqa: F401
                      deserialize_session, serialize_kv, serialize_session)
