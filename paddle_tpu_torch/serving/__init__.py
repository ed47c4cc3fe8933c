"""Serving engine of the port: decode models behind a continuous batcher."""
from .decode import DecodeModelSpec, DecodeRequest  # noqa: F401
from .server import Server, ServingConfig  # noqa: F401
