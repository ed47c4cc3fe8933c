"""Serving engine of the port: dense models and decode models behind a
continuous batcher."""
from .decode import DecodeModelSpec, DecodeRequest  # noqa: F401
from .server import (ModelSpec, Server, ServingConfig,  # noqa: F401
                     export_for_serving)
