from .metrics import (Counter, Gauge, Histogram,  # noqa: F401
                      LatencyWindow, MetricsRegistry, RateMeter,
                      default_registry)
