from .metrics import LatencyWindow, RateMeter  # noqa: F401
