"""Error taxonomy of the port (PADDLE_ENFORCE's error codes).

Counterpart of ``paddle_tpu/framework/enforce.py``: the same class names
and codes, kept to the ones the serving and training paths raise, so
callers catch the same exception types on both packages.
"""
from __future__ import annotations


class EnforceNotMet(RuntimeError):
    """Base enforce failure (enforce.h EnforceNotMet)."""

    code = "LEGACY"

    def __init__(self, msg, op=None):
        self.op = op
        if op:
            msg = f"(op: {op}) {msg}"
        super().__init__(f"[{self.code}] {msg}")


class InvalidArgumentError(EnforceNotMet):
    code = "INVALID_ARGUMENT"


class NotFoundError(EnforceNotMet):
    code = "NOT_FOUND"


class OutOfRangeError(EnforceNotMet):
    code = "OUT_OF_RANGE"


class PreconditionNotMetError(EnforceNotMet):
    code = "PRECONDITION_NOT_MET"


class UnimplementedError(EnforceNotMet):
    code = "UNIMPLEMENTED"


class UnavailableError(EnforceNotMet):
    """Transient refusal (backpressure, closed queue, a draining server).
    A refusal that expects the caller to come back carries a
    ``retry_after_s`` hint; None means no estimate."""

    code = "UNAVAILABLE"

    def __init__(self, msg, op=None, retry_after_s=None):
        super().__init__(msg, op)
        self.retry_after_s = retry_after_s
