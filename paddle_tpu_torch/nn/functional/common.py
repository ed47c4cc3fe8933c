"""Common functionals.

Counterpart of ``paddle_tpu/nn/functional/common.py``, kept to dropout,
plus the row-invariant linear of the serving path.
"""
from __future__ import annotations

import torch

from ...framework.random import current_generator

# rows of every GEMM that batch_invariant_linear issues
ROW_CHUNK = 128


def dropout(x, p=0.5, training=True, generator=None):
    """Upscale-in-train dropout: each element kept with probability
    ``1 - p`` and divided by it.  The mask is drawn from ``generator``,
    by default the active generator of ``x``'s device
    (``framework.random.current_generator``)."""
    if not training or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    g = generator if generator is not None else current_generator(x.device)
    keep = torch.rand(x.shape, generator=g, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def pad_rows(x, rows=ROW_CHUNK):
    """``x`` flattened to [n, K] rows and extended to a multiple of
    ``rows`` rows.  Returns (padded, n).  The extra rows are left
    unwritten: a GEMM never mixes rows, and their outputs are sliced
    away, so one copy launch is all the padding costs."""
    x2 = x.reshape(-1, x.shape[-1])
    n = x2.shape[0]
    pad = (-n) % rows
    if not pad:
        return x2, n
    out = x2.new_empty((n + pad, x2.shape[1]))
    out[:n].copy_(x2)
    return out, n


def rows_linear(xp, weight, bias=None, rows=ROW_CHUNK):
    """``F.linear`` over the rows of ``xp`` (from :func:`pad_rows`),
    ``rows`` at a time, so every GEMM has one shape."""
    if xp.shape[0] == rows:                  # a decode step: one chunk
        return torch.nn.functional.linear(xp, weight, bias)
    return torch.cat([torch.nn.functional.linear(c, weight, bias)
                      for c in xp.split(rows)])


def batch_invariant_linear(x, weight, bias=None, rows=ROW_CHUNK):
    """``F.linear`` whose output row depends on its own input row only,
    bit for bit, whatever rows ride with it.

    A GEMM library picks its kernel, and with it the reduction order, by
    the problem's shape, so one row's result can move by a rounding step
    with the number of rows it is multiplied with.  Here the rows are
    flattened and multiplied ``rows`` at a time, the last chunk padded
    (:func:`pad_rows`, :func:`rows_linear`): every call has one shape and
    gets one kernel, and no reduction mixes two rows.  The serving path
    (``forward_cached``) multiplies this way so that a served row equals
    its batch-1 ``generate()``; training keeps plain ``F.linear``."""
    xp, n = pad_rows(x, rows)
    return rows_linear(xp, weight, bias, rows)[:n].reshape(
        *x.shape[:-1], weight.shape[0])
