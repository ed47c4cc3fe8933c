"""Common functionals.

Counterpart of ``paddle_tpu/nn/functional/common.py``, kept to linear,
embedding, one_hot, label_smooth and dropout, plus the row-invariant
linear of the serving path.
"""
from __future__ import annotations

import torch

from ...framework.enforce import UnimplementedError
from ...framework.primitive import Primitive
from ...framework.random import current_generator

# rows of every GEMM that batch_invariant_linear issues
ROW_CHUNK = 128


def _linear_fn(x, weight, bias=None):
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


_linear = Primitive("linear", _linear_fn)


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with Paddle's weight layout [in_features,
    out_features] (the ``Linear`` layer stores torch's [out, in] and
    calls ``torch.nn.functional.linear``).  The registered op
    ``linear``."""
    return _linear(x, weight) if bias is None else _linear(x, weight, bias)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` looked up by the ids ``x``; an id equal to
    ``padding_idx`` (a negative one counts from the end) looks up zeros
    and passes no gradient to its row, as JAX's ``_embedding_fn``
    masks it."""
    if sparse:
        raise UnimplementedError(
            "embedding(sparse=True) is not ported: its gradient would be a "
            "SelectedRows (ROADMAP A5)")
    out = torch.nn.functional.embedding(x, weight)
    if padding_idx is None:
        return out
    pi = int(padding_idx)
    if pi < 0:
        pi += weight.shape[0]
    return torch.where((x != pi)[..., None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def one_hot(x, num_classes, name=None):
    """f32 one-hot rows over a new last axis of ``num_classes``; an id
    outside [0, num_classes) gives a row of zeros (``jax.nn.one_hot``)."""
    classes = torch.arange(int(num_classes), device=x.device)
    return (x[..., None] == classes).to(torch.float32)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """``(1 - epsilon) label + epsilon prior``, the prior uniform over
    the last axis unless ``prior_dist`` is given."""
    eps = float(epsilon)
    if prior_dist is None:
        return (1 - eps) * label + eps / label.shape[-1]
    return (1 - eps) * label + eps * prior_dist


def _dropout_fn(x, p=0.5, training=True, generator=None):
    if not training or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    g = generator
    if g is None and not x.is_meta:      # InferShape draws nothing
        g = current_generator(x.device)
    keep = torch.rand(x.shape, generator=g, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


_dropout = Primitive("dropout", _dropout_fn, random=True)


def dropout(x, p=0.5, training=True, generator=None):
    """Upscale-in-train dropout: each element kept with probability
    ``1 - p`` and divided by it.  The mask is drawn from ``generator``,
    by default the active generator of ``x``'s device
    (``framework.random.current_generator``).  The registered op
    ``dropout``, marked random."""
    return _dropout(x, p=p, training=training, generator=generator)


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


def cached_linears(x, *layers):
    """``layer(x)`` for each of ``layers``, projections of the serving
    path, each output row a function of its own input row.

    A float ``Linear`` multiplies in fixed row chunks
    (:func:`batch_invariant_linear`), and the ``Linear``s among
    ``layers`` share one :func:`pad_rows` copy of ``x``.  Any other
    site, a frozen int8 linear (``quantization.freeze``) among them,
    runs its own forward on the real rows of ``x``, as the JAX package
    calls the layer: its integer sum is exact at any row count and its
    quantize and epilogue are elementwise, so it needs no chunks.  Only
    a static site (a calibrated input scale, as PTQ's) keeps a served
    row equal to its batch-1 ``generate()``; a dynamic one quantizes at
    the abs-max of all of ``x``'s rows, as JAX's does."""
    floats = [isinstance(m, torch.nn.Linear) for m in layers]
    if not any(floats):
        return tuple(m(x) for m in layers)
    xp, n = pad_rows(x)
    return tuple(
        rows_linear(xp, m.weight, m.bias)[:n].reshape(
            *x.shape[:-1], m.weight.shape[0]) if f else m(x)
        for m, f in zip(layers, floats))


def cached_linear(x, layer):
    """:func:`cached_linears` of one layer."""
    if isinstance(layer, torch.nn.Linear):
        return batch_invariant_linear(x, layer.weight, layer.bias)
    return layer(x)


def cached_ffn(x, linear1, mid, linear2):
    """``linear2(mid(linear1(x)))`` on the serving path, row by row as
    :func:`cached_linears`.  Two float ``Linear``s keep the rows padded
    from ``linear1``'s input to ``linear2``'s output: one padding copy
    for both GEMMs."""
    if not (isinstance(linear1, torch.nn.Linear)
            and isinstance(linear2, torch.nn.Linear)):
        return cached_linear(mid(cached_linear(x, linear1)), linear2)
    hp, n = pad_rows(x)
    h = rows_linear(hp, linear1.weight, linear1.bias)
    h = rows_linear(mid(h), linear2.weight, linear2.bias)
    return h[:n].reshape(*x.shape[:-1], linear2.weight.shape[0])
