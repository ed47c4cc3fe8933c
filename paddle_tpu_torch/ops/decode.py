"""Beam-search decoding ops: one beam step, the parent gather, and the
path backtrace.

Counterpart of the beam functions of ``paddle_tpu/ops/decode.py``
(``beam_search_step`` in its ``_fn`` form with ``is_accumulated``,
``beam_parent_gather`` and ``gather_tree``), which keep a dense [batch,
beam] frontier and select with one top-k over beam*vocab a step.

``lax.top_k`` breaks ties toward the lower index; ``torch.topk`` promises
no order among equal values, so the selection here is a stable
descending sort, whose first ``beam`` entries are ``lax.top_k``'s, ties
included.  CRF, Viterbi and edit distance are not ported yet (ROADMAP
A3).
"""
from __future__ import annotations

import torch

__all__ = ["beam_search_step", "beam_parent_gather", "gather_tree"]


def _top_k(x, k):
    """The ``k`` largest entries of each row of ``x`` in descending order,
    equal values in index order (``lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_search_step(pre_ids, pre_scores, probs, beam_size=4, end_id=0,
                     is_accumulated=False):
    """One beam-search step (beam_search_op.cc).

    ``pre_ids`` int [B, K]: the tokens selected last step;
    ``pre_scores`` float [B, K]: accumulated log-probs; ``probs`` [B, K,
    V]: this step's distribution per beam (log-probs if
    ``is_accumulated``, else probabilities).  Returns (ids [B, K], scores
    [B, K], parents [B, K]).  A finished beam (``pre_id == end_id``)
    proposes only ``end_id`` at its unchanged score."""
    B, K, V = probs.shape
    logp = probs if is_accumulated \
        else torch.log(torch.clamp_min(probs, 1e-20))
    total = pre_scores[..., None] + logp                   # [B, K, V]
    finished = pre_ids == end_id
    only_end = torch.zeros(V, dtype=torch.bool, device=probs.device)
    only_end[end_id] = True
    neg_inf = torch.tensor(float("-inf"), dtype=total.dtype,
                           device=total.device)
    total = torch.where(finished[..., None],
                        torch.where(only_end, pre_scores[..., None],
                                    neg_inf), total)
    top_scores, top_idx = _top_k(total.reshape(B, K * V), beam_size)
    parents = torch.div(top_idx, V, rounding_mode="floor").to(pre_ids.dtype)
    tokens = (top_idx % V).to(pre_ids.dtype)
    return tokens, top_scores, parents


def beam_parent_gather(x, parents):
    """Reorder beam-parallel state rows by the selected parents: ``x
    [B*K, ...]``, ``parents [B, K]``; row ``(b, k)`` of the result is row
    ``(b, parents[b, k])`` of ``x`` (one gather; the KV-cache reorder of
    beam decode)."""
    B, K = parents.shape
    flat = (torch.arange(B, dtype=torch.long, device=parents.device)[:, None]
            * K + parents.long()).reshape(-1)
    return x.index_select(0, flat)


def gather_tree(ids, parents):
    """Backtrace full beam paths from per-step ids and parent indices,
    both int [T, B, K] (gather_tree_op.cc); returns [T, B, K]."""
    T, B, K = ids.shape
    cursor = torch.arange(K, device=ids.device).expand(B, K)
    out = torch.empty_like(ids)
    for t in range(T - 1, -1, -1):
        out[t] = ids[t].gather(1, cursor)
        cursor = parents[t].gather(1, cursor).long()
    return out
