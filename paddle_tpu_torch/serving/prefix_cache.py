"""Radix-trie prefix KV cache for the slot decode loop.

Counterpart of ``paddle_tpu/serving/prefix_cache.py``.  Requests sharing
a system prompt should pay its prefill once.  The row-invariant serving
path makes that sound: a cache column's K/V depends only on the token
prefix and the RELATIVE position ``column - start``, so a prefilled
prefix block is portable across slot rows and window shifts.  This
module indexes those blocks:

  * the trie is keyed by **blocks** of ``T`` tokens (``T`` = the slot
    loop's prefill chunk width): a node's path from the root spells a
    token prefix of ``depth * T`` tokens, and the node holds that
    block's device planes (every plane of the slot cache, one row x
    ``T`` columns, bf16 or int8 + scales);
  * ``lookup`` walks the longest cached chain and **pins** it
    (ref-counted), so an eviction never frees a block a joining row is
    about to restore;
  * ``publish`` inserts the blocks a completed prefill produced, deduped
    against what is cached (the fetch callback runs only for missing
    blocks, so republishing a hot prefix costs nothing);
  * eviction is LRU, leaves first, ``refs == 0`` only, until the cache
    fits ``FLAGS_prefix_cache_hbm_mb`` (0 = unbounded).

The JAX package's registry instruments (hit tokens, evictions by reason,
bytes) are plain counters in :meth:`PrefixCache.stats` here: the port
has no metrics registry yet.  The slot loop (serving/slots.py) does the
device work; this module is host-side bookkeeping only.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["PrefixCache"]


class _Node:
    __slots__ = ("key", "parent", "children", "block", "refs", "last_use")

    def __init__(self, key, parent):
        self.key = key
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.block = None
        self.refs = 0
        self.last_use = 0


class PrefixCache:
    """Block-granular radix trie over token prefixes → device KV blocks.

    ``block_tokens`` is the chunk width ``T``; ``block_nbytes`` the
    device footprint of ONE cached block (every plane of the slot-cache
    tree, one row × T columns: ``Generator.block_nbytes``);
    ``hbm_budget_mb`` caps the total (0 = unbounded)."""

    def __init__(self, block_tokens: int, block_nbytes: int,
                 hbm_budget_mb: float = 0.0):
        self.T = int(block_tokens)
        self.block_nbytes = int(block_nbytes)
        self.budget_bytes = int(float(hbm_budget_mb) * 1024 * 1024)
        self._root = _Node(None, None)   # guarded-by: _lock
        self._nodes = 0                  # guarded-by: _lock
        self._tick = 0                   # guarded-by: _lock
        self._lock = threading.Lock()
        self._hits = 0                   # guarded-by: _lock
        self._misses = 0                 # guarded-by: _lock
        self._hit_tokens = 0             # guarded-by: _lock
        self._evictions = 0              # guarded-by: _lock
        self._cleared = 0                # guarded-by: _lock

    # -- internals -----------------------------------------------------------
    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.last_use = self._tick

    def _nbytes_locked(self) -> int:
        return self._nodes * self.block_nbytes

    def nbytes(self) -> int:
        with self._lock:
            return self._nbytes_locked()

    def __len__(self) -> int:
        with self._lock:
            return self._nodes

    def _evict_until_fits(self) -> None:
        if self.budget_bytes <= 0:
            return
        while self._nbytes_locked() > self.budget_bytes:
            victim = None
            stack = [self._root]
            while stack:
                n = stack.pop()
                stack.extend(n.children.values())
                if n is self._root or n.children or n.refs > 0:
                    continue                # interior or pinned: keep
                if victim is None or n.last_use < victim.last_use:
                    victim = n
            if victim is None:
                return                      # everything pinned: stay over
            del victim.parent.children[victim.key]
            victim.block = None
            self._nodes -= 1
            self._evictions += 1

    # -- public API ----------------------------------------------------------
    def lookup(self, tokens: Sequence[int],
               max_blocks: Optional[int] = None):
        """Longest cached prefix of ``tokens``, pinned.

        Returns ``(blocks, pin)``: the device block trees covering the
        first ``len(blocks)·T`` tokens, and an opaque pin the caller
        MUST :meth:`release` once the blocks have been restored (the pin
        holds every chain node's refcount up, so eviction cannot race a
        restore in flight).  ``max_blocks`` clamps the walk — the slot
        loop passes ``(len(prompt) − 1) // T`` so at least one true
        suffix token always remains to produce the activation logits."""
        toks = [int(t) for t in tokens]
        limit = len(toks) // self.T if max_blocks is None \
            else min(max_blocks, len(toks) // self.T)
        with self._lock:
            chain: List[_Node] = []
            node = self._root
            for j in range(limit):
                key = tuple(toks[j * self.T:(j + 1) * self.T])
                child = node.children.get(key)
                if child is None:
                    break
                chain.append(child)
                node = child
            for n in chain:
                n.refs += 1
                self._touch(n)
            if chain:
                self._hits += 1
                self._hit_tokens += len(chain) * self.T
            else:
                self._misses += 1
            return [n.block for n in chain], tuple(chain)

    def release(self, pin) -> None:
        """Unpin a lookup chain (restore complete or abandoned)."""
        if not pin:
            return
        with self._lock:
            for n in pin:
                if n.refs > 0:
                    n.refs -= 1
            self._evict_until_fits()

    def publish(self, tokens: Sequence[int],
                fetch: Callable[[int], Any]) -> int:
        """Insert the full blocks of ``tokens``, deduped.  ``fetch(j)``
        is called ONLY for block indices not already cached and must
        return the device block tree for columns ``[j·T, (j+1)·T)`` of
        the (relative-position) prefix — the slot loop dispatches a
        ``pull_block`` there.  Returns the number of new blocks."""
        toks = [int(t) for t in tokens]
        new = 0
        with self._lock:
            node = self._root
            for j in range(len(toks) // self.T):
                key = tuple(toks[j * self.T:(j + 1) * self.T])
                child = node.children.get(key)
                if child is None:
                    child = _Node(key, node)
                    child.block = fetch(j)
                    node.children[key] = child
                    self._nodes += 1
                    new += 1
                self._touch(child)
                node = child
            self._evict_until_fits()
        return new

    def clear(self) -> None:
        with self._lock:
            n = self._nodes
            self._root = _Node(None, None)
            self._nodes = 0
            self._cleared += n

    def stats(self) -> dict:
        with self._lock:
            return {"blocks": self._nodes, "bytes": self._nbytes_locked(),
                    "hits": self._hits, "misses": self._misses,
                    "hit_tokens": self._hit_tokens,
                    "evictions": self._evictions,
                    "evictions_clear": self._cleared}
