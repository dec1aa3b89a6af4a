"""Token-id-keyed prefix index over committed full blocks (a copy of the
JAX package's ``repro.cache.prefix_cache``).

The simpler-than-radix design (sglang's ChunkCache lineage): the index
maps the EXACT token prefix covered by each committed full block —
``tuple(tokens[: (i + 1) * block_size])`` — to the physical block that
holds its KV.  Keying on the full token tuple (not a rolling hash) means a
hit is a *proof* that the cached KV was produced from identical token ids
at identical positions, which is what makes the house bit-identity
invariant (cache on == cache off, greedy) hold by construction.

Lifecycle:

* ``match(tokens)`` at admission walks full-block prefixes longest-first
  until the first miss and returns the hit chain (LRU-touching each
  entry).  A full-prompt hit is trimmed by one token so the request still
  prefill-processes >= 1 token (the engine needs a real chunk to emit the
  first logits; the trimmed tail block is then forked copy-on-write).
* ``commit(tokens, table)`` after the KV for a prefix has provably been
  written indexes each full block, pinning it with a refcount so the
  owner finishing does not recycle it.
* ``evict(n)`` under pool pressure drops least-recently-used entries
  whose ONLY reference is the cache itself — blocks shared into any live
  request table are never reclaimed.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, Sequence, Tuple

from repro_torch.cache.block_manager import BlockManager

Key = Tuple[int, ...]


class PrefixCache:
    """LRU prefix index over a :class:`BlockManager`'s committed blocks.

    Constructing one attaches it to the manager (``bm.prefix_cache``) so
    allocation-pressure paths can reclaim cache-only blocks on demand.
    """

    def __init__(self, block_manager: BlockManager):
        self.bm = block_manager
        self.bm.prefix_cache = self
        self._index: "OrderedDict[Key, int]" = OrderedDict()
        # stats (surfaced through serving metrics / benchmarks)
        self.n_lookups = 0
        self.n_hits = 0
        self.n_hit_tokens = 0
        self.n_committed_blocks = 0
        self.n_evicted_blocks = 0

    # ------------------------------------------------------------- queries
    def __len__(self) -> int:
        return len(self._index)

    @property
    def n_evictable(self) -> int:
        """Indexed blocks held by nobody else (refcount 1 == cache pin)."""
        return sum(1 for b in self._index.values()
                   if self.bm.refcount(b) == 1)

    # -------------------------------------------------------------- lookup
    def match(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached block-aligned prefix of ``tokens``.

        Returns ``(blocks, n_tokens)``: the physical hit chain (to map via
        :meth:`BlockManager.share`) and the number of prefix tokens it
        covers.  ``n_tokens`` is capped at ``len(tokens) - 1`` so at least
        one token always remains for the prefill to process — in that
        trimmed case the last shared block will be forked copy-on-write
        when the tail token's KV is written.
        """
        self.n_lookups += 1
        bs = self.bm.block_size
        toks = tuple(tokens)
        blocks: List[int] = []
        for i in range(len(toks) // bs):
            b = self._index.get(toks[: (i + 1) * bs])
            if b is None:
                break
            self._index.move_to_end(toks[: (i + 1) * bs])
            blocks.append(b)
        n = len(blocks) * bs
        if blocks and n >= len(toks):
            n = len(toks) - 1
        if blocks:
            self.n_hits += 1
            self.n_hit_tokens += n
        return blocks, n

    # -------------------------------------------------------------- commit
    def commit(self, tokens: Sequence[int], table: Sequence[int]) -> int:
        """Index every full block of ``tokens`` whose KV now lives in the
        corresponding ``table`` entry; returns how many NEW blocks were
        pinned.  Already-indexed prefixes are LRU-touched only — the first
        writer wins, so an index entry never silently switches physical
        blocks while readers may hold the old one."""
        bs = self.bm.block_size
        toks = tuple(tokens)
        added = 0
        for i in range(min(len(toks) // bs, len(table))):
            key = toks[: (i + 1) * bs]
            if key in self._index:
                self._index.move_to_end(key)
                continue
            self.bm.incref(table[i])
            self._index[key] = table[i]
            added += 1
        self.n_committed_blocks += added
        return added

    # ------------------------------------------------------------- evict
    def evict(self, n: int) -> int:
        """Release up to ``n`` cache-only blocks, least recently used
        first; returns how many were actually freed.  Entries whose block
        is still shared into a live table are skipped (their KV is in
        use); evicting a mid-chain block orphans its descendants in the
        index — they become unmatchable (match stops at the hole) and age
        out through this same LRU scan."""
        freed = 0
        for key in [k for k, b in self._index.items()
                    if self.bm.refcount(b) == 1]:
            if freed >= n:
                break
            self.bm._decref(self._index.pop(key))
            freed += 1
        self.n_evicted_blocks += freed
        return freed

    def stats(self) -> dict:
        return {
            "n_lookups": self.n_lookups,
            "n_hits": self.n_hits,
            "n_hit_tokens": self.n_hit_tokens,
            "n_indexed_blocks": len(self._index),
            "n_committed_blocks": self.n_committed_blocks,
            "n_evicted_blocks": self.n_evicted_blocks,
        }
