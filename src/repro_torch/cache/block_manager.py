"""Free-list block allocator with per-request block tables.

Pure-python bookkeeping (no jax): the manager decides *which* physical
blocks back *which* logical positions; the engine turns the resulting
tables into the int32 arrays the packed step consumes.  One manager is
shared by the engine and the (block-aware) scheduler so admission checks,
decode reservations and the engine's lazy per-chunk allocation all see the
same free list.

Prefix sharing (copy-on-write)
------------------------------
Every allocated physical block carries a **reference count**: normally 1
(one table entry), but a block may be mapped into several requests' tables
at once (:meth:`share` — prefix-cache hits) and/or pinned by the
:class:`~repro_torch.cache.prefix_cache.PrefixCache` index.  The
discipline is vLLM's:

* a FULL block is immutable — sharing it is a pure refcount increment;
* a request about to WRITE into a block it does not exclusively own must
  fork it first (:meth:`prepare_write` — copy-on-write): a fresh block is
  allocated, the table entry is swapped, and the (src, dst) pair is
  returned so the engine can copy the block's KV contents before the
  packed step runs;
* :meth:`free` DECREMENTS instead of releasing: a block only returns to
  the free list when its last reference drops.

Blocks whose only remaining reference is the prefix-cache index are
**reclaimable**: capacity queries count them as available, and an
allocation that would otherwise exhaust the pool evicts them LRU-first
through the attached cache (:attr:`prefix_cache`).

Host swap tier
--------------
With ``host_blocks > 0`` the manager also owns a pool of **host slots** —
block-sized rows in a host-RAM arena the engine mirrors (vLLM's
``blocks_to_swap_in/out``).  :meth:`swap_out` moves a victim request's
mapping wholesale to the host ledger (``_swapped``): its device blocks
return to the free list, each paired with a host slot the engine streams
the block's contents into; :meth:`swap_in` is the inverse — fresh device
blocks (reclaiming prefix-cache blocks if needed) rebuild the table before
the victim's next chunk.  Only fully *exclusive* tables are swappable:
a block that is shared with another request or pinned by the prefix cache
has a life beyond the victim, so such victims fall back to
preempt-for-recompute.  Device conservation is untouched (swap-out is
decref-to-free), and the host pool keeps its own mirror invariant
``n_host_free + n_swapped == n_host_slots``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class PoolExhausted(RuntimeError):
    """Raised when an allocation cannot be satisfied from the free list."""


class BlockManager:
    """Fixed-size-block KV pool: free-list allocation, watermark-gated
    admission, per-request block tables, refcounted sharing with
    copy-on-write forks, free-on-finish.

    Block 0 is reserved as the scratch block (see ``repro_torch.cache``); the
    usable pool is blocks ``1 .. n_blocks - 1``.
    """

    def __init__(self, n_blocks: int, block_size: int, *,
                 watermark: float = 0.0, host_blocks: int = 0):
        if n_blocks < 2:
            raise ValueError("need >= 2 blocks (one is reserved scratch)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        if not 0.0 <= watermark < 1.0:
            raise ValueError("watermark must be in [0, 1)")
        if host_blocks < 0:
            raise ValueError("host_blocks must be >= 0")
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self.scratch_block = 0
        self.n_usable = self.n_blocks - 1
        self.watermark_blocks = math.ceil(watermark * self.n_usable)
        self._free: List[int] = list(range(self.n_blocks - 1, 0, -1))
        self._tables: Dict[int, List[int]] = {}
        self._refs: Dict[int, int] = {}      # physical block -> live refs
        # optional PrefixCache (attached by its constructor): the LRU
        # index whose cache-only blocks are reclaimable under pressure
        self.prefix_cache = None
        # host swap tier: free host slots + per-request swapped ledger
        # (host slots, in table order).  Slots are indices into the
        # engine's host arena, disjoint from device block ids.
        self.n_host_slots = int(host_blocks)
        self._host_free: List[int] = list(range(self.n_host_slots - 1,
                                                -1, -1))
        self._swapped: Dict[int, List[int]] = {}
        # admission reservations: req_id -> blocks earmarked but not yet
        # allocated.  Reservations never touch the free list — they are a
        # promise consumed as the owner's chunks actually allocate
        # (``ensure`` / copy-on-write forks), and capacity queries charge
        # OTHER requests for them so two admissions can never double-book
        # the same free blocks (see :meth:`reserve`).
        self._reserved: Dict[int, int] = {}

    # ------------------------------------------------------------- queries
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_usable - self.n_free

    @property
    def n_referenced(self) -> int:
        """Blocks currently holding at least one reference (table entries
        + prefix-cache pins).  ``n_free + n_referenced == n_usable`` is the
        pool's conservation invariant (pinned by tests)."""
        return len(self._refs)

    @property
    def n_reclaimable(self) -> int:
        """Blocks whose only reference is the prefix-cache index — they
        can be evicted on demand, so capacity checks count them free."""
        return (self.prefix_cache.n_evictable
                if self.prefix_cache is not None else 0)

    @property
    def utilization(self) -> float:
        return self.n_used / self.n_usable if self.n_usable else 0.0

    @property
    def n_host_free(self) -> int:
        return len(self._host_free)

    @property
    def n_swapped(self) -> int:
        """Host slots currently holding swapped-out blocks.  The host
        ledger's conservation invariant (mirroring the device pool's) is
        ``n_host_free + n_swapped == n_host_slots``."""
        return sum(len(s) for s in self._swapped.values())

    @property
    def n_reserved(self) -> int:
        """Free blocks earmarked by admission reservations (not yet
        allocated; the free list still contains them)."""
        return sum(self._reserved.values())

    def reserved_for(self, req_id: int) -> int:
        return self._reserved.get(req_id, 0)

    def _reserved_other(self, req_id: int) -> int:
        """Blocks reserved by every request EXCEPT ``req_id`` — the part
        of the free list this request may not touch."""
        return sum(n for r, n in self._reserved.items() if r != req_id)

    def refcount(self, block: int) -> int:
        return self._refs.get(block, 0)

    def blocks_for_tokens(self, n_tokens: int) -> int:
        return max(0, -(-int(n_tokens) // self.block_size))

    def table(self, req_id: int) -> List[int]:
        return list(self._tables.get(req_id, ()))

    def allocated_tokens(self, req_id: int) -> int:
        """Token capacity of the blocks currently held by ``req_id``."""
        return len(self._tables.get(req_id, ())) * self.block_size

    def padded_table(self, req_id: Optional[int], n_entries: int
                     ) -> np.ndarray:
        """The request's block table as int32 [n_entries], padded with the
        scratch block (``req_id=None`` -> an all-scratch table)."""
        out = np.full((n_entries,), self.scratch_block, np.int32)
        if req_id is not None:
            t = self._tables.get(req_id, ())
            out[:len(t)] = t
        return out

    # ----------------------------------------------------------- capacity
    def can_allocate(self, n_tokens: int, *, watermark: bool = True) -> bool:
        """Would a fresh ``n_tokens`` allocation fit?  With ``watermark``
        (admission semantics) the post-allocation free count must stay
        above the watermark; without (append semantics) any fit counts."""
        return self.can_allocate_blocks(self.blocks_for_tokens(n_tokens),
                                        watermark=watermark)

    def can_allocate_blocks(self, n: int, *, watermark: bool = True,
                            hit_blocks: Sequence[int] = ()) -> bool:
        """Block-granular :meth:`can_allocate` — what a prefix-aware
        admission gate charges after subtracting its hit blocks.  Blocks
        already promised to admitted-but-still-prefilling requests
        (:meth:`reserve`) are NOT available: without this, two oversized
        admissions passing the same instantaneous free-list check can
        wedge a small pool once their lazy chunk allocations collide.

        ``hit_blocks`` is the prefix hit that the same admission is about
        to :meth:`share`.  Those of its blocks that only the cache holds
        are reclaimable now, but the share pins them, so they do not count
        here.  (The JAX package's gate counts them, and then ``ensure``
        can find no block: ROADMAP Queue 3.)"""
        floor = self.watermark_blocks if watermark else 0
        pinned = sum(1 for b in hit_blocks if self.refcount(b) == 1)
        return self.n_free + self.n_reclaimable - pinned - self.n_reserved \
            - int(n) >= floor

    def can_append(self, req_id: int, n_tokens: int) -> bool:
        """Can ``req_id``'s table grow to cover ``n_tokens`` positions?
        Appends for already-running requests ignore the watermark but must
        not eat into blocks reserved for OTHER admitted requests."""
        need = self.blocks_for_tokens(n_tokens) \
            - len(self._tables.get(req_id, ()))
        return need <= self.n_free + self.n_reclaimable \
            - self._reserved_other(req_id)

    def appendable_tokens(self, req_id: int) -> int:
        """Positions ``req_id`` could cover right now: already-allocated
        capacity plus everything left in the free list (no watermark),
        counting evictable prefix-cache blocks as free and excluding
        blocks reserved for other requests (the request's OWN reservation
        is part of the free count and stays claimable)."""
        return self.allocated_tokens(req_id) \
            + max(self.n_free + self.n_reclaimable
                  - self._reserved_other(req_id), 0) * self.block_size

    # ------------------------------------------------------- reservations
    def reserve(self, req_id: int, n: int):
        """Earmark ``n`` future blocks for ``req_id`` (taken by the
        scheduler at ADMISSION, after :meth:`can_allocate_blocks` said the
        whole prompt fits).  The free list is untouched; the promise is
        consumed block-by-block as the owner's chunks actually allocate
        (:meth:`ensure`, copy-on-write forks) and any remainder dies with
        the request (:meth:`free` / :meth:`swap_out`).  Capacity queries
        charge everyone ELSE for outstanding reservations, closing the
        admit-then-starve race where a second prompt is admitted against
        free blocks the first admission already needs."""
        if int(n) > 0:
            self._reserved[req_id] = self._reserved.get(req_id, 0) + int(n)

    def _consume_reservation(self, req_id: int, n: int):
        """An allocation for ``req_id`` just landed: retire up to ``n``
        blocks of its outstanding promise."""
        held = self._reserved.get(req_id, 0)
        if not held or n <= 0:
            return
        if held > n:
            self._reserved[req_id] = held - n
        else:
            del self._reserved[req_id]

    def release_reservation(self, req_id: int) -> int:
        """Drop ``req_id``'s remaining promise (idempotent); returns the
        number of blocks un-earmarked."""
        return self._reserved.pop(req_id, 0)

    # --------------------------------------------------------- allocation
    def _alloc_one(self) -> int:
        b = self._free.pop()
        self._refs[b] = 1
        return b

    def incref(self, block: int):
        """Add a reference to an allocated block (a prefix-cache pin or a
        shared table entry)."""
        if block not in self._refs:
            raise ValueError(f"block {block} is not allocated")
        self._refs[block] += 1

    def _decref(self, block: int) -> bool:
        """Drop one reference; returns True when the block actually went
        back to the free list (last reference)."""
        n = self._refs[block] - 1
        if n:
            self._refs[block] = n
            return False
        del self._refs[block]
        self._free.append(block)
        return True

    def _reclaim(self, need: int):
        """Evict prefix-cached blocks until ``need`` blocks are free (or
        nothing evictable remains)."""
        if self.prefix_cache is not None and need > self.n_free:
            self.prefix_cache.evict(need - self.n_free)

    def ensure(self, req_id: int, n_tokens: int) -> List[int]:
        """Grow ``req_id``'s block table to cover ``n_tokens`` logical
        positions; returns the (possibly unchanged) table.  Idempotent —
        the scheduler's reservation and the engine's lazy per-chunk call
        may both run for the same iteration.  A failed grow for a NEW
        request leaves no table entry behind (a stale empty table would
        corrupt refcounts once blocks are shared)."""
        held = self._tables.get(req_id)
        need = self.blocks_for_tokens(n_tokens) - (len(held) if held else 0)
        if need > self.n_free:
            self._reclaim(need)
        if need > self.n_free:
            raise PoolExhausted(
                f"req {req_id}: need {need} blocks, {self.n_free} free "
                f"(n_blocks={self.n_blocks}, block_size={self.block_size})")
        table = self._tables.setdefault(req_id, [])
        for _ in range(max(need, 0)):
            table.append(self._alloc_one())
        self._consume_reservation(req_id, need)
        return table

    def share(self, req_id: int, blocks: Sequence[int]) -> List[int]:
        """Map already-allocated ``blocks`` (a prefix-cache hit, in
        prefix order) into ``req_id``'s table, taking a reference on each.
        The request's table must be empty — hits are resolved at
        admission, before any exclusive allocation."""
        table = self._tables.setdefault(req_id, [])
        if table:
            raise ValueError(f"req {req_id} already holds {len(table)} "
                             f"blocks; prefix sharing must come first")
        for b in blocks:
            self.incref(b)
            table.append(b)
        return table

    def prepare_write(self, req_id: int, start: int, end: int
                      ) -> List[Tuple[int, int]]:
        """Copy-on-write fork for a write into positions ``[start, end)``:
        every covered block the request does not exclusively own is
        replaced by a fresh allocation, and the ``(src, dst)`` pairs are
        returned so the engine can copy block contents BEFORE the write
        lands.  Exclusive blocks (refcount 1) pass through untouched, so
        this is free on the non-shared fast path."""
        if end <= start:
            return []
        table = self._tables.get(req_id)
        if table is None:
            raise ValueError(f"req {req_id} holds no blocks")
        pairs: List[Tuple[int, int]] = []
        for i in range(start // self.block_size,
                       (end - 1) // self.block_size + 1):
            b = table[i]
            if self._refs[b] == 1:
                continue
            if not self._free:
                self._reclaim(1)
            if not self._free:
                raise PoolExhausted(
                    f"req {req_id}: copy-on-write fork needs a free block "
                    f"(n_blocks={self.n_blocks})")
            nb = self._alloc_one()
            self._decref(b)           # shared: never returns to free list
            table[i] = nb
            pairs.append((b, nb))
            # admission charged one block for the fork of a trimmed
            # full-prompt prefix hit — retire that promise here
            self._consume_reservation(req_id, 1)
        return pairs

    def free(self, req_id: int) -> int:
        """Drop ``req_id``'s references (idempotent: the scheduler frees
        on finish/preempt and the engine frees on slot release — whichever
        runs second is a no-op).  Shared blocks merely decrement; returns
        the number of blocks that actually went back to the free list.
        The host swap ledger is untouched: after a swap-out the engine's
        slot release still calls :meth:`free` (the table is already gone,
        so it is a no-op) and the swapped bytes must survive until
        :meth:`swap_in` or :meth:`drop_swap`."""
        self._reserved.pop(req_id, None)
        table = self._tables.pop(req_id, None)
        if not table:
            return 0
        return sum(self._decref(b) for b in reversed(table))

    # --------------------------------------------------------- host swap
    def is_swapped(self, req_id: int) -> bool:
        return req_id in self._swapped

    def swapped_blocks(self, req_id: int) -> int:
        return len(self._swapped.get(req_id, ()))

    def can_swap_out(self, req_id: int) -> bool:
        """Is ``req_id`` a swap candidate?  Requires a non-empty table of
        EXCLUSIVELY owned blocks (a block shared with another table or
        pinned by the prefix cache outlives the victim — swapping it out
        would tear KV other readers still address, so those victims fall
        back to recompute) and enough free host slots for the whole
        mapping."""
        table = self._tables.get(req_id)
        if not table or req_id in self._swapped:
            return False
        if len(table) > len(self._host_free):
            return False
        return all(self._refs[b] == 1 for b in table)

    def swap_out(self, req_id: int) -> List[Tuple[int, int]]:
        """Move ``req_id``'s whole mapping to the host tier: its device
        blocks return to the free list and a host slot is reserved per
        block.  Returns ``(device_block, host_slot)`` pairs in table order
        — the engine must stream those device blocks' contents into the
        arena BEFORE any of them is reallocated (the serving loops call
        the engine hook synchronously, so ordering holds)."""
        if not self.can_swap_out(req_id):
            raise ValueError(
                f"req {req_id} is not swappable (empty/shared/pinned "
                f"table, already swapped, or {self.n_host_free} host "
                f"slots free for {len(self._tables.get(req_id, ()))} "
                f"blocks)")
        self._reserved.pop(req_id, None)   # a mid-prefill victim's resume
        # re-allocates with append semantics; the promise does not persist
        table = self._tables.pop(req_id)
        slots: List[int] = []
        pairs: List[Tuple[int, int]] = []
        for b in table:
            s = self._host_free.pop()
            self._decref(b)          # exclusive: goes back to free list
            slots.append(s)
            pairs.append((b, s))
        self._swapped[req_id] = slots
        return pairs

    def can_swap_in(self, req_id: int, watermark: bool = False) -> bool:
        """Could ``req_id``'s swapped mapping be rebuilt on device right
        now, counting evictable prefix-cache blocks as free?

        ``watermark=True`` additionally demands the admission headroom on
        top of the rebuilt table — the anti-thrash discipline: resuming a
        victim into a pool with zero slack would immediately re-trigger
        the preemption that evicted it.  Callers drop the watermark when
        the victim is the only work left (it must resume eventually)."""
        slots = self._swapped.get(req_id)
        if slots is None:
            return False
        floor = self.watermark_blocks if watermark else 0
        return len(slots) + floor <= self.n_free + self.n_reclaimable \
            - self._reserved_other(req_id)

    def swap_in(self, req_id: int) -> List[Tuple[int, int]]:
        """Rebuild ``req_id``'s table from fresh device blocks (reclaiming
        prefix-cache blocks if needed) and release its host slots.
        Returns ``(host_slot, device_block)`` pairs in table order so the
        engine can scatter the arena rows back before the victim's next
        chunk runs."""
        slots = self._swapped.get(req_id)
        if slots is None:
            raise ValueError(f"req {req_id} is not swapped out")
        if self._tables.get(req_id):
            raise ValueError(f"req {req_id} holds device blocks while "
                             f"swapped — ledger corrupted")
        need = len(slots)
        if need > self.n_free:
            self._reclaim(need)
        if need > self.n_free:
            raise PoolExhausted(
                f"req {req_id}: swap-in needs {need} blocks, "
                f"{self.n_free} free (n_blocks={self.n_blocks})")
        del self._swapped[req_id]
        table = self._tables.setdefault(req_id, [])
        pairs: List[Tuple[int, int]] = []
        for s in slots:
            b = self._alloc_one()
            table.append(b)
            pairs.append((s, b))
            self._host_free.append(s)
        return pairs

    def drop_swap(self, req_id: int) -> int:
        """Abandon ``req_id``'s swapped bytes (request finished/cancelled
        while on host, or the scheduler demoted it to recompute): returns
        its host slots to the free pool without any device allocation.
        Idempotent; returns the number of slots released."""
        slots = self._swapped.pop(req_id, None)
        if not slots:
            return 0
        self._host_free.extend(slots)
        return len(slots)
