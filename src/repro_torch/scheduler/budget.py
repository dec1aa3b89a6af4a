"""Token-budget batch composition (Sarathi-Serve, arXiv 2403.02310).

A copy of the JAX package's ``repro.scheduler.budget``.  The offline
:class:`~repro_torch.scheduler.policies.SarathiScheduler` maximises
throughput: one chunk + as many piggybacked decodes as fit.  Online serving
instead needs a *latency* contract: every iteration must finish within a
bounded time so running decodes never stall behind a long prefill.  The
Sarathi-Serve insight is that the chunked-prefill machinery already gives
the control knob — compose each iteration under a fixed TOKEN BUDGET:

1. decodes first — every running decode-phase request gets its token
   (decodes are never evicted or displaced by prefill work);
2. the remaining budget is filled with prefill chunks, FCFS over the
   prefilling requests, each chunk sized ``min(chunk_size, budget_left,
   prefill_remaining)`` — so a single iteration may carry SEVERAL chunks
   from different requests (multi-chunk :class:`IterationPlan`);
3. admission is FCFS, gated on arrival time (a request that has not
   arrived yet by the loop's clock stays queued), with slot-pressure
   backoff: while the decode slots are saturated, new requests are not
   admitted (their prefills would inflate tail TBT without any decode
   capacity to serve them).

Because the budget bounds per-iteration work and decodes ride along every
iteration, inter-token latency is flat ("stall-free") regardless of how
long the co-running prompts are.

With a shared :class:`repro_torch.cache.BlockManager` the policy is
additionally **block-aware** (the vLLM/Sarathi-Serve memory discipline):

* admission is gated on ``can_allocate`` — the whole prompt must fit in
  the pool with the watermark to spare — and the admitted prompt's novel
  blocks are **reserved** (:meth:`BlockManager.reserve`) so a later
  admission cannot double-book the same free blocks while this prompt's
  chunks are still allocating lazily (the reservation drains as
  ``ensure`` lands blocks and dies with the request);
* every scheduled decode *reserves* its next block before the plan is
  emitted, so the engine's KV append can never fail mid-iteration;
* when the pool runs dry, the lowest-priority (latest-admitted) running
  request is preempted for recompute: blocks freed, request re-queued at
  the head of the waiting line (``Request.preempt``);
* prefill chunks shrink to the tokens the free list can actually back.

With a :class:`repro_torch.cache.PrefixCache` attached the policy
additionally reuses KV across requests (**prefix sharing**): admission
looks the prompt up in the cache, maps the hit blocks into the request's
table (refcounted), and starts ``prefilled`` at the hit boundary — so only the
NOVEL tokens are ever charged against the token budget or the free list,
and the first chunk the engine sees begins where the hit ends.  Written
prefixes are committed back to the cache at three points where the KV is
provably on device: at the top of ``next_plan`` (the previous plan has
fully executed by then, in both the sequential and pipelined serve loops
— in-flight requests are stripped from ``running`` there), on finish
(before the blocks are freed), and on preemption (the victim's blocks may
outlive it in the cache, so a readmission re-hits instead of recomputing).

The admission gate of the port counts a prefix hit's blocks that only
the cache holds as NOT reclaimable (:meth:`BlockManager.can_allocate_blocks`
with ``hit_blocks``): the same admission pins them with ``share``.  The JAX
package's gate counts them free and can then admit a prompt whose
``ensure`` finds no block (ROADMAP Queue 3).

Preemption policy (``preempt_mode``)
------------------------------------
What happens to a pool-pressure victim is selectable:

* ``recompute`` (default) — discard KV, re-prefill prompt + outputs on
  readmission (the PR 2 behaviour; the only option when the pool has no
  host tier);
* ``swap`` — move the victim's blocks to the BlockManager's host tier
  (``swap_out_hook`` streams the bytes into the engine's host arena) and
  stream them back at resume, before the victim's next chunk
  (``swap_in_hook``).  Victims whose tables hold shared or prefix-pinned
  blocks are not swappable and silently fall back to recompute;
* ``hybrid`` — per victim, compare the PCIe round trip
  (``2 * kv_swap_time`` over the whole block payload) against the
  re-prefill cost (``chunked_prefill_total`` of the victim's context)
  using the analytical cost model
  (:mod:`repro_torch.sim.cost_model`), and pick the cheaper restore path.

All three produce bit-identical greedy outputs: swap restores the exact
KV bytes recompute would regenerate — the policies differ only in clock
time and pool traffic.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.engine import DecodeWork, IterationPlan
from repro_torch.scheduler.policies import POLICIES, Scheduler
from repro_torch.scheduler.request import Request, State


class SarathiServeScheduler(Scheduler):
    """Stall-free token-budget scheduling for online continuous serving.

    Parameters
    ----------
    token_budget:
        Per-iteration cap on prefill + decode tokens.  Defaults to
        ``chunk_size + max_decodes`` — the exact footprint of the offline
        SARATHI hybrid batch, so with ``max_chunks_per_iter=1`` and
        ``admit_backoff=False`` this policy replays ``SarathiScheduler``
        plan-for-plan (the deterministic-replay test relies on this).
    max_chunks_per_iter:
        Optional cap on prefill chunks per iteration (None = fill the
        budget with as many chunks as fit).
    admit_backoff:
        Slot-pressure backoff: hold admissions while ``max_decodes``
        requests are already in decode phase.
    prefix_cache:
        Optional :class:`repro_torch.cache.PrefixCache` bound to
        ``block_manager``; enables cross-request KV reuse (see module
        docstring).  Greedy outputs are bit-identical with and without it.
    preempt_mode:
        ``recompute`` | ``swap`` | ``hybrid`` — what happens to a
        pool-pressure victim (see module docstring).  Non-default modes
        require a ``block_manager`` with host slots; ``hybrid``
        additionally needs ``swap_cfg`` + ``swap_hw`` for the cost-model
        comparison.
    """

    supports_time = True            # next_plan() accepts now= for gating
    supports_preempt = True         # next_plan() accepts preempt_hook=
    supports_swap = True            # next_plan() accepts swap_*_hook=

    PREEMPT_MODES = ("recompute", "swap", "hybrid")

    def __init__(self, *, n_slots: int, max_decodes: int, chunk_size: int,
                 token_budget: Optional[int] = None,
                 max_chunks_per_iter: Optional[int] = None,
                 admit_backoff: bool = True, block_manager=None,
                 prefix_cache=None, preempt_mode: str = "recompute",
                 swap_cfg=None, swap_hw=None):
        super().__init__(n_slots=n_slots, max_decodes=max_decodes,
                         chunk_size=chunk_size, block_manager=block_manager)
        self.token_budget = int(token_budget if token_budget is not None
                                else chunk_size + max_decodes)
        if self.token_budget < 1:
            raise ValueError("token_budget must be >= 1")
        self.max_chunks_per_iter = max_chunks_per_iter
        self.admit_backoff = admit_backoff
        if prefix_cache is not None:
            if block_manager is None:
                raise ValueError("prefix_cache requires a block_manager")
            if prefix_cache.bm is not block_manager:
                raise ValueError("prefix_cache is bound to a different "
                                 "block pool")
        self.prefix_cache = prefix_cache
        self.n_prefix_hits = 0          # admissions that reused >=1 block
        self.n_cached_tokens = 0        # prefill tokens served from cache
        if preempt_mode not in self.PREEMPT_MODES:
            raise ValueError(f"preempt_mode must be one of "
                             f"{self.PREEMPT_MODES}, got {preempt_mode!r}")
        if preempt_mode != "recompute":
            if block_manager is None:
                raise ValueError(f"preempt_mode={preempt_mode!r} requires "
                                 f"a block_manager")
            if block_manager.n_host_slots == 0:
                raise ValueError(f"preempt_mode={preempt_mode!r} requires "
                                 f"a block_manager with host_blocks > 0")
        if preempt_mode == "hybrid" and (swap_cfg is None
                                         or swap_hw is None):
            raise ValueError("preempt_mode='hybrid' needs swap_cfg and "
                             "swap_hw for the cost-model comparison")
        self.preempt_mode = preempt_mode
        self.swap_cfg = swap_cfg
        self.swap_hw = swap_hw
        self.n_swap_outs = 0            # victims evicted by swap
        self.n_swap_ins = 0             # swapped victims resumed

    # ------------------------------------------------------------- intake
    def _admit(self, admit_hook=None, now: Optional[float] = None,
               swap_in_hook=None):
        if self.admit_backoff:
            n_dec = sum(1 for r in self.running if r.state == State.DECODING)
            if n_dec >= self.max_decodes:
                return
        bm = self.block_manager
        i = 0
        while i < len(self.waiting) and len(self.running) < self.n_slots:
            req = self.waiting[i]
            # FCFS: a not-yet-arrived head blocks later arrivals too
            if now is not None and req.arrival_time > now:
                break
            if req.swapped:
                # resume a swapped-out victim: rebuild its table from
                # fresh device blocks and stream the host bytes back
                # BEFORE its next chunk/decode can be planned.  An
                # unresumable victim (device blocks still scarce) keeps
                # its queue position but does NOT block later arrivals:
                # its KV is parked on host, so free device blocks it
                # cannot claim yet may as well admit fresh work — this
                # is exactly how the swap tier sustains more resident
                # requests than recompute at equal device HBM.  Resume
                # demands the admission watermark on top of the table
                # (anti-thrash), waived when nothing else is running —
                # the victim must make progress eventually.
                if not bm.can_swap_in(req.req_id,
                                      watermark=bool(self.running)):
                    i += 1
                    continue
                del self.waiting[i]
                pairs = bm.swap_in(req.req_id)
                req.swap_in()
                self.running.append(req)
                self.n_swap_ins += 1
                if swap_in_hook:
                    swap_in_hook(req, pairs)
                continue
            if bm is not None:
                # watermark-gated admission: the whole prefill must fit
                # with headroom left for running requests' decode appends.
                # Preempted requests readmit with append semantics (no
                # watermark) — they were already admitted once and may
                # legally have grown past the admissible threshold.
                fresh = req.n_preemptions == 0
                floor = bm.watermark_blocks if fresh else 0
                if bm.blocks_for_tokens(len(req.prefill_tokens)) \
                        > bm.n_usable - floor:
                    # can NEVER be admitted at this pool geometry (vLLM's
                    # AllocStatus.NEVER): reject instead of wedging the
                    # FCFS queue behind an impossible head
                    del self.waiting[i]
                    req.state = State.FINISHED
                    self.rejected.append(req)
                    continue
                # prefix-cache hit: only the NOVEL blocks are charged
                # against the free list (the hit chain is refcount-shared,
                # not allocated; a trimmed full-prompt hit costs one extra
                # block for the copy-on-write fork of its tail)
                hit_blocks, hit_tokens = [], 0
                if self.prefix_cache is not None:
                    hit_blocks, hit_tokens = \
                        self.prefix_cache.match(req.prefill_tokens)
                need = bm.blocks_for_tokens(len(req.prefill_tokens)) \
                    - len(hit_blocks)
                if hit_tokens < len(hit_blocks) * bm.block_size:
                    need += 1
                # the hit blocks the cache alone holds are pinned by the
                # share below: they are not reclaimable for this prompt
                if not bm.can_allocate_blocks(need, watermark=fresh,
                                              hit_blocks=hit_blocks):
                    break
            del self.waiting[i]
            req.state = State.PREFILLING
            self.running.append(req)
            if bm is not None:
                # earmark the admitted prompt's novel blocks NOW: the
                # chunks allocate lazily over many iterations, and without
                # the reservation a later admission passes the same
                # instantaneous free-list check and the two prefills
                # starve each other mid-prompt (prefills never preempt,
                # so the pool wedges).  Consumed as ensure() allocates.
                bm.reserve(req.req_id, need)
            if bm is not None and hit_blocks:
                bm.share(req.req_id, hit_blocks)
                req.prefilled = hit_tokens
                req.cached_tokens += hit_tokens
                self.n_prefix_hits += 1
                self.n_cached_tokens += hit_tokens
            if admit_hook:
                admit_hook(req)

    # ----------------------------------------------------- prefix sharing
    def _written_tokens(self, req: Request):
        """The token ids whose KV is PROVABLY in this request's blocks.

        Everything up to ``prefilled`` is written by executed chunks;
        decode steps write one position each, except the most recently
        sampled token, which is still pending (its KV lands when the next
        decode processes it).  ``oip`` discounts post-preemption outputs
        that re-entered through the prefill path."""
        oip = len(req.prefill_tokens) - req.prompt_len
        written = req.prefilled + max(len(req.output) - oip - 1, 0)
        return (list(req.prefill_tokens[:req.prefilled])
                + list(req.output[oip:]))[:written]

    def _commit_prefixes(self, reqs):
        """Index every full written block of ``reqs`` into the prefix
        cache.  Only called at points where no plan touching these
        requests is in flight (top of ``next_plan``, finish, preemption),
        so the written-token prefix is actually on device."""
        if self.prefix_cache is None:
            return
        bm = self.block_manager
        for r in reqs:
            toks = self._written_tokens(r)
            if len(toks) >= bm.block_size:
                self.prefix_cache.commit(toks, bm.table(r.req_id))

    def _on_finish(self, req: Request):
        # commit before the base class frees the blocks: cache pins keep
        # the indexed prefix alive after the owner retires
        self._commit_prefixes([req])

    # --------------------------------------------------------- preemption
    def _swap_decision(self, victim: Request) -> bool:
        """Should ``victim`` be evicted by swap (True) or recompute
        (False)?  Decided BEFORE any prefix commit — committing would pin
        the victim's blocks and make them unswappable.  ``hybrid``
        charges the full PCIe round trip (out now + in at resume) against
        re-prefilling the victim's context in this policy's chunks."""
        if self.preempt_mode == "recompute":
            return False
        bm = self.block_manager
        if not bm.can_swap_out(victim.req_id):
            return False        # shared/pinned blocks or host tier full
        if self.preempt_mode == "swap":
            return True
        from repro_torch.sim.cost_model import (
            chunked_prefill_total, kv_swap_bytes, kv_swap_time)
        swap_t = 2.0 * kv_swap_time(
            self.swap_hw, kv_swap_bytes(self.swap_cfg,
                                        len(bm.table(victim.req_id)),
                                        bm.block_size))
        rec_t = chunked_prefill_total(self.swap_cfg, self.swap_hw,
                                      victim.context_len, self.chunk_size)
        return swap_t < rec_t

    def _preempt(self, victim: Request, preempt_hook=None,
                 swap_out_hook=None):
        """Evict ``victim`` and re-queue it at the head of the waiting
        line (it keeps its FCFS arrival priority).

        Recompute path: free its pool blocks and hand it to the executor
        hook (slot release); with a prefix cache the victim's written
        full blocks are committed first — they survive the free
        (cache-pinned), so its readmission re-hits them instead of
        recomputing from scratch.

        Swap path (``preempt_mode`` + :meth:`_swap_decision`): the blocks
        move to the host tier instead — ``swap_out_hook(victim, pairs)``
        streams the bytes into the engine's arena and releases the slot;
        prefill/decode progress is preserved for :meth:`_admit`'s
        resume."""
        self.running.remove(victim)
        bm = self.block_manager
        if bm is not None and self._swap_decision(victim):
            pairs = bm.swap_out(victim.req_id)
            if swap_out_hook:
                swap_out_hook(victim, pairs)
            victim.swap_out()
            self.n_swap_outs += 1
        else:
            if bm is not None:
                self._commit_prefixes([victim])
                bm.free(victim.req_id)
            if preempt_hook:
                preempt_hook(victim)
            victim.preempt()
        self.waiting.appendleft(victim)
        self.n_preemptions += 1

    def _pick_victim(self, protect) -> Optional[Request]:
        """Lowest-priority running request: latest admitted, skipping the
        ``protect`` set (requests already scheduled this iteration)."""
        for r in reversed(self.running):
            if r.req_id not in protect:
                return r
        return None

    # ------------------------------------------------------------- policy
    def next_plan(self, admit_hook=None, now: Optional[float] = None,
                  preempt_hook=None, swap_out_hook=None,
                  swap_in_hook=None) -> Optional[IterationPlan]:
        # the previous plan has fully executed by now (the serve loops
        # only compose a new plan after results return; pipelined serving
        # strips in-flight requests from ``running`` first), so every
        # running request's written prefix is safe to index
        self._commit_prefixes(self.running)
        self._admit(admit_hook, now, swap_in_hook)
        if not self.running:
            return None
        self.iteration += 1
        plan = IterationPlan()
        budget = self.token_budget
        bm = self.block_manager
        # 1) decodes first — never displaced by prefill.  With a block
        # manager each decode RESERVES the block its new token lands in;
        # a dry pool preempts the lowest-priority running request.
        decode_cap = min(self.max_decodes, budget)
        scheduled = set()
        for r in list(self.running):
            if r.state != State.DECODING:
                continue
            if len(plan.decodes) >= decode_cap:
                break
            if r not in self.running:       # preempted earlier this pass
                continue
            if bm is not None:
                need = r.decode_position + 1
                preempted_self = False
                while not bm.can_append(r.req_id, need):
                    victim = self._pick_victim(scheduled | {r.req_id})
                    if victim is None:
                        # everyone else is already in this plan: evict r
                        # itself (its decode waits for the recompute)
                        if len(self.running) == 1 and bm.blocks_for_tokens(
                                r.context_len + 1) > bm.n_usable:
                            raise RuntimeError(
                                f"KV pool too small for req {r.req_id} "
                                f"alone (ctx={r.context_len}); grow "
                                f"n_blocks")
                        self._preempt(r, preempt_hook, swap_out_hook)
                        preempted_self = True
                        break
                    self._preempt(victim, preempt_hook, swap_out_hook)
                if preempted_self:
                    continue
                bm.ensure(r.req_id, need)
            plan.decodes.append(DecodeWork(r.req_id, r.last_token,
                                           r.decode_position))
            scheduled.add(r.req_id)
            budget -= 1
        # 2) fill the remainder with FCFS prefill chunks, shrunk to what
        # the free list can back (prefills never trigger preemption — the
        # next iteration's decodes have first claim on reclaimed blocks)
        prefilling = [r for r in self.running if r.state == State.PREFILLING
                      and r.prefill_remaining > 0]
        for r in prefilling:
            if budget <= 0:
                break
            if (self.max_chunks_per_iter is not None
                    and len(plan.chunks) >= self.max_chunks_per_iter):
                break
            n = min(self.chunk_size, budget, r.prefill_remaining)
            if bm is not None:
                n = min(n, bm.appendable_tokens(r.req_id) - r.prefilled)
                if n <= 0:
                    break
                bm.ensure(r.req_id, r.prefilled + n)
            plan.chunks.append(self._take_chunk(r, n))
            budget -= n
        if not plan.chunks and not plan.decodes:
            return None
        return plan


POLICIES["sarathi_serve"] = SarathiServeScheduler

# policies whose engine compiles with C = chunk_size (the rest submit whole
# prompts as one 'chunk' and need C = max prompt length)
CHUNKED_POLICIES = frozenset({"sarathi", "sarathi_serve"})

# policies whose constructor takes a token_budget
BUDGETED_POLICIES = frozenset({"sarathi_serve"})

# policies whose constructor takes a prefix_cache (cross-request KV reuse)
PREFIX_POLICIES = frozenset({"sarathi_serve"})

# policies whose constructor takes preempt_mode/swap_cfg/swap_hw (host KV
# swap tier; next_plan accepts swap_out_hook=/swap_in_hook=)
SWAP_POLICIES = frozenset({"sarathi_serve"})
