"""Discrete-event pipeline-parallel simulator (paper §5.3, Fig. 5 / Fig. 12).

A copy of the JAX package's ``repro.sim.pipeline`` over the port's
:class:`~repro_torch.core.engine.IterationPlan` and schedulers.

Simulates iteration-level scheduling over a PP pipeline: micro-batches are
IterationPlans produced by a scheduler policy (sarathi / orca / ...), stage
time comes from the analytical cost model with layers split evenly over
stages, and a request's next iteration may only be scheduled after its
previous iteration leaves the LAST stage (the autoregressive dependency that
makes LLM pipeline bubbles special — Fig. 5's PB1/PB2/PB3).

Outputs per-stage idle (bubble) time, per-request bubble attribution, and
makespan — the quantities behind the paper's 6.29x bubble reduction and
1.91x end-to-end GPT-3 speedup.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import IterationPlan
from repro_torch.scheduler.policies import Scheduler
from repro_torch.sim.cost_model import BatchSpec, DecodeSeg, PrefillSeg, \
    iteration_time
from repro_torch.sim.hardware import Hardware


def _decode_seg(decodes) -> Tuple[DecodeSeg, ...]:
    if not decodes:
        return ()
    avg_ctx = sum(d.ctx for d in decodes) / len(decodes)
    return (DecodeSeg(len(decodes), max(int(avg_ctx), 1)),)


def plan_to_spec(plan: IterationPlan, fused: bool = True) -> BatchSpec:
    prefills = tuple(PrefillSeg(len(c.tokens), c.start) for c in plan.chunks)
    return BatchSpec(prefills=prefills, decodes=_decode_seg(plan.decodes),
                     fused=fused)


def _plan_specs(plan: IterationPlan, fused: bool):
    """The packed sub-step BatchSpecs :meth:`Engine.execute` runs a plan
    as: first chunk fused with all piggybacked decodes, remaining chunks
    alone, each paying its own weight fetch."""
    decodes = _decode_seg(plan.decodes)
    for i, c in enumerate(plan.chunks or [None]):
        spec = BatchSpec(
            prefills=(PrefillSeg(len(c.tokens), c.start),) if c else (),
            decodes=decodes if i == 0 else (), fused=fused)
        if spec.n_tokens:
            yield spec


def plan_time(cfg: ModelConfig, hw: Hardware, plan: IterationPlan, *,
              n_chips: int = 1, fused: bool = True,
              sp: bool = False) -> float:
    """Cost a plan as consecutive packed sub-steps (:func:`_plan_specs`).
    Single-chunk plans reduce to ``iteration_time(plan_to_spec(plan))``.
    ``n_chips`` is the TP degree: compute splits, and the per-layer
    all-reduce term of
    :func:`~repro_torch.sim.cost_model.tp_allreduce_time` is charged (``simulate_pipeline`` reports that share separately as
    ``collective_time``).  ``sp`` switches the collective to the
    reduce-scatter/all-gather pair and shards the norm/residual "others"
    term (sequence parallelism — see ``cost_model.iteration_time``)."""
    return sum(iteration_time(cfg, hw, s, n_chips=n_chips, sp=sp).total
               for s in _plan_specs(plan, fused))


@dataclass
class PipelineResult:
    makespan: float
    stage_busy: List[float]
    stage_idle: List[float]
    request_bubble: Dict[int, float]      # req_id -> attributed bubble time
    request_finish: Dict[int, float]
    n_microbatches: int
    collective_time: float = 0.0          # TP all-reduce stage-time (total)

    @property
    def total_bubble(self) -> float:
        return sum(self.stage_idle)

    @property
    def median_request_bubble(self) -> float:
        v = sorted(self.request_bubble.values())
        return v[len(v) // 2] if v else 0.0

    @property
    def collective_fraction(self) -> float:
        """TP all-reduce share of busy stage-time (0 at tp=1) — how much
        of the pipeline's occupied time is spent synchronising, the knob
        that couples TP degree to bubble size."""
        busy = sum(self.stage_busy)
        return self.collective_time / busy if busy > 0 else 0.0


def simulate_pipeline(cfg: ModelConfig, hw: Hardware,
                      scheduler: Scheduler, *, pp: int, tp: int = 1,
                      sp: bool = False, fused: bool = True,
                      p2p_bytes_per_token: Optional[int] = None,
                      max_iters: int = 1_000_000) -> PipelineResult:
    """Run the scheduler's workload through a ``pp``-stage pipeline.

    ``tp`` chips per stage split each stage's compute and charge the
    per-layer ring all-reduce term (``cost_model.tp_allreduce_time``;
    reported as ``collective_time`` / ``collective_fraction`` on the
    result — the measurable coupling between TP degree and bubble size).
    ``sp`` runs each stage sequence-parallel: the all-reduce splits into
    its RS/AG halves and the replicated norm/residual term shards by
    ``tp`` (``cost_model.iteration_time(sp=True)``), so predicted stage
    times drop at ``tp >= 2`` while collective bytes stay identical.
    Micro-batch stage time = iteration_time over n_layers/pp layers.  A
    simple P2P activation transfer cost is added between stages; the
    degenerate ``pp=1`` case has no inter-stage links, pays no transfer,
    and collapses exactly to the sequential single-stage cost model
    (tests/test_sim.py pins this).
    """
    if pp < 1:
        raise ValueError(f"pp must be >= 1, got {pp}")
    stage_free = [0.0] * pp
    ready_at: Dict[int, float] = {}
    req_bubble: Dict[int, float] = {}
    req_finish: Dict[int, float] = {}
    stage_busy = [0.0] * pp
    n_mb = 0
    coll_total = 0.0

    if p2p_bytes_per_token is None:
        p2p_bytes_per_token = cfg.d_model * 2

    def plan_cost(plan: IterationPlan) -> Tuple[float, float]:
        """-> (per-stage service time, full-plan collective time); one
        cost-model evaluation per packed sub-step serves both."""
        bds = [iteration_time(cfg, hw, s, n_chips=tp, sp=sp)
               for s in _plan_specs(plan, fused)]
        return (sum(b.total for b in bds) / pp,
                sum(b.collective for b in bds))

    def p2p_time(plan: IterationPlan) -> float:
        toks = plan.n_prefill_tokens + len(plan.decodes)
        return toks * p2p_bytes_per_token / hw.link_bw

    # Requests involved in an in-flight micro-batch are locked until it
    # drains the pipeline; the scheduler only sees unlocked requests.
    locked: Dict[int, float] = {}     # req_id -> unlock time

    for it in range(max_iters):
        if not scheduler.has_work:
            break
        now = stage_free[0]
        # unlock requests whose previous iteration has drained
        for rid in [r for r, t in locked.items() if t <= now]:
            del locked[rid]
        runnable = [r for r in scheduler.running if r.req_id not in locked]
        if not (runnable or scheduler.waiting):
            # idle until the next unlock
            t_next = min(locked.values())
            stage_free[0] = t_next
            continue
        # temporarily hide locked requests from the scheduler; they still
        # occupy engine slots, so the visible slot budget shrinks with
        # them (the real pipelined loop does the same — without this the
        # simulated scheduler admits more concurrency than any engine
        # could hold)
        hidden = [r for r in scheduler.running if r.req_id in locked]
        scheduler.running = [r for r in scheduler.running
                             if r.req_id not in locked]
        scheduler.n_slots -= len(hidden)
        try:
            plan = scheduler.next_plan()
        finally:
            scheduler.n_slots += len(hidden)
            scheduler.running.extend(hidden)
        if plan is None:
            if locked:
                stage_free[0] = min(locked.values())
                continue
            break
        n_mb += 1
        # pp stages each spend collective/pp of their service time in TP
        # all-reduces; summed over stages that is the plan's full term
        dt, coll = plan_cost(plan)
        coll_total += coll
        hop = p2p_time(plan) if pp > 1 else 0.0
        ids = [c.req_id for c in plan.chunks] + \
            [d.req_id for d in plan.decodes]

        t_prev_finish = None
        for s in range(pp):
            start = stage_free[s] if t_prev_finish is None else \
                max(stage_free[s], t_prev_finish + hop)
            idle = start - stage_free[s]
            if s > 0 and idle > 0:
                share = idle / max(len(ids), 1)
                for rid in ids:
                    req_bubble[rid] = req_bubble.get(rid, 0.0) + share
            finish = start + dt
            stage_busy[s] += dt
            stage_free[s] = finish
            t_prev_finish = finish
        # autoregressive dependency: a request whose micro-batch SAMPLES a
        # token (decode, or the last chunk of its prompt) rejoins only
        # after the drain.  A NON-last prefill chunk has no such
        # dependency — chunk i+1 needs chunk i's KV at stage s only once
        # it reaches stage s itself, which in-order injection guarantees —
        # so consecutive chunks of one prompt stream back-to-back through
        # the pipeline (the §5.3 mechanism that keeps it full of uniform
        # micro-batches).
        last_chunk_ids = {c.req_id for c in plan.chunks if c.is_last}
        decode_ids = {d.req_id for d in plan.decodes}
        for rid in last_chunk_ids | decode_ids:
            locked[rid] = t_prev_finish
        # feed dummy tokens (content-independent timing model)
        tokens = {rid: 1 for rid in ids
                  if rid in last_chunk_ids or rid in decode_ids}
        scheduler.on_tokens(tokens)
        for r in list(scheduler.running):
            if r.done:
                req_finish[r.req_id] = t_prev_finish
        for rid in tokens:
            if rid not in [r.req_id for r in scheduler.running]:
                req_finish.setdefault(rid, t_prev_finish)

    makespan = max(stage_free)
    stage_idle = [makespan - b for b in stage_busy]
    return PipelineResult(makespan=makespan, stage_busy=stage_busy,
                          stage_idle=stage_idle, request_bubble=req_bubble,
                          request_finish=req_finish, n_microbatches=n_mb,
                          collective_time=coll_total)
