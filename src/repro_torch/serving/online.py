"""Online continuous serving: arrival-driven event loop over the engine.

PyTorch counterpart of ``repro.serving.online``.  The offline
:class:`repro_torch.serving.Server` drains a static request list with no
notion of time; this module adds the serving dimension.  The loop keeps a
virtual clock, releases requests into the scheduler as they *arrive*,
executes one scheduler-composed iteration at a time, and advances the
clock by the iteration's duration — so per-request TTFT / TBT / queueing
delay fall out of the event times (:mod:`repro_torch.serving.metrics`).

The iteration duration comes from a pluggable **executor**:

* :class:`EngineExecutor` — the engine (on the card: its captured CUDA
  graphs); duration is measured wall-clock;
* :class:`CostModelExecutor` — the §5.3 analytical cost model; duration is
  the modelled iteration time on a target :class:`~repro_torch.sim.Hardware`
  profile (the JAX package's A6000 / A100 / TPU v5e constants: modelled
  times, not measurements).

Both share one loop, so the budget scheduler's behaviour is identical in
measurement and simulation.  As in the JAX package the clock leaves out the
scheduler's planning time between iterations.  A
:class:`~repro_torch.core.PipelineEngine` is served by
:func:`serve_online_pipelined` instead: ``pp`` micro-batches in flight on a
virtual pipeline clock fed with the measured stage times.
Phase-disaggregated serving is not ported yet (ROADMAP Queue 1,
"disagg").
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import Engine, IterationPlan, _unported
from repro_torch.core.pipeline_engine import PipelineEngine
from repro_torch.core.sampling import SamplingParams
from repro_torch.scheduler import Request, Scheduler
from repro_torch.serving.metrics import (PipelineStats, RequestTrace,
                                         ServingSummary, summarize)
from repro_torch.serving.server import build_engine_and_scheduler
from repro_torch.sim.cost_model import kv_swap_bytes, kv_swap_time
from repro_torch.sim.pipeline import plan_time


# --------------------------------------------------------------------------
# executors
# --------------------------------------------------------------------------
class EngineExecutor:
    """Run plans on the engine; duration = measured wall time."""

    def __init__(self, engine: Engine):
        self.engine = engine

    def admit(self, req: Request):
        self.engine.add_request(req.req_id, memory=req.memory)

    def release(self, req: Request):
        self.engine.release(req.req_id)

    def preempt(self, req: Request):
        """Free the preempted request's slot (and pool blocks, when paged);
        it will re-enter via ``admit`` once readmitted for recompute."""
        self.engine.release(req.req_id)

    def warmup(self):
        """Build the kernels and capture both step shapes off the clock;
        sampling/iteration state is preserved so warmed and cold engines
        replay identically."""
        self.engine.warmup()

    def extract(self, req: Request):
        raise _unported("extract", "disagg")

    def install(self, req: Request, handoff):
        raise _unported("install", "disagg")

    def _sync(self):
        """Wait for the current stream, so that a time read next holds the
        finished copies (a CUDA copy returns once it is queued)."""
        if self.engine.device.type == "cuda":
            torch.cuda.current_stream(self.engine.device).synchronize()

    def swap_out(self, req: Request, pairs, block_size: int) -> float:
        """Stream the victim's blocks into the host arena, then free its
        slot; returns the measured wall time of the finished copy (the
        loop's clock charge)."""
        t0 = time.perf_counter()
        self.engine.swap_out_blocks(pairs)
        self.engine.release(req.req_id)
        self._sync()
        return time.perf_counter() - t0

    def swap_in(self, req: Request, pairs, block_size: int) -> float:
        """Re-seat the resumed victim (fresh slot) and stream its blocks
        back from the arena; returns the measured wall time of the
        finished copy."""
        t0 = time.perf_counter()
        self.engine.add_request(req.req_id, memory=req.memory)
        self.engine.swap_in_blocks(pairs)
        self._sync()
        return time.perf_counter() - t0

    def __call__(self, plan: IterationPlan) -> Tuple[Dict[int, int], float]:
        # execute() ends in a host read of the sampled tokens, which waits
        # for the device: the span is the step's whole time
        t0 = time.perf_counter()
        tokens = self.engine.execute(plan)
        return tokens, time.perf_counter() - t0


class CostModelExecutor:
    """Time plans with the analytical cost model; tokens are synthetic
    (content-independent timing, like the pipeline simulator).

    Timing mirrors :meth:`Engine.execute` exactly: a multi-chunk plan is
    costed as consecutive packed sub-steps (first chunk fused with all
    decodes, remaining chunks alone), each paying its own weight fetch —
    not as one big fused batch — so simulated iteration times track what
    the engine's sub-steps would cost on ``hw``.
    """

    def __init__(self, cfg: ModelConfig, hw, *, n_chips: int = 1,
                 fused: bool = True):
        self.cfg = cfg
        self.hw = hw
        self.n_chips = n_chips
        self.fused = fused

    def admit(self, req: Request):
        pass

    def release(self, req: Request):
        pass

    def preempt(self, req: Request):
        pass

    def warmup(self):
        pass

    def extract(self, req: Request):
        raise _unported("extract", "disagg")

    def install(self, req: Request, handoff):
        raise _unported("install", "disagg")

    def _swap_time(self, pairs, block_size: int) -> float:
        return kv_swap_time(self.hw, kv_swap_bytes(self.cfg, len(pairs),
                                                   block_size))

    def swap_out(self, req: Request, pairs, block_size: int) -> float:
        """Modelled PCIe time of moving the victim's blocks to host —
        the :func:`repro_torch.sim.cost_model.kv_swap_time` clock
        charge."""
        return self._swap_time(pairs, block_size)

    def swap_in(self, req: Request, pairs, block_size: int) -> float:
        return self._swap_time(pairs, block_size)

    def __call__(self, plan: IterationPlan) -> Tuple[Dict[int, int], float]:
        dt = plan_time(self.cfg, self.hw, plan, n_chips=self.n_chips,
                       fused=self.fused)
        tokens = {c.req_id: 1 for c in plan.chunks if c.is_last}
        tokens.update({d.req_id: 1 for d in plan.decodes})
        return tokens, dt


# --------------------------------------------------------------------------
# the event loop
# --------------------------------------------------------------------------
@dataclass
class IterationRecord:
    t_start: float
    duration: float
    n_prefill_tokens: int
    n_decode_tokens: int
    pool_blocks_used: int = 0          # paged KV pool occupancy (0 = dense)
    pool_blocks_total: int = 0
    n_resident: int = 0                # requests holding KV (device + host)


@dataclass
class OnlineResult:
    traces: Dict[int, RequestTrace]
    outputs: Dict[int, List[int]]
    iterations: List[IterationRecord] = field(default_factory=list)
    makespan: float = 0.0
    n_preemptions: int = 0
    pipeline: Optional[PipelineStats] = None   # set by a pipelined loop
    tp: int = 1                                # engine TP degree
    # host KV swap tier traffic (zero under preempt_mode='recompute')
    n_swap_outs: int = 0
    n_swap_ins: int = 0
    kv_swap_time: float = 0.0                  # total clock time on PCIe

    @property
    def peak_pool_util(self) -> float:
        return max((i.pool_blocks_used / i.pool_blocks_total
                    for i in self.iterations if i.pool_blocks_total),
                   default=0.0)

    @property
    def peak_resident(self) -> int:
        """Most requests concurrently holding live KV state (on device or
        swapped to host) in any iteration — the capacity metric the swap
        tier multiplies past HBM."""
        return max((i.n_resident for i in self.iterations), default=0)

    @property
    def mean_pool_util(self) -> float:
        utils = [i.pool_blocks_used / i.pool_blocks_total
                 for i in self.iterations if i.pool_blocks_total]
        return sum(utils) / len(utils) if utils else 0.0

    def summary(self) -> ServingSummary:
        return summarize(self.traces.values(), makespan=self.makespan,
                         peak_pool_util=self.peak_pool_util,
                         pipeline=self.pipeline, tp=self.tp)


def serve_online(scheduler: Scheduler, executor,
                 requests: Sequence[Request], *,
                 max_iterations: int = 1_000_000) -> OnlineResult:
    """Drive timestamped requests through ``scheduler`` + ``executor``.

    The clock starts at 0, jumps forward over idle gaps (to the next
    arrival), and advances by each iteration's duration.  Schedulers that
    set ``supports_time`` get the clock passed as ``now=`` so they can gate
    admission on arrival themselves; for the rest the loop withholds
    not-yet-arrived requests.
    """
    pending = sorted(requests, key=lambda r: (r.arrival_time, r.req_id))
    traces = {r.req_id: RequestTrace(r.req_id, r.arrival_time)
              for r in requests}
    # single-stage TP runs carry the engine's degree into the summary
    result = OnlineResult(traces=traces, outputs={}, tp=getattr(
        getattr(executor, "engine", None), "tp", 1))
    clock = 0.0
    n_rejected = 0
    passes_now = getattr(scheduler, "supports_time", False)
    bm = getattr(scheduler, "block_manager", None)

    def release(req: Request):
        executor.release(req)
        tr = traces[req.req_id]
        tr.finish = clock
        tr.n_preemptions = req.n_preemptions
        tr.recompute_tokens = req.recompute_tokens
        tr.cached_tokens = req.cached_tokens
        tr.n_swap_outs = req.n_swap_outs
        tr.n_swap_ins = req.n_swap_ins
        tr.swapped_tokens = req.swapped_tokens
        result.outputs[req.req_id] = list(req.output)

    def preempt(req: Request):
        executor.preempt(req)
        result.n_preemptions += 1
        # count on the trace NOW (release syncs again): a request still in
        # flight when the loop stops must not lose its preemption history
        tr = traces[req.req_id]
        tr.n_preemptions += 1
        tr.recompute_tokens += req.context_len   # what recompute will redo

    # host-swap hooks: the executor moves the bytes (or models the PCIe
    # time) and the charge lands on the clock before the next iteration —
    # resume streams blocks back before the victim's next chunk runs
    swap_charge = [0.0]

    def swap_out(req: Request, pairs):
        dt = executor.swap_out(req, pairs, bm.block_size)
        swap_charge[0] += dt
        result.n_swap_outs += 1
        result.n_preemptions += 1
        result.kv_swap_time += dt
        tr = traces[req.req_id]
        tr.n_preemptions += 1
        tr.n_swap_outs += 1
        tr.swapped_tokens += req.context_len

    def swap_in(req: Request, pairs):
        dt = executor.swap_in(req, pairs, bm.block_size)
        swap_charge[0] += dt
        result.n_swap_ins += 1
        result.kv_swap_time += dt
        traces[req.req_id].n_swap_ins += 1

    for _ in range(max_iterations):
        while pending and pending[0].arrival_time <= clock:
            scheduler.submit(pending.pop(0))
        if not pending and not scheduler.has_work:
            break
        kwargs = {"now": clock} if passes_now else {}
        if getattr(scheduler, "supports_preempt", False):
            kwargs["preempt_hook"] = preempt
        if getattr(scheduler, "supports_swap", False):
            kwargs["swap_out_hook"] = swap_out
            kwargs["swap_in_hook"] = swap_in
        plan = scheduler.next_plan(admit_hook=executor.admit, **kwargs)
        if swap_charge[0]:
            clock += swap_charge[0]
            swap_charge[0] = 0.0
        # requests the scheduler rejected as unservable at this pool
        # geometry terminate with no output (vLLM's "ignored" requests)
        for req in getattr(scheduler, "rejected", [])[n_rejected:]:
            traces[req.req_id].finish = clock
            result.outputs[req.req_id] = []
            n_rejected += 1
        if plan is None:
            if pending:
                clock = max(clock, pending[0].arrival_time)
                continue
            if scheduler.has_work:          # pragma: no cover - safety net
                raise RuntimeError("scheduler stalled with work queued")
            break
        t0 = clock
        tokens, dt = executor(plan)
        clock = t0 + dt
        for c in plan.chunks:
            traces[c.req_id].mark_scheduled(t0)
        for d in plan.decodes:
            traces[d.req_id].mark_scheduled(t0)
        for rid in tokens:
            traces[rid].token_times.append(clock)
        result.iterations.append(IterationRecord(
            t0, dt, plan.n_prefill_tokens, plan.n_decode_tokens,
            pool_blocks_used=bm.n_used if bm is not None else 0,
            pool_blocks_total=bm.n_usable if bm is not None else 0,
            n_resident=len(scheduler.running)
            + sum(1 for r in scheduler.waiting
                  if getattr(r, "swapped", False))))
        scheduler.on_tokens(tokens, release_hook=release)
    result.makespan = clock
    return result


# --------------------------------------------------------------------------
# the pipelined event loop (pipeline-parallel engine)
# --------------------------------------------------------------------------
def _sync_stages(engine: PipelineEngine):
    """Wait for every CUDA stage device, so that a time read next holds
    the finished copies."""
    for dev in engine.devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def serve_online_pipelined(scheduler: Scheduler, engine: PipelineEngine,
                           requests: Sequence[Request], *,
                           warmup: bool = True,
                           max_iterations: int = 1_000_000) -> OnlineResult:
    """Arrival-driven serving over a :class:`PipelineEngine` with
    ``engine.pp`` micro-batches in flight.

    Iteration-level scheduling with the autoregressive pipeline dependency
    of ``repro_torch.sim.pipeline``: a request whose micro-batch is still
    draining the stages is LOCKED — hidden from the scheduler — so each of
    the ``pp`` in-flight micro-batches carries a disjoint request set, and
    the scheduler keeps composing fresh decode-maximal micro-batches from
    the unlocked requests instead of stalling the pipeline.  Time is the
    virtual pipeline clock of :class:`PipelineStats`, fed with the
    *measured* per-stage durations of every micro-batch; a token completes
    (TTFT/TBT event) when its micro-batch drains the LAST stage, and the
    per-stage busy/idle ledger is the engine-side counterpart of the
    simulator's bubble accounting.
    """
    if warmup:
        engine.warmup()                     # capture the stages off the clock
    stats = PipelineStats(engine.pp, tp=getattr(engine, "tp", 1))
    pending = sorted(requests, key=lambda r: (r.arrival_time, r.req_id))
    traces = {r.req_id: RequestTrace(r.req_id, r.arrival_time)
              for r in requests}
    result = OnlineResult(traces=traces, outputs={}, pipeline=stats,
                          tp=stats.tp)
    locked: Dict[int, float] = {}           # req_id -> drain (unlock) time
    n_rejected = 0
    passes_now = getattr(scheduler, "supports_time", False)
    bm = getattr(scheduler, "block_manager", None)
    drain_clock = 0.0                       # time of the newest drain event

    def admit(req: Request):
        engine.add_request(req.req_id, memory=req.memory)

    def release(req: Request):
        engine.release(req.req_id)
        tr = traces[req.req_id]
        tr.finish = drain_clock
        tr.n_preemptions = req.n_preemptions
        tr.recompute_tokens = req.recompute_tokens
        tr.cached_tokens = req.cached_tokens
        tr.n_swap_outs = req.n_swap_outs
        tr.n_swap_ins = req.n_swap_ins
        tr.swapped_tokens = req.swapped_tokens
        result.outputs[req.req_id] = list(req.output)

    def preempt(req: Request):
        engine.release(req.req_id)
        result.n_preemptions += 1
        tr = traces[req.req_id]
        tr.n_preemptions += 1
        tr.recompute_tokens += req.context_len

    # host-swap hooks: per-stage arena moves, measured on the wall clock
    # (the finished copies) and charged as head-of-pipeline delay (the
    # PCIe stream must finish before the resumed victim's next micro-batch
    # is injected)
    swap_charge = [0.0]

    def swap_out(req: Request, pairs):
        t0 = time.perf_counter()
        engine.swap_out_blocks(pairs)
        engine.release(req.req_id)
        _sync_stages(engine)
        dt = time.perf_counter() - t0
        swap_charge[0] += dt
        result.n_swap_outs += 1
        result.n_preemptions += 1
        result.kv_swap_time += dt
        tr = traces[req.req_id]
        tr.n_preemptions += 1
        tr.n_swap_outs += 1
        tr.swapped_tokens += req.context_len

    def swap_in(req: Request, pairs):
        t0 = time.perf_counter()
        engine.add_request(req.req_id, memory=req.memory)
        engine.swap_in_blocks(pairs)
        _sync_stages(engine)
        dt = time.perf_counter() - t0
        swap_charge[0] += dt
        result.n_swap_ins += 1
        result.kv_swap_time += dt
        traces[req.req_id].n_swap_ins += 1

    for _ in range(max_iterations):
        now = stats.stage_free[0]           # next injection opportunity
        while pending and pending[0].arrival_time <= now:
            scheduler.submit(pending.pop(0))
        if not pending and not scheduler.has_work:
            break
        for rid in [r for r, t in locked.items() if t <= now]:
            del locked[rid]
        # in-flight requests are invisible to the scheduler until drained;
        # they still occupy engine slots, so the visible slot budget
        # shrinks with them (or admission would overflow the engine)
        hidden = [r for r in scheduler.running if r.req_id in locked]
        scheduler.running = [r for r in scheduler.running
                             if r.req_id not in locked]
        scheduler.n_slots -= len(hidden)
        kwargs = {"now": now} if passes_now else {}
        if getattr(scheduler, "supports_preempt", False):
            kwargs["preempt_hook"] = preempt
        if getattr(scheduler, "supports_swap", False):
            kwargs["swap_out_hook"] = swap_out
            kwargs["swap_in_hook"] = swap_in
        try:
            plan = scheduler.next_plan(admit_hook=admit, **kwargs)
        finally:
            scheduler.n_slots += len(hidden)
            scheduler.running.extend(hidden)
        if swap_charge[0]:
            stats.advance_head(now + swap_charge[0])
            now = stats.stage_free[0]
            swap_charge[0] = 0.0
        for req in getattr(scheduler, "rejected", [])[n_rejected:]:
            traces[req.req_id].finish = now
            result.outputs[req.req_id] = []
            n_rejected += 1
        if plan is None:
            events = [t for t in locked.values()]
            if pending:
                events.append(pending[0].arrival_time)
            if not events:
                if scheduler.has_work:      # pragma: no cover - safety net
                    raise RuntimeError("scheduler stalled with work queued")
                break
            stats.advance_head(min(events))
            continue
        tokens, durs = engine.execute_timed(plan)
        drain = stats.inject(now, durs)
        drain_clock = drain
        ids = [c.req_id for c in plan.chunks] + \
            [d.req_id for d in plan.decodes]
        # autoregressive dependency: only token-producing work (decodes,
        # last chunks) waits for the drain; a NON-last prefill chunk's
        # successor chunk may enter the very next micro-batch — it meets
        # its predecessor's KV at each stage strictly after the
        # predecessor wrote it (in-order pipeline), so consecutive chunks
        # of one prompt stream back-to-back (§5.3)
        for c in plan.chunks:
            if c.is_last:
                locked[c.req_id] = drain
        for d in plan.decodes:
            locked[d.req_id] = drain
        for rid in ids:
            traces[rid].mark_scheduled(now)
        for rid in tokens:
            traces[rid].token_times.append(drain)
        result.iterations.append(IterationRecord(
            now, drain - now, plan.n_prefill_tokens, plan.n_decode_tokens,
            pool_blocks_used=bm.n_used if bm is not None else 0,
            pool_blocks_total=bm.n_usable if bm is not None else 0,
            n_resident=len(scheduler.running)
            + sum(1 for r in scheduler.waiting
                  if getattr(r, "swapped", False))))
        scheduler.on_tokens(tokens, release_hook=release)
    result.makespan = stats.makespan
    return result


# --------------------------------------------------------------------------
# convenience wrapper: engine + budget scheduler
# --------------------------------------------------------------------------
class OnlineServer:
    """Online counterpart of :class:`repro_torch.serving.Server`: same
    engine, arrival-driven loop, latency metrics.  Default policy is the
    token-budget ``sarathi_serve`` scheduler.  ``device=None`` is the CUDA
    card; ``host_blocks`` / ``preempt_mode`` / ``swap_hw`` give the paged
    pool its host swap tier (see :func:`build_engine_and_scheduler`).

    ``pp > 1`` (or ``force_pipeline``) serves on a :class:`PipelineEngine`
    through the pipelined event loop (:func:`serve_online_pipelined`): up
    to ``pp`` micro-batches in flight, per-stage bubble accounting on
    ``result.pipeline``.  ``tp`` and ``sp`` keep the JAX signature but
    raise ``NotImplementedError`` unless left at their defaults (ROADMAP
    Queue 1, "tp/sp").
    """

    def __init__(self, cfg: ModelConfig, params, *,
                 policy: str = "sarathi_serve", chunk_size: int = 256,
                 n_slots: int = 8, max_len: int = 4096,
                 max_prompt_len: Optional[int] = None,
                 token_budget: Optional[int] = None, dtype=torch.float32,
                 sampling: SamplingParams = SamplingParams(), seed: int = 0,
                 policy_kwargs: Optional[dict] = None, paged: bool = False,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 watermark: float = 0.0, host_blocks: int = 0,
                 preempt_mode: str = "recompute", swap_hw=None,
                 pp: int = 1, tp: int = 1, sp: bool = False,
                 devices=None, max_decodes: Optional[int] = None,
                 force_pipeline: bool = False, prefix_cache: bool = False,
                 device=None):
        self.cfg = cfg
        self.policy_name = policy
        self.engine, self.scheduler = build_engine_and_scheduler(
            cfg, params, policy=policy, chunk_size=chunk_size,
            n_slots=n_slots, max_len=max_len, max_prompt_len=max_prompt_len,
            token_budget=token_budget, dtype=dtype, sampling=sampling,
            seed=seed, policy_kwargs=policy_kwargs, paged=paged,
            block_size=block_size, n_blocks=n_blocks, watermark=watermark,
            host_blocks=host_blocks, preempt_mode=preempt_mode,
            swap_hw=swap_hw, pp=pp, tp=tp, sp=sp, devices=devices,
            max_decodes=max_decodes, force_pipeline=force_pipeline,
            prefix_cache=prefix_cache, device=device)
        self.executor = EngineExecutor(self.engine)

    def run(self, requests: Sequence[Request], *, warmup: bool = True,
            max_iterations: int = 1_000_000) -> OnlineResult:
        if isinstance(self.engine, PipelineEngine):
            return serve_online_pipelined(self.scheduler, self.engine,
                                          requests, warmup=warmup,
                                          max_iterations=max_iterations)
        if warmup:
            self.executor.warmup()          # build and capture off the clock
        return serve_online(self.scheduler, self.executor, requests,
                            max_iterations=max_iterations)
