"""Online-serving latency metrics (DistServe, arXiv 2401.09670 framing).

Per request we record the event times the loop observes — arrival, first
time any of its work ran, every generated-token completion, finish — and
derive the three latencies that define serving goodput:

* **TTFT** — time to first token, ``first token time - arrival``;
* **TBT / ITL** — time between tokens: gaps between consecutive token
  completions of one request (the stall metric SARATHI-style budget
  scheduling bounds);
* **queueing delay** — ``first scheduled - arrival`` (pure admission wait).

A copy of the JAX package's ``repro.serving.metrics`` (pure Python).

Percentiles use linear interpolation between order statistics (numpy's
default), which degrades sanely for the edge cases the tests pin down:
a single sample returns itself for every percentile, and ties collapse.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """q-th percentile (0..100), linear interpolation between ranks."""
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q={q} outside [0, 100]")
    v = sorted(values)
    if not v:
        raise ValueError("percentile of empty sequence")
    if len(v) == 1:
        return float(v[0])
    rank = (len(v) - 1) * (q / 100.0)
    lo = math.floor(rank)
    hi = math.ceil(rank)
    return float(v[lo] + (v[hi] - v[lo]) * (rank - lo))


@dataclass
class RequestTrace:
    """Event times for one request, as observed by the serving loop."""
    req_id: int
    arrival: float
    scheduled: Optional[float] = None       # first time any work ran
    finish: Optional[float] = None
    token_times: List[float] = field(default_factory=list)
    n_preemptions: int = 0                  # paged-pool evictions suffered
    recompute_tokens: int = 0               # context re-prefilled after them
    cached_tokens: int = 0                  # prefill tokens reused from the
    #                                         prefix cache (no compute paid)
    n_swap_outs: int = 0                    # evictions served by the host
    n_swap_ins: int = 0                     #   KV tier instead of recompute
    swapped_tokens: int = 0                 # context moved over PCIe

    def mark_scheduled(self, t: float):
        if self.scheduled is None:
            self.scheduled = t

    @property
    def ttft(self) -> Optional[float]:
        return self.token_times[0] - self.arrival if self.token_times else None

    @property
    def queue_delay(self) -> Optional[float]:
        return None if self.scheduled is None else self.scheduled - self.arrival

    @property
    def tbts(self) -> List[float]:
        """Inter-token gaps (empty until the 2nd token lands)."""
        return [b - a for a, b in zip(self.token_times, self.token_times[1:])]

    @property
    def e2e(self) -> Optional[float]:
        return None if self.finish is None else self.finish - self.arrival

    @property
    def n_tokens(self) -> int:
        return len(self.token_times)


@dataclass
class PipelineStats:
    """Per-stage occupancy of a pipeline-parallel serving run.

    The pipelined engine executes micro-batches stage-by-stage and
    *measures* each stage's service time
    (:meth:`repro_torch.core.PipelineEngine.execute_timed`); this class
    replays those measured durations on a virtual pipeline clock
    with exactly the recurrence ``repro_torch.sim.pipeline`` uses — a stage
    starts a micro-batch when both the stage is free and the previous
    stage has finished it — so measured bubble fractions are directly
    comparable to the simulator's predictions (benchmarks/pipeline.py).
    The activation hop between stages is inside the measured durations
    (it is the real device-to-device transfer), so no separate P2P term
    is added here.
    """
    pp: int
    tp: int = 1                # chips per stage (annotation only: TP time
    #                            is inside the measured stage durations)
    stage_free: List[float] = field(default_factory=list)
    stage_busy: List[float] = field(default_factory=list)
    n_microbatches: int = 0

    def __post_init__(self):
        if not self.stage_free:
            self.stage_free = [0.0] * self.pp
        if not self.stage_busy:
            self.stage_busy = [0.0] * self.pp

    def advance_head(self, t: float):
        """Idle the first stage until ``t`` (arrival gap / lock drain)."""
        self.stage_free[0] = max(self.stage_free[0], t)

    def inject(self, t_ready: float, durations: Sequence[float]) -> float:
        """Stream one micro-batch (per-stage measured ``durations``) into
        the pipeline no earlier than ``t_ready``; returns its drain time
        off the last stage (when its tokens exist / its requests unlock).
        """
        if len(durations) != self.pp:
            raise ValueError(f"expected {self.pp} durations, "
                             f"got {len(durations)}")
        t_prev: Optional[float] = None
        for s, dt in enumerate(durations):
            start = max(self.stage_free[s],
                        t_ready if t_prev is None else t_prev)
            self.stage_busy[s] += dt
            self.stage_free[s] = start + dt
            t_prev = self.stage_free[s]
        self.n_microbatches += 1
        return t_prev

    @property
    def makespan(self) -> float:
        return max(self.stage_free)

    @property
    def stage_idle(self) -> List[float]:
        m = self.makespan
        return [m - b for b in self.stage_busy]

    @property
    def total_bubble(self) -> float:
        return sum(self.stage_idle)

    @property
    def bubble_fraction(self) -> float:
        """Idle share of total stage-time — the §5.3 pipeline bubble
        metric (0 = perfectly full pipeline)."""
        m = self.makespan
        return self.total_bubble / (self.pp * m) if m > 0 else 0.0


@dataclass(frozen=True)
class Stat:
    """Summary statistics of one latency distribution."""
    n: int
    mean: float
    p50: float
    p90: float
    p99: float
    max: float

    @staticmethod
    def of(values: Sequence[float]) -> "Stat":
        if not values:
            return Stat(0, float("nan"), float("nan"), float("nan"),
                        float("nan"), float("nan"))
        return Stat(len(values), sum(values) / len(values),
                    percentile(values, 50), percentile(values, 90),
                    percentile(values, 99), max(values))


@dataclass(frozen=True)
class ServingSummary:
    n_requests: int
    n_tokens: int
    makespan: float
    ttft: Stat
    tbt: Stat
    queue_delay: Stat
    e2e: Stat
    # paged KV pool pressure (all zero for dense-cache runs)
    n_preemptions: int = 0
    recompute_tokens: int = 0
    peak_pool_util: float = 0.0
    # prefix-cache reuse (zero when the cache is off)
    n_prefix_hits: int = 0          # requests that reused >= 1 cached block
    cached_tokens: int = 0          # prefill tokens served from cache
    # host KV swap tier (zero under preempt_mode='recompute' / dense)
    n_swap_outs: int = 0            # evictions that swapped instead
    n_swap_ins: int = 0             # swapped victims streamed back
    swapped_tokens: int = 0         # context tokens moved over PCIe
    # pipeline-parallel stage occupancy (zero for single-stage runs)
    pp: int = 1
    tp: int = 1
    bubble_fraction: float = 0.0

    @property
    def throughput(self) -> float:
        """Generated tokens per second of serving time."""
        return self.n_tokens / self.makespan if self.makespan > 0 else 0.0

    @property
    def recompute_overhead(self) -> float:
        """Re-prefilled tokens per generated token (preemption cost)."""
        return self.recompute_tokens / self.n_tokens if self.n_tokens else 0.0

    @property
    def hit_rate(self) -> float:
        """Fraction of requests that reused at least one cached block."""
        return self.n_prefix_hits / self.n_requests if self.n_requests else 0.0


def summarize(traces: Iterable[RequestTrace],
              makespan: Optional[float] = None,
              peak_pool_util: float = 0.0,
              pipeline: Optional[PipelineStats] = None,
              tp: Optional[int] = None) -> ServingSummary:
    """``tp`` overrides the TP degree for single-stage (no PipelineStats)
    runs; pipelined runs carry it on ``pipeline.tp``."""
    traces = list(traces)
    ttfts = [t.ttft for t in traces if t.ttft is not None]
    tbts = [g for t in traces for g in t.tbts]
    queues = [t.queue_delay for t in traces if t.queue_delay is not None]
    e2es = [t.e2e for t in traces if t.e2e is not None]
    n_tokens = sum(t.n_tokens for t in traces)
    if makespan is None:
        ends = [t.token_times[-1] for t in traces if t.token_times]
        makespan = max(ends) - min(t.arrival for t in traces) \
            if ends and traces else 0.0
    return ServingSummary(
        n_requests=len(traces), n_tokens=n_tokens, makespan=makespan,
        ttft=Stat.of(ttfts), tbt=Stat.of(tbts),
        queue_delay=Stat.of(queues), e2e=Stat.of(e2es),
        n_preemptions=sum(t.n_preemptions for t in traces),
        recompute_tokens=sum(t.recompute_tokens for t in traces),
        peak_pool_util=peak_pool_util,
        n_prefix_hits=sum(1 for t in traces if t.cached_tokens),
        cached_tokens=sum(t.cached_tokens for t in traces),
        n_swap_outs=sum(t.n_swap_outs for t in traces),
        n_swap_ins=sum(t.n_swap_ins for t in traces),
        swapped_tokens=sum(t.swapped_tokens for t in traces),
        pp=pipeline.pp if pipeline is not None else 1,
        tp=(tp if tp is not None
            else pipeline.tp if pipeline is not None else 1),
        bubble_fraction=(pipeline.bubble_fraction
                         if pipeline is not None else 0.0))


def format_table(s: ServingSummary, unit: str = "s") -> str:
    """Human-readable metrics table (the example / benchmark output)."""
    scale = {"s": 1.0, "ms": 1e3, "us": 1e6}[unit]
    rows = [("ttft", s.ttft), ("tbt", s.tbt),
            ("queue_delay", s.queue_delay), ("e2e", s.e2e)]
    out = [f"requests={s.n_requests} tokens={s.n_tokens} "
           f"makespan={s.makespan:.3f}s throughput={s.throughput:.1f} tok/s",]
    if s.pp > 1 or s.tp > 1:
        out.append(f"pp={s.pp} tp={s.tp} "
                   f"bubble_fraction={s.bubble_fraction:.1%}")
    if s.n_preemptions or s.peak_pool_util:
        out.append(f"preemptions={s.n_preemptions} "
                   f"recompute_tokens={s.recompute_tokens} "
                   f"(overhead {s.recompute_overhead:.2f} tok/tok) "
                   f"peak_pool_util={s.peak_pool_util:.0%}")
    if s.cached_tokens:
        out.append(f"prefix_hits={s.n_prefix_hits}/{s.n_requests} "
                   f"({s.hit_rate:.0%}) cached_tokens={s.cached_tokens}")
    if s.n_swap_outs or s.n_swap_ins:
        out.append(f"swap_outs={s.n_swap_outs} swap_ins={s.n_swap_ins} "
                   f"swapped_tokens={s.swapped_tokens}")
    out += [
           f"{'metric':<12s} {'n':>5s} {'mean':>9s} {'p50':>9s} "
           f"{'p90':>9s} {'p99':>9s} {'max':>9s}   [{unit}]"]
    for name, st in rows:
        if st.n == 0:
            out.append(f"{name:<12s} {0:>5d} {'-':>9s} {'-':>9s} "
                       f"{'-':>9s} {'-':>9s} {'-':>9s}")
            continue
        out.append(f"{name:<12s} {st.n:>5d} {st.mean * scale:>9.3f} "
                   f"{st.p50 * scale:>9.3f} {st.p90 * scale:>9.3f} "
                   f"{st.p99 * scale:>9.3f} {st.max * scale:>9.3f}")
    return "\n".join(out)
