"""Timestamped request workloads for online serving.

Couples the paper's §5.3 request-shape distribution (Zipf lengths, fixed
P:D split — :func:`repro_torch.data.serving_workload`) with an arrival
process:

* ``poisson`` — open-loop Poisson arrivals at ``rate`` req/s (the standard
  serving-benchmark assumption; exponential inter-arrival gaps);
* ``uniform`` — deterministic, evenly spaced at ``rate`` req/s;
* ``bursty`` — Poisson-spaced bursts of ``burst`` simultaneous requests
  (mean rate preserved): the pool-pressure pattern that exercises
  preemption, and with a host KV tier, the swap path;
* an explicit trace of arrival times (replay of a recorded workload).

Prefix-reuse traffic (what ``benchmarks/prefix.py`` sweeps) comes from two
extra generators: :func:`shared_prefix_workload` (shared system prompts)
and :func:`multiturn_workload` (growing chat/agent transcripts, each turn
re-submitting the previous turn's prompt as a strict prefix).

A copy of the JAX package's ``repro.serving.workload``.

Every generator derives its arrival-time and content random streams from
INDEPENDENT substreams of one seed (``np.random.SeedSequence.spawn``), so
the timing of a request never correlates with its shape.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.data import serving_workload
from repro_torch.scheduler.request import Request


def poisson_arrivals(n: int, rate: float, seed=0) -> np.ndarray:
    """n arrival times with Exp(1/rate) inter-arrival gaps (open loop).
    ``seed`` is anything ``np.random.default_rng`` accepts (an int or a
    ``SeedSequence`` substream)."""
    if rate <= 0:
        raise ValueError("rate must be positive")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def bursty_arrivals(n: int, rate: float, burst: int = 4,
                    seed=0) -> np.ndarray:
    """n arrival times in Poisson-spaced bursts of ``burst`` simultaneous
    requests.  The burst process runs at ``rate / burst`` bursts/s, so the
    mean request rate stays ``rate`` — only the variance moves.  Bursts
    are what drive a paged pool into preemption: ``burst`` prompts land
    at once, the pool overcommits, and victims must recompute or swap."""
    if rate <= 0:
        raise ValueError("rate must be positive")
    if burst < 1:
        raise ValueError("burst must be >= 1")
    n_bursts = -(-n // burst)
    starts = poisson_arrivals(n_bursts, rate / burst, seed=seed)
    return np.repeat(starts, burst)[:n]


def uniform_arrivals(n: int, rate: float) -> np.ndarray:
    """n deterministic arrivals evenly spaced at ``rate`` req/s."""
    if rate <= 0:
        raise ValueError("rate must be positive")
    return np.arange(n, dtype=np.float64) / rate


def trace_arrivals(times: Sequence[float]) -> np.ndarray:
    """Validate and normalise an explicit arrival-time trace."""
    t = np.asarray(times, dtype=np.float64)
    if t.ndim != 1:
        raise ValueError("trace must be 1-D")
    if len(t) and (np.any(t < 0) or np.any(np.diff(t) < 0)):
        raise ValueError("trace times must be non-negative and sorted")
    return t


def online_workload(n_requests: int, *, rate: float = 1.0,
                    arrival: str = "poisson", burst: int = 4,
                    trace: Optional[Sequence[float]] = None,
                    pd_ratio: float = 8.0, min_len: int = 16,
                    max_len: int = 64, theta: float = 0.4,
                    vocab_size: int = 32000, seed: int = 0,
                    eos_token: Optional[int] = None) -> List[Request]:
    """Timestamped requests: paper-shaped prompts + an arrival process."""
    # the arrival process draws from its own substream: feeding the raw
    # seed to both streams correlated arrival gaps with prompt shapes.
    # (serving_workload keeps the raw seed so request SHAPES are unchanged
    # — only arrival times moved when this was fixed.)
    a_seed, _ = np.random.SeedSequence(seed).spawn(2)
    if trace is not None:
        times = trace_arrivals(trace)
        if len(times) != n_requests:
            raise ValueError(f"trace has {len(times)} times for "
                             f"{n_requests} requests")
    elif arrival == "poisson":
        times = poisson_arrivals(n_requests, rate, seed=a_seed)
    elif arrival == "bursty":
        times = bursty_arrivals(n_requests, rate, burst=burst, seed=a_seed)
    elif arrival == "uniform":
        times = uniform_arrivals(n_requests, rate)
    else:
        raise ValueError(f"unknown arrival process {arrival!r}")
    shapes = serving_workload(n_requests, pd_ratio=pd_ratio, min_len=min_len,
                              max_len=max_len, theta=theta, seed=seed,
                              vocab_size=vocab_size)
    return [Request(prompt=p, max_new_tokens=d, arrival_time=float(t),
                    eos_token=eos_token)
            for (p, d), t in zip(shapes, times)]


def shared_prefix_workload(n_requests: int, *, shared_len: int,
                           unique_len: int, n_decode: int = 8,
                           n_groups: int = 1, rate: float = 1.0,
                           arrival: str = "poisson",
                           vocab_size: int = 32000, seed: int = 0,
                           eos_token: Optional[int] = None) -> List[Request]:
    """Shared-system-prompt traffic: requests are dealt round-robin into
    ``n_groups`` groups, every member of a group shares the group's
    ``shared_len``-token prefix and carries a fresh ``unique_len``-token
    tail.  With a prefix cache, each group's prefix is prefilled once and
    every later member reuses its full blocks."""
    if shared_len < 0 or unique_len < 0 or shared_len + unique_len < 1:
        raise ValueError("need shared_len, unique_len >= 0 with a "
                         "non-empty prompt")
    if n_groups < 1:
        raise ValueError("n_groups must be >= 1")
    a_seed, p_seed = np.random.SeedSequence(seed).spawn(2)
    if arrival == "poisson":
        times = poisson_arrivals(n_requests, rate, seed=a_seed)
    elif arrival == "uniform":
        times = uniform_arrivals(n_requests, rate)
    else:
        raise ValueError(f"unknown arrival process {arrival!r}")
    rng = np.random.default_rng(p_seed)
    prefixes = [rng.integers(0, vocab_size, size=shared_len).tolist()
                for _ in range(n_groups)]
    return [Request(prompt=prefixes[i % n_groups]
                    + rng.integers(0, vocab_size, size=unique_len).tolist(),
                    max_new_tokens=n_decode, arrival_time=float(times[i]),
                    eos_token=eos_token)
            for i in range(n_requests)]


def multiturn_workload(n_conversations: int, n_turns: int, *,
                       turn_len: int = 32, n_decode: int = 8,
                       turn_gap: float = 1.0, rate: float = 0.5,
                       vocab_size: int = 32000, seed: int = 0,
                       eos_token: Optional[int] = None) -> List[Request]:
    """Growing-transcript traffic (multi-turn chat / agent loops): turn
    ``t`` of a conversation re-submits turn ``t-1``'s prompt plus a fresh
    ``turn_len``-token segment, so each turn's prompt is a strict prefix
    of the next — the re-prefill pattern prefix caching eliminates.
    Conversations start as a Poisson process at ``rate`` conv/s; turns
    within a conversation are spaced ``turn_gap`` seconds apart.

    Request shapes must be known when the workload is built, so the
    transcript grows by the submitted prompts only (generated outputs are
    not embedded); a cache hit needs nothing more than prefix equality of
    what IS re-submitted."""
    if n_turns < 1 or turn_len < 1:
        raise ValueError("need n_turns >= 1 and turn_len >= 1")
    if turn_gap < 0:
        raise ValueError("turn_gap must be >= 0")
    a_seed, p_seed = np.random.SeedSequence(seed).spawn(2)
    starts = poisson_arrivals(n_conversations, rate, seed=a_seed)
    rng = np.random.default_rng(p_seed)
    reqs = []
    for c in range(n_conversations):
        transcript: List[int] = []
        for t in range(n_turns):
            transcript = transcript + rng.integers(
                0, vocab_size, size=turn_len).tolist()
            reqs.append(Request(prompt=list(transcript),
                                max_new_tokens=n_decode,
                                arrival_time=float(starts[c] + t * turn_gap),
                                eos_token=eos_token))
    reqs.sort(key=lambda r: (r.arrival_time, r.req_id))
    return reqs
