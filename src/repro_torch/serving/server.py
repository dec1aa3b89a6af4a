"""Offline batched serving: scheduler policy x SARATHI engine.

Drives a workload of :class:`repro_torch.scheduler.Request`s to
completion and records each iteration's composition (prefill / decode
token counts), as ``repro.serving.server`` does, with the JAX loop's
preemption and swap hooks and its handling of rejected prompts.
``pp > 1`` (or ``force_pipeline``) serves on a
:class:`~repro_torch.core.PipelineEngine`; the engines refuse ``tp > 1``
and ``sp``, naming their ROADMAP item.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.cache import PrefixCache
from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import Engine
from repro_torch.core.pipeline_engine import PipelineEngine
from repro_torch.core.sampling import SamplingParams
from repro_torch.models import stack
from repro_torch.scheduler import (BUDGETED_POLICIES, CHUNKED_POLICIES,
                                   POLICIES, PREFIX_POLICIES, SWAP_POLICIES,
                                   Request)
from repro_torch.sim import A100

def build_engine_and_scheduler(cfg: ModelConfig, params, *, policy: str,
                               chunk_size: int, n_slots: int, max_len: int,
                               max_prompt_len: Optional[int] = None,
                               token_budget: Optional[int] = None,
                               dtype=torch.float32,
                               sampling: SamplingParams = SamplingParams(),
                               seed: int = 0,
                               policy_kwargs: Optional[dict] = None,
                               paged: bool = False, block_size: int = 16,
                               n_blocks: Optional[int] = None,
                               watermark: float = 0.0, pp: int = 1,
                               tp: int = 1, sp: bool = False, devices=None,
                               max_decodes: Optional[int] = None,
                               force_pipeline: bool = False,
                               prefix_cache: bool = False,
                               host_blocks: int = 0,
                               preempt_mode: str = "recompute",
                               swap_hw=None, device=None):
    """Shared construction of engine and scheduler.  Orca and
    request-level submit whole prompts as one chunk, so their engines take
    C = the max prompt length; the chunked policies take C = chunk_size.
    ``paged=True`` shares ONE BlockManager between engine and scheduler.
    ``prefix_cache=True`` attaches a :class:`PrefixCache` to that pool
    (paged, a prefix-aware policy and pure attention layers only), and
    ``token_budget`` goes to the policies that take one, as in the JAX
    ``build_engine_and_scheduler``.

    ``host_blocks > 0`` gives the paged pool a host swap tier of that many
    block-sized slots, and ``preempt_mode`` picks what the scheduler does
    to a pool-pressure victim: ``"recompute"`` (drop its KV, re-prefill on
    resume), ``"swap"`` (move its blocks to the host arena and back before
    its next chunk) or ``"hybrid"`` (per victim, the cheaper of the two
    under the cost model on ``swap_hw``, default A100).  Swap needs paged,
    a swap-aware policy and pure attention layers.

    ``pp > 1`` builds a :class:`PipelineEngine`: the layer stack cut into
    ``pp`` stages on ``devices`` (default: the visible CUDA cards,
    round-robin), with the same execute contract and tokens, and per-stage
    service times for the pipelined serving loop.  ``force_pipeline``
    builds one at ``pp=1`` too (the one-stage pipeline, the no-pipeline
    reference of a bubble measurement).  ``max_decodes`` caps the decodes
    the scheduler piggybacks per iteration (default ``n_slots - 1``); with
    a pipeline about ``n_slots / pp`` spreads them over the micro-batches
    in flight.  The engine's decode lanes stay ``n_slots - 1``."""
    if policy not in POLICIES:
        raise KeyError(f"unknown policy {policy!r}; have {sorted(POLICIES)}")
    engine_chunk = chunk_size if policy in CHUNKED_POLICIES else \
        (max_prompt_len or max_len)
    ekw = dict(n_slots=n_slots, max_len=max_len, chunk_size=engine_chunk,
               decode_slots=max(n_slots - 1, 1), dtype=dtype,
               sampling=sampling, seed=seed, paged=paged,
               block_size=block_size, n_blocks=n_blocks,
               watermark=watermark, host_blocks=host_blocks, tp=tp,
               devices=devices, sp=sp, device=device)
    if pp > 1 or force_pipeline:
        engine = PipelineEngine(cfg, params, pp=pp, **ekw)
    else:
        engine = Engine(cfg, params, **ekw)
    kw = dict(n_slots=n_slots,
              max_decodes=(max_decodes if max_decodes is not None
                           else max(n_slots - 1, 1)),
              chunk_size=chunk_size)
    if engine.block_manager is not None:
        kw["block_manager"] = engine.block_manager
    slot_kinds = sorted({k for k in stack.layer_kinds(cfg)
                         if k not in ("dense", "moe")})
    if prefix_cache:
        if policy not in PREFIX_POLICIES:
            raise ValueError(f"prefix_cache is only supported by "
                             f"{sorted(PREFIX_POLICIES)}, not {policy!r}")
        if engine.block_manager is None:
            raise ValueError("prefix_cache requires paged=True")
        if slot_kinds:
            raise ValueError(
                f"prefix_cache requires pure paged-attention layers; "
                f"{cfg.name} has slot-state kinds {slot_kinds} whose "
                f"per-request history the block pool cannot share")
        kw["prefix_cache"] = PrefixCache(engine.block_manager)
    if preempt_mode != "recompute":
        if policy not in SWAP_POLICIES:
            raise ValueError(f"preempt_mode={preempt_mode!r} is only "
                             f"supported by {sorted(SWAP_POLICIES)}, "
                             f"not {policy!r}")
        if engine.block_manager is None:
            raise ValueError("preempt_mode != 'recompute' requires "
                             "paged=True")
        if host_blocks <= 0:
            raise ValueError("preempt_mode != 'recompute' requires "
                             "host_blocks > 0 (the host swap tier)")
        if slot_kinds:
            raise ValueError(
                f"KV swap requires pure paged-attention layers; "
                f"{cfg.name} has slot-state kinds {slot_kinds} whose "
                f"per-request history lives outside the block pool")
        kw["preempt_mode"] = preempt_mode
        if preempt_mode == "hybrid":
            kw["swap_cfg"] = cfg
            kw["swap_hw"] = swap_hw if swap_hw is not None else A100
    if token_budget is not None:
        if policy not in BUDGETED_POLICIES:
            raise ValueError(f"token_budget is only supported by "
                             f"{sorted(BUDGETED_POLICIES)}, not {policy!r}")
        kw["token_budget"] = token_budget
    if policy_kwargs:
        reserved = kw.keys() & policy_kwargs.keys()
        if reserved:
            raise ValueError(f"policy_kwargs may not override "
                             f"{sorted(reserved)}; pass them as top-level "
                             f"arguments")
        kw.update(policy_kwargs)
    return engine, POLICIES[policy](**kw)


@dataclass
class IterationStats:
    n_prefill_tokens: int
    n_decode_tokens: int


@dataclass
class ServeResult:
    outputs: Dict[int, List[int]]
    iterations: List[IterationStats] = field(default_factory=list)

    @property
    def total_prefill_tokens(self) -> int:
        return sum(s.n_prefill_tokens for s in self.iterations)

    @property
    def total_decode_tokens(self) -> int:
        return sum(s.n_decode_tokens for s in self.iterations)


class Server:
    def __init__(self, cfg: ModelConfig, params, *, policy: str = "sarathi",
                 chunk_size: int = 256, n_slots: int = 8,
                 max_len: int = 4096, max_prompt_len: Optional[int] = None,
                 token_budget: Optional[int] = None, dtype=torch.float32,
                 sampling: SamplingParams = SamplingParams(), seed: int = 0,
                 paged: bool = False, block_size: int = 16,
                 n_blocks: Optional[int] = None, watermark: float = 0.0,
                 pp: int = 1, tp: int = 1, sp: bool = False, devices=None,
                 prefix_cache: bool = False, host_blocks: int = 0,
                 preempt_mode: str = "recompute", swap_hw=None,
                 device=None):
        self.cfg = cfg
        self.policy_name = policy
        self.engine, self.scheduler = build_engine_and_scheduler(
            cfg, params, policy=policy, chunk_size=chunk_size,
            n_slots=n_slots, max_len=max_len, max_prompt_len=max_prompt_len,
            token_budget=token_budget, dtype=dtype, sampling=sampling,
            seed=seed, paged=paged, block_size=block_size,
            n_blocks=n_blocks, watermark=watermark, pp=pp, tp=tp, sp=sp,
            devices=devices, prefix_cache=prefix_cache,
            host_blocks=host_blocks, preempt_mode=preempt_mode,
            swap_hw=swap_hw, device=device)

    def run(self, requests: Sequence[Request],
            max_iterations: int = 100_000) -> ServeResult:
        for r in requests:
            self.scheduler.submit(r)
        result = ServeResult(outputs={})

        def admit(req: Request):
            self.engine.add_request(req.req_id, memory=req.memory)

        def release(req: Request):
            self.engine.release(req.req_id)
            result.outputs[req.req_id] = list(req.output)

        kwargs = {}
        if getattr(self.scheduler, "supports_preempt", False):
            kwargs["preempt_hook"] = \
                lambda req: self.engine.release(req.req_id)
        if getattr(self.scheduler, "supports_swap", False):
            def swap_out(req: Request, pairs):
                self.engine.swap_out_blocks(pairs)
                self.engine.release(req.req_id)

            def swap_in(req: Request, pairs):
                self.engine.add_request(req.req_id, memory=req.memory)
                self.engine.swap_in_blocks(pairs)

            kwargs["swap_out_hook"] = swap_out
            kwargs["swap_in_hook"] = swap_in

        it = 0
        n_rejected = 0
        while self.scheduler.has_work and it < max_iterations:
            plan = self.scheduler.next_plan(admit_hook=admit, **kwargs)
            # block-aware rejection (prompt can never fit the pool):
            # terminate with empty output instead of vanishing
            for req in self.scheduler.rejected[n_rejected:]:
                result.outputs[req.req_id] = []
                n_rejected += 1
            if plan is None:
                break
            tokens = self.engine.execute(plan)
            result.iterations.append(IterationStats(
                plan.n_prefill_tokens, plan.n_decode_tokens))
            self.scheduler.on_tokens(tokens, release_hook=release)
            it += 1
        return result
