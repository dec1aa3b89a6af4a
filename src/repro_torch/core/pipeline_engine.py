"""Pipeline-parallel SARATHI execution engine (paper §5.3, operational).

PyTorch counterpart of ``repro.core.pipeline_engine``.  The simulator
(``repro_torch.sim.pipeline``) *predicts* that uniform decode-maximal
micro-batches shrink pipeline bubbles; this engine *executes* that
schedule.  The layer stack is cut into ``pp`` stages
(:mod:`repro_torch.launch.pipeline`), each stage owns its slice of the KV
cache (dense rows or paged pools) on its own device, and every packed
sub-step of an :class:`IterationPlan` flows through the stages as one
micro-batch.

Contract: drop-in for :class:`~repro_torch.core.engine.Engine` —
``add_request`` / ``release`` / ``execute(plan)`` / ``warmup`` behave the
same, and the tokens are bit-identical to the single engine's on the same
plans, greedy or sampled: the stages slice the layer loop without
changing a layer, and sampling runs after the last stage on the engine's
one generator, as in ``Engine``.

On CUDA each step shape, ``(C, D)`` and ``(0, D)``, gets ``pp`` captured
graphs, one a stage, in one graph pool a card.  A shape's first run is
eager; right after it each stage is captured reading the *captured*
static output of the stage before it (the eager outputs are throwaway
tensors), and every later step replays the stages in order.  The stages
share the shape's static step inputs when they share its device; a stage
on another device gets its own copy of them, filled each step.

Timing: the stages run one after another in-process (one micro-batch at a
time), which is result-equivalent to overlapped execution because the
micro-batches in flight touch disjoint requests (the serving loop locks a
request while its micro-batch is in flight).  Each stage is timed on the
host clock: the activation hop onto its device (a copy into its static
input, only when the devices differ), its replay and a synchronize of
its device.  :meth:`PipelineEngine.execute_timed` hands the per-stage
times to the serving loop, which rebuilds stage occupancy and bubbles on
a virtual pipeline clock (:class:`~repro_torch.serving.metrics.
PipelineStats`).  Stages that share one card do not overlap on it: the
bubbles are those of the virtual clock over the measured stage times.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.cache import BlockManager
from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import (ChunkWork, DecodeWork, Engine,
                                     IterationPlan, _copy_blocks,
                                     _pool_leaves, _reset_slot, _StepShape,
                                     _swap_in, _swap_out, _unported)
from repro_torch.core.sampling import SamplingParams
from repro_torch.kernels.launch import launches
from repro_torch.launch import pipeline as pl


class _StageSteps:
    """The per-stage side of one step shape: each stage's
    :class:`PackedBatch` (the shape's static inputs, or their copy on the
    stage's device), and with graphs each stage's captured graph, its
    static input (a hop buffer, only where the stage before it is on
    another device), its static output and the launches one replay
    makes."""

    def __init__(self, pp: int):
        self.pk: List = [None] * pp
        self.copies: List[_StepShape] = []     # static inputs elsewhere
        self.graphs: List[Optional[torch.cuda.CUDAGraph]] = [None] * pp
        self.inputs: List[Optional[torch.Tensor]] = [None] * pp
        self.outputs: List = [None] * pp
        self.launches: List[Dict[str, int]] = [{} for _ in range(pp)]


class PipelineEngine(Engine):
    """:class:`Engine` over a ``pp``-stage partition of the layer stack,
    one device per stage (``devices``; default every visible CUDA card,
    round-robin; on the CPU, the engine's ``device``).  ``tp`` and ``sp``
    keep the JAX signature and raise unless left at their defaults."""

    def __init__(self, cfg: ModelConfig, params, *, pp: int, n_slots: int,
                 max_len: int, chunk_size: int, decode_slots: int,
                 dtype=torch.float32,
                 sampling: SamplingParams = SamplingParams(),
                 seed: int = 0, paged: bool = False,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 watermark: float = 0.0, host_blocks: int = 0,
                 block_manager: Optional[BlockManager] = None,
                 tp: int = 1, devices: Optional[Sequence] = None,
                 sp: bool = False, device=None, graphs: bool = True):
        if int(tp) != 1:
            raise _unported("PipelineEngine(tp > 1)", "tp/sp")
        if sp:
            raise _unported("PipelineEngine(sp)", "tp/sp")
        super().__init__(cfg, params, n_slots=n_slots, max_len=max_len,
                         chunk_size=chunk_size, decode_slots=decode_slots,
                         dtype=dtype, sampling=sampling, seed=seed,
                         paged=paged, block_size=block_size,
                         n_blocks=n_blocks, watermark=watermark,
                         host_blocks=host_blocks,
                         block_manager=block_manager, device=device,
                         graphs=graphs)
        self.pp = int(pp)
        if devices is None and self.device.type != "cuda":
            devices = [self.device]
        self.devices = pl.stage_devices(self.pp, devices)
        if any(d.type != self.device.type for d in self.devices):
            raise ValueError(f"stage devices {self.devices} are not all "
                             f"{self.device.type} devices, as the engine")
        self.stage_params = pl.place_stages(
            pl.stage_params(cfg, params, self.pp), self.devices)
        self.stage_caches = pl.place_stages(
            pl.stage_cache(cfg, self.cache, self.pp), self.devices)
        # Engine.__init__ built one host arena per pool leaf, in layer
        # order; each stage swaps through its own leaves' arenas
        self._stage_arenas: List[List[torch.Tensor]] = []
        i = 0
        for c in self.stage_caches:
            n = len(_pool_leaves(c)) if self._host_pool else 0
            self._stage_arenas.append(self._host_pool[i:i + n])
            i += n
        # the monolithic cache list was the source of the stage slices
        # (the same dicts); every cache operation now goes by stage
        self.cache = None
        self._stages: Dict[int, _StageSteps] = {}    # by chunk lane width
        self._pools: Dict[int, Tuple] = {}   # by card: (pool, stream)
        self._durs = [0.0] * self.pp     # per-stage seconds of the last
        #                                  execute() call

    # ------------------------------------------------- engine overrides
    def _wipe_slot(self, slot: int):
        for c in self.stage_caches:
            _reset_slot(c, slot)

    def _apply_cow(self, pairs: Sequence[tuple]):
        # one engine-wide block id space: every stage's pool forks the
        # same (src, dst) pairs on its own cache slice
        for c, dev in zip(self.stage_caches, self.devices):
            src, dst = torch.tensor(pairs, dtype=torch.long, device=dev).T
            _copy_blocks(c, src, dst)

    def swap_out_blocks(self, pairs: Sequence[tuple]):
        """:meth:`Engine.swap_out_blocks` on every stage's pool slice,
        each through its own leaves' host arenas."""
        if pairs:
            for c, a, dev in zip(self.stage_caches, self._stage_arenas,
                                 self.devices):
                _swap_out(c, a, dev, pairs)

    def swap_in_blocks(self, pairs: Sequence[tuple]):
        """:meth:`Engine.swap_in_blocks` on every stage's pool slice, in
        place (the stage graphs hold the pool's addresses)."""
        if pairs:
            for c, a, dev in zip(self.stage_caches, self._stage_arenas,
                                 self.devices):
                _swap_in(c, a, dev, pairs)

    # ------------------------------------------------------ stage steps
    def _stage_forward(self, s: int, pk, x):
        out, _, _ = self.model.forward_packed_stage(
            self.stage_params[s], pk, self.stage_caches[s], x,
            first=s == 0, last=s == self.pp - 1)
        return out

    def _stage_steps(self, shape: _StepShape) -> _StageSteps:
        C_w = shape.pk.num_chunk
        st = self._stages.get(C_w)
        if st is None:
            st = self._stages[C_w] = _StageSteps(self.pp)
            elsewhere: Dict[str, _StepShape] = {}
            for s, dev in enumerate(self.devices):
                if pl.same_device(dev, self.device):
                    st.pk[s] = shape.pk
                    continue
                if str(dev) not in elsewhere:
                    elsewhere[str(dev)] = _StepShape(
                        C_w, self.D, self.blocks_per_seq, dev)
                st.pk[s] = elsewhere[str(dev)].pk
            st.copies = list(elsewhere.values())
        return st

    def _pool_for(self, dev: torch.device):
        """The graph pool and capture stream of ``dev``'s card: one each a
        card (``torch.cuda.graph``'s own default stream lives on the card
        that was current at its first use)."""
        key = torch.cuda.current_device() if dev.index is None \
            else dev.index
        if key not in self._pools:
            with torch.cuda.device(dev):
                self._pools[key] = (torch.cuda.graph_pool_handle(),
                                    torch.cuda.Stream())
        return self._pools[key]

    def _capture_stages(self, st: _StageSteps):
        """Record each stage into its graph, after an eager run of the
        shape: stage ``s + 1`` reads stage ``s``'s captured static output
        (or a hop buffer on its own device that the replay fills from
        it).  As in :meth:`Engine._capture`, the launch counts a capture
        adds are taken back off and added at every replay."""
        x = None
        for s, dev in enumerate(self.devices):
            if s:
                prev = st.outputs[s - 1]
                if pl.same_device(prev.device, dev):
                    x = prev
                else:
                    x = st.inputs[s] = torch.empty_like(prev, device=dev)
            before = dict(launches)
            graph = torch.cuda.CUDAGraph()
            pool, stream = self._pool_for(dev)
            with torch.cuda.device(dev):
                with torch.cuda.graph(graph, pool=pool, stream=stream):
                    out = self._stage_forward(s, st.pk[s], x)
            st.launches[s] = {k: launches[k] - n for k, n in before.items()}
            launches.update(before)
            st.graphs[s], st.outputs[s] = graph, out

    def _execute_packed(self, chunk: Optional[ChunkWork],
                        decodes: Sequence[DecodeWork],
                        pad_chunk: bool = False) -> Dict[int, int]:
        with torch.inference_mode():
            shape = self._pack(chunk, decodes, pad_chunk)
            st = self._stage_steps(shape)
            for copy in st.copies:
                # blocking: the host buffer is rewritten by the next step
                copy.buf.copy_(shape.host)
            captured = st.graphs[-1] is not None
            x = None
            for s, dev in enumerate(self.devices):
                t0 = time.perf_counter()
                if captured:
                    if st.inputs[s] is not None:          # the hop
                        st.inputs[s].copy_(st.outputs[s - 1])
                    st.graphs[s].replay()
                    for name, n in st.launches[s].items():
                        launches[name] += n
                    x = st.outputs[s]
                else:
                    if s:
                        x = x.to(dev)                     # the hop
                    # the kernels launch on the current card's stream
                    with (torch.cuda.device(dev) if dev.type == "cuda"
                          else contextlib.nullcontext()):
                        x = self._stage_forward(s, st.pk[s], x)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                self._durs[s] += time.perf_counter() - t0
            if not captured and self.graphs:
                self._capture_stages(st)
            logits = x
            if not pl.same_device(self.devices[-1], self.device):
                # sample on the engine's generator, as the single engine
                logits = tuple(None if t is None else t.to(self.device)
                               for t in logits)
            return self._sample(chunk, decodes, *logits)

    def execute(self, plan: IterationPlan) -> Dict[int, int]:
        self._durs = [0.0] * self.pp
        return super().execute(plan)

    def execute_timed(self, plan: IterationPlan) \
            -> Tuple[Dict[int, int], List[float]]:
        """Run one iteration; returns ``(tokens, stage_durations)`` where
        ``stage_durations[s]`` is the measured wall time stage ``s`` spent
        on this plan (summed over the plan's packed sub-steps): the
        micro-batch service times the pipelined serving loop's virtual
        clock consumes."""
        out = self.execute(plan)
        return out, list(self._durs)
