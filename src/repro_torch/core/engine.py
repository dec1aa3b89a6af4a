"""The SARATHI inference engine (single device, ``tp=1``).

PyTorch counterpart of ``repro.core.engine.Engine``: it owns the model
parameters and the slot-indexed (dense) or block-pooled (paged) KV cache
and runs packed steps of shape ``(C, D)`` (C = chunk size, D = decode
lanes).  An iteration without a prefill chunk runs the decode-only
``(0, D)`` shape; fewer than D decodes pad the decode lanes with scratch
rows (paged: the scratch block 0); a final partial chunk of a prompt is
padded to C and masked by ``chunk_len``.

Where JAX compiles the step into one XLA program per shape
(``jax.jit(self._step_impl)``), the port captures it into one CUDA graph
per shape.  Each shape has static inputs: every :class:`PackedBatch` field
is a view of one device int32 buffer, filled each step from one host
buffer by a single copy.  The first run of a shape is eager (it builds the
kernels and loads the libraries); the graph is captured right after it,
and every later step of that shape copies its ints and replays the graph.
Sampling stays outside the graph, on the graph's static logits.  The two
graphs share one memory pool: they never run at once.  ``graphs=False``
runs the same static-buffer step eagerly (the port's
``jax.disable_jit()``); on the CPU it always runs eagerly.

With ``paged=True`` the KV lives in a block pool: the engine allocates
blocks lazily per chunk / decode step from a shared
:class:`~repro_torch.cache.BlockManager`, threads the per-request block
tables through the :class:`PackedBatch`, copies a block that a write would
change while another table or the prefix cache holds it (copy-on-write)
and frees blocks on release.  On a CUDA device the paged attention runs
through the hand-written kernels of ``repro_torch.kernels``; every packed
step launches the decode kernel (the D lanes always exist) and steps with
a chunk lane launch the chunked-prefill kernel.

The cache is updated in place at fixed addresses; nothing is donated or
copied per step.

``host_blocks > 0`` gives the paged pool a host KV swap tier: the
:class:`BlockManager` keeps the host-slot ledger, and the engine one host
arena per pool leaf (pinned on CUDA) that :meth:`Engine.swap_out_blocks`
and :meth:`Engine.swap_in_blocks` move whole blocks through, writing the
pool in place so that the captured graphs keep reading it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.cache import BlockManager
from repro_torch.configs.base import ModelConfig
from repro_torch.core.sampling import SamplingParams, sample
from repro_torch.device import resolve_device
from repro_torch.kernels.launch import launches
from repro_torch.models import PackedBatch, build_model
from repro_torch.models.registry import Model

# paged block-pool leaves are block-indexed, not slot-indexed: nothing to
# wipe on slot reuse (freed blocks are overwritten before visible, or
# hidden by the context mask)
_POOL_KEYS = frozenset({"pkv"})


def _reset_slot(cache, slot: int) -> None:
    """Zero every slot-indexed cache leaf's row ``slot`` in place (-1 for
    integer leaves); block-pool leaves are skipped."""
    for layer in cache:
        for part in layer.values():
            for key, leaf in part.items():
                if key in _POOL_KEYS:
                    continue
                leaf[slot] = -1 if not leaf.is_floating_point() else 0


def _pool_leaves(cache) -> List[torch.Tensor]:
    """The block-pool leaves of ``cache`` (block axis first), in layer
    order."""
    return [leaf for layer in cache for part in layer.values()
            for key, leaf in part.items() if key in _POOL_KEYS]


def _copy_blocks(cache, src: torch.Tensor, dst: torch.Tensor) -> None:
    """Copy pool-block contents ``src[i] -> dst[i]`` on every paged KV
    leaf, in place (slot-indexed leaves are skipped).  This is the device
    half of a copy-on-write fork: the :class:`BlockManager` swaps a shared
    block out of the writer's table for a fresh one, and this copy makes
    the fork hold the same KV before the write lands."""
    for leaf in _pool_leaves(cache):
        leaf[dst] = leaf[src]


def _slot_runs(slots: Sequence[int]):
    """Split host slots into runs of consecutive slots: yields
    ``(i, first_slot, length)`` with ``slots[i:i + length] ==
    range(first_slot, first_slot + length)``, so that each run moves as
    one contiguous copy."""
    i = 0
    while i < len(slots):
        n = 1
        while i + n < len(slots) and slots[i + n] == slots[i] + n:
            n += 1
        yield i, slots[i], n
        i += n


def _swap_out(cache, arenas: Sequence[torch.Tensor], device: torch.device,
              pairs: Sequence[tuple]) -> None:
    """Copy the pool blocks of ``(device_block, host_slot)`` pairs into
    their host slots, on every pool leaf of ``cache`` (``arenas`` holds
    one arena per leaf, in order); returns once the copies have
    finished."""
    src = torch.tensor([b for b, _ in pairs], dtype=torch.long,
                       device=device)
    runs = list(_slot_runs([s for _, s in pairs]))
    for leaf, arena in zip(_pool_leaves(cache), arenas):
        rows = leaf.index_select(0, src)
        for i, s, n in runs:
            arena[s:s + n].copy_(rows[i:i + n], non_blocking=True)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _swap_in(cache, arenas: Sequence[torch.Tensor], device: torch.device,
             pairs: Sequence[tuple]) -> None:
    """Copy the host slots of ``(host_slot, device_block)`` pairs back
    into their pool blocks, in place, on every pool leaf of ``cache``."""
    dst = torch.tensor([b for _, b in pairs], dtype=torch.long,
                       device=device)
    runs = list(_slot_runs([s for s, _ in pairs]))
    for leaf, arena in zip(_pool_leaves(cache), arenas):
        rows = torch.empty((len(pairs), *leaf.shape[1:]),
                           dtype=leaf.dtype, device=device)
        for i, s, n in runs:
            rows[i:i + n].copy_(arena[s:s + n], non_blocking=True)
        leaf.index_copy_(0, dst, rows)


@dataclass
class ChunkWork:
    req_id: int
    tokens: Sequence[int]       # the chunk's token ids (len <= C)
    start: int                  # tokens already prefilled
    is_last: bool               # final chunk -> sample the first output token


@dataclass
class DecodeWork:
    req_id: int
    token: int                  # last generated (or last prompt) token
    ctx: int                    # current context length


class IterationPlan:
    """One engine iteration, as constructed by a scheduler policy: prefill
    chunks (the single-chunk policies put at most one) plus piggybacked
    decodes."""

    def __init__(self, chunk: Optional[ChunkWork] = None,
                 decodes: Optional[List[DecodeWork]] = None,
                 chunks: Optional[Sequence[ChunkWork]] = None):
        if chunk is not None and chunks:
            raise ValueError("pass either chunk= or chunks=, not both")
        self.chunks: List[ChunkWork] = (
            list(chunks) if chunks else ([chunk] if chunk is not None else []))
        self.decodes: List[DecodeWork] = list(decodes) if decodes else []

    @property
    def chunk(self) -> Optional[ChunkWork]:
        """The plan's first (for the original policies: only) chunk."""
        return self.chunks[0] if self.chunks else None

    @chunk.setter
    def chunk(self, work: Optional[ChunkWork]):
        self.chunks = [work] if work is not None else []

    @property
    def n_prefill_tokens(self) -> int:
        return sum(len(c.tokens) for c in self.chunks)

    @property
    def n_decode_tokens(self) -> int:
        return len(self.decodes)

    def __repr__(self) -> str:                       # pragma: no cover
        return (f"IterationPlan(chunks={self.chunks!r}, "
                f"decodes={self.decodes!r})")


def _unported(name: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{name} is not ported yet (ROADMAP Queue 1: "
                               f"{item})")


class _StepShape:
    """The static inputs of one packed-step shape ``(C_w, D)``.

    Every :class:`PackedBatch` field is a view of ONE device int32 buffer
    (each field 16-byte aligned), filled from ONE host buffer (pinned on
    CUDA) by one copy a step.  ``fields`` are numpy views of the host
    buffer.  With graphs on, the shape also holds its captured graph, the
    graph's static logits and the kernel launches one replay makes."""

    def __init__(self, C_w: int, D: int, M: int, device: torch.device):
        shapes = {"chunk_tokens": (C_w,), "chunk_slot": (),
                  "chunk_start": (), "chunk_len": (), "decode_tokens": (D,),
                  "decode_slots": (D,), "decode_ctx": (D,),
                  "chunk_blocks": (M,), "decode_blocks": (D, M)}
        spans, n = {}, 0
        for name, shp in shapes.items():
            spans[name] = (n, math.prod(shp), shp)
            n += -(-max(math.prod(shp), 1) // 4) * 4
        cuda = device.type == "cuda"
        self.host = torch.zeros((n,), dtype=torch.int32, pin_memory=cuda)
        self.buf = torch.zeros((n,), dtype=torch.int32, device=device)
        host = self.host.numpy()
        self.fields = {k: host[o:o + size].reshape(shp)
                       for k, (o, size, shp) in spans.items()}
        self.pk = PackedBatch(**{k: self.buf[o:o + size].view(shp)
                                 for k, (o, size, shp) in spans.items()})
        # marks the last copy out of ``host``, which must land before the
        # host buffer is written again
        self.copied = torch.cuda.Event() if cuda else None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Tuple = (None, None)
        self.launches: Dict[str, int] = {}


class Engine:
    """Slot-based SARATHI execution engine on one device (default: the
    CUDA card; ``device="cpu"`` runs the plain PyTorch attention).  On a
    CUDA device each step shape replays a captured CUDA graph;
    ``graphs=False`` runs the same step eagerly instead, so that the two
    can be held against each other."""

    def __init__(self, cfg: ModelConfig, params, *, n_slots: int,
                 max_len: int, chunk_size: int, decode_slots: int,
                 dtype=torch.float32,
                 sampling: SamplingParams = SamplingParams(),
                 seed: int = 0, paged: bool = False,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 watermark: float = 0.0, host_blocks: int = 0,
                 block_manager: Optional[BlockManager] = None,
                 tp: int = 1, devices: Optional[Sequence] = None,
                 sp: bool = False, device=None, graphs: bool = True):
        if int(tp) != 1 or devices:
            raise _unported("tp > 1 / devices", "tp/sp")
        if sp:
            raise _unported("sp", "tp/sp")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model: Model = build_model(cfg)
        weights_on = next(params.parameters()).device
        if weights_on.type != self.device.type:
            raise ValueError(f"params are on {weights_on}, the engine on "
                             f"{self.device}: make them there (init_params"
                             f"/from_jax_tree take device=)")
        self.params = params
        self.dtype = dtype
        self.C = int(chunk_size)
        self.D = int(decode_slots)
        self.n_slots = int(n_slots)
        self.max_len = int(max_len)
        self.scratch = n_slots                    # extra scratch row
        self.block_manager: Optional[BlockManager] = None
        if paged or block_manager is not None:
            bm = block_manager
            if bm is None:
                if max_len % block_size:
                    raise ValueError(f"max_len={max_len} must be a "
                                     f"multiple of block_size={block_size}")
                if n_blocks is None:
                    # same token capacity as the dense rows it replaces,
                    # minus the max_len-long scratch row (now ONE block)
                    n_blocks = n_slots * (max_len // block_size) + 1
                bm = BlockManager(n_blocks, block_size,
                                  watermark=watermark,
                                  host_blocks=host_blocks)
            if max_len % bm.block_size:
                raise ValueError("max_len must tile by the block size")
            self.block_manager = bm
            self.blocks_per_seq = max_len // bm.block_size
            self.cache = self.model.init_cache(
                n_slots + 1, max_len, dtype, paged_blocks=bm.n_blocks,
                block_size=bm.block_size, device=self.device)
        else:
            self.blocks_per_seq = 0
            self.cache = self.model.init_cache(n_slots + 1, max_len, dtype,
                                               device=self.device)
        self._host_pool = self._make_host_pool()
        self.sampling = sampling
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._free: List[int] = list(range(n_slots))
        self._slot_of: Dict[int, int] = {}
        self.iterations = 0
        # optional observer of every step's logits, called as
        # on_logits(chunk_logits | None, decode_logits | None); with
        # graphs these are the graph's static logits, valid until the
        # next step
        self.on_logits = None
        self.graphs = bool(graphs) and self.device.type == "cuda"
        self._shapes: Dict[int, _StepShape] = {}   # by chunk lane width
        self._pool = None                           # the graphs' one pool

    @property
    def paged(self) -> bool:
        return self.block_manager is not None

    def activation_bytes_per_iteration(self) -> int:
        """Residual-stream footprint of one packed hybrid step: the two
        ``[C + D, d_model]`` norm+residual boundary activations per layer
        (the JAX engine's measured counterpart of
        ``sim.cost_model.sp_activation_bytes``, at ``tp=1`` without
        sequence parallelism, the only case the port runs)."""
        return (2 * self.cfg.n_layers * (self.C + self.D)
                * self.cfg.d_model * self.dtype.itemsize)

    # ----------------------------------------------------------- requests
    def add_request(self, req_id: int, memory=None) -> int:
        """Assign a cache slot and wipe its rows."""
        if memory is not None or self.model.needs_memory:
            raise _unported("frontend memory", "the other mixers")
        if not self._free:
            raise RuntimeError("no free slots")
        slot = self._free.pop(0)
        self._slot_of[req_id] = slot
        self._wipe_slot(slot)
        return slot

    def _wipe_slot(self, slot: int):
        _reset_slot(self.cache, slot)

    def release(self, req_id: int):
        slot = self._slot_of.pop(req_id)
        self._free.append(slot)
        if self.block_manager is not None:
            self.block_manager.free(req_id)   # idempotent vs scheduler free

    def extract_request(self, req_id: int):
        raise _unported("extract_request", "disagg")

    def install_request(self, req_id: int, handoff):
        raise _unported("install_request", "disagg")

    # --------------------------------------------------------------- step
    def execute(self, plan: IterationPlan) -> Dict[int, int]:
        """Run one iteration; returns {req_id: newly sampled token} for the
        requests that produced a token this iteration.  A multi-chunk plan
        runs as consecutive packed sub-steps — the first carries all
        piggybacked decodes, the rest are chunk-only."""
        if len(plan.decodes) > self.D:
            raise ValueError(f"plan has {len(plan.decodes)} decodes > "
                             f"D={self.D}")
        for c in plan.chunks:
            if len(c.tokens) > self.C:
                raise ValueError("chunk longer than engine chunk size")

        out: Dict[int, int] = {}
        chunks: List[Optional[ChunkWork]] = list(plan.chunks) or [None]
        for i, chunk in enumerate(chunks):
            out.update(self._execute_packed(
                chunk, plan.decodes if i == 0 else []))
        return out

    def warmup(self):
        """Run both packed-step shapes once — the hybrid ``(C, D)`` step on
        a scratch chunk lane and the decode-only ``(0, D)`` step — so the
        kernels are built, the libraries initialised and (on CUDA, with
        graphs) both graphs captured before a timed run, WITHOUT consuming
        sampling or iteration state.  All writes land in the scratch row /
        scratch block."""
        state, n = self.generator.get_state(), self.iterations
        self._execute_packed(None, [], pad_chunk=True)
        self._execute_packed(None, [])
        self.generator.set_state(state)
        self.iterations = n

    # ------------------------------------------------------------- KV swap
    def _make_host_pool(self) -> List[torch.Tensor]:
        """One host arena per pool leaf, ``[n_host_slots, *block_shape]``,
        pinned on CUDA so that the swap copies are DMA transfers.  Unlike
        the JAX package's lazy numpy arena it is built with the engine, so
        that a swap's clock charge holds only the copy.  Empty without a
        host tier."""
        bm = self.block_manager
        if bm is None or not bm.n_host_slots:
            return []
        pin = self.device.type == "cuda"
        return [torch.empty((bm.n_host_slots, *leaf.shape[1:]),
                            dtype=leaf.dtype, pin_memory=pin)
                for leaf in _pool_leaves(self.cache)]

    def swap_out_blocks(self, pairs: Sequence[tuple]):
        """Device->host move for :meth:`BlockManager.swap_out` pairs
        ``(device_block, host_slot)``: each named block's KV lands in its
        host slot on every layer.  Returns once the copies have finished:
        the manager may hand those blocks to another request in the same
        plan."""
        if pairs:
            _swap_out(self.cache, self._host_pool, self.device, pairs)

    def swap_in_blocks(self, pairs: Sequence[tuple]):
        """Host->device move for :meth:`BlockManager.swap_in` pairs
        ``(host_slot, device_block)``, before the resumed request's next
        chunk: restores the exact KV bytes swapped out, so greedy outputs
        are bit-identical to never having been preempted.  The pool is
        written in place on the current stream (the JAX package returns a
        new cache tree instead); the captured graphs hold its addresses."""
        if pairs:
            _swap_in(self.cache, self._host_pool, self.device, pairs)

    # ------------------------------------------------------ packed steps
    def _pack(self, chunk: Optional[ChunkWork],
              decodes: Sequence[DecodeWork],
              pad_chunk: bool = False) -> _StepShape:
        """Host-side batch assembly into the shape's static inputs: the
        token/slot ints plus (when paged) the per-request block tables,
        allocating what this iteration's writes need and running the
        copy-on-write copies they call for.  A chunk-less iteration packs a
        ZERO-width chunk lane (the decode-only shape) unless ``pad_chunk``
        forces the C-wide scratch lane (warmup's hybrid shape).

        Every field is written in full: unused decode lanes go back to the
        scratch slot with ``ctx`` 0 and a table of block 0, and the whole
        padded tables are rewritten, so nothing of an earlier step (a
        stale lane or table entry would write into a live block) survives
        into a replay."""
        C_w = self.C if (chunk is not None or pad_chunk) else 0
        if C_w not in self._shapes:
            self._shapes[C_w] = _StepShape(C_w, self.D, self.blocks_per_seq,
                                           self.device)
        shape = self._shapes[C_w]
        if shape.copied is not None:
            # the host buffer still feeds this shape's last copy until it
            # lands; that step's dec_tok.tolist() has synchronised since,
            # so this returns at once
            shape.copied.synchronize()
        f = shape.fields
        f["chunk_tokens"][:] = 0
        if chunk:
            f["chunk_tokens"][:len(chunk.tokens)] = chunk.tokens
            f["chunk_slot"][...] = self._slot_of[chunk.req_id]
            f["chunk_start"][...] = chunk.start
            f["chunk_len"][...] = len(chunk.tokens)
        else:
            f["chunk_slot"][...] = self.scratch
            f["chunk_start"][...] = 0
            f["chunk_len"][...] = 0
        f["decode_tokens"][:] = 0
        f["decode_slots"][:] = self.scratch
        f["decode_ctx"][:] = 0
        for i, w in enumerate(decodes):
            f["decode_tokens"][i] = w.token
            f["decode_slots"][i] = self._slot_of[w.req_id]
            f["decode_ctx"][i] = w.ctx

        # block tables: allocate whatever this iteration's writes need;
        # padded entries point at the scratch block 0, so the scratch
        # chunk and unused decode lanes write into ONE reserved block
        f["chunk_blocks"][:] = 0
        f["decode_blocks"][:] = 0
        if self.paged:
            bm, M = self.block_manager, self.blocks_per_seq
            # copy-on-write: any write landing in a block this request
            # does not exclusively own (prefix-shared) forks it first;
            # tables are read AFTER prepare_write so they list the forks
            pairs = []
            if chunk:
                bm.ensure(chunk.req_id, chunk.start + len(chunk.tokens))
                pairs += bm.prepare_write(
                    chunk.req_id, chunk.start,
                    chunk.start + len(chunk.tokens))
                f["chunk_blocks"][:] = bm.padded_table(chunk.req_id, M)
            for i, w in enumerate(decodes):
                bm.ensure(w.req_id, w.ctx + 1)
                pairs += bm.prepare_write(w.req_id, w.ctx, w.ctx + 1)
                f["decode_blocks"][i] = bm.padded_table(w.req_id, M)
            if pairs:
                self._apply_cow(pairs)
        shape.buf.copy_(shape.host, non_blocking=True)
        if shape.copied is not None:
            shape.copied.record()
        return shape

    def _apply_cow(self, pairs: Sequence[tuple]):
        """Run the copy-on-write block copies on the device, eagerly on the
        current stream, before the step whose writes they protect.  (JAX
        pads the pairs to a power of two to bound its jit's shapes; an
        eager copy needs no padding.)"""
        src, dst = torch.tensor(pairs, dtype=torch.long,
                                device=self.device).T
        _copy_blocks(self.cache, src, dst)

    @staticmethod
    def _collect(chunk: Optional[ChunkWork], decodes: Sequence[DecodeWork],
                 chunk_tok, dec_tok) -> Dict[int, int]:
        out: Dict[int, int] = {}
        if chunk and chunk.is_last and chunk_tok is not None:
            out[chunk.req_id] = int(chunk_tok)
        if dec_tok is not None:
            dec = dec_tok.tolist()
            for i, w in enumerate(decodes):
                out[w.req_id] = int(dec[i])
        return out

    def _forward(self, shape: _StepShape):
        """The packed forward on the shape's static inputs: (chunk logits
        [1, V] | None, decode logits [D, V] | None)."""
        chunk_logits, decode_logits, _, _ = self.model.forward_packed(
            self.params, shape.pk, self.cache)
        return chunk_logits, decode_logits

    def _capture(self, shape: _StepShape):
        """Record the shape's packed forward into a CUDA graph, after an
        eager run of it has built the kernels and loaded the libraries.
        The wrappers count their launches in Python, which runs only
        here: the counts this capture adds are what one replay launches,
        so they are taken back off now and added at every replay."""
        before = dict(launches)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            logits = self._forward(shape)
        shape.launches = {k: launches[k] - n for k, n in before.items()}
        launches.update(before)
        shape.graph, shape.logits = graph, logits

    def _run(self, shape: _StepShape):
        """Replay the shape's graph, or run the step eagerly (the shape's
        first run, ``graphs=False``, the CPU); returns the logits."""
        if shape.graph is not None:
            shape.graph.replay()
            for name, n in shape.launches.items():
                launches[name] += n
            return shape.logits
        logits = self._forward(shape)
        if self.graphs:
            self._capture(shape)
        return logits

    def _execute_packed(self, chunk: Optional[ChunkWork],
                        decodes: Sequence[DecodeWork],
                        pad_chunk: bool = False) -> Dict[int, int]:
        with torch.inference_mode():
            shape = self._pack(chunk, decodes, pad_chunk)
            chunk_logits, decode_logits = self._run(shape)
            return self._sample(chunk, decodes, chunk_logits,
                                decode_logits)

    def _sample(self, chunk: Optional[ChunkWork],
                decodes: Sequence[DecodeWork], chunk_logits,
                decode_logits) -> Dict[int, int]:
        """Show the step's logits to ``on_logits``, sample its tokens and
        count the sub-step.  Sampling stays outside the graphs: the
        generator advances exactly as in the eager step, and capture
        consumes none of it."""
        if self.on_logits is not None:
            self.on_logits(chunk_logits, decode_logits)
        chunk_tok = (sample(chunk_logits[0], self.generator, self.sampling)
                     if chunk_logits is not None else None)
        dec_tok = (sample(decode_logits, self.generator, self.sampling)
                   if decode_logits is not None else None)
        self.iterations += 1
        return self._collect(chunk, decodes, chunk_tok, dec_tok)
