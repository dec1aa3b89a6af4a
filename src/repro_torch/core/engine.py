"""The SARATHI inference engine (single device, ``tp=1``).

PyTorch counterpart of ``repro.core.engine.Engine``: it owns the model
parameters and the slot-indexed (dense) or block-pooled (paged) KV cache
and runs packed steps of shape ``(C, D)`` (C = chunk size, D = decode
lanes).  An iteration without a prefill chunk runs the decode-only
``(0, D)`` shape; fewer than D decodes pad the decode lanes with scratch
rows (paged: the scratch block 0); a final partial chunk of a prompt is
padded to C and masked by ``chunk_len``.  PyTorch runs eagerly, so where
JAX compiles the two shapes, :meth:`Engine.warmup` runs each once.

With ``paged=True`` the KV lives in a block pool: the engine allocates
blocks lazily per chunk / decode step from a shared
:class:`~repro_torch.cache.BlockManager`, threads the per-request block
tables through the :class:`PackedBatch` and frees blocks on release.  On
a CUDA device the paged attention runs through the hand-written kernels
of ``repro_torch.kernels``; every packed step launches the decode kernel
(the D lanes always exist) and steps with a chunk lane launch the
chunked-prefill kernel.

The cache is updated in place; nothing is donated or copied per step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.cache import BlockManager
from repro_torch.configs.base import ModelConfig
from repro_torch.core.sampling import SamplingParams, sample
from repro_torch.device import resolve_device
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


class Engine:
    """Slot-based SARATHI execution engine on one device (default: the
    CUDA card; ``device="cpu"`` runs the plain PyTorch attention)."""

    def __init__(self, cfg: ModelConfig, params, *, n_slots: int,
                 max_len: int, chunk_size: int, decode_slots: int,
                 dtype=torch.float32,
                 sampling: SamplingParams = SamplingParams(),
                 seed: int = 0, paged: bool = False,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 watermark: float = 0.0, host_blocks: int = 0,
                 block_manager: Optional[BlockManager] = None,
                 tp: int = 1, devices: Optional[Sequence] = None,
                 sp: bool = False, device=None):
        if int(tp) != 1 or devices:
            raise _unported("tp > 1 / devices", "pp/tp/sp")
        if sp:
            raise _unported("sp", "pp/tp/sp")
        if host_blocks:
            raise _unported("host_blocks", "swap")
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
                bm = BlockManager(n_blocks, block_size, watermark=watermark)
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
        self.sampling = sampling
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._free: List[int] = list(range(n_slots))
        self._slot_of: Dict[int, int] = {}
        self.iterations = 0
        # optional observer of every step's logits, called as
        # on_logits(chunk_logits | None, decode_logits | None)
        self.on_logits = None

    @property
    def paged(self) -> bool:
        return self.block_manager is not None

    # ----------------------------------------------------------- requests
    def add_request(self, req_id: int, memory=None) -> int:
        """Assign a cache slot and wipe its rows."""
        if memory is not None or self.model.needs_memory:
            raise _unported("frontend memory", "the other mixers")
        if not self._free:
            raise RuntimeError("no free slots")
        slot = self._free.pop(0)
        self._slot_of[req_id] = slot
        _reset_slot(self.cache, slot)
        return slot

    def release(self, req_id: int):
        slot = self._slot_of.pop(req_id)
        self._free.append(slot)
        if self.block_manager is not None:
            self.block_manager.free(req_id)   # idempotent vs scheduler free

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
        kernels are built and the libraries initialised before a timed
        run, WITHOUT consuming sampling or iteration state.  All writes
        land in the scratch row / scratch block."""
        state, n = self.generator.get_state(), self.iterations
        self._execute_packed(None, [], pad_chunk=True)
        self._execute_packed(None, [])
        self.generator.set_state(state)
        self.iterations = n

    def _pack(self, chunk: Optional[ChunkWork],
              decodes: Sequence[DecodeWork],
              pad_chunk: bool = False) -> PackedBatch:
        """Host-side batch assembly: the static-shape token/slot arrays
        plus (when paged) the per-request block tables, allocating what
        this iteration's writes need.  A chunk-less iteration packs a
        ZERO-width chunk lane (the decode-only shape) unless ``pad_chunk``
        forces the C-wide scratch lane (warmup's hybrid shape)."""
        C_w = self.C if (chunk is not None or pad_chunk) else 0
        ct = np.zeros((C_w,), np.int32)
        if chunk:
            ct[:len(chunk.tokens)] = chunk.tokens
            c_slot = self._slot_of[chunk.req_id]
            c_start = chunk.start
            c_len = len(chunk.tokens)
        else:
            c_slot, c_start, c_len = self.scratch, 0, 0

        dt = np.zeros((self.D,), np.int32)
        ds = np.full((self.D,), self.scratch, np.int32)
        dc = np.zeros((self.D,), np.int32)
        for i, w in enumerate(decodes):
            dt[i] = w.token
            ds[i] = self._slot_of[w.req_id]
            dc[i] = w.ctx

        # block tables: allocate whatever this iteration's writes need;
        # padded entries point at the scratch block 0, so the scratch
        # chunk and unused decode lanes write into ONE reserved block
        M = self.blocks_per_seq
        cb = np.zeros((M,), np.int32)
        db = np.zeros((self.D, M), np.int32)
        if self.paged:
            bm = self.block_manager
            pairs = []
            if chunk:
                bm.ensure(chunk.req_id, chunk.start + len(chunk.tokens))
                pairs += bm.prepare_write(
                    chunk.req_id, chunk.start,
                    chunk.start + len(chunk.tokens))
                cb = bm.padded_table(chunk.req_id, M)
            for i, w in enumerate(decodes):
                bm.ensure(w.req_id, w.ctx + 1)
                pairs += bm.prepare_write(w.req_id, w.ctx, w.ctx + 1)
                db[i] = bm.padded_table(w.req_id, M)
            if pairs:
                # only prefix sharing makes copy-on-write pairs, and the
                # port has no prefix cache: a pair here is a fault
                raise _unported("copy-on-write block forks",
                                "CoW/prefix cache")

        def i32(a):
            return torch.as_tensor(np.asarray(a, np.int32),
                                   device=self.device)

        return PackedBatch(
            chunk_tokens=i32(ct), chunk_slot=i32(c_slot),
            chunk_start=i32(c_start), chunk_len=i32(c_len),
            decode_tokens=i32(dt), decode_slots=i32(ds),
            decode_ctx=i32(dc), chunk_blocks=i32(cb), decode_blocks=i32(db))

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

    def _step(self, pk: PackedBatch):
        """One packed forward + sampling: (chunk token | None, decode
        tokens [D] | None), on the device."""
        with torch.inference_mode():
            chunk_logits, decode_logits, self.cache, _ = \
                self.model.forward_packed(self.params, pk, self.cache)
            if self.on_logits is not None:
                self.on_logits(chunk_logits, decode_logits)
            chunk_tok = (sample(chunk_logits[0], self.generator,
                                self.sampling)
                         if chunk_logits is not None else None)
            dec_tok = (sample(decode_logits, self.generator, self.sampling)
                       if decode_logits is not None else None)
        return chunk_tok, dec_tok

    def _execute_packed(self, chunk: Optional[ChunkWork],
                        decodes: Sequence[DecodeWork],
                        pad_chunk: bool = False) -> Dict[int, int]:
        pk = self._pack(chunk, decodes, pad_chunk)
        chunk_tok, dec_tok = self._step(pk)
        self.iterations += 1
        return self._collect(chunk, decodes, chunk_tok, dec_tok)
