"""Attention layer blocks of the packed and batched paths.

PyTorch counterparts of the full-attention parts of ``repro.models.blocks``:
parameters are ``nn.Parameter``s under the JAX leaf names (``wq``, ``wk``,
``wv``, ``wo`` and, for qwen2-style models, ``bq``, ``bk``, ``bv``), laid
out ``[in, out]`` and applied as ``x @ w``.

The packed path takes a SARATHI hybrid batch ``x [C + D, d]``: the
projections run once over all tokens, attention splits the chunk and the
decode segments.  The batched path takes ``x [B, L, d]``, row ``b`` at
positions ``start[b] + i``.  KV caches are updated in place.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import common as cm
from repro_torch.models.packed import PackedBatch


class Attention(nn.Module):
    """Q/K/V/O projections of one attention layer."""

    def __init__(self, cfg: ModelConfig, generator, dtype, device):
        super().__init__()
        d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
        def w(shape):
            return cm.param(cm.dense_init(generator, shape, dtype, device))

        def zeros(n):
            return cm.param(torch.zeros((n,), dtype=dtype, device=device))

        self.wq, self.wk = w((d, qd)), w((d, kvd))
        self.wv, self.wo = w((d, kvd)), w((qd, d))
        if cfg.qkv_bias:
            self.bq, self.bk, self.bv = zeros(qd), zeros(kvd), zeros(kvd)


def init_attention(cfg: ModelConfig, generator, dtype, device) -> Attention:
    return Attention(cfg, generator, dtype, device)


def _qkv(cfg, p, x):
    """Project tokens to q/k/v heads.  x [..., d]."""
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if hasattr(p, "bq"):
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    hd = cfg.head_dim
    q = q.reshape(*x.shape[:-1], cfg.n_heads, hd)
    k = k.reshape(*x.shape[:-1], cfg.n_kv_heads, hd)
    v = v.reshape(*x.shape[:-1], cfg.n_kv_heads, hd)
    return q, k, v


def init_attn_cache(cfg: ModelConfig, rows: int, max_len: int, dtype,
                    device) -> Dict:
    shp = (rows, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}


def attn_batched(cfg, p, x, cache, start, *, train: bool):
    """x [B, L, d]; cache rows == B (``{"k", "v"}``, written in place at
    ``start``) or None; start [B] absolute offset per row.  ``train`` (or
    no cache) attends the L tokens among themselves.  Returns (out
    [B, L, d], cache).  The attention is plain torch on every device, as
    the JAX package keeps it plain jnp."""
    B, L, _ = x.shape
    q, k, v = _qkv(cfg, p, x)
    pos = start[:, None] + torch.arange(L, dtype=torch.int32,
                                        device=x.device)[None, :]
    sin, cos = cm.rope_sin_cos(pos, cfg.head_dim, cfg.rope_theta)
    q = cm.apply_rope(q, sin, cos)
    k = cm.apply_rope(k, sin, cos)
    if train or cache is None:
        out = cm.blocked_gqa_attention(q, k, v, pos)
    else:
        if "k" not in cache:
            raise ValueError("forward_batched takes a dense cache "
                             "(init_cache without paged_blocks)")
        ck = cm.write_kv_rows(cache["k"], k, start)
        cv = cm.write_kv_rows(cache["v"], v, start)
        out = cm.blocked_gqa_attention(q, ck, cv, pos)
    return out.reshape(B, L, cfg.q_dim) @ p.wo, cache


def init_paged_attn_cache(cfg: ModelConfig, n_blocks: int, block_size: int,
                          dtype, device) -> Dict:
    """Pooled KV for full-attention layers: ONE fused leaf ``[n_blocks,
    block_size, 2 * nk, hd]`` with K/V head-interleaved (K head ``h`` at
    channel ``2h``, its V at ``2h + 1``), addressed through per-request
    block tables (``repro_torch.cache``).  The key ``pkv`` (vs dense
    ``k``/``v``) marks the layout."""
    shp = (n_blocks, block_size, 2 * cfg.n_kv_heads, cfg.head_dim)
    return {"pkv": torch.zeros(shp, dtype=dtype, device=device)}


def _attn_packed_paged(cfg, p, q, k, v, pos, cache, pk: PackedBatch):
    """Block-table variant of the full-attention packed path: KV written
    through ONE (physical block, offset) scatter of the head-interleaved
    [.., 2nk, hd] rows, read by the paged attention kernels (their plain
    versions on the CPU)."""
    C, D = pk.num_chunk, pk.num_decode
    pool_kv = cache["pkv"]
    bs = pool_kv.shape[1]
    M = pk.chunk_blocks.shape[0]
    outs = []
    if C:
        cpos = pos[:C]
        # padding lanes past max_len must NOT clamp into the table's last
        # (live) block — route them to the reserved scratch block instead
        bidx = cpos // bs
        phys = torch.where(bidx < M,
                           pk.chunk_blocks[bidx.clamp(0, M - 1).long()], 0)
        pool_kv[phys.long(), (cpos % bs).long()] = \
            cm.interleave_kv(k[:C], v[:C])
        outs.append(kops.paged_chunked_prefill_attention(
            q[:C], pool_kv, pk.chunk_blocks, pk.chunk_start))
    if D:
        bidx = (pk.decode_ctx // bs)[:, None].long()
        phys = torch.gather(pk.decode_blocks, 1, bidx)[:, 0]
        pool_kv[phys.long(), (pk.decode_ctx % bs).long()] = \
            cm.interleave_kv(k[C:], v[C:])
        outs.append(kops.paged_decode_attention(
            q[C:], pool_kv, pk.decode_blocks, pk.decode_ctx))
    out = torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]
    return out, cache


def attn_packed(cfg, p, x, cache, pk: PackedBatch):
    """x [T, d] packed hybrid batch -> (out [T, d], cache updated in
    place).  Full attention only: sliding windows are refused by
    ``stack.layer_kinds``.  Neither layout reads a device value on the
    host, so the engine's CUDA graphs capture both."""
    C, D = pk.num_chunk, pk.num_decode
    q, k, v = _qkv(cfg, p, x)
    pos = pk.positions()
    sin, cos = cm.rope_sin_cos(pos, cfg.head_dim, cfg.rope_theta)
    q = cm.apply_rope(q, sin, cos)
    k = cm.apply_rope(k, sin, cos)

    if "pkv" in cache:
        out, cache = _attn_packed_paged(cfg, p, q, k, v, pos, cache, pk)
        return out.reshape(C + D, cfg.q_dim) @ p.wo, cache

    outs = []
    ck, cv = cache["k"], cache["v"]
    S = ck.shape[1]
    if C:
        cm.write_kv_slot(ck, k[:C], pk.chunk_slot, pk.chunk_start)
        cm.write_kv_slot(cv, v[:C], pk.chunk_slot, pk.chunk_start)
        slot = pk.chunk_slot.long().reshape(1)
        mask = cm.causal_cache_mask(pos[None, :C], S)
        outs.append(cm.gqa_attention(q[None, :C], ck.index_select(0, slot),
                                     cv.index_select(0, slot), mask)[0])
    if D:
        cm.write_kv_scatter(ck, k[C:], pk.decode_slots, pk.decode_ctx)
        cm.write_kv_scatter(cv, v[C:], pk.decode_slots, pk.decode_ctx)
        slots = pk.decode_slots.long()
        mask = cm.causal_cache_mask(pk.decode_ctx[:, None], S)
        outs.append(cm.gqa_attention(q[C:, None], ck[slots], cv[slots],
                                     mask)[:, 0])
    out = torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]
    return out.reshape(C + D, cfg.q_dim) @ p.wo, cache
