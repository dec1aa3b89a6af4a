"""Plain PyTorch versions of the attention kernels.

The wrappers take these for tensors on the CPU, and ``chip_smoke.py``
holds each CUDA kernel against them on the card.  They run
:func:`repro_torch.models.common.gqa_attention` under the kernel's mask;
the paged ones first gather the request's blocks into dense rows and
de-interleave K/V — the same composition as the JAX package's
``repro.kernels.ref`` oracles.
"""
from __future__ import annotations

import torch

from repro_torch.models import common as cm


def chunked_prefill_attention_ref(q, k, v, start):
    """q [C, nq, hd]; k, v [S, nk, hd]; start scalar (int or 0-dim)."""
    C = q.shape[0]
    S = k.shape[0]
    start = torch.as_tensor(start, dtype=torch.int32, device=q.device)
    q_pos = (start + torch.arange(C, dtype=torch.int32,
                                  device=q.device))[None]
    mask = cm.causal_cache_mask(q_pos, S)
    return cm.gqa_attention(q[None], k[None], v[None], mask)[0]


def decode_attention_ref(q, k, v, ctx):
    """q [B, nq, hd]; k, v [B, S, nk, hd]; ctx [B] (new token's position:
    keys at positions <= ctx are visible)."""
    mask = cm.causal_cache_mask(ctx[:, None].to(torch.int32), k.shape[1])
    return cm.gqa_attention(q[:, None], k, v, mask)[:, 0]


def paged_chunked_prefill_attention_ref(q, pool_kv, block_table, start):
    """q [C, nq, hd]; pool_kv [N, bs, 2*nk, hd] head-interleaved;
    block_table [M]; start scalar."""
    rows_k, rows_v = cm.split_fused_kv(
        cm.gather_block_rows(pool_kv, block_table))
    return chunked_prefill_attention_ref(q, rows_k, rows_v, start)


def paged_decode_attention_ref(q, pool_kv, block_tables, ctx):
    """q [B, nq, hd]; pool_kv [N, bs, 2*nk, hd] head-interleaved;
    block_tables [B, M]; ctx [B]."""
    rows_k, rows_v = cm.split_fused_kv(
        cm.gather_block_rows(pool_kv, block_tables))
    return decode_attention_ref(q, rows_k, rows_v, ctx)
