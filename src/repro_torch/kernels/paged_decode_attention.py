"""Batched decode attention over the fused paged KV pool.

A tensor on the CPU takes the plain PyTorch version
(:func:`repro_torch.kernels.ref.paged_decode_attention_ref`); a tensor on
a CUDA device takes the hand-written kernel ``csrc/paged_attention.cu``
(K4, replacing the JAX package's Pallas ``paged_decode_attention``) or
raises.  There is no fallback from one to the other.  The kernel splits
each row's keys across blocks (:func:`repro_torch.kernels.launch.
decode_split`, from the table's capacity, never from ``ctx``) and sums the
splits' partials in a second kernel on the same stream.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.launch import (check_inputs, decode_workspace,
                                        dtype_code, launches, launch_status,
                                        sm_count)


def paged_decode_attention(q, pool_kv, block_tables, ctx):
    """q [B, nq, hd] (ONE new token per sequence); pool_kv [n_blocks,
    block_size, 2 * nk, hd] head-interleaved (new KV already written at
    logical position ctx); block_tables [B, M] int32 physical block ids
    (scratch-padded); ctx [B] int32.  Returns [B, nq, hd]."""
    if q.device.type == "cpu":
        return ref.paged_decode_attention_ref(q, pool_kv, block_tables, ctx)
    B, nq, hd = q.shape
    N, bs, nk = pool_kv.shape[0], pool_kv.shape[1], pool_kv.shape[-2] // 2
    M = block_tables.shape[-1]
    check_inputs("paged_decode_attention", q, nk,
                 kv={"pool_kv": (pool_kv, (N, bs, 2 * nk, hd))},
                 ints={"block_tables": (block_tables, (B, M)),
                       "ctx": (ctx, (B,))})
    out = torch.empty_like(q)
    if B == 0:
        return out
    n_split, split_len, ws = decode_workspace(q, nk, M * bs,
                                              sm_count(q.device))
    from repro_torch.kernels import build
    lib = build.library("paged_attention")
    rc = lib.paged_decode_attention(
        dtype_code(q), hd, q.data_ptr(), pool_kv.data_ptr(),
        block_tables.data_ptr(), ctx.data_ptr(), out.data_ptr(),
        ws.data_ptr(), B, nq, nk, bs, M, n_split, split_len,
        1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream)
    launch_status("paged_decode_attention", rc)
    launches["paged_decode_attention"] += 1
    return out
