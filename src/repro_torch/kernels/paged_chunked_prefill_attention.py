"""Chunked-prefill attention over the fused paged KV pool.

SARATHI's offset-causal chunk attention: chunk query ``i`` (absolute
position ``start + i``) sees logical key ``j`` iff ``j <= start + i``,
reading the request's KV through its block table.  A tensor on the CPU
takes the plain PyTorch version
(:func:`repro_torch.kernels.ref.paged_chunked_prefill_attention_ref`); a
tensor on a CUDA device takes the hand-written kernel
``csrc/paged_attention.cu`` (K3, replacing the JAX package's Pallas
``paged_chunked_prefill_attention``) or raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.launch import (check_inputs, dtype_code, launches,
                                        launch_status)


def paged_chunked_prefill_attention(q, pool_kv, block_table, start):
    """q [C, nq, hd] — the chunk's queries (positions start + i); pool_kv
    [n_blocks, block_size, 2 * nk, hd] — the fused pool, the chunk's own
    KV already written through the table; block_table [M] int32 physical
    block ids (scratch-padded); start — int32 0-dim tensor on q's device
    (an int on the CPU).  Returns [C, nq, hd].  Any C works: the kernel
    masks a ragged last tile of rows."""
    if q.device.type == "cpu":
        return ref.paged_chunked_prefill_attention_ref(q, pool_kv,
                                                       block_table, start)
    C, nq, hd = q.shape
    N, bs, nk = pool_kv.shape[0], pool_kv.shape[1], pool_kv.shape[-2] // 2
    M = block_table.shape[0]
    check_inputs("paged_chunked_prefill_attention", q, nk,
                 kv={"pool_kv": (pool_kv, (N, bs, 2 * nk, hd))},
                 ints={"block_table": (block_table, (M,)),
                       "start": (start, ())})
    out = torch.empty_like(q)
    if C == 0:
        return out
    from repro_torch.kernels import build
    lib = build.library("paged_attention")
    rc = lib.paged_chunked_prefill_attention(
        dtype_code(q), hd, q.data_ptr(), pool_kv.data_ptr(),
        block_table.data_ptr(), start.data_ptr(), out.data_ptr(),
        C, nq, nk, bs, M, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    launch_status("paged_chunked_prefill_attention", rc)
    launches["paged_chunked_prefill_attention"] += 1
    return out
