"""Batched decode attention over dense KV rows.

One new query token per sequence attends its own KV row, keys at
positions ``<= ctx[b]`` visible (its new KV already written at ``ctx``).
A tensor on the CPU takes the plain PyTorch version
(:func:`repro_torch.kernels.ref.decode_attention_ref`); a tensor on a CUDA
device takes the hand-written kernel ``csrc/dense_attention.cu`` (K2,
replacing the JAX package's Pallas ``decode_attention``) or raises.  No
model path calls it, as in the JAX package.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.launch import (check_inputs, decode_workspace,
                                        dtype_code, launches, launch_status,
                                        sm_count)


def decode_attention(q, k, v, ctx, *, bk: int = 128):
    """q [B, nq, hd] (ONE new token per sequence); k, v [B, S, nk, hd]
    (cache rows, new KV already written at position ctx); ctx [B] int32.
    Returns [B, nq, hd].  S must tile by ``bk``, the JAX entry point's
    contract."""
    S = k.shape[1]
    if S % bk:
        raise ValueError(f"S={S} must tile by bk={bk}")
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, ctx)
    B, nq, hd = q.shape
    nk = k.shape[-2]
    check_inputs("decode_attention", q, nk,
                 kv={"k": (k, (B, S, nk, hd)), "v": (v, (B, S, nk, hd))},
                 ints={"ctx": (ctx, (B,))})
    out = torch.empty_like(q)
    if B == 0:
        return out
    n_split, split_len, ws = decode_workspace(q, nk, S, sm_count(q.device))
    from repro_torch.kernels import build
    lib = build.library("dense_attention")
    rc = lib.decode_attention(
        dtype_code(q), hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        ctx.data_ptr(), out.data_ptr(), ws.data_ptr(), B, S, nq, nk, n_split,
        split_len, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    launch_status("decode_attention", rc)
    launches["decode_attention"] += 1
    return out
