"""Chunked-prefill attention over one dense KV row (THE SARATHI kernel).

A prefill chunk of C queries at positions ``start + i`` attends a KV row
of S positions (the chunk's own KV already written at ``[start,
start + C)``) with the offset-causal mask of the paper's Fig. 6: key ``j``
is visible to query ``i`` iff ``j <= start + i``.  A tensor on the CPU
takes the plain PyTorch version
(:func:`repro_torch.kernels.ref.chunked_prefill_attention_ref`); a tensor
on a CUDA device takes the hand-written kernel ``csrc/dense_attention.cu``
(K1, replacing the JAX package's Pallas ``chunked_prefill_attention``) or
raises.  No model path calls it, as in the JAX package.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.launch import (check_inputs, dtype_code, launches,
                                        launch_status)


def chunked_prefill_attention(q, k, v, start, *, bq: int = 128,
                              bk: int = 128):
    """q [C, nq, hd] — the chunk's queries (positions start + i); k, v
    [S, nk, hd] — the KV row (chunk's KV already written); start — an int
    or an int32 0-dim tensor.  Returns [C, nq, hd].

    C and S must tile by ``bq`` / ``bk``, the JAX entry point's contract
    (its Pallas grid needs it; the CUDA kernel does not, but the API keeps
    it)."""
    C, S = q.shape[0], k.shape[0]
    if C % bq or S % bk:
        raise ValueError(f"C={C} S={S} must tile by (bq={bq}, bk={bk})")
    if q.device.type == "cpu":
        return ref.chunked_prefill_attention_ref(q, k, v, start)
    nq, hd = q.shape[1], q.shape[2]
    nk = k.shape[-2]
    if not isinstance(start, torch.Tensor):
        start = torch.tensor(int(start), dtype=torch.int32, device=q.device)
    check_inputs("chunked_prefill_attention", q, nk,
                 kv={"k": (k, (S, nk, hd)), "v": (v, (S, nk, hd))},
                 ints={"start": (start, ())})
    out = torch.empty_like(q)
    if C == 0:
        return out
    from repro_torch.kernels import build
    lib = build.library("dense_attention")
    rc = lib.chunked_prefill_attention(
        dtype_code(q), hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        start.data_ptr(), out.data_ptr(), C, S, nq, nk,
        1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream)
    launch_status("chunked_prefill_attention", rc)
    launches["chunked_prefill_attention"] += 1
    return out
