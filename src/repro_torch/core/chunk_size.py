"""Ideal chunk-size selection (paper §4.4), adapted to the TPU MXU.

Two-fold decision exactly as the paper prescribes:

1. pick a *target* token budget per hybrid batch from the desired prefill
   efficiency / P:D trade-off, and
2. quantize so the FUSED matmul M-dimension (chunk + piggybacked decodes)
   is a multiple of the hardware tile.  On GPU that's the thread-block tile
   (128 in the paper's experiments, Fig. 7); on TPU it's the 128x128 MXU
   systolic array — the same rule with the same constant, but for a
   different architectural reason (lane padding in the systolic array).

So for tile T, decode slots D:   C = round_to_multiple(C_target + D, T) - D.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

MXU_TILE = 128


def quantized_chunk_size(target: int, n_decodes: int,
                         tile: int = MXU_TILE) -> int:
    """Largest C <= target(ish) with (C + n_decodes) % tile == 0
    (paper §4.4: 'the prefill chunk size should be 256 - (B - 1)')."""
    total = max(tile, round((target + n_decodes) / tile) * tile)
    c = total - n_decodes
    if c <= 0:
        c = tile - (n_decodes % tile)
        if c <= 0:
            c = tile
    return c


def optimal_pd_ratio(chunk_size: int, batch_size: int) -> float:
    """P:D at which decodes perfectly piggyback: P:D = C/(B-1) (§5.1.3)."""
    if batch_size <= 1:
        return math.inf
    return chunk_size / (batch_size - 1)


def select_chunk_size(
    iter_time_fn: Callable[[int, int], float],
    *,
    prompt_len: int,
    decode_len: int,
    batch_size: int,
    candidates: Sequence[int] = (64, 128, 256, 512, 1024, 2048),
    tile: int = MXU_TILE,
) -> int:
    """Pick the chunk size maximizing modeled end-to-end throughput.

    ``iter_time_fn(n_prefill_tokens, n_decode_tokens) -> seconds`` is an
    analytical or profiled cost of one engine iteration (the paper's
    'one-time profiling of the prefill throughput for various chunk sizes').

    Models the steady state of a SARATHI schedule for requests with
    ``prompt_len`` prefill and ``decode_len`` decode tokens at batch size
    ``batch_size``: hybrid iterations cover chunks with B-1 piggybacked
    decodes, then any decode surplus runs as decode-only batches.
    """
    best_c, best_tput = None, -1.0
    D = batch_size - 1
    for target in candidates:
        c = quantized_chunk_size(target, D, tile)
        n_chunks = math.ceil(prompt_len / c)
        piggybacked = min(decode_len * batch_size, n_chunks * D)
        leftover = decode_len * batch_size - piggybacked
        t = n_chunks * iter_time_fn(c, D)
        if leftover > 0:
            t += (leftover / batch_size) * iter_time_fn(0, batch_size)
        total_tokens = prompt_len + decode_len * batch_size
        tput = total_tokens / t
        if tput > best_tput:
            best_c, best_tput = c, tput
    return best_c
