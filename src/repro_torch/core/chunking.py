"""Chunked-prefill arithmetic (paper §4.2).

A prompt of ``P`` tokens is split into equal-compute chunks of size ``C``
(the last chunk may be partial).  Chunk *i* covers token positions
``[i*C, min((i+1)*C, P))`` and attends to the KV cache of all earlier chunks
plus a causal mask within itself — mathematically equivalent to a full
prefill (validated by tests/test_equivalence.py for every arch family).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List


@dataclass(frozen=True)
class Chunk:
    start: int          # tokens already prefilled before this chunk
    length: int         # valid tokens in this chunk (<= chunk size)
    is_last: bool


def plan_chunks(prompt_len: int, chunk_size: int) -> List[Chunk]:
    """Split a prompt into SARATHI chunks."""
    if prompt_len <= 0:
        raise ValueError("prompt_len must be positive")
    if chunk_size <= 0:
        raise ValueError("chunk_size must be positive")
    out = []
    start = 0
    while start < prompt_len:
        ln = min(chunk_size, prompt_len - start)
        out.append(Chunk(start, ln, start + ln == prompt_len))
        start += ln
    return out


def num_chunks(prompt_len: int, chunk_size: int) -> int:
    return math.ceil(prompt_len / chunk_size)


def kv_reload_bytes_factor(prompt_len: int, chunk_size: int) -> float:
    """Extra KV-cache traffic caused by chunking (paper §4.2 overhead #2).

    With N chunks, chunk i re-reads the KV of all previous tokens; relative
    to the single full-prefill attention pass (which touches each KV once),
    the total KV bytes read grow by this factor:

        sum_i (start_i + len_i) / prompt_len
    """
    total = 0
    for c in plan_chunks(prompt_len, chunk_size):
        total += c.start + c.length
    return total / prompt_len


def piggyback_coverage(prompt_len: int, decode_slots: int,
                       chunk_size: int) -> int:
    """How many decode tokens can piggyback on one prompt's chunks
    (paper §4.4: P/C chunks x (B-1) decode slots each)."""
    return num_chunks(prompt_len, chunk_size) * decode_slots
