"""Deterministic, shardable synthetic token pipeline.

Serves two purposes: (a) the training driver's input (a reproducible mixture
of Zipf-distributed token ids with structure, so the loss actually goes
down), and (b) serving-workload generation with the paper's §5.3 request
distribution (Zipf sequence lengths in [min,max], fixed P:D ratio).

A copy of the JAX package's ``repro.data.pipeline`` (numpy only).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np


# --------------------------------------------------------------------------
# training batches
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticLM:
    """Markov-ish synthetic language: next token = (a*t + b) % V with noise.
    Learnable structure -> a ~100M model's loss drops well below uniform
    entropy within a few hundred steps (used by examples/train_tiny.py)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._rng = np.random.default_rng(cfg.seed)
        self._a = 31
        self._b = 17

    def batch(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        """-> (tokens [B, S], labels [B, S]) int32, deterministic in step."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        first = rng.integers(0, V, (B, 1))
        seq = np.zeros((B, S + 1), np.int64)
        seq[:, :1] = first
        noise = rng.random((B, S)) < 0.1
        rand = rng.integers(0, V, (B, S))
        for t in range(S):
            nxt = (self._a * seq[:, t] + self._b) % V
            seq[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        return (seq[:, :-1].astype(np.int32), seq[:, 1:].astype(np.int32))

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def shard_batch(tokens: np.ndarray, n_shards: int, shard: int) -> np.ndarray:
    """Static per-host sharding of the batch dimension."""
    per = tokens.shape[0] // n_shards
    return tokens[shard * per:(shard + 1) * per]


# --------------------------------------------------------------------------
# serving workloads (paper §5.3)
# --------------------------------------------------------------------------
def zipf_lengths(n: int, *, lo: int, hi: int, theta: float = 0.4,
                 seed: int = 0) -> np.ndarray:
    """Zipfian(theta) over the discrete range [lo, hi] (paper: theta=0.4,
    1K..4K).  Rank r gets probability ∝ 1/r^theta."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, hi - lo + 2, dtype=np.float64)
    p = 1.0 / np.power(ranks, theta)
    p /= p.sum()
    return (lo + rng.choice(len(ranks), size=n, p=p)).astype(np.int64)


def serving_workload(n_requests: int, *, pd_ratio: float, min_len: int = 1024,
                     max_len: int = 4096, theta: float = 0.4, seed: int = 0,
                     vocab_size: int = 32000) -> List[Tuple[List[int], int]]:
    """-> [(prompt_tokens, n_decode_tokens)] with seq_len ~ Zipf(theta) and
    prefill/decode split satisfying the P:D ratio (paper §5.3)."""
    rng = np.random.default_rng(seed + 1)
    out = []
    for L in zipf_lengths(n_requests, lo=min_len, hi=max_len, theta=theta,
                          seed=seed):
        p = int(round(L * pd_ratio / (pd_ratio + 1)))
        p = min(max(p, 1), L - 1) if L > 1 else 1
        d = max(int(L) - p, 1)
        prompt = rng.integers(0, vocab_size, p).tolist()
        out.append((prompt, d))
    return out
