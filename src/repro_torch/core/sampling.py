"""Token sampling."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0       # 0 -> greedy
    top_k: int = 0                 # 0 -> full distribution


def sample(logits, generator: Optional[torch.Generator] = None,
           params: SamplingParams = SamplingParams()):
    """logits [..., V] -> token ids [...] (int32).  Greedy takes the first
    index among equal maxima.  Stochastic sampling draws from the explicit
    ``generator``; its numbers differ from ``jax.random``'s."""
    if params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / params.temperature
    if params.top_k:
        kth = torch.sort(logits, dim=-1).values[..., -params.top_k][..., None]
        logits = torch.where(logits >= kth, logits, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    ids = torch.multinomial(flat, 1, generator=generator)
    return ids.reshape(probs.shape[:-1]).to(torch.int32)
