"""``build_model(cfg)`` — a thin namespace binding the stack to a config,
the modelling API the engine and the tests use."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import stack
from repro_torch.models.packed import PackedBatch


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init_params(self, seed: int = 0, dtype=torch.float32, device=None):
        return stack.init_params(self.cfg, seed, dtype, device)

    def init_cache(self, rows: int, max_len: int, dtype=torch.float32, *,
                   paged_blocks=None, block_size=None, device=None):
        return stack.init_cache(self.cfg, rows, max_len, dtype,
                                paged_blocks=paged_blocks,
                                block_size=block_size, device=device)

    def forward_batched(self, params, tokens, cache=None, start=None, *,
                        memory=None, train=False, logits_mode="all",
                        remat=False):
        return stack.forward_batched(
            self.cfg, params, tokens, cache, start, memory=memory,
            train=train, logits_mode=logits_mode, remat=remat)

    def forward_packed(self, params, pk: PackedBatch, cache):
        return stack.forward_packed(self.cfg, params, pk, cache)

    @property
    def needs_memory(self) -> bool:
        return self.cfg.family in ("vlm", "encdec")


def build_model(cfg: ModelConfig) -> Model:
    stack.layer_kinds(cfg)           # unported layer kinds raise here
    return Model(cfg)
