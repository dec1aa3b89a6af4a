"""``--arch <id>`` lookup for the configurations the port can build.

Every ``family="dense"`` architecture of the JAX package's registry is
listed; the other families need mixers the port does not have yet
(ROADMAP Queue 1, "the other mixers")."""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.configs import (granite_8b, paper_models, qwen2_0_5b,
                                 stablelm_12b, tinyllama_1_1b)

# The assigned architectures the port supports, keyed by their --arch ids.
ASSIGNED: Dict[str, Callable[[], ModelConfig]] = {
    "stablelm-12b": stablelm_12b.config,
    "granite-8b": granite_8b.config,
    "qwen2-0.5b": qwen2_0_5b.config,
    "tinyllama-1.1b": tinyllama_1_1b.config,
}

# The paper's own models.
PAPER: Dict[str, Callable[[], ModelConfig]] = {
    "paper-llama-13b": paper_models.llama_13b,
    "paper-llama-33b": paper_models.llama_33b,
    "paper-gpt3-175b": paper_models.gpt3_175b,
}

ARCHS: Dict[str, Callable[[], ModelConfig]] = {**ASSIGNED, **PAPER}


def get_config(arch: str) -> ModelConfig:
    """Resolve an ``--arch`` id."""
    key = arch.strip()
    if key not in ARCHS:
        raise KeyError(
            f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    return ARCHS[key]()
