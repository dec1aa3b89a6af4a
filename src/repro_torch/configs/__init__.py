from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCHS, ASSIGNED, PAPER, get_config

__all__ = ["ModelConfig", "ARCHS", "ASSIGNED", "PAPER", "get_config"]
