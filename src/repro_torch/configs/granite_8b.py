"""Granite-8B code model — llama-arch dense GQA. [arXiv:2405.04324]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=49152,
        rope_theta=10_000_000.0,
        max_seq_len=131072,
        source="arXiv:2405.04324",
    )
