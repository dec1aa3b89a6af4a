"""TinyLlama-1.1B — llama2-arch small dense GQA. [arXiv:2401.02385]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b",
        family="dense",
        n_layers=22,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        head_dim=64,
        d_ff=5632,
        vocab_size=32000,
        rope_theta=10_000.0,
        max_seq_len=2048,
        source="arXiv:2401.02385",
    )
