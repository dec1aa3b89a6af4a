"""StableLM-2 12B — dense GQA decoder. [hf:stabilityai/stablelm-2-1_6b]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=160,
        d_ff=13824,
        vocab_size=100352,
        rope_theta=10_000.0,
        max_seq_len=32768,
        source="hf:stabilityai/stablelm-2-1_6b",
    )
