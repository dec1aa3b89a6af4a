"""The paper's own evaluation models (§4.5 / Table 3).

LLaMA-13B (A6000), LLaMA-33B (A100), GPT-3 (64xA100 simulation).  These are
used by the benchmark suite to reproduce the paper's tables/figures via the
analytical cost model; they are also fully buildable models.
"""
from repro_torch.configs.base import ModelConfig


def llama_13b() -> ModelConfig:
    # paper §4.5: 40 layers, 40 heads, hidden 5120
    return ModelConfig(
        name="paper-llama-13b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=40, head_dim=128,
        d_ff=13824, vocab_size=32000, max_seq_len=4096,
        source="paper §4.5 / hf:decapoda-research/llama-13b-hf",
    )


def llama_33b() -> ModelConfig:
    # paper §4.5: 60 layers, 52 heads, hidden 6656
    return ModelConfig(
        name="paper-llama-33b", family="dense",
        n_layers=60, d_model=6656, n_heads=52, n_kv_heads=52, head_dim=128,
        d_ff=17920, vocab_size=32000, max_seq_len=4096,
        source="paper §4.5",
    )


def gpt3_175b() -> ModelConfig:
    # paper §4.5: 96 layers, 96 heads, hidden 12288.  GPT-3 uses a plain
    # (non-gated) GELU FFN with d_ff = 4*d.
    return ModelConfig(
        name="paper-gpt3-175b", family="dense",
        n_layers=96, d_model=12288, n_heads=96, n_kv_heads=96, head_dim=128,
        d_ff=49152, vocab_size=50257, act="gelu", max_seq_len=4096,
        source="paper §4.5",
    )
