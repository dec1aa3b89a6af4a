"""Model configuration dataclasses.

Every architecture in the assigned pool (plus the paper's own models) is
described by a single :class:`ModelConfig`.  The config is the source of truth
for:

* model construction (``repro_torch.models.registry.build_model``),
* the KV-cache geometry of the engine and the kernels,
* parameter / KV-cache byte accounting (``repro_torch.sim.cost_model``),
* the reduced "smoke" variants used by CPU tests.

(The JAX package's sharding policy reads it too; the port has none yet.)
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence, Tuple


# Families understood by the model zoo.
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec")


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters for one model.

    Only the transformer backbone is described for ``vlm`` / ``encdec``
    entries; modality frontends are stubs that provide embeddings of shape
    ``[B, n_frontend_tokens, d_model]`` (see the assignment carve-out).
    """

    name: str
    family: str                      # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    # --- attention details -------------------------------------------------
    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False           # Qwen2-style bias on Q/K/V projections
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None   # SWA variant (sub-quadratic dense)

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0               # 0 -> dense FFN
    top_k: int = 0
    capacity_factor: float = 1.25    # dispatch buffer slack
    moe_shared_d_ff: int = 0         # optional shared-expert FFN width

    # --- SSM (Mamba-2 / SSD) -------------------------------------------------
    ssm_state: int = 0               # N: state size per head
    ssm_expand: int = 2              # d_inner = expand * d_model
    ssm_headdim: int = 64            # P: channels per SSM head
    ssm_ngroups: int = 1             # B/C groups (GQA-analog)
    ssm_conv_width: int = 4          # causal depthwise conv width
    ssm_chunk: int = 128             # SSD intra-chunk length

    # --- hybrid (RecurrentGemma) --------------------------------------------
    # Repeating block pattern, e.g. ("rglru", "rglru", "local_attn") == 1:2
    block_pattern: Tuple[str, ...] = ()
    lru_width: int = 0               # RG-LRU recurrence width (0 -> d_model)
    local_window: int = 2048         # local-attention window

    # --- VLM ----------------------------------------------------------------
    cross_attn_every: int = 0        # every k-th layer is cross-attention
    n_frontend_tokens: int = 0       # image patch / audio frame embeddings

    # --- encoder-decoder -----------------------------------------------------
    n_encoder_layers: int = 0        # 0 -> decoder-only

    # --- misc ----------------------------------------------------------------
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    tie_embeddings: bool = False
    act: str = "silu"                # FFN activation ("silu" -> SwiGLU family)
    source: str = ""                 # provenance citation

    # ------------------------------------------------------------------ utils
    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        if self.family == "hybrid" and self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)

    # --- derived sizes -------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_state else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True if decode memory/compute is sub-quadratic in context length.

        SSM: O(1) state.  Hybrid: LRU state + bounded local window.  Dense with
        a sliding window: bounded KV.  Full-attention dense / vlm / encdec:
        quadratic -> cannot serve the 500k shape (skip, see DESIGN.md).
        """
        if self.family == "ssm":
            return True
        if self.family == "hybrid":
            return True
        return self.sliding_window is not None

    def attn_layer_indices(self) -> Sequence[int]:
        """Indices of layers that own a self-attention KV cache."""
        if self.family == "ssm":
            return []
        if self.family == "hybrid":
            pat = self.block_pattern
            return [i for i in range(self.n_layers) if pat[i % len(pat)] == "local_attn"]
        if self.family == "vlm" and self.cross_attn_every:
            # cross-attn layers cache *image* KV, handled separately
            return [i for i in range(self.n_layers)
                    if (i + 1) % self.cross_attn_every != 0]
        return list(range(self.n_layers))

    # --- accounting (used by sim + roofline sanity checks) -------------------
    def param_count(self) -> int:
        """Total parameter count (embedding included once if tied)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        n = 0
        n += v * d                                   # token embedding
        if not self.tie_embeddings:
            n += v * d                               # unembedding
        per_layer = 0
        if self.family == "ssm":
            di, ns, nh = self.d_inner, self.ssm_state, self.n_ssm_heads
            g = self.ssm_ngroups
            in_proj = d * (2 * di + 2 * g * ns + nh)
            per_layer = (in_proj + self.ssm_conv_width * (di + 2 * g * ns)
                         + nh                         # A_log
                         + nh                         # D
                         + di                         # dt bias via nh? keep nh
                         + di * d                     # out proj
                         + 2 * d)                     # norms
            n += self.n_layers * per_layer
            return n

        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.qkv_bias:
            attn += self.q_dim + 2 * self.kv_dim
        ffn_dense = 3 * d * f if self.act == "silu" else 2 * d * f
        for i in range(self.n_layers):
            kind = self._layer_kind(i)
            if kind == "rglru":
                w = self.lru_width
                blk = d * w * 2 + w * d + 3 * w      # gates+proj approx
                blk += 3 * d * self.d_ff             # gated mlp
            elif kind == "local_attn":
                blk = attn + 3 * d * self.d_ff
            elif kind == "cross_attn":
                blk = attn + ffn_dense
            elif kind == "moe":
                blk = attn + self.n_experts * 3 * d * self.d_ff
                blk += d * self.n_experts            # router
                if self.moe_shared_d_ff:
                    blk += 3 * d * self.moe_shared_d_ff
            else:                                     # dense
                blk = attn + ffn_dense
            blk += 2 * d                              # norms
            n += blk
        if self.n_encoder_layers:
            enc_blk = attn + ffn_dense + 2 * d
            dec_cross = attn                          # decoder cross-attn
            n += self.n_encoder_layers * enc_blk + self.n_layers * dec_cross
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only top-k experts)."""
        if not self.n_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_total = self.param_count()
        unused = self.n_layers * (self.n_experts - self.top_k) * 3 * d * f
        return dense_total - unused

    def _layer_kind(self, i: int) -> str:
        if self.family == "moe":
            return "moe"
        if self.family == "hybrid":
            return self.block_pattern[i % len(self.block_pattern)]
        if self.family == "vlm" and self.cross_attn_every:
            return "cross_attn" if (i + 1) % self.cross_attn_every == 0 else "dense"
        return "dense"

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """KV-cache bytes per sequence token (full-attention layers only)."""
        if self.family == "ssm":
            return 0
        n_attn = len(self.attn_layer_indices())
        return n_attn * 2 * self.kv_dim * dtype_bytes

    # --- reduced smoke variant ------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """2-layer, d_model<=512, <=4-expert variant for CPU smoke tests."""
        d = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        head_dim = max(d // n_heads, 16) if n_heads else 0
        n_kv = min(self.n_kv_heads, n_heads)
        changes = dict(
            n_layers=2,
            d_model=d,
            n_heads=n_heads,
            n_kv_heads=max(1, n_kv if n_kv <= n_heads else n_heads),
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512) or self.d_ff,
            vocab_size=min(self.vocab_size, 1024),
            max_seq_len=512,
        )
        if self.n_experts:
            changes.update(n_experts=4, top_k=min(self.top_k, 2))
        if self.ssm_state:
            changes.update(ssm_state=16, ssm_headdim=16, ssm_chunk=16,
                           n_layers=2)
        if self.family == "hybrid":
            # keep one rglru + one local_attn layer
            changes.update(block_pattern=("rglru", "local_attn"),
                           lru_width=d, local_window=64)
        if self.family == "vlm":
            changes.update(cross_attn_every=2, n_frontend_tokens=16)
        if self.n_encoder_layers:
            changes.update(n_encoder_layers=2, n_frontend_tokens=16)
        if self.sliding_window:
            changes.update(sliding_window=64)
        return replace(self, **changes)

    def with_sliding_window(self, window: int = 4096) -> "ModelConfig":
        """Beyond-paper SWA variant enabling long_500k for dense archs."""
        if self.family not in ("dense",):
            raise ValueError("SWA variant only defined for dense archs")
        return replace(self, sliding_window=window,
                       name=self.name + "-swa")
