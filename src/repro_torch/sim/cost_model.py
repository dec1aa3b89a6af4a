"""Analytical op-level cost model for one engine iteration.

A copy of the JAX package's ``repro.sim.cost_model``: pure arithmetic on
:class:`~repro_torch.configs.base.ModelConfig` fields and a
:class:`~repro_torch.sim.hardware.Hardware` profile, so its results equal
the JAX package's exactly.

Mirrors the paper's methodology (§5.3: "profile the runtime for each
operation in Table 1 ... build a regression model"): each transformer
operation is costed as max(compute-time, memory-time) + launch overhead,
with the crucial SARATHI property modelled explicitly — in a fused
(decode-maximal) batch the weights are fetched from HBM ONCE for the packed
token matrix, whereas separate prefill-only / decode-only iterations each
pay the full weight fetch.

The model is used to (a) reproduce the paper's tables/figures without GPU
hardware, (b) drive chunk-size selection, and (c) time micro-batches in the
pipeline-parallel simulator.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.sim.hardware import Hardware

BYTES = 2  # fp16/bf16 weights and activations


# --------------------------------------------------------------------------
# batch composition
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class PrefillSeg:
    n_tokens: int                # chunk length (== full prompt if unchunked)
    ctx_start: int = 0           # tokens already in the KV cache


@dataclass(frozen=True)
class DecodeSeg:
    n_seqs: int
    ctx: int                     # average context length per sequence


@dataclass(frozen=True)
class BatchSpec:
    prefills: Tuple[PrefillSeg, ...] = ()
    decodes: Tuple[DecodeSeg, ...] = ()
    fused: bool = True           # decode-maximal: linear ops share one fetch

    @property
    def n_tokens(self) -> int:
        return (sum(p.n_tokens for p in self.prefills)
                + sum(d.n_seqs for d in self.decodes))


# --------------------------------------------------------------------------
# primitive costs
# --------------------------------------------------------------------------
def _matmul_time(hw: Hardware, m: int, k: int, n: int,
                 weight_bytes: float, act_bytes: float,
                 quantize_tiles: bool = True) -> float:
    """One [m,k]x[k,n] matmul: max(compute, memory) + overhead.  ``m`` is the
    token dimension; tile quantization pads it to a multiple of hw.tile
    (paper §4.4 'tile quantization effect' / Fig. 7)."""
    if m == 0:
        return 0.0
    m_eff = math.ceil(m / hw.tile) * hw.tile if quantize_tiles else m
    flops = 2.0 * m_eff * k * n
    t_compute = flops / (hw.peak_flops * hw.matmul_eff)
    t_memory = (weight_bytes + act_bytes) / (hw.hbm_bw * hw.mem_eff)
    return max(t_compute, t_memory) + hw.kernel_overhead


def tp_allreduce_time(hw: Hardware, n_bytes: float, tp: int) -> float:
    """Ring all-reduce of an ``n_bytes`` activation over ``tp`` chips:
    every chip sends/receives ``2 (tp-1)/tp`` of the buffer over its link
    (reduce-scatter + all-gather fused in ONE kernel), plus one launch
    overhead.  This is the per-layer synchronisation Megatron TP pays
    after each row-parallel matmul — it does NOT shrink with ``tp``,
    which is exactly why TP x PP composition needs the term to predict
    bubble interaction.

    Sequence parallelism (``iteration_time(..., sp=True)``) decomposes
    this into its two halves — :func:`tp_reduce_scatter_time` +
    :func:`tp_all_gather_time` — moving the SAME bytes over the link but
    leaving the activations token-sharded between the halves, which is
    what lets the norm/residual "others" term shrink by ``tp``."""
    if tp <= 1 or n_bytes <= 0:
        return 0.0
    return 2.0 * (tp - 1) / tp * n_bytes / hw.link_bw + hw.kernel_overhead


def tp_reduce_scatter_time(hw: Hardware, n_bytes: float, tp: int) -> float:
    """Ring reduce-scatter of an ``n_bytes`` activation over ``tp`` chips
    — the first half of :func:`tp_allreduce_time`'s ring, emitted as its
    own kernel under sequence parallelism: each chip sends/receives
    ``(tp-1)/tp`` of the buffer and is left holding the reduced
    ``n_bytes / tp`` token shard (norms + residuals then run on the
    shard, not the full buffer)."""
    if tp <= 1 or n_bytes <= 0:
        return 0.0
    return (tp - 1) / tp * n_bytes / hw.link_bw + hw.kernel_overhead


def tp_all_gather_time(hw: Hardware, n_bytes: float, tp: int) -> float:
    """Ring all-gather restoring a token-sharded ``n_bytes`` activation
    to replicated — the second half of :func:`tp_allreduce_time`'s ring,
    emitted immediately before the next column-parallel matmul under
    sequence parallelism.  Same link traffic as the reduce-scatter half;
    RS + AG together move exactly the bytes one all-reduce moves, paying
    one extra kernel launch for the sharded region in between."""
    if tp <= 1 or n_bytes <= 0:
        return 0.0
    return (tp - 1) / tp * n_bytes / hw.link_bw + hw.kernel_overhead


def kv_transfer_time(hw: Hardware, n_bytes: float) -> float:
    """Relocate ``n_bytes`` of KV cache from one replica to another over
    the inter-chip link (the DistServe prefill->decode handoff): a single
    one-directional stream plus one launch overhead.  The per-token
    companion of :func:`tp_allreduce_time` — where TP pays a recurring
    per-layer synchronisation, phase disaggregation pays this ONCE per
    request, at the prefill/decode boundary (the JAX package's
    ``repro.serving.disagg`` charges it on the virtual clock between
    extract and install; the port has no disagg yet)."""
    if n_bytes <= 0:
        return 0.0
    return n_bytes / hw.link_bw + hw.kernel_overhead


def kv_handoff_bytes(cfg, n_tokens: int, dtype_bytes: int = BYTES) -> float:
    """Payload of a prefill->decode KV handoff: the full-attention KV of
    ``n_tokens`` cached positions (the same per-token footprint the
    capacity model uses)."""
    return float(n_tokens) * cfg.kv_bytes_per_token(dtype_bytes)


def kv_swap_time(hw: Hardware, n_bytes: float) -> float:
    """Move ``n_bytes`` of KV cache between device HBM and host RAM over
    PCIe — the swap-tier sibling of :func:`kv_transfer_time` (which models
    the inter-chip link): one directional stream at ``hw.pcie_bw`` plus one
    launch overhead.  Charged on the virtual clock once per swap-out and
    once per swap-in; the hybrid preemption policy compares the round trip
    (2x this) against :func:`chunked_prefill_total` per victim."""
    if n_bytes <= 0:
        return 0.0
    return n_bytes / hw.pcie_bw + hw.kernel_overhead


def kv_swap_bytes(cfg, n_blocks: int, block_size: int,
                  dtype_bytes: int = BYTES) -> float:
    """Payload of swapping ``n_blocks`` KV-pool blocks: PCIe moves whole
    blocks, so a partially written tail block still costs ``block_size``
    tokens of bandwidth (internal fragmentation is paid, unlike the
    token-granular :func:`kv_handoff_bytes`)."""
    return kv_handoff_bytes(cfg, int(n_blocks) * int(block_size),
                            dtype_bytes)


def _attention_time(hw: Hardware, n_q: int, n_kv: int, n_heads: int,
                    n_kv_heads: int, head_dim: int) -> float:
    """Score + AV for n_q query tokens against n_kv cached tokens."""
    if n_q == 0 or n_kv == 0:
        return 0.0
    flops = 2.0 * 2.0 * n_q * n_kv * n_heads * head_dim
    kv_bytes = 2.0 * n_kv * n_kv_heads * head_dim * BYTES
    q_bytes = n_q * n_heads * head_dim * BYTES
    t_compute = flops / (hw.peak_flops * hw.matmul_eff)
    t_memory = (kv_bytes + q_bytes) / (hw.hbm_bw * hw.mem_eff)
    return max(t_compute, t_memory) + hw.kernel_overhead


# --------------------------------------------------------------------------
# per-iteration model
# --------------------------------------------------------------------------
@dataclass
class CostBreakdown:
    preproj: float = 0.0
    attn: float = 0.0
    postproj: float = 0.0
    ffn: float = 0.0
    others: float = 0.0
    collective: float = 0.0      # TP all-reduce time (0 when n_chips == 1)

    @property
    def linear(self) -> float:
        return self.preproj + self.postproj + self.ffn

    @property
    def total(self) -> float:
        return self.linear + self.attn + self.others + self.collective


def _linear_ops_time(cfg: ModelConfig, hw: Hardware, token_groups:
                     Sequence[int], fused: bool) -> Tuple[float, float, float]:
    """Time of the four linear ops for one layer.

    ``token_groups`` — token counts that are executed as separate matmuls
    (e.g. [chunk+decodes] when fused, [chunk, decodes] when not).  The
    weights are fetched per GROUP — this is the decode-piggybacking effect.
    """
    d, f = cfg.d_model, cfg.d_ff
    qkv_out = cfg.q_dim + 2 * cfg.kv_dim
    w_qkv = d * qkv_out * BYTES
    w_o = cfg.q_dim * d * BYTES
    n_ffn_mats = 3 if cfg.act == "silu" else 2
    w_ffn = n_ffn_mats * d * f * BYTES

    pre = post = ffn = 0.0
    for m in token_groups:
        if m == 0:
            continue
        act = m * d * BYTES
        pre += _matmul_time(hw, m, d, qkv_out, w_qkv, act + m * qkv_out * BYTES)
        post += _matmul_time(hw, m, cfg.q_dim, d, w_o, act * 2)
        # gate/up then down (counted as one fused ffn op per paper Table 1)
        ffn += _matmul_time(hw, m, d, n_ffn_mats * f, w_ffn,
                            act + m * f * BYTES)
    return pre, post, ffn


def _moe_ffn_time(cfg: ModelConfig, hw: Hardware, token_groups:
                  Sequence[int], fused: bool) -> float:
    """MoE FFN: per group, FLOPs scale with top-k tokens; weight traffic is
    the experts actually touched (min(E, T*k) in expectation)."""
    d, f, E, k = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k
    expert_w = 3 * d * f * BYTES
    t = 0.0
    for m in token_groups:
        if m == 0:
            continue
        touched = min(E, m * k)
        flops = 2.0 * 3 * (m * k) * d * f
        w_bytes = touched * expert_w
        a_bytes = m * d * BYTES * 2
        t_c = flops / (hw.peak_flops * hw.matmul_eff)
        t_m = (w_bytes + a_bytes) / (hw.hbm_bw * hw.mem_eff)
        t += max(t_c, t_m) + hw.kernel_overhead
    return t


def iteration_time(cfg: ModelConfig, hw: Hardware, spec: BatchSpec,
                   n_chips: int = 1, others_frac: float = 0.05,
                   sp: bool = False) -> CostBreakdown:
    """Model one engine iteration over the whole model (all layers).

    ``n_chips`` divides weights/compute (tensor parallelism over the
    ``model`` axis; the paper's simulation assumes the split is ideal,
    §5.3) and ADDS the per-layer TP synchronisation: two ring all-reduces
    of the token group's ``[m, d_model]`` activations per layer (after the
    attention output projection and the FFN down projection), which do not
    shrink with ``n_chips`` — see :func:`tp_allreduce_time` and the
    ``collective`` field of the returned breakdown.  ``others_frac`` adds
    the paper's measured <5% for norms/residuals/activations — charged at
    the FULL (single-chip) token count when ``n_chips > 1``, because the
    inter-block region runs replicated on every TP chip.

    ``sp`` models sequence parallelism over the packed token axis
    (the JAX package's Engine ``sp=True``): each per-layer
    all-reduce splits into :func:`tp_reduce_scatter_time` +
    :func:`tp_all_gather_time` (same link bytes, one extra launch each),
    and in exchange the replicated norm/residual ``others`` term shrinks
    by ``n_chips`` — the activations stay ``[tokens/tp, d_model]`` shards
    through the inter-block region.  At ``n_chips == 1`` both flags are
    inert and the breakdown is bit-identical to the unsharded model.
    """
    bd = CostBreakdown()
    if spec.fused:
        groups = [spec.n_tokens]
    else:
        groups = [p.n_tokens for p in spec.prefills] + \
                 [sum(d.n_seqs for d in spec.decodes)]

    pre, post, ffn_t = _linear_ops_time(cfg, hw, groups, spec.fused)
    if cfg.n_experts:
        ffn_t = _moe_ffn_time(cfg, hw, groups, spec.fused)
    # attention is always computed per segment (paper §4.3: "letting the
    # attention computations ... happen separately")
    attn = 0.0
    for p in spec.prefills:
        # chunk queries attend ctx_start + triangular within-chunk keys
        avg_kv = p.ctx_start + (p.n_tokens + 1) / 2.0
        attn += _attention_time(hw, p.n_tokens, max(int(avg_kv), 1),
                                cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    for dseg in spec.decodes:
        attn += dseg.n_seqs * _attention_time(
            hw, 1, dseg.ctx, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)

    L = cfg.n_layers
    scale = L / max(n_chips, 1)
    bd.preproj = pre * scale
    bd.postproj = post * scale
    bd.ffn = ffn_t * scale
    bd.attn = attn * scale
    # norms / residuals / activation glue: replicated on every TP chip
    # (full token count) unless sequence parallelism shards the token
    # axis through the inter-block region — then it splits ideally
    others_full = (pre + post + ffn_t + attn) * L * others_frac
    bd.others = others_full / n_chips if (sp and n_chips > 1) \
        else others_full
    if n_chips > 1:
        coll = 0.0
        for m in groups:
            # two row-parallel matmul outputs per layer sync [m, d] each;
            # under SP the all-reduce splits into its RS + AG halves
            # (same bytes, one extra launch) bracketing the sharded region
            n_bytes = m * cfg.d_model * BYTES
            if sp:
                coll += 2.0 * (tp_reduce_scatter_time(hw, n_bytes, n_chips)
                               + tp_all_gather_time(hw, n_bytes, n_chips))
            else:
                coll += 2.0 * tp_allreduce_time(hw, n_bytes, n_chips)
        bd.collective = coll * L
    return bd


def sp_activation_bytes(cfg: ModelConfig, n_tokens: int, n_chips: int = 1,
                        sp: bool = False,
                        dtype_bytes: int = BYTES) -> float:
    """Per-chip bytes of the ``[tokens, d_model]`` residual stream held
    through the two inter-block (norm + residual) regions of each layer —
    the activation footprint sequence parallelism shrinks.  Replicated TP
    holds the full token count on every chip; with ``sp`` each chip holds
    a ``ceil(n_tokens / n_chips)`` token shard (the engine pads the packed
    token count to a multiple of ``tp``, so the ceil matches the padded
    lanes exactly)."""
    t = int(n_tokens)
    if sp and n_chips > 1:
        t = -(-t // n_chips)
    return 2.0 * cfg.n_layers * t * cfg.d_model * dtype_bytes


# --------------------------------------------------------------------------
# convenience entry points used by benchmarks / chunk-size selection
# --------------------------------------------------------------------------
def prefill_time(cfg, hw, n_tokens: int, ctx_start: int = 0,
                 n_chips: int = 1) -> float:
    return iteration_time(
        cfg, hw, BatchSpec(prefills=(PrefillSeg(n_tokens, ctx_start),)),
        n_chips).total


def decode_time(cfg, hw, batch: int, ctx: int, n_chips: int = 1) -> float:
    return iteration_time(
        cfg, hw, BatchSpec(decodes=(DecodeSeg(batch, ctx),)), n_chips).total


def hybrid_time(cfg, hw, chunk: int, ctx_start: int, n_decodes: int,
                decode_ctx: int, n_chips: int = 1) -> float:
    return iteration_time(
        cfg, hw, BatchSpec(prefills=(PrefillSeg(chunk, ctx_start),),
                           decodes=(DecodeSeg(n_decodes, decode_ctx),)),
        n_chips).total


def chunked_prefill_total(cfg, hw, prompt_len: int, chunk: int,
                          n_chips: int = 1) -> float:
    """Full prefill executed as chunks (paper Fig. 13 ablation)."""
    t, start = 0.0, 0
    while start < prompt_len:
        n = min(chunk, prompt_len - start)
        t += prefill_time(cfg, hw, n, start, n_chips)
        start += n
    return t


# --------------------------------------------------------------------------
# KV-memory capacity model (dense rows vs paged block pool)
# --------------------------------------------------------------------------
def kv_budget_bytes(cfg, hw: Hardware, n_chips: int = 1,
                    dtype_bytes: int = BYTES) -> float:
    """HBM left for KV after the (tensor-sharded) weights: the budget both
    cache layouts are compared at."""
    weights = cfg.param_count() * dtype_bytes / max(n_chips, 1)
    return max(hw.hbm_capacity - weights, 0.0)


def kv_pool_tokens(cfg, hbm_bytes: float, dtype_bytes: int = BYTES) -> int:
    """Cached token positions a KV budget can back (0-KV archs -> 2**62)."""
    per_tok = cfg.kv_bytes_per_token(dtype_bytes)
    return int(hbm_bytes // per_tok) if per_tok else 1 << 62


def dense_capacity(cfg, hbm_bytes: float, max_len: int,
                   dtype_bytes: int = BYTES) -> int:
    """Concurrent requests a DENSE slot cache admits: every slot reserves
    a full ``max_len`` row regardless of actual context."""
    return kv_pool_tokens(cfg, hbm_bytes, dtype_bytes) // max(max_len, 1)


def paged_capacity(cfg, hbm_bytes: float, block_size: int, seq_len: int,
                   dtype_bytes: int = BYTES) -> int:
    """Concurrent requests a PAGED pool admits at ``seq_len`` context:
    each holds only ``ceil(seq_len / block_size)`` blocks (one block is
    reserved scratch)."""
    n_blocks = kv_pool_tokens(cfg, hbm_bytes, dtype_bytes) // block_size
    per_req = -(-max(seq_len, 1) // block_size)
    return max(n_blocks - 1, 0) // per_req
