"""Decoder stack of the port: the packed and the batched forward.

PyTorch counterpart of ``repro.models.stack`` for the ``dense`` layer kind
with the glu or mlp FFN: :class:`Transformer` is an ``nn.Module`` whose
parameters keep the JAX leaf names (``embed``, ``final_norm``,
``unembed``; per layer ``ln1``, ``mixer.*``, ``ln2``, ``ffn.*``).
:func:`forward_packed` runs one SARATHI hybrid step and
:func:`forward_batched` a ``[B, L]`` batch (full or chunked prefill,
batched decode, or the no-cache forward), looping over the layers in
Python where JAX scans them.  The cache is a list with one dict
per layer, updated in place.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as bk
from repro_torch.models import common as cm
from repro_torch.models.packed import PackedBatch


# --------------------------------------------------------------------------
# layer-kind pattern
# --------------------------------------------------------------------------
def layer_kinds(cfg: ModelConfig) -> List[str]:
    """Every layer's kind; only ``dense`` exists in the port so far."""
    if cfg.family != "dense" or cfg.sliding_window:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r}"
            f"{' with a sliding window' if cfg.sliding_window else ''} "
            f"needs mixers the port does not have yet (ROADMAP Queue 1, "
            f"the other mixers)")
    return ["dense"] * cfg.n_layers


def _ffn_spec(cfg: ModelConfig) -> str:
    return "glu" if cfg.act in ("silu",) else "mlp"


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------
class GluFFN(nn.Module):
    def __init__(self, d_model: int, d_ff: int, generator, dtype, device):
        super().__init__()
        self.w_gate = cm.param(cm.dense_init(
            generator, (d_model, d_ff), dtype, device))
        self.w_up = cm.param(cm.dense_init(
            generator, (d_model, d_ff), dtype, device))
        self.w_down = cm.param(cm.dense_init(
            generator, (d_ff, d_model), dtype, device))


class MlpFFN(nn.Module):
    def __init__(self, d_model: int, d_ff: int, generator, dtype, device):
        super().__init__()
        self.w1 = cm.param(cm.dense_init(
            generator, (d_model, d_ff), dtype, device))
        self.b1 = cm.param(torch.zeros((d_ff,), dtype=dtype, device=device))
        self.w2 = cm.param(cm.dense_init(
            generator, (d_ff, d_model), dtype, device))
        self.b2 = cm.param(torch.zeros((d_model,), dtype=dtype,
                                       device=device))


class Layer(nn.Module):
    """``x += mixer(norm(x)); x += ffn(norm(x))`` (pre-norm)."""

    def __init__(self, cfg: ModelConfig, generator, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = cm.param(torch.ones((d,), dtype=dtype, device=device))
        self.mixer = bk.init_attention(cfg, generator, dtype, device)
        self.ln2 = cm.param(torch.ones((d,), dtype=dtype, device=device))
        ffn = GluFFN if _ffn_spec(cfg) == "glu" else MlpFFN
        self.ffn = ffn(d, cfg.d_ff, generator, dtype, device)


class Transformer(nn.Module):
    """The model's parameters.  Random init is the JAX package's scheme
    (truncated-normal fan-in, ones for norms, zeros for biases) drawn from
    a seeded ``torch.Generator``; the numbers differ from JAX's, so tests
    carry JAX weights across with ``repro_torch.serving.convert``."""

    def __init__(self, cfg: ModelConfig, generator, dtype, device):
        super().__init__()
        layer_kinds(cfg)
        self.cfg = cfg
        self.embed = cm.param(cm.embed_init(
            generator, (cfg.vocab_size, cfg.d_model), dtype, device))
        self.final_norm = cm.param(torch.ones((cfg.d_model,), dtype=dtype,
                                              device=device))
        if not cfg.tie_embeddings:
            self.unembed = cm.param(cm.dense_init(
                generator, (cfg.d_model, cfg.vocab_size), dtype, device))
        self.layers = nn.ModuleList(
            [Layer(cfg, generator, dtype, device)
             for _ in range(cfg.n_layers)])


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device=None) -> Transformer:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``,
    made on ``device`` (default: the CUDA card)."""
    from repro_torch.device import resolve_device
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        return Transformer(cfg, gen, dtype, device)


def init_layer_cache(cfg: ModelConfig, kind: str, rows: int, max_len: int,
                     dtype, device,
                     paged: Optional[Tuple[int, int]] = None) -> Dict:
    """``paged`` = (n_blocks, block_size) pools this layer's KV."""
    if kind != "dense":
        raise NotImplementedError(kind)
    if paged is not None:
        return {"attn": bk.init_paged_attn_cache(cfg, paged[0], paged[1],
                                                 dtype, device)}
    return {"attn": bk.init_attn_cache(cfg, rows, max_len, dtype, device)}


def init_cache(cfg: ModelConfig, rows: int, max_len: int,
               dtype=torch.float32, *, paged_blocks: Optional[int] = None,
               block_size: Optional[int] = None, device=None) -> List[Dict]:
    """One cache dict per layer.  ``paged_blocks``/``block_size`` switch
    the KV to the pooled paged layout (every layer gets its own
    ``paged_blocks``-block pool; one block table per request addresses
    all layers)."""
    from repro_torch.device import resolve_device
    device = resolve_device(device)
    paged = None
    if paged_blocks is not None:
        if not block_size:
            raise ValueError("paged cache needs block_size")
        paged = (int(paged_blocks), int(block_size))
    return [init_layer_cache(cfg, kind, rows, max_len, dtype, device, paged)
            for kind in layer_kinds(cfg)]


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------
def _apply_ffn(cfg, p, x):
    h = cm.rms_norm(x, p.ln2, cfg.norm_eps)
    if _ffn_spec(cfg) == "glu":
        return cm.glu_ffn(p.ffn, h, cfg.act)
    return cm.mlp_ffn(p.ffn, h, cfg.act)


def apply_layer_packed(cfg, kind, p, x, cache, pk: PackedBatch):
    if kind != "dense":
        raise NotImplementedError(kind)
    h = cm.rms_norm(x, p.ln1, cfg.norm_eps)
    mo, cache["attn"] = bk.attn_packed(cfg, p.mixer, h, cache["attn"], pk)
    x = x + mo
    x = x + _apply_ffn(cfg, p, x)
    return x, cache, 0.0


def apply_layer_batched(cfg, kind, p, x, cache, start, *, train: bool):
    if kind != "dense":
        raise NotImplementedError(kind)
    h = cm.rms_norm(x, p.ln1, cfg.norm_eps)
    mo, _ = bk.attn_batched(cfg, p.mixer, h, cache and cache["attn"],
                            start, train=train)
    x = x + mo
    x = x + _apply_ffn(cfg, p, x)
    return x, cache, 0.0


def _unembed(cfg, params, x):
    if cfg.tie_embeddings:
        return x @ params.embed.T
    return x @ params.unembed


def forward_packed(cfg: ModelConfig, params: Transformer, pk: PackedBatch,
                   cache: List[Dict]):
    """SARATHI hybrid step.  Returns (chunk_logits [1,V] | None,
    decode_logits [D,V] | None, cache (updated in place), aux)."""
    x = params.embed[pk.token_ids().long()]
    kinds = layer_kinds(cfg)
    aux = 0.0
    for kind, p, c in zip(kinds, params.layers, cache):
        x, _, a = apply_layer_packed(cfg, kind, p, x, c, pk)
        aux = aux + a
    x = cm.rms_norm(x, params.final_norm, cfg.norm_eps)
    C, D = pk.num_chunk, pk.num_decode
    if C:
        # last *valid* chunk row (the chunk may be padded past chunk_len)
        row = torch.clamp(pk.chunk_len.long() - 1, min=0).reshape(1)
        chunk_logits = _unembed(cfg, params, x.index_select(0, row))
    else:
        chunk_logits = None
    decode_logits = _unembed(cfg, params, x[C:]) if D else None
    return chunk_logits, decode_logits, cache, aux


_LOGITS_MODES = ("all", "last", "hidden", "none")


def forward_batched(cfg: ModelConfig, params: Transformer, tokens,
                    cache: Optional[List[Dict]] = None, start=None, *,
                    memory=None, train: bool = False,
                    logits_mode: str = "all", remat: bool = False):
    """tokens [B, L] int; cache (rows == B, dense, updated in place) or
    None; start [B] int32 offsets (default 0).  Returns (logits, cache,
    aux).  ``logits_mode``: "all" -> [B, L, V]; "last" -> [B, V];
    "hidden" -> the final hidden states [B, L, d]; "none" -> None."""
    if remat:
        raise NotImplementedError("remat: the port has no training yet "
                                  "(ROADMAP Queue 1, training)")
    if memory is not None:
        raise NotImplementedError("memory: cross attention is not ported "
                                  "yet (ROADMAP Queue 1, the other mixers)")
    if logits_mode not in _LOGITS_MODES:
        raise ValueError(f"logits_mode {logits_mode!r} not in "
                         f"{_LOGITS_MODES}")
    B, L = tokens.shape
    x = params.embed[tokens.long()]
    if start is None:
        start = torch.zeros((B,), dtype=torch.int32, device=x.device)
    aux = 0.0
    layer_caches = cache if cache is not None else [None] * cfg.n_layers
    for kind, p, c in zip(layer_kinds(cfg), params.layers, layer_caches):
        x, _, a = apply_layer_batched(cfg, kind, p, x, c, start, train=train)
        aux = aux + a
    x = cm.rms_norm(x, params.final_norm, cfg.norm_eps)
    if logits_mode == "all":
        logits = _unembed(cfg, params, x)
    elif logits_mode == "last":
        logits = _unembed(cfg, params, x[:, -1])
    elif logits_mode == "hidden":
        logits = x
    else:
        logits = None
    return logits, cache, aux
