"""Shared model primitives: norms, RoPE, attention math, cache plumbing, FFNs.

PyTorch counterparts of ``repro.models.common`` for the dense packed and
batched paths.  :func:`gqa_attention` is the plain attention that the
dense packed branch runs and that the kernels' plain versions
(``repro_torch.kernels.ref``) compose; :func:`blocked_gqa_attention` is the
batched forward's.  Unlike JAX, the cache writers update the cache tensor IN PLACE
(no functional copy of a multi-GB pool per step) and return it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

NEG_INF = -1e30


# --------------------------------------------------------------------------
# initialisers
# --------------------------------------------------------------------------
def param(t: torch.Tensor) -> nn.Parameter:
    """An inference weight: a parameter that takes no gradient."""
    return nn.Parameter(t, requires_grad=False)


def _trunc_normal(shape, generator, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                       generator=generator)


def dense_init(generator, shape, dtype, device,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in init (shape[-2] == fan_in for 2-D weights)."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return (_trunc_normal(shape, generator, device) * scale).to(dtype)


def embed_init(generator, shape, dtype, device) -> torch.Tensor:
    # 1/sqrt(d_model) keeps tied-unembedding logits O(1)
    scale = 1.0 / math.sqrt(shape[-1])
    return (_trunc_normal(shape, generator, device) * scale).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def rms_norm(x, weight, eps: float):
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------
def rope_sin_cos(positions, head_dim: int, theta: float):
    """positions [...,] -> (sin, cos) of shape [..., head_dim//2], fp32."""
    half = head_dim // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freqs            # [..., half]
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, sin, cos):
    """x [..., n_heads, head_dim]; sin/cos broadcastable to [..., 1, hd//2]."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    sin = sin[..., None, :]
    cos = cos[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention math
# --------------------------------------------------------------------------
def gqa_attention(q, k, v, mask):
    """Grouped-query attention.

    q    [B, L, nq, hd]
    k, v [B, S, nk, hd]   (nq % nk == 0)
    mask [B, L, S] bool (True = attend) or broadcastable.

    Returns [B, L, nq, hd].  Scores are fp32 (bf16 products are exact in
    fp32, so upcasting q and k matches JAX's fp32-accumulated einsum);
    probabilities are cast to ``v.dtype`` before the PV product.
    """
    B, L, nq, hd = q.shape
    nk = k.shape[2]
    g = nq // nk
    qg = q.reshape(B, L, nk, g, hd).float()
    scores = torch.einsum("blkgh,bskh->bklgs", qg, k.float())
    scores = scores / math.sqrt(hd)
    m = mask[:, None, :, None, :]                     # [B,1,L,1,S]
    m = torch.broadcast_to(m, scores.shape)
    scores = torch.where(m, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    # rows with no valid key (can happen for padded slots) -> zero output
    any_valid = torch.any(m, dim=-1, keepdim=True)
    probs = torch.where(any_valid, probs, 0.0)
    out = torch.einsum("bklgs,bskh->blkgh", probs.to(v.dtype), v)
    return out.reshape(B, L, nq, hd)


def blocked_gqa_attention(q, k, v, q_pos, *, qb: int = 128,
                          kb: int = 4096):
    """Memory-efficient (flash-style) causal GQA in plain PyTorch: loops
    over query and key blocks with an online softmax, so only ``qb x kb``
    scores per (row, head) live at once instead of ``Lq x S``.  The
    JAX package's ``blocked_gqa_attention`` (full attention).

    q     [B, Lq, nq, hd]
    k, v  [B, S, nk, hd]
    q_pos [B, Lq] absolute positions; key ``j`` (at position ``j``) is
    visible iff ``j <= q_pos``.  A row that sees no key outputs 0.
    """
    B, Lq, nq, hd = q.shape
    S, nk = k.shape[1], k.shape[2]
    g = nq // nk
    scale = 1.0 / math.sqrt(hd)
    kpos = torch.arange(S, dtype=torch.int32, device=q.device)
    out = torch.empty_like(q)
    for q0 in range(0, Lq, qb):
        qblk = q[:, q0:q0 + qb].reshape(B, -1, nk, g, hd).float()
        qp = q_pos[:, q0:q0 + qb, None]                   # [B, qb, 1]
        m = torch.full(qblk.shape[:-1], NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(qblk.shape, device=q.device)
        for k0 in range(0, S, kb):
            kblk, vblk = k[:, k0:k0 + kb], v[:, k0:k0 + kb]
            s = torch.einsum("bqkgh,bskh->bqkgs", qblk, kblk.float()) * scale
            valid = (kpos[None, None, k0:k0 + kb] <= qp)[:, :, None, None]
            s = torch.where(valid, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqkgs,bskh->bqkgh", p.to(v.dtype), vblk).float()
            m = m_new
        o = torch.where(l[..., None] > 0,
                        acc / torch.clamp(l[..., None], min=1e-30), 0.0)
        out[:, q0:q0 + qb] = o.reshape(B, -1, nq, hd).to(q.dtype)
    return out


def causal_cache_mask(q_pos, kv_len: int):
    """Mask for queries at absolute positions ``q_pos`` [B, L] attending a
    cache laid out 0..kv_len-1 by absolute position.  True = attend.
    """
    cols = torch.arange(kv_len, dtype=torch.int32,
                        device=q_pos.device)[None, None, :]
    return cols <= q_pos[:, :, None]


# --------------------------------------------------------------------------
# KV-cache plumbing (in place)
# --------------------------------------------------------------------------
def write_kv_rows(cache, new, start):
    """Write each row's L new tokens at its own offset, in place: cache
    [B, S, nk, hd], new [B, L, nk, hd], start [B].  An offset past
    ``S - L`` is clamped to it, as JAX's ``dynamic_update_slice`` clamps
    (the JAX package's ``write_kv_rows`` semantics)."""
    B, L = new.shape[:2]
    S = cache.shape[1]
    first = torch.clamp(start.long(), 0, max(S - L, 0))
    cols = first[:, None] + torch.arange(L, device=cache.device)
    rows = torch.arange(B, device=cache.device)[:, None]
    cache[rows, cols] = new
    return cache


def write_kv_slot(cache, new, slot, start):
    """Write one sequence's C new tokens into cache row ``slot`` at
    ``start``, in place, with device-side indices only (no host read, so a
    CUDA graph can capture it).

    cache [R, S, nk, hd], new [C, nk, hd] with C <= S; slot/start ints or
    0-dim tensors.  Rows landing past the cache length are DROPPED: a
    padded chunk whose static width spills past max_len must not clamp
    into live positions (the JAX package's ``write_kv_slot`` semantics).
    A dropped row at ``start + i >= S`` writes back, unchanged, the old
    value at ``start + i - C``: those positions lie in ``[S - C, start)``,
    which no kept row writes, so every index is distinct."""
    S, C = cache.shape[1], new.shape[0]
    slot = torch.as_tensor(slot, device=cache.device).long()
    pos = torch.as_tensor(start, device=cache.device).long() + torch.arange(
        C, device=cache.device)
    keep = pos < S
    idx = torch.where(keep, pos, pos - C)
    cache[slot, idx] = torch.where(keep[:, None, None], new,
                                   cache[slot, idx])
    return cache


def gather_block_rows(pool, block_tables):
    """Paged pool -> dense rows: pool [N, bs, ch, hd] x tables [..., M]
    -> [..., M * bs, ch, hd] in logical-position order.  ``ch`` is ``nk``
    for split k/v pools and ``2 * nk`` for the fused pool."""
    bt = block_tables.long()
    rows = pool[bt]
    shp = bt.shape[:-1] + (bt.shape[-1] * pool.shape[1],) + pool.shape[2:]
    return rows.reshape(shp)


def interleave_kv(k, v):
    """Head-interleave K/V for the fused paged pool: k, v [..., nk, hd] ->
    [..., 2 * nk, hd] with K head ``h`` at channel ``2h`` and its V at
    ``2h + 1``."""
    nk = k.shape[-2]
    return torch.stack([k, v], dim=-2).reshape(
        *k.shape[:-2], 2 * nk, k.shape[-1])


def split_fused_kv(rows):
    """Inverse of :func:`interleave_kv`: [..., 2 * nk, hd] -> (k, v) each
    [..., nk, hd].  Pure reshape/slice — bit-exact round trip."""
    nk = rows.shape[-2] // 2
    pairs = rows.reshape(*rows.shape[:-2], nk, 2, rows.shape[-1])
    return pairs[..., 0, :], pairs[..., 1, :]


def write_kv_scatter(cache, new, slots, positions):
    """Scatter one token per row, in place: cache[slots[d], positions[d]]
    = new[d].  cache [R, S, nk, hd], new [D, nk, hd], slots/positions [D].
    """
    cache[slots.long(), positions.long()] = new
    return cache


# --------------------------------------------------------------------------
# feed-forward networks
# --------------------------------------------------------------------------
_ACTS = {
    "silu": F.silu,
    "relu": F.relu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


def glu_ffn(p, x, act: str = "silu"):
    a = _ACTS[act]
    h = a(x @ p.w_gate) * (x @ p.w_up)
    return h @ p.w_down


def mlp_ffn(p, x, act: str = "relu"):
    a = _ACTS[act]
    return a(x @ p.w1 + p.b1) @ p.w2 + p.b2
