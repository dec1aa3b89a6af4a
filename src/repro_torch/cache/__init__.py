"""Paged KV-cache bookkeeping: a copy of the JAX package's numpy-only
:class:`BlockManager` (free list, per-request block tables, reserved
scratch block 0).  The pool tensors themselves live in the model's cache
(``repro_torch.models.blocks.init_paged_attn_cache``)."""
from repro_torch.cache.block_manager import BlockManager, PoolExhausted

__all__ = ["BlockManager", "PoolExhausted"]
