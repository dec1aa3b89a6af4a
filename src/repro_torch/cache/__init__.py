"""Paged KV-cache bookkeeping: copies of the JAX package's numpy-only
:class:`BlockManager` (free list, per-request block tables, reserved
scratch block 0, refcounted sharing with copy-on-write forks) and
:class:`PrefixCache` (the token-keyed index of committed blocks).  The
pool tensors themselves live in the model's cache
(``repro_torch.models.blocks.init_paged_attn_cache``)."""
from repro_torch.cache.block_manager import BlockManager, PoolExhausted
from repro_torch.cache.prefix_cache import PrefixCache

__all__ = ["BlockManager", "PoolExhausted", "PrefixCache"]
