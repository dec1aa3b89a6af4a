"""What the CUDA kernel wrappers share: input checks (what the kernels do
not take raises here, before a launch), the launch status check, and the
launch counts.

``launches[name]`` goes up by one where a wrapper launches its CUDA
kernel, and nowhere else: a call on CPU tensors (the plain version) does
not count.  A run shows that it went through the kernels by zeroing the
counts (:func:`reset_launches`) before it and reading them after.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

launches: Dict[str, int] = {
    "paged_chunked_prefill_attention": 0,
    "paged_decode_attention": 0,
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
MAX_GROUP = 16          # query heads per KV head a decode block holds


def dtype_code(t: torch.Tensor) -> int:
    return _DTYPES[t.dtype]


def check_inputs(name: str, q: torch.Tensor, pool_kv: torch.Tensor,
                 ints: Dict[str, Tuple[torch.Tensor, tuple]]) -> None:
    """q [T, nq, hd] and pool_kv [N, bs, 2 * nk, hd] of one dtype on one
    CUDA device, contiguous; ``ints`` maps a name to (int32 tensor,
    expected shape)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: q on {q.device}, expected cpu or cuda")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype} not in "
                        f"{sorted(map(str, _DTYPES))}")
    if pool_kv.dtype != q.dtype:
        raise TypeError(f"{name}: pool {pool_kv.dtype} != q {q.dtype}")
    if q.dim() != 3 or pool_kv.dim() != 4:
        raise ValueError(f"{name}: q must be 3-D, pool_kv 4-D")
    hd = q.shape[2]
    nch = pool_kv.shape[2]
    if hd not in HEAD_DIMS or pool_kv.shape[3] != hd:
        raise ValueError(f"{name}: head_dim {hd} (pool {pool_kv.shape[3]}) "
                         f"not in {HEAD_DIMS}")
    if nch % 2 or q.shape[1] % (nch // 2):
        raise ValueError(f"{name}: {q.shape[1]} query heads do not group "
                         f"over {nch // 2} KV heads")
    if q.shape[1] // (nch // 2) > MAX_GROUP:
        raise ValueError(f"{name}: group size {q.shape[1] // (nch // 2)} "
                         f"> {MAX_GROUP}")
    tensors = {"q": q, "pool_kv": pool_kv}
    for key, (t, shape) in ints.items():
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise TypeError(f"{name}: {key} must be an int32 tensor")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} shape {tuple(t.shape)} != "
                             f"{shape}")
        tensors[key] = t
    for key, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name}: {key} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if pool_kv.data_ptr() % 16:
        raise ValueError(f"{name}: pool_kv must be 16-byte aligned")


def launch_status(name: str, rc: int) -> None:
    """Raise if the C entry returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError "
                           f"{rc}")
