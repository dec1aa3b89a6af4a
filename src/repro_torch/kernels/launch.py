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

# per kernel: the head dims it is built for, and whether one block holds
# the g query heads of a KV head (the decode kernels: g <= MAX_GROUP)
KERNELS: Dict[str, Tuple[Tuple[int, ...], bool]] = {
    "paged_chunked_prefill_attention": ((64, 128), False),
    "paged_decode_attention": ((64, 128), True),
    "chunked_prefill_attention": ((64, 128, 256), False),
    "decode_attention": ((64, 128, 256), True),
}
MAX_GROUP = 16

launches: Dict[str, int] = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor) -> int:
    return _DTYPES[t.dtype]


def check_inputs(name: str, q: torch.Tensor, n_kv_heads: int,
                 kv: Dict[str, Tuple[torch.Tensor, tuple]],
                 ints: Dict[str, Tuple[torch.Tensor, tuple]]) -> None:
    """q [T, nq, hd] on a CUDA device; ``kv`` maps a name to (tensor of
    q's dtype, expected shape), each 16-byte aligned; ``ints`` maps a name
    to (int32 tensor, expected shape); all on q's device, contiguous."""
    head_dims, grouped = KERNELS[name]
    if q.device.type != "cuda":
        raise ValueError(f"{name}: q on {q.device}, expected cpu or cuda")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype} not in "
                        f"{sorted(map(str, _DTYPES))}")
    if q.dim() != 3:
        raise ValueError(f"{name}: q must be 3-D, got {tuple(q.shape)}")
    hd = q.shape[2]
    if hd not in head_dims:
        raise ValueError(f"{name}: head_dim {hd} not in {head_dims}")
    nq = q.shape[1]
    if n_kv_heads <= 0 or nq % n_kv_heads:
        raise ValueError(f"{name}: {nq} query heads do not group over "
                         f"{n_kv_heads} KV heads")
    if grouped and nq // n_kv_heads > MAX_GROUP:
        raise ValueError(f"{name}: group size {nq // n_kv_heads} > "
                         f"{MAX_GROUP}")
    tensors = {"q": q}
    for key, (t, shape) in {**kv, **ints}.items():
        want = q.dtype if key in kv else torch.int32
        if not isinstance(t, torch.Tensor) or t.dtype != want:
            raise TypeError(f"{name}: {key} must be a {want} tensor")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} shape {tuple(t.shape)} != "
                             f"{shape}")
        if key in kv and t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")
        tensors[key] = t
    for key, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name}: {key} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def launch_status(name: str, rc: int) -> None:
    """Raise if the C entry returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError "
                           f"{rc}")
