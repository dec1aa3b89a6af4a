"""What the CUDA kernel wrappers share: input checks (what the kernels do
not take raises here, before a launch), the decode kernels' split across
the keys, the launch status check, and the launch counts.

``launches[name]`` goes up by one where a wrapper launches its CUDA
kernel, and nowhere else: a call on CPU tensors (the plain version) does
not count.  It counts wrapper calls, one per attention call, also where
a decode call launches its split kernel and the combine kernel after it.
A run shows that it went through the kernels by zeroing the counts
(:func:`reset_launches`) before it and reading them after.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

# per kernel: the head dims it is built for, and whether one block holds
# the g query heads of a KV head (the decode kernels: g <= MAX_GROUP)
KERNELS: Dict[str, Tuple[Tuple[int, ...], bool]] = {
    "paged_chunked_prefill_attention": ((64, 128, 160), False),
    "paged_decode_attention": ((64, 128, 160), True),
    "chunked_prefill_attention": ((64, 128, 160, 256), False),
    "decode_attention": ((64, 128, 160, 256), True),
}
MAX_GROUP = 16
# the decode kernels' split across the keys: about WAVES waves of the
# blocks the card holds at once (RESIDENT a SM: a split block takes 44-83 KB
# of shared memory, 70 KB at the main path's bf16 head dim 128), and at
# least SPLIT_QUANTUM keys a split (a multiple of it), so that each of a
# block's 4 warps has keys to read
WAVES = 2
RESIDENT = 3
SPLIT_QUANTUM = 128

launches: Dict[str, int] = {name: 0 for name in KERNELS}


def decode_split(capacity: int, n_blocks: int, sms: int) -> Tuple[int, int]:
    """(n_split, split_len) for a decode call whose rows hold ``capacity``
    keys (S, or table entries x block size) over ``n_blocks`` = B x nk
    blocks, on a card of ``sms`` SMs.  Splits of ``split_len`` keys cover
    every key, and none is empty at full capacity.  Only shapes go in: the
    row lengths (``ctx``) stay on the device, so the choice adds no host
    sync (a split past a row's last key writes an empty partial)."""
    want = max(1, -(-WAVES * RESIDENT * sms // max(n_blocks, 1)))
    want = min(want, max(1, -(-capacity // SPLIT_QUANTUM)))
    per = -(-capacity // want)
    split_len = max(SPLIT_QUANTUM, -(-per // SPLIT_QUANTUM) * SPLIT_QUANTUM)
    return max(1, -(-capacity // split_len)), split_len


def decode_workspace(q: torch.Tensor, n_kv_heads: int, capacity: int,
                     sms: int) -> Tuple[int, int, torch.Tensor]:
    """The split of a decode call on q [B, nq, hd] over rows of
    ``capacity`` keys, and its fp32 workspace of B x nq x n_split x
    (hd + 2) partials (empty when n_split == 1), allocated on q's device
    and current stream."""
    B, nq, hd = q.shape
    n_split, split_len = decode_split(capacity, B * n_kv_heads, sms)
    size = B * nq * n_split * (hd + 2) if n_split > 1 else 0
    return n_split, split_len, torch.empty((size,), dtype=torch.float32,
                                           device=q.device)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The number of SMs of a CUDA device (read once per device)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor) -> int:
    return _DTYPES[t.dtype]


def check_inputs(name: str, q: torch.Tensor, n_kv_heads: int,
                 kv: Dict[str, Tuple[torch.Tensor, tuple]],
                 ints: Dict[str, Tuple[torch.Tensor, tuple]]) -> None:
    """q [T, nq, hd] on a CUDA device, 16-byte aligned; ``kv`` maps a name
    to (tensor of q's dtype, expected shape), each 16-byte aligned; ``ints``
    maps a name to (int32 tensor, expected shape); all on q's device,
    contiguous."""
    head_dims, grouped = KERNELS[name]
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
    if q.device.type != "cuda":
        raise ValueError(f"{name}: q on {q.device}, expected cpu or cuda")
    if q.data_ptr() % 16:
        raise ValueError(f"{name}: q must be 16-byte aligned")
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
