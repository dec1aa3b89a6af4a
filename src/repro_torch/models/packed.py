"""The SARATHI packed (hybrid) batch representation.

A *decode-maximal* batch is ONE prefill chunk of ``C`` tokens belonging to a
single request plus ``D`` piggybacked decode tokens (one token each from ``D``
other requests).  All token-parallel linear operators run over the packed
``[C + D, d_model]`` matrix; only attention treats the two segments
separately.  ``C == 0`` is a pure decode batch, ``D == 0`` a pure prefill
chunk step — both served by the same code path.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class PackedBatch:
    """One SARATHI iteration's worth of work, as int32 tensors on the
    model's device (field meanings as in ``repro.models.packed``):

    chunk_tokens  [C]  token ids of the prefill chunk (C may be 0)
    chunk_slot    []   cache row of the chunk's request
    chunk_start   []   tokens of this request already prefilled
    chunk_len     []   VALID tokens in the chunk (<= C); the rest is padding
    decode_tokens [D]  last sampled token of each piggybacked request
    decode_slots  [D]  cache rows
    decode_ctx    [D]  context length (== position of the new token)
    chunk_blocks  [M]  paged: the chunk request's block table, padded with
                       the scratch block 0 (M == 0 <=> dense mode)
    decode_blocks [D, M] paged: ditto per piggybacked decode
    """
    chunk_tokens: torch.Tensor
    chunk_slot: torch.Tensor
    chunk_start: torch.Tensor
    chunk_len: torch.Tensor
    decode_tokens: torch.Tensor
    decode_slots: torch.Tensor
    decode_ctx: torch.Tensor
    chunk_blocks: torch.Tensor
    decode_blocks: torch.Tensor

    @property
    def num_chunk(self) -> int:
        return self.chunk_tokens.shape[0]

    @property
    def num_decode(self) -> int:
        return self.decode_tokens.shape[0]

    def positions(self) -> torch.Tensor:
        """Absolute position of every packed token, shape [C + D]."""
        cpos = self.chunk_start + torch.arange(
            self.num_chunk, dtype=torch.int32, device=self.chunk_tokens.device)
        return torch.cat([cpos.to(torch.int32),
                          self.decode_ctx.to(torch.int32)])

    def token_ids(self) -> torch.Tensor:
        return torch.cat([self.chunk_tokens.to(torch.int32),
                          self.decode_tokens.to(torch.int32)])


def make_packed(chunk_tokens=None, chunk_slot=0, chunk_start=0,
                chunk_len=None, decode_tokens=None, decode_slots=None,
                decode_ctx=None, chunk_blocks=None, decode_blocks=None,
                device=None) -> PackedBatch:
    """Convenience constructor with numpy/python inputs."""
    def i32(x):
        return torch.as_tensor(x, dtype=torch.int32, device=device)

    ct = i32(chunk_tokens if chunk_tokens is not None else [])
    dt = i32(decode_tokens if decode_tokens is not None else [])
    D = dt.shape[0]
    cb = i32(chunk_blocks if chunk_blocks is not None else [])
    return PackedBatch(
        chunk_tokens=ct,
        chunk_slot=i32(chunk_slot),
        chunk_start=i32(chunk_start),
        chunk_len=i32(chunk_len if chunk_len is not None else ct.shape[0]),
        decode_tokens=dt,
        decode_slots=i32(decode_slots if decode_slots is not None
                         else [0] * D),
        decode_ctx=i32(decode_ctx if decode_ctx is not None else [0] * D),
        chunk_blocks=cb,
        decode_blocks=(i32(decode_blocks) if decode_blocks is not None
                       else torch.zeros((D, cb.shape[0]), dtype=torch.int32,
                                        device=device)),
    )
