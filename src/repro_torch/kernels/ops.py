"""Public entry points of the attention kernels, with their launch counts
(``launches``, see :mod:`repro_torch.kernels.launch`)."""
from repro_torch.kernels.chunked_prefill_attention import \
    chunked_prefill_attention
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.launch import launches, reset_launches
from repro_torch.kernels.paged_chunked_prefill_attention import \
    paged_chunked_prefill_attention
from repro_torch.kernels.paged_decode_attention import paged_decode_attention

__all__ = ["launches", "reset_launches", "chunked_prefill_attention",
           "decode_attention", "paged_chunked_prefill_attention",
           "paged_decode_attention"]
