"""PyTorch + CUDA port of the SARATHI reproduction (slice 1).

The decode-maximal hybrid step (one prefill chunk + D piggybacked decodes
packed into one ``[C + D, d]`` matrix) on dense full-attention models,
with the KV cache dense per slot or paged in a fused block pool.  On a
CUDA device the paged attention runs through two hand-written Hopper
kernels (``repro_torch.kernels``); on the CPU through their plain
PyTorch versions.  Imports torch, numpy and the standard library only.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
