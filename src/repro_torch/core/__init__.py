"""SARATHI core: chunked prefills + decode-maximal batching + engine."""
from repro_torch.core.chunking import (Chunk, kv_reload_bytes_factor,
                                       num_chunks, piggyback_coverage,
                                       plan_chunks)
from repro_torch.core.chunk_size import (MXU_TILE, optimal_pd_ratio,
                                         quantized_chunk_size,
                                         select_chunk_size)
from repro_torch.core.engine import (ChunkWork, DecodeWork, Engine,
                                     IterationPlan)
from repro_torch.core.sampling import SamplingParams, sample

__all__ = [
    "Chunk", "plan_chunks", "num_chunks", "kv_reload_bytes_factor",
    "piggyback_coverage", "MXU_TILE", "quantized_chunk_size",
    "optimal_pd_ratio", "select_chunk_size", "Engine", "IterationPlan",
    "ChunkWork", "DecodeWork", "SamplingParams", "sample",
]
