from repro_torch.sim.hardware import (A100, A6000, PROFILES, TPU_V5E,
                                      Hardware)
from repro_torch.sim.cost_model import (BatchSpec, CostBreakdown, DecodeSeg,
                                        PrefillSeg, chunked_prefill_total,
                                        decode_time, hybrid_time,
                                        iteration_time, kv_handoff_bytes,
                                        kv_swap_bytes, kv_swap_time,
                                        kv_transfer_time, prefill_time,
                                        sp_activation_bytes,
                                        tp_all_gather_time,
                                        tp_allreduce_time,
                                        tp_reduce_scatter_time)
from repro_torch.sim.pipeline import (PipelineResult, plan_time,
                                      plan_to_spec, simulate_pipeline)

__all__ = [
    "Hardware", "A6000", "A100", "TPU_V5E", "PROFILES", "BatchSpec",
    "PrefillSeg", "DecodeSeg", "CostBreakdown", "iteration_time",
    "prefill_time", "decode_time", "hybrid_time", "chunked_prefill_total",
    "tp_allreduce_time", "tp_reduce_scatter_time", "tp_all_gather_time",
    "sp_activation_bytes", "kv_transfer_time", "kv_handoff_bytes",
    "kv_swap_time", "kv_swap_bytes",
    "PipelineResult", "simulate_pipeline", "plan_to_spec", "plan_time",
]
