from repro_torch.data.pipeline import (DataConfig, SyntheticLM,
                                       serving_workload, shard_batch,
                                       zipf_lengths)

__all__ = ["DataConfig", "SyntheticLM", "shard_batch", "zipf_lengths",
           "serving_workload"]
