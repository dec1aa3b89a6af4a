from repro_torch.models.packed import PackedBatch, make_packed
from repro_torch.models.registry import Model, build_model
from repro_torch.models.stack import Transformer, init_params

__all__ = ["PackedBatch", "make_packed", "Model", "build_model",
           "Transformer", "init_params"]
