from repro_torch.serving.server import (IterationStats, ServeResult, Server,
                                        build_engine_and_scheduler)

__all__ = ["IterationStats", "ServeResult", "Server",
           "build_engine_and_scheduler"]
