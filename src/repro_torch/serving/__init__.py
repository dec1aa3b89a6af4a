from repro_torch.serving.server import (IterationStats, ServeResult, Server,
                                        build_engine_and_scheduler)
from repro_torch.serving.online import (CostModelExecutor, EngineExecutor,
                                        IterationRecord, OnlineResult,
                                        OnlineServer, serve_online,
                                        serve_online_pipelined)
from repro_torch.serving.metrics import (PipelineStats, RequestTrace,
                                         ServingSummary, Stat, format_table,
                                         percentile, summarize)
from repro_torch.serving.workload import (bursty_arrivals,
                                          multiturn_workload,
                                          online_workload, poisson_arrivals,
                                          shared_prefix_workload,
                                          trace_arrivals, uniform_arrivals)

__all__ = [
    "Server", "ServeResult", "IterationStats", "build_engine_and_scheduler",
    "OnlineServer", "OnlineResult", "IterationRecord", "serve_online",
    "serve_online_pipelined",
    "EngineExecutor", "CostModelExecutor",
    "PipelineStats",
    "RequestTrace", "ServingSummary", "Stat", "percentile", "summarize",
    "format_table",
    "online_workload", "shared_prefix_workload", "multiturn_workload",
    "poisson_arrivals", "uniform_arrivals", "bursty_arrivals",
    "trace_arrivals",
]
