from repro_torch.scheduler.request import Request, State
from repro_torch.scheduler.policies import (CHUNKED_POLICIES, POLICIES,
                                            OrcaScheduler,
                                            RequestLevelScheduler,
                                            SarathiScheduler, Scheduler)

__all__ = ["Request", "State", "Scheduler", "SarathiScheduler",
           "OrcaScheduler", "RequestLevelScheduler", "POLICIES",
           "CHUNKED_POLICIES"]
