from repro_torch.scheduler.request import Request, State
from repro_torch.scheduler.policies import (POLICIES, OrcaScheduler,
                                            RequestLevelScheduler,
                                            SarathiScheduler, Scheduler)
from repro_torch.scheduler.budget import (BUDGETED_POLICIES,
                                          CHUNKED_POLICIES, PREFIX_POLICIES,
                                          SWAP_POLICIES,
                                          SarathiServeScheduler)

__all__ = ["Request", "State", "Scheduler", "SarathiScheduler",
           "OrcaScheduler", "RequestLevelScheduler", "SarathiServeScheduler",
           "POLICIES", "CHUNKED_POLICIES", "BUDGETED_POLICIES",
           "PREFIX_POLICIES", "SWAP_POLICIES"]
