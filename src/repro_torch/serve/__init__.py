from repro_torch.serve.serve import BatchScheduler, RequestHandle, ServeConfig
from repro_torch.serve.traffic import (
    TrafficConfig,
    TrafficRequest,
    generate_workload,
    replay,
)

__all__ = [
    "ServeConfig", "BatchScheduler", "RequestHandle",
    "TrafficConfig", "TrafficRequest", "generate_workload", "replay",
]
