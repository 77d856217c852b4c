from repro_torch.serve.serve import (
    BatchScheduler,
    RequestHandle,
    ServeConfig,
    cache_pspec_tree,
    make_decode_step,
    make_encoder_step,
    make_prefill_step,
    serve_cache_pspecs,
)
from repro_torch.serve.traffic import (
    TrafficConfig,
    TrafficRequest,
    generate_workload,
    replay,
)

__all__ = [
    "ServeConfig", "BatchScheduler", "RequestHandle", "cache_pspec_tree",
    "make_decode_step", "make_encoder_step", "make_prefill_step", "serve_cache_pspecs",
    "TrafficConfig", "TrafficRequest", "generate_workload", "replay",
]
