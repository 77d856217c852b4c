"""Optimizer (``repro.optim``): AdamW with fp32 master weights, the
cosine schedule, and the int8 gradient compression of the cross-pod hop
(``optim.compression``)."""

from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    global_norm,
    optimizer_pspecs,
)
from repro_torch.optim.compression import compress_int8, decompress_int8
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm", "optimizer_pspecs",
           "cosine_schedule", "compress_int8", "decompress_int8"]
