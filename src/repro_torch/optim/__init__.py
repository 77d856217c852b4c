"""Optimizer (``repro.optim``): AdamW with fp32 master weights and the
cosine schedule. The int8 gradient compression of the cross-pod hop
(``repro.optim.compression``) waits for the distribution slice (ROADMAP.md
Queue 1, item 6)."""

from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "cosine_schedule"]
