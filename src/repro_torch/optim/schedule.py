"""Learning-rate schedules (``repro.optim.schedule``)."""

from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, warmup: int, total: int, floor: float = 0.1) -> float:
    """Returns an lr *scale* in [floor, 1]: linear warmup, then cosine decay
    to ``floor``; computed in fp32, as the JAX function is."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return float(warm * cos)
