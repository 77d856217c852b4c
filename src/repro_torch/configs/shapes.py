"""Assigned input shapes (``repro.configs.shapes``): 4 per arch, 40 cells
over the ten archs, and the rules that skip a cell.

A shape is a mode (train, prefill or decode) at a sequence length and a
global batch; an encoder-only arch runs its prefill cells as a full
encoder forward (``effective_mode``) and has no decode cells.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


SHAPES = (
    InputShape("train_4k", 4_096, 256, "train"),
    InputShape("prefill_32k", 32_768, 32, "prefill"),
    InputShape("decode_32k", 32_768, 128, "decode"),
    InputShape("long_500k", 524_288, 1, "decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}

_RECURRENT = ("mamba2", "mlstm", "slstm")


def skip_reason(cfg, shape: InputShape) -> str | None:
    """Why this (arch x shape) cell is skipped, or None if it runs."""
    for name, reason in cfg.skips:
        if name == shape.name:
            return reason
    if cfg.encoder_only and shape.mode == "decode":
        return "encoder-only architecture has no decode step"
    if shape.name == "long_500k" and not any(k in _RECURRENT for k in cfg.pattern):
        return ("pure full-attention arch: O(L^2) prefill and 500k-token KV "
                "scores exceed the memory budget; run only for SSM/hybrid")
    return None


def effective_mode(cfg, shape: InputShape) -> str:
    """Encoder archs run prefill as a full encoder forward."""
    if cfg.encoder_only and shape.mode == "prefill":
        return "encoder"
    return shape.mode
