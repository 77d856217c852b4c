"""Normalization layers (``repro.layers.norms``)."""

from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.ops import rmsnorm as _rmsnorm_op
from repro_torch.layers.common import ParamSpec


def rmsnorm_params(d: int, name: str = "scale") -> dict:
    return {name: ParamSpec((d,), init="ones")}


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
            zero_centered: bool = False) -> torch.Tensor:
    """RMSNorm; ``zero_centered`` uses (1+scale) gemma-style. On CUDA this
    launches the Triton kernel; on the CPU it runs the plain version."""
    return _rmsnorm_op(x, scale, eps, zero_centered)
