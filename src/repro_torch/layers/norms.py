"""Normalization layers (``repro.layers.norms``)."""

from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.ops import rmsnorm as _rmsnorm_op
from repro_torch.layers.common import ParamSpec


def rmsnorm_params(d: int, name: str = "scale") -> dict:
    return {name: ParamSpec((d,), init="ones")}


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
            zero_centered: bool = False) -> torch.Tensor:
    """RMSNorm; ``zero_centered`` uses (1+scale) gemma-style. Differentiable:
    on CUDA the forward and backward launch the kernels of
    ``csrc/rmsnorm.cu``; on the CPU the plain version runs and autograd
    differentiates it."""
    return _rmsnorm_op(x, scale, eps, zero_centered)
