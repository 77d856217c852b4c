"""Public RMSNorm wrapper: Triton kernel on CUDA, plain version on the CPU.

The route follows the tensor's device and nothing else. A CUDA tensor
launches the kernel (and raises if it cannot); there is no fallback.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference

_DTYPES = (torch.float32, torch.bfloat16)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
            zero_centered: bool = False) -> torch.Tensor:
    """x: (..., d); scale: (d,). Returns the shape and dtype of x."""
    if x.device.type == "cpu":
        return rmsnorm_reference(x, scale, eps, zero_centered)
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(
            f"rmsnorm: x on {x.device}, scale on {scale.device}; both must be "
            f"on one CUDA device (or x on the CPU)"
        )
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm: unsupported dtypes {x.dtype}/{scale.dtype}")
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"rmsnorm: scale shape {tuple(scale.shape)} != ({d},)")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: x and scale must be contiguous")
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_triton

    out = rmsnorm_triton(x.reshape(-1, d), scale, eps, zero_centered)
    LAUNCHES["rmsnorm"] += 1
    return out.reshape(x.shape)
