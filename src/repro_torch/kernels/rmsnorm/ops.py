"""Public RMSNorm wrapper: Triton kernels on CUDA, plain version on the CPU.

The route follows the tensor's device and nothing else. A CPU tensor runs
the plain version, which autograd differentiates. A CUDA tensor goes
through ``_RMSNorm``, whose forward launches the forward kernel and whose
backward launches the backward kernels (and raises if they cannot); there
is no fallback.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, record_cost
from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference

_DTYPES = (torch.float32, torch.bfloat16)


def _check(x: torch.Tensor, scale: torch.Tensor) -> int:
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
    return d


def _bytes(x, scale, tensors: int) -> float:
    return tensors * x.numel() * x.element_size() + scale.numel() * scale.element_size()


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps, zero_centered):
        from repro_torch.kernels.rmsnorm.kernel import rmsnorm_triton

        d = _check(x, scale)
        out = rmsnorm_triton(x.reshape(-1, d), scale, eps, zero_centered)
        LAUNCHES["rmsnorm"] += 1
        record_cost("rmsnorm", lambda: (4 * x.numel(), _bytes(x, scale, 2)))
        ctx.save_for_backward(x, scale)
        ctx.opts = (eps, zero_centered)
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        from repro_torch.kernels.rmsnorm.kernel import rmsnorm_backward_triton

        x, scale = ctx.saved_tensors
        eps, zero_centered = ctx.opts
        d = _check(x, scale)
        dy = dy.to(x.dtype).contiguous()
        dx, dscale = rmsnorm_backward_triton(x.reshape(-1, d), scale, dy.reshape(-1, d),
                                             eps, zero_centered)
        LAUNCHES["rmsnorm_backward"] += 1
        record_cost("rmsnorm_backward", lambda: (8 * x.numel(), _bytes(x, scale, 3)))
        return dx.reshape(x.shape), dscale, None, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
            zero_centered: bool = False) -> torch.Tensor:
    """x: (..., d); scale: (d,). Returns the shape and dtype of x;
    differentiable in x and scale."""
    if x.device.type == "cpu":
        return rmsnorm_reference(x, scale, eps, zero_centered)
    return _RMSNorm.apply(x, scale, eps, zero_centered)
