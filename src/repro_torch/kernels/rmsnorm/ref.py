"""Plain PyTorch RMSNorm: the oracle for the CUDA kernels and the CPU path.

Transcribes ``repro.layers.norms.rmsnorm``: upcast to fp32 (float64 stays
float64), mean of x^2 over the last axis, ``x * (var + eps) ** -0.5 *
scale`` (``1 + scale`` when zero-centred), cast back to ``x.dtype``.
``rmsnorm_backward_reference`` is the plain version of the backward:
autograd through it.
"""

from __future__ import annotations

import torch


def rmsnorm_reference(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
                      zero_centered: bool = False) -> torch.Tensor:
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * (var + eps) ** -0.5
    s = scale.to(xf.dtype)
    if zero_centered:
        s = 1.0 + s
    return (y * s).to(x.dtype)


def rmsnorm_backward_reference(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                               eps: float = 1e-6, zero_centered: bool = False):
    """(dx, dscale) of ``rmsnorm_reference`` for the cotangent ``dy``."""
    with torch.enable_grad():
        xl, sl = x.detach().requires_grad_(True), scale.detach().requires_grad_(True)
        return torch.autograd.grad(rmsnorm_reference(xl, sl, eps, zero_centered),
                                   (xl, sl), dy)
