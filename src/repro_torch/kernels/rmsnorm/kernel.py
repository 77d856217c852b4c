"""Fused RMSNorm for Hopper, in Triton.

Replaces: ``repro/kernels/rmsnorm/kernel.py`` ``_rmsnorm_kernel`` (launched
by ``rmsnorm_pallas``).

Bound on the H100: bytes. A row of d elements is read once and written
once, and the work is ~4 operations per element, far below the ~295
operations per byte at which the tensor cores would become the limit.

Design: one program per row. The row is loaded once into registers as a
power-of-two ``BLOCK`` with a mask past the true ``d`` (in place of the
TPU kernel's padding to the 128-lane width; masked lanes load 0 and the
mean divides by the true ``d``), reduced in fp32, scaled and stored: one
read and one write per element, with nothing staged in device memory.

``triton`` is imported when the kernel is first built, never when this
module is imported: machines without Triton still import the package.
The kernel body reads ``tl`` as a module global, which ``_build`` binds.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build

tl = None  # triton.language, bound by _build() before the first compile


def _rmsnorm_rows(X, S, O, d, stride_x, stride_o, eps,
                  ZERO_CENTERED: "tl.constexpr", BLOCK: "tl.constexpr"):
    row = tl.program_id(0)
    cols = tl.arange(0, BLOCK)
    mask = cols < d
    x = tl.load(X + row * stride_x + cols, mask=mask, other=0.0).to(tl.float32)
    var = tl.sum(x * x, axis=0) / d
    y = x * (1.0 / tl.sqrt(var + eps))
    s = tl.load(S + cols, mask=mask, other=0.0).to(tl.float32)
    if ZERO_CENTERED:
        s = 1.0 + s
    tl.store(O + row * stride_o + cols, (y * s).to(O.dtype.element_ty), mask=mask)


@functools.cache
def _build():
    global tl
    build.triton_cache_dir()
    import triton
    import triton.language

    tl = triton.language
    return triton, triton.jit(_rmsnorm_rows)


def compile_kernel() -> None:
    """Import Triton and build the jitted kernel object (compiles at launch)."""
    _build()


def rmsnorm_triton(x2: torch.Tensor, scale: torch.Tensor, eps: float,
                   zero_centered: bool) -> torch.Tensor:
    """x2: (rows, d) CUDA, last dim contiguous; scale: (d,). Returns (rows, d)."""
    triton, kernel = _build()
    rows, d = x2.shape
    out = torch.empty_like(x2)
    block = triton.next_power_of_2(d)
    num_warps = 4 if block <= 1024 else 8
    kernel[(rows,)](
        x2, scale, out, d, x2.stride(0), out.stride(0), float(eps),
        ZERO_CENTERED=bool(zero_centered), BLOCK=block, num_warps=num_warps,
    )
    return out
