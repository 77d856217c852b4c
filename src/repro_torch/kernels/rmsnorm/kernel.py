"""Fused RMSNorm for Hopper, in Triton: the forward and its backward.

Replaces: ``repro/kernels/rmsnorm/kernel.py`` ``_rmsnorm_kernel`` (launched
by ``rmsnorm_pallas``). The backward (dx, dscale) has no Pallas
counterpart: the JAX training step differentiates the jnp ``rmsnorm``.

Bound on the H100: bytes. A row of d elements is read once and written
once (the backward reads x and dy and writes dx), and the work is ~4-8
operations per element, far below the ~295 operations per byte at which
the tensor cores would become the limit.

Design. Forward: one program per row. The row is loaded once into
registers as a power-of-two ``BLOCK`` with a mask past the true ``d`` (in
place of the TPU kernel's padding to the 128-lane width; masked lanes load
0 and the mean divides by the true ``d``), reduced in fp32, scaled and
stored: one read and one write per element, with nothing staged in device
memory. Backward: each program takes a contiguous run of rows; per row it
recomputes rstd from x (so the forward saves nothing but its inputs) and
writes ``dx = rstd * (s*dy - xhat * mean(xhat * s*dy))`` with ``s`` the
scale (or 1 + scale, zero-centred), and it sums ``dy * xhat`` over its rows
in fp32 registers into one row of a ``(programs, d)`` buffer; a second
program reduces that buffer over programs into dscale. The order of every
sum is fixed by the partition, so the gradients are deterministic.

``triton`` is imported when a kernel is first built, never when this
module is imported: machines without Triton still import the package.
The kernel bodies read ``tl`` as a module global, which ``_build`` binds.
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


def _rmsnorm_bwd_rows(X, S, DY, DX, DS_PART, rows, d, rows_per_prog, stride_x,
                      stride_dy, stride_dx, eps,
                      ZERO_CENTERED: "tl.constexpr", BLOCK: "tl.constexpr"):
    pid = tl.program_id(0)
    cols = tl.arange(0, BLOCK)
    mask = cols < d
    s = tl.load(S + cols, mask=mask, other=0.0).to(tl.float32)
    if ZERO_CENTERED:
        s = 1.0 + s
    ds = tl.zeros((BLOCK,), dtype=tl.float32)
    for i in range(0, rows_per_prog):
        row = pid * rows_per_prog + i
        m = mask & (row < rows)
        x = tl.load(X + row * stride_x + cols, mask=m, other=0.0).to(tl.float32)
        dy = tl.load(DY + row * stride_dy + cols, mask=m, other=0.0).to(tl.float32)
        rstd = 1.0 / tl.sqrt(tl.sum(x * x, axis=0) / d + eps)
        xhat = x * rstd
        g = dy * s
        c = tl.sum(g * xhat, axis=0) / d
        tl.store(DX + row * stride_dx + cols,
                 (rstd * (g - xhat * c)).to(DX.dtype.element_ty), mask=m)
        ds += dy * xhat
    tl.store(DS_PART + pid * d + cols, ds, mask=mask)


def _column_sums(P, OUT, n, d, BLOCK: "tl.constexpr"):
    cols = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = cols < d
    acc = tl.zeros((BLOCK,), dtype=tl.float32)
    for r in range(0, n):
        acc += tl.load(P + r * d + cols, mask=mask, other=0.0)
    tl.store(OUT + cols, acc.to(OUT.dtype.element_ty), mask=mask)


@functools.cache
def _build():
    global tl
    build.triton_cache_dir()
    import triton
    import triton.language

    tl = triton.language
    return (triton, triton.jit(_rmsnorm_rows), triton.jit(_rmsnorm_bwd_rows),
            triton.jit(_column_sums))


def compile_kernel() -> None:
    """Import Triton and build the jitted kernel objects (they compile at
    their first launch)."""
    _build()


@functools.cache
def _programs(device_index: int) -> int:
    """Backward programs: four per SM, enough to cover the card."""
    return 4 * torch.cuda.get_device_properties(device_index).multi_processor_count


def rmsnorm_triton(x2: torch.Tensor, scale: torch.Tensor, eps: float,
                   zero_centered: bool) -> torch.Tensor:
    """x2: (rows, d) CUDA, last dim contiguous; scale: (d,). Returns (rows, d)."""
    triton, kernel, _, _ = _build()
    rows, d = x2.shape
    out = torch.empty_like(x2)
    block = triton.next_power_of_2(d)
    num_warps = 4 if block <= 1024 else 8
    kernel[(rows,)](
        x2, scale, out, d, x2.stride(0), out.stride(0), float(eps),
        ZERO_CENTERED=bool(zero_centered), BLOCK=block, num_warps=num_warps,
    )
    return out


def rmsnorm_backward_triton(x2: torch.Tensor, scale: torch.Tensor, dy2: torch.Tensor,
                            eps: float, zero_centered: bool):
    """x2, dy2: (rows, d) CUDA, last dim contiguous; scale: (d,). Returns
    (dx (rows, d) in x2's dtype, dscale (d,) in scale's dtype)."""
    triton, _, bwd, colsum = _build()
    rows, d = x2.shape
    dx = torch.empty_like(x2)
    per = max(1, -(-rows // _programs(x2.device.index or 0)))
    progs = max(1, -(-rows // per))
    part = torch.empty((progs, d), dtype=torch.float32, device=x2.device)
    block = triton.next_power_of_2(d)
    bwd[(progs,)](
        x2, scale, dy2, dx, part, rows, d, per, x2.stride(0), dy2.stride(0),
        dx.stride(0), float(eps), ZERO_CENTERED=bool(zero_centered), BLOCK=block,
        num_warps=4 if block <= 1024 else 8,
    )
    dscale = torch.empty_like(scale)
    cb = 256
    colsum[(triton.cdiv(d, cb),)](part, dscale, progs, d, BLOCK=cb, num_warps=4)
    return dx, dscale
