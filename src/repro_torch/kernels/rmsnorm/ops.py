"""Public RMSNorm wrapper: CUDA kernels on the card, plain version on the CPU.

The route follows the tensor's device and nothing else. A CPU tensor runs
the plain version in ``ref.py``, which autograd differentiates. A CUDA
tensor launches ``csrc/rmsnorm.cu`` through ``ctypes`` on PyTorch's current
stream, or raises; nothing falls back. A tensor on the meta device (a
step counted without running, ``launch.dryrun``) takes the meta route:
the launchers allocate what a launch would, on the meta device, report
the launch's cost through ``record_cost`` and launch nothing (``LAUNCHES``
stays as it was).

- When no gradient can flow (``torch.is_grad_enabled()`` is false, as under
  the serving path's ``torch.inference_mode()``, or neither ``x`` nor
  ``scale`` requires grad) the forward kernel is launched directly: no
  ``autograd.Function`` runs.
- Otherwise ``_RMSNorm`` runs: its forward launches the forward kernel and
  saves only the inputs; its backward launches the row pass (dx and one
  fp32 partial row of dscale a block) and the dscale combine.

``plan`` lays a row over the threads and partitions the rows into the
backward's blocks from the shapes, the dtype and the SM count alone, so
both gradients are bitwise repeatable.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import LAUNCHES, build, record_cost
from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference

_DTYPES = (torch.float32, torch.bfloat16)

# The library's limits (checked against it when it is loaded) and the plan's
# choices: a block is a team of at most 16 warps that owns a row at a time,
# each thread holding at most MAX_EPT elements of a tensor in VPT 16-byte
# accesses (or SCALAR_VPT single elements). The forward gives each row a
# block of its own and loads it when the block starts; the backward's
# BWD_BLOCKS_PER_SM blocks an SM each walk a run of consecutive rows with
# the loads of up to BWD_RING rows in flight (a ring in at most RING_BYTES
# of shared memory; 0, a row loaded when it is reached, on the scalar path
# and for rows too wide for a slot). Both choices are the fastest of
# tools/rmsnorm_variants.py's sweep at the training shape (PERF.md).
MAX_D = 8192
MAX_EPT = 16
MAX_WARPS = 16
SCALAR_VPT = 16
COMBINE_WARPS = 32
MAX_RING = 8
RING_BYTES = 40 * 1024
BWD_BLOCKS_PER_SM = 4
BWD_RING = 2
H100_SMS = 132

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the current stream's raw pointer, without building a Stream object
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


class Plan(NamedTuple):
    vec: bool        # 16-byte accesses (else one element an access)
    vpt: int         # accesses a thread makes on a row
    warps: int       # warps a block (the team that owns a row)
    fwd_blocks: int  # forward blocks
    fwd_per: int     # consecutive rows a forward block walks
    fwd_ring: int    # rows whose loads a forward block keeps in flight (0: none)
    blocks: int      # backward blocks
    per: int         # consecutive rows a backward block walks
    ring: int        # rows whose loads a backward block keeps in flight


def partition(rows: int, blocks_per_sm: int, sms: int) -> tuple[int, int]:
    """(blocks, rows a block): runs of equal length over about
    ``blocks_per_sm`` blocks an SM, none empty."""
    per = max(1, -(-rows // (blocks_per_sm * sms)))
    return max(1, -(-rows // per)), per


@functools.lru_cache(maxsize=256)
def plan(rows: int, d: int, itemsize: int, sms: int = H100_SMS, vector: bool = True) -> Plan:
    """The launch layout for a (rows, d) tensor of ``itemsize``-byte
    elements on a card of ``sms`` SMs; ``vector`` when the tensors are
    16-byte aligned and d a multiple of the 16-byte vector. The row
    partitions read only ``rows`` and ``sms``."""
    if not 1 <= d <= MAX_D:
        raise ValueError(f"rmsnorm kernel: width {d} outside 1..{MAX_D}")
    n = 16 // itemsize if vector else 1
    if d % n:
        raise ValueError(f"rmsnorm kernel: width {d} is not a multiple of the vector {n}")
    nv = d // n
    vmax = MAX_EPT // n if vector else SCALAR_VPT
    warps = 1
    while 32 * warps * vmax < nv:
        warps *= 2
    vpt = SCALAR_VPT
    if vector:
        vpt = 1
        while 32 * warps * vpt < nv:
            vpt *= 2
    slot = 16 * vpt * 32 * warps  # ring bytes a row of one tensor takes

    def ring(want: int, tensors: int) -> int:
        return min(want, RING_BYTES // (tensors * slot)) if vector else 0

    return Plan(vector, vpt, warps, max(1, rows), 1, 0,
                *partition(rows, BWD_BLOCKS_PER_SM, sms), ring(BWD_RING, 2))


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(build.load_library("rmsnorm"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``csrc/rmsnorm.cu``
    and check its limits against the plan's."""
    lib.rmsnorm_fwd_launch.argtypes = [_P] * 3 + [_I] * 5 + [_F] + [_I] * 6 + [_P]
    lib.rmsnorm_fwd_launch.restype = _I
    lib.rmsnorm_bwd_launch.argtypes = [_P] * 6 + [_I] * 5 + [_F] + [_I] * 6 + [_P]
    lib.rmsnorm_bwd_launch.restype = _I
    for name, want in (("rmsnorm_max_d", MAX_D), ("rmsnorm_max_ept", MAX_EPT),
                       ("rmsnorm_scalar_vpt", SCALAR_VPT),
                       ("rmsnorm_combine_warps", COMBINE_WARPS),
                       ("rmsnorm_max_ring", MAX_RING), ("rmsnorm_ring_bytes", RING_BYTES)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [], _I
        if fn() != want:
            raise RuntimeError(f"rmsnorm library: {name}() = {fn()}, the plan assumes {want}")
    return lib


def load() -> None:
    """Build (if needed) and load the CUDA library."""
    _lib()


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _stream(dev: int) -> int:
    if _raw_stream is not None:
        return _raw_stream(dev)
    return torch.cuda.current_stream(dev).cuda_stream


def _check(x: torch.Tensor, scale: torch.Tensor) -> int:
    """d of inputs the kernels take; raises for others. (Cheap accessors
    only: the serving path calls this 45 times a forward.)"""
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm kernel: dtypes x={x.dtype} scale={scale.dtype}; "
                        f"need float32 or bfloat16")
    d = x.shape[-1]
    if scale.dim() != 1 or scale.shape[0] != d:
        raise ValueError(f"rmsnorm: scale shape {tuple(scale.shape)} != ({d},)")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: x and scale must be contiguous")
    if x.is_meta:
        on_one = scale.is_meta
    else:
        on_one = x.is_cuda and scale.get_device() == x.get_device()
    if not on_one:
        raise ValueError(f"rmsnorm: x on {x.device}, scale on {scale.device}; both must be "
                         f"on one CUDA device (or x on the CPU)")
    return d


def _plan(x: torch.Tensor, d: int, dev: int, ptrs: int) -> Plan:
    """``ptrs``: the tensors' data pointers or'd together (16-byte aligned
    when its low four bits are 0)."""
    es = x.element_size()
    return plan(x.numel() // d, d, es, _sms(dev), d % (16 // es) == 0 and ptrs & 15 == 0)


def _bytes(x, scale, tensors: int) -> float:
    return tensors * x.numel() * x.element_size() + scale.numel() * scale.element_size()


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def launch_forward(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
                   zero_centered: bool = False, p: Plan | None = None,
                   lib: ctypes.CDLL | None = None) -> torch.Tensor:
    """The forward kernel on CUDA tensors, no autograd: x (..., d)
    contiguous, scale (d,). Returns x's shape and dtype. ``p`` and ``lib``
    replace the plan and the library (for timing other plans and builds)."""
    d = _check(x, scale)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    if x.is_meta:  # the meta route: no launch, its cost only
        record_cost("rmsnorm", lambda: (4 * x.numel(), _bytes(x, scale, 2)))
        return out
    dev = x.get_device()
    px, ps, po = x.data_ptr(), scale.data_ptr(), out.data_ptr()
    p = p or _plan(x, d, dev, px | ps | po)
    rc = (lib or _lib()).rmsnorm_fwd_launch(
        px, ps, po, x.numel() // d, d,
        x.dtype is torch.bfloat16, scale.dtype is torch.bfloat16, bool(zero_centered),
        float(eps), p.vec, p.vpt, p.warps, p.fwd_blocks, p.fwd_per, p.fwd_ring, _stream(dev))
    _raise_on(rc, "rmsnorm_fwd_kernel")
    LAUNCHES["rmsnorm"] += 1
    record_cost("rmsnorm", lambda: (4 * x.numel(), _bytes(x, scale, 2)))
    return out


def launch_backward(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6,
                    zero_centered: bool = False, p: Plan | None = None,
                    lib: ctypes.CDLL | None = None):
    """(dx, dscale) on CUDA tensors: x, dy (..., d) contiguous in one dtype,
    scale (d,). dx has x's dtype, dscale the scale's. ``p`` and ``lib`` as
    for ``launch_forward``."""
    d = _check(x, scale)
    if dy.dtype != x.dtype or dy.shape != x.shape or not dy.is_contiguous() \
            or dy.device != x.device:
        raise ValueError(f"rmsnorm backward: dy {dy.dtype} {tuple(dy.shape)} on {dy.device} "
                         f"must match x {x.dtype} {tuple(x.shape)} on {x.device}, contiguous")
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    if x.numel() == 0:
        return dx, dscale.zero_()
    if x.is_meta:  # the meta route: the launch's scratch and cost, no launch
        es = x.element_size()
        p = p or plan(x.numel() // d, d, es, H100_SMS, d % (16 // es) == 0)
        torch.empty((p.blocks, d), dtype=torch.float32, device=x.device)
        record_cost("rmsnorm_backward", lambda: (8 * x.numel(), _bytes(x, scale, 3)))
        return dx, dscale
    dev = x.get_device()
    px, ps, pg, pd = x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr()
    p = p or _plan(x, d, dev, px | ps | pg | pd)
    part = torch.empty((p.blocks, d), dtype=torch.float32, device=x.device)
    rc = (lib or _lib()).rmsnorm_bwd_launch(
        px, ps, pg, pd, part.data_ptr(),
        dscale.data_ptr(), x.numel() // d, d, x.dtype is torch.bfloat16,
        scale.dtype is torch.bfloat16, bool(zero_centered), float(eps), p.vec, p.vpt,
        p.warps, p.blocks, p.per, p.ring, _stream(dev))
    _raise_on(rc, "rmsnorm_bwd_kernel")
    LAUNCHES["rmsnorm_backward"] += 1
    record_cost("rmsnorm_backward", lambda: (8 * x.numel(), _bytes(x, scale, 3)))
    return dx, dscale


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps, zero_centered):
        ctx.save_for_backward(x, scale)
        ctx.opts = (eps, zero_centered)
        return launch_forward(x, scale, eps, zero_centered)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        eps, zero_centered = ctx.opts
        dx, dscale = launch_backward(x, scale, dy.to(x.dtype).contiguous(), eps, zero_centered)
        return dx, dscale, None, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
            zero_centered: bool = False) -> torch.Tensor:
    """x: (..., d); scale: (d,). Returns the shape and dtype of x;
    differentiable in x and scale."""
    if x.is_cpu:
        return rmsnorm_reference(x, scale, eps, zero_centered)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, eps, zero_centered)
    return launch_forward(x, scale, eps, zero_centered)
