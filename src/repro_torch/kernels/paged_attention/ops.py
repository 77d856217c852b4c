"""Public paged-attention wrappers: CUDA kernels on the card, plain versions
on the CPU.

``paged_attention`` (decode, S=1) and ``paged_prefill_attention`` (a chunk
of S>1 queries) keep the JAX wrappers' signatures. For CPU tensors they
run the plain versions in ``ref.py``; for CUDA tensors they check device,
dtype, shape and contiguity, allocate the output with ``torch.empty`` and
launch ``csrc/paged_attention.cu`` through ``ctypes`` on PyTorch's current
stream, raising if the launch returns a CUDA error. Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import LAUNCHES, build
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_reference,
    paged_prefill_attention_reference,
    per_row,
)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 256

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load_library("paged_attention")
    lib.paged_decode_launch.argtypes = (
        [_I] + [_P] * 7 + [_I] * 7 + [_I, _F, _F, _P]
    )
    lib.paged_decode_launch.restype = _I
    lib.paged_prefill_launch.argtypes = (
        [_I] + [_P] * 7 + [_I] * 8 + [_I, _I, _F, _F, _P]
    )
    lib.paged_prefill_launch.restype = _I
    return lib


def load() -> None:
    """Build (if needed) and load the CUDA library."""
    _lib()


def _check(q, k_pages, v_pages, block_tables, C_expected=None):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged attention kernel: q on {dev}, expected CUDA")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables)):
        if t.device != dev:
            raise ValueError(f"paged attention kernel: {name} on {t.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODE or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(
            f"paged attention kernel: dtypes q={q.dtype} k={k_pages.dtype} "
            f"v={v_pages.dtype}; need one of float32/bfloat16 for all three"
        )
    if block_tables.dtype != torch.int32:
        raise TypeError(f"block_tables must be int32, got {block_tables.dtype}")
    if q.dim() != 4 or k_pages.dim() != 4 or block_tables.dim() != 2:
        raise ValueError("expected q (B,S,Hq,D), pools (P,page,Hkv,D), tables (B,nL)")
    B, C, Hq, D = q.shape
    P, page, Hkv, Dk = k_pages.shape
    if v_pages.shape != k_pages.shape or Dk != D:
        raise ValueError(f"pool shapes {tuple(k_pages.shape)}/{tuple(v_pages.shape)} "
                         f"do not match q head dim {D}")
    if D > _MAX_D or Hq % Hkv:
        raise ValueError(f"head dim {D} > {_MAX_D} or Hq={Hq} not a multiple of Hkv={Hkv}")
    if block_tables.shape[0] != B:
        raise ValueError(f"block_tables rows {block_tables.shape[0]} != batch {B}")
    if C_expected is not None and C != C_expected:
        raise ValueError(f"decode expects one query per row, got {C}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables)):
        if not t.is_contiguous():
            raise ValueError(f"paged attention kernel: {name} must be contiguous")
    return B, C, Hq, D, P, page, Hkv, block_tables.shape[1]


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def paged_attention(q, k_pages, v_pages, block_tables, *, q_position, cache_len,
                    window: int | None = None, softcap: float | None = None):
    """Single-position attention against a paged KV pool.

    q: (B,1,Hq,D); k_pages/v_pages: (P, page, Hkv, D); block_tables:
    (B, n_logical) int32, ``-1`` = unallocated; q_position/cache_len: ()
    or (B,). Returns (B,1,Hq,D) in q.dtype."""
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, k_pages, v_pages, block_tables, q_position=q_position,
            cache_len=cache_len, window=window, softcap=softcap,
        )
    B, _, Hq, D, P, page, Hkv, nL = _check(q, k_pages, v_pages, block_tables, 1)
    lens = per_row(cache_len, B, q.device)
    qpos = per_row(q_position, B, q.device)
    out = torch.empty_like(q)
    rc = _lib().paged_decode_launch(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lens.data_ptr(), qpos.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, D, page, nL, P, int(window or 0), float(softcap or 0.0),
        1.0 / math.sqrt(D), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(rc, "paged_decode_kernel")
    LAUNCHES["paged_attention"] += 1
    return out


def paged_prefill_attention(q, k_pages, v_pages, block_tables, *, q_positions,
                            cache_len, causal: bool = True,
                            window: int | None = None,
                            softcap: float | None = None):
    """Multi-token chunk attention against a paged KV pool.

    q: (B,C,Hq,D) one chunk per row; ``q_positions`` (B,C) contiguous (row
    c sits at ``q_positions[:,0] + c``); cache_len: () or (B,) written
    tokens including this chunk. Returns (B,C,Hq,D) in q.dtype."""
    if q.device.type == "cpu":
        return paged_prefill_attention_reference(
            q, k_pages, v_pages, block_tables, q_positions=q_positions,
            cache_len=cache_len, causal=causal, window=window, softcap=softcap,
        )
    B, C, Hq, D, P, page, Hkv, nL = _check(q, k_pages, v_pages, block_tables)
    lens = per_row(cache_len, B, q.device)
    start = per_row(torch.as_tensor(q_positions, device=q.device).reshape(B, C)[:, 0],
                    B, q.device)
    out = torch.empty_like(q)
    rc = _lib().paged_prefill_launch(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lens.data_ptr(), start.data_ptr(), out.data_ptr(),
        B, C, Hq, Hkv, D, page, nL, P, int(bool(causal)), int(window or 0),
        float(softcap or 0.0), 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(rc, "paged_prefill_kernel")
    LAUNCHES["paged_prefill_attention"] += 1
    return out
