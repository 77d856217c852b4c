"""Public paged-attention wrappers: CUDA kernels on the card, plain versions
on the CPU.

``paged_attention`` (decode, S=1) and ``paged_prefill_attention`` (a chunk
of S>1 queries) keep the JAX wrappers' signatures. For CPU tensors they
run the plain versions in ``ref.py``; for CUDA tensors they check dtype,
shape, contiguity and device, allocate the output with ``torch.empty`` and
launch on PyTorch's current stream through ``ctypes``, raising if the
launch returns a CUDA error. The dtype picks the route before the launch
(``route``):

- bfloat16 -> ``tensor_cores``: ``csrc/paged_attention_tc.cu`` (mma.sync,
  key tiles by cp.async, split-K over pages in one launch: each block
  writes an fp32 partial to scratch this wrapper allocates, and the last
  block of each group combines them in split order; the split count comes
  from ``tc_plan``, which reads the shapes and the SM count, never
  ``cache_len``; the arrival counters are allocated zeroed once per device
  and stream, and the kernel leaves them zero);
- float32 -> ``cuda_cores``: ``csrc/paged_attention.cu`` (a warp per query
  row, fp32 FMAs; on the tensor cores fp32 would mean TF32).

Nothing falls back: not to the other route, not to the plain version.
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

_MAX_D = 256
ROUTES = {torch.float32: "cuda_cores", torch.bfloat16: "tensor_cores"}
# launches per route (decode and prefill alike); LAUNCHES counts per wrapper
ROUTE_LAUNCHES = {"cuda_cores": 0, "tensor_cores": 0}

# The tensor-core library's tiling, as the plan needs it: query rows a block
# owns (the library's BR, which it checks against the scratch it is given),
# keys a tile holds by head dim, and the plan's limits.
TC_BLOCK_ROWS = 64
TC_SPLIT_ROWS = 16  # groups of at most this many rows split over pages
TC_MAX_SPLITS = 64
TC_MAX_SPLIT_PAGES = 1024
H100_SMS = 132

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load_library("paged_attention")
    lib.paged_decode_launch.argtypes = [_P] * 7 + [_I] * 7 + [_I, _F, _F, _P]
    lib.paged_decode_launch.restype = _I
    lib.paged_prefill_launch.argtypes = [_P] * 7 + [_I] * 8 + [_I, _I, _F, _F, _P]
    lib.paged_prefill_launch.restype = _I
    return lib


@functools.cache
def _lib_tc() -> ctypes.CDLL:
    return bind_tc(build.load_library("paged_attention_tc"))


def bind_tc(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from
    ``csrc/paged_attention_tc.cu``."""
    lib.paged_tc_launch.argtypes = ([_I] + [_P] * 10 + [_L, _L] + [_I] * 10
                                    + [_F, _F, _I, _I, _P])
    lib.paged_tc_launch.restype = _I
    lib.paged_tc_block_rows.argtypes = []
    lib.paged_tc_block_rows.restype = _I
    if lib.paged_tc_block_rows() != TC_BLOCK_ROWS:
        raise RuntimeError(f"paged_attention_tc: the library's block owns "
                           f"{lib.paged_tc_block_rows()} rows, the plan {TC_BLOCK_ROWS}")
    return lib


def load() -> None:
    """Build (if needed) and load both routes' CUDA libraries."""
    _lib()
    _lib_tc()


def route(dtype: torch.dtype) -> str:
    """The kernels a CUDA tensor of ``dtype`` launches."""
    if dtype not in ROUTES:
        raise TypeError(f"paged attention kernel: dtype {dtype}; need float32 or bfloat16")
    return ROUTES[dtype]


def tc_plan(B: int, C: int, Hq: int, Hkv: int, D: int, page: int, nL: int,
            sms: int = H100_SMS) -> tuple[int, int]:
    """(splits, pages per split) of a tensor-core launch, from the shapes
    alone (never ``cache_len``). Groups of at most ``TC_SPLIT_ROWS`` query
    rows (decode: the G heads of one kv head) split to about one block an
    SM over (row tiles, splits, B * Hkv); larger groups (a prefill chunk)
    walk the table in one split, since their combine would cost more than
    the parallelism saves. Each split holds whole key tiles where a page
    divides a tile, and at least one page of the table."""
    if nL > TC_MAX_SPLITS * TC_MAX_SPLIT_PAGES:
        raise ValueError(f"paged attention kernel: {nL} table pages > "
                         f"{TC_MAX_SPLITS * TC_MAX_SPLIT_PAGES}")
    rows = (Hq // Hkv) * C
    tiles = B * Hkv * -(-rows // TC_BLOCK_ROWS)
    want = -(-sms // tiles) if rows <= TC_SPLIT_ROWS else 1
    splits = max(1, min(want, TC_MAX_SPLITS, nL))
    pages = -(-nL // splits)
    kt = 64 if D <= 128 else 32  # keys a tile holds (the library's KT)
    if kt % page == 0:
        pages = -(-pages // (kt // page)) * (kt // page)
    pages = min(max(pages, -(-nL // TC_MAX_SPLITS)), TC_MAX_SPLIT_PAGES)
    return -(-nL // pages), pages


def tc_scratch_shapes(B: int, C: int, Hq: int, Hkv: int, D: int, splits: int) -> dict:
    """Shapes of the fp32 partials (acc; m and l) and of the arrival
    counters of a launch with ``splits`` splits."""
    tiles = B * Hkv * -(-(Hq // Hkv) * C // TC_BLOCK_ROWS)
    return {"acc": (tiles, splits, TC_BLOCK_ROWS, D), "ml": (tiles, splits, TC_BLOCK_ROWS, 2),
            "counters": (tiles,)}


# Arrival counters per (device, stream): allocated zeroed once (grown when a
# launch needs more), left zero by every launch, so a call stays one launch
# and a CUDA graph that replays it keeps them zero. A buffer that is
# outgrown is kept, since a captured graph may still point at it.
_COUNTERS: dict = {}
_OUTGROWN: list = []


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _OUTGROWN.append(buf)
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def launch_costs(q, k_pages, n_logical: int, cache_len, q_start, *, causal: bool,
                 window: int | None = None):
    """(FLOPs, bytes) of one launch: ``cache_len`` and ``q_start`` (decode:
    the query's position, with ``causal=False``; prefill: the chunk's first)
    are per-row host ints. FLOPs are 4 * D per visible (query head, key)
    pair; bytes read q, the visible keys' K and V once each, the table, the
    lengths and the positions (one a query), and write the output once."""
    B, C, Hq, D = q.shape
    Hkv, es = k_pages.shape[2], q.element_size()
    pairs = keys = 0
    for ln, s in zip(cache_len, q_start):
        row_lo, row_hi = [], []
        for c in range(C):
            qp = s + c
            hi = min(ln, qp + 1) if causal else ln
            lo = max(0, qp - window + 1) if window and window > 0 else 0
            pairs += max(0, hi - lo)
            row_lo.append(lo)
            row_hi.append(hi)
        keys += max(0, max(row_hi) - min(row_lo))
    flops = 4 * Hq * D * pairs
    ints = B * n_logical + B * C + B
    return flops, (2 * B * C * Hq * D + 2 * keys * Hkv * D) * es + 4 * ints


def _check(q, k_pages, v_pages, block_tables, C_expected=None):
    """(B, C, Hq, D, P, page, Hkv, nL) of inputs a launch takes; raises for
    others. Dtypes and shapes are checked before the device, so every check
    but the last can be exercised without a card."""
    if q.dtype not in ROUTES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
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
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables)):
        if t.device != dev:
            raise ValueError(f"paged attention kernel: {name} on {t.device}, q on {dev}")
    if dev.type != "cuda":
        raise ValueError(f"paged attention kernel: q on {dev}, expected CUDA")
    return B, C, Hq, D, P, page, Hkv, block_tables.shape[1]


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def _launch_tc(prefill: bool, q, k_pages, v_pages, block_tables, lens, start, out,
               shape, causal, window, softcap):
    B, C, Hq, D, P, page, Hkv, nL = shape
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits, pages = tc_plan(B, C, Hq, Hkv, D, page, nL, sms)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    acc = ml = cnt = None
    if splits > 1:
        shapes = tc_scratch_shapes(B, C, Hq, Hkv, D, splits)
        acc = torch.empty(shapes["acc"], dtype=torch.float32, device=q.device)
        ml = torch.empty(shapes["ml"], dtype=torch.float32, device=q.device)
        cnt = _counters(q.device, stream, shapes["counters"][0])
    rc = _lib_tc().paged_tc_launch(
        int(prefill), q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lens.data_ptr(), start.data_ptr(), out.data_ptr(),
        *(None if t is None else t.data_ptr() for t in (acc, ml, cnt)),
        0 if acc is None else acc.numel(), 0 if ml is None else ml.numel(),
        B, C, Hq, Hkv, D, page, nL, P, int(bool(causal)), int(window or 0),
        float(softcap or 0.0), 1.0 / math.sqrt(D), splits, pages, stream,
    )
    _raise_on(rc, "paged_prefill_tc_kernel" if prefill else "paged_decode_tc_kernel")


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
    shape = _check(q, k_pages, v_pages, block_tables, 1)
    B, _, Hq, D, P, page, Hkv, nL = shape
    rt = route(q.dtype)
    lens = per_row(cache_len, B, q.device)
    qpos = per_row(q_position, B, q.device)
    out = torch.empty_like(q)
    if rt == "tensor_cores":
        _launch_tc(False, q, k_pages, v_pages, block_tables, lens, qpos, out, shape,
                   False, window, softcap)
    else:
        rc = _lib().paged_decode_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lens.data_ptr(), qpos.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, D, page, nL, P, int(window or 0), float(softcap or 0.0),
            1.0 / math.sqrt(D), torch.cuda.current_stream(q.device).cuda_stream,
        )
        _raise_on(rc, "paged_decode_kernel")
    LAUNCHES["paged_attention"] += 1
    ROUTE_LAUNCHES[rt] += 1
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
    shape = _check(q, k_pages, v_pages, block_tables)
    B, C, Hq, D, P, page, Hkv, nL = shape
    rt = route(q.dtype)
    lens = per_row(cache_len, B, q.device)
    start = per_row(torch.as_tensor(q_positions, device=q.device).reshape(B, C)[:, 0],
                    B, q.device)
    out = torch.empty_like(q)
    if rt == "tensor_cores":
        _launch_tc(True, q, k_pages, v_pages, block_tables, lens, start, out, shape,
                   causal, window, softcap)
    else:
        rc = _lib().paged_prefill_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lens.data_ptr(), start.data_ptr(), out.data_ptr(),
            B, C, Hq, Hkv, D, page, nL, P, int(bool(causal)), int(window or 0),
            float(softcap or 0.0), 1.0 / math.sqrt(D),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        _raise_on(rc, "paged_prefill_kernel")
    LAUNCHES["paged_prefill_attention"] += 1
    ROUTE_LAUNCHES[rt] += 1
    return out
