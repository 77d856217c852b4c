"""Public flash-attention wrapper: CUDA kernels on the card, the plain
version on the CPU.

``flash_attention`` keeps the signature of ``repro.layers.attention
.flash_attention`` (positions, ``kv_len``, causal, window, softcap; the
chunk sizes are the jnp scan's and have no meaning here). For CPU tensors
it runs ``ref.flash_attention_reference`` and autograd differentiates it.
For CUDA tensors it goes through ``_FlashAttention``, whose forward saves O
and the fp32 row log-sum-exp and whose backward launches the dq kernel,
then the dk/dv kernel. The dtype picks the route before the launch
(``route``):

- bfloat16 -> ``tensor_cores``: ``csrc/flash_attention_tc.cu`` (wgmma,
  bf16 tiles staged by cp.async, the head dim zero-padded to a multiple of
  64; the backward writes fp32 partial dK/dV per q head, (B, Sk, Hq, D),
  and sums them per kv head in a third kernel; the library decides the
  tiling and rejects sequences past 131072 rows);
- float32 -> ``cuda_cores``: ``csrc/flash_attention.cu`` (fp32 FMAs; on the
  tensor cores fp32 would mean TF32).

Both go through ``ctypes`` on PyTorch's current stream and raise if a
launch returns a CUDA error. Nothing falls back: not to the other route,
not to the plain version.

Tensors on the meta device (a step counted without running,
``launch.dryrun``) take the meta route in ``flash_forward`` and
``flash_backward``: they allocate what the launch would, on the meta
device, report its cost through ``record_cost`` and launch nothing
(``LAUNCHES`` and ``ROUTE_LAUNCHES`` stay as they were). A meta tensor
holds no values, so the cost is counted at the host positions that
``meta_positions`` sets (``MetaPositions``).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.kernels import LAUNCHES, build, record_cost
from repro_torch.kernels.flash_attention.ref import flash_attention_reference

_MAX_D = 256
ROUTES = {torch.float32: "cuda_cores", torch.bfloat16: "tensor_cores"}
# launches per route (forward and backward calls alike); LAUNCHES counts
# per wrapper
ROUTE_LAUNCHES = {"cuda_cores": 0, "tensor_cores": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load_library("flash_attention")
    lib.flash_fwd_launch.argtypes = [_P] * 8 + [_I] * 8 + [_F, _F, _P]
    lib.flash_fwd_launch.restype = _I
    lib.flash_bwd_launch.argtypes = [_P] * 13 + [_I] * 8 + [_F, _F, _P]
    lib.flash_bwd_launch.restype = _I
    return lib


@functools.cache
def _lib_tc() -> ctypes.CDLL:
    return bind_tc(build.load_library("flash_attention_tc"))


def bind_tc(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from
    ``csrc/flash_attention_tc.cu``."""
    lib.flash_tc_fwd_launch.argtypes = [_P] * 8 + [_I] * 8 + [_F, _F, _P]
    lib.flash_tc_fwd_launch.restype = _I
    lib.flash_tc_bwd_launch.argtypes = [_P] * 15 + [_I] * 8 + [_F, _F, _P]
    lib.flash_tc_bwd_launch.restype = _I
    lib.flash_tc_smem_bytes.argtypes = [_I, _I]
    lib.flash_tc_smem_bytes.restype = ctypes.c_long
    return lib


def load() -> None:
    """Build (if needed) and load both routes' CUDA libraries."""
    _lib()
    _lib_tc()


def route(dtype: torch.dtype) -> str:
    """The kernels a CUDA tensor of ``dtype`` launches."""
    if dtype not in ROUTES:
        raise TypeError(f"flash attention kernel: dtype {dtype}; need float32 or bfloat16")
    return ROUTES[dtype]


TC_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel", "flash_bwd_dkdv_tc_kernel")


def tc_smem_bytes(D: int) -> dict:
    """The dynamic shared memory each tensor-core kernel asks for at head
    dim D, as its launcher computes it (needs the built library)."""
    return {name: int(_lib_tc().flash_tc_smem_bytes(i, D)) for i, name in enumerate(TC_KERNELS)}


def visible_pairs(Sq: int, Sk: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs the kernels compute at index positions: query i
    sees keys max(0, i - window + 1) .. min(i, Sk - 1) (all keys when not
    causal). Tiles past the causal bound are skipped, so this, not Sq*Sk,
    is the work."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(0, i - window + 1) if window and window > 0 else np.zeros(Sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def position_pairs(qpos, kpos, kv_len, causal: bool, window: int | None):
    """(pairs, keys) at these positions: the (query, key) pairs the kernels
    compute, and per batch row the keys in the span some query sees (the
    K/V rows the kernels read). ``qpos`` (B,Sq) and ``kpos`` (B,Sk) host
    ints, ``kv_len`` (B,) or None. Key j is visible to query i when ``kpos
    <= qpos`` (causal), ``kpos > qpos - window`` (window) and ``kpos <
    kv_len``: a dense decode row at position p against kv_len p+1 sees p+1
    keys, where the index count would give it one."""
    big = np.int64(1) << 62
    qpos, kpos = np.asarray(qpos, np.int64), np.asarray(kpos, np.int64)
    pairs = keys = 0
    for b in range(qpos.shape[0]):
        ks = np.sort(kpos[b])
        hi = qpos[b] if causal else np.full_like(qpos[b], big)
        if kv_len is not None:
            hi = np.minimum(hi, int(kv_len[b]) - 1)
        lo = qpos[b] - window if window and window > 0 else np.full_like(qpos[b], -big)
        n = np.searchsorted(ks, hi, "right") - np.searchsorted(ks, lo, "right")
        pairs += int(np.clip(n, 0, None).sum())
        keys += max(0, int(np.searchsorted(ks, hi.max(), "right")
                           - np.searchsorted(ks, lo.min(), "right")))
    return pairs, keys


def launch_costs(q, k, causal, window, backward: bool, qpos=None, kpos=None,
                 kv_len=None):
    """(FLOPs, bytes) of one forward or backward launch. Without positions:
    at index positions (``visible_pairs``, every key read). With the
    launch's positions and ``kv_len`` (tensors or host ints;
    ``position_pairs``): the pairs and key span these positions give."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    es = q.element_size()
    if qpos is None:
        pairs, keys = B * visible_pairs(Sq, Sk, causal, window), B * Sk
    else:
        host = lambda t: t.cpu().numpy() if isinstance(t, torch.Tensor) else t  # noqa: E731
        pairs, keys = position_pairs(host(qpos), host(kpos),
                                     None if kv_len is None else host(kv_len), causal, window)
    fwd_flops = 4.0 * Hq * D * pairs
    io_q, io_kv, rows = B * Sq * Hq * D * es, keys * Hkv * D * es, B * Hq * Sq * 4
    if not backward:  # read q, k, v; write o and the LSE
        return fwd_flops, 2 * io_q + 2 * io_kv + rows
    # recompute S, dP, dQ, dK, dV: five products of the forward's two;
    # read q, k, v, o, dO, LSE; write dq, dk, dv and Delta
    return 2.5 * fwd_flops, 4 * io_q + 4 * io_kv + 2 * rows


@dataclasses.dataclass(frozen=True)
class MetaPositions:
    """The host positions that a launch on the meta device stands for, as
    a step implies them:

    - no ``kv_len`` (training, the one-shot prefill, the encoder): queries
      at ``q_offset + 0..Sq-1`` (a context-parallel rank's query block
      starts at its offset), keys at ``0..Sk-1``;
    - with ``kv_len`` (a decode step over a dense cache): every query row at
      ``decode_pos``, keys at ``k_offset + 0..Sk-1`` (a sequence-split
      cache block's own key range), ``kv_len = decode_pos + 1``."""

    q_offset: int = 0
    k_offset: int = 0
    decode_pos: int | None = None

    def host(self, B: int, Sq: int, Sk: int, cache: bool):
        """(qpos (B,Sq), kpos (B,Sk), kv_len (B,) or None) host arrays."""
        kpos = np.broadcast_to(self.k_offset + np.arange(Sk, dtype=np.int64), (B, Sk))
        if not cache:
            qpos = self.q_offset + np.arange(Sq, dtype=np.int64)
            return np.broadcast_to(qpos, (B, Sq)), kpos, None
        if self.decode_pos is None:
            raise ValueError("a meta launch over a cache needs its decode position: "
                             "set it with meta_positions(decode_pos=...)")
        return (np.full((B, Sq), self.decode_pos, np.int64), kpos,
                np.full(B, self.decode_pos + 1, np.int64))


_META_POSITIONS = [MetaPositions()]


@contextlib.contextmanager
def meta_positions(**kw):
    """Count meta launches inside the block at ``MetaPositions(**kw)``."""
    _META_POSITIONS.append(MetaPositions(**kw))
    try:
        yield _META_POSITIONS[-1]
    finally:
        _META_POSITIONS.pop()


def _meta_costs(q, k, kv_len, causal, window, backward: bool):
    """``launch_costs`` of a meta launch at the current ``MetaPositions``."""
    qpos, kpos, lens = _META_POSITIONS[-1].host(q.shape[0], q.shape[1], k.shape[1],
                                                kv_len is not None)
    return launch_costs(q, k, causal, window, backward, qpos, kpos, lens)


def _check(q, k, v):
    """(B, Sq, Sk, Hq, Hkv, D) of inputs a launch takes; raises for others.
    Dtypes and shapes are checked before the device, so every check but the
    last can be exercised without a card."""
    if q.dtype not in ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention kernel: dtypes q={q.dtype} k={k.dtype} "
                        f"v={v.dtype}; need one of float32/bfloat16 for all three")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("expected q (B,Sq,Hq,D) and k, v (B,Sk,Hkv,D)")
    B, Sq, Hq, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    if Bk != B or Dk != D or D > _MAX_D or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: batch and head "
                         f"dim must match, D <= {_MAX_D}, Hq a multiple of Hkv")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash attention kernel: {name} must be contiguous")
    dev = q.device
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"flash attention kernel: {name} on {t.device}, q on {dev}")
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"flash attention kernel: q on {dev}, expected CUDA")
    return B, Sq, Sk, Hq, Hkv, D


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def flash_forward(q, k, v, qpos, kpos, kv_len, causal, window, softcap):
    """Launch the forward of ``q.dtype``'s route: ``flash_fwd_tc_kernel``
    (bf16) or ``flash_fwd_kernel`` (fp32). q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D) CUDA,
    contiguous; qpos (B,Sq) / kpos (B,Sk) int32; kv_len (B,) int32 or None.
    Returns (o like q, fp32 LSE (B,Hq,Sq))."""
    B, Sq, Sk, Hq, Hkv, D = _check(q, k, v)
    rt = route(q.dtype)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    if q.is_meta:  # the meta route: no launch, its cost only
        record_cost("flash_attention", lambda: _meta_costs(q, k, kv_len, causal, window,
                                                           False))
        return out, lse
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(), kpos.data_ptr(),
            None if kv_len is None else kv_len.data_ptr(), out.data_ptr(), lse.data_ptr())
    opts = (B, Sq, Sk, Hq, Hkv, D, int(bool(causal)), int(window or 0),
            float(softcap or 0.0), 1.0 / math.sqrt(D),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rt == "tensor_cores":
        _raise_on(_lib_tc().flash_tc_fwd_launch(*ptrs, *opts), "flash_fwd_tc_kernel")
    else:
        _raise_on(_lib().flash_fwd_launch(*ptrs, *opts), "flash_fwd_kernel")
    LAUNCHES["flash_attention"] += 1
    ROUTE_LAUNCHES[rt] += 1
    # the positions come to the host only while a step is being counted
    record_cost("flash_attention", lambda: launch_costs(
        q, k, causal, window, False, qpos, kpos, kv_len))
    return out, lse


def flash_backward(q, k, v, out, lse, dout, qpos, kpos, kv_len, causal, window, softcap):
    """Launch the backward of ``q.dtype``'s route for the cotangent ``dout``
    of ``out`` (whose LSE the forward wrote): the dq kernel (which writes
    Delta), then the dk/dv kernel; on the tensor-core route the dk/dv
    kernel writes fp32 partials per q head and a third kernel sums them per
    kv head. Returns (dq, dk, dv), each like its input."""
    B, Sq, Sk, Hq, Hkv, D = _check(q, k, v)
    rt = route(q.dtype)
    dout = dout.to(q.dtype).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    if q.is_meta:  # the meta route: the launch's scratch and cost, no launch
        if rt == "tensor_cores":  # the fp32 partial dK and dV per q head
            dk_part, dv_part = (torch.empty((B, Sk, Hq, D), dtype=torch.float32,
                                            device=q.device) for _ in range(2))
        record_cost("flash_attention_backward", lambda: _meta_costs(
            q, k, kv_len, causal, window, True))
        return dq, dk, dv
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), qpos.data_ptr(), kpos.data_ptr(),
            None if kv_len is None else kv_len.data_ptr(), delta.data_ptr(), dq.data_ptr())
    opts = (B, Sq, Sk, Hq, Hkv, D, int(bool(causal)), int(window or 0),
            float(softcap or 0.0), 1.0 / math.sqrt(D),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rt == "tensor_cores":
        shape = (B, Sk, Hq, D)  # one partial per q head
        dk_part = torch.empty(shape, dtype=torch.float32, device=q.device)
        dv_part = torch.empty(shape, dtype=torch.float32, device=q.device)
        rc = _lib_tc().flash_tc_bwd_launch(
            *ptrs, dk_part.data_ptr(), dv_part.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *opts)
        _raise_on(rc, "flash_bwd_dq_tc_kernel / flash_bwd_dkdv_tc_kernel / "
                      "flash_bwd_dkdv_sum_kernel")
    else:
        rc = _lib().flash_bwd_launch(*ptrs, dk.data_ptr(), dv.data_ptr(), *opts)
        _raise_on(rc, "flash_bwd_dq_kernel / flash_bwd_dkdv_kernel")
    LAUNCHES["flash_attention_backward"] += 1
    ROUTE_LAUNCHES[rt] += 1
    record_cost("flash_attention_backward", lambda: launch_costs(
        q, k, causal, window, True, qpos, kpos, kv_len))
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, qpos, kpos, kv_len, causal, window, softcap):
        out, lse = flash_forward(q, k, v, qpos, kpos, kv_len, causal, window, softcap)
        ctx.save_for_backward(q, k, v, out, lse, qpos, kpos, kv_len)
        ctx.opts = (causal, window, softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, qpos, kpos, kv_len = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, dout, qpos, kpos, kv_len, *ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None


def positions_rows(x, B: int, S: int, device) -> torch.Tensor:
    """Positions (B,S) as contiguous int32 on ``device``; indices when None."""
    if x is None:
        return torch.arange(S, dtype=torch.int32, device=device).expand(B, S).contiguous()
    t = torch.as_tensor(x).to(device, torch.int32, non_blocking=True)
    return t.expand(B, S).contiguous()


def flash_attention(q, k, v, *, q_positions=None, k_positions=None,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None, kv_len=None):
    """Attention over whole sequences, differentiable.

    q: (B,Sq,Hq,D); k,v: (B,Sk,Hkv,D), Hq = G*Hkv; ``q_positions`` (B,Sq) /
    ``k_positions`` (B,Sk) int, or None for the indices; ``kv_len`` () or
    (B,): keys at positions >= kv_len are masked. Returns (B,Sq,Hq,D) in
    q.dtype."""
    kw = dict(q_positions=q_positions, k_positions=k_positions, causal=causal,
              window=window, softcap=softcap, kv_len=kv_len)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, **kw)
    B, Sq, Sk = q.shape[0], q.shape[1], k.shape[1]
    qpos = positions_rows(q_positions, B, Sq, q.device)
    kpos = positions_rows(k_positions, B, Sk, q.device)
    lens = None if kv_len is None else torch.as_tensor(kv_len).to(
        q.device, torch.int32, non_blocking=True).reshape(-1).expand(B).contiguous()
    return _FlashAttention.apply(q, k, v, qpos, kpos, lens, causal, window, softcap)


LSE_MASKED = 1e30  # the kernels' LSE of a row that sees no key


def flash_attention_lse(q, k, v, *, q_positions=None, k_positions=None,
                        causal: bool = True, window: int | None = None,
                        softcap: float | None = None, kv_len=None):
    """The forward alone, with its row log-sum-exp: (o (B,Sq,Hq,D), lse
    (B,Hq,Sq) fp32), ``lse`` ``-inf`` for a row that sees no key (the
    kernels write ``LSE_MASKED`` there). No autograd: the serving steps'
    attention over a rank's block of a split key sequence, whose ranks
    combine through the LSE (``distributed.shard.merge_partials``). CPU
    tensors take the plain version (``return_lse``); CUDA tensors launch
    the forward kernel of ``q.dtype``'s route."""
    kw = dict(q_positions=q_positions, k_positions=k_positions, causal=causal,
              window=window, softcap=softcap, kv_len=kv_len)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, return_lse=True, **kw)
    B, Sq, Sk = q.shape[0], q.shape[1], k.shape[1]
    qpos = positions_rows(q_positions, B, Sq, q.device)
    kpos = positions_rows(k_positions, B, Sk, q.device)
    lens = None if kv_len is None else torch.as_tensor(kv_len).to(
        q.device, torch.int32, non_blocking=True).reshape(-1).expand(B).contiguous()
    out, lse = flash_forward(q, k, v, qpos, kpos, lens, causal, window, softcap)
    return out, lse.masked_fill_(lse >= LSE_MASKED / 2, float("-inf"))
