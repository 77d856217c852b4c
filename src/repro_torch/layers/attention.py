"""Attention (``repro.layers.attention``): RoPE, the paged and dense KV
writes, and the paged, dense and cache-less branches of the attention
block.

Shapes follow (batch, seq, heads, head_dim) throughout, as in the JAX
package.

Paged pool layout: ``(P + 1, page, Hkv, hd)`` per layer. Pages ``0..P-1``
are the pool the allocator hands out; page ``P`` is a spare that receives
every write the JAX package drops (``.at[...].set(mode="drop")``: masked
entries, unallocated table entries, positions past the table). Sending
them there keeps the write free of a host sync (no boolean indexing), and
no block table ever names page ``P``, so readers never see it: attention
reads ``pool[:-1]``.

Dense cache layout: ``(B + 1, max_len, Hkv, hd)`` per layer. Rows
``0..B-1`` are the slots; row ``B`` is the spare that takes the writes the
JAX package drops. A spare batch row, not a spare column, keeps every
read a contiguous slice (``[:B]`` for a decode step, ``[slot:slot+1]``
for one slot's prefill chunk), which the flash-attention kernel needs.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import (
    paged_attention,
    paged_prefill_attention,
)
from repro_torch.layers.common import ParamSpec
from repro_torch.layers.norms import rmsnorm


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, rotary_frac: float = 1.0,
                     device=None, dtype=torch.float32):
    rot = int(head_dim * rotary_frac) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=dtype, device=device) / rot
    inv = 1.0 / (float(theta) ** exps)  # fp32 pow, as theta ** f32 in JAX
    return inv, rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
               rotary_frac: float = 1.0) -> torch.Tensor:
    """x: (B,S,H,D); positions: (B,S) int. Interleaved pairs ``0::2``/``1::2``
    (not HF's rotate-half), partial rotary on the first ``rot`` dims,
    computed in fp32 (float64 for float64 x) and cast back to x.dtype."""
    d = x.shape[-1]
    acc = torch.promote_types(x.dtype, torch.float32)
    inv, rot = rope_frequencies(d, theta, rotary_frac, x.device, acc)
    ang = positions[..., None].to(acc) * inv  # (B,S,rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr = x[..., :rot].to(acc)
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    y = torch.stack([y1, y2], dim=-1).reshape(x.shape[:-1] + (rot,))
    if rot < d:
        y = torch.cat([y, x[..., rot:].to(acc)], dim=-1)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# paged KV cache
# ---------------------------------------------------------------------------


def paged_write(pool: torch.Tensor, vals: torch.Tensor, positions: torch.Tensor,
                block_tables: torch.Tensor, seq_mask: torch.Tensor | None = None
                ) -> None:
    """Write ``vals`` (B,S,Hkv,hd) at ``positions`` (B,S) through the block
    table into ``pool`` (P+1, page, Hkv, hd), IN PLACE.

    The JAX package returns a new pool; here a functional copy of every
    layer's pool on every step would dominate the step, so the port writes
    in place. The flat index is ``phys_page*page + pos % page``. Entries
    that are masked, unallocated (table -1) or past the table go to the
    spare page P, as the JAX write drops them. Rows own disjoint pages
    (allocator invariant), so live writes never collide."""
    Pp1, psize, hkv, hd = pool.shape
    n_logical = block_tables.shape[1]
    page_idx = torch.div(positions, psize, rounding_mode="floor")
    phys = torch.gather(block_tables, 1, page_idx.clamp(0, n_logical - 1))
    valid = (phys >= 0) & (page_idx < n_logical)
    if seq_mask is not None:
        valid = valid & seq_mask
    flat = phys.long() * psize + torch.remainder(positions, psize)
    write_idx = torch.where(valid, flat, torch.full_like(flat, (Pp1 - 1) * psize))
    pool.view(Pp1 * psize, hkv, hd).index_put_(
        (write_idx.reshape(-1),), vals.reshape(-1, hkv, hd).to(pool.dtype)
    )


def dense_write(cache: torch.Tensor, vals: torch.Tensor, positions: torch.Tensor,
                row0: int, seq_mask: torch.Tensor | None = None) -> None:
    """Write ``vals`` (B,S,Hkv,hd) at ``positions`` (B,S) into cache rows
    ``row0 .. row0+B-1`` of ``cache`` (Bc, Smax, Hkv, hd), IN PLACE (the
    JAX masked scatter). Masked entries and positions outside ``[0,
    Smax)`` go to the spare row ``Bc-1``, as the JAX write drops them."""
    Bc, Smax, hkv, hd = cache.shape
    B = vals.shape[0]
    rows = torch.arange(row0, row0 + B, dtype=torch.int64, device=cache.device)[:, None]
    valid = (positions >= 0) & (positions < Smax)
    if seq_mask is not None:
        valid = valid & seq_mask
    flat = rows * Smax + positions.long()
    write_idx = torch.where(valid, flat, torch.full_like(flat, (Bc - 1) * Smax))
    cache.view(Bc * Smax, hkv, hd).index_put_(
        (write_idx.reshape(-1),), vals.reshape(-1, hkv, hd).to(cache.dtype)
    )


@functools.lru_cache(maxsize=8)
def key_positions(B: int, Smax: int, device: torch.device) -> torch.Tensor:
    """The dense cache's key positions, ``arange(Smax)`` per row, as the
    contiguous (B, Smax) int32 the flash-attention kernel reads: built once
    per shape, not per layer and step."""
    return torch.arange(Smax, dtype=torch.int32, device=device).expand(B, Smax).contiguous()


# ---------------------------------------------------------------------------
# the attention block
# ---------------------------------------------------------------------------


def attention_params(cfg) -> dict:
    """Projections; with ``attn_bias`` the q/k/v biases (zeros), with
    ``qk_norm`` the per-head RMSNorm scales over ``head_dim`` (ones)."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    p = {
        "wq": ParamSpec((d, hq * hd), ("embed", "qkv")),
        "wk": ParamSpec((d, hkv * hd), ("embed", "kv")),
        "wv": ParamSpec((d, hkv * hd), ("embed", "kv")),
        "wo": ParamSpec(
            (hq * hd, d), ("qkv", "embed_out"),
            scale=1.0 / (math.sqrt(hq * hd) * math.sqrt(2 * cfg.n_layers)),
        ),
    }
    if cfg.attn_bias:
        p["bq"] = ParamSpec((hq * hd,), ("qkv",), init="zeros")
        p["bk"] = ParamSpec((hkv * hd,), ("kv",), init="zeros")
        p["bv"] = ParamSpec((hkv * hd,), ("kv",), init="zeros")
    if cfg.qk_norm:
        p["q_norm"] = ParamSpec((hd,), (None,), init="ones")
        p["k_norm"] = ParamSpec((hd,), (None,), init="ones")
    return p


def _rank_heads(params: dict, cfg, tp):
    """A tensor-parallel rank's attention: its query heads ``tp.part(hq)``
    and the kv heads they read. ``params`` holds the rank's ``"qkv"``
    blocks (``wq``, ``bq``, ``wo``'s rows) and, when the kv heads divide
    the model axis, its ``"kv"`` blocks; otherwise the whole kv leaves,
    whose columns of the needed kv heads are cut here. Returns (params,
    query heads, kv heads, kv head of each query head when the rank's
    heads do not group evenly, else None)."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    qs = tp.part(hq)
    nq = qs.stop - qs.start
    if hkv % tp.size == 0:
        return params, nq, hkv // tp.size, None
    g = hq // hkv
    kv0, kv1 = qs.start // g, (qs.stop - 1) // g + 1
    p = dict(params)
    for name in ("wk", "wv", "bk", "bv"):
        if name in p:
            p[name] = p[name][..., kv0 * hd:kv1 * hd]
    nkv = kv1 - kv0
    of_q = [h // g - kv0 for h in range(qs.start, qs.stop)]
    if nq % nkv == 0 and of_q == [i // (nq // nkv) for i in range(nq)]:
        return p, nq, nkv, None
    return p, nq, nkv, of_q


def attention_block(params: dict, x: torch.Tensor, cfg, *, positions, cache,
                    cache_len, block_tables, seq_mask=None, causal: bool = True,
                    window: int | None = None, cache_row0: int = 0,
                    tp=None, cp=None) -> torch.Tensor:
    """The JAX ``attention_block``'s branches.

    ``cache`` None (training, full-sequence forward): project, rotate and
    attend over the sequence itself through the flash-attention kernel,
    at ``positions`` (B,S). ``cache`` dict(k_pages=(P+1,page,Hkv,hd),
    v_pages=...): write this step's K/V into the pool (in place), attend
    through the block table; S == 1 is a decode step (paged decode
    kernel), S > 1 a prefill chunk (paged prefill kernel). ``cache``
    dict(k=(Bc,Smax,Hkv,hd), v=...), the dense layout: write into cache
    rows ``cache_row0 .. cache_row0+B-1`` (in place) and attend those rows
    through the flash-attention kernel, keys at positions ``0..Smax-1``
    cut by ``kv_len = cache_len``: one query row a slot for a decode step,
    the chunk against everything written so far (the JAX
    ``cache_attend``) for S > 1. ``positions`` doubles as each row's
    write index. Returns (B,S,d).

    With ``tp`` (``distributed.shard.TensorParallel``; cache-less only),
    ``x`` is this rank's sequence part: it is all-gathered along the
    sequence, q/k/v are the rank's heads (column-parallel; ``_rank_heads``),
    the kernel runs on them at ``positions`` (B,S), and ``wo``'s rows
    (row-parallel) give partial sums that a reduce-scatter along the
    sequence turns into this rank's part of the output (B,S/n,d).

    With ``cp`` (``distributed.shard.ContextParallel``; cache-less only),
    ``x`` is this rank's sequence part and ``positions`` the whole
    sequence's: q, k and v are projected and rotated at the rank's own
    positions, K and V are all-gathered along the sequence (backward: a
    reduce-scatter of the rank's partial dK, dV), and the kernel runs the
    rank's query block against every key at their true positions, so the
    causal bound, the window and the tiles it skips follow the positions,
    never the indices. Returns the rank's rows (B,S/n,d)."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    kv_of_q = None
    k_positions = positions
    if tp is not None:
        assert cache is None, "tensor-parallel attention is cache-less"
        x = tp.seq_gather(x)
        params, hq, hkv, kv_of_q = _rank_heads(params, cfg, tp)
    if cp is not None:
        assert cache is None, "context-parallel attention is cache-less"
        positions = cp.local(positions)
    B, S, _ = x.shape
    compute = cfg.compute_dtype
    q = (x @ params["wq"].to(compute)).reshape(B, S, hq, hd)
    k = (x @ params["wk"].to(compute)).reshape(B, S, hkv, hd)
    v = (x @ params["wv"].to(compute)).reshape(B, S, hkv, hd)
    if cfg.attn_bias:  # after the projections, before RoPE
        q = q + params["bq"].reshape(1, 1, hq, hd).to(compute)
        k = k + params["bk"].reshape(1, 1, hkv, hd).to(compute)
        v = v + params["bv"].reshape(1, 1, hkv, hd).to(compute)
    if cfg.qk_norm:  # per head over head_dim, after the biases, before RoPE
        q = rmsnorm(q, params["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, params["k_norm"], cfg.norm_eps)
    if cfg.rope_theta:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.partial_rotary)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.partial_rotary)

    if kv_of_q is not None:  # one kv head a query head
        k, v = k[:, :, kv_of_q], v[:, :, kv_of_q]
    if cp is not None:
        k, v = cp.seq_gather(k).contiguous(), cp.seq_gather(v).contiguous()
    if cache is None:
        o = flash_attention(q, k, v, q_positions=positions, k_positions=k_positions,
                            causal=causal, window=window, softcap=cfg.attn_softcap)
    elif "k_pages" in cache:
        k_pool, v_pool = cache["k_pages"], cache["v_pages"]
        paged_write(k_pool, k, positions, block_tables, seq_mask)
        paged_write(v_pool, v, positions, block_tables, seq_mask)
        k_read, v_read = k_pool[:-1], v_pool[:-1]
        if S == 1:
            o = paged_attention(
                q, k_read, v_read, block_tables, q_position=positions[:, 0],
                cache_len=cache_len, window=window, softcap=cfg.attn_softcap,
            )
        else:
            o = paged_prefill_attention(
                q, k_read, v_read, block_tables, q_positions=positions,
                cache_len=cache_len, causal=causal, window=window,
                softcap=cfg.attn_softcap,
            )
    else:
        k_cache, v_cache = cache["k"], cache["v"]
        dense_write(k_cache, k, positions, cache_row0, seq_mask)
        dense_write(v_cache, v, positions, cache_row0, seq_mask)
        rows = slice(cache_row0, cache_row0 + B)
        o = flash_attention(
            q, k_cache[rows], v_cache[rows], q_positions=positions,
            k_positions=key_positions(B, k_cache.shape[1], k_cache.device),
            causal=causal, window=window, softcap=cfg.attn_softcap, kv_len=cache_len,
        )
    out = o.reshape(B, S, hq * hd) @ params["wo"].to(compute)
    return out if tp is None else tp.seq_scatter(out)
