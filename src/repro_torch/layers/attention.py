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

from repro_torch.distributed.shard import merge_partials
from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_lse
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


def _rank_heads(params: dict, cfg, tp, whole: bool = False):
    """A tensor-parallel rank's attention: its query heads ``tp.part(hq)``
    and the kv heads they read. ``params`` holds the rank's ``"qkv"``
    blocks (``wq``, ``bq``, ``wo``'s rows), or, with ``whole``, the whole
    leaves (a decode step's row-parallel attention on an fsdp mesh), whose
    columns and rows of the rank's heads are cut here; and, when the kv
    heads divide the model axis, its ``"kv"`` blocks (or with ``whole`` the
    whole leaves, cut likewise); otherwise the whole kv leaves, whose
    columns of the needed kv heads are cut here. Returns (params, query
    heads, kv heads, kv head of each query head when the rank's heads do
    not group evenly, else None)."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    qs = tp.part(hq)
    nq = qs.stop - qs.start
    p = dict(params)
    if whole:  # the rank's heads
        cols = slice(qs.start * hd, qs.stop * hd)
        p["wq"], p["wo"] = p["wq"][..., cols], p["wo"][cols]
        if "bq" in p:
            p["bq"] = p["bq"][..., cols]
    if hkv % tp.size == 0:
        ks = tp.part(hkv)
        for name in ("wk", "wv", "bk", "bv"):
            if whole and name in p:
                p[name] = p[name][..., ks.start * hd:ks.stop * hd]
        return p, nq, hkv // tp.size, None
    g = hq // hkv
    kv0, kv1 = qs.start // g, (qs.stop - 1) // g + 1
    for name in ("wk", "wv", "bk", "bv"):
        if name in p:
            p[name] = p[name][..., kv0 * hd:kv1 * hd]
    nkv = kv1 - kv0
    of_q = [h // g - kv0 for h in range(qs.start, qs.stop)]
    if nq % nkv == 0 and of_q == [i // (nq // nkv) for i in range(nq)]:
        return p, nq, nkv, None
    return p, nq, nkv, of_q


def _project(params: dict, x, cfg, positions, n: int, which: str):
    """``which`` "q" (B,S,n,hd), or "k" and "v": the projection, the bias,
    the per-head norm, RoPE at ``positions`` (B,S) (not for v)."""
    B, S, _ = x.shape
    hd, compute = cfg.head_dim_, cfg.compute_dtype
    t = (x @ params[f"w{which}"].to(compute)).reshape(B, S, n, hd)
    if cfg.attn_bias:  # after the projections, before RoPE
        t = t + params[f"b{which}"].reshape(1, 1, n, hd).to(compute)
    if which == "v":
        return t
    if cfg.qk_norm:  # per head over head_dim, after the biases, before RoPE
        t = rmsnorm(t, params[f"{which}_norm"], cfg.norm_eps)
    if cfg.rope_theta:
        t = apply_rope(t, positions, cfg.rope_theta, cfg.partial_rotary)
    return t


def prefill_write(cache: torch.Tensor, vals: torch.Tensor, row0: int, offset: int) -> None:
    """A one-shot prefill's write, IN PLACE: ``vals`` (B,S,Hkv,hd) are
    positions ``0..S-1`` of every row; this cache block ``(Bc, L, Hkv,
    hd)`` holds positions ``offset .. offset+L-1`` of rows ``row0 ..
    row0+B-1`` (``offset`` 0 and ``L`` = max_len unless the cache's
    sequence is split over ranks), so the write is the slice of the prompt
    that falls in it, copied as it is."""
    B, S = vals.shape[:2]
    n = max(0, min(S - offset, cache.shape[1]))
    if n:
        cache[row0:row0 + B, :n].copy_(vals[:, offset:offset + n])


def attention_block(params: dict, x: torch.Tensor, cfg, *, positions, cache,
                    cache_len, block_tables, seq_mask=None, causal: bool = True,
                    window: int | None = None, cache_row0: int = 0,
                    tp=None, cp=None, kv=None, cache_attend: bool = True,
                    whole: bool = False, pool_rows=None) -> torch.Tensor:
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
    write index. With ``cache_attend`` False (the one-shot prefill, JAX's
    ``prefill``: positions ``0..S-1`` of every row, dense layout) the
    chunk attends over itself, causal, with the window and softcap, and
    its K/V are copied into the cache (``prefill_write``). Returns (B,S,d).

    With ``tp`` (``distributed.shard.TensorParallel``), ``x`` is this
    rank's sequence part: it is all-gathered along the sequence, q/k/v are
    the rank's heads (column-parallel; ``_rank_heads``), the kernel runs on
    them at ``positions`` (B,S), and ``wo``'s rows (row-parallel) give
    partial sums that a reduce-scatter along the sequence turns into this
    rank's part of the output (B,S/n,d). Under ``RowParallel`` (a decode
    step) ``x`` is whole and the partial sums are all-reduced. With
    ``whole`` the leaves in ``params`` are whole although ``tp`` is set (a
    decode step's attention on an fsdp mesh,
    ``LogicalConstraints.attn_tp``): the rank's heads are cut from them.

    With ``cp`` (``distributed.shard.ContextParallel``), ``x`` is this
    rank's sequence part and ``positions`` the whole sequence's: q, k and
    v are projected and rotated at the rank's own positions, K and V are
    all-gathered along the sequence (backward: a reduce-scatter of the
    rank's partial dK, dV), and the kernel runs the rank's query block
    against every key at their true positions, so the causal bound, the
    window and the tiles it skips follow the positions, never the
    indices. Returns the rank's rows (B,S/n,d).

    With ``kv`` (``distributed.shard.CacheSplit``; dense layout) the cache
    is this rank's block: its KV heads (``kv.heads``), which are the heads
    the rank computes (under fsdp a decode step's ``tp`` is the row-parallel
    attention over them; a context-parallel prefill cuts them from the
    gathered K/V), or its block of the sequence (``kv.seq``): the
    rank writes every KV head at the positions its block holds, and a
    decode step attends every query head against its block at the block's
    true positions, returning the LSE, and the ranks combine
    (``distributed.shard.merge_partials``); under ``tp`` each rank then
    keeps its query heads for the row-parallel out-projection.

    On the paged layout over a mesh (the scheduler's steps) the pool is
    this rank's block: with ``kv.heads`` its KV heads, which the rank
    writes and reads, so the kernels run at ``Hq/n``, ``Hkv/n``; without
    (a pool that every ``"model"`` rank holds whole) every rank writes
    every KV head, gathers the query heads (``kv.head_gather``), attends
    all of them against the whole pool and keeps its own for ``wo``. With
    ``pool_rows`` (``distributed.shard.PoolRows``: the step's rows split
    over the batch axes, over which the pool is replicated) the write takes
    every rank's rows, at their positions through the global tables, and
    ``block_tables`` are the rank's rows' for the read."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    kv_of_q = None
    k_positions = positions
    leaves = params
    S_in = x.shape[1]
    if tp is not None:
        assert cache is None or kv is not None or tp.size == 1, \
            "tensor-parallel attention over a cache needs its placement (lc.kv)"
        x = tp.seq_gather(x)
        params, hq, hkv, kv_of_q = _rank_heads(params, cfg, tp, whole)
    if cp is not None:
        assert cache is None or not cache_attend, "context-parallel attention is one-shot"
        positions = cp.local(positions)
    B, S, _ = x.shape
    compute = cfg.compute_dtype
    paged = cache is not None and "k_pages" in cache
    seq_split = kv is not None and kv.seq and cache is not None and not paged
    replicated = paged and kv is not None and not kv.heads and tp is not None
    q, k, v = (_project(params, x, cfg, positions, n, w)
               for n, w in ((hq, "q"), (hkv, "k"), (hkv, "v")))
    k_all, v_all = k, v
    if (seq_split or replicated) and tp is not None:  # every kv head, for the rank's block
        k_all, v_all = (_project(leaves, x, cfg, positions, cfg.n_kv_heads, w) for w in "kv")

    if kv_of_q is not None:  # one kv head a query head
        k, v = k[:, :, kv_of_q], v[:, :, kv_of_q]
    if cp is not None:
        k, v = cp.seq_gather(k).contiguous(), cp.seq_gather(v).contiguous()
        k_all, v_all = k, v
    if cache is None:
        o = flash_attention(q, k, v, q_positions=positions, k_positions=k_positions,
                            causal=causal, window=window, softcap=cfg.attn_softcap)
    elif paged:
        k_pool, v_pool = cache["k_pages"], cache["v_pages"]
        kw, vw, wpos, wtables, wmask = k_all, v_all, positions, block_tables, seq_mask
        if pool_rows is not None:  # every rank's rows into the replicated pool
            kw, vw = pool_rows.kv(kw, vw)
            wpos, wtables, wmask = pool_rows.positions, pool_rows.tables, None
        paged_write(k_pool, kw, wpos, wtables, wmask)
        paged_write(v_pool, vw, wpos, wtables, wmask)
        k_read, v_read = k_pool[:-1], v_pool[:-1]
        if replicated:
            q = kv.head_gather(q)
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
        if replicated:
            o = o[:, :, tp.part(cfg.n_heads)]
    elif not cache_attend:  # one-shot prefill: attend the chunk, copy K/V in
        k_cache, v_cache = cache["k"], cache["v"]
        off = 0 if kv is None else kv.offset(k_cache.shape[1])
        if kv is not None and kv.heads and tp is None:  # the gathered K/V's kv heads
            ks = kv.kv_part(hkv)
            k_all, v_all = k_all[:, :, ks], v_all[:, :, ks]
        prefill_write(k_cache, k_all, cache_row0, off)
        prefill_write(v_cache, v_all, cache_row0, off)
        o = flash_attention(q, k, v, q_positions=positions, k_positions=k_positions,
                            causal=causal, window=window, softcap=cfg.attn_softcap)
    else:
        k_cache, v_cache = cache["k"], cache["v"]
        rows = slice(cache_row0, cache_row0 + B)
        L = k_cache.shape[1]
        if seq_split:  # write every kv head where the block holds it; attend, combine
            off = kv.offset(L)
            dense_write(k_cache, k_all, positions - off, cache_row0, seq_mask)
            dense_write(v_cache, v_all, positions - off, cache_row0, seq_mask)
            if tp is not None:
                q = kv.head_gather(q)
            kpos = key_positions(B, L, k_cache.device) + off
            o, lse = flash_attention_lse(
                q, k_cache[rows], v_cache[rows], q_positions=positions, k_positions=kpos,
                causal=causal, window=window, softcap=cfg.attn_softcap, kv_len=cache_len)
            o = merge_partials(o, lse, kv)
            if tp is not None:
                o = o[:, :, tp.part(cfg.n_heads)]
        else:
            dense_write(k_cache, k, positions, cache_row0, seq_mask)
            dense_write(v_cache, v, positions, cache_row0, seq_mask)
            o = flash_attention(
                q, k_cache[rows], v_cache[rows], q_positions=positions,
                k_positions=key_positions(B, L, k_cache.device),
                causal=causal, window=window, softcap=cfg.attn_softcap, kv_len=cache_len,
            )
    out = o.reshape(B, S, hq * hd) @ params["wo"].to(compute)
    return out if tp is None else tp.seq_scatter(out)
