"""Attention (``repro.layers.attention``): RoPE, the paged KV write, and the
paged and cache-less branches of the attention block.

Shapes follow (batch, seq, heads, head_dim) throughout, as in the JAX
package. The dense-cache branch waits for a later slice.

Paged pool layout: ``(P + 1, page, Hkv, hd)`` per layer. Pages ``0..P-1``
are the pool the allocator hands out; page ``P`` is a spare that receives
every write the JAX package drops (``.at[...].set(mode="drop")``: masked
entries, unallocated table entries, positions past the table). Sending
them there keeps the write free of a host sync (no boolean indexing), and
no block table ever names page ``P``, so readers never see it: attention
reads ``pool[:-1]``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import (
    paged_attention,
    paged_prefill_attention,
)
from repro_torch.layers.common import ParamSpec


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


# ---------------------------------------------------------------------------
# the attention block
# ---------------------------------------------------------------------------


def attention_params(cfg) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    return {
        "wq": ParamSpec((d, hq * hd)),
        "wk": ParamSpec((d, hkv * hd)),
        "wv": ParamSpec((d, hkv * hd)),
        "wo": ParamSpec(
            (hq * hd, d),
            scale=1.0 / (math.sqrt(hq * hd) * math.sqrt(2 * cfg.n_layers)),
        ),
    }


def attention_block(params: dict, x: torch.Tensor, cfg, *, positions, cache,
                    cache_len, block_tables, seq_mask=None, causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """The paged and cache-less branches of the JAX ``attention_block``.

    ``cache`` None (training, full-sequence forward): project, rotate and
    attend over the sequence itself through the flash-attention kernel,
    at ``positions`` (B,S). ``cache`` dict(k_pages=(P+1,page,Hkv,hd),
    v_pages=...): write this step's K/V into the pool (in place), attend
    through the block table; ``positions`` doubles as each row's write
    index. S == 1 is a decode step (paged decode kernel), S > 1 a prefill
    chunk (paged prefill kernel). Returns (B,S,d)."""
    if cache is not None and "k_pages" not in cache:
        raise NotImplementedError(
            "the dense-cache attention branch is not ported yet: use the "
            "paged cache"
        )
    B, S, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    compute = cfg.compute_dtype
    q = (x @ params["wq"].to(compute)).reshape(B, S, hq, hd)
    k = (x @ params["wk"].to(compute)).reshape(B, S, hkv, hd)
    v = (x @ params["wv"].to(compute)).reshape(B, S, hkv, hd)
    if cfg.rope_theta:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.partial_rotary)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.partial_rotary)

    if cache is None:
        o = flash_attention(q, k, v, q_positions=positions, k_positions=positions,
                            causal=causal, window=window, softcap=cfg.attn_softcap)
        return o.reshape(B, S, hq * hd) @ params["wo"].to(compute)

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
    return o.reshape(B, S, hq * hd) @ params["wo"].to(compute)
