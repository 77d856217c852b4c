"""Plain PyTorch versions of paged decode and paged prefill attention.

Both gather a slot's pages into the dense ``(B, n_logical*page, Hkv, D)``
view through the block table (``-1`` entries clipped to page 0; the
``cache_len`` mask hides them), then attend:

* decode: ``repro.layers.attention.decode_attention`` transcribed (the JAX
  ``paged_attention_reference``), except that a row with no visible key
  (cache_len 0) outputs 0, as the Pallas kernel does, where the softmax
  over its NEG_INF scores would give the mean of V;
* prefill: one masked softmax over the whole view with the ``kv_len``,
  causal, window and softcap semantics of the JAX ``flash_attention``:
  ``NEG_INF`` fill, the ``m_safe`` guard, masked probabilities forced to
  0, and ``o / max(l, 1e-30)``, so a fully masked row outputs 0.

Both accumulate in fp32, or in float64 for float64 inputs.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def gather_pages(pages: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """pages: (P, page, Hkv, D); block_tables: (B, n_logical) int.
    Returns (B, n_logical*page, Hkv, D)."""
    P, page, Hkv, D = pages.shape
    B, nL = block_tables.shape
    tbl = block_tables.long().clamp(0, P - 1)
    return pages[tbl].reshape(B, nL * page, Hkv, D)


def per_row(x, B: int, device) -> torch.Tensor:
    """() or (B,) lengths/positions -> contiguous (B,) int32 on ``device``."""
    t = torch.as_tensor(x, device=device).to(torch.int32)
    return t.reshape(-1).expand(B).contiguous()


def paged_attention_reference(q, k_pages, v_pages, block_tables, *, q_position,
                              cache_len, window: int | None = None,
                              softcap: float | None = None) -> torch.Tensor:
    """q: (B,1,Hq,D); pools (P,page,Hkv,D); block_tables (B,nL);
    q_position/cache_len: () or (B,). Returns (B,1,Hq,D) in q.dtype."""
    k_cache = gather_pages(k_pages, block_tables)
    v_cache = gather_pages(v_pages, block_tables)
    B, _, Hq, D = q.shape
    Sk, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, 1, Hkv, G, D).permute(0, 3, 2, 1, 4)  # (B,G,Hkv,1,D)
    kg = k_cache.permute(0, 2, 1, 3)  # (B,Hkv,Sk,D)
    vg = v_cache.permute(0, 2, 1, 3)
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bghqd,bhkd->bghqk", qg.to(acc), kg.to(acc))
    s = s * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    kpos = torch.arange(Sk, device=q.device)[None, None, None, None, :]
    qpos = per_row(q_position, B, q.device).reshape(-1, 1, 1, 1, 1)
    mask = kpos < per_row(cache_len, B, q.device).reshape(-1, 1, 1, 1, 1)
    if window is not None and window > 0:
        mask = mask & (kpos > qpos - window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    # a row that sees no key (an idle slot, cache_len 0) writes 0, as the
    # Pallas kernel and the port's kernels do (the softmax alone would give
    # it the mean of V); every other row is left bit for bit as it was
    p = torch.where(mask.any(dim=-1, keepdim=True), p, torch.zeros_like(p))
    o = torch.einsum("bghqk,bhkd->bghqd", p, vg.to(acc))
    return o.permute(0, 3, 2, 1, 4).reshape(B, 1, Hq, D).to(q.dtype)


def paged_prefill_attention_reference(q, k_pages, v_pages, block_tables, *,
                                      q_positions, cache_len, causal: bool = True,
                                      window: int | None = None,
                                      softcap: float | None = None) -> torch.Tensor:
    """q: (B,C,Hq,D) one chunk per row at positions ``q_positions`` (B,C);
    cache_len: () or (B,) written tokens including this chunk.
    Returns (B,C,Hq,D) in q.dtype."""
    k_cache = gather_pages(k_pages, block_tables)
    v_cache = gather_pages(v_pages, block_tables)
    B, C, Hq, D = q.shape
    Sk, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, C, Hkv, G, D).permute(0, 3, 2, 1, 4)  # (B,G,Hkv,C,D)
    kg = k_cache.permute(0, 2, 1, 3)
    vg = v_cache.permute(0, 2, 1, 3)
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bghqd,bhkd->bghqk", qg.to(acc), kg.to(acc)) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qp = torch.as_tensor(q_positions, device=q.device).reshape(B, 1, 1, C, 1)
    kp = torch.arange(Sk, device=q.device).reshape(1, 1, 1, 1, Sk)
    mask = kp < per_row(cache_len, B, q.device).reshape(B, 1, 1, 1, 1)
    if causal:
        mask = mask & (kp <= qp)
    if window is not None and window > 0:
        mask = mask & (kp > qp - window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.where(mask, torch.exp(s - m_safe), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bghqk,bhkd->bghqd", p, vg.to(acc)) / torch.clamp(l, min=1e-30)
    return o.permute(0, 3, 2, 1, 4).reshape(B, C, Hq, D).to(q.dtype)
