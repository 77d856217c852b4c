"""Plain PyTorch flash attention: the oracle for the CUDA kernels and the
CPU path.

Transcribes the semantics of ``repro.layers.attention.flash_attention``
(the jnp chunked online-softmax function the JAX training step runs) in
one unchunked pass: GQA (q head h reads kv head h // G), scores
``q.k / sqrt(D)`` in fp32 (float64 stays float64), the tanh softcap, then
the causal / window (``kpos > qpos - window``) / ``kv_len`` (``kpos <
kv_len``) masks at ``-1e30`` on the given positions, ``m_safe``, masked
probabilities 0 and ``o / max(l, 1e-30)``, so a fully masked row is 0.
Positions default to the indices ``0..S-1``. ``m_safe`` is taken out of
the graph: it only stabilises the exponent, and the normalisation makes
the result independent of it.

``flash_attention_backward_reference`` is the plain version of the
backward: autograd through the forward above.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _positions(pos, B: int, S: int, device) -> torch.Tensor:
    if pos is None:
        return torch.arange(S, device=device, dtype=torch.int32)[None].expand(B, S)
    return torch.as_tensor(pos, device=device).reshape(B, S)


def visibility(q_positions, k_positions, *, B: int, Sq: int, Sk: int, causal: bool,
               window: int | None, kv_len, device) -> torch.Tensor:
    """(B, Sq, Sk) bool: which keys each query sees."""
    qp = _positions(q_positions, B, Sq, device)[:, :, None]
    kp = _positions(k_positions, B, Sk, device)[:, None, :]
    mask = torch.ones((B, Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kp <= qp)
    if window is not None and window > 0:
        mask = mask & (kp > qp - window)
    if kv_len is not None:
        mask = mask & (kp < torch.as_tensor(kv_len, device=device).reshape(-1, 1, 1))
    return mask


def flash_attention_reference(q, k, v, *, q_positions=None, k_positions=None,
                              causal: bool = True, window: int | None = None,
                              softcap: float | None = None, kv_len=None):
    """q: (B,Sq,Hq,D); k,v: (B,Sk,Hkv,D); positions (B,S) or None (indices);
    kv_len () or (B,) or None. Returns (B,Sq,Hq,D) in q.dtype."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    acc = torch.promote_types(q.dtype, torch.float32)
    qf = q.to(acc).reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bghqk", qf, k.to(acc)) * (1.0 / math.sqrt(D))
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    mask = visibility(q_positions, k_positions, B=B, Sq=Sq, Sk=Sk, causal=causal,
                      window=window, kv_len=kv_len, device=q.device)[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True).detach()
    m_safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.where(mask, torch.exp(s - m_safe), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bghqk,bkhd->bghqd", p, v.to(acc)) / l.clamp(min=1e-30)
    return o.permute(0, 3, 2, 1, 4).reshape(B, Sq, Hq, D).to(q.dtype)


def flash_attention_backward_reference(q, k, v, dout, **kw):
    """(dq, dk, dv) of ``flash_attention_reference`` for the cotangent
    ``dout``, by autograd, each in its input's dtype."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_reference(*leaves, **kw)
        return torch.autograd.grad(out, leaves, dout)
