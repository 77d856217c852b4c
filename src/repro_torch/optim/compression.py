"""Gradient compression for the cross-pod hop (``repro.optim.compression``).

int8 block quantization with per-block scales: ``BLOCK`` values a block,
each block scaled by its largest |value| / 127 (at least 1e-12), rounded
half to even and clipped to [-127, 127]. With a key the rounding is
stochastic, ``round(x + u - 0.5)`` with ``u`` drawn by ``repro_torch.prng.uniform``,
so the draws are ``jax.random.uniform``'s bit for bit. The train step
round-trips every gradient through it when ``TrainConfig.compress_dcn_grads``
is set.
"""

from __future__ import annotations

import torch

from repro_torch import prng

BLOCK = 256


def compress_int8(g: torch.Tensor, key: torch.Tensor | None = None):
    """g: any-shape float tensor -> (q int8 (nblocks, BLOCK), scale fp32
    (nblocks,), meta). ``key``: a ``prng.prng_key`` (2,) for stochastic
    rounding."""
    flat = g.to(torch.float32).reshape(-1)
    true_n = flat.shape[0]
    pad = (-true_n) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.clamp(torch.amax(torch.abs(blocks), dim=1) / 127.0, min=1e-12)
    x = blocks / scale[:, None]
    if key is not None:
        noise = prng.uniform(key.to(g.device), x.numel()).reshape(x.shape) - 0.5
        x = x + noise
    q = torch.clamp(torch.round(x), -127, 127).to(torch.int8)
    return q, scale, (tuple(g.shape), true_n)


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, meta,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    shape, true_n = meta
    flat = (q.to(torch.float32) * scale[:, None]).reshape(-1)[:true_n]
    return flat.reshape(shape).to(dtype)
