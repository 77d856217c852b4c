"""The ``jax.random`` functions the serving scheduler samples with (and the
int8 gradient compression draws its rounding noise with), in
torch integer ops (JAX's default ``threefry2x32`` generator, with
``jax_threefry_partitionable`` on, as in JAX 0.9).

Threefry is counter-based and stateless, so these functions give the
JAX package's bits, uniforms, Gumbel draws and categorical samples for
the same key and the same counters, on the CPU and on the card alike.
Keys are ``(..., 2)`` int64 tensors holding two uint32 words (JAX's
``(2,)`` uint32 key data); every intermediate stays in int64 and is
masked back to 32 bits, since not every uint32 op exists on both devices.

  prng_key(seed)            jax.random.PRNGKey(seed)
  split(key, n)             jax.random.split(key, n)
  fold_in(keys, data)       jax.random.fold_in, vectorised over rows
  random_bits(keys, n)      jax.random.bits(key, (n,)) for each key row
  uniform(keys, n, lo, hi)  jax.random.uniform(key, (n,), float32, lo, hi)
  gumbel(keys, n)           jax.random.gumbel(key, (n,), float32), mode "low"
  categorical(keys, logits) jax.random.categorical(key, logits) per row
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block (20 rounds) of key words ``k0, k1`` over
    counter words ``x0, x1``; int64 tensors (or ints) of uint32 values that
    broadcast together. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``PRNGKey(seed)``: the seed's high and low 32 bits, (2,) int64."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK, seed & MASK], dtype=torch.int64,
                        device=device)


def split(key: torch.Tensor, n: int) -> torch.Tensor:
    """``split(key, n)``: threefry of ``key`` over counters (0, i), (n, 2)."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``fold_in(key, data)``: threefry of each key over the counter pair
    (0, data & 0xFFFFFFFF). ``keys`` (..., 2) and ``data`` (...) broadcast
    (rows (N, 2) with positions (N,), or one key with many data)."""
    if not isinstance(data, torch.Tensor):
        data = torch.full((), int(data), dtype=torch.int64, device=keys.device)
    data = data.to(torch.int64) & MASK
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits a position, ``(..., n)`` for ``keys`` (..., 2): the
    partitionable layout, ``y0 ^ y1`` of threefry over counters (0, i)."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[..., 0, None], keys[..., 1, None], torch.zeros_like(i), i)
    return y0 ^ y1


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniforms in [minval, maxval), ``(..., n)``: the top 23 bits
    as the mantissa of a float in [1, 2), minus 1, scaled, and clamped
    below at ``minval``, each step in float32 as JAX takes it."""
    bits = random_bits(keys, n)
    ones = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    # device scalars by a fill, not a host copy, which would wait for the
    # stream
    lo = torch.full((), minval, dtype=torch.float32, device=keys.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=keys.device)
    return torch.maximum(lo, (ones - 1.0) * (hi - lo) + lo)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """float32 standard Gumbel draws, ``(..., n)``: ``-log(-log(u))`` with
    ``u`` uniform in [tiny, 1) (JAX's mode "low")."""
    return -torch.log(-torch.log(uniform(keys, n, _TINY, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One index a row of ``logits`` (..., V) by the Gumbel-max trick, the
    first on a tie: ``argmax(gumbel + logits)``; int64 (...)."""
    return torch.argmax(gumbel(keys, logits.shape[-1]).to(logits.dtype) + logits, dim=-1)
