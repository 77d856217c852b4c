"""Parameter declaration and the port's own seeded initializer.

A layer declares its parameters as a nested dict of ``ParamSpec`` (shape
+ initializer), the same tree the JAX package declares, so that the JAX
parameter pytree converts leaf for leaf (``repro_torch.convert``). The
JAX package's logical sharding axes have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    init: str = "normal"      # normal | zeros | ones
    scale: float | None = None
    dtype: torch.dtype | None = None  # None -> config param dtype


def tree_map(fn: Callable, tree):
    """Map over the leaves of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs in sorted-key order; paths join keys with '/'."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_leaves(tree[k], f"{prefix}/{k}" if prefix else k)
        return out
    return [(prefix, tree)]


# A leaf of more elements than DRAW_SLICE_ELEMENTS is drawn in slices along
# its leading axis (qwen3-moe-30b-a3b's stacked experts: 9.66e9 elements,
# 38.7 GB of fp32 whole), as many rows a slice as keep it within
# DRAW_CHUNK_ELEMENTS (one row at least); every leaf of the dense archs
# lies below the threshold and draws as one call.
DRAW_SLICE_ELEMENTS = 2**32
DRAW_CHUNK_ELEMENTS = 2**28


def init_params(tree, generator: torch.Generator,
                param_dtype: torch.dtype = torch.float32, device=None):
    """Materialize a ParamSpec tree, one draw per leaf in sorted-key order.

    Reproduces the JAX initializer's distribution exactly: ``normal``
    leaves are N(0, 1) in fp32 times ``scale``, or times
    ``1/sqrt(shape[0])`` when the spec has none, then cast. ``shape[0]``
    is read off the shape as declared, which for a layer stacked over
    ``repeats`` is the repeat count: tinyllama's ``wq``/``wk``/``wv``/
    ``wi_gate``/``wi_up`` draw with std ``1/sqrt(22)``. That is the JAX
    package's behaviour and is kept, so full-width activations sit in the
    same numerical regime. The numbers themselves differ from
    ``jax.random``'s; parity tests convert JAX weights instead.

    Draws come from ``generator`` on its own device and are then moved to
    ``device``, so a CPU generator gives the same weights on every device;
    a CUDA generator draws on the card (a large model's weights then never
    cross the host). A leaf is scaled in place and cast, so a draw holds
    its fp32 leaf and the cast copy at once, never a second fp32 copy. A
    leaf of more than ``DRAW_SLICE_ELEMENTS`` elements is drawn slice by slice
    along its leading axis into the cast leaf (``DRAW_CHUNK_ELEMENTS`` a
    slice, one row at least), so at most one slice is ever held in fp32.
    """
    out = {}

    def make(spec: ParamSpec):
        dtype = spec.dtype or param_dtype
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        fan_in = spec.shape[0] if spec.shape else 1
        scale = spec.scale if spec.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
        if math.prod(spec.shape) > DRAW_SLICE_ELEMENTS:
            leaf = torch.empty(spec.shape, dtype=dtype, device=device)
            n = spec.shape[0]
            rows = max(1, DRAW_CHUNK_ELEMENTS // (math.prod(spec.shape) // n))
            for i in range(0, n, rows):
                w = torch.randn((min(rows, n - i),) + spec.shape[1:], generator=generator,
                                dtype=torch.float32, device=generator.device)
                leaf[i:i + rows].copy_(w.mul_(scale))
                del w
            return leaf
        w = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return w.mul_(scale).to(dtype=dtype, device=device)

    for path, spec in tree_leaves(tree):
        out[path] = make(spec)
    return unflatten(out)


def unflatten(flat: dict[str, Any]) -> dict:
    """Inverse of ``tree_leaves`` for '/'-joined paths."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def count_params(tree) -> int:
    total = 0
    for _, leaf in tree_leaves(tree):
        shape = leaf.shape if isinstance(leaf, ParamSpec) else tuple(leaf.shape)
        total += math.prod(shape)
    return total
