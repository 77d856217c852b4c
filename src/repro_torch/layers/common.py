"""Parameter declaration, the port's own seeded initializer, and the
logical sharding substrate (``repro.layers.common``).

A layer declares its parameters as a nested dict of ``ParamSpec`` (shape
+ *logical* axis names + initializer), the same tree the JAX package
declares, so that the JAX parameter pytree converts leaf for leaf
(``repro_torch.convert``). ``param_pspecs`` maps the logical axes to mesh
axes through an arch's sharding rules (``distributed.sharding``);
``LogicalConstraints`` does the same for activations. A pspec is a tuple
with one entry per dim: ``None``, a mesh-axis name, or a tuple of names,
the data of JAX's ``PartitionSpec`` (``tuple(P(...))`` compares equal).
A mesh is anything with ``axis_names`` and ``devices.shape``
(``launch.mesh.Mesh``, or a JAX mesh).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    logical: tuple[Any, ...] | None = None  # logical axis name (or None) per dim
    init: str = "normal"      # normal | zeros | ones
    scale: float | None = None
    dtype: torch.dtype | None = None  # None -> config param dtype

    def __post_init__(self):
        if self.logical is None:  # no axis named: replicated
            object.__setattr__(self, "logical", (None,) * len(self.shape))
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


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


def abstract_params(tree, param_dtype: torch.dtype = torch.float32) -> dict:
    """The ParamSpec tree as meta tensors (JAX ``abstract_params``): each
    leaf's shape in its own dtype, else ``param_dtype``; nothing is
    allocated."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype or param_dtype,
                                          device="meta"), tree)


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


def spec_bytes(tree, param_dtype: torch.dtype = torch.float32) -> int:
    """Bytes of a ParamSpec tree's leaves in their dtypes."""
    return sum(math.prod(s.shape) * (s.dtype or param_dtype).itemsize
               for _, s in tree_leaves(tree))


# ---------------------------------------------------------------------------
# logical axes -> mesh axes
# ---------------------------------------------------------------------------


def mesh_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _flat(ax) -> tuple:
    return (ax,) if isinstance(ax, str) else tuple(ax)


def _entry(axes: tuple):
    """A pspec entry: None, one axis name, or a tuple of names."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def _divisible_prefix(dim: int, axes: tuple, sizes: dict) -> tuple:
    """The longest prefix of ``axes`` whose sizes' product divides ``dim``."""
    keep, prod = [], 1
    for a in axes:
        nxt = prod * sizes.get(a, 1)
        if dim % nxt:
            break
        keep.append(a)
        prod = nxt
    return tuple(keep)


def param_pspecs(tree, rules: dict[str, Any], mesh=None):
    """Map logical axes -> mesh axes (JAX ``param_pspecs``). ``rules[name]``
    may be a mesh axis name, a tuple of axes, or None (replicated). A mesh
    axis appears once per pspec. With ``mesh`` given, each dim keeps only
    the longest prefix of its mapped axes whose product divides the dim
    size (a (5248,) conv bias cannot shard 256 ways)."""
    sizes = mesh_sizes(mesh) if mesh is not None else None

    def to_pspec(spec: ParamSpec) -> tuple:
        axes, used = [], set()
        for dim, name in zip(spec.shape, spec.logical):
            ax = rules.get(name) if name is not None else None
            if ax is not None:
                flat = tuple(a for a in _flat(ax) if a not in used)
                if sizes is not None:
                    flat = _divisible_prefix(dim, flat, sizes)
                used.update(flat)
                ax = _entry(flat)
            axes.append(ax)
        return tuple(axes)

    return tree_map(to_pspec, tree)


class LogicalConstraints:
    """Logical axes -> mesh axes for activations (JAX ``LogicalConstraints``).
    The port has no sharding propagation to constrain: the model reads
    ``group_count`` (the MoE dispatch's token groups) and nothing else.
    ``ranks``, when set, says that the tensors a layer sees are this rank's
    rows of the batch (``distributed.shard.BatchRanks``): one group of
    ``ranks.shards``, with the cross-rank sums it needs. ``tp``, when set
    (``distributed.shard.TensorParallel``), says that the residual stream
    is this rank's part of the sequence and that the layers compute their
    ``"model"`` share, meeting through ``tp``'s collectives. ``cp``, when
    set (``distributed.shard.ContextParallel``), says that the residual
    stream is this rank's part of the sequence and that the layers keep
    their weights whole (attention gathers K and V). ``kv``, when set
    (``distributed.shard.CacheSplit``), says that the serving caches are
    this rank's blocks under ``distributed.sharding.cache_pspec_tree``.
    ``attn_tp``, when set (``distributed.shard.RowParallel``; a decode step
    on an fsdp mesh whose KV heads split over ``"model"``), says that
    attention alone runs over the rank's heads, cut from the whole leaves,
    and meets in an all-reduce; the other layers run whole. Without a mesh
    all five are None and the layers run whole."""

    def __init__(self, mesh, rules: dict[str, Any] | None, ranks=None, tp=None, cp=None,
                 kv=None, attn_tp=None):
        self.mesh = mesh
        self.rules = rules or {}
        self.ranks = ranks
        self.tp = tp
        self.cp = cp
        self.kv = kv
        self.attn_tp = attn_tp

    @property
    def seq(self):
        """The split of the residual stream's sequence (``tp`` or ``cp``), or None."""
        return self.tp or self.cp

    def sum_axes(self, split: bool = False) -> tuple:
        """The mesh axes along which a leaf's gradient is summed: the ranks
        with other rows of the batch, and, where the sequence is split,
        the ``"model"`` peers, unless the leaf is ``split`` (a tensor-
        parallel rank's own ``"model"`` block, which no peer uses)."""
        axes = self.ranks.axes if self.ranks is not None else ()
        if self.seq is not None and not split:
            axes = axes + ("model",)
        return axes

    def pspec(self, *logical_axes) -> tuple:
        axes, used = [], set()
        for name in logical_axes:
            ax = self.rules.get(name) if name is not None else None
            if ax is not None:
                flat = tuple(a for a in _flat(ax) if a not in used)
                used.update(flat)
                ax = _entry(flat)
            axes.append(ax)
        return tuple(axes)

    def pspec_for(self, shape, *logical_axes) -> tuple:
        """Shape-aware pspec: per dim, keep the longest prefix of mapped
        mesh axes whose product divides the dim size (batch=32 over a
        ("data","model") mapping degrades to ("data",) instead of failing)."""
        sizes = mesh_sizes(self.mesh)
        axes, used = [], set()
        for dim, name in zip(shape, logical_axes):
            ax = self.rules.get(name) if name is not None else None
            if ax is None:
                axes.append(None)
                continue
            keep = _divisible_prefix(dim, tuple(a for a in _flat(ax) if a not in used), sizes)
            used.update(keep)
            axes.append(_entry(keep))
        return tuple(axes)

    def group_count(self, logical_name: str, dim: int) -> int:
        """Largest product of a prefix of the mapped mesh axes that divides
        ``dim`` (the MoE dispatch's groups: sorting stays per data shard)."""
        if self.mesh is None:
            return 1
        ax = self.rules.get(logical_name)
        if ax is None:
            return 1
        sizes = mesh_sizes(self.mesh)
        return math.prod(sizes.get(a, 1) for a in _divisible_prefix(dim, _flat(ax), sizes))

    def axis_size(self, logical_name: str) -> int:
        """Product of mesh-axis sizes a logical axis maps to (1 if unmapped)."""
        if self.mesh is None:
            return 1
        ax = self.rules.get(logical_name)
        if ax is None:
            return 1
        sizes = mesh_sizes(self.mesh)
        return math.prod(sizes.get(a, 1) for a in _flat(ax))


NULL_CONSTRAINTS = LogicalConstraints(None, None)
