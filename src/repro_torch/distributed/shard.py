"""Ranks that hold only their blocks: placements, the batch split, the
gather that a layer's weights go through, and the splits of the compute
over the mesh's ``"model"`` axis: tensor parallelism on a megatron mesh,
context parallelism on an fsdp mesh whose batch leaves that axis whole.

A leaf's placement is a ``NamedSharding``: a mesh and a pspec (a tuple,
one entry a dim: None, an axis name, or a tuple of names, major first).
Along a dim sharded over axes ``(a, b)`` the block index is ``i_a *
size_b + i_b``, as a JAX mesh orders its devices. A rank stores the
block at its own coordinates as a plain contiguous tensor; ranks that
differ only along axes the pspec does not name hold equal copies.

Each rank runs its rows of the global batch (``BatchRanks``, the rows
the ``"batch"`` activation rule gives it). ``gather`` assembles a leaf
just before its use: forward, an all-gather over the axes it is asked
to assemble; backward, the gradient summed over ``sum_axes`` (the ranks
whose work differs) and cut back to this rank's block: a reduce-scatter
over the assembled axes, then an all-reduce over the other summed axes;
when the assembled axes are not all summed (the ``"model"`` peers of a
megatron mesh without tensor parallelism, which compute the same rows),
the full gradient is all-reduced over ``sum_axes`` and each rank cuts
its block, so identical gradients count once. ``gloo`` has no
reduce-scatter for CUDA tensors: there the reduce-scatter is an
all-reduce and the rank's slice.

On a megatron mesh whose ``"model"`` axis is above 1 the compute splits
as JAX's activation rules split it (``TensorParallel``): the residual
stream is sequence-sharded over ``"model"``; attention runs on the
rank's query heads, the MLP on its hidden columns, the MoE FFN on its
experts, the embedding and the logits on its vocabulary rows, a mamba2
block on its SSM heads. A leaf that such a layer splits (``"qkv"``,
``"kv"`` when the kv heads divide, ``"mlp"``, ``"experts"``,
``"vocab"``, a split mamba2's ``out_proj``, gated-norm scale and
per-head leaves) is assembled over its other axes only and keeps its
``"model"`` block; its gradient is summed over the ranks with other rows
of the batch. Every other leaf (norm scales, the router, ``q_norm``, a
kv projection whose heads do not divide, mamba2's ``in_proj`` and conv,
whose B/C columns every head reads, the blocks this split leaves whole)
is assembled whole and its gradient summed over those ranks and the
``"model"`` peers: each rank's part of it comes from other sequence
rows or other heads. Under the fsdp strategy, where the batch does not
split over ``"model"`` (JAX's ``"batch"`` rule backs off to a prefix
without it), the ``"model"`` peers split the sequence instead
(``ContextParallel``): every leaf is whole and its gradient summed over
the ranks with other rows and the ``"model"`` peers. The ``"data"``
peers of a batch too small for that axis hold the same rows and sum no
gradient between them. The layers meet through the collectives of
``SequenceSplit``, each an ``autograd.Function`` whose backward is the
matching collective.
"""

from __future__ import annotations

import math

import torch


def _dist():
    import torch.distributed as dist

    return dist


class NamedSharding:
    """``mesh`` + ``spec``: where a leaf's blocks live (JAX's
    ``NamedSharding``'s data)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec})"

    def dim_axes(self, ndim: int) -> list[tuple]:
        out = []
        for d in range(ndim):
            ax = self.spec[d] if d < len(self.spec) else None
            out.append(() if ax is None else ((ax,) if isinstance(ax, str) else tuple(ax)))
        return out

    @property
    def axes(self) -> tuple:
        """Every axis the spec names, in mesh order."""
        named = [a for e in self.spec if e is not None
                 for a in ((e,) if isinstance(e, str) else e)]
        return self.mesh.ordered(named)

    def block_shape(self, shape) -> tuple:
        sizes = self.mesh.sizes
        out = []
        for n, dax in zip(shape, self.dim_axes(len(shape))):
            k = math.prod(sizes[a] for a in dax)
            if n % k:
                raise ValueError(f"dim {n} does not split over {dax} ({k})")
            out.append(n // k)
        return tuple(out)

    def block_slices(self, shape, rank: int | None = None) -> tuple:
        """The slices of the full leaf that ``rank`` (default: this rank) holds."""
        sizes, c = self.mesh.sizes, self.mesh.coords(rank)
        out = []
        for n, blk, dax in zip(shape, self.block_shape(shape), self.dim_axes(len(shape))):
            i = 0
            for a in dax:
                i = i * sizes[a] + c[a]
            out.append(slice(i * blk, (i + 1) * blk))
        return tuple(out)

    def without(self, axis: str) -> "NamedSharding":
        """The placement with ``axis`` left out: what remains to assemble
        of a leaf whose ``axis`` block a rank computes with."""
        def drop(e):
            if e is None or e == axis:
                return None
            if isinstance(e, str):
                return e
            rest = tuple(a for a in e if a != axis)
            return rest[0] if len(rest) == 1 else (rest or None)

        return NamedSharding(self.mesh, tuple(drop(e) for e in self.spec))

    def local(self, full):
        """This rank's block of ``full`` (a view)."""
        return full[self.block_slices(tuple(full.shape))]

    def owned(self, rank: int | None = None) -> bool:
        """Whether ``rank`` is the one holder of its block that counts it:
        index 0 along every axis the spec does not name."""
        c = self.mesh.coords(rank)
        named = set(self.axes)
        return all(c[a] == 0 for a in self.mesh.axis_names if a not in named)


def shardings_tree(mesh, pspec_tree):
    """A pspec tree (``param_pspecs``) -> the same tree of ``NamedSharding``s."""
    from repro_torch.layers.common import tree_map

    return tree_map(lambda p: NamedSharding(mesh, p), pspec_tree)


class BatchRanks:
    """This rank's rows of a batch split over mesh ``axes`` (the ``"batch"``
    pspec entry of the batch's shape, major first): ``shards`` groups of
    equal rows; ``group`` sums over the ranks that hold different rows."""

    def __init__(self, mesh, axes):
        self.mesh = mesh
        self.axes = tuple(axes)
        sizes, c = mesh.sizes, mesh.coords()
        self.shards = math.prod(sizes[a] for a in self.axes)
        idx = 0
        for a in self.axes:
            idx = idx * sizes[a] + c[a]
        self.index = idx
        self.group = mesh.group(self.axes) if self.axes else None

    @classmethod
    def for_batch(cls, lc, shape) -> "BatchRanks":
        """The split the activation rules give a (B, ...) batch: ``lc.pspec_for(
        shape, "batch", None, ...)``'s first entry."""
        ax = lc.pspec_for(tuple(shape), "batch", *([None] * (len(shape) - 1)))[0]
        return cls(lc.mesh, () if ax is None else ((ax,) if isinstance(ax, str) else ax))

    def rows(self, n: int) -> slice:
        per = n // self.shards
        return slice(self.index * per, (self.index + 1) * per)

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce ``t`` in place over the ranks with other rows."""
        if self.group is not None:
            _dist().all_reduce(t, group=self.group)
        return t


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _gloo_cuda(t: torch.Tensor, group) -> bool:
    return t.is_cuda and _dist().get_backend(group) == "gloo"


def _all_gather(block: torch.Tensor, group) -> torch.Tensor:
    """(n, *block.shape): the group's blocks in group rank order."""
    dist = _dist()
    block = block.contiguous()
    n = dist.get_world_size(group)
    if _gloo_cuda(block, group):
        parts = [torch.empty_like(block) for _ in range(n)]
        dist.all_gather(parts, block, group=group)
        return torch.stack(parts)
    # the concatenated form (gloo takes no other): (n * b0, ...) -> (n, b0, ...)
    out = block.new_empty((n * block.shape[0],) + tuple(block.shape[1:]))
    ag = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    ag(out, block, group=group)
    return out.view((n,) + tuple(block.shape))


def _reduce_scatter(stacked: torch.Tensor, group) -> torch.Tensor:
    """Sum of the group's (n, *blk) stacks; this rank's row."""
    dist = _dist()
    if _gloo_cuda(stacked, group):
        dist.all_reduce(stacked, group=group)
        return stacked[dist.get_rank(group)].clone()
    out = stacked.new_empty(tuple(stacked.shape[1:]))
    rs = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    rs(out, stacked.reshape((-1,) + tuple(stacked.shape[2:])), group=group)
    return out


def _assemble(stacked: torch.Tensor, sh: NamedSharding) -> torch.Tensor:
    """(n, *blk) in group rank order (row-major over ``sh.axes``) -> full."""
    axes, sizes = sh.axes, sh.mesh.sizes
    blk = tuple(stacked.shape[1:])
    t = stacked.reshape(*(sizes[a] for a in axes), *blk)
    k = len(axes)
    perm, shape = [], []
    for d, dax in enumerate(sh.dim_axes(len(blk))):
        perm += [axes.index(a) for a in dax] + [k + d]
        shape.append(blk[d] * math.prod(sizes[a] for a in dax))
    return t.permute(perm).reshape(shape)


def _split(full: torch.Tensor, sh: NamedSharding) -> torch.Tensor:
    """The inverse of ``_assemble``: full -> (n, *blk), contiguous."""
    axes, sizes = sh.axes, sh.mesh.sizes
    blk = sh.block_shape(tuple(full.shape))
    view, pos, bpos = [], {}, []
    for d, dax in enumerate(sh.dim_axes(full.dim())):
        for a in dax:
            pos[a] = len(view)
            view.append(sizes[a])
        bpos.append(len(view))
        view.append(blk[d])
    t = full.reshape(view).permute([pos[a] for a in axes] + bpos)
    return t.reshape((-1,) + blk).contiguous()


@torch.no_grad()
def gather_full(block: torch.Tensor, sh: NamedSharding) -> torch.Tensor:
    """The full leaf from the blocks of the ranks along ``sh.axes``."""
    group = sh.mesh.group(sh.axes)
    if group is None:
        return block
    return _assemble(_all_gather(block, group), sh)


@torch.no_grad()
def reduce_to_block(g: torch.Tensor, sh: NamedSharding, sum_axes) -> torch.Tensor:
    """A full-shape gradient summed over the ranks along ``sum_axes``, as
    this rank's block under ``sh``."""
    mesh, dist = sh.mesh, _dist()
    held, split = set(sh.axes), set(sum_axes)
    if held <= split:
        if held:
            blk = _reduce_scatter(_split(g, sh), mesh.group(held))
        else:
            blk = g.contiguous().clone()
        if split - held:
            dist.all_reduce(blk, group=mesh.group(split - held))
        return blk
    if split:
        g = g.contiguous().clone()
        dist.all_reduce(g, group=mesh.group(split))
    return sh.local(g).contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, sh, sum_axes):
        ctx.sh, ctx.sum_axes = sh, sum_axes
        full = gather_full(block, sh)
        return full.clone() if full is block else full

    @staticmethod
    def backward(ctx, g):
        return reduce_to_block(g, ctx.sh, ctx.sum_axes), None, None


def gather(block: torch.Tensor, sh: NamedSharding, sum_axes=()) -> torch.Tensor:
    """The leaf assembled over ``sh``'s axes, differentiable: the backward
    sums the gradient over the ranks along ``sum_axes`` and returns this
    rank's block. On a mesh without a process group, ``block`` itself."""
    if not sh.mesh.distributed:
        return block
    return _Gather.apply(block, sh, tuple(sum_axes))


# ---------------------------------------------------------------------------
# tensor parallelism over "model"
# ---------------------------------------------------------------------------


def _seq_all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(B, s, ...) a rank -> (B, n*s, ...), the group's parts in rank order."""
    return _all_gather(x, group).movedim(0, 1).flatten(1, 2)


def _seq_reduce_scatter(y: torch.Tensor, group) -> torch.Tensor:
    """(B, S, ...) partial sums -> their sum's (B, S/n, ...) part of this rank."""
    n = _dist().get_world_size(group)
    stacked = y.unflatten(1, (n, y.shape[1] // n)).movedim(1, 0).contiguous()
    return _reduce_scatter(stacked, group)


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq_all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _seq_reduce_scatter(g, ctx.group), None


class _SeqScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        return _seq_reduce_scatter(y, group)

    @staticmethod
    def backward(ctx, g):
        return _seq_all_gather(g, ctx.group), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        _dist().all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _dist().all_reduce(g, group=ctx.group)
        return g, None


class SequenceSplit:
    """The residual stream split along the sequence over the mesh's
    ``"model"`` axis: ``size`` ranks, this rank's ``index`` along it and
    their ``group``; a rank holds ``part(S)`` of every (B, S, ...) row.
    ``TensorParallel`` and ``ContextParallel`` say what the layers split
    besides."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.size = mesh.sizes["model"]
        self.index = mesh.coords()["model"]
        self.group = mesh.group(("model",))

    def part(self, n: int) -> slice:
        """This rank's ``n // size`` of ``n`` (heads, columns, experts,
        vocabulary rows, sequence positions)."""
        if n % self.size:
            raise ValueError(f"{n} does not split over the model axis ({self.size})")
        k = n // self.size
        return slice(self.index * k, (self.index + 1) * k)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's sequence part of a (B, S, ...) tensor that every rank holds."""
        return x[:, self.part(x.shape[1])]

    def seq_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S/n, ...) -> (B, S, ...); backward: the reduce-scatter."""
        return _SeqGather.apply(x, self.group)

    def seq_scatter(self, y: torch.Tensor) -> torch.Tensor:
        """(B, S, ...) partial sums -> this rank's (B, S/n, ...) of their
        sum; backward: the all-gather."""
        return _SeqScatter.apply(y, self.group)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the ``"model"`` ranks; backward: the same sum of the
        gradients (each rank's use of the sum is its own term of the loss)."""
        return _AllReduce.apply(x, self.group)

    def max_(self, x: torch.Tensor) -> torch.Tensor:
        """In-place maximum over the ``"model"`` ranks (no gradient)."""
        _dist().all_reduce(x, op=_dist().ReduceOp.MAX, group=self.group)
        return x


def _model_axis_over_ranks(mesh) -> bool:
    return mesh is not None and mesh.distributed and mesh.sizes.get("model", 1) > 1


class TensorParallel(SequenceSplit):
    """The compute split over a megatron mesh's ``"model"`` axis: the
    residual stream along the sequence, attention over its query heads,
    the MLP over its hidden columns, the MoE FFN over its experts, the
    embedding and the logits over its vocabulary rows, and a mamba2 block
    whose SSM heads divide the axis over its heads (``layers.recurrent``)."""

    @classmethod
    def of(cls, cfg, mesh) -> "TensorParallel | None":
        """The split for ``cfg`` on ``mesh``: a mesh over a process group
        whose ``"model"`` axis is above 1, under the megatron strategy;
        else None (the compute splits only the batch)."""
        from repro_torch.distributed.sharding import effective_strategy

        if not _model_axis_over_ranks(mesh) or effective_strategy(cfg, mesh) != "megatron":
            return None
        return cls(mesh)


class ContextParallel(SequenceSplit):
    """fsdp's context-parallel fallback (JAX's fsdp activation rules,
    ``"seq": "model"``, ``"seq_q": "model"``, ``"seq_kv": None``, where the
    batch does not split over ``"model"``): the residual stream, the
    norms, the MLP and the CE run on the rank's sequence part with whole
    weights; attention keeps the rank's query block at its true positions
    and all-gathers K and V (``seq_gather``: the backward reduce-scatters
    each rank's partial dK, dV); a recurrent block or the MoE FFN, which
    need the whole sequence, run on the gathered rows and keep their part.
    Each ``"model"`` peer's weight gradient is then a partial over other
    rows, so it is summed over ``"model"`` too."""

    @classmethod
    def of(cls, cfg, mesh, ranks) -> "ContextParallel | None":
        """The split for ``cfg`` on ``mesh`` for a batch that ``ranks``
        (``BatchRanks``) splits: the fsdp strategy, a ``"model"`` axis
        above 1 over a process group, and a batch split that backs off to
        axes without ``"model"``; else None."""
        from repro_torch.distributed.sharding import effective_strategy

        if (not _model_axis_over_ranks(mesh) or effective_strategy(cfg, mesh) != "fsdp"
                or "model" in ranks.axes):
            return None
        return cls(mesh)
