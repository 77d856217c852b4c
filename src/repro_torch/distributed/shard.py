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

    def channel_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(..., C/n) a rank -> (..., C), the ranks' blocks in rank order (no
        gradient: a serving cache's channel blocks)."""
        return _gather_dim(x, self.group, -1)


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


# ---------------------------------------------------------------------------
# the serving steps over a mesh
# ---------------------------------------------------------------------------


def _gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's blocks of ``x`` side by side along ``dim``, in rank order
    (no gradient: the serving steps run under inference mode)."""
    parts = _all_gather(x, group)                      # (n, *x.shape)
    return torch.cat(list(parts.unbind(0)), dim=dim)


class RowParallel(TensorParallel):
    """A decode step's split over a megatron mesh's ``"model"`` axis: one
    token a row, so the residual stays whole on every rank (JAX's ``"seq"``
    rule backs off on a dim of 1). The layers compute the same shares as
    under ``TensorParallel`` (query heads, MLP columns, experts, vocabulary
    rows, SSM heads) on the whole residual, and their partial sums meet in
    an all-reduce (``_AllReduce``) where ``TensorParallel`` reduce-scatters
    along the sequence: ``seq_gather`` and ``local`` are the identity,
    ``seq_scatter`` the all-reduce. No sequence all-gather runs."""

    def local(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def seq_gather(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def seq_scatter(self, y: torch.Tensor) -> torch.Tensor:
        return self.all_reduce(y)


class CacheSplit:
    """This rank's block of the serving caches over the mesh's ``"model"``
    axis (``distributed.sharding.cache_pspec_tree``): the KV heads when
    ``n_kv_heads`` divides the axis (``heads``), else the dense cache's
    sequence (``seq``), ``max_len / size`` positions a rank from
    ``index * max_len / size``; a paged pool, whose page axis no rank
    splits, is then whole on every rank (replicated). A split mamba2's SSM
    state is its heads' and its conv state a block of its channels
    (``"inner"``); the mLSTM and sLSTM state is whole. ``group`` is the
    ``"model"`` ranks'."""

    def __init__(self, cfg, mesh):
        self.size = mesh.sizes.get("model", 1)
        self.index = mesh.coords()["model"]
        self.group = mesh.group(("model",))
        self.heads = self.size > 1 and cfg.n_kv_heads % self.size == 0
        self.seq = self.size > 1 and not self.heads

    @classmethod
    def of(cls, cfg, mesh) -> "CacheSplit | None":
        """The split on a mesh over a process group whose ``"model"`` axis is
        above 1; else None (every rank holds its rows' whole caches)."""
        return cls(cfg, mesh) if _model_axis_over_ranks(mesh) else None

    def kv_part(self, hkv: int) -> slice:
        """The KV heads of this rank's block (all of them under ``seq``)."""
        if not self.heads:
            return slice(0, hkv)
        k = hkv // self.size
        return slice(self.index * k, (self.index + 1) * k)

    def offset(self, block: int) -> int:
        """The first position of this rank's sequence block of ``block``
        positions (0 unless ``seq``)."""
        return self.index * block if self.seq else 0

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In-place sum (or ``"max"``) over the ``"model"`` ranks."""
        dist = _dist()
        dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                        group=self.group)
        return x

    def head_gather(self, q: torch.Tensor) -> torch.Tensor:
        """(B, S, H/n, D) a rank -> (B, S, H, D): the ranks' heads in rank order."""
        return _gather_dim(q, self.group, 2)


def merge_partials(o: torch.Tensor, lse: torch.Tensor, split: CacheSplit) -> torch.Tensor:
    """Attention over a key sequence split across the ``"model"`` ranks, from
    each rank's attention over its own block: ``o`` (B, S, H, D) and its
    row log-sum-exp ``lse`` (B, H, S), ``-inf`` where the block holds no key
    the row sees. The ranks all-reduce the largest LSE, then the outputs
    and the sums of exponentials rescaled to it: ``o = sum_r o_r w_r /
    sum_r w_r`` with ``w_r = exp(lse_r - max)``. A rank with no visible key
    has ``w_r = 0`` and adds nothing; a row that sees no key on any rank
    is 0, as the kernel leaves it. Computed in fp32 (float64 for float64
    inputs); returns ``o``'s dtype."""
    acc = torch.promote_types(o.dtype, torch.float32)
    lse = lse.to(acc)
    m = split.all_reduce(lse.clone(), "max")
    w = torch.where(torch.isfinite(m), torch.exp(lse - m), torch.zeros_like(lse))
    w = w.permute(0, 2, 1)[..., None]                   # (B, S, H, 1)
    num = split.all_reduce((o.to(acc) * w).contiguous())
    den = split.all_reduce(w.contiguous())
    return (num / den.clamp(min=1e-30)).to(o.dtype)


def vocab_argmax(logits: torch.Tensor, tp) -> torch.Tensor:
    """The argmax over the whole vocabulary from this rank's columns
    ``logits`` (..., V/n) (the first index on a tie, as ``argmax`` over the
    whole row gives it): each rank's largest value and its index, all-
    gathered over ``"model"``, the first rank with the largest value wins.
    Without ``tp``, the row's argmax."""
    if tp is None:
        return torch.argmax(logits, dim=-1)
    i = torch.argmax(logits, dim=-1)
    v = torch.gather(logits, -1, i[..., None])[..., 0]
    i = i + tp.index * logits.shape[-1]
    vs, ids = _all_gather(v, tp.group), _all_gather(i, tp.group)   # (n, ...)
    win = torch.argmax(vs, dim=0)
    return torch.gather(ids, 0, win[None])[0]


def vocab_gather(logits: torch.Tensor, tp) -> torch.Tensor:
    """The whole vocabulary's logits from each rank's columns (or ``logits``
    itself without ``tp``)."""
    return logits if tp is None else _gather_dim(logits, tp.group, -1)


def rows_gather(x: torch.Tensor, ranks: BatchRanks) -> torch.Tensor:
    """The global batch from each rank's rows (``ranks``' groups in order)."""
    return x if ranks.group is None else _gather_dim(x, ranks.group, 0)


def any_over(flag: torch.Tensor, tp) -> torch.Tensor:
    """``flag`` (bool) true where it is true on any of ``tp``'s ranks (the
    flag itself without ``tp``): a sentinel computed from each rank's
    vocabulary columns."""
    return flag if tp is None else tp.max_(flag.to(torch.int32)).bool()


def row_broadcast(x: torch.Tensor, ranks: BatchRanks, src: int) -> torch.Tensor:
    """The ``x`` of the rank at index ``src`` of ``ranks``' group, on every
    rank of it (the others' ``x``, of the same shape, is not read): a
    recurrent state row lent by the rank that holds it."""
    return _all_gather(x, ranks.group)[src]


class PoolRows:
    """The paged write of a step whose rows split over the batch axes: the
    pool is replicated over them (``cache_pspec_tree``), so every rank
    writes every rank's rows. ``positions`` (B, S) are the global batch's
    write positions (a masked entry moved past the table, where
    ``paged_write`` drops it) and ``tables`` the global block tables; a
    layer's K/V are all-gathered over ``ranks`` (``kv``) before the write."""

    def __init__(self, ranks: BatchRanks, positions: torch.Tensor, seq_mask, tables):
        beyond = 2 ** 30   # past any table (max_len < 2**30): a dropped write
        if seq_mask is not None:
            positions = torch.where(seq_mask, positions, torch.full_like(positions, beyond))
        self.ranks = ranks
        self.positions = rows_gather(positions.contiguous(), ranks)
        self.tables = tables

    def kv(self, k: torch.Tensor, v: torch.Tensor):
        """Every rank's rows of a layer's K and V (one all-gather)."""
        both = rows_gather(torch.cat([k, v], dim=-1).contiguous(), self.ranks)
        return both.split(k.shape[-1], dim=-1)


def cache_block_shape(shape, spec, mesh, spare: bool) -> tuple:
    """The shape of a rank's block of a full serving-cache leaf under its
    placement ``spec`` (``cache_pspec_tree``). With ``spare`` (the dense
    layout's ``(R, B+1, ...)`` leaf) the placement splits rows ``0..B-1``
    and the block ends with a spare row of its own."""
    sh = NamedSharding(mesh, spec)
    if not spare:
        return sh.block_shape(tuple(shape))
    blk = sh.block_shape((shape[0], shape[1] - 1) + tuple(shape[2:]))
    return (blk[0], blk[1] + 1) + blk[2:]
