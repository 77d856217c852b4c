"""Model assembly (``repro.models.transformer``) for training and serving.

The layer stack is ``cfg.pattern`` repeated ``cfg.repeats`` times; the
parameter tree is the JAX package's, stacked over repeats, and a Python
loop over repeats takes the place of the ``scan``. The port runs every
block kind: ``attn``, ``local_attn`` (attention over the last
``cfg.window`` keys), ``moe`` (attention, then the Mixture-of-Experts
FFN), and the recurrent ``mamba2``, ``mlstm`` and ``slstm`` (the last
with its own MLP), cache-less for training and over the paged KV pool or
the dense KV cache for serving; recurrent state stays dense, one row a
slot, in both layouts. Inputs are token ids, stub frontend
embeddings (``batch["frontend"]`` (B,P,d): the vlm's patches ahead of the
text, or the audio model's frames with no tokens and no ``embed``), or
both. An encoder-only model (bidirectional attention) has ``forward`` and
``apply_logits`` and no cache:

  model_params(cfg)                      ParamSpec tree
  Transformer.from_init(cfg, seed)       seeded weights (port's initializer)
  Transformer(cfg, params)               weights from a tree of tensors
  Transformer(cfg, params, mesh=mesh)    this rank's blocks of those weights
  model.forward(batch)                   (loss, aux): training/eval loss
  model.apply_logits(batch)              (logits, aux): full-sequence logits
                                         (aux: the MoE router's totals)
  model.init_cache(batch, max_len, ...)  paged pools (R, P+1, page, Hkv, hd), or
                                         with paged=False dense (R, B+1, max_len, Hkv, hd);
                                         recurrent state (R, B, ...)
  model.reset_state(caches, slots)       recurrent rows back to their initial values
  model.prefill(batch, caches)           one-shot prefill at positions 0..S-1 into
                                         the dense cache; last-position logits
  model.prefill_chunk(tokens, ...)       incremental prefill at per-row offsets
  model.decode_step(tokens, pos, ...)    one-token step, per-slot positions

On a mesh of ranks the serving entry points take a ``LogicalConstraints``
that says how the rank splits the step and holds its cache blocks
(``serve.serve.serve_constraints`` builds it, for the one-shot steps and
the scheduler's).
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import check_supported
from repro_torch.device import resolve_device
from repro_torch.layers import attention as A
from repro_torch.layers import ffn as FFN
from repro_torch.layers import recurrent as R
from repro_torch.layers.common import (
    NULL_CONSTRAINTS,
    LogicalConstraints,
    ParamSpec,
    init_params,
    param_pspecs,
    tree_leaves,
    tree_map,
    unflatten,
)
from repro_torch.layers.norms import rmsnorm, rmsnorm_params


# ---------------------------------------------------------------------------
# parameter declaration
# ---------------------------------------------------------------------------


def _slot_params(cfg, kind: str) -> dict:
    """The JAX package's slot tree for every block kind."""
    p: dict = {"norm_in": rmsnorm_params(cfg.d_model)}
    if kind in ("attn", "local_attn", "moe"):
        p["attn"] = A.attention_params(cfg)
        p["norm_mlp"] = rmsnorm_params(cfg.d_model)
        if kind == "moe":
            p["moe"] = FFN.moe_params(cfg)
        else:
            p["mlp"] = FFN.mlp_params(cfg)
    elif kind == "mamba2":
        p["mamba"] = R.mamba2_params(cfg)
    elif kind == "mlstm":
        p["mlstm"] = R.mlstm_params(cfg)
    elif kind == "slstm":
        p["slstm"] = R.slstm_params(cfg)
        p["norm_mlp"] = rmsnorm_params(cfg.d_model)
        p["mlp"] = FFN.mlp_params(cfg, d_ff=int(cfg.d_model * cfg.xlstm.slstm_ff_factor))
    else:
        raise ValueError(f"unknown block kind {kind}")
    return p


def _stack(tree, n: int):
    """Stack a slot's leaves over ``n`` repeats: a leading ``"layers"`` axis."""
    return tree_map(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.logical, s.init, s.scale,
                            s.dtype), tree
    )


def model_params(cfg) -> dict:
    """The ParamSpec tree of every arch (the parameter count reads it);
    ``Transformer`` refuses what the port cannot run."""
    d, v = cfg.d_model, cfg.vocab_padded
    params: dict = {}
    if cfg.frontend != "audio":  # the audio stub feeds frame embeddings directly
        params["embed"] = ParamSpec((v, d), ("vocab", "embed"), scale=0.02)
    params["slots"] = {
        f"slot{i}_{kind}": _stack(_slot_params(cfg, kind), cfg.repeats)
        for i, kind in enumerate(cfg.pattern)
    }
    params["norm_f"] = rmsnorm_params(d)
    if not cfg.tie_embeddings or cfg.encoder_only:
        params["head"] = ParamSpec((d, v), ("embed", "vocab"), scale=1.0 / math.sqrt(d))
    return params


def init_cache(cfg, batch: int, max_len: int, *, paged: bool = True, page_size: int = 16,
               num_pages: int | None = None, dtype=None, device=None, mesh=None) -> dict:
    """The serving caches of ``cfg`` (``Transformer.init_cache``), stacked
    over repeats. With ``mesh`` over a process group, each leaf is this
    rank's block under ``distributed.sharding.cache_pspec_tree`` (a dense leaf's
    block ends with its own spare row; ``distributed.shard.cache_block_shape``).
    On ``device="meta"`` nothing is allocated."""
    dtype = dtype or cfg.compute_dtype
    if paged:
        if num_pages is None:
            num_pages = -(-batch * max_len // page_size)
        names = ("k_pages", "v_pages")
        shape = (cfg.repeats, num_pages + 1, page_size, cfg.n_kv_heads, cfg.head_dim_)
    else:
        names = ("k", "v")
        shape = (cfg.repeats, batch + 1, max_len, cfg.n_kv_heads, cfg.head_dim_)
    rows_of = {"mamba2": R.mamba2_cache, "mlstm": R.mlstm_cache, "slstm": R.slstm_cache}
    meta: dict = {}
    for i, kind in enumerate(cfg.pattern):
        if kind in R.CACHE_KEYS:
            rows = rows_of[kind](cfg, batch, dtype, "meta")
            meta[f"slot{i}_{kind}"] = {R.CACHE_KEYS[kind]: {
                k: torch.empty((cfg.repeats,) + tuple(v.shape), dtype=v.dtype, device="meta")
                for k, v in rows.items()}}
        else:
            meta[f"slot{i}_{kind}"] = {"attn": {
                n: torch.empty(shape, dtype=dtype, device="meta") for n in names}}
    specs = None
    if mesh is not None and mesh.distributed:
        from repro_torch.distributed.sharding import cache_pspec_tree

        specs = dict(tree_leaves(cache_pspec_tree(cfg, mesh, meta)))
    out = {}
    for path, t in tree_leaves(meta):
        dims = tuple(t.shape)
        if specs is not None:
            from repro_torch.distributed.shard import cache_block_shape

            dims = cache_block_shape(dims, specs[path], mesh, spare=path.endswith(("/k", "/v")))
        fill = R.M_INIT if path.endswith("/m") else 0.0
        out[path] = torch.full(dims, fill, dtype=t.dtype, device=device)
    return unflatten(out)


def _attr_name(path: str) -> str:
    return path.replace("/", "__")


# remat="dots": the outputs of the products without batch dims (``x @ W``
# dispatches to aten.mm, or aten.addmm with a bias) are kept; everything
# else in the layer, the batched einsums of the recurrent blocks and the
# kernels included, is recomputed in the backward, as
# ``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims`` does
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


class Transformer(nn.Module):
    """Decoder (with ``cfg.encoder_only``, encoder) transformer. Weights
    are ``nn.Parameter``s named after their path in the JAX parameter tree
    (``slots/slot0_attn/attn/wq`` -> ``slots__slot0_attn__attn__wq``),
    stacked over repeats as in JAX, so autograd has one leaf per tree
    leaf. A tensor handed in on the target
    device is used as it is, not copied.

    With ``mesh`` (``launch.mesh.Mesh``) each parameter is this rank's
    block of the full leaf under the arch's sharding rules (``shardings``:
    path -> ``NamedSharding``; ``params`` still gives the full leaves, on
    any device, and only the blocks reach ``device``). On a mesh over a
    process group each leaf is gathered just before its use: a stacked
    leaf one layer at a time inside ``_run_stack`` (under remat inside the
    checkpointed layer, so the backward gathers it again, and recomputes
    the layer's collectives, and a rank holds one layer's weights at a
    time), the embedding, final norm and head around theirs; the backward
    returns each rank its block of the gradient
    (``distributed.shard.gather``). Under tensor parallelism
    (``LogicalConstraints.tp``) a leaf that the rank's share computes with
    keeps its ``"model"`` block (``_gather``, ``_tp_split``), and the
    residual stream is the rank's part of the sequence; under context
    parallelism (``LogicalConstraints.cp``) every leaf is whole and the
    residual stream is the rank's part of the sequence. The kernels see
    plain contiguous tensors."""

    def __init__(self, cfg, params: dict, device=None, mesh=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.mesh = mesh
        dev = resolve_device(device)
        expected = {p: s.shape for p, s in tree_leaves(model_params(cfg))}
        got = dict(tree_leaves(params))
        if set(got) != set(expected):
            raise ValueError(
                f"parameter tree mismatch: missing {sorted(set(expected) - set(got))}, "
                f"unexpected {sorted(set(got) - set(expected))}"
            )
        self._paths = sorted(expected)
        self.shardings: dict = {}
        if mesh is not None:
            if not mesh.distributed and mesh.devices.size > 1:
                raise ValueError(f"a {mesh.devices.shape} mesh without a process group "
                                 f"has no ranks to hold the weights' blocks")
            from repro_torch.distributed.shard import NamedSharding
            from repro_torch.distributed.sharding import param_rules

            specs = dict(tree_leaves(param_pspecs(model_params(cfg), param_rules(cfg, mesh),
                                                  mesh)))
            self.shardings = {p: NamedSharding(mesh, specs[p]) for p in self._paths}
        for path in self._paths:
            t = got[path]
            if tuple(t.shape) != tuple(expected[path]):
                raise ValueError(f"{path}: shape {tuple(t.shape)} != {expected[path]}")
            t = t.detach()
            if mesh is not None:  # the block alone, in storage of its own
                t = self.shardings[path].local(t).to(dev, copy=True).contiguous()
            self.register_parameter(_attr_name(path), nn.Parameter(t.to(dev)))
        # a stacked leaf's placement per layer: its spec without "layers"
        per_slot: dict = {}
        for p, sh in self.shardings.items():
            if p.startswith("slots/"):
                _, name, sub = p.split("/", 2)
                per_slot.setdefault(name, {})[sub] = NamedSharding(mesh, sh.spec[1:])
        self._layer_shardings = {name: unflatten(d) for name, d in per_slot.items()}

    @property
    def gathers(self) -> bool:
        """Whether the leaves are blocks that a use must gather (a mesh over
        a process group)."""
        return self.mesh is not None and self.mesh.distributed

    def _leaf(self, path: str, lc: LogicalConstraints = NULL_CONSTRAINTS,
              split: bool = False) -> torch.Tensor:
        """The leaf at ``path`` as a layer computes with it: the parameter,
        or on a mesh of ranks its gather (``_gather``)."""
        t = getattr(self, _attr_name(path))
        if not self.gathers:
            return t
        return self._gather(t, self.shardings[path], lc, split)

    @staticmethod
    def _gather(t, sh, lc: LogicalConstraints, split: bool) -> torch.Tensor:
        """A block assembled for its use. With ``lc.tp``, a ``split`` leaf
        that the mesh stores split over ``"model"`` keeps its ``"model"``
        block, assembled over the other axes; any other leaf is the full
        leaf. The gradient is summed over ``lc.sum_axes``: the ranks with
        other rows, and the ``"model"`` peers where the sequence is split
        (``lc.tp`` or ``lc.cp``) and the leaf is whole
        (``distributed.shard``)."""
        from repro_torch.distributed.shard import gather

        if lc.tp is not None and split and "model" in sh.axes:
            return gather(t, sh.without("model"), lc.sum_axes(split=True))
        return gather(t, sh, lc.sum_axes())

    @classmethod
    def from_init(cls, cfg, seed: int = 0, device=None,
                  draw_device: str = "cpu", mesh=None) -> "Transformer":
        """Seeded weights from the port's initializer, stored in the
        config's param dtype. Drawn on the CPU by default (the same weights
        on every device); ``draw_device="cuda"`` draws them on the card
        with a CUDA generator (other numbers, no host round trip). With
        ``mesh`` every rank draws the full leaves on the draw device and
        keeps its blocks."""
        check_supported(cfg)  # before the draw
        dev = resolve_device(device)
        gen = torch.Generator(device=draw_device).manual_seed(seed)
        params = init_params(model_params(cfg), gen, cfg.param_dtype,
                             dev if mesh is None else None)
        return cls(cfg, params, dev, mesh)

    @property
    def device(self) -> torch.device:
        return self.norm_f__scale.device

    def _no_cache(self, what: str) -> None:
        if self.cfg.encoder_only:
            raise NotImplementedError(
                f"{self.cfg.name} is encoder-only: bidirectional attention has no KV "
                f"cache, so there is no {what} (use forward or apply_logits)")

    def named_params(self) -> dict[str, nn.Parameter]:
        """``{path: parameter}`` in sorted path order (the JAX leaf order)."""
        return {p: getattr(self, _attr_name(p)) for p in self._paths}

    def params(self) -> dict:
        return unflatten(self.named_params())

    # -- caches ---------------------------------------------------------

    def init_cache(self, batch: int, max_len: int, *, paged: bool = True,
                   page_size: int = 16, num_pages: int | None = None,
                   dtype=None) -> dict:
        """KV caches per attention slot. Paged (the default): pools ``(R,
        P+1, page, Hkv, hd)``, P pages for the allocator plus the spare that
        takes dropped writes; ``num_pages`` defaults to dense-equivalent
        capacity, ``ceil(batch*max_len/page_size)``. ``paged=False``: dense
        ``(R, batch+1, max_len, Hkv, hd)``, a row a slot plus the spare row
        (see ``layers.attention``). Recurrent state, in both layouts, one
        row a slot: ``(R, batch, ...)`` at its initial values (conv state in
        ``dtype``, the rest in fp32; xLSTM's ``m`` at -1e30). On a mesh of
        ranks, this rank's blocks (``init_cache``)."""
        self._no_cache("init_cache")
        return init_cache(self.cfg, batch, max_len, paged=paged, page_size=page_size,
                          num_pages=num_pages, dtype=dtype, device=self.device,
                          mesh=self.mesh)

    def reset_state(self, caches: dict, slots) -> None:
        """Restore the recurrent rows of ``slots`` to their initial values,
        in place (attention caches untouched). Unlike attention K/V, whose
        stale lines are never read, recurrent state carries: a reused slot
        would otherwise continue from its last request's state."""
        idx = None
        for i, kind in enumerate(self.cfg.pattern):
            if kind not in R.CACHE_KEYS:
                continue
            if idx is None:
                idx = torch.as_tensor(list(slots), dtype=torch.long).to(
                    self.device, non_blocking=True)
            rows = caches[f"slot{i}_{kind}"][R.CACHE_KEYS[kind]]
            for name, leaf in rows.items():
                leaf.index_fill_(1, idx, R.M_INIT if name == "m" else 0.0)

    # -- pieces ---------------------------------------------------------

    def _embed_inputs(self, tokens, frontend=None,
                      lc: LogicalConstraints = NULL_CONSTRAINTS) -> torch.Tensor:
        """Stub frontend embeddings (B,P,d) first, then the tokens' (B,S)
        embeddings, concatenated along the sequence; ``embed_scale`` after
        the concatenation, as in the JAX package. With ``lc.tp``, this
        rank's sequence part of it (``_embed_split``); with ``lc.cp``, the
        rank's part of the whole lookup."""
        cfg = self.cfg
        if lc.tp is not None:
            x = self._embed_split(tokens, frontend, lc)
        else:
            parts = []
            if frontend is not None:
                parts.append(frontend.to(self.device, cfg.compute_dtype, non_blocking=True))
            if tokens is not None:
                tokens = tokens.to(self.device, non_blocking=True)
                parts.append(self._leaf("embed", lc)[tokens.long()].to(cfg.compute_dtype))
            x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
            if lc.cp is not None:  # the kernels take contiguous rows
                x = lc.cp.local(x).contiguous()
        if cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.compute_dtype)
        return x

    def _embed_split(self, tokens, frontend, lc: LogicalConstraints) -> torch.Tensor:
        """The vocab-parallel lookup onto the sequence-sharded residual: each
        rank looks every token up in its vocabulary rows (0 for a token
        outside them), and a reduce-scatter along the sequence sums the
        ranks' rows onto each rank's part. Frontend rows enter the sum from
        the first rank alone; a model without tokens (hubert's frames)
        takes its part of them as they are. Returns (B, S/n, d)."""
        cfg, tp = self.cfg, lc.tp
        fe = None
        if frontend is not None:
            fe = frontend.to(self.device, cfg.compute_dtype, non_blocking=True)
        if tokens is None:
            return tp.local(fe).contiguous()
        emb = self._leaf("embed", lc, split=True)          # (V/n, d)
        local = tokens.to(self.device, non_blocking=True).long() - tp.part(cfg.vocab_padded).start
        inside = (local >= 0) & (local < emb.shape[0])
        rows = emb[local.clamp(0, emb.shape[0] - 1)].to(cfg.compute_dtype)
        x = torch.where(inside[..., None], rows, rows.new_zeros(()))
        if fe is not None:
            x = torch.cat([fe if tp.index == 0 else torch.zeros_like(fe), x], dim=1)
        return tp.seq_scatter(x)

    def _head(self, lc: LogicalConstraints = NULL_CONSTRAINTS) -> torch.Tensor:
        """(d, V): the head, or the tied embedding's transpose; with
        ``lc.tp`` this rank's vocabulary columns (d, V/n)."""
        split = lc.tp is not None
        if self.cfg.tie_embeddings:
            return self._leaf("embed", lc, split).T
        return self._leaf("head", lc, split)

    def _logits(self, x: torch.Tensor, head: torch.Tensor | None = None) -> torch.Tensor:
        cfg = self.cfg
        head = self._head() if head is None else head
        logits = x @ head.to(cfg.compute_dtype)
        if cfg.final_softcap:
            logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
        return logits

    def _final_norm(self, x, lc: LogicalConstraints = NULL_CONSTRAINTS):
        cfg = self.cfg
        return rmsnorm(x, self._leaf("norm_f/scale", lc), cfg.norm_eps, cfg.zero_centered_norm)

    def _apply_slot(self, sp: dict, x, *, kind, positions, cache, cache_len, seq_mask,
                    block_tables, cache_row0=0, commit_state=True, cache_attend=True,
                    lc: LogicalConstraints = NULL_CONSTRAINTS, pool_rows=None):
        """One block: pre-norm attention (over the last ``cfg.window`` keys
        for ``local_attn``; bidirectional for an encoder-only model) +
        pre-norm MLP (the MoE FFN for ``moe``), or a pre-norm recurrent
        block (``slstm`` with its own pre-norm MLP), residuals. Returns (x,
        aux): the MoE block's aux, else {}. Every position is routed,
        padding included, as in the JAX block. A recurrent block reads and
        writes the state rows ``cache_row0 .. cache_row0+B-1`` in place
        (with ``commit_state`` False it reads them and writes nothing).

        With ``lc.tp`` or ``lc.cp``, ``x`` is this rank's sequence part:
        the norms and (under ``cp``) the MLP run on it, and the other layers
        compute the rank's share and return its part (``layers``). Under
        ``tp`` a mamba2 block whose SSM heads divide the model axis runs
        the rank's heads (``R.mamba2_splits``); any other recurrent block
        runs on the all-gathered rows and keeps its part. With ``lc.kv``
        the caches are the rank's blocks (``layers.attention``,
        ``R.mamba2_block``); ``pool_rows`` goes to the attention's paged
        write (``layers.attention``)."""
        cfg, tp, seq = self.cfg, lc.tp, lc.seq
        if kind in R.CACHE_KEYS:
            if kind == "mamba2" and R.mamba2_splits(cfg, tp):
                h = rmsnorm(x, sp["norm_in"]["scale"], cfg.norm_eps, cfg.zero_centered_norm)
                rows = None
                if cache is not None:
                    rows = {k: v[cache_row0:cache_row0 + h.shape[0]]
                            for k, v in cache["mamba"].items()}
                o, new = R.mamba2_block(sp["mamba"], h, cfg, cache=rows, seq_mask=seq_mask, tp=tp)
                if new is not None and commit_state:
                    for k, v in new.items():
                        rows[k].copy_(v)
                return x + o, {}
            if seq is not None:  # the rank's part, contiguous for the kernels
                return seq.local(self._recurrent_slot(sp, seq.seq_gather(x), kind, cache,
                                                      seq_mask, cache_row0, commit_state,
                                                      tp)).contiguous(), {}
            return self._recurrent_slot(sp, x, kind, cache, seq_mask, cache_row0,
                                        commit_state, tp), {}
        h = rmsnorm(x, sp["norm_in"]["scale"], cfg.norm_eps, cfg.zero_centered_norm)
        x = x + A.attention_block(
            sp["attn"], h, cfg, positions=positions,
            cache=None if cache is None else cache["attn"],
            cache_len=cache_len, block_tables=block_tables, seq_mask=seq_mask,
            causal=not cfg.encoder_only,
            window=cfg.window if kind == "local_attn" else None, cache_row0=cache_row0,
            tp=tp if tp is not None else lc.attn_tp, cp=lc.cp, kv=lc.kv,
            cache_attend=cache_attend, whole=tp is None, pool_rows=pool_rows,
        )
        h2 = rmsnorm(x, sp["norm_mlp"]["scale"], cfg.norm_eps, cfg.zero_centered_norm)
        if kind == "moe":
            o, aux = FFN.moe_block(sp["moe"], h2, cfg, lc)
            return x + o, aux
        return x + FFN.mlp_block(sp["mlp"], h2, cfg, tp), {}

    def _recurrent_slot(self, sp: dict, x, kind, cache, seq_mask, cache_row0,
                        commit_state, tp=None):
        """A recurrent block run whole on ``x``'s rows. Under ``tp`` with a
        cache, mamba2's conv state is the rank's block of its channels: the
        blocks are all-gathered for the block and the rank's cut back."""
        cfg = self.cfg
        h = rmsnorm(x, sp["norm_in"]["scale"], cfg.norm_eps, cfg.zero_centered_norm)
        key = R.CACHE_KEYS[kind]
        rows = state = None
        if cache is not None:
            B = x.shape[0]
            rows = state = {k: v[cache_row0:cache_row0 + B] for k, v in cache[key].items()}
            if tp is not None and kind == "mamba2":
                state = dict(rows, conv=tp.channel_gather(rows["conv"]))
        block = {"mamba2": R.mamba2_block, "mlstm": R.mlstm_block,
                 "slstm": R.slstm_block}[kind]
        o, new = block(sp[key], h, cfg, cache=state, seq_mask=seq_mask)
        if new is not None and commit_state:
            if tp is not None and kind == "mamba2":
                new = dict(new, conv=new["conv"][..., tp.part(new["conv"].shape[-1])])
            for k, v in new.items():
                rows[k].copy_(v)
        x = x + o
        if kind == "slstm":
            h2 = rmsnorm(x, sp["norm_mlp"]["scale"], cfg.norm_eps, cfg.zero_centered_norm)
            x = x + FFN.mlp_block(sp["mlp"], h2, cfg)
        return x

    def _gathered_slot(self, name: str, layer: dict, x, lc, **kw):
        """``_apply_slot`` on a layer's blocks assembled for their use: with
        ``lc.tp`` the leaves that the rank's share computes with keep their
        ``"model"`` block (``_tp_split``), the rest are whole."""
        kind = name.split("_", 1)[1]
        flat = dict(tree_leaves(self._layer_shardings[name]))
        full = unflatten({sub: self._gather(t, flat[sub], lc, self._tp_split(kind, sub, lc))
                          for sub, t in tree_leaves(layer)})
        return self._apply_slot(full, x, lc=lc, **kw)

    def _tp_split(self, kind: str, sub: str, lc) -> bool:
        """Whether a layer's leaf enters the tensor-parallel compute as this
        rank's ``"model"`` block: attention's q and o (and kv when the kv
        heads divide the model axis), the MLPs, the experts, and a split
        mamba2's per-head and ``d_inner`` leaves (its ``in_proj`` and conv
        are whole: their B/C columns serve every head); never in another
        recurrent block, which this split leaves whole."""
        tp = lc.tp
        if tp is None:
            return False
        leaf = sub.rsplit("/", 1)[1]
        if kind == "mamba2":
            return (R.mamba2_splits(self.cfg, tp) and sub.startswith("mamba/")
                    and leaf in R.MAMBA2_SPLIT_LEAVES)
        if kind in R.CACHE_KEYS:
            return False
        if sub.startswith("attn/"):
            if leaf in ("wk", "wv", "bk", "bv"):
                return self.cfg.n_kv_heads % tp.size == 0
            return leaf in ("wq", "wo", "bq")
        return sub.startswith(("mlp/", "moe/shared/")) or sub in (
            "moe/wi_gate", "moe/wi_up", "moe/wo")

    def _run_stack(self, x, caches, *, positions, cache_len, seq_mask,
                   block_tables, cache_row0=0, commit_state=True, cache_attend=True,
                   lc: LogicalConstraints = NULL_CONSTRAINTS, pool_rows=None):
        """Pattern x repeats. Each stacked leaf is unbound over repeats once
        (views; the backward stacks the per-layer gradients in one op
        rather than scattering into the stacked leaf once per layer). With
        ``caches`` None and ``cfg.remat`` ``"full"`` or ``"dots"``, every
        layer runs under ``torch.utils.checkpoint`` (non-reentrant) while
        autograd records, as ``jax.checkpoint`` wraps the scanned layer
        body: ``"full"`` keeps only the layer's inputs, ``"dots"`` also the
        outputs of its products without batch dims (``_dots_policy``).
        Returns (x, aux): each aux entry summed over layers
        (``expert_load`` stays per expert), as the JAX ``_run_stack``
        reduces the scan's. On a mesh of ranks each layer's blocks are
        gathered inside the (checkpointed) layer (``_gathered_slot``), and
        under tensor parallelism its sequence collectives run there too:
        the recompute reruns both, in the same order on every rank."""
        cfg = self.cfg
        if cfg.remat not in ("none", "full", "dots"):
            raise ValueError(f"remat={cfg.remat!r}: one of 'none', 'full', 'dots'")
        remat = caches is None and cfg.remat != "none" and torch.is_grad_enabled()
        ckpt_kw = {"context_fn": _dots_context} if cfg.remat == "dots" else {}
        slots = {name: tree_map(lambda t: t.unbind(0), sp)
                 for name, sp in self.params()["slots"].items()}
        totals: dict = {}
        for r in range(cfg.repeats):
            for name, sp in slots.items():
                layer = tree_map(lambda t: t[r], sp)
                cache = None if caches is None else tree_map(lambda t: t[r], caches[name])
                kw = dict(kind=name.split("_", 1)[1], positions=positions, cache=cache,
                          cache_len=cache_len,
                          seq_mask=seq_mask, block_tables=block_tables,
                          cache_row0=cache_row0, commit_state=commit_state,
                          cache_attend=cache_attend, lc=lc, pool_rows=pool_rows)
                fn = self._apply_slot
                if self.gathers:
                    fn = functools.partial(self._gathered_slot, name)
                if remat:
                    x, aux = checkpoint(fn, layer, x, use_reentrant=False, **ckpt_kw, **kw)
                else:
                    x, aux = fn(layer, x, **kw)
                for k, v in aux.items():
                    totals[k] = v if k not in totals else totals[k] + v
        return x, totals

    def _per_row(self, x, B: int) -> torch.Tensor:
        """() or (B,) ints -> (B,) int32 on the model's device. Host values
        go up with ``non_blocking``: a blocking upload would wait for the
        whole queue of in-flight work on the stream."""
        t = x if isinstance(x, torch.Tensor) else torch.tensor(x, dtype=torch.int32)
        return t.to(self.device, torch.int32, non_blocking=True).reshape(-1).expand(B)

    def _chunk_loss(self, xi, li, z_coef: float, head, wi=None, tp=None):
        logits = self._logits(xi, head)
        logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
        w = (li >= 0).to(logits.dtype) if wi is None else wi.to(logits.dtype)
        if tp is None:
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, li.clamp(min=0).long()[..., None])[..., 0]
        else:
            lse, gold = self._split_lse_gold(logits, li, tp)
        nll = (lse - gold) * w
        zl = z_coef * lse**2 * w if z_coef else 0.0
        return torch.sum(nll + zl), torch.sum(w)

    def _split_lse_gold(self, logits, li, tp):
        """The log-sum-exp and the gold logit over the whole vocabulary from
        this rank's columns ``logits`` (..., V/n): the maximum and the sum
        of exponentials all-reduced over ``"model"``, the gold logit from
        the rank whose rows hold the label (the others add 0)."""
        m = tp.max_(logits.detach().amax(dim=-1))
        lse = torch.log(tp.all_reduce(torch.sum(torch.exp(logits - m[..., None]), dim=-1))) + m
        n = logits.shape[-1]
        local = li.long() - tp.index * n
        inside = (local >= 0) & (local < n)
        g = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
        return lse, tp.all_reduce(torch.where(inside, g, g.new_zeros(())))

    def cross_entropy(self, x, labels, *, seq_chunk: int = 512,
                      z_loss: float | None = None, head: torch.Tensor | None = None,
                      tp=None):
        """Chunked CE over the sequence: never materializes (B,S,V) logits.
        labels: (B,S) int; negative labels are masked out; the log-sum-exp
        runs over the padded vocabulary, with the z-loss ``z_loss *
        lse**2``. Each chunk is checkpointed (its logits are recomputed in
        the backward), as the JAX scan's ``jax.checkpoint`` does. Returns
        (loss_sum, weight_sum) in fp32 (float64 for a float64 model).
        ``head`` (d, V) defaults to ``_head()``.

        With ``tp`` (vocab-parallel, ``distributed.shard.TensorParallel``),
        ``x`` is this rank's sequence part (B,S/n,d) and ``head`` its
        vocabulary columns (d,V/n): ``x`` is all-gathered along the
        sequence, every rank computes its columns' logits of every row,
        the log-sum-exp and the gold logit are summed over the ranks
        (``_split_lse_gold``), and each rank counts the rows of its own
        sequence part, so the ranks' sums add up to the whole CE."""
        own = None
        if tp is not None:
            x = tp.seq_gather(x)
            own = torch.zeros(labels.shape, dtype=torch.bool, device=labels.device)
            own[:, tp.part(labels.shape[1])] = True
            own = own & (labels >= 0)
        B, S, _ = x.shape
        head = self._head() if head is None else head
        z_coef = self.cfg.z_loss if z_loss is None else z_loss
        c = min(seq_chunk, S)
        n = -(-S // c)
        if n * c > S:
            x = nn.functional.pad(x, (0, 0, 0, n * c - S))
            labels = nn.functional.pad(labels, (0, n * c - S), value=-1)
            if own is not None:
                own = nn.functional.pad(own, (0, n * c - S), value=False)
        acc = torch.promote_types(x.dtype, torch.float32)
        loss_sum = torch.zeros((), dtype=acc, device=x.device)
        w_sum = torch.zeros((), dtype=acc, device=x.device)
        for i in range(n):
            cut = slice(i * c, (i + 1) * c)
            xi, li = x[:, cut], labels[:, cut]
            wi = None if own is None else own[:, cut]
            if torch.is_grad_enabled():
                ls, ws = checkpoint(self._chunk_loss, xi, li, z_coef, head, wi, tp,
                                    use_reentrant=False)
            else:
                ls, ws = self._chunk_loss(xi, li, z_coef, head, wi, tp)
            loss_sum, w_sum = loss_sum + ls, w_sum + ws
        return loss_sum, w_sum

    def _full_sequence(self, batch: dict, lc: LogicalConstraints = NULL_CONSTRAINTS):
        """Embed, run the stack cache-less at positions 0..S-1, final norm.
        Returns (x, aux); with ``lc.tp`` or ``lc.cp`` x is this rank's
        sequence part (the positions stay the whole sequence's: each layer
        takes its part of them)."""
        x = self._embed_inputs(batch.get("tokens"), batch.get("frontend"), lc)
        B, S, _ = x.shape
        if lc.seq is not None:
            S *= lc.seq.size
        positions = torch.arange(S, dtype=torch.int32, device=self.device)[None].expand(B, S)
        x, aux = self._run_stack(x, None, positions=positions, cache_len=None,
                                 seq_mask=None, block_tables=None, lc=lc)
        return self._final_norm(x, lc), aux

    # -- entry points -----------------------------------------------------

    def forward(self, batch: dict, lc: LogicalConstraints = NULL_CONSTRAINTS,
                tokens: torch.Tensor | None = None):
        """Training/eval forward: ``batch`` {"tokens": (B,S), "labels": (B,S)},
        with stub embeddings ``"frontend"`` (B,P,d) ahead of the tokens, or
        in their place (labels then cover P + S positions; moved to the
        model's device). Returns (loss, aux): the mean CE plus z-loss over
        labelled tokens, plus for an MoE model ``moe_lb_coef`` and
        ``moe_z_coef`` times the router's losses averaged over layers; aux
        {"tokens": their count} and the router's totals (``expert_load``,
        ``moe_lb_loss``, ``moe_z_loss``).

        On a mesh of ranks ``batch`` holds this rank's rows (``lc.ranks``)
        and ``tokens`` the global batch's labelled-token count: the CE sum
        is divided by it, and the router terms are this rank's parts
        (``layers.ffn.moe_block``), so the ranks' losses add up to the
        global batch's loss and their gradients to its gradient. With
        ``lc.tp`` or ``lc.cp`` the CE sum is the rank's sequence part's
        (under ``cp`` its labels' part against the whole head), and the
        router terms, which every ``"model"`` rank computes alike, enter
        each rank's loss divided by the model axis, so they count once."""
        cfg, tp, seq = self.cfg, lc.tp, lc.seq
        x, aux = self._full_sequence(batch, lc)
        labels = batch["labels"].to(self.device, non_blocking=True)
        if lc.cp is not None:
            labels = lc.cp.local(labels)
        loss_sum, w_sum = self.cross_entropy(x, labels, head=self._head(lc), tp=tp)
        loss = loss_sum / torch.clamp(w_sum if tokens is None else tokens, min=1.0)
        if "moe_lb_loss" in aux:
            share = cfg.n_layers * (1 if seq is None else seq.size)
            loss = loss + cfg.moe_lb_coef * aux["moe_lb_loss"] / share
            loss = loss + cfg.moe_z_coef * aux["moe_z_loss"] / share
        aux["tokens"] = w_sum
        return loss, aux

    def apply_logits(self, batch: dict, lc: LogicalConstraints = NULL_CONSTRAINTS):
        """Full-sequence logits (B,S,V) (small-model/eval path; materializes
        them). Returns (logits, aux). With ``lc.tp`` or ``lc.cp`` the rank's
        sequence part is all-gathered before the head; under ``lc.tp`` the
        logits are the rank's vocabulary columns (B,S,V/n)."""
        x, aux = self._full_sequence(batch, lc)
        if lc.seq is not None:
            x = lc.seq.seq_gather(x)
        return self._logits(x, self._head(lc)), aux

    def _last_row(self, x, lc: LogicalConstraints) -> torch.Tensor:
        """(B,1,d): the last position's row; with the sequence split over
        ``"model"``, the last rank's, all-gathered."""
        x = x[:, -1:].contiguous()
        return x if lc.seq is None else lc.seq.seq_gather(x)[:, -1:].contiguous()

    @torch.inference_mode()
    def prefill(self, batch: dict, caches: dict, lc: LogicalConstraints = NULL_CONSTRAINTS):
        """One-shot prefill (JAX ``prefill``): ``batch`` {"tokens": (B,S)},
        with stub embeddings ``"frontend"`` (B,P,d) ahead of the tokens as
        ``_full_sequence`` embeds them, at positions ``0..S-1`` of every
        row into the dense cache (``init_cache(..., paged=False)``), rows
        ``0..B-1``. Attention runs over the prompt itself (the flash kernel,
        causal, with the arch's window and softcap) and copies its K/V into
        the cache; the recurrent blocks run their chunked forms from the
        cache's state and leave their final state there. Returns the logits
        (B,V) at the last position.

        On a mesh, ``lc`` (``serve.serve.make_prefill_step``): ``batch`` is
        the rank's rows and ``caches`` its blocks; under ``lc.tp`` or
        ``lc.cp`` the rank runs its part of the sequence, and under
        ``lc.tp`` the logits are its vocabulary columns (B,V/n)."""
        self._no_cache("prefill")
        if any(p.endswith("/k_pages") for p, _ in tree_leaves(caches)):
            raise ValueError("prefill writes the dense layout (init_cache(paged=False))")
        x = self._embed_inputs(batch.get("tokens"), batch.get("frontend"), lc)
        B, S, _ = x.shape
        if lc.seq is not None:
            S *= lc.seq.size
        positions = torch.arange(S, dtype=torch.int32, device=self.device)[None].expand(B, S)
        cache_len = torch.full((B,), S, dtype=torch.int32, device=self.device)
        x, _ = self._run_stack(x, caches, positions=positions, cache_len=cache_len,
                               seq_mask=None, block_tables=None, cache_attend=False, lc=lc)
        x = self._final_norm(self._last_row(x, lc), lc)
        return self._logits(x, self._head(lc))[:, 0]

    @staticmethod
    def _pool_rows(positions, seq_mask, block_tables, lc: LogicalConstraints):
        """(the paged write's ``PoolRows`` or None, the tables the rank
        reads): where ``lc.ranks`` splits the rows over the batch axes,
        ``block_tables`` are the global batch's; the rank reads its rows'
        and writes every rank's (``distributed.shard.PoolRows``)."""
        rk = lc.ranks
        if block_tables is None or rk is None or rk.group is None:
            return None, block_tables
        from repro_torch.distributed.shard import PoolRows

        return (PoolRows(rk, positions, seq_mask, block_tables),
                block_tables[rk.rows(block_tables.shape[0])])

    @torch.inference_mode()
    def prefill_chunk(self, tokens, caches, start, length, block_tables=None,
                      all_logits: bool = False, slot: int = 0,
                      commit_state: bool = True,
                      lc: LogicalConstraints = NULL_CONSTRAINTS):
        """One chunk of an incremental prefill: ``tokens`` (B,C) at positions
        ``start .. start+C``; ``length`` () or (B,) valid tokens (the rest is
        padding that writes nothing and advances no state). Writes the
        caches in place and attends against everything written so far:
        through ``block_tables`` (B,nL) on the paged layout, or, on the
        dense layout (``block_tables`` None), in cache rows ``slot ..
        slot+B-1``; recurrent state lives in rows ``slot .. slot+B-1`` in
        both layouts. ``commit_state=False`` reads the recurrent state and
        leaves it as it was (the speculative verify's scoring pass; the
        attention writes still land). Returns logits (B,V) at each row's
        last valid position, or (B,C,V) with ``all_logits``.

        On a mesh, ``lc`` (``serve.serve.serve_constraints``, mode
        ``"chunk"``; paged layout): ``tokens``, ``start`` and ``length`` are
        the rank's rows, ``block_tables`` the global batch's where the rows
        split (``_pool_rows``), and ``caches`` its blocks; under
        ``TensorParallel`` each rank runs its part of the chunk's sequence,
        under ``RowParallel`` the whole of it, and the logits are the
        rank's vocabulary columns (...,V/n)."""
        self._no_cache("prefill_chunk")
        B, C = tokens.shape
        x = self._embed_inputs(tokens, lc=lc)
        start = self._per_row(start, B)
        length = self._per_row(length, B)
        offs = torch.arange(C, dtype=torch.int32, device=self.device)[None, :]
        seq_mask = offs < length[:, None]
        positions = start[:, None] + offs
        pool_rows, block_tables = self._pool_rows(positions, seq_mask, block_tables, lc)
        x, _ = self._run_stack(x, caches, positions=positions, cache_len=start + length,
                               seq_mask=seq_mask, block_tables=block_tables,
                               cache_row0=slot, commit_state=commit_state, lc=lc,
                               pool_rows=pool_rows)
        x = self._final_norm(x, lc)
        if lc.seq is not None:
            x = lc.seq.seq_gather(x)
        head = self._head(lc)
        if all_logits:
            return self._logits(x, head)
        idx = (length - 1).clamp(min=0).long()[:, None, None].expand(B, 1, x.shape[-1])
        return self._logits(torch.gather(x, 1, idx), head)[:, 0]

    @torch.inference_mode()
    def decode_step(self, tokens, pos, caches, active=None, block_tables=None,
                    lc: LogicalConstraints = NULL_CONSTRAINTS):
        """One decode step. tokens: (B,1); pos: () or (B,) per-slot positions;
        ``active`` (B,) bool: inactive slots write nothing. ``block_tables``
        (B,nL) on the paged layout, None on the dense one (cache rows
        0..B-1); recurrent state in rows 0..B-1. Returns (B,V). On a mesh,
        ``lc`` (``serve.serve.serve_constraints``): ``tokens``, ``pos`` and
        ``active`` are the rank's rows and ``caches`` its blocks, dense
        (``make_decode_step``) or paged (the scheduler; ``block_tables``
        then the global batch's where the rows split, ``_pool_rows``);
        under ``lc.tp`` (``RowParallel``) the logits are the rank's
        vocabulary columns (B,V/n)."""
        self._no_cache("decode_step")
        x = self._embed_inputs(tokens, lc=lc)
        B = x.shape[0]
        pos = self._per_row(pos, B)
        positions = pos.reshape(B, 1)
        seq_mask = None if active is None else active.to(
            self.device, non_blocking=True).reshape(B, 1)
        pool_rows, block_tables = self._pool_rows(positions, seq_mask, block_tables, lc)
        x, _ = self._run_stack(x, caches, positions=positions, cache_len=pos + 1,
                               seq_mask=seq_mask, block_tables=block_tables, lc=lc,
                               pool_rows=pool_rows)
        return self._logits(self._final_norm(x, lc), self._head(lc))[:, 0]
