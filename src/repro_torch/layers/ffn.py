"""Feed-forward layers (``repro.layers.ffn``): dense and Mixture-of-Experts.

Dense: SwiGLU, GeGLU and GELU, with GELU's tanh approximation as in the
JAX package.

MoE: the JAX package's sort-based capacity dispatch per token group (G =
``lc.group_count("batch", B)``: one group without a mesh, one a data
shard on a mesh): router top-k -> (token, expert) pairs sorted by expert
(stable) within the group -> a capacity buffer (E, C, d) a group, pairs
past an expert's C dropped (they fall through the residual) -> batched
expert products -> combine with the routing weights. On a mesh of ranks
(``lc.ranks``) a rank's rows are one group: the sort and the drops stay on
the rank, the per-expert counts are summed over the ranks with other rows,
and the router's losses are this rank's part of the global ones. Every position is routed,
padding included (the JAX block takes no mask). The router's per-expert
pair counts (``aux["expert_load"]``) feed the monitor's expert
load-balance factor.

Determinism on the card: no step sums through atomics in the forward.
The dispatch writes each buffer slot at most once; each token's K expert
outputs are gathered as (n, K, d) and summed in ascending expert order,
the order of the JAX scatter-add. The backward's gathers have distinct
indices except the spare row that dropped pairs use, which is discarded.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.layers.common import NULL_CONSTRAINTS, LogicalConstraints, ParamSpec


def mlp_params(cfg, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    wo = ParamSpec((f, d), ("mlp", "embed_out"),
                   scale=1.0 / (math.sqrt(f) * math.sqrt(2 * cfg.n_layers)))
    wi = ParamSpec((d, f), ("embed", "mlp"))
    if cfg.act in ("swiglu", "geglu"):
        return {"wi_gate": wi, "wi_up": wi, "wo": wo}
    return {"wi": wi, "wo": wo}


def moe_params(cfg) -> dict:
    """The JAX ``moe_params`` tree: router, experts stacked (E, d, f) /
    (E, f, d), and the shared experts' dense MLP."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff, m.n_experts
    p = {
        "router": ParamSpec((d, e), ("embed", None), scale=0.02),
        "wi_gate": ParamSpec((e, d, f), ("experts", "embed", "expert_mlp")),
        "wi_up": ParamSpec((e, d, f), ("experts", "embed", "expert_mlp")),
        "wo": ParamSpec((e, f, d), ("experts", "expert_mlp", "embed_out"),
                        scale=1.0 / (math.sqrt(f) * math.sqrt(2 * cfg.n_layers))),
    }
    if m.n_shared_experts:
        p["shared"] = mlp_params(cfg, d_ff=m.d_ff * m.n_shared_experts)
    return p


def _act(name: str):
    return {
        "swiglu": F.silu,
        "geglu": lambda x: F.gelu(x, approximate="tanh"),
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[name]


def mlp_block(params: dict, x: torch.Tensor, cfg, tp=None) -> torch.Tensor:
    """With ``tp`` (``distributed.shard.TensorParallel``), ``x`` is this
    rank's sequence part and ``params`` its ``"mlp"`` blocks: the input is
    all-gathered along the sequence, the rank computes its hidden columns
    (``wi``: column-parallel) and ``wo``'s rows (row-parallel), and the
    partial sums reduce-scatter onto its sequence part."""
    if tp is not None:
        x = tp.seq_gather(x)
    out = _mlp(params, x, cfg)
    return out if tp is None else tp.seq_scatter(out)


def _mlp(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    compute = cfg.compute_dtype
    act = _act(cfg.act)
    if "wi_gate" in params:
        g = x @ params["wi_gate"].to(compute)
        u = x @ params["wi_up"].to(compute)
        h = act(g) * u
    else:
        h = act(x @ params["wi"].to(compute))
    return h @ params["wo"].to(compute)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def router_topk(logits: torch.Tensor, k: int, normalize: bool):
    """logits: (N, E) fp32. Returns (weights (N, k), experts (N, k)), the
    experts in descending logit order with ties lowest index first, as
    ``jax.lax.top_k`` orders them (``torch.topk`` promises no order among
    ties): a stable descending sort, sliced. ``normalize``: softmax over the
    k chosen logits; else the full softmax's weights of the k chosen."""
    vals, experts = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, experts = vals[..., :k], experts[..., :k]
    if normalize:
        return torch.softmax(vals, dim=-1), experts
    return torch.gather(torch.softmax(logits, dim=-1), -1, experts), experts


def _dispatch_group(xt: torch.Tensor, logits: torch.Tensor, E: int, K: int, C: int,
                    normalize: bool, compute, mine: slice | None = None):
    """Dispatch one token group, as the JAX ``_dispatch_group``.

    xt: (n, d); logits: (n, E) fp32. Returns ``(xbuf (E, C, d), st, sw,
    keep, slot, expert_counts)`` with the JAX meanings, over the n*K pairs
    in expert-sorted order: each pair's token, routing weight, whether it
    fits its expert's capacity, its buffer slot (``expert*C + position``,
    ``expert*C`` when dropped), and the pairs per expert (dropped ones
    counted). The pairs are sorted by expert with a stable sort, so an
    expert's slots go to its tokens in token order and the last ones past
    C drop. With ``mine`` (a tensor-parallel rank's experts) the buffer holds
    those experts' slots alone, ``(len, C, d)``; everything else is the
    whole group's.
    """
    n, d = xt.shape
    weights, experts = router_topk(logits, K, normalize)           # (n, K)
    pair_expert = experts.reshape(-1)                              # token-major
    order = torch.argsort(pair_expert, stable=True)
    se, sw = pair_expert[order], weights.reshape(-1)[order]
    st = torch.div(order, K, rounding_mode="floor")
    # a scatter of ones, not ``bincount``, which reads its size back to the
    # host on CUDA
    expert_counts = torch.zeros(E, dtype=torch.int64, device=xt.device).scatter_add_(
        0, pair_expert, torch.ones_like(pair_expert))
    first_idx = torch.cumsum(expert_counts, 0) - expert_counts
    pos = torch.arange(n * K, device=xt.device) - first_idx[se]
    keep = pos < C
    slot = se * C + torch.where(keep, pos, 0)
    # the pairs' rows in sorted order, gathered through the (n, K) expansion
    # so that the backward sums a token's K rows without atomics; dropped
    # pairs (and pairs of experts outside ``mine``) write the spare row,
    # which is cut off
    src = xt.to(compute)[:, None, :].expand(n, K, d).reshape(n * K, d)[order]
    e = mine or slice(0, E)
    n_e = e.stop - e.start
    dest = _local_slots(slot, keep, e.start * C, n_e * C)
    xbuf = torch.zeros((n_e * C + 1, d), dtype=compute, device=xt.device).index_put(
        (dest,), src)
    return xbuf[:n_e * C].reshape(n_e, C, d), st, sw, keep, slot, expert_counts


def _local_slots(slot, keep, first: int, n: int) -> torch.Tensor:
    """Each pair's row in a buffer of the ``n`` slots from ``first``: the
    spare row ``n`` for a dropped pair or one outside them."""
    local = slot - first
    return torch.where(keep & (local >= 0) & (local < n), local, n)


def moe_block(params: dict, x: torch.Tensor, cfg,
              lc: LogicalConstraints = NULL_CONSTRAINTS):
    """x: (B, S, d). Returns (out (B, S, d), aux): ``expert_load`` (E,) fp32
    pair counts, ``moe_lb_loss`` (switch-style: E * sum(mean router prob *
    load share)) and ``moe_z_loss`` (mean squared log-sum-exp of the router
    logits).

    The tokens split into G = ``lc.group_count("batch", B)`` groups of
    rows, as JAX's grouped dispatch splits them; each group sorts, fills
    and drops on its own with capacity ``m.capacity(N / G)``. With
    ``lc.ranks`` set, ``x`` is this rank's rows, one group of
    ``lc.ranks.shards``: ``expert_load`` is summed over those ranks (the
    global counts), and the losses are this rank's parts (its router
    probabilities and squared log-sum-exps over the global token count,
    against the global load share), which sum over the ranks to JAX's.

    With ``lc.tp`` (``distributed.shard.TensorParallel``) ``x`` is this
    rank's sequence part and the experts' leaves its ``E/n`` experts'
    blocks. The part is all-gathered along the sequence, so every
    ``"model"`` rank routes its data shard's tokens as one group (the
    router, the drops, ``expert_load`` and the losses are the same on
    each, and ``Transformer.forward`` counts the losses once); each rank
    fills and multiplies the capacity buffers of its own experts, combines
    its experts' outputs (a pair of another rank's expert adds 0), and the
    partial sums reduce-scatter onto its sequence part, as the MLP's do.
    The shared experts' MLP splits as the dense MLP.

    With ``lc.cp`` (``distributed.shard.ContextParallel``) ``x`` is this
    rank's sequence part and the leaves are whole: the part is
    all-gathered along the sequence, the block runs on its data shard's
    tokens as one group, as JAX's dispatch groups them, and the rank keeps
    its part of the output."""
    tp, seq = lc.tp, lc.seq
    if seq is not None:
        x = seq.seq_gather(x)
    m = cfg.moe
    B, S, d = x.shape
    N = B * S
    E, K = m.n_experts, m.top_k
    compute = cfg.compute_dtype
    ranks = lc.ranks
    G = 1 if ranks is not None else lc.group_count("batch", B)
    n_loc = N // G
    C = m.capacity(n_loc)

    xt = x.reshape(N, d)
    logits = (xt @ params["router"].to(compute)).to(torch.float32)     # (N, E)
    mine = slice(0, E) if tp is None else tp.part(E)  # this rank's experts
    n_e = mine.stop - mine.start
    groups = [_dispatch_group(xt[g * n_loc:(g + 1) * n_loc], logits[g * n_loc:(g + 1) * n_loc],
                              E, K, C, m.normalize_topk, compute, mine) for g in range(G)]
    # the groups' buffers side by side on the capacity axis: (n_e, G*C, d)
    xbuf = groups[0][0] if G == 1 else torch.cat([gr[0] for gr in groups], dim=1)

    act = _act("swiglu" if m.gated else "gelu")
    g = torch.bmm(xbuf, params["wi_gate"].to(compute))               # (n_e, G*C, f)
    if m.gated:
        h = act(g) * torch.bmm(xbuf, params["wi_up"].to(compute))
    else:
        h = act(g)
    ybuf = torch.bmm(h, params["wo"].to(compute))                    # (n_e, G*C, d)

    outs = []
    for i, (_, st, sw, keep, slot, _) in enumerate(groups):
        yg = ybuf if G == 1 else ybuf[:, i * C:(i + 1) * C]
        # combine: each pair's expert output (0 for a dropped pair, or one
        # of another rank's experts: the spare row), times its weight, then
        # each token's K rows in expert order
        ypad = torch.cat([yg.reshape(n_e * C, d), yg.new_zeros((1, d))])
        y = ypad[_local_slots(slot, keep, mine.start * C, n_e * C)] * \
            (sw * keep).to(compute)[:, None]
        # a token's sorted pairs in ascending order are its experts in
        # ascending order: the JAX scatter-add's order, kept by a
        # sequential sum
        y = y[torch.argsort(st, stable=True)].reshape(n_loc, K, d)
        o = y[:, 0]
        for j in range(1, K):
            o = o + y[:, j]
        outs.append(o)
    out = outs[0] if G == 1 else torch.cat(outs)

    if m.n_shared_experts:
        out = out + _mlp(params["shared"], xt, cfg)

    counts = groups[0][5]
    for gr in groups[1:]:
        counts = counts + gr[5]
    expert_load = counts.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    lse2 = torch.logsumexp(logits, dim=-1) ** 2
    if ranks is None:
        me, z_loss = probs.mean(dim=0), torch.mean(lse2)
    else:
        ranks.sum_(expert_load)
        total = N * ranks.shards
        me, z_loss = probs.sum(dim=0) / total, lse2.sum() / total
    ce = expert_load / torch.clamp(expert_load.sum(), min=1.0)
    aux = {"expert_load": expert_load,
           "moe_lb_loss": E * torch.sum(me * ce),
           "moe_z_loss": z_loss}
    out = out.reshape(B, S, d)
    if tp is not None:
        return tp.seq_scatter(out), aux
    return (out if seq is None else seq.local(out)), aux
