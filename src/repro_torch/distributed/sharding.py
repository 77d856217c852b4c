"""Sharding rules (``repro.distributed.sharding``): logical axes -> mesh
axes, per architecture.

Two strategies, checked against the arch's dimensions:

* ``megatron``: tensor parallelism over the "model" axis (attention heads,
  FFN hidden, experts, vocab), FSDP (ZeRO-3) over the "data" axis on every
  parameter's embed dim, sequence-parallel residual stream over "model",
  batch over ("pod", "data"). Used when heads/dff divide the model axis.

* ``fsdp``: parameters sharded over the flattened ("data","model") product
  on their largest divisible dim (pure ZeRO-3), activations batch-sharded
  over ("pod","data","model") with the residual stream sequence-sharded
  over "model". Used for archs whose head counts do not divide the model
  axis (gemma2-2b: 8 heads, xlstm-350m: 4 heads).

Rules are plain dicts consumed by ``layers.common.param_pspecs`` and
``LogicalConstraints``; they are pure functions of a config and a mesh's
axis names and sizes (``mesh.axis_names``, ``mesh.devices.shape``), so
the port's ``launch.mesh.Mesh`` and a JAX mesh give the same rules. A
pspec is a tuple (see ``layers.common``). The port stores parameters as
these rules say; its compute splits the batch, and on a megatron mesh
whose "model" axis is above 1 also the heads, MLP columns, experts,
vocabulary, SSM heads and the residual stream's sequence as the
activation rules do (``distributed.shard.TensorParallel``); on an fsdp
mesh whose batch does not split over "model", the sequence
(``distributed.shard.ContextParallel``).
"""

from __future__ import annotations

from typing import Any

BATCH_AXES = ("pod", "data")


def _axis(mesh, name: str) -> int:
    return dict(zip(mesh.axis_names, mesh.devices.shape)).get(name, 1)


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def param_rules(cfg, mesh) -> dict[str, Any]:
    """Logical param axis -> mesh axes."""
    model = _axis(mesh, "model")
    strategy = effective_strategy(cfg, mesh)

    if strategy == "megatron":
        return {
            "embed": "data",
            "embed_out": "data",
            "qkv": "model",
            "kv": "model",
            "mlp": "model",
            "experts": "model",
            "expert_mlp": None,
            "vocab": "model",
            "inner": "model",
            "inner_all": "model",
            "inner_q": "model",
            "ssm_heads": "model" if cfg.ssm and _div(cfg.ssm.n_heads(cfg.d_model), model) else None,
            "layers": None,
        }
    # fsdp: one big ZeRO-3 domain over (data x model); the mlp weights are
    # ("embed","mlp")/("mlp","embed_out"), and embed already carries the
    # fsdp axes, so mlp does not reuse them
    fsdp_axes = tuple(a for a in ("data", "model") if _axis(mesh, a) > 1) or ("data",)
    return {
        "embed": fsdp_axes,
        "embed_out": None,
        "qkv": None,
        "kv": None,
        "mlp": None,
        "experts": "model" if cfg.moe and _div(cfg.moe.n_experts, model) else None,
        "expert_mlp": None,
        "vocab": "model",
        "inner": fsdp_axes,
        "inner_all": fsdp_axes,
        "inner_q": None,
        "ssm_heads": None,
        "layers": None,
    }


def activation_rules(cfg, mesh) -> dict[str, Any]:
    model = _axis(mesh, "model")
    batch = tuple(a for a in BATCH_AXES if _axis(mesh, a) > 1) or ("data",)
    if effective_strategy(cfg, mesh) == "megatron":
        return {
            "batch": batch,
            "seq": "model",       # sequence-parallel residual stream
            "seq_q": None,
            "seq_kv": None,
            "seq_mlp": None,
            "heads": "model",
            "kv_heads": "model" if _div(cfg.n_kv_heads, model) else None,
            "mlp": "model",
            "experts": "model",
            "expert_cap": "data",
            "expert_mlp": None,
            "inner": "model",
            "vocab": "model",
        }
    return {
        # fsdp: batch over the whole fabric when divisible (the shape-aware
        # pspec backs off to a divisible prefix otherwise)
        "batch": batch + ("model",),
        "seq": "model",
        "seq_q": "model",         # context parallel: q stays seq-sharded
        "seq_kv": None,
        "seq_mlp": "model",
        "heads": None,
        "kv_heads": None,
        "mlp": None,
        "experts": None,
        "expert_cap": None,
        "expert_mlp": None,
        "inner": None,
        "vocab": "model",
    }


def effective_strategy(cfg, mesh) -> str:
    """The requested strategy, checked against the arch's dims: fall back to
    fsdp when tensor parallelism cannot shard the heads."""
    model = _axis(mesh, "model")
    if cfg.sharding == "megatron":
        heads_ok = _div(cfg.n_heads, model)
        dff_ok = cfg.d_ff == 0 or _div(cfg.d_ff, model)
        if heads_ok and (dff_ok or cfg.moe):
            return "megatron"
        return "fsdp"
    return cfg.sharding


def batch_pspec(cfg, mesh) -> tuple:
    """``(axes,)``: one axis as its name, several as a tuple (``tuple(P(...))``
    of JAX's)."""
    batch = tuple(a for a in BATCH_AXES if _axis(mesh, a) > 1) or ("data",)
    return (batch[0] if len(batch) == 1 else batch,)


def divisible_batch_axes(mesh, batch: int):
    """Longest prefix of the batch axes whose product divides ``batch``
    (a batch of 1 => no batch sharding)."""
    axes = []
    prod = 1
    for a in BATCH_AXES:
        size = _axis(mesh, a)
        if size <= 1:
            continue
        if batch % (prod * size) == 0:
            axes.append(a)
            prod *= size
        else:
            break
    if not axes:
        return None
    return tuple(axes) if len(axes) > 1 else axes[0]


def data_shards(mesh) -> int:
    return _axis(mesh, "pod") * _axis(mesh, "data")


def input_shardings(cfg, mesh, batch_spec_tree):
    """``NamedSharding``s for a batch tree (nested dicts of anything with a
    ``shape``): the leading dim is the global batch, over ``batch_pspec``."""
    from repro_torch.distributed.shard import NamedSharding
    from repro_torch.layers.common import tree_map

    bp = batch_pspec(cfg, mesh)
    return tree_map(
        lambda x: NamedSharding(mesh, (bp[0],) + (None,) * (len(x.shape) - 1)),
        batch_spec_tree)


def cache_pspec_tree(cfg, mesh, caches) -> dict:
    """The placement of each leaf of the port's cache tree (nested dicts of
    anything with a ``shape``; ``models.transformer.init_cache``), as the
    tuples ``layers.common.param_pspecs`` returns (JAX ``cache_pspec_tree``).
    Each dim gets the axes that JAX's rule gives the matching dim of JAX's
    stacked ``(R, B, ...)`` leaf: the batch over ``divisible_batch_axes``;
    the KV heads over ``"model"`` when ``n_kv_heads`` divides it, and
    otherwise the dense cache's sequence over ``"model"`` (attention over a
    split sequence combines each rank's part through its LSE); the paged
    pool's page axis never split (pages are read by physical index) and
    its KV heads as the dense cache's; mamba2's SSM heads over ``"model"``
    when they divide it and its conv channels over the activation rules'
    ``"inner"``; the mLSTM and sLSTM state whole but for the batch.

    The port's spare rows stay whole on every rank. A dense leaf is ``(R,
    B+1, max_len, Hkv, hd)``: its batch entry places rows ``0..B-1``
    (divisibility is read off ``B``), and every rank's block ends with a
    spare row of its own, ``(R, B/n + 1, ...)``, which takes the rank's
    dropped writes and is never read (``distributed.shard
    .cache_block_shape``).
    The paged pool's spare page ``P`` lies on the page axis, which no rank
    splits, so every rank holds it with the rest of the pool."""
    from repro_torch.layers.common import tree_leaves, unflatten

    rules = activation_rules(cfg, mesh)
    model = _axis(mesh, "model")
    kv_div = model > 1 and cfg.n_kv_heads % model == 0
    inner = rules["inner"]
    ssm_heads = ("model" if cfg.ssm and model > 1 and cfg.ssm.n_heads(cfg.d_model) % model == 0
                 else None)

    def place(path: str, leaf) -> tuple:
        nd = len(leaf.shape)
        if "pages" in path:  # (R, P+1, page, Hkv, hd): no batch dim
            return (None, None, None, "model" if kv_div else None, None)
        attn = "attn" in path
        b = (leaf.shape[1] - (1 if attn else 0)) if nd >= 2 else 1
        batch = divisible_batch_axes(mesh, b)
        if attn:  # (R, B+1, Smax, Hkv, hd)
            if kv_div:
                return (None, batch, None, "model", None)
            return (None, batch, "model" if model > 1 else None, None, None)
        if "mamba" in path and nd == 4:  # conv (R, B, K-1, C)
            return (None, batch, None, inner)
        if "mamba" in path and nd == 5:  # ssm (R, B, h, p, n)
            return (None, batch, ssm_heads, None, None)
        return (None, batch) + (None,) * (nd - 2)

    return unflatten({p: place(p, leaf) for p, leaf in tree_leaves(caches)})
