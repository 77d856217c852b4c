"""The train step (``repro.train.train``): microbatch accumulation, AdamW
with fp32 master, the cosine schedule, and the monitor's per-step
observables (real-token counts per data shard).

``make_train_step(cfg, tcfg)`` returns ``train_step(state, batch) ->
(state, metrics)`` with the JAX step's contract: ``batch`` holds
``tokens``/``labels`` of shape (A, B, S) with A = ``accum_steps``; each
microbatch's gradients (in the parameter dtype, as ``jax.grad`` gives
them) are summed in fp32, then loss and gradients are scaled by 1/A.
With ``compress_dcn_grads`` each averaged gradient makes the int8 round
trip of ``optim.compression`` (no key: round half to even) before the
update, as the JAX step does. Metrics: ``loss``, ``grad_norm``, ``lr``,
``tokens``, ``tokens_per_shard``, and for an MoE model ``expert_load``
(pairs per expert, summed over layers) and ``moe_lb_loss``, each summed
over the microbatches as the JAX step's scan sums them. The state is
updated in place and returned. ``TrainState.tree()`` is the JAX
``TrainState.tree()``'s layout over the live tensors (what a checkpoint
stores) and ``TrainState.load_tree`` copies such a tree back in.

``make_train_step(cfg, tcfg, mesh)`` is the step over a mesh of ranks
(JAX's ``make_train_step`` / ``compile_train_step`` under a mesh). Each
rank holds its blocks of the parameters, gradients and AdamW state
(``train_state_pspecs``; ``init_state(mesh=)``), plain tensors with
their ``NamedSharding``s beside them. Every rank gets the global batch
(``SyntheticLM.batch_at``) and runs the rows that JAX's ``"batch"``
activation rule gives it (``BatchRanks``). On a megatron mesh whose
``"model"`` axis is above 1 the ``"model"`` peers split those rows'
work as JAX's activation rules do (``TensorParallel``: the sequence of
the residual stream, heads, MLP columns, experts, vocabulary, a mamba2
block's SSM heads). Under the fsdp strategy, where the batch does not
split over ``"model"``, the ``"model"`` peers split the sequence of their
rows (``ContextParallel``: JAX's context parallelism, each rank's query
block against the gathered K and V). Ranks that neither rule splits
(the ``"data"`` peers of a batch too small for that axis) run the same
rows. The loss is each rank's CE sum over the global batch's labelled-token
count plus its share of the router terms, so the ranks' losses and
gradients sum to the global ones; the layers' gathers sum each
gradient over the ranks whose part of it differs (``distributed.shard``),
so identical parts count once. ``grad_norm`` is the whole gradient's
(each block counted on one rank, all-reduced). Metrics are the global
batch's, equal on every rank: ``loss`` summed over the ranks with other
rows (and over ``"model"`` where the sequence splits), ``moe_lb_loss``
over the ranks with other rows of the batch, ``tokens`` and ``tokens_per_shard``
(over ``data_shards(mesh)``) from the global labels, ``expert_load``
summed in the MoE block. On a mesh without a process group (world size
1) the step is the plain step.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed import sharding as SH
from repro_torch.distributed.shard import (
    BatchRanks,
    ContextParallel,
    TensorParallel,
    gather_full,
)
from repro_torch.layers.common import (
    LogicalConstraints,
    param_pspecs,
    tree_leaves,
    unflatten,
)
from repro_torch.models.transformer import Transformer, model_params
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    compress_int8,
    cosine_schedule,
    decompress_int8,
    global_norm,
    optimizer_pspecs,
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    accum_steps: int = 1
    warmup_steps: int = 100
    total_steps: int = 10_000
    # int8 round trip of the gradients for the cross-pod hop
    compress_dcn_grads: bool = False


@dataclasses.dataclass
class TrainState:
    model: Transformer   # holds the parameters
    opt_state: dict      # {"step", "m", "v", "master"}, flat {path: tensor}
    step: int = 0

    def tree(self) -> dict:
        """``{"params", "opt_state": {"step", "m", "v"[, "master"]}, "step"}``
        nested as the JAX tree, over the live tensors (no copy)."""
        opt = {k: (unflatten(v) if isinstance(v, dict) else v)
               for k, v in self.opt_state.items()}
        return {"params": self.model.params(), "opt_state": opt, "step": self.step}

    def shardings(self) -> dict | None:
        """``tree()``'s structure of ``NamedSharding``s on a mesh (None
        without one): what a sharded save gathers and a sharded restore
        cuts."""
        from repro_torch.distributed.shard import NamedSharding, shardings_tree

        mesh = self.model.mesh
        if mesh is None:
            return None
        pp = {k: sh.spec for k, sh in self.model.shardings.items()}
        opt = {k: (unflatten(pp) if isinstance(v, dict) else ())
               for k, v in self.opt_state.items()}
        tree = shardings_tree(mesh, {"params": unflatten(pp), "opt_state": opt})
        tree["step"] = NamedSharding(mesh, ())
        return tree

    @torch.no_grad()
    def load_tree(self, tree: dict) -> None:
        """Copy a tree of ``tree()``'s layout (a restored checkpoint) into
        the parameters and the optimizer state, in place."""
        named = self.model.named_params()
        for path, t in tree_leaves(tree["params"]):
            named[path].copy_(t)
        for key, v in tree["opt_state"].items():
            if key == "step":
                self.opt_state["step"] = int(v)
                continue
            for path, t in tree_leaves(v):
                self.opt_state[key][path].copy_(t)
        self.step = int(tree["step"])


def init_state(cfg, tcfg: TrainConfig, seed: int = 0, device=None, mesh=None) -> TrainState:
    """Seeded parameters (the port's initializer) and fresh AdamW state; on
    ``mesh`` this rank's blocks of both (on ``mesh.device`` unless
    ``device`` is given)."""
    if mesh is not None and device is None:
        device = mesh.device
    model = Transformer.from_init(cfg, seed=seed, device=device, mesh=mesh)
    return TrainState(model, adamw_init(model.named_params(), tcfg.optimizer), 0)


def train_state_pspecs(cfg, mesh, tcfg: TrainConfig) -> dict:
    """The state tree's pspecs (JAX ``train_state_pspecs``)."""
    pp = param_pspecs(model_params(cfg), SH.param_rules(cfg, mesh), mesh)
    return {"params": pp, "opt_state": optimizer_pspecs(pp, tcfg.optimizer), "step": ()}


def tokens_per_shard(labels: torch.Tensor, n_shards: int = 1) -> torch.Tensor:
    """Real (non-pad) token count per data shard: the data-LB observable.
    labels: (B,S); the batch dim is split over ``n_shards``."""
    B = labels.shape[0]
    if n_shards <= 1 or B % n_shards:
        return torch.sum(labels >= 0).reshape(1).to(torch.float32)
    g = labels.reshape(n_shards, B // n_shards, -1)
    return torch.sum(g >= 0, dim=(1, 2)).to(torch.float32)


def make_train_step(cfg, tcfg: TrainConfig, mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; with a mesh
    over a process group, the step over its ranks (the module docstring)."""
    ranked = mesh is not None and mesh.distributed
    rules = SH.activation_rules(cfg, mesh) if ranked else None
    split = LogicalConstraints(mesh, rules) if ranked else None  # reads the batch split
    tp = TensorParallel.of(cfg, mesh)
    n_shards = SH.data_shards(mesh) if mesh is not None else 1

    def train_step(state: TrainState, batch: dict):
        model = state.model
        params = model.named_params()
        leaves = list(params.values())
        dev = model.device
        batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
        A = batch["labels"].shape[0]
        gsum: dict = {}
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        tokens = torch.zeros((), dtype=torch.float32, device=dev)
        tps = None
        kept: dict = {}  # the router's totals, summed over microbatches
        lc = None
        for a in range(A):
            mb = {k: v[a] for k, v in batch.items()}
            n_real = None
            if ranked:
                ranks = BatchRanks.for_batch(split, mb["labels"].shape)
                cp = None if tp is not None else ContextParallel.of(cfg, mesh, ranks)
                lc = LogicalConstraints(mesh, rules, ranks, tp, cp)
                n_real = torch.sum(mb["labels"] >= 0).to(torch.float32)
                rows = ranks.rows(mb["labels"].shape[0])
                loss, aux = model({k: v[rows] for k, v in mb.items()}, lc, n_real)
            else:
                loss, aux = model(mb)
            grads = torch.autograd.grad(loss, leaves)
            for k, g in zip(params, grads):
                if k in gsum:
                    gsum[k].add_(g)
                else:
                    gsum[k] = g.to(torch.float32)
            del grads
            loss_sum = loss_sum + loss.detach()
            tokens = tokens + (aux["tokens"].detach() if n_real is None else n_real)
            for k in ("expert_load", "moe_lb_loss"):
                if k in aux:
                    v = aux[k].detach()
                    kept[k] = v if k not in kept else kept[k] + v
            t = tokens_per_shard(mb["labels"], n_shards)
            tps = t if tps is None else tps + t
        if lc is not None:  # each rank's parts -> the global batch's
            group = mesh.group(lc.sum_axes())
            if group is not None:
                import torch.distributed as dist

                dist.all_reduce(loss_sum, group=group)
            if "moe_lb_loss" in kept:
                lc.ranks.sum_(kept["moe_lb_loss"])
        inv = 1.0 / A
        for g in gsum.values():
            g.mul_(inv)
        if tcfg.compress_dcn_grads:
            for k, g in gsum.items():
                # the int8 blocks run over the full leaf: on a mesh of ranks
                # the leaf is gathered, round-tripped, and cut again
                full = gather_full(g, model.shardings[k]) if ranked else g
                q, scale, meta = compress_int8(full)
                rt = decompress_int8(q, scale, meta)
                g.copy_(model.shardings[k].local(rt) if ranked else rt)
        gnorm = None
        if ranked:
            gnorm = global_norm(gsum, model.shardings, mesh.group(mesh.axis_names))
        lr_scale = cosine_schedule(state.step, warmup=tcfg.warmup_steps,
                                   total=tcfg.total_steps)
        stats = adamw_update(params, gsum, state.opt_state, tcfg.optimizer, lr_scale, gnorm)
        state.step += 1
        metrics = {"loss": loss_sum * inv, "grad_norm": stats["grad_norm"],
                   "lr": stats["lr"], "tokens": tokens, "tokens_per_shard": tps, **kept}
        return state, metrics

    return train_step
