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
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.layers.common import unflatten
from repro_torch.models.transformer import Transformer
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    compress_int8,
    cosine_schedule,
    decompress_int8,
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

    @torch.no_grad()
    def load_tree(self, tree: dict) -> None:
        """Copy a tree of ``tree()``'s layout (a restored checkpoint) into
        the parameters and the optimizer state, in place."""
        from repro_torch.layers.common import tree_leaves

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


def init_state(cfg, tcfg: TrainConfig, seed: int = 0, device=None) -> TrainState:
    """Seeded parameters (the port's initializer) and fresh AdamW state."""
    model = Transformer.from_init(cfg, seed=seed, device=device)
    return TrainState(model, adamw_init(model.named_params(), tcfg.optimizer), 0)


def tokens_per_shard(labels: torch.Tensor, n_shards: int = 1) -> torch.Tensor:
    """Real (non-pad) token count per data shard: the data-LB observable.
    labels: (B,S); the batch dim is split over ``n_shards``."""
    B = labels.shape[0]
    if n_shards <= 1 or B % n_shards:
        return torch.sum(labels >= 0).reshape(1).to(torch.float32)
    g = labels.reshape(n_shards, B // n_shards, -1)
    return torch.sum(g >= 0, dim=(1, 2)).to(torch.float32)


def make_train_step(cfg, tcfg: TrainConfig):
    """Returns ``train_step(state, batch) -> (state, metrics)``."""

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
        for a in range(A):
            mb = {k: v[a] for k, v in batch.items()}
            loss, aux = model(mb)
            grads = torch.autograd.grad(loss, leaves)
            for k, g in zip(params, grads):
                if k in gsum:
                    gsum[k].add_(g)
                else:
                    gsum[k] = g.to(torch.float32)
            del grads
            loss_sum = loss_sum + loss.detach()
            tokens = tokens + aux["tokens"].detach()
            for k in ("expert_load", "moe_lb_loss"):
                if k in aux:
                    v = aux[k].detach()
                    kept[k] = v if k not in kept else kept[k] + v
            t = tokens_per_shard(mb["labels"])
            tps = t if tps is None else tps + t
        inv = 1.0 / A
        for g in gsum.values():
            g.mul_(inv)
        if tcfg.compress_dcn_grads:
            for g in gsum.values():
                q, scale, meta = compress_int8(g)
                g.copy_(decompress_int8(q, scale, meta))
        lr_scale = cosine_schedule(state.step, warmup=tcfg.warmup_steps,
                                   total=tcfg.total_steps)
        stats = adamw_update(params, gsum, state.opt_state, tcfg.optimizer, lr_scale)
        state.step += 1
        metrics = {"loss": loss_sum * inv, "grad_norm": stats["grad_norm"],
                   "lr": stats["lr"], "tokens": tokens, "tokens_per_shard": tps, **kept}
        return state, metrics

    return train_step
