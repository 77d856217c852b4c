"""The train step (``repro.train.train``): microbatch accumulation, AdamW
with fp32 master, the cosine schedule, and the monitor's per-step
observables (real-token counts per data shard).

``make_train_step(cfg, tcfg)`` returns ``train_step(state, batch) ->
(state, metrics)`` with the JAX step's contract: ``batch`` holds
``tokens``/``labels`` of shape (A, B, S) with A = ``accum_steps``; each
microbatch's gradients (in the parameter dtype, as ``jax.grad`` gives
them) are summed in fp32, then loss and gradients are scaled by 1/A.
Metrics: ``loss``, ``grad_norm``, ``lr``, ``tokens``,
``tokens_per_shard``. The state is updated in place and returned.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.transformer import Transformer
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    accum_steps: int = 1
    warmup_steps: int = 100
    total_steps: int = 10_000
    # int8 round trip of the gradients for the cross-pod hop: not ported
    # (ROADMAP.md Queue 1, item 6); True raises
    compress_dcn_grads: bool = False


@dataclasses.dataclass
class TrainState:
    model: Transformer   # holds the parameters
    opt_state: dict      # {"step", "m", "v", "master"}, flat {path: tensor}
    step: int = 0


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
    if tcfg.compress_dcn_grads:
        raise NotImplementedError(
            "compress_dcn_grads: the int8 gradient compression is not ported "
            "yet (ROADMAP.md Queue 1, item 6)"
        )

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
            t = tokens_per_shard(mb["labels"])
            tps = t if tps is None else tps + t
        inv = 1.0 / A
        for g in gsum.values():
            g.mul_(inv)
        lr_scale = cosine_schedule(state.step, warmup=tcfg.warmup_steps,
                                   total=tcfg.total_steps)
        stats = adamw_update(params, gsum, state.opt_state, tcfg.optimizer, lr_scale)
        state.step += 1
        metrics = {"loss": loss_sum * inv, "grad_norm": stats["grad_norm"],
                   "lr": stats["lr"], "tokens": tokens, "tokens_per_shard": tps}
        return state, metrics

    return train_step
