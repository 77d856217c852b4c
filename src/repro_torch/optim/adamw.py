"""AdamW with fp32 master weights over bf16 params (``repro.optim.adamw``).

The same update as the JAX package, leaf for leaf: global-norm clipping,
bias correction, decoupled weight decay applied to the fp32 master, and
the parameters re-cast from the master. The JAX update is functional; the
port updates the optimizer state and the parameters in place (a second
copy of a full-width state would double its memory), under ``no_grad``.
Parameters, gradients and state are flat ``{path: tensor}`` dicts keyed by
the JAX tree's paths, in sorted order.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    keep_master: bool = True  # fp32 master copy of bf16 params


def adamw_init(params: dict, cfg: AdamWConfig) -> dict:
    """``{"step": 0, "m": {path: fp32 zeros}, "v": ..., "master": fp32 copy}``."""
    with torch.no_grad():
        state = {
            "step": 0,
            "m": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for k, p in params.items()},
        }
        if cfg.keep_master:
            state["master"] = {k: p.detach().to(torch.float32, copy=True)
                               for k, p in params.items()}
    return state


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in fp32, leaves in
    sorted path order (the JAX leaf order)."""
    sums = [torch.sum(torch.square(tree[k].to(torch.float32))) for k in sorted(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict, cfg: AdamWConfig,
                 lr_scale=1.0) -> dict:
    """Update ``params`` and ``state`` in place. Returns stats
    {"grad_norm": device scalar, "lr": float}. The scalars (step, bias
    corrections, lr) are host fp32 arithmetic, as JAX's are fp32."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
            if cfg.grad_clip else None)
    lr = float(_f32(cfg.lr) * _f32(lr_scale))
    b1c = float(1.0 - _f32(cfg.b1) ** _f32(step))
    b2c = float(1.0 - _f32(cfg.b2) ** _f32(step))
    masters = state.get("master")
    for k in sorted(params):
        p, m, v = params[k], state["m"][k], state["v"][k]
        g32 = grads[k].to(torch.float32)
        if clip is not None:
            g32 = g32 * clip
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g32)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g32 * g32)
        base = masters[k] if masters is not None else p.to(torch.float32)
        new = base - lr * ((m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
                           + cfg.weight_decay * base)
        if masters is not None:
            masters[k].copy_(new)
        p.copy_(new.to(p.dtype))
    state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}
