"""AdamW with fp32 master weights over bf16 params (``repro.optim.adamw``).

The same update as the JAX package, leaf for leaf: global-norm clipping,
bias correction, decoupled weight decay applied to the fp32 master, and
the parameters re-cast from the master. The JAX update is functional; the
port updates the optimizer state and the parameters in place (a second
copy of a full-width state would double its memory), under ``no_grad``.
Parameters, gradients and state are flat ``{path: tensor}`` dicts keyed by
the JAX tree's paths, in sorted order; on a mesh of ranks each holds this
rank's blocks (``distributed.shard``) and the state inherits the
parameters' placement (``optimizer_pspecs``). A leaf above ``UPDATE_SLICE_ELEMENTS``
is updated in slices along its leading axis (as many rows a slice as keep
it within that size, one row at least), so that the update's fp32
temporaries are a slice's; the update is elementwise, so the result is
bitwise the whole leaf's.
"""

from __future__ import annotations

import dataclasses

import torch

# qwen3-moe-30b-a3b's stacked experts at 5 layers hold 1.0e9 elements: their
# update's temporaries would take 4.0 GB of fp32 each
UPDATE_SLICE_ELEMENTS = 2**27


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


def global_norm(tree: dict, shardings: dict | None = None, group=None) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in fp32, leaves in
    sorted path order (the JAX leaf order). On a mesh, ``tree`` holds this
    rank's blocks and ``shardings`` their placements: a block counts on
    the one rank that owns it (``NamedSharding.owned``; its other holders
    add 0), and the sum is all-reduced over ``group`` (every rank of the
    mesh) before the root, so the norm is the whole gradient's."""
    sums = [torch.sum(torch.square(tree[k].to(torch.float32))) for k in sorted(tree)]
    if shardings is not None:
        sums = [s if shardings[k].owned() else torch.zeros_like(s)
                for k, s in zip(sorted(tree), sums)]
    total = torch.sum(torch.stack(sums))
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(total, group=group)
    return torch.sqrt(total)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict, cfg: AdamWConfig,
                 lr_scale=1.0, grad_norm: torch.Tensor | None = None) -> dict:
    """Update ``params`` and ``state`` in place. Returns stats
    {"grad_norm": device scalar, "lr": float}. The scalars (step, bias
    corrections, lr) are host fp32 arithmetic, as JAX's are fp32. On a
    mesh the leaves are this rank's blocks (the update is elementwise) and
    ``grad_norm`` is the whole gradient's (``global_norm`` with
    ``shardings``), which clips every block alike."""
    step = state["step"] + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
            if cfg.grad_clip else None)
    lr = float(_f32(cfg.lr) * _f32(lr_scale))
    b1c = float(1.0 - _f32(cfg.b1) ** _f32(step))
    b2c = float(1.0 - _f32(cfg.b2) ** _f32(step))
    masters = state.get("master")

    def update(p, g, m, v, master):
        g32 = g.to(torch.float32)
        if clip is not None:
            g32 = g32 * clip
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g32)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g32 * g32)
        base = master if master is not None else p.to(torch.float32)
        new = base - lr * ((m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
                           + cfg.weight_decay * base)
        if master is not None:
            master.copy_(new)
        p.copy_(new.to(p.dtype))

    for k in sorted(params):
        leaf = (params[k], grads[k], state["m"][k], state["v"][k],
                masters[k] if masters is not None else None)
        p = leaf[0]
        if p.numel() > UPDATE_SLICE_ELEMENTS and p.dim() > 1:
            rows = max(1, UPDATE_SLICE_ELEMENTS // (p.numel() // p.shape[0]))
            for i in range(0, p.shape[0], rows):
                update(*(t if t is None else t[i:i + rows] for t in leaf))
        else:
            update(*leaf)
    state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}


def optimizer_pspecs(param_pspecs, cfg: AdamWConfig) -> dict:
    """Optimizer state placements mirror the parameters' (ZeRO-3: sharded
    params => sharded state); the step counter is replicated."""
    state = {"step": (), "m": param_pspecs, "v": param_pspecs}
    if cfg.keep_master:
        state["master"] = param_pspecs
    return state
