"""Carry weights (and a training state) across: the JAX parameter pytree,
as numpy arrays, into the port's model.

``jax.random`` cannot be reproduced in PyTorch, so every parity check
initializes in JAX, converts the leaves to numpy (``np.asarray``) on the
JAX side, and hands the tree here. The tree is the one
``repro.layers.common.init_params(T.model_params(cfg), ...)`` returns:
``embed``, ``norm_f/scale``, ``head`` and
``slots/slot{i}_{kind}/{norm_in, attn/{wq,wk,wv,wo}, norm_mlp,
mlp/{wi_gate,wi_up,wo}}`` stacked over ``repeats``. This module imports
no JAX: it sees only numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.layers.common import tree_map
from repro_torch.models.transformer import Transformer


def _to_torch(arr) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_numpy(tree: dict) -> dict:
    """Nested dict of numpy arrays -> the same nested dict of CPU tensors."""
    return tree_map(_to_torch, tree)


def from_jax_params(tree_of_numpy: dict, cfg, device=None) -> Transformer:
    """Build the port's ``Transformer`` on ``device`` from the JAX tree.
    Raises if the tree's paths or shapes differ from ``model_params(cfg)``."""
    return Transformer(cfg, params_from_numpy(tree_of_numpy), device)


def from_jax_train_state(tree_of_numpy: dict, cfg, device=None):
    """A port ``TrainState`` from the JAX ``TrainState.tree()`` as numpy:
    ``{"params", "opt_state": {"step", "m", "v"[, "master"]}, "step"}``.
    The optimizer trees are flattened to the port's ``{path: tensor}``
    dicts on the model's device, so a port run resumes from a JAX one."""
    from repro_torch.layers.common import tree_leaves
    from repro_torch.train.train import TrainState

    model = from_jax_params(tree_of_numpy["params"], cfg, device)
    dev = model.device
    opt = tree_of_numpy["opt_state"]
    opt_state = {"step": int(np.asarray(opt["step"]))}
    for key in ("m", "v", "master"):
        if key in opt:
            opt_state[key] = {p: _to_torch(a).to(dev) for p, a in tree_leaves(opt[key])}
    return TrainState(model, opt_state, int(np.asarray(tree_of_numpy["step"])))
