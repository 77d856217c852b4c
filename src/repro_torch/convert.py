"""Carry weights across: the JAX parameter pytree, as numpy arrays, into the
port's model.

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
