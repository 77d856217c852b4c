"""Elastic scaling (``repro.distributed.elastic``): move a training state
onto a mesh of another size.

``reshard_state`` takes a tree of full leaves (tensors on any device,
numpy arrays, or Python ints: what a checkpoint or one rank's gather
holds) and gives each rank of ``target_mesh`` its blocks under
``target_pspecs``. A leaf comes to the host once and only this rank's
block goes out to its device, so device memory grows by one shard a
leaf, never by a full leaf. A sharded checkpoint restore
(``checkpoint.load_checkpoint(shardings=)``) does the same from the
files, reading only this rank's blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed.shard import NamedSharding


def _host(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu")
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def reshard_state(state_tree, target_mesh, target_pspecs):
    """Every leaf of ``state_tree`` as this rank's block per ``target_pspecs``
    (a tree of pspec tuples, the same structure) on ``target_mesh.device``.
    Python ints pass through."""
    if isinstance(state_tree, dict):
        return {k: reshard_state(v, target_mesh, target_pspecs[k]) for k, v in state_tree.items()}
    if isinstance(state_tree, (int, np.integer)):
        return int(state_tree)
    host = _host(state_tree)
    block = NamedSharding(target_mesh, target_pspecs).local(host)
    return block.contiguous().to(target_mesh.device or "cpu")
