"""Checkpointing (``repro.checkpoint.checkpoint``) with atomic commit and
async file writes, in the JAX package's format, byte for byte.

Format: one directory per step:
    step_00000123.tmp/          (written)
      manifest.json             {"step", "arrays": {flat key: {shape, dtype, file}}}
      arr_00000.npy ...         one array per key, numbered in sorted key order
    step_00000123/              (``os.replace`` = commit)

Keys are the JAX package's ``_flatten`` paths of the state tree: dict keys
(and list indices) joined with '/', e.g. ``params/slots/slot0_attn/attn/
wq``, ``opt_state/m/...``, ``opt_state/step``, ``step``, so either
package restores the other's checkpoint. bf16 is stored as a ``uint16``
view under the dtype name ``"bfloat16"``; a Python int leaf (the port's
step counters) is stored as an int32 scalar, as JAX holds them. Leaves
are tensors and ints.

Contract:
  * a crash mid-save never corrupts the latest checkpoint (tmp dir +
    rename);
  * the device-to-host copy finishes before ``save_checkpoint`` returns
    (the port's AdamW then updates the parameters in place); with
    ``async_`` only the file writes run on a background thread;
  * restore places each array on its template leaf's device, in the
    template's dtype.

On a mesh of ranks (``shardings=``: a tree of ``distributed.shard.
NamedSharding``s of the state tree's structure, whose leaves are then
this rank's blocks) a save gathers each leaf (every rank takes part) and
rank 0 alone writes the files above, so the JAX loader reads them; a
restore reads only this rank's block of each array (the ``.npy`` is
memory-mapped and sliced).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

# numpy has no bfloat16: stored as a same-width integer view, restored by
# the manifest's dtype name
_VIEW_AS = {"bfloat16": np.uint16}


def _flatten(tree, prefix: str = "") -> dict[str, Any]:
    """Nested dicts and lists -> ``{path: leaf}``, paths joined by '/'."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: dict[str, Any] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """One leaf (a tensor or a Python int) as (host numpy array, dtype
    name), a blocking copy from the card."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).copy(), "bfloat16"
        a = t.numpy().copy()
    else:
        a = np.asarray(leaf, np.int32)
    return a, str(a.dtype)


def save_checkpoint(tree, directory: str, step: int, async_: bool = False, shardings=None):
    """Save ``tree`` as ``directory/step_%08d``; returns a join() callable
    (a no-op when synchronous, and on every rank but 0 of a mesh)."""
    flat = _flatten(tree)
    if shardings is not None:
        from repro_torch.distributed.shard import gather_full

        placed = _flatten(shardings)
        flat = {k: gather_full(v, placed[k]) if isinstance(v, torch.Tensor) else v
                for k, v in flat.items()}
        if _rank(shardings):
            return lambda: None
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    # device -> host now, so training may update the buffers after
    host = {k: _to_host(v) for k, v in flat.items()}

    def write():
        manifest = {}
        for i, (k, (arr, dt)) in enumerate(sorted(host.items())):
            fname = f"arr_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest[k] = {"shape": list(arr.shape), "dtype": dt, "file": fname}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "arrays": manifest}, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)

    if async_:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t.join
    write()
    return lambda: None


def _rank(shardings) -> int:
    """This process's rank on the mesh of ``shardings`` (0 without one)."""
    if shardings is None:
        return 0
    return next(iter(_flatten(shardings).values())).mesh.rank


def latest_step(directory: str) -> int | None:
    """The newest committed step (a ``.tmp`` dir or a dir without a
    manifest does not count), or None."""
    if not os.path.isdir(directory):
        return None
    steps = [
        int(name.split("_")[1])
        for name in os.listdir(directory)
        if name.startswith("step_") and not name.endswith(".tmp")
        and os.path.exists(os.path.join(directory, name, "manifest.json"))
    ]
    return max(steps) if steps else None


def _from_host(arr: np.ndarray, stored: str, tmpl):
    if stored in _VIEW_AS:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    if isinstance(tmpl, torch.Tensor):
        return t.to(device=tmpl.device, dtype=tmpl.dtype)
    return int(t)


def _unflatten_like(template, flat: dict, prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten_like(v, flat, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(template))
    return flat[prefix]


def load_checkpoint(template, directory: str, step: int | None = None, shardings=None):
    """Restore into the structure of ``template`` (nested dicts and lists
    of tensors and ints): each array on its template leaf's device and in
    its dtype; with ``shardings`` only this rank's block of each array.
    Returns (tree, step). Raises KeyError for a template key the
    checkpoint lacks."""
    placed = _flatten(shardings) if shardings is not None else {}
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)["arrays"]
    out = {}
    for k, tmpl in _flatten(template).items():
        if k not in manifest:
            raise KeyError(f"checkpoint missing array {k!r}")
        sh = placed.get(k) if isinstance(tmpl, torch.Tensor) else None
        arr = np.load(os.path.join(d, manifest[k]["file"]), mmap_mode="r" if sh else None)
        if sh is not None:
            arr = np.ascontiguousarray(arr[sh.block_slices(arr.shape)])
        out[k] = _from_host(arr, manifest[k]["dtype"], tmpl)
    return _unflatten_like(template, out), step


class CheckpointManager:
    """Rolling checkpoints (the newest ``keep``), restart, async saves."""

    def __init__(self, directory: str, keep: int = 3, async_: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_ = async_
        self._pending: list = []

    def save(self, tree, step: int, shardings=None) -> None:
        self._pending.append(save_checkpoint(tree, self.directory, step, self.async_,
                                             shardings))
        if _rank(shardings) == 0:  # rank 0 alone writes and prunes
            self._gc()

    def wait(self) -> None:
        for join in self._pending:
            join()
        self._pending.clear()

    def restore(self, template, shardings=None, step: int | None = None):
        return load_checkpoint(template, self.directory, step, shardings)

    def latest(self) -> int | None:
        return latest_step(self.directory)

    def _gc(self) -> None:
        if not os.path.isdir(self.directory):
            return
        steps = sorted(
            int(n.split("_")[1])
            for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp")
        )
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)
