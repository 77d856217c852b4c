"""Data pipeline (``repro.data.pipeline``): deterministic, step-indexed.

``batch_at(step)`` is a pure function of (seed, step), drawn with numpy
exactly as the JAX package draws it, so the port's batches are bitwise the
JAX ones. It returns CPU tensors; the training loop moves them to the
device with ``non_blocking``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab: int
    accum_steps: int = 1
    seed: int = 0
    pad_fraction: float = 0.0   # expected fraction of padded tail per sample
    frontend_tokens: int = 0    # stub patch/frame embeddings (not ported)
    d_model: int = 0

    def __post_init__(self):
        if self.frontend_tokens:
            raise NotImplementedError("frontend stubs (vlm/audio) are not ported yet")


class SyntheticLM:
    """Synthetic LM token stream (shift-by-one labels, -1 padding)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> dict:
        """{"tokens", "labels"}: (accum_steps, global_batch, seq_len) int32."""
        c = self.cfg
        rng = np.random.default_rng((c.seed, step))
        shape = (c.accum_steps, c.global_batch, c.seq_len)
        toks = rng.integers(4, c.vocab, size=shape, dtype=np.int32)
        labels = np.roll(toks, -1, axis=-1).astype(np.int32)
        labels[..., -1] = -1
        if c.pad_fraction > 0:
            # random tail padding per sample -> real-token imbalance
            lens = rng.integers(
                int(c.seq_len * (1 - 2 * c.pad_fraction)), c.seq_len + 1,
                size=shape[:2],
            )
            idx = np.arange(c.seq_len)[None, None, :]
            pad_mask = idx >= lens[..., None]
            toks = np.where(pad_mask, 0, toks)
            labels = np.where(pad_mask, -1, labels)
        return {"tokens": torch.from_numpy(np.ascontiguousarray(toks, np.int32)),
                "labels": torch.from_numpy(np.ascontiguousarray(labels, np.int32))}
