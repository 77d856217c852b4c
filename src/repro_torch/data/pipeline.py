"""Data pipeline (``repro.data.pipeline``): deterministic, step-indexed.

``batch_at(step)`` is a pure function of (seed, step), drawn with numpy
exactly as the JAX package draws it, so the port's batches are bitwise the
JAX ones. It returns CPU tensors; the training loop moves them to the
device with ``non_blocking``. ``batch_specs`` gives the inputs' shapes and
dtypes as meta tensors, for counting a step without its data.
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
    frontend_tokens: int = 0    # stub patch embeddings prepended (vlm)
    d_model: int = 0            # for frontend stubs


class SyntheticLM:
    """Synthetic LM token stream (shift-by-one labels, -1 padding)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> dict:
        """{"tokens", "labels"}: (accum_steps, global_batch, seq_len) int32.
        With ``frontend_tokens`` F (the vlm stub) the text is ``seq_len - F``
        tokens, ``"frontend"`` (A, B, F, d_model) bf16 patch embeddings
        (N(0, 1) * 0.02) come first, and the labels are -1 over them."""
        c = self.cfg
        rng = np.random.default_rng((c.seed, step))
        text_len = c.seq_len - c.frontend_tokens
        shape = (c.accum_steps, c.global_batch, text_len)
        toks = rng.integers(4, c.vocab, size=shape, dtype=np.int32)
        labels = np.roll(toks, -1, axis=-1).astype(np.int32)
        labels[..., -1] = -1
        if c.pad_fraction > 0:
            # random tail padding per sample -> real-token imbalance
            lens = rng.integers(
                int(text_len * (1 - 2 * c.pad_fraction)), text_len + 1,
                size=shape[:2],
            )
            idx = np.arange(text_len)[None, None, :]
            pad_mask = idx >= lens[..., None]
            toks = np.where(pad_mask, 0, toks)
            labels = np.where(pad_mask, -1, labels)
        out = {"tokens": torch.from_numpy(np.ascontiguousarray(toks, np.int32))}
        if c.frontend_tokens:
            fe = rng.standard_normal(
                (c.accum_steps, c.global_batch, c.frontend_tokens, c.d_model),
                dtype=np.float32,
            ) * 0.02
            out["frontend"] = torch.from_numpy(fe).to(torch.bfloat16)
            # frontend positions carry no labels
            pad = np.full((c.accum_steps, c.global_batch, c.frontend_tokens), -1, np.int32)
            labels = np.concatenate([pad, labels], axis=-1)
        out["labels"] = torch.from_numpy(np.ascontiguousarray(labels, np.int32))
        return out


def batch_specs(cfg, shape, mode: str = "train") -> dict:
    """Stand-ins for every model input (JAX ``batch_specs``): meta tensors
    (``torch.empty(..., device="meta")``, nothing allocated) with JAX's
    keys, shapes and dtypes. ``cfg``: ModelConfig; ``shape``: InputShape
    (``configs.shapes``); ``mode``: train (an accumulation axis of 1
    first), prefill or decode ((B, 1) tokens). The vlm's text is the
    sequence less its patches; the audio model takes frames and no
    tokens."""
    B, S = shape.global_batch, shape.seq_len
    fe, d = cfg.n_frontend_tokens, cfg.d_model

    def spec(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    lead = (1,) if mode == "train" else ()
    text = S - (fe if cfg.frontend == "vlm" else 0)
    out = {}
    if mode in ("train", "prefill"):
        if cfg.frontend == "audio":
            out["frontend"] = spec(lead + (B, S, d), torch.bfloat16)
        elif cfg.frontend == "vlm":
            out["frontend"] = spec(lead + (B, fe, d), torch.bfloat16)
            out["tokens"] = spec(lead + (B, text), torch.int32)
        else:
            out["tokens"] = spec(lead + (B, S), torch.int32)
        if mode == "train":
            out["labels"] = spec(lead + (B, S), torch.int32)
    elif mode == "decode":
        out["tokens"] = spec((B, 1), torch.int32)
    else:
        raise ValueError(mode)
    return out
