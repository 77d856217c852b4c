"""Model assembly (``repro.models.transformer``) for training and serving.

The layer stack is ``cfg.pattern`` repeated ``cfg.repeats`` times; the
parameter tree is the JAX package's, stacked over repeats, and a Python
loop over repeats takes the place of the ``scan``. The port runs the
``attn`` block kind, cache-less for training and over the paged KV pool
for serving:

  model_params(cfg)                      ParamSpec tree
  Transformer.from_init(cfg, seed)       seeded weights (port's initializer)
  Transformer(cfg, params)               weights from a tree of tensors
  model.forward(batch)                   (loss, aux): training/eval loss
  model.apply_logits(batch)              (logits, aux): full-sequence logits
  model.init_cache(batch, max_len, ...)  paged pools (R, P+1, page, Hkv, hd)
  model.prefill_chunk(tokens, ...)       incremental prefill at per-row offsets
  model.decode_step(tokens, pos, ...)    one-token step, per-slot positions
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import check_supported
from repro_torch.device import resolve_device
from repro_torch.layers import attention as A
from repro_torch.layers import ffn as FFN
from repro_torch.layers.common import (
    ParamSpec,
    init_params,
    tree_leaves,
    tree_map,
    unflatten,
)
from repro_torch.layers.norms import rmsnorm, rmsnorm_params


# ---------------------------------------------------------------------------
# parameter declaration
# ---------------------------------------------------------------------------


def _slot_params(cfg, kind: str) -> dict:
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    return {
        "norm_in": rmsnorm_params(cfg.d_model),
        "attn": A.attention_params(cfg),
        "norm_mlp": rmsnorm_params(cfg.d_model),
        "mlp": FFN.mlp_params(cfg),
    }


def _stack(tree, n: int):
    return tree_map(
        lambda s: ParamSpec((n,) + s.shape, s.init, s.scale, s.dtype), tree
    )


def model_params(cfg) -> dict:
    check_supported(cfg)
    d, v = cfg.d_model, cfg.vocab_padded
    params: dict = {"embed": ParamSpec((v, d), scale=0.02)}
    params["slots"] = {
        f"slot{i}_{kind}": _stack(_slot_params(cfg, kind), cfg.repeats)
        for i, kind in enumerate(cfg.pattern)
    }
    params["norm_f"] = rmsnorm_params(d)
    if not cfg.tie_embeddings or cfg.encoder_only:
        params["head"] = ParamSpec((d, v), scale=1.0 / math.sqrt(d))
    return params


def _attr_name(path: str) -> str:
    return path.replace("/", "__")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


class Transformer(nn.Module):
    """Decoder-only transformer. Weights are ``nn.Parameter``s named after
    their path in the JAX parameter tree (``slots/slot0_attn/attn/wq`` ->
    ``slots__slot0_attn__attn__wq``), stacked over repeats as in JAX, so
    autograd has one leaf per tree leaf. A tensor handed in on the target
    device is used as it is, not copied."""

    def __init__(self, cfg, params: dict, device=None):
        super().__init__()
        check_supported(cfg)
        if cfg.encoder_only:
            raise NotImplementedError(f"{cfg.name} is encoder-only: no decode path")
        self.cfg = cfg
        dev = resolve_device(device)
        expected = {p: s.shape for p, s in tree_leaves(model_params(cfg))}
        got = dict(tree_leaves(params))
        if set(got) != set(expected):
            raise ValueError(
                f"parameter tree mismatch: missing {sorted(set(expected) - set(got))}, "
                f"unexpected {sorted(set(got) - set(expected))}"
            )
        self._paths = sorted(expected)
        for path in self._paths:
            t = got[path]
            if tuple(t.shape) != tuple(expected[path]):
                raise ValueError(f"{path}: shape {tuple(t.shape)} != {expected[path]}")
            self.register_parameter(_attr_name(path), nn.Parameter(t.detach().to(dev)))

    @classmethod
    def from_init(cls, cfg, seed: int = 0, device=None) -> "Transformer":
        """Seeded weights from the port's initializer, drawn on the CPU (the
        same weights on every device), stored in the config's param dtype."""
        dev = resolve_device(device)
        gen = torch.Generator(device="cpu").manual_seed(seed)
        params = init_params(model_params(cfg), gen, cfg.param_dtype, dev)
        return cls(cfg, params, dev)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def named_params(self) -> dict[str, nn.Parameter]:
        """``{path: parameter}`` in sorted path order (the JAX leaf order)."""
        return {p: getattr(self, _attr_name(p)) for p in self._paths}

    def params(self) -> dict:
        return unflatten(self.named_params())

    # -- caches ---------------------------------------------------------

    def init_cache(self, batch: int, max_len: int, *, page_size: int = 16,
                   num_pages: int | None = None, dtype=None) -> dict:
        """Paged pools per attention slot, ``(R, P+1, page, Hkv, hd)``: P pages
        for the allocator plus the spare that takes dropped writes (see
        ``layers.attention``). ``num_pages`` defaults to dense-equivalent
        capacity, ``ceil(batch*max_len/page_size)``."""
        cfg = self.cfg
        dtype = dtype or cfg.compute_dtype
        if num_pages is None:
            num_pages = -(-batch * max_len // page_size)
        shape = (cfg.repeats, num_pages + 1, page_size, cfg.n_kv_heads, cfg.head_dim_)
        return {
            f"slot{i}_{kind}": {"attn": {
                "k_pages": torch.zeros(shape, dtype=dtype, device=self.device),
                "v_pages": torch.zeros(shape, dtype=dtype, device=self.device),
            }}
            for i, kind in enumerate(cfg.pattern)
        }

    # -- pieces ---------------------------------------------------------

    def _embed_inputs(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = self.embed[tokens.long()].to(cfg.compute_dtype)
        if cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.compute_dtype)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        head = self.embed.T if cfg.tie_embeddings else self.head
        logits = x @ head.to(cfg.compute_dtype)
        if cfg.final_softcap:
            logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
        return logits

    def _final_norm(self, x):
        cfg = self.cfg
        return rmsnorm(x, self.norm_f__scale, cfg.norm_eps, cfg.zero_centered_norm)

    def _apply_slot(self, sp: dict, x, *, positions, cache, cache_len, seq_mask,
                    block_tables):
        """One ``attn`` block: pre-norm attention + pre-norm MLP, residuals."""
        cfg = self.cfg
        h = rmsnorm(x, sp["norm_in"]["scale"], cfg.norm_eps, cfg.zero_centered_norm)
        x = x + A.attention_block(
            sp["attn"], h, cfg, positions=positions,
            cache=None if cache is None else cache["attn"],
            cache_len=cache_len, block_tables=block_tables, seq_mask=seq_mask,
            causal=True,
        )
        h2 = rmsnorm(x, sp["norm_mlp"]["scale"], cfg.norm_eps, cfg.zero_centered_norm)
        return x + FFN.mlp_block(sp["mlp"], h2, cfg)

    def _run_stack(self, x, caches, *, positions, cache_len, seq_mask,
                   block_tables):
        """Pattern x repeats. Each stacked leaf is unbound over repeats once
        (views; the backward stacks the per-layer gradients in one op
        rather than scattering into the stacked leaf once per layer). With
        ``caches`` None and ``cfg.remat == "full"``, every layer runs under
        ``torch.utils.checkpoint`` (non-reentrant) while autograd records,
        as ``jax.checkpoint`` wraps the scanned layer body."""
        cfg = self.cfg
        if cfg.remat not in ("none", "full"):
            raise NotImplementedError(f"remat={cfg.remat!r}: the port has 'none' and 'full'")
        remat = caches is None and cfg.remat == "full" and torch.is_grad_enabled()
        slots = {name: tree_map(lambda t: t.unbind(0), sp)
                 for name, sp in self.params()["slots"].items()}
        for r in range(cfg.repeats):
            for name, sp in slots.items():
                layer = tree_map(lambda t: t[r], sp)
                cache = None if caches is None else tree_map(lambda t: t[r], caches[name])
                kw = dict(positions=positions, cache=cache, cache_len=cache_len,
                          seq_mask=seq_mask, block_tables=block_tables)
                if remat:
                    x = checkpoint(self._apply_slot, layer, x, use_reentrant=False, **kw)
                else:
                    x = self._apply_slot(layer, x, **kw)
        return x

    def _per_row(self, x, B: int) -> torch.Tensor:
        """() or (B,) ints -> (B,) int32 on the model's device. Host values
        go up with ``non_blocking``: a blocking upload would wait for the
        whole queue of in-flight work on the stream."""
        t = x if isinstance(x, torch.Tensor) else torch.tensor(x, dtype=torch.int32)
        return t.to(self.device, torch.int32, non_blocking=True).reshape(-1).expand(B)

    def _chunk_loss(self, xi, li, z_coef: float):
        logits = self._logits(xi)
        logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, li.clamp(min=0).long()[..., None])[..., 0]
        w = (li >= 0).to(logits.dtype)
        nll = (lse - gold) * w
        zl = z_coef * lse**2 * w if z_coef else 0.0
        return torch.sum(nll + zl), torch.sum(w)

    def cross_entropy(self, x, labels, *, seq_chunk: int = 512,
                      z_loss: float | None = None):
        """Chunked CE over the sequence: never materializes (B,S,V) logits.
        labels: (B,S) int; negative labels are masked out; the log-sum-exp
        runs over the padded vocabulary, with the z-loss ``z_loss *
        lse**2``. Each chunk is checkpointed (its logits are recomputed in
        the backward), as the JAX scan's ``jax.checkpoint`` does. Returns
        (loss_sum, weight_sum) in fp32 (float64 for a float64 model)."""
        B, S, _ = x.shape
        z_coef = self.cfg.z_loss if z_loss is None else z_loss
        c = min(seq_chunk, S)
        n = -(-S // c)
        if n * c > S:
            x = nn.functional.pad(x, (0, 0, 0, n * c - S))
            labels = nn.functional.pad(labels, (0, n * c - S), value=-1)
        acc = torch.promote_types(x.dtype, torch.float32)
        loss_sum = torch.zeros((), dtype=acc, device=x.device)
        w_sum = torch.zeros((), dtype=acc, device=x.device)
        for i in range(n):
            xi, li = x[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
            if torch.is_grad_enabled():
                ls, ws = checkpoint(self._chunk_loss, xi, li, z_coef, use_reentrant=False)
            else:
                ls, ws = self._chunk_loss(xi, li, z_coef)
            loss_sum, w_sum = loss_sum + ls, w_sum + ws
        return loss_sum, w_sum

    def _full_sequence(self, tokens) -> torch.Tensor:
        """Embed, run the stack cache-less at positions 0..S-1, final norm."""
        x = self._embed_inputs(tokens.to(self.device, non_blocking=True))
        B, S, _ = x.shape
        positions = torch.arange(S, dtype=torch.int32, device=self.device)[None].expand(B, S)
        x = self._run_stack(x, None, positions=positions, cache_len=None,
                            seq_mask=None, block_tables=None)
        return self._final_norm(x)

    # -- entry points -----------------------------------------------------

    def forward(self, batch: dict):
        """Training/eval forward: ``batch`` {"tokens": (B,S), "labels": (B,S)}
        (moved to the model's device). Returns (loss, aux): the mean CE
        plus z-loss over labelled tokens, and aux {"tokens": their count}."""
        x = self._full_sequence(batch["tokens"])
        labels = batch["labels"].to(self.device, non_blocking=True)
        loss_sum, w_sum = self.cross_entropy(x, labels)
        return loss_sum / torch.clamp(w_sum, min=1.0), {"tokens": w_sum}

    def apply_logits(self, batch: dict):
        """Full-sequence logits (B,S,V) (small-model/eval path; materializes
        them). Returns (logits, aux)."""
        return self._logits(self._full_sequence(batch["tokens"])), {}

    @torch.inference_mode()
    def prefill_chunk(self, tokens, caches, start, length, block_tables,
                      all_logits: bool = False):
        """One chunk of an incremental prefill: ``tokens`` (B,C) at positions
        ``start .. start+C``; ``length`` () or (B,) valid tokens (the rest is
        padding that writes nothing). Writes the pools in place and attends
        against everything written so far through ``block_tables`` (B,nL).
        Returns logits (B,V) at each row's last valid position, or (B,C,V)
        with ``all_logits``."""
        x = self._embed_inputs(tokens)
        B, C, _ = x.shape
        start = self._per_row(start, B)
        length = self._per_row(length, B)
        offs = torch.arange(C, dtype=torch.int32, device=self.device)[None, :]
        seq_mask = offs < length[:, None]
        positions = start[:, None] + offs
        x = self._run_stack(x, caches, positions=positions, cache_len=start + length,
                            seq_mask=seq_mask, block_tables=block_tables)
        x = self._final_norm(x)
        if all_logits:
            return self._logits(x)
        idx = (length - 1).clamp(min=0).long()[:, None, None].expand(B, 1, x.shape[-1])
        return self._logits(torch.gather(x, 1, idx))[:, 0]

    @torch.inference_mode()
    def decode_step(self, tokens, pos, caches, active=None, block_tables=None):
        """One decode step. tokens: (B,1); pos: () or (B,) per-slot positions;
        ``active`` (B,) bool: inactive slots write nothing. Returns (B,V)."""
        if block_tables is None:
            raise NotImplementedError("only the paged cache is ported")
        x = self._embed_inputs(tokens)
        B = x.shape[0]
        pos = self._per_row(pos, B)
        positions = pos.reshape(B, 1)
        seq_mask = None if active is None else active.to(
            self.device, non_blocking=True).reshape(B, 1)
        x = self._run_stack(x, caches, positions=positions, cache_len=pos + 1,
                            seq_mask=seq_mask, block_tables=block_tables)
        return self._logits(self._final_norm(x))[:, 0]
