"""Analytic model FLOPs (the MODEL_FLOPS term of §Roofline): the port's
copy of ``repro.models.flops``, so a port record's ``model_flops`` is the
number the JAX record carries for the same configuration and batch.

6*N_active*tokens for training matmuls (2 fwd + 4 bwd) plus the
sequence-mixing quadratic terms; 2*N_active per token for inference.
Deliberately *useful*-work-only: no remat, no padding, no dropped-token
waste — the MODEL_FLOPS/HLO_FLOPs ratio then exposes exactly that waste.
"""

from __future__ import annotations


def _attn_layers(cfg) -> int:
    return sum(1 for k in cfg.pattern if k in ("attn", "local_attn", "moe")) * cfg.repeats


def _attention_fwd_flops(cfg, batch: int, seq: int) -> float:
    """Scores + AV einsums, honoring causality and sliding windows."""
    total = 0.0
    hq, hd = cfg.n_heads, cfg.head_dim_
    for kind in cfg.pattern:
        if kind not in ("attn", "local_attn", "moe"):
            continue
        if kind == "local_attn" and cfg.window:
            eff = min(cfg.window, seq)
            pairs = batch * seq * eff  # each query sees <= window keys
        else:
            pairs = batch * seq * seq * (0.5 if not cfg.encoder_only else 1.0)
        total += 4.0 * pairs * hq * hd  # qk + av, 2 flops per MAC
    return total * cfg.repeats


def _recurrent_fwd_flops(cfg, batch: int, seq: int) -> float:
    total = 0.0
    for kind in cfg.pattern:
        if kind == "mamba2" and cfg.ssm:
            s = cfg.ssm
            h = s.n_heads(cfg.d_model)
            p, n, L = s.head_dim, s.d_state, min(s.chunk, seq)
            # intra-chunk quadratic + state outer products/contractions
            total += 4.0 * batch * seq * L * h * 0.5 * (p + n)
            total += 4.0 * batch * seq * h * p * n
        elif kind == "mlstm" and cfg.xlstm:
            di = cfg.xlstm.d_inner(cfg.d_model)
            h = cfg.n_heads
            p = di // h
            L = min(cfg.xlstm.chunk, seq)
            total += 4.0 * batch * seq * L * h * 0.5 * p  # intra-chunk qk/av
            total += 4.0 * batch * seq * h * p * p        # state update/query
        elif kind == "slstm":
            total += 8.0 * batch * seq * cfg.d_model      # recurrent matvecs
    return total * cfg.repeats


def train_step_model_flops(cfg, labels_shape) -> float:
    """labels_shape: (A, B, S) or (B, S)."""
    if len(labels_shape) == 3:
        A, B, S = labels_shape
    else:
        A, B, S = 1, *labels_shape
    tokens = A * B * S
    n_active = cfg.active_param_count()
    matmul = 6.0 * n_active * tokens
    mixing = 3.0 * (_attention_fwd_flops(cfg, A * B, S) + _recurrent_fwd_flops(cfg, A * B, S))
    return matmul + mixing


def prefill_model_flops(cfg, batch: int, seq: int) -> float:
    n_active = cfg.active_param_count()
    return 2.0 * n_active * batch * seq + _attention_fwd_flops(cfg, batch, seq) + _recurrent_fwd_flops(cfg, batch, seq)


def decode_model_flops(cfg, batch: int, cache_len: int) -> float:
    """One new token per sequence against a cache of ``cache_len``."""
    n_active = cfg.active_param_count()
    flops = 2.0 * n_active * batch
    hq, hd = cfg.n_heads, cfg.head_dim_
    for kind in cfg.pattern:
        if kind in ("attn", "local_attn", "moe"):
            eff = min(cfg.window, cache_len) if (kind == "local_attn" and cfg.window) else cache_len
            flops += 4.0 * batch * eff * hq * hd * cfg.repeats
        elif kind == "mamba2" and cfg.ssm:
            s = cfg.ssm
            flops += 4.0 * batch * s.n_heads(cfg.d_model) * s.head_dim * s.d_state * cfg.repeats
        elif kind == "mlstm" and cfg.xlstm:
            di = cfg.xlstm.d_inner(cfg.d_model)
            p = di // cfg.n_heads
            flops += 4.0 * batch * cfg.n_heads * p * p * cfg.repeats
    return flops


def decode_model_bytes(cfg, batch: int, cache_len: int) -> float:
    """Minimal HBM traffic for one decode step: read active params once +
    read the visible KV/state cache once (the bandwidth roofline for
    decode cells; activations are negligible at S=1)."""
    param_bytes = 2.0 * cfg.active_param_count()  # bf16
    cache_bytes = 0.0
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    for kind in cfg.pattern:
        if kind in ("attn", "local_attn", "moe"):
            eff = min(cfg.window, cache_len) if (kind == "local_attn" and cfg.window) else cache_len
            cache_bytes += 2.0 * batch * eff * hkv * hd * 2  # k+v bf16
        elif kind == "mamba2" and cfg.ssm:
            ssm = cfg.ssm
            cache_bytes += 4.0 * batch * ssm.n_heads(cfg.d_model) * ssm.head_dim * ssm.d_state
        elif kind == "mlstm" and cfg.xlstm:
            di = cfg.xlstm.d_inner(cfg.d_model)
            p = di // cfg.n_heads
            cache_bytes += 4.0 * batch * cfg.n_heads * p * p
        elif kind == "slstm":
            cache_bytes += 4.0 * 4 * batch * cfg.d_model
    cache_bytes *= cfg.repeats
    return param_bytes + cache_bytes
