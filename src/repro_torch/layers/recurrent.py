"""Parameter trees of the recurrent blocks (``repro.layers.recurrent``):
mamba2, mLSTM and sLSTM, declared leaf for leaf as the JAX package declares
them, so that the parameter count and ``models.flops`` are the JAX ones
for zamba2 and xLSTM. The blocks themselves are not ported yet (ROADMAP.md
Queue 1, item 7): ``configs.base.check_supported`` refuses them.
"""

from __future__ import annotations

import math

from repro_torch.layers.common import ParamSpec


def mamba2_params(cfg) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_inner = s.d_inner(d)
    h = s.n_heads(d)
    conv_ch = d_inner + 2 * s.n_groups * s.d_state
    return {
        "in_proj": ParamSpec((d, 2 * d_inner + 2 * s.n_groups * s.d_state + h)),
        "conv_w": ParamSpec((s.d_conv, conv_ch), scale=0.5),
        "conv_b": ParamSpec((conv_ch,), init="zeros"),
        "A_log": ParamSpec((h,), init="ones"),
        "D": ParamSpec((h,), init="ones"),
        "dt_bias": ParamSpec((h,), init="zeros"),
        "norm": ParamSpec((d_inner,), init="ones"),
        "out_proj": ParamSpec(
            (d_inner, d), scale=1.0 / (math.sqrt(d_inner) * math.sqrt(2 * cfg.n_layers))),
    }


def mlstm_params(cfg) -> dict:
    x = cfg.xlstm
    d = cfg.d_model
    di = x.d_inner(d)
    h = cfg.n_heads
    return {
        "up_proj": ParamSpec((d, 2 * di)),
        "conv_w": ParamSpec((x.d_conv, di), scale=0.5),
        "conv_b": ParamSpec((di,), init="zeros"),
        "wq": ParamSpec((di, di)),
        "wk": ParamSpec((di, di)),
        "wv": ParamSpec((di, di)),
        "w_if": ParamSpec((di, 2 * h), scale=0.02),
        "b_i": ParamSpec((h,), init="zeros"),
        "b_f": ParamSpec((h,), init="ones"),
        "norm": ParamSpec((di,), init="ones"),
        "down_proj": ParamSpec(
            (di, d), scale=1.0 / (math.sqrt(di) * math.sqrt(2 * cfg.n_layers))),
    }


def slstm_params(cfg) -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    return {
        "w_in": ParamSpec((d, 4 * d)),
        "r": ParamSpec((h, d // h, 4 * (d // h)), scale=0.02),
        "b": ParamSpec((4 * d,), init="zeros"),
        "norm": ParamSpec((d,), init="ones"),
    }
