"""Dense feed-forward layers (``repro.layers.ffn`` ``mlp_block``).

SwiGLU, GeGLU and GELU, with GELU's tanh approximation as in the JAX
package. The MoE block waits for a later slice (ROADMAP.md Queue 1, item
5); ``moe_params`` declares its tree so that the parameter count is the
JAX one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.layers.common import ParamSpec


def mlp_params(cfg, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    wo = ParamSpec((f, d), scale=1.0 / (math.sqrt(f) * math.sqrt(2 * cfg.n_layers)))
    if cfg.act in ("swiglu", "geglu"):
        return {"wi_gate": ParamSpec((d, f)), "wi_up": ParamSpec((d, f)), "wo": wo}
    return {"wi": ParamSpec((d, f)), "wo": wo}


def moe_params(cfg) -> dict:
    """The JAX ``moe_params`` tree (router, stacked experts, shared
    experts): declared, not run."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff, m.n_experts
    p = {
        "router": ParamSpec((d, e), scale=0.02),
        "wi_gate": ParamSpec((e, d, f)),
        "wi_up": ParamSpec((e, d, f)),
        "wo": ParamSpec((e, f, d), scale=1.0 / (math.sqrt(f) * math.sqrt(2 * cfg.n_layers))),
    }
    if m.n_shared_experts:
        p["shared"] = mlp_params(cfg, d_ff=m.d_ff * m.n_shared_experts)
    return p


def _act(name: str):
    return {
        "swiglu": F.silu,
        "geglu": lambda x: F.gelu(x, approximate="tanh"),
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[name]


def mlp_block(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    compute = cfg.compute_dtype
    act = _act(cfg.act)
    if "wi_gate" in params:
        g = x @ params["wi_gate"].to(compute)
        u = x @ params["wi_up"].to(compute)
        h = act(g) * u
    else:
        h = act(x @ params["wi"].to(compute))
    return h @ params["wo"].to(compute)
