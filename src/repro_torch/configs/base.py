"""Model configuration schema, field for field the JAX ``ModelConfig``.

The layer stack is ``pattern`` repeated ``repeats`` times. The port runs
every block kind (``attn``, ``local_attn``, ``moe``, ``mamba2``,
``mlstm``, ``slstm``), the qkv bias, qk-norm, the stub frontends (``vlm``
patch embeddings, ``audio`` frame embeddings) and encoder-only models.
``check_supported`` refuses what it does not know.
"""

from __future__ import annotations

import dataclasses
import math

import torch

BLOCK_KINDS = ("attn", "local_attn", "moe", "mamba2", "mlstm", "slstm")
# the block kinds each family config must accompany
_FAMILY = {"moe": "moe", "mamba2": "ssm", "mlstm": "xlstm", "slstm": "xlstm"}

# float64 runs only on the CPU (the kernels take bf16/f32): a reference
# for the fp32 paths' rounding
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; known: {sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    normalize_topk: bool = True
    gated: bool = True

    def capacity(self, n_tokens: int) -> int:
        """Slots per expert for a group of ``n_tokens``: ``top_k *
        capacity_factor`` times the even share, rounded up to a multiple of
        128, at least 128, never above ``n_tokens`` (a token's experts are
        distinct, so no expert sees more)."""
        c = math.ceil(n_tokens * self.top_k * self.capacity_factor / self.n_experts)
        return min(max(128, -(-c // 128) * 128), n_tokens)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    proj_factor: float = 2.0
    d_conv: int = 4
    chunk: int = 256
    slstm_ff_factor: float = 4.0 / 3.0

    def d_inner(self, d_model: int) -> int:
        return int(self.proj_factor * d_model)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    pattern: tuple[str, ...]
    repeats: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # attention details
    rope_theta: float = 10000.0
    partial_rotary: float = 1.0
    window: int | None = None
    attn_softcap: float | None = None
    final_softcap: float | None = None
    attn_bias: bool = False
    qk_norm: bool = False

    # families
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    xlstm: XLSTMConfig | None = None

    # model shape/behaviour
    encoder_only: bool = False
    frontend: str | None = None
    n_frontend_tokens: int = 0
    tie_embeddings: bool = False
    embed_scale: bool = False
    zero_centered_norm: bool = False
    act: str = "swiglu"
    norm_eps: float = 1e-6

    # numerics
    param_dtype_name: str = "bfloat16"
    compute_dtype_name: str = "bfloat16"

    # attention chunking knobs of the JAX flash path; the port's kernels
    # tile by their own block sizes and do not read them
    q_chunk: int = 512
    kv_chunk: int = 1024
    causal_skip: bool = False
    # paged attention implementation. The port routes by the tensor's
    # device (kernel on CUDA, plain version on the CPU) and accepts only
    # "auto"; the field stays for config parity with the JAX package.
    paged_attn_impl: str = "auto"

    # distribution (JAX-only knobs, carried as data), except remat: the
    # training forward checkpoints every layer when "full", and keeps the
    # outputs of its plain products when "dots"
    sharding: str = "megatron"
    remat: str = "full"
    scan_layers: bool = True

    skips: tuple[tuple[str, str], ...] = ()

    # training details
    z_loss: float = 1e-4
    moe_lb_coef: float = 0.01
    moe_z_coef: float = 1e-3

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.repeats

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype_name)

    @property
    def param_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype_name)

    @property
    def vocab_padded(self) -> int:
        """vocab rounded up to a multiple of 256, as in the JAX package."""
        return -(-self.vocab // 256) * 256

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        from repro_torch.layers.common import count_params
        from repro_torch.models.transformer import model_params

        return count_params(model_params(self))

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        total = self.param_count()
        if self.moe is None:
            return total
        m = self.moe
        per_expert = 3 * self.d_model * m.d_ff if m.gated else 2 * self.d_model * m.d_ff
        n_moe_layers = sum(1 for k in self.pattern if k == "moe") * self.repeats
        return total - n_moe_layers * per_expert * (m.n_experts - m.top_k)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run: an
    unknown block kind, a block kind without its family config (``moe``,
    ``ssm``, ``xlstm``), a frontend other than the ``vlm`` and ``audio``
    stubs, or a ``paged_attn_impl`` other than ``"auto"``."""
    kinds = sorted(set(cfg.pattern) - set(BLOCK_KINDS))
    if kinds:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {kinds} are not ported (the port runs {BLOCK_KINDS})"
        )
    for kind in sorted(set(cfg.pattern) & set(_FAMILY)):
        if getattr(cfg, _FAMILY[kind]) is None:
            raise NotImplementedError(
                f"{cfg.name}: block kind {kind!r} needs its {_FAMILY[kind]} config")
    if cfg.frontend not in (None, "vlm", "audio"):
        raise NotImplementedError(f"{cfg.name}: frontend {cfg.frontend!r} is not ported")
    if cfg.paged_attn_impl != "auto":
        raise NotImplementedError(
            f"paged_attn_impl={cfg.paged_attn_impl!r}: the port routes by "
            f"device and takes only 'auto'"
        )
