"""The JAX package's architectures, copied as data, plus the smoke variants.

Only ``tinyllama-1.1b`` runs through the port's model in this slice; the
others are here so configs can be read and compared, and the model raises
``NotImplementedError`` for the parts it lacks.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, XLSTMConfig

FULL_ATTN_SKIP = (
    ("long_500k",
     "pure full-attention arch: O(L^2) attention at 524288 tokens"),
)


def hubert_xlarge() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        d_model=1280, n_heads=16, n_kv_heads=16, d_ff=5120, vocab=504,
        pattern=("attn",), repeats=48,
        act="gelu", encoder_only=True, frontend="audio",
        rope_theta=10000.0, attn_bias=True,
        norm_eps=1e-5,
    )


def dbrx_132b() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b",
        d_model=6144, n_heads=48, n_kv_heads=8, d_ff=0, vocab=100352,
        pattern=("moe",), repeats=40,
        moe=MoEConfig(n_experts=16, top_k=4, d_ff=10752, normalize_topk=True),
        rope_theta=500000.0,
        skips=FULL_ATTN_SKIP,
    )


def qwen3_moe_30b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        d_model=2048, n_heads=32, n_kv_heads=4, d_ff=0, vocab=151936,
        head_dim=128,
        pattern=("moe",), repeats=48,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff=768, normalize_topk=True),
        rope_theta=1000000.0, qk_norm=True,
        skips=FULL_ATTN_SKIP,
    )


def zamba2_2p7b() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240, vocab=32000,
        pattern=("mamba2", "mamba2", "mamba2", "mamba2", "mamba2", "attn"),
        repeats=9,
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1),
        act="gelu",
        rope_theta=10000.0,
    )


def gemma2_2b() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        d_model=2304, n_heads=8, n_kv_heads=4, d_ff=9216, vocab=256000,
        head_dim=256,
        pattern=("local_attn", "attn"), repeats=13,
        window=4096, attn_softcap=50.0, final_softcap=30.0,
        act="geglu", tie_embeddings=True, embed_scale=True,
        zero_centered_norm=True, rope_theta=10000.0,
        sharding="fsdp",
        skips=FULL_ATTN_SKIP,
    )


def tinyllama_1b() -> ModelConfig:
    # [arXiv:2401.02385; hf] llama2-arch small
    return ModelConfig(
        name="tinyllama-1.1b",
        d_model=2048, n_heads=32, n_kv_heads=4, d_ff=5632, vocab=32000,
        pattern=("attn",), repeats=22,
        rope_theta=10000.0,
        skips=FULL_ATTN_SKIP,
    )


def glm4_9b() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b",
        d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696, vocab=151552,
        pattern=("attn",), repeats=40,
        rope_theta=10000.0, partial_rotary=0.5, attn_bias=True,
        norm_eps=1.5625e-7,
        skips=FULL_ATTN_SKIP,
    )


def command_r_35b() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b",
        d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22528, vocab=256000,
        pattern=("attn",), repeats=40,
        rope_theta=8000000.0, tie_embeddings=True,
        norm_eps=1e-5,
        skips=FULL_ATTN_SKIP,
    )


def llava_next_mistral_7b() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b",
        d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336, vocab=32000,
        pattern=("attn",), repeats=32,
        rope_theta=1000000.0,
        frontend="vlm", n_frontend_tokens=1152,
        skips=FULL_ATTN_SKIP,
    )


def xlstm_350m() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m",
        d_model=1024, n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304,
        pattern=("mlstm",) * 7 + ("slstm",), repeats=3,
        xlstm=XLSTMConfig(proj_factor=2.0, d_conv=4),
        act="geglu",
        rope_theta=0.0,
        sharding="fsdp",
    )


ARCHS = {
    "hubert-xlarge": hubert_xlarge,
    "dbrx-132b": dbrx_132b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b,
    "zamba2-2.7b": zamba2_2p7b,
    "gemma2-2b": gemma2_2b,
    "tinyllama-1.1b": tinyllama_1b,
    "glm4-9b": glm4_9b,
    "command-r-35b": command_r_35b,
    "llava-next-mistral-7b": llava_next_mistral_7b,
    "xlstm-350m": xlstm_350m,
}


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config, exactly as the JAX package reduces it."""
    cfg = ARCHS[name]()
    kw: dict = dict(
        d_model=128,
        n_heads=4,
        n_kv_heads=min(4, cfg.n_kv_heads),
        head_dim=32,
        d_ff=0 if cfg.d_ff == 0 else 256,
        vocab=512,
        repeats=2,
        q_chunk=64,
        kv_chunk=64,
        remat="none",
        n_frontend_tokens=16 if cfg.frontend == "vlm" else 0,
    )
    if cfg.moe:
        kw["moe"] = MoEConfig(
            n_experts=8, top_k=2, d_ff=64,
            normalize_topk=cfg.moe.normalize_topk,
            n_shared_experts=cfg.moe.n_shared_experts,
        )
    if cfg.ssm:
        kw["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=32)
    if cfg.xlstm:
        kw["xlstm"] = XLSTMConfig(proj_factor=2.0, d_conv=4, chunk=32)
    return cfg.replace(**kw)


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]()
