"""The port's kernels against the JAX package's, on the same inputs.

On the CPU: the port's plain versions of paged decode attention, paged
prefill attention and RMSNorm against the JAX Pallas kernels run in
interpret mode, over the case tables of ``tests/test_kernels.py``; RoPE
and the paged write/read round trip against JAX. The hand-written kernels
against their plain versions on the card are in ``test_torch_cuda.py``.
Inputs are made with numpy from a seed and fed to both sides.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention.kernel import (  # noqa: E402
    paged_attention_pallas,
    paged_prefill_attention_pallas,
)
from repro.kernels.rmsnorm.kernel import rmsnorm_pallas  # noqa: E402
from repro_torch.kernels import cases  # noqa: E402
from repro_torch.kernels.paged_attention import ops as PA  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_reference,
    paged_prefill_attention_reference,
)
from repro_torch.kernels.rmsnorm import ops as RMS  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference  # noqa: E402

DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _jx(a, dtype=None):
    x = jnp.asarray(a)
    return x.astype(dtype) if dtype else x


def _th(a, dtype=None, device="cpu"):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype) if dtype else t.to(device)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=tol, rtol=tol)


def _f32(t):
    return t.detach().float().cpu().numpy()


# ---------------------------------------------------------------------------
# (a) plain versions vs the JAX Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


PAGED_JAX = cases.PAGED_CASES + cases.PAGED_SPLIT_CASES
PREFILL_JAX = cases.PREFILL_CASES + cases.PREFILL_SPLIT_CASES


@pytest.mark.parametrize("case", PAGED_JAX, ids=[str(c[:8]) for c in PAGED_JAX])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_decode_plain_matches_pallas(case, dtype):
    B, Hq, Hkv, D, psize, nL, P, lens, window, softcap = case
    c = cases.paged_case(B, Hq, Hkv, D, psize, nL, P, lens, seed=1)
    jd = jnp.dtype(dtype)
    out_j = paged_attention_pallas(
        _jx(c["q"], jd), _jx(c["k_pages"], jd), _jx(c["v_pages"], jd),
        _jx(c["block_tables"]), q_position=_jx(c["q_position"]),
        cache_len=_jx(c["cache_len"]), window=window, softcap=softcap,
        interpret=True,
    )
    td = TORCH_DT[dtype]
    out_t = paged_attention_reference(
        _th(c["q"], td), _th(c["k_pages"], td), _th(c["v_pages"], td),
        _th(c["block_tables"]), q_position=_th(c["q_position"]),
        cache_len=_th(c["cache_len"]), window=window, softcap=softcap,
    )
    assert tuple(out_t.shape) == tuple(out_j.shape) and out_t.dtype == td
    _close(_f32(out_t), out_j, TOL[dtype])


@pytest.mark.parametrize("case", PREFILL_JAX, ids=[str(c[:9]) for c in PREFILL_JAX])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_prefill_plain_matches_pallas(case, dtype):
    B, C, Hq, Hkv, D, psize, nL, P, starts, window, softcap = case
    c = cases.prefill_case(B, C, Hq, Hkv, D, psize, nL, P, starts, seed=2)
    jd = jnp.dtype(dtype)
    out_j = paged_prefill_attention_pallas(
        _jx(c["q"], jd), _jx(c["k_pages"], jd), _jx(c["v_pages"], jd),
        _jx(c["block_tables"]), q_positions=_jx(c["q_positions"]),
        cache_len=_jx(c["cache_len"]), causal=True, window=window,
        softcap=softcap, interpret=True,
    )
    td = TORCH_DT[dtype]
    out_t = paged_prefill_attention_reference(
        _th(c["q"], td), _th(c["k_pages"], td), _th(c["v_pages"], td),
        _th(c["block_tables"]), q_positions=_th(c["q_positions"]),
        cache_len=_th(c["cache_len"]), causal=True, window=window,
        softcap=softcap,
    )
    assert tuple(out_t.shape) == tuple(out_j.shape) and out_t.dtype == td
    _close(_f32(out_t), out_j, TOL[dtype])


@pytest.mark.parametrize("rows,d", cases.RMS_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("zero_centered", [False, True])
def test_rmsnorm_plain_matches_pallas(rows, d, dtype, zero_centered):
    c = cases.rms_case(rows, d, seed=3)
    out_j = rmsnorm_pallas(_jx(c["x"], jnp.dtype(dtype)), _jx(c["scale"]),
                           zero_centered=zero_centered, block_rows=64,
                           interpret=True)
    out_t = rmsnorm_reference(_th(c["x"], TORCH_DT[dtype]), _th(c["scale"]),
                              zero_centered=zero_centered)
    assert out_t.dtype == TORCH_DT[dtype]
    _close(_f32(out_t), out_j, TOL[dtype])


def test_cpu_wrappers_take_the_plain_versions():
    """On CPU tensors the public wrappers ARE the plain versions and count
    no kernel launch."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    c = cases.paged_case(*cases.PAGED_CASES[0][:8], seed=4)
    args = (_th(c["q"]), _th(c["k_pages"]), _th(c["v_pages"]), _th(c["block_tables"]))
    kw = dict(q_position=_th(c["q_position"]), cache_len=_th(c["cache_len"]))
    assert torch.equal(PA.paged_attention(*args, **kw),
                       paged_attention_reference(*args, **kw))
    r = cases.rms_case(3, 300, seed=4)
    assert torch.equal(RMS.rmsnorm(_th(r["x"]), _th(r["scale"])),
                       rmsnorm_reference(_th(r["x"]), _th(r["scale"])))
    assert set(launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# (b) layers: RoPE and the paged write/read round trip vs JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frac", [1.0, 0.5])
def test_apply_rope_matches_jax(frac):
    from repro.layers.attention import apply_rope as rope_j
    from repro_torch.layers.attention import apply_rope as rope_t

    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 500, size=(2, 7)).astype(np.int32)
    out_j = rope_j(_jx(x), _jx(pos), 10000.0, frac)
    out_t = rope_t(_th(x), _th(pos), 10000.0, frac)
    _close(_f32(out_t), out_j, 2e-5)
    if frac < 1.0:  # the unrotated half passes through untouched
        np.testing.assert_array_equal(_f32(out_t)[..., 32:], x[..., 32:])


@pytest.mark.parametrize("S", [1, 5])
def test_paged_write_read_roundtrip_matches_jax(S):
    """The paged branch of ``attention_block`` on both sides, on one pool and
    table: the in-place write lands (and drops masked, unallocated and
    out-of-table entries) where the JAX scatter does, and the read through
    the table (decode at S=1, prefill chunk at S>1) agrees."""
    from repro.configs import smoke_config as smoke_j
    from repro.layers.attention import attention_block as block_j
    from repro.layers.attention import attention_params as params_j
    from repro.layers.common import init_params as init_j
    from repro_torch.configs import smoke_config as smoke_t
    from repro_torch.convert import params_from_numpy
    from repro_torch.layers.attention import attention_block as block_t

    f32 = dict(compute_dtype_name="float32", param_dtype_name="float32")
    cfg_j = smoke_j("tinyllama-1.1b").replace(**f32)
    cfg_t = smoke_t("tinyllama-1.1b").replace(**f32)
    hkv, hd = cfg_j.n_kv_heads, cfg_j.head_dim_
    psize, P, nL = 4, 10, 4
    rng = np.random.default_rng(6)
    pool0 = {k: rng.standard_normal((P, psize, hkv, hd)).astype(np.float32)
             for k in ("k_pages", "v_pages")}
    x = rng.standard_normal((2, S, cfg_j.d_model)).astype(np.float32)
    start = np.asarray([0, 9], np.int32) if S > 1 else np.asarray([4, 13], np.int32)
    pos = (start[:, None] + np.arange(S)[None]).astype(np.int32)
    # row 0's logical page 1 is unallocated; row 1 runs past its table at S>1
    tbl = np.asarray([[3, -1, 7, 8], [0, 5, 2, 9]], np.int32)
    if S > 1:
        tbl[1, 3] = -1
    mask = np.ones((2, S), bool)
    mask[0, S // 2] = False
    cache_len = start + S
    params = {k: np.asarray(v) for k, v in
              init_j(params_j(cfg_j), jax.random.PRNGKey(3), jnp.float32).items()}

    out_j, new_j = block_j(
        {k: _jx(v) for k, v in params.items()}, _jx(x), cfg_j, positions=_jx(pos),
        cache={k: _jx(v) for k, v in pool0.items()}, cache_len=_jx(cache_len),
        seq_mask=_jx(mask), block_tables=_jx(tbl),
    )
    pools_t = {k: torch.cat([_th(v), torch.zeros((1, psize, hkv, hd))])
               for k, v in pool0.items()}  # + the spare page
    out_t = block_t(
        params_from_numpy(params), _th(x), cfg_t, positions=_th(pos),
        cache=pools_t, cache_len=_th(cache_len), seq_mask=_th(mask),
        block_tables=_th(tbl),
    )
    for k in pools_t:
        _close(pools_t[k][:P].numpy(), new_j[k], 2e-5)
        untouched = np.all(np.asarray(new_j[k]) == pool0[k], axis=(1, 2, 3))
        np.testing.assert_array_equal(pools_t[k][:P].numpy()[untouched],
                                      pool0[k][untouched])
    _close(out_t.numpy(), out_j, 2e-5)


def test_cuda_request_raises_without_a_card():
    """Entry points asked for CUDA never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.configs import smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models.transformer import Transformer

    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="cuda"):
        Transformer.from_init(smoke_config("tinyllama-1.1b"))
