"""The hand-written kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where torch sees no GPU (the
decision is made when the test runs, in the ``cuda`` fixture). The file
imports no JAX, so it runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Cases are the JAX package's kernel case tables plus the serving and
training paths' shapes at tinyllama-1.1b's full width and at the other
archs' (``cases.*_ARCH_*``: the MoE archs' too, K3/K4 at dbrx's GQA group
of 6 and qwen3's of 8 at head dim 128, K1 at qwen3's qk-norm rows of 128,
K2 at qwen3's training shape; the recurrent archs' too: zamba2's K2-K4 at
head dim 80 and G 1, its speculative verify at C 5 with an idle slot, K1
at the mamba2 gated norm's width 5120 and xlstm's widths). Tolerances: paged
attention and forwards f32 1e-4 (the kernels sum in another order than the
plain versions), bf16 2e-2; the training kernels' outputs and gradients
f32 1e-4 and bf16 2e-2 of the largest |value| (at least of 1): bf16 keeps
~3 significant digits, so one rounding of a value near 16 is 0.06; flash
attention's also within ``cases.TOL_L2`` of the relative L2 error, paged
attention's within ``cases.TOL_L2_PAGED``, RMSNorm's (the tests added with
its CUDA kernels) within ``cases.TOL_L2_RMS``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import cases, nan_check  # noqa: E402
from repro_torch.kernels.paged_attention import ops as PA  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_reference,
    paged_prefill_attention_reference,
)
from repro_torch.kernels.rmsnorm import ops as RMS  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FA  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_backward_reference,
    flash_attention_reference,
)
from repro_torch.kernels.rmsnorm.ref import (  # noqa: E402
    rmsnorm_backward_reference,
    rmsnorm_reference,
)

DTYPES = ["float32", "bfloat16"]
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _th(a, dtype=None, device="cpu"):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype) if dtype else t.to(device)


def _f32(t):
    return t.detach().float().cpu().numpy()


def _close(a, b, tol):
    np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, not at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


PAGED_ALL = (cases.PAGED_CASES + cases.PAGED_SPLIT_CASES + [cases.MAIN_PAGED]
             + cases.PAGED_ARCH_CASES)
PREFILL_ALL = (cases.PREFILL_CASES + cases.PREFILL_SPLIT_CASES + [cases.MAIN_PREFILL]
               + cases.PREFILL_ARCH_CASES)


def _paged_args(case, dtype, cuda, seed):
    """Decode inputs on the card and the wrapper's keyword arguments."""
    B, Hq, Hkv, D, psize, nL, P, lens, window, softcap = case
    c = cases.paged_case(B, Hq, Hkv, D, psize, nL, P, lens, seed=seed)
    td = TORCH_DT[dtype]
    args = [_th(c[k], td, cuda) for k in ("q", "k_pages", "v_pages")]
    args.append(_th(c["block_tables"], None, cuda))
    kw = dict(q_position=_th(c["q_position"], None, cuda),
              cache_len=_th(c["cache_len"], None, cuda),
              window=window, softcap=softcap)
    return args, kw


def _prefill_args(case, dtype, cuda, seed):
    """Prefill inputs on the card and the wrapper's keyword arguments."""
    B, C, Hq, Hkv, D, psize, nL, P, starts, window, softcap, lengths = cases.prefill_row(case)
    c = cases.prefill_case(B, C, Hq, Hkv, D, psize, nL, P, starts, seed=seed, lengths=lengths)
    td = TORCH_DT[dtype]
    args = [_th(c[k], td, cuda) for k in ("q", "k_pages", "v_pages")]
    args.append(_th(c["block_tables"], None, cuda))
    kw = dict(q_positions=_th(c["q_positions"], None, cuda),
              cache_len=_th(c["cache_len"], None, cuda),
              causal=True, window=window, softcap=softcap)
    return args, kw


def _paged_close(got, want, dtype):
    """Paged attention's gates: elementwise within 1e-4 (f32) / 2e-2 (bf16),
    and the relative L2 error within ``cases.TOL_L2_PAGED``."""
    _close(got, want, 1e-4 if dtype == "float32" else 2e-2)
    assert cases.l2_rel_err(got, want) <= cases.TOL_L2_PAGED[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("case", PAGED_ALL, ids=[str(c[:8]) for c in PAGED_ALL])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_decode_kernel_matches_plain(cuda, case, dtype):
    args, kw = _paged_args(case, dtype, cuda, seed=7)
    out = PA.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    _paged_close(_f32(out), _f32(paged_attention_reference(*args, **kw)), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", PREFILL_ALL, ids=[str(c[:9]) for c in PREFILL_ALL])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_prefill_kernel_matches_plain(cuda, case, dtype):
    args, kw = _prefill_args(case, dtype, cuda, seed=8)
    out = PA.paged_prefill_attention(*args, **kw)
    torch.cuda.synchronize()
    _paged_close(_f32(out), _f32(paged_prefill_attention_reference(*args, **kw)), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,case", [("decode", c) for c in PAGED_ALL]
                         + [("prefill", c) for c in PREFILL_ALL],
                         ids=[f"decode{c[:8]}" for c in PAGED_ALL]
                         + [f"prefill{c[:9]}" for c in PREFILL_ALL])
def test_paged_tensor_core_route_is_bitwise_repeatable(cuda, kind, case):
    """The splits are combined in split order, whichever block arrives last:
    two bf16 calls give bitwise-equal outputs."""
    if kind == "decode":
        args, kw = _paged_args(case, "bfloat16", cuda, seed=9)
        outs = [PA.paged_attention(*args, **kw) for _ in range(2)]
    else:
        args, kw = _prefill_args(case, "bfloat16", cuda, seed=9)
        outs = [PA.paged_prefill_attention(*args, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_idle_slot_writes_zeros(cuda, dtype):
    """A decode slot with cache_len 0 sees no key: its rows are exactly 0,
    whatever the other slots hold (PAGED_SPLIT_CASES[0]: 0, 1, 63, 512)."""
    case = cases.PAGED_SPLIT_CASES[0]
    args, kw = _paged_args(case, dtype, cuda, seed=10)
    out = PA.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert case[7][0] == 0
    assert torch.count_nonzero(out[0]) == 0 and torch.count_nonzero(out[1:]) > 0


VERIFY_CASE = next(c for c in cases.PREFILL_SPLIT_CASES if len(c) == 12)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_verify_idle_slot_and_ragged_lengths(cuda, dtype):
    """The speculative verify's K4 call (16 rows of 5 positions, ragged
    lengths): the idle row (length 0 at start 0) is exactly 0; released as
    the scheduler leaves it (table -1, a stale start of 300), it changes
    no other row, bitwise, and every row stays within the gates."""
    args, kw = _prefill_args(VERIFY_CASE, dtype, cuda, seed=12)
    out = PA.paged_prefill_attention(*args, **kw)
    assert VERIFY_CASE[11][0] == 0 and VERIFY_CASE[8][0] == 0
    assert torch.count_nonzero(out[0]) == 0 and torch.count_nonzero(out[1:]) > 0
    tables, qpos, lens = args[3].clone(), kw["q_positions"].clone(), kw["cache_len"].clone()
    tables[0] = -1
    qpos[0] += 300
    lens[0] = 300
    args2 = (*args[:3], tables)
    kw2 = dict(kw, q_positions=qpos, cache_len=lens)
    stale = PA.paged_prefill_attention(*args2, **kw2)
    torch.cuda.synchronize()
    assert torch.equal(stale[1:], out[1:])
    _paged_close(_f32(stale), _f32(paged_prefill_attention_reference(*args2, **kw2)), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_dtype_launches_its_own_route(cuda, dtype):
    """bf16 launches the tensor-core kernels, f32 the CUDA-core kernels:
    one decode and one prefill launch on its route, none on the other."""
    before = dict(PA.ROUTE_LAUNCHES)
    args, kw = _paged_args(cases.MAIN_PAGED, dtype, cuda, seed=11)
    PA.paged_attention(*args, **kw)
    args, kw = _prefill_args(cases.MAIN_PREFILL, dtype, cuda, seed=11)
    PA.paged_prefill_attention(*args, **kw)
    torch.cuda.synchronize()
    moved = {r: PA.ROUTE_LAUNCHES[r] - before[r] for r in before}
    want = PA.route(TORCH_DT[dtype])
    assert moved == {r: (2 if r == want else 0) for r in before}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_paged_launches_report_their_cost_to_a_listening_sink(cuda, kind):
    """While ``core.profile`` counts a step, each paged launch reports
    ``launch_costs`` of its inputs (the serving record's K3/K4 FLOPs and
    bytes); with no sink listening it reports nothing."""
    from repro_torch import kernels as K

    got = []
    if kind == "decode":
        args, kw = _paged_args(cases.MAIN_PAGED, "bfloat16", cuda, seed=12)
        call = lambda: PA.paged_attention(*args, **kw)
        want = PA.launch_costs(args[0], args[1], args[3].shape[1],
                               kw["cache_len"].tolist(), kw["q_position"].tolist(),
                               causal=False)
    else:
        args, kw = _prefill_args(cases.MAIN_PREFILL, "bfloat16", cuda, seed=12)
        call = lambda: PA.paged_prefill_attention(*args, **kw)
        want = PA.launch_costs(args[0], args[1], args[3].shape[1],
                               kw["cache_len"].tolist(), kw["q_positions"][:, 0].tolist(),
                               causal=True)
    call()

    def sink(name, flops, nbytes):
        got.append((name, flops, nbytes))

    K.COST_SINKS.append(sink)
    try:
        call()
    finally:
        K.COST_SINKS.remove(sink)
    name = "paged_attention" if kind == "decode" else "paged_prefill_attention"
    assert got == [(name, float(want[0]), float(want[1]))] and want[0] > 0


RMS_ARCH = [c[:2] for c in cases.RMS_ARCH_CASES]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", cases.RMS_CASES + cases.MAIN_RMS + RMS_ARCH)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("zero_centered", [False, True])
def test_rmsnorm_kernel_matches_plain(cuda, rows, d, dtype, zero_centered):
    c = cases.rms_case(rows, d, seed=9)
    x = _th(c["x"], TORCH_DT[dtype], cuda)
    s = _th(c["scale"], None, cuda)
    out = RMS.rmsnorm(x, s, zero_centered=zero_centered)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == "float32" else 2e-2
    _close(_f32(out), _f32(rmsnorm_reference(x, s, zero_centered=zero_centered)), tol)


# ---------------------------------------------------------------------------
# training kernels: flash attention (K2) forward and backward, RMSNorm (K1)
# backward
# ---------------------------------------------------------------------------

FLASH_ALL = ([c + (0, None) for c in cases.FLASH_CASES] + cases.FLASH_KVLEN_CASES
             + [c + (0, None) for c in cases.FLASH_ARCH_CASES])


def _rel_close(got, want, dtype):
    scale = max(1.0, float(np.abs(want).max()))
    tol = (1e-4 if dtype == "float32" else 2e-2) * scale
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _flash_close(got, want, dtype):
    """Both gates of flash attention: the largest error (``_rel_close``) and
    the relative L2 error (``cases.TOL_L2``), which a fault confined to some
    rows moves even where the largest |value| lies in other rows."""
    _rel_close(got, want, dtype)
    assert cases.l2_rel_err(got, want) <= cases.TOL_L2[dtype]


def _flash_args(case, dtype, cuda, seed):
    B, Sq, Sk, Hq, Hkv, D, causal, window, softcap, q_off, kv_len = case
    c = cases.flash_case(B, Sq, Sk, Hq, Hkv, D, seed=seed, q_offset=q_off, kv_len=kv_len)
    td = TORCH_DT[dtype]
    qkv = [_th(c[n], td, cuda) for n in ("q", "k", "v")]
    kw = dict(q_positions=_th(c["q_positions"], None, cuda),
              k_positions=_th(c["k_positions"], None, cuda),
              kv_len=None if c["kv_len"] is None else _th(c["kv_len"], None, cuda),
              causal=causal, window=window, softcap=softcap)
    return qkv, _th(c["dout"], td, cuda), kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_ALL, ids=[str(c[:6]) for c in FLASH_ALL])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernels_match_plain(cuda, case, dtype):
    """Forward output, then dq, dk, dv against the plain version's autograd."""
    (q, k, v), dout, kw = _flash_args(case, dtype, cuda, seed=10)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = FA.flash_attention(*leaves, **kw)
    out.backward(dout)
    torch.cuda.synchronize()
    _flash_close(_f32(out), _f32(flash_attention_reference(q, k, v, **kw)), dtype)
    for got, want in zip(leaves, flash_attention_backward_reference(q, k, v, dout, **kw)):
        _flash_close(_f32(got.grad), _f32(want), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", cases.MAIN_FLASH_DENSE, ids=["decode", "chunk"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_dense_serving_shapes_match_plain(cuda, case, dtype):
    """K2 forward at the dense KV layout's shapes (one query row a slot at
    its own position, a chunk into one slot's row; keys cut by kv_len):
    both gates, and two calls bitwise equal."""
    (q, k, v), _, kw = _flash_args(case, dtype, cuda, seed=12)
    with torch.no_grad():
        out, again = FA.flash_attention(q, k, v, **kw), FA.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    _flash_close(_f32(out), _f32(flash_attention_reference(q, k, v, **kw)), dtype)
    assert torch.equal(out, again)


def _oneshot_args(case, dtype, cuda, seed):
    """A 12-field K2 row (the keys' first position last): q, k, v on the
    card and the wrapper's keyword arguments."""
    B, Sq, Sk, Hq, Hkv, D, causal, window, softcap, q_off, kv_len, k_off = case
    c = cases.flash_case(B, Sq, Sk, Hq, Hkv, D, seed=seed, q_offset=q_off, kv_len=kv_len,
                         k_offset=k_off)
    td = TORCH_DT[dtype]
    kw = dict(q_positions=_th(c["q_positions"], None, cuda),
              k_positions=_th(c["k_positions"], None, cuda),
              kv_len=None if c["kv_len"] is None else _th(c["kv_len"], None, cuda),
              causal=causal, window=window, softcap=softcap)
    return [_th(c[n], td, cuda) for n in ("q", "k", "v")], kw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_one_shot_prefill_matches_plain(cuda, dtype):
    """K2 at the one-shot prefill's shape (``cases.MAIN_FLASH_ONESHOT``: B 1
    x 32,768 tokens, 32/4 heads, D 64, causal) against the plain version in
    1024-query blocks (the whole score tensor would not fit): both gates,
    two calls bitwise equal."""
    (q, k, v), kw = _oneshot_args(cases.MAIN_FLASH_ONESHOT, dtype, cuda, seed=18)
    with torch.no_grad():
        out, again = FA.flash_attention(q, k, v, **kw), FA.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    qpos = kw["q_positions"]
    for i in range(0, q.shape[1], 1024):
        want = flash_attention_reference(q[:, i:i + 1024], k, v,
                                         **dict(kw, q_positions=qpos[:, i:i + 1024]))
        _flash_close(_f32(out[:, i:i + 1024]), _f32(want), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_split_decode_block_returns_the_lse(cuda, dtype):
    """K2 at a rank's block of a split decode (``cases.MAIN_FLASH_SPLIT_DECODE``:
    glm4's rank 3 on (1, 4), keys at 3,120..4,159) through
    ``flash_attention_lse``: the output and the LSE against the plain
    version's, the slot whose query sees no key of the block 0 with an LSE
    of -inf (not NaN)."""
    (q, k, v), kw = _oneshot_args(cases.MAIN_FLASH_SPLIT_DECODE, dtype, cuda, seed=19)
    o, lse = FA.flash_attention_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    wo, wl = flash_attention_reference(q, k, v, return_lse=True, **kw)
    _flash_close(_f32(o), _f32(wo), dtype)
    fin = torch.isfinite(wl)
    assert not bool(fin.all()) and torch.equal(torch.isneginf(lse), ~fin)
    _flash_close(_f32(lse[fin]), _f32(wl[fin]), dtype)
    assert bool((o.permute(0, 2, 1, 3)[~fin] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", nan_check.KINDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_a_nan_in_the_cache_reaches_only_the_rows_that_see_it(cuda, kind, dtype):
    """The sentinel's premise on both routes: a NaN key row or page a row
    can see makes that row non-finite, the other rows equal the clean
    call. Where no row may look (past kv_len, an unnamed page 0) the
    kernels read nothing and stay finite, while the plain versions carry
    0 * NaN into every row (ROADMAP.md Queue 3)."""
    r = nan_check.check(kind, dtype, cuda)
    for impl in ("kernel", "plain"):
        assert r[impl]["seen_nonfinite"] and r[impl]["unseen_equal"], (impl, r)
    assert r["kernel"]["past_len_finite"] and not r["plain"]["past_len_finite"], r


@pytest.mark.cuda
def test_flash_backward_is_deterministic(cuda):
    """No atomics: two backward calls give bitwise-equal gradients."""
    (q, k, v), dout, kw = _flash_args(cases.FLASH_CASES[0] + (0, None), "bfloat16", cuda, 11)
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        FA.flash_attention(*leaves, **kw).backward(dout)
        runs.append([t.grad for t in leaves])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


MAIN_FLASH_CASE = cases.MAIN_FLASH + (0, None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernels_match_plain_at_the_training_shape(cuda, dtype):
    """tinyllama-1.1b's training shape (B=4, S=2048, Hq=32, Hkv=4, D=64,
    causal): bf16 on the tensor-core route, f32 on the CUDA-core route."""
    (q, k, v), dout, kw = _flash_args(MAIN_FLASH_CASE, dtype, cuda, seed=13)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = FA.flash_attention(*leaves, **kw)
    out.backward(dout)
    torch.cuda.synchronize()
    _flash_close(_f32(out), _f32(flash_attention_reference(q, k, v, **kw)), dtype)
    for got, want in zip(leaves, flash_attention_backward_reference(q, k, v, dout, **kw)):
        _flash_close(_f32(got.grad), _f32(want), dtype)


@pytest.mark.cuda
def test_flash_backward_is_deterministic_at_the_training_shape(cuda):
    """The tensor-core backward sums the G partial dK/dV in a fixed order:
    two calls give bitwise-equal gradients at the training shape too."""
    (q, k, v), dout, kw = _flash_args(MAIN_FLASH_CASE, "bfloat16", cuda, 14)
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        FA.flash_attention(*leaves, **kw).backward(dout)
        runs.append([t.grad for t in leaves])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_dtype_launches_its_own_route(cuda, dtype):
    """bf16 launches the tensor-core kernels, f32 the CUDA-core kernels:
    one forward and one backward on its route, none on the other."""
    (q, k, v), dout, kw = _flash_args(FLASH_ALL[0], dtype, cuda, seed=15)
    before = dict(FA.ROUTE_LAUNCHES)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    FA.flash_attention(*leaves, **kw).backward(dout)
    torch.cuda.synchronize()
    moved = {r: FA.ROUTE_LAUNCHES[r] - before[r] for r in before}
    want = FA.route(TORCH_DT[dtype])
    assert moved == {r: (2 if r == want else 0) for r in before}


@pytest.mark.cuda
def test_tensor_core_route_raises_past_its_sequence_limit(cuda):
    """The tensor-core library flags a block's tiles in 2048 bits of shared
    memory, so it takes at most 131072 rows; past that the launch is
    refused and the wrapper raises (the CUDA-core route has no such limit)."""
    S = 2048 * 64 + 1
    q = torch.zeros(1, S, 1, 64, dtype=torch.bfloat16, device=cuda)
    pos = FA.positions_rows(None, 1, S, cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        FA.flash_forward(q, q, q, pos, pos, None, True, None, None)
    out, lse = FA.flash_forward(q[:, :-1], q[:, :-1], q[:, :-1], pos[:, :-1].contiguous(),
                                pos[:, :-1].contiguous(), None, True, None, None)
    torch.cuda.synchronize()
    assert out.shape == (1, S - 1, 1, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d",
                         cases.RMS_CASES + cases.MAIN_RMS + [cases.MAIN_RMS_TRAIN] + RMS_ARCH)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("zero_centered", [False, True])
def test_rmsnorm_backward_kernel_matches_plain(cuda, rows, d, dtype, zero_centered):
    c = cases.rms_case(rows, d, seed=12)
    td = TORCH_DT[dtype]
    x, s, dy = (_th(c[n], td, cuda) for n in ("x", "scale", "dy"))
    xl, sl = x.clone().requires_grad_(True), s.clone().requires_grad_(True)
    RMS.rmsnorm(xl, sl, 1e-6, zero_centered).backward(dy)
    torch.cuda.synchronize()
    dx, ds = rmsnorm_backward_reference(x, s, dy, 1e-6, zero_centered)
    _rel_close(_f32(xl.grad), _f32(dx), dtype)
    _rel_close(_f32(sl.grad), _f32(ds), dtype)



def _rms_gates(got, want, dtype):
    """K1's gates: within 1e-4 (f32) / 2e-2 (bf16) of the largest |value|
    (at least 1), and the relative L2 error within ``cases.TOL_L2_RMS``."""
    _rel_close(got, want, dtype)
    assert cases.l2_rel_err(got, want) <= cases.TOL_L2_RMS[dtype]


def _rms_both(x, s, dy, zero_centered=False):
    """The kernels' output and (dx, dscale), and the plain version's."""
    xl, sl = x.clone().requires_grad_(True), s.clone().requires_grad_(True)
    out = RMS.rmsnorm(xl, sl, 1e-6, zero_centered)
    out.backward(dy)
    torch.cuda.synchronize()
    want = [rmsnorm_reference(x, s, 1e-6, zero_centered),
            *rmsnorm_backward_reference(x, s, dy, 1e-6, zero_centered)]
    return [out, xl.grad, sl.grad], want


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", cases.RMS_WIDTH_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernels_at_every_model_width(cuda, rows, d, dtype):
    """Forward and backward at each width of the configs (one warp a row to
    sixteen), zero-centred, with the scale in x's dtype."""
    c = cases.rms_case(rows, d, seed=19)
    x, s, dy = (_th(c[n], TORCH_DT[dtype], cuda) for n in ("x", "scale", "dy"))
    got, want = _rms_both(x, s, dy, zero_centered=True)
    for g, w in zip(got, want):
        _rms_gates(_f32(g), _f32(w), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [2048, 8192, 300])
def test_rmsnorm_kernels_on_unaligned_tensors(cuda, dtype, d):
    """x and dy contiguous but one element past a 16-byte boundary: the
    scalar path, held to the same gates."""
    rows = 6
    c = cases.rms_case(rows, d, seed=20)
    td = TORCH_DT[dtype]
    x, dy = (torch.empty(rows * d + 1, dtype=td, device=cuda)[1:].view(rows, d)
             for _ in range(2))
    x.copy_(_th(c["x"], td, cuda))
    dy.copy_(_th(c["dy"], td, cuda))
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    s = _th(c["scale"], td, cuda)
    got, want = _rms_both(x, s, dy)
    for g, w in zip(got, want):
        _rms_gates(_f32(g), _f32(w), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [cases.MAIN_RMS_TRAIN, (17, 96), (3, 300)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_backward_is_bitwise_repeatable(cuda, rows, d, dtype):
    c = cases.rms_case(rows, d, seed=21)
    x, s, dy = (_th(c[n], TORCH_DT[dtype], cuda) for n in ("x", "scale", "dy"))
    first = RMS.launch_backward(x, s, dy)
    again = RMS.launch_backward(x, s, dy)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_rmsnorm_without_grad_launches_the_forward_alone(cuda):
    """Under ``torch.inference_mode()`` (the serving path) and under
    ``torch.no_grad()`` with leaves that require grad, one call is one
    forward launch and builds no autograd graph."""
    from repro_torch.kernels import LAUNCHES

    c = cases.rms_case(4, 2048, seed=22)
    x = _th(c["x"], torch.bfloat16, cuda).requires_grad_(True)
    s = _th(c["scale"], torch.bfloat16, cuda).requires_grad_(True)
    for ctx in (torch.inference_mode, torch.no_grad):
        before = dict(LAUNCHES)
        with ctx():
            out = RMS.rmsnorm(x, s)
        torch.cuda.synchronize()
        assert out.grad_fn is None and not out.requires_grad
        assert LAUNCHES["rmsnorm"] == before["rmsnorm"] + 1
        assert {k: v for k, v in LAUNCHES.items() if k != "rmsnorm"} == \
            {k: v for k, v in before.items() if k != "rmsnorm"}
        _close(_f32(out), _f32(rmsnorm_reference(x.detach(), s.detach())), 2e-2)


@pytest.mark.cuda
def test_rmsnorm_raises_on_other_dtypes_and_mixed_devices(cuda):
    from repro_torch.kernels import LAUNCHES

    before = dict(LAUNCHES)
    x = torch.zeros(4, 128, device=cuda)
    with pytest.raises(TypeError):
        RMS.rmsnorm(x.half(), torch.zeros(128, device=cuda, dtype=torch.float16))
    with pytest.raises(TypeError):
        RMS.rmsnorm(x.double(), torch.zeros(128, device=cuda))
    with pytest.raises(ValueError, match="CUDA device"):
        RMS.rmsnorm(x, torch.zeros(128))
    with pytest.raises(ValueError, match="CUDA device"):
        RMS.rmsnorm(x.requires_grad_(True), torch.zeros(128))
    with pytest.raises(ValueError, match="outside"):
        RMS.rmsnorm(torch.zeros(2, RMS.MAX_D + 8, device=cuda), torch.zeros(RMS.MAX_D + 8,
                                                                             device=cuda))
    assert dict(LAUNCHES) == before

@pytest.mark.cuda
def test_smoke_train_step_on_the_card_matches_the_cpu(cuda):
    """The smoke tinyllama in fp32, loss and gradients of one microbatch on
    the card (kernels) and on the CPU (plain versions), each against a
    float64 CPU run of the same weights: the card's loss within 1e-5
    relative, and its gradients' RMS error, all leaves together and each
    leaf, within 2x the CPU fp32 run's. (Two fp32 runs of this model
    disagree by up to ~4e-4 of a leaf's largest gradient: the JAX
    initializer's scales make the attention near one-hot, so the float64
    run, not the other fp32 run, is the reference.)"""
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.layers.common import tree_map
    from repro_torch.models.transformer import Transformer

    cfg = smoke_config("tinyllama-1.1b").replace(
        compute_dtype_name="float32", param_dtype_name="float32", remat="full")
    cpu = Transformer.from_init(cfg, seed=0, device="cpu")
    cfg64 = cfg.replace(compute_dtype_name="float64", param_dtype_name="float64")
    exact = Transformer(cfg64, tree_map(lambda t: t.detach().double(), cpu.params()), "cpu")
    batch = {k: v[0] for k, v in SyntheticLM(DataConfig(
        global_batch=2, seq_len=64, vocab=cfg.vocab, pad_fraction=0.05)).batch_at(0).items()}
    results = {}
    for name, model in (("cpu", cpu), ("card", Transformer(cfg, cpu.params(), cuda)),
                        ("exact", exact)):
        loss, _ = model(batch)
        grads = torch.autograd.grad(loss, list(model.named_params().values()))
        results[name] = (float(loss.detach()), [g.detach().double().cpu() for g in grads])
    loss64, g64 = results["exact"]
    assert results["card"][0] == pytest.approx(loss64, rel=1e-5)

    def rms_err(gs):
        per = [float((g - e).norm() / e.norm()) for g, e in zip(gs, g64)]
        total = float(sum((g - e).pow(2).sum() for g, e in zip(gs, g64)) ** 0.5
                      / sum(e.pow(2).sum() for e in g64) ** 0.5)
        return total, per

    card, cpu_err = rms_err(results["card"][1]), rms_err(results["cpu"][1])
    assert card[0] <= 2 * cpu_err[0] + 1e-7
    for c, p in zip(card[1], cpu_err[1]):
        assert c <= 2 * p + 1e-7
