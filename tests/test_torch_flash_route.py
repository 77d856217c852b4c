"""The flash-attention wrapper's routing, checked on the CPU.

bf16 CUDA tensors go to the tensor-core kernels (``flash_attention_tc.cu``),
fp32 CUDA tensors to the CUDA-core kernels (``flash_attention.cu``); the
choice, the checks of the inputs and the counted work are plain Python, so
they are held here, as are the gates (``cases.max_rel_err``,
``cases.l2_rel_err``) that hold the kernels to their plain versions on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``). The tiling is the
library's own and is checked on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import cases  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FA  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_reference  # noqa: E402

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "tensor_cores"),
                                        (torch.float32, "cuda_cores")])
def test_dtype_picks_the_route(dtype, want):
    assert FA.route(dtype) == want


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
def test_route_raises_on_other_dtypes(dtype):
    with pytest.raises(TypeError):
        FA.route(dtype)


def _qkv(B=1, Sq=8, Sk=8, Hq=2, Hkv=1, D=64, dtype=torch.bfloat16):
    return (torch.zeros(B, Sq, Hq, D, dtype=dtype), torch.zeros(B, Sk, Hkv, D, dtype=dtype),
            torch.zeros(B, Sk, Hkv, D, dtype=dtype))


def _bad_inputs():
    q, k, v = _qkv()
    return {
        "float16": (TypeError, _qkv(dtype=torch.float16)),
        "mixed dtypes": (TypeError, (q, k.float(), v)),
        "3-d q": (ValueError, (q[0], k, v)),
        "v unlike k": (ValueError, (q, k, v[:, :4])),
        "batch mismatch": (ValueError, (q, *_qkv(B=2)[1:])),
        "head dim 257": (ValueError, _qkv(D=257)),
        "Hq not a multiple of Hkv": (ValueError, _qkv(Hq=3, Hkv=2)),
        "strided q": (ValueError, (q.transpose(1, 2).contiguous().transpose(1, 2), k, v)),
    }


@pytest.mark.parametrize("what", list(_bad_inputs()))
def test_launchers_raise_on_inputs_no_kernel_takes(what):
    """Dtypes and shapes are checked before the device, so each refusal
    shows here, without a card; a sequence past 131072 rows is refused by
    the tensor-core library itself (a launch error, raised)."""
    err, (q, k, v) = _bad_inputs()[what]
    with pytest.raises(err):
        FA._check(q, k, v)


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (8, 8, True, None), (8, 8, False, None), (16, 16, True, 4), (12, 20, True, None),
    (20, 12, True, 3), (9, 9, False, 2)])
def test_visible_pairs_counts_every_visible_pair(Sq, Sk, causal, window):
    """The work ``launch_costs`` counts, against a brute-force count over
    every (query, key) pair at index positions."""
    i, j = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    vis = np.ones((Sq, Sk), bool)
    if causal:
        vis &= j <= i
    if window:
        vis &= j > i - window
    assert FA.visible_pairs(Sq, Sk, causal, window) == int(vis.sum())


# The relative L2 gate (cases.TOL_L2) against faults a flash kernel could
# have, emulated in plain float64 attention over a causal sequence of 512
# rows in 128-row blocks of 64-key tiles: each fault leaves the early rows,
# where the largest |value| lies, alone or nearly so.
S_G, H_G, D_G = 512, 2, 64


def _gate_qkv(dtype):
    c = cases.flash_case(1, S_G, S_G, H_G, H_G, D_G, seed=5)
    return [torch.from_numpy(c[n][0]).to(TORCH_DT[dtype]).double().transpose(0, 1)
            for n in ("q", "k", "v")]  # (H, S, D), rounded to the dtype


def _attention(q, k, v, visible):
    s = (q @ k.transpose(-1, -2) / D_G ** 0.5).masked_fill(~visible, float("-inf"))
    return torch.softmax(s, -1) @ v


def _causal():
    i = torch.arange(S_G)
    return i[:, None], i[None, :], i[:, None] >= i[None, :]


def _late_rows_30pct(q, k, v):
    o = _attention(q, k, v, _causal()[2])
    o[:, S_G // 2:] *= 1.3
    return o


def _late_rows_skip_diagonal_tile(q, k, v):
    """The second warpgroup of each late block drops its diagonal key tile."""
    i, j, vis = _causal()
    drop = (i >= S_G // 2) & (i % 128 >= 64) & (j // 64 == i // 64)
    return _attention(q, k, v, vis & ~drop)


def _second_warpgroup_row_map(q, k, v):
    """Rows 64..127 of each block masked with the positions 64 rows back."""
    i, j, vis = _causal()
    return _attention(q, k, v, j <= i - 64 * (i % 128 >= 64).long())


def _no_rescale(q, k, v):
    """Online softmax over 64-key tiles whose O is not rescaled when the
    running max grows (its sum is)."""
    i, j, vis = _causal()
    m = torch.full((H_G, S_G, 1), float("-inf"), dtype=torch.float64)
    l, acc = torch.zeros_like(m), torch.zeros_like(q)
    for t in range(0, S_G, 64):
        s = (q @ k[:, t:t + 64].transpose(-1, -2) / D_G ** 0.5).masked_fill(
            ~vis[:, t:t + 64], float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new).nan_to_num(0.0)
        l = l * torch.exp(m - m_new).nan_to_num(0.0) + p.sum(-1, keepdim=True)
        acc = acc + p @ v[:, t:t + 64]
        m = m_new
    return acc / l


FAULTS = {"late rows 30% off": _late_rows_30pct,
          "late rows without their diagonal tile": _late_rows_skip_diagonal_tile,
          "second warpgroup's row map": _second_warpgroup_row_map,
          "O not rescaled": _no_rescale}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gates_pass_rounding_alone(dtype):
    """The exact output rounded once to the dtype passes both gates."""
    q, k, v = _gate_qkv(dtype)
    want = _attention(q, k, v, _causal()[2])
    got = want.to(TORCH_DT[dtype]).double()
    assert cases.max_rel_err(got.numpy(), want.numpy()) <= cases.TOL_MAX[dtype]
    assert cases.l2_rel_err(got.numpy(), want.numpy()) <= cases.TOL_L2[dtype]


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l2_gate_fails_faults_confined_to_some_rows(fault, dtype):
    q, k, v = _gate_qkv(dtype)
    want = _attention(q, k, v, _causal()[2])
    got = FAULTS[fault](q, k, v).to(TORCH_DT[dtype]).double()
    assert cases.l2_rel_err(got.numpy(), want.numpy()) > cases.TOL_L2[dtype]


def test_l2_rel_err_is_absolute_against_zeros():
    assert cases.l2_rel_err(np.array([3.0, 4.0]), np.zeros(2)) == 5.0
    assert cases.l2_rel_err(np.zeros(2), np.zeros(2)) == 0.0


def test_max_rel_err_divides_by_at_least_one():
    assert cases.max_rel_err(np.array([0.5, 0.0]), np.array([0.25, 0.0])) == 0.25
    assert cases.max_rel_err(np.array([9.0, 0.0]), np.array([8.0, 0.0])) == 1 / 8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_entry_points_raise_for_cpu_tensors(dtype):
    """The launchers never take a CPU tensor: no quiet fall back to the
    plain version below the public wrapper."""
    q = torch.zeros(1, 8, 2, 64, dtype=dtype)
    k = torch.zeros(1, 8, 1, 64, dtype=dtype)
    pos = FA.positions_rows(None, 1, 8, "cpu")
    with pytest.raises(ValueError, match="expected CUDA"):
        FA.flash_forward(q, k, k, pos, pos, None, True, None, None)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="expected CUDA"):
        FA.flash_backward(q, k, k, q, lse, q, pos, pos, None, True, None, None)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    c = cases.flash_case(1, 16, 16, 4, 2, 32, seed=3)
    q, k, v = (torch.from_numpy(c[n]) for n in ("q", "k", "v"))
    before = dict(FA.ROUTE_LAUNCHES)
    out = FA.flash_attention(q, k, v, causal=True)
    assert FA.ROUTE_LAUNCHES == before
    assert torch.equal(out, flash_attention_reference(q, k, v, causal=True))


@pytest.mark.parametrize("backward,flops,nbytes", [
    (False, 68_753_031_168, 76_546_048),
    (True, 171_882_577_920, 153_092_096),
])
def test_launch_costs_unchanged_at_the_training_shape(backward, flops, nbytes):
    """The counted FLOPs and bytes the run record and the bound use: causal
    pairs 2048 * 2049 / 2 per (batch, head), 4 D FLOPs a pair forward and
    2.5 times that backward; each tensor read or written once."""
    B, Sq, Sk, Hq, Hkv, D, causal, window, _ = cases.MAIN_FLASH
    q = torch.empty(B, Sq, Hq, D, dtype=torch.bfloat16, device="meta")
    k = torch.empty(B, Sk, Hkv, D, dtype=torch.bfloat16, device="meta")
    assert FA.visible_pairs(Sq, Sk, causal, window) == 2048 * 2049 // 2
    assert FA.launch_costs(q, k, causal, window, backward) == (flops, nbytes)
