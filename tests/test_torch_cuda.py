"""The hand-written kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where torch sees no GPU (the
decision is made when the test runs, in the ``cuda`` fixture). The file
imports no JAX, so it runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Cases are the JAX package's kernel case tables plus the serving path's
shapes at tinyllama-1.1b's full width. Tolerances: f32 1e-4 (the page loop
sums in another order than the gather), bf16 2e-2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import cases  # noqa: E402
from repro_torch.kernels.paged_attention import ops as PA  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_reference,
    paged_prefill_attention_reference,
)
from repro_torch.kernels.rmsnorm import ops as RMS  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference  # noqa: E402

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


@pytest.mark.cuda
@pytest.mark.parametrize("case", cases.PAGED_CASES + [cases.MAIN_PAGED],
                         ids=[str(c[:7]) for c in cases.PAGED_CASES + [cases.MAIN_PAGED]])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_decode_kernel_matches_plain(cuda, case, dtype):
    B, Hq, Hkv, D, psize, nL, P, lens, window, softcap = case
    c = cases.paged_case(B, Hq, Hkv, D, psize, nL, P, lens, seed=7)
    td = TORCH_DT[dtype]
    args = [_th(c[k], td, cuda) for k in ("q", "k_pages", "v_pages")]
    args.append(_th(c["block_tables"], None, cuda))
    kw = dict(q_position=_th(c["q_position"], None, cuda),
              cache_len=_th(c["cache_len"], None, cuda),
              window=window, softcap=softcap)
    out = PA.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == "float32" else 2e-2
    _close(_f32(out), _f32(paged_attention_reference(*args, **kw)), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", cases.PREFILL_CASES + [cases.MAIN_PREFILL],
                         ids=[str(c[:9]) for c in cases.PREFILL_CASES + [cases.MAIN_PREFILL]])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_prefill_kernel_matches_plain(cuda, case, dtype):
    B, C, Hq, Hkv, D, psize, nL, P, starts, window, softcap = case
    c = cases.prefill_case(B, C, Hq, Hkv, D, psize, nL, P, starts, seed=8)
    td = TORCH_DT[dtype]
    args = [_th(c[k], td, cuda) for k in ("q", "k_pages", "v_pages")]
    args.append(_th(c["block_tables"], None, cuda))
    kw = dict(q_positions=_th(c["q_positions"], None, cuda),
              cache_len=_th(c["cache_len"], None, cuda),
              causal=True, window=window, softcap=softcap)
    out = PA.paged_prefill_attention(*args, **kw)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == "float32" else 2e-2
    _close(_f32(out), _f32(paged_prefill_attention_reference(*args, **kw)), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", cases.RMS_CASES + cases.MAIN_RMS)
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
