"""The port's training kernels' plain versions against the JAX package.

Flash attention (K2), forward and gradients, against the jnp
``layers.attention.flash_attention`` the JAX training step runs (the
Pallas flash kernel cannot run on the installed JAX: ROADMAP.md, Queue 2),
and the RMSNorm backward (K1) against ``jax.vjp`` of the JAX ``rmsnorm``,
over the JAX case tables plus position and ``kv_len`` cases and the
other dense archs' shapes at small lengths (head dim 256 with a window
that cuts keys, GQA group 16, bidirectional at head dim 80), on numpy
inputs from a seed. The kernels against these plain versions on the card
are in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.kernels import cases  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as RMS  # noqa: E402


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


_FLASH_ALL = ([c + (0, None) for c in cases.FLASH_CASES] + cases.FLASH_KVLEN_CASES
              + [c + (0, None) for c in cases.FLASH_ARCH_SMALL])


def _flash_inputs(case, seed):
    B, Sq, Sk, Hq, Hkv, D, causal, window, softcap, q_off, kv_len = case
    c = cases.flash_case(B, Sq, Sk, Hq, Hkv, D, seed=seed, q_offset=q_off, kv_len=kv_len)
    kw = dict(causal=causal, window=window, softcap=softcap)
    return c, kw


def _flash_jax(c, kw):
    """The jnp function, chunked by 64 where 64 divides both sequences. It
    pads a ragged sequence with keys at position 1e9, which only the causal
    mask hides, so non-causal ragged cases run it unchunked (ROADMAP.md
    Queue 3)."""
    from repro.layers.attention import flash_attention as flash_j

    Sq, Sk = c["q"].shape[1], c["k"].shape[1]
    chunks = (dict(q_chunk=64, kv_chunk=64) if Sq % 64 == 0 and Sk % 64 == 0
              else dict(q_chunk=Sq, kv_chunk=Sk))

    def f(q, k, v):
        return flash_j(q, k, v, q_positions=_jx(c["q_positions"]),
                       k_positions=_jx(c["k_positions"]),
                       kv_len=None if c["kv_len"] is None else _jx(c["kv_len"]),
                       **chunks, **kw)

    return f


def _flash_torch_kw(c, kw):
    return dict(q_positions=_th(c["q_positions"]), k_positions=_th(c["k_positions"]),
                kv_len=None if c["kv_len"] is None else _th(c["kv_len"]), **kw)


@pytest.mark.parametrize("case", _FLASH_ALL, ids=[str(c[:6]) for c in _FLASH_ALL])
def test_flash_plain_matches_jnp_flash_attention(case):
    """Forward, f32, within 2e-5: GQA, causal, window, softcap, ragged
    sequences, odd head dims, positions offset from 0 and kv_len (one case
    with fully masked rows)."""
    from repro_torch.kernels.flash_attention import ops as FA

    c, kw = _flash_inputs(case, seed=5)
    out_j = _flash_jax(c, kw)(_jx(c["q"]), _jx(c["k"]), _jx(c["v"]))
    out_t = FA.flash_attention(_th(c["q"]), _th(c["k"]), _th(c["v"]), **_flash_torch_kw(c, kw))
    assert tuple(out_t.shape) == tuple(out_j.shape)
    _close(_f32(out_t), out_j, 2e-5)


@pytest.mark.parametrize("case", _FLASH_ALL, ids=[str(c[:6]) for c in _FLASH_ALL])
def test_flash_plain_gradients_match_jax_grad(case):
    """dq, dk, dv of the plain version (autograd) against jax.vjp of the jnp
    function for the same cotangent, within 1e-4 of the largest |grad|."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_backward_reference

    c, kw = _flash_inputs(case, seed=6)
    _, vjp = jax.vjp(_flash_jax(c, kw), _jx(c["q"]), _jx(c["k"]), _jx(c["v"]))
    grads_j = vjp(_jx(c["dout"]))
    grads_t = flash_attention_backward_reference(
        _th(c["q"]), _th(c["k"]), _th(c["v"]), _th(c["dout"]), **_flash_torch_kw(c, kw))
    for gt, gj in zip(grads_t, grads_j):
        gj = np.asarray(gj)
        tol = 1e-4 * max(1.0, float(np.abs(gj).max()))
        np.testing.assert_allclose(_f32(gt), gj, atol=tol, rtol=0)


@pytest.mark.parametrize("rows,d", cases.RMS_CASES + cases.RMS_WIDTH_CASES)
@pytest.mark.parametrize("zero_centered", [False, True])
def test_rmsnorm_plain_backward_matches_jax_grad(rows, d, zero_centered):
    """(dx, dscale) of the plain version against jax.vjp of the JAX
    ``layers.norms.rmsnorm``, f32, within 1e-5 of the largest |grad|."""
    from repro.layers.norms import rmsnorm as rmsnorm_j
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_backward_reference

    c = cases.rms_case(rows, d, seed=7)
    _, vjp = jax.vjp(lambda x, s: rmsnorm_j(x, s, 1e-6, zero_centered),
                     _jx(c["x"]), _jx(c["scale"]))
    grads_j = vjp(_jx(c["dy"]))
    grads_t = rmsnorm_backward_reference(_th(c["x"]), _th(c["scale"]), _th(c["dy"]),
                                         1e-6, zero_centered)
    for gt, gj in zip(grads_t, grads_j):
        gj = np.asarray(gj)
        np.testing.assert_allclose(_f32(gt), gj, atol=1e-5 * max(1.0, float(np.abs(gj).max())),
                                   rtol=0)


def test_training_wrappers_are_differentiable_on_the_cpu():
    """On CPU tensors the flash and RMSNorm wrappers are their plain
    versions, autograd flows through them, and no kernel launch is counted."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention.ref import flash_attention_reference

    reset_launch_counts()
    c = cases.flash_case(1, 16, 16, 4, 2, 32, seed=8)
    q, k, v = (_th(c[n]).requires_grad_(True) for n in ("q", "k", "v"))
    out = FA.flash_attention(q, k, v)
    assert torch.equal(out, flash_attention_reference(q, k, v))
    r = cases.rms_case(3, 64, seed=8)
    x, s = _th(r["x"]).requires_grad_(True), _th(r["scale"]).requires_grad_(True)
    (out.sum() + RMS.rmsnorm(x, s).sum()).backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v, x, s))
    assert set(launch_counts().values()) == {0}
