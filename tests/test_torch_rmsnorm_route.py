"""The RMSNorm wrapper's plan, input checks and CPU route, and the algorithm
of its CUDA kernels, checked on the CPU.

``kernels/rmsnorm/ops.py plan`` lays a row over the threads of the kernels
in ``csrc/rmsnorm.cu`` and partitions the rows into the backward's blocks
from the shapes, the dtype and the SM count alone; that is plain Python,
so it is held here. The backward's algorithm (a row pass that writes dx
and one fp32 partial row of dscale a block, then a combine that adds the
partials in 32 contiguous runs in block order and the runs in order) is
emulated in torch with that plan and held against ``jax.vjp`` of the JAX
``repro.layers.norms.rmsnorm`` in f32 within 1e-5 of the largest |grad|;
planted faults in the emulation must fail that gate. The kernels against
their plain versions on the card are in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.layers.norms import rmsnorm as rmsnorm_j  # noqa: E402
from repro_torch.kernels import cases, launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as RMS  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference  # noqa: E402

SMS = [1, 7, 132]
ALL_ROWS = cases.RMS_CASES + cases.MAIN_RMS + [cases.MAIN_RMS_TRAIN]
EMULATED = cases.RMS_CASES + cases.MAIN_RMS


def _th(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,d", ALL_ROWS)
@pytest.mark.parametrize("sms", SMS)
def test_plan_covers_every_row_once(rows, d, sms):
    """The forward's and the backward's blocks of ``per`` consecutive rows
    cover 0..rows-1 exactly once, each block holds a row (the forward's
    exactly one), and the partitions read only rows and the SM count (not
    the width, the dtype's vector path or an earlier call)."""
    p = RMS.plan(rows, d, 2, sms, d % 8 == 0)
    assert (p.fwd_blocks, p.fwd_per, p.fwd_ring) == (rows, 1, 0)
    for blocks, per, per_sm in ((p.fwd_blocks, p.fwd_per, rows / sms),
                                (p.blocks, p.per, RMS.BWD_BLOCKS_PER_SM)):
        seen = np.zeros(rows, np.int64)
        for b in range(blocks):
            lo, hi = b * per, min((b + 1) * per, rows)
            assert lo < hi
            seen[lo:hi] += 1
        assert (seen == 1).all()
        assert blocks <= per_sm * sms
    for itemsize, vector, width in ((4, d % 4 == 0, d), (2, False, d), (4, False, 8192),
                                    (2, True, 8)):
        q = RMS.plan.__wrapped__(rows, width, itemsize, sms, vector)
        assert (q.fwd_blocks, q.fwd_per, q.blocks, q.per) == \
            (p.fwd_blocks, p.fwd_per, p.blocks, p.per)


@pytest.mark.parametrize("d", sorted({d for _, d in cases.RMS_CASES + cases.RMS_WIDTH_CASES}))
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("vector", [True, False])
def test_plan_layout_fits_the_library(d, itemsize, vector):
    """Every width of the configs and the case tables gets a layout the
    library takes (its ``layout_ok``): the team covers the row, a thread
    holds at most MAX_EPT elements (the vector path's VPT 1, 2 or 4; the
    scalar path's SCALAR_VPT), at most MAX_WARPS warps a block, and a ring
    of at most MAX_RING rows in flight in at most RING_BYTES of shared
    memory (none on the scalar path), as deep as the budget allows."""
    n = 16 // itemsize if vector else 1
    if d % n:
        with pytest.raises(ValueError, match="multiple of the vector"):
            RMS.plan(4, d, itemsize, 132, vector)
        return
    p = RMS.plan(4, d, itemsize, 132, vector)
    assert 32 * p.warps * p.vpt * n >= d
    if vector:
        assert p.vpt in (1, 2, 4) and n * p.vpt <= RMS.MAX_EPT
    else:
        assert p.vpt == RMS.SCALAR_VPT
    assert 1 <= p.warps <= RMS.MAX_WARPS
    slot = 16 * 2 * p.vpt * 32 * p.warps
    if vector:
        assert 0 <= p.ring <= min(RMS.BWD_RING, RMS.MAX_RING) and p.ring * slot <= RMS.RING_BYTES
        assert p.ring == RMS.BWD_RING or (p.ring + 1) * slot > RMS.RING_BYTES
    else:
        assert p.ring == 0
    assert p.fwd_ring == 0


@pytest.mark.parametrize("d", [0, RMS.MAX_D + 1])
def test_plan_raises_outside_the_widths(d):
    with pytest.raises(ValueError, match="outside"):
        RMS.plan(4, d, 2, 132, False)


# ---------------------------------------------------------------------------
# the backward's algorithm, emulated with the plan
# ---------------------------------------------------------------------------


def emulate_backward(x, scale, dy, eps, zero_centered, sms, fault=None):
    """(dx, dscale) as the kernels compute them, in f32: the row pass per
    row (rstd from x; dx = rstd * (g - xhat * mean(g * xhat)), g = dy * s),
    dscale partials per block of the plan summed over its rows in order,
    then the combine's fixed order. ``fault``: ``drop_last`` leaves out the
    last block's partial; ``twice`` adds the first partial twice."""
    rows, d = x.shape
    p = RMS.plan(rows, d, 4, sms, d % 4 == 0)
    s = 1.0 + scale if zero_centered else scale
    g = dy * s
    rstd = torch.rsqrt((x * x).sum(-1, keepdim=True) / d + eps)
    xh = x * rstd
    dx = rstd * (g - xh * (rstd * (g * x).sum(-1, keepdim=True) / d))
    contrib = torch.zeros(p.blocks * p.per, d)
    contrib[:rows] = dy * xh
    contrib = contrib.reshape(p.blocks, p.per, d)
    parts = torch.zeros(p.blocks, d)
    for i in range(p.per):  # each block's rows in order
        parts += contrib[:, i]
    parts = list(parts)
    if fault == "drop_last":
        parts = parts[:-1]
    elif fault == "twice":
        parts.insert(1, parts[0])
    n, runs = len(parts), []
    for w in range(RMS.COMBINE_WARPS):  # contiguous runs in block order
        acc = torch.zeros(d)
        for b in range(w * n // RMS.COMBINE_WARPS, (w + 1) * n // RMS.COMBINE_WARPS):
            acc = acc + parts[b]
        runs.append(acc)
    dscale = torch.zeros(d)
    for r in runs:
        dscale = dscale + r
    return dx, dscale


def _jax_grads(c, zero_centered):
    _, vjp = jax.vjp(lambda x, s: rmsnorm_j(x, s, 1e-6, zero_centered),
                     jnp.asarray(c["x"]), jnp.asarray(c["scale"]))
    return [np.asarray(g) for g in vjp(jnp.asarray(c["dy"]))]


def _worst(got, want) -> float:
    """The largest error of either gradient over its largest |value|."""
    return max(float(np.abs(g.numpy() - w).max() / np.abs(w).max()) for g, w in zip(got, want))


@pytest.mark.parametrize("rows,d", EMULATED)
@pytest.mark.parametrize("zero_centered", [False, True])
@pytest.mark.parametrize("sms", SMS)
def test_emulated_backward_matches_jax_vjp(rows, d, zero_centered, sms):
    c = cases.rms_case(rows, d, seed=17)
    got = emulate_backward(_th(c["x"]), _th(c["scale"]), _th(c["dy"]), 1e-6, zero_centered,
                           sms)
    assert _worst(got, _jax_grads(c, zero_centered)) <= 1e-5


@pytest.mark.parametrize("rows,d", EMULATED)
@pytest.mark.parametrize("fault", ["drop_last", "twice"])
def test_planted_backward_faults_fail_the_gate(rows, d, fault):
    c = cases.rms_case(rows, d, seed=17)
    got = emulate_backward(_th(c["x"]), _th(c["scale"]), _th(c["dy"]), 1e-6, False, 7, fault)
    assert not _worst(got, _jax_grads(c, False)) <= 1e-5


# ---------------------------------------------------------------------------
# the wrapper on CPU tensors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grad", [False, True])
def test_wrapper_takes_the_plain_version_on_the_cpu(grad):
    reset_launch_counts()
    c = cases.rms_case(3, 300, seed=18)
    x, s = _th(c["x"]).requires_grad_(grad), _th(c["scale"]).requires_grad_(grad)
    with torch.set_grad_enabled(grad):
        out = RMS.rmsnorm(x, s, 1e-6, True)
        want = rmsnorm_reference(x, s, 1e-6, True)
    assert torch.equal(out, want)
    assert (out.grad_fn is not None) == grad
    if grad:
        out.backward(_th(c["dy"]))
        assert x.grad is not None and s.grad is not None
    assert set(launch_counts().values()) == {0}


def test_kernel_launchers_raise_on_cpu_tensors_and_other_dtypes():
    """``launch_forward`` / ``launch_backward`` never run on the CPU: a CPU
    tensor or a dtype the kernels do not take raises before any launch."""
    x, s = torch.zeros(4, 128), torch.zeros(128)
    with pytest.raises(ValueError, match="CUDA"):
        RMS.launch_forward(x, s)
    with pytest.raises(ValueError, match="CUDA"):
        RMS.launch_backward(x, s, x)
    with pytest.raises(TypeError):
        RMS.launch_forward(x.half(), s)
    with pytest.raises(TypeError):
        RMS.launch_forward(x, s.double())
    with pytest.raises(ValueError, match="scale shape"):
        RMS.launch_forward(x, torch.zeros(64))
    with pytest.raises(ValueError, match="contiguous"):
        RMS.launch_forward(torch.zeros(128, 4).t(), s)
