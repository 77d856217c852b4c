"""The paged-attention wrapper's routing and the split-K algorithm of its
bf16 kernels, checked on the CPU.

bf16 CUDA tensors go to the tensor-core kernels (``paged_attention_tc.cu``),
fp32 CUDA tensors to the CUDA-core kernels (``paged_attention.cu``); the
choice, the checks of the inputs, the split plan and the counted work are
plain Python, so they are held here. The split-K algorithm itself (key
tiles within a split, online softmax with the reference's masking guards,
partials combined in split order) is emulated in numpy with the plan the
wrapper hands the kernel, and held against the JAX Pallas kernels in
interpret mode over every case table; emulated combine faults must fail
the gates (``cases.TOL_MAX``, ``cases.TOL_L2_PAGED``) that hold the
kernels to their plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention.kernel import (  # noqa: E402
    paged_attention_pallas,
    paged_prefill_attention_pallas,
)
from repro_torch.kernels import cases  # noqa: E402
from repro_torch.kernels.paged_attention import ops as PA  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_reference,
    paged_prefill_attention_reference,
)

NEG_INF = -1e30


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "tensor_cores"),
                                        (torch.float32, "cuda_cores")])
def test_dtype_picks_the_route(dtype, want):
    assert PA.route(dtype) == want


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
def test_route_raises_on_other_dtypes(dtype):
    with pytest.raises(TypeError):
        PA.route(dtype)


def _inputs(B=2, C=1, Hq=4, Hkv=2, D=64, P=6, page=4, nL=3, dtype=torch.bfloat16):
    return (torch.zeros(B, C, Hq, D, dtype=dtype), torch.zeros(P, page, Hkv, D, dtype=dtype),
            torch.zeros(P, page, Hkv, D, dtype=dtype), torch.zeros(B, nL, dtype=torch.int32))


def _bad_inputs():
    q, k, v, t = _inputs()
    return {
        "float16": (TypeError, _inputs(dtype=torch.float16)),
        "mixed dtypes": (TypeError, (q, k.float(), v, t)),
        "int64 table": (TypeError, (q, k, v, t.long())),
        "3-d q": (ValueError, (q[0], k, v, t)),
        "v unlike k": (ValueError, (q, k, v[:, :2], t)),
        "head dim 257": (ValueError, _inputs(D=257)),
        "Hq not a multiple of Hkv": (ValueError, _inputs(Hq=3)),
        "table rows unlike batch": (ValueError, (q, k, v, t[:1])),
        "strided q": (ValueError, (q.transpose(1, 2).contiguous().transpose(1, 2), k, v, t)),
        "CPU tensors": (ValueError, (q, k, v, t)),
    }


@pytest.mark.parametrize("what", list(_bad_inputs()))
def test_check_refuses_inputs_no_kernel_takes(what):
    """Dtypes and shapes are checked before the device, so each refusal
    shows here, without a card (the last: CPU tensors at the launcher)."""
    err, args = _bad_inputs()[what]
    with pytest.raises(err):
        PA._check(*args)


def test_decode_check_wants_one_query_a_row():
    with pytest.raises(ValueError, match="one query per row"):
        PA._check(*_inputs(C=2), C_expected=1)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    c = cases.paged_case(*cases.PAGED_SPLIT_CASES[0][:8], seed=3)
    args = [torch.from_numpy(c[n]) for n in ("q", "k_pages", "v_pages", "block_tables")]
    kw = dict(q_position=torch.from_numpy(c["q_position"]),
              cache_len=torch.from_numpy(c["cache_len"]))
    before = dict(PA.ROUTE_LAUNCHES)
    assert torch.equal(PA.paged_attention(*args, **kw), paged_attention_reference(*args, **kw))
    assert PA.ROUTE_LAUNCHES == before


# ---------------------------------------------------------------------------
# the split plan
# ---------------------------------------------------------------------------


def test_plan_at_the_serving_shapes():
    """Decode: 16 (sequence, kv head) pairs x 8 splits of 4 pages (one
    64-key tile each) = 128 blocks on 132 SMs; prefill: 8 row tiles x 4 kv
    heads = 32 blocks of 64 rows, each walking the whole table (no
    combine)."""
    B, Hq, Hkv, D, ps, nL = cases.MAIN_PAGED[:6]
    assert PA.tc_plan(B, 1, Hq, Hkv, D, ps, nL) == (8, 4)
    B, C, Hq, Hkv, D, ps, nL = cases.MAIN_PREFILL[:7]
    assert PA.tc_plan(B, C, Hq, Hkv, D, ps, nL) == (1, 32)


@pytest.mark.parametrize("C,Hq,Hkv,split", [(1, 32, 4, True), (2, 32, 4, True),
                                              (4, 16, 4, True), (3, 32, 4, False),
                                              (64, 32, 4, False), (1, 64, 2, False)])
def test_plan_splits_groups_of_at_most_16_rows(C, Hq, Hkv, split):
    assert (PA.tc_plan(1, C, Hq, Hkv, 64, 16, 32)[0] > 1) == split


PLAN_SHAPES = [  # B, C, Hq, Hkv, D, page, nL, sms
    (1, 1, 1, 1, 64, 16, 1, 132), (4, 1, 32, 4, 64, 16, 32, 132),
    (1, 1, 8, 8, 256, 16, 5000, 132), (64, 1, 32, 4, 64, 16, 32, 132),
    (1, 512, 32, 4, 128, 16, 256, 132), (2, 1, 4, 2, 100, 3, 70, 132),
    (1, 1, 2, 1, 32, 1, 65536, 132), (3, 7, 6, 3, 48, 5, 11, 8),
]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=[str(s) for s in PLAN_SHAPES])
def test_plan_covers_the_table_within_the_library_limits(shape):
    """Every page of the table lies in exactly one split, no split starts
    past the table, and the library's limits hold (it refuses others)."""
    splits, pages = PA.tc_plan(*shape)
    nL = shape[6]
    assert 1 <= splits <= PA.TC_MAX_SPLITS and 1 <= pages <= PA.TC_MAX_SPLIT_PAGES
    assert splits * pages >= nL and (splits - 1) * pages < nL


def test_plan_raises_past_the_pages_it_can_split():
    with pytest.raises(ValueError):
        PA.tc_plan(1, 1, 2, 1, 64, 16, PA.TC_MAX_SPLITS * PA.TC_MAX_SPLIT_PAGES + 1)


def test_scratch_shapes_at_the_serving_decode_shape():
    shapes = PA.tc_scratch_shapes(4, 1, 32, 4, 64, 8)
    assert shapes == {"acc": (16, 8, 64, 64), "ml": (16, 8, 64, 2), "counters": (16,)}


@pytest.mark.parametrize("kind,flops,nbytes", [
    ("decode", 6_291_456, 819_744),
    ("prefill", 117_702_656, 786_820),
])
def test_launch_costs_at_the_serving_shapes(kind, flops, nbytes):
    """The FLOPs and bytes phase 7's bound uses: 4 D FLOPs per visible
    (query head, key) pair; q, the visible keys' K and V, the table, the
    lengths and positions read once, the output written once."""
    if kind == "decode":
        B, Hq, Hkv, D, ps, nL, P, lens, _, _ = cases.MAIN_PAGED
        q = torch.empty(B, 1, Hq, D, dtype=torch.bfloat16, device="meta")
        got = PA.launch_costs(q, torch.empty(P, ps, Hkv, D, dtype=torch.bfloat16, device="meta"),
                              nL, lens, [n - 1 for n in lens], causal=False)
    else:
        B, C, Hq, Hkv, D, ps, nL, P, starts, _, _ = cases.MAIN_PREFILL
        q = torch.empty(B, C, Hq, D, dtype=torch.bfloat16, device="meta")
        got = PA.launch_costs(q, torch.empty(P, ps, Hkv, D, dtype=torch.bfloat16, device="meta"),
                              nL, [s + C for s in starts], starts, causal=True)
    assert got == (flops, nbytes)


def test_launch_costs_count_the_window():
    """A window of 4 at position 9 over 10 keys: keys 6..9 are visible."""
    q = torch.empty(1, 1, 2, 8, device="meta")
    k = torch.empty(4, 4, 1, 8, device="meta")
    flops, nbytes = PA.launch_costs(q, k, 3, [10], [9], causal=False, window=4)
    assert flops == 4 * 2 * 8 * 4
    assert nbytes == (2 * 2 * 8 + 2 * 4 * 8) * 4 + 4 * (3 + 2)


# ---------------------------------------------------------------------------
# split-K, emulated
# ---------------------------------------------------------------------------


def split_k(q, k_pages, v_pages, tbl, lens, start, *, causal, window, softcap, fault=None):
    """The bf16 kernels' algorithm in float32 numpy, with the plan
    ``ops.tc_plan`` gives them: per (sequence, kv head, 64-row tile, split),
    KT-key tiles from the split's first key, the online softmax with the
    reference's guards, then the splits combined in split order with weight
    exp(m_i - m) (0 for an empty split). ``fault``: ``"no_rescale"`` (weight
    1), ``"drop_last_live_split"`` (the last split that saw a key, ignored).
    q (B,C,Hq,D); start: the position of query 0 of each row."""
    B, C, Hq, D = q.shape
    P, page, Hkv, _ = k_pages.shape
    nL = tbl.shape[1]
    G, rows, BR = Hq // Hkv, (Hq // Hkv) * C, PA.TC_BLOCK_ROWS
    splits, pps = PA.tc_plan(B, C, Hq, Hkv, D, page, nL)
    kt = 64 if D <= 128 else 32
    scale = np.float32(1 / math.sqrt(D))
    out = np.zeros_like(q)
    for b in range(B):
        pages = np.clip(tbl[b], 0, P - 1)
        ln = min(int(lens[b]), nL * page)
        for h in range(Hkv):
            keys = np.zeros((nL * page + kt, D), np.float32)
            vals = np.zeros_like(keys)
            keys[:nL * page] = k_pages[pages, :, h].reshape(nL * page, D)
            vals[:nL * page] = v_pages[pages, :, h].reshape(nL * page, D)
            for r0 in range(0, rows, BR):
                r = np.arange(r0, min(rows, r0 + BR))
                c, g = r // G, r % G
                qr = q[b, c, h * G + g]
                qp = int(start[b]) + c
                hi = min(ln, int(qp.max()) + 1) if causal else ln
                lo = max(0, int(qp.min()) - window + 1) if window else 0
                parts = []
                for sp in range(splits):
                    ks = sp * pps * page
                    kb, ke = max(ks, lo), min(min(sp * pps + pps, nL) * page, hi)
                    m = np.full(len(r), NEG_INF, np.float32)
                    l = np.zeros(len(r), np.float32)
                    acc = np.zeros((len(r), D), np.float32)
                    k0 = ks + ((kb - ks) // kt) * kt if kb < ke else ke
                    while k0 < ke:
                        kpos = np.arange(k0, k0 + kt)
                        s = (qr @ keys[kpos].T) * scale
                        if softcap:
                            s = np.tanh(s / softcap) * softcap
                        vis = (kpos >= kb) & (kpos < ke) & np.ones((len(r), 1), bool)
                        if causal:
                            vis &= kpos[None] <= qp[:, None]
                        if window:
                            vis &= kpos[None] > qp[:, None] - window
                        s = np.where(vis, s, NEG_INF).astype(np.float32)
                        mx = np.maximum(m, s.max(1))
                        msafe = np.where(mx <= NEG_INF / 2, 0, mx).astype(np.float32)
                        alpha = np.where(m <= NEG_INF / 2, 0, np.exp(m - msafe))
                        p = np.where(vis, np.exp(s - msafe[:, None]), 0).astype(np.float32)
                        l = l * alpha + p.sum(1)
                        acc = acc * alpha[:, None] + p @ vals[kpos]
                        m = mx
                        k0 += kt
                    parts.append((m, l, acc))
                if splits == 1:
                    m, l, acc = parts[0]
                    o = acc / np.maximum(l, 1e-30)[:, None]
                else:
                    ms = np.stack([p[0] for p in parts])  # (splits, rows)
                    mt = ms.max(0)
                    live = ms > NEG_INF / 2
                    w = np.where(live, np.exp(np.where(live, ms - mt, 0)), 0)
                    if fault == "no_rescale":
                        w = live.astype(np.float32)
                    elif fault == "drop_last_live_split":
                        last = splits - 1 - np.argmax(live[::-1], axis=0)
                        w[last, np.arange(len(r))] = 0
                    L = sum(w[i] * parts[i][1] for i in range(splits))
                    A = sum(w[i][:, None] * parts[i][2] for i in range(splits))
                    o = A / np.maximum(L, 1e-30)[:, None]
                out[b, c, h * G + g] = o
    return out


def _decode(case, seed):
    B, Hq, Hkv, D, ps, nL, P, lens, window, softcap = case
    c = cases.paged_case(B, Hq, Hkv, D, ps, nL, P, lens, seed=seed)
    kw = dict(causal=False, window=window, softcap=softcap)
    return c, c["q_position"], kw


def _prefill(case, seed):
    B, C, Hq, Hkv, D, ps, nL, P, starts, window, softcap, lengths = cases.prefill_row(case)
    c = cases.prefill_case(B, C, Hq, Hkv, D, ps, nL, P, starts, seed=seed, lengths=lengths)
    kw = dict(causal=True, window=window, softcap=softcap)
    return c, c["q_positions"][:, 0], kw


@functools.cache
def _pallas(kind, case):
    """The JAX Pallas kernel in interpret mode, fp32, once per case."""
    if kind == "decode":
        c, _, kw = _decode(case, seed=21)
        out = paged_attention_pallas(
            jnp.asarray(c["q"]), jnp.asarray(c["k_pages"]), jnp.asarray(c["v_pages"]),
            jnp.asarray(c["block_tables"]), q_position=jnp.asarray(c["q_position"]),
            cache_len=jnp.asarray(c["cache_len"]), window=kw["window"],
            softcap=kw["softcap"], interpret=True)
    else:
        c, _, kw = _prefill(case, seed=21)
        out = paged_prefill_attention_pallas(
            jnp.asarray(c["q"]), jnp.asarray(c["k_pages"]), jnp.asarray(c["v_pages"]),
            jnp.asarray(c["block_tables"]), q_positions=jnp.asarray(c["q_positions"]),
            cache_len=jnp.asarray(c["cache_len"]), causal=True, window=kw["window"],
            softcap=kw["softcap"], interpret=True)
    return np.asarray(out, np.float32)


EMULATED = ([("decode", c) for c in cases.PAGED_CASES + cases.PAGED_SPLIT_CASES]
            + [("prefill", c) for c in cases.PREFILL_CASES + cases.PREFILL_SPLIT_CASES])


@pytest.mark.parametrize("kind,case", EMULATED,
                         ids=[f"{k}{c[:9]}" for k, c in EMULATED])
def test_split_k_emulation_matches_pallas(kind, case):
    """The split-K algorithm with its fixed-order combine gives the Pallas
    kernel's output within 2e-5 (fp32), empty splits and rows that see no
    key (cache_len 0: output 0) included."""
    c, start, kw = (_decode if kind == "decode" else _prefill)(case, seed=21)
    got = split_k(c["q"], c["k_pages"], c["v_pages"], c["block_tables"], c["cache_len"],
                  start, **kw)
    np.testing.assert_allclose(got, _pallas(kind, case), atol=2e-5, rtol=2e-5)
    for b in np.flatnonzero(c["cache_len"] == 0):
        assert not got[b].any()


def test_split_cases_exercise_the_combine_and_empty_splits():
    """Each decode split case and the 16-row prefill case run more than one
    split, and the idle slot and the one-key row leave splits with no key
    (the combine's zero weight); the full-width prefill cases walk up to 8
    key tiles through one block's ring of stages."""
    for case in cases.PAGED_SPLIT_CASES:
        B, Hq, Hkv, D, ps, nL = case[:6]
        assert PA.tc_plan(B, 1, Hq, Hkv, D, ps, nL)[0] > 1
    B, C, Hq, Hkv, D, ps, nL = cases.PREFILL_SPLIT_CASES[-1][:7]
    assert PA.tc_plan(B, C, Hq, Hkv, D, ps, nL)[0] > 1
    assert {0, 1, 512} <= set(cases.PAGED_SPLIT_CASES[0][7])
    assert cases.PREFILL_SPLIT_CASES[0][8] == (448,)


FAULT_SHAPES = [("decode", cases.MAIN_PAGED), ("decode", cases.PAGED_SPLIT_CASES[0]),
                ("prefill", cases.PREFILL_SPLIT_CASES[-1])]


@pytest.mark.parametrize("fault", ["no_rescale", "drop_last_live_split"])
@pytest.mark.parametrize("kind,case", FAULT_SHAPES,
                         ids=[f"{k}{c[:8]}" for k, c in FAULT_SHAPES])
def test_gates_fail_combine_faults(fault, kind, case):
    """A combine that drops a split or skips the exp(m_i - m) rescale fails
    the gates at bf16's tolerance, against the plain version."""
    c, start, kw = (_decode if kind == "decode" else _prefill)(case, seed=22)
    t = {n: torch.from_numpy(c[n]) for n in c}
    args = (t["q"], t["k_pages"], t["v_pages"], t["block_tables"])
    if kind == "decode":
        want = paged_attention_reference(*args, q_position=t["q_position"],
                                         cache_len=t["cache_len"], window=kw["window"],
                                         softcap=kw["softcap"]).numpy()
    else:
        want = paged_prefill_attention_reference(
            *args, q_positions=t["q_positions"], cache_len=t["cache_len"], causal=True,
            window=kw["window"], softcap=kw["softcap"]).numpy()
    ok = split_k(c["q"], c["k_pages"], c["v_pages"], c["block_tables"], c["cache_len"],
                 start, **kw)
    bad = split_k(c["q"], c["k_pages"], c["v_pages"], c["block_tables"], c["cache_len"],
                  start, fault=fault, **kw)
    assert cases.l2_rel_err(ok, want) <= cases.TOL_L2_PAGED["float32"]
    assert cases.max_rel_err(ok, want) <= cases.TOL_MAX["float32"]
    assert (cases.l2_rel_err(bad, want) > cases.TOL_L2_PAGED["bfloat16"]
            and cases.max_rel_err(bad, want) > cases.TOL_MAX["bfloat16"])


def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_card_gates_fail_non_finite_readings(dtype):
    """A kernel that writes NaN gives NaN readings, which no comparison
    with a limit passes: the gates of phase 2 count them as failures."""
    C = _chip_smoke()
    nan = float("nan")
    assert len(C.paged_failures({"abs": nan, "max": nan, "l2": nan}, dtype)) == 3
    assert len(C.flash_failures({"fwd_max": nan, "fwd_l2": 0.0, "bwd_max": 0.0,
                                 "bwd_l2": nan}, dtype)) == 2
    assert C.paged_failures({"abs": 0.0, "max": 0.0, "l2": 0.0}, dtype) == []
