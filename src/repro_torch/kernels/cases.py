"""Seeded kernel test cases, as numpy, for both frameworks.

The case tables are those of the JAX package's ``tests/test_kernels.py``
(``FLASH_CASES``, ``PAGED_CASES``, ``PREFILL_CASES``, ``RMS_CASES``), plus
``FLASH_KVLEN_CASES`` for the position and ``kv_len`` masking of
``layers.attention.flash_attention``, ``RMS_WIDTH_CASES`` for the model
widths of the RMSNorm kernels, and ``PAGED_SPLIT_CASES`` and
``PREFILL_SPLIT_CASES`` for the split-K edges of the bf16 paged kernels;
the functions below make the inputs with numpy from a seed, so the JAX
functions and the port's kernels and plain versions see the same numbers. ``MAIN_*`` are the shapes the serving
and training paths give the kernels at tinyllama-1.1b's full width.
"""

from __future__ import annotations

import numpy as np

FLASH_CASES = [
    # B, Sq, Sk, Hq, Hkv, D, causal, window, softcap
    (2, 256, 256, 4, 2, 64, True, None, None),
    (1, 128, 128, 4, 4, 64, False, None, None),
    (1, 256, 256, 2, 1, 64, True, 64, None),      # sliding window
    (2, 64, 64, 8, 2, 32, True, None, 30.0),      # softcap (gemma2)
    (1, 200, 200, 2, 2, 48, True, None, None),    # non-multiple-of-block seq
    (1, 96, 96, 2, 1, 100, False, 32, 50.0),      # padding in D + win + cap
]

FLASH_KVLEN_CASES = [
    # B, Sq, Sk, Hq, Hkv, D, causal, window, softcap, q_offset, kv_len
    # a chunk at positions 64.. against 128 keys, one row's keys cut at 90
    (2, 64, 128, 4, 2, 64, True, None, None, 64, (128, 90)),
    # bidirectional, window and softcap, a short row
    (2, 48, 48, 4, 4, 32, False, 16, 30.0, 0, (48, 20)),
    # kv_len 0: every row of batch row 1 fully masked (output and grads 0)
    (2, 40, 40, 2, 1, 100, True, None, None, 0, (40, 0)),
]

PAGED_CASES = [
    # B, Hq, Hkv, D, psize, nL, P, lens, window, softcap
    (3, 4, 2, 64, 4, 4, 12, (6, 3, 11), None, None),
    (2, 4, 4, 64, 16, 4, 9, (50, 17), None, None),
    (2, 2, 1, 64, 4, 8, 20, (29, 13), 6, None),     # window crosses pages
    (2, 8, 2, 32, 8, 3, 8, (20, 9), None, 30.0),    # softcap (gemma2)
    (1, 2, 2, 100, 8, 4, 6, (27,), 11, 50.0),       # odd D + win + cap
]

PREFILL_CASES = [
    # B, C, Hq, Hkv, D, psize, nL, P, starts, window, softcap
    (2, 8, 4, 2, 64, 4, 6, 14, (0, 8), None, None),     # ragged starts, GQA
    (1, 16, 4, 4, 64, 16, 2, 3, (16,), None, None),     # page == chunk
    (2, 8, 2, 1, 64, 4, 8, 18, (4, 12), 6, None),       # window crosses pages
    (2, 8, 8, 2, 32, 8, 3, 7, (0, 16), None, 30.0),     # softcap (gemma2)
    (1, 8, 2, 2, 100, 8, 4, 5, (8,), 5, 50.0),          # odd D + win + cap
]

# Split-K over pages (the bf16 route's ``ops.tc_plan``): groups of at most
# 16 query rows split; at the serving widths a decode split holds 4 pages
# (64 keys), and a 64-token prefill chunk walks its table in one split.
# Idle slot (cache_len 0), one key, one below a split boundary, a full
# table; a window that starts inside an earlier split; odd head dims and
# soft-caps over several splits (D = 30: element-wise staging and
# combine); the last chunk of a 512-token table; a 2-token chunk (16 rows)
# that splits, one row ending at a split boundary.
PAGED_SPLIT_CASES = [
    # B, Hq, Hkv, D, psize, nL, P, lens, window, softcap
    (4, 32, 4, 64, 16, 32, 40, (0, 1, 63, 512), None, None),
    (2, 32, 4, 64, 16, 32, 40, (300, 200), 100, None),
    (3, 8, 2, 32, 8, 16, 40, (0, 57, 128), 20, 30.0),
    (2, 4, 2, 100, 8, 12, 30, (95, 9), 11, 50.0),
    (2, 4, 2, 30, 8, 12, 30, (70, 33), None, None),       # D % 4 != 0
]

PREFILL_SPLIT_CASES = [
    # B, C, Hq, Hkv, D, psize, nL, P, starts, window, softcap
    (1, 64, 32, 4, 64, 16, 32, 40, (448,), None, None),   # last chunk, full table
    (1, 64, 32, 4, 64, 16, 32, 40, (256,), 100, None),    # window from split 1
    (2, 24, 8, 2, 32, 8, 16, 40, (0, 100), 30, 30.0),     # ragged row tiles, cap
    (2, 2, 8, 1, 64, 16, 32, 40, (300, 62), 100, None),   # 16 rows: 8 splits
]

RMS_CASES = [(4, 128), (3, 300), (1, 1024), (17, 96)]
# every model width of ``configs/archs.py`` (rows, d): the RMSNorm kernels'
# row layouts from one warp a row to sixteen
RMS_WIDTH_CASES = [(5, d) for d in (1024, 1280, 2048, 2304, 2560, 4096, 6144, 8192)]

# tinyllama-1.1b serving: Hq=32, Hkv=4, D=64, page 16, max_len 512 (32
# logical pages), batch 4 decode slots, 64-token prefill chunks, d=2048
MAIN_PAGED = (4, 32, 4, 64, 16, 32, 128, (97, 160, 223, 288), None, None)
MAIN_PREFILL = (1, 64, 32, 4, 64, 16, 32, 128, (192,), None, None)
MAIN_RMS = [(4, 2048), (64, 2048)]
# tinyllama-1.1b training step: B=4, S=2048, Hq=32, Hkv=4, D=64, causal;
# RMSNorm over B*S = 8192 rows of 2048
MAIN_FLASH = (4, 2048, 2048, 32, 4, 64, True, None, None)
MAIN_RMS_TRAIN = (8192, 2048)


# Gates of a kernel against its plain version, by dtype. TOL_MAX bounds the
# largest error over the largest |value| (at least 1); TOL_L2 bounds the
# relative L2 error, which a fault confined to some rows (a lost rescale, a
# skipped tile) moves even where the largest |value| lies in rows that the
# fault leaves alone. Both take numpy arrays.
TOL_MAX = {"float32": 1e-4, "bfloat16": 2e-2}
TOL_L2 = {"float32": 1e-5, "bfloat16": 1e-2}
# paged attention (K3, K4), beside the elementwise TOL_MAX gate
TOL_L2_PAGED = {"float32": 1e-5, "bfloat16": 1e-2}
# RMSNorm (K1) forward and backward, beside the elementwise gates: about 5x
# the largest readings of the CUDA kernels over every case of chip_smoke.py
# phase 2 on an H100 (f32 2.1e-7, bf16 3.1e-5; PERF.md)
TOL_L2_RMS = {"float32": 1e-6, "bfloat16": 2e-4}


def max_rel_err(got, want) -> float:
    """max |got - want| over max(1, max |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max(initial=0.0) / max(1.0, np.abs(want).max(initial=0.0)))


def l2_rel_err(got, want) -> float:
    """||got - want||_2 over ||want||_2; the absolute norm where want is 0."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, ref = float(np.linalg.norm(got - want)), float(np.linalg.norm(want))
    return err / ref if ref > 0 else err


def _table(rng, B, nL, P, psize, lens):
    """Scrambled block table backing ``lens[b]`` tokens per row, -1 past."""
    perm = rng.permutation(P)
    tbl = np.full((B, nL), -1, np.int32)
    used = 0
    for b, ln in enumerate(lens):
        n = -(-ln // psize)
        tbl[b, :n] = perm[used:used + n]
        used += n
    return tbl


def paged_case(B, Hq, Hkv, D, psize, nL, P, lens, seed=0) -> dict:
    """Decode inputs: q (B,1,Hq,D), pools (P,psize,Hkv,D) fp32, table,
    cache_len = lens and q_position = lens - 1."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    return {"q": f(B, 1, Hq, D), "k_pages": f(P, psize, Hkv, D),
            "v_pages": f(P, psize, Hkv, D),
            "block_tables": _table(rng, B, nL, P, psize, lens),
            "cache_len": lens, "q_position": lens - 1}


def prefill_case(B, C, Hq, Hkv, D, psize, nL, P, starts, seed=0) -> dict:
    """Prefill inputs: a C-token chunk per row at ``starts[b]``; cache_len =
    start + C; q_positions (B,C) contiguous."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    lens = np.asarray([s + C for s in starts], np.int32)
    qpos = (np.asarray(starts)[:, None] + np.arange(C)[None]).astype(np.int32)
    return {"q": f(B, C, Hq, D), "k_pages": f(P, psize, Hkv, D),
            "v_pages": f(P, psize, Hkv, D),
            "block_tables": _table(rng, B, nL, P, psize, lens),
            "cache_len": lens, "q_positions": qpos}


def flash_case(B, Sq, Sk, Hq, Hkv, D, seed=0, q_offset=0, kv_len=None) -> dict:
    """q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D) and a cotangent dout like q, fp32;
    positions: queries at ``q_offset + i``, keys at ``j``; kv_len (B,) or
    None."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"q": f(B, Sq, Hq, D), "k": f(B, Sk, Hkv, D), "v": f(B, Sk, Hkv, D),
            "dout": f(B, Sq, Hq, D),
            "q_positions": np.broadcast_to(q_offset + np.arange(Sq, dtype=np.int32),
                                           (B, Sq)).copy(),
            "k_positions": np.broadcast_to(np.arange(Sk, dtype=np.int32), (B, Sk)).copy(),
            "kv_len": None if kv_len is None else np.asarray(kv_len, np.int32)}


def rms_case(rows, d, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((rows, d)).astype(np.float32),
            "scale": rng.standard_normal(d).astype(np.float32),
            "dy": rng.standard_normal((rows, d)).astype(np.float32)}
