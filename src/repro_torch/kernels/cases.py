"""Seeded kernel test cases, as numpy, for both frameworks.

The case tables are those of the JAX package's ``tests/test_kernels.py``
(``PAGED_CASES``, ``PREFILL_CASES``, ``RMS_CASES``); the functions below
make the inputs with numpy from a seed, so the JAX kernels and the port's
kernels and plain versions see the same numbers. ``MAIN_*`` are the shapes the
serving path gives the kernels at tinyllama-1.1b's full width.
"""

from __future__ import annotations

import numpy as np

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

RMS_CASES = [(4, 128), (3, 300), (1, 1024), (17, 96)]

# tinyllama-1.1b serving: Hq=32, Hkv=4, D=64, page 16, max_len 512 (32
# logical pages), batch 4 decode slots, 64-token prefill chunks, d=2048
MAIN_PAGED = (4, 32, 4, 64, 16, 32, 128, (97, 160, 223, 288), None, None)
MAIN_PREFILL = (1, 64, 32, 4, 64, 16, 32, 128, (192,), None, None)
MAIN_RMS = [(4, 2048), (64, 2048)]


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


def rms_case(rows, d, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((rows, d)).astype(np.float32),
            "scale": rng.standard_normal(d).astype(np.float32)}
