"""Seeded kernel test cases, as numpy, for both frameworks.

The case tables are those of the JAX package's ``tests/test_kernels.py``
(``FLASH_CASES``, ``PAGED_CASES``, ``PREFILL_CASES``, ``RMS_CASES``), plus
``FLASH_KVLEN_CASES`` for the position and ``kv_len`` masking of
``layers.attention.flash_attention``, ``RMS_WIDTH_CASES`` for the model
widths of the RMSNorm kernels, and ``PAGED_SPLIT_CASES`` and
``PREFILL_SPLIT_CASES`` for the split-K edges of the bf16 paged kernels
and for block tables that share pages across rows, as the prefix cache
makes them;
the functions below make the inputs with numpy from a seed, so the JAX
functions and the port's kernels and plain versions see the same numbers. ``MAIN_*`` are the shapes the serving
and training paths give the kernels at tinyllama-1.1b's full width, and
``*_ARCH_*`` those of the other archs (the MoE ones' rows named
``*_QWEN3``, ``*_DBRX``; the hybrid zamba2-2.7b's ``*_ZAMBA2``).
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
    # the loaded server's decode (batch 16, max_len 1024: 3 splits of 24
    # pages) under prefix sharing: a 250-token system prompt's 15 full pages
    # named by all 16 rows (288 logical pages on 63 of a 70-page pool)
    (16, 32, 4, 64, 16, 64, 70,
     (258, 280, 314, 251, 266, 300, 253, 290, 262, 310, 275, 257, 299, 268, 284, 305),
     None, None),
]

PREFILL_SPLIT_CASES = [
    # B, C, Hq, Hkv, D, psize, nL, P, starts, window, softcap
    (1, 64, 32, 4, 64, 16, 32, 40, (448,), None, None),   # last chunk, full table
    (1, 64, 32, 4, 64, 16, 32, 40, (256,), 100, None),    # window from split 1
    (2, 24, 8, 2, 32, 8, 16, 40, (0, 100), 30, 30.0),     # ragged row tiles, cap
    # after a copy-on-write hit: chunks that start mid-page over tables whose
    # first 15 entries are another row's pages
    (2, 64, 32, 4, 64, 16, 64, 26, (250, 265), None, None),
    # the speculative verify at batch 16, spec_k 4 (max_len 1024): one
    # [last token, 4 drafts] row a slot at its own start, ragged lengths
    # (a 12th field), windows that cross page boundaries, an idle slot
    # (length 0, no key) and a row with no draft (length 1)
    (16, 5, 32, 4, 64, 16, 64, 320,
     (0, 97, 14, 250, 31, 126, 300, 511, 62, 190, 777, 1019, 158, 45, 383, 600),
     None, None, (0, 1, 5, 5, 3, 5, 2, 4, 4, 5, 5, 5, 3, 5, 1, 5)),
    (2, 2, 8, 1, 64, 16, 32, 40, (300, 62), 100, None),   # 16 rows: 8 splits
]

RMS_CASES = [(4, 128), (3, 300), (1, 1024), (17, 96)]
# every model width of ``configs/archs.py`` (rows, d): the RMSNorm kernels'
# row layouts from one warp a row to sixteen
# (5120: zamba2's gated norm over the mamba2 inner width)
RMS_WIDTH_CASES = [(5, d) for d in (1024, 1280, 2048, 2304, 2560, 4096, 5120, 6144, 8192)]

# tinyllama-1.1b serving: Hq=32, Hkv=4, D=64, page 16, max_len 512 (32
# logical pages), batch 4 decode slots, 64-token prefill chunks, d=2048
MAIN_PAGED = (4, 32, 4, 64, 16, 32, 128, (97, 160, 223, 288), None, None)
MAIN_PREFILL = (1, 64, 32, 4, 64, 16, 32, 128, (192,), None, None)
MAIN_RMS = [(4, 2048), (64, 2048)]
# tinyllama-1.1b training step: B=4, S=2048, Hq=32, Hkv=4, D=64, causal;
# RMSNorm over B*S = 8192 rows of 2048
MAIN_FLASH = (4, 2048, 2048, 32, 4, 64, True, None, None)
MAIN_RMS_TRAIN = (8192, 2048)
# tinyllama-1.1b serving on the dense KV layout (max_len 512) through K2,
# forward only: a decode step, one query row a slot at positions 96..287
# against 512 keys cut at kv_len = position + 1; a 64-token chunk at 192
# into one slot's row, keys cut at kv_len 256. Rows as FLASH_KVLEN_CASES
# (q_offset per row for the decode)
MAIN_FLASH_DECODE = (4, 1, 512, 32, 4, 64, True, None, None, (96, 159, 222, 287),
                     (97, 160, 223, 288))
MAIN_FLASH_CHUNK = (1, 64, 512, 32, 4, 64, True, None, None, 192, (256,))
MAIN_FLASH_DENSE = [MAIN_FLASH_DECODE, MAIN_FLASH_CHUNK]

# The other dense archs (gemma2-2b, glm4-9b, command-r-35b,
# llava-next-mistral-7b, hubert-xlarge) give the kernels new shapes: head
# dim 256 (gemma2: the tensor-core K2 at DP = 256 with one stage, the fp32
# K2 at D = 256, the tensor-core K3/K4 at 32-key tiles), a sliding window
# of 4096 that cuts keys, GQA groups of 16 (glm4, 2 kv heads) and 8
# (command-r), a bidirectional K2 at D = 80 (hubert). The ``*_ARCH_SMALL``
# rows carry those shapes at small sequence lengths, for the CPU tests
# against the JAX functions; the others are the paths' own shapes.
#
# K2 (B, Sq, Sk, Hq, Hkv, D, causal, window, softcap)
FLASH_ARCH_SMALL = [
    (1, 96, 96, 8, 4, 256, True, 32, 50.0),       # gemma2 local: window cuts keys
    (1, 80, 80, 8, 4, 256, True, None, 50.0),     # gemma2 global
    (1, 64, 64, 32, 2, 128, True, None, None),    # glm4: G = 16
    (2, 48, 48, 16, 16, 80, False, None, None),   # hubert: bidirectional
    (1, 64, 64, 32, 4, 128, True, None, None),    # qwen3: G = 8, D = 128
    (1, 64, 64, 32, 32, 80, True, None, None),    # zamba2: G = 1, causal, D = 80
]
# gemma2-2b training (B 1, S 8192): the local layers (window 4096) and the
# global ones, softcap 50
MAIN_FLASH_GEMMA2 = (1, 8192, 8192, 8, 4, 256, True, 4096, 50.0)
MAIN_FLASH_GEMMA2_GLOBAL = (1, 8192, 8192, 8, 4, 256, True, None, 50.0)
FLASH_GLM4 = (1, 2048, 2048, 32, 2, 128, True, None, None)
# llava-next-mistral-7b training (B 2, S 2048: 1152 patch embeddings, 896
# text tokens) and hubert-xlarge training (B 4, 1024 frames)
MAIN_FLASH_LLAVA = (2, 2048, 2048, 32, 8, 128, True, None, None)
MAIN_FLASH_HUBERT = (4, 1024, 1024, 16, 16, 80, False, None, None)
# qwen3-moe-30b-a3b training (B 1, S 4096: 32/4 heads, head dim 128)
MAIN_FLASH_QWEN3 = (1, 4096, 4096, 32, 4, 128, True, None, None)
# zamba2-2.7b training (B 1, S 4096): its attention layers at 32/32 heads
# (G 1), head dim 80 (padded to 128 on the tensor-core route), causal
MAIN_FLASH_ZAMBA2 = (1, 4096, 4096, 32, 32, 80, True, None, None)
# tinyllama-1.1b training on a (1, 2) tensor-parallel mesh (chip_smoke.py
# phase 6b (b)): a rank's 16 of 32 query heads and 2 of 4 kv heads over the
# whole sequence; its RMSNorms run on its sequence half, 4096 of phase 6's
# 8192 rows of 2048 (qwen3's training row of RMS_ARCH_CASES)
MAIN_FLASH_MESH = (4, 2048, 2048, 16, 2, 64, True, None, None)
MAIN_RMS_MESH = (4096, 2048)
# gemma2-2b training on a (1, 2) fsdp mesh at B 1 x S 8192 (chip_smoke.py
# phase 6b (d), context parallelism): a rank's 4096-query block against the
# gathered 8192 keys, at its true positions (rank 0 from 0, rank 1 from
# 4096), local (window 4096) and global layers. Rows as FLASH_KVLEN_CASES:
# (B, Sq, Sk, Hq, Hkv, D, causal, window, softcap, q_offset, kv_len)
MAIN_FLASH_CP_LOCAL = [(1, 4096, 8192, 8, 4, 256, True, 4096, 50.0, off, None)
                       for off in (0, 4096)]
MAIN_FLASH_CP_GLOBAL = [(1, 4096, 8192, 8, 4, 256, True, None, 50.0, off, None)
                        for off in (0, 4096)]
# zamba2-2.7b training on a (1, 2) megatron mesh (phase 6b (c)): its
# attention layer at a rank's 16 of 32 heads (G 1, head dim 80)
MAIN_FLASH_ZAMBA2_TP = (1, 4096, 4096, 16, 16, 80, True, None, None)
# the one-shot serving steps (chip_smoke.py phase ``oneshot``). (a)
# tinyllama-1.1b's one-shot prefill of a 32,768-token prompt (the
# prefill_32k shape's length): B 1, 32/4 heads, head dim 64, causal over
# the prompt itself. (c) glm4-9b's decode step on a (1, 4) mesh, whose 2 kv
# heads do not divide 4: the dense cache of max_len 4,160 splits its
# sequence, and a rank (here rank 3, keys at 3,120..4,159) attends one query
# row a slot, all 32 query heads, against its 1,040-key block at the
# block's true positions, cut at kv_len, returning the LSE; the second
# slot's query (position 3,000) sees no key of the block: its LSE is -inf.
# Rows as FLASH_KVLEN_CASES with a 12th field, the keys' first position.
MAIN_FLASH_ONESHOT = (1, 32768, 32768, 32, 4, 64, True, None, None, 0, None, 0)
MAIN_FLASH_SPLIT_DECODE = (2, 1, 1040, 32, 2, 128, True, None, None, (4100, 3000),
                           (4101, 3001), 3120)
FLASH_ARCH_CASES = FLASH_ARCH_SMALL + [MAIN_FLASH_GEMMA2, MAIN_FLASH_GEMMA2_GLOBAL,
                                       FLASH_GLM4, MAIN_FLASH_LLAVA, MAIN_FLASH_HUBERT,
                                       MAIN_FLASH_QWEN3, MAIN_FLASH_ZAMBA2, MAIN_FLASH_MESH,
                                       MAIN_FLASH_ZAMBA2_TP]

# K3 (B, Hq, Hkv, D, psize, nL, P, lens, window, softcap)
PAGED_ARCH_SMALL = [
    (2, 8, 4, 256, 8, 8, 20, (50, 29), 16, 50.0),    # gemma2: window crosses pages
    (2, 8, 4, 256, 8, 8, 20, (61, 7), None, 50.0),
    (2, 32, 2, 128, 8, 4, 10, (30, 17), None, None),  # glm4: G = 16
    (2, 64, 8, 128, 8, 4, 10, (25, 9), None, None),   # command-r: G = 8
    (2, 32, 4, 128, 8, 4, 10, (30, 17), None, None),  # qwen3: G = 8
    (3, 48, 8, 128, 8, 4, 12, (27, 11, 1), None, None),  # dbrx: G = 6
    (3, 32, 32, 80, 8, 4, 12, (30, 17, 0), None, None),  # zamba2: G = 1, D = 80, idle
]
# gemma2-2b serving (batch 4, max_len 8192: 512 logical pages of 16) with
# prompts of 4,300-6,100 tokens: the local layers' window 4096 cuts keys,
# the global layers read every page
MAIN_PAGED_GEMMA2 = (4, 8, 4, 256, 16, 512, 1400, (4300, 4913, 5507, 6100), 4096, 50.0)
MAIN_PAGED_GEMMA2_GLOBAL = (4, 8, 4, 256, 16, 512, 1400, (4300, 4913, 5507, 6100),
                            None, 50.0)
PAGED_GLM4 = (4, 32, 2, 128, 16, 128, 520, (700, 1500, 2047, 333), None, None)
PAGED_COMMAND_R = (4, 64, 8, 128, 16, 128, 520, (700, 1500, 2047, 333), None, None)
# the MoE archs' serving (batch 4, max_len 2048): qwen3 at G 8, dbrx at
# G 6 (a 16-row tile of the tensor-core kernel spans 2 2/3 query heads'
# groups)
PAGED_QWEN3 = (4, 32, 4, 128, 16, 128, 520, (700, 1500, 2047, 333), None, None)
PAGED_DBRX = (4, 48, 8, 128, 16, 128, 520, (700, 1500, 2047, 333), None, None)
# zamba2-2.7b's serving (batch 4, max_len 2048): MHA (G 1) at head dim 80,
# which the tensor-core route serves on its DP = 128 instance
PAGED_ZAMBA2 = (4, 32, 32, 80, 16, 128, 520, (700, 1500, 2047, 333), None, None)
# tinyllama-1.1b's scheduler on a (1, 2) mesh (chip_smoke.py phase
# ``serve_mesh``): a rank's 16 of 32 query heads and 2 of 4 KV heads (G 8),
# its block of the pool (max_len 512: 32 logical pages of 16); the decode
# over the 8 slots' rows, which the "data" axis of 1 leaves whole
PAGED_MESH = (8, 16, 2, 64, 16, 32, 160, (97, 160, 223, 288, 75, 130, 201, 310), None, None)
PAGED_ARCH_CASES = PAGED_ARCH_SMALL + [MAIN_PAGED_GEMMA2, MAIN_PAGED_GEMMA2_GLOBAL,
                                       PAGED_GLM4, PAGED_COMMAND_R, PAGED_QWEN3, PAGED_DBRX,
                                       PAGED_ZAMBA2, PAGED_MESH]

# K4 (B, C, Hq, Hkv, D, psize, nL, P, starts, window, softcap)
PREFILL_ARCH_SMALL = [
    (1, 16, 8, 4, 256, 8, 12, 14, (40,), 16, 50.0),     # gemma2: the window splits
    (2, 8, 32, 2, 128, 4, 6, 14, (0, 8), None, None),   # glm4: G = 16
    (1, 8, 64, 8, 128, 4, 6, 8, (12,), None, None),     # command-r: G = 8
    (2, 8, 32, 4, 128, 4, 6, 14, (0, 8), None, None),   # qwen3: G = 8
    (1, 8, 48, 8, 128, 4, 6, 8, (10,), None, None),     # dbrx: G = 6, mid-page
    (2, 5, 48, 8, 128, 4, 6, 14, (3, 9), None, None),   # dbrx: 30 rows, ragged tile
    (2, 8, 32, 32, 80, 4, 6, 14, (0, 8), None, None),   # zamba2: G = 1, D = 80
]
# a gemma2-2b chunk of 64 past 4096: the window's first key (405..468)
# lies inside a page, so the window crosses and splits pages
MAIN_PREFILL_GEMMA2 = (1, 64, 8, 4, 256, 16, 512, 400, (4500,), 4096, 50.0)
MAIN_PREFILL_GEMMA2_GLOBAL = (1, 64, 8, 4, 256, 16, 512, 400, (4500,), None, 50.0)
PREFILL_GLM4 = (1, 64, 32, 2, 128, 16, 128, 140, (1000,), None, None)
# the MoE archs' 64-token chunks at 1000, which starts mid-page (62 * 16 + 8)
PREFILL_QWEN3 = (1, 64, 32, 4, 128, 16, 128, 140, (1000,), None, None)
PREFILL_DBRX = (1, 64, 48, 8, 128, 16, 128, 140, (1000,), None, None)
# zamba2-2.7b: a 64-token chunk at 1000 (G 1, D 80), and its speculative
# verify (spec_k 4: C 5) at batch 4, ragged lengths and an idle slot. The
# verify's two passes (scoring, then the commit of the accepted prefix)
# launch the kernel twice at this shape, the second over positions the
# first wrote
PREFILL_ZAMBA2 = (1, 64, 32, 32, 80, 16, 128, 140, (1000,), None, None)
PREFILL_ZAMBA2_VERIFY = (4, 5, 32, 32, 80, 16, 128, 520, (700, 1500, 2040, 333), None, None,
                         (5, 3, 1, 0))
# the same rank's 64-token chunk of one row at 200 (12 * 16 + 8: mid-page)
PREFILL_MESH = (1, 64, 16, 2, 64, 16, 32, 160, (200,), None, None)
PREFILL_ARCH_CASES = PREFILL_ARCH_SMALL + [MAIN_PREFILL_GEMMA2, MAIN_PREFILL_GEMMA2_GLOBAL,
                                           PREFILL_GLM4, PREFILL_QWEN3, PREFILL_DBRX,
                                           PREFILL_ZAMBA2, PREFILL_ZAMBA2_VERIFY, PREFILL_MESH]

# K1 (rows, d, zero_centred) on the new paths: gemma2's zero-centred norm
# at 2304 (a decode step, a chunk, the training step's 8192 rows), glm4 and
# llava at 4096, command-r at 8192, hubert's training rows at 1280; the MoE
# archs: qwen3's qk-norm over head dim 128 (a decode step's 4 x 32 query
# rows, the training step's 4096 x 32 query and 4096 x 4 key rows), its
# training block norm (4096 x 2048), dbrx's decode at 6144; the recurrent
# archs: zamba2's block norms at 2560 and the mamba2 gated norm at 5120 (a
# decode step, a 64-token chunk, the training step's 4096 rows), xlstm's
# block norms at 1024 and the mLSTM norm at 2048 (a decode step; training,
# B 4 x S 1024: 4096 rows, the 2048-wide ones qwen3's row)
RMS_ARCH_CASES = [(4, 2304, True), (64, 2304, True), (8192, 2304, True), (4, 4096, False),
                  (4, 8192, False), (4096, 1280, False), (128, 128, False),
                  (131072, 128, False), (16384, 128, False), (4096, 2048, False),
                  (4, 6144, False), (4, 2560, False), (4, 5120, False), (64, 5120, False),
                  (4096, 2560, False), (4096, 5120, False), (4, 1024, False),
                  (4, 2048, False), (4096, 1024, False)]


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
    """max |got - want| over max(1, max |want|). numpy arrays, or torch
    tensors, read in float64 on their own device (no host copy)."""
    if hasattr(got, "detach"):  # a torch tensor
        if got.numel() == 0:
            return 0.0
        got, want = got.detach().double(), want.detach().double()
        return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max(initial=0.0) / max(1.0, np.abs(want).max(initial=0.0)))


def l2_rel_err(got, want) -> float:
    """||got - want||_2 over ||want||_2; the absolute norm where want is 0.
    numpy arrays, or torch tensors read in float64 on their own device."""
    if hasattr(got, "detach"):  # a torch tensor
        got, want = got.detach().double(), want.detach().double()
        err, ref = float((got - want).norm()), float(want.norm())
    else:
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        err, ref = float(np.linalg.norm(got - want)), float(np.linalg.norm(want))
    return err / ref if ref > 0 else err


def _table(rng, B, nL, P, psize, lens):
    """Scrambled block table backing ``lens[b]`` tokens per row, -1 past.
    Rows own disjoint pages while the pool ``P`` holds them all. A smaller
    pool makes the rows share, as prefix sharing does: every row after the
    first maps its first ``s`` logical pages onto row 0's, ``s`` the fewest
    that fit."""
    perm = rng.permutation(P)
    need = [-(-ln // psize) for ln in lens]
    shared = next(s for s in range(need[0] + 1)
                  if need[0] + sum(max(n - s, 0) for n in need[1:]) <= P)
    tbl = np.full((B, nL), -1, np.int32)
    used = 0
    for b, n in enumerate(need):
        k = min(shared, n) if b else 0
        tbl[b, :k] = tbl[0, :k]
        tbl[b, k:n] = perm[used:used + n - k]
        used += n - k
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


def prefill_row(case) -> tuple:
    """A ``PREFILL_*`` row as (B, C, Hq, Hkv, D, psize, nL, P, starts,
    window, softcap, lengths); ``lengths`` is None where every row fills
    its chunk."""
    return tuple(case) if len(case) == 12 else (*case, None)


def prefill_case(B, C, Hq, Hkv, D, psize, nL, P, starts, seed=0, lengths=None) -> dict:
    """Prefill inputs: a C-token chunk per row at ``starts[b]``, of which
    ``lengths[b]`` tokens are written (default C; the rest is padding that
    still attends); cache_len = start + length; q_positions (B,C)
    contiguous."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    lengths = [C] * len(starts) if lengths is None else lengths
    lens = np.asarray([s + n for s, n in zip(starts, lengths)], np.int32)
    qpos = (np.asarray(starts)[:, None] + np.arange(C)[None]).astype(np.int32)
    return {"q": f(B, C, Hq, D), "k_pages": f(P, psize, Hkv, D),
            "v_pages": f(P, psize, Hkv, D),
            "block_tables": _table(rng, B, nL, P, psize, lens),
            "cache_len": lens, "q_positions": qpos}


def flash_case(B, Sq, Sk, Hq, Hkv, D, seed=0, q_offset=0, kv_len=None,
               k_offset: int = 0) -> dict:
    """q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D) and a cotangent dout like q, fp32;
    positions: queries at ``q_offset + i`` (``q_offset`` an int or one a
    row), keys at ``k_offset + j``; kv_len (B,) or None."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"q": f(B, Sq, Hq, D), "k": f(B, Sk, Hkv, D), "v": f(B, Sk, Hkv, D),
            "dout": f(B, Sq, Hq, D),
            "q_positions": np.broadcast_to(
                np.asarray(q_offset, np.int32).reshape(-1, 1) + np.arange(Sq, dtype=np.int32),
                (B, Sq)).copy(),
            "k_positions": np.broadcast_to(k_offset + np.arange(Sk, dtype=np.int32),
                                           (B, Sk)).copy(),
            "kv_len": None if kv_len is None else np.asarray(kv_len, np.int32)}


def rms_case(rows, d, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((rows, d)).astype(np.float32),
            "scale": rng.standard_normal(d).astype(np.float32),
            "dy": rng.standard_normal((rows, d)).astype(np.float32)}
