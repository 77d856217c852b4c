#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card
and check them.

    python3 chip_smoke.py

Run from the repository root (it puts ``src`` on ``sys.path`` itself). It
needs one NVIDIA GPU and ``nvcc``; it builds every kernel from the sources
in the checkout and imports no JAX. Phases, each printing one JSON
line with its own seconds, and any failure ends the run with a non-zero
exit:

1. build   compile ``csrc/paged_attention.cu`` (K3/K4's fp32 route),
           ``csrc/paged_attention_tc.cu`` (K3/K4's bf16 tensor-core route),
           ``csrc/flash_attention.cu`` (K2's fp32 route),
           ``csrc/flash_attention_tc.cu`` (K2's bf16 tensor-core route) and
           ``csrc/rmsnorm.cu`` (K1 forward and backward, both dtypes), one
           nvcc each, sm_90a, concurrently; report each tensor-core and
           RMSNorm kernel's registers, spills and shared memory (ptxas log;
           an RMSNorm kernel that spills fails the phase) and check with
           ``cuobjdump -sass``, where the toolkit has it, that the bf16 K2
           forward holds HGMMA and the other tensor-core kernels HGMMA or
           HMMA, and that every RMSNorm kernel of the 16-byte path holds
           16-byte loads (LDG.E.128); a kernel without fails the phase;
2. kernels each kernel against its plain PyTorch version on the card, over
           the JAX package's case tables and the serving and training
           paths' shapes (the other dense archs' too: head dim 256 with a
           window of 4096 and soft-caps, GQA groups of 16 and 8, a
           bidirectional head dim 80): paged attention (both routes, with the split-K
           cases too) and RMSNorm forward f32 within 1e-4 (the page loop
           sums in another order than the gather), bf16 within 2e-2 (RMSNorm
           also at the training shape and every model width, within
           ``cases.TOL_MAX`` of the largest |value| and ``cases.TOL_L2_RMS``
           of the relative L2 error), paged
           attention also within ``cases.TOL_MAX`` of the largest |value|
           and ``cases.TOL_L2_PAGED`` of the relative L2 error, two paged
           calls bitwise equal, and each dtype on its own paged route;
           flash attention forward and backward (dq, dk,
           dv against the plain version's autograd), the flash attention
           forward at the dense KV layout's decode and chunk shapes
           (``cases.MAIN_FLASH_DENSE``) and at the one-shot steps' (the
           32,768-token prefill against the plain version in 1024-query
           blocks, and a rank's key block of a split decode with its LSE:
           -inf and a 0 output where a row sees no key of the block), and
           the RMSNorm
           backward within 1e-4 (f32) and 2e-2 (bf16) of the largest
           |value| (at least of 1), flash attention also within
           ``cases.TOL_L2`` and the RMSNorm backward within
           ``cases.TOL_L2_RMS`` of the relative L2 error (which a fault in
           some rows moves where the largest |value| lies in others); two
           flash backward calls, and two RMSNorm backward calls, must give
           bitwise-equal gradients; f32 flash must launch only the
           CUDA-core route and bf16 only the tensor-core route. TF32 is off
           for every matmul. Then ``kernels.nan_check`` for K2 (dense
           decode and chunk), K3 and K4 on both routes: a NaN key row or
           page a row can see makes that row non-finite and leaves every
           other row bitwise the clean call's, kernel and plain version
           alike; a NaN where no row may look is recorded;
3. parity  tinyllama-1.1b at full width in fp32 with seeded weights: one
           64-token ``prefill_chunk`` (logits at every position) and
           DECODE_STEPS ``decode_step``s on the card (kernels) and on the
           CPU (plain versions); logits agree within LOGIT_TOL and greedy
           tokens agree wherever the top-2 gap exceeds it. The card with
           the plain versions and a float64 CPU run are the witnesses: the
           kernels' own share and each fp32 run's distance from exact,
           per layer too. The same run on the card's dense layout (K2 for
           attention) is gated in phase 4e;
4. serve   tinyllama-1.1b in bf16 through ``BatchScheduler`` (batch 4,
           max_len 512, page 16, chunk 64, overlap): 8 requests of 64-256
           prompt tokens, 32 new tokens each. Launch counters are zeroed
           before and read after: paged decode 22 per decode step, paged
           prefill 22 per chunk, RMSNorm 45 per forward. Then the same
           trace again, flushing every tick, for time to first token;
4b. serve-load  phase 4's weights at LOAD_REPEATS (6) of its 22 layers,
           as phases 4c and 4d, under load (batch 16, max_len 1024, page
           16, chunk 64, overlap): (a) a 250-token system prompt and 16
           requests, the prefix cache on: 15 hits with copy-on-write, every
           trie page's bytes unchanged from its insert to the end, pages in
           use equal to the trie's after ``drain`` and 0 after ``clear``;
           (b) ``serve.traffic.replay`` of a 64-request bursty trace with
           cancellations and three priority classes against a LOAD_PAGES
           pool under the monitor: preemptions (more than (c)'s), resumes
           equal to them, cancellations, none failed, every request
           accounted for, no page left in use, the pool filled; the record
           in ``results/talp/<arch>/serve_monitor/`` passes ``validate_pop``
           with regions decode, prefill, preempt and traffic, visited once
           per decode step, prefill chunk and preemption; (c) the same
           trace with the dense-equivalent pool, no prefix cache and the
           null collector: the greedy tokens of every request completed in
           both runs equal, except at a near tie (the card's top-2 logit gap
           there below LOGIT_TOL). Launch counts exact in each run; goodput,
           TTFT percentiles, queue depth and the record's region times for
           information;
4c. serve-spec  phase 4b's server with sampling and speculation: (a)
           SPEC_REQUESTS requests of 77-238 prompt tokens, 64 new each,
           sampled (SAMPLE: temperature 0.8, top-k 50, seed 0) in submit
           order, in reverse order with overlap off, and with one request
           submitted behind a full batch into a short blocker's slot: every
           stream equal across the three runs, except from a near tie on
           (logits / T + the Gumbel draw) onward, every id below the vocab;
           (b) the copy regime (every layer's weights zeroed, phase 4's
           embedding and head), prompts of a 4-token motif whose last token
           sits on a short cycle of the successor map, SPEC_NEW new tokens:
           spec (SPEC_K) on and off, greedy and sampled at SPEC_COPY_TEMP:
           tokens equal except at a near tie, drafts accepted, tokens per
           dispatch above 1, fewer decode dispatches than spec off, launches
           exact (no K3 under speculation, K4 = 22 per chunk and per
           verify), no page left in use; (c) (b)'s greedy traffic against
           SPEC_TIGHT_PAGES pages: preemptions resumed, the pool filled,
           tokens equal to (b)'s; (d) (b)'s greedy spec run under the
           monitor (``results/talp/<arch>/serve_spec/``): POP valid,
           ``decode`` visited once per verify, K4's FLOPs in its profile.
           For information: goodput, tokens per verify, acceptance, and the
           sampler's time, kernels and share of a tick;
4d. serve-fault  phase 4b's server under faults (``serve/faults.py``):
           (a) FAULT_TRAFFIC fault-free and under FAULTS (2 NaN logits, 2
           NaN pages, 2 allocator spikes, 1 hang), both under the monitor,
           the watchdog's deadline set from the fault-free run's slowest
           decode dispatch: every scheduled fault lands, retries at least
           the NaN, page and hang faults, watchdog trips equal the hangs,
           every request completes with the fault-free tokens (except at a
           near tie), no page in use, no free page holding a non-finite
           value, and the record (``results/talp/<arch>/serve_fault/``)
           visits ``recovery`` once per retry, quarantine, shed, checksum
           failure and watchdog trip; (b) a bit flip in a trie page of the
           prefix run's system prompt, caught by ``checksum_pages``: a
           checksum failure, the subtree evicted, the same tokens; (c)
           max_retries + 1 NaNs pinned to one request: it ends ``failed``,
           its neighbours' tokens unchanged; (d) FAULT_SHED_N requests at
           once against ``shed_queue_depth``: the rule's victims shed, the
           rest complete; (e) 4c's copy regime with speculation and NaNs in
           verify dispatches: retries, tokens equal 4c's spec-off run;
4e. serve-dense  phase 4's trace on the dense layout (``paged=False``)
           under the monitor and unmonitored: tokens equal phase 4's paged
           run except at a near tie, exactly 22 K2 forward launches per
           decode step and per chunk and no K3/K4, the record
           (``results/talp/<arch>/serve_dense/``) counting the first decode
           step's K2 FLOPs from its positions (p + 1 keys a row, not 1);
           phase 3's fp32 dense logits within LOGIT_TOL of the CPU's and
           their RMS error against float64 within EXACT_RATIO times the
           CPU fp32 run's;
5. train-parity  tinyllama-1.1b at full width in fp32, phase 3's weights
           at TRAIN_PARITY_REPEATS of its 22 layers:
           the loss and gradients of one batch (B=1, S=TRAIN_PARITY_S, remat full) on
           the card (kernels), on the CPU (plain versions) and on the card
           with the plain versions (the kernels' own share), each against a
           float64 CPU run of the same weights: the card's loss within
           TRAIN_TOL and its gradients' RMS error (together and per leaf)
           within EXACT_RATIO times the CPU fp32 run's;
6. train   tinyllama-1.1b at full width in bf16 through ``TrainLoop``
           (B=4, S=2048, accum 1, remat full, 10 steps, monitor backend):
           every loss finite, launch counters zeroed before and read after
           and exact (derived in ``phase_train``), the run record written to
           ``results/talp/<arch>/train_monitor/`` with POP factors that pass
           ``validate_pop``; median step time, tokens/s, MFU, peak memory
           and the record's dispatch efficiency;
6b. mesh   training on a mesh of ranks: (a) phase 6's configuration
           MESH_STEPS steps on a 1 x 1 mesh over a one-rank ``nccl``
           group (every leaf all-gathered and its gradient reduce-scattered
           through the group, launched on the card), each loss and grad
           norm within MESH_TOL of phase 6's same step (printed: whether
           bitwise), launches exact, the held state its share; (b) two
           ``gloo`` ranks on the one card (this script's ``--mesh-rank``
           subprocesses, killed past MESH_RANK_TIMEOUT) at MESH_REPEATS
           layers on each of MESH_SHAPES, MESH_PAIR_STEPS steps: on
           (1, 2) tensor-parallel (each rank its heads, MLP columns,
           vocabulary rows and sequence half), on (2, 1) the batch split;
           each loss within MESH_PAIR_TOL of a one-rank run at that depth,
           each rank's held bytes its share under the pspecs, launches
           exact, on (1, 2) every K2 launch at ``cases.MAIN_FLASH_MESH``
           and every K1 forward at ``cases.MAIN_RMS_MESH`` and each rank's
           counted matmul FLOPs half the one-rank count within
           MESH_FLOP_TOL; rank 0's record in ``results/talp_mesh/``
           naming the mesh and passing ``validate_pop``; then MESH_MOE
           (qwen3-moe-30b-a3b at 2 of 48 layers) on (1, 2): each step's
           ``expert_load`` equal to a one-rank run's, each rank's expert
           products (``aten.bmm``) half the one-rank FLOPs (its 64 of 128
           experts); step times and peak memory a rank; (c) MESH_SSM
           (zamba2-2.7b at full width, 6 of 54 layers, weights at fan-in)
           on (1, 2), mamba2 split over its SSM heads: losses and grad
           norms within MESH_PAIR_TOL of a one-rank run, each rank's
           counted ``in_proj`` FLOPs (2 d_inner/n + 2gN + h/n) / (2 d_inner
           + 2gN + h) = 0.5061 and ``out_proj`` 0.500 of one rank's within
           MESH_FLOP_TOL, K2 only at the rank's 16/16 heads, launches exact
           (the split gated norm's K1 launches gone); (d) MESH_CP
           (gemma2-2b at 4 of 26 layers, fsdp, B 1 x S 8192) on (1, 2),
           where the ranks split the sequence: losses and grad norms within
           MESH_PAIR_TOL of one rank's, K2 only at the 4096-query block
           against 8192 keys, each rank's counted K2 FLOPs those of
           ``launch_costs`` at its positions, launches exact; each rank's
           K2 milliseconds and the record's host load balance printed
           (record in ``results/talp_mesh_cp/``);
6c. oneshot the one-shot serving steps (``serve.serve.make_prefill_step``,
           ``make_decode_step``, ``make_encoder_step``), weights at their
           per-layer fan-in: (a) ONESHOT, tinyllama-1.1b at full width and
           depth in bf16: a 32,768-token prompt into a dense cache of
           32,784 positions, 16 decode steps, against ``prefill_chunk`` in
           2,048-token chunks and the same decode inputs (tokens equal but
           at a top-2 gap under LOGIT_TOL; the largest logit difference
           printed), launches exact (22 K2 and 45 K1 for the prefill, 22
           and 45 a decode step); the prefill's seconds, decode tokens/s
           and peak memory; the same at 2 layers in fp32 (the prefill's
           logits within ONESHOT_TOL, every token equal); (b)
           ONESHOT_ENCODER, hubert-xlarge's encoder step at 48 layers in
           bf16, B 4 x S 1024 (48 bidirectional K2 launches, 97 K1), and at
           2 layers in fp32 against the plain versions on the card (tokens
           equal, logits within ONESHOT_TOL); (c) ONESHOT_MESH, gloo ranks
           sharing the card (this script's ``--oneshot-rank``
           subprocesses): tinyllama at 4 layers on (1, 2) and glm4-9b at 2
           layers on (1, 4) (the sequence-split cache, the LSE combine),
           bf16 weights computed in fp32, ONESHOT_MESH_RUN's 2 rows, 4,096-
           token prefill and 8 decode steps: every token equal one rank's,
           logits within ONESHOT_TOL, launches those of one rank, each
           rank's K2 shapes its share, its cache bytes 1/n of one rank's;
6e. serve_mesh the serving scheduler (``serve.BatchScheduler``) on meshes of
           gloo ranks sharing the card (this script's ``--serve-rank``
           subprocesses, SERVE_MESH_GROUPS), bf16 weights computed in
           fp32: (a) tinyllama-1.1b at full depth, SERVE_MESH's 16
           requests behind one system prompt through 8 slots and a pool
           that preempts, greedy and speculation on (1, 2), greedy and
           sampled on (2, 1); (b) glm4-9b at 2 layers on (1, 4) (the pool
           whole on every rank) and (c) zamba2-2.7b at 6 of 54 layers on
           (1, 2) (weights at their per-layer fan-in) on
           SERVE_MESH_SMALL. Every request's tokens equal one rank's run
           in this process, each rank's K3, K4 and K1 launches one rank's
           (less the split gated norm's K1) at the rank's rows and heads,
           rank 0's record of the (1, 2) greedy run in
           SERVE_MESH_TALP_DIR passing ``talp validate``; tokens/s, time
           to first token and a gloo all-reduce's ms a mesh beside one
           rank's. The ranks start together and run after the one-rank
           references;
6d. dryrun the dry run (``launch.dryrun``) on the host: nothing allocated
           on the card, the blocks meta tensors, the collectives a
           ``"fake"`` process group's; the kernels' meta routes report
           their costs and launch nothing (launch counters zeroed before
           and read after: all 0; each of K1 and K2 counted in every cell
           it runs in). (a) phase 6's step (DRYRUN_TRAIN) counted on a
           1 x 1 meta mesh: its FLOPs and bytes a step within
           DRYRUN_COUNT_TOL of phase 6's ``StepProfile.count`` of the real
           step, the kernel entries equal call for call, and the predicted
           peak (arguments + the step's peak) within DRYRUN_PEAK_TOL of
           phase 6's ``max_memory_allocated`` less what earlier phases
           still held when phase 6 began; (b) DRYRUN_CELLS at full
           depth on the production meshes: status ok, finite roofline
           terms, each cell's bytes a rank against the card's memory, its
           terms and its count seconds;
7. report  the same configuration REPORT_STEPS steps under the tracer
           (record in ``results/talp/<arch>/train_tracer/``) and under the
           null collector, launch counters exact for each; the tracer's
           record against the monitor's (the paper's cross-tool check: the
           same regions, each run's step count, train_step's counted FLOPs,
           bytes and model FLOPs per step within AGREE_TOL, factors that
           pass ``validate_pop``, hardware ``h100_sxm``); then the ``talp``
           CLI (``python -m repro_torch.core.pages``) as subprocesses:
           ``metadata``, ``ci-report`` into ``results/talp_site/index.html``,
           ``validate`` (6 runs, 0 violations) and ``badge``, each exiting
           0, the page naming the six experiments (phase 4b's, 4c's, 4d's
           and 4e's serve records too) with a train_step table whose
           parallel efficiency is the monitor record's, and a badge with a
           number. For information only: the median step time under null,
           monitor and tracer, the trace's bytes against the record's,
           ``post_process``'s seconds and peak ``tracemalloc`` bytes against
           ``scan`` + ``build_table`` on the monitor's record, and the
           ``ci-report`` seconds;
9. archs   the other dense archs at full width (``ARCH_PATHS``), bf16,
           seeded weights drawn on the card: gemma2-2b (the slice's main
           path; 8 of 26 layers) serves 4 prompts of 4,200-6,000 tokens through
           ``BatchScheduler`` (batch 4, max_len 8192, page 16, chunk 64), so
           the local layers' window of 4096 cuts keys in K3 and K4, and
           trains 5 steps at B 1, S 8192 (26 layers) through ``TrainLoop`` under the
           monitor (K2 at head dim 256), its record in
           ``results/talp_archs/gemma2-2b/train_monitor/`` passing the
           ``talp validate`` CLI; an fp32 parity run of gemma2-2b at depth 2
           with its window cut to 1024 (a 1,088-token prefill in chunks of
           64, past the window, then DECODE_STEPS decode steps) and of
           glm4-9b at depth 1 with N(0, 0.3) qkv biases, card vs CPU within
           LOGIT_TOL and the card's RMS error against float64 within
           EXACT_RATIO of the CPU's (weights drawn on the card and copied
           to the host);
           glm4-9b (20 of 40 layers), command-r-35b (8 of 40) and
           llava-next-mistral-7b (16 of 32) serve 4 requests of 300-1,700
           tokens; llava trains 3 steps with 1152 stub patch embeddings (8 of
           32 layers) and hubert-xlarge 3 steps on frame batches (full
           depth). Every request completes, logits finite, launches exact in
           each run, every loss finite. The kernel shapes of these paths are
           in phase 2's tables (``cases.*_ARCH_*``) and timed in phase 8;
10. moe    the MoE archs at full width (``MOE_PATHS``), bf16, seeded weights
           drawn on the card (slice by slice for a stacked expert leaf),
           after every earlier model is freed: qwen3-moe-30b-a3b (12 of 48 layers,
           qk-norm) and dbrx-132b (8 of 40 layers, GQA group 6) serve
           phase 9's glm4 traffic through ``BatchScheduler`` (every request
           completes, logits finite, launches exact: K1 4L+1 a forward with
           qk-norm; tokens/s, TTFT, peak memory, and one decode step's time
           beside the bound of reading every expert once); qwen3 trains 3
           steps at 5 of 48 layers (B 1, S 4096, remat full) through
           ``wrap_step`` in a session opened by ``repro_torch.start(...,
           backend="monitor")``: losses finite, launches exact, the record
           in ``results/talp_moe/`` passing ``talp validate`` with an
           ``expert_load_balance`` in (0, 1) read from the router's counts;
           an fp32 parity run of qwen3 at depth 1 (a 256-token prefill in
           chunks of 64, DECODE_STEPS decode steps) held as phase 9's, its
           routing decisions that differ between card and CPU counted and
           allowed only where the CPU's K-th and (K+1)-th router logits lie
           within ROUTE_TIE;
11. recurrent the recurrent and hybrid archs at full width
           (``RECURRENT_PATHS``), bf16, weights drawn on the card after
           every earlier model is freed, at fan-in scale (``_fan_in_``:
           stacked leaves at their per-layer fan-in): zamba2-2.7b (6 of 54 layers:
           5 mamba2, 1 attention at 32/32 heads, head dim 80) serves glm4's traffic
           (launches exact: K3/K4 on the attention layers, K1 on every
           norm, the mamba2 gated norm at 5120 included), 16 requests
           against a 12-page pool that preempts (tokens equal an ample
           pool's but at a near tie), a shared system prompt through the
           prefix cache (the hybrid rule: pages shared, no prefill token
           skipped; tokens equal); greedy speculation with every decoding
           request preempted once, so the replayed history commits through
           the two-pass verify several tokens at a time (no K3, two
           forwards' K4 and K1 a verify): in bf16 at 6 layers, where the
           verify's chunked recurrences and K4 round apart from the decode
           step's beyond a near tie, each request that parts from the
           plain run held to an fp32 witness of the same weights (the two
           tokens' fp32 logits within twice the bf16 logits' error), and in
           fp32 at 12 layers with tokens equal the plain run's but at a near
           tie; the copy regime (spec on and off equal, drafts accepted); it trains 3
           steps at B 1, S 4096 under the monitor (K2 at head dim 80, G 1),
           its record in ``results/talp_recurrent/`` passing ``talp
           validate``; xlstm-350m (21 mLSTM, 3 sLSTM; K1 alone) serves the
           same traffic at 8 of its 24 layers and a slot-reuse run (tokens equal a fresh
           scheduler's), and trains at B 4, S 1024: at 8 of its 24 layers
           checkpoint-restart
           (checkpoints every 2 steps, a failure at step 3, the failed
           run's state taking step 3 as the uninterrupted run would, the
           restart's losses within rtol 1e-4 of those, save seconds and
           bytes; a temporary directory under ``results/``, deleted), and at
           8 of its 24 layers one step under remat ``full``, ``none`` and
           ``dots`` (``dots``'s loss within 1e-6 of ``full``'s, the
           gradients within GRAD_REMAT_TOL of ``full``'s, each one's peak
           memory) and one with ``compress_dcn_grads`` (its gradients on the
           int8 grid, within half a step of ``full``'s); the sLSTM
           block's host scan timed and its kernels counted; fp32 parity of
           both at one pattern repeat, held as phase 9's;
8. timing  each kernel, its plain version and one PyTorch library call at
           the serving and training paths' shapes, beside the bound: ``ms``
           back to back with CUDA events (what an eager caller pays, host
           dispatch included), ``device_ms`` replayed from a CUDA graph (the
           card's own time); for K3 and K4 also ``cold_device_ms`` with the
           L2 cache flushed before each call, as the serving step finds it,
           and K4 at the speculative verify's shape too (``verify_shape``);
           K2's forward also at the dense layout's decode and chunk shapes
           (rows with ``path`` ``serve_dense``, SDPA on the same mask) and
           at the one-shot steps' (``path`` ``oneshot``: the 32,768-token
           prefill, its plain version in 1024-query blocks; and
           ``oneshot_glm4_1x4``: the split decode's key block);
           for the K1 backward the row pass's and the combine's device times
           apart, from the profiler's kernel names; then each kernel at phase
           9's shapes (rows with their ``path``; a soft-capped attention has
           no library call: SDPA without the cap beside it), and at phase
           10's (G 6 and G 8 at head dim 128, qk-norm rows of 128) and
           11's (zamba2's K2-K4 at head dim 80, G 1, and its verify; the
           norms at 1024-5120).

``python3 chip_smoke.py --profile`` adds ``torch.profiler`` over the serve
trace (after phase 4), over 40 mid-burst ticks of phase 4b's tight-pool
trace (after phase 4b) and over two training steps (after phase 6), for
the device's busy share and the kernel-time breakdown.

It then prints the ``kernels`` line, the card's name and power limit
(``nvidia-smi``) and, last, ``{"ok": true, "device": {...}}``. Details go
to ``results/chip_smoke.json``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time
import tracemalloc

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# NVIDIA H100 SXM data sheet: HBM rate, dense tensor-core bf16, fp32 (no TC)
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2**20
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# Phase 3 gates on fp32 logits at full width (64 prefill positions plus
# DECODE_STEPS decode steps), each set from readings on an H100 that
# PERF.md records: card (kernels) vs CPU (plain versions) within
# LOGIT_TOL; the kernels' own share (card kernels vs card plain versions)
# within KERNEL_LOGIT_TOL; and the card's RMS logit error against a
# float64 CPU run of the same weights within EXACT_RATIO times the CPU fp32
# run's, so a gap between two fp32 runs is fp32 rounding, not a fault of
# either. (Max-abs is the tail of 2.3M errors: on an H100 it put the card
# at 2.2x the CPU where the RMS puts it at 1.3x.)
LOGIT_TOL = 2e-2
KERNEL_LOGIT_TOL = 1e-2
EXACT_RATIO = 2.0
DECODE_STEPS = 8
# Phase 5 gates one full-width fp32 batch's loss within TRAIN_TOL of a
# float64 CPU run of the same weights, and its gradients' RMS error against
# that run (all leaves together, and each leaf) within EXACT_RATIO times
# the CPU fp32 run's. On an H100 any two fp32 runs of this model at init
# disagree by 4-6% of a leaf's largest gradient (card kernels, card plain
# versions and CPU alike: PERF.md), so only the float64 witness can tell
# the kernels' error from fp32 rounding.
TRAIN_TOL = 1e-4
# Phase 5's sequence length and depth: its CPU fp32 and float64 runs
# dominate the phase, and S 128 at 4 of the 22 layers keeps the script
# within its time (PERF.md)
TRAIN_PARITY_S = 128
TRAIN_PARITY_REPEATS = 4
TRAIN_STEPS = 10
TRAIN_B, TRAIN_S, TRAIN_A = 4, 2048, 1
# Phase 7 runs the training configuration REPORT_STEPS steps more under the
# tracer and under the null collector, and holds the tracer's record to the
# monitor's: per step, train_step's counted FLOPs, bytes and model FLOPs
# within AGREE_TOL relative (both count step 0 with StepProfile.count).
REPORT_STEPS = 5
AGREE_TOL = 1e-6
# Phase 6b (mesh): (a) phase 6's configuration on a 1 x 1 mesh over a
# one-rank nccl group, MESH_STEPS steps, each loss and grad_norm within
# MESH_TOL relative of phase 6's same step; (b) two gloo ranks sharing the
# card at MESH_REPEATS layers on each of MESH_SHAPES, MESH_PAIR_STEPS steps
# ((1, 2): tensor parallel), each loss within MESH_PAIR_TOL relative of a
# one-rank run at that depth, each rank's held state bytes its share under
# the pspecs, on (1, 2) each rank's counted matmul FLOPs half the one-rank
# count within MESH_FLOP_TOL; then MESH_MOE on (1, 2) against one rank.
# MESH_PAIR_TOL: bf16 runs of one weights part from their fp32 run; the
# split reorders the bf16 sums (the reduce-scatters add bf16 partials), so
# the gate is twice the one-rank bf16 loss's distance from the loss of the
# same weights computed in fp32: 2.106e-4 relative (phase 6b's
# ``one_rank_bf16_vs_fp32`` on an NVIDIA H100 80GB HBM3, 700.00 W; the
# split's own distance read 2.8e-5 there)
MESH_STEPS = 3
MESH_TOL = 1e-5
MESH_REPEATS = 4
MESH_SHAPES = ((1, 2), (2, 1))
MESH_PAIR_STEPS = 2
MESH_PAIR_TOL = 4.2e-4
MESH_FLOP_TOL = 1e-2
MESH_RANK_TIMEOUT = 480
# qwen3-moe-30b-a3b at 2 of 48 layers, bf16 weights computed in fp32 (in
# bf16 the split's reordered sums flip the router's near ties, so
# expert_load could not be held equal), B 1 x S 4096, 2 steps
MESH_MOE = dict(arch="qwen3-moe-30b-a3b", repeats=2, batch=1, seq=4096, steps=2, seed=75)
MESH_TALP_DIR = os.path.join("results", "talp_mesh")
# (c) zamba2-2.7b at full width, one repeat of its pattern (5 mamba2 + 1
# attention of 54 layers), weights at their per-layer fan-in (``_fan_in_``),
# bf16 computed in fp32, B 1 x S 4096 on (1, 2): mamba2 split over its 80
# SSM heads. (d) gemma2-2b at 4 of 26 layers (2 local + 2 global), fsdp,
# B 1 x S 8192 on (1, 2): the batch cannot split over "model", so the two
# ranks split the sequence (context parallelism); its record, with each
# rank's K2 milliseconds as the hosts' work, in MESH_CP_TALP_DIR
MESH_SSM = dict(arch="zamba2-2.7b", repeats=1, batch=1, seq=4096, steps=2, seed=76)
MESH_CP = dict(arch="gemma2-2b", repeats=2, batch=1, seq=8192, steps=2, seed=77)
MESH_CP_TALP_DIR = os.path.join("results", "talp_mesh_cp")
# Phase 6c (oneshot): the one-shot serving steps, every weight drawn at its
# per-layer fan-in (``_fan_in_``: under the reference draw attention is near
# one-hot, and the fp32 kernels' rounding moved hubert's 2-layer logits
# 5.8e-3 from the plain versions', PERF.md section 6). (a) tinyllama-1.1b at
# full width and depth in bf16, one 32,768-token prompt (prefill_32k's
# length) into a dense cache of 32,768 + 16 positions, 16 decode steps,
# against ``prefill_chunk`` in 2,048-token chunks; again in fp32 at 2 of its
# 22 layers. (b) hubert-xlarge's encoder step at 48 layers, bf16, B 4 x S
# 1024; in fp32 at 2 layers against the plain versions. (c) gloo ranks
# sharing the card (``--oneshot-rank``), bf16 weights computed in fp32, 2 rows,
# a 4,096-token prefill and 8 decode steps into a cache of 4,160 positions:
# tinyllama at 4 of 22 layers on (1, 2) (KV heads over "model") and glm4-9b
# at 2 of 40 on (1, 4) (2 KV heads: the cache's sequence over "model", the
# ranks' attention combined through the LSE)
# Phase 6e (serve_mesh): the scheduler (``serve.BatchScheduler``) on meshes
# of gloo ranks sharing the card (``--serve-rank``), bf16 weights computed in
# fp32, each run's tokens against one rank's run of the same weights in this
# process. (a) tinyllama-1.1b at full width and depth: SERVE_MESH's 16
# requests behind one 40-token system prompt (copy-on-write hits) through 8
# slots and a pool of 20 pages that preempts, greedy and speculation (the
# drafter on one-token matches) on (1, 2) (each rank holding its blocks:
# 16/2 heads), greedy and sampled on (2, 1) (the serve launcher's way:
# whole weights, the slots' rows split over "data"); the (1, 2) greedy
# run's rank 0 record in
# SERVE_MESH_TALP_DIR. (b) glm4-9b at 2 of 40 layers on (1, 4) (2 KV heads:
# the pool whole on every rank) and (c) zamba2-2.7b at 6 of 54 layers on
# (1, 2), weights at their per-layer fan-in (mamba2 over its SSM heads):
# SERVE_MESH_SMALL, 8 requests, an ample pool. Every process warms up on
# 2 requests first; the ranks of all groups start together, time
# SERVE_MESH_COLLECTIVES all-reduces of a decode step's activations, wait
# while this process runs the one-rank references, then run at once.
SERVE_MESH = dict(batch=8, max_len=512, page_size=16, prefill_chunk=64, num_pages=20,
                  requests=16, prefix=40, tail=(8, 24), max_new=8, seed=81)
SERVE_MESH_SMALL = dict(SERVE_MESH, num_pages=None, requests=8, max_new=4)
SERVE_MESH_COLLECTIVES = 30
SERVE_MESH_GROUPS = {
    "tinyllama_12": dict(arch="tinyllama-1.1b", repeats=None, mesh=(1, 2),
                         runs={"greedy": {}}),
    "tinyllama_12_spec": dict(arch="tinyllama-1.1b", repeats=None, mesh=(1, 2),
                              runs={"spec": dict(spec_decode=True, spec_k=4,
                                                 spec_min_match=1)}),
    "tinyllama_21": dict(arch="tinyllama-1.1b", repeats=None, mesh=(2, 1),
                         runs={"greedy": {}, "sampled": dict(greedy=False, temperature=0.8,
                                                             top_k=50, sample_seed=7)}),
    "glm4_14": dict(arch="glm4-9b", repeats=2, mesh=(1, 4), work=SERVE_MESH_SMALL,
                    runs={"greedy": {}}),
    "zamba2_12": dict(arch="zamba2-2.7b", repeats=1, mesh=(1, 2), fan_in=True,
                      work=SERVE_MESH_SMALL, runs={"greedy": {}}),
}
SERVE_MESH_TALP_DIR = os.path.join("results", "talp_serve_mesh")
# Phase 6d (dryrun): (a) phase 6's step counted on the meta device at 1 x 1
# against phase 6's count of the real step (the same operators and kernel
# entries: within DRYRUN_COUNT_TOL relative), and the predicted peak
# (arguments + the step's peak of live tensors) against the card's
# ``max_memory_allocated`` within DRYRUN_PEAK_TOL; (b) six production cells
# at full depth: a megatron train cell, a sequence-split decode cache, the
# encoder, an MoE train cell, fsdp's context-parallel train cell across two
# pods (DCN) and the hybrid's 500k-token decode across two pods
DRYRUN_COUNT_TOL = 1e-6
DRYRUN_PEAK_TOL = 0.15
DRYRUN_CELLS = (("tinyllama-1.1b", "train_4k", False), ("glm4-9b", "decode_32k", False),
                ("hubert-xlarge", "prefill_32k", False), ("qwen3-moe-30b-a3b", "train_4k", False),
                ("gemma2-2b", "train_4k", True), ("zamba2-2.7b", "long_500k", True))
DRYRUN_DIR = os.path.join(ROOT, "results", "dryrun")
# phase 6's per-step count of the real step (the monitor's static profile)
TRAIN_PROFILE: dict = {}

ONESHOT = dict(arch="tinyllama-1.1b", prompt=32768, decode=16, chunk=2048, fp32_repeats=2,
               seed=81)
ONESHOT_TOL = 1e-4
ONESHOT_ENCODER = dict(arch="hubert-xlarge", batch=4, seq=1024, fp32_repeats=2, seed=82)
ONESHOT_MESH = {
    "tinyllama_1x2": dict(arch="tinyllama-1.1b", repeats=4, mesh=(1, 2), seed=83),
    "glm4_1x4": dict(arch="glm4-9b", repeats=2, mesh=(1, 4), seed=84),
}
ONESHOT_MESH_RUN = dict(batch=2, prompt=4096, decode=8, max_len=4160)
# Phase 4b: the loaded server. Batch 16 at max_len 1024 (a 1024-page
# dense-equivalent pool), the traffic harness's bursty trace, and a pool of
# LOAD_PAGES pages: at 384 (37.5%) the trace never fills it (peak 349 pages,
# every preemption a priority one), so it is cut to 256, which the trace
# fills (PERF.md).
LOAD_BATCH, LOAD_MAX_LEN, LOAD_PAGES = 16, 1024, 256
# phases 4b-4d serve at full width on LOAD_REPEATS of tinyllama's 22 layers
# (phase 4's weights, its first layers; 22 until phase 6b's (c) and (d),
# for the script's time: a host-bound tick's time follows the layer count)
LOAD_REPEATS = 6
PROFILE_LOAD_FROM, PROFILE_LOAD_TICKS = 200, 40
LOAD_TRAFFIC = dict(n_requests=64, seed=0, arrival="burst", rate=0.25, burst_mult=6,
                    prompt_short=(32, 128), prompt_long=(384, 768), long_frac=0.25,
                    max_new_short=(16, 64), max_new_long=(128, 256), long_out_frac=0.25,
                    priorities=(0, 1, 2), cancel_frac=0.1, vocab_hi=32000)
# Phase 4c: sampled decoding and speculation on phase 4b's server. (a)
# SPEC_REQUESTS sampled requests (SAMPLE); (b) the copy regime (every
# layer's weights zeroed, so a token's successor is a function of it alone)
# with prompts of a 4-token motif repeated SPEC_MOTIF_REPS times, whose last
# token lies on a short cycle of that map, SPEC_NEW new tokens each, spec
# on (SPEC_K) and off, greedy and sampled at SPEC_COPY_TEMP; (c) (b)'s
# greedy traffic against SPEC_TIGHT_PAGES pages, half of what it needs.
# SPEC_COPY_TEMP is low enough that a sampled stream mostly keeps to its
# cycle (drafts accepted) and high enough that it leaves it at times (drafts
# rejected): the cycles' top-2 logit gaps are 0.05-0.6, and at 0.1 a
# simulated sampled stream on the seeded weights kept only 31% of its drafts
# (PERF.md).
SAMPLE = dict(greedy=False, temperature=0.8, top_k=50, sample_seed=0)
SPEC_REQUESTS, SPEC_K, SPEC_NEW, SPEC_MOTIF_REPS = 16, 4, 256, 16
SPEC_COPY_TEMP, SPEC_TIGHT_PAGES = 0.02, 160
# Phase 4d: serving under faults on phase 4b's server (dense-equivalent
# pool). (a) FAULT_TRAFFIC (LOAD_TRAFFIC cut to 32 requests, without
# cancellations, so every request completes in both runs) fault-free and
# under FAULTS (NaN logits, NaN pages, allocator spikes, a hang), both under
# the monitor: the watchdog's deadline is FAULT_DEADLINE_X times the
# fault-free run's slowest decode dispatch (its first, the monitor's
# counting pass, included) and the hang FAULT_HANG_X times the deadline;
# (c) FAULT_QUARANTINE_N requests; (d) FAULT_SHED_N requests at once against
# FAULT_SHED_DEPTH; (e) NaNs at FAULT_SPEC_TICKS into 4c's copy regime.
FAULT_TRAFFIC = dict(LOAD_TRAFFIC, n_requests=32, cancel_frac=0.0)
FAULTS = dict(seed=1, horizon_ticks=160, n_nan=2, n_page_corrupt=2, n_alloc_spike=2,
              n_hang=1, corrupt_mode="nan", spike_pages=64, spike_ticks=8)
FAULT_DEADLINE_X, FAULT_HANG_X = 2.0, 2.0
FAULT_QUARANTINE_N = 6
FAULT_SHED_N, FAULT_SHED_DEPTH = 24, 4
FAULT_SPEC_TICKS = (6, 20, 40)
# Phase 9: the other dense archs at full width, seeded random weights drawn
# on the card (a CPU twin only for the parity runs). gemma2-2b is the
# slice's main path: serving at 8 of its 26 layers with prompts of
# 4,200-6,000 tokens, so the local layers' window of 4096 cuts keys in K3
# and K4; training at full depth at B 1, S 8192 (K2 at head dim 256,
# the window on the local layers) under the monitor; an fp32 parity run at
# depth 2 (one local and one global layer) with the window cut to 1024,
# whose 1,088-token prefill in chunks of 64 ends past it (the CPU fp32 and
# float64 runs of a 4,160-token prefill past 4096 took 50 s). glm4-9b at 20 of its 40 layers, and an fp32
# parity run at depth 1 with non-zero qkv biases. command-r-35b at 8 of its
# 40 layers (all 40 would be 60.6 GB of bf16 weights). llava-next-mistral-7b
# serves at 16 of 32 layers and trains at 8 (AdamW's fp32 master,
# m and v and the fp32 gradients take 18 bytes a parameter: 2.0e9
# parameters fit beside the activations, 7.24e9 do not). hubert-xlarge
# trains at full depth on frame batches (``FrameStream``).
ARCH_PATHS = {
    "gemma2-2b": dict(serve_repeats=4, max_len=8192, prompt_lens=(4200, 4800, 5400, 6000),
                      max_new=16,
                      train_batch=1, train_seq=8192, train_steps=5,
                      parity_repeats=1, parity_prompt=1088, parity_window=1024),
    "glm4-9b": dict(repeats=20, max_len=2048, prompt_lens=(600, 900, 1300, 1700),
                    max_new=16, parity_repeats=1, parity_prompt=256, parity_bias_std=0.3),
    "command-r-35b": dict(repeats=8, max_len=2048, prompt_lens=(600, 900, 1300, 1700),
                          max_new=16),
    "llava-next-mistral-7b": dict(repeats=16, max_len=2048, prompt_lens=(300, 700, 1100, 1500),
                                  max_new=16, train_repeats=8, train_batch=2,
                                  train_seq=2048, train_steps=3),
    "hubert-xlarge": dict(train_batch=4, train_seq=1024, train_steps=3),
}
# Phase 10: the MoE archs at full width, bf16, seeded weights drawn on the
# card (a CPU twin only for the parity run). qwen3-moe-30b-a3b (qk-norm,
# 128 experts, top 8; 30.5e9 parameters, 61.0 GB of bf16) serves at 12 of
# 48 layers with glm4's traffic (24 until tensor parallelism joined phase
# 6b, for the script's time); dbrx-132b (16 experts, top 4, G =
# 6) at 8 of 40 layers (40 would be 263 GB: 8 are 55 GB); qwen3 trains at
# 5 of 48 layers, the deepest that leaves a tenth of the card free (AdamW's
# state and the fp32 gradients take 18 bytes a parameter: 3.7e9 of them at
# 5 layers; the peak read 74.8e9 of 85.0e9 bytes on an H100, PERF.md) in a
# session opened by ``repro_torch.start``; an fp32 parity run of qwen3 at depth 1 (a 256-token
# prefill in chunks of 64) counts the routing decisions that differ between
# the card and the CPU, each allowed only at a CPU near tie (its K-th and
# (K+1)-th router logits within ROUTE_TIE).
MOE_PATHS = {
    "qwen3-moe-30b-a3b": dict(repeats=12, max_len=2048, prompt_lens=(600, 900, 1300, 1700),
                              max_new=16, train_repeats=5, train_batch=1, train_seq=4096,
                              train_steps=3, parity_repeats=1, parity_prompt=256),
    "dbrx-132b": dict(repeats=8, max_len=2048, prompt_lens=(600, 900, 1300, 1700),
                      max_new=16),
}
ROUTE_TIE = 1e-4
MOE_TALP_DIR = os.path.join("results", "talp_moe")
# Phase 11: the recurrent and hybrid archs at full width, bf16, weights
# drawn on the card after every earlier model is freed (a CPU twin only for
# the parity runs), at fan-in scale (``_fan_in_``): every stacked leaf that
# the initializer draws at its default scale is rescaled from 1/sqrt(repeats)
# (the reference behaviour) to 1/sqrt of its per-layer fan-in. At the
# reference scales the recurrent stacks are chaotic in fp32 (on the CPU
# JAX's own jit and eager runs part by 1.19 on xlstm's smoke logits,
# tests/test_torch_recurrent.py), so no comparison of two computation
# orders (speculation on and off, card and CPU) could hold; at fan-in
# scale they part by 3.9e-5. zamba2-2.7b (2.67e9 parameters) serves at
# 6 of 54 layers (full depth until tensor parallelism joined phase 6b, 30
# until phase 6b's (c) and (d), for the script's time) with glm4's traffic, 16 requests against a
# pool that preempts and a shared system prompt through the prefix cache,
# two-pass speculation in bf16 (each parting from the plain run held to
# an fp32 witness) and in fp32 at 12 layers with the copy regime, and
# trains at B 1, S 4096
# under the monitor (record in RECURRENT_TALP_DIR); xlstm-350m (0.53e9)
# serves the same traffic at 8 of 24 layers plus a slot-reuse run, and trains at B 4, S 1024
# with checkpoint-restart (at 8 of 24 layers, for the script's time),
# remat "dots" and compress_dcn_grads; both run
# fp32 parity at one pattern repeat (6 and 8 layers), a 256-token prefill
# in chunks of 64 and DECODE_STEPS decode steps, held as phase 9's.
RECURRENT_PATHS = {
    "zamba2-2.7b": dict(max_len=2048, prompt_lens=(600, 900, 1300, 1700), max_new=16,
                        pool_requests=16, pool_prompt=(32, 96), pool_new=8, pool_pages=12,
                        prefix_system=128, prefix_tail=(10, 40), prefix_requests=6,
                        serve_repeats=1, spec_bf16_requests=8, spec_repeats=2,
                        spec_preempt_at=16,
                        spec_k=4, copy_new=48,
                        train_batch=1, train_seq=4096, train_steps=3,
                        parity_repeats=1, parity_prompt=256),
    "xlstm-350m": dict(max_len=2048, prompt_lens=(600, 900, 1300, 1700), max_new=16,
                       serve_repeats=1, reuse_prompts=(300, 200), train_batch=4, train_seq=1024,
                       ckpt_repeats=1, ckpt_steps=4, ckpt_every=2, fail_at=3, remat_repeats=1,
                       parity_repeats=1, parity_prompt=256),
}
RECURRENT_TALP_DIR = os.path.join("results", "talp_recurrent")
# phase 11's remat steps: the gradients under remat none and dots against
# full's, from the same weights and batch, in the relative L2 of each leaf
# (bitwise equality recorded; bf16 gradients one ulp apart in every
# element would read 2^-8 to 2^-7)
GRAD_REMAT_TOL = 1e-2
# phase 9's gemma2-2b training record, apart from phase 7's CI folder (whose
# report and ``validate`` count its six runs)
ARCH_TALP_DIR = os.path.join("results", "talp_archs")
TALP_DIR = os.path.join(ROOT, "results", "talp")  # the CI folder: <arch>/<experiment>/
SITE_DIR = os.path.join(ROOT, "results", "talp_site")
ARCH = "tinyllama-1.1b"
DEV = "cuda"
RESULT: dict = {}


def _config():
    from repro_torch.configs import get_config

    return get_config(ARCH)


_T_PHASE = [time.perf_counter()]


def emit(phase: str, **fields) -> None:
    """Print the phase's JSON line with its seconds since the last emit."""
    now = time.perf_counter()
    fields = {"seconds": round(now - _T_PHASE[0], 3), **fields}
    _T_PHASE[0] = now
    RESULT[phase] = fields
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, iters: int = 100, stream=None) -> float:
    """Device time per call without host dispatch: ``iters`` calls captured
    into one CUDA graph (on ``stream``, or a new side stream), replayed once
    between two events."""
    import torch

    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def cold_graph_ms(fn, iters: int = 20) -> float:
    """Device time per call of ``fn`` with the L2 cache flushed before each
    call (as a serving step finds it, after every layer's weights went
    through): a CUDA graph of ``iters`` (flush, call) pairs less one of
    ``iters`` flushes alone. The flush writes twice the H100's 50 MB L2."""
    import torch

    flush = torch.empty(2 * L2_BYTES // 4, dtype=torch.int32, device=DEV)
    both = graph_ms(lambda: (flush.zero_(), fn()), iters)
    alone = graph_ms(flush.zero_, iters)
    return both - alone


def profiler_device_ms(fn, iters: int = 10) -> float:
    """Device time per call as ``torch.profiler`` sums its kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in _device_events(prof)) / 1e3 / iters


def autograd_device_ms(forward, leaves, grad_out, iters: int = 10):
    """Device time of ``torch.autograd.grad`` of one saved output of
    ``forward()`` alone: the forward runs on a side stream, so its backward
    kernels go to that stream and a CUDA graph captured on it holds them.
    Where capture refuses, the profiler's summed device time of the same
    call. Returns (ms, how)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = forward()
    fn = lambda: torch.autograd.grad(out, leaves, grad_out, retain_graph=True)  # noqa: E731
    try:
        return graph_ms(fn, iters, stream=side), "cuda graph"
    except RuntimeError as e:
        torch.cuda.synchronize()
        why = (str(e).splitlines() or [""])[0][:80]
        return profiler_device_ms(fn, iters), f"profiler (capture refused: {why})"


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------


CUDA_SOURCES = ("paged_attention", "paged_attention_tc", "flash_attention",
                "flash_attention_tc", "rmsnorm")
# the bf16 kernels, by library, and the SASS instructions that show they run
# on the tensor cores: wgmma (HGMMA) for the K2 forward, wgmma or mma.sync
# (HMMA) for the others
TC_LIBRARIES = {
    "flash_attention_tc": {"flash_fwd_tc_kernel": ("HGMMA",),
                           "flash_bwd_dq_tc_kernel": ("HGMMA", "HMMA"),
                           "flash_bwd_dkdv_tc_kernel": ("HGMMA", "HMMA")},
    "paged_attention_tc": {"paged_decode_tc_kernel": ("HMMA", "HGMMA"),
                           "paged_prefill_tc_kernel": ("HMMA", "HGMMA")},
}
SERVE_KERNELS = ("paged_attention", "paged_prefill_attention", "rmsnorm")
TRAIN_KERNELS = ("flash_attention", "flash_attention_backward", "rmsnorm",
                 "rmsnorm_backward")


def phase_build():
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.paged_attention import ops as PA
    from repro_torch.kernels.rmsnorm import ops as RMS

    with concurrent.futures.ThreadPoolExecutor(max_workers=len(CUDA_SOURCES)) as pool:
        libs = {n: pool.submit(build.compile_library, n) for n in CUDA_SOURCES}
        paths = {n: f.result() for n, f in libs.items()}
    PA.load()
    FA.load()
    RMS.load()
    torch.cuda.synchronize()
    ptxas = {}
    for name, path in paths.items():
        log = path.with_name(path.name + ".log")
        lines = log.read_text().splitlines() if log.exists() else []
        ptxas[name] = [ln.strip() for ln in lines if "registers" in ln or "spill" in ln]
    tc_ptxas, sass = {}, {}
    for lib in TC_LIBRARIES:
        log = paths[lib].with_name(paths[lib].name + ".log")
        tc_ptxas.update(_ptxas_by_kernel(log.read_text()))
        sass[lib] = _sass_check(paths[lib], TC_LIBRARIES[lib])
    log = paths["rmsnorm"].with_name(paths["rmsnorm"].name + ".log")
    rms_ptxas = _ptxas_by_kernel(log.read_text())
    sass["rmsnorm"] = _sass_vectors(paths["rmsnorm"])
    del ptxas["rmsnorm"]  # by kernel in rmsnorm_kernels
    from repro_torch.device import features

    emit("build", features=features(),
         libraries={n: str(p.relative_to(ROOT)) for n, p in paths.items()},
         tensor_core_kernels=tc_ptxas, rmsnorm_kernels=rms_ptxas, sass=sass, ptxas=ptxas)
    missing = [k for v in sass.values() for k in v.get("missing", [])]
    if missing:
        raise AssertionError(f"build: kernels without their instructions (tensor-core "
                             f"products, 16-byte loads): {missing}")
    spills = [k for k, v in rms_ptxas.items() if v.get("spill_stores") or v.get("spill_loads")]
    if spills or not rms_ptxas:
        raise AssertionError(f"build: RMSNorm kernels that spill: {spills} "
                             f"(of {sorted(rms_ptxas)})")


_RMS_ARGS = {"13__nv_bfloat16": "bf16", "f": "f32"}


def _kernel_key(mangled: str) -> str | None:
    """``flash_fwd_tc_kernel<64>``, ``paged_decode_tc_kernel<64,64>`` or
    ``rmsnorm_bwd_kernel<bf16,bf16,8,2>`` (x's type, the scale's, elements
    an access, accesses a thread) from a mangled name, None for others."""
    m = re.search(r"(rmsnorm_(?:fwd|bwd|dscale)_kernel)I(\w*?)EE", mangled)
    if m:
        toks = re.findall(r"13__nv_bfloat16|S\d*_|Li\d+|f", m.group(2))
        args = [_RMS_ARGS.get(t, "bf16" if t.startswith("S") else t[2:]) for t in toks]
        return f"{m.group(1)}<{','.join(args)}>"
    m = re.search(r"((?:flash_(?:fwd|bwd)_\w*?(?:tc|sum)|paged_(?:decode|prefill)_tc)_kernel)"
                  r"(?:ILi(\d+)E(?:Li(\d+)E)?)?", mangled)
    if not m:
        return None
    args = ",".join(g for g in m.groups()[1:] if g)
    return m.group(1) + (f"<{args}>" if args else "")


def _ptxas_by_kernel(log: str) -> dict:
    """Registers, spill bytes and static shared memory of each kernel in a
    ptxas ``-v`` report, and for K2 the dynamic shared memory its launcher
    asks for (the library's own ``flash_tc_smem_bytes``; the paged
    kernels' grows with the pages of a split: ``ops.tc_plan``)."""
    from repro_torch.kernels.flash_attention import ops as FA

    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            cur = _kernel_key(m.group(1))
            if cur:
                out[cur] = {}
            continue
        if not cur:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[cur]["spill_stores"], out[cur]["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[cur]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            out[cur]["static_smem"] = int(sm.group(1)) if sm else 0
            cur = None
    for key, row in out.items():
        name, _, dp = key.partition("<")
        if dp and name in FA.TC_KERNELS:
            row["dynamic_smem"] = FA.tc_smem_bytes(int(dp[:-1]))[name]
    return out


def _sass_counts(lib, ops: dict):
    """(cuobjdump, {kernel key: {op: count}}) of the lines that match each
    regex of ``ops`` in a library's SASS (``cuobjdump -sass``); counts None
    where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.access(tool, os.X_OK):
        return "not available", None
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = _kernel_key(m.group(1))
            if cur:
                counts[cur] = dict.fromkeys(ops, 0)
            continue
        if cur:
            for op, rx in ops.items():
                if re.search(rx, ln):
                    counts[cur][op] += 1
    return tool, counts


def _sass_check(lib, wanted: dict) -> dict:
    """Count HGMMA / HMMA in the SASS of each bf16 kernel of a library;
    ``missing`` lists the kernels of ``wanted`` with none of the
    instructions it asks of them."""
    tool, counts = _sass_counts(lib, {op: rf"\b{op}\." for op in ("HGMMA", "HMMA")})
    if counts is None:
        return {"cuobjdump": tool}
    missing = [k for k, c in counts.items() if k.partition("<")[0] in wanted
               and not any(c[op] for op in wanted[k.partition("<")[0]])]
    seen = {k.partition("<")[0] for k in counts}
    missing += [k for k in wanted if k not in seen]
    return {"cuobjdump": tool, "counts": counts, "missing": missing}


def _sass_vectors(lib) -> dict:
    """Count 16-byte global loads and stores in the SASS of each RMSNorm
    kernel; ``missing`` lists the forward and backward kernels of the
    16-byte path (more than one element an access) with no 16-byte load."""
    tool, counts = _sass_counts(lib, {"LDG.128": r"\bLDG\.E\.(?:\w+\.)*128\b",
                                      "STG.128": r"\bSTG\.E\.(?:\w+\.)*128\b"})
    if counts is None:
        return {"cuobjdump": tool}
    vector = [k for k in counts if not k.startswith("rmsnorm_dscale")
              and k.rstrip(">").split(",")[-2] != "1"]
    return {"cuobjdump": tool, "counts": counts,
            "missing": [k for k in vector if not counts[k]["LDG.128"]]
            + ([] if vector else ["rmsnorm_fwd_kernel", "rmsnorm_bwd_kernel"])}


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions
# ---------------------------------------------------------------------------


def _tensors(case: dict, dtype, keys_float):
    import torch

    return {k: (torch.from_numpy(v).to(DEV, dtype) if k in keys_float
                else torch.from_numpy(v).to(DEV)) for k, v in case.items()}


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def phase_kernels():
    import torch

    from repro_torch.kernels import cases
    from repro_torch.kernels.rmsnorm import ops as RMS
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference

    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    checks = {"rmsnorm": []}
    main_err = {"l2_rel_err": {}}
    _check_paged_kernels(checks, main_err)
    # the absolute gate on the JAX case table and the serving shapes; the
    # relative gates (cases.TOL_MAX, cases.TOL_L2_RMS) everywhere
    absolute = cases.RMS_CASES + cases.MAIN_RMS
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for rows, d in (absolute + [cases.MAIN_RMS_TRAIN] + cases.RMS_WIDTH_CASES
                        + [c[:2] for c in cases.RMS_ARCH_CASES]):
            for zc in (False, True):
                c = cases.rms_case(rows, d, seed=13)
                x = torch.from_numpy(c["x"]).to(DEV, dtype)
                s = torch.from_numpy(c["scale"]).to(DEV, dtype)
                out = RMS.rmsnorm(x, s, 1e-6, zc)
                torch.cuda.synchronize()
                want = rmsnorm_reference(x, s, 1e-6, zc)
                e, rel, l2 = (_err(out, want), cases.max_rel_err(_f64(out), _f64(want)),
                              cases.l2_rel_err(_f64(out), _f64(want)))
                checks["rmsnorm"].append([dn, [rows, d, zc], e, rel, l2])
                if not (rel <= cases.TOL_MAX[dn] and l2 <= cases.TOL_L2_RMS[dn]
                        and ((rows, d) not in absolute or e <= tol[dtype])):  # NaN fails
                    raise AssertionError(f"rmsnorm {dn} {(rows, d, zc)}: err {e}, "
                                         f"of the largest {rel}, relative L2 {l2}")
                if (rows, d) == cases.MAIN_RMS[0] and not zc and dtype is torch.bfloat16:
                    main_err["rmsnorm"] = e
                    main_err["l2_rel_err"]["rmsnorm"] = l2
                for key in _arch_err_keys("rmsnorm", (rows, d, zc)):
                    if dtype is torch.bfloat16:
                        main_err[key], main_err["l2_rel_err"][key] = e, l2
    deterministic = _check_training_kernels(checks, main_err)
    _check_dense_flash(checks, main_err)
    _check_oneshot_flash(checks, main_err)
    _check_nan(checks)
    emit("kernels", tf32=False, tolerance={"float32": 1e-4, "bfloat16": 2e-2},
         training_tolerance="of the largest |value|, at least of 1",
         flash_l2_tolerance=cases.TOL_L2,
         paged_l2_tolerance=cases.TOL_L2_PAGED, rmsnorm_l2_tolerance=cases.TOL_L2_RMS,
         max_abs_err={k: max(c[2] for c in v) for k, v in checks.items()
                      if not k.endswith("_routes") and k != "nan"},
         flash_routes=checks["flash_routes"], paged_routes=checks["paged_routes"],
         flash_dense_routes=checks["flash_dense_routes"],
         flash_oneshot_routes=checks["flash_oneshot_routes"], nan=checks["nan"],
         paged_bitwise_repeatable=True,
         main_shape_bf16_err=main_err, flash_backward_bitwise_repeatable=deterministic,
         rmsnorm_backward_bitwise_repeatable=True, cases=checks)
    return main_err


def paged_inputs(kind: str, case, dtype, seed: int):
    """The wrapper's positional and keyword arguments on the card for a
    decode (``PAGED_*``) or prefill (``PREFILL_*``) case."""
    from repro_torch.kernels import cases

    fl = ("q", "k_pages", "v_pages")
    if kind == "decode":
        B, Hq, Hkv, D, ps, nL, P, lens, win, cap = case
        t = _tensors(cases.paged_case(B, Hq, Hkv, D, ps, nL, P, lens, seed=seed), dtype, fl)
        kw = dict(q_position=t["q_position"], cache_len=t["cache_len"], window=win,
                  softcap=cap)
    else:
        B, C, Hq, Hkv, D, ps, nL, P, starts, win, cap, lengths = cases.prefill_row(case)
        t = _tensors(cases.prefill_case(B, C, Hq, Hkv, D, ps, nL, P, starts, seed=seed,
                                        lengths=lengths), dtype, fl)
        kw = dict(q_positions=t["q_positions"], cache_len=t["cache_len"], causal=True,
                  window=win, softcap=cap)
    return (t["q"], t["k_pages"], t["v_pages"], t["block_tables"]), kw


def paged_errors(out, want) -> dict:
    """The gates' readings of a paged output against its plain version:
    ``abs`` the largest absolute error, ``max`` ``cases.max_rel_err``,
    ``l2`` ``cases.l2_rel_err``."""
    from repro_torch.kernels import cases

    got, w = _f64(out), _f64(want)
    return {"abs": float((got - w).abs().max()) if got.numel() else 0.0,
            "max": cases.max_rel_err(got, w), "l2": cases.l2_rel_err(got, w)}


def paged_failures(errs: dict, dtype_name: str) -> list:
    """The readings of ``paged_errors`` past their gates, or not finite: the
    absolute 1e-4 (f32) / 2e-2 (bf16) that phase 2 held them to first,
    ``cases.TOL_MAX`` and ``cases.TOL_L2_PAGED``."""
    from repro_torch.kernels import cases

    tol = {"abs": {"float32": 1e-4, "bfloat16": 2e-2}[dtype_name],
           "max": cases.TOL_MAX[dtype_name], "l2": cases.TOL_L2_PAGED[dtype_name]}
    return [f"{k} {e:.3g} > {tol[k]}" for k, e in errs.items() if not e <= tol[k]]


PAGED_KINDS = ("decode", "prefill")


def paged_case_table(kind: str) -> list:
    from repro_torch.kernels import cases

    if kind == "decode":
        return (cases.PAGED_CASES + cases.PAGED_SPLIT_CASES + [cases.MAIN_PAGED]
                + cases.PAGED_ARCH_CASES)
    return (cases.PREFILL_CASES + cases.PREFILL_SPLIT_CASES + [cases.MAIN_PREFILL]
            + cases.PREFILL_ARCH_CASES)


def _check_paged_kernels(checks: dict, main_err: dict) -> None:
    """K3 and K4 against their plain versions on both routes, over the JAX
    case tables, the split cases and the serving shapes, held to
    ``paged_failures``' gates; two calls of each must be bitwise equal, and
    each dtype must launch only its own route."""
    import torch

    from repro_torch.kernels import cases
    from repro_torch.kernels.paged_attention import ops as PA
    from repro_torch.kernels.paged_attention import ref as PR

    fns = {"decode": (PA.paged_attention, PR.paged_attention_reference, "paged_attention"),
           "prefill": (PA.paged_prefill_attention, PR.paged_prefill_attention_reference,
                       "paged_prefill_attention")}
    checks["paged_routes"] = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        before = dict(PA.ROUTE_LAUNCHES)
        n = 0
        for kind in PAGED_KINDS:
            fn, ref, name = fns[kind]
            checks.setdefault(name, [])
            for case in paged_case_table(kind):
                args, kw = paged_inputs(kind, case, dtype, seed=11 if kind == "decode" else 12)
                out, again = fn(*args, **kw), fn(*args, **kw)
                n += 2
                torch.cuda.synchronize()
                errs = paged_errors(out, ref(*args, **kw))
                checks[name].append([dn, list(case[:9]), errs["abs"], errs["max"], errs["l2"]])
                bad = paged_failures(errs, dn)
                if bad:
                    raise AssertionError(f"{name} {dn} {case}: {', '.join(bad)}")
                if not torch.equal(out, again):
                    raise AssertionError(f"{name} {dn} {case}: two calls differ")
                if case in (cases.MAIN_PAGED, cases.MAIN_PREFILL) and dtype is torch.bfloat16:
                    main_err[name] = errs["abs"]
                    main_err["l2_rel_err"][name] = errs["l2"]
                for key in _arch_err_keys(name, case):
                    if dtype is torch.bfloat16:
                        main_err[key], main_err["l2_rel_err"][key] = errs["abs"], errs["l2"]
        moved = {r: PA.ROUTE_LAUNCHES[r] - before[r] for r in before}
        want = {r: (n if r == PA.route(dtype) else 0) for r in before}
        checks["paged_routes"][dn] = moved
        if moved != want:
            raise AssertionError(f"paged attention {dn}: route launches {moved} != {want}")


def _f64(t):
    """A kernel's output or its plain version's, in float64 on its device:
    the gates (``cases.max_rel_err``, ``cases.l2_rel_err``) read tensors
    where they lie, without a host copy."""
    return t.detach().double()


def flash_inputs(case, dtype, seed: int):
    """q, k, v, dout on the card and the wrapper's keyword arguments for a
    flash case (B, Sq, Sk, Hq, Hkv, D, causal, window, softcap, q_offset,
    kv_len)."""
    import torch

    from repro_torch.kernels import cases

    B, Sq, Sk, Hq, Hkv, D, causal, win, cap, off, kvl = case
    c = cases.flash_case(B, Sq, Sk, Hq, Hkv, D, seed=seed, q_offset=off, kv_len=kvl)
    q, k, v, dout = (torch.from_numpy(c[n]).to(DEV, dtype) for n in ("q", "k", "v", "dout"))
    kw = dict(q_positions=torch.from_numpy(c["q_positions"]).to(DEV),
              k_positions=torch.from_numpy(c["k_positions"]).to(DEV),
              kv_len=None if kvl is None else torch.from_numpy(c["kv_len"]).to(DEV),
              causal=causal, window=win, softcap=cap)
    return (q, k, v, dout), kw


def flash_reference(q, k, v, dout, kw):
    """The plain version's output and its autograd's (dq, dk, dv), in
    float64 on the card."""
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_backward_reference,
        flash_attention_reference,
    )

    return (_f64(flash_attention_reference(q, k, v, **kw)),
            [_f64(w) for w in flash_attention_backward_reference(q, k, v, dout, **kw)])


def flash_errors(out, grads, want) -> dict:
    """Both gates' readings of a flash output and its gradients (dq, dk,
    dv) against ``flash_reference``'s ``want``: ``max`` is
    ``cases.max_rel_err``, ``l2`` is ``cases.l2_rel_err``; the backward's
    are the largest over the three gradients."""
    from repro_torch.kernels import cases

    want_o, want_g = want
    got = _f64(out)
    errs = {"fwd_max": cases.max_rel_err(got, want_o), "fwd_l2": cases.l2_rel_err(got, want_o)}
    got = [_f64(g) for g in grads]
    errs["bwd_max"] = max(cases.max_rel_err(g, w) for g, w in zip(got, want_g))
    errs["bwd_l2"] = max(cases.l2_rel_err(g, w) for g, w in zip(got, want_g))
    return errs


def flash_failures(errs: dict, dtype_name: str) -> list:
    """The readings of ``flash_errors`` past their gate (cases.TOL_MAX,
    cases.TOL_L2), or not finite."""
    from repro_torch.kernels import cases

    tol = {"max": cases.TOL_MAX[dtype_name], "l2": cases.TOL_L2[dtype_name]}
    return [f"{k} {e:.3g} > {tol[k[4:]]}" for k, e in errs.items() if not e <= tol[k[4:]]]


def _check_training_kernels(checks: dict, main_err: dict) -> bool:
    """Flash attention forward and backward and the RMSNorm backward against
    their plain versions (the backward: the plain version's autograd), over
    the JAX case tables, the position / kv_len cases, the training shapes
    and (RMSNorm) the model widths. Errors are relative to the largest
    |value| (at least 1); both are also held to the relative L2 error, and
    two backward calls must give bitwise-equal gradients."""
    import torch

    from repro_torch.kernels import cases
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.rmsnorm import ops as RMS
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_backward_reference

    for k in ("flash_attention", "flash_attention_backward", "rmsnorm_backward"):
        checks[k] = []
    flash_cases = ([c + (0, None) for c in cases.FLASH_CASES] + cases.FLASH_KVLEN_CASES
                   + [cases.MAIN_FLASH + (0, None)]
                   + [c + (0, None) for c in cases.FLASH_ARCH_CASES]
                   + cases.MAIN_FLASH_CP_LOCAL + cases.MAIN_FLASH_CP_GLOBAL)
    deterministic = True
    checks["flash_routes"] = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        before = dict(FA.ROUTE_LAUNCHES)
        for case in flash_cases:
            (q, k, v, dout), kw = flash_inputs(case, dtype, seed=14)
            grads = []
            for _ in range(2):
                leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
                out = FA.flash_attention(*leaves, **kw)
                out.backward(dout)
                grads.append([t.grad for t in leaves])
            torch.cuda.synchronize()
            deterministic &= all(torch.equal(a, b) for a, b in zip(*grads))
            errs = flash_errors(out, grads[0], flash_reference(q, k, v, dout, kw))
            checks["flash_attention"].append([dn, list(case[:9]), errs["fwd_max"],
                                              errs["fwd_l2"]])
            checks["flash_attention_backward"].append([dn, list(case[:9]), errs["bwd_max"],
                                                       errs["bwd_l2"]])
            bad = flash_failures(errs, dn)
            if bad:
                raise AssertionError(f"flash attention {dn} {case}: {', '.join(bad)}")
            if case[:9] == cases.MAIN_FLASH and dtype is torch.bfloat16:
                main_err["flash_attention"] = errs["fwd_max"]
                main_err["flash_attention_backward"] = errs["bwd_max"]
                main_err["l2_rel_err"].update({"flash_attention": errs["fwd_l2"],
                                               "flash_attention_backward": errs["bwd_l2"]})
            for name, part in (("flash_attention", "fwd"), ("flash_attention_backward", "bwd")):
                for key in _arch_err_keys(name, case):
                    if dtype is torch.bfloat16:
                        main_err[key] = errs[f"{part}_max"]
                        main_err["l2_rel_err"][key] = errs[f"{part}_l2"]
            del grads, out
            torch.cuda.empty_cache()
        # each dtype on its own route: two forwards and two backwards a case
        moved = {r: FA.ROUTE_LAUNCHES[r] - before[r] for r in before}
        want = {r: (4 * len(flash_cases) if r == FA.route(dtype) else 0) for r in before}
        checks["flash_routes"][dn] = moved
        if moved != want:
            raise AssertionError(f"flash attention {dn}: route launches {moved} != {want}")
        for rows, d in (cases.RMS_CASES + cases.MAIN_RMS + [cases.MAIN_RMS_TRAIN]
                        + cases.RMS_WIDTH_CASES + [c[:2] for c in cases.RMS_ARCH_CASES]):
            for zc in (False, True):
                c = cases.rms_case(rows, d, seed=15)
                x, sc, dy = (torch.from_numpy(c[n]).to(DEV, dtype) for n in ("x", "scale", "dy"))
                xl, sl = x.clone().requires_grad_(True), sc.clone().requires_grad_(True)
                RMS.rmsnorm(xl, sl, 1e-6, zc).backward(dy)
                again = RMS.launch_backward(x, sc, dy, 1e-6, zc)
                torch.cuda.synchronize()
                if not (torch.equal(xl.grad, again[0]) and torch.equal(sl.grad, again[1])):
                    raise AssertionError(f"rmsnorm backward {dn} {(rows, d, zc)}: two calls "
                                         f"gave different gradients")
                dx, ds = rmsnorm_backward_reference(x, sc, dy, 1e-6, zc)
                got, want = (_f64(xl.grad), _f64(sl.grad)), (_f64(dx), _f64(ds))
                e = max(cases.max_rel_err(g, w) for g, w in zip(got, want))
                l2 = max(cases.l2_rel_err(g, w) for g, w in zip(got, want))
                checks["rmsnorm_backward"].append([dn, [rows, d, zc], e, l2])
                if not (e <= cases.TOL_MAX[dn] and l2 <= cases.TOL_L2_RMS[dn]):
                    raise AssertionError(f"rmsnorm backward {dn} {(rows, d, zc)}: err {e}, "
                                         f"relative L2 {l2}")
                if (rows, d) == cases.MAIN_RMS_TRAIN and not zc and dtype is torch.bfloat16:
                    main_err["rmsnorm_backward"] = e
                    main_err["l2_rel_err"]["rmsnorm_backward"] = l2
                for key in _arch_err_keys("rmsnorm_backward", (rows, d, zc)):
                    if dtype is torch.bfloat16:
                        main_err[key], main_err["l2_rel_err"][key] = e, l2
    if not deterministic:
        raise AssertionError("flash attention backward: two calls gave different gradients")
    return deterministic


def _check_dense_flash(checks: dict, main_err: dict) -> None:
    """K2's forward at the dense KV layout's shapes (``cases.MAIN_FLASH_DENSE``),
    both routes: both gates (``cases.TOL_MAX``, ``cases.TOL_L2``), two calls
    bitwise equal, each dtype on its own route."""
    import torch

    from repro_torch.kernels import cases
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention.ref import flash_attention_reference

    checks["flash_attention_dense"], checks["flash_dense_routes"] = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        before = dict(FA.ROUTE_LAUNCHES)
        for name, case in zip(("decode", "chunk"), cases.MAIN_FLASH_DENSE):
            (q, k, v, _), kw = flash_inputs(case, dtype, seed=16)
            with torch.no_grad():
                out, again = FA.flash_attention(q, k, v, **kw), FA.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            got, want = _f64(out), _f64(flash_attention_reference(q, k, v, **kw))
            e, l2 = cases.max_rel_err(got, want), cases.l2_rel_err(got, want)
            checks["flash_attention_dense"].append([dn, name, e, l2])
            if not (e <= cases.TOL_MAX[dn] and l2 <= cases.TOL_L2[dn]):
                raise AssertionError(f"flash attention dense {name} {dn}: err {e}, L2 {l2}")
            if not torch.equal(out, again):
                raise AssertionError(f"flash attention dense {name} {dn}: two calls differ")
            if dtype is torch.bfloat16:
                main_err[f"flash_attention_dense_{name}"] = e
                main_err["l2_rel_err"][f"flash_attention_dense_{name}"] = l2
        moved = {r: FA.ROUTE_LAUNCHES[r] - before[r] for r in before}
        want_r = {r: (4 if r == FA.route(dtype) else 0) for r in before}
        checks["flash_dense_routes"][dn] = moved
        if moved != want_r:
            raise AssertionError(f"flash attention dense {dn}: route launches {moved}")


def _oneshot_reference(q, k, v, kw, block: int = 1024):
    """The plain K2 over ``q``'s rows ``block`` queries at a time (at 32,768
    queries the whole score tensor would not fit the card): each block at
    its own positions against every key, in float64 on the card."""
    import torch

    from repro_torch.kernels.flash_attention.ref import flash_attention_reference

    qpos = kw["q_positions"]
    parts = []
    for i in range(0, q.shape[1], block):
        parts.append(_f64(flash_attention_reference(
            q[:, i:i + block], k, v, **dict(kw, q_positions=qpos[:, i:i + block]))))
    return torch.cat(parts, dim=1)


def _split_case_inputs(case, dtype, seed: int):
    """q, k, v on the card and the keyword arguments of a 12-field K2 row
    (``cases.MAIN_FLASH_ONESHOT``, ``cases.MAIN_FLASH_SPLIT_DECODE``: the
    keys' first position last)."""
    import torch

    from repro_torch.kernels import cases

    B, Sq, Sk, Hq, Hkv, D, causal, win, cap, off, kvl, koff = case
    c = cases.flash_case(B, Sq, Sk, Hq, Hkv, D, seed=seed, q_offset=off, kv_len=kvl,
                         k_offset=koff)
    q, k, v = (torch.from_numpy(c[n]).to(DEV, dtype) for n in ("q", "k", "v"))
    kw = dict(q_positions=torch.from_numpy(c["q_positions"]).to(DEV),
              k_positions=torch.from_numpy(c["k_positions"]).to(DEV),
              kv_len=None if kvl is None else torch.from_numpy(c["kv_len"]).to(DEV),
              causal=causal, window=win, softcap=cap)
    return q, k, v, kw


def _check_oneshot_flash(checks: dict, main_err: dict) -> None:
    """K2 at the one-shot steps' shapes, both routes, both gates
    (``cases.TOL_MAX``, ``cases.TOL_L2``), two calls bitwise equal, each
    dtype on its own route: the one-shot prefill (``cases.MAIN_FLASH_ONESHOT``,
    against the plain version in 1024-query blocks) and a rank's block of a
    split decode (``cases.MAIN_FLASH_SPLIT_DECODE``, through
    ``flash_attention_lse``): its LSE too (finite where the plain version's
    is, within the gates there, ``-inf`` at the row that sees no key of the
    block, whose output is 0)."""
    import torch

    from repro_torch.kernels import cases
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention.ref import flash_attention_reference

    checks["flash_attention_oneshot"], checks["flash_oneshot_routes"] = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        before = dict(FA.ROUTE_LAUNCHES)
        q, k, v, kw = _split_case_inputs(cases.MAIN_FLASH_ONESHOT, dtype, seed=18)
        with torch.no_grad():
            out, again = FA.flash_attention(q, k, v, **kw), FA.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        got, want = _f64(out), _oneshot_reference(q, k, v, kw)
        e, l2 = cases.max_rel_err(got, want), cases.l2_rel_err(got, want)
        bitwise = torch.equal(out, again)
        del q, k, v, out, again, got, want
        torch.cuda.empty_cache()
        q, k, v, kw = _split_case_inputs(cases.MAIN_FLASH_SPLIT_DECODE, dtype, seed=19)
        o, lse = FA.flash_attention_lse(q, k, v, **kw)
        o2, lse2 = FA.flash_attention_lse(q, k, v, **kw)
        torch.cuda.synchronize()
        wo, wl = flash_attention_reference(q, k, v, return_lse=True, **kw)
        fin = torch.isfinite(wl)
        se = max(cases.max_rel_err(_f64(o), _f64(wo)), cases.max_rel_err(lse[fin].double(),
                                                                           wl[fin].double()))
        sl2 = max(cases.l2_rel_err(_f64(o), _f64(wo)), cases.l2_rel_err(lse[fin].double(),
                                                                          wl[fin].double()))
        idle = (bool(((lse == float("-inf")) == ~fin).all())
                and bool((o.permute(0, 2, 1, 3)[~fin] == 0).all()))
        checks["flash_attention_oneshot"] += [[dn, "prefill", e, l2], [dn, "split_decode", se,
                                                                        sl2, idle]]
        if not (e <= cases.TOL_MAX[dn] and l2 <= cases.TOL_L2[dn] and bitwise):
            raise AssertionError(f"flash attention one-shot prefill {dn}: err {e}, L2 {l2}, "
                                 f"bitwise {bitwise}")
        if not (se <= cases.TOL_MAX[dn] and sl2 <= cases.TOL_L2[dn] and idle
                and torch.equal(o, o2) and torch.equal(lse, lse2) and not fin.all()):
            raise AssertionError(f"flash attention split decode {dn}: err {se}, L2 {sl2}, "
                                 f"-inf LSE and 0 output where no key is seen: {idle}")
        if dtype is torch.bfloat16:
            main_err["flash_attention_oneshot"], main_err["flash_attention_split_decode"] = e, se
            main_err["l2_rel_err"]["flash_attention_oneshot"] = l2
            main_err["l2_rel_err"]["flash_attention_split_decode"] = sl2
        moved = {r: FA.ROUTE_LAUNCHES[r] - before[r] for r in before}
        want_r = {r: (4 if r == FA.route(dtype) else 0) for r in before}
        checks["flash_oneshot_routes"][dn] = moved
        if moved != want_r:
            raise AssertionError(f"flash attention one-shot {dn}: route launches {moved}")
        del q, k, v, o, o2, lse, lse2, wo, wl
        torch.cuda.empty_cache()


def _check_nan(checks: dict) -> None:
    """``kernels.nan_check`` for K2 dense, K3 and K4 on both routes: a NaN a
    row can see makes that row non-finite, every other row is bitwise the
    clean call's, kernel and plain version alike. Where no row may look,
    each reading is recorded (the plain versions' 0 * NaN)."""
    from repro_torch.kernels import nan_check

    checks["nan"] = {}
    for kind in nan_check.KINDS:
        for dn in ("float32", "bfloat16"):
            r = nan_check.check(kind, dn, DEV)
            checks["nan"][f"{kind}/{dn}"] = r
            bad = [impl for impl in ("kernel", "plain")
                   if not (r[impl]["seen_nonfinite"] and r[impl]["unseen_equal"])]
            if bad:
                raise AssertionError(f"nan check {kind} {dn}: {r}")


# ---------------------------------------------------------------------------
# phase 3: full width, card vs CPU
# ---------------------------------------------------------------------------


def _greedy_run(model, prompt, page: int, toks=None, dense: bool = False):
    """One ``prefill_chunk`` (every position's logits) then DECODE_STEPS
    ``decode_step``s, feeding ``toks`` or, when None, the run's own greedy
    tokens, over a paged cache (``dense``: the dense layout, through K2).
    Returns, on the CPU in float64, the logits (positions, V), the fed
    tokens, and the residual stream after every layer of every forward
    (prefill first, then each decode step)."""
    import torch

    dev, C = model.device, prompt.shape[1]
    nL = -(-(C + DECODE_STEPS) // page)
    if dense:
        caches, tb = model.init_cache(1, nL * page, paged=False), None
    else:
        caches = model.init_cache(1, nL * page, page_size=page, num_pages=nL)
        tb = torch.arange(nL, dtype=torch.int32, device=dev)[None]
    resid: list = []
    inner = model._apply_slot

    def recording(*a, **k):
        out = inner(*a, **k)
        resid.append(out[0][0].double().cpu())  # (x, aux): the batch's one row
        return out

    model._apply_slot = recording
    try:
        rows = [model.prefill_chunk(torch.from_numpy(prompt).to(dev), caches, 0, C, tb,
                                    all_logits=True)[0]]
        fed = []
        for i in range(DECODE_STEPS):
            fed.append(int(rows[-1][-1].argmax()) if toks is None else toks[i])
            rows.append(model.decode_step(
                torch.tensor([[fed[-1]]], dtype=torch.int32).to(dev),
                torch.tensor([C + i], dtype=torch.int32).to(dev), caches,
                block_tables=tb))
    finally:
        del model._apply_slot
    return torch.cat([r.double().cpu() for r in rows]), fed, resid


def phase_parity():
    import numpy as np
    import torch

    import repro_torch.layers.attention as LA
    import repro_torch.layers.norms as LN
    from repro_torch.kernels.paged_attention import ref as PR
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference
    from repro_torch.layers.common import tree_map
    from repro_torch.models.transformer import Transformer

    cfg = _config().replace(param_dtype_name="float32", compute_dtype_name="float32")
    t0 = time.perf_counter()
    cpu = Transformer.from_init(cfg, seed=0, device="cpu", draw_device="cuda")
    init_s = time.perf_counter() - t0
    page, C = 16, 64
    prompt = np.random.default_rng(21).integers(4, cfg.vocab, size=(1, C)).astype(np.int32)

    # the CPU's fp32 run picks the tokens every other run is fed
    ref, toks, res_cpu = _greedy_run(cpu, prompt, page)
    # the same weights (fp32 values, exact in float64) run in float64: the
    # witness that says how far each fp32 run is from the exact function
    cfg64 = cfg.replace(param_dtype_name="float64", compute_dtype_name="float64")
    exact_model = Transformer(cfg64, tree_map(lambda t: t.double(), cpu.params()), "cpu")
    exact, _, res_exact = _greedy_run(exact_model, prompt, page, toks)
    del exact_model
    gpu = Transformer(cfg, cpu.params(), device=DEV)
    got, _, res_card = _greedy_run(gpu, prompt, page, toks)
    # the same card run with the plain versions in place of the kernels
    # isolates the kernels' share of the difference from the matmuls'
    saved = LA.paged_attention, LA.paged_prefill_attention, LN._rmsnorm_op
    LA.paged_attention = PR.paged_attention_reference
    LA.paged_prefill_attention = PR.paged_prefill_attention_reference
    LN._rmsnorm_op = rmsnorm_reference
    try:
        plain, _, res_plain = _greedy_run(gpu, prompt, page, toks)
    finally:
        LA.paged_attention, LA.paged_prefill_attention, LN._rmsnorm_op = saved

    def dist(a, b) -> float:
        return float((a - b).abs().max())

    err, kernels_err = dist(got, ref), dist(got, plain)
    top2 = ref.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > LOGIT_TOL
    ok_tokens = bool((got.argmax(-1) == ref.argmax(-1))[decided].all())
    finite = bool(torch.isfinite(got).all())
    # each fp32 run against float64: logits by part, and the residual
    # stream per layer (max |fp32 - float64| over max |float64|; for decode
    # the largest over the steps)
    L = cfg.n_layers

    def rel(a, e) -> float:
        return dist(a, e) / float(e.abs().max())

    def witness(logits, res) -> dict:
        d = (logits - exact).abs()
        return {
            "prefill_max": float(d[:C].max()), "decode_max": float(d[C:].max()),
            "rms_rel": float((logits - exact).pow(2).mean().sqrt() / exact.pow(2).mean().sqrt()),
            "layer_prefill_rel": [rel(res[i], res_exact[i]) for i in range(L)],
            "layer_decode_rel": [max(rel(res[s * L + i], res_exact[s * L + i])
                                     for s in range(1, DECODE_STEPS + 1)) for i in range(L)],
        }

    # the dense layout on the card (K2 for attention), the same tokens fed
    dense, _, res_dense = _greedy_run(gpu, prompt, page, toks, dense=True)
    vs_float64 = {"card": witness(got, res_card), "card_plain": witness(plain, res_plain),
                  "cpu": witness(ref, res_cpu),
                  "resid_absmax_prefill": [float(e.abs().max()) for e in res_exact[:L]]}
    card_rms, cpu_rms = vs_float64["card"]["rms_rel"], vs_float64["cpu"]["rms_rel"]
    # one fp32 matmul of the model (the MLP's down projection, K = d_ff)
    # against float64, at the decode (M=1) and prefill (M=C) shapes
    w = cpu.params()["slots"]["slot0_attn"]["mlp"]["wo"][0]
    xs = torch.randn((C, w.shape[0]), generator=torch.Generator().manual_seed(5))
    w_card = w.to(DEV)
    matmul = {}
    for m in (1, C):
        want = xs[:m].double() @ w.double()
        matmul[f"M={m}"] = {
            name: rel(y.double().cpu(), want)
            for name, y in (("card", xs[:m].to(DEV) @ w_card), ("cpu", xs[:m] @ w))}
    vs_float64["matmul_rel"] = matmul
    del w_card
    emit("parity", arch=ARCH, params=cfg.param_count(), dtype="float32",
         positions=int(ref.shape[0]), decode_steps=DECODE_STEPS,
         tolerance={"card_vs_cpu": LOGIT_TOL, "kernels_vs_plain": KERNEL_LOGIT_TOL,
                    "card_over_cpu_rms_vs_float64": EXACT_RATIO},
         max_abs_err=err, card_kernels_vs_card_plain=kernels_err,
         card_plain_vs_cpu=dist(plain, ref), card_over_cpu_rms_vs_float64=card_rms / cpu_rms,
         logit_absmax=float(exact.abs().max()),
         greedy_equal_where_gap_exceeds_tol=ok_tokens,
         positions_decided=int(decided.sum()), vs_float64=vs_float64,
         init_seconds=round(init_s, 3))
    if not (finite and err <= LOGIT_TOL and ok_tokens):
        raise AssertionError(f"card vs CPU logits: err {err} (tol {LOGIT_TOL}), "
                             f"finite {finite}, greedy equal {ok_tokens}")
    if kernels_err > KERNEL_LOGIT_TOL:
        raise AssertionError(f"card kernels vs card plain versions: {kernels_err} "
                             f"> {KERNEL_LOGIT_TOL}")
    if card_rms > EXACT_RATIO * cpu_rms:
        raise AssertionError(f"card's RMS logit error against float64 {card_rms}, "
                             f"more than {EXACT_RATIO}x the CPU fp32 run's ({cpu_rms})")
    dense_parity = {"max_abs_err_vs_cpu": dist(dense, ref),
                    "finite": bool(torch.isfinite(dense).all()),
                    "vs_float64": witness(dense, res_dense),
                    "cpu_rms_rel_vs_float64": cpu_rms,
                    "tolerance": {"vs_cpu": LOGIT_TOL, "rms_over_cpu_vs_float64": EXACT_RATIO}}
    params = cpu.params()
    del cpu, gpu
    torch.cuda.empty_cache()
    return params, dense_parity


# ---------------------------------------------------------------------------
# phase 4: serve at full width
# ---------------------------------------------------------------------------


def _serve_once(model, cfg, prompts, max_new, flush_every_tick: bool):
    import torch

    from repro_torch.serve.serve import BatchScheduler, ServeConfig

    sched = BatchScheduler(model, ServeConfig(
        max_len=512, batch=4, prefill_chunk=64, overlap=True, page_size=16))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for rid, p in enumerate(prompts):
        sched.submit(p, request_id=rid, max_new=max_new)
    while len(sched.completed) < len(prompts):
        sched.step()
        if flush_every_tick:
            sched.flush()
    sched.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ttft = sorted(r["t_first_token"] - r["t_submit"] for r in sched.completed)
    n_tok = sum(len(r["generated"]) for r in sched.completed)
    return sched, wall, ttft, n_tok


def _serve_trace(cfg):
    """8 requests of 64-256 seeded prompt tokens, 32 new tokens each."""
    import numpy as np

    rng = np.random.default_rng(31)
    prompts = [rng.integers(4, cfg.vocab, size=int(n)).tolist()
               for n in rng.integers(64, 257, size=8)]
    return prompts, 32


def phase_profile(model):
    """The serve trace once more under ``torch.profiler``: device busy time
    (sum of kernel self time) over wall time, and where it goes."""
    from torch.profiler import ProfilerActivity, profile

    cfg = model.cfg
    prompts, max_new = _serve_trace(cfg)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sched, wall, _, n_tok = _serve_once(model, cfg, prompts, max_new, False)
    events = _device_events(prof)
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    emit("profile", wall_s=wall, tokens_per_s=n_tok / wall,
         ticks=sched.stats["ticks"], device_busy_ms=busy_us / 1e3,
         device_busy_share=busy_us / 1e6 / wall,
         # the profiler slows the host; against phase 4's unprofiled wall
         device_busy_share_unprofiled=busy_us / 1e6 / RESULT["serve"]["wall_s"],
         groups_ms_count=_groups(events),
         top_kernels=[[e.key[:90], round(e.self_device_time_total / 1e3, 3), e.count]
                      for e in top])


def phase_serve(params_f32):
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.layers.common import tree_map
    from repro_torch.models.transformer import Transformer

    cfg = _config()  # bf16 params and compute
    torch.cuda.reset_peak_memory_stats()  # the serve's own peak, not phase 3's
    model = Transformer(cfg, tree_map(lambda t: t.to(torch.bfloat16), params_f32), DEV)
    prompts, max_new = _serve_trace(cfg)
    bad = _finite_guard(model)
    reset_launch_counts()
    sched, wall, ttft, n_tok = _serve_once(model, cfg, prompts, max_new, False)
    counts = launch_counts()
    st = sched.stats
    L = cfg.n_layers
    forwards = st["decode_steps"] + st["prefill_chunks"]
    want = {k: 0 for k in counts}  # no training kernel in the serve
    want.update({"paged_attention": L * st["decode_steps"],
                 "paged_prefill_attention": L * st["prefill_chunks"],
                 "rmsnorm": (2 * L + 1) * forwards})
    gens = [r["generated"] for r in sched.completed]
    _, wall_s, ttft_s, n_tok_s = _serve_once(model, cfg, prompts, max_new, True)
    kv = sched.kv_cache_stats()
    emit("serve", arch=ARCH, dtype="bfloat16", requests=len(prompts),
         prompt_lens=[len(p) for p in prompts], max_new=max_new,
         completed=len(sched.completed), ticks=st["ticks"],
         decode_steps=st["decode_steps"], prefill_chunks=st["prefill_chunks"],
         overlap_ticks=st["overlap_ticks"], readbacks=st["readbacks"],
         launches=counts, expected_launches=want,
         tokens_per_s=n_tok / wall, wall_s=wall,
         ttft_deferred_s={"p50": ttft[len(ttft) // 2], "max": ttft[-1]},
         streaming={"tokens_per_s": n_tok_s / wall_s, "wall_s": wall_s,
                    "ttft_s": {"p50": ttft_s[len(ttft_s) // 2], "max": ttft_s[-1]}},
         peak_used_pages=kv["peak_used_pages"], kv_bytes=kv["kv_bytes"],
         peak_mem_bytes=torch.cuda.max_memory_allocated())
    if len(sched.completed) != len(prompts) or any(len(g) != max_new for g in gens):
        raise AssertionError(f"serve: {len(sched.completed)} completed, lengths "
                             f"{[len(g) for g in gens]}")
    if any(not 0 <= t < cfg.vocab_padded for g in gens for t in g):
        raise AssertionError("serve: token id out of range")
    if bool(bad):
        raise AssertionError("serve: non-finite logits")
    if counts != want or min(counts[k] for k in SERVE_KERNELS) <= 0:
        raise AssertionError(f"serve: launches {counts} != expected {want}")
    return model, counts, {r["id"]: r["generated"] for r in sched.completed}, n_tok / wall


# ---------------------------------------------------------------------------
# phase 4b: serving under load at full width
# ---------------------------------------------------------------------------


def _load_scheduler(model, session=None, fault_injector=None, **kw):
    from repro_torch.serve.serve import BatchScheduler, ServeConfig

    base = dict(max_len=LOAD_MAX_LEN, batch=LOAD_BATCH, prefill_chunk=64, overlap=True,
                page_size=16)
    return BatchScheduler(model, ServeConfig(**{**base, **kw}), session=session,
                          fault_injector=fault_injector)


def _serve_launches(cfg, st) -> dict:
    """The exact launches of a serving run: per forward N+1 RMSNorm (N =
    ``_layer_norms``, 2L for tinyllama), per decode step A paged decode (A
    = ``_attn_layers``, L for tinyllama), per prefill chunk A paged
    prefill, per speculative verify (counted among the decode steps) A
    paged prefill and a forward's RMSNorms, twice with recurrent state (the
    scoring pass, then the commit pass)."""
    from repro_torch.kernels import launch_counts

    A, N = _attn_layers(cfg), _layer_norms(cfg)
    verify = st["spec_dispatches"]
    passes = 2 if any(k in _RECURRENT_NORMS for k in cfg.pattern) else 1
    forwards = st["decode_steps"] - verify + passes * verify + st["prefill_chunks"]
    want = dict.fromkeys(launch_counts(), 0)
    want.update({"paged_attention": A * (st["decode_steps"] - verify),
                 "paged_prefill_attention": A * (st["prefill_chunks"] + passes * verify),
                 "rmsnorm": (N + 1) * forwards})
    return want


def _page_bytes(sched, page: int) -> list:
    return [pool[:, page].clone() for slot in sched.caches.values()
            for pool in slot["attn"].values()]


def _prefix_run(model, cfg, failures: list) -> dict:
    """(a) A 250-token system prompt and 16 requests with private tails:
    request 0 runs until its prompt is prefilled (its pages enter the
    trie), then the other 15 attach against it. Every trie page's bytes
    are snapshotted at its insert and compared at the end."""
    import numpy as np
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts

    rng = np.random.default_rng(41)
    system = rng.integers(4, cfg.vocab, size=250).tolist()
    prompts = [system + rng.integers(4, cfg.vocab, size=int(n)).tolist()
               for n in rng.integers(8, 65, size=16)]
    sched = _load_scheduler(model, prefix_cache=True)
    snaps, insert = {}, sched._prefix.insert

    def recording(prompt, pages):
        insert(prompt, pages)
        for p in pages[:len(prompt) // sched.scfg.page_size]:
            if p not in snaps:
                snaps[p] = _page_bytes(sched, p)

    sched._prefix.insert = recording
    reset_launch_counts()
    t0 = time.perf_counter()
    h0 = sched.submit(prompts[0], request_id=0, max_new=64)
    while h0.status in ("queued", "prefilling"):
        sched.step()
    for rid, p in enumerate(prompts[1:], start=1):
        sched.submit(p, request_id=rid, max_new=64)
    sched.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, want = launch_counts(), _serve_launches(cfg, sched.stats)
    kv = sched.kv_cache_stats()
    pc = kv["prefix_cache"]
    trie_pages = sorted(n.page for n in _trie_nodes(sched._prefix))
    changed = [p for p in trie_pages
               if not all(torch.equal(a, b) for a, b in zip(_page_bytes(sched, p), snaps[p]))]
    in_use, pinned = kv["pages_in_use"], sched._prefix.size
    sched._prefix.clear()
    after_clear = sched.kv_cache_stats()["pages_in_use"]
    gens = [r["generated"] for r in sched.completed]
    out = {"requests": len(prompts), "prompt_lens": [len(p) for p in prompts],
           "completed": len(sched.completed), "prefix_cache": pc,
           "pages_in_use_after_drain": in_use, "trie_pages": pinned,
           "pages_in_use_after_clear": after_clear, "snapshotted_pages": len(snaps),
           "trie_pages_changed": changed, "ticks": sched.stats["ticks"],
           "decode_steps": sched.stats["decode_steps"],
           "prefill_chunks": sched.stats["prefill_chunks"],
           "launches": counts, "wall_s": wall}
    if pc["hits"] != 15 or pc["cow_copies"] < 1 or pc["prefill_tokens_skipped"] <= 0:
        failures.append(f"prefix: hits {pc['hits']}, cow {pc['cow_copies']}, "
                        f"skipped {pc['prefill_tokens_skipped']}")
    if in_use != pinned or after_clear != 0:
        failures.append(f"prefix: {in_use} pages in use after drain, trie {pinned}, "
                        f"{after_clear} after clear")
    if changed or set(trie_pages) - set(snaps):
        failures.append(f"prefix: trie pages written after insert: {changed}")
    if len(gens) != 16 or any(len(g) != 64 for g in gens):
        failures.append(f"prefix: {len(gens)} completed, lengths {[len(g) for g in gens]}")
    if counts != want:
        failures.append(f"prefix: launches {counts} != expected {want}")
    return out


def _trie_nodes(trie) -> list:
    out, stack = [], list(trie.root.children.values())
    while stack:
        n = stack.pop()
        out.append(n)
        stack.extend(n.children.values())
    return out


def _first_divergence(a: list, b: list) -> int | None:
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def _history_logits(model, hist: list, dense: bool = False):
    """Logits (V,) after ``hist``: through ``prefill_chunk`` on the card
    (64-token chunks, fresh cache; ``dense``: the dense layout)."""
    import torch

    nL = -(-len(hist) // 16)
    if dense:
        caches, tb = model.init_cache(1, nL * 16, paged=False), None
    else:
        caches = model.init_cache(1, nL * 16, page_size=16, num_pages=nL)
        tb = torch.arange(nL, dtype=torch.int32, device=DEV)[None]
    for start in range(0, len(hist), 64):
        chunk = hist[start:start + 64]
        logits = model.prefill_chunk(torch.tensor([chunk], dtype=torch.int32, device=DEV),
                                     caches, start, len(chunk), tb)
    return logits[0]


def _top2_gap(model, prompt: list, tokens: list, i: int) -> float:
    """Top-2 logit gap where ``tokens[i]`` is chosen."""
    top2 = _history_logits(model, prompt + tokens[:i]).float().topk(2).values
    return float(top2[0] - top2[1])


def phase_serve_load(model):
    """Serving under load, bf16, phase 4's seeded weights, batch 16,
    max_len 1024, page 16, chunk 64, overlap: (a) the prefix run; (b) the
    traffic harness's bursty trace against a tight pool under the monitor,
    its record in ``results/talp/<arch>/serve_monitor/``; (c) the same
    trace with an ample pool, no prefix cache and the null collector, whose
    greedy tokens must equal (b)'s except at shown near ties."""
    import torch

    from repro_torch.core.factors import validate_pop
    from repro_torch.core.records import ResourceConfig, RunRecord
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.traffic import TrafficConfig, generate_workload, replay
    from repro_torch.session import PerfSession, SessionConfig

    cfg = model.cfg
    failures: list = []
    prefix = _prefix_run(model, cfg, failures)
    torch.cuda.empty_cache()

    work = generate_workload(TrafficConfig(**LOAD_TRAFFIC))
    runs = {}
    for name in ("tight", "ample"):
        monitored = name == "tight"
        # every computation in the record (not the default 16 heaviest), so
        # the kernels' counted costs can be checked there
        session = PerfSession(
            SessionConfig(app_name=f"serve-{ARCH}", backend="monitor" if monitored else "null",
                          lb_sample_every=1, respect_env=False, top_computations=64),
            ResourceConfig(num_hosts=1, devices_per_host=1))
        sched = _load_scheduler(model, session=session,
                                num_pages=LOAD_PAGES if monitored else None)
        reset_launch_counts()
        with session:
            m = replay(sched, work)
        torch.cuda.synchronize()
        counts = launch_counts()
        want = _serve_launches(cfg, sched.stats)
        if counts != want:
            failures.append(f"{name}: launches {counts} != expected {want}")
        if monitored:
            session.finalize(os.path.join(TALP_DIR, ARCH, "serve_monitor"))
        runs[name] = {"metrics": m, "stats": dict(sched.stats), "launches": counts,
                      "record": session.last_record_path}
        del sched
        torch.cuda.empty_cache()

    tight, ample = runs["tight"]["metrics"], runs["ample"]["metrics"]
    st = runs["tight"]["stats"]
    if (tight["preemptions"] < 1 or tight["resumes"] != tight["preemptions"]
            or tight["cancellations"] < 1 or tight["failed"] != 0):
        failures.append(f"tight: preemptions {tight['preemptions']}, resumes "
                        f"{tight['resumes']}, cancellations {tight['cancellations']}, "
                        f"failed {tight['failed']}")
    if tight["completed"] + tight["cancelled"] != len(work) or tight["kv"]["pages_in_use"]:
        failures.append(f"tight: {tight['completed']} completed + {tight['cancelled']} "
                        f"cancelled of {len(work)}, {tight['kv']['pages_in_use']} pages in use")
    # the pool filled, and filling it preempted more than priority alone
    if (tight["kv"]["peak_used_pages"] != LOAD_PAGES
            or tight["preemptions"] <= ample["preemptions"]):
        failures.append(f"tight: peak {tight['kv']['peak_used_pages']} of {LOAD_PAGES} pages, "
                        f"{tight['preemptions']} preemptions vs {ample['preemptions']} ample")
    record = RunRecord.load(runs["tight"]["record"])
    visits = {n: r.measurements.num_visits for n, r in record.regions.items()}
    pop_errors = {n: e for n, r in record.regions.items() if (e := validate_pop(r.pop))}
    if not {"decode", "prefill", "preempt", "traffic"} <= set(visits) or pop_errors:
        failures.append(f"record: regions {sorted(visits)}, POP errors {pop_errors}")
    elif (visits["decode"], visits["prefill"], visits["preempt"]) != (
            st["decode_steps"], st["prefill_chunks"], st["preemptions"]):
        failures.append(f"record visits {visits} vs decode {st['decode_steps']}, "
                        f"prefill {st['prefill_chunks']}, preempt {st['preemptions']}")
    # the first decode and chunk were counted with the kernels' own costs
    kernel_costs = {}
    for region, names in (("decode", ("paged_attention", "rmsnorm")),
                          ("prefill", ("paged_prefill_attention", "rmsnorm"))):
        comps = record.regions[region].computations if region in record.regions else {}
        kernel_costs.update({f"{region}/{n}": comps[n].flops for n in names if n in comps})
    if len(kernel_costs) != 4 or min(kernel_costs.values()) <= 0:
        failures.append(f"record: kernel costs {kernel_costs}")

    # (c) greedy tokens of every request completed in both runs
    prompts = {str(r.request_id): list(r.prompt) for r in work}
    ties, compared = [], 0
    for rid, toks in tight["generated"].items():
        if rid not in ample["generated"]:
            continue
        compared += 1
        i = _first_divergence(toks, ample["generated"][rid])
        if i is None:
            continue
        gap = _top2_gap(model, prompts[rid], toks, i)
        ties.append({"request": rid, "position": i, "top2_gap": gap})
        if not gap < LOGIT_TOL:
            failures.append(f"identity: request {rid} differs at token {i}, top-2 gap "
                            f"{gap} >= {LOGIT_TOL}")
    if compared == 0:
        failures.append("identity: no request completed in both runs")

    def info(m: dict) -> dict:
        return {k: m[k] for k in ("completed", "cancelled", "failed", "ticks", "wall_s",
                                  "good_tokens", "goodput_tokens_per_sec", "ttft_p50_s",
                                  "ttft_p95_s", "ttft_p99_s", "ttft_max_s",
                                  "queue_depth_peak", "queue_depth_mean", "preemptions",
                                  "resumes", "cancellations")}

    regions_s = {n: {"elapsed_s": r.measurements.elapsed_s,
                     "device_time_s": r.measurements.device_time_s, "visits": visits[n]}
                 for n, r in record.regions.items()}
    emit("serve_load", arch=ARCH, dtype="bfloat16", batch=LOAD_BATCH, max_len=LOAD_MAX_LEN,
         prefix=prefix, traffic=LOAD_TRAFFIC, pool_pages=LOAD_PAGES,
         tight={**info(tight), "kv": tight["kv"], "sched_stats": st,
                "launches": runs["tight"]["launches"]},
         ample={**info(ample), "peak_used_pages": ample["kv"]["peak_used_pages"],
                "sched_stats": runs["ample"]["stats"], "launches": runs["ample"]["launches"]},
         record=os.path.relpath(runs["tight"]["record"], ROOT), visits=visits,
         kernel_flops=kernel_costs,
         regions=regions_s, identity={"compared": compared, "near_ties": ties})
    if failures:
        raise AssertionError("serve_load: " + "; ".join(failures))
    return runs["tight"]["launches"]


def _shallow(model, repeats: int):
    """``model``'s first ``repeats`` layers as a model of its own, its
    stacked leaves views of ``model``'s (no copy)."""
    from repro_torch.layers.common import tree_leaves, unflatten
    from repro_torch.models.transformer import Transformer

    cut = {p: (t[:repeats] if p.startswith("slots/") else t).detach()
           for p, t in tree_leaves(model.params())}
    return Transformer(model.cfg.replace(repeats=repeats), unflatten(cut), model.device)


def phase_profile_load(model):
    """``--profile``: phase 4b's tight-pool trace again under the monitor,
    with ``torch.profiler`` recording PROFILE_LOAD_TICKS ticks from tick
    PROFILE_LOAD_FROM (mid-burst): the card's busy share of those ticks'
    wall time, and where its time goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.core.records import ResourceConfig
    from repro_torch.serve.traffic import TrafficConfig, generate_workload, replay
    from repro_torch.session import PerfSession, SessionConfig

    session = PerfSession(SessionConfig(app_name=f"serve-{ARCH}", backend="monitor",
                                        lb_sample_every=1, respect_env=False),
                          ResourceConfig(num_hosts=1, devices_per_host=1))
    sched = _load_scheduler(model, session=session, num_pages=LOAD_PAGES)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=PROFILE_LOAD_FROM - 2, warmup=2,
                                     active=PROFILE_LOAD_TICKS, repeat=1))
    ends, inner = [], sched.step
    forwards = []

    def stepping():
        busy = inner()
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        forwards.append(sched.stats["decode_steps"] + sched.stats["prefill_chunks"])
        prof.step()
        return busy

    sched.step = stepping
    with session, prof:
        replay(sched, generate_workload(TrafficConfig(**LOAD_TRAFFIC)))
    a, b = PROFILE_LOAD_FROM - 1, PROFILE_LOAD_FROM + PROFILE_LOAD_TICKS - 1
    wall = ends[b] - ends[a]
    events = _device_events(prof)
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    emit("serve_load_profile", ticks=[a + 2, b + 1], forwards=forwards[b] - forwards[a],
         wall_s=wall, device_busy_ms=busy_us / 1e3, device_busy_share=busy_us / 1e6 / wall,
         groups_ms_count=_groups(events),
         top_kernels=[[e.key[:90], round(e.self_device_time_total / 1e3, 3), e.count]
                      for e in top])


# ---------------------------------------------------------------------------
# phase 4c: sampled decoding and speculation at full width
# ---------------------------------------------------------------------------


def _sampled_top2_gap(model, prompt: list, tokens: list, i: int, rid, temperature: float,
                      top_k, seed: int) -> float:
    """Top-2 gap of (logits / T, top-k masked, + the request's Gumbel draw)
    where ``tokens[i]`` is sampled, with the scheduler's key ``fold_in(
    fold_in(PRNGKey(seed), tag), position)``."""
    import torch

    from repro_torch import prng
    from repro_torch.serve.serve import _request_tag

    hist = prompt + tokens[:i]
    lg = _history_logits(model, hist).float() / temperature
    lg[model.cfg.vocab:] = float("-inf")
    if top_k:
        lg = torch.where(lg >= lg.topk(top_k).values[-1], lg, float("-inf"))
    key = prng.fold_in(prng.fold_in(prng.prng_key(seed), _request_tag(rid)).to(DEV),
                       len(hist) - 1)
    z = (lg + prng.gumbel(key, lg.shape[0])).topk(2).values
    return float(z[0] - z[1])


def _tie_check(model, prompts: dict, runs: dict, base: str, label: str, failures: list,
               sampled=None) -> list:
    """Every request's tokens in each run against ``runs[base]``: equal, or
    equal up to a near tie where they first differ (greedy: the top-2 logit
    gap below LOGIT_TOL; ``sampled`` (temperature, top_k, seed): the top-2
    gap of logits / T + the Gumbel draw below ``sampled[3]``)."""
    ties = []
    for name, toks in runs.items():
        if name == base:
            continue
        for rid, want in runs[base].items():
            got = toks.get(rid)
            if got is None or len(got) != len(want):
                failures.append(f"{label} {name}: request {rid} has "
                                f"{None if got is None else len(got)} tokens, {base} {len(want)}")
                continue
            i = _first_divergence(got, want)
            if i is None:
                continue
            if sampled:
                gap = _sampled_top2_gap(model, prompts[rid], want, i, rid, *sampled[:3])
                limit = sampled[3]
            else:
                gap, limit = _top2_gap(model, prompts[rid], want, i), LOGIT_TOL
            ties.append({"run": name, "request": rid, "position": i, "top2_gap": gap})
            if not gap < limit:
                failures.append(f"{label} {name}: request {rid} differs at token {i}, "
                                f"top-2 gap {gap} >= {limit}")
    return ties


def _spec_run(model, cfg, reqs, failures: list, label: str, late=None, session=None,
              **kw) -> dict:
    """Serve ``reqs`` [(id, prompt, max_new)] on phase 4b's server shape,
    launch counters zeroed before and read after; ``late`` (id, prompt,
    max_new, blocker id): submitted after the first tick, when every slot is
    busy, so it waits for the (short) blocker's slot. Checks the launches,
    the late request's slot and that no page stays in use."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts

    sched = _load_scheduler(model, session=session, **kw)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for rid, prompt, max_new in reqs:
        sched.submit(prompt, request_id=rid, max_new=max_new)
    if late is not None:
        sched.step()  # every request attaches: the batch is full
        full = not any(sched._free(s) for s in range(LOAD_BATCH))
        blocker_slot = sched._slot_of(sched._by_id[late[3]])
        handle = sched.submit(late[1], request_id=late[0], max_new=late[2])
        waited = 0
        while handle.status == "queued":
            sched.step()
            waited += 1
        late_info = {"batch_full_at_submit": full, "waited_ticks": waited,
                     "slot": sched._slot_of(sched._by_id[late[0]]),
                     "blocker_slot": blocker_slot}
        if not (full and waited > 0 and late_info["slot"] == blocker_slot):
            failures.append(f"{label}: the late request did not wait for the "
                            f"blocker's slot: {late_info}")
    sched.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, want = launch_counts(), _serve_launches(cfg, sched.stats)
    kv = sched.kv_cache_stats()
    toks = {r["id"]: r["generated"] for r in sched.completed}
    n_tok = sum(len(t) for t in toks.values())
    out = {"wall_s": wall, "ticks": sched.stats["ticks"], "tokens": n_tok,
           "goodput_tokens_per_s": n_tok / wall, "launches": counts,
           "sched_stats": dict(sched.stats), "speculation": kv["speculation"],
           "pressure": kv["pressure"], "peak_used_pages": kv["peak_used_pages"],
           "pages_in_use": kv["pages_in_use"], "generated": toks}
    if late is not None:
        out["late"] = late_info
    if counts != want:
        failures.append(f"{label}: launches {counts} != expected {want}")
    if kv["pages_in_use"] or len(toks) != len(reqs) + (late is not None):
        failures.append(f"{label}: {len(toks)} completed, {kv['pages_in_use']} pages in use")
    if any(not 0 <= t < cfg.vocab for g in toks.values() for t in g):
        failures.append(f"{label}: token id out of range")
    return out


def _copy_regime_motifs(copy_model, n: int, rng) -> tuple[list, list]:
    """Prompts for the copy regime: a 4-token motif repeated, its last token
    on a short cycle of the successor map, so greedy decode cycles at once.
    The map is computed on the card as a decode step computes it (rows of
    LOAD_BATCH through the final norm and the head); its cycles are found
    on the host, the shortest used first (length-1 cycles last). Returns
    the prompts and the cycles' lengths."""
    import numpy as np
    import torch

    V = copy_model.cfg.vocab
    succ = []
    with torch.inference_mode():
        for i in range(0, V, LOAD_BATCH):
            t = torch.arange(i, min(i + LOAD_BATCH, V), dtype=torch.int32, device=DEV)[:, None]
            x = copy_model._final_norm(copy_model._embed_inputs(t))
            succ.append(copy_model._logits(x)[:, 0, :V].argmax(-1))
    f = torch.cat(succ).cpu().numpy()
    state = np.zeros(V, np.int8)
    cycles = []
    for s in range(V):
        path = []
        t = s
        while state[t] == 0:
            state[t] = 1
            path.append(t)
            t = int(f[t])
        if state[t] == 1:
            cycles.append(path[path.index(t):])
        state[path] = 2
    cycles.sort(key=lambda c: (len(c) == 1, len(c)))
    ends = [t for c in cycles for t in c][:n]
    prompts = []
    for j in range(n):
        motif = rng.integers(4, V, size=3).tolist() + [int(ends[j % len(ends)])]
        prompts.append(motif * SPEC_MOTIF_REPS)
    return prompts, sorted(len(c) for c in cycles)


def _sampler_timing(cfg, spec_ticks_s: float, decode_tick_s: float) -> dict:
    """The sampler (plain torch ops, no Pallas counterpart) at the decode
    (LOAD_BATCH rows) and verify (LOAD_BATCH * (SPEC_K + 1) rows) shapes:
    time per call (CUDA events), kernels per call (the profiler), and its
    share of a tick's wall time."""
    import functools

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import prng
    from repro_torch.serve.serve import _sample_tokens

    out = {}
    for name, rows, tick in (("decode", LOAD_BATCH, decode_tick_s),
                             ("verify", LOAD_BATCH * (SPEC_K + 1), spec_ticks_s)):
        logits = torch.randn(rows, cfg.vocab_padded, device=DEV).to(torch.bfloat16)
        keys = prng.split(prng.prng_key(1), rows).to(DEV)
        pos = torch.arange(rows, dtype=torch.int32, device=DEV)
        fn = functools.partial(_sample_tokens, logits, keys, pos, greedy=False,
                               vocab=cfg.vocab, **{k: SAMPLE[k] for k in ("temperature", "top_k")})
        ms = cuda_ms(fn, iters=20, warmup=3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        launches = sum(e.count for e in _device_events(prof))
        out[name] = {"rows": rows, "ms": ms, "kernels": launches,
                     "tick_share": ms / 1e3 / tick if tick else None}
    return out


def phase_serve_spec(model):
    """Sampled decoding and speculation, bf16, phase 4b's server shape: (a)
    sampled streams equal in submit order, in reverse order with overlap
    off, and with one request attached late behind a busy slot; (b) the copy
    regime, spec on and off, greedy and sampled: tokens equal, drafts
    accepted, fewer dispatches, exact launches (no K3 under speculation);
    (c) (b)'s greedy traffic against a pool it fills: preemptions resumed,
    tokens equal; (d) (b)'s greedy spec run under the monitor: a record
    whose ``decode`` region is visited once per verify with K4's FLOPs."""
    import numpy as np
    import torch

    from repro_torch.core.factors import validate_pop
    from repro_torch.core.records import ResourceConfig, RunRecord
    from repro_torch.layers.common import tree_map
    from repro_torch.models.transformer import Transformer
    from repro_torch.session import PerfSession, SessionConfig

    cfg = model.cfg
    failures: list = []

    # (a) sampled streams
    rng = np.random.default_rng(51)
    prompts_a = {rid: rng.integers(4, cfg.vocab, size=int(n)).tolist()
                 for rid, n in enumerate(rng.integers(77, 239, size=SPEC_REQUESTS))}
    reqs = [(rid, p, 64) for rid, p in prompts_a.items()]
    late_id = SPEC_REQUESTS - 1
    blocker = ("blocker", rng.integers(4, cfg.vocab, size=40).tolist(), 8)
    sampled = {
        "submit_order": _spec_run(model, cfg, reqs, failures, "sampled", **SAMPLE),
        "reverse_no_overlap": _spec_run(model, cfg, reqs[::-1], failures, "sampled reverse",
                                        overlap=False, **SAMPLE),
        "late_attach": _spec_run(model, cfg, [blocker] + reqs[:-1], failures, "sampled late",
                                 late=(late_id, prompts_a[late_id], 64, "blocker"), **SAMPLE),
    }
    streams = {k: {rid: r["generated"][rid] for rid in prompts_a} for k, r in sampled.items()}
    ties_a = _tie_check(model, prompts_a, streams, "submit_order", "sampled", failures,
                        sampled=(SAMPLE["temperature"], SAMPLE["top_k"], SAMPLE["sample_seed"],
                                 LOGIT_TOL))
    torch.cuda.empty_cache()

    # (b) the copy regime
    params = model.params()
    copy_model = Transformer(cfg, dict(params, slots=tree_map(torch.zeros_like,
                                                              params["slots"])), DEV)
    prompts_list, cycle_lens = _copy_regime_motifs(copy_model, SPEC_REQUESTS,
                                                   np.random.default_rng(52))
    prompts_b = dict(enumerate(prompts_list))
    reqs_b = [(rid, p, SPEC_NEW) for rid, p in prompts_b.items()]
    samp_b = dict(SAMPLE, temperature=SPEC_COPY_TEMP)
    session = PerfSession(
        SessionConfig(app_name=f"serve-{ARCH}", backend="monitor", lb_sample_every=1,
                      respect_env=False, top_computations=64),
        ResourceConfig(num_hosts=1, devices_per_host=1))
    copy = {"greedy_off": _spec_run(copy_model, cfg, reqs_b, failures, "copy greedy off")}
    with session:
        copy["greedy_on"] = _spec_run(copy_model, cfg, reqs_b, failures, "copy greedy on",
                                      session=session, spec_decode=True, spec_k=SPEC_K)
    session.finalize(os.path.join(TALP_DIR, ARCH, "serve_spec"))
    copy["sampled_off"] = _spec_run(copy_model, cfg, reqs_b, failures, "copy sampled off",
                                    **samp_b)
    copy["sampled_on"] = _spec_run(copy_model, cfg, reqs_b, failures, "copy sampled on",
                                   spec_decode=True, spec_k=SPEC_K, **samp_b)
    ties_b = _tie_check(copy_model, prompts_b, {k: copy[k]["generated"] for k in
                                                ("greedy_off", "greedy_on")},
                        "greedy_off", "copy greedy", failures)
    # a logit that moves by LOGIT_TOL moves logits / T by LOGIT_TOL / T
    ties_b += _tie_check(copy_model, prompts_b, {k: copy[k]["generated"] for k in
                                                 ("sampled_off", "sampled_on")},
                         "sampled_off", "copy sampled", failures,
                         sampled=(samp_b["temperature"], samp_b["top_k"],
                                  samp_b["sample_seed"], LOGIT_TOL / samp_b["temperature"]))
    # sampling really sampled: some stream left the greedy path
    if copy["sampled_off"]["generated"] == copy["greedy_off"]["generated"]:
        failures.append("copy sampled: every sampled stream equals the greedy one")
    for mode in ("greedy", "sampled"):
        on, off = copy[f"{mode}_on"], copy[f"{mode}_off"]
        sp = on["speculation"]
        if (sp["accepted"] <= 0 or sp["tokens_per_dispatch"] <= 1
                or on["sched_stats"]["decode_steps"] >= off["sched_stats"]["decode_steps"]):
            failures.append(f"copy {mode}: speculation {sp}, decode dispatches "
                            f"{on['sched_stats']['decode_steps']} vs "
                            f"{off['sched_stats']['decode_steps']} off")
        if on["launches"]["paged_attention"] != 0:
            failures.append(f"copy {mode}: {on['launches']['paged_attention']} K3 launches")

    # (c) speculation under pressure
    tight = _spec_run(copy_model, cfg, reqs_b, failures, "copy tight",
                      num_pages=SPEC_TIGHT_PAGES, spec_decode=True, spec_k=SPEC_K)
    pr = tight["pressure"]
    if (pr["preemptions"] < 1 or pr["resumes"] != pr["preemptions"]
            or tight["peak_used_pages"] != SPEC_TIGHT_PAGES):
        failures.append(f"copy tight: pressure {pr}, peak {tight['peak_used_pages']} of "
                        f"{SPEC_TIGHT_PAGES} pages")
    ties_c = _tie_check(copy_model, prompts_b, {"ample": copy["greedy_on"]["generated"],
                                                "tight": tight["generated"]},
                        "ample", "copy tight", failures)

    # (d) the monitored record of (b)'s greedy spec run
    record = RunRecord.load(session.last_record_path)
    visits = {n: r.measurements.num_visits for n, r in record.regions.items()}
    pop_errors = {n: e for n, r in record.regions.items() if (e := validate_pop(r.pop))}
    st = copy["greedy_on"]["sched_stats"]
    if pop_errors or visits.get("decode") != st["spec_dispatches"] or \
            visits.get("prefill") != st["prefill_chunks"]:
        failures.append(f"record: visits {visits}, spec dispatches {st['spec_dispatches']}, "
                        f"chunks {st['prefill_chunks']}, POP errors {pop_errors}")
    comps = record.regions["decode"].computations if "decode" in record.regions else {}
    decode_k4 = comps["paged_prefill_attention"].flops if "paged_prefill_attention" in comps \
        else 0.0
    if decode_k4 <= 0 or "paged_attention" in comps:
        failures.append(f"record: decode region's kernels {sorted(comps)}")
    def info(r: dict) -> dict:
        return {k: r[k] for k in ("wall_s", "ticks", "tokens", "goodput_tokens_per_s",
                                  "speculation", "pressure", "peak_used_pages", "launches")}

    decode_tick = sampled["submit_order"]["wall_s"] / sampled["submit_order"]["ticks"]
    spec_tick = copy["sampled_on"]["wall_s"] / copy["sampled_on"]["ticks"]
    emit("serve_spec", arch=ARCH, dtype="bfloat16", batch=LOAD_BATCH, max_len=LOAD_MAX_LEN,
         spec_k=SPEC_K, sample=SAMPLE, copy_temperature=SPEC_COPY_TEMP,
         sampled={k: {**info(r), **({"late": r["late"]} if "late" in r else {})}
                  for k, r in sampled.items()},
         sampled_near_ties=ties_a,
         copy_regime={"cycle_lengths": cycle_lens[:12], "prompt_len": 4 * SPEC_MOTIF_REPS,
                      "max_new": SPEC_NEW, **{k: info(r) for k, r in copy.items()}},
         copy_near_ties=ties_b, tight={**info(tight), "pool_pages": SPEC_TIGHT_PAGES},
         tight_near_ties=ties_c,
         record=os.path.relpath(session.last_record_path, ROOT), visits=visits,
         decode_region_k4_flops=decode_k4,
         sampler=_sampler_timing(cfg, spec_tick, decode_tick))
    if failures:
        raise AssertionError("serve_spec: " + "; ".join(failures))
    # the copy regime's model and fault-free spec-off streams, for 4d (e)
    copy_ctx = {"model": copy_model, "reqs": reqs_b, "prompts": prompts_b,
                "base": copy["greedy_off"]["generated"]}
    return copy["greedy_on"]["launches"], copy_ctx


# ---------------------------------------------------------------------------
# phase 4d: serving under faults at full width
# ---------------------------------------------------------------------------


def _sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _monitor(app: str):
    from repro_torch.core.records import ResourceConfig
    from repro_torch.session import PerfSession, SessionConfig

    return PerfSession(SessionConfig(app_name=app, backend="monitor", lb_sample_every=1,
                                     respect_env=False, top_computations=64),
                       ResourceConfig(num_hosts=1, devices_per_host=1))


def _timed_decode(sched) -> list:
    """Seconds of each decode dispatch call, as the watchdog times it."""
    times, inner = [], sched.decode

    def decode(*a, **k):
        t0 = time.perf_counter()
        out = inner(*a, **k)
        times.append(time.perf_counter() - t0)
        return out

    sched.decode = decode
    return times


def _free_pages_finite(sched) -> bool:
    """No page on the free list holds a non-finite value."""
    import torch

    free = sorted(set(range(sched._alloc.num_pages)) - set(sched._alloc.refs))
    idx = torch.as_tensor(free, dtype=torch.long, device=sched.device)
    return all(bool(torch.isfinite(pool.index_select(1, idx)).all())
               for slot in sched.caches.values() for pool in slot["attn"].values())


def _chaos_replay(model, cfg, failures: list) -> dict:
    """(a) FAULT_TRAFFIC fault-free and then under FAULTS, both under the
    monitor. The fault-free run's decode dispatch times set the watchdog
    (FAULT_DEADLINE_X times their maximum) and the hang (FAULT_HANG_X
    times the deadline)."""
    from repro_torch.core.factors import validate_pop
    from repro_torch.core.records import RunRecord
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.faults import FaultConfig, FaultInjector
    from repro_torch.serve.traffic import TrafficConfig, generate_workload, replay

    work = generate_workload(TrafficConfig(**FAULT_TRAFFIC))
    runs, deadline = {}, None
    for name in ("clean", "chaos"):
        session = _monitor(f"serve-{ARCH}")
        sched = _load_scheduler(model, session=session, watchdog_deadline_s=deadline)
        times = _timed_decode(sched)
        injector = None
        if name == "chaos":
            injector = FaultInjector(FaultConfig(**FAULTS, hang_s=FAULT_HANG_X * deadline))
        reset_launch_counts()
        with session:
            m = replay(sched, work, faults=injector)
        _sync()
        counts, want = launch_counts(), _serve_launches(cfg, sched.stats)
        if counts != want:
            failures.append(f"fault {name}: launches {counts} != expected {want}")
        if name == "chaos":
            session.finalize(os.path.join(TALP_DIR, ARCH, "serve_fault"))
        else:
            deadline = FAULT_DEADLINE_X * max(times)
        runs[name] = {"metrics": m, "stats": dict(sched.stats), "launches": counts,
                      "dispatch_s": {"max": max(times), "median": sorted(times)[len(times) // 2],
                                     "n": len(times)},
                      "record": session.last_record_path, "scrubbed": _free_pages_finite(sched),
                      "injected": injector and dict(injector.counters),
                      "exhausted": injector is None or injector.exhausted,
                      "status": {r: q["_status"] for r, q in sched._by_id.items()}}
        del sched

    clean, chaos = runs["clean"]["metrics"], runs["chaos"]["metrics"]
    rec, inj = chaos["recovery"], runs["chaos"]["injected"]
    landed = {k: inj[v] for k, v in (("nan", "nan_injected"), ("page_corrupt", "pages_corrupted"),
                                     ("alloc_spike", "alloc_spikes"), ("hang", "hangs"))}
    scheduled = {"nan": FAULTS["n_nan"], "page_corrupt": FAULTS["n_page_corrupt"],
                 "alloc_spike": FAULTS["n_alloc_spike"], "hang": FAULTS["n_hang"]}
    if landed != scheduled or not runs["chaos"]["exhausted"]:
        failures.append(f"chaos: landed {landed} of {scheduled}")
    if rec["retries"] < landed["nan"] + landed["page_corrupt"] + landed["hang"]:
        failures.append(f"chaos: {rec['retries']} retries for {landed}")
    if rec["watchdog_trips"] != landed["hang"]:
        failures.append(f"chaos: {rec['watchdog_trips']} watchdog trips, {landed['hang']} hangs "
                        f"(clean dispatch max {runs['clean']['dispatch_s']['max']:.3f} s, "
                        f"deadline {deadline:.3f} s)")
    for name, r in runs.items():
        m = r["metrics"]
        if (m["completed"] + m["cancelled"] != len(work) or m["failed"] or m["shed"]
                or m["kv"]["pages_in_use"]):
            failures.append(f"fault {name}: {m['completed']} completed + {m['cancelled']} "
                            f"cancelled of {len(work)}, failed {m['failed']}, shed "
                            f"{m['shed']}, {m['kv']['pages_in_use']} pages in use")
    if not runs["chaos"]["scrubbed"]:
        failures.append("chaos: a free page holds a non-finite value")
    record = RunRecord.load(runs["chaos"]["record"])
    visits = {n: r.measurements.num_visits for n, r in record.regions.items()}
    acts = (rec["retries"] + rec["quarantined"] + rec["shed"] + rec["checksum_failures"]
            + rec["watchdog_trips"])
    pop_errors = {n: e for n, r in record.regions.items() if (e := validate_pop(r.pop))}
    if visits.get("recovery") != acts or pop_errors:
        failures.append(f"chaos record: visits {visits}, {acts} recovery actions, "
                        f"POP errors {pop_errors}")
    prompts = {str(r.request_id): list(r.prompt) for r in work}
    ties = _tie_check(model, prompts, {"clean": clean["generated"], "chaos": chaos["generated"]},
                      "clean", "chaos", failures)
    return {"traffic": FAULT_TRAFFIC, "faults": {**FAULTS, "hang_s": FAULT_HANG_X * deadline},
            "watchdog_deadline_s": deadline, "landed": landed, "injected": inj,
            "recovery": rec, "record": os.path.relpath(runs["chaos"]["record"], ROOT),
            "visits": visits, "near_ties": ties,
            **{name: {"dispatch_s": r["dispatch_s"], "wall_s": r["metrics"]["wall_s"],
                      "ticks": r["metrics"]["ticks"],
                      "goodput_tokens_per_sec": r["metrics"]["goodput_tokens_per_sec"],
                      "ttft_p99_s": r["metrics"]["ttft_p99_s"], "sched_stats": r["stats"],
                      "launches": r["launches"]} for name, r in runs.items()}}


def _bitflip_run(model, cfg, failures: list) -> dict:
    """(b) The prefix run's system prompt with checksums: a request fills
    the trie, a bit flip lands on a page only the trie pins, and the same
    prompt again must find the checksum mismatch, evict the subtree and
    prefill afresh to the same tokens."""
    import numpy as np

    from repro_torch.serve.faults import FaultConfig, FaultEvent, FaultInjector

    rng = np.random.default_rng(41)
    prompt = rng.integers(4, cfg.vocab, size=250).tolist() + rng.integers(
        4, cfg.vocab, size=20).tolist()
    injector = FaultInjector(FaultConfig(corrupt_mode="bitflip"),
                             events=[FaultEvent(kind="page_corrupt", tick=1)])
    sched = _load_scheduler(model, prefix_cache=True, checksum_pages=True,
                            fault_injector=injector)
    first = sched.submit(prompt, request_id="a", max_new=32).result()
    while not injector.exhausted:
        sched.step()
    trie_before = sched._prefix.size
    second = sched.submit(prompt, request_id="b", max_new=32).result()
    sched.drain()
    kv = sched.kv_cache_stats()
    out = {"prompt_len": len(prompt), "checksum_failures": kv["recovery"]["checksum_failures"],
           "trie_pages_before": trie_before, "trie_pages_after": sched._prefix.size,
           "evicted_pages": kv["prefix_cache"]["evicted_pages"],
           "hits": kv["prefix_cache"]["hits"], "injected": dict(injector.counters),
           "equal_tokens": first == second}
    # the re-prefill starts where the match was cut, on another chunk grid
    out["near_ties"] = _tie_check(model, {0: prompt}, {"a": {0: first}, "b": {0: second}}, "a",
                                  "bitflip", failures)
    if (out["checksum_failures"] < 1 or out["evicted_pages"] < 1
            or injector.counters["pages_corrupted"] != 1
            or sched._alloc.used != sched._prefix.size):
        failures.append(f"bitflip: {out}")
    return out


def _quarantine_run(model, cfg, failures: list) -> dict:
    """(c) FAULT_QUARANTINE_N short requests, max_retries + 1 NaNs pinned to
    request 0: it ends failed, its pages freed, the others' tokens equal
    the fault-free run's (except at a near tie)."""
    import numpy as np

    from repro_torch.serve.faults import FaultEvent, FaultInjector

    rng = np.random.default_rng(71)
    prompts = {rid: rng.integers(4, cfg.vocab, size=int(n)).tolist()
               for rid, n in enumerate(rng.integers(32, 129, size=FAULT_QUARANTINE_N))}
    retries = 2
    gens = {}
    for name in ("clean", "chaos"):
        injector = None
        if name == "chaos":
            injector = FaultInjector(events=[FaultEvent(kind="nan", tick=2 + 2 * i, request_id=0)
                                             for i in range(retries + 1)])
        sched = _load_scheduler(model, max_retries=retries, fault_injector=injector)
        handles = [sched.submit(p, request_id=rid, max_new=32) for rid, p in prompts.items()]
        sched.drain()
        gens[name] = {r["id"]: r["generated"] for r in sched.completed}
        status = [h.status for h in handles]
    out = {"requests": FAULT_QUARANTINE_N, "max_retries": retries, "status": status,
           "failed": [r["id"] for r in sched.failed], "recovery": sched.kv_cache_stats()["recovery"],
           "injected": dict(injector.counters), "pages_in_use": sched._alloc.used}
    neighbours = {rid: t for rid, t in gens["clean"].items() if rid != 0}
    out["near_ties"] = _tie_check(model, prompts, {"clean": neighbours, "chaos": gens["chaos"]},
                                  "clean", "quarantine", failures)
    if (out["failed"] != [0] or status[0] != "failed" or out["recovery"]["quarantined"] != 1
            or out["injected"]["nan_injected"] != retries + 1 or out["pages_in_use"]
            or set(gens["chaos"]) != set(neighbours)):
        failures.append(f"quarantine: {out}")
    return out


def _shed_run(model, cfg, failures: list) -> dict:
    """(d) FAULT_SHED_N requests of mixed priority submitted at once against
    shed_queue_depth FAULT_SHED_DEPTH: the shed ids are those the rule
    (lowest priority, youngest first, at each submit) picks, each handle
    reads shed with no token, the rest complete."""
    import numpy as np

    rng = np.random.default_rng(81)
    prio = rng.integers(0, 3, size=FAULT_SHED_N).tolist()
    sched = _load_scheduler(model, shed_queue_depth=FAULT_SHED_DEPTH)
    handles = [sched.submit(rng.integers(4, cfg.vocab, size=24).tolist(), request_id=i,
                            max_new=8, priority=p) for i, p in enumerate(prio)]
    queue, want = [], []
    for i, p in enumerate(prio):  # the rule, apart from the scheduler
        queue.append((p, i))
        if len(queue) > FAULT_SHED_DEPTH:
            victim = min(queue, key=lambda r: (r[0], -r[1]))
            queue.remove(victim)
            want.append(victim[1])
    sched.drain()
    shed = [r["id"] for r in sched.shed]
    out = {"requests": FAULT_SHED_N, "batch": LOAD_BATCH, "depth": FAULT_SHED_DEPTH,
           "priorities": prio, "shed": shed, "expected": want,
           "recovery": sched.kv_cache_stats()["recovery"]}
    ok = all((h.status, h.tokens == []) == ("shed", True) if h.request_id in want
             else (h.status, len(h.tokens)) == ("done", 8) for h in handles)
    if shed != want or out["recovery"]["shed"] != len(want) or not ok or sched._alloc.used:
        failures.append(f"shed: {out}")
    return out


def _spec_fault_run(copy_ctx, cfg, failures: list) -> dict:
    """(e) 4c's copy regime with speculation, NaNs in verify dispatches:
    retries happen, and every stream equals 4c's spec-off fault-free run
    (except at a near tie)."""
    from repro_torch.serve.faults import FaultEvent, FaultInjector

    injector = FaultInjector(events=[FaultEvent(kind="nan", tick=t) for t in FAULT_SPEC_TICKS])
    sched = _load_scheduler(copy_ctx["model"], spec_decode=True, spec_k=SPEC_K,
                            fault_injector=injector)
    t0 = time.perf_counter()
    for rid, prompt, max_new in copy_ctx["reqs"]:
        sched.submit(prompt, request_id=rid, max_new=max_new)
    sched.drain()
    _sync()
    toks = {r["id"]: r["generated"] for r in sched.completed}
    kv = sched.kv_cache_stats()
    out = {"wall_s": time.perf_counter() - t0, "recovery": kv["recovery"],
           "speculation": kv["speculation"], "pages_in_use": kv["pages_in_use"]}
    out["near_ties"] = _tie_check(copy_ctx["model"], copy_ctx["prompts"],
                                  {"off": copy_ctx["base"], "chaos": toks}, "off", "spec fault",
                                  failures)
    if (kv["recovery"]["retries"] < len(FAULT_SPEC_TICKS)
            or kv["recovery"]["injected"]["nan_injected"] != len(FAULT_SPEC_TICKS)
            or kv["pages_in_use"] or kv["speculation"]["accepted"] <= 0):
        failures.append(f"spec fault: {out}")
    return out


def phase_serve_fault(model, copy_ctx):
    """Serving under faults, bf16, phase 4b's server shape: (a) a chaos
    replay under the monitor; (b) a bit flip caught by the page checksums;
    (c) quarantine; (d) shedding; (e) speculation under NaN verifies."""
    import torch

    cfg = model.cfg
    failures: list = []
    out = {"chaos": _chaos_replay(model, cfg, failures)}
    torch.cuda.empty_cache()
    out["bitflip"] = _bitflip_run(model, cfg, failures)
    out["quarantine"] = _quarantine_run(model, cfg, failures)
    out["shed"] = _shed_run(model, cfg, failures)
    out["spec"] = _spec_fault_run(copy_ctx, cfg, failures)
    emit("serve_fault", arch=ARCH, dtype="bfloat16", batch=LOAD_BATCH, max_len=LOAD_MAX_LEN,
         **out)
    if failures:
        raise AssertionError("serve_fault: " + "; ".join(failures))
    return out["chaos"]["chaos"]["launches"]


# ---------------------------------------------------------------------------
# phase 4e: the dense KV layout at full width
# ---------------------------------------------------------------------------


def _serve_layout(model, prompts, max_new, session=None, paged=False) -> dict:
    """Phase 4's server (``paged``) or its dense twin over ``prompts``,
    launch counters zeroed before and read after; the positions of the
    first decode dispatch (the one the monitor counts)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.serve import BatchScheduler, ServeConfig

    sched = BatchScheduler(model, ServeConfig(max_len=512, batch=4, prefill_chunk=64,
                                              overlap=True, paged=paged), session=session)
    first, inner = {}, sched._decode

    def recording(decoding, c0):
        first.setdefault("pos", sched.pos.copy())
        return inner(decoding, c0)

    sched._decode = recording
    reset_launch_counts()
    _sync()
    t0 = time.perf_counter()
    with sched.session:
        for rid, p in enumerate(prompts):
            sched.submit(p, request_id=rid, max_new=max_new)
        sched.drain()
    _sync()
    wall = time.perf_counter() - t0
    st = sched.stats
    n_tok = sum(len(r["generated"]) for r in sched.completed)
    return {"wall_s": wall, "tokens_per_s": n_tok / wall, "ticks": st["ticks"],
            "decode_steps": st["decode_steps"], "prefill_chunks": st["prefill_chunks"],
            "launches": launch_counts(), "first_decode_pos": first["pos"].tolist(),
            "tokens": {r["id"]: r["generated"] for r in sched.completed},
            "layout": sched.kv_cache_stats()["layout"],
            "kv_bytes": sched.kv_cache_stats()["kv_bytes"]}


def phase_serve_dense(model, params_f32, paged_tokens: dict, paged_tokens_per_s: float,
                      dense_parity: dict):
    """Phase 4's trace on the dense layout, bf16: under the monitor
    (exact launches, the record's counted K2 FLOPs), then unmonitored in
    turns with the paged layout (paged, dense, dense, paged: tokens/s).
    Tokens against the paged layout in fp32 (phase 3's weights, both
    layouts on the card), where two attention kernels' roundings cannot
    pass for a difference; in bf16, where they can, the first divergences
    and the two layouts' prefill logits for information. Phase 3's fp32
    dense logits against float64."""
    import torch

    from repro_torch.core.records import RunRecord
    from repro_torch.layers.common import tree_map
    from repro_torch.models.transformer import Transformer

    cfg = model.cfg
    failures: list = []
    prompts, max_new = _serve_trace(cfg)
    session = _monitor(f"serve-{ARCH}")
    runs = {"monitor": _serve_layout(model, prompts, max_new, session=session)}
    session.finalize(os.path.join(TALP_DIR, ARCH, "serve_dense"))
    turns: dict = {"paged": [], "dense": []}
    for name in ("paged", "dense", "dense", "paged"):
        r = _serve_layout(model, prompts, max_new, paged=name == "paged")
        turns[name].append(r["tokens_per_s"])
        runs[f"null_{name}"] = r
    L = cfg.n_layers
    for name, r in runs.items():
        if name == "null_paged":
            continue
        forwards = r["decode_steps"] + r["prefill_chunks"]
        want = dict.fromkeys(r["launches"], 0)
        want.update({"flash_attention": L * forwards, "rmsnorm": (2 * L + 1) * forwards})
        if r["launches"] != want or r["layout"] != "dense":
            failures.append(f"dense {name}: layout {r['layout']}, launches {r['launches']} "
                            f"!= expected {want}")
    # the decode region's profile is the first decode step's count, scaled
    # by the region's steps: K2 at each row's position p against kv_len
    # p + 1, p + 1 pairs a row
    record = RunRecord.load(session.last_record_path)
    dec = record.regions.get("decode")
    comps = dec.computations if dec else {}
    got = comps["flash_attention"].flops if "flash_attention" in comps else 0.0
    n = max(dec.measurements.num_steps, dec.measurements.num_visits, 1) if dec else 0
    per_step = L * 4.0 * cfg.n_heads * cfg.head_dim_ * sum(
        p + 1 for p in runs["monitor"]["first_decode_pos"])
    index_step = L * 4.0 * cfg.n_heads * cfg.head_dim_ * len(runs["monitor"]["first_decode_pos"])
    if got != n * per_step or "paged_attention" in comps:
        failures.append(f"dense record: decode K2 FLOPs {got} != {n} x {per_step} from "
                        f"positions {runs['monitor']['first_decode_pos']}; kernels "
                        f"{sorted(comps)}")
    if runs["null_dense"]["tokens"] != runs["monitor"]["tokens"]:
        failures.append("dense: the monitored run's tokens differ from the unmonitored run's")
    # tokens, dense against paged, in fp32
    cfg32 = cfg.replace(param_dtype_name="float32", compute_dtype_name="float32")
    model32 = Transformer(cfg32, tree_map(lambda t: t.to(torch.float32), params_f32), DEV)
    fp32 = {"paged": _serve_layout(model32, prompts, max_new, paged=True),
            "dense": _serve_layout(model32, prompts, max_new)}
    prompts_d = dict(enumerate(prompts))
    ties = _tie_check(model32, prompts_d, {k: v["tokens"] for k, v in fp32.items()}, "paged",
                      "dense fp32", failures)
    del model32
    torch.cuda.empty_cache()
    paged_bf16 = runs["null_paged"]["tokens"]
    bf16_div = [{"request": rid, "position": i, "top2_gap": _top2_gap(model, prompts_d[rid],
                                                                     toks, i)}
                for rid, toks in paged_bf16.items()
                if (i := _first_divergence(toks, runs["monitor"]["tokens"][rid])) is not None]
    lp, ld = (_history_logits(model, prompts[0], dense=d).float() for d in (False, True))
    bf16_logits = {"max_abs_diff": float((lp - ld).abs().max()),
                   "logit_absmax": float(lp.abs().max()),
                   "paged_equals_phase4": paged_bf16 == paged_tokens}
    dp = dense_parity
    rms_ratio = dp["vs_float64"]["rms_rel"] / dp["cpu_rms_rel_vs_float64"]
    if not (dp["finite"] and dp["max_abs_err_vs_cpu"] <= LOGIT_TOL and rms_ratio <= EXACT_RATIO):
        failures.append(f"dense fp32 logits: {dp['max_abs_err_vs_cpu']} vs the CPU (tol "
                        f"{LOGIT_TOL}), RMS vs float64 {rms_ratio}x the CPU's")
    emit("serve_dense", arch=ARCH, dtype="bfloat16",
         runs={k: {kk: vv for kk, vv in v.items() if kk != "tokens"} for k, v in runs.items()},
         phase4_paged_tokens_per_s=paged_tokens_per_s, tokens_per_s_in_turns=turns,
         fp32={k: {kk: vv for kk, vv in v.items() if kk != "tokens"} for k, v in fp32.items()},
         fp32_near_ties=ties, bf16_first_divergence_from_paged=bf16_div,
         bf16_prefill_logits=bf16_logits,
         decode_k2_flops={"record": got, "steps": n, "per_step_from_positions": per_step,
                          "per_step_at_index_positions": index_step},
         parity_fp32={**dp, "rms_over_cpu_vs_float64": rms_ratio})
    if failures:
        raise AssertionError("serve_dense: " + "; ".join(failures))
    return runs["monitor"]["launches"]


# ---------------------------------------------------------------------------
# phase 5: the training step at full width, card vs CPU
# ---------------------------------------------------------------------------


def _loss_and_grads(model, batch):
    """Loss and every leaf's gradient of one microbatch, as the train step
    computes them; gradients go to the CPU in float64."""
    import torch

    leaves = model.named_params()
    loss, _ = model(batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), {k: g.detach().double().cpu() for k, g in zip(leaves, grads)}


def _grad_errors(run, exact) -> dict:
    """A run's distance from the float64 run: the loss's relative error,
    the relative RMS error of all gradients together and of each leaf
    (||g - g64|| / ||g64||), and each leaf's max |g - g64| over max |g64|."""
    (loss, g), (loss64, g64) = run, exact
    sq = {k: float((g[k] - g64[k]).pow(2).sum()) for k in g64}
    ref = {k: float(g64[k].pow(2).sum()) for k in g64}
    return {"loss_rel": abs(loss - loss64) / abs(loss64),
            "rms_rel": (sum(sq.values()) / sum(ref.values())) ** 0.5,
            "leaf_rms_rel": {k: (sq[k] / ref[k]) ** 0.5 for k in g64},
            "leaf_max_rel": {k: float((g[k] - g64[k]).abs().max() / g64[k].abs().max())
                             for k in g64}}


def phase_train_parity(params_f32):
    import torch

    import repro_torch.layers.attention as LA
    import repro_torch.layers.norms as LN
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention.ref import flash_attention_reference
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference
    from repro_torch.layers.common import tree_map
    from repro_torch.models.transformer import Transformer

    cfg = _config().replace(param_dtype_name="float32", compute_dtype_name="float32",
                            remat="full", repeats=TRAIN_PARITY_REPEATS)
    params_f32 = dict(params_f32, slots=tree_map(lambda t: t[:TRAIN_PARITY_REPEATS],
                                                 params_f32["slots"]))
    batch = {k: v[0] for k, v in SyntheticLM(DataConfig(
        global_batch=1, seq_len=TRAIN_PARITY_S, vocab=cfg.vocab, pad_fraction=0.05,
        seed=7)).batch_at(0).items()}
    runs = {"cpu": _loss_and_grads(Transformer(cfg, params_f32, "cpu"), batch)}
    # the same weights (fp32 values, exact in float64) in float64: the
    # witness that says how far each fp32 run is from the exact gradients
    cfg64 = cfg.replace(param_dtype_name="float64", compute_dtype_name="float64",
                        remat="none")
    exact = _loss_and_grads(
        Transformer(cfg64, tree_map(lambda t: t.detach().double(), params_f32), "cpu"),
        batch)
    card = Transformer(cfg, params_f32, DEV)
    runs["card"] = _loss_and_grads(card, batch)
    # the same card run with the plain versions in place of the kernels
    saved = LA.flash_attention, LN._rmsnorm_op
    LA.flash_attention, LN._rmsnorm_op = flash_attention_reference, rmsnorm_reference
    try:
        runs["card_plain"] = _loss_and_grads(card, batch)
    finally:
        LA.flash_attention, LN._rmsnorm_op = saved
    del card
    torch.cuda.empty_cache()

    errs = {k: _grad_errors(v, exact) for k, v in runs.items()}
    ratio = errs["card"]["rms_rel"] / errs["cpu"]["rms_rel"]
    leaf_ratio = max(errs["card"]["leaf_rms_rel"][k] / errs["cpu"]["leaf_rms_rel"][k]
                     for k in exact[1])
    finite = all(torch.isfinite(g).all() for g in runs["card"][1].values())
    grad_norm = {k: float(sum(g.pow(2).sum() for g in v[1].values()) ** 0.5)
                 for k, v in {**runs, "float64": exact}.items()}
    emit("train_parity", arch=ARCH, dtype="float32", batch=1, seq_len=TRAIN_PARITY_S,
         remat="full",
         tolerance={"card_over_cpu_rms_vs_float64": EXACT_RATIO, "loss_rel": TRAIN_TOL},
         loss={**{k: v[0] for k, v in runs.items()}, "float64": exact[0]},
         grad_norm=grad_norm, vs_float64=errs,
         card_over_cpu_rms_vs_float64=ratio, card_over_cpu_leaf_rms_max=leaf_ratio)
    if not finite:
        raise AssertionError("train parity: non-finite card gradients")
    if errs["card"]["loss_rel"] > TRAIN_TOL:
        raise AssertionError(f"train parity: card loss {runs['card'][0]} vs float64 "
                             f"{exact[0]}: {errs['card']['loss_rel']} > {TRAIN_TOL}")
    if max(ratio, leaf_ratio) > EXACT_RATIO:
        raise AssertionError(f"train parity: card's gradient RMS error against float64 "
                             f"{errs['card']['rms_rel']} (worst leaf ratio {leaf_ratio}) is "
                             f"more than {EXACT_RATIO}x the CPU fp32 run's "
                             f"({errs['cpu']['rms_rel']})")


# ---------------------------------------------------------------------------
# phase 6: train at full width through TrainLoop
# ---------------------------------------------------------------------------


def _norms_per_layer(cfg) -> int:
    """K1 launches an attention layer a forward: the block's two norms, and
    with qk-norm the query and key norms."""
    return 4 if cfg.qk_norm else 2


_ATTN_KINDS = ("attn", "local_attn", "moe")
# K1 launches a recurrent layer a forward: the pre-norm and the block's own
# norm (mamba2's gated norm over d_inner, mLSTM's over its inner width),
# and sLSTM's third, its MLP's pre-norm
_RECURRENT_NORMS = {"mamba2": 2, "mlstm": 2, "slstm": 3}


def _attn_layers(cfg) -> int:
    """The layers that launch attention (K2 in training, K3/K4 serving)."""
    return sum(k in _ATTN_KINDS for k in cfg.pattern) * cfg.repeats


def _layer_norms(cfg) -> int:
    """K1 launches a forward in the layers, the final norm apart: nL for
    an attention-only stack (``_norms_per_layer``)."""
    return cfg.repeats * sum(_RECURRENT_NORMS.get(k) or _norms_per_layer(cfg)
                             for k in cfg.pattern)


def _train_expected_launches(cfg, steps: int, accum: int) -> dict:
    """Per microbatch, A attention layers and N layer norms (``_attn_layers``,
    ``_layer_norms``; A = L and N = nL for an attention-only stack): the
    forward runs N RMSNorms and A attentions plus the final norm; under
    remat ``full`` or ``dots`` the backward recomputes every layer once (N
    RMSNorms and A attentions more: the final norm sits outside the
    checkpointed layers, and ``dots`` keeps only the aten products, not
    the kernels' outputs), then launches one flash backward per attention
    layer and one RMSNorm backward per norm (A, N+1)."""
    A, N = _attn_layers(cfg), _layer_norms(cfg)
    assert cfg.remat in ("none", "full", "dots")
    rerun = 0 if cfg.remat == "none" else 1
    per = {"flash_attention": (1 + rerun) * A, "flash_attention_backward": A,
           "rmsnorm": (1 + rerun) * N + 1, "rmsnorm_backward": N + 1}
    return {k: v * steps * accum for k, v in per.items()}


def _train_loop(backend: str, steps: int):
    """The full-width training configuration of phases 6 and 7 (bf16 params
    and compute, remat full, B=4, S=2048, accum 1) in a ``TrainLoop`` whose
    session runs ``backend``; returns (cfg, data, loop)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train.loop import LoopConfig, TrainLoop
    from repro_torch.train.train import TrainConfig

    cfg = _config()
    data = SyntheticLM(DataConfig(global_batch=TRAIN_B, seq_len=TRAIN_S, vocab=cfg.vocab,
                                  accum_steps=TRAIN_A, pad_fraction=0.05))
    loop = TrainLoop(cfg, TrainConfig(total_steps=steps), data,
                     LoopConfig(steps=steps, lb_sample_every=1, monitor_app_name=ARCH,
                                monitor_backend=backend), device=DEV)
    if loop.session.backend != backend:
        raise AssertionError(f"train: session backend {loop.session.backend!r}; unset "
                             f"TALP_ENABLE or set TALP_BACKEND={backend}")
    return cfg, data, loop


def phase_train(profile: bool):
    import numpy as np
    import torch

    from repro_torch.core.factors import validate_pop
    from repro_torch.core.records import RunRecord
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.flops import train_step_model_flops

    B, S, A = TRAIN_B, TRAIN_S, TRAIN_A
    # earlier phases' garbage is collected first: a reference cycle freed by
    # the collector inside the loop would leave the peak below held_before
    # plus the step's own peak
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()  # earlier phases' tensors, in the peak
    cfg, data, loop = _train_loop("monitor", TRAIN_STEPS)
    reset_launch_counts()
    loop.run()
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in counts}
    want.update(_train_expected_launches(cfg, TRAIN_STEPS, A))
    TRAIN_PROFILE["train_step"] = loop.session.collector._regions["train_step"].static
    record = loop.finalize_run(os.path.join(TALP_DIR, ARCH, "train_monitor"))
    path = loop.session.last_record_path
    loaded = RunRecord.load(path)
    pop_errors = {n: validate_pop(r.pop) for n, r in loaded.regions.items()}
    hist = loop.metrics_history
    losses = [h["loss"] for h in hist]
    secs = [h["seconds"] for h in hist]
    median = float(np.median(secs[1:]))
    model_flops = train_step_model_flops(cfg, (A, B, S))
    ts = record.regions["train_step"]
    emit("train", arch=ARCH, dtype="bfloat16", batch=B, seq_len=S, accum=A, remat=cfg.remat,
         steps=TRAIN_STEPS, losses=losses, grad_norms=[h["grad_norm"] for h in hist],
         step_seconds=secs,
         step0_seconds=secs[0], median_step_seconds=median,
         tokens_per_s=A * B * S / median,
         real_tokens_per_step=float(sum(int((data.batch_at(i)["labels"] >= 0).sum())
                                        for i in range(TRAIN_STEPS)) / TRAIN_STEPS),
         model_flops_per_step=model_flops, mfu=model_flops / median / PEAK_FLOPS["bfloat16"],
         counted_flops_per_step=ts.counters.useful_flops / max(ts.measurements.num_steps, 1),
         peak_mem_bytes=peak, held_before_bytes=held_before, launches=counts,
         expected_launches=want,
         record=os.path.relpath(path, ROOT), regions=sorted(loaded.regions),
         num_steps=ts.measurements.num_steps,
         dispatch_efficiency=ts.pop.get("dispatch_efficiency"),
         pop_train_step={k: ts.pop[k] for k in sorted(ts.pop)}, pop_errors=pop_errors,
         top_computations=[[c.name, c.kind, c.flops, c.hbm_bytes]
                           for c in ts.top_computations(8, by="flops")])
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train: non-finite loss in {losses}")
    if counts != want or min(counts[k] for k in TRAIN_KERNELS) <= 0:
        raise AssertionError(f"train: launches {counts} != expected {want}")
    if any(pop_errors.values()) or ts.measurements.num_steps != TRAIN_STEPS:
        raise AssertionError(f"train: record {path}: POP identities {pop_errors}, "
                             f"{ts.measurements.num_steps} steps")
    if profile:
        phase_profile_train(cfg, loop.final_state, data)
    del loop, record
    torch.cuda.empty_cache()
    return counts


def _mesh_data(cfg):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    return SyntheticLM(DataConfig(global_batch=TRAIN_B, seq_len=TRAIN_S, vocab=cfg.vocab,
                                  accum_steps=TRAIN_A, pad_fraction=0.05))


def _mesh_loop(cfg, steps: int, mesh, backend: str = "monitor"):
    """Phase 6's training configuration (``cfg`` at its depth) for ``steps``
    steps of a ``TrainConfig(total_steps=TRAIN_STEPS)`` run, on ``mesh``."""
    from repro_torch.train.loop import LoopConfig, TrainLoop
    from repro_torch.train.train import TrainConfig

    return TrainLoop(cfg, TrainConfig(total_steps=TRAIN_STEPS), _mesh_data(cfg),
                     LoopConfig(steps=steps, lb_sample_every=1, monitor_app_name=ARCH,
                                monitor_backend=backend), device=DEV, mesh=mesh)


def _share_bytes(cfg, mesh) -> int:
    """A rank's share of the training state under the rules: each leaf's
    bytes over the product of the mesh axes its pspec names (parameters in
    the param dtype, m, v and master in fp32)."""
    import math

    from repro_torch.layers.common import tree_leaves
    from repro_torch.models.transformer import model_params
    from repro_torch.train.train import TrainConfig, train_state_pspecs

    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    shapes = dict(tree_leaves(model_params(cfg)))
    total = 0
    for path, spec in tree_leaves(train_state_pspecs(cfg, mesh, TrainConfig())):
        if path in ("step", "opt_state/step"):
            continue
        leaf = path.split("/", 2)[-1] if path.startswith("opt_state/") else path[len("params/"):]
        split = math.prod(sizes[a] for e in spec if e is not None
                          for a in ((e,) if isinstance(e, str) else e))
        itemsize = cfg.param_dtype.itemsize if path.startswith("params/") else 4
        total += math.prod(shapes[leaf].shape) * itemsize // split
    return total


def _held_bytes(state) -> int:
    from repro_torch.layers.common import tree_leaves

    return sum(t.numel() * t.element_size() for _, t in tree_leaves(state.tree())
               if hasattr(t, "numel"))


def _matmul_flops(prof) -> float:
    """A ``StepProfile``'s matrix-product FLOPs a device: ``aten.mm``,
    ``aten.addmm``, ``aten.bmm`` and K2's cost sink."""
    names = ("aten.mm", "aten.addmm", "aten.bmm", "flash_attention", "flash_attention_backward")
    per = prof.per_computation
    return sum(per[n].flops for n in names if n in per) / prof.num_devices


class _Seen:
    """While open: the ``StepProfile``s counted, and the shapes K2's forward
    (q, k) and K1's forward (rows, d) launch at."""

    def __enter__(self):
        from repro_torch.core.profile import StepProfile
        from repro_torch.kernels.flash_attention import ops as FA
        from repro_torch.kernels.rmsnorm import ops as RMS

        self.profiles, self.flash, self.rms = [], set(), set()
        self._saved = (StepProfile.__dict__["count"], FA.flash_forward, RMS.launch_forward)
        count, flash, norm = StepProfile.count, FA.flash_forward, RMS.launch_forward

        def counted(*a, **kw):
            out, prof = count(*a, **kw)
            self.profiles.append(prof)
            return out, prof

        def flash_seen(q, k, *a, **kw):
            self.flash.add((tuple(q.shape), tuple(k.shape)))
            return flash(q, k, *a, **kw)

        def norm_seen(x, *a, **kw):
            self.rms.add((x.numel() // x.shape[-1], x.shape[-1]))
            return norm(x, *a, **kw)

        StepProfile.count, FA.flash_forward, RMS.launch_forward = counted, flash_seen, norm_seen
        return self

    def __exit__(self, *exc):
        from repro_torch.core.profile import StepProfile
        from repro_torch.kernels.flash_attention import ops as FA
        from repro_torch.kernels.rmsnorm import ops as RMS

        StepProfile.count, FA.flash_forward, RMS.launch_forward = self._saved
        return False


def _mesh_moe_run(mesh) -> dict:
    """MESH_MOE on ``mesh`` (None: one rank, no process group): bf16
    weights drawn on the card from the seed (a rank keeps its blocks),
    computed in fp32, its steps through ``make_train_step``, the first
    counted by ``StepProfile.count``."""
    import torch

    from repro_torch.core.profile import StepProfile
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.train.train import TrainConfig, make_train_step

    m = MESH_MOE
    tcfg = TrainConfig(total_steps=m["steps"])
    torch.cuda.reset_peak_memory_stats()
    cfg, state = _mesh_arch_state(m, tcfg, mesh, fan_in=False)
    data = _mesh_data_of(m, cfg)
    model = state.model
    step = make_train_step(cfg, tcfg, mesh)
    reset_launch_counts()
    losses, norms, loads, secs = [], [], [], []
    for i in range(m["steps"]):
        t0 = time.perf_counter()
        if i == 0:
            (state, met), prof = StepProfile.count(step, state, data.batch_at(i))
        else:
            state, met = step(state, data.batch_at(i))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        loads.append(met["expert_load"].tolist())
        secs.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    experts = [tuple(t.shape) for p, t in model.named_params().items() if p.endswith("moe/wi_gate")]
    out = dict(layers=cfg.n_layers, compute="float32", params="bfloat16", losses=losses,
               grad_norms=norms, expert_load=loads, step_seconds=secs, launches=launch_counts(),
               expected_launches=_train_expected_launches(cfg, m["steps"], 1),
               matmul_flops=_matmul_flops(prof), expert_flops=prof.per_computation["aten.bmm"].flops,
               expert_blocks=experts, peak_mem_bytes=torch.cuda.max_memory_allocated())
    del step, state, model, met
    _release()
    return out


def _mesh_arch_state(m: dict, tcfg, mesh, fan_in: bool):
    """``m``'s config (bf16 weights computed in fp32) and a train state of
    weights drawn on the card from ``m["seed"]`` (a rank keeps its blocks;
    ``fan_in``: ``_fan_in_`` after the draw)."""
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim import adamw_init
    from repro_torch.train.train import TrainState

    cfg = _arch_cfg(m["arch"], m["repeats"]).replace(compute_dtype_name="float32")
    model = Transformer.from_init(cfg, seed=m["seed"], device=DEV, draw_device="cuda", mesh=mesh)
    if fan_in:
        _fan_in_(model)
    return cfg, TrainState(model, adamw_init(model.named_params(), tcfg.optimizer), 0)


def _mesh_data_of(m: dict, cfg):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    return SyntheticLM(DataConfig(global_batch=m["batch"], seq_len=m["seq"], vocab=cfg.vocab,
                                  pad_fraction=0.05))


class _Projections:
    """While open: the FLOPs that ``StepProfile.count`` counts in each call
    of a mamba2 block's ``in_projection`` and ``out_projection`` (forward
    calls: a remat rerun counts again)."""

    def __enter__(self):
        from repro_torch.core.profile import StepProfile
        from repro_torch.layers import recurrent as R

        self.flops = {"in_proj": 0.0, "out_proj": 0.0}
        self._saved = (R.in_projection, R.out_projection)

        def counting(fn, key):
            def run(*a, **kw):
                out, prof = StepProfile.count(fn, *a, **kw)
                self.flops[key] += prof.flops
                return out
            return run

        R.in_projection = counting(self._saved[0], "in_proj")
        R.out_projection = counting(self._saved[1], "out_proj")
        return self

    def __exit__(self, *exc):
        from repro_torch.layers import recurrent as R

        R.in_projection, R.out_projection = self._saved
        return False


def _split_ssm_launches(cfg, steps: int) -> dict:
    """``_train_expected_launches`` of a tensor-parallel rank whose mamba2
    blocks split: their gated norm is torch ops there (its mean sums over
    the ranks, which K1 cannot take), one K1 forward (and its rerun) and
    one backward fewer a mamba2 layer."""
    want = _train_expected_launches(cfg, steps, 1)
    n = cfg.repeats * cfg.pattern.count("mamba2")
    want["rmsnorm"] -= (1 if cfg.remat == "none" else 2) * n * steps
    want["rmsnorm_backward"] -= n * steps
    return want


def _mesh_ssm_run(mesh) -> dict:
    """(c): MESH_SSM on ``mesh`` (None: one rank), its steps through
    ``make_train_step``, the first with the mamba2 projections counted."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.train.train import TrainConfig, make_train_step

    m = MESH_SSM
    tcfg = TrainConfig(total_steps=m["steps"])
    torch.cuda.reset_peak_memory_stats()
    cfg, state = _mesh_arch_state(m, tcfg, mesh, fan_in=True)
    data = _mesh_data_of(m, cfg)
    step = make_train_step(cfg, tcfg, mesh)
    reset_launch_counts()
    losses, norms, secs = [], [], []
    with _Seen() as seen:
        for i in range(m["steps"]):
            t0 = time.perf_counter()
            with (_Projections() if i == 0 else contextlib.nullcontext()) as counted:
                state, met = step(state, data.batch_at(i))
                losses.append(float(met["loss"]))
            if i == 0:
                proj = counted.flops
            norms.append(float(met["grad_norm"]))
            secs.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    split = mesh is not None and mesh.sizes["model"] > 1
    out = dict(layers=cfg.n_layers, compute="float32", params="bfloat16", fan_in=True,
               losses=losses, grad_norms=norms, step_seconds=secs, launches=launch_counts(),
               expected_launches=(_split_ssm_launches(cfg, m["steps"]) if split
                                  else _train_expected_launches(cfg, m["steps"], 1)),
               in_proj_flops=proj["in_proj"], out_proj_flops=proj["out_proj"],
               flash_shapes=sorted(seen.flash), peak_mem_bytes=torch.cuda.max_memory_allocated())
    del step, state, met
    _release()
    return out


class _K2Timer:
    """While open: each K2 forward and backward launch timed by CUDA events
    on its stream; ``take()`` returns the milliseconds since the last take."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops as FA

        self.events, self.steps = [], []
        self._saved = (FA.flash_forward, FA.flash_backward)

        def timed(fn):
            def run(*a, **kw):
                import torch

                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*a, **kw)
                e1.record()
                self.events.append((e0, e1))
                return out
            return run

        FA.flash_forward, FA.flash_backward = timed(self._saved[0]), timed(self._saved[1])
        return self

    def take(self) -> float:
        import torch

        torch.cuda.synchronize()
        ms = sum(e0.elapsed_time(e1) for e0, e1 in self.events)
        self.events = []
        self.steps.append(ms)
        return ms

    def __exit__(self, *exc):
        from repro_torch.kernels.flash_attention import ops as FA

        FA.flash_forward, FA.flash_backward = self._saved
        return False


def _cp_k2_flops(cfg, m: dict, index: int, size: int) -> tuple:
    """(forward, backward) K2 FLOPs of one step of the rank at ``index`` of
    ``size`` along "model" (its query block against every key) as
    ``launch_costs`` counts them from its positions: each attention layer's
    forward (and its remat rerun) and backward."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import ops as FA

    B, S = m["batch"], m["seq"]
    blk = S // size
    q = torch.empty((B, blk, cfg.n_heads, cfg.head_dim_), device="meta")
    k = torch.empty((B, S, cfg.n_kv_heads, cfg.head_dim_), device="meta")
    qpos = np.broadcast_to(np.arange(index * blk, (index + 1) * blk), (B, blk))
    kpos = np.broadcast_to(np.arange(S), (B, S))
    fwd = bwd = 0.0
    for kind in cfg.pattern * cfg.repeats:
        if kind not in _ATTN_KINDS:
            continue
        win = cfg.window if kind == "local_attn" else None
        fwd += (1 if cfg.remat == "none" else 2) * FA.launch_costs(
            q, k, True, win, False, qpos, kpos)[0]
        bwd += FA.launch_costs(q, k, True, win, True, qpos, kpos)[0]
    return fwd, bwd


def _mesh_cp_run(mesh) -> dict:
    """(d): MESH_CP on ``mesh`` (None: one rank) in a monitored
    ``TrainLoop`` whose hosts' work is each rank's K2 milliseconds of the
    step (``_K2Timer``), so the record's host load balance reads the
    imbalance of a contiguous sequence split; the record (on the mesh) in
    MESH_CP_TALP_DIR."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.train.loop import LoopConfig, TrainLoop
    from repro_torch.train.train import TrainConfig

    m = MESH_CP
    tcfg = TrainConfig(total_steps=m["steps"])
    torch.cuda.reset_peak_memory_stats()
    cfg, state = _mesh_arch_state(m, tcfg, mesh, fan_in=False)
    timer = _K2Timer()

    def k2_ms(step):
        ms = timer.take()
        if mesh is None:
            return [ms]
        import torch.distributed as dist

        every = [None] * mesh.devices.size
        dist.all_gather_object(every, ms)
        return every

    loop = TrainLoop(cfg, tcfg, _mesh_data_of(m, cfg),
                     LoopConfig(steps=m["steps"], lb_sample_every=1, monitor_app_name=m["arch"],
                                host_times_fn=k2_ms), state=state, mesh=mesh)
    reset_launch_counts()
    with timer, _Seen() as seen:
        loop.run()
    torch.cuda.synchronize()
    index, size = (0, 1) if mesh is None else (mesh.coords()["model"], mesh.sizes["model"])
    record = None
    if mesh is not None:
        label = f"{mesh.sizes['data']}x{mesh.sizes['model']}"
        loop.finalize_run(os.path.join(MESH_CP_TALP_DIR, m["arch"], f"train_cp_{label}"))
        record = loop.session.last_record_path
    prof = seen.profiles[0]  # the record's count: machine totals over num_devices ranks
    k2 = [prof.per_computation[n].flops / prof.num_devices
          for n in ("flash_attention", "flash_attention_backward")]
    hist = loop.metrics_history
    out = dict(layers=cfg.n_layers, compute="float32", params="bfloat16", rank_index=index,
               losses=[h["loss"] for h in hist], grad_norms=[h["grad_norm"] for h in hist],
               step_seconds=[h["seconds"] for h in hist], k2_ms=timer.steps,
               launches=launch_counts(), expected_launches=_train_expected_launches(
                   cfg, m["steps"], 1),
               flash_shapes=sorted(seen.flash),
               k2_flops=k2,
               expected_k2_flops=list(_cp_k2_flops(cfg, m, index, size)), record=record,
               peak_mem_bytes=torch.cuda.max_memory_allocated())
    del loop, state
    _release()
    return out


def _mesh_rank_main(argv) -> int:
    """One of phase 6b (b) to (d)'s ranks: ``--mesh-rank RANK WORLD STORE OUT``."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh

    rank, world, store, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=MESH_RANK_TIMEOUT))
    cfg = _config().replace(repeats=MESH_REPEATS)
    res = {}
    for shape in MESH_SHAPES:
        mesh = make_host_mesh(model=shape[1], device=DEV)
        torch.cuda.reset_peak_memory_stats()
        loop = _mesh_loop(cfg, MESH_PAIR_STEPS, mesh)
        reset_launch_counts()
        with _Seen() as seen:
            loop.run()
        torch.cuda.synchronize()
        label = f"{shape[0]}x{shape[1]}"
        loop.finalize_run(os.path.join(MESH_TALP_DIR, ARCH, f"train_mesh_{label}"))
        res[label] = dict(
            rank=rank, mesh=mesh.sizes, device=str(mesh.device),
            losses=[h["loss"] for h in loop.metrics_history],
            grad_norms=[h["grad_norm"] for h in loop.metrics_history],
            step_seconds=[h["seconds"] for h in loop.metrics_history],
            peak_mem_bytes=torch.cuda.max_memory_allocated(), launches=launch_counts(),
            held_bytes=_held_bytes(loop.final_state), share_bytes=_share_bytes(cfg, mesh),
            matmul_flops=_matmul_flops(seen.profiles[0]), flash_shapes=sorted(seen.flash),
            rms_shapes=sorted(seen.rms), record=loop.session.last_record_path)
        del loop
        torch.cuda.empty_cache()
    res["moe"] = _mesh_moe_run(make_host_mesh(model=2, device=DEV))
    res["moe"]["rank"] = rank
    res["ssm"] = _mesh_ssm_run(make_host_mesh(model=2, device=DEV))
    res["cp"] = _mesh_cp_run(make_host_mesh(model=2, device=DEV))
    for key in ("ssm", "cp"):
        res[key]["rank"] = rank
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _mesh_one_rank(failures: list) -> tuple[dict, dict]:
    """(a): phase 6's configuration on a 1 x 1 mesh over a one-rank nccl
    group (the gathers and reduce-scatters launch on the card)."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh

    store = os.path.join(ROOT, "results", "mesh_store")
    shutil.rmtree(store, ignore_errors=True)
    os.makedirs(store)
    cfg = _config()
    dist.init_process_group("nccl", init_method=f"file://{store}/one", rank=0, world_size=1)
    try:
        mesh = make_host_mesh(device=DEV)
        torch.cuda.reset_peak_memory_stats()
        loop = _mesh_loop(cfg, MESH_STEPS, mesh)
        reset_launch_counts()
        loop.run()
        torch.cuda.synchronize()
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        held, share = _held_bytes(loop.final_state), _share_bytes(cfg, mesh)
        hist = loop.metrics_history
        del loop
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    torch.cuda.empty_cache()
    ref = RESULT["train"]
    losses, norms = [h["loss"] for h in hist], [h["grad_norm"] for h in hist]
    want_l, want_g = ref["losses"][:MESH_STEPS], ref["grad_norms"][:MESH_STEPS]
    rel = max(max(abs(a - b) / abs(b) for a, b in zip(losses, want_l)),
              max(abs(a - b) / abs(b) for a, b in zip(norms, want_g)))
    want = {k: 0 for k in counts}
    want.update(_train_expected_launches(cfg, MESH_STEPS, TRAIN_A))
    if rel > MESH_TOL:
        failures.append(f"(a) losses {losses} / grad norms {norms} vs phase 6's {want_l} / "
                        f"{want_g}: {rel:.3g} relative > {MESH_TOL}")
    if counts != want or min(counts[k] for k in TRAIN_KERNELS) <= 0:
        failures.append(f"(a) launches {counts} != expected {want}")
    if held != share:
        failures.append(f"(a) held state {held} B != its share {share} B")
    return dict(mesh=mesh.sizes, backend="nccl", steps=MESH_STEPS, losses=losses,
                grad_norms=norms, phase6_losses=want_l, phase6_grad_norms=want_g,
                max_rel_err=rel, bitwise_equal=losses == want_l and norms == want_g,
                step_seconds=[h["seconds"] for h in hist], peak_mem_bytes=peak,
                held_bytes=held, share_bytes=share, launches=counts,
                expected_launches=want), counts


def _mesh_pair(failures: list) -> tuple[dict, dict]:
    """(b) to (d): two gloo ranks sharing the card (subprocesses of this
    script, ``--mesh-rank``) at MESH_REPEATS layers on each of MESH_SHAPES,
    then MESH_MOE, MESH_SSM and MESH_CP on (1, 2), against one-rank runs of
    each in this process. Returns the phase's fields and rank 0's launches
    on (1, 2) by path (``mesh_tp``, ``mesh_ssm``, ``mesh_cp``)."""
    import math

    import torch

    from repro_torch.core.factors import validate_pop
    from repro_torch.core.records import RunRecord
    from repro_torch.kernels import cases

    cfg = _config().replace(repeats=MESH_REPEATS)
    loop = _mesh_loop(cfg, MESH_PAIR_STEPS, None)
    with _Seen() as seen:
        loop.run()
    ref = [h["loss"] for h in loop.metrics_history]
    ref_norms = [h["grad_norm"] for h in loop.metrics_history]
    ref_flops = _matmul_flops(seen.profiles[0])
    del loop
    # the same weights computed in fp32: how far bf16 alone moves the loss
    loop = _mesh_loop(cfg.replace(compute_dtype_name="float32"), MESH_PAIR_STEPS, None, "null")
    loop.run()
    ref32 = [h["loss"] for h in loop.metrics_history]
    ref32_norms = [h["grad_norm"] for h in loop.metrics_history]
    del loop
    torch.cuda.empty_cache()
    moe_ref = _mesh_moe_run(None)
    ssm_ref, cp_ref = _mesh_ssm_run(None), _mesh_cp_run(None)
    work = os.path.join(ROOT, "results", "mesh_pair")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    world = 2
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-rank",
                               str(r), str(world), os.path.join(work, "store"), work],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    logs = []
    deadline = time.monotonic() + MESH_RANK_TIMEOUT
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:  # a hung rank ends here, never outlives the script
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError("mesh (b): ranks exited " + str([p.returncode for p in procs])
                             + "\n" + "\n".join(x[-3000:] for x in logs))
    ranks = []
    for r in range(world):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    shutil.rmtree(work, ignore_errors=True)
    want_launches = _train_expected_launches(cfg, MESH_PAIR_STEPS, TRAIN_A)
    B, Sq, Sk, Hq, Hkv, D = cases.MAIN_FLASH_MESH[:6]
    tp_shapes = dict(flash=[[[B, Sq, Hq, D], [B, Sk, Hkv, D]]], rms=[list(cases.MAIN_RMS_MESH)])
    out = {}
    for shape in MESH_SHAPES:
        label = f"{shape[0]}x{shape[1]}"
        rows = [rk[label] for rk in ranks]
        for row in rows:
            rel = max(abs(a - b) / abs(b) for a, b in zip(row["losses"], ref))
            row["max_rel_err"] = rel
            row["matmul_flops_over_one_rank"] = row["matmul_flops"] / ref_flops
            where = f"(b) {label} rank {row['rank']}"
            if rel > MESH_PAIR_TOL or not all(map(math.isfinite, row["losses"])):
                failures.append(f"{where}: losses {row['losses']} vs one rank's {ref}: "
                                f"{rel:.3g} > {MESH_PAIR_TOL}")
            if row["held_bytes"] != row["share_bytes"]:
                failures.append(f"{where}: held {row['held_bytes']} B != its share "
                                f"{row['share_bytes']} B")
            if row["mesh"] != {"data": shape[0], "model": shape[1]}:
                failures.append(f"{where}: mesh {row['mesh']}")
            got = {k: v for k, v in row["launches"].items() if v}
            if got != want_launches:
                failures.append(f"{where}: launches {got} != {want_launches}")
            if shape[1] > 1:
                if abs(row["matmul_flops_over_one_rank"] - 0.5) > 0.5 * MESH_FLOP_TOL:
                    failures.append(f"{where}: matmul FLOPs {row['matmul_flops']} against one "
                                    f"rank's {ref_flops}: not half within {MESH_FLOP_TOL}")
                if (row["flash_shapes"], row["rms_shapes"]) != (tp_shapes["flash"],
                                                                tp_shapes["rms"]):
                    failures.append(f"{where}: K2 at {row['flash_shapes']}, K1 at "
                                    f"{row['rms_shapes']}, not the rank's {tp_shapes}")
        rec = RunRecord.load(rows[0]["record"])
        pop_errors = {n: validate_pop(r.pop) for n, r in rec.regions.items()}
        if rec.resources.mesh != {"data": shape[0], "model": shape[1]} or any(pop_errors.values()):
            failures.append(f"(b) {label} record: mesh {rec.resources.mesh}, POP {pop_errors}")
        if rows[1]["record"] is not None:
            failures.append(f"(b) {label}: rank 1 wrote a record")
        out[label] = dict(ranks=rows, record=os.path.relpath(rows[0]["record"], ROOT),
                          record_resources=rec.resources.to_json(),
                          data_lb=rec.regions["train_step"].measurements.data_lb)
    moe = [rk["moe"] for rk in ranks]
    for row in moe:
        where = f"(b) moe rank {row['rank']}"
        if row["expert_load"] != moe_ref["expert_load"]:
            failures.append(f"{where}: expert_load differs from one rank's")
        if row["expert_flops"] * 2 != moe_ref["expert_flops"]:
            failures.append(f"{where}: expert products {row['expert_flops']} FLOPs, one rank "
                            f"{moe_ref['expert_flops']}: not its half")
        got = {k: v for k, v in row["launches"].items() if v}
        if got != row["expected_launches"] or not all(map(math.isfinite, row["losses"])):
            failures.append(f"{where}: launches {got} != {row['expected_launches']}, losses "
                            f"{row['losses']}")
        row["max_rel_err"] = max(abs(a - b) / abs(b) for a, b in zip(
            row["losses"] + row["grad_norms"], moe_ref["losses"] + moe_ref["grad_norms"]))
    ssm, cp = _mesh_ssm_gates(ranks, ssm_ref, failures), _mesh_cp_gates(ranks, cp_ref, failures)
    return dict(repeats=MESH_REPEATS, steps=MESH_PAIR_STEPS, backend="gloo", world=world,
                one_rank_losses=ref, one_rank_grad_norms=ref_norms,
                one_rank_fp32_losses=ref32, one_rank_fp32_grad_norms=ref32_norms,
                one_rank_bf16_vs_fp32=max(abs(a - b) / abs(b) for a, b in zip(ref, ref32)),
                one_rank_matmul_flops=ref_flops, meshes=out,
                moe=dict(config=MESH_MOE, one_rank=moe_ref, ranks=moe), ssm=ssm, cp=cp), \
        {"mesh_tp": ranks[0]["1x2"]["launches"], "mesh_ssm": ranks[0]["ssm"]["launches"],
         "mesh_cp": ranks[0]["cp"]["launches"]}


def _pair_gates(row: dict, ref: dict, where: str, failures: list) -> None:
    """A rank's losses and grad norms within MESH_PAIR_TOL relative of the
    one-rank run's (``row["max_rel_err"]``), finite, and its launches
    exactly ``row["expected_launches"]``."""
    import math

    pairs = list(zip(row["losses"] + row["grad_norms"], ref["losses"] + ref["grad_norms"]))
    row["max_rel_err"] = max(abs(a - b) / abs(b) for a, b in pairs)
    if row["max_rel_err"] > MESH_PAIR_TOL or not all(math.isfinite(a) for a, _ in pairs):
        failures.append(f"{where}: losses {row['losses']}, grad norms {row['grad_norms']} vs "
                        f"one rank's {ref['losses']}, {ref['grad_norms']}: "
                        f"{row['max_rel_err']:.3g} > {MESH_PAIR_TOL}")
    got = {k: v for k, v in row["launches"].items() if v}
    want = {k: v for k, v in row["expected_launches"].items() if v}
    if got != want:
        failures.append(f"{where}: launches {got} != {want}")


def _mesh_ssm_gates(ranks: list, ref: dict, failures: list) -> dict:
    """(c): each rank's steps against one rank's, its counted in_proj FLOPs
    ``(2 d_inner/n + 2 g N + h/n) / (2 d_inner + 2 g N + h)`` and out_proj
    FLOPs half of one rank's within MESH_FLOP_TOL, K2 at the rank's heads."""
    cfg = _arch_cfg(MESH_SSM["arch"])
    s, n = cfg.ssm, 2
    di, gn, h = s.d_inner(cfg.d_model), s.n_groups * s.d_state, s.n_heads(cfg.d_model)
    in_share = (2 * di / n + 2 * gn + h / n) / (2 * di + 2 * gn + h)
    B, S = MESH_SSM["batch"], MESH_SSM["seq"]
    flash = [[[B, S, cfg.n_heads // n, cfg.head_dim_], [B, S, cfg.n_kv_heads // n, cfg.head_dim_]]]
    rows = [rk["ssm"] for rk in ranks]
    for row in rows:
        where = f"(c) zamba2 rank {row['rank']}"
        _pair_gates(row, ref, where, failures)
        row["in_proj_over_one_rank"] = row["in_proj_flops"] / ref["in_proj_flops"]
        row["out_proj_over_one_rank"] = row["out_proj_flops"] / ref["out_proj_flops"]
        for key, want in (("in_proj", in_share), ("out_proj", 0.5)):
            got = row[f"{key}_over_one_rank"]
            if abs(got / want - 1) > MESH_FLOP_TOL:
                failures.append(f"{where}: {key} FLOPs {got:.5f} of one rank's, not "
                                f"{want:.5f} within {MESH_FLOP_TOL}")
        if row["flash_shapes"] != flash:
            failures.append(f"{where}: K2 at {row['flash_shapes']}, not the rank's {flash}")
    return dict(config=MESH_SSM, in_proj_share=in_share, one_rank=ref, ranks=rows)


def _mesh_cp_gates(ranks: list, ref: dict, failures: list) -> dict:
    """(d): each rank's steps against one rank's, K2 only at the rank's
    4096-query block against 8192 keys, its counted K2 FLOPs those of
    ``launch_costs`` at its positions; the record's host load balance (the
    ranks' K2 milliseconds) and each rank's K2 time printed."""
    from repro_torch.core.factors import validate_pop
    from repro_torch.core.records import RunRecord

    cfg = _arch_cfg(MESH_CP["arch"])
    B, S = MESH_CP["batch"], MESH_CP["seq"]
    flash = [[[B, S // 2, cfg.n_heads, cfg.head_dim_], [B, S, cfg.n_kv_heads, cfg.head_dim_]]]
    rows = [rk["cp"] for rk in ranks]
    for row in rows:
        where = f"(d) gemma2 rank {row['rank']}"
        _pair_gates(row, ref, where, failures)
        if row["flash_shapes"] != flash:
            failures.append(f"{where}: K2 at {row['flash_shapes']}, not the block {flash}")
        if any(abs(a - b) > 1e-9 * b for a, b in zip(row["k2_flops"], row["expected_k2_flops"])):
            failures.append(f"{where}: counted K2 FLOPs {row['k2_flops']} != launch_costs at "
                            f"its positions {row['expected_k2_flops']}")
    rec = RunRecord.load(rows[0]["record"])
    region = rec.regions["train_step"]
    pop_errors = validate_pop(region.pop)
    if rec.resources.mesh != {"data": 1, "model": 2} or pop_errors or rows[1]["record"]:
        failures.append(f"(d) record: mesh {rec.resources.mesh}, POP {pop_errors}, rank 1's "
                        f"record {rows[1]['record']}")
    host_lb = region.measurements.host_lb
    k2_ms = {row["rank"]: row["k2_ms"] for row in rows}
    print(f"mesh (d) gemma2 context parallel: K2 ms a step by rank {k2_ms}, "
          f"record host load balance {host_lb}", flush=True)
    return dict(config=MESH_CP, one_rank=ref, ranks=rows, k2_ms_by_rank=k2_ms,
                record=os.path.relpath(rows[0]["record"], ROOT), record_host_lb=host_lb,
                k2_flops_rank0_over_rank1=rows[0]["k2_flops"][0] / rows[1]["k2_flops"][0])


def phase_mesh() -> dict:
    """6b: the training step over a mesh of ranks, (a) to (d); returns the
    launches of (a) (``"mesh"``) and of rank 0 of (b)'s tensor-parallel
    mesh, (c) and (d) (``"mesh_tp"``, ``"mesh_ssm"``, ``"mesh_cp"``)."""
    failures: list = []
    one, counts = _mesh_one_rank(failures)
    pair, rank0 = _mesh_pair(failures)
    emit("mesh", one_rank_nccl=one, two_ranks_gloo=pair, card=_card())
    if failures:
        raise AssertionError("mesh: " + "; ".join(failures))
    return {"mesh": counts, **rank0}


def _oneshot_tokens(vocab: int, shape, seed: int):
    import numpy as np
    import torch

    return torch.from_numpy(np.random.default_rng(seed).integers(4, vocab, size=shape)
                            .astype(np.int32))


def _top2_gaps(logits):
    """Each row's gap between its two largest logits."""
    top = logits.float().topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1]).cpu()


def _recorded_logits(model) -> list:
    """The logits that ``model``'s ``prefill``, ``decode_step`` and
    ``apply_logits`` return from here on, in order, as the serving steps
    call them, made whole: the vocabulary's ranks' columns gathered
    (``vocab_gather``), then the rows' ranks' rows (``rows_gather``). The
    steps themselves return tokens only, as JAX's do."""
    import inspect

    from repro_torch.distributed.shard import rows_gather, vocab_gather
    from repro_torch.layers.common import NULL_CONSTRAINTS

    seen = []
    for name in ("prefill", "decode_step", "apply_logits"):
        fn = getattr(model, name)

        def rec(*a, _fn=fn, _sig=inspect.signature(fn), **k):
            out = _fn(*a, **k)
            lc = _sig.bind(*a, **k).arguments.get("lc", NULL_CONSTRAINTS)
            full = vocab_gather(out[0] if isinstance(out, tuple) else out, lc.tp)
            seen.append(full if lc.ranks is None else rows_gather(full, lc.ranks))
            return out
        setattr(model, name, rec)
    return seen


@contextlib.contextmanager
def _plain_versions():
    """K2 and K1 replaced by their plain versions while open."""
    import repro_torch.layers.attention as LA
    import repro_torch.layers.norms as LN
    from repro_torch.kernels.flash_attention.ref import flash_attention_reference
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference

    saved = LA.flash_attention, LN._rmsnorm_op
    LA.flash_attention, LN._rmsnorm_op = flash_attention_reference, rmsnorm_reference
    try:
        yield
    finally:
        LA.flash_attention, LN._rmsnorm_op = saved


def _oneshot_pair(model, prompt, decode: int, chunk: int) -> dict:
    """``prompt`` (1, P) through ``make_prefill_step`` into a dense cache of
    P + ``decode`` positions and ``decode`` greedy steps of
    ``make_decode_step``; then the same prompt through ``prefill_chunk`` in
    ``chunk``-token chunks into a second cache, and the same decode inputs
    (the one-shot run's tokens) through ``decode_step``. Launches, seconds
    and peak memory of the one-shot run; the logits of both runs at every
    step (the prefill's last position first)."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.serve import make_decode_step, make_prefill_step

    P = prompt.shape[1]
    prefill = make_prefill_step(model)
    step = make_decode_step(model)
    logits = _recorded_logits(model)
    caches = model.init_cache(1, P + decode, paged=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    tok, caches = prefill({"tokens": prompt}, caches)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    reset_launch_counts()
    inputs = []
    t0 = time.perf_counter()
    for i in range(decode):
        inputs.append(tok.reshape(1, 1))
        tok, caches = step(inputs[-1], P + i, caches)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    decode_launches = launch_counts()
    one = [lg.float() for lg in logits]
    del caches, logits[:]
    ref_caches = model.init_cache(1, P + decode, paged=False)
    ref = []
    for c0 in range(0, P, chunk):
        lg = model.prefill_chunk(prompt[:, c0:c0 + chunk], ref_caches, c0, chunk)
    ref.append(lg.float())
    for i, t in enumerate(inputs):
        ref.append(model.decode_step(t, P + i, ref_caches).float())
    del ref_caches
    torch.cuda.empty_cache()
    return dict(one=one, ref=ref, prefill_s=prefill_s, decode_s=decode_s,
                prefill_launches=prefill_launches, decode_launches=decode_launches,
                peak_mem_bytes=peak)


def _oneshot_gates(run: dict, cfg, decode: int, label: str, failures: list,
                   tol: float | None) -> dict:
    """The one-shot run against the chunked one: greedy tokens equal except
    where the chunked run's top-2 gap is under LOGIT_TOL (``tol`` None, the
    bf16 run), or equal everywhere with the prefill's last logits within
    ``tol`` of their largest |value| (fp32; the decode steps' distances
    printed); launches exact (K2 one a layer for the prefill and each
    decode step, K1 on every norm)."""
    import torch

    A, N = _attn_layers(cfg), _layer_norms(cfg) + 1
    diffs, parted, near = [], [], []
    for i, (a, b) in enumerate(zip(run["one"], run["ref"])):
        diffs.append(float((a - b).abs().max()) / max(1.0, float(b.abs().max())))
        ta, tb = torch.argmax(a, -1), torch.argmax(b, -1)
        if not torch.equal(ta, tb):
            gap = float(_top2_gaps(b).min())
            (near if tol is None and gap < LOGIT_TOL else parted).append([i, gap])
    want_p = {"flash_attention": A, "rmsnorm": N}
    want_d = {"flash_attention": A * decode, "rmsnorm": N * decode}
    got_p = {k: v for k, v in run["prefill_launches"].items() if v}
    got_d = {k: v for k, v in run["decode_launches"].items() if v}
    if got_p != want_p or got_d != want_d:
        failures.append(f"(a) {label}: launches prefill {got_p} != {want_p}, decode {got_d} "
                        f"!= {want_d}")
    if parted:
        failures.append(f"(a) {label}: tokens part from the chunked prefill's at (step, "
                        f"top-2 gap) {parted}")
    if tol is not None and diffs[0] > tol:
        failures.append(f"(a) {label}: the prefill's logits {diffs[0]} of the largest |value| "
                        f"from the chunked prefill's > {tol}")
    return dict(max_logit_diff=max(diffs), logit_diff_per_step=diffs, near_ties=near,
                prefill_launches=got_p, decode_launches=got_d)


def _oneshot_single(failures: list) -> tuple[dict, dict]:
    """(a): ONESHOT in bf16 at full depth, then in fp32 at ``fp32_repeats``
    layers; returns the phase's fields and the bf16 run's launches."""
    import torch

    o = ONESHOT
    cfg = _arch_cfg(o["arch"])
    model, draw_s = _card_model(cfg, o["seed"], fan_in=True)
    prompt = _oneshot_tokens(cfg.vocab, (1, o["prompt"]), o["seed"])
    run = _oneshot_pair(model, prompt, o["decode"], o["chunk"])
    _release(model)
    bf16 = _oneshot_gates(run, cfg, o["decode"], "bf16", failures, None)
    bf16.update(prefill_s=run["prefill_s"], prefill_tokens_per_s=o["prompt"] / run["prefill_s"],
                decode_s=run["decode_s"], decode_tokens_per_s=o["decode"] / run["decode_s"],
                peak_mem_bytes=run["peak_mem_bytes"], draw_s=draw_s)
    counts = {k: run["prefill_launches"][k] + run["decode_launches"][k]
              for k in run["prefill_launches"]}
    del run
    cfg32 = _arch_cfg(o["arch"], o["fp32_repeats"], "float32")
    model, _ = _card_model(cfg32, o["seed"], fan_in=True)
    run = _oneshot_pair(model, prompt, o["decode"], o["chunk"])
    _release(model)
    fp32 = _oneshot_gates(run, cfg32, o["decode"], "fp32", failures, ONESHOT_TOL)
    del run
    torch.cuda.empty_cache()
    return dict(prompt=o["prompt"], decode_steps=o["decode"], chunk=o["chunk"], bf16=bf16,
                fp32=dict(repeats=o["fp32_repeats"], tol=ONESHOT_TOL, **fp32)), counts


def _oneshot_encoder(failures: list) -> dict:
    """(b): hubert-xlarge's encoder step at full depth in bf16 (launches
    exact), then at ``fp32_repeats`` layers in fp32 against the same weights
    with the plain versions in place of the kernels; then, at those layers
    under the reference draw (attention near one-hot), the kernels' and the
    plain versions' fp32 logits each against a float64 run of the same
    weights through the plain versions (``_reference_draw_witness``)."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.serve import make_encoder_step

    e = ONESHOT_ENCODER
    out = {}
    for label, cfg in (("bf16", _arch_cfg(e["arch"])),
                       ("fp32", _arch_cfg(e["arch"], e["fp32_repeats"], "float32"))):
        model, _ = _card_model(cfg, e["seed"], fan_in=True)
        frames = _oneshot_frames(cfg, e)
        step = make_encoder_step(model)
        seen = _recorded_logits(model)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        tok = step({"frontend": frames})
        torch.cuda.synchronize()
        logits = seen.pop()
        row = dict(repeats=cfg.repeats, seconds=time.perf_counter() - t0,
                   launches={k: v for k, v in launch_counts().items() if v},
                   finite=bool(torch.isfinite(logits).all()))
        want = {"flash_attention": _attn_layers(cfg), "rmsnorm": _layer_norms(cfg) + 1}
        if row["launches"] != want or not row["finite"] or tuple(tok.shape) != (
                e["batch"], e["seq"]):
            failures.append(f"(b) {label}: launches {row['launches']} != {want}, finite "
                            f"{row['finite']}, tokens {tuple(tok.shape)}")
        if label == "fp32":
            with _plain_versions():
                ptok = step({"frontend": frames})
            plog = seen.pop()
            row["max_logit_diff"] = float((logits - plog).abs().max()) / max(
                1.0, float(plog.abs().max()))
            row["tokens_equal"] = bool(torch.equal(tok, ptok))
            if not row["tokens_equal"] or row["max_logit_diff"] > ONESHOT_TOL:
                failures.append(f"(b) fp32: against the plain versions tokens equal "
                                f"{row['tokens_equal']}, logits {row['max_logit_diff']} > "
                                f"{ONESHOT_TOL}")
            del ptok, plog
        out[label] = row
        del tok, logits, frames, step
        _release(model)
    out["fp32_reference_draw"] = _reference_draw_witness(failures)
    return out


def _oneshot_frames(cfg, e: dict):
    import torch

    gen = torch.Generator(device=DEV).manual_seed(e["seed"])
    return torch.randn((e["batch"], e["seq"], cfg.d_model), generator=gen, device=DEV,
                       dtype=torch.float32).to(cfg.compute_dtype)


def _reference_draw_witness(failures: list) -> dict:
    """hubert-xlarge at ``fp32_repeats`` layers under the reference draw
    (no ``_fan_in_``), ONESHOT_ENCODER's frames: the encoder step's fp32
    logits through the kernels and through the plain versions, each
    against a float64 run of the same weights and frames through the plain
    versions. Max and RMS distance over the float64 logits' max and RMS;
    the gate: the kernels' RMS distance within EXACT_RATIO times the plain
    fp32 run's, so that a gap between the two fp32 runs is fp32 rounding,
    not a fault of the kernels."""
    import torch

    from repro_torch.layers.common import tree_map
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve.serve import make_encoder_step

    e = ONESHOT_ENCODER
    cfg = _arch_cfg(e["arch"], e["fp32_repeats"], "float32")
    model, _ = _card_model(cfg, e["seed"])
    frames = _oneshot_frames(cfg, e)
    step = make_encoder_step(model)
    seen = _recorded_logits(model)
    tok = step({"frontend": frames})
    with _plain_versions():
        ptok = step({"frontend": frames})
    kern, plain = seen
    cfg64 = cfg.replace(param_dtype_name="float64", compute_dtype_name="float64")
    exact_model = Transformer(cfg64, tree_map(lambda t: t.double(), model.params()), DEV)
    with _plain_versions(), torch.inference_mode():
        exact = exact_model.apply_logits({"frontend": frames.double()})[0]
    del exact_model
    _release(model)

    def against(x) -> dict:
        d = x.double() - exact
        return dict(max_rel=float(d.abs().max() / exact.abs().max()),
                    rms_rel=float(d.pow(2).mean().sqrt() / exact.pow(2).mean().sqrt()),
                    tokens_equal_float64=bool(torch.equal(x.argmax(-1), exact.argmax(-1))))

    row = dict(repeats=cfg.repeats, kernels=against(kern), plain=against(plain),
               kernels_vs_plain_max_rel=float((kern - plain).abs().max() / plain.abs().max()),
               tokens_equal=bool(torch.equal(tok, ptok)), ratio_limit=EXACT_RATIO)
    row["rms_ratio"] = row["kernels"]["rms_rel"] / row["plain"]["rms_rel"]
    if row["rms_ratio"] > EXACT_RATIO:
        failures.append(f"(b) reference draw: the kernels' RMS distance from float64 "
                        f"{row['kernels']['rms_rel']} > {EXACT_RATIO} x the plain versions' "
                        f"{row['plain']['rms_rel']}")
    del kern, plain, exact, seen, frames
    torch.cuda.empty_cache()
    return row


def _oneshot_mesh_run(m: dict, mesh) -> dict:
    """``m`` (an ONESHOT_MESH row) with ONESHOT_MESH_RUN's batch, prompt and
    decode steps on ``mesh`` (None: one rank): greedy tokens and logits of
    every step, launches, and the (q, k) shapes K2's forward saw."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve.serve import make_decode_step, make_prefill_step

    r = ONESHOT_MESH_RUN
    cfg = _arch_cfg(m["arch"], m["repeats"]).replace(compute_dtype_name="float32")
    model = Transformer.from_init(cfg, seed=m["seed"], device=DEV, draw_device="cuda", mesh=mesh)
    _fan_in_(model)
    prompt = _oneshot_tokens(cfg.vocab, (r["batch"], r["prompt"]), m["seed"])
    caches = model.init_cache(r["batch"], r["max_len"], paged=False)
    prefill = make_prefill_step(model, mesh)
    step = make_decode_step(model, mesh)
    logits = _recorded_logits(model)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with _Seen() as seen:
        tok, caches = prefill({"tokens": prompt}, caches)
        toks = [tok.cpu()]
        tok = tok[:, None]
        for i in range(r["decode"]):
            tok, caches = step(tok, r["prompt"] + i, caches)
            toks.append(tok[:, 0].cpu())
    torch.cuda.synchronize()
    lgs = [lg.float().cpu() for lg in logits]
    out = dict(tokens=torch.stack(toks), logits=torch.stack(lgs),
               seconds=time.perf_counter() - t0,
               launches={k: v for k, v in launch_counts().items() if v},
               flash_shapes=sorted(seen.flash),
               cache_bytes=sum(t.numel() * t.element_size()
                               for leaf in caches.values() for d in leaf.values()
                               for t in d.values()))
    del model, caches
    torch.cuda.empty_cache()
    return out


def _oneshot_rank_main(argv) -> int:
    """One of phase 6c (c)'s ranks: ``--oneshot-rank CASE RANK WORLD STORE OUT``."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    case, rank, world, store, out = argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=MESH_RANK_TIMEOUT))
    m = ONESHOT_MESH[case]
    res = _oneshot_mesh_run(m, make_host_mesh(model=m["mesh"][1], device=DEV))
    res["rank"] = rank
    if rank:
        res.pop("logits")
    torch.save(res, os.path.join(out, f"{case}_rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _oneshot_share(m: dict) -> set:
    """The (q, k) shapes a rank's K2 forward takes on ``m``'s mesh: the
    prefill at its query heads (and KV heads, where they divide the model
    axis) over the whole prompt; a decode step against its rows' cache
    block, its KV heads at every position, or, where the cache's sequence
    is split, every query head against its block of the positions."""
    from repro_torch.configs import get_config

    cfg, r = get_config(m["arch"]), ONESHOT_MESH_RUN
    n, B, P, L = m["mesh"][1], r["batch"], r["prompt"], r["max_len"]
    hq, hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    if hkv % n == 0:
        return {((B, P, hq // n, D), (B, P, hkv // n, D)),
                ((B, 1, hq // n, D), (B, L, hkv // n, D))}
    kv = len({h * hkv // hq for h in range(hq // n)})  # the kv heads a rank's q heads read
    return {((B, P, hq // n, D), (B, P, kv, D)), ((B, 1, hq, D), (B, L // n, hkv, D))}


def _oneshot_mesh(failures: list) -> tuple[dict, dict]:
    """(c): each ONESHOT_MESH case's gloo ranks sharing the card (this
    script's ``--oneshot-rank`` subprocesses; the cases' ranks all started
    together) against one rank's run of the same weights in this process:
    every step's tokens equal, logits within ONESHOT_TOL of the largest
    |value|, launches those of one rank, each rank's K2 shapes its share.
    Returns the fields and rank 0's launches of the sequence-split case."""
    import torch

    from repro_torch.kernels import LAUNCHES

    work = os.path.join(ROOT, "results", "oneshot_mesh")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    procs = []
    for case, m in ONESHOT_MESH.items():
        world = m["mesh"][0] * m["mesh"][1]
        procs += [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--oneshot-rank", case, str(rk),
             str(world), os.path.join(work, f"store_{case}"), work],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rk in range(world)]
    refs = {case: _oneshot_mesh_run(m, None) for case, m in ONESHOT_MESH.items()}
    logs = []
    deadline = time.monotonic() + MESH_RANK_TIMEOUT
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:  # a hung rank ends here, never outlives the script
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError("oneshot (c): ranks exited " + str([p.returncode for p in procs])
                             + "\n" + "\n".join(x[-3000:] for x in logs))
    out, counts = {}, {}
    for case, m in ONESHOT_MESH.items():
        world = m["mesh"][0] * m["mesh"][1]
        ranks = [torch.load(os.path.join(work, f"{case}_rank{rk}.pt"), weights_only=False)
                 for rk in range(world)]
        ref = refs[case]
        diff = float((ranks[0]["logits"] - ref["logits"]).abs().max()) / max(
            1.0, float(ref["logits"].abs().max()))
        share = _oneshot_share(m)
        row = dict(mesh=m["mesh"], repeats=m["repeats"], max_logit_diff=diff,
                   one_rank_seconds=ref["seconds"], one_rank_launches=ref["launches"],
                   ranks=[dict(rank=rk["rank"], seconds=rk["seconds"], launches=rk["launches"],
                               flash_shapes=rk["flash_shapes"], cache_bytes=rk["cache_bytes"])
                          for rk in ranks], one_rank_cache_bytes=ref["cache_bytes"])
        for rk in ranks:
            where = f"(c) {case} rank {rk['rank']}"
            if not torch.equal(rk["tokens"], ref["tokens"]):
                failures.append(f"{where}: tokens {rk['tokens'].tolist()} != one rank's "
                                f"{ref['tokens'].tolist()}")
            if rk["launches"] != ref["launches"]:
                failures.append(f"{where}: launches {rk['launches']} != one rank's "
                                f"{ref['launches']}")
            got = {(tuple(q), tuple(k)) for q, k in rk["flash_shapes"]}
            if got != share:
                failures.append(f"{where}: K2 at {sorted(got)}, not its share {sorted(share)}")
            if rk["cache_bytes"] * world != ref["cache_bytes"]:  # spare rows split alike
                failures.append(f"{where}: cache block {rk['cache_bytes']} B, not 1/{world} "
                                f"of one rank's {ref['cache_bytes']} B")
        if diff > ONESHOT_TOL:
            failures.append(f"(c) {case}: logits {diff} of the largest |value| from one rank's "
                            f"> {ONESHOT_TOL}")
        out[case] = row
        counts[f"oneshot_{case}"] = {k: ranks[0]["launches"].get(k, 0) for k in LAUNCHES}
    shutil.rmtree(work, ignore_errors=True)
    return out, counts


class _PagedSeen:
    """While open: the (kind, q shape, pool shape) at which the serving
    layers call K3 (``"decode"``) and K4 (``"chunk"``)."""

    def __enter__(self):
        from repro_torch.layers import attention as A

        self.shapes = set()
        self._saved = A.paged_attention, A.paged_prefill_attention

        def tagged(fn, kind):
            def seen(q, k, *a, **kw):
                self.shapes.add((kind, tuple(q.shape), tuple(k.shape)))
                return fn(q, k, *a, **kw)
            return seen

        A.paged_attention = tagged(self._saved[0], "decode")
        A.paged_prefill_attention = tagged(self._saved[1], "chunk")
        return self

    def __exit__(self, *exc):
        from repro_torch.layers import attention as A

        A.paged_attention, A.paged_prefill_attention = self._saved
        return False


def _serve_mesh_prompts(vocab: int, m: dict) -> list:
    import numpy as np

    rng = np.random.default_rng(m["seed"])
    system = rng.integers(4, vocab, m["prefix"]).tolist()
    return [system + rng.integers(4, vocab, int(rng.integers(*m["tail"]))).tolist()
            for _ in range(m["requests"])]


def _serve_mesh_model(g: dict, mesh):
    """``g``'s weights, bf16 computed in fp32, drawn on the card from
    SERVE_MESH's seed: on a mesh whose "model" axis is above 1 this rank's
    blocks, else the whole weights (the scheduler then takes the mesh)."""
    from repro_torch.models.transformer import Transformer

    cfg = _arch_cfg(g["arch"], g["repeats"]).replace(compute_dtype_name="float32")
    held = mesh if mesh is not None and mesh.sizes["model"] > 1 else None
    model = Transformer.from_init(cfg, seed=SERVE_MESH["seed"], device=DEV,
                                  draw_device="cuda", mesh=held)
    if g.get("fan_in"):
        _fan_in_(model)
    return model, cfg


def _serve_mesh_session(devices: int):
    from repro_torch.core.records import ResourceConfig
    from repro_torch.session import PerfSession, SessionConfig

    return PerfSession(SessionConfig(app_name="serve-mesh", backend="monitor",
                                     lb_sample_every=1),
                       ResourceConfig(num_hosts=1, devices_per_host=devices))


def _serve_mesh_run(model, cfg, mesh, g: dict, over: dict, session=None,
                    warm: bool = False) -> dict:
    """``g``'s workload (SERVE_MESH unless it names another) through a
    scheduler on ``mesh`` (None: one rank): tokens, launches, the paged
    kernels' and K1's shapes, seconds, tokens/s, time to first token and
    the counters. ``warm``: the first 2 requests, 2 tokens each (the
    process's warm-up)."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.serve import BatchScheduler, ServeConfig

    m = dict(g.get("work", SERVE_MESH))
    if warm:
        m.update(requests=2, max_new=2)
    sched = BatchScheduler(model, ServeConfig(
        max_len=m["max_len"], batch=m["batch"], page_size=m["page_size"],
        prefill_chunk=m["prefill_chunk"], num_pages=m["num_pages"], prefix_cache=True, **over),
        session=session, mesh=mesh)
    prompts = _serve_mesh_prompts(cfg.vocab, m)[:m["requests"]]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with _PagedSeen() as paged, _Seen() as seen:
        for rid, p in enumerate(prompts):
            sched.submit(p, request_id=rid, max_new=m["max_new"])
        sched.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = {r["id"]: r["generated"] for r in sched.completed}
    ttft = sorted(r["t_first_token"] - r["t_submit"] for r in sched.completed)
    kv = sched.kv_cache_stats()
    out = dict(tokens=toks, launches={k: v for k, v in launch_counts().items() if v},
               paged_shapes=sorted(paged.shapes), rms_shapes=sorted(seen.rms),
               seconds=wall, tokens_per_s=sum(len(t) for t in toks.values()) / wall,
               ttft_p50_s=ttft[len(ttft) // 2], ttft_max_s=ttft[-1],
               decode_steps=sched.stats["decode_steps"],
               prefill_chunks=sched.stats["prefill_chunks"],
               preemptions=kv["pressure"]["preemptions"],
               cow_copies=kv["prefix_cache"]["cow_copies"])
    if over.get("spec_decode"):
        out["speculation"] = kv["speculation"]
    del sched
    torch.cuda.empty_cache()
    return out


def _serve_rank_main(argv) -> int:
    """One of phase 6e's ranks: ``--serve-rank GROUP RANK WORLD STORE OUT``."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    group, rank, world, store, out = argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=MESH_RANK_TIMEOUT))
    g = SERVE_MESH_GROUPS[group]
    mesh = make_host_mesh(model=g["mesh"][1], device=DEV)
    model, cfg = _serve_mesh_model(g, mesh)
    for over in g["runs"].values():
        _serve_mesh_run(model, cfg, mesh, g, over, warm=True)
    res = {"rank": rank, "runs": {}, "allreduce_ms": _allreduce_ms(cfg)}
    while not os.path.exists(os.path.join(out, "go")):  # the references first
        time.sleep(0.05)
    for label, over in g["runs"].items():
        record = group == "tinyllama_12" and label == "greedy"
        session = _serve_mesh_session(world) if record else None
        res["runs"][label] = _serve_mesh_run(model, cfg, mesh, g, over, session)
        if record:
            session.finalize(os.path.join(ROOT, SERVE_MESH_TALP_DIR, cfg.name, "serve_mesh"),
                             save=rank == 0)
    torch.save(res, os.path.join(out, f"{group}_rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _allreduce_ms(cfg) -> float:
    """One all-reduce over every rank of a decode step's activations (8 x
    d fp32 on the card) under gloo, in ms: the mean of
    SERVE_MESH_COLLECTIVES, after one untimed."""
    import torch
    import torch.distributed as dist

    x = torch.ones((SERVE_MESH["batch"], cfg.d_model), dtype=torch.float32, device=DEV)
    dist.all_reduce(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SERVE_MESH_COLLECTIVES):
        dist.all_reduce(x)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / SERVE_MESH_COLLECTIVES


def _serve_mesh_launches(g: dict, cfg, ref: dict) -> dict:
    """A rank's launches: one rank's (the same dispatches), but where a
    tensor-parallel rank's mamba2 blocks split, their gated norm is torch
    ops (its mean sums over the ranks): one K1 fewer a mamba2 layer and
    dispatch (``_split_ssm_launches``)."""
    want = dict(ref["launches"])
    n = g["mesh"][1]
    if cfg.ssm is not None and n > 1 and cfg.ssm.n_heads(cfg.d_model) % n == 0 \
            and "rmsnorm" in want:  # (the card's count: the CPU launches none)
        layers = cfg.repeats * cfg.pattern.count("mamba2")
        want["rmsnorm"] -= layers * (ref["decode_steps"] + ref["prefill_chunks"])
    return want


def _serve_mesh_share(g: dict, cfg, kind: str) -> tuple:
    """(rows, query heads, pool KV heads) at which a rank of ``g``'s mesh
    calls a paged kernel: the decode over its rows of the slots (the chunk:
    one row on every rank), its KV heads and the query heads they serve,
    or, where the KV heads do not split, every head against the whole
    pool."""
    d, n = g["mesh"]
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    rows = g.get("work", SERVE_MESH)["batch"] // d if kind == "decode" else 1
    return (rows,) + ((hq // n, hkv // n) if hkv % n == 0 else (hq, hkv))


def _serve_mesh(failures: list) -> tuple[dict, dict]:
    """6e: every group's gloo ranks sharing the card (this script's
    ``--serve-rank`` subprocesses, all started together) against one
    rank's runs of the same weights in this process: every request's
    tokens equal, each rank's K3, K4 and K1 launches those of one rank
    (the same dispatches) at the rank's shapes, rank 0's record passing
    ``talp validate``. Returns the fields and rank 0's launches of the
    (1, 2) greedy run (the path of ``cases.PAGED_MESH`` and
    ``cases.PREFILL_MESH``)."""
    import torch

    from repro_torch.kernels import LAUNCHES

    work = os.path.join(ROOT, "results", "serve_mesh")
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(os.path.join(ROOT, SERVE_MESH_TALP_DIR), ignore_errors=True)
    os.makedirs(work)
    procs = []
    for group, g in SERVE_MESH_GROUPS.items():
        world = g["mesh"][0] * g["mesh"][1]
        procs += [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--serve-rank", group, str(rk),
             str(world), os.path.join(work, f"store_{group}"), work],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rk in range(world)]
    refs: dict = {}
    logs = []
    try:
        t0 = time.perf_counter()
        for group, g in SERVE_MESH_GROUPS.items():
            model = cfg = None
            for label, over in g["runs"].items():
                key = (g["arch"], label)
                if key in refs:
                    continue
                if model is None:
                    model, cfg = _serve_mesh_model(g, None)
                    _serve_mesh_run(model, cfg, None, g, over, warm=True)
                session = _serve_mesh_session(1) if group == "tinyllama_12" and \
                    label == "greedy" else None
                refs[key] = _serve_mesh_run(model, cfg, None, g, over, session)
                if session is not None:
                    session.finalize(None, save=False)
            del model
            torch.cuda.empty_cache()
        refs_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        open(os.path.join(work, "go"), "w").close()
        deadline = time.monotonic() + MESH_RANK_TIMEOUT
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
        ranks_s = time.perf_counter() - t0
    finally:
        for p in procs:  # a hung rank ends here, never outlives the script
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError("serve_mesh: ranks exited " + str([p.returncode for p in procs])
                             + "\n" + "\n".join(x[-3000:] for x in logs))
    out, counts = {}, {}
    for group, g in SERVE_MESH_GROUPS.items():
        world = g["mesh"][0] * g["mesh"][1]
        cfg = _arch_cfg(g["arch"], g["repeats"])
        ranks = [torch.load(os.path.join(work, f"{group}_rank{rk}.pt"), weights_only=False)
                 for rk in range(world)]
        row = dict(mesh=g["mesh"], arch=g["arch"], layers=cfg.n_layers,
                   allreduce_ms=[rk["allreduce_ms"] for rk in ranks], runs={})
        for label in g["runs"]:
            ref = refs[(g["arch"], label)]
            runs = [rk["runs"][label] for rk in ranks]
            row["runs"][label] = dict(
                one_rank=dict((k, ref[k]) for k in (
                    "seconds", "tokens_per_s", "ttft_p50_s", "ttft_max_s", "decode_steps",
                    "prefill_chunks", "preemptions", "cow_copies", "launches")),
                ranks=[dict((k, r[k]) for k in ("seconds", "tokens_per_s", "ttft_p50_s",
                                                "ttft_max_s", "launches", "paged_shapes",
                                                "rms_shapes")) for r in runs])
            if "speculation" in ref:
                row["runs"][label]["speculation"] = ref["speculation"]
            if "work" not in g and ref["preemptions"] < 1:
                failures.append(f"{group} {label}: the pool never preempted")
            for rk, r in enumerate(runs):
                where = f"{group} {label} rank {rk}"
                if r["tokens"] != ref["tokens"]:
                    bad = [i for i in ref["tokens"] if r["tokens"].get(i) != ref["tokens"][i]]
                    failures.append(f"{where}: tokens of requests {bad} differ from one rank's")
                want = _serve_mesh_launches(g, cfg, ref)
                if r["launches"] != want:
                    failures.append(f"{where}: launches {r['launches']} != {want} (one "
                                    f"rank's {ref['launches']})")
                for kind, q, pool in r["paged_shapes"]:
                    want = _serve_mesh_share(g, cfg, "chunk" if q[0] == 1 and kind == "chunk"
                                             else "decode")
                    if (q[0], q[2], pool[2]) != want:
                        failures.append(f"{where}: {kind} at q {q}, pool {pool}, not the "
                                        f"rank's (rows, q heads, kv heads) {want}")
        if group == "tinyllama_12":
            counts_of = ranks[0]["runs"]["greedy"]["launches"]
            counts["serve_mesh"] = {k: counts_of.get(k, 0) for k in LAUNCHES}
        out[group] = row
    out["seconds"] = dict(references=refs_s, ranks_after_references=ranks_s)
    cli = _talp_cli("validate", "-i", SERVE_MESH_TALP_DIR)
    records = _records_under(SERVE_MESH_TALP_DIR)
    out["record"] = dict(cli_rc=cli["rc"], files=records)
    if cli["rc"] != 0 or len(records) != 1 or not os.path.basename(records[0]).startswith(
            "talp_1x2_"):
        failures.append(f"serve_mesh record: validate rc {cli['rc']}, files {records}: "
                        f"{cli['stdout'][-500:]} {cli['stderr'][-500:]}")
    shutil.rmtree(work, ignore_errors=True)
    return out, counts


def _records_under(folder: str) -> list:
    """The run records under ``folder`` (relative to the repository root)."""
    found = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, folder)):
        found += [os.path.join(dirpath, f) for f in files
                  if f.startswith("talp_") and f.endswith(".json")]
    return sorted(found)


def phase_serve_mesh() -> dict:
    """6e: the scheduler on meshes of ranks; returns rank 0's launches of
    the (1, 2) greedy run (``"serve_mesh"``)."""
    failures: list = []
    fields: dict = {}
    try:  # what ran is printed before a failure ends the phase
        fields["groups"], counts = _serve_mesh(failures)
    finally:
        emit("serve_mesh", **fields, failures=failures, card=_card())
    if failures:
        raise AssertionError("serve_mesh: " + "; ".join(failures))
    return counts


def _kernel_entries(prof) -> dict:
    return {k: [c.multiplicity, c.flops, c.hbm_bytes] for k, c in prof.per_computation.items()
            if c.kind == "kernel"}


def _entry(prof, name: str) -> tuple:
    c = prof.per_computation.get(name)
    return (0.0, 0.0, 0.0) if c is None else (c.multiplicity, c.flops, c.hbm_bytes)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def phase_dryrun() -> None:
    """Phase 6d (module docstring): the dry run on the host."""
    import math

    import torch

    from repro_torch.configs import InputShape
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train.train import TrainConfig

    card, total = _card(), torch.cuda.get_device_properties(0).total_memory
    failures = []
    reset_launch_counts()
    # (a) phase 6's step on a 1 x 1 meta mesh
    real = TRAIN_PROFILE["train_step"]
    shape = InputShape("phase6", TRAIN_S, TRAIN_B * TRAIN_A, "train")
    prof, meta = D.count_cell(_config(), shape, Mesh((1, 1), ("data", "model")),
                              TrainConfig(total_steps=TRAIN_STEPS), accum=TRAIN_A, arch=ARCH)
    # phase 6's own peak: less what earlier phases still held when it began
    peak = RESULT["train"]["peak_mem_bytes"] - RESULT["train"]["held_before_bytes"]
    mem = prof.memory
    predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    got_k, want_k = _kernel_entries(prof), _kernel_entries(real)
    a = {"flops": prof.flops, "flops_phase6": real.flops,
         "flops_rel": _rel(prof.flops, real.flops),
         "hbm_bytes": prof.hbm_bytes, "hbm_bytes_phase6": real.hbm_bytes,
         "hbm_bytes_rel": _rel(prof.hbm_bytes, real.hbm_bytes),
         "kernels": got_k, "kernels_phase6": want_k, "memory_analysis": mem,
         # the entries that differ: name -> [calls, FLOPs, bytes] here and in phase 6
         "differing": {k: [list(_entry(prof, k)), list(_entry(real, k))]
                       for k in set(prof.per_computation) | set(real.per_computation)
                       if _entry(prof, k) != _entry(real, k)},
         "predicted_peak_bytes": predicted, "peak_mem_bytes_phase6": peak,
         "held_before_phase6_bytes": RESULT["train"]["held_before_bytes"],
         "peak_rel": _rel(predicted, peak), "count_s": meta["count_s"]}
    if a["flops_rel"] > DRYRUN_COUNT_TOL or a["hbm_bytes_rel"] > DRYRUN_COUNT_TOL:
        failures.append(f"(a) counted flops/bytes {prof.flops}/{prof.hbm_bytes} vs phase 6's "
                        f"{real.flops}/{real.hbm_bytes}")
    if set(got_k) != set(want_k) or any(
            got_k[k][0] != want_k[k][0] or _rel(got_k[k][1], want_k[k][1]) > DRYRUN_COUNT_TOL
            or _rel(got_k[k][2], want_k[k][2]) > DRYRUN_COUNT_TOL for k in want_k):
        failures.append(f"(a) kernel entries {got_k} vs phase 6's {want_k}")
    if a["peak_rel"] > DRYRUN_PEAK_TOL:
        failures.append(f"(a) predicted peak {predicted} vs phase 6's {peak}")
    # (b) production cells at full depth
    cells = []
    for arch, shape_name, multi_pod in DRYRUN_CELLS:
        rec = D.run_cell(arch, shape_name, multi_pod, DRYRUN_DIR, force=True)
        row = {"arch": arch, "shape": shape_name, "status": rec["status"],
               "mesh": "2x16x16" if multi_pod else "16x16"}
        if rec["status"] != "ok":
            failures.append(f"(b) {arch} {shape_name}: {rec.get('error')}")
            cells.append(row)
            continue
        r = rec["roofline"]
        terms = {k: r[k] for k in ("compute_s", "memory_s", "collective_s",
                                   "collective_ici_s", "collective_dcn_s")}
        kernels = {k: v["multiplicity"] / rec["profile"]["num_devices"]
                   for k, v in rec["profile"]["per_computation"].items()
                   if v["kind"] == "kernel"}
        row.update(terms, bottleneck=r["bottleneck"], mode=rec["mode"],
                   strategy=rec["strategy"], counted_rank=rec["counted_rank"],
                   mem_per_device_bytes=D.mem_per_device_gib(rec) * 2**30,
                   mem_fraction_of_card=D.mem_per_device_gib(rec) * 2**30 / total,
                   memory_analysis=rec["memory_analysis"], kernel_calls=kernels,
                   collective_counts=rec["profile"]["collective_counts"],
                   count_s=rec["count_s"], ranks=rec.get("ranks"))
        if not all(math.isfinite(v) and v >= 0 for v in terms.values()):
            failures.append(f"(b) {arch} {shape_name}: terms {terms}")
        want = {"rmsnorm", "flash_attention"}  # every cell has norms and attention
        if rec["mode"] == "train":
            want |= {"rmsnorm_backward", "flash_attention_backward"}
        if not want <= set(kernels):
            failures.append(f"(b) {arch} {shape_name}: meta-route calls {kernels}")
        cells.append(row)
        print(f"dryrun {arch} {shape_name} {row['mesh']}: {row['mem_per_device_bytes'] / 2**30:.2f}"
              f" GiB a rank of {total / 2**30:.1f} GiB; compute {r['compute_s']:.4g} s, memory"
              f" {r['memory_s']:.4g} s, collective {r['collective_s']:.4g} s"
              f" ({r['bottleneck']}); counted in {rec['count_s']} s [{card}]", flush=True)
    launches = launch_counts()
    if any(launches.values()):
        failures.append(f"the dry run launched kernels: {launches}")
    emit("dryrun", card=card, total_memory_bytes=total, train_1x1=a, cells=cells,
         launches=launches, failures=failures)
    if failures:
        raise AssertionError("dryrun: " + "; ".join(failures))


def phase_oneshot() -> dict:
    """6c: the one-shot prefill, decode and encoder steps, (a) to (c);
    returns (a)'s launches (``"oneshot"``) and rank 0's of each (c) case."""
    failures: list = []
    fields: dict = {}
    try:  # what ran is printed before a failure ends the phase
        fields["single"], counts = _oneshot_single(failures)
        fields["encoder"] = _oneshot_encoder(failures)
        fields["mesh"], mesh_counts = _oneshot_mesh(failures)
    finally:
        emit("oneshot", **fields, failures=failures, card=_card())
    if failures:
        raise AssertionError("oneshot: " + "; ".join(failures))
    return {"oneshot": counts, **mesh_counts}


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _kernel_group(key: str) -> str:
    k = key.lower()
    if "flash_fwd" in k:
        return "flash attention forward (K2)"
    if "flash_bwd" in k:
        return "flash attention backward (K2)"
    if "paged_decode" in k or "paged_prefill" in k:
        return "paged attention (K3/K4)"
    if "rmsnorm_bwd" in k:
        return "rmsnorm backward row pass (K1)"
    if "rmsnorm_dscale" in k:
        return "rmsnorm backward combine (K1)"
    if "rmsnorm_fwd" in k:
        return "rmsnorm (K1)"
    if any(t in k for t in ("gemm", "gemv", "cutlass", "sm90_", "nvjet", "cublas")):
        return "matmul"
    if "memcpy" in k or "memset" in k:
        return "copies"
    return "other elementwise/index"


def _device_events(prof):
    """Device-side events only: a CPU op's self device time repeats the
    time of the kernels it launched, which are listed on their own, and so
    does a scheduled profiler's ``ProfilerStep#`` annotation."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep")]


def _groups(events) -> dict:
    groups: dict = {}
    for e in events:
        g = groups.setdefault(_kernel_group(e.key), [0.0, 0])
        g[0] += e.self_device_time_total / 1e3
        g[1] += e.count
    return {k: [round(v[0], 3), v[1]] for k, v in groups.items()}


def phase_profile_train(cfg, state, data):
    """Two training steps under ``torch.profiler`` (after one unprofiled):
    device busy time over wall time, and where it goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train.train import TrainConfig, make_train_step

    step_fn = make_train_step(cfg, TrainConfig(total_steps=TRAIN_STEPS))
    state, m = step_fn(state, data.batch_at(0))
    float(m["loss"])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in (1, 2):
            state, m = step_fn(state, data.batch_at(i))
        float(m["loss"])
        wall = time.perf_counter() - t0
    events = _device_events(prof)
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    emit("profile_train", steps=2, wall_s=wall, device_busy_ms=busy_us / 1e3,
         device_busy_share=busy_us / 1e6 / wall, groups_ms_count=_groups(events),
         top_kernels=[[e.key[:90], round(e.self_device_time_total / 1e3, 3), e.count]
                      for e in top])


# ---------------------------------------------------------------------------
# phase 7: the report side: tracer and null collectors, the talp CLI
# ---------------------------------------------------------------------------


def _traced(fn):
    """``fn()`` under ``tracemalloc``: (result, seconds, peak Python bytes)."""
    tracemalloc.start()
    try:
        t0 = time.perf_counter()
        out = fn()
        seconds = time.perf_counter() - t0
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    return out, seconds, peak


def _talp_cli(*args) -> dict:
    """``python -m repro_torch.core.pages *args`` from the repository root."""
    env = {**os.environ, "PYTHONPATH": "src"}
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "repro_torch.core.pages", *args], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=600)
    return {"rc": p.returncode, "seconds": time.perf_counter() - t0,
            "stdout": p.stdout[-4000:], "stderr": p.stderr[-4000:]}


def _html_parallel_efficiency(page: str, experiment: str, region: str) -> str | None:
    """The Parallel efficiency cell of ``experiment``'s ``region`` table in
    the report's index.html, as printed (2 decimals)."""
    for section in page.split("<h2>Experiment: ")[1:]:
        if not section.startswith(experiment + "</h2>"):
            continue
        table = section.partition(f"region <code>{region}</code></h3>")[2].partition("</table>")[0]
        m = re.search(r"Parallel efficiency</td><td class='[a-z]*'>([^<]+)</td>", table)
        return m.group(1) if m else None
    return None


def phase_report():
    """Phase 6's configuration again, REPORT_STEPS steps under the tracer
    (record in ``results/talp/<arch>/train_tracer/``) and under the null
    collector (no record), each with exact launch counts; the tracer's
    record held to the monitor's; the ``talp`` CLI over ``results/talp``
    into ``results/talp_site``; and the collectors' costs (paper Tables
    1/2), for information only."""
    import numpy as np
    import torch

    from repro_torch.core.factors import validate_pop
    from repro_torch.core.folder import scan
    from repro_torch.core.records import RunRecord
    from repro_torch.core.scaling import build_table
    from repro_torch.core.tracer import post_process, trace_storage_bytes
    from repro_torch.kernels import launch_counts, reset_launch_counts

    failures = []
    mon_path = os.path.join(ROOT, RESULT["train"]["record"])
    trace_dir = os.path.join(ROOT, "results", "talp_trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    runs = {}
    for backend in ("tracer", "null"):
        cfg, _, loop = _train_loop(backend, REPORT_STEPS)
        if backend == "tracer":
            loop.session.collector.trace_dir = trace_dir
        reset_launch_counts()
        loop.run()
        torch.cuda.synchronize()
        counts = launch_counts()
        want = {k: 0 for k in counts}
        want.update(_train_expected_launches(cfg, REPORT_STEPS, TRAIN_A))
        loop.finalize_run(os.path.join(TALP_DIR, ARCH, f"train_{backend}"))
        secs = [h["seconds"] for h in loop.metrics_history]
        losses = [h["loss"] for h in loop.metrics_history]
        runs[backend] = {"median_step_seconds": float(np.median(secs[1:])),
                         "step_seconds": secs, "losses": losses, "launches": counts,
                         "record": loop.session.last_record_path}
        if not all(np.isfinite(losses)):
            failures.append(f"{backend}: non-finite loss in {losses}")
        if counts != want or min(counts[k] for k in TRAIN_KERNELS) <= 0:
            failures.append(f"{backend}: launches {counts} != expected {want}")
        del loop
        torch.cuda.empty_cache()

    # (b) the cross-tool check: the tracer's record against the monitor's
    mon = RunRecord.load(mon_path)
    tra = RunRecord.load(runs["tracer"]["record"])
    a, b = mon.regions["train_step"], tra.regions["train_step"]
    agreement = {}
    for key in ("useful_flops", "hlo_bytes", "model_flops"):
        va = getattr(a.counters, key) / max(a.measurements.num_steps, 1)
        vb = getattr(b.counters, key) / max(b.measurements.num_steps, 1)
        agreement[key] = [va, vb, abs(va - vb) / max(abs(va), abs(vb), 1e-30)]
        if not agreement[key][2] <= AGREE_TOL or va <= 0:
            failures.append(f"train_step {key} per step: monitor {va} vs tracer {vb}")
    if sorted(mon.regions) != sorted(tra.regions):
        failures.append(f"regions: monitor {sorted(mon.regions)} vs tracer {sorted(tra.regions)}")
    if (a.measurements.num_steps, b.measurements.num_steps) != (TRAIN_STEPS, REPORT_STEPS):
        failures.append(f"num_steps: monitor {a.measurements.num_steps}, "
                        f"tracer {b.measurements.num_steps}")
    pop_errors = {f"{which}/{n}": e for which, run in (("monitor", mon), ("tracer", tra))
                  for n, r in run.regions.items() if (e := validate_pop(r.pop))}
    if pop_errors:
        failures.append(f"POP identities: {pop_errors}")
    if tra.hardware != "h100_sxm":
        failures.append(f"tracer record hardware {tra.hardware!r}")

    # (d) the collectors' costs: post-processing the trace against reading
    # the monitor's record, and the bytes each keeps
    _, pp_s, pp_peak = _traced(lambda: build_table([post_process(trace_dir)], region="train_step"))
    _, mon_s, mon_peak = _traced(lambda: build_table(
        scan(os.path.dirname(mon_path))[0].runs, region="train_step"))

    # (c) the talp CLI over the CI folder
    shutil.rmtree(SITE_DIR, ignore_errors=True)
    cli = {
        "metadata": _talp_cli("metadata", "-i", "results/talp"),
        "ci-report": _talp_cli("ci-report", "-i", "results/talp", "-o", "results/talp_site",
                               "--regions", "train_step", "--print-tables"),
        "validate": _talp_cli("validate", "-i", "results/talp"),
        "badge": _talp_cli("badge", "-i", "results/talp", "-o", "results/talp_site/badge.svg",
                           "--region", "train_step"),
    }
    failures += [f"talp {k}: exit {v['rc']}: {v['stderr'][-400:]}" for k, v in cli.items()
                 if v["rc"] != 0]
    m = re.search(r"(\d+) runs checked, (\d+) violations", cli["validate"]["stdout"])
    # train monitor and tracer, serve monitor (4b), serve spec (4c), serve
    # fault (4d) and serve dense (4e)
    if not m or m.groups() != ("6", "0"):
        failures.append(f"talp validate: {cli['validate']['stdout'][-400:]!r}")
    index = os.path.join(SITE_DIR, "index.html")
    page = open(index).read() if os.path.exists(index) else ""
    for exp in ("train_monitor", "train_tracer", "serve_monitor", "serve_spec", "serve_fault",
                "serve_dense"):
        if f"<h2>Experiment: {ARCH} / {exp}</h2>" not in page:
            failures.append(f"index.html names no experiment {ARCH} / {exp}")
    pe_html = _html_parallel_efficiency(page, f"{ARCH} / train_monitor", "train_step")
    pe_record = f"{a.pop['parallel_efficiency']:.2f}"
    if pe_html != pe_record:
        failures.append(f"index.html train_step parallel efficiency {pe_html} != record's "
                        f"{pe_record}")
    badge_path = os.path.join(SITE_DIR, "badge.svg")
    badge = open(badge_path).read() if os.path.exists(badge_path) else ""
    badge_value = re.search(r">(\d+\.\d\d)</text>", badge)
    if not badge_value:
        failures.append(f"badge holds no number: {badge[-200:]!r}")

    emit("report", arch=ARCH, steps=REPORT_STEPS,
         median_step_seconds={"null": runs["null"]["median_step_seconds"],
                              "monitor": RESULT["train"]["median_step_seconds"],
                              "tracer": runs["tracer"]["median_step_seconds"]},
         step_seconds={k: v["step_seconds"] for k, v in runs.items()},
         launches={k: v["launches"] for k, v in runs.items()},
         trace_bytes=trace_storage_bytes(trace_dir), monitor_record_bytes=os.path.getsize(mon_path),
         tracer_record_bytes=os.path.getsize(runs["tracer"]["record"]),
         post_process_seconds=pp_s, post_process_peak_bytes=pp_peak,
         monitor_scan_table_seconds=mon_s, monitor_scan_table_peak_bytes=mon_peak,
         ci_report_seconds=cli["ci-report"]["seconds"],
         cli={k: {"rc": v["rc"], "seconds": v["seconds"], "stdout": v["stdout"][-600:]}
              for k, v in cli.items()},
         agreement=agreement, parallel_efficiency={"html": pe_html, "record": pe_record},
         badge=badge_value.group(1) if badge_value else None,
         records=[os.path.relpath(p, ROOT) for p in (mon_path, runs["tracer"]["record"])],
         site=os.path.relpath(index, ROOT))
    if failures:
        raise AssertionError("report: " + "; ".join(failures))


# ---------------------------------------------------------------------------
# phase 9: the other dense archs at full width
# ---------------------------------------------------------------------------


def _finite_guard(model):
    """Wrap the model's ``decode_step`` and ``prefill_chunk`` so that a
    non-finite logit sets the returned flag (on the device: no sync). The
    wrappers hold the model: ``_release`` drops them."""
    import torch

    bad = torch.zeros((), dtype=torch.bool, device=DEV)
    for name in ("decode_step", "prefill_chunk"):
        orig = getattr(model, name)

        def checked(*a, _orig=orig, **k):
            out = _orig(*a, **k)
            bad.logical_or_(~torch.isfinite(out).all())
            return out

        setattr(model, name, checked)
    return bad


def _release(*objs) -> None:
    """Drop a phase's model and what holds it: the wrappers ``_finite_guard``
    set on a model and any reference cycle (a scheduler, a loop's session),
    so that the card's memory is free before the next phase draws its
    weights."""
    import gc

    import torch

    for obj in objs:
        for name in ("decode_step", "prefill_chunk"):
            if name in getattr(obj, "__dict__", {}):
                delattr(obj, name)
    del objs
    gc.collect()
    torch.cuda.empty_cache()


def _arch_cfg(arch: str, repeats: int | None = None, dtype: str = "bfloat16"):
    from repro_torch.configs import get_config

    cfg = get_config(arch).replace(param_dtype_name=dtype, compute_dtype_name=dtype)
    return cfg if repeats is None else cfg.replace(repeats=repeats)


def _card_model(cfg, seed: int, fan_in: bool = False):
    """Seeded weights drawn on the card (``torch.Generator(device="cuda")``:
    no CPU twin needs them, and a large model's weights never cross the
    host), with the draw's seconds; ``fan_in``: ``_fan_in_`` after the
    draw."""
    import torch

    from repro_torch.models.transformer import Transformer

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = Transformer.from_init(cfg, seed=seed, device=DEV, draw_device="cuda")
    if fan_in:
        _fan_in_(model)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def _fan_in_(model) -> None:
    """Rescale, in place, every stacked leaf that the initializer draws at
    its default scale, 1/sqrt of its leading axis (the repeat count: the
    reference behaviour, ROADMAP.md Queue 3), to 1/sqrt of its per-layer
    fan-in (its second axis), as a per-layer draw would be. Phase 11's
    weights."""
    import torch

    from repro_torch.layers.common import tree_leaves
    from repro_torch.models.transformer import model_params

    specs = dict(tree_leaves(model_params(model.cfg)))
    with torch.no_grad():
        for path, p in model.named_params().items():
            s = specs[path]
            if path.startswith("slots/") and s.init == "normal" and s.scale is None:
                p.mul_((s.shape[0] / s.shape[1]) ** 0.5)


def _serve_run(model, cfg, reqs, label: str, failures: list, max_len: int,
               warm_first: bool = False, preempt_at: int | None = None, **kw) -> dict:
    """``reqs`` [(id, prompt, max_new)] through ``BatchScheduler`` (batch 4,
    page 16, chunk 64, overlap; ``kw`` on top), launch counters zeroed
    before and read after: every request completes with its tokens, in
    the padded vocab (greedy takes its argmax over it), launches exact
    (``_serve_launches``: per layer and norm, the two-pass verify with
    recurrent state), no page left in use beside the prefix trie's. Gates
    append to ``failures``. ``warm_first``: request 0
    completes before the others are submitted; ``preempt_at``: after that
    many ticks every decoding slot is preempted (its request resumes
    later, replaying its history)."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.serve import BatchScheduler, ServeConfig

    sched = BatchScheduler(model, ServeConfig(**{**dict(
        max_len=max_len, batch=4, prefill_chunk=64, overlap=True, page_size=16), **kw}))
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, (rid, prompt, max_new) in enumerate(reqs):
        sched.submit(prompt, request_id=rid, max_new=max_new)
        if warm_first and i == 0:
            sched.drain()
    if preempt_at is not None:
        for _ in range(preempt_at):
            sched.step()
        for slot in range(sched.scfg.batch):
            if sched.active[slot] is not None:
                sched._preempt(slot)
    sched.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, want = launch_counts(), _serve_launches(cfg, sched.stats)
    kv = sched.kv_cache_stats()
    toks = {r["id"]: r["generated"] for r in sched.completed}
    ttft = sorted(r["t_first_token"] - r["t_submit"] for r in sched.completed)
    n_tok = sum(len(t) for t in toks.values())
    out = {"wall_s": wall, "tokens": n_tok, "tokens_per_s": n_tok / wall,
           "ticks": sched.stats["ticks"], "decode_steps": sched.stats["decode_steps"],
           "prefill_chunks": sched.stats["prefill_chunks"],
           "launches": counts, "expected_launches": want, "pressure": kv["pressure"],
           "speculation": kv["speculation"], "prefix_cache": kv.get("prefix_cache"),
           "peak_used_pages": kv["peak_used_pages"], "kv_bytes": kv["kv_bytes"],
           "ttft_deferred_s": {"p50": ttft[len(ttft) // 2], "max": ttft[-1]} if ttft else None,
           "generated": toks}
    if counts != want:
        failures.append(f"{label}: launches {counts} != expected {want}")
    held = kv["pages_in_use"] - (kv["prefix_cache"]["trie_pages"] if "prefix_cache" in kv else 0)
    if held or sorted(toks) != sorted(r[0] for r in reqs) or any(
            len(toks[rid]) != n for rid, _, n in reqs):
        failures.append(f"{label}: {len(toks)} of {len(reqs)} completed, "
                        f"{held} pages in use beside the trie's")
    if any(not 0 <= t < cfg.vocab_padded for g in toks.values() for t in g):
        failures.append(f"{label}: token id out of range")
    return out


def phase_arch_serve(arch: str, repeats, max_len: int, prompt_lens, max_new: int,
                     seed: int) -> dict:
    """``_serve_run`` (batch 4, page 16, chunk 64, overlap) at full width in
    bf16 on seeded card weights: every request completes with ``max_new``
    tokens in the vocab, finite logits, launches exact (K3 one per layer a
    decode step, K4 one per layer a chunk, K1 nL+1 a forward, n the norms
    of a layer). For an MoE arch also one decode step's time on a fresh
    pool at the trace's positions (events, after two warm-up steps) beside
    the bound of reading every expert's weights once, and the kernels and
    copies a step puts on the card (``torch.profiler``)."""
    import numpy as np
    import torch

    cfg = _arch_cfg(arch, repeats)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, init_s = _card_model(cfg, seed)
    bad = _finite_guard(model)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(4, cfg.vocab, size=int(n)).tolist() for n in prompt_lens]
    phase = f"serve_{arch}"
    failures: list = []
    run = _serve_run(model, cfg, [(rid, p, max_new) for rid, p in enumerate(prompts)], phase,
                     failures, max_len)
    counts = run["launches"]
    moe = _moe_decode(model, cfg, [len(p) for p in prompts], max_len) if cfg.moe else {}
    # every prompt runs past the window: each local layer's K4 launch from
    # the first chunk past it, and each K3 launch, leaves keys out
    emit(phase, arch=arch, dtype="bfloat16", layers=cfg.n_layers,
         full_layers=_arch_cfg(arch).n_layers, params=cfg.param_count(),
         weights_drawn_on="cuda", init_seconds=round(init_s, 3), window=cfg.window, batch=4,
         max_len=max_len, page=16, chunk=64, prompt_lens=[len(p) for p in prompts],
         max_new=max_new, completed=len(run["generated"]),
         **{k: run[k] for k in ("ticks", "decode_steps", "prefill_chunks", "launches",
                                "expected_launches", "tokens_per_s", "wall_s",
                                "ttft_deferred_s", "kv_bytes", "peak_used_pages")},
         peak_mem_bytes=torch.cuda.max_memory_allocated(), **moe)
    if cfg.window and min(len(p) for p in prompts) <= cfg.window:
        failures.append(f"a prompt within the window {cfg.window}: the local layers' K3/K4 "
                        f"launches must cut keys")
    if bool(bad):
        failures.append("non-finite logits")
    if min(counts[k] for k in _path_kernels(cfg, SERVE_KERNELS)) <= 0:
        failures.append(f"a kernel of the path not launched: {counts}")
    if failures:
        raise AssertionError(f"{phase}: " + "; ".join(failures))
    _release(model)
    return counts


def _path_kernels(cfg, kernels) -> tuple:
    """The kernels of ``kernels`` a path of ``cfg`` must launch: an arch
    with no attention layer (xlstm-350m) launches K1 alone."""
    return kernels if _attn_layers(cfg) else tuple(k for k in kernels if "rmsnorm" in k)


class FrameStream:
    """hubert-xlarge's training batches: frame embeddings (1, B, S, d) bf16,
    N(0, 1) from a generator seeded per step, and targets drawn in the
    vocab. The JAX package has no audio stream (its launcher feeds token
    batches, which the audio model cannot embed), so this stands in, as
    ``tests/test_arch_smoke.py``'s frame batch does there."""

    def __init__(self, batch: int, seq_len: int, d_model: int, vocab: int, seed: int = 0):
        self.shape, self.d, self.vocab, self.seed = (1, batch, seq_len), d_model, vocab, seed

    def batch_at(self, step: int) -> dict:
        import torch

        g = torch.Generator().manual_seed(self.seed * 100_003 + step)
        return {"frontend": torch.randn(self.shape + (self.d,), generator=g).to(torch.bfloat16),
                "labels": torch.randint(0, self.vocab, self.shape, generator=g,
                                        dtype=torch.int32)}


def phase_arch_train(arch: str, repeats, data, steps: int, seed: int, backend: str = "null",
                     record_dir: str | None = None, fan_in: bool = False) -> dict:
    """``TrainLoop`` at full width in bf16 (remat full, AdamW with fp32
    master) from seeded card weights: losses finite, launches exact; with
    ``record_dir`` the monitor's run record there, its POP factors valid."""
    import numpy as np
    import torch

    from repro_torch.core.factors import validate_pop
    from repro_torch.core.records import RunRecord
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.flops import train_step_model_flops
    from repro_torch.optim import adamw_init
    from repro_torch.train.loop import LoopConfig, TrainLoop
    from repro_torch.train.train import TrainConfig, TrainState

    cfg = _arch_cfg(arch, repeats)
    tcfg = TrainConfig(total_steps=steps)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, init_s = _card_model(cfg, seed, fan_in)
    state = TrainState(model, adamw_init(model.named_params(), tcfg.optimizer), 0)
    loop = TrainLoop(cfg, tcfg, data, LoopConfig(steps=steps, lb_sample_every=1,
                                                 monitor_app_name=arch,
                                                 monitor_backend=backend), state=state)
    if loop.session.backend != backend:
        raise AssertionError(f"train {arch}: session backend {loop.session.backend!r}")
    reset_launch_counts()
    loop.run()
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in counts}
    want.update(_train_expected_launches(cfg, steps, 1))
    hist = loop.metrics_history
    losses = [h["loss"] for h in hist]
    secs = [h["seconds"] for h in hist]
    median = float(np.median(secs[1:]))
    shape = tuple(data.batch_at(0)["labels"].shape)
    model_flops = train_step_model_flops(cfg, shape)
    out = dict(arch=arch, dtype="bfloat16", layers=cfg.n_layers,
               full_layers=_arch_cfg(arch).n_layers, params=cfg.param_count(),
               weights_drawn_on="cuda", init_seconds=round(init_s, 3),
               labels_shape=list(shape), frontend="frontend" in data.batch_at(0),
               remat=cfg.remat, steps=steps, losses=losses, step_seconds=secs,
               median_step_seconds=median, tokens_per_s=shape[1] * shape[2] / median,
               model_flops_per_step=model_flops,
               mfu=model_flops / median / PEAK_FLOPS["bfloat16"], peak_mem_bytes=peak,
               launches=counts, expected_launches=want, backend=backend)
    failures = []
    if record_dir:
        loop.finalize_run(record_dir)
        path = loop.session.last_record_path
        loaded = RunRecord.load(path)
        ts = loaded.regions["train_step"]
        pop_errors = {n: validate_pop(r.pop) for n, r in loaded.regions.items()}
        out.update(record=os.path.relpath(path, ROOT), hardware=loaded.hardware,
                   regions=sorted(loaded.regions), num_steps=ts.measurements.num_steps,
                   dispatch_efficiency=ts.pop.get("dispatch_efficiency"),
                   pop_errors=pop_errors)
        if any(pop_errors.values()) or ts.measurements.num_steps != steps:
            failures.append(f"record {path}: POP {pop_errors}, {ts.measurements.num_steps} steps")
        if loaded.hardware != "h100_sxm":
            failures.append(f"record hardware {loaded.hardware!r}")
    emit(f"train_{arch}", **out)
    if not all(np.isfinite(losses)):
        failures.append(f"non-finite loss in {losses}")
    if counts != want or min(counts[k] for k in _path_kernels(cfg, TRAIN_KERNELS)) <= 0:
        failures.append(f"launches {counts} != expected {want}")
    if failures:
        raise AssertionError(f"train {arch}: " + "; ".join(failures))
    del loop, state, model
    _release()
    return counts


def _chunked_run(model, prompt, page: int, chunk: int, toks=None):
    """``prompt`` (1, n) through ``prefill_chunk`` in chunks of ``chunk``
    (the logits at each chunk's last position), then DECODE_STEPS
    ``decode_step``s fed ``toks`` or the run's own greedy tokens. Returns
    the logits on the CPU in float64 (chunks + DECODE_STEPS, V) and the fed
    tokens."""
    import torch

    dev, n = model.device, prompt.shape[1]
    nL = -(-(n + DECODE_STEPS) // page)
    caches = model.init_cache(1, nL * page, page_size=page, num_pages=nL)
    tb = torch.arange(nL, dtype=torch.int32, device=dev)[None]
    rows = []
    for s in range(0, n, chunk):
        part = torch.from_numpy(prompt[:, s:s + chunk]).to(dev)
        rows.append(model.prefill_chunk(part, caches, s, part.shape[1], tb).double().cpu())
    fed = []
    for i in range(DECODE_STEPS):
        fed.append(int(rows[-1][-1].argmax()) if toks is None else toks[i])
        rows.append(model.decode_step(
            torch.tensor([[fed[-1]]], dtype=torch.int32).to(dev),
            torch.tensor([n + i], dtype=torch.int32).to(dev), caches,
            block_tables=tb).double().cpu())
    return torch.cat(rows), fed


def phase_arch_parity(arch: str, repeats: int, prompt_len: int, seed: int,
                      bias_std: float = 0.0, fan_in: bool = False, window=None) -> None:
    """Full width, fp32, ``repeats`` repeats of the pattern: weights drawn on
    the CPU (qkv biases, where the arch has them, redrawn as N(0,
    ``bias_std``): the initializer zeroes them), a ``prompt_len``-token
    prefill in chunks of 64 and DECODE_STEPS decode steps on the card
    (kernels) and on the CPU (plain versions). Gates as phase 3's: logits
    within LOGIT_TOL, greedy tokens equal wherever the CPU's top-2 gap
    exceeds it, and the card's RMS logit error against a float64 CPU run
    of the same weights within EXACT_RATIO times the CPU fp32 run's. For an
    MoE arch the routing decisions that differ between the card and the
    CPU are counted, and each must lie at a CPU near tie (its K-th and
    (K+1)-th router logits within ROUTE_TIE)."""
    import numpy as np
    import torch

    from repro_torch.layers.common import tree_map
    from repro_torch.models.transformer import Transformer

    cfg = _arch_cfg(arch, repeats, "float32")
    if window:
        cfg = cfg.replace(window=window)
    routed = _routing_recorded if cfg.moe else (lambda: contextlib.nullcontext([]))
    t0 = time.perf_counter()
    # drawn on the card and copied to the host: a CPU draw of the large
    # embeddings took 5-13 s
    cpu = Transformer.from_init(cfg, seed=seed, device="cpu", draw_device="cuda")
    if fan_in:
        _fan_in_(cpu)
    if bias_std:
        g = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            for path, p in cpu.named_params().items():
                if path.rsplit("/", 1)[-1] in ("bq", "bk", "bv"):
                    p.copy_(bias_std * torch.randn(p.shape, generator=g))
    init_s = time.perf_counter() - t0
    page, chunk = 16, 64
    prompt = np.random.default_rng(seed).integers(4, cfg.vocab, size=(1, prompt_len))
    prompt = prompt.astype(np.int32)
    t0 = time.perf_counter()
    with routed() as cpu_routes:
        ref, toks = _chunked_run(cpu, prompt, page, chunk)
    cpu_s = time.perf_counter() - t0
    cfg64 = cfg.replace(param_dtype_name="float64", compute_dtype_name="float64")
    exact_model = Transformer(cfg64, tree_map(lambda t: t.double(), cpu.params()), "cpu")
    exact, _ = _chunked_run(exact_model, prompt, page, chunk, toks)
    del exact_model
    gpu = Transformer(cfg, cpu.params(), device=DEV)
    t0 = time.perf_counter()
    with routed() as card_routes:
        got, _ = _chunked_run(gpu, prompt, page, chunk, toks)
    card_s = time.perf_counter() - t0
    routing = _routing_flips(card_routes, cpu_routes, cfg.moe.top_k) if cfg.moe else {}
    err = float((got - ref).abs().max())
    top2 = ref.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > LOGIT_TOL
    ok_tokens = bool((got.argmax(-1) == ref.argmax(-1))[decided].all())
    finite = bool(torch.isfinite(got).all())

    def rms_rel(a) -> float:
        return float((a - exact).pow(2).mean().sqrt() / exact.pow(2).mean().sqrt())

    card_rms, cpu_rms = rms_rel(got), rms_rel(ref)
    n_chunks = -(-prompt_len // chunk)
    emit(f"parity_{arch}", arch=arch, dtype="float32", layers=cfg.n_layers,
         pattern=list(cfg.pattern), params=cfg.param_count(), window=cfg.window,
         attn_bias=cfg.attn_bias, bias_std=bias_std, fan_in=fan_in, prompt_len=prompt_len,
         chunk=chunk,
         chunks=n_chunks, decode_steps=DECODE_STEPS,
         tolerance={"card_vs_cpu": LOGIT_TOL, "card_over_cpu_rms_vs_float64": EXACT_RATIO},
         max_abs_err=err, prefill_max_abs_err=float((got - ref)[:n_chunks].abs().max()),
         decode_max_abs_err=float((got - ref)[n_chunks:].abs().max()),
         card_rms_rel_vs_float64=card_rms, cpu_rms_rel_vs_float64=cpu_rms,
         card_over_cpu_rms_vs_float64=card_rms / cpu_rms,
         logit_absmax=float(exact.abs().max()), positions_decided=int(decided.sum()),
         greedy_equal_where_gap_exceeds_tol=ok_tokens, init_seconds=round(init_s, 3),
         cpu_seconds=round(cpu_s, 3), card_seconds=round(card_s, 3),
         **({"routing": dict(routing, tie_tolerance=ROUTE_TIE)} if routing else {}))
    if not (finite and err <= LOGIT_TOL and ok_tokens):
        raise AssertionError(f"parity {arch}: card vs CPU logits err {err} (tol {LOGIT_TOL}), "
                             f"finite {finite}, greedy equal {ok_tokens}")
    if card_rms > EXACT_RATIO * cpu_rms:
        raise AssertionError(f"parity {arch}: card's RMS logit error against float64 "
                             f"{card_rms}, more than {EXACT_RATIO}x the CPU's ({cpu_rms})")
    if routing and not all(g <= ROUTE_TIE for g in routing["flip_cpu_gaps"]):
        raise AssertionError(f"parity {arch}: routing flips away from a near tie: {routing}")
    del cpu, gpu
    _release()


def phase_archs() -> dict:
    """The other dense archs at full width (ARCH_PATHS' cuts): gemma2-2b's
    serving, training and fp32 parity, the slice's main path; glm4-9b's
    serving and fp32 parity with non-zero qkv biases; command-r-35b's and
    llava-next-mistral-7b's serving; llava's training with the vlm stub and
    hubert-xlarge's on frame batches. Returns each path's launch counts."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    counts = {}
    g = ARCH_PATHS["gemma2-2b"]
    counts["gemma2_serve"] = phase_arch_serve("gemma2-2b", g["serve_repeats"], g["max_len"],
                                              g["prompt_lens"], g["max_new"], seed=51)
    record_dir = os.path.join(ROOT, ARCH_TALP_DIR, "gemma2-2b", "train_monitor")
    shutil.rmtree(os.path.join(ROOT, ARCH_TALP_DIR), ignore_errors=True)
    cfg = _arch_cfg("gemma2-2b")
    data = SyntheticLM(DataConfig(global_batch=g["train_batch"], seq_len=g["train_seq"],
                                  vocab=cfg.vocab, pad_fraction=0.05))
    counts["gemma2_train"] = phase_arch_train("gemma2-2b", None, data, g["train_steps"],
                                              seed=52, backend="monitor",
                                              record_dir=record_dir)
    cli = _talp_cli("validate", "-i", ARCH_TALP_DIR)
    m = re.search(r"(\d+) runs checked, (\d+) violations", cli["stdout"])
    RESULT["train_gemma2-2b"]["talp_validate"] = cli
    if cli["rc"] != 0 or not m or m.groups() != ("1", "0"):
        raise AssertionError(f"talp validate {ARCH_TALP_DIR}: {cli}")
    phase_arch_parity("gemma2-2b", g["parity_repeats"], g["parity_prompt"], seed=53,
                      window=g["parity_window"])
    gl = ARCH_PATHS["glm4-9b"]
    counts["glm4_serve"] = phase_arch_serve("glm4-9b", gl["repeats"], gl["max_len"],
                                            gl["prompt_lens"], gl["max_new"], seed=54)
    phase_arch_parity("glm4-9b", gl["parity_repeats"], gl["parity_prompt"], seed=55,
                      bias_std=gl["parity_bias_std"])
    c = ARCH_PATHS["command-r-35b"]
    counts["command_r_serve"] = phase_arch_serve("command-r-35b", c["repeats"], c["max_len"],
                                                 c["prompt_lens"], c["max_new"], seed=56)
    lv = ARCH_PATHS["llava-next-mistral-7b"]
    counts["llava_serve"] = phase_arch_serve("llava-next-mistral-7b", lv["repeats"], lv["max_len"],
                                             lv["prompt_lens"], lv["max_new"], seed=57)
    cfg = _arch_cfg("llava-next-mistral-7b")
    data = SyntheticLM(DataConfig(global_batch=lv["train_batch"], seq_len=lv["train_seq"],
                                  vocab=cfg.vocab, pad_fraction=0.05,
                                  frontend_tokens=cfg.n_frontend_tokens, d_model=cfg.d_model))
    counts["llava_train"] = phase_arch_train("llava-next-mistral-7b", lv["train_repeats"], data,
                                             lv["train_steps"], seed=58)
    h = ARCH_PATHS["hubert-xlarge"]
    cfg = _arch_cfg("hubert-xlarge")
    data = FrameStream(h["train_batch"], h["train_seq"], cfg.d_model, cfg.vocab, seed=59)
    counts["hubert_train"] = phase_arch_train("hubert-xlarge", None, data, h["train_steps"],
                                              seed=59)
    return counts


def phase_moe_train(arch: str, repeats: int, batch: int, seq: int, steps: int,
                    seed: int) -> dict:
    """The train step at full width in bf16 (remat full, AdamW with fp32
    master) on seeded card weights, through a session opened by
    ``repro_torch.start(..., backend="monitor")`` and ``wrap_step``, as a
    user integrates it: losses finite, launches exact, the record in
    ``MOE_TALP_DIR`` passing ``validate_pop`` and the ``talp validate``
    CLI, its ``expert_load_balance`` in (0, 1] and not the default 1.0."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.core.factors import validate_pop
    from repro_torch.core.records import ResourceConfig, RunRecord
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.flops import train_step_model_flops
    from repro_torch.optim import adamw_init
    from repro_torch.train.train import TrainConfig, TrainState, make_train_step

    cfg = _arch_cfg(arch, repeats)
    tcfg = TrainConfig(total_steps=steps)
    data = SyntheticLM(DataConfig(global_batch=batch, seq_len=seq, vocab=cfg.vocab,
                                  pad_fraction=0.05))
    shape = tuple(data.batch_at(0)["labels"].shape)
    record_dir = os.path.join(ROOT, MOE_TALP_DIR, arch, "train_monitor")
    shutil.rmtree(os.path.join(ROOT, MOE_TALP_DIR), ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, init_s = _card_model(cfg, seed)
    state = TrainState(model, adamw_init(model.named_params(), tcfg.optimizer), 0)
    session = repro_torch.start(arch, backend="monitor", lb_sample_every=1,
                                resources=ResourceConfig(num_hosts=1, devices_per_host=1,
                                                         mesh={"data": 1, "model": 1},
                                                         num_pods=1))
    if session.backend != "monitor":
        raise AssertionError(f"train {arch}: session backend {session.backend!r}")
    step = session.wrap_step(make_train_step(cfg, tcfg), region="train_step", derive=True,
                             model_flops=train_step_model_flops(cfg, shape))
    reset_launch_counts()
    losses, secs, loads = [], [], []
    with session:
        for i in range(steps):
            t0 = time.perf_counter()
            state, metrics = step(state, data.batch_at(i))
            losses.append(float(metrics["loss"]))
            secs.append(time.perf_counter() - t0)
            loads.append(metrics["expert_load"].tolist())
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    session.finalize(record_dir)
    path = session.last_record_path
    loaded = RunRecord.load(path)
    ts = loaded.regions["train_step"]
    pop_errors = {n: validate_pop(r.pop) for n, r in loaded.regions.items()}
    cli = _talp_cli("validate", "-i", MOE_TALP_DIR)
    m = re.search(r"(\d+) runs checked, (\d+) violations", cli["stdout"])
    want = {k: 0 for k in counts}
    want.update(_train_expected_launches(cfg, steps, 1))
    median = float(np.median(secs[1:]))
    model_flops = train_step_model_flops(cfg, shape)
    factor = ts.pop.get("expert_load_balance")
    emit(f"train_{arch}", arch=arch, dtype="bfloat16", layers=cfg.n_layers,
         full_layers=_arch_cfg(arch).n_layers, params=cfg.param_count(),
         active_params=cfg.active_param_count(), weights_drawn_on="cuda",
         init_seconds=round(init_s, 3), labels_shape=list(shape), remat=cfg.remat,
         session="repro_torch.start(backend='monitor')", steps=steps, losses=losses,
         step_seconds=secs, median_step_seconds=median, tokens_per_s=shape[1] * shape[2] / median,
         model_flops_per_step=model_flops, mfu=model_flops / median / PEAK_FLOPS["bfloat16"],
         peak_mem_bytes=peak, card_bytes=torch.cuda.get_device_properties(0).total_memory,
         expert_load_per_step=loads, expert_lb=ts.measurements.expert_lb,
         expert_load_balance=factor, launches=counts, expected_launches=want,
         record=os.path.relpath(path, ROOT), regions=sorted(loaded.regions),
         num_steps=ts.measurements.num_steps, pop_errors=pop_errors, talp_validate=cli)
    failures = []
    if not all(np.isfinite(losses)):
        failures.append(f"non-finite loss in {losses}")
    if counts != want or min(counts[k] for k in TRAIN_KERNELS) <= 0:
        failures.append(f"launches {counts} != expected {want}")
    if any(pop_errors.values()) or ts.measurements.num_steps != steps:
        failures.append(f"record {path}: POP {pop_errors}, {ts.measurements.num_steps} steps")
    if cli["rc"] != 0 or not m or m.groups() != ("1", "0"):
        failures.append(f"talp validate {MOE_TALP_DIR}: {cli}")
    if factor is None or not 0.0 < factor <= 1.0 or factor == 1.0:
        failures.append(f"expert_load_balance {factor}: not in (0, 1) from the router")
    if failures:
        raise AssertionError(f"train {arch}: " + "; ".join(failures))
    del step, session, state, model
    _release()
    return counts


def phase_moe() -> dict:
    """The MoE archs at full width (MOE_PATHS' cuts): qwen3-moe-30b-a3b's
    serving at 24 of 48 layers, training in a ``repro_torch.start`` session and
    fp32 parity with its routing flips counted; dbrx-132b's serving (G 6).
    Runs after every earlier model is freed. Returns each path's launch
    counts."""
    import torch

    _release()
    counts = {}
    q = MOE_PATHS["qwen3-moe-30b-a3b"]
    RESULT["moe_allocated_before_bytes"] = torch.cuda.memory_allocated()
    counts["qwen3_serve"] = phase_arch_serve("qwen3-moe-30b-a3b", q["repeats"], q["max_len"],
                                             q["prompt_lens"], q["max_new"], seed=71)
    d = MOE_PATHS["dbrx-132b"]
    counts["dbrx_serve"] = phase_arch_serve("dbrx-132b", d["repeats"], d["max_len"],
                                            d["prompt_lens"], d["max_new"], seed=72)
    counts["qwen3_train"] = phase_moe_train("qwen3-moe-30b-a3b", q["train_repeats"],
                                            q["train_batch"], q["train_seq"],
                                            q["train_steps"], seed=73)
    phase_arch_parity("qwen3-moe-30b-a3b", q["parity_repeats"], q["parity_prompt"], seed=74)
    return counts


def _moe_decode(model, cfg, lens, max_len: int, warmup: int = 2, iters: int = 5) -> dict:
    """One decode step of batch 4 at positions ``lens`` on a fresh paged
    pool (CUDA events, after ``warmup`` steps), beside the bound of its
    expert weights read once: the JAX formulation multiplies every
    expert's capacity buffer, so a decode step reads all E experts of
    every layer however few tokens it routes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    m, B, page = cfg.moe, len(lens), 16
    nL = max_len // page
    caches = model.init_cache(B, max_len, page_size=page)
    tb = torch.arange(B * nL, dtype=torch.int32, device=DEV).reshape(B, nL)
    pos = torch.tensor(lens, dtype=torch.int32, device=DEV)
    toks = torch.full((B, 1), 7, dtype=torch.int32, device=DEV)
    for _ in range(warmup):
        model.decode_step(toks, pos, caches, block_tables=tb)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        model.decode_step(toks, pos, caches, block_tables=tb)
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        model.decode_step(toks, pos, caches, block_tables=tb)
        torch.cuda.synchronize()
    kernels = sum(e.count for e in _device_events(prof))
    n_moe = sum(k == "moe" for k in cfg.pattern) * cfg.repeats
    nbytes = n_moe * (3 if m.gated else 2) * m.n_experts * cfg.d_model * m.d_ff * 2
    del caches
    return dict(experts=m.n_experts, top_k=m.top_k, capacity_decode=m.capacity(B),
                decode_step_ms=start.elapsed_time(end) / iters,
                decode_step_kernels=kernels,
                expert_weight_bytes_per_step=nbytes,
                expert_read_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)


@contextlib.contextmanager
def _routing_recorded():
    """Within the block, ``layers.ffn.router_topk`` (looked up by name on
    each call) keeps each call's router logits (float64, CPU) and chosen
    experts in the list it yields."""
    from repro_torch.layers import ffn as FFN

    calls, inner = [], FFN.router_topk

    def recording(logits, k, normalize):
        w, e = inner(logits, k, normalize)
        calls.append((logits.detach().double().cpu(), e.cpu()))
        return w, e

    FFN.router_topk = recording
    try:
        yield calls
    finally:
        FFN.router_topk = inner


def _routing_flips(card: list, cpu: list, k: int) -> dict:
    """Routing decisions (a token's set of K experts in one layer of one
    forward) that differ between the card and the CPU, and each one's CPU
    gap between its K-th and (K+1)-th router logit."""
    import torch

    if len(card) != len(cpu):
        raise AssertionError(f"routing: {len(card)} router calls on the card, {len(cpu)} on "
                             f"the CPU")
    gaps, n = [], 0
    for (_, e_card), (logits, e_cpu) in zip(card, cpu):
        differ = (e_card.sort(-1).values != e_cpu.sort(-1).values).any(-1)
        n += int(differ.numel())
        top = logits.sort(-1, descending=True).values
        gaps += (top[:, k - 1] - top[:, k])[differ].tolist()
    return {"decisions": n, "flips": len(gaps), "flip_cpu_gaps": gaps}


# ---------------------------------------------------------------------------
# phase 11: the recurrent and hybrid archs at full width
# ---------------------------------------------------------------------------


def _spec_gates(run: dict, label: str, failures: list) -> None:
    """A speculating ``_serve_run`` whose decoding requests were preempted:
    verifies dispatched, requests resumed, and no K3 launch (every decode
    step is a verify through K4)."""
    sp, k3 = run["speculation"], run["launches"]["paged_attention"]
    if not (sp["verify_dispatches"] > 0 and run["pressure"]["resumes"] > 0 and k3 == 0):
        failures.append(f"{label}: {sp}, {run['pressure']}, K3 {k3}")


def _fp32_witness(model, prompts: dict, base: dict, other: dict) -> list:
    """Where two greedy runs of a bf16 ``model`` part (``base``'s and
    ``other``'s tokens of each request), the logits after their common
    history from the model and from an fp32 copy of its weights: at the
    first differing position, the bf16 top-2 gap, the fp32 logit of
    ``base``'s token less that of ``other``'s (``fp32_gap``) and the bf16
    logits' largest distance from the fp32 ones (``bf16_err``). Rounding
    explains a parting where the fp32 run tells the two tokens apart by no
    more than twice that distance."""
    import torch

    from repro_torch.layers.common import tree_map
    from repro_torch.models.transformer import Transformer

    cfg32 = model.cfg.replace(param_dtype_name="float32", compute_dtype_name="float32")
    m32 = Transformer(cfg32, tree_map(lambda t: t.float(), model.params()), DEV)
    out = []
    with torch.no_grad():
        for rid, want in base.items():
            got = other[rid]
            i = _first_divergence(got, want)
            if i is None:
                continue
            hist = prompts[rid] + want[:i]
            l16 = _history_logits(model, hist).float()
            l32 = _history_logits(m32, hist).float()
            top = l16.topk(2).values
            out.append({"request": rid, "position": i, "tokens": [want[i], got[i]],
                        "bf16_top2_gap": float(top[0] - top[1]),
                        "fp32_gap": float(l32[want[i]] - l32[got[i]]),
                        "bf16_err": float((l16 - l32).abs().max())})
    del m32
    return out


def phase_zamba2_serve(p: dict, seed: int) -> dict:
    """zamba2-2.7b serving, fan-in weights drawn on the card. At
    ``serve_repeats`` repeats of the pattern (6 layers: 5 mamba2, 1
    attention) in bf16, one model: (a) glm4's
    traffic (launches exact: K3 and K4 on the attention layers, K1 on
    every norm); (b) ``pool_requests`` requests against ``pool_pages``
    pages, which preempts, and against an ample pool: tokens equal but at
    a near tie (``_tie_check``); (c) a shared system prompt with the prefix
    cache on and off: the hybrid rule (pages shared, no prefill token
    skipped: the chunk count equal), tokens equal; (d) greedy speculation
    on the first ``spec_bf16_requests`` of (b)'s requests (every decoding
    one preempted after
    ``spec_preempt_at`` ticks): the drafter finds little in random weights'
    streams, but a resumed request's history replays through verify
    windows of up to ``spec_k`` + 1 tokens, all accepted, so the commit
    pass advances the state over several tokens at once; launches exact
    for the two-pass verify (no K3, two forwards' K4 and K1 a verify). In
    bf16 the verify's chunked recurrences and K4 round apart from the
    decode step's recurrent form and K3, and requests part from (b)'s
    ample run beyond a near tie; each parting is held to the fp32 witness
    (``_fp32_witness``). (e) the same at ``spec_repeats`` repeats of the
    pattern in fp32 on all of (b)'s requests: tokens equal the plain run's
    but at a near tie; (f)
    the copy regime (every layer zeroed, a prompt on a short cycle of the
    successor map): spec on and off equal, drafts accepted. Returns the
    launch counts of (a) and of (e)."""
    import numpy as np
    import torch

    arch = "zamba2-2.7b"
    cfg = _arch_cfg(arch, p["serve_repeats"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, init_s = _card_model(cfg, seed, fan_in=True)
    bad = _finite_guard(model)
    rng = np.random.default_rng(seed)
    failures: list = []
    out: dict = {}
    draw = lambda n: rng.integers(4, cfg.vocab, size=int(n)).tolist()  # noqa: E731
    max_len = p["max_len"]
    # (a) glm4's traffic
    main = [(i, draw(n), p["max_new"]) for i, n in enumerate(p["prompt_lens"])]
    out["traffic"] = _serve_run(model, cfg, main, "zamba2 traffic", failures, max_len)
    # (b) a pool that preempts against an ample one
    pool = [(i, draw(n), p["pool_new"])
            for i, n in enumerate(rng.integers(*p["pool_prompt"], size=p["pool_requests"]))]
    prompts = {rid: pr for rid, pr, _ in pool}
    tight = _serve_run(model, cfg, pool, "zamba2 tight pool", failures, max_len,
                           num_pages=p["pool_pages"])
    ample = _serve_run(model, cfg, pool, "zamba2 ample pool", failures, max_len)
    out["pool"] = {"tight": tight, "ample": {k: v for k, v in ample.items() if k != "generated"},
                   "ties": _tie_check(model, prompts, {"tight": tight["generated"],
                                                       "ample": ample["generated"]},
                                      "ample", "zamba2 pool", failures)}
    if tight["pressure"]["preemptions"] <= 0:
        failures.append(f"zamba2 tight pool: no preemption ({tight['pressure']})")
    # (c) the prefix cache's hybrid rule
    system = draw(p["prefix_system"])
    shared = [(i, system + draw(n), p["pool_new"])
              for i, n in enumerate(rng.integers(*p["prefix_tail"], size=p["prefix_requests"]))]
    on = _serve_run(model, cfg, shared, "zamba2 prefix on", failures, max_len,
                        warm_first=True, prefix_cache=True)
    off = _serve_run(model, cfg, shared, "zamba2 prefix off", failures, max_len,
                         warm_first=True)
    pc = on["prefix_cache"]
    out["prefix"] = {"on": on, "off": {k: v for k, v in off.items() if k != "generated"},
                     "ties": _tie_check(model, {rid: pr for rid, pr, _ in shared},
                                        {"on": on["generated"], "off": off["generated"]},
                                        "off", "zamba2 prefix", failures)}
    if not (pc["hits"] == len(shared) - 1 and pc["pages_saved_by_sharing"] > 0
            and pc["prefill_tokens_skipped"] == 0
            and on["prefill_chunks"] == off["prefill_chunks"]):
        failures.append(f"zamba2 prefix: the hybrid rule does not hold: {pc}, chunks "
                        f"{on['prefill_chunks']} vs {off['prefill_chunks']}")
    # (d) speculation in bf16 at serve_repeats, the two-pass verify, every
    # decoding request preempted once, on the first ``spec_bf16_requests``
    # of (b)'s requests against their ample run; where they part, the fp32
    # witness of the same weights
    sub = pool[:p["spec_bf16_requests"]]
    spec16 = _serve_run(model, cfg, sub, "zamba2 bf16 spec on", failures, max_len,
                        preempt_at=p["spec_preempt_at"], spec_decode=True, spec_k=p["spec_k"])
    _spec_gates(spec16, "zamba2 bf16 spec", failures)
    witness = _fp32_witness(model, prompts, {rid: ample["generated"][rid] for rid, _, _ in sub},
                            spec16["generated"])
    out["spec_bf16"] = {"on": {k: v for k, v in spec16.items() if k != "generated"},
                        "requests": len(sub), "parted": len(witness), "witness": witness}
    for w in witness:
        if not abs(w["fp32_gap"]) <= 2 * w["bf16_err"]:
            failures.append(f"zamba2 bf16 spec: request {w['request']} parts at token "
                            f"{w['position']} beyond bf16 rounding: {w}")
    peak = torch.cuda.max_memory_allocated()
    finite = not bool(bad)
    _release(model)
    del model, bad
    # (e) the same in fp32 at a cut depth: tokens equal but at a near tie
    cfg32 = _arch_cfg(arch, p["spec_repeats"], "float32")
    model, _ = _card_model(cfg32, seed + 1, fan_in=True)
    bad = _finite_guard(model)
    plain = _serve_run(model, cfg32, pool, "zamba2 fp32 spec off", failures, max_len)
    spec = _serve_run(model, cfg32, pool, "zamba2 fp32 spec on", failures, max_len,
                          preempt_at=p["spec_preempt_at"], spec_decode=True,
                          spec_k=p["spec_k"])
    out["spec"] = {"dtype": "float32", "layers": cfg32.n_layers, "on": spec,
                   "off": {k: v for k, v in plain.items() if k != "generated"},
                   "ties": _tie_check(model, prompts, {"spec": spec["generated"],
                                                       "plain": plain["generated"]},
                                      "plain", "zamba2 spec", failures)}
    _spec_gates(spec, "zamba2 fp32 spec", failures)
    finite = finite and not bool(bad)
    # (f) the copy regime: every layer zeroed, so a token's successor is a
    # function of it alone and greedy decode cycles; the drafter locks on
    with torch.no_grad():
        for path, t in model.named_params().items():
            if path.startswith("slots/"):
                t.zero_()
    copy_prompts, cycles = _copy_regime_motifs(model, 1, rng)
    copy = [(0, copy_prompts[0], p["copy_new"])]
    cp_off = _serve_run(model, cfg32, copy, "zamba2 copy off", failures, max_len)
    cp_on = _serve_run(model, cfg32, copy, "zamba2 copy on", failures, max_len,
                           spec_decode=True, spec_k=p["spec_k"])
    out["copy_regime"] = {"on": {k: v for k, v in cp_on.items() if k != "generated"},
                          "off": {k: v for k, v in cp_off.items() if k != "generated"},
                          "equal": cp_on["generated"] == cp_off["generated"],
                          "shortest_cycles": cycles[:8]}
    if cp_on["generated"] != cp_off["generated"] or cp_on["speculation"]["accepted"] <= 0:
        failures.append(f"zamba2 copy regime: equal {out['copy_regime']['equal']}, "
                        f"{cp_on['speculation']}")
    emit(f"serve_{arch}", arch=arch, dtype="bfloat16", layers=cfg.n_layers,
         attention_layers=_attn_layers(cfg), params=cfg.param_count(), init="fan_in",
         weights_drawn_on="cuda", init_seconds=round(init_s, 3), peak_mem_bytes=peak,
         finite_logits=finite, **out)
    if not finite:
        failures.append("non-finite logits")
    if failures:
        raise AssertionError(f"serve {arch}: " + "; ".join(failures))
    _release(model)
    return {"zamba2_serve": out["traffic"]["launches"], "zamba2_spec": spec["launches"]}


def phase_xlstm_serve(p: dict, seed: int) -> dict:
    """xlstm-350m serving at ``serve_repeats`` repeats of its pattern (8 of
    24 layers: 7 mLSTM, 1 sLSTM; no attention, so K1 alone), bf16, fan-in
    weights on the card: glm4's traffic
    (launches exact), then slot reuse: a batch-1 scheduler serves request
    "a" and then "b" in the slot "a" left, and "b"'s tokens equal a fresh
    scheduler's (the reset restores the initial carries, ``m`` -1e30).
    Returns the traffic's launch counts."""
    import numpy as np
    import torch

    arch = "xlstm-350m"
    cfg = _arch_cfg(arch, p["serve_repeats"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, init_s = _card_model(cfg, seed, fan_in=True)
    bad = _finite_guard(model)
    rng = np.random.default_rng(seed)
    failures: list = []
    draw = lambda n: rng.integers(4, cfg.vocab, size=int(n)).tolist()  # noqa: E731
    reqs = [(i, draw(n), p["max_new"]) for i, n in enumerate(p["prompt_lens"])]
    traffic = _serve_run(model, cfg, reqs, "xlstm traffic", failures, p["max_len"])
    a, b = (("a", draw(p["reuse_prompts"][0]), p["max_new"]),
            ("b", draw(p["reuse_prompts"][1]), p["max_new"]))
    reused = _serve_run(model, cfg, [a, b], "xlstm reuse", failures, p["max_len"],
                            batch=1)
    fresh = _serve_run(model, cfg, [b], "xlstm fresh", failures, p["max_len"], batch=1)
    equal = reused["generated"]["b"] == fresh["generated"]["b"]
    if not equal:
        failures.append(f"xlstm slot reuse: b {reused['generated']['b']} != fresh "
                        f"{fresh['generated']['b']}")
    emit(f"serve_{arch}", arch=arch, dtype="bfloat16", layers=cfg.n_layers,
         attention_layers=_attn_layers(cfg), params=cfg.param_count(), init="fan_in",
         weights_drawn_on="cuda", init_seconds=round(init_s, 3),
         peak_mem_bytes=torch.cuda.max_memory_allocated(), finite_logits=not bool(bad),
         traffic=traffic, slot_reuse={"reused": reused, "fresh_b": fresh["generated"]["b"],
                                      "equal": equal})
    if bool(bad):
        failures.append("non-finite logits")
    if failures:
        raise AssertionError(f"serve {arch}: " + "; ".join(failures))
    _release(model)
    return {"xlstm_serve": traffic["launches"]}


def _slstm_scan(cfg, batch: int, seq: int, seed: int) -> dict:
    """One sLSTM block's forward at (batch, seq, d), bf16, no grad: the host
    loop of ``seq`` cell steps. Its time (CUDA events, after a warm-up
    call) and the kernels it puts on the card (``torch.profiler``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.layers import recurrent as R
    from repro_torch.layers.common import init_params

    gen = torch.Generator(device=DEV).manual_seed(seed)
    params = init_params(R.slstm_params(cfg), gen, cfg.param_dtype, DEV)
    x = torch.randn((batch, seq, cfg.d_model), generator=gen, device=DEV).to(cfg.compute_dtype)
    with torch.no_grad():
        R.slstm_block(params, x, cfg)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        R.slstm_block(params, x, cfg)
        end.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            R.slstm_block(params, x, cfg)
            torch.cuda.synchronize()
    kernels = sum(e.count for e in _device_events(prof))
    del params, x
    ms = start.elapsed_time(end)
    return {"batch": batch, "seq": seq, "ms": ms, "ms_per_position": ms / seq,
            "kernels": kernels, "kernels_per_position": kernels / seq}


def _step_grads(state, grad_norm: float, opt) -> dict:
    """One step's gradients from a fresh AdamW state's first moment, ``m =
    (1 - b1) * clip * g`` (fp32 on the card), the clip undone from the
    step's ``grad_norm``. The first step's update is 0 (the warm-up's lr
    scale at step 0), so the gradients, not the parameters, show what the
    backward computed."""
    clip = min(1.0, opt.grad_clip / max(grad_norm, 1e-12)) if opt.grad_clip else 1.0
    return {k: v / ((1 - opt.b1) * clip) for k, v in state.opt_state["m"].items()}


def _grad_blocks(t):
    """A leaf flattened in fp32 and cut into the int8 compression's blocks
    (``optim.compression.BLOCK`` values, the tail zero-padded as there)."""
    import torch.nn.functional as F

    from repro_torch.optim.compression import BLOCK

    f = t.reshape(-1).float()
    return F.pad(f, (0, (-f.numel()) % BLOCK)).view(-1, BLOCK)


def _grad_agreement(got: dict, ref: dict) -> dict:
    """Gradients against ``ref`` leaf by leaf: bitwise equal or not, the
    largest ||got - ref|| / ||ref|| of a leaf (a leaf's norm floored at
    1e-7 of the whole gradient's), and the largest distance of an element
    in steps of its block's int8 grid (the block's max |ref| / 127)."""
    import torch

    total = float(torch.sqrt(sum(torch.sum(torch.square(g)) for g in ref.values())))
    rel = steps = 0.0
    bitwise = True
    for k, r in ref.items():
        d = got[k] - r
        bitwise = bitwise and bool(torch.equal(got[k], r))
        rel = max(rel, float(d.norm()) / max(float(r.norm()), 1e-7 * total))
        step = _grad_blocks(r).abs().amax(1, keepdim=True) / 127.0
        steps = max(steps, float((_grad_blocks(d).abs() / step.clamp(min=1e-30)).max()))
    return {"bitwise": bitwise, "max_leaf_rel_l2": rel, "max_grid_steps": steps}


def _int8_round_trip_check(got: dict, ref: dict) -> dict:
    """A ``compress_dcn_grads`` step's gradients against the uncompressed
    step's (``ref``, the same weights and batch): the largest distance of
    an element in steps of its block's grid (round half to even: at most
    0.5), the largest distance of ``got / its block's step`` from an
    integer (the values lie on the int8 grid), and the share of elements
    the round trip changed."""
    import torch

    out = _grad_agreement(got, ref)
    off, changed, n = 0.0, 0, 0
    for k, g in got.items():
        b = _grad_blocks(g)
        q = b / (b.abs().amax(1, keepdim=True) / 127.0).clamp(min=1e-30)
        off = max(off, float((q - torch.round(q)).abs().max()))
        changed += int(torch.count_nonzero(g != ref[k]))
        n += g.numel()
    return {"max_grid_steps": out["max_grid_steps"], "max_off_grid": off,
            "changed_share": changed / n, "max_leaf_rel_l2": out["max_leaf_rel_l2"]}


def phase_xlstm_train(p: dict, seed: int) -> dict:
    """xlstm-350m training at ``ckpt_repeats`` repeats of the pattern, B
    ``train_batch``, S ``train_seq``, bf16, remat full, fan-in weights
    drawn on the card (the same seed for every run; the sLSTM host loop is
    most of a step, 5-6 s at full depth): (a) checkpoint-restart: a
    ``TrainLoop`` of ``ckpt_steps`` steps with ``ckpt_every`` that fails at
    ``fail_at`` (a temporary directory under ``results/``, deleted after);
    its state, as the failure left it, takes step ``fail_at`` at once, so
    steps 0..``ckpt_steps``-1 are the uninterrupted run's; a second loop
    over the same directory resumes at the last checkpoint, and its losses
    equal the uninterrupted ones within rtol 1e-4 (the JAX test's bound;
    bitwise equality recorded); launches exact over the first loop; the
    save's seconds and bytes recorded; at ``remat_repeats`` repeats, (b)
    one step under remat ``full``, ``none`` and ``dots`` from the same
    weights and batch: ``dots``'s loss equal to ``full``'s within 1e-6
    relative, the gradients of ``none`` and ``dots`` within
    GRAD_REMAT_TOL of ``full``'s in each leaf's relative L2 (the step's
    loss precedes the update and cannot tell a wrong backward), each one's
    peak memory, launches exact; (c) one step with ``compress_dcn_grads``:
    a finite loss, its gradients on the int8 grid of their blocks (to
    1e-3 of a step) and within half a step of ``full``'s (round half to
    even) plus the spread of (b); (d) the sLSTM block's host scan at full
    width timed and its kernels counted. Returns the first loop's launch
    counts."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.optim import adamw_init
    from repro_torch.train.loop import InjectedFailure, LoopConfig, TrainLoop
    from repro_torch.train.train import TrainConfig, TrainState, make_train_step

    arch = "xlstm-350m"
    cfg = _arch_cfg(arch, p["ckpt_repeats"])
    tcfg = TrainConfig(total_steps=p["ckpt_steps"])
    data = SyntheticLM(DataConfig(global_batch=p["train_batch"], seq_len=p["train_seq"],
                                  vocab=cfg.vocab, pad_fraction=0.05))
    failures: list = []

    def fresh(c=cfg):
        model, _ = _card_model(c, seed, fan_in=True)
        return TrainState(model, adamw_init(model.named_params(), tcfg.optimizer), 0)

    def loop(ckpt_dir: str, fail_at=None, state=None):
        return TrainLoop(cfg, tcfg, data, LoopConfig(
            steps=p["ckpt_steps"], ckpt_every=p["ckpt_every"], ckpt_dir=ckpt_dir,
            fail_at_step=fail_at, monitor_backend="null", monitor_app_name=arch),
            state=state if state is not None else fresh())

    _release()
    os.makedirs(os.path.join(ROOT, "results"), exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="ckpt_", dir=os.path.join(ROOT, "results"))
    try:
        # (a) the run that fails, its state's next step, the restart
        state = fresh()
        first = loop(ckpt_dir, fail_at=p["fail_at"], state=state)
        saves = []
        inner = first.ckpt.save

        def timed_save(tree, step, shardings=None, _inner=inner):
            t0 = time.perf_counter()
            _inner(tree, step, shardings)
            saves.append({"step": step, "seconds_to_return": time.perf_counter() - t0})

        first.ckpt.save = timed_save
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        failed = False
        t0 = time.perf_counter()
        try:
            first.run()
        except InjectedFailure:
            failed = True
        first_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = launch_counts()
        first_peak = torch.cuda.max_memory_allocated()
        want = dict.fromkeys(counts, 0)
        want.update(_train_expected_launches(cfg, p["fail_at"], 1))
        if counts != want or min(counts[k] for k in _path_kernels(cfg, TRAIN_KERNELS)) <= 0:
            failures.append(f"launches {counts} != expected {want}")
        ref = [h["loss"] for h in first.metrics_history]
        ref_secs = [h["seconds"] for h in first.metrics_history]
        step = make_train_step(cfg, tcfg)
        for t in range(p["fail_at"], p["ckpt_steps"]):
            state, m = step(state, data.batch_at(t))
            ref.append(float(m["loss"]))
        latest = first.ckpt.latest()
        step_dir = os.path.join(ckpt_dir, f"step_{latest:08d}") if latest else None
        nbytes = sum(os.path.getsize(os.path.join(step_dir, f))
                     for f in os.listdir(step_dir)) if step_dir else 0
        done_first = [h["step"] for h in first.metrics_history]
        del first, state, step
        _release()
        t0 = time.perf_counter()
        second = loop(ckpt_dir).run()
        restart_s = time.perf_counter() - t0
        resumed = [(h["step"], h["loss"]) for h in second.metrics_history]
        del second
        _release()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    steps_resumed = [s for s, _ in resumed]
    got = [loss for _, loss in resumed]
    want_losses = [ref[s] for s in steps_resumed]
    ckpt = {"every": p["ckpt_every"], "fail_at": p["fail_at"], "failed": failed,
            "first_run_steps": done_first, "first_run_s": first_s, "latest": latest,
            "saves": saves, "checkpoint_bytes": nbytes, "resumed_steps": steps_resumed,
            "resumed_losses": got, "uninterrupted_losses": want_losses,
            "bitwise_equal": got == want_losses, "restart_run_s": restart_s,
            "directory_removed": not os.path.exists(ckpt_dir)}
    expect_resume = list(range(p["fail_at"] // p["ckpt_every"] * p["ckpt_every"],
                               p["ckpt_steps"]))
    if not (failed and steps_resumed == expect_resume
            and np.allclose(got, want_losses, rtol=1e-4, atol=0)):
        failures.append(f"checkpoint-restart: {ckpt}")
    # (b) remat full, none and dots, (c) compress_dcn_grads: one step each
    # from the same weights, at a cut depth; each step's gradients read
    # back from AdamW's first moment
    remat, batch, grads = {}, data.batch_at(0), {}
    cut = cfg.replace(repeats=p["remat_repeats"])
    for name, c, tc in (("full", cut, tcfg), ("none", cut.replace(remat="none"), tcfg),
                        ("dots", cut.replace(remat="dots"), tcfg),
                        ("compress_dcn_grads", cut,
                         TrainConfig(total_steps=p["ckpt_steps"], compress_dcn_grads=True))):
        state = fresh(c)
        step = make_train_step(c, tc)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        secs = time.perf_counter() - t0
        counts_c = launch_counts()
        want_c = dict.fromkeys(counts_c, 0)
        want_c.update(_train_expected_launches(c, 1, 1))
        remat[name] = {"loss": loss, "grad_norm": float(m["grad_norm"]), "seconds": secs,
                       "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                       "launches": counts_c}
        if counts_c != want_c or not np.isfinite(loss):
            failures.append(f"{name} step: loss {loss}, launches {counts_c} != {want_c}")
        got = _step_grads(state, float(m["grad_norm"]), tcfg.optimizer)
        if name == "full":
            grads["full"] = got
        elif name == "compress_dcn_grads":
            remat[name]["vs_full"] = _int8_round_trip_check(got, grads["full"])
        else:
            remat[name]["vs_full"] = _grad_agreement(got, grads["full"])
        del state, step, m, got
        _release()
    del grads
    rel = abs(remat["dots"]["loss"] - remat["full"]["loss"]) / abs(remat["full"]["loss"])
    if rel > 1e-6:
        failures.append(f"remat dots loss {remat['dots']['loss']} vs full "
                        f"{remat['full']['loss']}: {rel} relative")
    for name in ("none", "dots"):
        if not remat[name]["vs_full"]["max_leaf_rel_l2"] <= GRAD_REMAT_TOL:
            failures.append(f"remat {name} gradients vs full: {remat[name]['vs_full']}")
    q = remat["compress_dcn_grads"]["vs_full"]
    spread = max(remat[n]["vs_full"]["max_grid_steps"] for n in ("none", "dots"))
    if not (q["max_grid_steps"] <= 0.5 + 1e-3 + spread and q["max_off_grid"] <= 1e-3
            and q["changed_share"] > 0):
        failures.append(f"compress_dcn_grads gradients vs full: {q}, spread {spread}")
    scan = _slstm_scan(cfg, p["train_batch"], p["train_seq"], seed)
    emit(f"train_{arch}", arch=arch, dtype="bfloat16", layers=cfg.n_layers,
         params=cfg.param_count(), init="fan_in", weights_drawn_on="cuda",
         labels_shape=[1, p["train_batch"], p["train_seq"]], remat=cfg.remat,
         losses=ref, step_seconds=ref_secs, median_step_seconds=float(np.median(ref_secs[1:])),
         launches=counts, expected_launches=want, first_run_peak_mem_bytes=first_peak,
         checkpoint_restart=ckpt, remat_layers=cut.n_layers, remat_steps=remat,
         remat_dots_vs_full_rel=rel, slstm_scan=scan)
    if failures:
        raise AssertionError(f"train {arch}: " + "; ".join(failures))
    return counts


def phase_recurrent() -> dict:
    """The recurrent and hybrid archs at full width (RECURRENT_PATHS), after
    every earlier model is freed: zamba2-2.7b's serving (traffic, a pool
    that preempts, the prefix cache's hybrid rule, two-pass speculation,
    the copy regime) and training under the monitor (its record passing
    ``talp validate``); xlstm-350m's serving and slot reuse, and training
    with checkpoint-restart, remat ``dots`` and ``compress_dcn_grads``;
    fp32 parity of both at one pattern repeat. Returns each path's launch
    counts."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    _release()
    counts = {}
    z = RECURRENT_PATHS["zamba2-2.7b"]
    counts.update(phase_zamba2_serve(z, seed=81))
    record_dir = os.path.join(ROOT, RECURRENT_TALP_DIR, "zamba2-2.7b", "train_monitor")
    shutil.rmtree(os.path.join(ROOT, RECURRENT_TALP_DIR), ignore_errors=True)
    cfg = _arch_cfg("zamba2-2.7b")
    data = SyntheticLM(DataConfig(global_batch=z["train_batch"], seq_len=z["train_seq"],
                                  vocab=cfg.vocab, pad_fraction=0.05))
    counts["zamba2_train"] = phase_arch_train("zamba2-2.7b", None, data, z["train_steps"],
                                              seed=82, backend="monitor",
                                              record_dir=record_dir, fan_in=True)
    cli = _talp_cli("validate", "-i", RECURRENT_TALP_DIR)
    m = re.search(r"(\d+) runs checked, (\d+) violations", cli["stdout"])
    RESULT["train_zamba2-2.7b"]["talp_validate"] = cli
    if cli["rc"] != 0 or not m or m.groups() != ("1", "0"):
        raise AssertionError(f"talp validate {RECURRENT_TALP_DIR}: {cli}")
    x = RECURRENT_PATHS["xlstm-350m"]
    counts.update(phase_xlstm_serve(x, seed=83))
    counts["xlstm_train"] = phase_xlstm_train(x, seed=84)
    phase_arch_parity("zamba2-2.7b", z["parity_repeats"], z["parity_prompt"], seed=85,
                      fan_in=True)
    phase_arch_parity("xlstm-350m", x["parity_repeats"], x["parity_prompt"], seed=86,
                      fan_in=True)
    return counts


def _arch_kernel_rows() -> list:
    """(kernel, label, path, case) of each kernel shape the other dense
    archs' paths run: phase 2 keeps its bf16 errors under
    ``f"{kernel}@{label}"`` and phase 8 times it, with the path's
    launches. A path's count covers both of gemma2's layer kinds (local and
    global rows share it)."""
    from repro_torch.kernels import cases

    rows = []
    for name in ("flash_attention", "flash_attention_backward"):
        rows += [(name, "gemma2_local", "gemma2_train", cases.MAIN_FLASH_GEMMA2),
                 (name, "gemma2_global", "gemma2_train", cases.MAIN_FLASH_GEMMA2_GLOBAL),
                 (name, "llava", "llava_train", cases.MAIN_FLASH_LLAVA),
                 (name, "hubert", "hubert_train", cases.MAIN_FLASH_HUBERT)]
    rows += [("paged_attention", "gemma2_local", "gemma2_serve", cases.MAIN_PAGED_GEMMA2),
             ("paged_attention", "gemma2_global", "gemma2_serve",
              cases.MAIN_PAGED_GEMMA2_GLOBAL),
             ("paged_attention", "glm4", "glm4_serve", cases.PAGED_GLM4),
             ("paged_attention", "command_r", "command_r_serve", cases.PAGED_COMMAND_R),
             ("paged_prefill_attention", "gemma2_local", "gemma2_serve",
              cases.MAIN_PREFILL_GEMMA2),
             ("paged_prefill_attention", "gemma2_global", "gemma2_serve",
              cases.MAIN_PREFILL_GEMMA2_GLOBAL),
             ("paged_prefill_attention", "glm4", "glm4_serve", cases.PREFILL_GLM4)]
    by_case = {c[:2]: c for c in cases.RMS_ARCH_CASES}
    rows += [("rmsnorm", "gemma2_decode", "gemma2_serve", by_case[(4, 2304)]),
             ("rmsnorm", "gemma2_train", "gemma2_train", by_case[(8192, 2304)]),
             ("rmsnorm_backward", "gemma2_train", "gemma2_train", by_case[(8192, 2304)]),
             ("rmsnorm", "glm4_decode", "glm4_serve", by_case[(4, 4096)]),
             ("rmsnorm", "command_r_decode", "command_r_serve", by_case[(4, 8192)]),
             ("rmsnorm", "hubert_train", "hubert_train", by_case[(4096, 1280)]),
             ("rmsnorm_backward", "hubert_train", "hubert_train", by_case[(4096, 1280)])]
    # a tensor-parallel rank of phase 6b (b): tinyllama's 16 of 32 heads,
    # its sequence half of the norms' rows
    rows += [(name, "mesh_tp", "mesh_tp", cases.MAIN_FLASH_MESH)
             for name in ("flash_attention", "flash_attention_backward")]
    rows += [(name, "mesh_tp", "mesh_tp", by_case[cases.MAIN_RMS_MESH])
             for name in ("rmsnorm", "rmsnorm_backward")]
    # the MoE archs (phase 10): qwen3 at G 8 and dbrx at G 6, qk-norm at
    # head dim 128
    rows += [(name, "qwen3", "qwen3_train", cases.MAIN_FLASH_QWEN3)
             for name in ("flash_attention", "flash_attention_backward")]
    rows += [("paged_attention", "qwen3", "qwen3_serve", cases.PAGED_QWEN3),
             ("paged_attention", "dbrx", "dbrx_serve", cases.PAGED_DBRX),
             ("paged_prefill_attention", "qwen3", "qwen3_serve", cases.PREFILL_QWEN3),
             ("paged_prefill_attention", "dbrx", "dbrx_serve", cases.PREFILL_DBRX),
             ("rmsnorm", "qwen3_qk_decode", "qwen3_serve", by_case[(128, 128)]),
             ("rmsnorm", "dbrx_decode", "dbrx_serve", by_case[(4, 6144)])]
    for label, shape in (("qwen3_q_norm_train", (131072, 128)),
                         ("qwen3_k_norm_train", (16384, 128)),
                         ("qwen3_train", (4096, 2048))):
        rows += [(name, label, "qwen3_train", by_case[shape])
                 for name in ("rmsnorm", "rmsnorm_backward")]
    # the recurrent archs (phase 11): zamba2's attention at G 1, head dim
    # 80, and its verify's two passes; the mamba2 gated norm at 5120;
    # xlstm's norms (no attention)
    rows += [(name, "zamba2", "zamba2_train", cases.MAIN_FLASH_ZAMBA2)
             for name in ("flash_attention", "flash_attention_backward")]
    # phase 6b (c) and (d): zamba2's attention at a tensor-parallel rank's
    # 16 heads; gemma2's context-parallel block of rank 1 (queries 4096..8191,
    # the heavier one), local and global
    for name in ("flash_attention", "flash_attention_backward"):
        rows += [(name, "zamba2_tp", "mesh_ssm", cases.MAIN_FLASH_ZAMBA2_TP),
                 (name, "gemma2_cp_local", "mesh_cp", cases.MAIN_FLASH_CP_LOCAL[1]),
                 (name, "gemma2_cp_global", "mesh_cp", cases.MAIN_FLASH_CP_GLOBAL[1])]
    # phase 6e (a): a rank of tinyllama's scheduler on (1, 2), 16/2 heads
    rows += [("paged_attention", "serve_mesh", "serve_mesh", cases.PAGED_MESH),
             ("paged_prefill_attention", "serve_mesh", "serve_mesh", cases.PREFILL_MESH)]
    rows += [("paged_attention", "zamba2", "zamba2_serve", cases.PAGED_ZAMBA2),
             ("paged_prefill_attention", "zamba2", "zamba2_serve", cases.PREFILL_ZAMBA2),
             ("paged_prefill_attention", "zamba2_verify", "zamba2_spec",
              cases.PREFILL_ZAMBA2_VERIFY),
             ("rmsnorm", "zamba2_decode", "zamba2_serve", by_case[(4, 2560)]),
             ("rmsnorm", "zamba2_gated_decode", "zamba2_serve", by_case[(4, 5120)]),
             ("rmsnorm", "zamba2_gated_chunk", "zamba2_serve", by_case[(64, 5120)]),
             ("rmsnorm", "xlstm_decode", "xlstm_serve", by_case[(4, 1024)]),
             ("rmsnorm", "xlstm_mlstm_decode", "xlstm_serve", by_case[(4, 2048)])]
    for label, path, shape in (("zamba2_train", "zamba2_train", (4096, 2560)),
                               ("zamba2_gated_train", "zamba2_train", (4096, 5120)),
                               ("xlstm_train", "xlstm_train", (4096, 1024)),
                               ("xlstm_mlstm_train", "xlstm_train", (4096, 2048))):
        rows += [(name, label, path, by_case[shape])
                 for name in ("rmsnorm", "rmsnorm_backward")]
    return rows


def _arch_err_keys(name: str, case) -> list:
    """``f"{name}@{label}"`` of every row of ``_arch_kernel_rows`` that is
    (name, case) (flash cases compared on their first 9 fields; two paths
    may share a shape)."""
    return [f"{name}@{label}" for n, label, _, c in _arch_kernel_rows()
            if n == name and tuple(c) == tuple(case)[:len(c)]]


_SOURCES = {
    "flash_attention": ("src/repro_torch/csrc/flash_attention_tc.cu",
                        "src/repro/kernels/flash_attention/kernel.py:35"),
    "paged_attention": ("src/repro_torch/csrc/paged_attention_tc.cu",
                        "src/repro/kernels/paged_attention/kernel.py:43"),
    "paged_prefill_attention": ("src/repro_torch/csrc/paged_attention_tc.cu",
                                "src/repro/kernels/paged_attention/kernel.py:99"),
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm/kernel.py:22"),
}
_SOURCES["flash_attention_backward"] = _SOURCES["flash_attention"]
_SOURCES["rmsnorm_backward"] = _SOURCES["rmsnorm"]
NO_SOFTCAP_LIBRARY = ("none: no PyTorch call computes a soft-capped attention "
                      "(library_without_softcap_ms: SDPA on the same mask without it)")


def _arch_timing() -> list:
    """Each row of ``_arch_kernel_rows`` timed as phase 8 times the
    tinyllama rows (bf16), with its path and error key."""
    rows = []
    for name, label, path, case in _arch_kernel_rows():
        if name.startswith("flash"):
            row = _flash_arch_timing(case, backward=name.endswith("backward"), seed=63)
        elif name == "paged_attention":
            row = _decode_timing(case, seed=61)
        elif name == "paged_prefill_attention":
            row = _prefill_timing(case, seed=62)
        else:
            row = _rms_arch_timing(*case, backward=name.endswith("backward"), seed=64)
        source, replaces = _SOURCES[name]
        rows.append(dict(name=name, route="cuda", path=path, err_key=f"{name}@{label}",
                         source=source, replaces=replaces, **row))
    return rows


def _sdpa_mask(qpos, kpos, causal: bool, window, kv_len=None):
    """The boolean (B, 1, Sq, Sk) mask of these positions, for SDPA."""
    import torch

    q, k = qpos[:, None, :, None], kpos[:, None, None, :]
    m = (k <= q) if causal else torch.ones_like(k <= q)
    if window:
        m = m & (k > q - window)
    if kv_len is not None:
        m = m & (k < kv_len[:, None, None, None])
    return m


def _flash_arch_timing(case, backward: bool, seed: int, ms_iters=(20, 3), dev_iters=10,
                       plain_iters=None) -> dict:
    """K2's forward or backward at one training shape, bf16 (index positions;
    a case with a 10th field, a query block at that offset against keys
    0..Sk-1, masked, counted and bound by its positions):
    the kernel, its plain version and, without a soft-cap, SDPA on the same
    mask (k/v repeated to the q heads outside the timing; the backward's
    library call is the autograd of one saved SDPA output). ``ms_iters``
    (iterations, warmup) and ``dev_iters`` time the kernel, ``plain_iters``
    the plain version (default (3, 1) forward, (2, 1) backward)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cases
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_backward_reference,
        flash_attention_reference,
    )

    bf = torch.bfloat16
    B, Sq, Sk, Hq, Hkv, D, causal, win, cap = case[:9]
    off = case[9] if len(case) > 9 else 0
    c = cases.flash_case(B, Sq, Sk, Hq, Hkv, D, seed=seed, q_offset=off)
    q, k, v, do = (torch.from_numpy(c[n]).to(DEV, bf) for n in ("q", "k", "v", "dout"))
    qpos, kpos = (torch.from_numpy(c[n]).to(DEV) for n in ("q_positions", "k_positions"))
    # a query block off the diagonal (context parallelism): the mask, the
    # pairs and the key span follow the positions
    blocked = bool(off) or Sq != Sk
    G = Hq // Hkv
    qt, dot = q.transpose(1, 2).contiguous(), do.transpose(1, 2).contiguous()
    kt, vt = (t.transpose(1, 2).repeat_interleave(G, dim=1).contiguous() for t in (k, v))
    sdpa_kw = (dict(attn_mask=_sdpa_mask(qpos, kpos, causal, win)) if win or blocked
               else dict(is_causal=causal))
    kw = dict(q_positions=qpos, k_positions=kpos, causal=causal, window=win, softcap=cap)
    flops, nbytes = FA.launch_costs(q, k, causal, win, backward,
                                    *((qpos, kpos) if blocked else ()))
    bound, by = _bound_ms(nbytes, flops, "bfloat16")
    shape = (f"B={B} S={Sq}" + (f" Sk={Sk} q_offset={off}" if blocked else "")
             + f" Hq={Hq} Hkv={Hkv} D={D} " + ("causal" if causal else "bidirectional")
             + (f" window={win}" if win else "") + (f" softcap={cap}" if cap else "") + " bf16")
    if not backward:
        kernel = lambda: FA.flash_forward(q, k, v, qpos, kpos, None, causal, win, cap)  # noqa: E731
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)  # noqa: E731
        plain = lambda: flash_attention_reference(q, k, v, **kw)  # noqa: E731
        lib_ms, lib_dev = cuda_ms(lib, iters=20, warmup=3), graph_ms(lib, iters=10)
        plain_ms, via = cuda_ms(plain, *(plain_iters or (3, 1))), "cuda graph"
    else:
        o, lse = FA.flash_forward(q, k, v, qpos, kpos, None, causal, win, cap)
        kernel = lambda: FA.flash_backward(q, k, v, o, lse, do, qpos, kpos, None,  # noqa: E731
                                           causal, win, cap)
        leaves = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
        out_lib = F.scaled_dot_product_attention(*leaves, **sdpa_kw)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(out_lib, leaves, dot, retain_graph=True),
                         iters=10, warmup=2)
        lib_dev, via = autograd_device_ms(
            lambda: F.scaled_dot_product_attention(*leaves, **sdpa_kw), leaves, dot)
        plain_ms = cuda_ms(lambda: flash_attention_backward_reference(q, k, v, do, **kw),
                           *(plain_iters or (2, 1)))
    dev = graph_ms(kernel, iters=dev_iters)
    out = dict(variant=FA.route(bf), shape=shape, ms=cuda_ms(kernel, *ms_iters),
               device_ms=dev, tflops=flops / dev / 1e9, plain_ms=plain_ms,
               bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)
    if cap:
        out.update(library_ms=None, library_device_ms=None, library=NO_SOFTCAP_LIBRARY,
                   library_without_softcap_ms=lib_ms, library_without_softcap_device_ms=lib_dev)
    else:
        out.update(library_ms=lib_ms, library_device_ms=lib_dev, library_device_via=via,
                   library=("autograd of one saved " if backward else "")
                   + "F.scaled_dot_product_attention, k/v repeated, the same mask")
    torch.cuda.empty_cache()
    return out


def _decode_timing(case, seed: int) -> dict:
    """K3 at one ``PAGED_*`` case, bf16: the kernel (also L2 cold), its plain
    version and, without a soft-cap, SDPA over the pre-gathered dense view
    on the same mask, beside the bound from ``launch_costs``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cases
    from repro_torch.kernels.paged_attention import ops as PA
    from repro_torch.kernels.paged_attention import ref as PR

    B, Hq, Hkv, D, ps, nL, P, lens, win, cap = case
    t = _tensors(cases.paged_case(B, Hq, Hkv, D, ps, nL, P, lens, seed=seed), torch.bfloat16,
                 ("q", "k_pages", "v_pages"))
    args = (t["q"], t["k_pages"], t["v_pages"], t["block_tables"])
    kw = dict(q_position=t["q_position"], cache_len=t["cache_len"], window=win, softcap=cap)
    flops, nbytes = PA.launch_costs(t["q"], t["k_pages"], nL, lens, [n - 1 for n in lens],
                                    causal=False, window=win)
    bound, by = _bound_ms(nbytes, flops, "bfloat16")
    kd = PR.gather_pages(t["k_pages"], t["block_tables"]).permute(0, 2, 1, 3)
    vd = PR.gather_pages(t["v_pages"], t["block_tables"]).permute(0, 2, 1, 3)
    kd = kd.repeat_interleave(Hq // Hkv, dim=1).contiguous()
    vd = vd.repeat_interleave(Hq // Hkv, dim=1).contiguous()
    qd = t["q"].permute(0, 2, 1, 3).contiguous()
    kpos = torch.arange(nL * ps, device=DEV, dtype=torch.int32).expand(B, nL * ps)
    mask = _sdpa_mask(t["q_position"][:, None], kpos, True, win, t["cache_len"])
    kernel = lambda: PA.paged_attention(*args, **kw)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)  # noqa: E731
    out = dict(variant=PA.route(torch.bfloat16),
               shape=(f"B={B} Hq={Hq} Hkv={Hkv} D={D} page={ps} lens={list(lens)}"
                      + (f" window={win}" if win else "") + (f" softcap={cap}" if cap else "")
                      + " bf16"),
               ms=cuda_ms(kernel), device_ms=graph_ms(kernel),
               cold_device_ms=cold_graph_ms(kernel),
               plain_ms=cuda_ms(lambda: PR.paged_attention_reference(*args, **kw), iters=50),
               bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)
    lib = dict(library_ms=cuda_ms(sdpa), library_device_ms=graph_ms(sdpa),
               library_cold_device_ms=cold_graph_ms(sdpa))
    if cap:  # SDPA computes the same function only without the soft-cap
        out.update(library_ms=None, library_device_ms=None, library=NO_SOFTCAP_LIBRARY,
                   **{k.replace("library", "library_without_softcap"): v for k, v in lib.items()})
    else:
        out.update(lib, library="F.scaled_dot_product_attention on the pre-gathered dense view")
    return out


def _rms_arch_timing(r: int, d: int, zc: bool, backward: bool, seed: int) -> dict:
    """K1's forward or backward at (r, d), bf16, zero-centred or not; the
    library call ``F.rms_norm`` (its autograd for the backward) with weight
    ``1 + scale`` where zero-centred (formed outside the timing)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cases
    from repro_torch.kernels.rmsnorm import ops as RMS
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_backward_reference, rmsnorm_reference

    bf = torch.bfloat16
    c = cases.rms_case(r, d, seed=seed)
    x, sc, dy = (torch.from_numpy(c[n]).to(DEV, bf) for n in ("x", "scale", "dy"))
    w = (1 + sc) if zc else sc
    shape = f"rows={r} d={d}" + (" zero-centred" if zc else "") + " bf16"
    if not backward:
        nbytes, flops = (2 * r * d + d) * 2, 4 * r * d
        kernel = lambda: RMS.rmsnorm(x, sc, 1e-6, zc)  # noqa: E731
        lib = lambda: F.rms_norm(x, (d,), w, 1e-6)  # noqa: E731
        lib_ms, lib_dev = cuda_ms(lib), graph_ms(lib)
        plain_ms = cuda_ms(lambda: rmsnorm_reference(x, sc, 1e-6, zc), iters=50)
        label = "F.rms_norm" + (" with weight 1 + scale" if zc else "")
    else:
        nbytes, flops = 3 * r * d * 2 + 2 * d * 2, 8 * r * d
        kernel = lambda: RMS.launch_backward(x, sc, dy, 1e-6, zc)  # noqa: E731
        xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y_lib = F.rms_norm(xl, (d,), wl, 1e-6)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(y_lib, (xl, wl), dy, retain_graph=True))
        lib_dev, via = autograd_device_ms(lambda: F.rms_norm(xl, (d,), wl, 1e-6), (xl, wl),
                                          dy, iters=20)
        plain_ms = cuda_ms(lambda: rmsnorm_backward_reference(x, sc, dy, 1e-6, zc), iters=20)
        label = "autograd of F.rms_norm" + (" with weight 1 + scale" if zc else "")
    bound, by = _bound_ms(nbytes, flops, "bfloat16")
    out = dict(shape=shape, ms=cuda_ms(kernel), device_ms=graph_ms(kernel), plain_ms=plain_ms,
               library_ms=lib_ms, library_device_ms=lib_dev, library=label,
               bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)
    if backward:
        out["library_device_via"] = via
    return out


# ---------------------------------------------------------------------------
# phase 8: timing beside the bound
# ---------------------------------------------------------------------------


def _bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_timing(main_err, counts):
    import torch

    from repro_torch.kernels import cases
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.paged_attention import ops as PA

    bf = torch.bfloat16
    rows = []

    # K3: paged decode at the serving shape
    rows.append(dict(name="paged_attention", route="cuda",
                     source="src/repro_torch/csrc/paged_attention_tc.cu",
                     replaces="src/repro/kernels/paged_attention/kernel.py:43",
                     **_decode_timing(cases.MAIN_PAGED, seed=41)))

    # K4: paged prefill at the serving shape, and at the speculative
    # verify's (PREFILL_SPLIT_CASES' ragged row)
    verify = next(c for c in cases.PREFILL_SPLIT_CASES if len(c) == 12)
    rows.append(dict(
        name="paged_prefill_attention", route="cuda", variant=PA.route(bf),
        source="src/repro_torch/csrc/paged_attention_tc.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:99",
        **_prefill_timing(cases.MAIN_PREFILL, seed=42),
        verify_shape=_prefill_timing(verify, seed=44)))

    # K1: RMSNorm at the decode shape (4 rows), and the prefill-chunk shape;
    # no operand requires grad, so the wrapper launches the forward directly
    # as under the serving path's inference mode
    extra = {r: _rms_arch_timing(r, d, False, False, seed=43) for r, d in cases.MAIN_RMS}
    r0 = cases.MAIN_RMS[0][0]
    rows.append(dict(name="rmsnorm", route="cuda", source="src/repro_torch/csrc/rmsnorm.cu",
                     replaces="src/repro/kernels/rmsnorm/kernel.py:22",
                     **extra[r0], chunk_shape=extra[cases.MAIN_RMS[1][0]],
                     train_shape=_rms_arch_timing(*cases.MAIN_RMS_TRAIN, False, False,
                                                  seed=45)))
    rows += _training_timing()
    for name, case in zip(("decode", "chunk"), cases.MAIN_FLASH_DENSE):
        rows.append(dict(name="flash_attention", route="cuda", path="serve_dense",
                         err_key=f"flash_attention_dense_{name}", variant=FA.route(bf),
                         source="src/repro_torch/csrc/flash_attention_tc.cu",
                         replaces="src/repro/kernels/flash_attention/kernel.py:35",
                         **_dense_flash_timing(case, seed=47)))
    for name, case in (("oneshot", cases.MAIN_FLASH_ONESHOT),
                       ("split_decode", cases.MAIN_FLASH_SPLIT_DECODE)):
        rows.append(dict(name="flash_attention", route="cuda",
                         path="oneshot" if name == "oneshot" else "oneshot_glm4_1x4",
                         err_key=f"flash_attention_{name}", variant=FA.route(bf),
                         source="src/repro_torch/csrc/flash_attention_tc.cu",
                         replaces="src/repro/kernels/flash_attention/kernel.py:35",
                         **_oneshot_flash_timing(case, seed=48, blocked=name == "oneshot")))
    rows += _arch_timing()
    for row in rows:
        path = row.get("path")
        row["launches"] = (counts[path][row["name"]] if path else
                           counts["train"].get(row["name"], 0) or counts["serve"][row["name"]])
        row["launches_by_path"] = {p: c[row["name"]] for p, c in counts.items()}
        key = row.pop("err_key", row["name"])
        row["max_abs_err"] = main_err[key]
        if key in main_err["l2_rel_err"]:
            row["l2_rel_err"] = main_err["l2_rel_err"][key]
    return rows


def _dense_flash_timing(case, seed: int) -> dict:
    """K2's forward at a dense serving shape, bf16: the kernel, its plain
    version and SDPA on the same masked inputs (k/v repeated to the q heads
    outside the timing; the mask causal and cut at kv_len), beside the bound
    from ``launch_costs`` of these positions."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cases
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention.ref import flash_attention_reference

    B, Sq, Sk, Hq, Hkv, D, causal, _, _, off, kvl = case
    c = cases.flash_case(B, Sq, Sk, Hq, Hkv, D, seed=seed, q_offset=off, kv_len=kvl)
    q, k, v = (torch.from_numpy(c[n]).to(DEV, torch.bfloat16) for n in ("q", "k", "v"))
    qpos, kpos, lens = (torch.from_numpy(c[n]).to(DEV) for n in
                        ("q_positions", "k_positions", "kv_len"))
    flops, nbytes = FA.launch_costs(q, k, causal, None, False, qpos, kpos, lens)
    bound, by = _bound_ms(nbytes, flops, "bfloat16")
    G = Hq // Hkv
    qd = q.transpose(1, 2).contiguous()
    kd, vd = (t.transpose(1, 2).repeat_interleave(G, dim=1).contiguous() for t in (k, v))
    mask = _sdpa_mask(qpos, kpos, True, None, lens)
    kernel = lambda: FA.flash_forward(q, k, v, qpos, kpos, lens, causal, None, None)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)  # noqa: E731
    plain = lambda: flash_attention_reference(q, k, v, q_positions=qpos,  # noqa: E731
                                              k_positions=kpos, causal=causal, kv_len=lens)
    return dict(
        shape=f"B={B} Sq={Sq} Sk={Sk} Hq={Hq} Hkv={Hkv} D={D} q_pos={off} kv_len={list(kvl)} bf16",
        ms=cuda_ms(kernel), device_ms=graph_ms(kernel), plain_ms=cuda_ms(plain, iters=50),
        library_ms=cuda_ms(sdpa), library_device_ms=graph_ms(sdpa),
        library="F.scaled_dot_product_attention, k/v repeated, the same mask",
        bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)


def _oneshot_flash_timing(case, seed: int, blocked: bool) -> dict:
    """K2's forward at a one-shot row (``cases.MAIN_FLASH_ONESHOT``,
    ``MAIN_FLASH_SPLIT_DECODE``), bf16: the kernel (the split decode's with
    the LSE it returns), its plain version (``blocked``: in 1024-query
    blocks, whose score tensors fit the card, the whole prompt's would
    not), and SDPA on the same masks (k/v repeated to the q heads outside
    the timing; the one-shot prefill ``is_causal``), beside the bound from
    ``launch_costs`` of these positions."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention.ref import flash_attention_reference

    q, k, v, kw = _split_case_inputs(case, torch.bfloat16, seed)
    B, Sq, Sk, Hq, Hkv, D, causal, _, _, off, kvl, koff = case
    qpos, kpos, lens = kw["q_positions"], kw["k_positions"], kw["kv_len"]
    flops, nbytes = FA.launch_costs(q, k, causal, None, False, qpos, kpos, lens)
    bound, by = _bound_ms(nbytes, flops, "bfloat16")
    G = Hq // Hkv
    qd = q.transpose(1, 2).contiguous()
    kd, vd = (t.transpose(1, 2).repeat_interleave(G, dim=1).contiguous() for t in (k, v))
    kernel = lambda: FA.flash_forward(q, k, v, qpos, kpos, lens, causal, None, None)  # noqa: E731
    if blocked:
        sdpa = lambda: F.scaled_dot_product_attention(qd, kd, vd, is_causal=True)  # noqa: E731
        plain = lambda: _oneshot_reference(q, k, v, kw)  # noqa: E731
        plain_ms = cuda_ms(plain, iters=2, warmup=1)
    else:
        mask = _sdpa_mask(qpos, kpos, True, None, lens)
        sdpa = lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)  # noqa: E731
        plain = lambda: flash_attention_reference(q, k, v, return_lse=True, **kw)  # noqa: E731
        plain_ms = cuda_ms(plain, iters=50)
    iters = 5 if blocked else 200
    return dict(
        shape=f"B={B} Sq={Sq} Sk={Sk} Hq={Hq} Hkv={Hkv} D={D} q_pos={off} k_pos={koff} "
              f"kv_len={None if kvl is None else list(kvl)} bf16",
        ms=cuda_ms(kernel, iters=iters, warmup=2), device_ms=graph_ms(kernel, iters=iters),
        plain_ms=plain_ms, plain="in 1024-query blocks" if blocked else "whole",
        library_ms=cuda_ms(sdpa, iters=iters, warmup=2),
        library_device_ms=graph_ms(sdpa, iters=iters),
        library="F.scaled_dot_product_attention, k/v repeated, the same mask",
        bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)


def _prefill_timing(case, seed: int) -> dict:
    """K4 at one ``PREFILL_*`` case, bf16: the kernel, its plain version and
    SDPA over the pre-gathered dense view (the same masks), beside the
    bound from ``launch_costs`` of these inputs."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cases
    from repro_torch.kernels.paged_attention import ops as PA
    from repro_torch.kernels.paged_attention import ref as PR

    B, C, Hq, Hkv, D, ps, nL, P, starts, win, cap, lengths = cases.prefill_row(case)
    t = _tensors(cases.prefill_case(B, C, Hq, Hkv, D, ps, nL, P, starts, seed=seed,
                                    lengths=lengths), torch.bfloat16, ("q", "k_pages", "v_pages"))
    args = (t["q"], t["k_pages"], t["v_pages"], t["block_tables"])
    kw = dict(q_positions=t["q_positions"], cache_len=t["cache_len"], causal=True,
              window=win, softcap=cap)
    flops, nbytes = PA.launch_costs(t["q"], t["k_pages"], nL, t["cache_len"].tolist(),
                                    list(starts), causal=True, window=win)
    bound, by = _bound_ms(nbytes, flops, "bfloat16")
    S = nL * ps
    kd = PR.gather_pages(t["k_pages"], t["block_tables"]).permute(0, 2, 1, 3)
    vd = PR.gather_pages(t["v_pages"], t["block_tables"]).permute(0, 2, 1, 3)
    kd = kd.repeat_interleave(Hq // Hkv, dim=1).contiguous()
    vd = vd.repeat_interleave(Hq // Hkv, dim=1).contiguous()
    qd = t["q"].permute(0, 2, 1, 3).contiguous()
    kpos = torch.arange(S, device=DEV).expand(B, S)
    mask = _sdpa_mask(t["q_positions"], kpos, True, win, t["cache_len"])
    kernel = lambda: PA.paged_prefill_attention(*args, **kw)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)  # noqa: E731
    out = dict(
        shape=(f"B={B} C={C} Hq={Hq} Hkv={Hkv} D={D} page={ps} start={list(starts)}"
               + (f" length={list(lengths)}" if lengths else "")
               + (f" window={win}" if win else "") + (f" softcap={cap}" if cap else "") + " bf16"),
        ms=cuda_ms(kernel), device_ms=graph_ms(kernel), cold_device_ms=cold_graph_ms(kernel),
        plain_ms=cuda_ms(lambda: PR.paged_prefill_attention_reference(*args, **kw), iters=50),
        bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)
    lib = dict(library_ms=cuda_ms(sdpa), library_device_ms=graph_ms(sdpa),
               library_cold_device_ms=cold_graph_ms(sdpa))
    if cap:  # SDPA computes the same function only without the soft-cap
        out.update(library_ms=None, library_device_ms=None, library=NO_SOFTCAP_LIBRARY,
                   **{k.replace("library", "library_without_softcap"): v for k, v in lib.items()})
    else:
        out.update(lib, library="F.scaled_dot_product_attention on the pre-gathered dense view")
    return out


def _kernel_split_ms(fn, parts: dict, iters: int = 20) -> dict:
    """Device time per launch of each part of ``fn`` (the kernels whose name
    holds its substring), from ``torch.profiler``: the part's summed time
    over its launches, so a launch the profiler missed moves nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = _device_events(prof)
    out = {}
    for k, sub in parts.items():
        hit = [e for e in events if sub in e.key]
        n = sum(e.count for e in hit)
        out[k] = sum(e.self_device_time_total for e in hit) / 1e3 / n if n else None
        out[k + "_launches_seen"] = n
    return out


def _training_timing() -> list:
    """K2 forward and backward and the K1 backward at the training path's
    shapes (B=4, S=2048, Hq=32, Hkv=4, D=64, causal; 8192 x 2048), bf16,
    through ``_flash_arch_timing`` and ``_rms_arch_timing`` (K2 at the
    iteration counts its rows were first timed with: the forward 50 calls
    after 5, 20 on the graph, its plain version 5; the backward's plain
    version 3); the K1 backward also with its row pass's and combine's
    device times apart
    (``_kernel_split_ms``) and its plan."""
    import torch

    from repro_torch.kernels import cases
    from repro_torch.kernels.rmsnorm import ops as RMS

    common = dict(route="cuda", source="src/repro_torch/csrc/flash_attention_tc.cu",
                  replaces="src/repro/kernels/flash_attention/kernel.py:35")
    rows = [dict(name="flash_attention", **common,
                 **_flash_arch_timing(cases.MAIN_FLASH, backward=False, seed=44,
                                      ms_iters=(50, 5), dev_iters=20, plain_iters=(5, 1))),
            dict(name="flash_attention_backward", **common,
                 note="the backward of K2: no Pallas counterpart",
                 **_flash_arch_timing(cases.MAIN_FLASH, backward=True, seed=44,
                                      plain_iters=(3, 1)))]
    r, d = cases.MAIN_RMS_TRAIN
    rc = cases.rms_case(r, d, seed=46)
    x, sc, dy = (torch.from_numpy(rc[n]).to(DEV, torch.bfloat16) for n in ("x", "scale", "dy"))
    kb = lambda: RMS.launch_backward(x, sc, dy, 1e-6, False)  # noqa: E731
    split = _kernel_split_ms(kb, {"row_pass": "rmsnorm_bwd", "combine": "rmsnorm_dscale"})
    rows.append(dict(name="rmsnorm_backward", route="cuda",
                     source="src/repro_torch/csrc/rmsnorm.cu",
                     replaces="src/repro/kernels/rmsnorm/kernel.py:22",
                     note="the backward of K1: no Pallas counterpart",
                     **_rms_arch_timing(r, d, False, True, seed=46),
                     row_pass_device_ms=split["row_pass"], combine_device_ms=split["combine"],
                     profiled_launches=[split["row_pass_launches_seen"],
                                        split["combine_launches_seen"]],
                     plan=RMS.plan(r, d, 2, torch.cuda.get_device_properties(0)
                                   .multi_processor_count, True)._asdict()))
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--mesh-rank"]:
        return _mesh_rank_main(sys.argv[2:])
    if sys.argv[1:2] == ["--oneshot-rank"]:
        return _oneshot_rank_main(sys.argv[2:])
    if sys.argv[1:2] == ["--serve-rank"]:
        return _serve_rank_main(sys.argv[2:])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    profile = "--profile" in sys.argv[1:]
    t_start = time.perf_counter()
    _T_PHASE[0] = t_start
    shutil.rmtree(TALP_DIR, ignore_errors=True)  # the CI folder phase 7 renders
    phase_build()
    main_err = phase_kernels()
    params, dense_parity = phase_parity()
    model, serve_counts, serve_tokens, serve_tps = phase_serve(params)
    if profile:
        phase_profile(model)
    shallow = _shallow(model, LOAD_REPEATS)
    load_counts = phase_serve_load(shallow)
    if profile:
        phase_profile_load(shallow)
    spec_counts, copy_ctx = phase_serve_spec(shallow)
    fault_counts = phase_serve_fault(shallow, copy_ctx)
    del shallow
    del copy_ctx
    dense_counts = phase_serve_dense(model, params, serve_tokens, serve_tps, dense_parity)
    del model
    torch.cuda.empty_cache()
    phase_train_parity(params)
    del params
    train_counts = phase_train(profile)
    mesh_counts = phase_mesh()
    oneshot_counts = phase_oneshot()
    serve_mesh_counts = phase_serve_mesh()
    phase_dryrun()
    phase_report()
    arch_counts = phase_archs()
    moe_counts = phase_moe()
    recurrent_counts = phase_recurrent()
    rows = phase_timing(main_err, {"serve": serve_counts, "serve_dense": dense_counts,
                                   "serve_load": load_counts, "serve_spec": spec_counts,
                                   "serve_fault": fault_counts, "train": train_counts,
                                   **mesh_counts, **oneshot_counts, **serve_mesh_counts,
                                   **arch_counts, **moe_counts, **recurrent_counts})
    emit("timing", rows=len(rows))
    card = _card()
    RESULT["kernels_line"] = rows
    RESULT["card"] = card
    RESULT["torch"] = torch.__version__
    RESULT["cuda"] = torch.version.cuda
    RESULT["seconds"] = round(time.perf_counter() - t_start, 3)
    out_dir = os.path.join(ROOT, "results")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(RESULT, f, indent=1)
    print(json.dumps({"kernels": [
        {**{k: row[k] for k in ("name", "route", "source", "replaces", "launches",
                                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "device_ms", "library_device_ms")},
         **{k: row[k] for k in ("variant", "path", "shape", "tflops", "row_pass_device_ms",
                                "combine_device_ms") if k in row}}
        for row in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
