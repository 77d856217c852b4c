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
           paths' shapes: paged attention (both routes, with the split-K
           cases too) and RMSNorm forward f32 within 1e-4 (the page loop
           sums in another order than the gather), bf16 within 2e-2 (RMSNorm
           also at the training shape and every model width, within
           ``cases.TOL_MAX`` of the largest |value| and ``cases.TOL_L2_RMS``
           of the relative L2 error), paged
           attention also within ``cases.TOL_MAX`` of the largest |value|
           and ``cases.TOL_L2_PAGED`` of the relative L2 error, two paged
           calls bitwise equal, and each dtype on its own paged route;
           flash attention forward and backward (dq, dk,
           dv against the plain version's autograd) and the RMSNorm
           backward within 1e-4 (f32) and 2e-2 (bf16) of the largest
           |value| (at least of 1), flash attention also within
           ``cases.TOL_L2`` and the RMSNorm backward within
           ``cases.TOL_L2_RMS`` of the relative L2 error (which a fault in
           some rows moves where the largest |value| lies in others); two
           flash backward calls, and two RMSNorm backward calls, must give
           bitwise-equal gradients; f32 flash must launch only the
           CUDA-core route and bf16 only the tensor-core route. TF32 is off
           for every matmul;
3. parity  tinyllama-1.1b at full width in fp32 with seeded weights: one
           64-token ``prefill_chunk`` (logits at every position) and
           DECODE_STEPS ``decode_step``s on the card (kernels) and on the
           CPU (plain versions); logits agree within LOGIT_TOL and greedy
           tokens agree wherever the top-2 gap exceeds it. The card with
           the plain versions and a float64 CPU run are the witnesses: the
           kernels' own share and each fp32 run's distance from exact,
           per layer too;
4. serve   tinyllama-1.1b in bf16 through ``BatchScheduler`` (batch 4,
           max_len 512, page 16, chunk 64, overlap): 8 requests of 64-256
           prompt tokens, 32 new tokens each. Launch counters are zeroed
           before and read after: paged decode 22 per decode step, paged
           prefill 22 per chunk, RMSNorm 45 per forward. Then the same
           trace again, flushing every tick, for time to first token;
5. train-parity  tinyllama-1.1b at full width in fp32, phase 3's weights:
           the loss and gradients of one batch (B=1, S=256, remat full) on
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
7. report  the same configuration REPORT_STEPS steps under the tracer
           (record in ``results/talp/<arch>/train_tracer/``) and under the
           null collector, launch counters exact for each; the tracer's
           record against the monitor's (the paper's cross-tool check: the
           same regions, each run's step count, train_step's counted FLOPs,
           bytes and model FLOPs per step within AGREE_TOL, factors that
           pass ``validate_pop``, hardware ``h100_sxm``); then the ``talp``
           CLI (``python -m repro_torch.core.pages``) as subprocesses:
           ``metadata``, ``ci-report`` into ``results/talp_site/index.html``,
           ``validate`` (0 violations) and ``badge``, each exiting 0, the
           page naming both experiments with a train_step table whose
           parallel efficiency is the monitor record's, and a badge with a
           number. For information only: the median step time under null,
           monitor and tracer, the trace's bytes against the record's,
           ``post_process``'s seconds and peak ``tracemalloc`` bytes against
           ``scan`` + ``build_table`` on the monitor's record, and the
           ``ci-report`` seconds;
8. timing  each kernel, its plain version and one PyTorch library call at
           the serving and training paths' shapes, beside the bound: ``ms``
           back to back with CUDA events (what an eager caller pays, host
           dispatch included), ``device_ms`` replayed from a CUDA graph (the
           card's own time); for K3 and K4 also ``cold_device_ms`` with the
           L2 cache flushed before each call, as the serving step finds it;
           for the K1 backward the row pass's and the combine's device times
           apart, from the profiler's kernel names.

``python3 chip_smoke.py --profile`` adds ``torch.profiler`` over the serve
trace (after phase 4) and over two training steps (after phase 6), for
the device's busy share and the kernel-time breakdown.

It then prints the ``kernels`` line, the card's name and power limit
(``nvidia-smi``) and, last, ``{"ok": true, "device": {...}}``. Details go
to ``results/chip_smoke.json``.
"""

from __future__ import annotations

import concurrent.futures
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
TRAIN_STEPS = 10
TRAIN_B, TRAIN_S, TRAIN_A = 4, 2048, 1
# Phase 7 runs the training configuration REPORT_STEPS steps more under the
# tracer and under the null collector, and holds the tracer's record to the
# monitor's: per step, train_step's counted FLOPs, bytes and model FLOPs
# within AGREE_TOL relative (both count step 0 with StepProfile.count).
REPORT_STEPS = 5
AGREE_TOL = 1e-6
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
        for rows, d in absolute + [cases.MAIN_RMS_TRAIN] + cases.RMS_WIDTH_CASES:
            for zc in (False, True):
                c = cases.rms_case(rows, d, seed=13)
                x = torch.from_numpy(c["x"]).to(DEV, dtype)
                s = torch.from_numpy(c["scale"]).to(DEV, dtype)
                out = RMS.rmsnorm(x, s, 1e-6, zc)
                torch.cuda.synchronize()
                want = rmsnorm_reference(x, s, 1e-6, zc)
                e, rel, l2 = (_err(out, want), cases.max_rel_err(_np(out), _np(want)),
                              cases.l2_rel_err(_np(out), _np(want)))
                checks["rmsnorm"].append([dn, [rows, d, zc], e, rel, l2])
                if not (rel <= cases.TOL_MAX[dn] and l2 <= cases.TOL_L2_RMS[dn]
                        and ((rows, d) not in absolute or e <= tol[dtype])):  # NaN fails
                    raise AssertionError(f"rmsnorm {dn} {(rows, d, zc)}: err {e}, "
                                         f"of the largest {rel}, relative L2 {l2}")
                if (rows, d) == cases.MAIN_RMS[0] and not zc and dtype is torch.bfloat16:
                    main_err["rmsnorm"] = e
                    main_err["l2_rel_err"]["rmsnorm"] = l2
    deterministic = _check_training_kernels(checks, main_err)
    emit("kernels", tf32=False, tolerance={"float32": 1e-4, "bfloat16": 2e-2},
         training_tolerance="of the largest |value|, at least of 1",
         flash_l2_tolerance=cases.TOL_L2,
         paged_l2_tolerance=cases.TOL_L2_PAGED, rmsnorm_l2_tolerance=cases.TOL_L2_RMS,
         max_abs_err={k: max(c[2] for c in v) for k, v in checks.items()
                      if not k.endswith("_routes")},
         flash_routes=checks["flash_routes"], paged_routes=checks["paged_routes"],
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
        B, C, Hq, Hkv, D, ps, nL, P, starts, win, cap = case
        t = _tensors(cases.prefill_case(B, C, Hq, Hkv, D, ps, nL, P, starts, seed=seed),
                     dtype, fl)
        kw = dict(q_positions=t["q_positions"], cache_len=t["cache_len"], causal=True,
                  window=win, softcap=cap)
    return (t["q"], t["k_pages"], t["v_pages"], t["block_tables"]), kw


def paged_errors(out, want) -> dict:
    """The gates' readings of a paged output against its plain version:
    ``abs`` the largest absolute error, ``max`` ``cases.max_rel_err``,
    ``l2`` ``cases.l2_rel_err``."""
    import numpy as np

    from repro_torch.kernels import cases

    got, w = _np(out), _np(want)
    return {"abs": float(np.abs(got - w).max(initial=0.0)),
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
        return cases.PAGED_CASES + cases.PAGED_SPLIT_CASES + [cases.MAIN_PAGED]
    return cases.PREFILL_CASES + cases.PREFILL_SPLIT_CASES + [cases.MAIN_PREFILL]


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
        moved = {r: PA.ROUTE_LAUNCHES[r] - before[r] for r in before}
        want = {r: (n if r == PA.route(dtype) else 0) for r in before}
        checks["paged_routes"][dn] = moved
        if moved != want:
            raise AssertionError(f"paged attention {dn}: route launches {moved} != {want}")


def _np(t):
    return t.detach().float().cpu().numpy()


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
    """The plain version's output and its autograd's (dq, dk, dv), as numpy."""
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_backward_reference,
        flash_attention_reference,
    )

    return (_np(flash_attention_reference(q, k, v, **kw)),
            [_np(w) for w in flash_attention_backward_reference(q, k, v, dout, **kw)])


def flash_errors(out, grads, want) -> dict:
    """Both gates' readings of a flash output and its gradients (dq, dk,
    dv) against ``flash_reference``'s ``want``: ``max`` is
    ``cases.max_rel_err``, ``l2`` is ``cases.l2_rel_err``; the backward's
    are the largest over the three gradients."""
    from repro_torch.kernels import cases

    want_o, want_g = want
    got = _np(out)
    errs = {"fwd_max": cases.max_rel_err(got, want_o), "fwd_l2": cases.l2_rel_err(got, want_o)}
    got = [_np(g) for g in grads]
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
                   + [cases.MAIN_FLASH + (0, None)])
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
            del grads, out
            torch.cuda.empty_cache()
        # each dtype on its own route: two forwards and two backwards a case
        moved = {r: FA.ROUTE_LAUNCHES[r] - before[r] for r in before}
        want = {r: (4 * len(flash_cases) if r == FA.route(dtype) else 0) for r in before}
        checks["flash_routes"][dn] = moved
        if moved != want:
            raise AssertionError(f"flash attention {dn}: route launches {moved} != {want}")
        for rows, d in (cases.RMS_CASES + cases.MAIN_RMS + [cases.MAIN_RMS_TRAIN]
                        + cases.RMS_WIDTH_CASES):
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
                got, want = (_np(xl.grad), _np(sl.grad)), (_np(dx), _np(ds))
                e = max(cases.max_rel_err(g, w) for g, w in zip(got, want))
                l2 = max(cases.l2_rel_err(g, w) for g, w in zip(got, want))
                checks["rmsnorm_backward"].append([dn, [rows, d, zc], e, l2])
                if not (e <= cases.TOL_MAX[dn] and l2 <= cases.TOL_L2_RMS[dn]):
                    raise AssertionError(f"rmsnorm backward {dn} {(rows, d, zc)}: err {e}, "
                                         f"relative L2 {l2}")
                if (rows, d) == cases.MAIN_RMS_TRAIN and not zc and dtype is torch.bfloat16:
                    main_err["rmsnorm_backward"] = e
                    main_err["l2_rel_err"]["rmsnorm_backward"] = l2
    if not deterministic:
        raise AssertionError("flash attention backward: two calls gave different gradients")
    return deterministic


# ---------------------------------------------------------------------------
# phase 3: full width, card vs CPU
# ---------------------------------------------------------------------------


def _greedy_run(model, prompt, page: int, toks=None):
    """One ``prefill_chunk`` (every position's logits) then DECODE_STEPS
    ``decode_step``s, feeding ``toks`` or, when None, the run's own greedy
    tokens. Returns, on the CPU in float64, the logits (positions, V), the
    fed tokens, and the residual stream after every layer of every forward
    (prefill first, then each decode step)."""
    import torch

    dev, C = model.device, prompt.shape[1]
    nL = -(-(C + DECODE_STEPS) // page)
    caches = model.init_cache(1, nL * page, page_size=page, num_pages=nL)
    tb = torch.arange(nL, dtype=torch.int32, device=dev)[None]
    resid: list = []
    inner = model._apply_slot

    def recording(*a, **k):
        out = inner(*a, **k)
        resid.append(out[0].double().cpu())
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
    cpu = Transformer.from_init(cfg, seed=0, device="cpu")
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
    params = cpu.params()
    del cpu, gpu
    torch.cuda.empty_cache()
    return params


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
    bad = torch.zeros((), dtype=torch.bool, device=DEV)
    for name in ("decode_step", "prefill_chunk"):
        orig = getattr(model, name)

        def checked(*a, _orig=orig, **k):
            out = _orig(*a, **k)
            bad.logical_or_(~torch.isfinite(out).all())
            return out

        setattr(model, name, checked)

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
    return model, counts


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
                            remat="full")
    batch = {k: v[0] for k, v in SyntheticLM(DataConfig(
        global_batch=1, seq_len=256, vocab=cfg.vocab, pad_fraction=0.05,
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
    emit("train_parity", arch=ARCH, dtype="float32", batch=1, seq_len=256, remat="full",
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


def _train_expected_launches(cfg, steps: int, accum: int) -> dict:
    """Per microbatch, L layers, remat full: the forward runs 2 RMSNorms and
    one attention per layer plus the final norm (2L+1, L); the backward
    recomputes every layer once (2L RMSNorms and L attentions more: the
    final norm sits outside the checkpointed layers) and then launches one
    flash backward per layer and one RMSNorm backward per norm (L, 2L+1)."""
    L = cfg.n_layers
    assert cfg.remat == "full"
    per = {"flash_attention": 2 * L, "flash_attention_backward": L,
           "rmsnorm": 4 * L + 1, "rmsnorm_backward": 2 * L + 1}
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
    shutil.rmtree(TALP_DIR, ignore_errors=True)  # the CI folder phase 7 renders
    torch.cuda.reset_peak_memory_stats()
    cfg, data, loop = _train_loop("monitor", TRAIN_STEPS)
    reset_launch_counts()
    loop.run()
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in counts}
    want.update(_train_expected_launches(cfg, TRAIN_STEPS, A))
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
         steps=TRAIN_STEPS, losses=losses, step_seconds=secs,
         step0_seconds=secs[0], median_step_seconds=median,
         tokens_per_s=A * B * S / median,
         real_tokens_per_step=float(sum(int((data.batch_at(i)["labels"] >= 0).sum())
                                        for i in range(TRAIN_STEPS)) / TRAIN_STEPS),
         model_flops_per_step=model_flops, mfu=model_flops / median / PEAK_FLOPS["bfloat16"],
         counted_flops_per_step=ts.counters.useful_flops / max(ts.measurements.num_steps, 1),
         peak_mem_bytes=peak, launches=counts, expected_launches=want,
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
    time of the kernels it launched, which are listed on their own."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


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
    if not m or m.groups() != ("2", "0"):
        failures.append(f"talp validate: {cli['validate']['stdout'][-400:]!r}")
    index = os.path.join(SITE_DIR, "index.html")
    page = open(index).read() if os.path.exists(index) else ""
    for exp in ("train_monitor", "train_tracer"):
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
# phase 8: timing beside the bound
# ---------------------------------------------------------------------------


def _bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_timing(main_err, counts):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cases
    from repro_torch.kernels.paged_attention import ops as PA
    from repro_torch.kernels.paged_attention import ref as PR
    from repro_torch.kernels.rmsnorm import ops as RMS
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference

    bf = torch.bfloat16
    es = 2  # bf16 bytes
    fl = ("q", "k_pages", "v_pages")
    rows = []

    # K3: paged decode at the serving shape
    B, Hq, Hkv, D, ps, nL, P, lens, _, _ = cases.MAIN_PAGED
    t = _tensors(cases.paged_case(B, Hq, Hkv, D, ps, nL, P, lens, seed=41), bf, fl)
    args = (t["q"], t["k_pages"], t["v_pages"], t["block_tables"])
    kw = dict(q_position=t["q_position"], cache_len=t["cache_len"])
    flops, nbytes = PA.launch_costs(t["q"], t["k_pages"], nL, lens, [n - 1 for n in lens],
                                    causal=False)
    bound, by = _bound_ms(nbytes, flops, "bfloat16")
    S = nL * ps
    kd = PR.gather_pages(t["k_pages"], t["block_tables"]).permute(0, 2, 1, 3)
    vd = PR.gather_pages(t["v_pages"], t["block_tables"]).permute(0, 2, 1, 3)
    kd = kd.repeat_interleave(Hq // Hkv, dim=1).contiguous()
    vd = vd.repeat_interleave(Hq // Hkv, dim=1).contiguous()
    qd = t["q"].permute(0, 2, 1, 3).contiguous()
    mask = (torch.arange(S, device=DEV)[None, :] < t["cache_len"][:, None])[:, None, None]
    rows.append(dict(
        name="paged_attention", route="cuda", variant=PA.route(bf),
        source="src/repro_torch/csrc/paged_attention_tc.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:43",
        shape=f"B={B} Hq={Hq} Hkv={Hkv} D={D} page={ps} lens={list(lens)} bf16",
        ms=cuda_ms(lambda: PA.paged_attention(*args, **kw)),
        device_ms=graph_ms(lambda: PA.paged_attention(*args, **kw)),
        library_device_ms=graph_ms(
            lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)),
        cold_device_ms=cold_graph_ms(lambda: PA.paged_attention(*args, **kw)),
        library_cold_device_ms=cold_graph_ms(
            lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)),
        plain_ms=cuda_ms(lambda: PR.paged_attention_reference(*args, **kw), iters=50),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)),
        library="F.scaled_dot_product_attention on the pre-gathered dense view",
        bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops))

    # K4: paged prefill at the serving shape
    B, C, Hq, Hkv, D, ps, nL, P, starts, _, _ = cases.MAIN_PREFILL
    t = _tensors(cases.prefill_case(B, C, Hq, Hkv, D, ps, nL, P, starts, seed=42), bf, fl)
    args = (t["q"], t["k_pages"], t["v_pages"], t["block_tables"])
    kw = dict(q_positions=t["q_positions"], cache_len=t["cache_len"], causal=True)
    flops, nbytes = PA.launch_costs(t["q"], t["k_pages"], nL, [s + C for s in starts], starts,
                                    causal=True)
    bound, by = _bound_ms(nbytes, flops, "bfloat16")
    S = nL * ps
    kd = PR.gather_pages(t["k_pages"], t["block_tables"]).permute(0, 2, 1, 3)
    vd = PR.gather_pages(t["v_pages"], t["block_tables"]).permute(0, 2, 1, 3)
    kd = kd.repeat_interleave(Hq // Hkv, dim=1).contiguous()
    vd = vd.repeat_interleave(Hq // Hkv, dim=1).contiguous()
    qd = t["q"].permute(0, 2, 1, 3).contiguous()
    kpos = torch.arange(S, device=DEV)
    mask = ((kpos[None, None, :] <= t["q_positions"][:, :, None])
            & (kpos[None, None, :] < t["cache_len"][:, None, None]))[:, None]
    rows.append(dict(
        name="paged_prefill_attention", route="cuda", variant=PA.route(bf),
        source="src/repro_torch/csrc/paged_attention_tc.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:99",
        shape=f"B={B} C={C} Hq={Hq} Hkv={Hkv} D={D} page={ps} start={list(starts)} bf16",
        ms=cuda_ms(lambda: PA.paged_prefill_attention(*args, **kw)),
        device_ms=graph_ms(lambda: PA.paged_prefill_attention(*args, **kw)),
        library_device_ms=graph_ms(
            lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)),
        cold_device_ms=cold_graph_ms(lambda: PA.paged_prefill_attention(*args, **kw)),
        library_cold_device_ms=cold_graph_ms(
            lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)),
        plain_ms=cuda_ms(lambda: PR.paged_prefill_attention_reference(*args, **kw), iters=50),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)),
        library="F.scaled_dot_product_attention on the pre-gathered dense view",
        bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops))

    # K1: RMSNorm at the decode shape (4 rows), and the prefill-chunk shape;
    # no operand requires grad, so the wrapper launches the forward directly
    # as under the serving path's inference mode
    extra = {}
    for r, d in cases.MAIN_RMS:
        c = cases.rms_case(r, d, seed=43)
        x = torch.from_numpy(c["x"]).to(DEV, bf)
        s = torch.from_numpy(c["scale"]).to(DEV, bf)
        nbytes = (2 * r * d + d) * es
        bound, by = _bound_ms(nbytes, 4 * r * d, "bfloat16")
        lib = (cuda_ms(lambda: F.rms_norm(x, (d,), s, 1e-6))
               if hasattr(F, "rms_norm") else None)
        extra[r] = dict(
            shape=f"rows={r} d={d} bf16",
            ms=cuda_ms(lambda: RMS.rmsnorm(x, s)),
            device_ms=graph_ms(lambda: RMS.rmsnorm(x, s)),
            library_device_ms=(graph_ms(lambda: F.rms_norm(x, (d,), s, 1e-6))
                               if lib is not None else None),
            plain_ms=cuda_ms(lambda: rmsnorm_reference(x, s)),
            library_ms=lib, library="F.rms_norm" if lib is not None else None,
            bound_ms=bound, bound_by=by, bytes=nbytes, flops=4 * r * d)
    r0 = cases.MAIN_RMS[0][0]
    rows.append(dict(name="rmsnorm", route="cuda", source="src/repro_torch/csrc/rmsnorm.cu",
                     replaces="src/repro/kernels/rmsnorm/kernel.py:22",
                     **extra[r0], chunk_shape=extra[cases.MAIN_RMS[1][0]],
                     train_shape=_rms_train_timing()))
    rows += _training_timing()
    for row in rows:
        row["launches"] = counts["train"].get(row["name"], 0) or counts["serve"][row["name"]]
        row["launches_by_path"] = {p: c[row["name"]] for p, c in counts.items()}
        row["max_abs_err"] = main_err[row["name"]]
        if row["name"] in main_err["l2_rel_err"]:
            row["l2_rel_err"] = main_err["l2_rel_err"][row["name"]]
    return rows


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


def _rms_train_timing() -> dict:
    """The RMSNorm forward at the training shape (B*S rows of 2048)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cases
    from repro_torch.kernels.rmsnorm import ops as RMS
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference

    r, d = cases.MAIN_RMS_TRAIN
    c = cases.rms_case(r, d, seed=45)
    x = torch.from_numpy(c["x"]).to(DEV, torch.bfloat16)
    s = torch.from_numpy(c["scale"]).to(DEV, torch.bfloat16)
    nbytes = (2 * r * d + d) * 2
    bound, by = _bound_ms(nbytes, 4 * r * d, "bfloat16")
    return dict(shape=f"rows={r} d={d} bf16", ms=cuda_ms(lambda: RMS.rmsnorm(x, s)),
                device_ms=graph_ms(lambda: RMS.rmsnorm(x, s)),
                plain_ms=cuda_ms(lambda: rmsnorm_reference(x, s), iters=50),
                library_ms=cuda_ms(lambda: F.rms_norm(x, (d,), s, 1e-6)),
                library_device_ms=graph_ms(lambda: F.rms_norm(x, (d,), s, 1e-6)),
                library="F.rms_norm", bound_ms=bound, bound_by=by, bytes=nbytes,
                flops=4 * r * d)


def _training_timing() -> list:
    """K2 forward and backward and the K1 backward at the training path's
    shapes (B=4, S=2048, Hq=32, Hkv=4, D=64, causal; 8192 x 2048), bf16.
    The library calls: SDPA (causal; k/v repeated to the q heads, prepared
    outside the timing), its backward alone (autograd of one saved SDPA
    output; its dk/dv are per q head, so the GQA sum is not in it), and
    the autograd of ``F.rms_norm``; the two backwards' device times from
    ``autograd_device_ms``. K2 is the bf16 route (``tensor_cores``), with
    its achieved TFLOP/s over the counted FLOPs (``launch_costs``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cases
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_backward_reference,
        flash_attention_reference,
    )
    from repro_torch.kernels.rmsnorm import ops as RMS
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_backward_reference

    bf = torch.bfloat16
    rows = []
    B, S, _, Hq, Hkv, D, causal, _, _ = cases.MAIN_FLASH
    c = cases.flash_case(B, S, S, Hq, Hkv, D, seed=44)
    q, k, v, do = (torch.from_numpy(c[n]).to(DEV, bf) for n in ("q", "k", "v", "dout"))
    pos = FA.positions_rows(None, B, S, DEV)
    o, lse = FA.flash_forward(q, k, v, pos, pos, None, causal, None, None)
    G = Hq // Hkv
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t.transpose(1, 2).repeat_interleave(G, dim=1).contiguous() for t in (k, v))
    dot = do.transpose(1, 2).contiguous()
    leaves = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    out_lib = F.scaled_dot_product_attention(*leaves, is_causal=True)
    shape = f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} causal bf16"
    common = dict(route="cuda", variant=FA.route(bf),
                  source="src/repro_torch/csrc/flash_attention_tc.cu",
                  replaces="src/repro/kernels/flash_attention/kernel.py:35", shape=shape)
    fwd = lambda: FA.flash_forward(q, k, v, pos, pos, None, causal, None, None)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)  # noqa: E731
    flops, nbytes = FA.launch_costs(q, k, causal, None, False)
    bound, by = _bound_ms(nbytes, flops, "bfloat16")
    dev = graph_ms(fwd, iters=20)
    rows.append(dict(name="flash_attention", **common,
                     ms=cuda_ms(fwd, iters=50, warmup=5), device_ms=dev,
                     tflops=flops / dev / 1e9,
                     plain_ms=cuda_ms(lambda: flash_attention_reference(q, k, v), 5, 1),
                     library_ms=cuda_ms(sdpa, iters=20, warmup=3),
                     library_device_ms=graph_ms(sdpa, iters=10),
                     library_device_via="cuda graph",
                     library="F.scaled_dot_product_attention(is_causal=True), k/v repeated",
                     bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops))
    bwd = lambda: FA.flash_backward(q, k, v, o, lse, do, pos, pos, None,  # noqa: E731
                                    causal, None, None)
    flops, nbytes = FA.launch_costs(q, k, causal, None, True)
    bound, by = _bound_ms(nbytes, flops, "bfloat16")
    dev = graph_ms(bwd, iters=10)
    lib_dev, via = autograd_device_ms(
        lambda: F.scaled_dot_product_attention(*leaves, is_causal=True), leaves, dot)
    rows.append(dict(name="flash_attention_backward", **common,
                     note="the backward of K2: no Pallas counterpart",
                     ms=cuda_ms(bwd, iters=20, warmup=3), device_ms=dev,
                     tflops=flops / dev / 1e9,
                     plain_ms=cuda_ms(lambda: flash_attention_backward_reference(q, k, v, do),
                                      3, 1),
                     library_ms=cuda_ms(lambda: torch.autograd.grad(
                         out_lib, leaves, dot, retain_graph=True), iters=10, warmup=2),
                     library_device_ms=lib_dev, library_device_via=via,
                     library="autograd of one saved F.scaled_dot_product_attention output",
                     bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops))
    del out_lib
    r, d = cases.MAIN_RMS_TRAIN
    rc = cases.rms_case(r, d, seed=46)
    x, sc, dy = (torch.from_numpy(rc[n]).to(DEV, bf) for n in ("x", "scale", "dy"))
    xl, sl = x.clone().requires_grad_(True), sc.clone().requires_grad_(True)
    y_lib = F.rms_norm(xl, (d,), sl, 1e-6)
    kb = lambda: RMS.launch_backward(x, sc, dy, 1e-6, False)  # noqa: E731
    nbytes = 3 * r * d * 2 + 2 * d * 2  # x, dy read, dx written; scale, dscale
    bound, by = _bound_ms(nbytes, 8 * r * d, "bfloat16")
    lib_dev, via = autograd_device_ms(lambda: F.rms_norm(xl, (d,), sl, 1e-6), (xl, sl), dy,
                                      iters=20)
    split = _kernel_split_ms(kb, {"row_pass": "rmsnorm_bwd", "combine": "rmsnorm_dscale"})
    rows.append(dict(name="rmsnorm_backward", route="cuda",
                     source="src/repro_torch/csrc/rmsnorm.cu",
                     replaces="src/repro/kernels/rmsnorm/kernel.py:22",
                     note="the backward of K1: no Pallas counterpart",
                     shape=f"rows={r} d={d} bf16", ms=cuda_ms(kb), device_ms=graph_ms(kb),
                     row_pass_device_ms=split["row_pass"], combine_device_ms=split["combine"],
                     profiled_launches=[split["row_pass_launches_seen"],
                                        split["combine_launches_seen"]],
                     plan=RMS.plan(r, d, 2, torch.cuda.get_device_properties(0)
                                   .multi_processor_count, True)._asdict(),
                     plain_ms=cuda_ms(lambda: rmsnorm_backward_reference(x, sc, dy), iters=20),
                     library_ms=cuda_ms(lambda: torch.autograd.grad(
                         y_lib, (xl, sl), dy, retain_graph=True)),
                     library_device_ms=lib_dev, library_device_via=via,
                     library="autograd of F.rms_norm",
                     bound_ms=bound, bound_by=by, bytes=nbytes, flops=8 * r * d))
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    profile = "--profile" in sys.argv[1:]
    t_start = time.perf_counter()
    _T_PHASE[0] = t_start
    phase_build()
    main_err = phase_kernels()
    params = phase_parity()
    model, serve_counts = phase_serve(params)
    if profile:
        phase_profile(model)
    del model
    torch.cuda.empty_cache()
    phase_train_parity(params)
    del params
    train_counts = phase_train(profile)
    phase_report()
    rows = phase_timing(main_err, {"serve": serve_counts, "train": train_counts})
    emit("timing", rows=len(rows))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
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
         **{k: row[k] for k in ("variant", "tflops", "row_pass_device_ms", "combine_device_ms")
            if k in row}}
        for row in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
