#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and check it.

    python3 chip_smoke.py

Run from the repository root (it puts ``src`` on ``sys.path`` itself). It
needs one NVIDIA GPU, ``nvcc`` and Triton; it builds every kernel from the
sources in the checkout and imports no JAX. Phases, each printing one JSON
line, and any failure ends the run with a non-zero exit:

1. build   compile ``csrc/paged_attention.cu`` (nvcc, sm_90a) and the
           Triton RMSNorm kernel, concurrently;
2. kernels each kernel against its plain PyTorch version on the card, over
           the JAX package's case tables and the serving path's shapes
           (f32 within 1e-4: the page loop sums in another order than the
           gather; bf16 within 2e-2). TF32 is off for every matmul;
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
5. timing  each kernel, its plain version and one PyTorch library call at
           the serving path's shapes, beside the bound: ``ms`` back to back
           with CUDA events (what an eager caller pays, host dispatch
           included), ``device_ms`` replayed from a CUDA graph (the card's
           own time).

``python3 chip_smoke.py --profile`` adds a phase between 4 and 5: the
serve trace under ``torch.profiler``, for the device's busy share and the
kernel-time breakdown.

It then prints the ``kernels`` line, the card's name and power limit
(``nvidia-smi``) and, last, ``{"ok": true, "device": {...}}``. Details go
to ``results/chip_smoke.json``.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# NVIDIA H100 SXM data sheet: HBM rate, dense tensor-core bf16, fp32 (no TC)
HBM_BYTES_PER_S = 3.35e12
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
ARCH = "tinyllama-1.1b"
DEV = "cuda"
RESULT: dict = {}


def _config():
    from repro_torch.configs import get_config

    return get_config(ARCH)


def emit(phase: str, **fields) -> None:
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


def graph_ms(fn, iters: int = 100) -> float:
    """Device time per call without host dispatch: ``iters`` calls captured
    into one CUDA graph, replayed once between two events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------


def phase_build():
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import ops as PA
    from repro_torch.kernels.rmsnorm import ops as RMS
    from repro_torch.kernels.rmsnorm import kernel as RK

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        cu = pool.submit(build.compile_library, "paged_attention")
        tr = pool.submit(RK.compile_kernel)
        lib_path = cu.result()
        tr.result()
    PA.load()
    # the first launch compiles the Triton kernel for these constants
    x = torch.ones((1, 2048), dtype=torch.bfloat16, device=DEV)
    RMS.rmsnorm(x, torch.ones(2048, dtype=torch.bfloat16, device=DEV))
    torch.cuda.synchronize()
    log = lib_path.with_name(lib_path.name + ".log").read_text() \
        if lib_path.with_name(lib_path.name + ".log").exists() else ""
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    from repro_torch.device import features

    emit("build", seconds=round(time.perf_counter() - t0, 3), features=features(),
         library=str(lib_path.relative_to(ROOT)), ptxas=ptxas)


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
    from repro_torch.kernels.paged_attention import ops as PA
    from repro_torch.kernels.paged_attention import ref as PR
    from repro_torch.kernels.rmsnorm import ops as RMS
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference

    fl = ("q", "k_pages", "v_pages")
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    checks = {"paged_attention": [], "paged_prefill_attention": [], "rmsnorm": []}
    main_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for case in cases.PAGED_CASES + [cases.MAIN_PAGED]:
            B, Hq, Hkv, D, ps, nL, P, lens, win, cap = case
            t = _tensors(cases.paged_case(B, Hq, Hkv, D, ps, nL, P, lens, seed=11), dtype, fl)
            args = (t["q"], t["k_pages"], t["v_pages"], t["block_tables"])
            kw = dict(q_position=t["q_position"], cache_len=t["cache_len"],
                      window=win, softcap=cap)
            out = PA.paged_attention(*args, **kw)
            torch.cuda.synchronize()
            e = _err(out, PR.paged_attention_reference(*args, **kw))
            checks["paged_attention"].append([dn, list(case[:8]), e])
            if e > tol[dtype]:
                raise AssertionError(f"paged_attention {dn} {case}: err {e} > {tol[dtype]}")
            if case is cases.MAIN_PAGED and dtype is torch.bfloat16:
                main_err["paged_attention"] = e
        for case in cases.PREFILL_CASES + [cases.MAIN_PREFILL]:
            B, C, Hq, Hkv, D, ps, nL, P, starts, win, cap = case
            t = _tensors(cases.prefill_case(B, C, Hq, Hkv, D, ps, nL, P, starts, seed=12),
                         dtype, fl)
            args = (t["q"], t["k_pages"], t["v_pages"], t["block_tables"])
            kw = dict(q_positions=t["q_positions"], cache_len=t["cache_len"],
                      causal=True, window=win, softcap=cap)
            out = PA.paged_prefill_attention(*args, **kw)
            torch.cuda.synchronize()
            e = _err(out, PR.paged_prefill_attention_reference(*args, **kw))
            checks["paged_prefill_attention"].append([dn, list(case[:9]), e])
            if e > tol[dtype]:
                raise AssertionError(f"paged_prefill {dn} {case}: err {e} > {tol[dtype]}")
            if case is cases.MAIN_PREFILL and dtype is torch.bfloat16:
                main_err["paged_prefill_attention"] = e
        for rows, d in cases.RMS_CASES + cases.MAIN_RMS:
            for zc in (False, True):
                c = cases.rms_case(rows, d, seed=13)
                x = torch.from_numpy(c["x"]).to(DEV, dtype)
                s = torch.from_numpy(c["scale"]).to(DEV, dtype)
                out = RMS.rmsnorm(x, s, 1e-6, zc)
                torch.cuda.synchronize()
                e = _err(out, rmsnorm_reference(x, s, 1e-6, zc))
                checks["rmsnorm"].append([dn, [rows, d, zc], e])
                if e > tol[dtype]:
                    raise AssertionError(f"rmsnorm {dn} {(rows, d, zc)}: err {e}")
                if (rows, d) == cases.MAIN_RMS[0] and not zc and dtype is torch.bfloat16:
                    main_err["rmsnorm"] = e
    emit("kernels", tf32=False, tolerance={"float32": 1e-4, "bfloat16": 2e-2},
         max_abs_err={k: max(c[2] for c in v) for k, v in checks.items()},
         main_shape_bf16_err=main_err, cases=checks)
    return main_err


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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = model.cfg
    prompts, max_new = _serve_trace(cfg)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sched, wall, _, n_tok = _serve_once(model, cfg, prompts, max_new, False)
    # device-side events only: a CPU op's self device time repeats the
    # time of the kernels it launched, which are listed on their own
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)

    def group(key: str) -> str:
        k = key.lower()
        if "paged_decode" in k or "paged_prefill" in k:
            return "paged attention (K3/K4)"
        if "rmsnorm" in k:
            return "rmsnorm (K1)"
        if any(t in k for t in ("gemm", "gemv", "cutlass", "sm90_", "nvjet", "cublas")):
            return "matmul"
        if "memcpy" in k or "memset" in k:
            return "copies"
        return "other elementwise/index"

    groups: dict = {}
    for e in events:
        g = groups.setdefault(group(e.key), [0.0, 0])
        g[0] += e.self_device_time_total / 1e3
        g[1] += e.count
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    emit("profile", wall_s=wall, tokens_per_s=n_tok / wall,
         ticks=sched.stats["ticks"], device_busy_ms=busy_us / 1e3,
         device_busy_share=busy_us / 1e6 / wall,
         # the profiler slows the host; against phase 4's unprofiled wall
         device_busy_share_unprofiled=busy_us / 1e6 / RESULT["serve"]["wall_s"],
         groups_ms_count={k: [round(v[0], 3), v[1]] for k, v in groups.items()},
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
    want = {"paged_attention": L * st["decode_steps"],
            "paged_prefill_attention": L * st["prefill_chunks"],
            "rmsnorm": (2 * L + 1) * forwards}
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
    if counts != want or min(counts.values()) <= 0:
        raise AssertionError(f"serve: launches {counts} != expected {want}")
    return model, counts


# ---------------------------------------------------------------------------
# phase 5: timing beside the bound
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
    n_keys = sum(lens)
    nbytes = (2 * B * Hq * D + 2 * n_keys * Hkv * D) * es + 4 * (B * nL + 2 * B)
    flops = 4 * Hq * D * n_keys
    bound, by = _bound_ms(nbytes, flops, "bfloat16")
    S = nL * ps
    kd = PR.gather_pages(t["k_pages"], t["block_tables"]).permute(0, 2, 1, 3)
    vd = PR.gather_pages(t["v_pages"], t["block_tables"]).permute(0, 2, 1, 3)
    kd = kd.repeat_interleave(Hq // Hkv, dim=1).contiguous()
    vd = vd.repeat_interleave(Hq // Hkv, dim=1).contiguous()
    qd = t["q"].permute(0, 2, 1, 3).contiguous()
    mask = (torch.arange(S, device=DEV)[None, :] < t["cache_len"][:, None])[:, None, None]
    rows.append(dict(
        name="paged_attention", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:43",
        shape=f"B={B} Hq={Hq} Hkv={Hkv} D={D} page={ps} lens={list(lens)} bf16",
        ms=cuda_ms(lambda: PA.paged_attention(*args, **kw)),
        device_ms=graph_ms(lambda: PA.paged_attention(*args, **kw)),
        library_device_ms=graph_ms(
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
    n_keys = sum(s + C for s in starts)
    pairs = sum(sum(s + c + 1 for c in range(C)) for s in starts)
    nbytes = (2 * B * C * Hq * D + 2 * n_keys * Hkv * D) * es + 4 * (B * nL + B * C + B)
    flops = 4 * Hq * D * pairs
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
        name="paged_prefill_attention", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:99",
        shape=f"B={B} C={C} Hq={Hq} Hkv={Hkv} D={D} page={ps} start={list(starts)} bf16",
        ms=cuda_ms(lambda: PA.paged_prefill_attention(*args, **kw)),
        device_ms=graph_ms(lambda: PA.paged_prefill_attention(*args, **kw)),
        library_device_ms=graph_ms(
            lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)),
        plain_ms=cuda_ms(lambda: PR.paged_prefill_attention_reference(*args, **kw), iters=50),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)),
        library="F.scaled_dot_product_attention on the pre-gathered dense view",
        bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops))

    # K1: RMSNorm at the decode shape (4 rows), and the prefill-chunk shape
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
    rows.append(dict(name="rmsnorm", route="triton",
                     source="src/repro_torch/kernels/rmsnorm/kernel.py",
                     replaces="src/repro/kernels/rmsnorm/kernel.py:22",
                     **extra[r0], prefill_shape=extra[cases.MAIN_RMS[1][0]]))
    for row in rows:
        row["launches"] = counts[row["name"]]
        row["max_abs_err"] = main_err[row["name"]]
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_build()
    main_err = phase_kernels()
    params = phase_parity()
    model, counts = phase_serve(params)
    if "--profile" in sys.argv[1:]:
        phase_profile(model)
    del model, params
    torch.cuda.empty_cache()
    rows = phase_timing(main_err, counts)
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
        {k: row[k] for k in ("name", "route", "source", "replaces", "launches",
                             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "device_ms", "library_device_ms")}
        for row in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
