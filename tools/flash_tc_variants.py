#!/usr/bin/env python3
"""Variants of the bf16 flash-attention kernels at tinyllama-1.1b's training
shape (B=4, S=2048, Hq=32, Hkv=4, D=64, causal), on one CUDA card.

    python3 tools/flash_tc_variants.py [--out PATH]

Run from the repository root. Each variant is a text edit of
``src/repro_torch/csrc/flash_attention_tc.cu`` inside one kernel, written
under ``build/repro_torch/variants/`` and compiled there with the flags of
``kernels/build.py``; the committed source is left as it is. Two kinds:

- leave-outs, which split the forward's time: ``no_score_code`` (the
  scores go straight to P.V: no scale, mask, online softmax or rescale),
  ``no_products`` (no wgmma: made-up scores, and P folded into O without
  V), ``loop_only`` (both: the tile loads and the loop remain). Their
  outputs are wrong by design and are not checked.
- planted faults, each a bug a kernel of this design could have, held to
  the gates of ``chip_smoke.flash_failures`` (``cases.TOL_MAX`` and
  ``cases.TOL_L2``). A fault that passes the gates fails the run.

The committed kernel runs beside them: both gates' readings at every flash
case of ``chip_smoke``'s phase 2 (both dtypes, no gate applied: these are
readings), its readings and its forward and backward times at the training
shape, timed in the same rounds as the leave-outs. Prints one JSON line per
result and writes them all to ``--out`` (default
``results/flash_tc_variants.json``); exits 1 if the committed kernel fails
a gate at the training shape or a planted fault passes them.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

FWD, DQ, DKDV = "flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel", "flash_bwd_dkdv_tc_kernel"
# the forward's per-score code: from the visibility mask to the rescale of O
SCORE_CODE = (FWD, "      const uint32_t vis = all ? 0xffffffffu", "      uint32_t af[4][4];")
S_PRODUCT = (FWD, "wgmma_ss(s, desc_k<TR>(q_s, 64 * wg, ks), desc_k<TI>(kt_s, 0, ks), ks > 0);",
             "for (int e = 0; e < 32; ++e)\n"
             "          s[e] = 0.125f * static_cast<float>((lane + e + ks + kt) & 15);")
PV_PRODUCT = (FWD, "wgmma_rs(o[cb], af[kk], desc_mn<TI>(vt_s, kk, cb));",
              "o[cb][kk] += __uint_as_float((af[kk][0] ^ af[kk][1] ^ af[kk][2] ^ af[kk][3])"
              " & 0x3f7fffffu);")
# the loop's next tile, except that blocks in the second half of the
# sequence stop before their last visible key tile
SKIP_LAST_LATE = ("const int kn = next(kt + 1);",
                  "const int kn = q0 >= a.Sq / 2 && next(next(kt + 1) + 1) >= nk ? nk"
                  " : next(kt + 1);")

LEAVE_OUTS = {
    "no_score_code": [("cut",) + SCORE_CODE],
    "no_products": [("replace",) + S_PRODUCT, ("replace",) + PV_PRODUCT],
    "loop_only": [("cut",) + SCORE_CODE, ("replace",) + S_PRODUCT, ("replace",) + PV_PRODUCT],
}
FAULTS = {
    # O is not rescaled when the running max grows (l still is)
    "fwd_no_rescale": [("replace", FWD, "o[cb][e] *= alpha[(e >> 1) & 1];", "o[cb][e] *= 1.f;")],
    # the diagonal key tile is dropped for the late rows
    "fwd_late_rows_skip_last_tile": [("replace", FWD) + SKIP_LAST_LATE],
    "dq_late_rows_skip_last_tile": [("replace", DQ) + SKIP_LAST_LATE],
    # the second warpgroup masks its keys with the first one's positions
    "dkdv_wg1_key_positions": [("replace", DKDV, "kp[hf] = kin[hf] ? kpos[c] : 0;",
                                "kp[hf] = kin[hf] ? kpos[c - 64 * wg] : 0;")],
}


def edit(text: str, ops) -> str:
    """Apply (kind, kernel, a, b) edits inside one kernel's body each:
    ``replace`` a by b, ``cut`` from a up to b (b kept). Each a (and b)
    must occur exactly once in that kernel."""
    for kind, kernel, a, b in ops:
        start = text.index(f" {kernel}(Args a) {{")
        end = text.find("__global__", start)
        end = len(text) if end < 0 else end
        body = text[start:end]
        if body.count(a) != 1 or (kind == "cut" and body.count(b) != 1):
            raise ValueError(f"{kernel}: edit anchor not found exactly once: {a!r}")
        if kind == "replace":
            body = body.replace(a, b)
        else:
            i = body.index(a)
            body = body[:i] + body[body.index(b, i):]
        text = text[:start] + body + text[end:]
    return text


def build_variants(names_ops: dict) -> dict:
    """Write and compile every variant at once; {name: library path}."""
    from repro_torch import device as D
    from repro_torch.kernels import build

    src = (build.CSRC / "flash_attention_tc.cu").read_text()
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, ops in names_ops.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(edit(src, ops))
        lib = out_dir / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [D.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building variant {name}:\n{log}")
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "results", "flash_tc_variants.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("flash_tc_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as C
    from repro_torch.kernels import build, cases
    from repro_torch.kernels.flash_attention import ops as FA

    torch.backends.cuda.matmul.allow_tf32 = False
    results, failed = [], []

    def emit(**row):
        results.append(row)
        print(json.dumps(row), flush=True)

    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        # the committed libraries of both routes, beside the variants
        built = [pool.submit(build.compile_library, n)
                 for n in ("flash_attention", "flash_attention_tc")]
        paths = build_variants({**LEAVE_OUTS, **FAULTS})
        for f in built:
            f.result()
    FA.load()
    committed = FA._lib_tc()
    libs = {"committed": committed}
    libs.update({n: FA.bind_tc(ctypes.CDLL(str(p))) for n, p in paths.items()})

    # the committed kernel at every flash case of phase 2: readings only
    flash_cases = ([c + (0, None) for c in cases.FLASH_CASES] + cases.FLASH_KVLEN_CASES)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for case in flash_cases:
            (q, k, v, dout), kw = C.flash_inputs(case, dtype, seed=14)
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out = FA.flash_attention(*leaves, **kw)
            out.backward(dout)
            errs = C.flash_errors(out, [t.grad for t in leaves],
                                  C.flash_reference(q, k, v, dout, kw))
            emit(variant="committed", dtype=dn, case=list(case), **errs,
                 past_gate=C.flash_failures(errs, dn))

    # the training shape
    B, S, _, Hq, Hkv, D, causal, _, _ = cases.MAIN_FLASH
    (q, k, v, dout), kw = C.flash_inputs(cases.MAIN_FLASH + (0, None), torch.bfloat16, seed=14)
    pos = FA.positions_rows(None, B, S, C.DEV)
    want = C.flash_reference(q, k, v, dout, kw)
    fwd = lambda: FA.flash_forward(q, k, v, pos, pos, None, causal, None, None)  # noqa: E731
    fwd_flops = FA.launch_costs(q, k, causal, None, False)[0]
    try:
        for name in ["committed", *FAULTS]:
            FA._lib_tc = lambda lib=libs[name]: lib
            o, lse = fwd()
            grads = FA.flash_backward(q, k, v, o, lse, dout, pos, pos, None, causal, None, None)
            torch.cuda.synchronize()
            errs = C.flash_errors(o, grads, want)
            bad = C.flash_failures(errs, "bfloat16")
            emit(variant=name, dtype="bfloat16", case=list(cases.MAIN_FLASH), **errs,
                 past_gate=bad, caught=bool(bad))
            if (name == "committed") == bool(bad):
                failed.append(name)
        times = {n: [] for n in ["committed", *LEAVE_OUTS]}
        bwd_ms = []
        for _ in range(2):  # two rounds, the variants interleaved
            for name in times:
                FA._lib_tc = lambda lib=libs[name]: lib
                times[name].append(C.graph_ms(fwd, iters=20))
            FA._lib_tc = lambda: committed
            o, lse = fwd()
            bwd_ms.append(C.graph_ms(lambda: FA.flash_backward(
                q, k, v, o, lse, dout, pos, pos, None, causal, None, None), iters=10))
    finally:
        FA._lib_tc = lambda: committed
    for name, ms in times.items():
        emit(variant=name, forward_device_ms=ms,
             tflops=[fwd_flops / t / 1e9 for t in ms] if name == "committed" else None)
    emit(variant="committed", backward_device_ms=bwd_ms)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    emit(card=card, failed=failed)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
