#!/usr/bin/env python3
"""Variants of the bf16 paged-attention kernels (K3 decode, K4 prefill) at
tinyllama-1.1b's serving shapes (``cases.MAIN_PAGED``: B=4 decode slots over
97-288 keys; ``cases.MAIN_PREFILL``: a 64-token chunk at 192; Hq=32, Hkv=4,
D=64, page 16), on one CUDA card.

    python3 tools/paged_tc_variants.py [--out PATH]

Run from the repository root. Each variant is a text edit of
``src/repro_torch/csrc/paged_attention_tc.cu``, written under
``build/repro_torch/variants/`` and compiled there with the flags of
``kernels/build.py``; the committed source is left as it is. Three kinds:

- leave-outs, which split the kernels' time: ``no_staging`` (no K/V tile
  copies, nor their addressing through the table), ``no_score_code`` (the
  scores go straight to P V: no scale, mask, online softmax or rescale),
  ``no_products`` (no mma.sync: made-up sums), ``no_combine`` (the last
  block of a group returns instead of combining the splits). Their outputs
  are wrong by design and are not checked.
- planted faults, each a bug a kernel of this design could have, held to
  the gates of ``chip_smoke.paged_failures`` (the absolute 2e-2,
  ``cases.TOL_MAX``, ``cases.TOL_L2_PAGED``) at both serving shapes. A
  fault that passes the gates at both fails the run.
- plans: the committed kernel under other split counts than ``ops.tc_plan``
  picks, timed beside it.

The committed kernel runs beside them: its gate readings at every paged
case of ``chip_smoke``'s phase 2 (both dtypes, readings only) and its times
at the serving shapes, in the same interleaved rounds as the leave-outs,
warm (back to back), cold (``chip_smoke.cold_graph_ms``: L2 flushed
before each call) and, for the committed kernel, right after a 4096 x 4096
bf16 matmul (a CUDA graph of both less one of the matmul alone).
Prints one JSON line per result and writes them all to ``--out`` (default
``results/paged_tc_variants.json``); exits 1 if the committed kernel fails a
gate at a serving shape or a planted fault passes them.
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

SCORE_CODE = ("        // scale, soft-cap, mask; the online softmax of the tile",
              "        // O += P V: P in registers (bf16), V by ldmatrix.trans")
MMA = ('''  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));''',
       "  d[0] += __uint_as_float((a[0] ^ b0) & 0x3f7fffffu);\n"
       "  d[1] += __uint_as_float((a[1] ^ b1) & 0x3f7fffffu);\n"
       "  d[2] += __uint_as_float((a[2] ^ b0) & 0x3f7fffffu);\n"
       "  d[3] += __uint_as_float((a[3] ^ b1) & 0x3f7fffffu);")
COPIES = ("          cp_async16(kd + j * LD + cc * 8, a.k + off, ok);\n"
          "          cp_async16(vd + j * LD + cc * 8, a.v + off, ok);\n", "")
# the counters are left zero, as the committed kernel leaves them
NO_COMBINE = ("  if (!last_s) return;\n",
              "  if (last_s && tid == 0) a.counters[cidx] = 0;\n  return;\n")
COMBINE_WEIGHT = "      const float w = mli.x <= NEG_INF / 2 ? 0.f : expf(mli.x - mt);"

LEAVE_OUTS = {
    "no_staging": [("replace",) + COPIES],
    "no_score_code": [("cut",) + SCORE_CODE],
    "no_products": [("replace",) + MMA],
    "no_combine": [("replace",) + NO_COMBINE],
}
FAULTS = {
    # the combine ignores the last split that saw a key (an off-by-one in
    # the splits it walks: the last split of the table is empty at the
    # serving shapes, so dropping it would change nothing)
    "combine_drops_last_live_split": [
        ("replace", "#pragma unroll 8\n    for (int i = 0; i < a.splits; ++i) "
                    "mt = fmaxf(mt, __ldcg(ml + i * BR * 2));",
         "int live = -1;\n    for (int i = 0; i < a.splits; ++i) {\n"
         "      const float mi_ = __ldcg(ml + i * BR * 2);\n"
         "      mt = fmaxf(mt, mi_);\n      if (mi_ > NEG_INF / 2) live = i;\n    }"),
        ("replace", COMBINE_WEIGHT,
         "      const float w = mli.x <= NEG_INF / 2 || i == live ? 0.f : expf(mli.x - mt);")],
    # partials summed without the exp(m_i - m) rescale
    "combine_without_rescale": [
        ("replace", COMBINE_WEIGHT, "      const float w = mli.x <= NEG_INF / 2 ? 0.f : 1.f;")],
    # each split stops one page short of its last
    "split_skips_its_last_page": [
        ("replace", "const int kb = max(ks, lo), ke = min(ks + npg * page, hi);",
         "const int kb = max(ks, lo), ke = min(ks + (npg - 1) * page, hi);")],
    # the tile is read from the stage whose copy is still in flight (the
    # next tile's) instead of the one waited for; leaving out the wait
    # alone did not show at the serving shapes (the copies had landed)
    "tile_read_from_a_stage_in_flight": [
        ("replace", "const bf16* k_s = kv_s + (2 * (t % STAGES)) * T::kv_elems;",
         "const bf16* k_s = kv_s + (2 * ((t + 1) % STAGES)) * T::kv_elems;")],
}
# split counts tried beside ops.tc_plan's (the table's 32 pages split evenly)
PLANS = {"decode": (1, 2, 4, 8, 16), "prefill": (1, 2, 4, 8)}


def edit(text: str, ops) -> str:
    """Apply (kind, a, b) edits: ``replace`` a by b, ``cut`` from a up to b
    (b kept). Each a (and b) must occur exactly once in the source."""
    for kind, a, b in ops:
        if text.count(a) != 1 or (kind == "cut" and text.count(b) != 1):
            raise ValueError(f"edit anchor not found exactly once: {a!r}")
        if kind == "replace":
            text = text.replace(a, b)
        else:
            i = text.index(a)
            text = text[:i] + text[text.index(b, i):]
    return text


def build_variants(names_ops: dict) -> dict:
    """Write and compile every variant at once; {name: library path}."""
    from repro_torch import device as D
    from repro_torch.kernels import build

    src = (build.CSRC / "paged_attention_tc.cu").read_text()
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, ops in names_ops.items():
        cu = out_dir / f"paged_{name}.cu"
        cu.write_text(edit(src, ops))
        lib = out_dir / f"libpaged_{name}.so"
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
    ap.add_argument("--out", default=os.path.join(ROOT, "results", "paged_tc_variants.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("paged_tc_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as C
    from repro_torch.kernels import build, cases
    from repro_torch.kernels.paged_attention import ops as PA
    from repro_torch.kernels.paged_attention import ref as PR

    results, failed = [], []

    def emit(**row):
        results.append(row)
        print(json.dumps(row), flush=True)

    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        # the committed libraries of both routes, beside the variants
        built = [pool.submit(build.compile_library, n)
                 for n in ("paged_attention", "paged_attention_tc")]
        paths = build_variants({**LEAVE_OUTS, **FAULTS})
        for f in built:
            f.result()
    PA.load()
    committed = PA._lib_tc()
    libs = {"committed": committed}
    libs.update({n: PA.bind_tc(ctypes.CDLL(str(p))) for n, p in paths.items()})
    fns = {"decode": (PA.paged_attention, PR.paged_attention_reference),
           "prefill": (PA.paged_prefill_attention, PR.paged_prefill_attention_reference)}

    # the committed kernels at every paged case of phase 2: readings only
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for kind in C.PAGED_KINDS:
            fn, ref = fns[kind]
            for case in C.paged_case_table(kind):
                a, kw = C.paged_inputs(kind, case, dtype, seed=16)
                errs = C.paged_errors(fn(*a, **kw), ref(*a, **kw))
                emit(variant="committed", kind=kind, dtype=dn, case=list(case[:9]), **errs,
                     past_gate=C.paged_failures(errs, dn))

    main = {"decode": cases.MAIN_PAGED, "prefill": cases.MAIN_PREFILL}
    inputs = {k: C.paged_inputs(k, main[k], torch.bfloat16, seed=16) for k in main}
    want = {k: fns[k][1](*inputs[k][0], **inputs[k][1]) for k in main}
    plan = PA.tc_plan
    try:
        for name in ["committed", *FAULTS]:
            PA._lib_tc = lambda lib=libs[name]: lib
            bad_any = False
            for kind in main:
                a, kw = inputs[kind]
                out = fns[kind][0](*a, **kw)
                torch.cuda.synchronize()
                errs = C.paged_errors(out, want[kind])
                bad = C.paged_failures(errs, "bfloat16")
                bad_any |= bool(bad)
                emit(variant=name, kind=kind, dtype="bfloat16", case=list(main[kind][:9]),
                     **errs, past_gate=bad)
                if name == "committed" and bad:
                    failed.append(f"committed {kind}")
            if name != "committed":
                emit(variant=name, caught=bad_any)
                if not bad_any:
                    failed.append(name)
        times = {(n, k): [] for n in ["committed", *LEAVE_OUTS] for k in main}
        cold = {key: [] for key in times}
        after_mm = {k: [] for k in main}
        big = torch.randn(4096, 4096, dtype=torch.bfloat16, device=C.DEV)
        mm = lambda: big @ big  # noqa: E731
        for _ in range(2):  # two rounds, the variants interleaved
            for name, kind in times:
                PA._lib_tc = lambda lib=libs[name]: lib
                a, kw = inputs[kind]
                fn = lambda: fns[kind][0](*a, **kw)  # noqa: E731
                times[(name, kind)].append(C.graph_ms(fn, iters=100))
                cold[(name, kind)].append(C.cold_graph_ms(fn))
                if name == "committed":  # right after a 4096^2 bf16 matmul
                    after_mm[kind].append(C.graph_ms(lambda: (mm(), fn()), iters=20)
                                          - C.graph_ms(mm, iters=20))
        PA._lib_tc = lambda: committed
        plan_ms = {}
        for kind, counts in PLANS.items():
            a, kw = inputs[kind]
            nL = a[3].shape[1]
            for splits in counts:
                pages = -(-nL // splits)
                PA.tc_plan = lambda *_, s=splits, p=pages: (s, p)
                plan_ms[(kind, splits)] = C.graph_ms(lambda: fns[kind][0](*a, **kw), iters=100)
            PA.tc_plan = plan
    finally:
        PA._lib_tc = lambda: committed
        PA.tc_plan = plan
    for (name, kind), ms in times.items():
        emit(variant=name, kind=kind, device_ms=ms, cold_device_ms=cold[(name, kind)],
             **({"after_matmul_device_ms": after_mm[kind]} if name == "committed" else {}))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for kind, case in main.items():
        shape = (case[0], 1, *case[1:6]) if kind == "decode" else case[:7]
        emit(plan_of=kind, committed_plan=list(PA.tc_plan(*shape, sms)),
             device_ms_by_splits={s: ms for (k, s), ms in plan_ms.items() if k == kind})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    emit(card=card, failed=failed)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
