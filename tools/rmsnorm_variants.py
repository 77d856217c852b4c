#!/usr/bin/env python3
"""Variants of the RMSNorm kernels (K1, ``src/repro_torch/csrc/rmsnorm.cu``)
at tinyllama-1.1b's shapes (``cases.MAIN_RMS``: 4 and 64 rows of 2048,
serving; ``cases.MAIN_RMS_TRAIN``: 8192 rows of 2048, training), bf16, on
one CUDA card.

    python3 tools/rmsnorm_variants.py [--out PATH]

Run from the repository root. The committed kernels and plan run at every
shape, and the forward in both row layouts below at the serving shapes;
beside them, at the training shape, every combination of

- a build: the committed library, and the leave-out ``nosum`` compiled
  with ``-DRMSNORM_NO_SUM`` under ``build/repro_torch/variants/`` (no
  cross-thread sums: the streaming alone; its output is wrong by design
  and is not checked);
- a row layout of d = 2048: four warps of two 16-byte accesses a thread
  (``4x2``) or eight warps of one (``8x1``);
- a partition: about K blocks an SM (``per_smK``), or one row a block
  (``row``, the forward only);
- a ring: the rows whose loads a block keeps in flight (``ringK``; 0 loads
  a row into registers when it is reached), where it fits the library's
  shared-memory budget.

Times are device times from a CUDA graph (``chip_smoke.graph_ms``) in
interleaved rounds; for the backward also the row pass and the combine
apart, from the profiler's kernel names; and, as yardsticks of the card's
streaming rate, PyTorch's ``copy_`` and ``add`` over the same bytes. Every
variant but the leave-out is held to phase 2's gates against the plain
version first (2e-2 of the largest |value|, ``cases.TOL_L2_RMS``); the run
exits 1 if one fails.
Prints one JSON line per result and writes them all to ``--out`` (default
``results/rmsnorm_variants.json``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

BUILDS = {"nosum": ["-DRMSNORM_NO_SUM"]}
LAYOUTS = {"4x2": (4, 2), "8x1": (8, 1)}
FWD_PARTITIONS = ("per_sm2", "per_sm4", "per_sm8", "row")
BWD_PARTITIONS = ("per_sm2", "per_sm3", "per_sm4", "per_sm8")
RINGS = (0, 1, 2, 4, 8)
ROUNDS = 2


def build_variants() -> dict:
    """Compile every build at once; {name: (library path, ptxas report)}."""
    from repro_torch import device as D
    from repro_torch.kernels import build

    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, flags in BUILDS.items():
        lib = out_dir / f"librmsnorm_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [D.nvcc_path(), *build.NVCC_FLAGS, *flags, "-o", str(lib),
             str(build.CSRC / "rmsnorm.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name}:\n{log}")
        libs[name] = (lib, log)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "results", "rmsnorm_variants.json"))
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("rmsnorm_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as C
    from repro_torch.kernels import cases
    from repro_torch.kernels.rmsnorm import ops as RMS
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_backward_reference, rmsnorm_reference

    results, failed = [], []

    def emit(**row):
        results.append(row)
        print(json.dumps(row), flush=True)

    paths = build_variants()
    RMS.load()
    libs = {"committed": RMS._lib()}
    libs.update({n: RMS.bind(ctypes.CDLL(str(p))) for n, (p, _) in paths.items()})
    for n, (_, log) in paths.items():  # the bf16 kernels' registers and spills
        emit(build=n, ptxas={k: v for k, v in C._ptxas_by_kernel(log).items()
                             if "bf16,bf16" in k})
    bf = torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    train = cases.MAIN_RMS_TRAIN
    shapes = cases.MAIN_RMS + [train]
    inputs = {}
    for r, d in shapes:
        c = cases.rms_case(r, d, seed=47)
        inputs[r, d] = [torch.from_numpy(c[n]).to("cuda", bf) for n in ("x", "scale", "dy")]

    def plan_of(shape, layout=None, part=None, kind="fwd", ring=None):
        r, d = shape
        p = RMS.plan(r, d, 2, sms, True)
        if layout:
            p = p._replace(warps=LAYOUTS[layout][0], vpt=LAYOUTS[layout][1])
        if part:
            blocks, per = (r, 1) if part == "row" else RMS.partition(r, int(part[6:]), sms)
            keys = ("fwd_blocks", "fwd_per") if kind == "fwd" else ("blocks", "per")
            p = p._replace(**dict(zip(keys, (blocks, per))))
        if ring is not None:
            p = p._replace(**{"fwd_ring" if kind == "fwd" else "ring": ring})
        return p

    def fits(layout, kind, ring):
        warps, vpt = LAYOUTS[layout]
        return 16 * ring * (1 if kind == "fwd" else 2) * vpt * 32 * warps <= RMS.RING_BYTES

    def call(job):
        build_name, layout, part, ring, kind, shape = job
        x, s, dy = inputs[shape]
        p, lib = plan_of(shape, layout, part, kind, ring), libs[build_name]
        if kind == "fwd":
            return lambda: RMS.launch_forward(x, s, 1e-6, False, p, lib)
        return lambda: RMS.launch_backward(x, s, dy, 1e-6, False, p, lib)

    jobs = [("committed", None, None, None, "fwd", sh) for sh in shapes]
    jobs.append(("committed", None, None, None, "bwd", train))
    # the row layouts at the serving shapes too, one row a block
    jobs += [("committed", lay, "row", 0, "fwd", sh) for lay in LAYOUTS for sh in cases.MAIN_RMS]
    for b in ("committed", *BUILDS):
        for lay in LAYOUTS:
            for ring in RINGS:
                jobs += [(b, lay, part, ring, "fwd", train) for part in FWD_PARTITIONS
                         if fits(lay, "fwd", ring)]
                jobs += [(b, lay, part, ring, "bwd", train) for part in BWD_PARTITIONS
                         if fits(lay, "bwd", ring)]
    # the gates first (not for the leave-outs)
    for job in jobs:
        if job[0].startswith("nosum"):
            continue
        x, s, dy = inputs[job[5]]
        got = call(job)()
        torch.cuda.synchronize()
        want = ([rmsnorm_reference(x, s)] if job[4] == "fwd"
                else list(rmsnorm_backward_reference(x, s, dy)))
        got = [got] if job[4] == "fwd" else list(got)
        errs = [(cases.max_rel_err(C._np(g), C._np(w)), cases.l2_rel_err(C._np(g), C._np(w)))
                for g, w in zip(got, want)]
        ok = all(m <= cases.TOL_MAX["bfloat16"] and l2 <= cases.TOL_L2_RMS["bfloat16"]
                 for m, l2 in errs)
        if not ok:
            emit(check=list(job[:5]), shape=list(job[5]), errors=errs, ok=ok)
            failed.append(list(job[:5]))
    # times, in interleaved rounds
    times: dict = {}
    for _ in range(ROUNDS):
        for job in jobs:
            times.setdefault(job, []).append(C.graph_ms(call(job), iters=50))
    for job, ts in times.items():
        row = dict(build=job[0], layout=job[1], partition=job[2], ring=job[3], kind=job[4],
                   shape=list(job[5]), device_ms=ts, mean_device_ms=float(np.mean(ts)))
        if job[4] == "bwd":
            fn = call(job)
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
            row["kernels_ms"] = {}
            for e in C._device_events(prof):
                m = re.search(r"rmsnorm_\w+?_kernel", e.key)
                name = m.group(0) if m else e.key[:40]
                row["kernels_ms"][name] = (row["kernels_ms"].get(name, 0.0)
                                           + e.self_device_time_total / 1e3 / 20)
        emit(**row)
    # yardsticks: the card's streaming rate for the same bytes, as PyTorch's
    # own copy and add reach it (graph-timed like the kernels)
    x, s, dy = inputs[train]
    y = torch.empty_like(x)
    for name, fn, nbytes in (("y.copy_(x): the forward's bytes", lambda: y.copy_(x),
                              2 * x.numel() * 2),
                             ("torch.add(x, dy, out=y): the backward's bytes",
                              lambda: torch.add(x, dy, out=y), 3 * x.numel() * 2)):
        ts = [C.graph_ms(fn, iters=50) for _ in range(ROUNDS)]
        emit(yardstick=name, bytes=nbytes, device_ms=ts, mean_device_ms=float(np.mean(ts)),
             tb_per_s=nbytes / float(np.mean(ts)) / 1e9)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    emit(card=card, failed=failed)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
