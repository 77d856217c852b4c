"""Serving launcher for the PyTorch port: continuous batching over the
paged KV cache, chunked prefill overlapped with decode, greedy tokens.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --smoke --device cpu --requests 8 --max-new 8

Without ``--device`` it runs on the card (``cuda``) and raises if there
is none. Weights are the port's seeded initializer's, seed 0. It
prints the completed count, ticks, decode steps, prefill chunks, the
paged-KV line and each kernel's launch count.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain PyTorch versions)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="prefill token budget per scheduler tick")
    ap.add_argument("--no-overlap", action="store_true",
                    help="stop-the-world prefill on attach (A/B baseline)")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="retire requests early on this token id")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (must divide --max-len)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="KV pool size in pages (default: dense-equivalent)")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve.serve import BatchScheduler, ServeConfig

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only: no decode serving")
    model = Transformer.from_init(cfg, seed=0, device=args.device)
    sched = BatchScheduler(model, ServeConfig(
        max_len=args.max_len, batch=args.batch,
        prefill_chunk=args.prefill_chunk, overlap=not args.no_overlap,
        eos_id=args.eos_id, page_size=args.page_size, num_pages=args.num_pages,
    ))
    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        prompt = rng.integers(4, cfg.vocab, size=rng.integers(3, 10)).tolist()
        sched.submit(prompt, request_id=rid, max_new=args.max_new)
    reset_launch_counts()
    steps = 0
    while len(sched.completed) < args.requests and steps < 10 * args.max_len:
        sched.step()
        steps += 1
    sched.drain()
    print(f"[serve] device {model.device}; completed {len(sched.completed)}/"
          f"{args.requests} requests in {steps} ticks "
          f"({sched.stats['decode_steps']} decode steps, "
          f"{sched.stats['prefill_chunks']} prefill chunks)")
    kv = sched.kv_cache_stats()
    print(f"[serve] paged KV: {kv['kv_bytes']} pool bytes, "
          f"{kv['num_pages']} pages x {kv['page_size']} tokens, "
          f"peak {kv['peak_used_pages']} pages in use "
          f"(utilization {kv['pool_utilization']})")
    counts = launch_counts()
    route = "kernel launches" if model.device.type == "cuda" else \
        "kernel launches (0 on the CPU: plain versions ran)"
    print(f"[serve] {route}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
