"""Serving launcher for the PyTorch port: continuous batching over the
paged KV cache, chunked prefill overlapped with decode, greedy tokens
(``--sample``: temperature and top-k sampling keyed like ``jax.random``),
under a monitored session (``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --smoke --device cpu --requests 8 --max-new 8

``--prefix-cache`` shares prompt pages across requests (the fixed trace
then gives every prompt one system prompt); ``--arrival poisson|burst``
replaces the fixed trace with the seeded open-loop traffic harness (mixed
lengths, priority classes, ``--cancel-frac`` mid-stream cancellations)
and reports goodput, TTFT percentiles and queue depth;
``--preempt-policy`` picks the victim order when the page pool runs dry;
``--spec`` drafts up to ``--spec-k`` tokens a slot by prompt lookup and
verifies them in one batched dispatch a tick; ``--dense`` keeps one dense
KV cache row a slot instead of the paged pool; ``--chaos`` attaches the
seeded fault injector (``--fault-seed``), with ``--max-retries``,
``--watchdog-deadline``, ``--checksum-pages`` and ``--shed-queue-depth``
for the recovery layer:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --smoke --device cpu --arrival burst --rate 0.8 --requests 16 \\
        --num-pages 8 --page-size 8 --cancel-frac 0.2 --talp-out /tmp/talp_serve

``--arch`` takes every decoder arch the port runs, the MoE ones
(qwen3-moe-30b-a3b, dbrx-132b) and the recurrent ones (zamba2-2.7b,
xlstm-350m) too. Without ``--device`` it runs on the
card (``cuda``) and raises if there is none. Weights are the port's seeded initializer's, seed 0. It prints
the completed count, ticks, decode steps, prefill chunks, the traffic,
KV, prefix-cache, pressure, speculation and recovery lines, each
kernel's launch count, and where the TALP run record (regions ``decode``, ``prefill``,
``preempt``, ``traffic``) was written.

Under ``torchrun`` (``WORLD_SIZE`` above 1; ``nccl`` on the card,
``gloo`` on the CPU) it serves on a ``(world, 1)`` mesh of ranks, every
device on ``"data"`` as JAX's launcher's ``make_host_mesh()`` puts them:
every rank holds the whole weights and runs the same scheduler, the
decode and verify rows split over the ranks (``serve.BatchScheduler``'s
``mesh``); rank 0 prints and writes ``talp_1x<world>_*.json``:

    torchrun --nproc_per_node 2 -m repro_torch.launch.serve --device cpu \
        --smoke --arch tinyllama-1.1b

``--dense`` on a mesh of more than one rank raises: the dense layout's
scheduler on a mesh is not ported (ROADMAP item 8b-iv).
"""

from __future__ import annotations

import argparse
import os


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
    ap.add_argument("--paged", dest="paged", action="store_true", default=True,
                    help="paged KV cache (the default): shared page pool + "
                         "per-slot block tables")
    ap.add_argument("--dense", dest="paged", action="store_false",
                    help="dense (batch x max_len) KV cache, the A/B baseline")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (must divide --max-len)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="KV pool size in pages (default: dense-equivalent)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="cross-request prefix sharing: map previously "
                         "prefilled prompt pages into new requests' block "
                         "tables (copy-on-write at the divergence point)")
    ap.add_argument("--prefix-trie-capacity", type=int, default=None,
                    help="max pages the prefix trie may pin (LRU-trimmed); "
                         "default: unbounded (pool pressure still evicts)")
    ap.add_argument("--arrival", choices=("poisson", "burst"), default=None,
                    help="open-loop traffic instead of the fixed trace: "
                         "Poisson or Markov-modulated bursty arrivals")
    ap.add_argument("--rate", type=float, default=0.5,
                    help="mean arrivals per scheduler tick (calm state)")
    ap.add_argument("--cancel-frac", type=float, default=0.0,
                    help="fraction of traffic requests that cancel "
                         "mid-stream at a scheduled tick")
    ap.add_argument("--preempt-policy", default="priority",
                    choices=("priority", "pages", "progress", "never"),
                    help="victim selection when the page pool runs dry: "
                         "lowest-priority-first (default), most-pages, "
                         "least-progress, or never (exhaustion raises)")
    ap.add_argument("--chaos", action="store_true",
                    help="attach the seeded fault injector (NaN logits, KV "
                         "page corruption, allocator spikes, hung dispatches): "
                         "the scheduler must recover")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="FaultConfig seed: same seed, same fault schedule")
    ap.add_argument("--max-retries", type=int, default=3,
                    help="fault retries per request before quarantine")
    ap.add_argument("--watchdog-deadline", type=float, default=None,
                    help="per-dispatch watchdog deadline in seconds (default: "
                         "off; --chaos defaults it to 0.5)")
    ap.add_argument("--checksum-pages", action="store_true",
                    help="per-page fingerprints checked at prefix-cache "
                         "sharing (catches silent bit flips)")
    ap.add_argument("--shed-queue-depth", type=int, default=None,
                    help="admission queue depth beyond which the "
                         "lowest-priority youngest waiter is shed (default: "
                         "never)")
    ap.add_argument("--spec", action="store_true",
                    help="speculative decoding: n-gram self-drafting + one "
                         "batched verify dispatch per tick (tokens stay "
                         "identical to plain decode)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="max draft tokens proposed per verify dispatch")
    ap.add_argument("--spec-min-match", type=int, default=2,
                    help="shortest history n-gram the drafter may match on")
    ap.add_argument("--sample", action="store_true",
                    help="temperature/top-k sampling instead of greedy argmax")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--sample-seed", type=int, default=0)
    ap.add_argument("--talp-out", default="",
                    help="directory for the TALP run record (CI artifact)")
    args = ap.parse_args(argv)

    import numpy as np

    import torch.distributed as dist

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.records import ResourceConfig
    from repro_torch.device import resolve_device
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve.serve import BatchScheduler, ServeConfig
    from repro_torch.session import PerfSession, SessionConfig

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only: no decode serving")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not args.paged:
        raise ValueError("--dense on a mesh of ranks: the dense layout's scheduler on a "
                         "mesh is not ported (ROADMAP item 8b-iv); serve the paged layout")
    if world > 1 and not dist.is_initialized():
        dist.init_process_group(
            "nccl" if resolve_device(args.device).type == "cuda" else "gloo")
    # JAX's launcher: every device on "data" (make_host_mesh()), the
    # parameters unplaced; here every rank holds the whole weights and the
    # slots' rows split over "data"
    mesh = make_host_mesh(device=args.device)
    rank0 = mesh.rank == 0
    model = Transformer.from_init(cfg, seed=0, device=mesh.device)
    session = PerfSession(
        SessionConfig(app_name=f"serve-{args.arch}", backend="monitor",
                      lb_sample_every=1),
        ResourceConfig(num_hosts=1, devices_per_host=mesh.devices.size),
    )
    rng = np.random.default_rng(0)
    injector = None
    watchdog = args.watchdog_deadline
    if args.chaos:
        from repro_torch.serve.faults import FaultConfig, FaultInjector

        injector = FaultInjector(FaultConfig(seed=args.fault_seed))
        if watchdog is None:
            watchdog = 0.5
    reset_launch_counts()
    with session:
        sched = BatchScheduler(model, ServeConfig(
            max_len=args.max_len, batch=args.batch,
            prefill_chunk=args.prefill_chunk, overlap=not args.no_overlap,
            eos_id=args.eos_id, paged=args.paged, page_size=args.page_size,
            num_pages=args.num_pages,
            prefix_cache=args.prefix_cache,
            prefix_trie_capacity=args.prefix_trie_capacity,
            preempt_policy=args.preempt_policy,
            greedy=not args.sample, temperature=args.temperature, top_k=args.top_k,
            sample_seed=args.sample_seed,
            max_retries=args.max_retries, watchdog_deadline_s=watchdog,
            checksum_pages=args.checksum_pages, shed_queue_depth=args.shed_queue_depth,
            spec_decode=args.spec, spec_k=args.spec_k,
            spec_min_match=args.spec_min_match,
        ), session=session, fault_injector=injector, mesh=mesh)
        if args.arrival:
            # open-loop traffic: arrivals, lengths, priorities and cancels
            # are a pure function of the seeded TrafficConfig
            from repro_torch.serve.traffic import (TrafficConfig,
                                                   generate_workload, replay)

            workload = generate_workload(TrafficConfig(
                n_requests=args.requests, arrival=args.arrival,
                rate=args.rate, cancel_frac=args.cancel_frac,
                vocab_hi=cfg.vocab,
            ))
            metrics = replay(sched, workload)
            steps = metrics["ticks"]
        else:
            metrics = None
            # with prefix sharing on, give requests something to share: a
            # common system prompt over several pages, divergent tails
            system = (
                rng.integers(4, cfg.vocab,
                             size=min(4 * args.page_size, args.max_len // 2)).tolist()
                if args.prefix_cache else []
            )
            for rid in range(args.requests):
                prompt = system + rng.integers(4, cfg.vocab,
                                               size=rng.integers(3, 10)).tolist()
                sched.submit(prompt, request_id=rid, max_new=args.max_new)
            steps = 0
            while len(sched.completed) < args.requests and steps < 10 * args.max_len:
                sched.step()
                steps += 1
            sched.drain()
    session.finalize(args.talp_out or None, save=rank0)
    if dist.is_initialized():
        dist.destroy_process_group()
    if not rank0:
        return 0
    print(f"[serve] mesh {mesh.sizes} over {mesh.devices.size} rank(s)")
    print(f"[serve] device {model.device}; completed {len(sched.completed)}/"
          f"{args.requests} requests in {steps} ticks "
          f"({sched.stats['decode_steps']} decode steps, "
          f"{sched.stats['prefill_chunks']} prefill chunks)")
    if metrics is not None:
        print(f"[serve] traffic ({args.arrival}): "
              f"goodput {metrics['goodput_tokens_per_sec']} tok/s "
              f"({metrics['good_tokens']} tokens), "
              f"{metrics['cancelled']} cancelled, {metrics['failed']} failed; "
              f"TTFT p50/p95/p99 {metrics['ttft_p50_s']}/"
              f"{metrics['ttft_p95_s']}/{metrics['ttft_p99_s']} s; "
              f"queue depth peak {metrics['queue_depth_peak']} "
              f"(mean {metrics['queue_depth_mean']})")
    kv = sched.kv_cache_stats()
    if kv["layout"] == "paged":
        print(f"[serve] paged KV: {kv['kv_bytes']} pool bytes, "
              f"{kv['num_pages']} pages x {kv['page_size']} tokens, "
              f"peak {kv['peak_used_pages']} pages in use "
              f"(utilization {kv['pool_utilization']})")
    else:
        print(f"[serve] dense KV: {kv['kv_bytes']} bytes")
    if "prefix_cache" in kv:
        pc = kv["prefix_cache"]
        print(f"[serve] prefix cache: hit rate {pc['hit_rate']} "
              f"({pc['hits']}/{pc['hits'] + pc['misses']} attaches), "
              f"{pc['prefill_tokens_skipped']} prefill tokens skipped, "
              f"{pc['pages_saved_by_sharing']} pages saved by sharing, "
              f"{pc['cow_copies']} copy-on-write pages, "
              f"{pc['trie_pages']} pages cached "
              f"({pc['evicted_pages']} evicted)")
    pr = kv["pressure"]
    print(f"[serve] pressure: {pr['preemptions']} preemptions "
          f"({pr['pages_freed_by_preempt']} pages freed), "
          f"{pr['resumes']} resumes, "
          f"{pr['evictions_for_preempt']} trie evictions for preempt, "
          f"{pr['cancellations']} cancellations, "
          f"peak queue depth {pr['peak_queue_depth']}")
    if args.spec:
        sp = kv["speculation"]
        print(f"[serve] speculation: acceptance rate {sp['acceptance_rate']} "
              f"({sp['accepted']}/{sp['drafted']} drafts), "
              f"{sp['tokens_per_dispatch']} tokens/dispatch over "
              f"{sp['verify_dispatches']} verify dispatches "
              f"(mean accepted len {sp['mean_accepted_len']})")
    rec = kv["recovery"]
    print(f"[serve] recovery: {rec['retries']} retries "
          f"({rec['backoff_total_ticks']} backoff ticks), "
          f"{rec['quarantined']} quarantined, {rec['shed']} shed, "
          f"{rec['watchdog_trips']} watchdog trips, "
          f"{rec['checksum_failures']} checksum failures"
          + (f"; injected {rec['injected']}" if "injected" in rec else ""))
    counts = launch_counts()
    route = "kernel launches" if model.device.type == "cuda" else \
        "kernel launches (0 on the CPU: plain versions ran)"
    print(f"[serve] {route}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
    if session.last_record_path:
        print(f"[serve] TALP record: {session.last_record_path}")
    elif args.talp_out:
        print("[serve] monitoring disabled by environment; no run record")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
