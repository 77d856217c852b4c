"""Batched serving on the PyTorch port: continuous batching over a paged KV
cache, chunked prefill overlapped with in-flight decode, and TALP
monitoring of the serving loop, emitting a run record for the same CI
report as training runs.

    PYTHONPATH=src python examples/torch_serve_batch.py            # paged, on the card
    PYTHONPATH=src python examples/torch_serve_batch.py --device cpu
    PYTHONPATH=src python examples/torch_serve_batch.py --dense    # dense baseline
    PYTHONPATH=src python examples/torch_serve_batch.py --shared-prefix
        # the prefix cache: requests share a system prompt whose KV pages
        # are prefilled once and mapped into every later request's block
        # table (copy-on-write at the divergence point)
    PYTHONPATH=src python examples/torch_serve_batch.py --traffic
        # open-loop bursty traffic against a tight page pool: arrivals
        # queue, victims preempt and recompute-resume, some clients hang
        # up mid-stream; prints goodput, TTFT percentiles and the pressure
    PYTHONPATH=src python examples/torch_serve_batch.py --chaos
        # the traffic run under a seeded fault schedule (NaN logits, a
        # corrupted page, an allocator spike, a hung dispatch); victims
        # retry through recompute-resume, the watchdog trips on the hang
    PYTHONPATH=src python examples/torch_serve_batch.py --spec
        # speculative decoding A/B on a workload the drafter can predict:
        # the same trace with speculation on and off, tokens compared

The port's counterpart of ``examples/serve_batch.py``. The scheduler
(``repro_torch.serve.serve.BatchScheduler``) runs on the mesh of
``launch.mesh.make_host_mesh`` (1 x 1 here; under ``torchrun`` the
serve launcher splits the slots' rows over the ranks) and takes the
session of ``repro_torch.start``: every decode dispatch is a visit of its
``decode`` region, every prefill chunk one of ``prefill``. ``TALP_ENABLE=1
TALP_BACKEND=tracer`` swaps the collector, ``TALP_ENABLE=0`` turns it off.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import ResourceConfig  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.serve.serve import BatchScheduler, ServeConfig  # noqa: E402


def _setup(args, app: str | None, copy_regime: bool = False):
    """The smoke tinyllama on the mesh's device and, with ``app``, a
    started session.
    ``copy_regime`` zeroes every layer: greedy decode is then a function of
    the last token alone, generations cycle and the drafter locks on."""
    cfg = smoke_config("tinyllama-1.1b")
    mesh = make_host_mesh(device=args.device)
    model = Transformer.from_init(cfg, seed=0, device=mesh.device)
    if copy_regime:
        with torch.no_grad():
            for path, p in model.named_params().items():
                if path.startswith("slots/"):
                    p.zero_()
    session = None if app is None else repro_torch.start(
        app, backend="monitor", lb_sample_every=1,
        resources=ResourceConfig(num_hosts=1, devices_per_host=mesh.devices.size))
    return cfg, mesh, model, session


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    for mode in ("dense", "shared-prefix", "traffic", "chaos", "spec"):
        ap.add_argument(f"--{mode}", action="store_true")
    ap.add_argument("--out", default="results/torch_serve_batch")
    args = ap.parse_args(argv)
    if (args.shared_prefix or args.traffic or args.chaos or args.spec) and args.dense:
        raise SystemExit("--shared-prefix/--traffic/--chaos/--spec need the paged layout")
    if args.traffic or args.chaos:
        return main_traffic(args)
    if args.spec:
        return main_spec(args)
    cfg, mesh, model, session = _setup(args, "serve")
    paged, shared = not args.dense, args.shared_prefix
    rng = np.random.default_rng(0)
    with session:
        sched = BatchScheduler(
            model,
            # pool sized to the workload: 4 slots x ceil((10+8)/16) pages,
            # against the dense equivalent of 4 x 128/16 = 32 pages (the
            # shared-prefix run carries 48 more prompt tokens a request,
            # shared after the first, plus the trie's pinned copy)
            ServeConfig(max_len=128, batch=4, prefill_chunk=16, paged=paged, page_size=16,
                        num_pages=(16 if shared else 8) if paged else None,
                        prefix_cache=shared),
            session=session, mesh=mesh)
        system = rng.integers(4, cfg.vocab, size=48).tolist() if shared else []
        for rid in range(10):
            prompt = system + rng.integers(4, cfg.vocab, size=rng.integers(3, 10)).tolist()
            sched.submit(prompt, request_id=rid, max_new=8)
        sched.drain()  # every request to completion, readbacks flushed
    run = session.finalize(os.path.join(args.out, "serve"))
    print(f"completed {len(sched.completed)} requests on {model.device} "
          f"({sched.stats['decode_steps']} decode steps, "
          f"{sched.stats['prefill_chunks']} prefill chunks)")
    kv = sched.kv_cache_stats()
    if kv["layout"] == "paged":
        print(f"paged KV pool: {kv['kv_bytes']} bytes ({kv['num_pages']} pages x "
              f"{kv['page_size']} tokens), peak {kv['peak_used_pages']} pages live, "
              f"utilization {kv['pool_utilization']}")
        if "prefix_cache" in kv:
            pc = kv["prefix_cache"]
            print(f"prefix cache: {pc['pages_saved_by_sharing']} pages saved by sharing, "
                  f"{pc['prefill_tokens_skipped']} prefill tokens skipped, hit rate "
                  f"{pc['hit_rate']} ({pc['cow_copies']} copy-on-write pages)")
    else:
        print(f"dense KV cache: {kv['kv_bytes']} bytes")
    for req in sched.completed[:3]:
        print(f"  request {req['id']}: generated {req['generated']}")
    if run is None:
        print("monitoring disabled by environment; no run record")
        return None
    for name in ("prefill", "decode"):
        reg = run.regions[name]
        print(f"{name} region: {reg.measurements.num_steps} steps, "
              f"dispatch efficiency {reg.pop.get('dispatch_efficiency', 0):.3f}")
    print(f"run record: {session.last_record_path}")
    return session.last_record_path


def main_traffic(args):
    """Open-loop bursty load against a pool well under the demand peak:
    queueing, preemption with recompute-resume, mid-stream cancellations.
    With ``--chaos`` a seeded fault schedule rides the same run and the
    scheduler recovers through retry and quarantine."""
    from repro_torch.serve.traffic import TrafficConfig, generate_workload, replay

    cfg, mesh, model, session = _setup(args, "serve-traffic")
    workload = generate_workload(TrafficConfig(
        n_requests=12, seed=0, arrival="burst", rate=0.8, burst_mult=5.0,
        prompt_short=(4, 10), prompt_long=(12, 20), max_new_short=(4, 8),
        max_new_long=(8, 12), cancel_frac=0.0 if args.chaos else 0.2, vocab_hi=cfg.vocab))
    injector = None
    if args.chaos:
        from repro_torch.serve.faults import FaultConfig, FaultInjector

        injector = FaultInjector(FaultConfig(seed=3, horizon_ticks=24, hang_s=0.2))
    with session:
        sched = BatchScheduler(
            model,
            # 2 slots x 3 pages: bursts queue, long requests preempt
            ServeConfig(max_len=64, batch=2, prefill_chunk=8, paged=True, page_size=8,
                        num_pages=6, watchdog_deadline_s=0.05 if args.chaos else None),
            session=session, mesh=mesh)
        m = replay(sched, workload, faults=injector)
    session.finalize(os.path.join(args.out, "traffic"))
    print(f"bursty traffic: {m['completed']} completed, {m['cancelled']} cancelled, "
          f"{m['failed']} failed of {m['requests']} in {m['ticks']} ticks")
    print(f"goodput {m['goodput_tokens_per_sec']} tok/s ({m['good_tokens']} tokens); "
          f"TTFT p50/p95/p99 {m['ttft_p50_s']}/{m['ttft_p95_s']}/{m['ttft_p99_s']} s; "
          f"queue depth peak {m['queue_depth_peak']}")
    print(f"pressure: {m['preemptions']} preemptions, {m['resumes']} resumes, "
          f"{m['cancellations']} cancellations "
          f"({m['kv']['pressure']['pages_freed_by_preempt']} pages freed by preempt)")
    if args.chaos:
        rec = m["recovery"]
        print(f"chaos: injected {rec['injected']}; recovered with {rec['retries']} retries "
              f"({rec['backoff_total_ticks']} backoff ticks), {rec['watchdog_trips']} "
              f"watchdog trips, {rec['quarantined']} quarantined, {rec['shed']} shed")
    return m


def main_spec(args):
    """Speculative decoding A/B on the copy regime (every layer zeroed):
    generation cycles and the prompt-lookup drafter locks on. On random
    weights the drafter proposes little and speculation runs as plain
    decode; the tokens are the same either way."""
    cfg, mesh, model, _ = _setup(args, None, copy_regime=True)
    pat = [5, 9, 13, 7]
    prompts = [pat * 4, pat * 6, [2, 3] + pat * 5]

    def run(spec_on):
        sched = BatchScheduler(
            model, ServeConfig(max_len=256, batch=4, prefill_chunk=16, paged=True,
                               page_size=16, num_pages=44, spec_decode=spec_on, spec_k=4),
            mesh=mesh)
        for rid, p in enumerate(prompts):
            sched.submit(p, request_id=rid, max_new=64)
        sched.drain()
        return sched

    plain, spec = run(False), run(True)
    toks = lambda s: {r["id"]: r["generated"] for r in s.completed}  # noqa: E731
    sp = spec.kv_cache_stats()["speculation"]
    print(f"plain decode: {plain.stats['decode_steps']} dispatches for "
          f"{sum(len(g) for g in toks(plain).values())} tokens")
    print(f"speculative:  {spec.stats['decode_steps']} dispatches "
          f"({sp['tokens_per_dispatch']} tokens/dispatch, acceptance rate "
          f"{sp['acceptance_rate']}, mean accepted len {sp['mean_accepted_len']})")
    same = toks(spec) == toks(plain)
    print(f"tokens identical: {same}")
    return same


if __name__ == "__main__":
    main()
