"""Training launcher for the PyTorch port (``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --smoke --device cpu --steps 4 --global-batch 2 --seq-len 32 \\
        --talp-out /tmp/talp/case/current

Without ``--device`` it runs on the card (``cuda``) and raises if there is
none; ``--device cpu`` runs the plain PyTorch versions of the kernels.
Weights are the port's seeded initializer's. It prints the first and last
loss, each kernel's launch count, and where the TALP run record (schema
v3, regions ``initialize`` and ``train_step``) was written.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain PyTorch versions)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--talp-out", default="",
                    help="directory for the TALP run record (CI artifact)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import LoopConfig, TrainLoop
    from repro_torch.train.train import TrainConfig

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    data = SyntheticLM(DataConfig(
        global_batch=args.global_batch, seq_len=args.seq_len, vocab=cfg.vocab,
        accum_steps=args.accum, pad_fraction=0.05, d_model=cfg.d_model,
    ))
    loop = TrainLoop(
        cfg, TrainConfig(optimizer=AdamWConfig(lr=args.lr), total_steps=args.steps),
        data,
        LoopConfig(steps=args.steps, lb_sample_every=1, monitor_app_name=args.arch),
        device=args.device,
    )
    reset_launch_counts()
    loop.run()
    h = loop.metrics_history
    print(f"[launch] {args.arch} on {loop.device}: steps {h[0]['step']}..{h[-1]['step']} "
          f"loss {h[0]['loss']:.3f} -> {h[-1]['loss']:.3f}")
    route = "kernel launches" if loop.device.type == "cuda" else \
        "kernel launches (0 on the CPU: plain versions ran)"
    print(f"[launch] {route}: " + ", ".join(f"{k} {v}" for k, v in launch_counts().items()))
    loop.finalize_run(args.talp_out or None)
    if loop.session.last_record_path:
        print(f"[launch] TALP record: {loop.session.last_record_path}")
    elif args.talp_out:
        print("[launch] monitoring disabled by environment; no run record")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
