"""Training launcher for the PyTorch port (``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --smoke --device cpu --steps 4 --global-batch 2 --seq-len 32 \\
        --talp-out /tmp/talp/case/current [--ckpt-dir /tmp/ckpt --ckpt-every 2]

Without ``--device`` it runs on the card (``cuda``) and raises if there is
none; ``--device cpu`` runs the plain PyTorch versions of the kernels.
Weights are the port's seeded initializer's. It prints the first and last
loss, each kernel's launch count, and where the TALP run record (schema
v3, regions ``initialize`` and ``train_step``) was written.

On a mesh of ranks, under ``torchrun`` (``WORLD_SIZE`` above 1; the
process group starts from the environment, ``nccl`` on the card and
``gloo`` on the CPU), ``--model-axis`` sets the mesh's "model" axis:

    torchrun --nproc_per_node 4 -m repro_torch.launch.train --device cpu \\
        --smoke --arch tinyllama-1.1b --model-axis 2

trains on a (2, 2) mesh, each rank holding its blocks of the state
(``train.train``); rank 0 prints and writes the record. Without
``torchrun`` the mesh is 1 x 1.

``--optimized`` applies the JAX package's optimized preset
(``configs.optimized_config``): among other fields, the fsdp strategy for
a megatron arch under 5e9 active parameters. With ``--smoke`` it applies
the same fields to the smoke config (the JAX launcher drops
``--optimized`` under ``--smoke``). Under fsdp, where the global batch
does not split over ``data x model`` (``--global-batch 1 --model-axis
2``), the ``"model"`` ranks split the sequence (context parallelism,
``distributed.shard.ContextParallel``):

    torchrun --nproc_per_node 2 -m repro_torch.launch.train --device cpu \\
        --smoke --optimized --arch tinyllama-1.1b --model-axis 2 --global-batch 1

``--ckpt-dir``/``--ckpt-every`` checkpoint the state every so many steps
(``checkpoint``, the JAX package's format), and a run started over a
directory that holds one resumes from the latest.

``--arch`` takes every arch the port runs: the MoE ones (qwen3-moe-30b-a3b,
dbrx-132b), whose record's ``expert_load_balance`` reads the router's
per-expert counts, and the recurrent ones (zamba2-2.7b, xlstm-350m). The vlm (llava-next-mistral-7b)
trains on the synthetic stream with its stub patch embeddings ahead of
the text, as the JAX launcher feeds it. The audio model (hubert-xlarge)
is refused: the synthetic stream is a token stream and the audio model
takes frame embeddings and has no token embedding. The JAX launcher
feeds it tokens and fails with ``KeyError: 'embed'``. Train it through
``train.loop.TrainLoop`` with a data source whose batches carry
``frontend`` (``chip_smoke.py`` does).
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the optimized preset (configs.optimized_config)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain PyTorch versions)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--model-axis", type=int, default=1,
                    help="size of the mesh's model axis (ranks from torchrun)")
    ap.add_argument("--talp-out", default="",
                    help="directory for the TALP run record (CI artifact)")
    args = ap.parse_args(argv)

    import os

    import torch.distributed as dist

    from repro_torch.configs import get_config, optimized_config, smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.device import resolve_device
    from repro_torch.distributed.sharding import effective_strategy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import LoopConfig, TrainLoop
    from repro_torch.train.train import TrainConfig

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.optimized:
        cfg = optimized_config(args.arch, cfg)
    if cfg.frontend == "audio":
        raise SystemExit(
            f"{args.arch} takes audio frame embeddings (batch['frontend']) and has no "
            f"token embedding; the synthetic stream has no audio frames (nor has the "
            f"JAX package's), so this launcher cannot train it. Drive "
            f"train.loop.TrainLoop with a data source of frontend batches instead.")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized():
        dist.init_process_group(
            "nccl" if resolve_device(args.device).type == "cuda" else "gloo")
    mesh = make_host_mesh(model=args.model_axis, device=args.device)
    rank0 = mesh.rank == 0
    data = SyntheticLM(DataConfig(
        global_batch=args.global_batch, seq_len=args.seq_len, vocab=cfg.vocab,
        accum_steps=args.accum, pad_fraction=0.05,
        frontend_tokens=cfg.n_frontend_tokens if cfg.frontend == "vlm" else 0,
        d_model=cfg.d_model,
    ))
    loop = TrainLoop(
        cfg, TrainConfig(optimizer=AdamWConfig(lr=args.lr), total_steps=args.steps),
        data,
        LoopConfig(steps=args.steps, ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
                   lb_sample_every=1, monitor_app_name=args.arch),
        mesh=mesh,
    )
    reset_launch_counts()
    loop.run()
    loop.finalize_run(args.talp_out or None)
    if dist.is_initialized():
        dist.destroy_process_group()
    if not rank0:
        return 0
    h = loop.metrics_history
    print(f"[launch] {args.arch} on {loop.device}: steps {h[0]['step']}..{h[-1]['step']} "
          f"loss {h[0]['loss']:.3f} -> {h[-1]['loss']:.3f}")
    print(f"[launch] mesh {mesh.sizes} over {mesh.devices.size} rank(s), "
          f"{effective_strategy(cfg, mesh)} strategy")
    route = "kernel launches" if loop.device.type == "cuda" else \
        "kernel launches (0 on the CPU: plain versions ran)"
    print(f"[launch] {route}: " + ", ".join(f"{k} {v}" for k, v in launch_counts().items()))
    if loop.session.last_record_path:
        print(f"[launch] TALP record: {loop.session.last_record_path}")
    elif args.talp_out:
        print("[launch] monitoring disabled by environment; no run record")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
