"""End-to-end training on the PyTorch port: a ~100M-parameter llama-family
model with monitoring, checkpointing, restart and a TALP-Pages artifact.

Full run (a few hundred steps on the card):
    PYTHONPATH=src python examples/torch_train.py --steps 300

Reduced width, the same code path (on the card, or with ``--device cpu``):
    PYTHONPATH=src python examples/torch_train.py --steps 4 --tiny --device cpu

The port's counterpart of ``examples/train_100m.py``. The loop checkpoints
every quarter of the run into ``--ckpt-dir``; rerunning the command over the
same directory resumes from the latest checkpoint.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train.loop import LoopConfig, TrainLoop  # noqa: E402
from repro_torch.train.train import TrainConfig  # noqa: E402


def model_100m() -> ModelConfig:
    """~105M params: llama-style, d=640, 12 layers, vocab 32000."""
    return ModelConfig(
        name="llama-100m", d_model=640, n_heads=10, n_kv_heads=5,
        d_ff=1792, vocab=32000, pattern=("attn",), repeats=12,
        rope_theta=10000.0, remat="none", q_chunk=256, kv_chunk=256,
    )


def model_tiny() -> ModelConfig:
    return model_100m().replace(d_model=64, n_heads=4, n_kv_heads=2,
                                d_ff=128, vocab=512, repeats=2)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--tiny", action="store_true", help="reduced width, the same code path")
    ap.add_argument("--ckpt-dir", default="results/torch_train/ckpt")
    ap.add_argument("--out", default="results/torch_train/talp/main/history")
    args = ap.parse_args(argv)

    cfg = model_tiny() if args.tiny else model_100m()
    if args.tiny:
        args.seq = min(args.seq, 128)
    mesh = make_host_mesh(device=args.device)
    print(f"model: {cfg.name} ({cfg.param_count() / 1e6:.1f}M params) on {mesh.device}")

    data = SyntheticLM(DataConfig(global_batch=args.batch, seq_len=args.seq,
                                  vocab=cfg.vocab, pad_fraction=0.05))
    loop = TrainLoop(
        cfg,
        TrainConfig(optimizer=AdamWConfig(lr=3e-4), warmup_steps=20, total_steps=args.steps),
        data,
        LoopConfig(steps=args.steps, ckpt_every=max(args.steps // 4, 1),
                   ckpt_dir=args.ckpt_dir, lb_sample_every=1, monitor_app_name="train_100m"),
        mesh=mesh,
    )
    loop.run()

    hist = loop.metrics_history
    if hist:
        print(f"steps {hist[0]['step']}..{hist[-1]['step']}  "
              f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
    else:
        print(f"nothing to do: the checkpoint in {args.ckpt_dir} is at step {args.steps}")
    # finalize + git metadata + CI folder layout in one session call
    run = loop.finalize_run(args.out)
    if run is None:
        print("monitoring disabled by environment; no run record")
        return loop
    reg = run.regions["train_step"]
    print(f"run record: {loop.session.last_record_path}")
    print(f"parallel efficiency: {reg.pop.get('parallel_efficiency', 0):.3f}  "
          f"achieved TFLOP/s/dev: {reg.pop.get('achieved_tflops_per_device', 0):.4f}")
    print(f"restartable: rerun this command — it resumes from {args.ckpt_dir}")
    return loop


if __name__ == "__main__":
    main()
