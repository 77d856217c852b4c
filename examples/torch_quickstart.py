"""Quickstart on the PyTorch port: train a reduced-config model with TALP
monitoring, print the POP factors, write a TALP-Pages run record.

    PYTHONPATH=src python examples/torch_quickstart.py              # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The port's counterpart of ``examples/quickstart.py``: the training loop
(``repro_torch.train.loop.TrainLoop``) owns a ``PerfSession`` and
``loop.finalize_run(out_dir)`` writes the schema-v3 run record (git
metadata included) into the CI folder layout. The environment re-points
or re-plugs it with no code change:

    TALP_ENABLE=1 TALP_BACKEND=tracer # swap the collector backend
    TALP_ENABLE=0                     # kill switch: no collection at all
    TALP_OUT=talp/quickstart/history  # redirect the artifact
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import build_table, render_text  # noqa: E402
from repro_torch.core import factors as F  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.train.loop import LoopConfig, TrainLoop  # noqa: E402
from repro_torch.train.train import TrainConfig  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default="results/torch_quickstart")
    args = ap.parse_args(argv)

    cfg = smoke_config("tinyllama-1.1b")
    data = SyntheticLM(DataConfig(global_batch=4, seq_len=64, vocab=cfg.vocab,
                                  pad_fraction=0.1))
    loop = TrainLoop(cfg, TrainConfig(), data,
                     LoopConfig(steps=args.steps, lb_sample_every=1,
                                monitor_app_name="quickstart"),
                     mesh=make_host_mesh(device=args.device))
    loop.run()
    print(f"device {loop.device}; losses:",
          [round(m["loss"], 3) for m in loop.metrics_history])

    # one call: finalize + git metadata + save into the CI folder layout
    run = loop.finalize_run(args.out)
    if run is None:  # TALP_ENABLE=0 disabled collection entirely
        print("monitoring disabled by environment; no run record")
        return None
    print(f"\nTALP run record: {loop.session.last_record_path}")

    reg = run.regions["train_step"]
    print(f"\nPOP factors for region 'train_step' ({reg.measurements.num_steps} steps, "
          f"{reg.measurements.elapsed_s:.2f}s elapsed):")
    for key, depth in F.iter_tree():
        if key in reg.pop:
            print(f"  {'  ' * depth}{F.DISPLAY_NAMES[key]:<34} {reg.pop[key]:.3f}")
    print("\n" + render_text(build_table([run], region="train_step")))
    return loop.session.last_record_path


if __name__ == "__main__":
    main()
