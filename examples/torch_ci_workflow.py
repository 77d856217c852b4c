"""The CI workflow on the PyTorch port: the paper's GENE-X integration
(section "CI Workflow", listings 5/6) end to end on the mini-app.

  for each "commit":                          (performance job)
      run the performance experiment at two resource configurations:
          one rank, and two ranks of a (2, 1) mesh (gloo)
      write talp/<case>/<experiment>/talp_*.json
      talp metadata  (inject commit info)
  then:                                       (talp-pages job)
      talp merge-history  (previous pipeline's artifacts)
      talp ci-report -i talp -o public/talp --regions train_step
      -> static site with badges, scaling tables, time series, findings

    PYTHONPATH=src python examples/torch_ci_workflow.py               # on the card
    PYTHONPATH=src python examples/torch_ci_workflow.py --device cpu

The port's counterpart of ``examples/ci_workflow.py``. Each job's ranks
are processes of their own that meet through ``gloo`` (both ranks may
share one card), train with ``repro_torch.train.loop.TrainLoop`` on
``launch.mesh.make_host_mesh`` and rank 0 writes the record; the report
side is the port's ``talp`` CLI (``repro_torch.core.pages``). The third
commit carries a host stall: the report must flag it.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

SRC = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
sys.path.insert(0, SRC)

from repro_torch.core.pages import main as talp_cli  # noqa: E402

_JOB = """
import datetime, os, sys, time
sys.path.insert(0, {src!r})
import torch
import torch.distributed as dist
from repro_torch.configs import smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train.loop import LoopConfig, TrainLoop
from repro_torch.train.train import TrainConfig

rank, world = int(sys.argv[1]), {ndev}
torch.set_num_threads(1)  # the jobs' ranks run side by side
if world > 1:
    dist.init_process_group("gloo", init_method="file://" + {store!r}, rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
cfg = smoke_config("tinyllama-1.1b")
data = SyntheticLM(DataConfig(global_batch=4, seq_len=64, vocab=cfg.vocab))
loop = TrainLoop(cfg, TrainConfig(), data,
                 LoopConfig(steps=4, lb_sample_every=1, monitor_app_name="miniapp"),
                 mesh=make_host_mesh(device={device!r}))
if {slow}:  # this commit has a host-stall bug
    _obs = loop.session.observe_step
    def slow_obs(*a, **k):
        time.sleep(0.2)
        return _obs(*a, **k)
    loop.session.observe_step = slow_obs
loop.run()
run = loop.finalize_run()
if world > 1:
    dist.destroy_process_group()
if rank == 0:
    if run is None:
        raise SystemExit("the CI workflow needs collection enabled: unset TALP_ENABLE=0")
    run.metadata.update({{"git_commit_short": {commit!r}, "git_commit_timestamp": {ts!r}}})
    run.timestamp = {ts!r}
    run.save({out!r})
    print("performance job done:", run.resources.label)
"""


def performance_job(commit: str, ts: str, slow: bool, pipeline_dir: str, device) -> None:
    """The paper's matrix job: one run a resource configuration, every
    rank of both started together (one thread each)."""
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        for ndev in (1, 2):
            out = os.path.join(pipeline_dir, "talp", "salpha", "strong_scaling",
                               f"talp_1x{ndev}_{commit}.json")
            code = _JOB.format(ndev=ndev, src=SRC, commit=commit, ts=ts, out=out,
                               slow="True" if slow else "False", device=device,
                               store=os.path.join(tmp, f"store_{ndev}"))
            procs += [subprocess.Popen([sys.executable, "-c", code, str(rank)],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True) for rank in range(ndev)]
        try:
            logs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
    if any(p.returncode for p in procs):
        raise RuntimeError("\n".join(log[-2000:] for log in logs))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--root", default="results/torch_ci_workflow")
    args = ap.parse_args(argv)
    shutil.rmtree(args.root, ignore_errors=True)
    commits = [("aaa111", False), ("bbb222", False), ("ccc333", True)]
    prev_pipeline = site = None
    for i, (commit, slow) in enumerate(commits):
        pipeline = os.path.join(args.root, f"pipeline_{i}")
        ts = f"2026-07-{10 + i:02d}T12:00:00"
        print(f"=== pipeline {i} (commit {commit}{' - buggy' if slow else ''}) ===")
        performance_job(commit, ts, slow, pipeline, args.device)

        talp_dir = os.path.join(pipeline, "talp")
        # talp metadata (already injected by the loop here; idempotent)
        talp_cli(["metadata", "-i", talp_dir, "--extra", f"pipeline={i}"])
        # talp merge-history (the previous pipeline's artifacts)
        if prev_pipeline:
            talp_cli(["merge-history", "--history", os.path.join(prev_pipeline, "talp"),
                      "--current", talp_dir])
        site = os.path.join(pipeline, "public", "talp")
        talp_cli(["ci-report", "-i", talp_dir, "-o", site,
                  "--regions", "train_step", "--region-for-badge", "train_step"])
        prev_pipeline = pipeline

    with open(os.path.join(site, "findings.json")) as f:
        findings = json.load(f)
    print(f"\nfinal report: {os.path.join(site, 'index.html')}")
    print(f"findings ({len(findings)}):")
    for f in findings:
        print("  -", f["description"])
    regressions = [f for f in findings if f["kind"] == "regression" and f["commit"] == "ccc333"]
    if not regressions:
        raise SystemExit("the buggy commit ccc333 was not detected")
    print(f"\nCI workflow reproduced: buggy commit ccc333 detected "
          f"and explained via {regressions[0]['explanation']}")
    return site


if __name__ == "__main__":
    main()
