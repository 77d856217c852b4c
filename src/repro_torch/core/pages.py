"""``talp`` CLI — the TALP-Pages command-line interface.

Mirrors the paper's commands:
  talp ci-report -i ./talp_folder -o output [--regions r1 r2]
                 [--region-for-badge r]
  talp metadata -i ./talp_folder [--extra k=v ...]
  talp merge-history --history old_talp --current talp
      (the ``talp download-gitlab`` + unzip + copy step, CI-agnostic:
       artifact download itself is one curl against the CI API; what the
       tool owns is the merge)
  talp badge -i ./talp_folder -o badge.svg [--region r]

The port's copy of ``repro.core.pages``, with its flags, defaults and exit
codes, run as ``python -m repro_torch.core.pages ...``. It renders records
of either package, the port's ``h100_sxm`` records too.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.core import folder as _folder
from repro_torch.core import report as _report
from repro_torch.core import scaling as _scaling
from repro_torch.core.records import GLOBAL_REGION


def _cmd_ci_report(args: argparse.Namespace) -> int:
    experiments = _folder.scan(args.input)
    if not experiments:
        print(f"no run records found under {args.input}", file=sys.stderr)
        return 1
    index = _report.generate_report(
        experiments,
        args.output,
        regions=args.regions,
        region_for_badge=args.region_for_badge,
        overlap_fraction=args.overlap,
        title=args.title,
        top_computations=args.top_computations,
    )
    n_runs = sum(len(e.runs) for e in experiments)
    print(f"report: {index} ({len(experiments)} experiments, {n_runs} runs)")
    if args.print_tables:
        for exp in experiments:
            for region in [GLOBAL_REGION, *args.regions]:
                table = _scaling.build_table(exp.runs, region=region)
                if table:
                    print(f"\n== {exp.name} :: {region} ==")
                    print(_scaling.render_text(table))
    return 0


def _cmd_metadata(args: argparse.Namespace) -> int:
    meta = _folder.git_metadata(args.git_dir)
    for kv in args.extra:
        k, _, v = kv.partition("=")
        meta[k] = v
    n = _folder.add_metadata(args.input, meta)
    print(f"updated {n} run records with metadata {sorted(meta)}")
    return 0


def _cmd_merge_history(args: argparse.Namespace) -> int:
    if not os.path.isdir(args.history):
        print(f"no history at {args.history} (first pipeline run?) — nothing to merge")
        return 0
    n = _folder.merge_history(args.history, args.current)
    print(f"merged {n} historic run records into {args.current}")
    return 0


def _cmd_badge(args: argparse.Namespace) -> int:
    experiments = _folder.scan(args.input)
    value = None
    for exp in experiments:
        for run in _scaling.latest_per_config(exp.runs):
            reg = run.regions.get(args.region)
            if reg and "parallel_efficiency" in reg.pop:
                value = reg.pop["parallel_efficiency"]
    with open(args.output, "w") as f:
        f.write(_report.badge_svg(args.label, value))
    print(f"badge: {args.output} ({value})")
    return 0


def _cmd_validate(args: argparse.Namespace) -> int:
    """Validate the folder structure + every record's factor identities."""
    from repro_torch.core import factors as F

    experiments = _folder.scan(args.input)
    bad = 0
    for exp in experiments:
        for run in exp.runs:
            for name, reg in run.regions.items():
                errs = F.validate_pop(reg.pop) if reg.pop else []
                for e in errs:
                    bad += 1
                    print(f"{exp.rel_path}: {run.timestamp} region {name}: {e}")
    print(f"{sum(len(e.runs) for e in experiments)} runs checked, {bad} violations")
    return 1 if bad else 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="talp", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("ci-report", help="generate the HTML report")
    r.add_argument("-i", "--input", required=True)
    r.add_argument("-o", "--output", required=True)
    r.add_argument("--regions", nargs="*", default=[])
    r.add_argument("--region-for-badge", default=None)
    r.add_argument("--overlap", type=float, default=0.0,
                   help="modeled compute/comm overlap fraction")
    r.add_argument("--top-computations", type=int, default=8, metavar="N",
                   help="rows in the per-computation drill-down tables/plots "
                        "(0 disables the breakdown)")
    r.add_argument("--title", default="TALP-Pages performance report")
    r.add_argument("--print-tables", action="store_true")
    r.set_defaults(fn=_cmd_ci_report)

    m = sub.add_parser("metadata", help="inject git metadata into run records")
    m.add_argument("-i", "--input", required=True)
    m.add_argument("--git-dir", default=".")
    m.add_argument("--extra", nargs="*", default=[], metavar="K=V")
    m.set_defaults(fn=_cmd_metadata)

    h = sub.add_parser("merge-history", help="merge previous pipeline artifacts")
    h.add_argument("--history", required=True)
    h.add_argument("--current", required=True)
    h.set_defaults(fn=_cmd_merge_history)

    b = sub.add_parser("badge", help="emit a parallel-efficiency badge")
    b.add_argument("-i", "--input", required=True)
    b.add_argument("-o", "--output", required=True)
    b.add_argument("--region", default=GLOBAL_REGION)
    b.add_argument("--label", default="parallel eff")
    b.set_defaults(fn=_cmd_badge)

    v = sub.add_parser("validate", help="check records + factor identities")
    v.add_argument("-i", "--input", required=True)
    v.set_defaults(fn=_cmd_validate)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
