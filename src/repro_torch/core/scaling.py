"""Scaling-efficiency tables (paper Fig. 3, Tables 6/7).

Given the runs of one experiment folder:
  * group runs by resource configuration (column key),
  * keep the run with the **latest timestamp** per configuration,
  * pick the configuration with the **least resources** as the reference,
  * detect weak vs strong scaling from the instructions-per-device rule,
  * emit one column of POP factors per configuration.

All rules follow the paper's §Scaling-efficiency table verbatim. The
port's copy of ``repro.core.scaling``: each column's factors are computed
under the hardware its record names (``core.hardware`` knows the H100 and
the JAX package's targets).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core import factors as F
from repro_torch.core.records import GLOBAL_REGION, RegionRecord, ResourceConfig, RunRecord


@dataclasses.dataclass
class ScalingColumn:
    label: str
    resources: ResourceConfig
    timestamp: str
    pop: dict[str, float]
    is_reference: bool


@dataclasses.dataclass
class ScalingTable:
    region: str
    mode: str  # factors.WEAK | factors.STRONG | "comparison"
    columns: list[ScalingColumn]

    def row(self, key: str) -> list[float | None]:
        return [c.pop.get(key) for c in self.columns]

    def to_json(self) -> dict[str, Any]:
        return {
            "region": self.region,
            "mode": self.mode,
            "columns": [
                {
                    "label": c.label,
                    "resources": c.resources.to_json(),
                    "timestamp": c.timestamp,
                    "pop": dict(c.pop),
                    "is_reference": c.is_reference,
                }
                for c in self.columns
            ],
        }


def latest_per_config(runs: list[RunRecord]) -> list[RunRecord]:
    """One run per resource configuration — the latest timestamp wins."""
    best: dict[str, RunRecord] = {}
    for run in runs:
        key = run.resources.label
        cur = best.get(key)
        if cur is None or run.timestamp > cur.timestamp:
            best[key] = run
    return sorted(best.values(), key=lambda r: r.resources.total_devices)


def build_table(
    runs: list[RunRecord],
    region: str = GLOBAL_REGION,
    overlap_fraction: float = 0.0,
    mode: str | None = None,
) -> ScalingTable | None:
    """Build the scaling-efficiency table for one experiment folder."""
    selected = [r for r in latest_per_config(runs) if region in r.regions]
    if not selected:
        return None

    pairs: list[tuple[RegionRecord, ResourceConfig]] = [
        (r.regions[region], r.resources) for r in selected
    ]
    if mode is None:
        mode = F.detect_scaling_mode(pairs)
    ref_region, ref_resources = pairs[0]  # least resources (sorted above)

    columns = []
    for run, (reg, res) in zip(selected, pairs):
        pop = F.compute_pop(
            reg,
            res,
            run.hardware,
            overlap_fraction=overlap_fraction,
            ref=(ref_region, ref_resources),
            mode=mode,
        )
        columns.append(
            ScalingColumn(
                label=res.label,
                resources=res,
                timestamp=run.timestamp,
                pop=pop,
                is_reference=res.label == ref_resources.label,
            )
        )
    return ScalingTable(region=region, mode=mode, columns=columns)


def render_text(table: ScalingTable, width: int = 9) -> str:
    """Plain-text rendering (used by the CLI and tests)."""
    header = ["Metrics".ljust(36)] + [c.label.rjust(width) for c in table.columns]
    lines = [" | ".join(header)]
    lines.append("-" * len(lines[0]))
    for key, depth in F.iter_tree():
        vals = table.row(key)
        if all(v is None for v in vals):
            continue
        name = ("  " * depth) + F.DISPLAY_NAMES.get(key, key)
        cells = [
            ("-".rjust(width) if v is None else f"{v:.2f}".rjust(width)) for v in vals
        ]
        lines.append(" | ".join([name.ljust(36)] + cells))
    for key in F.INFO_ROWS:
        vals = table.row(key)
        if all(v is None for v in vals):
            continue
        fmt = "{:.2f}" if key != F.ELAPSED_S else "{:.2f}"
        cells = [
            ("-".rjust(width) if v is None else fmt.format(v).rjust(width)) for v in vals
        ]
        lines.append(" | ".join([F.DISPLAY_NAMES.get(key, key).ljust(36)] + cells))
    lines.append(f"(scaling mode: {table.mode}, region: {table.region})")
    return "\n".join(lines)
