"""Time-evolution series (paper §Time-evolution plots, Figure 7).

For each resource configuration in an experiment folder, order runs by the
series timestamp (git commit timestamp when present, else the DLB
end-of-execution timestamp) and expose per-region metric series:
elapsed time, the computation counters (FLOPs, throughput, frequency
analogues), parallel efficiency and its sub-metrics. The port's copy of
``repro.core.timeseries``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core import factors as F
from repro_torch.core.records import RunRecord

# metric groups rendered as plot rows (paper: elapsed | computation | efficiency)
SERIES_GROUPS: list[tuple[str, list[str]]] = [
    ("Elapsed time [s]", [F.ELAPSED_S]),
    (
        "Computation",
        [F.ACHIEVED_TFLOPS, F.MXU_UTIL, F.FLOP_USEFULNESS],
    ),
    (
        "Parallel efficiency",
        [F.PARALLEL_EFF, F.DISPATCH_EFF, F.COMM_EFF, F.LOAD_BALANCE],
    ),
    (
        "Sub-metrics",
        [F.ICI_COMM_EFF, F.DCN_COMM_EFF, F.DATA_LB, F.EXPERT_LB, F.HOST_LB],
    ),
]


@dataclasses.dataclass
class SeriesPoint:
    timestamp: str
    commit: str | None
    values: dict[str, float]  # factor key -> value (one region)
    # per-computation counters at this point (schema v3):
    # computation name -> {metric -> value}, metrics per
    # records.ComputationCounters.METRICS
    computations: dict[str, dict[str, float]] = dataclasses.field(
        default_factory=dict
    )


@dataclasses.dataclass
class RegionSeries:
    region: str
    points: list[SeriesPoint]

    def series(self, key: str) -> list[tuple[str, float]]:
        return [
            (p.timestamp, p.values[key]) for p in self.points if key in p.values
        ]

    def computation_series(self, metric: str = "hbm_bytes") -> dict[str, list[float]]:
        """Per-computation time series of one counter metric, aligned to
        ``points`` (NaN where a point lacks the computation — e.g. runs
        recorded before the computation existed or below the top-N cut)."""
        names: list[str] = []
        for p in self.points:
            for n in p.computations:
                if n not in names:
                    names.append(n)
        return {
            n: [p.computations.get(n, {}).get(metric, float("nan")) for p in self.points]
            for n in names
        }

    def top_computation_names(self, n: int = 5, metric: str = "hbm_bytes") -> list[str]:
        """Names of the n heaviest computations by peak ``metric`` over the
        series (the ones worth plotting)."""
        peak: dict[str, float] = {}
        for p in self.points:
            for cn, cv in p.computations.items():
                peak[cn] = max(peak.get(cn, 0.0), cv.get(metric, 0.0))
        return sorted(peak, key=lambda cn: peak[cn], reverse=True)[:n]


@dataclasses.dataclass
class ConfigSeries:
    """All region series for one resource configuration."""

    label: str
    regions: dict[str, RegionSeries]

    def to_json(self) -> dict[str, Any]:
        return {
            "label": self.label,
            "regions": {
                name: [
                    {
                        "timestamp": p.timestamp,
                        "commit": p.commit,
                        "values": p.values,
                        "computations": p.computations,
                    }
                    for p in rs.points
                ]
                for name, rs in self.regions.items()
            },
        }


def build_series(runs: list[RunRecord]) -> list[ConfigSeries]:
    by_config: dict[str, list[RunRecord]] = {}
    for run in runs:
        by_config.setdefault(run.resources.label, []).append(run)

    out = []
    for label in sorted(by_config, key=lambda s: [int(t) for t in s.split("x") if t.isdigit()] or [0]):
        cfg_runs = sorted(by_config[label], key=lambda r: r.series_timestamp)
        regions: dict[str, RegionSeries] = {}
        for run in cfg_runs:
            for name, reg in run.regions.items():
                rs = regions.setdefault(name, RegionSeries(region=name, points=[]))
                values = dict(reg.pop) if reg.pop else {}
                values.setdefault(F.ELAPSED_S, reg.measurements.elapsed_s)
                # raw counters/measurements (underscore keys): consumed by
                # regression detection to compute cross-run scalability
                values["_useful_flops"] = reg.counters.useful_flops
                values["_model_flops"] = reg.counters.model_flops
                values["_hbm_bytes"] = reg.counters.hlo_bytes
                values["_collective_bytes"] = (
                    reg.counters.collective_bytes_ici
                    + reg.counters.collective_bytes_dcn
                )
                values["_device_time_s"] = reg.measurements.device_time_s
                rs.points.append(
                    SeriesPoint(
                        timestamp=run.series_timestamp,
                        commit=run.metadata.get("git_commit_short")
                        or run.metadata.get("git_commit"),
                        values=values,
                        computations={
                            cn: {m: getattr(cc, m) for m in cc.METRICS}
                            for cn, cc in reg.computations.items()
                        },
                    )
                )
        out.append(ConfigSeries(label=label, regions=regions))
    return out
