"""TALP JSON record schema: the port's copy of ``repro.core.records``.

Schema v3 unchanged (``docs/RECORD_SCHEMA.md``), so one report renders
the records of both packages. One JSON file per run — the artifact TALP (the DLB module) writes after
execution and TALP-Pages consumes. This is the contract between the
*collection* side (``core.monitor`` running inside the training/serving
process) and the *reporting* side (``core.pages`` running later, possibly on
a different machine, from CI artifacts).

Layout mirrors DLB-TALP's pop-metrics JSON, adapted to the TPU/JAX setting
(DESIGN.md §3): MPI processes -> host processes, OpenMP threads -> local
devices, PAPI counters -> HLO-derived counters.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

SCHEMA_VERSION = 3

GLOBAL_REGION = "Global"


# --------------------------------------------------------------------------
# resource configuration
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ResourceConfig:
    """Which resources a run used. The scaling table's column key.

    ``label`` renders like the paper's "2x56" (hosts x devices-per-host); the
    mesh dict carries the full axis split so factors can be attributed to
    ICI vs DCN domains.
    """

    num_hosts: int = 1
    devices_per_host: int = 1
    mesh: dict[str, int] = dataclasses.field(default_factory=dict)
    num_pods: int = 1

    @property
    def total_devices(self) -> int:
        return self.num_hosts * self.devices_per_host

    @property
    def label(self) -> str:
        return f"{self.num_hosts}x{self.devices_per_host}"

    def to_json(self) -> dict[str, Any]:
        return {
            "num_hosts": self.num_hosts,
            "devices_per_host": self.devices_per_host,
            "num_pods": self.num_pods,
            "mesh": dict(self.mesh),
        }

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "ResourceConfig":
        return cls(
            num_hosts=int(d.get("num_hosts", 1)),
            devices_per_host=int(d.get("devices_per_host", 1)),
            num_pods=int(d.get("num_pods", 1)),
            mesh=dict(d.get("mesh", {})),
        )


# --------------------------------------------------------------------------
# per-region data
# --------------------------------------------------------------------------


@dataclasses.dataclass
class RegionCounters:
    """The PAPI-analogue counters for one region (DESIGN.md §3).

    useful_flops      -- executed HLO FLOPs attributed to this region (total,
                         all devices, whole region lifetime). The
                         "instructions" analogue.
    hlo_bytes         -- HBM bytes moved (total).
    collective_bytes  -- bytes through collectives, split by fabric domain.
    model_flops       -- 6*N*D-style useful model FLOPs (to expose
                         remat/redundancy waste as instruction inflation,
                         exactly what PAPI instruction counts catch on CPUs).
    """

    useful_flops: float = 0.0
    hlo_bytes: float = 0.0
    collective_bytes_ici: float = 0.0
    collective_bytes_dcn: float = 0.0
    model_flops: float = 0.0

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "RegionCounters":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: float(v) for k, v in d.items() if k in known})


@dataclasses.dataclass
class RegionMeasurements:
    """On-the-fly measured quantities for one region (O(1) memory).

    Times are host-wall seconds over the whole region lifetime (sum over
    visits). Load-balance inputs are dimensionless [0, 1] ratios
    (avg work / max work) accumulated as running step-weighted means; see
    monitor.LoadBalanceAccumulator.
    """

    elapsed_s: float = 0.0
    num_visits: int = 0
    num_steps: int = 0
    # measured device-work time (dispatch->block_until_ready), summed
    device_time_s: float = 0.0
    # data-parallel load balance from real token counts (padding skew)
    data_lb: float | None = None
    # expert-parallel load balance from router statistics (MoE only)
    expert_lb: float | None = None
    # host-level timing balance (multi-host; straggler indicator)
    host_lb: float | None = None
    in_pod_lb: float | None = None
    inter_pod_lb: float | None = None

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "RegionMeasurements":
        known = {f.name for f in dataclasses.fields(cls)}
        kw: dict[str, Any] = {}
        for k, v in d.items():
            if k not in known:
                continue
            if k in ("num_visits", "num_steps"):
                kw[k] = int(v)
            else:
                kw[k] = None if v is None else float(v)
        return cls(**kw)


# truncation knob shared by the collectors (MonitorConfig default, tracer):
# how many of the heaviest computations a region persists, ranked by
# RANK_METRIC. The regression side uses RANK_METRIC to decide whether a
# computation absent from one run's breakdown could merely sit below the cut.
DEFAULT_TOP_COMPUTATIONS = 16
RANK_METRIC = "hbm_bytes"


def top_computations(items, n: int = 8, by: str = RANK_METRIC) -> list:
    """The n heaviest per-computation cost entries by attribute ``by`` —
    the one ranking shared by HloCost, StepProfile and RegionRecord."""
    return sorted(items, key=lambda c: getattr(c, by), reverse=True)[: max(n, 0)]


def merge_computations(
    per_region, n: int = DEFAULT_TOP_COMPUTATIONS
) -> dict[str, "ComputationCounters"]:
    """Sum per-computation counters across regions and keep the heaviest n —
    the Global region's breakdown inheritance (monitor and tracer)."""
    agg: dict[str, ComputationCounters] = {}
    for comps in per_region:
        for cn, cc in comps.items():
            prev = agg.get(cn)
            if prev is None:
                agg[cn] = dataclasses.replace(cc)
            else:
                prev.flops += cc.flops
                prev.dot_flops += cc.dot_flops
                prev.hbm_bytes += cc.hbm_bytes
                prev.collective_operand_bytes += cc.collective_operand_bytes
    return {cc.name: cc for cc in top_computations(agg.values(), n)}


@dataclasses.dataclass
class ComputationCounters:
    """Counters for one HLO computation inside a region (schema v3).

    The per-computation slice of ``RegionCounters``: machine totals over the
    whole region lifetime, derived from the static ``StepProfile`` breakdown
    scaled by the observed step count. This is what lets a regression finding
    name the computation whose counters moved instead of stopping at the
    factor leaf (e.g. "communication efficiency -> while_body.all_gather.3").

    ``kind`` is the call-graph role from core.hlo (entry|fusion|while_body|
    while_cond|branch|called); ``multiplicity`` is executions per step.
    """

    name: str = ""
    kind: str = "called"
    multiplicity: float = 1.0
    num_instructions: int = 0
    flops: float = 0.0
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_operand_bytes: float = 0.0

    # metrics a regression can be attributed to (share-shift ranking)
    METRICS = ("flops", "hbm_bytes", "collective_operand_bytes")

    def to_json(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d.pop("name")  # dict key carries the name
        return d

    @classmethod
    def from_json(cls, name: str, d: dict[str, Any]) -> "ComputationCounters":
        return cls(
            name=name or str(d.get("name", "")),
            kind=str(d.get("kind", "called")),
            multiplicity=float(d.get("multiplicity", 1.0)),
            num_instructions=int(d.get("num_instructions", 0)),
            flops=float(d.get("flops", 0.0)),
            dot_flops=float(d.get("dot_flops", 0.0)),
            hbm_bytes=float(d.get("hbm_bytes", 0.0)),
            collective_operand_bytes=float(d.get("collective_operand_bytes", 0.0)),
        )

    def scaled(self, steps: float) -> "ComputationCounters":
        return dataclasses.replace(
            self,
            flops=self.flops * steps,
            dot_flops=self.dot_flops * steps,
            hbm_bytes=self.hbm_bytes * steps,
            collective_operand_bytes=self.collective_operand_bytes * steps,
        )


@dataclasses.dataclass
class RegionRecord:
    name: str
    measurements: RegionMeasurements = dataclasses.field(
        default_factory=RegionMeasurements
    )
    counters: RegionCounters = dataclasses.field(default_factory=RegionCounters)
    # POP factor hierarchy, filled by factors.compute_pop (flat dict:
    # factor name -> value). Persisted so the report side never recomputes
    # from raw data of old schema versions.
    pop: dict[str, float] = dataclasses.field(default_factory=dict)
    # per-HLO-computation slice of ``counters`` (schema v3; the heaviest
    # computations only — the monitor truncates to its top_computations knob)
    computations: dict[str, ComputationCounters] = dataclasses.field(
        default_factory=dict
    )

    def top_computations(self, n: int = 8, by: str = "hbm_bytes") -> list[ComputationCounters]:
        return top_computations(self.computations.values(), n, by)

    def to_json(self) -> dict[str, Any]:
        d = {
            "measurements": self.measurements.to_json(),
            "counters": self.counters.to_json(),
            "pop": dict(self.pop),
        }
        if self.computations:
            d["computations"] = {
                cn: cc.to_json() for cn, cc in self.computations.items()
            }
        return d

    @classmethod
    def from_json(cls, name: str, d: dict[str, Any]) -> "RegionRecord":
        return cls(
            name=name,
            measurements=RegionMeasurements.from_json(d.get("measurements", {})),
            counters=RegionCounters.from_json(d.get("counters", {})),
            pop={k: float(v) for k, v in d.get("pop", {}).items()},
            computations={
                cn: ComputationCounters.from_json(cn, cd)
                for cn, cd in d.get("computations", {}).items()
            },
        )


# --------------------------------------------------------------------------
# run record (one JSON file)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class RunRecord:
    app_name: str
    resources: ResourceConfig
    timestamp: str  # ISO-8601, end of execution (DLB semantics)
    regions: dict[str, RegionRecord] = dataclasses.field(default_factory=dict)
    # git metadata; commit timestamp overrides `timestamp` for time series
    metadata: dict[str, Any] = dataclasses.field(default_factory=dict)
    hardware: str = "tpu_v5e"
    schema_version: int = SCHEMA_VERSION

    # ---- convenience ----

    @property
    def global_region(self) -> RegionRecord:
        return self.regions[GLOBAL_REGION]

    @property
    def series_timestamp(self) -> str:
        """Timestamp used for time-series ordering (paper: git commit
        timestamp when present, else DLB end-of-execution timestamp)."""
        return str(self.metadata.get("git_commit_timestamp") or self.timestamp)

    def region(self, name: str) -> RegionRecord:
        return self.regions[name]

    # ---- (de)serialization ----

    def to_json(self) -> dict[str, Any]:
        return {
            "schema_version": self.schema_version,
            "app_name": self.app_name,
            "timestamp": self.timestamp,
            "hardware": self.hardware,
            "resources": self.resources.to_json(),
            "metadata": dict(self.metadata),
            "regions": {n: r.to_json() for n, r in self.regions.items()},
        }

    def save(self, path: str | os.PathLike) -> None:
        path = os.fspath(path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
        os.replace(tmp, path)  # atomic: CI artifact collection never sees partial files

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "RunRecord":
        ver = int(d.get("schema_version", 1))
        if ver > SCHEMA_VERSION:
            raise ValueError(
                f"run record schema {ver} is newer than supported {SCHEMA_VERSION}"
            )
        regions = {
            name: RegionRecord.from_json(name, rd)
            for name, rd in d.get("regions", {}).items()
        }
        metadata = dict(d.get("metadata", {}))
        if ver < 3:
            _migrate_v2_computations(regions, metadata)
        return cls(
            app_name=str(d.get("app_name", "unknown")),
            resources=ResourceConfig.from_json(d.get("resources", {})),
            timestamp=str(d.get("timestamp", "")),
            regions=regions,
            metadata=metadata,
            hardware=str(d.get("hardware", "tpu_v5e")),
            # migrated records are v3-shaped in memory; a re-save writes v3
            schema_version=SCHEMA_VERSION,
        )

    @classmethod
    def load(cls, path: str | os.PathLike) -> "RunRecord":
        with open(os.fspath(path)) as f:
            return cls.from_json(json.load(f))


def _migrate_v2_computations(
    regions: dict[str, RegionRecord], metadata: dict[str, Any]
) -> None:
    """v2 -> v3: lift the untyped ``metadata["per_computation"]`` blob
    (region -> list of {name, kind, ...} dicts, written by the old monitor)
    into the typed ``RegionRecord.computations`` field, in place.

    Keeps the paper's merge-history loop intact: old CI artifacts keep
    loading and render through the same per-computation drill-down as fresh
    v3 records.
    """
    blob = metadata.pop("per_computation", None)
    if not isinstance(blob, dict):
        return
    for region_name, comps in blob.items():
        reg = regions.get(region_name)
        if reg is None or not isinstance(comps, list):
            continue
        for cd in comps:
            if not isinstance(cd, dict):
                continue
            cname = str(cd.get("name", ""))
            if cname and cname not in reg.computations:
                reg.computations[cname] = ComputationCounters.from_json(cname, cd)


def load_folder(folder: str | os.PathLike) -> list[RunRecord]:
    """Load every ``*.json`` directly inside ``folder`` (non-recursive)."""
    folder = os.fspath(folder)
    runs = []
    for name in sorted(os.listdir(folder)):
        if name.endswith(".json"):
            runs.append(RunRecord.load(os.path.join(folder, name)))
    return runs
