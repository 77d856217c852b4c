"""Tracing-based baseline — the Score-P/Extrae stand-in (paper §Comparison).

The paper compares TALP-Pages against trace-based toolchains that can also
produce the scaling-efficiency table, at orders-of-magnitude higher
post-processing cost (Table 2). To reproduce that comparison end-to-end we
implement the baseline **inside** the framework: a tracer that records the
full event timeline (per device, per step, per region, per collective — the
granularity Extrae/Score-P record at) and a post-processor that recovers
the *same* POP factors from the trace (the Tables 6/7 cross-tool agreement
check).

Cost structure mirrors the real tools by construction:
  * runtime: an event append per (device, step, region, collective) —
    O(devices x steps) work and storage vs the monitor's O(regions) state;
  * post-processing: the whole trace is materialized and sorted (Paraver/
    Scalasca semantics) before factors are computed.

This module is intentionally *not* optimized: it is the honest baseline.

The port's copy of ``repro.core.tracer``. Its recorder is ``EventTracer``
(the JAX package's ``TraceRecorder``; the name differs, as the monitor's
does, because the JAX package's tests keep that constructor to its own
files). ``record_step`` waits on the step's CUDA outputs as the monitor
does, and ``trace_meta.json`` names the run's ``hardware``, so
``post_process`` computes the factors under the spec the run was recorded
for (``tpu_v5e``, the records' own default, where the key is missing, as
in a JAX trace).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any

import numpy as np

from repro_torch.core import factors as _factors
from repro_torch.core.monitor import _block, _host
from repro_torch.core.profile import StepProfile
from repro_torch.core.records import (
    DEFAULT_TOP_COMPUTATIONS,
    GLOBAL_REGION,
    RegionCounters,
    RegionMeasurements,
    RegionRecord,
    ResourceConfig,
    RunRecord,
    merge_computations,
)


class EventTracer:
    """Records one event stream per device rank, like Extrae's per-process
    .mpit files."""

    def __init__(
        self,
        trace_dir: str,
        resources: ResourceConfig,
        app_name: str = "app",
        clock=time.perf_counter,
        hardware: str = "h100_sxm",
    ) -> None:
        self.trace_dir = trace_dir
        self.resources = resources
        self.app_name = app_name
        self.clock = clock
        self.hardware = hardware
        os.makedirs(trace_dir, exist_ok=True)
        self._files = [
            open(os.path.join(trace_dir, f"rank_{r:05d}.trace"), "w")
            for r in range(resources.total_devices)
        ]
        self._region_stack: list[str] = []
        self._step_profiles: dict[str, StepProfile] = {}
        self._t0 = self.clock()
        self._emit_all("region_enter", region=GLOBAL_REGION)

    # -- event emission ------------------------------------------------

    def _emit_all(self, kind: str, **fields: Any) -> None:
        t = self.clock() - self._t0
        for rank, f in enumerate(self._files):
            rec = {"t": t, "kind": kind, "rank": rank, **fields}
            f.write(json.dumps(rec))
            f.write("\n")

    def region_enter(self, name: str) -> None:
        self._region_stack.append(name)
        self._emit_all("region_enter", region=name)

    def region_exit(self, name: str) -> None:
        if self._region_stack and self._region_stack[-1] == name:
            self._region_stack.pop()
        self._emit_all("region_exit", region=name)

    def attach_static(self, region: str, profile: StepProfile) -> None:
        self._step_profiles[region] = profile

    def record_step(self, outputs: Any = None, **aux: Any) -> None:
        """One step: emits compute events plus one event per collective
        instance per device — the Extrae-style full-granularity record."""
        if outputs is not None:
            _block(outputs)
        region = self._region_stack[-1] if self._region_stack else GLOBAL_REGION
        self._emit_all("step", region=region)
        profile = self._step_profiles.get(region)
        if profile is not None:
            per_dev = max(profile.num_devices, 1)
            for kind, count in profile.collective_counts.items():
                bytes_per = (
                    (profile.collective_bytes_ici + profile.collective_bytes_dcn)
                    / per_dev
                    / max(sum(profile.collective_counts.values()), 1)
                )
                for i in range(int(count)):
                    self._emit_all(
                        "collective", coll=kind, idx=i, bytes=bytes_per, region=region
                    )
        for k, v in aux.items():
            if v is None:
                continue
            arr = _host(v).reshape(-1)
            self._emit_all(k, values=arr.tolist(), region=region)

    def close(self) -> dict[str, Any]:
        self._emit_all("region_exit", region=GLOBAL_REGION)
        meta = {
            "app_name": self.app_name,
            "resources": self.resources.to_json(),
            "hardware": self.hardware,
            "profiles": {k: p.to_json() for k, p in self._step_profiles.items()},
        }
        with open(os.path.join(self.trace_dir, "trace_meta.json"), "w") as f:
            json.dump(meta, f)
        for f in self._files:
            f.close()
        return meta


# ---------------------------------------------------------------------------
# post-processing (the expensive path measured in benchmark Table 2)
# ---------------------------------------------------------------------------


def trace_storage_bytes(trace_dir: str) -> int:
    total = 0
    for name in os.listdir(trace_dir):
        total += os.path.getsize(os.path.join(trace_dir, name))
    return total


def post_process(trace_dir: str) -> RunRecord:
    """Reconstruct the run record (and POP factors) from the raw trace.

    Deliberately materializes the full, globally sorted event list first —
    this is what Paraver/Scalasca-style analysis does, and what makes the
    memory row of Table 2 large.
    """
    with open(os.path.join(trace_dir, "trace_meta.json")) as f:
        meta = json.load(f)
    resources = ResourceConfig.from_json(meta["resources"])
    hardware = meta.get("hardware", "tpu_v5e")
    profiles = {k: StepProfile.from_json(p) for k, p in meta.get("profiles", {}).items()}

    events: list[dict[str, Any]] = []
    for name in sorted(os.listdir(trace_dir)):
        if not name.endswith(".trace"):
            continue
        with open(os.path.join(trace_dir, name)) as f:
            for line in f:
                events.append(json.loads(line))
    events.sort(key=lambda e: (e["t"], e["rank"]))

    # timeline reconstruction per region
    @dataclasses.dataclass
    class _Reg:
        elapsed: float = 0.0
        visits: int = 0
        steps: int = 0
        t_enter: float | None = None
        last_t: float = 0.0
        device_time: float = 0.0
        data_lb_samples: list[float] = dataclasses.field(default_factory=list)
        expert_lb_samples: list[float] = dataclasses.field(default_factory=list)
        host_lb_samples: list[float] = dataclasses.field(default_factory=list)

    regs: dict[str, _Reg] = {}
    t_end = events[-1]["t"] if events else 0.0

    for ev in events:
        if ev["rank"] != 0:  # rank 0 carries the canonical timeline
            continue
        region = ev.get("region", GLOBAL_REGION)
        reg = regs.setdefault(region, _Reg())
        kind = ev["kind"]
        if kind == "region_enter":
            if reg.t_enter is None:
                reg.t_enter = ev["t"]
                reg.visits += 1
                reg.last_t = ev["t"]
        elif kind == "region_exit":
            if reg.t_enter is not None:
                reg.elapsed += ev["t"] - reg.t_enter
                reg.t_enter = None
        elif kind == "step":
            reg.steps += 1
            reg.device_time += ev["t"] - reg.last_t
            reg.last_t = ev["t"]
            for other in regs.values():
                if other is not reg and other.t_enter is not None:
                    other.steps += 0  # nested accounting happens via own events
        elif kind == "tokens_per_shard":
            w = np.asarray(ev["values"])
            if w.size and w.max() > 0:
                reg.data_lb_samples.append(float(w.mean() / w.max()))
        elif kind == "expert_load":
            w = np.asarray(ev["values"])
            if w.size and w.max() > 0:
                reg.expert_lb_samples.append(float(w.mean() / w.max()))
        elif kind == "host_times":
            w = np.asarray(ev["values"])
            if w.size and w.max() > 0:
                reg.host_lb_samples.append(float(w.mean() / w.max()))

    regions: dict[str, RegionRecord] = {}
    for name, reg in regs.items():
        if reg.t_enter is not None:  # unclosed region: close at trace end
            reg.elapsed += t_end - reg.t_enter
        meas = RegionMeasurements(
            elapsed_s=reg.elapsed,
            num_visits=reg.visits,
            num_steps=reg.steps,
            device_time_s=reg.device_time,
            data_lb=float(np.mean(reg.data_lb_samples)) if reg.data_lb_samples else None,
            expert_lb=float(np.mean(reg.expert_lb_samples)) if reg.expert_lb_samples else None,
            host_lb=float(np.mean(reg.host_lb_samples)) if reg.host_lb_samples else None,
        )
        counters = RegionCounters()
        computations = {}
        if name in profiles:
            scaled = profiles[name].scaled(max(reg.steps, 1))
            counters = scaled.to_counters()
            # same typed breakdown as the monitor (cross-tool agreement)
            computations = {
                cc.name: cc
                for cc in scaled.top_computations(DEFAULT_TOP_COMPUTATIONS)
            }
        regions[name] = RegionRecord(
            name=name, measurements=meas, counters=counters,
            computations=computations,
        )

    g = regions.setdefault(GLOBAL_REGION, RegionRecord(name=GLOBAL_REGION))
    if g.counters.useful_flops == 0.0:
        for name, r in regions.items():
            if name == GLOBAL_REGION:
                continue
            g.counters.useful_flops += r.counters.useful_flops
            g.counters.hlo_bytes += r.counters.hlo_bytes
            g.counters.collective_bytes_ici += r.counters.collective_bytes_ici
            g.counters.collective_bytes_dcn += r.counters.collective_bytes_dcn
            g.counters.model_flops += r.counters.model_flops
        if not g.computations:
            # Global inherits the child breakdown, exactly like the monitor
            g.computations = merge_computations(
                r.computations for n_, r in regions.items() if n_ != GLOBAL_REGION
            )

    import datetime as _dt

    run = RunRecord(
        app_name=meta.get("app_name", "app"),
        resources=resources,
        timestamp=_dt.datetime.now(_dt.timezone.utc).isoformat(),
        regions=regions,
        hardware=hardware,
    )
    for r in run.regions.values():
        r.pop = _factors.compute_pop(r, run.resources, hardware)
    return run
