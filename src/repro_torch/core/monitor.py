"""RegionMonitor: the on-the-fly TALP collector (``repro.core.monitor``'s
``TalpMonitor``) for PyTorch programs.

O(regions) collection of the measurements that feed the POP factor
hierarchy (core.factors): an implicit Global region spanning start..stop,
a region API with nesting and accumulation over visits, per-region running
accumulators only (never per-step logs), one RunRecord at the end.

Runtime-measured quantities: elapsed wall time, device-busy time (the host
waits for a step's outputs with ``torch.cuda.synchronize``), step counts,
data/expert/host load balances (sampled every ``lb_sample_every`` steps).
Static quantities: the ``StepProfile`` counted from one execution of the
step (core.profile), attached per region and scaled by the observed step
count at finalize time.

``sync_regions`` keeps the paper's overhead trade-off (Table 1):
synchronizing at region boundaries gives exact attribution but costs the
overlap of host dispatch with device work.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import factors as _factors
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


def _cuda_devices(tree, found: set) -> set:
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, found)
    return found


def _block(tree) -> None:
    """Wait until the device work behind ``tree`` is done: synchronize every
    CUDA device holding one of its tensors. CPU tensors are computed
    eagerly, so there is nothing to wait for."""
    for dev in _cuda_devices(tree, set()):
        torch.cuda.synchronize(dev)


def _host(x) -> np.ndarray:
    """A tensor, array or list as a float64 numpy array on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


@dataclasses.dataclass
class MonitorConfig:
    app_name: str = "app"
    hardware: str = "h100_sxm"
    sync_regions: bool = True
    lb_sample_every: int = 10
    overlap_fraction: float = 0.0  # modeled compute/comm overlap for comm-eff
    # how many of the heaviest computations (operators, kernels) to persist per region
    # (bounds the run-record size; 0 disables the breakdown entirely)
    top_computations: int = DEFAULT_TOP_COMPUTATIONS
    clock: Callable[[], float] = time.perf_counter


class _LBAccumulator:
    """Running step-weighted mean of avg/max work ratios. O(1) state."""

    __slots__ = ("total", "count")

    def __init__(self) -> None:
        self.total = 0.0
        self.count = 0

    def update(self, work: np.ndarray | list[float]) -> None:
        w = np.asarray(work, dtype=np.float64).reshape(-1)
        if w.size == 0:
            return
        mx = float(w.max())
        if mx <= 0.0:
            return
        self.total += float(w.mean()) / mx
        self.count += 1

    def value(self) -> float | None:
        if self.count == 0:
            return None
        return self.total / self.count


class _RegionState:
    __slots__ = (
        "name", "elapsed", "visits", "steps", "device_time", "open_depth",
        "t_enter", "t_last_mark", "data_lb", "expert_lb", "in_pod_lb",
        "inter_pod_lb", "host_lb", "static", "static_steps",
    )

    def __init__(self, name: str) -> None:
        self.name = name
        self.elapsed = 0.0
        self.visits = 0
        self.steps = 0
        self.device_time = 0.0
        self.open_depth = 0
        self.t_enter = 0.0
        self.t_last_mark = 0.0
        self.data_lb = _LBAccumulator()
        self.expert_lb = _LBAccumulator()
        self.host_lb = _LBAccumulator()
        self.in_pod_lb = _LBAccumulator()
        self.inter_pod_lb = _LBAccumulator()
        self.static: StepProfile | None = None
        self.static_steps = 0


class RegionMonitor:
    name = "monitor"  # satisfies the repro_torch.session.Collector protocol

    def __init__(
        self,
        config: MonitorConfig | None = None,
        resources: ResourceConfig | None = None,
        metadata: dict[str, Any] | None = None,
    ) -> None:
        self.config = config or MonitorConfig()
        self.resources = resources or ResourceConfig()
        self.metadata = dict(metadata or {})
        self._regions: dict[str, _RegionState] = {}
        self._stack: list[_RegionState] = []
        self._started = False
        self._stopped = False
        self._step_counter = 0

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def start(self) -> "RegionMonitor":
        if self._started:
            raise RuntimeError("monitor already started")
        self._started = True
        self._enter(GLOBAL_REGION)
        return self

    def stop(self) -> None:
        if self._stopped:
            return
        while self._stack:
            self._exit(self._stack[-1].name, sync=None)
        self._stopped = True

    # ------------------------------------------------------------------
    # regions
    # ------------------------------------------------------------------

    def _state(self, name: str) -> _RegionState:
        st = self._regions.get(name)
        if st is None:
            st = self._regions[name] = _RegionState(name)
        return st

    def _enter(self, name: str) -> None:
        st = self._state(name)
        now = self.config.clock()
        if st.open_depth == 0:
            st.t_enter = now
            st.t_last_mark = now
            st.visits += 1
        st.open_depth += 1
        self._stack.append(st)

    def _exit(self, name: str, sync: Any) -> None:
        st = self._regions[name]
        if self.config.sync_regions and sync is not None:
            _block(sync)
        now = self.config.clock()
        st.open_depth -= 1
        if st.open_depth == 0:
            st.elapsed += now - st.t_enter
        if self._stack and self._stack[-1] is st:
            self._stack.pop()
        else:  # out-of-order exit: remove the most recent matching frame
            for i in range(len(self._stack) - 1, -1, -1):
                if self._stack[i] is st:
                    del self._stack[i]
                    break

    def region_enter(self, name: str) -> None:
        """Open a region (pairs with ``region_exit``); the
        ``repro_torch.session`` facade's regions are built on these."""
        if name == GLOBAL_REGION:
            raise ValueError("the Global region is implicit")
        if not self._started:
            self.start()
        self._enter(name)

    def region_exit(self, name: str, sync: Any = None) -> None:
        self._exit(name, sync)

    # ------------------------------------------------------------------
    # per-step observation
    # ------------------------------------------------------------------

    def observe_step(
        self,
        outputs: Any = None,
        *,
        tokens_per_shard: Any = None,
        expert_load: Any = None,
        host_times: Any = None,
        pod_size: int | None = None,
    ) -> None:
        """Record one training/serving step.

        outputs          -- step outputs; blocked on (measures device time)
        tokens_per_shard -- (data_shards,) real (non-pad) tokens per shard
        expert_load      -- (experts,) tokens routed per expert
        host_times       -- (hosts,) per-host step durations
        All are optional and sampled every ``lb_sample_every`` steps.
        """
        cfg = self.config
        self._step_counter += 1
        opened = [st for st in self._regions.values() if st.open_depth > 0]
        if outputs is not None:
            _block(outputs)
        now = cfg.clock()
        for st in opened:
            st.steps += 1
            st.device_time += now - st.t_last_mark
            st.t_last_mark = now
        if self._step_counter % max(cfg.lb_sample_every, 1) != 0:
            return
        if tokens_per_shard is not None:
            arr = _host(tokens_per_shard)
            for st in opened:
                st.data_lb.update(arr)
        if expert_load is not None:
            arr = _host(expert_load)
            for st in opened:
                st.expert_lb.update(arr)
        if host_times is not None:
            arr = _host(host_times).reshape(-1)
            # host LB splits: in-pod = balance within each pod (mean over
            # pods), inter-pod = balance of per-pod maxima
            if pod_size and pod_size > 0 and arr.size % pod_size == 0 and arr.size > pod_size:
                pods = arr.reshape(-1, pod_size)
                in_pod = float(np.mean(pods.mean(axis=1) / np.maximum(pods.max(axis=1), 1e-30)))
                pod_max = pods.max(axis=1)
                inter_pod = float(pod_max.mean() / max(pod_max.max(), 1e-30))
                for st in opened:
                    st.in_pod_lb.total += in_pod
                    st.in_pod_lb.count += 1
                    st.inter_pod_lb.total += inter_pod
                    st.inter_pod_lb.count += 1
            else:
                for st in opened:
                    st.host_lb.update(arr)

    def mark_device(self) -> None:
        """Reset the device-time mark (call after host-only work inside a
        region so it is not attributed to device time)."""
        now = self.config.clock()
        for st in self._regions.values():
            if st.open_depth > 0:
                st.t_last_mark = now

    # ------------------------------------------------------------------
    # static counters (the PAPI analogue)
    # ------------------------------------------------------------------

    def attach_static(self, region: str, profile: StepProfile) -> None:
        """Attach the compiled-step profile for a region. Counters scale
        with the region's observed step count at finalize time."""
        self._state(region).static = profile

    # ------------------------------------------------------------------
    # finalize
    # ------------------------------------------------------------------

    def finalize(self) -> RunRecord:
        if not self._stopped:
            self.stop()
        regions: dict[str, RegionRecord] = {}
        for name, st in self._regions.items():
            meas = RegionMeasurements(
                elapsed_s=st.elapsed,
                num_visits=st.visits,
                num_steps=st.steps,
                device_time_s=st.device_time,
                data_lb=st.data_lb.value(),
                expert_lb=st.expert_lb.value(),
                host_lb=st.host_lb.value(),
                in_pod_lb=st.in_pod_lb.value(),
                inter_pod_lb=st.inter_pod_lb.value(),
            )
            counters = RegionCounters()
            computations = {}
            if st.static is not None:
                n = max(st.steps, st.visits, 1)
                scaled = st.static.scaled(n)
                counters = scaled.to_counters()
                # typed per-computation slice (schema v3), truncated to the
                # heaviest entries so the artifact stays O(regions)-small
                computations = {
                    cc.name: cc
                    for cc in scaled.top_computations(self.config.top_computations)
                }
            regions[name] = RegionRecord(
                name=name, measurements=meas, counters=counters,
                computations=computations,
            )

        # Global region inherits summed counters from annotated children if
        # it has none itself (TALP's implicit-global semantics).
        g = regions.get(GLOBAL_REGION)
        if g is not None and g.counters.useful_flops == 0.0:
            agg = RegionCounters()
            for name, r in regions.items():
                if name == GLOBAL_REGION:
                    continue
                agg.useful_flops += r.counters.useful_flops
                agg.hlo_bytes += r.counters.hlo_bytes
                agg.collective_bytes_ici += r.counters.collective_bytes_ici
                agg.collective_bytes_dcn += r.counters.collective_bytes_dcn
                agg.model_flops += r.counters.model_flops
            g.counters = agg
            if not g.computations:
                g.computations = merge_computations(
                    (r.computations for n_, r in regions.items() if n_ != GLOBAL_REGION),
                    self.config.top_computations,
                )

        run = RunRecord(
            app_name=self.config.app_name,
            resources=self.resources,
            timestamp=_dt.datetime.now(_dt.timezone.utc).isoformat(),
            regions=regions,
            metadata=dict(self.metadata),
            hardware=self.config.hardware,
        )
        for r in run.regions.values():
            r.pop = _factors.compute_pop(
                r, run.resources, self.config.hardware,
                overlap_fraction=self.config.overlap_fraction,
            )
        return run
