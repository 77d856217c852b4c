"""repro_torch.session: the single public instrumentation surface of the
port (``repro.session``'s ``PerfSession``).

One facade through which the training loop and the launchers touch
instrumentation, with the collector chosen by config or by environment:

    TALP_ENABLE=1 TALP_BACKEND=monitor python -m repro_torch.launch.train ...
    TALP_ENABLE=1 TALP_BACKEND=tracer  python -m repro_torch.launch.train ...
    TALP_OUT=talp/mycase/history      # redirect finalize() artifacts

Backends (the ``Collector`` protocol):

  monitor   RegionMonitor: O(regions) on-the-fly POP collection
  tracer    EventTracer + post_process (``core.tracer``): the full-event
            Score-P/Extrae baseline; same RunRecord out, orders of
            magnitude more state
  null      no instrumentation; every hook is a no-op and ``wrap_step``
            returns the function unchanged

Surface:

  session.region(name)            context manager AND decorator
  session.wrap_step(fn, ...)      attach a StepProfile to ``region`` (given,
                                  or counted from the first call with
                                  ``derive=True``) and per call: enter the
                                  region, execute, observe the step
  session.observe_step(...)       manual per-step observation
  session.finalize(out_dir)       stop, build the RunRecord, inject git
                                  metadata, save into the CI folder layout
"""

from __future__ import annotations

import dataclasses
import functools
import os
import tempfile
import time
from typing import Any, Callable, Protocol, runtime_checkable

from repro_torch.core.records import (
    DEFAULT_TOP_COMPUTATIONS,
    ResourceConfig,
    RunRecord,
)

# environment contract: the LD_PRELOAD analogue
ENV_ENABLE = "TALP_ENABLE"
ENV_BACKEND = "TALP_BACKEND"
ENV_OUT = "TALP_OUT"

BACKENDS = ("monitor", "tracer", "null")

_FALSY = {"0", "false", "no", "off", ""}


def env_backend(default: str | None = None) -> str | None:
    """Resolve the backend requested through the environment.

    Returns None when ``TALP_ENABLE`` is unset (no env override), ``"null"``
    when it is set falsy (explicit kill switch), else the backend named by
    ``TALP_BACKEND`` (falling back to ``default`` or ``"monitor"``).
    """
    raw = os.environ.get(ENV_ENABLE)
    if raw is None:
        return None
    if raw.strip().lower() in _FALSY:
        return "null"
    backend = os.environ.get(ENV_BACKEND, "").strip().lower() or default or "monitor"
    if backend not in BACKENDS:
        raise ValueError(f"{ENV_BACKEND}={backend!r} is not one of {BACKENDS}")
    return backend


@dataclasses.dataclass
class SessionConfig:
    """Session-level knobs; backend-specific config is derived from these."""

    app_name: str = "app"
    backend: str = "null"  # "monitor" | "tracer" | "null"
    hardware: str = "h100_sxm"
    sync_regions: bool = True
    lb_sample_every: int = 10
    overlap_fraction: float = 0.0
    top_computations: int = DEFAULT_TOP_COMPUTATIONS
    trace_dir: str = ""  # tracer backend event-stream directory
    out_dir: str = ""  # default finalize() destination (CI folder layout)
    clock: Callable[[], float] = time.perf_counter
    # honor TALP_ENABLE / TALP_BACKEND (off for overhead baselines so the
    # environment cannot skew a measurement)
    respect_env: bool = True


@runtime_checkable
class Collector(Protocol):
    """What a PerfSession backend must provide. ``finalize`` may return None
    (the null backend has nothing to report)."""

    name: str

    def start(self) -> None: ...

    def stop(self) -> None: ...

    def region_enter(self, name: str) -> None: ...

    def region_exit(self, name: str, sync: Any = None) -> None: ...

    def observe_step(self, outputs: Any = None, **aux: Any) -> None: ...

    def mark_device(self) -> None: ...

    def attach_static(self, region: str, profile: Any) -> None: ...

    def finalize(self) -> RunRecord | None: ...


class NullCollector:
    """Zero-overhead backend: every hook is a no-op."""

    name = "null"

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass

    def region_enter(self, name: str) -> None:
        pass

    def region_exit(self, name: str, sync: Any = None) -> None:
        pass

    def observe_step(self, outputs: Any = None, **aux: Any) -> None:
        pass

    def mark_device(self) -> None:
        pass

    def attach_static(self, region: str, profile: Any) -> None:
        pass

    def finalize(self) -> RunRecord | None:
        return None


class TracerCollector:
    """The Score-P/Extrae baseline: full event streams + post-processing
    (core.tracer). Same RunRecord out: the cross-tool agreement contract."""

    name = "tracer"

    # monitor-only observation kwargs the tracer's event schema has no
    # representation for (post_process only understands array-valued aux)
    _DROP_AUX = ("pod_size",)

    def __init__(self, config: SessionConfig, resources: ResourceConfig) -> None:
        self._config = config
        self._resources = resources
        self._recorder = None
        self._ever_started = False
        self._pre_start_static: dict[str, Any] = {}
        self.trace_dir = config.trace_dir

    def start(self) -> None:
        from repro_torch.core.tracer import EventTracer

        if self._recorder is not None:
            raise RuntimeError("tracer session already started")
        self._ever_started = True
        if not self.trace_dir:
            self.trace_dir = tempfile.mkdtemp(prefix="talp_trace_")
        self._recorder = EventTracer(
            self.trace_dir,
            self._resources,
            app_name=self._config.app_name,
            clock=self._config.clock,
            hardware=self._config.hardware,
        )
        for region, profile in self._pre_start_static.items():
            self._recorder.attach_static(region, profile)
        self._pre_start_static.clear()

    def stop(self) -> None:
        if self._recorder is not None:
            self._recorder.close()
            self._recorder = None

    def region_enter(self, name: str) -> None:
        if self._recorder is None:
            self.start()  # parity with the monitor's region auto-start
        self._recorder.region_enter(name)

    def region_exit(self, name: str, sync: Any = None) -> None:
        if self._recorder is not None:
            self._recorder.region_exit(name)

    def observe_step(self, outputs: Any = None, **aux: Any) -> None:
        if self._recorder is None:
            return  # outside a started session: silent, like the monitor
        kept = {
            k: v for k, v in aux.items()
            if v is not None and k not in self._DROP_AUX
        }
        self._recorder.record_step(outputs, **kept)

    def mark_device(self) -> None:
        pass  # device-time marks are reconstructed from the event timeline

    def attach_static(self, region: str, profile: Any) -> None:
        if self._recorder is None:  # profiles attached before start()
            self._pre_start_static[region] = profile
        else:
            self._recorder.attach_static(region, profile)

    def finalize(self) -> RunRecord:
        from repro_torch.core import factors as _factors
        from repro_torch.core.tracer import post_process

        if not self._ever_started:
            self.start()  # finalize without start: emit an empty valid trace
        self.stop()
        run = post_process(self.trace_dir)
        # post_process knows nothing of session-level knobs; re-derive the
        # factors under the session's hardware/overlap model so both
        # backends answer through one contract
        run.hardware = self._config.hardware
        for reg in run.regions.values():
            reg.pop = _factors.compute_pop(
                reg, run.resources, self._config.hardware,
                overlap_fraction=self._config.overlap_fraction,
            )
        return run


def make_collector(backend: str, config: SessionConfig,
                   resources: ResourceConfig) -> Collector:
    if backend == "monitor":
        from repro_torch.core.monitor import MonitorConfig, RegionMonitor

        return RegionMonitor(
            MonitorConfig(
                app_name=config.app_name,
                hardware=config.hardware,
                sync_regions=config.sync_regions,
                lb_sample_every=config.lb_sample_every,
                overlap_fraction=config.overlap_fraction,
                top_computations=config.top_computations,
                clock=config.clock,
            ),
            resources,
        )
    if backend == "tracer":
        return TracerCollector(config, resources)
    if backend == "null":
        return NullCollector()
    raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")


class _NullRegion:
    """Shared no-op handle: zero allocation per disabled region visit."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return fn


_NULL_REGION = _NullRegion()


class _Region:
    __slots__ = ("_session", "name", "sync")

    def __init__(self, session: "PerfSession", name: str, sync: Any = None):
        self._session = session
        self.name = name
        self.sync = sync

    def __enter__(self) -> "PerfSession":
        ses = self._session
        if not ses._started:
            ses.start()
        ses._collector.region_enter(self.name)
        return ses

    def __exit__(self, *exc) -> bool:
        self._session._collector.region_exit(self.name, self.sync)
        return False

    def __call__(self, fn: Callable) -> Callable:
        ses, name, sync = self._session, self.name, self.sync

        @functools.wraps(fn)
        def wrapped(*args, **kw):
            with _Region(ses, name, sync):
                return fn(*args, **kw)

        return wrapped


def _default_observe(out: Any) -> dict[str, Any]:
    """Pull the monitor observables out of a step result: a metrics dict, or
    a ``(state, metrics)``-style tuple whose last element is the dict."""
    metrics = None
    if isinstance(out, dict):
        metrics = out
    elif isinstance(out, (tuple, list)) and out and isinstance(out[-1], dict):
        metrics = out[-1]
    if metrics is None:
        return {"outputs": out}
    return {
        "outputs": metrics,
        "tokens_per_shard": metrics.get("tokens_per_shard"),
        "expert_load": metrics.get("expert_load"),
    }


class PerfSession:
    """One run's instrumentation handle: the only object user code needs.

    >>> session = PerfSession(SessionConfig(app_name="train", backend="monitor"))
    >>> step = session.wrap_step(train_step, region="train_step", derive=True)
    >>> with session:
    ...     for batch in batches:
    ...         state, metrics = step(state, batch)
    >>> session.finalize("talp/mycase/history")

    With the default ``backend="null"`` every hook is free, and the same
    program gains full monitoring from ``TALP_ENABLE=1`` alone.
    """

    def __init__(self, config: SessionConfig | None = None,
                 resources: ResourceConfig | None = None,
                 metadata: dict[str, Any] | None = None) -> None:
        self.config = config or SessionConfig()
        backend = self.config.backend
        if self.config.respect_env:
            override = env_backend(default=backend if backend != "null" else None)
            if override is not None:
                backend = override
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
        self.backend = backend
        self.resources = resources or ResourceConfig()
        self.metadata = dict(metadata or {})
        self._collector: Collector = make_collector(backend, self.config, self.resources)
        self._started = False
        self._stopped = False
        self.last_record_path: str | None = None

    # -- lifecycle ------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self.backend != "null"

    @property
    def collector(self) -> Collector:
        return self._collector

    def start(self) -> "PerfSession":
        if not self._started:
            self._started = True
            self._collector.start()
        return self

    def stop(self) -> None:
        if self._started and not self._stopped:
            self._stopped = True
            self._collector.stop()

    def __enter__(self) -> "PerfSession":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- regions --------------------------------------------------------

    def region(self, name: str, sync: Any = None):
        """A handle usable as context manager *and* decorator."""
        if not self.enabled:
            return _NULL_REGION
        return _Region(self, name, sync)

    # -- per-step hooks ---------------------------------------------------

    def observe_step(self, outputs: Any = None, **aux: Any) -> None:
        if self.enabled:
            self._collector.observe_step(outputs, **aux)

    def mark_device(self) -> None:
        if self.enabled:
            self._collector.mark_device()

    def attach_static(self, region: str, profile: Any) -> None:
        if self.enabled:
            self._collector.attach_static(region, profile)

    # -- the integration one-liner --------------------------------------

    def wrap_step(self, fn: Callable, region: str = "step", *, profile: Any = None,
                  derive: bool = False, num_devices: int = 1,
                  model_flops: float = 0.0, model_bytes: float = 0.0,
                  observe: Callable[[Any], dict[str, Any]] | None = None) -> Callable:
        """Instrument a step function in one call.

        Attaches ``profile`` to ``region``, or with ``derive=True`` counts
        the first call (``StepProfile.count``: operator FLOPs and bytes plus
        what the kernels report) and attaches that. PyTorch has no compiled
        program to read, so the count is one real execution: the first
        step, inside its region. Each call enters ``region``, executes, and
        observes the step; ``observe`` maps the step result to
        ``observe_step`` kwargs (an ``"outputs"`` key overrides what is
        waited on).

        With the null backend the original function is returned unchanged.
        """
        if not self.enabled:
            return fn
        from repro_torch.core.profile import StepProfile

        if profile is not None:
            self.attach_static(region, profile)
        state = {"pending": derive and profile is None}
        sync_outputs = self.config.sync_regions
        obs_fn = observe or _default_observe
        handle = _Region(self, region)

        @functools.wraps(fn)
        def wrapped(*args, **kw):
            with handle:
                if state["pending"]:
                    state["pending"] = False
                    out, prof = StepProfile.count(
                        fn, *args, num_devices=num_devices, model_flops=model_flops,
                        model_bytes=model_bytes, **kw)
                    self.attach_static(region, prof)
                else:
                    out = fn(*args, **kw)
                obs = dict(obs_fn(out))
                outputs = obs.pop("outputs", out)
                self.observe_step(outputs if sync_outputs else None, **obs)
            return out

        return wrapped

    # -- finalize: record + git metadata + CI folder layout, in one call -

    def finalize(self, out_dir: str | None = None, *, save: bool = True,
                 git: bool | str = "auto") -> RunRecord | None:
        """Stop collection and build the RunRecord. Injects git metadata
        (commit, branch, commit timestamp) and, when a destination is known,
        writes ``talp_<label>_<ts>.json`` into it (the CI folder layout).
        ``TALP_OUT`` overrides any destination. ``git="auto"`` injects
        exactly when the record is persisted. Returns None for the null
        backend."""
        self.stop()
        run = self._collector.finalize()
        if run is None:
            return None
        for k, v in self.metadata.items():
            run.metadata.setdefault(k, v)
        env_dest = os.environ.get(ENV_OUT) if self.config.respect_env else None
        dest = env_dest or out_dir or self.config.out_dir
        will_save = bool(save and dest)
        if git is True or (git == "auto" and will_save):
            from repro_torch.core.folder import git_metadata

            for k, v in git_metadata().items():
                run.metadata.setdefault(k, v)
        if will_save:
            fname = f"talp_{run.resources.label}_{run.timestamp.replace(':', '')[:17]}.json"
            path = os.path.join(dest, fname)
            run.save(path)
            self.last_record_path = path
        return run
