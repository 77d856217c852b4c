"""Training loop with first-class TALP monitoring (``repro.train.loop``).

The loop owns a ``PerfSession`` with an ``initialize`` region (state
set-up) and a ``train_step`` region (the paper's ``timestep``) attached by
``session.wrap_step``, which counts the step's static profile from its
first execution and streams the per-step observables (tokens per shard,
host heartbeat) into the collector. ``finalize_run(out_dir)`` writes the
JSON artifact for TALP-Pages in one call.

``metrics_history`` holds each step's loss and its host-clock seconds
(batch made to loss on the host). Kept from the JAX loop: the straggler hook (``on_straggler`` when the host
load balance drops below ``straggler_threshold``) and ``fail_at_step``
(crash injection). Checkpointing waits for ROADMAP.md Queue 1, item 6:
``ckpt_dir`` raises. The loop starts from the port's seeded initializer,
or from ``state`` when given (a state converted from the JAX package with
``repro_torch.convert.from_jax_train_state``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.records import ResourceConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models.flops import train_step_model_flops
from repro_torch.session import PerfSession, SessionConfig
from repro_torch.train.train import TrainConfig, TrainState, init_state, make_train_step


@dataclasses.dataclass
class LoopConfig:
    steps: int = 50
    ckpt_every: int = 0              # checkpoints: not ported yet (raises)
    ckpt_dir: str = ""
    seed: int = 0
    straggler_threshold: float = 0.8
    monitor_app_name: str = "train"
    monitor_backend: str = "monitor"  # PerfSession backend (env can override)
    lb_sample_every: int = 1
    fail_at_step: int | None = None  # crash injection for restart tests
    host_times_fn: Callable[[int], Any] | None = None  # heartbeat source


class InjectedFailure(RuntimeError):
    pass


_UNSAMPLED = object()  # heartbeat not yet read for the current step


class TrainLoop:
    def __init__(self, cfg, tcfg: TrainConfig, data: SyntheticLM, loop_cfg: LoopConfig,
                 device=None, on_straggler: Callable[[int, float], None] | None = None,
                 state: TrainState | None = None):
        if loop_cfg.ckpt_dir or loop_cfg.ckpt_every:
            raise NotImplementedError(
                "checkpointing is not ported yet (ROADMAP.md Queue 1, item 6): leave "
                "ckpt_dir and ckpt_every unset"
            )
        self.cfg, self.tcfg = cfg, tcfg
        self.device = state.model.device if state is not None else resolve_device(device)
        self.data = data
        self.loop = loop_cfg
        self.on_straggler = on_straggler
        self.straggler_events: list[tuple[int, float]] = []
        self._state = state
        # the step runs on one device: one host, one device, a 1 x 1 mesh
        self.resources = ResourceConfig(num_hosts=1, devices_per_host=1,
                                        mesh={"data": 1, "model": 1}, num_pods=1)
        self.session = PerfSession(
            SessionConfig(
                app_name=loop_cfg.monitor_app_name,
                backend=loop_cfg.monitor_backend,
                lb_sample_every=loop_cfg.lb_sample_every,
            ),
            self.resources,
        )
        self.metrics_history: list[dict] = []
        self._cur_step = 0
        self._host_times: Any = _UNSAMPLED

    # ------------------------------------------------------------------

    def run(self) -> "TrainLoop":
        ses = self.session
        ses.start()
        with ses.region("initialize"):
            state, start_step, step_fn = self._initialize()
        try:
            for step in range(start_step, self.loop.steps):
                if self.loop.fail_at_step is not None and step == self.loop.fail_at_step:
                    raise InjectedFailure(f"injected failure at step {step}")
                t0 = time.perf_counter()
                batch = self.data.batch_at(step)
                self._cur_step = step
                self._host_times = _UNSAMPLED
                state, metrics = step_fn(state, batch)
                # the heartbeat is read post-step by _observe (inside the
                # train_step region); sample it here only when a null
                # backend skipped observation
                if self._host_times is _UNSAMPLED:
                    self._host_times = self._sample_host_times()
                self._check_straggler(step, self._host_times)
                loss = float(metrics["loss"])  # waits for the step's device work
                self.metrics_history.append(
                    {"step": step, "loss": loss, "seconds": time.perf_counter() - t0})
        finally:
            ses.stop()
        self.final_state = state
        return self

    # ------------------------------------------------------------------

    def _initialize(self):
        state = self._state
        if state is None:
            state = init_state(self.cfg, self.tcfg, seed=self.loop.seed, device=self.device)
        example = self.data.batch_at(0)
        step_fn = self.session.wrap_step(
            make_train_step(self.cfg, self.tcfg),
            region="train_step",
            derive=True,
            num_devices=self.resources.total_devices,
            model_flops=train_step_model_flops(self.cfg, tuple(example["labels"].shape)),
            observe=self._observe,
        )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return state, state.step, step_fn

    def _sample_host_times(self):
        """Read the per-host heartbeat for the step that just executed."""
        return self.loop.host_times_fn(self._cur_step) if self.loop.host_times_fn else None

    def _observe(self, out) -> dict:
        """Map one step result to the monitor observables (wrap_step hook;
        runs inside the train_step region, after the step executed)."""
        _state, metrics = out
        host_times = self._host_times = self._sample_host_times()
        return {
            "outputs": metrics,
            "tokens_per_shard": metrics.get("tokens_per_shard"),
            "expert_load": metrics.get("expert_load"),
            "host_times": host_times,
            "pod_size": None,
        }

    def _check_straggler(self, step: int, host_times) -> None:
        if host_times is None:
            return
        arr = np.asarray(host_times, dtype=np.float64).reshape(-1)
        if arr.size < 2 or arr.max() <= 0:
            return
        lb = float(arr.mean() / arr.max())
        if lb < self.loop.straggler_threshold:
            self.straggler_events.append((step, lb))
            if self.on_straggler:
                self.on_straggler(step, lb)

    def finalize_run(self, out_dir: str | None = None):
        """Finalize the session's RunRecord and, when a destination resolves
        (``out_dir``, ``TALP_OUT``, or the session config), inject git
        metadata and save into the CI folder layout."""
        return self.session.finalize(out_dir)
