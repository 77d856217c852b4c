"""Open-loop traffic harness for the serving stack (``repro.serve.traffic``).

A workload is a pure function of its :class:`TrafficConfig`: every
arrival time, prompt, output budget, priority and scheduled cancellation
comes out of one seeded ``np.random.default_rng``, so two runs with the
same config replay bit for bit, in either package (the draws are the JAX
package's, call for call).

Two arrival processes, both in the scheduler-tick domain (open loop: the
workload does not slow down when the server falls behind):

  ``poisson``  arrivals per tick ~ Poisson(rate)
  ``burst``    a Markov-modulated Poisson process: a two-state chain
               (calm/burst) that flips each tick with probability
               1/mean_len, drawing at ``rate`` calm and ``rate *
               burst_mult`` bursting

:func:`replay` drives a ``BatchScheduler`` through a workload (submits at
arrival ticks, fires scheduled cancellations, runs to quiescence) inside
the session's ``traffic`` region, and reports goodput, TTFT percentiles,
queue depth, the scheduler's pressure counters, the requests shed and the
recovery counters under the JAX package's keys. ``replay(...,
faults=injector)`` composes a seeded fault schedule with the seeded
workload (chaos mode).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Everything a workload is; hash the fields, hash the traffic."""

    n_requests: int = 16
    seed: int = 0
    # arrival process (tick domain)
    arrival: str = "poisson"          # "poisson" | "burst"
    rate: float = 0.5                 # mean arrivals per tick (calm state)
    burst_mult: float = 6.0           # burst-state rate = rate * burst_mult
    burst_mean_len: float = 4.0       # mean ticks a burst lasts
    calm_mean_len: float = 12.0       # mean ticks between bursts
    # a short/long mixture of prompt and output lengths
    prompt_short: tuple[int, int] = (4, 16)
    prompt_long: tuple[int, int] = (24, 48)
    long_frac: float = 0.25           # probability a prompt is long
    max_new_short: tuple[int, int] = (4, 12)
    max_new_long: tuple[int, int] = (16, 32)
    long_out_frac: float = 0.25
    # priority classes drawn by weight (higher = more important)
    priorities: tuple[int, ...] = (0, 1, 2)
    priority_weights: tuple[float, ...] = (0.7, 0.2, 0.1)
    # this fraction of requests cancel ``cancel_delay`` ticks after arrival
    cancel_frac: float = 0.0
    cancel_delay: tuple[int, int] = (2, 10)
    vocab_lo: int = 4
    vocab_hi: int = 256

    def __post_init__(self):
        if self.arrival not in ("poisson", "burst"):
            raise ValueError(
                f"arrival must be poisson|burst, got {self.arrival!r}"
            )
        if len(self.priorities) != len(self.priority_weights):
            raise ValueError("priorities and priority_weights differ in length")


@dataclasses.dataclass(frozen=True)
class TrafficRequest:
    """One generated request: where it arrives, what it asks, how it ends."""

    request_id: int
    arrival_tick: int
    prompt: tuple[int, ...]
    max_new: int
    priority: int
    cancel_tick: int | None = None    # absolute tick; None = runs to budget


def _uniform_int(rng, lo_hi) -> int:
    lo, hi = lo_hi
    return int(rng.integers(lo, hi + 1))


def generate_workload(tcfg: TrafficConfig) -> list[TrafficRequest]:
    """The workload as a pure function of its config: ticks advance one at
    a time, each drawing its arrival count from the current state's
    Poisson rate until ``n_requests`` have been emitted."""
    rng = np.random.default_rng(tcfg.seed)
    out: list[TrafficRequest] = []
    tick = 0
    bursting = False
    while len(out) < tcfg.n_requests:
        if tcfg.arrival == "burst":
            mean = tcfg.burst_mean_len if bursting else tcfg.calm_mean_len
            if rng.random() < 1.0 / max(mean, 1.0):
                bursting = not bursting
            lam = tcfg.rate * (tcfg.burst_mult if bursting else 1.0)
        else:
            lam = tcfg.rate
        for _ in range(int(rng.poisson(lam))):
            if len(out) >= tcfg.n_requests:
                break
            is_long = rng.random() < tcfg.long_frac
            plen = _uniform_int(
                rng, tcfg.prompt_long if is_long else tcfg.prompt_short
            )
            prompt = tuple(
                int(t) for t in rng.integers(tcfg.vocab_lo, tcfg.vocab_hi,
                                             size=plen)
            )
            max_new = _uniform_int(
                rng,
                tcfg.max_new_long if rng.random() < tcfg.long_out_frac
                else tcfg.max_new_short,
            )
            prio = int(rng.choice(tcfg.priorities,
                                  p=np.asarray(tcfg.priority_weights)
                                  / sum(tcfg.priority_weights)))
            cancel = None
            if rng.random() < tcfg.cancel_frac:
                cancel = tick + _uniform_int(rng, tcfg.cancel_delay)
            out.append(TrafficRequest(
                request_id=len(out), arrival_tick=tick, prompt=prompt,
                max_new=max_new, priority=prio, cancel_tick=cancel,
            ))
        tick += 1
    return out


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile on a sorted list: the value reported is one
    that was measured."""
    if not sorted_vals:
        return 0.0
    k = max(0, min(len(sorted_vals) - 1,
                   int(np.ceil(q / 100.0 * len(sorted_vals))) - 1))
    return sorted_vals[k]


def replay(sched, workload: list[TrafficRequest], *,
           max_ticks: int | None = None, faults=None) -> dict:
    """Drive ``sched`` through ``workload`` and measure it.

    Open loop: request ``r`` is submitted at the top of tick
    ``r.arrival_tick`` however far behind the server is, and scheduled
    cancellations fire at their tick whether or not the stream attached.
    After the last arrival the scheduler runs to quiescence (``drain``).
    Goodput counts only tokens of requests that completed.

    ``faults``: a ``serve.faults.FaultInjector`` attached to the scheduler
    for the replay; the same (TrafficConfig, FaultConfig) pair replays the
    same streams, and the budget grows by the retries' recompute and the
    spikes' stalls.

    On a mesh of ranks every rank replays the same seeded trace through its
    scheduler, whose decisions are the same on each, so the counts agree;
    the clock readings (TTFT, goodput) are each rank's own, and the serve
    launcher reports rank 0's."""
    if faults is not None:
        sched.faults = faults
    workload = sorted(workload, key=lambda r: (r.arrival_tick, r.request_id))
    cancels = sorted(
        (r.cancel_tick, r.request_id) for r in workload if r.cancel_tick is not None
    )
    horizon = max((r.arrival_tick for r in workload), default=0)
    budget = max_ticks if max_ticks is not None else (
        horizon + 64 + 4 * sum(r.max_new + len(r.prompt) for r in workload)
    )
    if faults is not None and max_ticks is None:
        budget += sum(
            (r.max_new + len(r.prompt)) * sched.scfg.max_retries for r in workload
        ) + faults.fcfg.spike_ticks * (faults.fcfg.n_alloc_spike + 1)
    submit_t: dict[int, float] = {}
    ttft: dict[int, float] = {}
    depths: list[int] = []
    next_arrival = 0
    next_cancel = 0
    tick = 0
    t0 = time.perf_counter()
    # one "traffic" visit spans the whole replay, beside the scheduler's
    # decode, prefill and preempt regions
    with sched.session.region("traffic"):
        while tick < budget:
            while (next_arrival < len(workload)
                   and workload[next_arrival].arrival_tick <= tick):
                r = workload[next_arrival]
                sched.submit(list(r.prompt), request_id=r.request_id,
                             max_new=r.max_new, priority=r.priority)
                submit_t[r.request_id] = time.perf_counter()
                next_arrival += 1
            while (next_cancel < len(cancels)
                   and cancels[next_cancel][0] <= tick):
                sched.cancel(cancels[next_cancel][1])
                next_cancel += 1
            done_arriving = next_arrival >= len(workload)
            live = (sched.queue or sched._parked or sched._prefills
                    or any(s is not None for s in sched.active))
            if done_arriving and next_cancel >= len(cancels) and not live:
                break
            sched.step()
            now = time.perf_counter()
            depths.append(len(sched.queue) + len(sched._parked))
            for req in sched.active:
                if req is not None and req["id"] not in ttft:
                    # the request just cleared prefill: its first token is
                    # in flight; TTFT is wall clock from its submit
                    ttft[req["id"]] = now - submit_t[req["id"]]
            tick += 1
        sched.drain()
    wall = time.perf_counter() - t0

    good_tokens = sum(len(r["generated"]) for r in sched.completed)
    cancelled_tokens = sum(len(r["generated"]) for r in sched.cancelled)
    lat = sorted(ttft[r["id"]] for r in sched.completed if r["id"] in ttft)
    stats = sched.kv_cache_stats()
    press = stats["pressure"]
    return {
        "requests": len(workload),
        "completed": len(sched.completed),
        "cancelled": len(sched.cancelled),
        "failed": len(sched.failed),
        "shed": len(sched.shed),
        "ticks": tick,
        "wall_s": round(wall, 4),
        "good_tokens": good_tokens,
        "cancelled_tokens": cancelled_tokens,
        "goodput_tokens_per_sec": round(good_tokens / max(wall, 1e-9), 2),
        "ttft_p50_s": round(_percentile(lat, 50), 4),
        "ttft_p95_s": round(_percentile(lat, 95), 4),
        "ttft_p99_s": round(_percentile(lat, 99), 4),
        "ttft_max_s": round(lat[-1] if lat else 0.0, 4),
        "queue_depth_peak": max(depths, default=0),
        "queue_depth_mean": round(sum(depths) / max(len(depths), 1), 2),
        "preemptions": press["preemptions"],
        "resumes": press["resumes"],
        "cancellations": press["cancellations"],
        "evictions_for_preempt": press["evictions_for_preempt"],
        "peak_queue_depth": press["peak_queue_depth"],
        "recovery": stats["recovery"],
        "kv": stats,
        "sched_stats": dict(sched.stats),
        "generated": {str(r["id"]): r["generated"] for r in sched.completed},
    }
