"""Seeded fault injection for the serving stack (``repro.serve.faults``).

A fault schedule is a pure function of its :class:`FaultConfig`, as a
traffic workload is of its ``TrafficConfig``: every injection tick, fault
kind and target pick comes out of one seeded ``np.random.default_rng``
(the JAX package's draws, call for call), so two chaos runs with the same
config inject the same faults, in either package, and recovery can be
held to a fault-free run token for token.

Four fault kinds, which ``BatchScheduler`` applies through the paths a
real fault would take (``sched.faults``):

  ``nan``           poison one decode (or verify) dispatch's logits with NaN
                    for a chosen slot; the finiteness sentinel that rides
                    the token readback catches it
  ``page_corrupt``  overwrite one KV pool page a live request reads
                    (``corrupt_mode="nan"``: caught by the sentinel on the
                    next read; ``"bitflip"``: finite garbage in a page only
                    the prefix trie pins, which only the per-page checksums
                    catch)
  ``alloc_spike``   hold free pool pages for a few ticks (a co-tenant's
                    burst): the scheduler degrades through its normal
                    park/preempt path and recovers when the spike releases
  ``hang``          delay one decode dispatch past the watchdog deadline:
                    the watchdog trips and the victim retries

The injector hands the scheduler due events and takes back, via
``defer``, those without a target yet, so every scheduled fault lands
while work is live.

The page edits work in place on the port's pools, ``(R, P + 1, page, Hkv,
hd)`` per layer: pages ``0..P-1`` are the allocator's, page ``P`` the spare
that takes dropped writes, which no edit or fingerprint touches.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Everything a fault schedule is; hash the fields, hash the chaos."""

    seed: int = 0
    horizon_ticks: int = 48       # injection ticks draw from [1, horizon]
    n_nan: int = 1                # poisoned decode dispatches
    n_page_corrupt: int = 1       # corrupted KV pool pages
    n_alloc_spike: int = 1        # transient allocator-exhaustion spikes
    n_hang: int = 1               # delayed (hung) decode dispatches
    corrupt_mode: str = "nan"     # "nan" (sentinel) | "bitflip" (checksum)
    spike_pages: int = 2          # pages a spike grabs (clamped to free)
    spike_ticks: int = 4          # ticks a spike holds them
    hang_s: float = 0.05          # injected dispatch delay (seconds)

    def __post_init__(self):
        if self.corrupt_mode not in ("nan", "bitflip"):
            raise ValueError(
                f"corrupt_mode must be nan|bitflip, got {self.corrupt_mode!r}"
            )
        if self.horizon_ticks < 1:
            raise ValueError("horizon_ticks must be >= 1")


@dataclasses.dataclass
class FaultEvent:
    """One scheduled injection. ``tick`` advances when the event is
    deferred; ``pick`` (and ``pick2``, a page) choose the victim among the
    applicable candidates, modulo their count, so a rerun hits the same
    targets. ``request_id`` restricts the candidates to one request."""

    kind: str                 # "nan" | "page_corrupt" | "alloc_spike" | "hang"
    tick: int
    pick: int = 0
    pick2: int = 0
    request_id: object = None


def generate_faults(fcfg: FaultConfig) -> list[FaultEvent]:
    """The fault schedule as a pure function of its config."""
    rng = np.random.default_rng(fcfg.seed)
    events: list[FaultEvent] = []
    for kind, n in (("nan", fcfg.n_nan),
                    ("page_corrupt", fcfg.n_page_corrupt),
                    ("alloc_spike", fcfg.n_alloc_spike),
                    ("hang", fcfg.n_hang)):
        for _ in range(max(int(n), 0)):
            events.append(FaultEvent(
                kind=kind,
                tick=int(rng.integers(1, fcfg.horizon_ticks + 1)),
                pick=int(rng.integers(0, 1 << 30)),
                pick2=int(rng.integers(0, 1 << 30)),
            ))
    events.sort(key=lambda e: (e.tick, e.kind, e.pick))
    return events


class FaultInjector:
    """Drives a fault schedule into a ``BatchScheduler`` tick by tick:
    ``due(tick)`` pops what is due, ``defer`` hands an event without a
    target back for the next tick, ``record`` counts what landed
    (``counters``, surfaced in ``kv_cache_stats()["recovery"]``)."""

    def __init__(self, fcfg: FaultConfig | None = None,
                 events: list[FaultEvent] | None = None):
        self.fcfg = fcfg if fcfg is not None else FaultConfig()
        self.pending: list[FaultEvent] = (
            list(events) if events is not None else generate_faults(self.fcfg)
        )
        self.counters = {
            "nan_injected": 0, "pages_corrupted": 0, "alloc_spikes": 0,
            "hangs": 0, "deferrals": 0,
        }

    def due(self, tick: int) -> list[FaultEvent]:
        """Pop every event scheduled at or before ``tick``."""
        ready = [e for e in self.pending if e.tick <= tick]
        if ready:
            self.pending = [e for e in self.pending if e.tick > tick]
        return ready

    def defer(self, event: FaultEvent, tick: int) -> None:
        """No applicable target this tick: the event is due again next tick."""
        event.tick = tick + 1
        self.pending.append(event)
        self.counters["deferrals"] += 1

    @property
    def exhausted(self) -> bool:
        return not self.pending

    def record(self, kind: str) -> None:
        key = {"nan": "nan_injected", "page_corrupt": "pages_corrupted",
               "alloc_spike": "alloc_spikes", "hang": "hangs"}[kind]
        self.counters[key] += 1


# ---------------------------------------------------------------------------
# page edits and fingerprints, on the device
# ---------------------------------------------------------------------------

_INT = {2: torch.int16, 4: torch.int32}
_FLIP = {2: 0x5A5A, 4: 0x5A5A5A5A}


def paged_pools(caches, path: str = ""):
    """The paged pool tensors of a cache tree: the leaves whose key path
    holds "pages", as the JAX package picks them; other leaves (a dense
    cache) are not pools."""
    if isinstance(caches, dict):
        for k, v in caches.items():
            yield from paged_pools(v, f"{path}/{k}")
    elif isinstance(caches, torch.Tensor) and "pages" in path:
        yield caches


def _page_rows(pool: torch.Tensor, page: int) -> torch.Tensor:
    if not 0 <= page < pool.shape[1] - 1:
        raise IndexError(f"page {page} outside the pool's {pool.shape[1] - 1} pages")
    return pool[:, page]


def page_edit(caches, pages, mode: str) -> None:
    """Rewrite physical page(s) ``pages`` (an int or a list) of every paged
    pool, in place: ``nan`` fills them with NaN, ``zero`` with 0 (the
    scrub), ``bitflip`` XORs every element's bits with 0x5A5A (bf16) or
    0x5A5A5A5A (fp32), which leaves most values finite. Queued on the
    pools' stream: no host sync. On a mesh of ranks each rank edits its
    block of the pools (its KV heads, or the whole pool where they do not
    split), so the ranks' edits together are the whole page's."""
    if mode not in ("nan", "zero", "bitflip"):
        raise ValueError(f"page edit mode must be nan|zero|bitflip, got {mode!r}")
    pages = [pages] if isinstance(pages, int) else [int(p) for p in pages]
    idx = None
    for pool in paged_pools(caches):
        rows = [_page_rows(pool, p) for p in pages]
        if mode == "bitflip":
            for r in rows:
                r.view(_INT[pool.element_size()]).bitwise_xor_(_FLIP[pool.element_size()])
            continue
        if idx is None:  # one upload for every pool
            idx = torch.as_tensor(pages, dtype=torch.long).to(pool.device, non_blocking=True)
        pool.index_fill_(1, idx, float("nan") if mode == "nan" else 0.0)


def page_fingerprint(caches, page: int, split=None) -> int:
    """The JAX package's uint32 fingerprint of physical ``page``: its bits
    as unsigned integers, summed over every paged pool with wraparound.
    CUDA has no unsigned 32-bit sum, so each element's bits are widened to
    int64, masked to their width, summed, and the total masked to 32 bits.
    With ``split`` (``distributed.shard.CacheSplit`` whose KV heads split
    over ``"model"``) the pools are this rank's blocks: their int64 partial
    is summed over the ``"model"`` ranks before the mask, so every rank
    gets JAX's integer. One host sync (the result is a Python int)."""
    acc = None
    for pool in paged_pools(caches):
        es = pool.element_size()
        bits = _page_rows(pool, page).view(_INT[es]).to(torch.int64) & ((1 << (8 * es)) - 1)
        s = bits.sum()
        acc = s if acc is None else acc + s
    if acc is None:
        return 0
    if split is not None:
        acc = split.all_reduce(acc.reshape(1))
    return int(acc.sum()) & 0xFFFFFFFF


__all__ = ["FaultConfig", "FaultEvent", "FaultInjector", "generate_faults",
           "page_edit", "page_fingerprint", "paged_pools"]
