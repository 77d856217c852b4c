"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper (``rmsnorm.ops``, ``flash_attention.ops``,
``paged_attention.ops``) takes its plain version for a CPU tensor and
launches its kernel for a CUDA tensor, or raises. ``LAUNCHES`` counts
kernel launches per wrapper, incremented at the launch and nowhere else,
so a run can show that its main path went through the kernels (a
backward counts once per call, however many kernels it launches).

A kernel launched through ``ctypes`` is invisible to PyTorch's
operator-level counters, so each wrapper also reports the FLOPs and bytes
of its launch, worked out from its shapes, to every callable in
``COST_SINKS`` (``core.profile`` installs one while it counts a step).
"""

from __future__ import annotations

LAUNCHES = {
    "rmsnorm": 0, "rmsnorm_backward": 0,
    "flash_attention": 0, "flash_attention_backward": 0,
    "paged_attention": 0, "paged_prefill_attention": 0,
}

# callables (name, flops, bytes) -> None; empty outside a counting pass
COST_SINKS: list = []


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def record_cost(name: str, cost_fn) -> None:
    """Report one launch's cost; ``cost_fn() -> (flops, bytes)`` runs only
    while a sink listens."""
    if COST_SINKS:
        flops, nbytes = cost_fn()
        for sink in COST_SINKS:
            sink(name, float(flops), float(nbytes))
