"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper (``rmsnorm.ops``, ``paged_attention.ops``) takes its plain
version for a CPU tensor and launches its kernel for a CUDA tensor, or
raises. ``LAUNCHES`` counts kernel launches per wrapper, incremented at
the launch and nowhere else, so a run can show that its main path went
through the kernels.
"""

from __future__ import annotations

LAUNCHES = {"rmsnorm": 0, "paged_attention": 0, "paged_prefill_attention": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)
