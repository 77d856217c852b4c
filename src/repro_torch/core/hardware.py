"""Hardware target models for the port: the NVIDIA H100 SXM.

``ChipSpec`` keeps the JAX package's field names (``repro.core.hardware``)
so records and factors read the same on both sides; on Hopper the
TPU-named fields hold:

  peak_flops_bf16  dense bf16 tensor-core FLOP/s
  hbm_bandwidth    HBM3 bytes/s
  hbm_bytes        device memory
  ici_bandwidth    NVLink 4: bytes/s per link, one direction
  ici_links        NVLink links per GPU
  dcn_bandwidth    the node's network card for traffic between hosts
                   (400 Gb/s per GPU)
  clock_ghz        boost clock (the GPU does change its clock under load)
  vmem_bytes       shared memory per SM (the fast on-chip scratch)

Numbers are NVIDIA's H100 SXM data sheet and Hopper white paper.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops_bf16: float     # FLOP/s per chip
    hbm_bandwidth: float       # bytes/s per chip
    hbm_bytes: float           # HBM capacity per chip
    ici_bandwidth: float       # bytes/s per link (one direction)
    ici_links: int             # links per chip
    dcn_bandwidth: float       # bytes/s per chip for cross-host traffic
    clock_ghz: float           # nominal clock
    vmem_bytes: float          # on-chip scratch per core (SM)


H100_SXM = ChipSpec(
    name="h100_sxm",
    peak_flops_bf16=989e12,
    hbm_bandwidth=3.35e12,
    hbm_bytes=80e9,
    ici_bandwidth=25e9,
    ici_links=18,
    dcn_bandwidth=50e9,
    clock_ghz=1.98,
    vmem_bytes=228 * 1024,
)

TARGETS = {s.name: s for s in (H100_SXM,)}
DEFAULT_TARGET = H100_SXM


def get_target(name: str | None) -> ChipSpec:
    if name is None:
        return DEFAULT_TARGET
    try:
        return TARGETS[name]
    except KeyError:
        raise KeyError(f"unknown hardware target {name!r}; known: {sorted(TARGETS)}")
