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

``TPU_V5E`` and ``TPU_V5P`` are the JAX package's two targets, copied as
data so that the port's report side renders the JAX package's records
(and records without a ``hardware`` field, which default to ``tpu_v5e``)
under the spec they were written for. Nothing in the port runs on them.
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

# the JAX package's targets (``repro.core.hardware``), as data only
TPU_V5E = ChipSpec(
    name="tpu_v5e",
    peak_flops_bf16=197e12,
    hbm_bandwidth=819e9,
    hbm_bytes=16 * 1024**3,
    ici_bandwidth=50e9,
    ici_links=4,
    dcn_bandwidth=6.25e9,
    clock_ghz=0.94,
    vmem_bytes=128 * 1024**2,
)

TPU_V5P = ChipSpec(
    name="tpu_v5p",
    peak_flops_bf16=459e12,
    hbm_bandwidth=2765e9,
    hbm_bytes=95 * 1024**3,
    ici_bandwidth=100e9,
    ici_links=6,
    dcn_bandwidth=6.25e9,
    clock_ghz=1.75,
    vmem_bytes=128 * 1024**2,
)

TARGETS = {s.name: s for s in (H100_SXM, TPU_V5E, TPU_V5P)}
DEFAULT_TARGET = H100_SXM


def get_target(name: str | None) -> ChipSpec:
    if name is None:
        return DEFAULT_TARGET
    try:
        return TARGETS[name]
    except KeyError:
        raise KeyError(f"unknown hardware target {name!r}; known: {sorted(TARGETS)}")
