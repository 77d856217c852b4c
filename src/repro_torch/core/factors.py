"""POP fundamental performance factors: the port's copy of
``repro.core.factors``, the same hierarchy and identities. The "MXU
utilization" row reads, on the H100, as achieved FLOP/s over the dense
bf16 tensor-core peak, and the ICI/DCN terms as NVLink and the NIC (see
``core.hardware``).

The paper computes the POP efficiency hierarchy [Wagner et al., 17] from
TALP's on-the-fly MPI/OpenMP measurements + PAPI counters. On TPU/XLA none of
those interfaces exist; DESIGN.md §3 defines the mapping implemented here:

  Global efficiency
  ├── Parallel efficiency                         (absolute, per run)
  │   ├── Dispatch efficiency      [measured]  device-busy wall fraction —
  │   │                                        the OpenMP-serialization analogue
  │   │                                        (host stalls, input pipeline)
  │   ├── Communication efficiency [modeled]   exposed collective time from
  │   │   ├── ICI comm efficiency              HLO collective bytes + fabric
  │   │   └── DCN comm efficiency              bandwidth model
  │   └── Load balance             [measured]
  │       ├── Data load balance                non-pad tokens per data shard
  │       ├── Expert load balance              MoE router occupancy
  │       └── Host load balance                per-host step times
  │           ├── In-pod load balance          (ICI domain)
  │           └── Inter-pod load balance       (DCN domain)
  └── Computation scalability                     (relative to reference run)
      ├── FLOP scaling             "instruction scaling": executed HLO FLOPs
      ├── Throughput scaling       "IPC scaling": achieved FLOP/s per device
      └── Frequency scaling        chip clock ratio (≈1 on TPU, kept for
                                   table parity with the paper)

Every factor is an efficiency in [0, 1]-ish (scalability factors may exceed
1, exactly as in the paper's Table 7 where superlinear IPC scaling appears).
Products hold exactly:  parallel = dispatch * comm * lb,
comm = ici * dcn,  lb = data * expert * host,  host = in_pod * inter_pod,
comp_scalability = flop * throughput * frequency,
global = parallel * comp_scalability.
"""

from __future__ import annotations

from typing import Any

from repro_torch.core.hardware import ChipSpec, get_target
from repro_torch.core.records import RegionRecord, ResourceConfig

# Canonical factor keys ------------------------------------------------------

GLOBAL_EFF = "global_efficiency"
PARALLEL_EFF = "parallel_efficiency"
DISPATCH_EFF = "dispatch_efficiency"
COMM_EFF = "communication_efficiency"
ICI_COMM_EFF = "ici_comm_efficiency"
DCN_COMM_EFF = "dcn_comm_efficiency"
LOAD_BALANCE = "load_balance"
DATA_LB = "data_load_balance"
EXPERT_LB = "expert_load_balance"
HOST_LB = "host_load_balance"
IN_POD_LB = "in_pod_load_balance"
INTER_POD_LB = "inter_pod_load_balance"
COMP_SCALABILITY = "computation_scalability"
FLOP_SCALING = "flop_scaling"
THROUGHPUT_SCALING = "throughput_scaling"
FREQUENCY_SCALING = "frequency_scaling"

# informational (non-multiplicative) rows
MXU_UTIL = "mxu_utilization"
FLOP_USEFULNESS = "flop_usefulness"
ACHIEVED_TFLOPS = "achieved_tflops_per_device"
ELAPSED_S = "elapsed_s"

# (name, children) recursive tree; rendering + regression explanation walk it.
FACTOR_TREE: tuple = (
    GLOBAL_EFF,
    [
        (
            PARALLEL_EFF,
            [
                (DISPATCH_EFF, []),
                (COMM_EFF, [(ICI_COMM_EFF, []), (DCN_COMM_EFF, [])]),
                (
                    LOAD_BALANCE,
                    [
                        (DATA_LB, []),
                        (EXPERT_LB, []),
                        (HOST_LB, [(IN_POD_LB, []), (INTER_POD_LB, [])]),
                    ],
                ),
            ],
        ),
        (
            COMP_SCALABILITY,
            [(FLOP_SCALING, []), (THROUGHPUT_SCALING, []), (FREQUENCY_SCALING, [])],
        ),
    ],
)

INFO_ROWS = (MXU_UTIL, FLOP_USEFULNESS, ACHIEVED_TFLOPS, ELAPSED_S)

DISPLAY_NAMES = {
    GLOBAL_EFF: "Global efficiency",
    PARALLEL_EFF: "Parallel efficiency",
    DISPATCH_EFF: "Dispatch efficiency",
    COMM_EFF: "Communication efficiency",
    ICI_COMM_EFF: "ICI communication efficiency",
    DCN_COMM_EFF: "DCN communication efficiency",
    LOAD_BALANCE: "Load balance",
    DATA_LB: "Data load balance",
    EXPERT_LB: "Expert load balance",
    HOST_LB: "Host load balance",
    IN_POD_LB: "In-pod load balance",
    INTER_POD_LB: "Inter-pod load balance",
    COMP_SCALABILITY: "Computation scalability",
    FLOP_SCALING: "FLOP (instruction) scaling",
    THROUGHPUT_SCALING: "Throughput (IPC) scaling",
    FREQUENCY_SCALING: "Frequency scaling",
    MXU_UTIL: "MXU utilization",
    FLOP_USEFULNESS: "FLOP usefulness (model/HLO)",
    ACHIEVED_TFLOPS: "Achieved TFLOP/s/device",
    ELAPSED_S: "Elapsed time [s]",
}


def iter_tree(node=FACTOR_TREE, depth: int = 0):
    """Yield (key, depth) over the factor tree, pre-order."""
    name, children = node
    yield name, depth
    for child in children:
        yield from iter_tree(child, depth + 1)


# ---------------------------------------------------------------------------
# modeled communication times
# ---------------------------------------------------------------------------


def modeled_times(
    region: RegionRecord,
    resources: ResourceConfig,
    spec: ChipSpec,
    overlap_fraction: float = 0.0,
) -> dict[str, float]:
    """Per-device modeled times (seconds, whole region lifetime).

    ``t_useful`` is the roofline of the useful (non-collective) work:
    max(compute, memory). Collective times are scaled by
    ``1 - overlap_fraction`` — the exposed share after compute/comm overlap
    (0.0 = fully serial, the conservative paper-faithful default).
    """
    c = region.counters
    n = max(resources.total_devices, 1)
    t_compute = c.useful_flops / (n * spec.peak_flops_bf16)
    t_memory = c.hlo_bytes / (n * spec.hbm_bandwidth)
    t_useful = max(t_compute, t_memory)
    exposed = 1.0 - min(max(overlap_fraction, 0.0), 1.0)
    t_ici = exposed * c.collective_bytes_ici / (n * spec.ici_bandwidth)
    t_dcn = exposed * c.collective_bytes_dcn / (n * spec.dcn_bandwidth)
    return {
        "t_compute": t_compute,
        "t_memory": t_memory,
        "t_useful": t_useful,
        "t_ici": t_ici,
        "t_dcn": t_dcn,
        "t_total": t_useful + t_ici + t_dcn,
    }


# ---------------------------------------------------------------------------
# absolute factors (parallel-efficiency branch)
# ---------------------------------------------------------------------------


def _clamp01(x: float) -> float:
    return min(max(x, 0.0), 1.0)


def absolute_factors(
    region: RegionRecord,
    resources: ResourceConfig,
    spec: ChipSpec | str | None = None,
    overlap_fraction: float = 0.0,
) -> dict[str, float]:
    """Parallel-efficiency hierarchy + informational rows for one region."""
    if not isinstance(spec, ChipSpec):
        spec = get_target(spec)
    m = region.measurements
    t = modeled_times(region, resources, spec, overlap_fraction)

    # communication efficiency: multiplicative split that composes exactly
    if t["t_total"] > 0:
        ici_eff = t["t_useful"] / (t["t_useful"] + t["t_ici"]) if t["t_useful"] > 0 else 1.0
        dcn_eff = (
            (t["t_useful"] + t["t_ici"]) / t["t_total"] if t["t_total"] > 0 else 1.0
        )
    else:
        ici_eff = dcn_eff = 1.0
    comm_eff = ici_eff * dcn_eff

    # dispatch efficiency (measured): device-busy wall fraction
    if m.elapsed_s > 0 and m.device_time_s > 0:
        dispatch_eff = _clamp01(m.device_time_s / m.elapsed_s)
    else:
        dispatch_eff = 1.0

    # load balance (measured sub-balances default to 1 when not observed)
    data_lb = 1.0 if m.data_lb is None else m.data_lb
    expert_lb = 1.0 if m.expert_lb is None else m.expert_lb
    if m.in_pod_lb is not None or m.inter_pod_lb is not None:
        in_pod = 1.0 if m.in_pod_lb is None else m.in_pod_lb
        inter_pod = 1.0 if m.inter_pod_lb is None else m.inter_pod_lb
        host_lb = in_pod * inter_pod
    else:
        host_lb = 1.0 if m.host_lb is None else m.host_lb
        in_pod = host_lb
        inter_pod = 1.0
    lb = data_lb * expert_lb * host_lb

    parallel = dispatch_eff * comm_eff * lb

    out = {
        PARALLEL_EFF: parallel,
        DISPATCH_EFF: dispatch_eff,
        COMM_EFF: comm_eff,
        ICI_COMM_EFF: ici_eff,
        DCN_COMM_EFF: dcn_eff,
        LOAD_BALANCE: lb,
        DATA_LB: data_lb,
        EXPERT_LB: expert_lb,
        HOST_LB: host_lb,
        IN_POD_LB: in_pod,
        INTER_POD_LB: inter_pod,
    }

    # informational rows
    c = region.counters
    n = max(resources.total_devices, 1)
    if m.device_time_s > 0 and c.useful_flops > 0:
        achieved = c.useful_flops / (n * m.device_time_s)
        out[ACHIEVED_TFLOPS] = achieved / 1e12
        out[MXU_UTIL] = achieved / spec.peak_flops_bf16
    if c.useful_flops > 0 and c.model_flops > 0:
        out[FLOP_USEFULNESS] = c.model_flops / c.useful_flops
    out[ELAPSED_S] = m.elapsed_s
    return out


# ---------------------------------------------------------------------------
# computation scalability (relative to a reference run)
# ---------------------------------------------------------------------------

WEAK = "weak"
STRONG = "strong"


def detect_scaling_mode(
    runs: list[tuple[RegionRecord, ResourceConfig]],
    rel_tol: float = 0.2,
) -> str:
    """Paper's rule: weak scaling iff instructions per CPU are constant
    (within tolerance); otherwise strong. "Instructions" -> HLO FLOPs,
    "CPU" -> device."""
    per_dev = [
        r.counters.useful_flops / max(res.total_devices, 1) for r, res in runs
    ]
    per_dev = [p for p in per_dev if p > 0]
    if len(per_dev) < 2:
        return STRONG
    lo, hi = min(per_dev), max(per_dev)
    return WEAK if hi <= lo * (1.0 + rel_tol) else STRONG


def scalability_factors(
    region: RegionRecord,
    resources: ResourceConfig,
    ref_region: RegionRecord,
    ref_resources: ResourceConfig,
    mode: str,
    spec: ChipSpec | str | None = None,
) -> dict[str, float]:
    """FLOP/throughput/frequency scaling vs the reference configuration.

    Mirrors the paper exactly: strong scaling assumes *total* instructions
    constant, weak scaling assumes instructions *per CPU* constant; deviations
    count as inefficiency. Throughput scaling is the IPC-scaling analogue
    (achieved useful FLOP/s per device relative to reference); frequency
    scaling uses the (fixed) chip clock.
    """
    if not isinstance(spec, ChipSpec):
        spec = get_target(spec)
    c, rc = region.counters, ref_region.counters
    m, rm = region.measurements, ref_region.measurements
    n, rn = max(resources.total_devices, 1), max(ref_resources.total_devices, 1)

    if mode == STRONG:
        flop_scaling = rc.useful_flops / c.useful_flops if c.useful_flops > 0 else 1.0
    else:
        per = c.useful_flops / n
        rper = rc.useful_flops / rn
        flop_scaling = rper / per if per > 0 else 1.0

    # throughput (IPC) scaling: achieved FLOP/s per device, relative
    if m.device_time_s > 0 and rm.device_time_s > 0 and c.useful_flops > 0 and rc.useful_flops > 0:
        thr = c.useful_flops / (n * m.device_time_s)
        rthr = rc.useful_flops / (rn * rm.device_time_s)
        throughput_scaling = thr / rthr if rthr > 0 else 1.0
    else:
        throughput_scaling = 1.0

    frequency_scaling = 1.0  # TPU clocks are fixed (DESIGN.md §3)

    return {
        COMP_SCALABILITY: flop_scaling * throughput_scaling * frequency_scaling,
        FLOP_SCALING: flop_scaling,
        THROUGHPUT_SCALING: throughput_scaling,
        FREQUENCY_SCALING: frequency_scaling,
    }


def compute_pop(
    region: RegionRecord,
    resources: ResourceConfig,
    spec: ChipSpec | str | None = None,
    overlap_fraction: float = 0.0,
    ref: tuple[RegionRecord, ResourceConfig] | None = None,
    mode: str = STRONG,
) -> dict[str, float]:
    """Full factor dict for one region. Without a reference, the
    scalability branch is identity (absolute run)."""
    pop = absolute_factors(region, resources, spec, overlap_fraction)
    if ref is not None:
        pop.update(
            scalability_factors(region, resources, ref[0], ref[1], mode, spec)
        )
    else:
        pop.update(
            {
                COMP_SCALABILITY: 1.0,
                FLOP_SCALING: 1.0,
                THROUGHPUT_SCALING: 1.0,
                FREQUENCY_SCALING: 1.0,
            }
        )
    pop[GLOBAL_EFF] = pop[PARALLEL_EFF] * pop[COMP_SCALABILITY]
    return pop


def validate_pop(pop: dict[str, float], atol: float = 1e-9) -> list[str]:
    """Check the multiplicative identities; returns list of violations.

    Used by hypothesis property tests: for any raw inputs, the published
    factor dict must compose exactly.
    """
    errors = []

    def close(a: float, b: float) -> bool:
        return abs(a - b) <= atol + 1e-6 * max(abs(a), abs(b))

    checks = [
        (GLOBAL_EFF, [PARALLEL_EFF, COMP_SCALABILITY]),
        (PARALLEL_EFF, [DISPATCH_EFF, COMM_EFF, LOAD_BALANCE]),
        (COMM_EFF, [ICI_COMM_EFF, DCN_COMM_EFF]),
        (LOAD_BALANCE, [DATA_LB, EXPERT_LB, HOST_LB]),
        (HOST_LB, [IN_POD_LB, INTER_POD_LB]),
        (COMP_SCALABILITY, [FLOP_SCALING, THROUGHPUT_SCALING, FREQUENCY_SCALING]),
    ]
    for parent, children in checks:
        if parent in pop and all(ch in pop for ch in children):
            prod = 1.0
            for ch in children:
                prod *= pop[ch]
            if not close(pop[parent], prod):
                errors.append(f"{parent}={pop[parent]} != prod(children)={prod}")
    return errors
