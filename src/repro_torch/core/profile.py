"""StepProfile: static per-step counters for one execution of a step.

The JAX package derives them from the compiled HLO (``repro.core.hlo``);
PyTorch runs eagerly and has no compiled program to read, so the port
counts one real execution of the step instead (``StepProfile.count``):

* one ``TorchDispatchMode`` (``_Counter``) sees every operator the step
  dispatches and runs it as it came. Per operator it sums the bytes of
  its tensor inputs and outputs (views move nothing and are skipped:
  the HBM traffic of an eager program that keeps no intermediate on
  chip), and the FLOPs of the operators that
  ``torch.utils.flop_counter``'s formula registry knows (the matrix
  products and attention, forward and backward; a composite operator
  that reaches the mode whole, as ``aten.einsum`` does in inference
  mode, counts its parts' FLOPs, read off its decomposition on meta
  tensors). ``FlopCounterMode`` does not count the step: it runs every
  operator that its registry lacks through ``func.decompose``, so the
  counted step would run other maths than the step it describes (bf16
  ``silu_backward`` became sigmoid, sub, mul and add) and its bytes
  would be those parts';
* a kernel launched through ``ctypes`` is invisible to both, so each
  kernel wrapper
  reports its own FLOPs and bytes from its shapes through
  ``repro_torch.kernels.COST_SINKS`` (attention counts only the causal
  work its loop bound computes).

``per_computation`` is keyed by operator (``aten.mm``) or kernel name
(``flash_attention``), which is what a record's ``computations`` then
holds. A StepProfile describes ONE execution across the whole machine.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry as _FLOP_FORMULAS

from repro_torch import kernels as K
from repro_torch.core.hardware import ChipSpec, get_target
from repro_torch.core.records import (
    ComputationCounters,
    RegionCounters,
    top_computations as _top_computations,
)


def _tensor_bytes(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (list, tuple)):
        return sum(_tensor_bytes(o) for o in obj)
    if isinstance(obj, dict):
        return sum(_tensor_bytes(o) for o in obj.values())
    return 0


def _composite(func) -> bool:
    """Whether ``func`` runs its C++ ``CompositeImplicitAutograd`` kernel:
    in inference mode such an operator (``aten.matmul``, ``aten.einsum``)
    reaches a dispatch mode whole, and its parts run below it."""
    return torch._C._dispatch_has_kernel_for_dispatch_key(
        func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)


def _meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device="meta")
    return x


def _composite_flops(func, args, kwargs) -> float:
    """The FLOPs of a composite operator's parts, read off its decomposition
    on meta tensors with every dispatch mode set aside: nothing runs on the
    step's tensors, and no other mode sees the parts. An operator whose
    shapes depend on its data has no meta decomposition: it counts 0."""
    from torch.utils._pytree import tree_map
    from torch.utils._python_dispatch import _disable_current_modes
    from torch.utils.flop_counter import FlopCounterMode

    with _disable_current_modes(), FlopCounterMode(display=False) as fm:
        try:
            func(*tree_map(_meta, args), **tree_map(_meta, kwargs))
        except (NotImplementedError, RuntimeError):
            return 0.0
    return float(fm.get_total_flops())


class _Counter(TorchDispatchMode):
    """Per-operator call count, input+output bytes and FLOPs; every
    operator runs exactly as it was dispatched."""

    def __init__(self) -> None:
        super().__init__()
        self.ops: dict[str, list] = {}  # name -> [calls, bytes, flops]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view:
            entry = self.ops.setdefault(str(func.overloadpacket), [0, 0, 0.0])
            entry[0] += 1
            entry[1] += _tensor_bytes(args) + _tensor_bytes(kwargs) + _tensor_bytes(out)
            formula = _FLOP_FORMULAS.get(func.overloadpacket)
            if formula is not None:
                entry[2] += float(formula(*args, **kwargs, out_val=out))
            elif _composite(func):
                entry[2] += _composite_flops(func, args, kwargs)
        return out


@dataclasses.dataclass
class StepProfile:
    """Machine-total static counters for one step execution."""

    num_devices: int = 1
    flops: float = 0.0                  # executed FLOPs, total
    dot_flops: float = 0.0              # of which matrix products / attention
    hbm_bytes: float = 0.0              # operator input+output bytes, total
    collective_bytes_ici: float = 0.0
    collective_bytes_dcn: float = 0.0
    model_flops: float = 0.0            # analytic useful FLOPs (6ND-style)
    model_bytes: float = 0.0
    # collective kind -> instances per step (empty on one card); the
    # tracer emits one event per instance
    collective_counts: dict[str, int] = dataclasses.field(default_factory=dict)
    per_computation: dict[str, ComputationCounters] = dataclasses.field(
        default_factory=dict
    )

    # ---- construction ----

    @classmethod
    def count(cls, fn: Callable, *args, num_devices: int = 1, model_flops: float = 0.0,
              model_bytes: float = 0.0, **kwargs) -> tuple[Any, "StepProfile"]:
        """Run ``fn(*args, **kwargs)`` once under the counters; returns its
        result and the profile of that execution. The count is one
        device's: on a mesh of ``num_devices`` ranks, each running its
        equal share of the step (its rows, and on a tensor-parallel mesh
        its heads, columns, experts and vocabulary block), the machine
        total is ``num_devices`` times it (as the JAX package scales its
        per-device HLO count)."""
        kernels: dict[str, list] = {}

        def sink(name: str, flops: float, nbytes: float) -> None:
            entry = kernels.setdefault(name, [0, 0.0, 0.0])
            entry[0] += 1
            entry[1] += flops
            entry[2] += nbytes

        K.COST_SINKS.append(sink)
        try:
            with _Counter() as counter:
                out = fn(*args, **kwargs)
        finally:
            K.COST_SINKS.remove(sink)
        per: dict[str, ComputationCounters] = {}
        for name, (calls, nbytes, f) in counter.ops.items():
            per[name] = ComputationCounters(
                name=name, kind="op", multiplicity=float(calls), num_instructions=calls,
                flops=f, dot_flops=f, hbm_bytes=float(nbytes))
        for name, (calls, f, nbytes) in kernels.items():
            per[name] = ComputationCounters(
                name=name, kind="kernel", multiplicity=float(calls), num_instructions=calls,
                flops=f, dot_flops=f if name.startswith("flash") else 0.0,
                hbm_bytes=nbytes)
        n = max(num_devices, 1)
        if n > 1:
            per = {name: c.scaled(n) for name, c in per.items()}
        return out, cls(
            num_devices=n,
            flops=sum(c.flops for c in per.values()),
            dot_flops=sum(c.dot_flops for c in per.values()),
            hbm_bytes=sum(c.hbm_bytes for c in per.values()),
            model_flops=model_flops, model_bytes=model_bytes, per_computation=per,
        )

    # ---- transforms ----

    def scaled(self, steps: float) -> "StepProfile":
        kw = {
            k: getattr(self, k) * steps
            for k in ("flops", "dot_flops", "hbm_bytes", "collective_bytes_ici",
                      "collective_bytes_dcn", "model_flops", "model_bytes")
        }
        return dataclasses.replace(
            self,
            collective_counts=dict(self.collective_counts),
            per_computation={
                name: cc.scaled(steps) for name, cc in self.per_computation.items()
            },
            **kw,
        )

    def top_computations(self, n: int = 8, by: str = "hbm_bytes") -> list[ComputationCounters]:
        """The n most expensive computations by ``by``."""
        return _top_computations(self.per_computation.values(), n, by)

    def to_counters(self) -> RegionCounters:
        return RegionCounters(
            useful_flops=self.flops,
            hlo_bytes=self.hbm_bytes,
            collective_bytes_ici=self.collective_bytes_ici,
            collective_bytes_dcn=self.collective_bytes_dcn,
            model_flops=self.model_flops,
        )

    # ---- roofline (the three terms) ----

    def roofline_terms(self, spec: ChipSpec | str | None = None) -> dict[str, Any]:
        """Seconds per step on the target hardware (JAX ``roofline_terms``;
        ``spec`` a ``ChipSpec``, a target's name, or None for
        ``DEFAULT_TARGET``, the H100 SXM):

        compute    = FLOPs / (devices * peak)
        memory     = bytes / (devices * HBM bandwidth)
        collective = collective bytes / (devices * link bandwidth)

        with the bottleneck, the bound (the largest term) and the serial sum;
        against ``model_flops`` the roofline fractions and the model-to-
        counted FLOP ratio, and against ``model_bytes`` the memory fraction."""
        if not isinstance(spec, ChipSpec):
            spec = get_target(spec)
        n = self.num_devices
        compute = self.flops / (n * spec.peak_flops_bf16)
        memory = self.hbm_bytes / (n * spec.hbm_bandwidth)
        coll_ici = self.collective_bytes_ici / (n * spec.ici_bandwidth)
        coll_dcn = self.collective_bytes_dcn / (n * spec.dcn_bandwidth)
        collective = coll_ici + coll_dcn
        terms: dict[str, Any] = {
            "compute_s": compute,
            "memory_s": memory,
            "collective_s": collective,
            "collective_ici_s": coll_ici,
            "collective_dcn_s": coll_dcn,
        }
        terms["bottleneck"] = max(("compute_s", "memory_s", "collective_s"),
                                  key=lambda k: terms[k])
        terms["step_time_lower_bound_s"] = max(compute, memory, collective)
        terms["step_time_serial_s"] = compute + memory + collective
        if self.model_flops > 0:
            ideal = self.model_flops / (n * spec.peak_flops_bf16)
            terms["roofline_fraction"] = ideal / max(terms["step_time_serial_s"], 1e-30)
            terms["roofline_fraction_overlapped"] = ideal / max(
                terms["step_time_lower_bound_s"], 1e-30)
            terms["model_to_hlo_flops"] = self.model_flops / max(self.flops, 1e-30)
        if self.model_bytes > 0:
            ideal_mem = self.model_bytes / (n * spec.hbm_bandwidth)
            terms["memory_roofline_fraction"] = ideal_mem / max(terms["memory_s"], 1e-30)
        return terms

    # ---- serialization (the tracer's ``trace_meta.json``; the JAX key names) ----

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "StepProfile":
        """Read a profile written by either package: keys the port has no
        field for (the JAX package's ``xla_cost``, ``memory``, ...) are
        dropped."""
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in known}
        kw["per_computation"] = {
            name: ComputationCounters.from_json(name, cd)
            for name, cd in (kw.get("per_computation") or {}).items()
        }
        return cls(**kw)
