"""StepProfile: static per-step counters for one execution of a step.

The JAX package derives them from the compiled HLO (``repro.core.hlo``);
PyTorch runs eagerly and has no compiled program to read, so the port
counts one real execution of the step instead (``StepProfile.count``):

* ``torch.utils.flop_counter.FlopCounterMode`` gives the FLOPs of the
  matrix products (forward and backward), per operator;
* a ``TorchDispatchMode`` sums, per operator, the bytes of its tensor
  inputs and outputs (views move nothing and are skipped): the HBM
  traffic of an eager program that keeps no intermediate on chip;
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
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import kernels as K
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


class _ByteCounter(TorchDispatchMode):
    """Per-operator call count and input+output bytes."""

    def __init__(self) -> None:
        super().__init__()
        self.ops: dict[str, list] = {}  # name -> [calls, bytes]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view:
            entry = self.ops.setdefault(str(func.overloadpacket), [0, 0])
            entry[0] += 1
            entry[1] += _tensor_bytes(args) + _tensor_bytes(kwargs) + _tensor_bytes(out)
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
        result and the profile of that execution."""
        kernels: dict[str, list] = {}

        def sink(name: str, flops: float, nbytes: float) -> None:
            entry = kernels.setdefault(name, [0, 0.0, 0.0])
            entry[0] += 1
            entry[1] += flops
            entry[2] += nbytes

        K.COST_SINKS.append(sink)
        try:
            with _ByteCounter() as bytes_mode, FlopCounterMode(display=False) as flop_mode:
                out = fn(*args, **kwargs)
        finally:
            K.COST_SINKS.remove(sink)
        op_flops = {str(op): float(f)
                    for op, f in flop_mode.get_flop_counts().get("Global", {}).items()}
        per: dict[str, ComputationCounters] = {}
        for name, (calls, nbytes) in bytes_mode.ops.items():
            f = op_flops.get(name, 0.0)
            per[name] = ComputationCounters(
                name=name, kind="op", multiplicity=float(calls), num_instructions=calls,
                flops=f, dot_flops=f, hbm_bytes=float(nbytes))
        for name, (calls, f, nbytes) in kernels.items():
            per[name] = ComputationCounters(
                name=name, kind="kernel", multiplicity=float(calls), num_instructions=calls,
                flops=f, dot_flops=f if name.startswith("flash") else 0.0,
                hbm_bytes=nbytes)
        return out, cls(
            num_devices=max(num_devices, 1),
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
