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
  work its loop bound computes);
* a ``torch.distributed`` collective reaches the mode as a ``c10d``
  operator. Its kind, its group's size, and its operand and wire bytes
  follow the JAX package's rule for an HLO collective (from the result's
  bytes and the group size ``g``: an all-gather's operand is the result
  over ``g``, a reduce-scatter's the result times ``g``; the wire carries
  ``(g-1)/g`` of the larger, twice for an all-reduce). A group that spans
  more than one pod (``devices_per_pod``) counts as DCN, any other as ICI;
  a one-rank group moves nothing and is not counted. Its operand and
  result bytes stay in ``hbm_bytes`` as any operator's do;
* with ``memory_args`` the mode also follows the storages that the step
  allocates (``_Memory``), which gives the JAX ``memory_analysis`` keys of
  the eager program: its arguments, outputs, the outputs that are
  arguments updated in place (``alias``), and the peak of the storages
  alive beyond the arguments (``temp``). On the meta device nothing is
  allocated, and this is how ``launch.dryrun`` sizes a rank's memory.

``per_computation`` is keyed by operator (``aten.mm``) or kernel name
(``flash_attention``), which is what a record's ``computations`` then
holds. A StepProfile describes ONE execution across the whole machine.
"""

from __future__ import annotations

import dataclasses
import weakref
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


# c10d operator -> the JAX package's collective kind
_COLLECTIVES = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "collective-broadcast",
}


def collective_bytes(kind: str, result_bytes: float, g: int) -> tuple[float, float]:
    """(operand bytes, wire bytes) of one collective over ``g`` ranks whose
    result is ``result_bytes`` (the JAX package's rule, ``core/hlo.py``)."""
    if kind == "all-gather":
        return result_bytes / g, result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return result_bytes * g, result_bytes * (g - 1)
    if kind == "all-reduce":
        return result_bytes, 2.0 * result_bytes * (g - 1) / g
    if kind == "all-to-all":
        return result_bytes, result_bytes * (g - 1) / g
    return result_bytes, result_bytes


def _group_ranks(func, args, kwargs) -> list[int]:
    """The ranks of a c10d operator's process group argument."""
    import torch.distributed as dist

    for i, a in enumerate(func._schema.arguments):
        if "ProcessGroup" in str(a.type):
            pg = args[i] if i < len(args) else kwargs[a.name]
            return dist.get_process_group_ranks(dist.ProcessGroup.unbox(pg))
    raise ValueError(f"{func}: no process group argument")


def _storages(obj, out: dict) -> dict:
    """``{storage key: (storage, bytes)}`` of every tensor in ``obj``."""
    if isinstance(obj, torch.Tensor):
        st = obj.untyped_storage()
        out.setdefault(st._cdata, (st, st.nbytes()))
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _storages(o, out)
    elif isinstance(obj, dict):
        for o in obj.values():
            _storages(o, out)
    return out


_PLAIN = (bool, int, float, str, torch.dtype, torch.device, torch.layout, torch.memory_format)


def _meta_key(func, args, kwargs, meta_only: bool = True):
    """A hashable key of an operator's call on tensors that are all on the
    meta device (any device unless ``meta_only``): their shapes, strides
    and dtypes, and every other argument by type and value; or None (no
    tensor, a tensor elsewhere, an argument of another kind)."""
    parts = [func]
    tensors = 0

    def add(a) -> bool:
        nonlocal tensors
        if isinstance(a, torch.Tensor):
            if meta_only and not a.is_meta:
                return False
            tensors += 1
            parts.append((tuple(a.shape), a.stride(), a.dtype))
        elif isinstance(a, (list, tuple)):
            parts.append(("seq", len(a)))
            return all(add(x) for x in a)
        elif a is None or isinstance(a, _PLAIN):
            parts.append((type(a), a))
        else:
            return False
        return True

    if not (add(args) and add(tuple(sorted(kwargs.items())))) or not tensors:
        return None
    return tuple(parts)


def _out_spec(out):
    """The metadata of an operator's meta outputs: a tensor, or a tuple or
    list of tensors (None for anything else)."""
    if isinstance(out, torch.Tensor):
        return (tuple(out.shape), out.stride(), out.dtype) if out.is_meta else None
    if isinstance(out, (list, tuple)):
        specs = [_out_spec(o) for o in out]
        if specs and all(isinstance(o, torch.Tensor) for o in out) and None not in specs:
            return (type(out), specs)
    return None


def _from_spec(spec):
    if isinstance(spec[0], type):
        return spec[0](_from_spec(s) for s in spec[1])
    shape, stride, dtype = spec
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


class _Memory:
    """The storages a step allocates: their live bytes and its peak. A
    storage counts from the operator that makes it (one that is neither a
    view nor in place and does not return an input's storage) until it is
    freed (a ``weakref`` to the storage); the arguments' storages never
    count."""

    def __init__(self, args) -> None:
        self.args = _storages(args, {})
        self.seen: set[int] = set(self.args)
        self.live = 0
        self.peak = 0
        self._refs: list = []

    def _free(self, nbytes: int, key: int, _ref) -> None:
        self.live -= nbytes
        self.seen.discard(key)

    def add(self, out, inputs) -> None:
        """The storages ``out`` holds that no input holds and none before."""
        held = _storages(inputs, {})
        for key, (st, nbytes) in _storages(out, {}).items():
            if key in self.seen or key in held:
                continue
            self.seen.add(key)
            self._refs.append(weakref.ref(st, lambda r, n=nbytes, k=key: self._free(n, k, r)))
            self.live += nbytes
        self.peak = max(self.peak, self.live)

    def analysis(self, out) -> dict[str, float]:
        """The JAX ``memory_analysis`` keys (bytes of one rank)."""
        outs = _storages(out, {})
        return {
            "argument_size_in_bytes": float(sum(n for _, n in self.args.values())),
            "output_size_in_bytes": float(sum(n for _, n in outs.values())),
            "alias_size_in_bytes": float(sum(n for k, (_, n) in outs.items() if k in self.args)),
            "temp_size_in_bytes": float(self.peak),
        }


class _Counter(TorchDispatchMode):
    """Per-operator call count, input+output bytes and FLOPs, the
    collectives, and with ``memory`` the storages allocated; every
    operator runs as it was dispatched (on the meta device a repeated
    call may take its outputs' metadata from the first, ``_run``)."""

    def __init__(self, devices_per_pod: int | None = None, memory: _Memory | None = None):
        super().__init__()
        self.ops: dict[str, list] = {}  # name -> [calls, bytes, flops]
        # kind -> [count, operand ici, operand dcn, wire ici, wire dcn]
        self.collectives: dict[str, list] = {}
        self.devices_per_pod = devices_per_pod
        self.memory = memory
        self._meta_specs: dict = {}
        self._funcs: dict = {}
        self._flops: dict = {}

    def _collective(self, kind: str, func, args, kwargs) -> None:
        ranks = _group_ranks(func, args, kwargs)
        g = len(ranks)
        if g <= 1:
            return
        operand, wire = collective_bytes(kind, float(_tensor_bytes(args[0])), g)
        dpp = self.devices_per_pod
        dcn = bool(dpp) and len({r // dpp for r in ranks}) > 1
        entry = self.collectives.setdefault(kind, [0, 0.0, 0.0, 0.0, 0.0])
        entry[0] += 1
        entry[2 if dcn else 1] += operand
        entry[4 if dcn else 3] += wire

    def _run(self, func, args, kwargs, functional: bool):
        """``func(*args, **kwargs)``; on the meta device a functional
        operator called before on inputs of the same shapes, strides and
        dtypes (and the same other arguments) gets fresh outputs of the
        metadata the first call gave, without running its meta function
        again (a recurrent block's step repeats its operators thousands of
        times); one whose outputs shared an input's storage always runs.
        Returns (outputs, whether they are such fresh ones)."""
        key = _meta_key(func, args, kwargs) if functional else None
        if key is None:
            return func(*args, **kwargs), False
        spec = self._meta_specs.get(key)
        if spec is None:
            out = func(*args, **kwargs)
            spec = _out_spec(out)
            # outputs of another kind, or an input's storage (``_unsafe_view``)
            if spec is None or _storages(out, {}).keys() & _storages((args, kwargs), {}):
                spec = False
            self._meta_specs[key] = spec
            return out, False
        if spec is False:
            return func(*args, **kwargs), False
        return _from_spec(spec), True

    def _info(self, func) -> tuple:
        """(functional, view, entry name, FLOP formula, composite,
        collective kind) of an operator, read once."""
        info = self._funcs.get(func)
        if info is None:
            view = func.is_view
            info = self._funcs[func] = (
                not view and not func._schema.is_mutable, view, str(func.overloadpacket),
                _FLOP_FORMULAS.get(func.overloadpacket), _composite(func),
                _COLLECTIVES.get(func._opname) if func.namespace == "c10d" else None)
        return info

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        functional, view, name, formula, composite, kind = self._info(func)
        out, fresh = self._run(func, args, kwargs, functional)
        if self.memory is not None and functional:
            self.memory.add(out, () if fresh else (args, kwargs))
        if kind is not None:
            self._collective(kind, func, args, kwargs)
        if not view:
            entry = self.ops.setdefault(name, [0, 0, 0.0])
            entry[0] += 1
            entry[1] += _tensor_bytes(args) + _tensor_bytes(kwargs) + _tensor_bytes(out)
            if formula is not None:
                entry[2] += float(formula(*args, **kwargs, out_val=out))
            elif composite:
                entry[2] += self._composite_flops(func, args, kwargs)
        return out

    def _composite_flops(self, func, args, kwargs) -> float:
        """``_composite_flops``, once per call signature (shapes, dtypes and
        arguments): a recurrent block's step repeats its calls."""
        key = _meta_key(func, args, kwargs, meta_only=False)
        if key is None:
            return _composite_flops(func, args, kwargs)
        flops = self._flops.get(key)
        if flops is None:
            flops = self._flops[key] = _composite_flops(func, args, kwargs)
        return flops


@dataclasses.dataclass
class StepProfile:
    """Machine-total static counters for one step execution."""

    num_devices: int = 1
    flops: float = 0.0                  # executed FLOPs, total
    dot_flops: float = 0.0              # of which matrix products / attention
    hbm_bytes: float = 0.0              # operator input+output bytes, total
    collective_bytes_ici: float = 0.0   # operand-bytes convention, total
    collective_bytes_dcn: float = 0.0
    collective_wire_bytes_ici: float = 0.0
    collective_wire_bytes_dcn: float = 0.0
    model_flops: float = 0.0            # analytic useful FLOPs (6ND-style)
    model_bytes: float = 0.0
    # collective kind -> instances per step on one rank (empty on one
    # card); the tracer emits one event per instance
    collective_counts: dict[str, int] = dataclasses.field(default_factory=dict)
    # one rank's JAX ``memory_analysis`` keys (``count(memory_args=...)``)
    memory: dict[str, float] = dataclasses.field(default_factory=dict)
    per_computation: dict[str, ComputationCounters] = dataclasses.field(
        default_factory=dict
    )

    # ---- construction ----

    @classmethod
    def count(cls, fn: Callable, *args, num_devices: int = 1, model_flops: float = 0.0,
              model_bytes: float = 0.0, devices_per_pod: int | None = None,
              memory_args=None, **kwargs) -> tuple[Any, "StepProfile"]:
        """Run ``fn(*args, **kwargs)`` once under the counters; returns its
        result and the profile of that execution. The count is one
        device's: on a mesh of ``num_devices`` ranks, each running its
        equal share of the step (its rows, and on a tensor-parallel mesh
        its heads, columns, experts and vocabulary block), the machine
        total is ``num_devices`` times it (as the JAX package scales its
        per-device HLO count); so are the collective bytes, DCN where a
        group spans more than one pod of ``devices_per_pod`` ranks.
        ``memory_args`` (a tree of tensors: what the rank holds as the
        step's inputs) turns on the memory count, ``memory``."""
        kernels: dict[str, list] = {}

        def sink(name: str, flops: float, nbytes: float) -> None:
            entry = kernels.setdefault(name, [0, 0.0, 0.0])
            entry[0] += 1
            entry[1] += flops
            entry[2] += nbytes

        mem = None if memory_args is None else _Memory(memory_args)
        K.COST_SINKS.append(sink)
        try:
            with _Counter(devices_per_pod, mem) as counter:
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
        coll = counter.collectives.values()
        return out, cls(
            num_devices=n,
            flops=sum(c.flops for c in per.values()),
            dot_flops=sum(c.dot_flops for c in per.values()),
            hbm_bytes=sum(c.hbm_bytes for c in per.values()),
            collective_bytes_ici=n * sum(c[1] for c in coll),
            collective_bytes_dcn=n * sum(c[2] for c in coll),
            collective_wire_bytes_ici=n * sum(c[3] for c in coll),
            collective_wire_bytes_dcn=n * sum(c[4] for c in coll),
            model_flops=model_flops, model_bytes=model_bytes,
            collective_counts={k: c[0] for k, c in sorted(counter.collectives.items())},
            memory={} if mem is None else mem.analysis(out),
            per_computation=per,
        )

    # ---- transforms ----

    def scaled(self, steps: float) -> "StepProfile":
        kw = {
            k: getattr(self, k) * steps
            for k in ("flops", "dot_flops", "hbm_bytes", "collective_bytes_ici",
                      "collective_bytes_dcn", "collective_wire_bytes_ici",
                      "collective_wire_bytes_dcn", "model_flops", "model_bytes")
        }
        return dataclasses.replace(
            self,
            collective_counts=dict(self.collective_counts),
            memory=dict(self.memory),
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
        field for (the JAX package's ``xla_cost``, ``remat_dot_flops``,
        ...) are dropped."""
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in known}
        kw["per_computation"] = {
            name: ComputationCounters.from_json(name, cd)
            for name, cd in (kw.get("per_computation") or {}).items()
        }
        return cls(**kw)
