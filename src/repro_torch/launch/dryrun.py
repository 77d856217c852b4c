"""Multi-pod dry run (``repro.launch.dryrun``): one rank's share of every
(architecture x input shape) cell on the production meshes, counted on the
meta device, with NO buffer allocation and nothing run on a device.

For each cell that ``configs.skip_reason`` keeps, this process stands for
one rank of a ``"fake"`` process group of the mesh's size
(``launch.mesh.meta_mesh``; its collectives return at once and move
nothing). The rank's blocks of the state or parameters, the caches and
the batch are meta tensors; the cell's step (``make_train_step``,
``make_prefill_step``, ``make_decode_step`` or ``make_encoder_step``) is
dispatched once under ``StepProfile.count``, which gives per cell a JSON
artifact with:

  * ``memory_analysis``  -- the rank's bytes under the JAX keys
                            (arguments, outputs, aliased outputs, the peak
                            of the step's own tensors);
  * ``profile``          -- the counted FLOPs and bytes (operators, and
                            the K1/K2 kernels' meta routes) and the
                            collectives' bytes split ICI/DCN;
  * ``roofline``         -- the three roofline terms at the port's default
                            target (``h100_sxm``'s data-sheet peaks).

These are the counts of the port's own eager program, not of a compiled
XLA program: the JAX package's ``compile_s`` is ``count_s`` here (the
count's wall time), and there is no ``generated_code_size_in_bytes``.

A meta tensor holds no values, so the attention kernel's meta route counts
its pairs at the positions the cell implies (``kernels.flash_attention.ops
.meta_positions``): training, the prefill and the encoder at index
positions, a context-parallel rank's query block at its offset; a decode
step at the cache's last position, ``seq_len - 1``, every key visible, a
sequence-split cache block at its own key range. Where fsdp's context
parallelism splits the sequence over ``"model"``, rank 0 holds the first
query block, whose causal work is the least, so the last rank along
``"model"`` is counted too; both are recorded (``ranks``) and the profile
and roofline are the larger one's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dbrx-132b \\
      --shape train_4k --multi-pod both --out results/dryrun

Run it under ``TALP_ENABLE=1`` and every cell becomes a region of a
``repro_torch.start("dryrun")`` session (the count's wall time, the cell's
static counters) with one TALP run record written beside the artifacts.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Callable

import torch

from repro_torch.configs import (
    SHAPE_BY_NAME,
    SHAPES,
    effective_mode,
    get_config,
    list_archs,
    skip_reason,
)
from repro_torch.core.profile import StepProfile
from repro_torch.data.pipeline import batch_specs
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.shard import NamedSharding
from repro_torch.kernels.flash_attention.ops import meta_positions
from repro_torch.launch.mesh import Mesh, devices_per_pod, make_production_mesh, meta_mesh
from repro_torch.layers.common import abstract_params, tree_leaves, tree_map
from repro_torch.models import transformer as T
from repro_torch.models.flops import (
    decode_model_bytes,
    decode_model_flops,
    prefill_model_flops,
    train_step_model_flops,
)
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.serve.serve import (
    make_decode_step,
    make_encoder_step,
    make_prefill_step,
    serve_constraints,
)
from repro_torch.train.train import TrainConfig, TrainState, make_train_step

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def abstract_state(cfg, tcfg: TrainConfig) -> dict:
    """The train state's tree as meta tensors (JAX ``abstract_state``):
    params in the param dtype, AdamW's ``m``/``v`` (and ``master``) fp32,
    the step counters int32 scalars."""
    params = abstract_params(T.model_params(cfg), cfg.param_dtype)
    f32 = lambda p: _meta(p.shape, torch.float32)  # noqa: E731
    opt = {
        "step": _meta((), torch.int32),
        "m": tree_map(f32, params),
        "v": tree_map(f32, params),
    }
    if tcfg.optimizer.keep_master:
        opt["master"] = tree_map(f32, params)
    return {"params": params, "opt_state": opt, "step": _meta((), torch.int32)}


def _batch_shardings(mesh, batch_tree, lead_dims: int = 1) -> dict:
    """The batch dim (index 1 of train's (A, B, ...) layout, else 0) over
    ``divisible_batch_axes``, every other dim whole."""

    def f(x):
        b_index = 1 if lead_dims == 2 else 0
        spec = [None] * len(x.shape)
        spec[b_index] = SH.divisible_batch_axes(mesh, x.shape[b_index])
        return NamedSharding(mesh, tuple(spec))

    return tree_map(f, batch_tree)


def _blocks(tree, shardings) -> dict:
    """``{path: meta block}``: each leaf's block under its placement."""
    sh = dict(tree_leaves(shardings))
    return {p: _meta(sh[p].block_shape(tuple(t.shape)), t.dtype) for p, t in tree_leaves(tree)}


def _rank_of(mesh: Mesh, coords: dict) -> int:
    """The row-major rank at ``coords`` (axes missing from it at 0)."""
    r = 0
    for name, size in zip(mesh.axis_names, mesh.devices.shape):
        r = r * size + coords.get(name, 0)
    return r


def _count_rank(cfg, shape, mode: str, mesh: Mesh, rank: int, tcfg: TrainConfig,
                accum: int) -> tuple[StepProfile, dict]:
    """One rank's count of the cell's step on ``mesh`` (shape only; a mesh
    of one rank runs the plain step, with no process group). Returns the
    profile and ``{"rank", "context_parallel", "count_s"}``."""
    if mesh.devices.size == 1:
        return _count(rank_inputs(cfg, shape, mode, None, tcfg, accum))
    with meta_mesh(mesh.devices.shape, mesh.axis_names, rank) as ranked:
        return _count(rank_inputs(cfg, shape, mode, ranked, tcfg, accum))


@dataclasses.dataclass
class RankInputs:
    """One rank's share of a cell: ``run()`` dispatches the step once;
    ``held`` is what the rank holds as its inputs (``{group: {path: meta
    block}}``, the JAX trees' paths), ``args`` the step's own tensors among
    them (the model's and AdamW's blocks, the caches), ``positions`` the
    host positions its attention launches stand for (``meta_positions``),
    ``count`` the ``StepProfile.count`` keywords."""

    run: Callable[[], Any]
    held: dict
    args: dict
    rank: int
    context_parallel: bool = False
    positions: dict = dataclasses.field(default_factory=dict)
    count: dict = dataclasses.field(default_factory=dict)


def rank_inputs(cfg, shape, mode: str, mesh, tcfg: TrainConfig | None = None,
                accum: int = 1) -> RankInputs:
    """The rank's meta blocks of the cell and its step: ``mesh`` a meta
    mesh (``meta_mesh``; the rank is the process group's), or None for one
    rank with no process group. The step takes the global batch, as a
    rank of the port does, and reads its rows (a view); ``held`` has the
    rank's block of it."""
    tcfg = tcfg or TrainConfig(optimizer=AdamWConfig())
    B, S = shape.global_batch, shape.seq_len
    shape_mesh = mesh if mesh is not None else Mesh((1, 1), ("data", "model"))
    abstract = abstract_state(cfg, tcfg) if mode == "train" else {
        "params": abstract_params(T.model_params(cfg), cfg.param_dtype)}
    # the rank's blocks of the parameters (a block of a meta leaf allocates nothing)
    model = T.Transformer(cfg, abstract["params"], device=META, mesh=mesh)
    params = model.named_params()
    kw = dict(num_devices=shape_mesh.devices.size, devices_per_pod=devices_per_pod(shape_mesh))
    rank = 0 if mesh is None else mesh.rank
    positions: dict = {}
    cp = None

    if mode == "train":
        state = TrainState(model, adamw_init(params, tcfg.optimizer), 0)
        opt = {k: v for k, v in state.opt_state.items() if k != "step"}
        batch = batch_specs(cfg, shape, "train")
        if accum > 1:
            batch = {k: _meta((accum, x.shape[1] // accum) + tuple(x.shape[2:]), x.dtype)
                     for k, x in batch.items()}
        flat = {f"params/{p}": t for p, t in params.items()}
        flat.update({f"opt_state/{k}/{p}": t for k, leaves in opt.items()
                     for p, t in leaves.items()})
        flat["opt_state/step"] = abstract["opt_state"]["step"]
        flat["step"] = abstract["step"]
        held = {"state": flat,
                "batch": _blocks(batch, _batch_shardings(shape_mesh, batch, lead_dims=2))}
        args = {"params": params, "opt": opt}
        cp = _train_cp(cfg, mesh, batch["labels"].shape[1], S)
        step = make_train_step(cfg, tcfg, mesh)

        def run():  # the state's tensors are updated in place: the aliased outputs
            st, metrics = step(state, batch)
            return {"params": st.model.named_params(),
                    "opt": {k: v for k, v in st.opt_state.items() if k != "step"}}, metrics

        kw["model_flops"] = train_step_model_flops(cfg, batch["labels"].shape)
    else:
        batch = ({"tokens": _meta((B, 1), torch.int32)} if mode == "decode"
                 else batch_specs(cfg, shape, "prefill"))
        held = {"params": dict(params),
                "batch": _blocks(batch, _batch_shardings(shape_mesh, batch))}
        args = {"params": params}
        if mode == "encoder":
            enc = make_encoder_step(model, mesh)
            run = lambda: enc(batch)  # noqa: E731
            kw["model_flops"] = prefill_model_flops(cfg, B, S)
        else:
            caches = model.init_cache(B, S, paged=False)
            args["caches"] = held["caches"] = dict(tree_leaves(caches))
            if mode == "prefill":
                pre = make_prefill_step(model, mesh)
                run = lambda: pre(batch, caches)  # noqa: E731
                kw["model_flops"] = prefill_model_flops(cfg, B, S)
            else:
                dec = make_decode_step(model, mesh)
                pos = S - 1
                held["pos"] = {"pos": _meta((), torch.int32)}
                run = lambda: dec(batch["tokens"], pos, caches)  # noqa: E731
                positions = dict(decode_pos=pos, k_offset=_cache_offset(cfg, mesh, S))
                kw.update(model_flops=decode_model_flops(cfg, B, S),
                          model_bytes=decode_model_bytes(cfg, B, S))
        if mode != "decode" and mesh is not None:
            cp = serve_constraints(model, mesh, B, mode).cp
    if cp is not None:  # the rank's query block starts at its offset
        positions = dict(q_offset=cp.part(S).start)
    return RankInputs(run, held, args, rank, cp is not None, positions, kw)


def held_bytes(held: dict) -> int:
    """The bytes of a rank's input blocks (``RankInputs.held``)."""
    return sum(t.numel() * t.element_size() for _, t in tree_leaves(held))


def _count(inp: RankInputs) -> tuple[StepProfile, dict]:
    t0 = time.perf_counter()
    with meta_positions(**inp.positions):
        _, prof = StepProfile.count(inp.run, memory_args=inp.args, **inp.count)
    info = {"rank": inp.rank, "context_parallel": inp.context_parallel,
            "count_s": time.perf_counter() - t0}
    prof.memory["argument_size_in_bytes"] = float(held_bytes(inp.held))
    return prof, info


def _train_cp(cfg, mesh, rows: int, S: int):
    """The train step's ``ContextParallel`` on ``mesh`` for a microbatch of
    ``rows`` (None where it does not split the sequence), as
    ``make_train_step`` decides it."""
    from repro_torch.distributed.shard import BatchRanks, ContextParallel, TensorParallel
    from repro_torch.layers.common import LogicalConstraints

    if mesh is None or TensorParallel.of(cfg, mesh) is not None:
        return None
    split = LogicalConstraints(mesh, SH.activation_rules(cfg, mesh))
    return ContextParallel.of(cfg, mesh, BatchRanks.for_batch(split, (rows, S)))


def _cache_offset(cfg, mesh, max_len: int) -> int:
    """The first key position of the rank's dense cache block."""
    from repro_torch.distributed.shard import CacheSplit

    kv = None if mesh is None else CacheSplit.of(cfg, mesh)
    return 0 if kv is None else kv.offset(max_len // kv.size)


def _bound(prof: StepProfile) -> tuple[float, float]:
    """The larger count: the roofline's bound, then its serial sum (a
    collective-bound cell's ranks differ in compute alone)."""
    r = prof.roofline_terms()
    return r["step_time_lower_bound_s"], r["step_time_serial_s"]


def _rank_summary(prof: StepProfile, info: dict) -> dict:
    flash = prof.per_computation.get("flash_attention")
    return {
        "rank": info["rank"],
        "flops": prof.flops / prof.num_devices,
        "hbm_bytes": prof.hbm_bytes / prof.num_devices,
        "flash_attention_flops": (flash.flops / prof.num_devices) if flash else 0.0,
        "step_time_lower_bound_s": prof.roofline_terms()["step_time_lower_bound_s"],
        "count_s": info["count_s"],
    }


def cell_meta(cfg, shape, mesh: Mesh, arch: str | None = None) -> dict:
    """The cell's ``arch``, ``shape``, ``mode``, ``mesh`` and ``strategy`` (JAX's)."""
    return {"arch": arch or cfg.name, "shape": shape.name, "mode": effective_mode(cfg, shape),
            "mesh": dict(zip(mesh.axis_names, mesh.devices.shape)),
            "strategy": SH.effective_strategy(cfg, mesh)}


def count_cell(cfg, shape, mesh: Mesh, tcfg: TrainConfig | None = None, accum: int = 1,
               arch: str | None = None) -> tuple[StepProfile, dict]:
    """Count ``cfg``'s step at ``shape`` (an ``InputShape``) on ``mesh`` (a
    shape-only ``Mesh``: the production mesh, or any other) as one rank
    holds it; returns (profile, meta). Under context parallelism the last
    rank along ``"model"`` is counted too and the larger count kept
    (``_bound``)."""
    tcfg = tcfg or TrainConfig(optimizer=AdamWConfig())
    meta = cell_meta(cfg, shape, mesh, arch)
    mode = meta["mode"]
    prof, info = _count_rank(cfg, shape, mode, mesh, 0, tcfg, accum)
    counted = [(prof, info)]
    if info["context_parallel"]:
        last = _rank_of(mesh, {"model": mesh.sizes["model"] - 1})
        counted.append(_count_rank(cfg, shape, mode, mesh, last, tcfg, accum))
        meta["ranks"] = [_rank_summary(p, i) for p, i in counted]
    prof, info = max(counted, key=lambda c: _bound(c[0]))
    meta["counted_rank"] = info["rank"]
    meta["count_s"] = round(sum(i["count_s"] for _, i in counted), 2)
    if mode == "decode":
        meta["model_bytes"] = prof.model_bytes
    return prof, meta


def lower_cell(arch: str, shape_name: str, multi_pod: bool, tcfg=None, cfg=None,
               accum: int = 1):
    """Count one cell on the production mesh; returns (profile,
    model_flops, mesh, meta): JAX's (compiled, ...) with the profile in the
    compiled program's place. ``cfg`` overrides the registry config;
    ``accum`` splits the train global batch into microbatches."""
    cfg = cfg or get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    prof, meta = count_cell(cfg, SHAPE_BY_NAME[shape_name], mesh, tcfg, accum, arch=arch)
    return prof, prof.model_flops, mesh, meta


def _tag(arch: str, shape_name: str, multi_pod: bool, optimized: bool) -> str:
    tag = f"{arch}__{shape_name}__{'multipod' if multi_pod else 'singlepod'}"
    return tag + "__opt" if optimized else tag


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             force: bool = False, optimized: bool = False) -> dict:
    out_path = os.path.join(out_dir, _tag(arch, shape_name, multi_pod, optimized) + ".json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    cfg = get_config(arch)
    shape = SHAPE_BY_NAME[shape_name]
    reason = skip_reason(cfg, shape)
    if reason:
        rec = {"status": "skipped", "reason": reason, "arch": arch,
               "shape": shape_name, "multi_pod": multi_pod}
        _save(out_path, rec)
        return rec

    try:
        cfg_over = None
        if optimized:
            from repro_torch.configs import optimized_config

            cfg_over = optimized_config(arch)
        profile, _, _, meta = lower_cell(arch, shape_name, multi_pod, cfg=cfg_over)
        rec = ok_record(profile, meta, multi_pod)
    except Exception as e:  # a failed cell is a bug: record it loudly
        rec = {"status": "failed", "arch": arch, "shape": shape_name,
               "multi_pod": multi_pod, "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()}
    _save(out_path, rec)
    return rec


def ok_record(profile: StepProfile, meta: dict, multi_pod: bool) -> dict:
    """A counted cell's artifact (JAX's keys; ``count_s`` for ``compile_s``)."""
    meta = {k: v for k, v in meta.items() if k != "model_bytes"}
    return {"status": "ok", "multi_pod": multi_pod, **meta,
            "profile": profile.to_json(), "roofline": profile.roofline_terms(),
            "memory_analysis": profile.memory}


def _save(path: str, rec: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def mem_per_device_gib(rec: dict) -> float:
    """Arguments plus the step's peak, GiB: what one rank needs."""
    mem = rec["memory_analysis"]
    return (mem.get("argument_size_in_bytes", 0) + mem.get("temp_size_in_bytes", 0)) / 2**30


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", choices=["on", "off", "both"], default="both")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="use the optimized presets (configs.optimized_config) instead "
                         "of the baselines")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    shapes = [s.name for s in SHAPES] if args.shape == "all" else args.shape.split(",")
    pods = {"on": [True], "off": [False], "both": [False, True]}[args.multi_pod]

    import repro_torch

    session = repro_torch.start("dryrun")  # no-op unless TALP_ENABLE=1

    n_fail = 0
    counts: dict[str, int] = {}
    t_sweep = time.time()
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                tag = _tag(arch, shape, mp, False)
                t0 = time.time()
                with session.region(tag):
                    rec = run_cell(arch, shape, mp, args.out, args.force, args.optimized)
                if rec.get("status") == "ok" and "profile" in rec:
                    session.attach_static(tag, StepProfile.from_json(rec["profile"]))
                dt = time.time() - t0
                status = rec["status"]
                counts[status] = counts.get(status, 0) + 1
                line = (f"{arch:24s} {shape:12s} {'2x16x16' if mp else '16x16':8s} "
                        f"{status:8s} {dt:6.1f}s")
                if status == "ok":
                    r = rec["roofline"]
                    frac = r.get("memory_roofline_fraction", r.get("roofline_fraction", 0))
                    line += (f" bottleneck={r['bottleneck'][:-2]:12s}"
                             f" roofline={frac:.3f}"
                             f" mem/dev={mem_per_device_gib(rec):.2f}GiB")
                elif status == "skipped":
                    line += f" ({rec['reason'][:60]})"
                else:
                    n_fail += 1
                    line += f" {rec['error'][:120]}"
                print(line, flush=True)
    print(f"[dryrun] {counts} in {time.time() - t_sweep:.1f} s", flush=True)
    if session.finalize(os.path.join(args.out, "talp")) is not None:
        print(f"[dryrun] TALP record: {session.last_record_path}", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
