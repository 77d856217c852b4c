"""The rank program of ``tests/test_torch_distributed.py``: one process a
rank, ``gloo`` on the CPU, meeting through a ``FileStore`` in the test's
temporary directory (never a fixed port, so parallel test workers cannot
clash). It imports no JAX: the test hands it the JAX states as torch
files and reads back what each rank writes.

    python tests/torch_mesh_ranks.py PHASE RANK WORLD DIR

Phases: ``four`` (4 ranks: the dense steps on (2, 2) and (4, 1), the
latter through the collectives ``gloo`` has for CUDA tensors, the MoE
step on (2, 2), a monitored ``TrainLoop`` on (2, 2), a checkpoint saved
from (2, 2)); ``two`` (2 ranks: that checkpoint restored on (2, 1), the
same blocks cut by ``reshard_state`` from the full leaves, saved again, a JAX checkpoint restored on (1, 2) and one step more, a
``TrainLoop`` at world size 2); ``back`` (4 ranks: the 2-rank save
restored on (2, 2)). Rank 0 writes ``DIR/out_PHASE.pt``.

The tensor-parallel phases of ``tests/test_torch_tensor_parallel.py``:
``tp4`` (4 ranks: glm4-9b's steps on (1, 4)) and ``tp2`` (2 ranks:
command-r-35b's steps on (1, 2); one step of every megatron arch on
(1, 2) from the weights the test hands over; a tinyllama step counted
by ``StepProfile.count``, with the shapes that reach the attention
kernel, the RMSNorm and the gathers).

The phases of ``tests/test_torch_ssm_parallel.py``: ``ssm2`` (2 ranks:
zamba2-2.7b's steps on (1, 2), mamba2 split over its SSM heads; a step
whose mamba2 projections are counted by ``StepProfile.count``) and
``ssm4`` (4 ranks: the same on (1, 4)). The phases of
``tests/test_torch_context_parallel.py``: ``cp2`` (2 ranks: gemma2-2b,
xlstm-350m, tinyllama-1.1b and qwen3-moe-30b-a3b under ``optimized_config``
on (1, 2) at B 1, where fsdp splits the sequence, and (but qwen3) at B 2,
where it splits the rows)
and ``cp4`` (4 ranks on (2, 2): gemma2 at B 1, the ``"data"`` peers on
the same row, and at B 2; tinyllama's megatron step at B 1).

The phases of ``tests/test_torch_serve_mesh.py``: ``sched2`` (2 ranks:
the scheduler's cases on (1, 2) and (2, 1)) and ``sched4`` (4 ranks: on
(2, 2) and (1, 4), and a chaos replay on (2, 2)), ``SCHED``'s rows: each
rank keeps the tokens, the counters, its pool and state blocks and the
shapes that reached the paged kernels' wrappers.
"""

from __future__ import annotations

import datetime
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.checkpoint.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs import optimized_config, smoke_config  # noqa: E402
from repro_torch.convert import from_jax_train_state  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.distributed import reshard_state, shard  # noqa: E402
from repro_torch.distributed.shard import gather_full  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.layers.common import tree_leaves, unflatten  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train.loop import LoopConfig, TrainLoop  # noqa: E402
from repro_torch.train.train import TrainConfig, make_train_step, train_state_pspecs  # noqa: E402

F32 = dict(compute_dtype_name="float32", param_dtype_name="float32")
MIXED = dict(compute_dtype_name="float32")  # bf16 parameters computed in fp32
# (name, arch, config, mesh (data, model), batch, seq, accum, steps)
STEPS = {
    "dense22": ("tinyllama-1.1b", F32, (2, 2), 4, 32, 1, 2),
    "dense41": ("tinyllama-1.1b", F32, (4, 1), 4, 32, 2, 2),
    "moe22": ("qwen3-moe-30b-a3b", MIXED, (2, 2), 4, 256, 1, 2),
}
LOOP = ("qwen3-moe-30b-a3b", MIXED, 4, 32, 3)  # arch, config, batch, seq, steps
# tensor parallel over "model": glm4's 2 kv heads do not divide 4;
# command-r ties its embedding
TP_STEPS = {
    "glm4_14": ("glm4-9b", F32, (1, 4), 4, 32, 1, 2),
    "commandr_12": ("command-r-35b", F32, (1, 2), 4, 32, 1, 2),
}
# every arch whose smoke config takes the megatron strategy on (1, 2)
MEGATRON_ARCHS = ("tinyllama-1.1b", "glm4-9b", "command-r-35b", "llava-next-mistral-7b",
                  "hubert-xlarge", "qwen3-moe-30b-a3b", "dbrx-132b", "zamba2-2.7b")
# mamba2 split over "model" (16 SSM heads)
SSM_STEPS = {
    "zamba2_12": ("zamba2-2.7b", F32, (1, 2), 2, 32, 1, 2),
    "zamba2_14": ("zamba2-2.7b", F32, (1, 4), 2, 32, 1, 2),
}
# fsdp on a "model" axis: at B 1 the batch cannot split over it and the
# ranks split the sequence; at B 2 they split the rows. gemma2's window is
# cut to 8 so that it bites at S 32; "optimized" takes optimized_config
OPT = dict(F32, optimized=True)
GEMMA2 = dict(F32, window=8)
CP_STEPS = {
    "gemma2_cp": ("gemma2-2b", GEMMA2, (1, 2), 1, 32, 1, 2),
    "xlstm_cp": ("xlstm-350m", F32, (1, 2), 1, 32, 1, 2),
    "tinyllama_opt_cp": ("tinyllama-1.1b", OPT, (1, 2), 1, 32, 1, 2),
    "gemma2_rows": ("gemma2-2b", GEMMA2, (1, 2), 2, 32, 1, 2),
    "xlstm_rows": ("xlstm-350m", F32, (1, 2), 2, 32, 1, 2),
    "tinyllama_opt_rows": ("tinyllama-1.1b", OPT, (1, 2), 2, 32, 1, 2),
    "gemma2_cp22": ("gemma2-2b", GEMMA2, (2, 2), 1, 32, 1, 2),
    "gemma2_cp22_b2": ("gemma2-2b", GEMMA2, (2, 2), 2, 32, 1, 2),
    "tinyllama_tp22": ("tinyllama-1.1b", F32, (2, 2), 1, 32, 1, 2),
    # the MoE FFN under context parallelism: the gathered sequence routed
    # as its data shard's one group
    "qwen3_opt_cp": ("qwen3-moe-30b-a3b", OPT, (1, 2), 1, 32, 1, 2),
}


# the one-shot serving steps on a mesh: (arch, config, mesh, batch, prompt,
# max_len, decode steps); gemma2's window cut to 8 bites at the prompt
ONESHOT = {
    "tinyllama_12": ("tinyllama-1.1b", F32, (1, 2), 2, 16, 32, 4),
    "gemma2_12": ("gemma2-2b", GEMMA2, (1, 2), 2, 16, 32, 4),
    "zamba2_12": ("zamba2-2.7b", F32, (1, 2), 2, 16, 32, 4),
    "hubert_12": ("hubert-xlarge", F32, (1, 2), 2, 16, 0, 0),
    "tinyllama_22": ("tinyllama-1.1b", F32, (2, 2), 2, 16, 32, 4),
    "glm4_14": ("glm4-9b", F32, (1, 4), 2, 16, 32, 4),
}


# the scheduler on a mesh: (arch, config, mesh, ServeConfig fields, whole):
# 4 slots over a pool of 24 pages of 4 tokens, which the test's 8 requests
# behind one system prompt (copy-on-write hits) outgrow, so it preempts;
# ``whole``: the model holds the whole weights and the scheduler takes the
# mesh (the serve launcher's way; the "model" axis 1)
PRESSURE = dict(max_len=64, batch=4, prefill_chunk=8, page_size=4, num_pages=14,
                prefix_cache=True)
SAMPLED = dict(greedy=False, temperature=0.8, top_k=50, sample_seed=3)
# a verify of 5 tokens a row: RowParallel on (1, 2); zamba2's of 4 tiles its
# recurrent chunk. A one-token match drafts often enough on random weights
SPEC = dict(spec_decode=True, spec_k=4, spec_min_match=1)
SPEC3 = dict(spec_decode=True, spec_k=3, spec_min_match=1)
CHAOS = dict(max_len=64, batch=4, prefill_chunk=8, page_size=4, num_pages=32,
             prefix_cache=True, checksum_pages=True)
CHAOS_FAULTS = dict(seed=1, n_hang=0, corrupt_mode="bitflip", horizon_ticks=24)
CHAOS_TRAFFIC = dict(n_requests=10, arrival="burst", rate=0.8, seed=2)
SCHED = {
    "tinyllama_12": ("tinyllama-1.1b", F32, (1, 2), PRESSURE, False),
    "tinyllama_12_sampled": ("tinyllama-1.1b", F32, (1, 2), {**PRESSURE, **SAMPLED}, False),
    "tinyllama_12_spec": ("tinyllama-1.1b", F32, (1, 2), {**PRESSURE, **SPEC}, False),
    "zamba2_12": ("zamba2-2.7b", F32, (1, 2), {**PRESSURE, **SPEC3}, False),
    "zamba2_21": ("zamba2-2.7b", F32, (2, 1), {**PRESSURE, **SPEC3}, True),
    "qwen3_12": ("qwen3-moe-30b-a3b", F32, (1, 2), PRESSURE, False),
    "gemma2_12": ("gemma2-2b", F32, (1, 2), PRESSURE, False),
    "tinyllama_22": ("tinyllama-1.1b", F32, (2, 2), PRESSURE, False),
    "tinyllama_22_sampled": ("tinyllama-1.1b", F32, (2, 2), {**PRESSURE, **SAMPLED}, False),
    "glm4_14": ("glm4-9b", F32, (1, 4), PRESSURE, False),
    "chaos_22": ("tinyllama-1.1b", F32, (2, 2), CHAOS, False),
}


def tcfg() -> TrainConfig:
    return TrainConfig(optimizer=AdamWConfig(), warmup_steps=1, total_steps=10)


def data_for(cfg, batch, seq, accum) -> SyntheticLM:
    return SyntheticLM(DataConfig(global_batch=batch, seq_len=seq, vocab=cfg.vocab,
                                  accum_steps=accum, pad_fraction=0.2))


def full_tree(state) -> dict:
    """The state gathered to full leaves, on the CPU (every rank takes part)."""
    sh = dict(tree_leaves(state.shardings()))
    return {p: (gather_full(t.detach(), sh[p]).cpu().clone()
                if isinstance(t, torch.Tensor) else t)
            for p, t in tree_leaves(state.tree())}


def held(state, full0: dict, mesh, cfg) -> dict:
    """This rank's bytes and whether each block is the slice of ``full0`` that
    its placement names."""
    sh = dict(tree_leaves(state.shardings()))
    nbytes, exact = 0, True
    for p, t in tree_leaves(state.tree()):
        if isinstance(t, torch.Tensor):
            nbytes += t.numel() * t.element_size()
            if p in full0:
                exact &= torch.equal(sh[p].local(full0[p]), t.detach().cpu())
    return {"bytes": nbytes, "exact": exact, "coords": mesh.coords(),
            "pspecs": dict(tree_leaves(train_state_pspecs(cfg, mesh, tcfg())))}


def config_for(arch, kw):
    """``arch``'s smoke config with ``kw``; ``optimized`` applies
    ``optimized_config`` to it."""
    kw = dict(kw)
    opt = kw.pop("optimized", False)
    cfg = smoke_config(arch).replace(**kw)
    return optimized_config(arch, cfg) if opt else cfg


def run_steps(name, init, out, rank, table=STEPS, seen=None):
    """``table[name]``'s steps on its mesh from ``init[name]``; rank 0 keeps
    the metrics, each rank's holdings and the gathered final state. With
    ``seen``, each rank's shapes and positions that reach the attention
    kernel's wrapper."""
    arch, kw, shape, B, S, A, steps = table[name]
    cfg = config_for(arch, kw)
    mesh = make_host_mesh(model=shape[1], device="cpu")
    assert mesh.sizes == {"data": shape[0], "model": shape[1]}
    state = from_jax_train_state(init[name], cfg, mesh=mesh)
    start = {p: t for p, t in tree_leaves(_state_tree(init[name]))}
    info = held(state, start, mesh, cfg)
    step = make_train_step(cfg, tcfg(), mesh)
    data = data_for(cfg, B, S, A)
    hist = []
    flash = set()
    with _FlashSeen(flash if seen is not None else None):
        for i in range(steps):
            state, m = step(state, data.batch_at(i))
            hist.append({k: (v.detach().cpu().clone() if isinstance(v, torch.Tensor) else v)
                         for k, v in m.items()})
    infos, flashes = [None] * dist.get_world_size(), [None] * dist.get_world_size()
    dist.all_gather_object(infos, info)
    dist.all_gather_object(flashes, sorted(flash))
    res = {"hist": hist, "held": infos, "final": full_tree(state), "flash": flashes}
    if rank == 0:
        out[name] = res
    return state


def _state_tree(tree_np) -> dict:
    from repro_torch.convert import params_from_numpy

    return params_from_numpy({"params": tree_np["params"], "opt_state": {
        k: v for k, v in tree_np["opt_state"].items() if k != "step"}})


def run_loop(init, world, talp_dir, out, rank):
    arch, kw, B, S, steps = LOOP
    cfg = smoke_config(arch).replace(**kw)
    mesh = make_host_mesh(model=2 if world == 4 else 1, device="cpu")
    state = from_jax_train_state(init["loop"], cfg, mesh=mesh)
    data = SyntheticLM(DataConfig(global_batch=B, seq_len=S, vocab=cfg.vocab, pad_fraction=0.2))
    loop = TrainLoop(cfg, TrainConfig(), data, LoopConfig(steps=steps, lb_sample_every=1),
                     state=state, mesh=mesh)
    loop.run()
    loop.finalize_run(talp_dir)
    if rank == 0:
        out[f"loop{world}"] = {"path": loop.session.last_record_path,
                       "history": loop.metrics_history}


def restore(directory, cfg, mesh, init_tree):
    """A state on ``mesh`` restored from ``directory`` block by block."""
    state = from_jax_train_state(init_tree, cfg, mesh=mesh)
    tree, step = load_checkpoint(state.tree(), directory, shardings=state.shardings())
    state.load_tree(tree)
    return state, step


def arch_steps(init, out, rank):
    """One step of each megatron arch on (1, 2) from ``init["archs"]``'s
    weights and batch: the loss and ``grad_norm`` (the test holds them to
    the port's one-rank step)."""
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim import adamw_init
    from repro_torch.train.train import TrainState

    mesh = make_host_mesh(model=2, device="cpu")
    res = {}
    for arch, (params, batch) in init["archs"].items():
        cfg = smoke_config(arch).replace(**F32)
        model = Transformer(cfg, params, "cpu", mesh)
        state = TrainState(model, adamw_init(model.named_params(), tcfg().optimizer))
        _, m = make_train_step(cfg, tcfg(), mesh)(state, batch)
        res[arch] = {k: float(m[k]) for k in ("loss", "grad_norm")}
    if rank == 0:
        out["archs"] = res


def counted_step(out, rank):
    """tinyllama smoke (bf16) on (1, 2), one step under ``StepProfile.count``:
    the counted FLOPs per operator, and the shapes that reach the attention
    kernel's wrapper, the RMSNorm and the gathers."""
    from repro_torch.core.profile import StepProfile
    from repro_torch.layers import attention as A
    from repro_torch.layers import norms as N
    from repro_torch.train.train import init_state

    seen = {"flash": [], "rmsnorm": [], "gather": []}
    flash, norm, gather = A.flash_attention, N._rmsnorm_op, shard.gather

    def flash_seen(q, k, v, **kw):
        seen["flash"].append((tuple(q.shape), tuple(k.shape)))
        return flash(q, k, v, **kw)

    def norm_seen(x, *a):
        seen["rmsnorm"].append(tuple(x.shape))
        return norm(x, *a)

    def gather_seen(block, sh, sum_axes=()):
        full = gather(block, sh, sum_axes)
        seen["gather"].append((sh.spec, tuple(full.shape), tuple(sum_axes)))
        return full

    cfg = smoke_config("tinyllama-1.1b")
    mesh = make_host_mesh(model=2, device="cpu")
    state = init_state(cfg, tcfg(), seed=0, mesh=mesh)
    A.flash_attention, N._rmsnorm_op, shard.gather = flash_seen, norm_seen, gather_seen
    try:
        _, prof = StepProfile.count(make_train_step(cfg, tcfg(), mesh), state,
                                    data_for(cfg, 4, 32, 1).batch_at(0))
    finally:
        A.flash_attention, N._rmsnorm_op, shard.gather = flash, norm, gather
    if rank == 0:
        out["counted"] = {"flops": {k: c.flops for k, c in prof.per_computation.items()},
                          **seen}


class _FlashSeen:
    """While open, the (q, k) shapes, and the first and last query and key
    positions of row 0, that reach the attention kernel's wrapper go into
    ``into`` (nothing with ``into`` None)."""

    def __init__(self, into):
        self.into = into

    def __enter__(self):
        from repro_torch.layers import attention as A

        self.saved = flash = A.flash_attention
        if self.into is None:
            return self

        def seen(q, k, v, **kw):
            qp, kp = kw["q_positions"][0], kw["k_positions"][0]
            self.into.add((tuple(q.shape), tuple(k.shape), int(qp[0]), int(qp[-1]),
                           int(kp[0]), int(kp[-1])))
            return flash(q, k, v, **kw)

        A.flash_attention = seen
        return self

    def __exit__(self, *exc):
        from repro_torch.layers import attention as A

        A.flash_attention = self.saved
        return False


def counted_projections(init, out, rank):
    """zamba2 on (1, 2), one step from ``init["zamba2_12"]`` with each
    mamba2 projection counted by ``StepProfile.count``: rank 0 keeps the
    forward FLOPs of ``in_projection`` and ``out_projection``."""
    from repro_torch.layers import recurrent as R

    arch, kw, shape, B, S, A, _ = SSM_STEPS["zamba2_12"]
    cfg = config_for(arch, kw)
    mesh = make_host_mesh(model=shape[1], device="cpu")
    state = from_jax_train_state(init["zamba2_12"], cfg, mesh=mesh)
    flops, saved = count_projections(R)
    try:
        make_train_step(cfg, tcfg(), mesh)(state, data_for(cfg, B, S, A).batch_at(0))
    finally:
        R.in_projection, R.out_projection = saved
    if rank == 0:
        out["projections"] = flops


def count_projections(R):
    """Patch ``R.in_projection`` and ``R.out_projection`` to add each call's
    counted FLOPs (``StepProfile.count``) to the returned dict; returns
    (that dict, the original pair)."""
    from repro_torch.core.profile import StepProfile

    flops = {"in_proj": 0.0, "out_proj": 0.0}
    saved = (R.in_projection, R.out_projection)

    def counting(fn, key):
        def run(*a, **k):
            res, prof = StepProfile.count(fn, *a, **k)
            flops[key] += prof.flops
            return res
        return run

    R.in_projection = counting(saved[0], "in_proj")
    R.out_projection = counting(saved[1], "out_proj")
    return flops, saved


def run_oneshot(name, init, out, rank):
    """``ONESHOT[name]``: the prefill of ``init[name]``'s prompt and decode
    steps fed its tokens, on the case's mesh; rank 0 keeps the outputs and
    every rank's cache blocks (spare rows dropped) and kernel shapes. An
    encoder-only arch runs ``make_encoder_step`` instead."""
    from repro_torch.convert import from_jax_params
    from repro_torch.serve.serve import make_decode_step, make_encoder_step, make_prefill_step

    arch, kw, shape, B, S, max_len, steps = ONESHOT[name]
    cfg = config_for(arch, kw)
    mesh = make_host_mesh(model=shape[1], device="cpu")
    model = from_jax_params(init[name]["params"], cfg, "cpu", mesh)
    batch = {k: torch.from_numpy(v) for k, v in init[name]["batch"].items()}
    seen: set = set()
    res: dict = {}
    logits = recorded_logits(model)
    with _FlashSeen(seen), _LseSeen(seen):
        if cfg.encoder_only:
            res["tokens"] = make_encoder_step(model, mesh)(batch)
            res["logits"] = logits[0]
        else:
            caches = model.init_cache(B, max_len, paged=False)
            tok, caches = make_prefill_step(model, mesh)(batch, caches)
            res["tokens"] = [tok]
            decode = make_decode_step(model, mesh)
            for i, t in enumerate(init[name]["decode"]):
                tok, caches = decode(torch.from_numpy(t), S + i, caches)
                res["tokens"].append(tok)
            res["logits"] = logits
            blocks = {p: (t[:, :-1] if p.endswith(("/k", "/v")) else t).clone()
                      for p, t in tree_leaves(caches)}
    world = dist.get_world_size()
    got_blocks, got_seen = [None] * world, [None] * world
    dist.all_gather_object(got_seen, sorted(seen, key=repr))
    if not cfg.encoder_only:
        dist.all_gather_object(got_blocks, blocks)
    res["blocks"], res["seen"] = got_blocks, got_seen
    if rank == 0:
        out[name] = res


def recorded_logits(model) -> list:
    """The logits that ``model``'s ``prefill``, ``decode_step`` and
    ``apply_logits`` return from here on, in order, as the serving steps
    call them, made whole: the vocabulary's ranks' columns gathered
    (``vocab_gather``), then the rows' ranks' rows (``rows_gather``)."""
    import inspect

    from repro_torch.distributed.shard import rows_gather, vocab_gather
    from repro_torch.layers.common import NULL_CONSTRAINTS

    seen = []
    for name in ("prefill", "decode_step", "apply_logits"):
        fn = getattr(model, name)

        def rec(*a, _fn=fn, _sig=inspect.signature(fn), **k):
            out = _fn(*a, **k)
            lc = _sig.bind(*a, **k).arguments.get("lc", NULL_CONSTRAINTS)
            full = vocab_gather(out[0] if isinstance(out, tuple) else out, lc.tp)
            seen.append(full if lc.ranks is None else rows_gather(full, lc.ranks))
            return out
        setattr(model, name, rec)
    return seen


class _LseSeen:
    """While open, the (q, k) shapes and the first and last key positions of
    row 0 that reach the attention kernel's LSE wrapper go into ``into``,
    tagged ``"lse"``."""

    def __init__(self, into):
        self.into = into

    def __enter__(self):
        from repro_torch.layers import attention as A

        self.saved = fn = A.flash_attention_lse

        def seen(q, k, v, **kw):
            kp = kw["k_positions"][0]
            self.into.add(("lse", tuple(q.shape), tuple(k.shape), int(kp[0]), int(kp[-1])))
            return fn(q, k, v, **kw)

        A.flash_attention_lse = seen
        return self

    def __exit__(self, *exc):
        from repro_torch.layers import attention as A

        A.flash_attention_lse = self.saved
        return False


class _PagedSeen:
    """While open, the (q, pool) shapes that reach the paged kernels'
    wrappers go into ``into``, tagged ``"decode"`` or ``"chunk"``."""

    def __init__(self, into):
        self.into = into

    def __enter__(self):
        from repro_torch.layers import attention as A

        self.saved = A.paged_attention, A.paged_prefill_attention

        def tagged(fn, tag):
            def seen(q, k, v, *a, **kw):
                self.into.add((tag, tuple(q.shape), tuple(k.shape)))
                return fn(q, k, v, *a, **kw)
            return seen

        A.paged_attention = tagged(self.saved[0], "decode")
        A.paged_prefill_attention = tagged(self.saved[1], "chunk")
        return self

    def __exit__(self, *exc):
        from repro_torch.layers import attention as A

        A.paged_attention, A.paged_prefill_attention = self.saved
        return False


def sched_observe(sched) -> dict:
    """What a scheduler run must agree on with JAX's: every request's
    tokens and status, and the counters of ``kv_cache_stats``."""
    kv = sched.kv_cache_stats()
    return {
        "tokens": {r["id"]: r["generated"] for r in sched.completed},
        "status": {rid: r["_status"] for rid, r in sched._by_id.items()},
        "kv": {k: kv.get(k) for k in ("speculation", "pressure", "recovery",
                                      "prefix_cache", "pages_in_use", "peak_used_pages",
                                      "shared_pages")},
        "kv_bytes": kv["kv_bytes"],
        "stats": {k: sched.stats[k] for k in ("decode_steps", "prefill_chunks",
                                              "spec_dispatches", "resumes", "preemptions",
                                              "retries")},
    }


def sched_drive(sched, name, vocab, faults_mod, traffic_mod, case) -> dict:
    """``SCHED[name]``'s work through a scheduler of either package (its
    ``serve.faults`` and ``serve.traffic`` modules given): ``case``'s
    prompts, or for the chaos case the seeded traffic and faults.
    Returns ``sched_observe``."""
    if name.startswith("chaos"):
        workload = traffic_mod.generate_workload(traffic_mod.TrafficConfig(
            **CHAOS_TRAFFIC, vocab_hi=vocab))
        traffic_mod.replay(sched, workload, faults=faults_mod.FaultInjector(
            faults_mod.FaultConfig(**CHAOS_FAULTS)))
    else:
        for rid, p in enumerate(case["prompts"]):
            sched.submit(list(p), request_id=rid, max_new=case["max_new"])
        sched.drain()
    return sched_observe(sched)


def run_sched(name, init, out, rank):
    """``SCHED[name]``: the scheduler on the case's mesh over ``init[name]``'s
    weights, through its prompts (or, for the chaos case, the seeded
    traffic and faults); rank 0 keeps the observations, every rank's blocks
    of the caches (the spare page dropped) and the paged kernels' shapes,
    and the page fingerprints (every rank computes them: a collective)."""
    from repro_torch.convert import from_jax_params
    from repro_torch.serve import faults as F
    from repro_torch.serve import traffic
    from repro_torch.serve.serve import BatchScheduler, ServeConfig

    arch, kw, shape, scfg, whole = SCHED[name]
    cfg = config_for(arch, kw)
    mesh = make_host_mesh(model=shape[1], device="cpu")
    assert mesh.sizes == {"data": shape[0], "model": shape[1]}
    model = from_jax_params(init[name]["params"], cfg, "cpu", None if whole else mesh)
    seen: set = set()
    with _PagedSeen(seen):
        sched = BatchScheduler(model, ServeConfig(**scfg), mesh=mesh)
        res = sched_drive(sched, name, cfg.vocab, F, traffic, init[name])
    res["fingerprints"] = [F.page_fingerprint(sched.caches, p, sched._kv_heads)
                           for p in range(scfg["num_pages"])]
    blocks = {p: (t[:, :-1] if "pages" in p else t).clone()
              for p, t in tree_leaves(sched.caches)}
    world = dist.get_world_size()
    got_blocks, got_seen = [None] * world, [None] * world
    dist.all_gather_object(got_blocks, blocks)
    dist.all_gather_object(got_seen, sorted(seen))
    res["blocks"], res["seen"] = got_blocks, got_seen
    if rank == 0:
        out[name] = res


gloo_cuda = shard._gloo_cuda


def main() -> None:
    phase, rank, world, d = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store_{phase}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    init = torch.load(os.path.join(d, "init.pt"), weights_only=False)
    out: dict = {}
    if phase == "four":
        state = run_steps("dense22", init, out, rank)
        save_checkpoint(state.tree(), os.path.join(d, "ck4"), 2, shardings=state.shardings())
        # (4, 1) takes the collectives gloo has for CUDA tensors (a list
        # all-gather; the reduce-scatter as an all-reduce and a slice): the
        # path of two ranks sharing one card
        shard._gloo_cuda = lambda t, group: True
        run_steps("dense41", init, out, rank)
        shard._gloo_cuda = gloo_cuda
        run_steps("moe22", init, out, rank)
        run_loop(init, world, os.path.join(d, "talp", "qwen3", "train"), out, rank)
    elif phase == "two":
        cfg = smoke_config("tinyllama-1.1b").replace(**F32)
        state, step = restore(os.path.join(d, "ck4"), cfg, make_host_mesh(device="cpu"),
                              init["dense22"])
        out["from4"] = {"step": step, "final": full_tree(state)}
        # the same blocks from the full leaves through reshard_state
        full = unflatten(out["from4"]["final"])
        placed = reshard_state(full, state.model.mesh, train_state_pspecs(cfg, state.model.mesh,
                                                                          tcfg()))
        out["from4"]["reshard_equal"] = all(
            torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
            for (_, a), (_, b) in zip(tree_leaves(placed), tree_leaves(state.tree())))
        save_checkpoint(state.tree(), os.path.join(d, "ck2"), step, shardings=state.shardings())
        state, step = restore(os.path.join(d, "jax_ckpt"), cfg,
                              make_host_mesh(model=2, device="cpu"), init["dense22"])
        out["from_jax"] = {"step": step, "final": full_tree(state)}
        data = data_for(cfg, 4, 32, 1)
        state, m = make_train_step(cfg, tcfg(), state.model.mesh)(state, data.batch_at(step))
        out["from_jax"]["loss"] = float(m["loss"])
        run_loop(init, world, os.path.join(d, "talp", "qwen3", "train"), out, rank)
    elif phase == "tp4":
        run_steps("glm4_14", init, out, rank, TP_STEPS)
    elif phase == "tp2":
        run_steps("commandr_12", init, out, rank, TP_STEPS)
        arch_steps(init, out, rank)
        counted_step(out, rank)
    elif phase in ("ssm2", "ssm4"):
        run_steps("zamba2_1" + phase[-1], init, out, rank, SSM_STEPS, seen=True)
        if phase == "ssm2":
            counted_projections(init, out, rank)
    elif phase in ("cp2", "cp4"):
        for name, row in CP_STEPS.items():
            if row[2][0] * row[2][1] == world:
                run_steps(name, init, out, rank, CP_STEPS, seen=True)
    elif phase in ("oneshot2", "oneshot4"):
        for name, row in ONESHOT.items():
            if row[2][0] * row[2][1] == world:
                run_oneshot(name, init, out, rank)
    elif phase in ("sched2", "sched4"):
        for name, row in SCHED.items():
            if row[2][0] * row[2][1] == world and name in init:
                run_sched(name, init, out, rank)
    elif phase == "back":
        cfg = smoke_config("tinyllama-1.1b").replace(**F32)
        state, step = restore(os.path.join(d, "ck2"), cfg,
                              make_host_mesh(model=2, device="cpu"), init["dense22"])
        out["from2"] = {"step": step, "final": full_tree(state)}
    if rank == 0:
        torch.save(out, os.path.join(d, f"out_{phase}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
