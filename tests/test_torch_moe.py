"""The Mixture-of-Experts archs through the port against the JAX package, on the CPU.

qwen3-moe-30b-a3b (qk-norm, 128 experts, top 8) and dbrx-132b (16
experts, top 4, GQA group 6), each on its fp32 smoke config (8 experts,
top 2) with weights drawn by ``jax.random`` and converted leaf for leaf:

(a) ``router_topk`` against the JAX one, both ``normalize`` settings, and
    with a zeroed router, where every logit ties and JAX picks experts
    ``0..K-1``;
(b) ``_dispatch_group`` and ``moe_block`` against the JAX ones at 320
    tokens with a router column biased so that pairs drop past capacity
    (JAX drops them too, the same ones), with and without a shared expert;
    ``expert_load``, ``moe_lb_loss`` and ``moe_z_loss`` against JAX's;
(c) for both archs: full-sequence logits; paged prefill chunks and decode
    steps (padding and idle slots routed, as in JAX); the loss with the
    router's lb and z terms and the per-leaf gradients (gated as in
    ``test_torch_archs.py``); one train step; a bf16 ``TrainLoop`` whose
    per-step ``expert_load`` equals JAX's and whose record's ``expert_lb``
    equals JAX's within 1e-6; both launchers with ``--smoke --device cpu``;
(d) ``layers.common.init_params``: tinyllama's smoke tree drawn bitwise as
    one draw per leaf, and a leaf above a lowered threshold drawn slice by
    slice (shape, dtype, each slice's moments).

Tolerance: 2e-5 for the MoE functions, 1e-4 for the models (fp32), as in
``test_torch_archs.py``.
"""

import dataclasses
import functools
import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as smoke_j  # noqa: E402
from repro.layers import ffn as FJ  # noqa: E402
from repro.models import transformer as TJ  # noqa: E402
from repro_torch.configs import smoke_config as smoke_t  # noqa: E402
from repro_torch.convert import from_jax_train_state, params_from_numpy  # noqa: E402
from repro_torch.layers import ffn as FT  # noqa: E402
from repro_torch.layers.common import tree_leaves  # noqa: E402

ARCHS = ["qwen3-moe-30b-a3b", "dbrx-132b"]
F32 = dict(compute_dtype_name="float32", param_dtype_name="float32")
# bf16 parameters (the JAX loop cannot train fp32 ones) computed in fp32:
# in bf16 compute the packages' elementwise ops round apart (XLA's silu
# and tanh-gelu against PyTorch's differ in 28-42% of bf16 outputs), so
# router near ties flip and the counts part
MIXED = dict(compute_dtype_name="float32")
FN_TOL, TOL = 2e-5, 1e-4
B, S = 2, 40


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(arch, **kw):
    kw = dict(F32, **kw)
    return smoke_j(arch).replace(**kw), smoke_t(arch).replace(**kw)


# ---------------------------------------------------------------------------
# (a) the router's top-k
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("zero", [False, True], ids=["random", "zero_router"])
@pytest.mark.parametrize("normalize", [True, False])
def test_router_topk_matches_jax(normalize, zero):
    rng = np.random.default_rng(0)
    logits = np.zeros((64, 8), np.float32) if zero else rng.standard_normal((64, 8)).astype(
        np.float32)
    wj, ej = FJ.router_topk(jnp.asarray(logits), 3, normalize)
    wt, et = FT.router_topk(torch.from_numpy(logits), 3, normalize)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=FN_TOL, rtol=FN_TOL)
    if zero:  # every logit ties: experts 0..K-1, lowest index first
        assert (et.numpy() == np.arange(3)).all()


# ---------------------------------------------------------------------------
# (b) dispatch and the MoE block
# ---------------------------------------------------------------------------


N_DROP = 320  # > 128 tokens: below, C = n and nothing can drop


def _moe_inputs(shared: int = 0):
    """The qwen3 smoke config (fp32) with ``shared`` shared experts, JAX
    MoE weights (router column 0 biased so that every token picks expert 0
    first) and (1, N_DROP, d) inputs with a positive mean."""
    from repro.layers.common import init_params

    cfg_j, cfg_t = _cfgs("qwen3-moe-30b-a3b")
    cfg_j = cfg_j.replace(moe=dataclasses.replace(cfg_j.moe, n_shared_experts=shared))
    cfg_t = cfg_t.replace(moe=dataclasses.replace(cfg_t.moe, n_shared_experts=shared))
    params = jax.tree_util.tree_map(
        np.array, init_params(FJ.moe_params(cfg_j), jax.random.PRNGKey(1), jnp.float32))
    params["router"][:, 0] += 0.05
    x = (np.random.default_rng(2).standard_normal((1, N_DROP, cfg_j.d_model)) + 1.0)
    return cfg_j, cfg_t, params, x.astype(np.float32)


def test_dispatch_group_drops_the_pairs_jax_drops():
    cfg_j, _, params, x = _moe_inputs()
    m = cfg_j.moe
    E, K, C = m.n_experts, m.top_k, m.capacity(N_DROP)
    xt = x[0]
    logits = xt @ params["router"]
    out_j = FJ._dispatch_group(jnp.asarray(xt), jnp.asarray(logits), E, K, C,
                               m.normalize_topk, jnp.float32)
    out_t = FT._dispatch_group(torch.from_numpy(xt), torch.from_numpy(logits), E, K, C,
                               m.normalize_topk, torch.float32)
    xbuf_j, st_j, sw_j, keep_j, slot_j, counts_j = (np.asarray(a) for a in out_j)
    xbuf_t, st_t, sw_t, keep_t, slot_t, counts_t = (a.numpy() for a in out_t)
    assert C == 128 and counts_j[0] == N_DROP
    assert (~keep_j).sum() == np.maximum(counts_j - C, 0).sum() >= N_DROP - C
    for got, want in ((st_t, st_j), (keep_t, keep_j), (slot_t, slot_j), (counts_t, counts_j)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(sw_t, sw_j, atol=FN_TOL, rtol=FN_TOL)
    np.testing.assert_allclose(xbuf_t, xbuf_j, atol=FN_TOL, rtol=FN_TOL)


@pytest.mark.parametrize("shared", [0, 1])
def test_moe_block_and_its_aux_match_jax(shared):
    cfg_j, cfg_t, params, x = _moe_inputs(shared)
    out_j, aux_j = FJ.moe_block(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
                                cfg_j)
    out_t, aux_t = FT.moe_block(params_from_numpy(params), torch.from_numpy(x), cfg_t)
    assert ("shared" in params) == bool(shared)
    assert float(aux_j["expert_load"][0]) == N_DROP  # expert 0 is past capacity
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=FN_TOL, rtol=FN_TOL)
    np.testing.assert_array_equal(aux_t["expert_load"].numpy(), np.asarray(aux_j["expert_load"]))
    assert aux_t["expert_load"].dtype == torch.float32
    for k in ("moe_lb_loss", "moe_z_loss"):
        assert float(aux_t[k]) == pytest.approx(float(aux_j[k]), rel=FN_TOL)


def test_capacity_is_the_jax_one():
    cfg_j, cfg_t = _cfgs("qwen3-moe-30b-a3b")
    for n in (1, 4, 64, 129, 320, 4096, 100_000):
        assert cfg_t.moe.capacity(n) == cfg_j.moe.capacity(n)


# ---------------------------------------------------------------------------
# (c) the MoE archs
# ---------------------------------------------------------------------------


@functools.cache
def _jax_state(arch, dtype=None):
    from repro.train.train import TrainConfig as TrainConfigJ
    from repro.train.train import init_state

    cfg_j = smoke_j(arch) if dtype == "bf16" else _cfgs(arch)[0]
    return _np_tree(init_state(cfg_j, TrainConfigJ(), jax.random.PRNGKey(0)).tree())


def _params_j(arch):
    return jax.tree_util.tree_map(jnp.asarray, _jax_state(arch)["params"])


def _port_state(arch):
    return from_jax_train_state(_jax_state(arch), _cfgs(arch)[1], "cpu")


def _batch(arch, seed=3):
    cfg_j, _ = _cfgs(arch)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg_j.vocab, size=(B, S)).astype(np.int32)
    labels[:, ::7] = -1
    return {"tokens": rng.integers(4, cfg_j.vocab, size=(B, S)).astype(np.int32),
            "labels": labels}


def _to_j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_logits_and_router_totals_match_jax(arch):
    cfg_j, _ = _cfgs(arch)
    batch = _batch(arch)
    batch.pop("labels")
    logits_j, aux_j = TJ.apply_logits(_params_j(arch), _to_j(batch), cfg_j)
    with torch.no_grad():
        logits_t, aux_t = _port_state(arch).model.apply_logits(params_from_numpy(batch))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(aux_t["expert_load"].numpy(), np.asarray(aux_j["expert_load"]))
    assert float(aux_t["expert_load"].sum()) == cfg_j.n_layers * B * S * cfg_j.moe.top_k


PAGE, CHUNK, MAX_LEN, N_PAGES = 4, 12, 48, 24


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunks_and_decode_steps_match_jax(arch):
    """Two ragged chunks (padding routed in both packages) and 4 decode
    steps with one slot idle every other step, over the paged pool."""
    cfg_j, _ = _cfgs(arch)
    params = _params_j(arch)
    model = _port_state(arch).model
    rng = np.random.default_rng(11)
    tbl = np.full((B, MAX_LEN // PAGE), -1, np.int32)
    perm = rng.permutation(N_PAGES)
    tbl[0, :9], tbl[1, :9] = perm[:9], perm[9:18]
    caches_j = TJ.init_cache(cfg_j, B, MAX_LEN, paged=True, page_size=PAGE, num_pages=N_PAGES)
    caches_t = model.init_cache(B, MAX_LEN, page_size=PAGE, num_pages=N_PAGES)
    tbl_j, tbl_t = jnp.asarray(tbl), torch.from_numpy(tbl)
    lengths = np.asarray([CHUNK, 9], np.int32)
    errs = []
    for start, all_logits in ((np.zeros(B, np.int32), False), (lengths.copy(), True)):
        toks = rng.integers(4, cfg_j.vocab, size=(B, CHUNK)).astype(np.int32)
        lj, caches_j = TJ.prefill_chunk(
            params, {"tokens": jnp.asarray(toks)}, cfg_j, caches_j, jnp.asarray(start),
            jnp.asarray(lengths), block_tables=tbl_j, all_logits=all_logits)
        lt = model.prefill_chunk(torch.from_numpy(toks), caches_t, torch.from_numpy(start),
                                 torch.from_numpy(lengths), tbl_t, all_logits=all_logits)
        if all_logits:
            lj, lt = lj[:, :int(lengths.min())], lt[:, :int(lengths.min())]
        errs.append(np.abs(lt.numpy() - np.asarray(lj)).max())
    pos = 2 * lengths
    active = np.asarray([True, False])
    for _ in range(4):
        toks = rng.integers(4, cfg_j.vocab, size=(B, 1)).astype(np.int32)
        lj, caches_j = TJ.decode_step(params, jnp.asarray(toks), jnp.asarray(pos), cfg_j,
                                      caches_j, active=jnp.asarray(active),
                                      block_tables=tbl_j)
        lt = model.decode_step(torch.from_numpy(toks), torch.from_numpy(pos), caches_t,
                               active=torch.from_numpy(active), block_tables=tbl_t)
        errs.append(np.abs(lt.numpy() - np.asarray(lj)).max())
        pos = pos + active
        active = ~active
    assert max(errs) < TOL * max(1.0, float(np.abs(np.asarray(lj)).max())), errs


# as test_torch_archs.py: each leaf within GRAD_TOL of its own largest
# |value| in JAX's run, GRAD_FLOOR of the largest leaf's at least
GRAD_TOL, GRAD_FLOOR = 2e-3, 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_with_router_terms_and_gradients_match_jax(arch):
    cfg_j, _ = _cfgs(arch)
    batch = _batch(arch)
    (loss_j, aux_j), grads_j = jax.value_and_grad(
        lambda p: TJ.forward(p, _to_j(batch), cfg_j), has_aux=True)(_params_j(arch))
    model = _port_state(arch).model
    loss_t, aux_t = model(params_from_numpy(batch))
    leaves = model.named_params()
    grads_t = torch.autograd.grad(loss_t, list(leaves.values()))
    assert float(loss_t) == pytest.approx(float(loss_j), rel=TOL)
    for k in ("moe_lb_loss", "moe_z_loss"):
        assert float(aux_t[k]) == pytest.approx(float(aux_j[k]), rel=FN_TOL)
    ce_only = float(loss_j) - (cfg_j.moe_lb_coef * float(aux_j["moe_lb_loss"])
                               + cfg_j.moe_z_coef * float(aux_j["moe_z_loss"])) / cfg_j.n_layers
    assert abs(float(loss_t) - ce_only) > 1e-3  # the router's terms are in
    np.testing.assert_array_equal(aux_t["expert_load"].numpy(), np.asarray(aux_j["expert_load"]))
    gj = dict(tree_leaves(_np_tree(grads_j)))
    assert set(gj) == set(leaves)
    assert any(p.endswith("moe/router") for p in gj)
    assert any(p.endswith("attn/q_norm") for p in gj) == cfg_j.qk_norm
    top = max(float(np.abs(g).max()) for g in gj.values())
    for (path, _), g in zip(leaves.items(), grads_t):
        scale = float(np.abs(gj[path]).max())
        assert scale > 0, path
        err = float(np.abs(g.numpy() - gj[path]).max())
        assert err <= GRAD_TOL * max(scale, GRAD_FLOOR * top), (path, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_jax(arch):
    """Each package's train step from the same state, two steps on one
    batch (warmup 1): losses within 1e-4, the gradient norm within 1e-3,
    the router's metrics equal, the displacement within 2e-2 in relative
    L2 norm (``test_torch_archs.py``'s bound)."""
    from repro.launch.mesh import make_host_mesh
    from repro.train.train import TrainConfig as TrainConfigJ
    from repro.train.train import compile_train_step
    from repro_torch.train.train import TrainConfig, make_train_step

    cfg_j, cfg_t = _cfgs(arch)
    batch = {k: v[None] for k, v in _batch(arch).items()}
    state_j = jax.tree_util.tree_map(jnp.asarray, _jax_state(arch))
    _, call = compile_train_step(cfg_j, make_host_mesh(),
                                 TrainConfigJ(warmup_steps=1, total_steps=10), state_j,
                                 _to_j(batch))
    state_t = _port_state(arch)
    step = make_train_step(cfg_t, TrainConfig(warmup_steps=1, total_steps=10))
    for _ in range(2):
        state_j, mj = call(state_j, _to_j(batch))
        state_t, mt = step(state_t, params_from_numpy(batch))
        assert float(mt["loss"]) == pytest.approx(float(mj["loss"]), rel=TOL)
        np.testing.assert_array_equal(mt["expert_load"].numpy(), np.asarray(mj["expert_load"]))
        assert float(mt["moe_lb_loss"]) == pytest.approx(float(mj["moe_lb_loss"]), rel=FN_TOL)
    assert float(mt["grad_norm"]) == pytest.approx(float(mj["grad_norm"]), rel=1e-3)
    pj = dict(tree_leaves(_np_tree(state_j["params"])))
    p0 = dict(tree_leaves(_jax_state(arch)["params"]))
    err2 = ref2 = 0.0
    for path, p in state_t.model.named_params().items():
        moved = pj[path] - p0[path]
        err2 += float(np.sum((p.detach().numpy() - p0[path] - moved) ** 2))
        ref2 += float(np.sum(moved ** 2))
    assert np.sqrt(err2 / ref2) < 2e-2


def _recording(loop, seen: list):
    """Wrap ``loop._observe`` (read by ``_initialize`` when the loop runs)
    to keep each step's ``expert_load``."""
    inner = loop._observe

    def observe(out):
        obs = inner(out)
        seen.append(np.asarray(obs["expert_load"], np.float64))
        return obs

    loop._observe = observe


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_param_train_loop_expert_load_and_record_match_jax(arch, tmp_path):
    """Both ``TrainLoop``s on the smoke config with bf16 parameters (the JAX
    loop cannot train fp32 ones) computed in fp32 (``MIXED``), from the same
    state and batches: each step's ``expert_load`` equal, then the record's
    ``expert_lb`` within 1e-6 and its ``expert_load_balance`` below 1 (not
    the default)."""
    from repro.core.records import RunRecord
    from repro.data.pipeline import DataConfig as DataConfigJ
    from repro.data.pipeline import SyntheticLM as SyntheticLMJ
    from repro.launch.mesh import make_host_mesh
    from repro.train.loop import LoopConfig as LoopConfigJ
    from repro.train.loop import TrainLoop as TrainLoopJ
    from repro.train.train import TrainConfig as TrainConfigJ
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train.loop import LoopConfig, TrainLoop
    from repro_torch.train.train import TrainConfig

    steps, data = 3, dict(global_batch=2, seq_len=32, vocab=512, pad_fraction=0.05)
    cfg_j, cfg_t = smoke_j(arch).replace(**MIXED), smoke_t(arch).replace(**MIXED)
    loop_j = TrainLoopJ(cfg_j, make_host_mesh(), TrainConfigJ(total_steps=steps),
                        SyntheticLMJ(DataConfigJ(**data)),
                        LoopConfigJ(steps=steps, lb_sample_every=1))
    loop_t = TrainLoop(cfg_t, TrainConfig(total_steps=steps), SyntheticLM(DataConfig(**data)),
                       LoopConfig(steps=steps, lb_sample_every=1), device="cpu",
                       state=from_jax_train_state(_jax_state(arch, "bf16"), cfg_t, "cpu"))
    seen_j, seen_t = [], []
    _recording(loop_j, seen_j)
    _recording(loop_t, seen_t)
    loop_j.run().finalize_run(str(tmp_path / "jax"))
    loop_t.run().finalize_run(str(tmp_path / "torch"))
    assert len(seen_t) == len(seen_j) == steps
    for a, b in zip(seen_t, seen_j):
        np.testing.assert_array_equal(a, b)
    recs = {k: RunRecord.load(*glob.glob(os.path.join(tmp_path, k, "talp_*.json")))
            for k in ("jax", "torch")}
    lb_j = recs["jax"].regions["train_step"].measurements.expert_lb
    lb_t = recs["torch"].regions["train_step"].measurements.expert_lb
    assert lb_t == pytest.approx(lb_j, abs=1e-6)
    factor = recs["torch"].regions["train_step"].pop["expert_load_balance"]
    assert 0 < factor < 1 and factor == pytest.approx(lb_t, abs=1e-12)


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_run_the_moe_arch_on_the_cpu(arch, capsys, tmp_path):
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main

    assert train_main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                       "--global-batch", "2", "--seq-len", "32",
                       "--talp-out", str(tmp_path)]) == 0
    assert f"[launch] {arch} on cpu: steps 0..1" in capsys.readouterr().out
    assert serve_main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "2",
                       "--max-new", "4"]) == 0
    assert capsys.readouterr().out


# ---------------------------------------------------------------------------
# (d) the initializer's slice-by-slice draw
# ---------------------------------------------------------------------------


def test_init_params_draws_small_leaves_as_one_draw_each():
    """Every leaf of tinyllama's smoke tree, bitwise as one ``randn`` a leaf
    in sorted path order (the draw before slicing existed)."""
    import math

    from repro_torch.layers.common import ParamSpec, init_params
    from repro_torch.models.transformer import model_params

    tree = model_params(smoke_t("tinyllama-1.1b"))
    got = dict(tree_leaves(init_params(tree, torch.Generator().manual_seed(5), torch.bfloat16)))
    gen = torch.Generator().manual_seed(5)
    for path, spec in tree_leaves(tree):
        assert isinstance(spec, ParamSpec)
        if spec.init == "normal":
            scale = spec.scale if spec.scale is not None else 1 / math.sqrt(spec.shape[0])
            want = (torch.randn(spec.shape, generator=gen) * scale).to(torch.bfloat16)
        else:
            want = (torch.zeros if spec.init == "zeros" else torch.ones)(spec.shape,
                                                                       dtype=torch.bfloat16)
        assert torch.equal(got[path].view(torch.int16), want.view(torch.int16)), path


def test_init_params_draws_a_large_leaf_slice_by_slice(monkeypatch):
    """Above ``DRAW_SLICE_ELEMENTS`` elements: one fp32 draw a slice of the
    leading axis (``DRAW_CHUNK_ELEMENTS`` a slice, one row at least), cast
    into the leaf; each row N(0, scale^2)."""
    from repro_torch.layers import common
    from repro_torch.layers.common import ParamSpec, init_params

    draws = []
    randn = torch.randn

    def counting(*shape, **kw):
        draws.append(tuple(shape[0] if len(shape) == 1 else shape))
        return randn(*shape, **kw)

    def draw(slice_above, chunk):
        monkeypatch.setattr(common, "DRAW_SLICE_ELEMENTS", slice_above)
        monkeypatch.setattr(common, "DRAW_CHUNK_ELEMENTS", chunk)
        return init_params({"w": spec}, torch.Generator().manual_seed(0), torch.bfloat16)["w"]

    defaults = common.DRAW_SLICE_ELEMENTS, common.DRAW_CHUNK_ELEMENTS
    monkeypatch.setattr(common.torch, "randn", counting)
    spec = ParamSpec((7, 64, 48), scale=0.5)
    leaf = draw(10_000, 2 * 64 * 48)
    small = draw(*defaults)
    rowwise = draw(10_000, 1)
    assert draws == [(2, 64, 48)] * 3 + [(1, 64, 48), (7, 64, 48)] + [(1, 64, 48)] * 7
    assert small.shape == leaf.shape == rowwise.shape
    assert tuple(leaf.shape) == spec.shape and leaf.dtype == torch.bfloat16
    for sl in leaf.float():
        assert abs(float(sl.mean())) < 0.5 * 4 / np.sqrt(sl.numel())
        assert float(sl.std()) == pytest.approx(0.5, rel=0.05)
    assert len({bytes(sl.view(torch.int16).numpy()) for sl in leaf}) == 7


def test_adamw_updates_a_large_leaf_slice_by_slice_bitwise(monkeypatch):
    """Above ``UPDATE_SLICE_ELEMENTS`` a leaf is updated one slice of its
    leading axis at a time: parameters, masters and moments bitwise those
    of the whole-leaf update, over three steps with clipping."""
    from repro_torch.optim import adamw as A

    gen = torch.Generator().manual_seed(0)
    params = {"e": torch.randn(6, 50, 40, generator=gen).bfloat16(),
              "n": torch.randn(30, generator=gen).bfloat16()}
    grads = {k: 3 * torch.randn(v.shape, generator=gen) for k, v in params.items()}
    cfg = A.AdamWConfig()
    runs = []
    for limit in (A.UPDATE_SLICE_ELEMENTS, 4000, 1):  # whole; 2 rows a slice; 1 row
        monkeypatch.setattr(A, "UPDATE_SLICE_ELEMENTS", limit)
        p = {k: v.clone() for k, v in params.items()}
        state = A.adamw_init(p, cfg)
        for _ in range(3):
            stats = A.adamw_update(p, grads, state, cfg, 0.5)
        runs.append((p, state, float(stats["grad_norm"])))
    (p1, s1, g1) = runs[0]
    for p2, s2, g2 in runs[1:]:
        assert g1 == g2 > cfg.grad_clip  # clipped
        for k in params:
            assert torch.equal(p1[k].view(torch.int16), p2[k].view(torch.int16)), k
            for part in ("m", "v", "master"):
                assert torch.equal(s1[part][k], s2[part][k]), (part, k)
