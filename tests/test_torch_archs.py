"""The other dense archs through the port against the JAX package, on the CPU.

gemma2-2b (local attention, head dim 256, softcaps, zero-centred norm,
GeGLU, tied and scaled embeddings), glm4-9b (qkv bias, partial RoPE, GQA
group 16), command-r-35b (tied embeddings), llava-next-mistral-7b (the vlm
stub: patch embeddings ahead of the text) and hubert-xlarge (encoder-only,
the audio stub: frame embeddings and no token embedding), each on its fp32
smoke config with weights drawn by ``jax.random`` and converted leaf for
leaf:

(a) ``configs/archs.py`` and ``models/flops.py`` equal to the JAX ones for
    all ten archs; ``check_supported`` admits all ten (the MoE archs run
    in ``test_torch_moe.py``, the recurrent ones in
    ``test_torch_recurrent.py``) and qk-norm, and refuses an unknown block
    kind, frontend or paged-attention implementation;
(b) full-sequence logits (``apply_logits``) against ``T.apply_logits``;
(c) logits after two prefill chunks and 4 decode steps, paged and dense,
    against ``T.prefill_chunk`` / ``T.decode_step`` (not hubert: no cache,
    which the port refuses);
(d) one train step's loss and gradients against ``jax.value_and_grad(T.
    forward)``, and one step of each package's train step; the vlm's
    synthetic stream bit for bit the JAX ``SyntheticLM``'s; hubert on
    ``test_arch_smoke._batch``'s frame batch;
(e) the launchers: the train launcher runs the vlm and refuses the audio
    model with a message, where the JAX launcher's model raises
    ``KeyError: 'embed'``; the serve launcher refuses hubert.

The initializer zeroes the qkv biases, so glm4's and hubert's are drawn
non-zero here; gemma2's smoke window is cut to 16 in both packages so that
it cuts keys at the smoke lengths. Tolerance: 1e-4 (fp32), as in
``test_torch_serve.py`` and ``test_torch_train.py``.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as get_j  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.configs import smoke_config as smoke_j  # noqa: E402
from repro.models import transformer as TJ  # noqa: E402
from repro_torch.configs import get_config as get_t  # noqa: E402
from repro_torch.configs import smoke_config as smoke_t  # noqa: E402
from repro_torch.convert import from_jax_train_state  # noqa: E402
from repro_torch.layers.common import tree_leaves  # noqa: E402

ARCHS = ["gemma2-2b", "glm4-9b", "command-r-35b", "llava-next-mistral-7b", "hubert-xlarge"]
DECODERS = [a for a in ARCHS if a != "hubert-xlarge"]
# configs check_supported refuses, with the message each raises
REFUSED = [(dict(frontend="speech"), "frontend"), (dict(pattern=("attn", "conv")), "conv"),
           (dict(paged_attn_impl="pallas"), "paged_attn_impl"),
           (dict(pattern=("mamba2",), ssm=None), "ssm config")]
F32 = dict(compute_dtype_name="float32", param_dtype_name="float32")
# gemma2's window (4096) never cuts at the smoke lengths: 16 does
SMOKE_EXTRA = {"gemma2-2b": dict(window=16)}
TOL = 1e-4
B, S = 2, 40


def _cfgs(arch):
    kw = dict(F32, **SMOKE_EXTRA.get(arch, {}))
    return smoke_j(arch).replace(**kw), smoke_t(arch).replace(**kw)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb_biases(tree, rng):
    """Draw the zero-initialised qkv biases as N(0, 0.3), in place."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _perturb_biases(v, rng)
        elif k in ("bq", "bk", "bv"):
            tree[k] = (0.3 * rng.standard_normal(v.shape)).astype(v.dtype)


@functools.cache
def _jax_state(arch):
    """The JAX TrainState of the fp32 smoke config as numpy, its qkv biases
    (and their fp32 masters, where the state keeps one) non-zero."""
    from repro.train.train import TrainConfig as TrainConfigJ
    from repro.train.train import init_state

    cfg_j, _ = _cfgs(arch)
    tree = _np_tree(init_state(cfg_j, TrainConfigJ(), jax.random.PRNGKey(0)).tree())
    _perturb_biases(tree["params"], np.random.default_rng(7))
    if "master" in tree["opt_state"]:
        _perturb_biases(tree["opt_state"]["master"], np.random.default_rng(7))
    return tree


def _params_j(arch):
    return jax.tree_util.tree_map(jnp.asarray, _jax_state(arch)["params"])


def _port_state(arch):
    _, cfg_t = _cfgs(arch)
    return from_jax_train_state(_jax_state(arch), cfg_t, "cpu")


def _batch(arch, seed=3):
    """A training batch (numpy) for each input kind: tokens; the vlm's
    patch embeddings ahead of the tokens (labels -1 over them); the audio
    model's frame embeddings (no tokens)."""
    cfg_j, _ = _cfgs(arch)
    rng = np.random.default_rng(seed)
    d, nf = cfg_j.d_model, cfg_j.n_frontend_tokens
    labels = rng.integers(0, cfg_j.vocab, size=(B, S)).astype(np.int32)
    labels[:, ::7] = -1
    if cfg_j.frontend == "audio":
        return {"frontend": rng.standard_normal((B, S, d)).astype(np.float32),
                "labels": labels}
    if cfg_j.frontend == "vlm":
        labels[:, :nf] = -1
        return {"frontend": (0.02 * rng.standard_normal((B, nf, d))).astype(np.float32),
                "tokens": rng.integers(4, cfg_j.vocab, size=(B, S - nf)).astype(np.int32),
                "labels": labels}
    return {"tokens": rng.integers(4, cfg_j.vocab, size=(B, S)).astype(np.int32),
            "labels": labels}


def _to_j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _to_t(batch):
    from repro_torch.convert import params_from_numpy

    return params_from_numpy(batch)


# ---------------------------------------------------------------------------
# (a) configs, FLOPs, what the port admits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list_archs())
def test_arch_configs_equal_jax_field_by_field(arch):
    for get_jf, get_tf in ((get_j, get_t), (smoke_j, smoke_t)):
        cj, ct = get_jf(arch), get_tf(arch)
        names = [f.name for f in dataclasses.fields(cj)]
        assert names == [f.name for f in dataclasses.fields(ct)]
        for name in names:
            vj, vt = getattr(cj, name), getattr(ct, name)
            if dataclasses.is_dataclass(vj):
                assert dataclasses.asdict(vj) == dataclasses.asdict(vt), (arch, name)
            else:
                assert vj == vt, (arch, name)
        assert ct.param_count() == cj.param_count()
        assert ct.active_param_count() == cj.active_param_count()


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_equal_jax_for_the_full_config(arch):
    from repro.models import flops as FJ
    from repro_torch.models import flops as FT

    cj, ct = get_j(arch), get_t(arch)
    for shape in ((1, 4, 2048), (2, 8192), (1, 1, 524288)):
        assert FT.train_step_model_flops(ct, shape) == FJ.train_step_model_flops(cj, shape)
    for batch, seq in ((1, 2048), (4, 8192), (8, 131072)):
        assert FT.prefill_model_flops(ct, batch, seq) == FJ.prefill_model_flops(cj, batch, seq)
        assert FT.decode_model_flops(ct, batch, seq) == FJ.decode_model_flops(cj, batch, seq)
        assert FT.decode_model_bytes(ct, batch, seq) == FJ.decode_model_bytes(cj, batch, seq)


def test_check_supported_admits_the_dense_archs_only():
    """All ten archs are admitted now, the dense, MoE and recurrent ones,
    at full size and smoke size, and build; qk-norm too. An unknown
    frontend, block kind or paged-attention implementation, and a
    recurrent kind without its config, still raise before any weight is
    drawn."""
    from repro_torch.configs.base import check_supported
    from repro_torch.models.transformer import Transformer

    for arch in list_archs():
        check_supported(get_t(arch))
        check_supported(smoke_t(arch))
    for arch in ("zamba2-2.7b", "xlstm-350m"):
        Transformer.from_init(smoke_t(arch), device="cpu")
    check_supported(smoke_t("glm4-9b").replace(qk_norm=True))
    for over, msg in REFUSED:
        with pytest.raises(NotImplementedError, match=msg):
            check_supported(smoke_t("zamba2-2.7b").replace(**over))
        with pytest.raises(NotImplementedError, match=msg):
            Transformer.from_init(smoke_t("zamba2-2.7b").replace(**over), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_tree_is_the_jax_tree(arch):
    """Paths and shapes leaf for leaf: the biases where ``attn_bias`` is
    set, no ``embed`` for the audio model, ``local_attn`` slots."""
    from repro.layers.common import ParamSpec as SpecJ
    from repro_torch.models.transformer import model_params

    cj, ct = get_j(arch), get_t(arch)
    leaves_j = jax.tree_util.tree_leaves_with_path(
        TJ.model_params(cj), is_leaf=lambda x: isinstance(x, SpecJ))
    want = {"/".join(k.key for k in path): tuple(s.shape) for path, s in leaves_j}
    got = {p: tuple(s.shape) for p, s in tree_leaves(model_params(ct))}
    assert got == want
    assert ("embed" in got) == (ct.frontend != "audio")
    assert any(p.endswith("attn/bq") for p in got) == ct.attn_bias


# ---------------------------------------------------------------------------
# (b) full-sequence logits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_logits_matches_jax(arch):
    cfg_j, _ = _cfgs(arch)
    batch = _batch(arch)
    batch.pop("labels")
    logits_j, _ = TJ.apply_logits(_params_j(arch), _to_j(batch), cfg_j)
    model = _port_state(arch).model
    with torch.no_grad():
        logits_t, _ = model.apply_logits(_to_t(batch))
    assert tuple(logits_t.shape) == tuple(logits_j.shape) == (B, S, cfg_j.vocab_padded)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# (c) serving: prefill chunks then decode steps, paged and dense
# ---------------------------------------------------------------------------


PAGE, CHUNK, MAX_LEN, N_PAGES = 4, 12, 48, 24


@pytest.mark.parametrize("layout", ["paged", "dense"])
@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_chunks_and_decode_steps_match_jax(arch, layout):
    """Two ragged chunks (the second at every position) and 4 decode steps
    with one slot idle every other step; gemma2's positions reach 30, past
    its smoke window of 16, on both layer kinds."""
    cfg_j, _ = _cfgs(arch)
    params = _params_j(arch)
    model = _port_state(arch).model
    paged = layout == "paged"
    rng = np.random.default_rng(11)
    if paged:
        tbl = np.full((B, MAX_LEN // PAGE), -1, np.int32)
        perm = rng.permutation(N_PAGES)
        tbl[0, :9], tbl[1, :9] = perm[:9], perm[9:18]
        caches_j = TJ.init_cache(cfg_j, B, MAX_LEN, paged=True, page_size=PAGE,
                                 num_pages=N_PAGES)
        caches_t = model.init_cache(B, MAX_LEN, page_size=PAGE, num_pages=N_PAGES)
        tbl_j, tbl_t = jnp.asarray(tbl), torch.from_numpy(tbl)
    else:
        caches_j = TJ.init_cache(cfg_j, B, MAX_LEN)
        caches_t = model.init_cache(B, MAX_LEN, paged=False)
        tbl_j = tbl_t = None
    lengths = np.asarray([CHUNK, 9], np.int32)
    errs = []
    for start, all_logits in ((np.zeros(B, np.int32), False), (lengths.copy(), True)):
        toks = rng.integers(4, cfg_j.vocab, size=(B, CHUNK)).astype(np.int32)
        lj, caches_j = TJ.prefill_chunk(
            params, {"tokens": jnp.asarray(toks)}, cfg_j, caches_j, jnp.asarray(start),
            jnp.asarray(lengths), block_tables=tbl_j, all_logits=all_logits)
        lt = model.prefill_chunk(torch.from_numpy(toks), caches_t, torch.from_numpy(start),
                                 torch.from_numpy(lengths), tbl_t, all_logits=all_logits)
        if all_logits:  # positions past length hold garbage on both sides
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
    assert int(pos.max()) > 16  # past gemma2's smoke window
    assert max(errs) < TOL * max(1.0, float(np.abs(np.asarray(lj)).max())), errs


def test_encoder_only_model_refuses_caches():
    model = _port_state("hubert-xlarge").model
    with pytest.raises(NotImplementedError, match="encoder-only"):
        model.init_cache(1, 16)
    with pytest.raises(NotImplementedError, match="encoder-only"):
        model.prefill_chunk(torch.zeros((1, 4), dtype=torch.int32), {}, 0, 4)
    with pytest.raises(NotImplementedError, match="encoder-only"):
        model.decode_step(torch.zeros((1, 1), dtype=torch.int32), 0, {})


def test_local_window_cuts_keys_in_the_smoke_model():
    """gemma2's local layers see a window of 16: logits at positions past
    it change when the window is lifted, and those before it do not."""
    _, cfg_t = _cfgs("gemma2-2b")
    model = _port_state("gemma2-2b").model
    batch = _to_t(_batch("gemma2-2b"))
    with torch.no_grad():
        cut, _ = model.apply_logits(batch)
        model.cfg = cfg_t.replace(window=None)
        full, _ = model.apply_logits(batch)
    assert torch.equal(cut[:, :16], full[:, :16])
    assert float((cut[:, 16:] - full[:, 16:]).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# (d) training
# ---------------------------------------------------------------------------


def _port_grads(model, batch):
    loss, aux = model(batch)
    leaves = model.named_params()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), aux, {p: g.double().numpy() for p, g in zip(leaves, grads)}


@functools.cache
def _grads(arch, smoke_batch: bool = False):
    """Loss, token count and per-leaf gradients of the same batch (``_batch``,
    or with ``smoke_batch`` ``tests/test_arch_smoke.py``'s): JAX fp32, the
    port fp32 and the port in float64 on the same (fp32) weights."""
    from repro_torch.layers.common import tree_map
    from repro_torch.models.transformer import Transformer

    cfg_j, cfg_t = _cfgs(arch)
    batch = ({k: v[0] for k, v in _arch_smoke_batch(cfg_j).items()} if smoke_batch
             else _batch(arch))
    (loss_j, aux_j), grads_j = jax.value_and_grad(
        lambda p: TJ.forward(p, _to_j(batch), cfg_j), has_aux=True)(_params_j(arch))
    model = _port_state(arch).model
    loss_t, aux_t, gt = _port_grads(model, _to_t(batch))
    cfg64 = cfg_t.replace(param_dtype_name="float64", compute_dtype_name="float64")
    m64 = Transformer(cfg64, tree_map(lambda t: t.double(), model.params()), "cpu")
    b64 = {k: (v.double() if v.is_floating_point() else v) for k, v in _to_t(batch).items()}
    assert ("tokens" in batch) == (cfg_j.frontend != "audio")
    _, _, g64 = _port_grads(m64, b64)
    return ((float(loss_j), float(aux_j["tokens"]), dict(tree_leaves(_np_tree(grads_j)))),
            (float(loss_t), float(aux_t["tokens"]), gt), g64)


# A leaf's gradient against JAX's, over the leaf's own largest |value|:
# the readings reach 6.9e-4 (llava's wk on the arch-smoke batch; JAX's own
# fp32 run lies up to 7e-4 from float64 there), so 2e-3, under what a
# bias gradient scaled by 1.01 or zeroed reads (1e-2, 1). A leaf whose
# gradient is below 1e-4 of the largest leaf's is held to that size: with
# the arch-smoke batch's equal tokens the attention gradients (wq, wk, bq,
# bk) vanish in exact arithmetic and both fp32 runs hold only rounding
# (~1e-9 of the largest leaf's).
GRAD_TOL, GRAD_FLOOR = 2e-3, 1e-4


@pytest.mark.parametrize("smoke_batch", [False, True], ids=["batch", "arch_smoke_batch"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax_value_and_grad(arch, smoke_batch):
    """Loss within 1e-4 relative; each leaf's gradient within ``GRAD_TOL``
    of its own largest |value| in JAX's run (``GRAD_FLOOR`` of the largest
    leaf's at least). Two batches: ``_batch``'s, and
    ``tests/test_arch_smoke.py``'s (token ids 1 or constant embeddings;
    hubert's: frames only, no tokens)."""
    (loss_j, tok_j, gj), (loss_t, tok_t, gt), _ = _grads(arch, smoke_batch)
    assert loss_t == pytest.approx(loss_j, rel=TOL)
    assert tok_t == tok_j
    assert set(gj) == set(gt)
    top = max(float(np.abs(g).max()) for g in gj.values())
    for path, g in gt.items():
        scale = float(np.abs(gj[path]).max())
        assert scale > 0, path  # every leaf, the biases too, gets one
        err = float(np.abs(g - gj[path]).max())
        assert err <= GRAD_TOL * max(scale, GRAD_FLOOR * top), (path, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_are_as_close_to_float64_as_jax_ones(arch):
    """A check of rounding beside the gate above, which holds the port to
    JAX: against the same weights' float64 gradients from the port (JAX's
    own float64 run would not do: its norms, RoPE, attention scores and
    loss cast to float32), the port's fp32 gradients lie within 2x the JAX
    fp32 ones' relative L2 distance, over all leaves together and for each
    leaf above 1e-6 of JAX's own distance."""
    (_, _, gj), (_, _, gt), g64 = _grads(arch)

    def dist(g, path=None):
        paths = [path] if path else list(g64)
        err = sum(float(np.sum((g[p] - g64[p]) ** 2)) for p in paths)
        ref = sum(float(np.sum(g64[p] ** 2)) for p in paths)
        return np.sqrt(err / ref)

    assert dist(gt) <= 2.0 * dist(gj), (dist(gt), dist(gj))
    for path in g64:
        if dist(gj, path) > 1e-6:
            assert dist(gt, path) <= 2.0 * dist(gj, path), (path, dist(gt, path),
                                                            dist(gj, path))


def _arch_smoke_batch(cfg):
    """``tests/test_arch_smoke.py``'s batch (accum 1), as numpy."""
    import test_arch_smoke

    return _np_tree(test_arch_smoke._batch(cfg, accum=1))


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_jax(arch):
    """Each package's train step (AdamW, schedule, clipping) from the same
    state on ``_batch``'s batch (the vlm: patch embeddings; hubert: its
    frame embeddings, no tokens), two steps on one batch (warmup 1: the
    first at lr 0): the losses within 1e-4 (the second one reads the
    update), the gradient norm within 1e-3, and the displacement of all
    leaves together within 2e-2 in relative L2 norm, the bound
    ``test_torch_train.py`` holds five steps to. Not per leaf: Adam's first
    step moves an element by about lr whatever its gradient's size, so where
    a gradient is fp32 noise (glm4's key bias along the dims RoPE leaves
    alone, where the loss does not depend on it; command-r's first norm at
    these weights) the two runs move it either way."""
    from repro.launch.mesh import make_host_mesh
    from repro.optim import AdamWConfig as AdamWConfigJ
    from repro.train.train import TrainConfig as TrainConfigJ
    from repro.train.train import compile_train_step
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.train import TrainConfig, make_train_step

    cfg_j, cfg_t = _cfgs(arch)
    batch = {k: v[None] for k, v in _batch(arch).items()}
    state_j = jax.tree_util.tree_map(jnp.asarray, _jax_state(arch))
    tj = TrainConfigJ(optimizer=AdamWConfigJ(), warmup_steps=1, total_steps=10)
    _, call = compile_train_step(cfg_j, make_host_mesh(), tj, state_j, _to_j(batch))
    state_t = _port_state(arch)
    step = make_train_step(cfg_t, TrainConfig(optimizer=AdamWConfig(), warmup_steps=1,
                                              total_steps=10))
    for _ in range(2):
        state_j, metrics_j = call(state_j, _to_j(batch))
        state_t, metrics_t = step(state_t, _to_t(batch))
        assert float(metrics_t["loss"]) == pytest.approx(float(metrics_j["loss"]), rel=TOL)
    assert float(metrics_t["grad_norm"]) == pytest.approx(float(metrics_j["grad_norm"]),
                                                          rel=1e-3)
    pj = dict(tree_leaves(_np_tree(state_j["params"])))
    p0 = dict(tree_leaves(_jax_state(arch)["params"]))
    err2 = ref2 = 0.0
    for path, p in state_t.model.named_params().items():
        moved = pj[path] - p0[path]
        assert np.abs(moved).max() > 0, path  # every leaf moved
        err2 += float(np.sum((p.detach().numpy() - p0[path] - moved) ** 2))
        ref2 += float(np.sum(moved ** 2))
    assert np.sqrt(err2 / ref2) < 2e-2


@pytest.mark.parametrize("accum,pad", [(1, 0.0), (2, 0.05)])
def test_vlm_synthetic_stream_is_bitwise_the_jax_one(accum, pad):
    from repro.data.pipeline import DataConfig as DataConfigJ
    from repro.data.pipeline import SyntheticLM as SyntheticLMJ
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    kw = dict(global_batch=2, seq_len=40, vocab=512, accum_steps=accum, pad_fraction=pad,
              seed=5, frontend_tokens=16, d_model=128)
    bj, bt = SyntheticLMJ(DataConfigJ(**kw)), SyntheticLM(DataConfig(**kw))
    for step in (0, 3):
        a, b = bj.batch_at(step), bt.batch_at(step)
        assert set(a) == set(b) == {"tokens", "labels", "frontend"}
        assert tuple(b["tokens"].shape) == (accum, 2, 24)
        assert tuple(b["labels"].shape) == (accum, 2, 40)
        assert (b["labels"][..., :16] == -1).all()
        assert b["frontend"].dtype == torch.bfloat16
        np.testing.assert_array_equal(b["frontend"].view(torch.int16).numpy(),
                                      np.asarray(a["frontend"]).view(np.int16))
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]))


def test_vlm_trains_from_the_synthetic_stream():
    """A TrainLoop over the vlm's stream: the patch embeddings ride through
    the microbatches (accum 2): the first step's loss is the mean of the
    model's losses on the two microbatches with their embeddings (and not
    without them), every loss finite."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import LoopConfig, TrainLoop
    from repro_torch.train.train import TrainConfig

    _, cfg_t = _cfgs("llava-next-mistral-7b")
    data = SyntheticLM(DataConfig(global_batch=2, seq_len=40, vocab=cfg_t.vocab,
                                  accum_steps=2, frontend_tokens=cfg_t.n_frontend_tokens,
                                  d_model=cfg_t.d_model))
    model = _port_state("llava-next-mistral-7b").model
    batch = data.batch_at(0)
    with torch.no_grad():
        want = [float(model({k: v[a] for k, v in batch.items()})[0]) for a in range(2)]
        blind = float(model({k: v[0] for k, v in batch.items() if k != "frontend"}
                            | {"labels": batch["labels"][0, :, 16:]})[0])
    loop = TrainLoop(cfg_t, TrainConfig(optimizer=AdamWConfig(lr=3e-3), warmup_steps=1,
                                        total_steps=4), data,
                     LoopConfig(steps=4, monitor_backend="null"), device="cpu",
                     state=_port_state("llava-next-mistral-7b"))
    losses = [h["loss"] for h in loop.run().metrics_history]
    assert all(np.isfinite(losses)), losses
    assert losses[0] == pytest.approx(sum(want) / 2, rel=1e-6)
    assert abs(blind - want[0]) > 1e-4


# ---------------------------------------------------------------------------
# (e) launchers
# ---------------------------------------------------------------------------


def test_train_launcher_refuses_the_audio_model_where_jax_raises_keyerror():
    """The JAX launcher feeds hubert-xlarge token batches, which its model
    cannot embed (no ``embed``: ``KeyError: 'embed'``); the port's launcher
    refuses it up front, naming the missing audio stream."""
    from repro_torch.launch.train import main

    cfg_j, _ = _cfgs("hubert-xlarge")
    tokens = {"tokens": jnp.ones((1, 8), jnp.int32), "labels": jnp.ones((1, 8), jnp.int32)}
    with pytest.raises(KeyError, match="embed"):
        TJ.forward(_params_j("hubert-xlarge"), tokens, cfg_j)
    with pytest.raises(SystemExit, match="audio frame"):
        main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu", "--steps", "1"])


def test_serve_launcher_refuses_the_encoder_only_model():
    from repro_torch.launch.serve import main

    with pytest.raises(SystemExit, match="encoder-only"):
        main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])


@pytest.mark.parametrize("arch", ["gemma2-2b", "llava-next-mistral-7b"])
def test_train_launcher_runs_the_arch_on_the_cpu(arch, capsys):
    from repro_torch.launch.train import main

    assert main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                 "--global-batch", "2", "--seq-len", "32"]) == 0
    assert f"[launch] {arch} on cpu: steps 0..1" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["gemma2-2b", "glm4-9b"])
def test_serve_launcher_runs_the_arch_on_the_cpu(arch, capsys):
    from repro_torch.launch.serve import main

    assert main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "2",
                 "--max-new", "4"]) == 0
    assert capsys.readouterr().out
