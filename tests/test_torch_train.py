"""The port's training step against the JAX package's, on converted state.

(a) the data pipeline, the schedule and one AdamW update against JAX;
(b) the smoke tinyllama in fp32 from a JAX-initialised state converted
leaf for leaf: the step-0 loss and per-leaf gradients against
``jax.value_and_grad(T.forward)``, then 5 train steps (warmup 2, so the
parameters move) for accum 1 and 2, losses and final parameters against
the JAX train step; remat full against none; (c) the recompute structure
that ``chip_smoke.py``'s launch counts rest on; (d) what the slice leaves
out raises instead of being ignored.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as smoke_j  # noqa: E402
from repro.data.pipeline import DataConfig as DataConfigJ  # noqa: E402
from repro.data.pipeline import SyntheticLM as SyntheticLMJ  # noqa: E402
from repro.models import transformer as TJ  # noqa: E402
from repro.optim import AdamWConfig as AdamWConfigJ  # noqa: E402
from repro.train.train import TrainConfig as TrainConfigJ  # noqa: E402
from repro_torch.configs import smoke_config as smoke_t  # noqa: E402
from repro_torch.convert import from_jax_train_state  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train.train import TrainConfig, make_train_step  # noqa: E402

ARCH = "tinyllama-1.1b"
F32 = dict(compute_dtype_name="float32", param_dtype_name="float32")
B, S, STEPS, WARMUP = 2, 32, 5, 2


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.cache
def _jax_state():
    """The JAX TrainState of the fp32 smoke config, as numpy."""
    from repro.train.train import init_state

    cfg = smoke_j(ARCH).replace(**F32)
    st = init_state(cfg, TrainConfigJ(), jax.random.PRNGKey(0))
    return _np_tree(st.tree())


def _port_state(remat="none"):
    cfg = smoke_t(ARCH).replace(remat=remat, **F32)
    return cfg, from_jax_train_state(_jax_state(), cfg, "cpu")


def _data(accum, framework):
    kw = dict(global_batch=B, seq_len=S, vocab=512, accum_steps=accum, pad_fraction=0.05)
    return SyntheticLM(DataConfig(**kw)) if framework == "torch" else \
        SyntheticLMJ(DataConfigJ(**kw))


def _tcfg(cls, opt):
    return cls(optimizer=opt(), warmup_steps=WARMUP, total_steps=20)


@functools.cache
def _jax_run(accum):
    """Losses of STEPS JAX train steps and the final parameters (numpy)."""
    from repro.launch.mesh import make_host_mesh
    from repro.train.train import compile_train_step

    cfg = smoke_j(ARCH).replace(**F32)
    data = _data(accum, "jax")
    state = jax.tree_util.tree_map(jnp.asarray, _jax_state())
    _, call = compile_train_step(cfg, make_host_mesh(), _tcfg(TrainConfigJ, AdamWConfigJ),
                                 state, data.batch_at(0))
    losses = []
    for step in range(STEPS):
        state, metrics = call(state, data.batch_at(step))
        losses.append(float(metrics["loss"]))
    return losses, _np_tree(state["params"]), float(metrics["grad_norm"])


def _port_run(accum, remat="none"):
    cfg, state = _port_state(remat)
    data = _data(accum, "torch")
    step_fn = make_train_step(cfg, _tcfg(TrainConfig, AdamWConfig))
    losses = []
    for step in range(STEPS):
        state, metrics = step_fn(state, data.batch_at(step))
        losses.append(float(metrics["loss"]))
    return losses, state, float(metrics["grad_norm"])


# ---------------------------------------------------------------------------
# (a) data, schedule, optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("accum,pad", [(1, 0.0), (2, 0.05)])
def test_synthetic_batches_are_bitwise_the_jax_ones(accum, pad):
    kw = dict(global_batch=3, seq_len=17, vocab=500, accum_steps=accum,
              pad_fraction=pad, seed=4)
    bj, bt = SyntheticLMJ(DataConfigJ(**kw)), SyntheticLM(DataConfig(**kw))
    for step in (0, 7):
        a, b = bj.batch_at(step), bt.batch_at(step)
        for k in ("tokens", "labels"):
            assert b[k].dtype == torch.int32
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]))


def test_cosine_schedule_matches_jax():
    from repro.optim import cosine_schedule as cos_j
    from repro_torch.optim import cosine_schedule as cos_t

    for step in (0, 1, 2, 5, 50, 99, 100, 150, 1000):
        want = float(cos_j(step, warmup=10, total=200))
        assert cos_t(step, warmup=10, total=200) == pytest.approx(want, rel=1e-6, abs=1e-7)


def test_one_adamw_update_matches_jax():
    """Clipping (the gradient norm exceeds the clip), bias correction, weight
    decay on the master, bf16 params re-cast from the fp32 master."""
    from repro.optim import adamw_init as init_j
    from repro.optim import adamw_update as update_j
    from repro_torch.convert import params_from_numpy
    from repro_torch.optim import adamw_init, adamw_update

    rng = np.random.default_rng(3)
    params = {"a": rng.standard_normal((4, 6)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = {k: 3 * rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
    cfg_j, cfg_t = AdamWConfigJ(lr=1e-2), AdamWConfig(lr=1e-2)
    pj = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    sj = init_j(pj, cfg_j)
    for _ in range(2):  # two updates: the second sees nonzero m, v
        pj, sj, stats_j = update_j(pj, {k: jnp.asarray(v) for k, v in grads.items()},
                                   sj, cfg_j, 0.5)
    pt = {k: v.to(torch.bfloat16) for k, v in params_from_numpy(params).items()}
    st = adamw_init(pt, cfg_t)
    for _ in range(2):
        stats_t = adamw_update(pt, params_from_numpy(grads), st, cfg_t, 0.5)
    assert float(stats_t["grad_norm"]) == pytest.approx(float(stats_j["grad_norm"]), rel=1e-6)
    assert stats_t["lr"] == pytest.approx(float(stats_j["lr"]), rel=1e-7)
    assert st["step"] == int(sj["step"]) == 2
    for k in params:
        for name in ("m", "v", "master"):
            np.testing.assert_allclose(st[name][k].numpy(), np.asarray(sj[name][k]),
                                       rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(pt[k].float().numpy(),
                                      np.asarray(pj[k].astype(jnp.float32)))


# ---------------------------------------------------------------------------
# (b) the train step on converted state
# ---------------------------------------------------------------------------


def test_step0_loss_and_grads_match_jax_value_and_grad():
    cfg_j = smoke_j(ARCH).replace(**F32)
    batch = _data(1, "jax").batch_at(0)
    mb_j = {k: v[0] for k, v in batch.items()}
    params_j = jax.tree_util.tree_map(jnp.asarray, _jax_state()["params"])
    (loss_j, _), grads_j = jax.value_and_grad(
        lambda p: TJ.forward(p, mb_j, cfg_j), has_aux=True)(params_j)

    from repro_torch.layers.common import tree_leaves

    _, state = _port_state()
    model = state.model
    mb_t = {k: v[0] for k, v in _data(1, "torch").batch_at(0).items()}
    loss_t, aux = model(mb_t)
    leaves = model.named_params()
    grads_t = torch.autograd.grad(loss_t, list(leaves.values()))
    assert float(loss_t.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    assert float(aux["tokens"]) == float((np.asarray(mb_j["labels"]) >= 0).sum())
    gj = dict(tree_leaves(_np_tree(grads_j)))
    assert set(gj) == set(leaves)
    for (path, _), g in zip(leaves.items(), grads_t):
        ref = gj[path]
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * max(1e-3, float(np.abs(ref).max())),
                                   err_msg=path)


@pytest.mark.parametrize("accum", [1, 2])
def test_five_train_steps_match_jax(accum):
    """Losses within 1e-4 relative at every step. After the 5th step (lr
    warmed up over 2 steps, so the parameters move) each leaf's
    displacement from the initial state agrees with JAX's within 2e-2 in
    relative L2 norm, and the gradient norm within 1e-3 relative. Not
    elementwise: a gradient element of ~1e-7 (the largest are ~10) has a
    sign that is fp32 noise, and Adam turns either sign into a full step
    of ~lr; the two runs reach such elements by step 3 (relative L2 up to
    7.6e-3 for the embedding, 9e-4 for the rest, where JAX against itself
    with another attention chunking gives 4e-4)."""
    losses_j, params_j, gnorm_j = _jax_run(accum)
    losses_t, state, gnorm_t = _port_run(accum)
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    assert gnorm_t == pytest.approx(gnorm_j, rel=1e-3)
    from repro_torch.layers.common import tree_leaves

    pj, p0 = dict(tree_leaves(params_j)), _jax_params_at_0()
    for path, p in state.model.named_params().items():
        moved = pj[path] - p0[path]
        assert np.abs(moved).max() > 1e-4, path  # the parameters did move
        err = np.linalg.norm(p.detach().numpy() - p0[path] - moved) / np.linalg.norm(moved)
        assert err < 2e-2, (path, err)


@functools.cache
def _jax_params_at_0():
    from repro_torch.layers.common import tree_leaves

    return dict(tree_leaves(_jax_state()["params"]))


def test_remat_full_gives_the_losses_of_remat_none():
    losses_none, _, _ = _port_run(1, "none")
    losses_full, _, _ = _port_run(1, "full")
    np.testing.assert_allclose(losses_full, losses_none, rtol=1e-6)


# ---------------------------------------------------------------------------
# (c) what the launch counts of chip_smoke.py rest on
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat,recompute", [("none", 0), ("full", 1), ("dots", 1)])
def test_forward_backward_calls_per_microbatch(monkeypatch, remat, recompute):
    """Per microbatch: attention runs once per layer in the forward and once
    more under remat full (the layer's recompute), RMSNorm 2 per layer plus
    the final norm, and 2 per layer more under remat (the final norm sits
    outside the checkpointed layers)."""
    import repro_torch.layers.attention as LA
    import repro_torch.layers.norms as LN

    calls = {"attn": 0, "norm": 0}

    def counting(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(LA, "flash_attention", counting("attn", LA.flash_attention))
    monkeypatch.setattr(LN, "_rmsnorm_op", counting("norm", LN._rmsnorm_op))
    cfg, state = _port_state(remat)
    step_fn = make_train_step(cfg, _tcfg(TrainConfig, AdamWConfig))
    step_fn(state, _data(2, "torch").batch_at(0))
    L, A = cfg.n_layers, 2
    assert calls == {"attn": A * L * (1 + recompute),
                     "norm": A * ((2 * L + 1) + 2 * L * recompute)}


# ---------------------------------------------------------------------------
# (d) the options the JAX loop has run, and an unknown one raises
# ---------------------------------------------------------------------------


def test_unported_options_raise():
    """Every option of the JAX step and loop runs in the port now:
    ``compress_dcn_grads`` builds a step, ``ckpt_dir`` a loop with a
    checkpoint manager, the tracer backend a session, ``remat="dots"`` a
    forward (``test_torch_checkpoint.py`` holds each against JAX); a remat
    policy neither package knows still raises."""
    import tempfile

    from repro_torch.session import PerfSession, SessionConfig
    from repro_torch.train.loop import LoopConfig, TrainLoop

    cfg = smoke_t(ARCH)
    assert callable(make_train_step(cfg, TrainConfig(compress_dcn_grads=True)))
    with tempfile.TemporaryDirectory() as d:
        loop = TrainLoop(cfg, TrainConfig(), _data(1, "torch"),
                         LoopConfig(steps=1, ckpt_dir=d, ckpt_every=1), device="cpu")
        assert loop.ckpt is not None and loop.ckpt.latest() is None
    assert PerfSession(SessionConfig(backend="tracer", respect_env=False)).backend == "tracer"
    _, st = _port_state()
    batch = {k: v[0] for k, v in _data(1, "torch").batch_at(0).items()}
    st.model.cfg = st.model.cfg.replace(remat="dots")
    loss, _ = st.model(batch)
    assert torch.isfinite(loss)
    st.model.cfg = st.model.cfg.replace(remat="selective")
    with pytest.raises(ValueError, match="remat"):
        st.model(batch)


def test_train_launcher_asks_for_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.launch.train import main

    with pytest.raises(RuntimeError, match="cuda"):
        main(["--arch", ARCH, "--smoke", "--steps", "1"])


def test_apply_logits_matches_jax():
    """Full-sequence logits of the smoke tinyllama in fp32 on converted
    weights, against ``T.apply_logits``."""
    cfg_j = smoke_j(ARCH).replace(**F32)
    tokens = np.random.default_rng(9).integers(4, 512, size=(2, 24)).astype(np.int32)
    params_j = jax.tree_util.tree_map(jnp.asarray, _jax_state()["params"])
    logits_j, _ = TJ.apply_logits(params_j, {"tokens": jnp.asarray(tokens)}, cfg_j)
    _, state = _port_state()
    with torch.no_grad():
        logits_t, _ = state.model.apply_logits({"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=1e-4, rtol=1e-4)
