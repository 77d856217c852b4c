"""Checkpoint-restart, the int8 gradient compression and ``remat="dots"``
in the port, against the JAX package, on the CPU.

(a) ``tests/test_checkpoint.py`` mirrored on the port: roundtrip (fp32,
    bf16, ints, nested dicts and lists), the async save, no ``.tmp`` left
    and ``latest_step`` ignoring partial saves, the rolling ``keep``, a
    missing key raising, the crash-restart resuming at ``[4, 5, 6, 7]``,
    and a restarted run equal to the uninterrupted one (rtol 1e-4, the
    JAX test's bound);
(b) across the packages: a checkpoint the JAX ``TrainLoop`` wrote restored
    by the port's (every array bitwise, the manifest's keys, shapes and
    dtypes those of a port save), and one the port wrote restored by JAX's
    ``load_checkpoint`` and ``TrainLoop``; each resumed run's losses
    against the other package's uninterrupted run. The JAX loop cannot run
    fp32 parameters (its fp32 master aliases them), so both loops run the
    smoke tinyllama with bf16 parameters computed in fp32: the step that
    reads the restored state agrees within 1e-5, the one after it within
    1e-4 (the packages' AdamW updates can round a bf16 parameter apart);
(c) ``compress_int8`` / ``decompress_int8`` bitwise against JAX's, with
    and without a key (the keyed noise drawn as ``jax.random.uniform``);
(d) a train step with ``compress_dcn_grads`` and one with
    ``remat="dots"`` against JAX's (fp32 smoke tinyllama): loss within
    1e-5, gradient norm within 1e-4, the displacement of all leaves within
    2e-2 (relative L2, ``test_torch_train.py``'s bound); ``"dots"`` gives
    the loss of ``"full"`` within 1e-6.
"""

import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as smoke_j  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointManager,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.configs import smoke_config as smoke_t  # noqa: E402
from repro_torch.layers.common import tree_leaves  # noqa: E402

ARCH = "tinyllama-1.1b"
F32 = dict(compute_dtype_name="float32", param_dtype_name="float32")
MIXED = dict(compute_dtype_name="float32")
DATA = dict(global_batch=2, seq_len=32, vocab=512, pad_fraction=0.05)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test. These tests run the recurrent blocks' many
    small ops (the sLSTM scan is a host loop); beside the other test
    workers, torch's intra-op threads contend for the cores and such a test
    ran ~15x slower (six concurrent runs of
    ``test_remat_dots_on_the_recurrent_archs[xlstm-350m]``: 199 s, against
    12 s with one thread each)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tree():
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "nested": {"b": torch.ones((2, 2), dtype=torch.bfloat16), "step": 7},
        "list": [torch.zeros(3), torch.full((2,), 2.5)],
    }


def assert_tree_equal(a, b):
    la, lb = tree_leaves(_as_dict(a)), tree_leaves(_as_dict(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (_, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert type(x) is type(y) and x == y


def _as_dict(t):
    if isinstance(t, (list, tuple)):
        return {str(i): _as_dict(v) for i, v in enumerate(t)}
    if isinstance(t, dict):
        return {k: _as_dict(v) for k, v in t.items()}
    return t


# ---------------------------------------------------------------------------
# (a) tests/test_checkpoint.py on the port
# ---------------------------------------------------------------------------


def test_roundtrip(tmp_path):
    t = tree()
    save_checkpoint(t, str(tmp_path), 3)
    restored, step = load_checkpoint(t, str(tmp_path))
    assert step == 3
    assert_tree_equal(t, restored)


def test_async_save_then_join(tmp_path):
    t = tree()
    join = save_checkpoint(t, str(tmp_path), 1, async_=True)
    t["a"].add_(1.0)  # the host copy was taken before save_checkpoint returned
    join()
    restored, _ = load_checkpoint(t, str(tmp_path))
    assert torch.equal(restored["a"], t["a"] - 1.0)


def test_no_tmp_left_and_latest_ignores_partial(tmp_path):
    save_checkpoint(tree(), str(tmp_path), 1)
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    os.makedirs(tmp_path / "step_00000002.tmp")
    os.makedirs(tmp_path / "step_00000005")  # committed dir but no manifest
    assert latest_step(str(tmp_path)) == 1


def test_manager_rolls_old_checkpoints(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_=False)
    for s in (1, 2, 3, 4):
        mgr.save(tree(), s)
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert steps == [3, 4]


def test_missing_key_raises(tmp_path):
    save_checkpoint({"a": torch.ones(3)}, str(tmp_path), 1)
    with pytest.raises(KeyError):
        load_checkpoint({"a": torch.ones(3), "b": torch.ones(2)}, str(tmp_path))


def _loop(ckpt_dir, steps, fail_at=None, cfg=None, state=None):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train.loop import LoopConfig, TrainLoop
    from repro_torch.train.train import TrainConfig

    cfg = cfg or smoke_t(ARCH)
    return TrainLoop(cfg, TrainConfig(total_steps=steps), SyntheticLM(DataConfig(**DATA)),
                     LoopConfig(steps=steps, ckpt_every=2, ckpt_dir=str(ckpt_dir),
                                fail_at_step=fail_at),
                     device="cpu", state=state)


def test_crash_restart_resumes_from_checkpoint(tmp_path):
    from repro_torch.train.loop import InjectedFailure

    loop = _loop(tmp_path, steps=8, fail_at=5)
    with pytest.raises(InjectedFailure):
        loop.run()
    assert loop.ckpt.latest() == 4  # checkpoints at 2 and 4
    resumed = _loop(tmp_path, steps=8)
    resumed.run()
    assert [m["step"] for m in resumed.metrics_history] == [4, 5, 6, 7]
    assert resumed.final_state.step == 8 and resumed.final_state.opt_state["step"] == 8


def test_restarted_run_matches_uninterrupted_run(tmp_path):
    from repro_torch.train.loop import InjectedFailure

    a = _loop(tmp_path / "a", steps=6).run()
    with pytest.raises(InjectedFailure):
        _loop(tmp_path / "b", steps=6, fail_at=3).run()
    b = _loop(tmp_path / "b", steps=6).run()
    assert [m["step"] for m in b.metrics_history] == [2, 3, 4, 5]
    np.testing.assert_allclose(b.metrics_history[-1]["loss"], a.metrics_history[-1]["loss"],
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# (b) across the packages
# ---------------------------------------------------------------------------


def _loop_j(ckpt_dir, steps, fail_at=None):
    from repro.data.pipeline import DataConfig as DataConfigJ
    from repro.data.pipeline import SyntheticLM as SyntheticLMJ
    from repro.launch.mesh import make_host_mesh
    from repro.train.loop import LoopConfig as LoopConfigJ
    from repro.train.loop import TrainLoop as TrainLoopJ
    from repro.train.train import TrainConfig as TrainConfigJ

    return TrainLoopJ(smoke_j(ARCH).replace(**MIXED), make_host_mesh(),
                      TrainConfigJ(total_steps=steps), SyntheticLMJ(DataConfigJ(**DATA)),
                      LoopConfigJ(steps=steps, ckpt_every=2,
                                  ckpt_dir=str(ckpt_dir) if ckpt_dir else "",
                                  fail_at_step=fail_at))


@functools.cache
def _jax_uninterrupted():
    return [m["loss"] for m in _loop_j(None, 4).run().metrics_history]


def _port_from_jax_init(ckpt_dir, steps, fail_at=None):
    """The port's loop from the JAX loop's initial state (its init_state at
    seed 0), bf16 parameters computed in fp32."""
    from repro.train.train import TrainConfig as TrainConfigJ
    from repro.train.train import init_state
    from repro_torch.convert import from_jax_train_state

    cfg_j = smoke_j(ARCH).replace(**MIXED)
    state0 = jax.tree_util.tree_map(
        np.asarray, init_state(cfg_j, TrainConfigJ(), jax.random.PRNGKey(0)).tree())
    cfg_t = smoke_t(ARCH).replace(**MIXED)
    return _loop(ckpt_dir, steps, fail_at, cfg=cfg_t,
                 state=from_jax_train_state(state0, cfg_t, "cpu"))


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def _check_resumed_losses(resumed, want):
    """Steps 2 and 3 of a run resumed at 2 against the other package's
    uninterrupted losses: the first reads the restored state alone."""
    got = [m["loss"] for m in resumed.metrics_history]
    assert [m["step"] for m in resumed.metrics_history] == [2, 3]
    np.testing.assert_allclose(got[0], want[2], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[3], rtol=1e-4)


def test_jax_checkpoint_restored_by_the_port(tmp_path):
    from repro.train.loop import InjectedFailure as InjectedFailureJ

    with pytest.raises(InjectedFailureJ):
        _loop_j(tmp_path / "j", 4, fail_at=3).run()
    assert latest_step(str(tmp_path / "j")) == 2
    resumed = _port_from_jax_init(tmp_path / "j", 4).run()
    # the port's own save of the resumed state: JAX's keys, shapes, dtypes
    mj, mt = _manifest(tmp_path / "j", 2), _manifest(tmp_path / "j", 4)
    assert {k: (v["shape"], v["dtype"]) for k, v in mj["arrays"].items()} == \
        {k: (v["shape"], v["dtype"]) for k, v in mt["arrays"].items()}
    assert "params/slots/slot0_attn/attn/wq" in mj["arrays"] and "opt_state/step" in mj["arrays"]
    _check_resumed_losses(resumed, _jax_uninterrupted())
    # the restored tree is bitwise the one JAX saved
    fresh = _port_from_jax_init(tmp_path / "none", 4)
    fresh_state = fresh._initialize()[0]
    tree_t, step = load_checkpoint(fresh_state.tree(), str(tmp_path / "j"), 2)
    for path, t in tree_leaves(tree_t):
        info = mj["arrays"][path]
        arr = np.load(tmp_path / "j" / "step_00000002" / info["file"])
        got = t.view(torch.int16).numpy().view(np.uint16) if isinstance(t, torch.Tensor) \
            and t.dtype == torch.bfloat16 else np.asarray(t)
        np.testing.assert_array_equal(got, arr.astype(got.dtype), err_msg=path)


def test_port_checkpoint_restored_by_jax(tmp_path):
    from repro.checkpoint import load_checkpoint as load_j
    from repro_torch.train.loop import InjectedFailure

    with pytest.raises(InjectedFailure):
        _port_from_jax_init(tmp_path / "t", 4, fail_at=3).run()
    assert latest_step(str(tmp_path / "t")) == 2
    port_run = _port_from_jax_init(tmp_path / "ref", 4).run()
    resumed = _loop_j(tmp_path / "t", 4).run()
    _check_resumed_losses(resumed, [m["loss"] for m in port_run.metrics_history])
    # JAX's load_checkpoint reads every array of the port's save
    from repro.train.train import TrainConfig as TrainConfigJ
    from repro.train.train import init_state

    template = init_state(smoke_j(ARCH).replace(**MIXED), TrainConfigJ(),
                          jax.random.PRNGKey(0)).tree()
    restored, step = load_j(template, str(tmp_path / "t"), 2)
    assert step == 2 and int(restored["step"]) == 2
    assert int(restored["opt_state"]["step"]) == 2


# ---------------------------------------------------------------------------
# (c) compress_int8
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("keyed", [False, True])
@pytest.mark.parametrize("shape,dtype", [((1000,), "float32"), ((3, 300), "bfloat16"),
                                        ((4, 256), "float32")])
def test_compress_int8_is_bitwise_jax(shape, dtype, keyed):
    from repro.optim import compress_int8 as comp_j
    from repro.optim import decompress_int8 as decomp_j
    from repro_torch.convert import params_from_numpy
    from repro_torch.optim import compress_int8, decompress_int8
    from repro_torch import prng

    rng = np.random.default_rng(3)
    g = (rng.standard_normal(shape) * np.exp(rng.standard_normal(shape))).astype(np.float32)
    g[..., :7] = 0.0  # an all-zero stretch: the scale floor
    gj = jnp.asarray(g, dtype)
    gt = params_from_numpy({"g": np.asarray(gj)})["g"]
    qj, sj, meta_j = comp_j(gj, jax.random.PRNGKey(11) if keyed else None)
    qt, st, meta_t = compress_int8(gt, prng.prng_key(11) if keyed else None)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert meta_t == (tuple(meta_j[0]), meta_j[1])
    np.testing.assert_array_equal(decompress_int8(qt, st, meta_t).numpy(),
                                  np.asarray(decomp_j(qj, sj, meta_j)))


# ---------------------------------------------------------------------------
# (d) train steps: compress_dcn_grads, remat="dots"
# ---------------------------------------------------------------------------


@functools.cache
def _state0():
    from repro.train.train import TrainConfig as TrainConfigJ
    from repro.train.train import init_state

    cfg = smoke_j(ARCH).replace(**F32)
    return jax.tree_util.tree_map(
        lambda x: np.array(x, copy=True),
        init_state(cfg, TrainConfigJ(), jax.random.PRNGKey(0)).tree())


def _steps(impl, n=2, remat="none", compress=False):
    """``n`` train steps of ``impl`` from ``_state0`` on one batch (warmup 1):
    (losses, last grad norm, final params as {path: numpy})."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    batch = SyntheticLM(DataConfig(**DATA)).batch_at(0)
    batch = {k: np.asarray(v) for k, v in batch.items()}
    if impl == "jax":
        from repro.launch.mesh import make_host_mesh
        from repro.train.train import TrainConfig as TrainConfigJ
        from repro.train.train import compile_train_step

        cfg = smoke_j(ARCH).replace(remat=remat, **F32)
        bj = {k: jnp.asarray(v) for k, v in batch.items()}
        state = jax.tree_util.tree_map(jnp.asarray, _state0())
        _, call = compile_train_step(cfg, make_host_mesh(), TrainConfigJ(
            warmup_steps=1, total_steps=10, compress_dcn_grads=compress), state, bj)
        out = []
        for _ in range(n):
            state, m = call(state, bj)
            out.append(m)
        return ([float(m["loss"]) for m in out], float(out[-1]["grad_norm"]),
                dict(tree_leaves(jax.tree_util.tree_map(np.asarray, state["params"]))))
    from repro_torch.convert import from_jax_train_state, params_from_numpy
    from repro_torch.train.train import TrainConfig, make_train_step

    cfg = smoke_t(ARCH).replace(remat=remat, **F32)
    state = from_jax_train_state(_state0(), cfg, "cpu")
    step = make_train_step(cfg, TrainConfig(warmup_steps=1, total_steps=10,
                                            compress_dcn_grads=compress))
    out = []
    for _ in range(n):
        state, m = step(state, params_from_numpy(batch))
        out.append(m)
    return ([float(m["loss"]) for m in out], float(out[-1]["grad_norm"]),
            {p: t.detach().numpy() for p, t in state.model.named_params().items()})


def _same_steps(got, want):
    (lt, gt, pt), (lj, gj, pj) = got, want
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    assert gt == pytest.approx(gj, rel=1e-4)
    p0 = dict(tree_leaves(_state0()["params"]))
    err2 = ref2 = 0.0
    for path in pj:
        moved = pj[path] - p0[path]
        err2 += float(np.sum((pt[path] - p0[path] - moved) ** 2))
        ref2 += float(np.sum(moved ** 2))
    assert np.sqrt(err2 / ref2) < 2e-2


def test_compress_dcn_grads_step_matches_jax():
    got = _steps("port", compress=True)
    _same_steps(got, _steps("jax", compress=True))
    # the round trip moves the update: the parameters differ from a plain step
    plain = _steps("port")
    assert any(not np.array_equal(got[2][p], plain[2][p]) for p in plain[2])


def test_remat_dots_step_matches_jax_and_full():
    got = _steps("port", remat="dots")
    _same_steps(got, _steps("jax", remat="dots"))
    full = _steps("port", remat="full")
    np.testing.assert_allclose(got[0], full[0], rtol=1e-6)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-350m"])
def test_remat_dots_on_the_recurrent_archs(arch):
    """``"dots"`` over the recurrent blocks: loss and gradients equal to
    ``"none"``'s (the recompute runs the same ops on the same inputs)."""
    from repro_torch.models.transformer import Transformer

    cfg = smoke_t(arch).replace(**F32)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(4, 512, (2, 64)).astype(np.int32)),
             "labels": torch.from_numpy(rng.integers(0, 512, (2, 64)).astype(np.int32))}
    out = {}
    for remat in ("none", "dots"):
        model = Transformer.from_init(cfg.replace(remat=remat), seed=1, device="cpu")
        loss, _ = model(batch)
        grads = torch.autograd.grad(loss, list(model.named_params().values()))
        out[remat] = (float(loss.detach()), grads)
    assert out["dots"][0] == pytest.approx(out["none"][0], rel=1e-6)
    for a, b in zip(out["dots"][1], out["none"][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_remat_dots_keeps_the_products_and_recomputes_the_rest():
    """Counted at the dispatcher over one forward and backward of the smoke
    tinyllama: ``"full"`` reruns every layer's plain products (aten.mm) in
    the backward, ``"dots"`` reruns none of them, and both rerun the
    layers' other ops (here the RoPE's cosines), which ``"none"`` runs once."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models.transformer import Transformer

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {"mm": 0, "cos": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in self.n:
                self.n[name] += 1
            return func(*args, **(kwargs or {}))

    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(4, 512, (2, 32)).astype(np.int32)),
             "labels": torch.from_numpy(rng.integers(0, 512, (2, 32)).astype(np.int32))}
    counts = {}
    for remat in ("none", "full", "dots"):
        model = Transformer.from_init(smoke_t(ARCH).replace(remat=remat, **F32), device="cpu")
        with Count() as c:
            loss, _ = model(batch)
            torch.autograd.grad(loss, list(model.named_params().values()))
        counts[remat] = c.n
    layers = smoke_t(ARCH).n_layers
    rerun = counts["full"]["mm"] - counts["none"]["mm"]
    assert rerun > 0 and rerun % layers == 0, counts
    assert counts["dots"]["mm"] == counts["none"]["mm"]
    assert counts["full"]["cos"] == counts["dots"]["cos"] == 2 * counts["none"]["cos"]
