"""Tensor-, sequence- and expert-parallel compute over a megatron mesh's
``"model"`` axis, against JAX's GSPMD runs on meshes of the same shape.

The ranks are ``gloo`` processes on the CPU (``tests/torch_mesh_ranks.py``,
phases ``tp4`` and ``tp2``), started once by one fixture beside one JAX
subprocess with 4 host devices; both start from the same JAX initial
states (``convert.from_jax_train_state``). Checked:

* glm4-9b smoke in fp32 on (1, 4) (2 kv heads, which do not divide 4,
  and qkv biases) and command-r-35b smoke on (1, 2) (the tied embedding
  through the vocab-parallel lookup and head): 2 steps, loss and
  ``grad_norm`` within 1e-4 of JAX's, the parameters under
  ``test_torch_distributed``'s gate;
* every megatron arch's smoke config, one step on (1, 2) from the port's
  seeded weights (stacked leaves at their fan-in, as
  ``tests/test_torch_recurrent.py`` draws them): loss and ``grad_norm``
  within 1e-4 of the port's one-rank step (llava's frontend, hubert's
  frames and bidirectional attention, dbrx, zamba2's mamba2 split over its SSM heads);
* tinyllama smoke on a (1, 2) rank: the counted matmul FLOPs half the
  one-rank count; the attention kernel's wrapper sees the rank's 2 of 4
  heads, every RMSNorm the rank's sequence half, and no gather names
  ``"model"``;
* in one process, each rank's attention (heads that group evenly, one kv
  head for two ranks, groups that straddle ranks), MLP and MoE FFN give
  partial sums that add up to the whole layer's output.
"""

import functools
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import smoke_config as smoke_j  # noqa: E402
from repro.train.train import TrainConfig as TrainConfigJ  # noqa: E402
from repro.train.train import init_state as init_state_j  # noqa: E402
from repro_torch.configs import smoke_config as smoke_t  # noqa: E402
from repro_torch.distributed.shard import NamedSharding, TensorParallel  # noqa: E402
from repro_torch.layers.common import init_params, tree_leaves, unflatten  # noqa: E402
from repro_torch.models.transformer import Transformer, model_params  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.train.train import TrainState, make_train_step  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
sys.path.insert(0, HERE)
import torch_mesh_ranks as RANKS  # noqa: E402
from test_torch_distributed import RANK_TIMEOUT, TOL, _np_tree, _ranks, _wait  # noqa: E402
from test_torch_distributed import assert_params_match, leaf_parts  # noqa: E402

B_ARCH, S_ARCH = 2, 32  # the every-arch step's batch


def _fan_in(cfg, params: dict) -> dict:
    """Every stacked leaf the initializer scales by default (1/sqrt of the
    repeat count) rescaled to 1/sqrt of its per-layer fan-in."""
    specs = dict(tree_leaves(model_params(cfg)))
    out = {}
    for path, t in tree_leaves(params):
        s = specs[path]
        if path.startswith("slots/") and s.init == "normal" and s.scale is None:
            t = t * math.sqrt(s.shape[0] / s.shape[1])
        out[path] = t
    return unflatten(out)


def _arch_case(arch):
    """(fp32 weights, a (1, B, S) batch) of ``arch``'s smoke config."""
    cfg = smoke_t(arch).replace(**RANKS.F32)
    params = _fan_in(cfg, init_params(model_params(cfg), torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(3)
    labels = rng.integers(0, cfg.vocab, size=(1, B_ARCH, S_ARCH)).astype(np.int32)
    labels[..., ::7] = -1
    d, nf = cfg.d_model, cfg.n_frontend_tokens
    if cfg.frontend == "audio":
        batch = {"frontend": rng.standard_normal((1, B_ARCH, S_ARCH, d)).astype(np.float32)}
    elif cfg.frontend == "vlm":
        labels[..., :nf] = -1
        batch = {"frontend": (0.02 * rng.standard_normal((1, B_ARCH, nf, d))).astype(np.float32),
                 "tokens": rng.integers(4, cfg.vocab, (1, B_ARCH, S_ARCH - nf)).astype(np.int32)}
    else:
        batch = {"tokens": rng.integers(4, cfg.vocab, (1, B_ARCH, S_ARCH)).astype(np.int32)}
    batch["labels"] = labels
    return params, {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.cache
def _inits():
    out = {}
    for name, (arch, kw, *_rest) in RANKS.TP_STEPS.items():
        cfg = smoke_j(arch).replace(**kw)
        out[name] = _np_tree(init_state_j(cfg, TrainConfigJ(), jax.random.PRNGKey(0)).tree())
    out["archs"] = {arch: _arch_case(arch) for arch in RANKS.MEGATRON_ARCHS}
    return out


JAX_REFERENCE = """
import os, sys, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, SRC); sys.path.insert(0, HERE)
import jax, jax.numpy as jnp, numpy as np
from repro import compat
from repro.configs import smoke_config
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.optim import AdamWConfig
from repro.train.train import TrainConfig, compile_train_step
import torch_mesh_ranks as RANKS
with open(os.path.join(D, "init.pkl"), "rb") as f:
    init = pickle.load(f)
tcfg = TrainConfig(optimizer=AdamWConfig(), warmup_steps=1, total_steps=10)
out = {}
for name, (arch, kw, shape, B, S, A, steps) in RANKS.TP_STEPS.items():
    cfg = smoke_config(arch).replace(**kw)
    mesh = compat.make_mesh(shape, ("data", "model"), devices=jax.devices()[:shape[0] * shape[1]])
    data = SyntheticLM(DataConfig(global_batch=B, seq_len=S, vocab=cfg.vocab,
                                  accum_steps=A, pad_fraction=0.2))
    state = jax.tree_util.tree_map(jnp.asarray, init[name])
    _, call = compile_train_step(cfg, mesh, tcfg, state, data.batch_at(0))
    hist = []
    for i in range(steps):
        state, m = call(state, data.batch_at(i))
        hist.append({k: np.asarray(v) for k, v in m.items()})
    out[name] = {"hist": hist, "params": jax.tree_util.tree_map(np.asarray, state["params"])}
with open(os.path.join(D, "jax_out.pkl"), "wb") as f:
    pickle.dump(out, f)
print("OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX reference and both rank phases, started together; returns
    (port outputs, JAX outputs)."""
    import pickle

    d = str(tmp_path_factory.mktemp("tp"))
    inits = _inits()
    with open(os.path.join(d, "init.pkl"), "wb") as f:
        pickle.dump({k: v for k, v in inits.items() if k != "archs"}, f)
    torch.save(inits, os.path.join(d, "init.pt"))
    prog = f"SRC = {SRC!r}\nHERE = {HERE!r}\nD = {d!r}\n" + textwrap.dedent(JAX_REFERENCE)
    ref = subprocess.Popen([sys.executable, "-c", prog], stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        four, two = _ranks("tp4", 4, d), _ranks("tp2", 2, d)
        _wait(four, "tp4 ranks")
        _wait(two, "tp2 ranks")
        _, err = ref.communicate(timeout=RANK_TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-4000:]
    port = {}
    for phase in ("tp4", "tp2"):
        port.update(torch.load(os.path.join(d, f"out_{phase}.pt"), weights_only=False))
    with open(os.path.join(d, "jax_out.pkl"), "rb") as f:
        jax_out = pickle.load(f)
    return port, jax_out


def _one_rank_steps(name: str) -> dict:
    """path -> the port's final leaf after the same steps on one rank."""
    from repro_torch.convert import from_jax_train_state

    arch, kw, shape, B, S, A, steps = RANKS.TP_STEPS[name]
    cfg = smoke_t(arch).replace(**kw)
    state = from_jax_train_state(_inits()[name], cfg, "cpu")
    step, data = make_train_step(cfg, RANKS.tcfg()), RANKS.data_for(cfg, B, S, A)
    for i in range(steps):
        state, _ = step(state, data.batch_at(i))
    return {f"params/{p}": t.detach() for p, t in state.model.named_params().items()}


@pytest.mark.parametrize("name", list(RANKS.TP_STEPS))
def test_tensor_parallel_steps_match_jax(runs, name):
    """Losses and ``grad_norm`` within 1e-4 of JAX's; every leaf under
    ``test_torch_distributed``'s gate, but for a leaf on which the port's
    own one-rank run of the same steps fails that gate: that leaf stays
    within twice the one-rank run's L2 distance from JAX's. Only glm4's
    zero-initialized q/k/v biases are such leaves. RoPE leaves half of
    each head's dims unrotated, where the k bias shifts all of a query's
    scores alike and softmax cancels it, and turns the low-frequency half
    little over 32 positions: most of its gradient is fp32 noise, whose
    sign sets a full Adam step (the port's one-rank fp32 k bias lies
    further from a float64 run's than JAX's does, ROADMAP Queue 3)."""
    port, ref = runs
    one = _one_rank_steps(name)
    hard = []
    for path, (t, w, w0) in assert_params_match(port[name], ref[name], _inits()[name]).items():
        if leaf_parts(one[path], w, w0) is None:
            assert leaf_parts(t, w, w0) is None, path
            continue
        hard.append(path.rsplit("/", 1)[1])
        w = np.asarray(w, np.float32)
        assert np.linalg.norm(t.numpy() - w) <= 2 * np.linalg.norm(one[path].numpy() - w), path
    assert set(hard) <= {"bq", "bk", "bv"}, hard


def _one_rank(arch):
    params, batch = _inits()["archs"][arch]
    cfg = smoke_t(arch).replace(**RANKS.F32)
    model = Transformer(cfg, params, "cpu")
    state = TrainState(model, adamw_init(model.named_params(), RANKS.tcfg().optimizer))
    _, m = make_train_step(cfg, RANKS.tcfg())(state, batch)
    return m


@pytest.mark.parametrize("arch", RANKS.MEGATRON_ARCHS)
def test_every_megatron_arch_steps_on_one_by_two_as_on_one_rank(runs, arch):
    from repro_torch.distributed.sharding import effective_strategy
    from repro_torch.launch.mesh import Mesh

    cfg = smoke_t(arch)
    assert effective_strategy(cfg, Mesh((1, 2), ("data", "model"))) == "megatron"
    got, want = runs[0]["archs"][arch], _one_rank(arch)
    for k in ("loss", "grad_norm"):
        assert got[k] == pytest.approx(float(want[k]), abs=TOL, rel=TOL), k


def _matmul_flops(per: dict) -> float:
    return sum(per.get(k, 0.0) for k in ("aten.mm", "aten.addmm", "aten.bmm"))


def test_a_one_by_two_rank_counts_half_the_matmul_flops(runs):
    from repro_torch.core.profile import StepProfile
    from repro_torch.train.train import init_state

    cfg = smoke_t("tinyllama-1.1b")
    state = init_state(cfg, RANKS.tcfg(), seed=0, device="cpu")
    _, prof = StepProfile.count(make_train_step(cfg, RANKS.tcfg()), state,
                                RANKS.data_for(cfg, 4, 32, 1).batch_at(0))
    one = _matmul_flops({k: c.flops for k, c in prof.per_computation.items()})
    rank = _matmul_flops(runs[0]["counted"]["flops"])
    assert one > 0 and rank / one == pytest.approx(0.5, rel=1e-2)


def test_a_rank_computes_its_heads_on_its_sequence_half(runs):
    """tinyllama smoke on (1, 2), B 4 x S 32: the attention kernel's wrapper
    gets the rank's 2 of 4 heads at the whole sequence, every RMSNorm the
    rank's 16 positions, and every split leaf arrives as its "model"
    block: no gather assembles over "model"."""
    cfg = smoke_t("tinyllama-1.1b")
    seen = runs[0]["counted"]
    hd = cfg.head_dim_
    assert seen["flash"] and set(seen["flash"]) == {((4, 32, 2, hd), (4, 32, 2, hd))}
    assert seen["rmsnorm"] and set(seen["rmsnorm"]) == {(4, 16, cfg.d_model)}
    specs = {spec for spec, _, _ in seen["gather"]}
    assert not any("model" in (e if isinstance(e, tuple) else (e,)) for sp in specs for e in sp)
    shapes = {shape for _, shape, _ in seen["gather"]}
    for shape in ((cfg.d_model, cfg.n_heads * hd // 2), (cfg.n_heads * hd // 2, cfg.d_model),
                  (cfg.d_model, cfg.d_ff // 2), (cfg.d_ff // 2, cfg.d_model),
                  (cfg.d_model, cfg.vocab_padded // 2)):
        assert shape in shapes, shape
    # a split leaf's gradient sums over "data" alone, a whole leaf's over both
    assert {axes for _, _, axes in seen["gather"]} == {("data",), ("data", "model")}


# ---------------------------------------------------------------------------
# in one process: each rank's partial sums add up to the whole layer
# ---------------------------------------------------------------------------


class _RankOf:
    """Rank ``index`` of ``size`` along "model" without a process group: the
    sequence collectives are the identity, so a layer returns its rank's
    partial sums of the whole sequence."""

    part = TensorParallel.part

    def __init__(self, size, index):
        self.size, self.index = size, index

    def seq_gather(self, x):
        return x

    def seq_scatter(self, y):
        return y


def _blocks(params: dict, specs: dict, tp, split) -> dict:
    """Each leaf's "model" block where ``split`` says the rank computes
    with it, else the whole leaf."""
    from repro_torch.launch.mesh import Mesh

    mesh = Mesh((1, tp.size), ("data", "model"))
    mesh.rank = tp.index
    out = {}
    for path, t in tree_leaves(params):
        spec = tuple("model" if ax in ("qkv", "kv", "mlp", "experts") else None
                     for ax in specs[path].logical)
        out[path] = NamedSharding(mesh, spec).local(t) if split(path) else t
    return unflatten(out)


def _f32(arch, **over):
    return smoke_t(arch).replace(**RANKS.F32, **over)


@pytest.mark.parametrize("heads,kv,model", [(4, 4, 2), (4, 2, 4), (6, 3, 2), (6, 2, 2)],
                         ids=["even", "kv_for_two_ranks", "groups_straddle", "groups_of_three"])
def test_rank_attention_heads_sum_to_the_whole_block(heads, kv, model):
    from repro_torch.layers import attention as A

    cfg = _f32("glm4-9b", n_heads=heads, n_kv_heads=kv, head_dim=32)
    specs = dict(tree_leaves(A.attention_params(cfg)))
    gen = torch.Generator().manual_seed(1)
    params = unflatten({p: torch.randn(s.shape, generator=gen) * 0.2 for p, s in specs.items()})
    x = torch.randn(2, 24, cfg.d_model, generator=gen)
    pos = torch.arange(24).expand(2, 24)
    kw = dict(positions=pos, cache=None, cache_len=None, block_tables=None)
    whole = A.attention_block(params, x, cfg, **kw)
    total = 0
    for r in range(model):
        tp = _RankOf(model, r)
        split = (lambda p: p in ("wq", "wo", "bq") or (kv % model == 0 and p[1:] in ("k", "v")))
        total = total + A.attention_block(_blocks(params, specs, tp, split), x, cfg, tp=tp, **kw)
    np.testing.assert_allclose(total.numpy(), whole.numpy(), atol=2e-5, rtol=2e-5)


def test_rank_mlp_and_moe_sum_to_the_whole_block():
    from repro_torch.layers import ffn as FFN
    from repro_torch.layers.common import LogicalConstraints

    gen = torch.Generator().manual_seed(2)
    for arch in ("tinyllama-1.1b", "qwen3-moe-30b-a3b"):
        cfg = _f32(arch)
        tree = FFN.moe_params(cfg) if cfg.moe else FFN.mlp_params(cfg)
        specs = dict(tree_leaves(tree))
        params = unflatten({p: torch.randn(s.shape, generator=gen) * 0.1 for p, s in specs.items()})
        x = torch.randn(2, 40, cfg.d_model, generator=gen)
        if cfg.moe:
            whole, aux = FFN.moe_block(params, x, cfg)
        else:
            whole = FFN.mlp_block(params, x, cfg)
        total = 0
        for r in range(2):
            tp = _RankOf(2, r)
            rank_params = _blocks(params, specs, tp, lambda p: p != "router")
            if cfg.moe:
                out, rank_aux = FFN.moe_block(rank_params, x, cfg,
                                              LogicalConstraints(None, None, tp=tp))
                for k, v in aux.items():
                    assert torch.equal(rank_aux[k], v), k
            else:
                out = FFN.mlp_block(rank_params, x, cfg, tp)
            total = total + out
        np.testing.assert_allclose(total.numpy(), whole.numpy(), atol=2e-5, rtol=2e-5)


def test_tensor_parallel_is_off_where_the_compute_cannot_split():
    from repro_torch.launch.mesh import Mesh

    shape_only = Mesh((1, 2), ("data", "model"))  # no process group
    assert TensorParallel.of(smoke_t("tinyllama-1.1b"), shape_only) is None
    assert TensorParallel.of(smoke_t("tinyllama-1.1b"), None) is None
    sh = NamedSharding(shape_only, ("data", ("data", "model"), "model", None))
    assert sh.without("model").spec == ("data", "data", None, None)
