"""mamba2 split over a megatron mesh's ``"model"`` axis (zamba2-2.7b's SSM
heads), against JAX's GSPMD runs on meshes of the same shape.

The ranks are ``gloo`` processes on the CPU (``tests/torch_mesh_ranks.py``,
phases ``ssm2`` and ``ssm4``), started once by one fixture beside one JAX
subprocess with 4 host devices; both start from the same JAX initial
state with its stacked leaves redrawn at their per-layer fan-in (at the
reference draw the smoke stack is chaotic in fp32: there a (1, 2) rank's
``grad_norm`` parts from one rank's by 9e-4 while both agree to 1e-14 in
float64, ``tests/test_torch_recurrent.py`` draws the same way). Checked:

* zamba2 smoke in fp32 (16 SSM heads) on (1, 2) and (1, 4): 2 steps,
  loss and ``grad_norm`` within 1e-4 of JAX's, the parameters under
  ``assert_leaves_match`` (``test_torch_distributed``'s gate; the
  zero-initialized leaves under its displacement part); the attention
  kernel's wrapper sees the rank's heads over the whole sequence;
* a (1, 2) rank's counted ``in_proj`` FLOPs are ``(2 d_inner/n + 2 g N +
  h/n) / (2 d_inner + 2 g N + h)`` of one rank's and its ``out_proj``'s
  half, at the smoke width (from the ranks) and at full width (0.5061);
* in one process, ``mamba2_block`` split 2 and 4 ways (each rank's share
  through a stand-in with no process group: the ``out_proj`` partial sums
  and the gated norm's sums of squares added) equals the whole block,
  forward and every leaf's gradient, in fp32 within 2e-5.
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
from repro_torch.configs import get_config as get_t  # noqa: E402
from repro_torch.configs import smoke_config as smoke_t  # noqa: E402
from repro_torch.distributed.shard import SequenceSplit  # noqa: E402
from repro_torch.layers import recurrent as R  # noqa: E402
from repro_torch.layers.common import init_params, tree_leaves  # noqa: E402
from repro_torch.models.transformer import model_params  # noqa: E402
from repro_torch.train.train import make_train_step  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
sys.path.insert(0, HERE)
import torch_mesh_ranks as RANKS  # noqa: E402
from test_torch_distributed import RANK_TIMEOUT, _np_tree, _ranks, _wait  # noqa: E402
from test_torch_distributed import assert_params_match, leaf_parts  # noqa: E402


def _fan_in_state(cfg, tree: dict) -> dict:
    """A JAX state tree (numpy) with every stacked leaf that the initializer
    scales by default redrawn at 1/sqrt of its per-layer fan-in (the
    parameters, and the fp32 master where there is one)."""
    specs = dict(tree_leaves(model_params(cfg)))

    def scaled(path, a):
        s = specs[path]
        if path.startswith("slots/") and s.init == "normal" and s.scale is None:
            return (a.astype(np.float32) * math.sqrt(s.shape[0] / s.shape[1])).astype(a.dtype)
        return a

    def walk(t, prefix=""):
        return {k: (walk(v, f"{prefix}{k}/") if isinstance(v, dict) else scaled(prefix + k, v))
                for k, v in t.items()}

    tree["params"] = walk(tree["params"])
    if "master" in tree["opt_state"]:
        tree["opt_state"]["master"] = walk(tree["opt_state"]["master"])
    return tree


@functools.cache
def _inits():
    out = {}
    for name, (arch, kw, *_rest) in RANKS.SSM_STEPS.items():
        cfg = smoke_j(arch).replace(**kw)
        tree = _np_tree(init_state_j(cfg, TrainConfigJ(), jax.random.PRNGKey(0)).tree())
        out[name] = _fan_in_state(smoke_t(arch).replace(**kw), tree)
    return out


# one mesh run of a ``torch_mesh_ranks`` table's entry NAME (TABLE) in
# JAX, on 4 host devices; ``optimized`` takes JAX's own optimized preset's
# fields onto the smoke config
JAX_REFERENCE = """
import dataclasses, os, sys, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, SRC); sys.path.insert(0, HERE)
import jax, jax.numpy as jnp, numpy as np
from repro import compat
from repro.configs import optimized_config, smoke_config
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.optim import AdamWConfig
from repro.train.train import TrainConfig, compile_train_step
import torch_mesh_ranks as RANKS
with open(os.path.join(D, "init.pkl"), "rb") as f:
    init = pickle.load(f)
tcfg = TrainConfig(optimizer=AdamWConfig(), warmup_steps=1, total_steps=10)
arch, kw, shape, B, S, A, steps = getattr(RANKS, TABLE)[NAME]
kw = dict(kw)
opt = kw.pop("optimized", False)
cfg = smoke_config(arch).replace(**kw)
if opt:
    o = optimized_config(arch)
    cfg = cfg.replace(causal_skip=o.causal_skip, q_chunk=o.q_chunk, kv_chunk=o.kv_chunk,
                      sharding=o.sharding)
    if cfg.moe:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=o.moe.capacity_factor))
mesh = compat.make_mesh(shape, ("data", "model"), devices=jax.devices()[:shape[0] * shape[1]])
data = SyntheticLM(DataConfig(global_batch=B, seq_len=S, vocab=cfg.vocab,
                              accum_steps=A, pad_fraction=0.2))
state = jax.tree_util.tree_map(jnp.asarray, init[NAME])
_, call = compile_train_step(cfg, mesh, tcfg, state, data.batch_at(0))
hist = []
for i in range(steps):
    state, m = call(state, data.batch_at(i))
    hist.append({k: np.asarray(v) for k, v in m.items()})
out = {"hist": hist, "params": jax.tree_util.tree_map(np.asarray, state["params"])}
with open(os.path.join(D, f"jax_{NAME}.pkl"), "wb") as f:
    pickle.dump(out, f)
"""


def start_jax(d: str, table: str, names) -> dict:
    """One JAX subprocess a table entry, all started at once: name -> Popen."""
    procs = {}
    for name in names:
        prog = (f"SRC = {SRC!r}\nHERE = {HERE!r}\nD = {d!r}\nTABLE = {table!r}\n"
                f"NAME = {name!r}\n" + textwrap.dedent(JAX_REFERENCE))
        procs[name] = subprocess.Popen([sys.executable, "-c", prog], stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    return procs


def collect_jax(d: str, procs: dict) -> dict:
    """Wait for ``start_jax``'s runs; name -> their outputs."""
    import pickle

    out = {}
    try:
        for name, p in procs.items():
            _, err = p.communicate(timeout=RANK_TIMEOUT)
            assert p.returncode == 0, f"JAX {name}: " + err[-4000:]
            with open(os.path.join(d, f"jax_{name}.pkl"), "rb") as f:
                out[name] = pickle.load(f)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references and both rank phases, started together; returns
    (port outputs, JAX outputs)."""
    import pickle

    d = str(tmp_path_factory.mktemp("ssm"))
    inits = _inits()
    with open(os.path.join(d, "init.pkl"), "wb") as f:
        pickle.dump(inits, f)
    torch.save(inits, os.path.join(d, "init.pt"))
    ref = start_jax(d, "SSM_STEPS", RANKS.SSM_STEPS)
    try:
        four, two = _ranks("ssm4", 4, d), _ranks("ssm2", 2, d)
        _wait(four, "ssm4 ranks")
        _wait(two, "ssm2 ranks")
    finally:
        jax_out = collect_jax(d, ref)
    port = {}
    for phase in ("ssm4", "ssm2"):
        port.update(torch.load(os.path.join(d, f"out_{phase}.pt"), weights_only=False))
    return port, jax_out


def assert_leaves_match(leaves: dict, cfg) -> None:
    """``leaves`` (``assert_params_match``'s path -> (the port's leaf, the
    reference's, the initial one)) under ``test_torch_distributed``'s gate,
    but for the zero-initialized leaves (a mamba2's ``conv_b`` and
    ``dt_bias``, an sLSTM's bias: 32 to 1,024 elements a smoke stack, so
    one element is up to 3%), which take the gate's displacement part
    alone: after two Adam steps such a leaf holds lr-sized values set by
    m / sqrt(v) of gradients near fp32 noise (the port's own one-rank run
    of the same steps parts from JAX's at an element or two of them too)."""
    zeros = {f"params/{p}" for p, s in tree_leaves(model_params(cfg)) if s.init == "zeros"}
    for path, (t, w, w0) in leaves.items():
        if path not in zeros:
            assert leaf_parts(t, w, w0) is None, path
            continue
        w0 = np.asarray(w0, np.float32)
        moved = np.asarray(w, np.float32) - w0
        assert np.linalg.norm(t.numpy() - w0 - moved) <= 2e-2 * np.linalg.norm(moved), path


@pytest.mark.parametrize("name", list(RANKS.SSM_STEPS))
def test_split_mamba2_steps_match_jax(runs, name):
    """Losses and ``grad_norm`` within 1e-4 of JAX's; the leaves under
    ``assert_leaves_match``."""
    port, ref = runs
    arch, kw = RANKS.SSM_STEPS[name][:2]
    leaves = assert_params_match(port[name], ref[name], _inits()[name])
    assert_leaves_match(leaves, smoke_t(arch).replace(**kw))


@pytest.mark.parametrize("name", list(RANKS.SSM_STEPS))
def test_a_rank_attends_with_its_heads_over_the_whole_sequence(runs, name):
    arch, kw, shape, B, S = RANKS.SSM_STEPS[name][:5]
    cfg = smoke_t(arch)
    hq, hkv = cfg.n_heads // shape[1], cfg.n_kv_heads // shape[1]
    for seen in runs[0][name]["flash"]:
        assert seen == [((B, S, hq, cfg.head_dim_), (B, S, hkv, cfg.head_dim_), 0, S - 1, 0, S - 1)]


def _ratio(cfg, n: int) -> float:
    s = cfg.ssm
    di, gn, h = s.d_inner(cfg.d_model), s.n_groups * s.d_state, s.n_heads(cfg.d_model)
    return (2 * di / n + 2 * gn + h / n) / (2 * di + 2 * gn + h)


def test_a_rank_counts_its_share_of_the_projections(runs):
    """The (1, 2) rank's forward ``in_projection`` and ``out_projection``
    FLOPs against one rank's on the same step."""
    from repro_torch.convert import from_jax_train_state

    arch, kw, shape, B, S, A, _ = RANKS.SSM_STEPS["zamba2_12"]
    cfg = smoke_t(arch).replace(**kw)
    state = from_jax_train_state(_inits()["zamba2_12"], cfg, "cpu")
    one, saved = RANKS.count_projections(R)
    try:
        make_train_step(cfg, RANKS.tcfg())(state, RANKS.data_for(cfg, B, S, A).batch_at(0))
    finally:
        R.in_projection, R.out_projection = saved
    rank = runs[0]["projections"]
    assert one["in_proj"] > 0 and one["out_proj"] > 0
    assert rank["in_proj"] / one["in_proj"] == pytest.approx(_ratio(cfg, 2), rel=1e-12)
    assert rank["out_proj"] / one["out_proj"] == pytest.approx(0.5, rel=1e-12)


def test_full_width_in_proj_share_is_the_formula():
    """zamba2-2.7b at full width on (1, 2): the rank's counted
    ``in_projection`` is 5,288 / 10,448 = 0.5061 of one rank's."""
    from repro_torch.core.profile import StepProfile

    cfg = get_t("zamba2-2.7b").replace(compute_dtype_name="float32")
    s = cfg.ssm
    h = s.n_heads(cfg.d_model)
    w = torch.zeros(cfg.d_model, 2 * s.d_inner(cfg.d_model) + 2 * s.d_state + h)
    x = torch.zeros(1, 4, cfg.d_model)
    _, whole = StepProfile.count(R.in_projection, x, w, cfg, slice(0, h))
    _, rank = StepProfile.count(R.in_projection, x, w, cfg, slice(h // 2, h))
    assert rank.flops / whole.flops == pytest.approx(5288 / 10448, rel=1e-12)
    assert round(rank.flops / whole.flops, 4) == 0.5061 == round(_ratio(cfg, 2), 4)


# ---------------------------------------------------------------------------
# in one process: each rank's share adds up to the whole block
# ---------------------------------------------------------------------------


class _RankOf:
    """Rank ``index`` of ``size`` along "model" without a process group: the
    sequence collectives are the identity (the block returns its partial
    sums of the whole sequence). ``all_reduce`` hands back ``total`` when it
    is set; without it, it records its argument and returns it."""

    part = SequenceSplit.part

    def __init__(self, size, index, total=None):
        self.size, self.index, self.total, self.seen = size, index, total, []

    def seq_gather(self, x):
        return x

    def seq_scatter(self, y):
        return y

    def all_reduce(self, x):
        if self.total is None:
            self.seen.append(x)
            return x
        return self.total


def _rank_params(params: dict, cfg, tp) -> dict:
    """The leaves as a rank gets them: ``MAMBA2_SPLIT_LEAVES`` as its blocks
    (rows of its heads or of its ``d_inner`` part), the rest whole."""
    s = cfg.ssm
    h, p = s.n_heads(cfg.d_model), s.head_dim
    heads = tp.part(h)
    cols = slice(heads.start * p, heads.stop * p)
    out = dict(params)
    for name in ("A_log", "D", "dt_bias"):
        out[name] = params[name][heads]
    out["norm"], out["out_proj"] = params["norm"][cols], params["out_proj"][cols]
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_rank_mamba2_shares_sum_to_the_whole_block(n):
    """Each rank's share, its gated norm's mean from every rank's sums of
    squares: pass one records each rank's sum, pass two hands each rank
    their total (autograd runs through both, so the gradient of every
    leaf carries each rank's use of the total)."""
    cfg = smoke_t("zamba2-2.7b").replace(**RANKS.F32)
    gen = torch.Generator().manual_seed(4)
    params = {path: t.requires_grad_(True)
              for path, t in init_params(R.mamba2_params(cfg), gen, torch.float32).items()}
    with torch.no_grad():  # non-trivial per-head leaves and norm scale
        for name in ("A_log", "D", "dt_bias", "norm", "conv_b"):
            params[name].add_(0.3 * torch.randn(params[name].shape, generator=gen))
    x = torch.randn(2, 64, cfg.d_model, generator=gen)
    cot = torch.randn(2, 64, cfg.d_model, generator=gen)
    whole, _ = R.mamba2_block(params, x, cfg)
    want = torch.autograd.grad((whole * cot).sum(), list(params.values()))

    first = [_RankOf(n, r) for r in range(n)]
    for tp in first:
        R.mamba2_block(_rank_params(params, cfg, tp), x, cfg, tp=tp)
    total = sum(tp.seen[0] for tp in first)
    assert total.shape == (2, 64, 1)
    out = sum(R.mamba2_block(_rank_params(params, cfg, tp), x, cfg, tp=tp)[0]
              for tp in (_RankOf(n, r, total) for r in range(n)))
    np.testing.assert_allclose(out.detach().numpy(), whole.detach().numpy(), atol=2e-5, rtol=2e-5)
    got = torch.autograd.grad((out * cot).sum(), list(params.values()))
    for name, g, w in zip(params, got, want):
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= 2e-5 * scale, (name, float((g - w).abs().max()))
