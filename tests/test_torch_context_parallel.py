"""fsdp's context-parallel fallback: where the batch does not split over
the mesh's ``"model"`` axis, the ``"model"`` ranks split the sequence
(JAX's fsdp activation rules: ``"seq_q": "model"``, K and V gathered),
against JAX's GSPMD runs on meshes of the same shape; and the
``optimized_config`` preset that sends the small megatron archs there.

The ranks are ``gloo`` processes on the CPU (``tests/torch_mesh_ranks.py``,
phases ``cp2`` and ``cp4``), started by one fixture beside one JAX
subprocess a reference run (4 host devices each); both start from the same
JAX initial states (xlstm's stacked leaves redrawn at their per-layer
fan-in, as ``tests/test_torch_ssm_parallel.py`` draws zamba2's). Checked:

* gemma2-2b smoke (window cut to 8 so that it bites at S 32, the same on
  both sides), xlstm-350m smoke and tinyllama-1.1b smoke under
  ``optimized_config`` (fsdp) in fp32 on (1, 2) at B 1: 2 steps, loss and
  ``grad_norm`` within 1e-4 of JAX's, the parameters under
  ``test_torch_ssm_parallel.assert_leaves_match``; each rank's attention
  kernel call takes its query block at its true positions (16..31 on rank
  1) against all 32 keys;
* the same archs at B 2, which divides ``data x model``: the ranks split
  the rows only (whole sequences at positions 0..31), and the steps equal
  the port's one-rank steps;
* qwen3-moe-30b-a3b smoke under ``optimized_config`` at B 1 on (1, 2):
  the MoE FFN routes the gathered sequence as one group; the steps equal
  the port's one-rank steps;
* on (2, 2): gemma2 at B 1 (the ``"data"`` peers on the same row, the
  ``"model"`` peers splitting its sequence) and at B 2 (rows over
  ``"data"``, the sequence over ``"model"``), and tinyllama's megatron
  step at B 1 (tensor parallel, the ``"data"`` peers on the same row:
  their identical gradients count once), each against the port's
  one-rank steps;
* ``optimized_config`` equals JAX's on every field for all ten archs;
  ``launch.train --smoke --optimized`` trains fsdp on the CPU;
* in one process, the attention kernel's plain version on a query block
  at offset positions (causal, sliding window, softcap) gives those rows
  of the whole attention, and the blocks' dK, dV add up to the whole's.
"""

import dataclasses
import functools
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import optimized_config as optimized_j  # noqa: E402
from repro.configs import smoke_config as smoke_j  # noqa: E402
from repro.train.train import TrainConfig as TrainConfigJ  # noqa: E402
from repro.train.train import init_state as init_state_j  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.configs import optimized_config as optimized_t  # noqa: E402
from repro_torch.configs import smoke_config as smoke_t  # noqa: E402
from repro_torch.distributed.shard import ContextParallel  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_mesh_ranks as RANKS  # noqa: E402
from test_torch_distributed import TOL, _np_tree, _ranks, _wait  # noqa: E402
from test_torch_ssm_parallel import _fan_in_state, assert_leaves_match  # noqa: E402
from test_torch_ssm_parallel import collect_jax, start_jax  # noqa: E402
from repro_torch.train.train import make_train_step  # noqa: E402

JAX_RUNS = ("gemma2_cp", "xlstm_cp", "tinyllama_opt_cp")
ONE_RANK_RUNS = [n for n in RANKS.CP_STEPS if n not in JAX_RUNS]


def _cfg(name):
    arch, kw = RANKS.CP_STEPS[name][:2]
    return RANKS.config_for(arch, kw)


@functools.cache
def _init_of(arch: str, kw: tuple) -> dict:
    """JAX's initial state (numpy) of ``arch``'s smoke config with ``kw``
    (xlstm's at fan-in), drawn once for the entries that share it."""
    tree = _np_tree(init_state_j(smoke_j(arch).replace(**dict(kw)), TrainConfigJ(),
                                 jax.random.PRNGKey(0)).tree())
    return _fan_in_state(smoke_t(arch).replace(**dict(kw)), tree) \
        if arch == "xlstm-350m" else tree


@functools.cache
def _inits():
    """The JAX initial state of every entry (numpy)."""
    return {name: _init_of(arch, tuple(sorted((k, v) for k, v in kw.items()
                                              if k != "optimized")))
            for name, (arch, kw, *_rest) in RANKS.CP_STEPS.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references and both rank phases, started together; returns
    (port outputs, JAX outputs)."""
    import pickle

    d = str(tmp_path_factory.mktemp("cp"))
    inits = _inits()
    with open(os.path.join(d, "init.pkl"), "wb") as f:
        pickle.dump({n: inits[n] for n in JAX_RUNS}, f)
    torch.save(inits, os.path.join(d, "init.pt"))
    ref = start_jax(d, "CP_STEPS", JAX_RUNS)
    try:
        four, two = _ranks("cp4", 4, d), _ranks("cp2", 2, d)
        _wait(four, "cp4 ranks")
        _wait(two, "cp2 ranks")
    finally:
        jax_out = collect_jax(d, ref)
    port = {}
    for phase in ("cp4", "cp2"):
        port.update(torch.load(os.path.join(d, f"out_{phase}.pt"), weights_only=False))
    return port, jax_out


@functools.cache
def _one_rank_steps(name: str) -> dict:
    """path -> the port's final leaf after ``name``'s steps on one rank; and
    the steps' metrics under ``"hist"``."""
    from repro_torch.convert import from_jax_train_state

    arch, kw, shape, B, S, A, steps = RANKS.CP_STEPS[name]
    cfg = RANKS.config_for(arch, kw)
    state = from_jax_train_state(_inits()[name], cfg, "cpu")
    step, data = make_train_step(cfg, RANKS.tcfg()), RANKS.data_for(cfg, B, S, A)
    hist = []
    for i in range(steps):
        state, m = step(state, data.batch_at(i))
        hist.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    out = {f"params/{p}": t.detach() for p, t in state.model.named_params().items()}
    out["hist"] = hist
    return out


def _close(a, b, tol=TOL) -> bool:
    return abs(float(a) - float(b)) <= tol * max(1.0, abs(float(b)))


@pytest.mark.parametrize("name", JAX_RUNS)
def test_context_parallel_steps_match_jax(runs, name):
    """Per step the loss within 1e-4 of JAX's, and ``grad_norm`` too, but
    where the port's one-rank run of the same steps misses JAX's by as
    much: there the mesh run's is the one-rank run's within 1e-6 (the
    split adds nothing). Only tinyllama's second step is such a step: an
    embedding element whose first gradient is fp32 noise takes a full
    Adam step of the other sign in the port's fp32 run (its parameters
    part from a float64 run's at that one element, JAX's at none), and the
    second ``grad_norm`` moves 9.8e-5 from the float64 run's, JAX's 2.1e-5
    (ROADMAP Queue 3). The leaves under ``assert_leaves_match``."""
    port, ref = runs
    got, want, one = port[name], ref[name], _one_rank_steps(name)
    for g, w, o in zip(got["hist"], want["hist"], one["hist"], strict=True):
        assert _close(g["loss"], w["loss"])
        assert float(g["tokens"]) == float(w["tokens"])
        if not _close(o["grad_norm"], w["grad_norm"]):
            assert _close(g["grad_norm"], o["grad_norm"], 1e-6)
            continue
        assert _close(g["grad_norm"], w["grad_norm"])
    from repro_torch.layers.common import tree_leaves

    params, start = dict(tree_leaves(want["params"])), dict(tree_leaves(_inits()[name]["params"]))
    leaves = {p: (t, params[p[len("params/"):]], start[p[len("params/"):]])
              for p, t in got["final"].items() if p.startswith("params/")}
    assert_leaves_match(leaves, _cfg(name))


@pytest.mark.parametrize("name", JAX_RUNS)
def test_a_rank_attends_its_query_block_at_its_positions(runs, name):
    """B 1, S 32 on (1, 2): rank r's queries are positions 16 r .. 16 r + 15,
    its keys all 32 positions, at the arch's heads (no head split)."""
    cfg = _cfg(name)
    want = [[((1, 16, cfg.n_heads, cfg.head_dim_), (1, 32, cfg.n_kv_heads, cfg.head_dim_),
               16 * r, 16 * r + 15, 0, 31)] if _attends(cfg) else [] for r in range(2)]
    assert runs[0][name]["flash"] == want


def _attends(cfg) -> bool:
    return any(k in ("attn", "local_attn", "moe") for k in cfg.pattern)


@pytest.mark.parametrize("name", [n for n in ONE_RANK_RUNS if n.endswith("_rows")])
def test_a_batch_that_fills_the_mesh_still_splits_rows_only(runs, name):
    """B 2 on (1, 2): each rank attends one whole row, queries and keys at
    0..31, and the steps are the port's one-rank steps."""
    cfg = _cfg(name)
    whole = [((1, 32, cfg.n_heads, cfg.head_dim_), (1, 32, cfg.n_kv_heads, cfg.head_dim_),
              0, 31, 0, 31)] if _attends(cfg) else []
    assert runs[0][name]["flash"] == [whole, whole]
    _assert_one_rank(name, runs[0][name])


def _assert_one_rank(name: str, got: dict) -> None:
    """A mesh run's losses and ``grad_norm`` within 1e-4 of the port's
    one-rank steps, its leaves under ``assert_leaves_match`` against them."""
    one = _one_rank_steps(name)
    for g, w in zip(got["hist"], one["hist"], strict=True):
        for k in ("loss", "grad_norm"):
            assert float(g[k]) == pytest.approx(w[k], abs=TOL, rel=TOL), k
    from repro_torch.layers.common import tree_leaves

    start = dict(tree_leaves(_inits()[name]["params"]))
    leaves = {p: (t, one[p].numpy(), start[p[len("params/"):]])
              for p, t in got["final"].items() if p.startswith("params/")}
    assert_leaves_match(leaves, _cfg(name))


@pytest.mark.parametrize("name", ["gemma2_cp22", "gemma2_cp22_b2", "tinyllama_tp22"])
def test_two_by_two_steps_equal_one_rank(runs, name):
    """On (2, 2) the ``"data"`` peers of a batch too small for them hold the
    same row and count its gradient once, whether the ``"model"`` peers
    split its sequence (fsdp) or its heads (megatron)."""
    got = runs[0][name]
    cfg = _cfg(name)
    if name.startswith("gemma2"):  # a query block of one row a rank
        assert got["flash"] == [[((1, 16, cfg.n_heads, cfg.head_dim_),
                                  (1, 32, cfg.n_kv_heads, cfg.head_dim_), 16 * r, 16 * r + 15,
                                  0, 31)] for r in (0, 1, 0, 1)]
    _assert_one_rank(name, got)


def test_moe_under_context_parallelism_equals_one_rank(runs):
    """qwen3-moe smoke under ``optimized_config`` (fsdp, capacity factor
    1.0) at B 1 on (1, 2): each rank routes the gathered sequence as one
    group, keeps its part, and the steps are the port's one-rank steps."""
    cfg = _cfg("qwen3_opt_cp")
    assert cfg.sharding == "fsdp" and cfg.moe.capacity_factor == 1.0
    assert runs[0]["qwen3_opt_cp"]["flash"] == [
        [((1, 16, cfg.n_heads, cfg.head_dim_), (1, 32, cfg.n_kv_heads, cfg.head_dim_),
          16 * r, 16 * r + 15, 0, 31)] for r in range(2)]
    _assert_one_rank("qwen3_opt_cp", runs[0]["qwen3_opt_cp"])


# ---------------------------------------------------------------------------
# the preset and the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list_archs())
def test_optimized_config_equals_jax_field_by_field(arch):
    cj, ct = optimized_j(arch), optimized_t(arch)
    names = [f.name for f in dataclasses.fields(cj)]
    assert names == [f.name for f in dataclasses.fields(ct)]
    for name in names:
        vj, vt = getattr(cj, name), getattr(ct, name)
        if dataclasses.is_dataclass(vj):
            assert dataclasses.asdict(vj) == dataclasses.asdict(vt), (arch, name)
        else:
            assert vj == vt, (arch, name)


def test_optimized_smoke_config_takes_the_full_archs_strategy():
    """The smoke config under the preset: the fields JAX's preset sets, with
    fsdp read from the full arch (a smoke config is always under 5e9)."""
    for arch in list_archs():
        full, smoke = optimized_j(arch), optimized_t(arch, smoke_t(arch))
        assert smoke.sharding == full.sharding, arch
        assert (smoke.causal_skip, smoke.q_chunk, smoke.kv_chunk) == (
            full.causal_skip, full.q_chunk, full.kv_chunk), arch
        if full.moe:
            assert smoke.moe.capacity_factor == full.moe.capacity_factor == 1.0
    assert optimized_t("tinyllama-1.1b", smoke_t("tinyllama-1.1b")).sharding == "fsdp"
    assert optimized_t("command-r-35b", smoke_t("command-r-35b")).sharding == "megatron"


def test_train_launcher_optimized_runs_fsdp_on_the_cpu(capsys, tmp_path):
    from repro_torch.launch import train

    assert train.main(["--arch", "tinyllama-1.1b", "--smoke", "--optimized", "--device", "cpu",
                       "--steps", "2", "--global-batch", "2", "--seq-len", "32",
                       "--talp-out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "fsdp strategy" in out and "loss" in out


# ---------------------------------------------------------------------------
# in one process: query blocks at their positions add up to the whole
# ---------------------------------------------------------------------------


class _Mesh:
    """What ``ContextParallel.of`` reads of a mesh over a process group."""

    distributed = True

    def __init__(self, data, model):
        self.sizes = {"data": data, "model": model}
        self.axis_names = ("data", "model")
        self.devices = type("D", (), {"shape": (data, model)})()

    def coords(self, rank=None):
        return {"data": 0, "model": 0}

    def group(self, axes):
        return None


def test_context_parallel_engages_only_where_the_batch_leaves_model_whole():
    from repro_torch.distributed.shard import BatchRanks
    from repro_torch.distributed.sharding import activation_rules
    from repro_torch.layers.common import LogicalConstraints

    fsdp, mega = smoke_t("gemma2-2b"), smoke_t("tinyllama-1.1b")
    for (data, model), B, want in (((1, 2), 1, True), ((1, 2), 2, False), ((2, 2), 1, True),
                                   ((2, 2), 2, True), ((2, 2), 4, False), ((2, 1), 1, False)):
        mesh = _Mesh(data, model)
        lc = LogicalConstraints(mesh, activation_rules(fsdp, mesh))
        ranks = BatchRanks.for_batch(lc, (B, 32))
        assert (ContextParallel.of(fsdp, mesh, ranks) is not None) == want, (data, model, B)
        assert ContextParallel.of(mega, mesh, ranks) is None


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal,window,softcap", [(True, None, None), (True, 12, 50.0),
                                                   (False, None, 30.0)],
                         ids=["causal", "window_softcap", "bidirectional_softcap"])
def test_query_blocks_at_their_positions_give_the_whole_attention(n, causal, window, softcap):
    gen = torch.Generator().manual_seed(5)
    B, S, hq, hkv, D = 2, 48, 4, 2, 16
    q, k, v, cot = (torch.randn(B, S, h, D, generator=gen) for h in (hq, hkv, hkv, hq))
    pos = torch.arange(S).expand(B, S)
    kw = dict(causal=causal, window=window, softcap=softcap)
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    whole = flash_attention(*leaves, q_positions=pos, k_positions=pos, **kw)
    want = torch.autograd.grad((whole * cot).sum(), leaves)
    blk = S // n
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for r in range(n):
        rows = slice(r * blk, (r + 1) * blk)
        qb = q.detach()[:, rows].clone().requires_grad_(True)
        out = flash_attention(qb, k, v, q_positions=pos[:, rows], k_positions=pos, **kw)
        np.testing.assert_allclose(out.detach().numpy(), whole.detach()[:, rows].numpy(),
                                   atol=2e-5, rtol=2e-5)
        gq, gk, gv = torch.autograd.grad((out * cot[:, rows]).sum(), (qb, k, v))
        np.testing.assert_allclose(gq.numpy(), want[0][:, rows].numpy(), atol=2e-5, rtol=2e-5)
        dk, dv = dk + gk, dv + gv
    np.testing.assert_allclose(dk.numpy(), want[1].numpy(), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(dv.numpy(), want[2].numpy(), atol=2e-5, rtol=2e-5)
