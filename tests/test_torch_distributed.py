"""The port's training on a mesh of ranks against JAX's on a mesh of the
same shape.

The ranks are ``gloo`` processes on the CPU (``tests/torch_mesh_ranks.py``,
one process a rank, meeting through a ``FileStore`` in the test's
temporary directory, each with its own timeout). The references come
from one JAX subprocess with 4 host devices (as ``tests/test_elastic.py``
runs them), started beside the ranks; both start from the same JAX
initial states. Checked:

* dense: tinyllama smoke in fp32, ``pad_fraction`` 0.2, 2 steps on (2, 2)
  and on (4, 1) with 2 microbatches: loss and ``grad_norm`` within 1e-4,
  ``tokens_per_shard`` equal, each parameter leaf within 1e-4 of its own
  largest |value| but for at most 0.1% of its elements (those whose
  gradient's sign is fp32 noise; their leaf's displacement then within
  2e-2 in relative L2, the gate of ``test_torch_train``);
* placement: every rank holds exactly the blocks that JAX's shardings put
  on the device at its mesh position, and its bytes are its share;
* MoE: qwen3-moe smoke, bf16 parameters computed in fp32, B 4 x S 256 on
  (2, 2) with a router that overloads expert 0: ``expert_load`` equal to
  JAX's each step, the loss JAX's, and a one-group step's loss not
  (the two data shards drop other pairs than one group does);
* the grouped dispatch in one process: G groups drop the pairs JAX's G
  groups drop, and not the pairs of one group;
* the monitored ``TrainLoop`` on (2, 2): the record's resources, mesh,
  ``data_lb`` and ``expert_lb`` against JAX's loop;
* elastic: a state saved from 4 ranks restores bitwise on 2 (and
  ``reshard_state`` of the full leaves gives the same blocks) and, saved
  again, on 4; a JAX checkpoint from a (2, 2) mesh restores on 2 ranks
  with equal values, and one step more is finite;
* world size 1: the mesh step is bitwise the plain step, with no process
  group and with a one-rank one;
* the records at world sizes 1, 2 and 4 render a scaling table in the
  port's ``talp ci-report``.
"""

import functools
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as smoke_j  # noqa: E402
from repro.train.train import TrainConfig as TrainConfigJ  # noqa: E402
from repro.train.train import init_state as init_state_j  # noqa: E402
from repro_torch.configs import smoke_config as smoke_t  # noqa: E402
from repro_torch.convert import from_jax_train_state  # noqa: E402
from repro_torch.layers.common import tree_leaves  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
sys.path.insert(0, HERE)
import torch_mesh_ranks as RANKS  # noqa: E402

TOL = 1e-4
RANK_TIMEOUT = 600  # beside the suite's other workers the ranks run several times slower


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _biased(tree):
    """Every token's residual gains a positive mean and the router's expert 0
    column follows it: expert 0 is every token's first choice, past
    capacity at 512 tokens a group."""
    p = tree["params"]
    p["embed"] = (p["embed"].astype(np.float32) + 0.05).astype(p["embed"].dtype)
    for slot in p["slots"].values():
        r = slot["moe"]["router"]
        r[..., 0] = (r[..., 0].astype(np.float32) + 0.05).astype(r.dtype)
    if "master" in tree["opt_state"]:
        tree["opt_state"]["master"] = jax.tree_util.tree_map(
            lambda a: a.astype(np.float32), p)
    return tree


@functools.cache
def _inits():
    """The JAX initial states (numpy) the references and the ranks share."""
    out = {}
    for name, (arch, kw, *_rest) in RANKS.STEPS.items():
        cfg = smoke_j(arch).replace(**kw)
        out[name] = _np_tree(init_state_j(cfg, TrainConfigJ(), jax.random.PRNGKey(0)).tree())
    out["moe22"] = _biased(out["moe22"])
    arch, kw = RANKS.LOOP[:2]
    out["loop"] = _np_tree(init_state_j(smoke_j(arch).replace(**kw), TrainConfigJ(),
                                        jax.random.PRNGKey(0)).tree())
    return out


JAX_REFERENCE = """
import os, sys, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, SRC); sys.path.insert(0, HERE)
import jax, jax.numpy as jnp, numpy as np
from repro import compat
from repro.checkpoint import save_checkpoint
from repro.configs import smoke_config
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.optim import AdamWConfig
from repro.train.loop import LoopConfig, TrainLoop
from repro.train.train import TrainConfig, compile_train_step
import torch_mesh_ranks as RANKS
with open(os.path.join(D, "init.pkl"), "rb") as f:
    init = pickle.load(f)
tcfg = TrainConfig(optimizer=AdamWConfig(), warmup_steps=1, total_steps=10)
out = {}
for name, (arch, kw, shape, B, S, A, steps) in RANKS.STEPS.items():
    cfg = smoke_config(arch).replace(**kw)
    mesh = compat.make_mesh(shape, ("data", "model"))
    data = SyntheticLM(DataConfig(global_batch=B, seq_len=S, vocab=cfg.vocab,
                                  accum_steps=A, pad_fraction=0.2))
    state = jax.tree_util.tree_map(jnp.asarray, init[name])
    _, call = compile_train_step(cfg, mesh, tcfg, state, data.batch_at(0))
    hist = []
    for i in range(steps):
        state, m = call(state, data.batch_at(i))
        if i == 0:
            pos = {d.id: tuple(int(x) for x in np.argwhere(mesh.devices == d)[0])
                   for d in mesh.devices.flat}
            shards = {"/".join(str(getattr(k, "key", k)) for k in path):
                      {pos[s.device.id]: tuple((sl.start, sl.stop) for sl in s.index)
                       for s in leaf.addressable_shards}
                      for path, leaf in jax.tree_util.tree_leaves_with_path(state)}
        hist.append({k: np.asarray(v) for k, v in m.items()})
    out[name] = {"hist": hist, "params": jax.tree_util.tree_map(np.asarray, state["params"]),
                 "shards": shards}
    if name == "dense22":
        save_checkpoint(state, os.path.join(D, "jax_ckpt"), steps)
        out["jax_ckpt"] = jax.tree_util.tree_map(np.asarray, state)
arch, kw, B, S, steps = RANKS.LOOP
cfg = smoke_config(arch).replace(**kw)
mesh = compat.make_mesh((2, 2), ("data", "model"))
data = SyntheticLM(DataConfig(global_batch=B, seq_len=S, vocab=cfg.vocab, pad_fraction=0.2))
loop = TrainLoop(cfg, mesh, TrainConfig(), data, LoopConfig(steps=steps, lb_sample_every=1))
loop.run()
run = loop.finalize_run()
m = run.regions["train_step"].measurements
out["loop"] = {"resources": run.resources.to_json(), "data_lb": m.data_lb,
               "expert_lb": m.expert_lb, "num_steps": m.num_steps,
               "losses": [h["loss"] for h in loop.metrics_history]}
with open(os.path.join(D, "jax_out.pkl"), "wb") as f:
    pickle.dump(out, f)
print("OK")
"""


def _ranks(phase: str, world: int, d: str) -> list:
    return [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_mesh_ranks.py"), phase, str(r), str(world), d],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _wait(procs: list, what: str) -> None:
    deadline = time.monotonic() + RANK_TIMEOUT
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"{what}: a rank hung past {RANK_TIMEOUT} s")
        logs.append(out)
    bad = [(i, p.returncode) for i, p in enumerate(procs) if p.returncode]
    assert not bad, f"{what}: ranks failed {bad}\n" + "\n".join(x[-3000:] for x in logs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the JAX reference and the 4-rank phase together, then the 2-rank
    and 4-rank restores; returns (port outputs, JAX outputs, directory)."""
    import pickle

    d = str(tmp_path_factory.mktemp("mesh"))
    inits = _inits()
    with open(os.path.join(d, "init.pkl"), "wb") as f:
        pickle.dump(inits, f)
    torch.save(inits, os.path.join(d, "init.pt"))
    prog = f"SRC = {SRC!r}\nHERE = {HERE!r}\nD = {d!r}\n" + textwrap.dedent(JAX_REFERENCE)
    ref = subprocess.Popen([sys.executable, "-c", prog], stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        _wait(_ranks("four", 4, d), "four ranks")
        out, err = ref.communicate(timeout=RANK_TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-4000:]
    _wait(_ranks("two", 2, d), "two ranks")
    _wait(_ranks("back", 4, d), "four ranks again")
    port = {}
    for phase in ("four", "two", "back"):
        port.update(torch.load(os.path.join(d, f"out_{phase}.pt"), weights_only=False))
    with open(os.path.join(d, "jax_out.pkl"), "rb") as f:
        jax_out = pickle.load(f)
    return port, jax_out, d


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------


def leaf_parts(t, w, w0) -> str | None:
    """Why leaf ``t`` fails the gate against JAX's ``w`` (both moved from
    ``w0``), or None: every element within ``TOL`` of the leaf's largest
    |value| but for at most 0.1% of them, and then the leaf's displacement
    within 2e-2 in relative L2."""
    t, w, w0 = _f32(t), _f32(w), _f32(w0)
    off = np.abs(t - w) > TOL * np.abs(w).max()
    # a gradient element of fp32-noise size has a sign that is noise, and
    # Adam turns either sign into a full step of ~lr (test_torch_train's
    # five-step test): such elements may part, a few a leaf, and the
    # leaf's displacement then agrees within 2e-2 in relative L2
    if off.mean() > 1e-3:
        return f"{int(off.sum())} elements off"
    moved = w - w0
    if np.linalg.norm(t - w0 - moved) > 2e-2 * np.linalg.norm(moved):
        return "displacement off"
    return None


def assert_params_match(got: dict, want: dict, init: dict) -> dict:
    """A port mesh run (``hist``, ``final``) against JAX's (``hist``,
    ``params``) from the JAX state ``init``: per step loss and
    ``grad_norm`` within ``TOL``, tokens equal. Returns path -> (the
    port's final leaf, JAX's, the initial one) for the gate."""
    for g, w in zip(got["hist"], want["hist"], strict=True):
        assert float(g["loss"]) == pytest.approx(float(w["loss"]), abs=TOL, rel=TOL)
        assert float(g["grad_norm"]) == pytest.approx(float(w["grad_norm"]), abs=TOL, rel=TOL)
        np.testing.assert_array_equal(_f32(g["tokens_per_shard"]), _f32(w["tokens_per_shard"]))
        assert float(g["tokens"]) == float(w["tokens"])
    params, start = dict(tree_leaves(want["params"])), dict(tree_leaves(init["params"]))
    return {p: (t, params[p[len("params/"):]], start[p[len("params/"):]])
            for p, t in got["final"].items() if p.startswith("params/")}


@pytest.mark.parametrize("name", ["dense22", "dense41"])
def test_dense_mesh_steps_match_jax(runs, name):
    port, ref, _ = runs
    for path, leaves in assert_params_match(port[name], ref[name], _inits()[name]).items():
        assert leaf_parts(*leaves) is None, path


@pytest.mark.parametrize("name", ["dense22", "dense41", "moe22"])
def test_each_rank_holds_exactly_its_jax_blocks(runs, name):
    """Each rank's state blocks are the slices of the initial state that its
    placement names (checked on the rank), its placements are the ones JAX
    put on the device at its mesh position, and its bytes are its share of
    the state under the pspecs."""
    from repro_torch.distributed.shard import NamedSharding
    from repro_torch.launch.mesh import Mesh

    port, ref, _ = runs
    arch, kw, shape = RANKS.STEPS[name][:3]
    cfg = smoke_t(arch).replace(**kw)
    mesh = Mesh(shape, ("data", "model"))
    full = {p: (tuple(t.shape), t.dtype) for p, t in port[name]["final"].items()
            if isinstance(t, torch.Tensor)}
    for rank, info in enumerate(port[name]["held"]):
        assert info["exact"], rank
        assert info["coords"] == mesh.coords(rank)
        want_bytes = 0
        for path, (shp, dt) in full.items():
            spec = info["pspecs"][path]
            split = 1
            for e in spec:
                for a in (() if e is None else (e,) if isinstance(e, str) else e):
                    split *= mesh.sizes[a]
            want_bytes += int(np.prod(shp)) * dt.itemsize // split
            jax_block = ref[name]["shards"][path][tuple(mesh.coords(rank).values())]
            got = NamedSharding(mesh, spec).block_slices(shp, rank)
            assert tuple((s.start, s.stop) for s in got) == tuple(
                (a or 0, shp[i] if b is None else b) for i, (a, b) in enumerate(jax_block)), path
        assert info["bytes"] == want_bytes, rank


def test_moe_mesh_step_routes_and_drops_per_data_shard_as_jax(runs):
    port, ref, d = runs
    got, want = port["moe22"], ref["moe22"]
    for g, w in zip(got["hist"], want["hist"]):
        np.testing.assert_array_equal(_f32(g["expert_load"]), _f32(w["expert_load"]))
        np.testing.assert_array_equal(_f32(g["tokens_per_shard"]), _f32(w["tokens_per_shard"]))
        assert float(g["loss"]) == pytest.approx(float(w["loss"]), abs=TOL, rel=TOL)
        assert float(g["grad_norm"]) == pytest.approx(float(w["grad_norm"]), rel=1e-3)
    # an expert past capacity on average over the layers and the groups:
    # pairs drop in one group and in two
    cfg = smoke_t("qwen3-moe-30b-a3b").replace(**RANKS.MIXED)
    n_group = 2 * 256  # the (2, 2) mesh's 2 data shards of 2 rows
    load = float(want["hist"][0]["expert_load"].max())
    assert load > cfg.n_layers * 2 * cfg.moe.capacity(n_group)
    assert load > cfg.n_layers * cfg.moe.capacity(2 * n_group)
    # one group (the plain step) drops other pairs: its loss is not the mesh's
    from repro_torch.train.train import make_train_step

    state = from_jax_train_state(_inits()["moe22"], cfg, "cpu")
    arch, kw, shape, B, S, A, steps = RANKS.STEPS["moe22"]
    _, m = make_train_step(cfg, RANKS.tcfg())(state, RANKS.data_for(cfg, B, S, A).batch_at(0))
    # (the first layer's drops differ, so the second layer's routing does)
    assert not np.array_equal(_f32(m["expert_load"]), _f32(want["hist"][0]["expert_load"]))
    assert abs(float(m["loss"]) - float(want["hist"][0]["loss"])) > 10 * TOL


def test_grouped_dispatch_drops_the_pairs_jax_groups_drop():
    """In one process: the port's ``moe_block`` over G = 2 groups (a (2, 2)
    mesh's data shards) against JAX's grouped ``moe_block`` (its sharding
    constraints left out), and each group's drops against JAX's
    ``_dispatch_group``; one group drops other pairs."""
    from repro.distributed import sharding as SHJ
    from repro.layers import ffn as FJ
    from repro.layers.common import LogicalConstraints as LCJ
    from repro.layers.common import init_params
    from repro_torch.convert import params_from_numpy
    from repro_torch.distributed import sharding as SHT
    from repro_torch.layers import ffn as FT
    from repro_torch.layers.common import LogicalConstraints as LCT
    from repro_torch.launch.mesh import Mesh

    class GroupsOnly(LCJ):
        def __call__(self, x, *axes):
            return x

    F32 = dict(compute_dtype_name="float32", param_dtype_name="float32")
    cfg_j = smoke_j("qwen3-moe-30b-a3b").replace(**F32)
    cfg_t = smoke_t("qwen3-moe-30b-a3b").replace(**F32)
    mesh = Mesh((2, 2), ("data", "model"))
    params = jax.tree_util.tree_map(
        np.array, init_params(FJ.moe_params(cfg_j), jax.random.PRNGKey(1), jnp.float32))
    params["router"][:, 0] += 0.05
    x = (np.random.default_rng(2).standard_normal((4, 80, cfg_j.d_model)) + 1.0).astype(
        np.float32)
    lc_j = GroupsOnly(mesh, SHJ.activation_rules(cfg_j, mesh))
    lc_t = LCT(mesh, SHT.activation_rules(cfg_t, mesh))
    assert lc_j.group_count("batch", 4) == lc_t.group_count("batch", 4) == 2
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    out_j, aux_j = FJ.moe_block(pj, jnp.asarray(x), cfg_j, lc_j)
    out_t, aux_t = FT.moe_block(params_from_numpy(params), torch.from_numpy(x), cfg_t, lc_t)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=2e-5, rtol=2e-5)
    np.testing.assert_array_equal(aux_t["expert_load"].numpy(), np.asarray(aux_j["expert_load"]))
    for k in ("moe_lb_loss", "moe_z_loss"):
        assert float(aux_t[k]) == pytest.approx(float(aux_j[k]), rel=2e-5)
    m = cfg_j.moe
    xt = x.reshape(2, 160, -1)
    C = m.capacity(160)
    for g in range(2):
        logits = xt[g] @ params["router"]
        keep_j = np.asarray(FJ._dispatch_group(jnp.asarray(xt[g]), jnp.asarray(logits), 8, 2,
                                               C, m.normalize_topk, jnp.float32)[3])
        keep_t = FT._dispatch_group(torch.from_numpy(xt[g]), torch.from_numpy(logits), 8, 2, C,
                                    m.normalize_topk, torch.float32)[3].numpy()
        np.testing.assert_array_equal(keep_t, keep_j)
        assert (~keep_t).sum() > 0
    one, _ = FT.moe_block(params_from_numpy(params), torch.from_numpy(x), cfg_t)
    assert float((one - out_t).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# the loop's record, elastic restores, the scaling table
# ---------------------------------------------------------------------------


def test_train_loop_record_on_a_mesh_matches_jax(runs):
    from repro.core.factors import validate_pop
    from repro.core.records import RunRecord

    port, ref, _ = runs
    rec = RunRecord.load(port["loop4"]["path"])
    m = rec.regions["train_step"].measurements
    want = ref["loop"]
    assert rec.resources.to_json() == want["resources"]
    assert rec.resources.mesh == {"data": 2, "model": 2}
    assert m.num_steps == want["num_steps"] == RANKS.LOOP[-1]
    assert m.data_lb == pytest.approx(want["data_lb"], abs=1e-6)
    assert m.expert_lb == pytest.approx(want["expert_lb"], abs=1e-6)
    assert 0 < m.data_lb < 1 and 0 < m.expert_lb < 1
    assert not any(validate_pop(r.pop) for r in rec.regions.values())
    np.testing.assert_allclose([h["loss"] for h in port["loop4"]["history"]], want["losses"],
                               rtol=1e-3)


def test_checkpoint_restores_bitwise_across_world_sizes(runs):
    """4 ranks save; 2 ranks restore it and save again; 4 ranks restore
    that: every leaf bitwise the one the 4 ranks held."""
    from repro_torch.checkpoint.checkpoint import load_checkpoint

    port, _, d = runs
    assert port["from4"]["reshard_equal"]
    saved4 = port["dense22"]["final"]
    for key in ("from4", "from2"):
        assert port[key]["step"] == 2
        got = port[key]["final"]
        assert set(got) == set(saved4)
        for path, t in saved4.items():
            if isinstance(t, torch.Tensor):
                assert torch.equal(got[path], t), (key, path)
            else:
                assert got[path] == t, (key, path)
    # the files are the format of one process's save: read whole, unsharded
    tree, step = load_checkpoint({p: t for p, t in saved4.items()}, os.path.join(d, "ck2"))
    assert step == 2 and all(torch.equal(tree[p], t) for p, t in saved4.items()
                             if isinstance(t, torch.Tensor))


def test_jax_mesh_checkpoint_restores_on_two_ranks(runs):
    port, ref, _ = runs
    got = port["from_jax"]
    assert got["step"] == 2
    want = dict(tree_leaves(ref["jax_ckpt"]))
    n = 0
    for path, t in got["final"].items():
        if isinstance(t, torch.Tensor):
            np.testing.assert_array_equal(_f32(t), _f32(want[path]))
            n += 1
    assert n == len([p for p in want if p not in ("step", "opt_state/step")])
    assert np.isfinite(got["loss"])


def test_records_at_three_world_sizes_render_a_scaling_table(runs, capsys):
    from repro_torch.core import pages
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.loop import LoopConfig, TrainLoop
    from repro_torch.train.train import TrainConfig

    _, _, d = runs
    arch, kw, B, S, steps = RANKS.LOOP
    cfg = smoke_t(arch).replace(**kw)
    talp = os.path.join(d, "talp")
    loop = TrainLoop(cfg, TrainConfig(), SyntheticLM(DataConfig(
        global_batch=B, seq_len=S, vocab=cfg.vocab, pad_fraction=0.2)),
        LoopConfig(steps=steps, lb_sample_every=1),
        state=from_jax_train_state(_inits()["loop"], cfg, "cpu"),
        mesh=make_host_mesh(device="cpu"))
    loop.run()
    loop.finalize_run(os.path.join(talp, "qwen3", "train"))
    assert pages.main(["ci-report", "-i", talp, "-o", os.path.join(d, "site"),
                       "--regions", "train_step", "--print-tables"]) == 0
    text = capsys.readouterr().out
    table = text.split("== qwen3 / train :: train_step ==")[1].strip().splitlines()
    assert table[0].split("|")[1:] and all(label in table[0] for label in ("1x1", "1x2", "1x4")), \
        table[0]
    rows = {r.split("|")[0].strip(): r.split("|")[1:] for r in table[2:]}
    # every rank runs its share of the step: the (2, 1) machine counts the
    # 1-rank one's FLOPs. On the (2, 2) megatron mesh the "model" peers
    # split their data shard's work (heads, experts, vocabulary): each rank
    # counts a quarter of the 1-rank FLOPs F1 (the capacity buffers too:
    # 4 experts x capacity(64) = 64 slots against 8 x capacity(128) = 128)
    # but for the router's products, which both peers compute on their
    # shard's tokens: R = 3 (forward, and the backward's two) x 2 N d E x
    # layers at N = B S. The machine counts F1 + R, the scaling is
    # F1 / (F1 + R) = 0.9968 (F1 = 483,917,824, R = 1,572,864)
    from repro_torch.core.records import RunRecord

    one = RunRecord.load(loop.session.last_record_path).regions["train_step"].counters
    four = RunRecord.load(runs[0]["loop4"]["path"]).regions["train_step"].counters
    R = 3 * 2 * B * S * cfg.d_model * cfg.moe.n_experts * cfg.n_layers * steps
    assert four.useful_flops == one.useful_flops + R
    want = one.useful_flops / (one.useful_flops + R)
    assert want >= 0.9
    assert [float(v) for v in rows["FLOP (instruction) scaling"]] == [1.0, 1.0, round(want, 2)]
    assert all(0 < float(v) < 1 for v in rows["Data load balance"][1:])
    assert os.path.exists(os.path.join(d, "site", "index.html"))


# ---------------------------------------------------------------------------
# world size 1
# ---------------------------------------------------------------------------


def _one_rank_runs(mesh):
    from repro_torch.train.train import make_train_step

    cfg = smoke_t("tinyllama-1.1b").replace(**RANKS.F32)
    data = RANKS.data_for(cfg, 4, 32, 2)
    out = []
    for m in (None, mesh):
        state = from_jax_train_state(_inits()["dense41"], cfg, "cpu", mesh=m)
        step = make_train_step(cfg, RANKS.tcfg(), m)
        losses = []
        for i in range(2):
            state, metrics = step(state, data.batch_at(i))
            losses.append((metrics["loss"].clone(), metrics["grad_norm"].clone()))
        out.append((losses, {p: t.detach().clone() for p, t in state.model.named_params().items()}))
    return out


@pytest.mark.parametrize("group", [False, True], ids=["no_process_group", "one_rank_gloo"])
def test_world_size_one_mesh_step_is_bitwise_the_plain_step(group, tmp_path):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    if group:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                                world_size=1)
    try:
        mesh = make_host_mesh(device="cpu")
        assert mesh.distributed == group and mesh.sizes == {"data": 1, "model": 1}
        (plain_losses, plain_params), (mesh_losses, mesh_params) = _one_rank_runs(mesh)
    finally:
        if group:
            dist.destroy_process_group()
    for (lp, gp), (lm, gm) in zip(plain_losses, mesh_losses):
        assert torch.equal(lp, lm) and torch.equal(gp, gm)
    for p, t in plain_params.items():
        assert torch.equal(mesh_params[p], t), p


def test_launcher_builds_a_one_by_one_mesh_without_torchrun(tmp_path, capsys, monkeypatch):
    from repro_torch.launch import train as launcher

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert launcher.main(["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu",
                          "--steps", "2", "--global-batch", "2", "--seq-len", "16",
                          "--model-axis", "1", "--talp-out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "[launch] tinyllama-1.1b on cpu: steps 0..1" in out
    assert "[launch] mesh {'data': 1, 'model': 1} over 1 rank(s)" in out
    assert any(n.startswith("talp_1x1_") for n in os.listdir(tmp_path))
    with pytest.raises(ValueError, match="process group"):
        launcher.main(["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu",
                       "--steps", "1", "--model-axis", "2"])

