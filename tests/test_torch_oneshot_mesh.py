"""The one-shot serving steps on a mesh of ranks against JAX's mesh runs.

The ranks are ``gloo`` processes on the CPU (``tests/torch_mesh_ranks.py``,
phases ``oneshot2`` and ``oneshot4``), each holding only its blocks of the
parameters (``train_state_pspecs``' placement) and of the dense caches
(``distributed.sharding.cache_pspec_tree``'s), started by one fixture beside one
JAX subprocess with 4 host devices that jits ``prefill``, ``decode_step``
and ``apply_logits`` with the parameters and caches placed by JAX's rules
(``param_pspecs``, ``cache_pspec_tree``) and its activation constraints.
Both start from the same JAX weights (zamba2's stacked leaves at their
per-layer fan-in), in fp32. The cases (``RANKS.ONESHOT``): tinyllama on
(1, 2) and (2, 2) (KV heads over ``"model"``), glm4 on (1, 4) (2 KV heads:
the cache's sequence over ``"model"``, decode attention combined through
the LSE), gemma2 on (1, 2) (fsdp: a context-parallel prefill, the window
cut to 8 and the softcaps, the cache's KV heads over ``"model"``), zamba2
on (1, 2) (mamba2 over its SSM heads, its conv state a block of the
channels), hubert's encoder step on (1, 2). A B 2 x S 16 prompt into a
cache of 32 positions, then 4 decode steps fed the same tokens on both
sides. Checked: every step's tokens equal JAX's argmax; logits within
``TOL`` (1e-4) of the largest |value|; each rank's cache block (the
spare row dropped) within ``TOL`` of its leaf's largest |value| from the
block of JAX's cache that the placement gives that rank, the placement
equal to JAX's; the (q, k) shapes each rank's attention kernel saw are
its share.

In one process: ``cache_pspec_tree`` / ``serve_cache_pspecs`` give JAX's
placement for every leaf, dense and paged, for all ten archs on the
meshes of ``tests/test_torch_sharding.py`` (duck-typed meshes for JAX's),
and a rank's block shapes (``cache_block_shape``, the spare dense row its
own); the LSE combine of a key sequence split over ranks
(``merge_partials``, threads standing in for the ranks) under a window
and a softcap, with a rank that sees no key, equals the whole attention.
"""

import functools
import math
import os
import pickle
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as get_j  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.configs import smoke_config as smoke_j  # noqa: E402
from repro.layers.common import init_params as init_j  # noqa: E402
from repro.models import transformer as TJ  # noqa: E402
from repro.serve import serve as SJ  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import smoke_config as smoke_t  # noqa: E402
from repro_torch.distributed.shard import NamedSharding  # noqa: E402
from repro_torch.distributed.sharding import effective_strategy  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.layers.common import tree_leaves, unflatten  # noqa: E402
from repro_torch.models.transformer import init_cache, model_params  # noqa: E402
from repro_torch.serve.serve import cache_pspec_tree, serve_cache_pspecs  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
sys.path.insert(0, HERE)
import torch_mesh_ranks as RANKS  # noqa: E402
from test_torch_distributed import RANK_TIMEOUT, _ranks, _wait  # noqa: E402

TOL = 1e-4
FAN_IN = ("zamba2-2.7b",)
ARCHS = list_archs()
MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def _fan_in(arch, cfg_t, tree):
    """Every stacked leaf drawn at the default scale rescaled to its
    per-layer fan-in, in place (numpy)."""
    specs = dict(tree_leaves(model_params(cfg_t)))

    def walk(t, prefix=""):
        for k, v in t.items():
            p = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, p)
            elif p.startswith("slots/") and specs[p].init == "normal" and specs[p].scale is None:
                t[k] = (v * math.sqrt(specs[p].shape[0] / specs[p].shape[1])).astype(v.dtype)

    walk(tree)
    return tree


@functools.cache
def _inits():
    out = {}
    for name, (arch, kw, shape, B, S, max_len, steps) in RANKS.ONESHOT.items():
        cfg_j = smoke_j(arch).replace(**kw)
        tree = jax.tree_util.tree_map(np.asarray, init_j(TJ.model_params(cfg_j),
                                                         jax.random.PRNGKey(0), cfg_j.param_dtype))
        if arch in FAN_IN:
            tree = _fan_in(arch, RANKS.config_for(arch, kw), tree)
        rng = np.random.default_rng(5)
        if cfg_j.frontend == "audio":
            batch = {"frontend": rng.standard_normal((B, S, cfg_j.d_model)).astype(np.float32)}
        else:
            batch = {"tokens": rng.integers(4, cfg_j.vocab, (B, S)).astype(np.int32)}
        decode = [rng.integers(4, cfg_j.vocab, (B, 1)).astype(np.int32) for _ in range(steps)]
        out[name] = {"params": tree, "batch": batch, "decode": decode}
    return out


JAX_REFERENCE = """
import os, sys, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, SRC); sys.path.insert(0, HERE)
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.configs import smoke_config
from repro.distributed import sharding as SH
from repro.layers.common import LogicalConstraints, param_pspecs
from repro.models import transformer as T
from repro.serve.serve import cache_pspec_tree
import torch_mesh_ranks as RANKS
with open(os.path.join(D, "init.pkl"), "rb") as f:
    init = pickle.load(f)

def placed(mesh, tree):
    return jax.tree_util.tree_map(lambda p: compat.named_sharding(mesh, p), tree,
                                  is_leaf=lambda x: isinstance(x, P))

def rows(mesh, x):
    spec = [None] * x.ndim
    spec[0] = SH.divisible_batch_axes(mesh, x.shape[0])
    return compat.named_sharding(mesh, P(*spec))

out = {}
for name, (arch, kw, shape, B, S, max_len, steps) in RANKS.ONESHOT.items():
    cfg = smoke_config(arch).replace(**kw)
    mesh = compat.make_mesh(shape, ("data", "model"), devices=jax.devices()[:shape[0] * shape[1]])
    lc = LogicalConstraints(mesh, SH.activation_rules(cfg, mesh))
    params = jax.tree_util.tree_map(jnp.asarray, init[name]["params"])
    p_sh = placed(mesh, param_pspecs(T.model_params(cfg), SH.param_rules(cfg, mesh), mesh))
    batch = {k: jnp.asarray(v) for k, v in init[name]["batch"].items()}
    b_sh = {k: rows(mesh, v) for k, v in batch.items()}
    res = {"logits": [], "tokens": []}
    with compat.use_mesh(mesh):
        if cfg.encoder_only:
            f = jax.jit(lambda p, b: T.apply_logits(p, b, cfg, lc)[0], in_shardings=(p_sh, b_sh))
            lg = np.asarray(f(params, batch))
            res["logits"], res["tokens"] = lg, np.argmax(lg, -1)
            out[name] = res
            continue
        caches = T.init_cache(cfg, B, max_len)
        specs = cache_pspec_tree(cfg, mesh, caches)
        c_sh = placed(mesh, specs)
        pf = jax.jit(lambda p, b, c: T.prefill(p, b, cfg, c, lc),
                     in_shardings=(p_sh, b_sh, c_sh), out_shardings=(None, c_sh))
        lg, caches = pf(params, batch, caches)
        res["logits"].append(np.asarray(lg))
        tok = jnp.zeros((B, 1), jnp.int32)
        df = jax.jit(lambda p, t, pos, c: T.decode_step(p, t, pos, cfg, c, lc),
                     in_shardings=(p_sh, rows(mesh, tok), None, c_sh), out_shardings=(None, c_sh))
        for i, t in enumerate(init[name]["decode"]):
            lg, caches = df(params, jnp.asarray(t), jnp.asarray(S + i, jnp.int32), caches)
            res["logits"].append(np.asarray(lg))
        res["tokens"] = [np.argmax(x, -1) for x in res["logits"]]
        flat = jax.tree_util.tree_flatten_with_path(caches)[0]
        res["caches"] = {"/".join(str(k.key) for k in path): np.asarray(leaf)
                         for path, leaf in flat}
        flat = jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, P))[0]
        res["specs"] = {"/".join(str(k.key) for k in path): tuple(p) for path, p in flat}
    out[name] = res
with open(os.path.join(D, "jax_out.pkl"), "wb") as f:
    pickle.dump(out, f)
print("OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX reference and both rank phases, started together; returns
    (port outputs, JAX outputs)."""
    d = str(tmp_path_factory.mktemp("oneshot"))
    inits = _inits()
    with open(os.path.join(d, "init.pkl"), "wb") as f:
        pickle.dump(inits, f)
    torch.save(inits, os.path.join(d, "init.pt"))
    prog = f"SRC = {SRC!r}\nHERE = {HERE!r}\nD = {d!r}\n" + textwrap.dedent(JAX_REFERENCE)
    ref = subprocess.Popen([sys.executable, "-c", prog], stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        two, four = _ranks("oneshot2", 2, d), _ranks("oneshot4", 4, d)
        _wait(two, "oneshot2 ranks")
        _wait(four, "oneshot4 ranks")
        _, err = ref.communicate(timeout=RANK_TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-4000:]
    port = {}
    for phase in ("oneshot2", "oneshot4"):
        port.update(torch.load(os.path.join(d, f"out_{phase}.pt"), weights_only=False))
    with open(os.path.join(d, "jax_out.pkl"), "rb") as f:
        return port, pickle.load(f)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= TOL * max(1.0, np.abs(want).max()), (what, err, np.abs(want).max())


DECODERS = [n for n, row in RANKS.ONESHOT.items() if row[6]]


@pytest.mark.parametrize("name", list(RANKS.ONESHOT))
def test_mesh_steps_give_jax_tokens_and_logits(runs, name):
    port, ref = runs
    got, want = port[name], ref[name]
    if name not in DECODERS:  # the encoder step: (B, S) tokens
        np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])
        _close(got["logits"].numpy(), want["logits"], "encoder logits")
        return
    assert len(got["tokens"]) == len(want["tokens"]) == 1 + RANKS.ONESHOT[name][6]
    for i, (t, lg, wt, wl) in enumerate(zip(got["tokens"], got["logits"], want["tokens"],
                                            want["logits"])):
        np.testing.assert_array_equal(t.reshape(-1).numpy(), wt.reshape(-1), err_msg=str(i))
        _close(lg.numpy(), wl, f"step {i}")


@pytest.mark.parametrize("name", DECODERS)
def test_each_rank_holds_jax_block_of_the_caches(runs, name):
    """Each rank's cache blocks, the spare row dropped, against the block of
    JAX's final caches that the placement gives that rank; the port's
    placement equal to JAX's."""
    port, ref = runs
    arch, kw, shape, B, S, max_len, _ = RANKS.ONESHOT[name]
    cfg = RANKS.config_for(arch, kw)
    mesh = Mesh(shape, ("data", "model"))
    specs = dict(tree_leaves(cache_pspec_tree(cfg, mesh, init_cache(
        cfg, B, max_len, paged=False, device="meta"))))
    assert specs == ref[name]["specs"]
    blocks = port[name]["blocks"]
    assert len(blocks) == shape[0] * shape[1]
    for rank, held in enumerate(blocks):
        assert set(held) == set(specs)
        for path, blk in held.items():
            full = ref[name]["caches"][path]
            sl = NamedSharding(mesh, specs[path]).block_slices(full.shape, rank)
            assert tuple(blk.shape) == full[sl].shape, (rank, path)
            _close(blk.numpy(), full[sl], f"rank {rank} {path}")


def _share(name) -> set:
    """The (q, k) shapes a rank's attention kernel takes on ``name``'s mesh:
    a prefill (or encoder step) under tensor parallelism at the rank's
    query heads and the KV heads they read over the whole prompt, under
    context parallelism (fsdp) at its half of the queries against every
    key, all heads; a decode step against its rows' cache block at its
    KV heads, or, where the cache's sequence is split, every query head
    against its block of the positions (``"lse"``: the kernel returns the
    LSE)."""
    arch, kw, shape, B, S, max_len, steps = RANKS.ONESHOT[name]
    cfg = RANKS.config_for(arch, kw)
    n, rows = shape[1], B // shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    if effective_strategy(cfg, Mesh(shape, ("data", "model"))) == "fsdp":
        out = {("flash", (rows, S // n, hq, hd), (rows, S, hkv, hd))}
    else:
        kv = hkv // n if hkv % n == 0 else len({h * hkv // hq for h in range(hq // n)})
        out = {("flash", (rows, S, hq // n, hd), (rows, S, kv, hd))}
    if steps:
        if hkv % n == 0:
            out.add(("flash", (rows, 1, hq // n, hd), (rows, max_len, hkv // n, hd)))
        else:
            out.add(("lse", (rows, 1, hq, hd), (rows, max_len // n, hkv, hd)))
    return out


@pytest.mark.parametrize("name", list(RANKS.ONESHOT))
def test_each_rank_attends_its_share(runs, name):
    port, _ = runs
    shape, max_len = RANKS.ONESHOT[name][2], RANKS.ONESHOT[name][5]
    for rank, seen in enumerate(port[name]["seen"]):
        got = set()
        for row in seen:
            if row[0] == "lse":
                got.add(("lse", row[1], row[2]))
                # the block's true positions
                L = max_len // shape[1]
                assert (row[3], row[4]) == (rank % shape[1] * L, rank % shape[1] * L + L - 1)
            else:
                got.add(("flash", row[0], row[1]))
        assert got == _share(name), rank


class _FakeDevices:
    def __init__(self, shape):
        self.shape = shape
        self.size = int(np.prod(shape))


class _FakeMesh:
    """Duck-typed mesh for the JAX functions (1 real device in-process)."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = _FakeDevices(shape)


# ---------------------------------------------------------------------------
# cache_pspec_tree
# ---------------------------------------------------------------------------


def _jax_cache_specs(cfg, mesh, batch, max_len, paged):
    kw = dict(paged=True, page_size=16, num_pages=64) if paged else {}
    specs = SJ.serve_cache_pspecs(cfg, mesh, batch, max_len, **kw)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(k.key) for k in path): tuple(p) for path, p in flat}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_cache_placement_is_jax_for_every_arch(mesh_name, layout):
    """Every leaf's placement equals JAX's, dim by dim, for all ten archs
    (the encoder-only hubert has no cache), at a batch that every batch
    axis divides and at a batch of 1, which backs off."""
    shape, names = MESHES[mesh_name]
    paged = layout == "paged"
    kw = dict(paged=True, page_size=16, num_pages=64) if paged else {}
    for arch in ARCHS:
        cfg_t, cfg_j = get_config(arch), get_j(arch)
        if cfg_t.encoder_only:
            continue
        for batch in (64, 1):
            got = dict(tree_leaves(serve_cache_pspecs(cfg_t, Mesh(shape, names), batch, 64,
                                                      **kw)))
            want = _jax_cache_specs(cfg_j, _FakeMesh(shape, names), batch, 64, paged)
            assert got == want, (arch, batch)


def test_cache_blocks_are_the_placement_with_a_spare_row():
    """The blocks a rank's ``init_cache`` allocates on a mesh: each leaf's
    block of rows ``0..B-1`` under the placement, a dense leaf's with a
    spare row of its own (``cache_block_shape``)."""
    from repro_torch.distributed.shard import NamedSharding, cache_block_shape
    from repro_torch.models.transformer import init_cache

    for arch, shape in (("glm4-9b", (2, 2)), ("zamba2-2.7b", (2, 2)), ("xlstm-350m", (1, 2)),
                        ("gemma2-2b", (1, 2))):
        cfg = smoke_t(arch)
        mesh = Mesh(shape, ("data", "model"))
        full = dict(tree_leaves(init_cache(cfg, 4, 32, paged=False, device="cpu")))
        specs = dict(tree_leaves(cache_pspec_tree(cfg, mesh, unflatten(full))))
        for path, leaf in full.items():
            spare = path.endswith(("/k", "/v"))
            rows = (leaf.shape[0], leaf.shape[1] - spare) + tuple(leaf.shape[2:])
            blk = NamedSharding(mesh, specs[path]).block_shape(rows)
            want = (blk[0], blk[1] + spare) + blk[2:]
            assert cache_block_shape(leaf.shape, specs[path], mesh, spare) == want, path
            if path.endswith("/k"):  # a split dim: the kv heads or the sequence
                assert math.prod(want) * shape[1] * shape[0] == (
                    leaf[:, :4].numel() + shape[0] * leaf[:, 4:].numel()), path


# ---------------------------------------------------------------------------
# the LSE combine of a split key sequence
# ---------------------------------------------------------------------------


class _ThreadSplit:
    """``CacheSplit``'s collectives for ``n`` threads standing in for the
    ranks: each in-place reduction waits for every rank's tensor."""

    def __init__(self, n):
        self.n, self.barrier, self.slots = n, threading.Barrier(n), {}

    def rank(self, index):
        split = self

        class _Rank:
            size = split.n

            def all_reduce(self, x, op="sum"):
                split.slots[index] = x.clone()
                split.barrier.wait()
                parts = [split.slots[i] for i in range(split.n)]
                red = torch.stack(parts).amax(0) if op == "max" else torch.stack(parts).sum(0)
                split.barrier.wait()
                return x.copy_(red)

        return _Rank()


@pytest.mark.parametrize("window,softcap", [(None, None), (12, 30.0), (5, None)])
def test_split_key_sequence_combines_to_the_whole_attention(window, softcap):
    """Keys at 0..47 split into 4 blocks of 12; rows at positions 3, 20, 47
    (the first sees no key of three blocks, a window of 5 leaves every
    row one or two blocks): each block's attention with its LSE, combined
    (``merge_partials``), equals the whole attention within 1e-6; a block
    with no visible key has an LSE of -inf and adds nothing (no NaN)."""
    from repro_torch.distributed.shard import merge_partials
    from repro_torch.kernels.flash_attention.ops import flash_attention_lse
    from repro_torch.kernels.flash_attention.ref import flash_attention_reference

    gen = torch.Generator().manual_seed(3)
    Bq, Hq, Hkv, D, Sk, n = 2, 4, 2, 16, 48, 4
    q = torch.randn(Bq, 3, Hq, D, generator=gen, dtype=torch.float64)
    k = torch.randn(Bq, Sk, Hkv, D, generator=gen, dtype=torch.float64)
    v = torch.randn(Bq, Sk, Hkv, D, generator=gen, dtype=torch.float64)
    qpos = torch.tensor([3, 20, 47]).expand(Bq, 3)
    kw = dict(causal=True, window=window, softcap=softcap, kv_len=torch.tensor([48, 40]))
    whole = flash_attention_reference(q, k, v, q_positions=qpos, **kw)
    split, out, lses = _ThreadSplit(n), [None] * n, [None] * n
    L = Sk // n

    def rank(r):
        kp = (r * L + torch.arange(L)).expand(Bq, L)
        o, lse = flash_attention_lse(q, k[:, r * L:(r + 1) * L], v[:, r * L:(r + 1) * L],
                                     q_positions=qpos, k_positions=kp, **kw)
        lses[r] = lse.clone()
        out[r] = merge_partials(o, lse, split.rank(r))

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert any(bool(torch.isneginf(x).any()) for x in lses)
    for r in range(n):
        assert torch.isfinite(out[r]).all()
        np.testing.assert_allclose(out[r].numpy(), whole.numpy(), atol=1e-6, rtol=0)
