"""The serving scheduler on a mesh of ranks against JAX's scheduler.

The ranks are ``gloo`` processes on the CPU (``tests/torch_mesh_ranks.py``,
phases ``sched2`` and ``sched4``, the rows of ``RANKS.SCHED``), each
holding its blocks of the weights (or, on the data mesh of (2, 1), the
whole weights, as the serve launcher holds them) and of the paged pool and
the recurrent state (``cache_pspec_tree``'s placement). The fixture
starts both phases, one JAX subprocess with 4 host devices running JAX's
``BatchScheduler`` on ``(2, 2)`` and ``(1, 4)`` meshes and on one device
for the cases of two ranks, and the serve launcher under ``torchrun`` on a
``(2, 1)`` mesh, all at once; meanwhile the test process runs the port's
scheduler without a mesh for every case (one torch thread). Weights:
the fp32 smoke configs, zamba2's stacked leaves at their per-layer fan-in.

The cases: tinyllama on (1, 2) and (2, 2), greedy and sampled (T 0.8,
top-k 50), 8 requests behind one system prompt (copy-on-write hits)
through 4 slots and a pool of 14 pages that preempts; speculation
(``spec_k`` 4) on (1, 2); glm4 on (1, 4) (2 KV heads: the pool whole on
every rank); zamba2 on (1, 2) (mamba2 over its SSM heads) and (2, 1) (its
recurrent rows over ``"data"``), with the two-pass verify; qwen3-moe and
gemma2 (fsdp: the chunk's attention over the rank's KV heads) on (1, 2);
a chaos replay on (2, 2) (seeded traffic and faults, ``checksum_pages``).

Checked: tokens equal JAX's (exactly: no near tie parted them), the
``kv_cache_stats`` counters, statuses and step counts equal JAX's; each
rank's pool and state blocks within 1e-5 of the matching slice of the
one-rank run's caches, and the ``"data"`` peers' blocks bitwise equal;
the shapes that reached the paged kernels are the rank's share; the
chaos run's page fingerprints are JAX's integers for the assembled pool;
the launcher's rank 0 record loads with JAX's ``RunRecord.load`` and
passes ``validate_pop``; a one-rank mesh over a ``gloo`` group gives the
plain scheduler's bytes; ``--dense`` on a mesh raises.
"""

import functools
import glob
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as smoke_j  # noqa: E402
from repro.layers.common import init_params as init_j  # noqa: E402
from repro.models import transformer as TJ  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.distributed.shard import NamedSharding  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.layers.common import tree_leaves  # noqa: E402
from repro_torch.serve.serve import BatchScheduler, ServeConfig, cache_pspec_tree  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
sys.path.insert(0, HERE)
import torch_mesh_ranks as RANKS  # noqa: E402
from test_torch_distributed import RANK_TIMEOUT, _ranks, _wait  # noqa: E402
from test_torch_oneshot_mesh import _fan_in  # noqa: E402

TOL = 1e-5
N_REQ, MAX_NEW = 8, 8


@pytest.fixture(scope="module", autouse=True)
def _free_jax_programs():
    """JAX's scheduler steps compiled here are freed when the module ends,
    so that a later module in the same worker stays under the kernel's
    limit of mappings a process (as ``tests/test_torch_oneshot.py``)."""
    yield
    jax.clear_caches()


def _prompts(seed: int = 5) -> list:
    """One system prompt of 10 tokens (2.5 pages: copy-on-write) and tails
    that repeat a short cycle, so the drafter proposes."""
    rng = np.random.default_rng(seed)
    system = rng.integers(4, 500, 10).tolist()
    out = []
    for _ in range(N_REQ):
        cyc = rng.integers(4, 500, 3).tolist()
        out.append(system + (cyc * 3)[:int(rng.integers(4, 9))])
    return out


@functools.cache
def _inits():
    out = {}
    for name, (arch, kw, *_rest) in RANKS.SCHED.items():
        cfg_j = smoke_j(arch).replace(**kw)
        tree = jax.tree_util.tree_map(np.asarray, init_j(TJ.model_params(cfg_j),
                                                         jax.random.PRNGKey(0),
                                                         cfg_j.param_dtype))
        if arch == "zamba2-2.7b":
            tree = _fan_in(arch, RANKS.config_for(arch, kw), tree)
        out[name] = {"params": tree, "prompts": _prompts(), "max_new": MAX_NEW}
    return out


JAX_REFERENCE = """
import os, sys, pickle
# one thread: the suite's other workers and the ranks share the cores
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
sys.path.insert(0, SRC); sys.path.insert(0, HERE)
import jax, jax.numpy as jnp
from repro import compat
from repro.configs import smoke_config
from repro.serve import faults, traffic
from repro.serve.serve import BatchScheduler, ServeConfig
import torch_mesh_ranks as RANKS
with open(os.path.join(D, "init.pkl"), "rb") as f:
    init = pickle.load(f)
out = {}
for name in NAMES:
    arch, kw, shape, scfg, _ = RANKS.SCHED[name]
    cfg = smoke_config(arch).replace(**kw)
    if shape[0] * shape[1] == 2:  # JAX's scheduler on one device for two ranks
        shape = (1, 1)
    mesh = compat.make_mesh(shape, ("data", "model"), devices=jax.devices()[:shape[0] * shape[1]])
    params = jax.tree_util.tree_map(jnp.asarray, init[name]["params"])
    with compat.use_mesh(mesh):
        sched = BatchScheduler(cfg, mesh, ServeConfig(paged=True, **scfg), params)
        out[name] = RANKS.sched_drive(sched, name, cfg.vocab, faults, traffic, init[name])
with open(os.path.join(D, "jax_out.pkl"), "wb") as f:
    pickle.dump(out, f)
print("OK")
"""


def _port_one_rank(name, init):
    """The port's scheduler without a mesh: its observations and caches."""
    from repro_torch.serve import faults, traffic

    arch, kw, shape, scfg, _ = RANKS.SCHED[name]
    cfg = RANKS.config_for(arch, kw)
    sched = BatchScheduler(from_jax_params(init["params"], cfg, "cpu"), ServeConfig(**scfg))
    res = RANKS.sched_drive(sched, name, cfg.vocab, faults, traffic, init)
    res["caches"] = {p: (t[:, :-1] if "pages" in p else t).clone()
                     for p, t in tree_leaves(sched.caches)}
    return res


def _torchrun(d: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "repro_torch.launch.serve", "--device", "cpu", "--smoke",
         "--arch", "tinyllama-1.1b", "--requests", "4", "--max-new", "4",
         "--talp-out", os.path.join(d, "talp")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=d)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh run, JAX's references and the port's one-rank runs;
    returns (port mesh outputs, JAX outputs, one-rank outputs, launcher
    (output, directory))."""
    d = str(tmp_path_factory.mktemp("sched"))
    inits = _inits()
    with open(os.path.join(d, "init.pkl"), "wb") as f:
        pickle.dump(inits, f)
    torch.save(inits, os.path.join(d, "init.pt"))
    prog = (f"SRC = {SRC!r}\nHERE = {HERE!r}\nD = {d!r}\nNAMES = {list(RANKS.SCHED)!r}\n"
            + textwrap.dedent(JAX_REFERENCE))
    ref = subprocess.Popen([sys.executable, "-c", prog], stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    procs = []
    threads = torch.get_num_threads()
    try:
        two, four, launcher = _ranks("sched2", 2, d), _ranks("sched4", 4, d), _torchrun(d)
        procs = two + four + [launcher]
        torch.set_num_threads(1)
        one = {n: _port_one_rank(n, inits[n]) for n in RANKS.SCHED}
        _wait(two, "sched2 ranks")
        _wait(four, "sched4 ranks")
        launched, _ = launcher.communicate(timeout=RANK_TIMEOUT)
        _, err = ref.communicate(timeout=RANK_TIMEOUT)
    finally:
        torch.set_num_threads(threads)
        for p in procs + [ref]:
            if p.poll() is None:
                p.kill()
    assert ref.returncode == 0, err[-4000:]
    assert launcher.returncode == 0, launched[-4000:]
    port = {}
    for phase in ("sched2", "sched4"):
        port.update(torch.load(os.path.join(d, f"out_{phase}.pt"), weights_only=False))
    with open(os.path.join(d, "jax_out.pkl"), "rb") as f:
        want = pickle.load(f)
    return port, want, one, (launched, d)


@pytest.mark.parametrize("name", list(RANKS.SCHED))
def test_mesh_scheduler_gives_jax_tokens_and_counters(runs, name):
    """Tokens, statuses, ``kv_cache_stats`` counters and step counts equal
    JAX's scheduler's (on the case's mesh for 4 ranks, on one device for
    2); the pool's bytes are the whole pool's, as one rank counts them."""
    port, want, one, _ = runs
    got, ref = port[name], want[name]
    assert got["tokens"] == ref["tokens"]
    assert len(got["tokens"]) >= (6 if name.startswith("chaos") else N_REQ)
    assert got["status"] == ref["status"]
    assert got["kv"] == ref["kv"]
    assert got["stats"] == ref["stats"]
    assert got["kv_bytes"] == one[name]["kv_bytes"]
    # the pressure the cases are built for
    if name.startswith("chaos"):
        assert sum(got["kv"]["recovery"]["injected"].values()) >= 2
    else:
        assert got["kv"]["pressure"]["preemptions"] >= 1
        assert got["kv"]["prefix_cache"]["hits"] >= 1
    if not name.startswith("zamba2") and not name.startswith("chaos"):
        assert got["kv"]["prefix_cache"]["cow_copies"] >= 1
    if RANKS.SCHED[name][3].get("spec_decode"):
        assert got["kv"]["speculation"]["drafted"] >= 1


@pytest.mark.parametrize("name", list(RANKS.SCHED))
def test_each_rank_holds_the_one_rank_blocks(runs, name):
    """Each rank's block of every cache leaf (the pool's spare page
    dropped) within 1e-5 of the matching slice of the one-rank run's leaf
    (its largest |value| at least 1), under ``cache_pspec_tree``'s
    placement; ranks that differ only along ``"data"`` hold bitwise equal
    pool blocks."""
    port, _, one, _ = runs
    arch, kw, shape, scfg, _ = RANKS.SCHED[name]
    cfg = RANKS.config_for(arch, kw)
    mesh = Mesh(shape, ("data", "model"))
    full = one[name]["caches"]
    specs = dict(tree_leaves(cache_pspec_tree(cfg, mesh, full)))
    blocks = port[name]["blocks"]
    assert len(blocks) == shape[0] * shape[1]
    for rank, held in enumerate(blocks):
        assert set(held) == set(full)
        for path, blk in held.items():
            want = full[path][NamedSharding(mesh, specs[path]).block_slices(
                tuple(full[path].shape), rank)]
            assert tuple(blk.shape) == tuple(want.shape), (rank, path)
            err = (blk.double() - want.double()).abs().max().item()
            assert err <= TOL * max(1.0, want.abs().max().item()), (rank, path, err)
    for rank, held in enumerate(blocks):
        peer = mesh.group_ranks(("data",), rank)[0]
        for path, blk in held.items():
            if "pages" in path:
                assert torch.equal(blk, blocks[peer][path]), (rank, peer, path)


def _share(name) -> set:
    """The (q, pool) shapes each rank's paged kernels take: the chunk (one
    row, every rank) and the decode (or, with speculation, the verify's
    ``spec_k + 1`` wide chunk) over the rank's rows, at the rank's KV
    heads and the query heads they serve; where the KV heads do not split
    (glm4 on (1, 4)) every query head against the whole pool."""
    arch, kw, shape, scfg, _ = RANKS.SCHED[name]
    cfg = RANKS.config_for(arch, kw)
    n = shape[1]
    rows = scfg["batch"] // shape[0]
    hd, hq, hkv = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    heads = (hq // n, hkv // n) if hkv % n == 0 else (hq, hkv)
    pool = (scfg["num_pages"], scfg["page_size"], heads[1], hd)
    out = {("chunk", (1, scfg["prefill_chunk"], heads[0], hd), pool)}
    if scfg.get("spec_decode"):
        out.add(("chunk", (rows, scfg["spec_k"] + 1, heads[0], hd), pool))
    else:
        out.add(("decode", (rows, 1, heads[0], hd), pool))
    return out


@pytest.mark.parametrize("name", list(RANKS.SCHED))
def test_each_rank_runs_the_paged_kernels_at_its_share(runs, name):
    port, _, _, _ = runs
    for rank, seen in enumerate(port[name]["seen"]):
        assert set(seen) == _share(name), rank


def test_chaos_fingerprints_are_jax_integers_for_the_whole_pool(runs):
    """Every rank's page fingerprints (its blocks' int64 partials summed
    over ``"model"``) equal JAX's ``page_fingerprint`` of the whole pool
    assembled from the ranks' blocks."""
    from repro.serve.faults import page_fingerprint_step

    port, _, _, _ = runs
    got = port["chaos_22"]
    shape = RANKS.SCHED["chaos_22"][2]
    mesh = Mesh(shape, ("data", "model"))
    pools = {}
    for path in got["blocks"][0]:
        if "pages" in path:
            parts = [got["blocks"][r][path] for r in mesh.group_ranks(("model",), 0)]
            pools[path] = jnp.asarray(torch.cat(parts, dim=3).numpy())
    tree = {}
    for path, arr in pools.items():
        name, attn, leaf = path.split("/")
        tree.setdefault(name, {}).setdefault(attn, {})[leaf] = arr
    fp = page_fingerprint_step()
    want = [int(fp(tree, p)) for p in range(len(got["fingerprints"]))]
    assert got["fingerprints"] == want
    assert got["kv"]["recovery"]["checksum_failures"] == \
        runs[1]["chaos_22"]["kv"]["recovery"]["checksum_failures"]


def test_serve_launcher_under_torchrun_writes_a_record_jax_validates(runs):
    """``torchrun --nproc_per_node 2 -m repro_torch.launch.serve --device cpu
    --smoke``: a (2, 1) mesh; rank 0 alone prints and writes
    ``talp_1x2_*.json``, which JAX's ``RunRecord.load`` reads and whose
    factors pass JAX's ``validate_pop``."""
    from repro.core.factors import validate_pop
    from repro.core.records import RunRecord

    out, d = runs[3]
    assert "[serve] mesh {'data': 2, 'model': 1} over 2 rank(s)" in out
    assert out.count("completed 4/4 requests") == 1
    paths = glob.glob(os.path.join(d, "talp", "talp_*.json"))
    assert [os.path.basename(p)[:9] for p in paths] == ["talp_1x2_"]
    run = RunRecord.load(paths[0])
    assert run.resources.total_devices == 2
    assert {"decode", "prefill"} <= set(run.regions)
    for name, reg in run.regions.items():
        assert validate_pop(reg.pop) == [], name


def test_dense_layout_on_a_mesh_raises(monkeypatch):
    """``--dense`` under ``torchrun`` refuses before any process group
    starts: the dense layout's scheduler on a mesh is not ported."""
    from repro_torch.launch import serve as L

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="8b-iv"):
        L.main(["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu", "--dense"])


def test_one_rank_mesh_is_the_plain_scheduler_bitwise(tmp_path):
    """A 1 x 1 mesh over a one-rank ``gloo`` group: the same tokens and the
    same pool bytes as no mesh, greedy with speculation."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    init = _inits()["tinyllama_12_spec"]
    scfg = RANKS.SCHED["tinyllama_12_spec"][3]
    cfg = RANKS.config_for("tinyllama-1.1b", RANKS.F32)

    def run(mesh):
        sched = BatchScheduler(from_jax_params(init["params"], cfg, "cpu", mesh),
                               ServeConfig(**scfg))
        for rid, p in enumerate(init["prompts"]):
            sched.submit(list(p), request_id=rid, max_new=init["max_new"])
        sched.drain()
        return RANKS.sched_observe(sched), dict(tree_leaves(sched.caches))

    plain, plain_caches = run(None)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        got, caches = run(make_host_mesh(device="cpu"))
    finally:
        dist.destroy_process_group()
    assert got == plain
    for path, t in plain_caches.items():
        assert torch.equal(caches[path], t), path
