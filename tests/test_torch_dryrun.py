"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's, on the CPU, in one process: nothing is allocated and nothing
runs, the blocks are meta tensors and the collectives go to a ``"fake"``
process group of the mesh's size (``launch.mesh.meta_mesh``).

Checked: ``abstract_state`` leaf for leaf (path, shape, dtype) for all ten
archs; for every runnable cell on both production meshes, rank 0's blocks
of the state or parameters, the dense caches (less the port's spare row)
and the batch equal JAX's ``NamedSharding(AbstractMesh(...), spec)
.shard_shape(global)`` under JAX's own specs (``train_state_pspecs``,
``param_pspecs``, ``cache_pspec_tree`` and its batch rule), and the
artifact's ``argument_size_in_bytes`` is their bytes and the spare rows';
skip records and the cells' meta keys are JAX's; the six cells of
``chip_smoke.py`` phase ``dryrun`` (b) at one and two pattern repeats
count ``ok`` with the collectives a layer adds, DCN bytes only where a
group crosses the pod, and per-rank product FLOPs times the ranks within
a stated bound of the same cell counted at 1 x 1; the K1/K2 meta routes
report ``launch_costs`` at the positions the cell implies without a launch
or the plain version; the counter's collective bytes by JAX's rule and its
memory count; the CLI's artifact and, under ``TALP_ENABLE=1``, a run record
that the JAX package loads.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` (512 host devices) when it is
imported: ``_jax_dryrun`` imports it only after JAX's backend has started
and puts the variable back at once.
"""

import dataclasses
import importlib
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import NamedSharding as NamedShardingJ  # noqa: E402

from repro.configs import SHAPES as SHAPES_J  # noqa: E402
from repro.configs import effective_mode as mode_j  # noqa: E402
from repro.configs import get_config as get_j  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.configs import skip_reason as skip_j  # noqa: E402
from repro.data.pipeline import batch_specs as batch_specs_j  # noqa: E402
from repro.distributed import sharding as SHJ  # noqa: E402
from repro.layers.common import abstract_params as abstract_params_j  # noqa: E402
from repro.layers.common import param_pspecs as param_pspecs_j  # noqa: E402
from repro.models import transformer as TJ  # noqa: E402
from repro.optim import AdamWConfig as AdamWConfigJ  # noqa: E402
from repro.serve.serve import cache_pspec_tree as cache_pspecs_j  # noqa: E402
from repro.train.train import TrainConfig as TrainConfigJ  # noqa: E402
from repro.train.train import train_state_pspecs as state_pspecs_j  # noqa: E402
from repro_torch.configs import SHAPE_BY_NAME, SHAPES, get_config, skip_reason  # noqa: E402
from repro_torch.core.profile import StepProfile, collective_bytes  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FA  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as RN  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_production_mesh, meta_mesh  # noqa: E402
from repro_torch.layers.common import tree_leaves  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train.train import TrainConfig  # noqa: E402

ARCHS = list_archs()
MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module", autouse=True)
def _clear_jax():
    yield
    jax.clear_caches()


def _jax_dryrun():
    """``repro.launch.dryrun`` with ``XLA_FLAGS`` as it was before the import."""
    jax.devices()  # the backend is up: the flag can no longer reach it
    before = os.environ.get("XLA_FLAGS")
    mod = importlib.import_module("repro.launch.dryrun")
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    assert os.environ.get("XLA_FLAGS") == before
    return mod


class _FakeDevices:
    def __init__(self, shape):
        self.shape = shape
        self.size = int(np.prod(shape))


class _FakeMesh:
    """Duck-typed mesh for the JAX rules (1 real device in-process)."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = _FakeDevices(shape)


def _flat_j(tree, leaf_type=None):
    is_leaf = None if leaf_type is None else (lambda x: isinstance(x, leaf_type))
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in flat}


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


# ---------------------------------------------------------------------------
# abstract_state, per-rank blocks, skip records and meta
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_state_is_jax_leaf_for_leaf(arch):
    DJ = _jax_dryrun()
    want = {p: (tuple(s.shape), _dtype_name(s.dtype)) for p, s in _flat_j(
        DJ.abstract_state(get_j(arch), TrainConfigJ(optimizer=AdamWConfigJ()))).items()}
    got_tree = D.abstract_state(get_config(arch), TrainConfig(optimizer=AdamWConfig()))
    got = {p: (tuple(t.shape), _dtype_name(t.dtype)) for p, t in tree_leaves(got_tree)}
    assert got == want
    assert all(t.is_meta for _, t in tree_leaves(got_tree))


def _jax_cell_blocks(cfg_j, shape_j, mode, fake, amesh):
    """JAX's global trees of a cell and each leaf's shard shape:
    ``{group: {path: (shard shape, dtype name)}}`` and the dense caches' paths."""
    P = jax.sharding.PartitionSpec

    def shard(tree, specs):
        return {p: (tuple(NamedShardingJ(amesh, specs[p]).shard_shape(tuple(x.shape))),
                    _dtype_name(x.dtype)) for p, x in _flat_j(tree).items()}

    def batch_rule(tree, b_index):
        specs = {}
        for p, x in _flat_j(tree).items():
            spec = [None] * len(x.shape)
            spec[b_index] = SHJ.divisible_batch_axes(fake, x.shape[b_index])
            specs[p] = P(*spec)
        return specs

    B, S = shape_j.global_batch, shape_j.seq_len
    if mode == "train":
        tcfg = TrainConfigJ(optimizer=AdamWConfigJ())
        state = _jax_dryrun().abstract_state(cfg_j, tcfg)
        batch = batch_specs_j(cfg_j, shape_j, "train")
        return {"state": shard(state, _flat_j(state_pspecs_j(cfg_j, fake, tcfg), P)),
                "batch": shard(batch, batch_rule(batch, 1))}
    params = abstract_params_j(TJ.model_params(cfg_j), cfg_j.param_dtype)
    pspecs = param_pspecs_j(TJ.model_params(cfg_j), SHJ.param_rules(cfg_j, fake), fake)
    batch = ({"tokens": jax.ShapeDtypeStruct((B, 1), jax.numpy.int32)} if mode == "decode"
             else batch_specs_j(cfg_j, shape_j, "prefill"))
    out = {"params": shard(params, _flat_j(pspecs, P)), "batch": shard(batch, batch_rule(batch, 0))}
    if mode != "encoder":
        caches = jax.eval_shape(lambda: TJ.init_cache(cfg_j, B, S))
        out["caches"] = shard(caches, _flat_j(cache_pspecs_j(cfg_j, fake, caches), P))
    if mode == "decode":
        out["pos"] = {"pos": ((), "int32")}
    return out


@pytest.mark.parametrize("group", ["train", "serve"])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_rank_blocks_are_jax_shard_shapes(group, multi_pod):
    """Rank 0's blocks of every runnable cell (``group``: the train cells,
    or the prefill/encoder/decode ones) on a production mesh, as the dry
    run builds them (the model's and AdamW's blocks, ``init_cache``'s, the
    batch's), against JAX's shard shapes; a dense cache leaf's block ends
    with the port's spare row. ``argument_size_in_bytes`` is their bytes."""
    shape, names = MESHES[multi_pod]
    fake, amesh = _FakeMesh(shape, names), AbstractMesh(shape, names)
    shapes_j = {s.name: s for s in SHAPES_J}
    n = 0
    with meta_mesh(shape, names) as mesh:
        for arch in ARCHS:
            cfg_t, cfg_j = get_config(arch), get_j(arch)
            for s in SHAPES:
                mode = D.effective_mode(cfg_t, s)
                if skip_reason(cfg_t, s) or (mode == "train") != (group == "train"):
                    continue
                want = _jax_cell_blocks(cfg_j, shapes_j[s.name], mode, fake, amesh)
                inp = D.rank_inputs(cfg_t, s, mode, mesh)
                assert set(inp.held) == set(want), (arch, s.name)
                spare = 0
                for g, leaves in want.items():
                    got = {p: (tuple(t.shape), _dtype_name(t.dtype))
                           for p, t in inp.held[g].items()}
                    assert set(got) == set(leaves), (arch, s.name, g)
                    for p, t in inp.held[g].items():
                        assert t.is_meta, (arch, p)
                        if g == "caches" and p.endswith(("/k", "/v")):  # the spare row
                            spare += t.numel() // t.shape[1] * t.element_size()
                            got[p] = ((got[p][0][0], got[p][0][1] - 1) + got[p][0][2:],
                                      got[p][1])
                    assert got == leaves, (arch, s.name, g)
                want_bytes = sum(math.prod(sh) * np.dtype(
                    jax.numpy.dtype(dt)).itemsize for leaves in want.values()
                    for sh, dt in leaves.values())
                assert D.held_bytes(inp.held) == want_bytes + spare, (arch, s.name)
                n += 1
    assert n == {"train": 10, "serve": 21}[group]


def test_skip_records_and_meta_are_jax(tmp_path):
    """Every cell on both meshes: the skip reason, and for a runnable cell
    ``mode``, ``mesh`` and ``strategy`` (JAX's ``effective_mode`` and
    ``effective_strategy``); a skipped cell's record is the one JAX's
    ``run_cell`` writes, byte for byte."""
    DJ = _jax_dryrun()
    runnable = skipped = 0
    for multi_pod, (shape, names) in MESHES.items():
        fake = _FakeMesh(shape, names)
        for arch in ARCHS:
            cfg_t, cfg_j = get_config(arch), get_j(arch)
            for sj in SHAPES_J:
                st = SHAPE_BY_NAME[sj.name]
                assert skip_reason(cfg_t, st) == skip_j(cfg_j, sj), (arch, sj.name)
                if skip_j(cfg_j, sj):
                    got = D.run_cell(arch, sj.name, multi_pod, str(tmp_path / "t"))
                    want = DJ.run_cell(arch, sj.name, multi_pod, str(tmp_path / "j"))
                    tag = f"{arch}__{sj.name}__{'multipod' if multi_pod else 'singlepod'}.json"
                    assert got == want and got["status"] == "skipped"
                    assert ((tmp_path / "t" / tag).read_bytes()
                            == (tmp_path / "j" / tag).read_bytes())
                    skipped += 1
                    continue
                got = D.cell_meta(cfg_t, st, make_production_mesh(multi_pod=multi_pod), arch)
                assert got == {"arch": arch, "shape": sj.name, "mode": mode_j(cfg_j, sj),
                               "mesh": dict(zip(names, shape)),
                               "strategy": SHJ.effective_strategy(cfg_j, fake)}
                runnable += 1
    assert (runnable, skipped) == (62, 18)


# ---------------------------------------------------------------------------
# six cells counted at one and two pattern repeats
# ---------------------------------------------------------------------------

# (arch, shape, multi_pod) -> the collective kinds a pattern repeat adds: a
# training layer gathers its weights and the sequence (all-gather), scatters
# the sequence and the weight gradients (reduce-scatter) and sums whole
# leaves' gradients (all-reduce); a decode step gathers weights and sums the
# row-parallel partials (all-reduce), with no sequence to scatter; the
# encoder's forward gathers and scatters the sequence and sums nothing
CELLS = {
    ("tinyllama-1.1b", "train_4k", False): {"all-gather", "all-reduce", "reduce-scatter"},
    ("glm4-9b", "decode_32k", False): {"all-gather", "all-reduce"},
    ("hubert-xlarge", "prefill_32k", False): {"all-gather", "reduce-scatter"},
    ("qwen3-moe-30b-a3b", "train_4k", False): {"all-gather", "all-reduce", "reduce-scatter"},
    ("gemma2-2b", "train_4k", True): {"all-gather", "all-reduce", "reduce-scatter"},
    ("zamba2-2.7b", "long_500k", True): {"all-gather", "all-reduce"},
}
# n x (a rank's product FLOPs) / (one rank's at 1 x 1), at one repeat: at
# least 1 (no work lost) and at most the bound. A split cell repeats only
# small products on every rank (the router, norms' neighbours): 5%. gemma2's
# context-parallel count is the last "model" rank's, whose causal attention
# is near twice the mean: 2. zamba2's single row cannot split over the 32
# "pod" x "data" ranks, which all compute it: 32, and 40% for the products
# its "model" split leaves whole.
FLOP_RATIO = {
    "tinyllama-1.1b": (1.0, 1.05), "glm4-9b": (1.0, 1.05), "hubert-xlarge": (1.0, 1.05),
    "qwen3-moe-30b-a3b": (1.0, 1.05), "gemma2-2b": (1.0, 2.0), "zamba2-2.7b": (32.0, 32 * 1.4),
}


def _products(prof: StepProfile) -> float:
    return sum(c.dot_flops for c in prof.per_computation.values())


def _pod_spanning(cfg, shape, mode: str, mesh) -> bool:
    """Whether a collective of the cell's step spans the pods: a leaf placed
    over ``"pod"``, or (training) gradients summed over a batch split that
    includes it."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.layers.common import param_pspecs
    from repro_torch.models.transformer import model_params

    names = lambda e: () if e is None else ((e,) if isinstance(e, str) else e)  # noqa: E731
    specs = dict(tree_leaves(param_pspecs(model_params(cfg), SH.param_rules(cfg, mesh), mesh)))
    placed = any("pod" in names(e) for spec in specs.values() for e in spec)
    rows = SH.divisible_batch_axes(mesh, shape.global_batch)
    return placed or (mode == "train" and "pod" in names(rows))


@pytest.mark.parametrize("cell", list(CELLS), ids=lambda c: f"{c[0]}-{c[1]}")
def test_six_cells_count_at_one_and_two_repeats(cell):
    arch, shape_name, multi_pod = cell
    base = get_config(arch)
    counted = {}
    for repeats in (1, 2):
        cfg = dataclasses.replace(base, repeats=repeats)
        prof, _, mesh, meta = D.lower_cell(arch, shape_name, multi_pod, cfg=cfg)
        rec = json.loads(json.dumps(D.ok_record(prof, meta, multi_pod)))
        assert rec["status"] == "ok" and rec["count_s"] >= 0
        assert all(math.isfinite(rec["roofline"][k]) and rec["roofline"][k] > 0
                   for k in ("compute_s", "memory_s", "collective_s"))
        mem = rec["memory_analysis"]
        assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
        counted[repeats] = prof
    grown = {k for k, v in counted[2].collective_counts.items()
             if v > counted[1].collective_counts.get(k, 0)}
    assert grown == CELLS[cell]
    p1 = counted[1]
    spans = _pod_spanning(dataclasses.replace(base, repeats=1), SHAPE_BY_NAME[shape_name],
                          D.effective_mode(base, SHAPE_BY_NAME[shape_name]), mesh)
    assert multi_pod or not spans
    assert (p1.collective_bytes_dcn > 0) == spans
    assert (p1.collective_wire_bytes_dcn > 0) == spans and p1.collective_bytes_ici > 0
    one, _ = D.count_cell(dataclasses.replace(base, repeats=1), SHAPE_BY_NAME[shape_name],
                          Mesh((1, 1), ("data", "model")), arch=arch)
    assert not one.collective_counts
    ratio = _products(p1) / _products(one)  # p1 is n ranks' worth of one rank's count
    lo, hi = FLOP_RATIO[arch]
    assert lo * (1 - 1e-9) <= ratio <= hi, ratio


def test_context_parallel_counts_the_busiest_rank():
    """gemma2's fsdp cell splits the sequence over "model": rank 0's query
    block sees the fewest keys, the last rank's the most; both are recorded
    and the profile is the last rank's."""
    cfg = dataclasses.replace(get_config("gemma2-2b"), repeats=1)
    prof, meta = D.count_cell(cfg, SHAPE_BY_NAME["train_4k"],
                              make_production_mesh(multi_pod=True))
    first, last = meta["ranks"]
    assert (first["rank"], last["rank"]) == (0, 15) and meta["counted_rank"] == 15
    # causal pairs of query block 0 and 15 of 16 (256 rows each) against 4096 keys
    blk = 256
    pairs0, pairs15 = blk * (blk + 1) // 2, blk * 15 * blk + blk * (blk + 1) // 2
    assert last["flash_attention_flops"] / first["flash_attention_flops"] == pytest.approx(
        pairs15 / pairs0, rel=0.05)
    assert prof.per_computation["flash_attention"].flops / prof.num_devices == \
        last["flash_attention_flops"]


# ---------------------------------------------------------------------------
# the kernels' meta routes
# ---------------------------------------------------------------------------


def _raise(*a, **k):
    raise AssertionError("a meta call reached the plain version")


def _kernel_costs(prof: StepProfile) -> dict:
    return {k: (c.multiplicity, c.flops, c.hbm_bytes) for k, c in prof.per_computation.items()
            if c.kind == "kernel"}


def _host(t):
    return torch.as_tensor(np.ascontiguousarray(t))


@pytest.mark.parametrize("case", ["train", "window", "context_parallel", "decode", "lse_block"])
def test_flash_meta_route_reports_launch_costs(case, monkeypatch):
    """The K2 meta route: outputs of the kernel's shapes and dtypes, no
    launch, no plain version, and the (flops, bytes) ``launch_costs`` gives
    at the positions the case implies (host tensors)."""
    monkeypatch.setattr(FA, "flash_attention_reference", _raise)
    B, Hq, Hkv, D_ = 2, 8, 2, 64
    Sq, Sk, window, pos = {"train": (512, 512, None, None), "window": (512, 512, 128, None),
                           "context_parallel": (128, 512, None, None),
                           "decode": (1, 4096, None, 4095),
                           "lse_block": (1, 1024, None, 4095)}[case]
    kw = dict(q_offset=256) if case == "context_parallel" else {}
    if pos is not None:
        kw = dict(decode_pos=pos, k_offset=2048 if case == "lse_block" else 0)
    q = torch.empty(B, Sq, Hq, D_, dtype=torch.bfloat16, device="meta")
    k = torch.empty(B, Sk, Hkv, D_, dtype=torch.bfloat16, device="meta")
    before = (dict(LAUNCHES), dict(FA.ROUTE_LAUNCHES))

    def step():
        if case == "lse_block":
            return FA.flash_attention_lse(q, k, k, kv_len=torch.empty((), device="meta"))
        if case == "decode":
            return FA.flash_attention(q, k, k, kv_len=torch.empty((), device="meta"))
        qr = q.clone().requires_grad_()
        o = FA.flash_attention(qr, k, k, causal=True, window=window)
        return o, torch.autograd.grad(o.sum(), qr)

    with FA.meta_positions(**kw):
        out, prof = StepProfile.count(step)
    assert (dict(LAUNCHES), dict(FA.ROUTE_LAUNCHES)) == before
    qpos = np.broadcast_to(kw.get("q_offset", 0) + np.arange(Sq), (B, Sq))
    kpos = np.broadcast_to(kw.get("k_offset", 0) + np.arange(Sk), (B, Sk))
    lens = None
    if pos is not None:
        qpos, lens = np.full((B, Sq), pos), np.full(B, pos + 1)
    hq = torch.empty(B, Sq, Hq, D_, dtype=torch.bfloat16)
    hk = torch.empty(B, Sk, Hkv, D_, dtype=torch.bfloat16)
    args = (_host(qpos), _host(kpos), None if lens is None else _host(lens))
    want = {"flash_attention": (1.0,) + FA.launch_costs(hq, hk, True, window, False, *args)}
    if pos is None:
        want["flash_attention_backward"] = (1.0,) + FA.launch_costs(hq, hk, True, window, True,
                                                                    *args)
    assert _kernel_costs(prof) == want
    if case == "lse_block":
        o, lse = out
        assert lse.shape == (B, Hq, Sq) and lse.dtype == torch.float32 and o.shape == q.shape
    elif pos is None:
        o, (dq,) = out
        assert o.shape == q.shape and dq.shape == q.shape and dq.dtype == q.dtype


def test_flash_meta_route_needs_a_decode_position():
    q = torch.empty(1, 1, 4, 64, dtype=torch.bfloat16, device="meta")
    k = torch.empty(1, 64, 4, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="decode position"):
        StepProfile.count(lambda: FA.flash_attention(q, k, k, kv_len=torch.empty((),
                                                                               device="meta")))


@pytest.mark.parametrize("grad", [False, True])
def test_rmsnorm_meta_route_reports_launch_costs(grad, monkeypatch):
    monkeypatch.setattr(RN, "rmsnorm_reference", _raise)
    rows, d = 4096, 2048
    x = torch.empty(rows, d, dtype=torch.bfloat16, device="meta", requires_grad=grad)
    scale = torch.empty(d, dtype=torch.bfloat16, device="meta", requires_grad=grad)
    before = dict(LAUNCHES)

    def step():
        y = RN.rmsnorm(x, scale)
        return torch.autograd.grad(y.sum(), (x, scale)) if grad else y

    out, prof = StepProfile.count(step)
    assert dict(LAUNCHES) == before
    xb, sb = rows * d * 2, d * 2
    want = {"rmsnorm": (1.0, 4.0 * rows * d, 2.0 * xb + sb)}
    if grad:
        want["rmsnorm_backward"] = (1.0, 8.0 * rows * d, 3.0 * xb + sb)
        assert out[0].shape == x.shape and out[1].shape == scale.shape
    assert _kernel_costs(prof) == want


# ---------------------------------------------------------------------------
# the counter: collectives, memory; the mesh; the CLI
# ---------------------------------------------------------------------------


def test_collectives_are_counted_by_jax_rule_and_split_by_pod():
    """On a (2, 2, 2) meta mesh of 4 ranks a pod: an all-reduce over
    "model" (ICI), an all-gather over "pod" (DCN), a reduce-scatter over
    ("data", "model") (ICI); bytes by JAX's rule from the result and the
    group size, machine totals (times 8); ``hbm_bytes`` still holds each
    collective's operand and result bytes; the JSON reads back in both
    packages."""
    from repro.core.profile import StepProfile as StepProfileJ
    from repro_torch.distributed.shard import _all_gather, _reduce_scatter

    with meta_mesh((2, 2, 2), ("pod", "data", "model")) as mesh:
        x = torch.empty(64, 32, device="meta")

        def step():
            import torch.distributed as dist

            dist.all_reduce(x, group=mesh.group(("model",)))
            _all_gather(x, mesh.group(("pod",)))
            return _reduce_scatter(torch.empty(4, 8, 32, device="meta"),
                                   mesh.group(("data", "model")))

        _, prof = StepProfile.count(step, num_devices=8, devices_per_pod=4)
    nb = 64 * 32 * 4
    ar, ag, rs = (collective_bytes("all-reduce", nb, 2), collective_bytes("all-gather", 2 * nb, 2),
                  collective_bytes("reduce-scatter", 8 * 32 * 4, 4))
    assert ar == (nb, nb) and ag == (nb, nb) and rs == (4 * 8 * 32 * 4, 3 * 8 * 32 * 4)
    assert prof.collective_counts == {"all-gather": 1, "all-reduce": 1, "reduce-scatter": 1}
    assert prof.collective_bytes_ici == 8 * (ar[0] + rs[0])
    assert prof.collective_wire_bytes_ici == 8 * (ar[1] + rs[1])
    assert (prof.collective_bytes_dcn, prof.collective_wire_bytes_dcn) == (8 * ag[0], 8 * ag[1])
    assert prof.per_computation["c10d.allreduce_"].hbm_bytes == 8 * 2 * nb
    back = StepProfile.from_json(json.loads(json.dumps(prof.to_json())))
    assert back == prof
    j = StepProfileJ.from_json(prof.to_json())
    assert (j.collective_wire_bytes_dcn, j.collective_counts) == (
        prof.collective_wire_bytes_dcn, prof.collective_counts)


def test_memory_count_follows_storages():
    """Arguments, outputs, an argument updated in place (aliased), and the
    peak of the step's own tensors; views and repeated shapes (outputs
    made from the metadata of an earlier call) alike."""
    held = torch.empty(1000, device="meta")

    def step(x):
        a = torch.empty(1000, device="meta")
        b = a * 2          # peak: a and b, 8000 bytes
        del a
        c = b + 1          # b freed after: 4000 live, then c
        del b
        d = (c * 3).view(10, 100)   # c * 3 is a repeat of b's shape: metadata reused
        _ = held[:5]                # a view of a tensor held before: nothing new
        x.add_(1)
        return d, x

    x = torch.empty(100, device="meta")
    _, prof = StepProfile.count(step, x, memory_args=(x,))
    assert prof.memory == {"argument_size_in_bytes": 400.0, "output_size_in_bytes": 4400.0,
                           "alias_size_in_bytes": 400.0, "temp_size_in_bytes": 8000.0}


def test_meta_mesh_groups_and_teardown():
    """``meta_mesh``: the rank's groups are the blocks ``group_ranks``
    gives (computed in one pass), the group is torn down at the end, and a
    second default group is refused."""
    import torch.distributed as dist

    with meta_mesh((2, 4, 2), ("pod", "data", "model"), rank=13) as mesh:
        assert mesh.rank == 13 and mesh.device.type == "meta"
        for axes in (("model",), ("data", "model"), ("pod", "model"), ("pod", "data", "model")):
            assert dist.get_process_group_ranks(mesh.group(axes)) == mesh.group_ranks(axes)
            seen = []
            for r in range(16):
                b = mesh.group_ranks(axes, r)
                if b not in seen:
                    seen.append(b)
            assert mesh._blocks(axes) == seen
        with pytest.raises(RuntimeError, match="exists already"):
            with meta_mesh((2,), ("model",)):
                pass
    assert not dist.is_initialized()


def test_cli_writes_jax_artifact_keys_and_a_record_jax_loads(tmp_path, monkeypatch, capsys):
    from repro.core.records import RunRecord as RunRecordJ

    monkeypatch.setenv("TALP_ENABLE", "1")
    monkeypatch.setenv("TALP_BACKEND", "monitor")
    out = tmp_path / "dry"
    rc = D.main(["--arch", "tinyllama-1.1b", "--shape", "train_4k,long_500k",
                 "--multi-pod", "off", "--out", str(out), "--force"])
    assert rc == 0
    rec = json.loads((out / "tinyllama-1.1b__train_4k__singlepod.json").read_text())
    # JAX's keys, with count_s in compile_s's place
    assert set(rec) == {"status", "multi_pod", "arch", "shape", "mode", "mesh", "strategy",
                        "counted_rank", "count_s", "profile", "roofline", "memory_analysis"}
    assert rec["status"] == "ok" and rec["mesh"] == {"data": 16, "model": 16}
    assert set(rec["memory_analysis"]) == {"argument_size_in_bytes", "output_size_in_bytes",
                                           "temp_size_in_bytes", "alias_size_in_bytes"}
    assert rec["roofline"]["bottleneck"] in ("compute_s", "memory_s", "collective_s")
    from repro.core.profile import StepProfile as StepProfileJ

    known = {f.name for f in dataclasses.fields(StepProfileJ)}
    assert set(rec["profile"]) <= known
    skip = json.loads((out / "tinyllama-1.1b__long_500k__singlepod.json").read_text())
    assert skip["status"] == "skipped"
    printed = capsys.readouterr().out
    assert "bottleneck=" in printed and "mem/dev=" in printed and "TALP record" in printed
    records = list((out / "talp").rglob("*.json"))
    assert len(records) == 1
    loaded = RunRecordJ.load(str(records[0]))
    assert "tinyllama-1.1b__train_4k__singlepod" in loaded.regions
