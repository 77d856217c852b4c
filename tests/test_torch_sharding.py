"""The port's sharding rules, logical axes and pspecs against the JAX
package's, in one process: duck-typed meshes (as
``tests/test_dryrun_unit.py``'s ``_FakeMesh``) for the JAX functions, the
port's shape-only ``launch.mesh.Mesh`` for the port's, on the meshes (1,
1), (2, 2), (4, 2), (16, 16) and (2, 16, 16), for all ten archs. A pspec
in the port is a tuple, JAX's a ``PartitionSpec``: ``tuple(P)`` compares.
Also ``tests/test_dryrun_unit.py``'s batch-axis, strategy-fallback and
shape-aware back-off tests, mirrored."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as get_j  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.distributed import sharding as SHJ  # noqa: E402
from repro.layers.common import LogicalConstraints as LCJ  # noqa: E402
from repro.layers.common import ParamSpec as SpecJ  # noqa: E402
from repro.layers.common import param_pspecs as pspecs_j  # noqa: E402
from repro.models import transformer as TJ  # noqa: E402
from repro.train.train import TrainConfig as TrainConfigJ  # noqa: E402
from repro.train.train import train_state_pspecs as state_pspecs_j  # noqa: E402
from repro_torch.configs import get_config as get_t  # noqa: E402
from repro_torch.distributed import sharding as SHT  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_production_mesh  # noqa: E402
from repro_torch.layers.common import LogicalConstraints as LCT  # noqa: E402
from repro_torch.layers.common import param_pspecs as pspecs_t  # noqa: E402
from repro_torch.layers.common import tree_leaves  # noqa: E402
from repro_torch.models.transformer import model_params  # noqa: E402
from repro_torch.train.train import TrainConfig  # noqa: E402
from repro_torch.train.train import train_state_pspecs as state_pspecs_t  # noqa: E402

ARCHS = list_archs()
MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
# the logical activation names the layers constrain, and dims to place
ACTIVATION_NAMES = ("batch", "seq", "seq_q", "seq_kv", "seq_mlp", "heads", "kv_heads", "mlp",
                    "experts", "expert_cap", "expert_mlp", "inner", "vocab", "embed", None)
DIMS = (1, 2, 3, 4, 6, 8, 16, 32, 64, 96, 256, 512, 1024)


class _FakeDevices:
    def __init__(self, shape):
        self.shape = shape
        self.size = int(np.prod(shape))


class _FakeMesh:
    """Duck-typed mesh for the JAX rules (1 real device in-process)."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = _FakeDevices(shape)


def _meshes(name):
    shape, names = MESHES[name]
    return _FakeMesh(shape, names), Mesh(shape, names)


def _jax_tree(tree, leaf_type):
    leaves = jax.tree_util.tree_leaves_with_path(tree, is_leaf=lambda x: isinstance(x, leaf_type))
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf for path, leaf in leaves}


@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_has_the_jax_shape_and_logical_axes(arch):
    want = {p: (tuple(s.shape), tuple(s.logical))
            for p, s in _jax_tree(TJ.model_params(get_j(arch)), SpecJ).items()}
    got = {p: (tuple(s.shape), tuple(s.logical)) for p, s in tree_leaves(model_params(get_t(arch)))}
    assert got == want
    stacked = [p for p in got if p.startswith("slots/")]
    assert stacked and all(got[p][1][0] == "layers" for p in stacked)


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_bytes_and_param_count_are_jax_ones(arch):
    import jax.numpy as jnp

    from repro.layers.common import count_params as count_j
    from repro.layers.common import spec_bytes as bytes_j
    from repro_torch.layers.common import count_params as count_t
    from repro_torch.layers.common import spec_bytes as bytes_t

    tj, tt = TJ.model_params(get_j(arch)), model_params(get_t(arch))
    assert count_t(tt) == count_j(tj)
    for dj, dt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        assert bytes_t(tt, dt) == bytes_j(tj, dj)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_and_strategy_are_jax_ones(arch, mesh):
    mj, mt = _meshes(mesh)
    cj, ct = get_j(arch), get_t(arch)
    assert SHT.effective_strategy(ct, mt) == SHJ.effective_strategy(cj, mj)
    assert SHT.param_rules(ct, mt) == SHJ.param_rules(cj, mj)
    assert SHT.activation_rules(ct, mt) == SHJ.activation_rules(cj, mj)
    assert SHT.batch_pspec(ct, mt) == tuple(SHJ.batch_pspec(cj, mj))
    assert SHT.data_shards(mt) == SHJ.data_shards(mj)
    for b in DIMS:
        assert SHT.divisible_batch_axes(mt, b) == SHJ.divisible_batch_axes(mj, b)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_train_state_pspecs_are_jax_ones(arch, mesh):
    mj, mt = _meshes(mesh)
    cj, ct = get_j(arch), get_t(arch)
    want = {p: tuple(s) for p, s in _jax_tree(
        pspecs_j(TJ.model_params(cj), SHJ.param_rules(cj, mj), mj), P).items()}
    got = dict(tree_leaves(pspecs_t(model_params(ct), SHT.param_rules(ct, mt), mt)))
    assert got == want
    # without a mesh: no divisibility back-off
    want0 = {p: tuple(s) for p, s in _jax_tree(
        pspecs_j(TJ.model_params(cj), SHJ.param_rules(cj, mj)), P).items()}
    assert dict(tree_leaves(pspecs_t(model_params(ct), SHT.param_rules(ct, mt)))) == want0
    want_state = {p: tuple(s) for p, s in _jax_tree(
        state_pspecs_j(cj, mj, TrainConfigJ()), P).items()}
    got_state = dict(tree_leaves(state_pspecs_t(ct, mt, TrainConfig())))
    assert got_state == want_state


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_activation_pspecs_groups_and_axis_sizes_are_jax_ones(arch, mesh):
    mj, mt = _meshes(mesh)
    lj = LCJ(mj, SHJ.activation_rules(get_j(arch), mj))
    lt = LCT(mt, SHT.activation_rules(get_t(arch), mt))
    for name in ACTIVATION_NAMES:
        if name is not None:
            assert lt.axis_size(name) == lj.axis_size(name), name
        for d in DIMS:
            if name is not None:
                assert lt.group_count(name, d) == lj.group_count(name, d), (name, d)
            for other in ("seq", "heads", None):
                shape = (d, 2 * d, 64)
                assert lt.pspec_for(shape, name, other, None) == tuple(
                    lj.pspec_for(shape, name, other, None)), (name, other, d)
        assert lt.pspec(name, "seq", "vocab") == tuple(lj.pspec(name, "seq", "vocab"))


def test_meshes_without_a_process_group():
    for multi, shape, names in ((False, (16, 16), ("data", "model")),
                                (True, (2, 16, 16), ("pod", "data", "model"))):
        m = make_production_mesh(multi_pod=multi)
        assert (m.devices.shape, m.axis_names, m.distributed) == (shape, names, False)
    from repro.launch.mesh import devices_per_pod as dpp_j
    from repro_torch.launch.mesh import devices_per_pod as dpp_t

    for name in MESHES:
        mj, mt = _meshes(name)
        assert dpp_t(mt) == dpp_j(mj)
    host = make_host_mesh(device="cpu")
    assert (host.devices.shape, host.distributed, host.device) == ((1, 1), False,
                                                                   torch.device("cpu"))
    # row-major ranks, and the ranks of a group of axes in rank order
    m = Mesh((2, 2), ("data", "model"))
    assert [tuple(m.coords(r).values()) for r in range(4)] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert m.group_ranks(("model",), 2) == [2, 3]
    assert m.group_ranks(("data",), 1) == [1, 3]
    assert m.group_ranks(("model", "data"), 3) == [0, 1, 2, 3]


def test_named_sharding_blocks_tile_the_leaf():
    """Every element of a leaf belongs to the blocks the ranks hold, and a
    block's holders are exactly the ranks that differ along the axes the
    pspec does not name; one of them owns it."""
    from repro_torch.distributed.shard import NamedSharding, _assemble, _split

    m = Mesh((2, 2), ("data", "model"))
    x = torch.arange(8 * 6 * 4).reshape(8, 6, 4)
    for spec in [(None, "model", None), ("data", None, "model"), (("data", "model"), None, None),
                 (None, None, None), ("model", "data", None)]:
        sh = NamedSharding(m, spec)
        cover = torch.zeros_like(x)
        owners = torch.zeros_like(x)
        for r in range(4):
            sl = sh.block_slices(tuple(x.shape), r)
            cover[sl] += 1
            owners[sl] += int(sh.owned(r))
        n_axes = len(sh.axes)
        assert (cover == 4 // (2 ** n_axes)).all() and (owners == 1).all(), spec
        # the all-gather's stack (group rank order) reassembles the leaf
        group = m.group_ranks(sh.axes, 0)
        stacked = torch.stack([x[sh.block_slices(tuple(x.shape), r)] for r in group])
        assert torch.equal(_assemble(stacked, sh), x)
        assert torch.equal(_split(x, sh), stacked)


def test_divisible_batch_axes():
    mesh = Mesh((2, 2), ("data", "model"))
    assert SHT.divisible_batch_axes(mesh, 4) == "data"
    assert SHT.divisible_batch_axes(mesh, 1) is None
    assert SHT.divisible_batch_axes(mesh, 3) is None
    mp = Mesh((2, 4, 2), ("pod", "data", "model"))
    assert SHT.divisible_batch_axes(mp, 16) == ("pod", "data")
    assert SHT.divisible_batch_axes(mp, 2) == "pod"


def test_effective_strategy_fallback():
    mesh = make_host_mesh(device="cpu")  # 1 device: model axis = 1 -> all divisible
    assert SHT.effective_strategy(get_t("tinyllama-1.1b"), mesh) == "megatron"
    assert SHT.effective_strategy(get_t("gemma2-2b"), mesh) == "fsdp"


def test_shape_aware_pspec_backoff():
    mesh = Mesh((2, 2), ("data", "model"))
    lc = LCT(mesh, {"batch": ("data", "model")})
    # divisible by 4 -> both axes
    assert lc.pspec_for((8, 3), "batch", None)[0] == ("data", "model")
    # divisible by 2 only -> back off to ("data",)
    assert lc.pspec_for((2, 3), "batch", None)[0] == "data"
    # not divisible -> replicated
    assert lc.pspec_for((3, 3), "batch", None)[0] is None


def test_input_shardings_put_the_batch_on_the_batch_axes():
    mesh = Mesh((2, 2), ("data", "model"))
    cfg = get_t("tinyllama-1.1b")
    tree = SHT.input_shardings(cfg, mesh, {"tokens": torch.zeros(1, 4, 8),
                                           "frontend": torch.zeros(1, 4, 2, 3)})
    assert tree["tokens"].spec == ("data", None, None)
    assert tree["frontend"].spec == ("data", None, None, None)
    pod = SHT.input_shardings(cfg, Mesh((2, 2, 1), ("pod", "data", "model")),
                              {"labels": torch.zeros(4, 8)})
    assert pod["labels"].spec == (("pod", "data"), None)
