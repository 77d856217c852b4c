"""Meshes of ranks (``repro.launch.mesh``).

``Mesh`` carries what the sharding rules read from a JAX mesh,
``axis_names`` and ``devices.shape``, so ``distributed.sharding`` reads
either unchanged. A mesh over a ``torch.distributed`` process group also
holds a ``DeviceMesh`` over the same ranks (rank ``r`` at the row-major
position ``r``), this rank's ``torch.device``, and a process group for
every set of its axes: the ranks that differ only along those axes, in
rank order, which is row-major over the axes in mesh order (the order of
a JAX mesh's devices along a dim sharded over several axes). One rank
holds one device; on the card the backend is ``nccl``, one rank a card;
on the CPU it is ``gloo``.

Nothing here touches the process group at import time, and a mesh that
names no process group (``make_production_mesh``, or world size 1 without
one) has no devices to talk to: its collectives are skipped.

``meta_mesh`` is the dry run's mesh: one process stands for one rank of a
``"fake"`` process group of any size (its collectives return at once and
move nothing) and holds its blocks on the meta device, so a step over
the production mesh is counted without allocating or running anything.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import os

import torch

from repro_torch.device import resolve_device


class _Devices:
    """The ``mesh.devices`` the rules read: ``shape`` and ``size``."""

    def __init__(self, shape):
        self.shape = tuple(shape)
        self.size = math.prod(self.shape)


class Mesh:
    """``axis_names`` x ``devices.shape`` over the ranks of a process group
    (``distributed`` True), or shape only (``device_mesh`` None)."""

    def __init__(self, shape, axis_names, *, device=None, device_mesh=None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} vs axes {tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.devices = _Devices(shape)
        self.device = device
        self.device_mesh = device_mesh
        self.rank = 0
        self._groups: dict[tuple, object] = {}
        if device_mesh is not None:
            import torch.distributed as dist

            self.rank = dist.get_rank()
            self._make_groups()

    @property
    def distributed(self) -> bool:
        return self.device_mesh is not None

    @property
    def sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def coords(self, rank: int | None = None) -> dict[str, int]:
        """A rank's index along each axis (row-major ranks)."""
        r = self.rank if rank is None else rank
        out = {}
        for name, size in reversed(list(zip(self.axis_names, self.devices.shape))):
            out[name] = r % size
            r //= size
        return {n: out[n] for n in self.axis_names}

    def ordered(self, axes) -> tuple:
        """``axes`` in mesh order."""
        axes = set(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def group_ranks(self, axes, rank: int | None = None) -> list[int]:
        """The ranks that differ from ``rank`` only along ``axes``, in rank order."""
        axes = self.ordered(axes)
        c = self.coords(rank)
        sizes = self.sizes
        out = []
        for r in range(self.devices.size):
            rc = self.coords(r)
            if all(rc[a] == c[a] for a in self.axis_names if a not in axes):
                out.append(r)
        assert len(out) == math.prod(sizes[a] for a in axes)
        return out

    def group(self, axes):
        """This rank's process group over ``axes`` (None for no axes or a
        mesh without a process group)."""
        axes = self.ordered(axes)
        if not axes or not self.distributed:
            return None
        return self._groups[axes]

    def _make_groups(self) -> None:
        """Every rank takes part in every ``new_group`` call, in one order:
        for each non-empty set of axes (single axes from the DeviceMesh),
        one group for each block of the partition it makes."""
        import torch.distributed as dist

        for n in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, n):
                if n == 1:
                    self._groups[axes] = self.device_mesh.get_group(axes[0])
                    continue
                for ranks in self._blocks(axes):
                    pg = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[axes] = pg

    def _blocks(self, axes) -> list[list[int]]:
        """The partition of the ranks that ``axes`` makes (each block the
        ranks that differ only along ``axes``, in rank order), blocks in
        the order of their first rank: one pass over the ranks."""
        ranks = torch.arange(self.devices.size).reshape(self.devices.shape)
        keep = [i for i, a in enumerate(self.axis_names) if a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in keep]
        blocks = ranks.permute(rest + keep).reshape(-1, math.prod(
            self.devices.shape[i] for i in keep))
        return [b.tolist() for b in blocks]

    def __repr__(self) -> str:
        return f"Mesh({dict(self.sizes)}, rank={self.rank}, device={self.device})"


def _rank_device(device):
    """This rank's device: ``resolve_device(device)``, and on the card the
    card ``LOCAL_RANK % device_count`` (one rank a card under ``nccl``; two
    ``gloo`` ranks may share one)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        import torch.distributed as dist

        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def make_host_mesh(model: int | None = None, device=None) -> Mesh:
    """A ``(world // model, model)`` mesh ("data", "model") over the ranks of
    the default process group; world size 1 without a process group gives a
    1 x 1 mesh with no collectives. The device is the card unless
    ``device="cpu"``."""
    import torch.distributed as dist

    model = model or 1
    dev = _rank_device(device)
    if not dist.is_initialized():
        if model != 1:
            raise ValueError(f"model axis {model} needs a process group of that many ranks")
        return Mesh((1, 1), ("data", "model"), device=dev)
    world = dist.get_world_size()
    if world % model:
        raise ValueError(f"world size {world} is not a multiple of the model axis {model}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    from torch.distributed.device_mesh import init_device_mesh

    shape = (world // model, model)
    dm = init_device_mesh(dev.type, shape, mesh_dim_names=("data", "model"))
    return Mesh(shape, ("data", "model"), device=dev, device_mesh=dm)


@contextlib.contextmanager
def meta_mesh(shape, axis_names, rank: int = 0):
    """A ``Mesh`` of ``shape`` on the meta device over a ``"fake"`` default
    process group of ``prod(shape)`` ranks, this process rank ``rank``;
    the group is torn down when the block ends. Refuses to run beside an
    existing default group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group exists already: the meta mesh "
                           "sets up a fake one of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=math.prod(shape))
    try:
        dm = init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axis_names))
        yield Mesh(shape, axis_names, device=torch.device("meta"), device_mesh=dm)
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Shape only: 16x16 ("data", "model"), one pod of 256 chips, or 2x16x16
    ("pod", "data", "model"). No process group and no devices: the rules
    and the dry run read its axes."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def devices_per_pod(mesh) -> int | None:
    """Device count inside one pod (None when single-pod: no DCN)."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    if "pod" not in sizes or sizes["pod"] == 1:
        return None
    return math.prod(mesh.devices.shape) // sizes["pod"]
