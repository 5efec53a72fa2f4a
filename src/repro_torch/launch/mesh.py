"""The data-parallel mesh across processes: the port's counterpart of the
JAX package's ``launch/mesh.py``.

The JAX launcher builds a ``(data, model)`` device mesh and runs its step
under ``shard_map`` over the data axis. The port's mesh is a
``torch.distributed`` process group: one rank a card over NCCL, or several
ranks over gloo (on the CPU, or sharing one card when the caller names it).
Each rank holds ``data / world`` of the data axis's workers on the leading
dim of its per-worker tensors (``core/comm.py:DistComm``); rank r's local
worker j is global worker ``r * local + j``. Without a process group one
process holds all of them (``SimComm``), as before.

    python -m torch.distributed.run --nproc-per-node 2 \\
        -m repro_torch.launch.train --mesh 4x1 ...

A model axis above 1 spans ``data x model`` ranks, rank ``d * model + m``
holding coordinate (d, m): the model axis is minor, as ``jax.make_mesh``
orders devices. Every rank makes the model-axis groups (the ranks of one
d) and the data-axis groups (those of one m) in one fixed order, and the
mesh keeps its own two. Serving takes such a mesh for all ten
architectures (``launch/serve.py``, the fixed scheduler, and the continuous
one for the token LMs), and so does training (``launch/train.py`` with
every compressor, codec, per-leaf policy, schedule, lazy group and wire,
whose sync's ``DistComm`` spans the data-axis group, :func:`make_comm`).

The production mesh (:func:`make_production_mesh`) is the H100 cluster
the port is deployed on: one DGX SuperPOD scalable unit of 32 nodes of 8
cards, ``(data 32, model 8)``, with the model axis inside a node's NVLink
domain and the data axis across nodes over InfiniBand; ``multi_pod`` takes
two units, ``(64, 8)``. The JAX package's is a TPU v5e 16 x 16; the port's
shape differs on purpose, since a model axis of 16 would span two nodes.
The dry run (``launch/dryrun.py``) builds it over a fake process group
(:func:`init_fake_distributed`) and fake tensors, on no card.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.core.comm import DistComm, ModelComm, SimComm
from repro_torch.models.common import resolve_device

__all__ = [
    "DataMesh",
    "init_distributed",
    "make_mesh",
    "make_comm",
    "make_model_comm",
    "make_production_mesh",
    "init_fake_distributed",
    "PRODUCTION_MESH_SHAPE",
]

# (data, model) of the production mesh: one scalable unit (256 cards), or
# two with multi_pod (512); the model axis is a node's 8 cards
PRODUCTION_MESH_SHAPE = {False: (32, 8), True: (64, 8)}
# what a refusal of the production mesh names
PRODUCTION_MESH = "the H100 production mesh"


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A ``(data, model)`` mesh over ``world`` processes: this rank, the
    workers it holds (``local``), its device and the process group's
    backend (None without a group)."""

    data: int
    model: int
    world: int
    rank: int
    local: int
    device: torch.device
    backend: str | None
    # this rank's (data, model) coordinates (at a model axis of 1 its index
    # among the ranks) and, above 1, the process groups of its model-axis
    # and data-axis neighbours
    data_index: int = 0
    model_index: int = 0
    model_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    data_group: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.data, self.model)

    @property
    def sizes(self) -> dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def coords(self) -> dict[str, int]:
        return {"data": self.data_index, "model": self.model_index}

    @property
    def distributed(self) -> bool:
        return self.backend is not None


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _rank_device(device: torch.device | str, backend: str | None) -> torch.device:
    """This rank's device: the CPU, the card the caller names (``cuda:i``,
    every rank on it: gloo only, where ranks share a host), or the card of
    its ``LOCAL_RANK`` (``cuda``). Never a card picked by a modulo."""
    dev = torch.device(device)
    if dev.type != "cuda" or backend is None:
        return resolve_device(dev)
    resolve_device(dev)
    if dev.index is not None:
        if backend == "nccl" and _env_int("LOCAL_WORLD_SIZE", 1) > 1:
            raise ValueError(
                f"--device {dev} puts every rank of this host on one card, "
                "which NCCL refuses; give each rank its card (--device cuda) "
                "or share the card over --dist-backend gloo"
            )
        return dev
    local_rank, cards = _env_int("LOCAL_RANK", 0), torch.cuda.device_count()
    if local_rank >= cards:
        raise ValueError(
            f"LOCAL_RANK {local_rank} on a host with {cards} card(s): run one "
            "rank a card, or share one card with --dist-backend gloo "
            "--device cuda:0"
        )
    return torch.device("cuda", local_rank)


def init_distributed(
    backend: str | None = None, device: torch.device | str = "cuda"
) -> bool:
    """Join the process group torchrun describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``), with ``backend``
    (default NCCL for CUDA, gloo for the CPU), and print it. Returns True
    where this call created the group (the caller destroys it when done);
    False where a group exists already (it is used as it is) or where
    there is no torchrun variable (one process: the caller runs without a
    group)."""
    if dist.is_initialized():
        return False
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    rank, world = _env_int("RANK", 0), _env_int("WORLD_SIZE", 1)
    kind = torch.device(device).type
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if backend == "nccl" and kind != "cuda":
        raise ValueError(f"NCCL needs CUDA tensors, not --device {device}")
    dev = _rank_device(device, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    print(
        f"# torch.distributed: backend={backend} world={world} rank={rank} "
        f"local_rank={_env_int('LOCAL_RANK', 0)} device={dev}",
        flush=True,
    )
    return True


def make_mesh(
    shape: tuple[int, int], device: torch.device | str = "cuda"
) -> DataMesh:
    """The ``(data, model)`` mesh over the process group (one process where
    there is none). At a model axis of 1 each rank holds ``data / world``
    of the data axis's workers, which ``world`` must divide. Above 1 the
    mesh must cover the world exactly (``data * model`` ranks, one worker
    a rank), and every rank makes the model-axis and data-axis groups."""
    data, model = shape
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        backend = str(dist.get_backend())
    else:
        world, rank, backend = 1, 0, None
    if model < 1:
        raise ValueError(f"a model axis of {model}")
    if model > 1:
        if data < 1 or data * model != world:
            raise ValueError(
                f"a {data}x{model} mesh over {world} rank(s): a model axis "
                "above 1 takes data x model ranks, one a coordinate"
            )
        model_group = data_group = None
        # every rank creates every group, in this order
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if d == rank // model:
                model_group = g
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if m == rank % model:
                data_group = g
        return DataMesh(
            data=data,
            model=model,
            world=world,
            rank=rank,
            local=1,
            device=_rank_device(device, backend),
            backend=backend,
            data_index=rank // model,
            model_index=rank % model,
            model_group=model_group,
            data_group=data_group,
        )
    if data < 1 or data % world:
        raise ValueError(
            f"a data axis of {data} over {world} ranks: each rank holds "
            "data / world workers"
        )
    return DataMesh(
        data=data,
        model=model,
        world=world,
        rank=rank,
        local=data // world,
        device=_rank_device(device, backend),
        backend=backend,
        data_index=rank,
    )


def make_comm(mesh: DataMesh, *, record: bool = False) -> SimComm | DistComm:
    """The workers' comm: a ``DistComm`` of the rank's workers over the
    process group (over its data-axis group where the model axis is above
    1), or a ``SimComm`` of all of them without one."""
    if mesh.distributed:
        return DistComm(mesh.local, record=record, group=mesh.data_group)
    return SimComm(mesh.data, record=record)


def make_model_comm(mesh: DataMesh) -> ModelComm:
    """The model-axis comm of this rank (a group of one at a model axis
    of 1)."""
    return ModelComm(mesh.model_group, mesh.model, mesh.model_index)


def make_production_mesh(
    *, multi_pod: bool = False, device: torch.device | str = "cuda"
) -> DataMesh:
    """:func:`make_mesh` of the production mesh's shape over the process
    group, which must have its 256 ranks (512 with ``multi_pod``): under
    torchrun across the cluster, or the dry run's fake group."""
    data, model = PRODUCTION_MESH_SHAPE[multi_pod]
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != data * model:
        kind = "multi-pod " if multi_pod else ""
        raise ValueError(
            f"{PRODUCTION_MESH} ({kind}{data}x{model}) takes {data * model} ranks, "
            f"not {world}: run it under torchrun over {data * model} ranks, or "
            "trace it with python -m repro_torch.launch.dryrun"
        )
    return make_mesh((data, model), device)


def init_fake_distributed(world: int, rank: int = 0) -> None:
    """A fake process group of ``world`` ranks in which this process is
    ``rank``: its collectives return at once and move nothing (PyTorch's
    ``fake`` backend), so a rank's step can be traced over fake tensors at
    the production mesh's size in one process. The caller destroys it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group exists already")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
