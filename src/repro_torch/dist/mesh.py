"""The mesh of spmd training: ``pod · data · model`` ranks over
``torch.distributed``, after the ``(pod, data, model)`` meshes of
``repro/launch/mesh.py`` and ``repro/train/coded.py``'s spmd mode.

Ranks are laid out as ``jax.make_mesh((pod, data, model), ("pod",
"data", "model"))`` lays out devices: rank = (pod_index · data +
data_index) · model + model_index.  Coding runs across the ``data``
ranks (one worker each); the ``pod`` ranks of one data index hold row
halves of the same worker's shards and are summed first; the ``model``
ranks of one (pod, data) index hold the tensor-parallel shards of one
replica (``models.params.shard_model``) and read the same batches.  A
rank's data group is the ranks with its pod and model index, its pod
group those with its data and model index, its model group those with
its pod and data index.  Every rank creates every subgroup, in the same
order (``torch.distributed.new_group`` is collective).

``meta_mesh`` is the same mesh with no process group, for the dry run
(``repro_torch.launch.dryrun``): one rank's view, on the meta device,
whose groups are ``MetaGroup``s; the collectives make no
``torch.distributed`` call on it (``dist/collectives.py``).
``solo_mesh`` is one rank's view on a real device whose groups are
``SoloGroup``s: the rank runs alone, its collectives return what one
rank's would in shape (the dry run's ``--measure``).

The reference's coded region keeps ``model`` an auto axis that GSPMD
splits by its sharding rules; the port splits it explicitly by the same
rules (``dist/sharding.py``).  Every spmd entry point takes its ``Mesh``
as an argument, so there is no ambient mesh context.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

__all__ = ["Mesh", "MetaGroup", "SoloGroup", "build_mesh", "meta_mesh", "solo_mesh",
           "default_backend", "check_backend"]

BACKENDS = ("nccl", "gloo")


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh: its coordinates, its device and its
    groups — the world, its ``data`` ranks, its ``pod`` ranks (``None``
    when ``pod`` is 1) and its ``model`` ranks (``None`` when ``model``
    is 1)."""

    data: int
    pod: int
    rank: int
    device: torch.device
    world_group: object
    data_group: object
    pod_group: object
    model: int = 1
    model_group: object = None

    @property
    def size(self) -> int:
        return self.data * self.pod * self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model % self.data

    @property
    def pod_index(self) -> int:
        return self.rank // (self.model * self.data)

    @property
    def shape(self) -> dict:
        """Mesh axis -> size, as the reference's production meshes name
        them: ``pod`` when there are pods, then ``data`` and ``model``."""
        axes = {"pod": self.pod} if self.pod > 1 else {}
        return {**axes, "data": self.data, "model": self.model}


@dataclass(frozen=True)
class MetaGroup:
    """A group of ``size`` ranks with no process group behind it."""

    size: int


@dataclass(frozen=True)
class SoloGroup:
    """A group of ``size`` ranks of which only this one runs: its
    collectives make no ``torch.distributed`` call and return what this
    rank's would in shape — an all-reduce or a broadcast its input, an
    all-gather its tile repeated, a reduce-scatter its first tile — so
    the values are not the mesh's."""

    size: int


def _view(data: int, pod: int, rank: int, model: int, device, group) -> Mesh:
    if data < 1 or pod < 1 or model < 1 or not 0 <= rank < data * pod * model:
        raise ValueError(f"a (pod={pod}, data={data}, model={model}) mesh has no rank {rank}")
    return Mesh(data=data, pod=pod, rank=rank, device=torch.device(device),
                world_group=group(data * pod * model), data_group=group(data),
                pod_group=group(pod) if pod > 1 else None, model=model,
                model_group=group(model) if model > 1 else None)


def meta_mesh(data: int, pod: int = 1, rank: int = 0, model: int = 1) -> Mesh:
    """Rank ``rank``'s view of a ``(pod, data, model)`` mesh on the meta
    device: the shapes of spmd steps, no process group and no storage."""
    return _view(data, pod, rank, model, "meta", MetaGroup)


def solo_mesh(data: int, pod: int = 1, rank: int = 0, model: int = 1,
              device="cuda") -> Mesh:
    """Rank ``rank``'s view of a ``(pod, data, model)`` mesh on ``device``
    with ``SoloGroup``s: the rank's step runs alone, with its own shapes
    and memory, and no process group."""
    return _view(data, pod, rank, model, device, SoloGroup)


def default_backend(device: torch.device) -> str:
    """``nccl`` for CUDA tensors, ``gloo`` for the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def check_backend(backend: str, n_local_ranks: int, device: torch.device = None) -> None:
    """Raise before a process group exists when ``backend`` cannot run
    ``n_local_ranks`` ranks of this host: NCCL takes one card per rank
    and CUDA tensors only.  ``gloo`` takes any number of ranks, CPU or
    CUDA tensors (staged through the host)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if backend != "nccl":
        return
    if device is not None and device.type != "cuda":
        raise ValueError(f"backend='nccl' needs CUDA tensors, the mesh device is {device}")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_local_ranks > cards:
        raise ValueError(f"backend='nccl' runs one rank per card: {n_local_ranks} ranks on "
                         f"this host share {cards} card(s); pass backend='gloo' to "
                         "rehearse several ranks on one card")


def build_mesh(data: int, pod: int, device: torch.device, model: int = 1) -> Mesh:
    """The mesh over the initialized default process group, which must
    hold ``pod · data · model`` ranks; creates the subgroups (collective:
    every rank calls this in the same order)."""
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs an initialized default process group "
                           "(repro_torch.launch.mesh.make_local_mesh or dist.spawn)")
    if data < 1 or pod < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data} pod={pod} model={model}")
    world = dist.get_world_size()
    if world != data * pod * model:
        raise ValueError(f"a (pod={pod}, data={data}, model={model}) mesh needs "
                         f"{data * pod * model} ranks, the process group has {world}")
    rank = dist.get_rank()

    def group(members):
        """One group per entry of ``members`` (lists of (p, d, m)
        coordinates); returns this rank's."""
        found = None
        for coords in members:
            ranks = [(p * data + d) * model + m for p, d, m in coords]
            g = dist.new_group(ranks)
            if rank in ranks:
                found = g
        return found

    world_group = dist.group.WORLD
    data_group, pod_group, model_group = world_group, None, None
    if pod > 1 or model > 1:
        data_group = group([[(p, d, m) for d in range(data)]
                            for p in range(pod) for m in range(model)])
    if pod > 1:
        pod_group = group([[(p, d, m) for p in range(pod)]
                           for d in range(data) for m in range(model)])
    if model > 1:
        model_group = group([[(p, d, m) for m in range(model)]
                             for p in range(pod) for d in range(data)])
    return Mesh(data=data, pod=pod, rank=rank, device=device, world_group=world_group,
                data_group=data_group, pod_group=pod_group, model=model,
                model_group=model_group)
