"""The mesh of spmd training: N·P data-parallel ranks over
``torch.distributed``, after the ``(pod, data)`` meshes of
``repro/launch/mesh.py`` and ``repro/train/coded.py``'s spmd mode.

Ranks are laid out pod-major, as ``jax.make_mesh((pod, data),
("pod", "data"))`` lays out devices: rank = pod_index · data +
data_index.  Coding runs across the ``data`` ranks (one worker each);
the ``pod`` ranks of one data index hold row halves of the same
worker's shards and are summed first.  Every rank creates every
subgroup, in the same order (``torch.distributed.new_group`` is
collective).

``meta_mesh`` is the same mesh with no process group, for the dry run
(``repro_torch.launch.dryrun``): one rank's view, on the meta device,
whose groups are ``MetaGroup``s; the collectives make no
``torch.distributed`` call on it (``dist/collectives.py``).

The reference's GSPMD sharding rules (``repro/dist/sharding.py``) and
its jax shims have no counterpart: the port's ranks hold replicated
parameters, as the reference's fully manual coded region replicates the
model axis.  Every spmd entry point takes its ``Mesh`` as an argument,
so there is no ambient mesh context either.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

__all__ = ["Mesh", "MetaGroup", "build_mesh", "meta_mesh", "default_backend",
           "check_backend"]

BACKENDS = ("nccl", "gloo")


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh: its coordinates, its device and its
    groups — the world, its pod's ``data`` ranks and its data index's
    ``pod`` ranks (``None`` when ``pod`` is 1)."""

    data: int
    pod: int
    rank: int
    device: torch.device
    world_group: object
    data_group: object
    pod_group: object

    @property
    def size(self) -> int:
        return self.data * self.pod

    @property
    def data_index(self) -> int:
        return self.rank % self.data

    @property
    def pod_index(self) -> int:
        return self.rank // self.data


@dataclass(frozen=True)
class MetaGroup:
    """A group of ``size`` ranks with no process group behind it."""

    size: int


def meta_mesh(data: int, pod: int = 1, rank: int = 0) -> Mesh:
    """Rank ``rank``'s view of a ``(pod, data)`` mesh on the meta device:
    the shapes of spmd steps, no process group and no storage."""
    if data < 1 or pod < 1 or not 0 <= rank < data * pod:
        raise ValueError(f"a (pod={pod}, data={data}) mesh has no rank {rank}")
    return Mesh(data=data, pod=pod, rank=rank, device=torch.device("meta"),
                world_group=MetaGroup(data * pod), data_group=MetaGroup(data),
                pod_group=MetaGroup(pod) if pod > 1 else None)


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


def build_mesh(data: int, pod: int, device: torch.device) -> Mesh:
    """The mesh over the initialized default process group, which must
    hold ``data · pod`` ranks; creates the subgroups (collective: every
    rank calls this in the same order)."""
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs an initialized default process group "
                           "(repro_torch.launch.mesh.make_local_mesh or dist.spawn)")
    if data < 1 or pod < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data} pod={pod}")
    world = dist.get_world_size()
    if world != data * pod:
        raise ValueError(f"a (pod={pod}, data={data}) mesh needs {data * pod} ranks, the "
                         f"process group has {world}")
    rank = dist.get_rank()
    world_group = dist.group.WORLD
    data_group, pod_group = world_group, None
    if pod > 1:
        for p in range(pod):
            g = dist.new_group([p * data + d for d in range(data)])
            if p == rank // data:
                data_group = g
        for d in range(data):
            g = dist.new_group([p * data + d for p in range(pod)])
            if d == rank % data:
                pod_group = g
    return Mesh(data=data, pod=pod, rank=rank, device=device, world_group=world_group,
                data_group=data_group, pod_group=pod_group)
