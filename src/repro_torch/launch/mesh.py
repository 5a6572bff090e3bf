"""Meshes: the virtual and the process meshes, and the production mesh
shapes.

``VirtualMesh`` is the twin of ``repro.launch.mesh.make_host_mesh(data,
model)`` for the port's virtual-rank executor: ``data`` ranks held as the
leading axis of every parameter, optimizer and gradient tensor on one
device, with a model axis of 1. Its ``shape`` is what the sharding policy
reads.

``ProcessMesh`` is the same mesh over processes, every rank its own
process holding its own buffers, as each JAX device does. With a model
axis of 1 it is ``make_host_mesh(data=world, model=1)``, and the
cross-process executor (:mod:`repro_torch.core.collectives_dist`) runs on
the world group. :func:`lay_out_mesh` lays a world out as a given
``MeshShape`` of exactly its size, row-major as ``make_mesh`` lays out the
JAX devices: on ``(pod, data, model)`` global rank ``r = (p·data +
d)·model + m``, so a model group is a run of consecutive ranks
(:func:`split_model_axis` is its ``(data, model)`` case). It then holds a
``DeviceMesh`` with the shape's dim names, on which the policy's specs place
every leaf as a DTensor (its model groups carry DTensor's tensor-parallel
collectives), and this rank's gradient group: the ranks that share its
model coordinate, the data axes flattened into one in pod-major order,
which is JAX's combined index of ``("pod", "data")`` over which the
Schedule IR numbers its partners. Under ``flat_dp`` (``make_policy``'s,
which makes the whole mesh data parallel) the mesh keeps its dims and the
gradient group is the whole world in row-major order. The backend is the
caller's choice and is never switched: ``nccl`` moves device tensors as
they are and puts no two ranks on one GPU; ``gloo`` stages every CUDA
payload through host memory, so on one card its times are those of a
host-staged wire, not of a link.

The production meshes are shapes (``sharding.policy.MeshShape``): single
pod, 256 chips as (data=16, model=16); multi-pod, 2 × 256 as (pod=2,
data=16, model=16), the gradient all-reduce running over ("pod", "data").
The policy is made and checked on them; a world of 256 or 512 ranks is laid
out as one of them by :func:`lay_out_mesh`.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device
from repro_torch.sharding.policy import MeshShape, flat_group


@dataclasses.dataclass(frozen=True)
class VirtualMesh:
    data: int  # data-parallel ranks
    device: torch.device  # where all of them live
    axis: str = "data"

    def __post_init__(self):
        if self.data < 1:
            raise ValueError(f"the data axis needs at least one rank, got {self.data}")

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis: self.data, "model": 1}


def make_host_mesh(data: int, device: torch.device) -> VirtualMesh:
    return VirtualMesh(data=data, device=torch.device(device))


NCCL_ONE_RANK_PER_GPU = ("{ranks} ranks on this host but {cards} visible CUDA card(s): NCCL "
                         "puts no two ranks on one GPU; pass the gloo backend to stage "
                         "payloads through host memory")


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    rank: int
    world: int
    group: dist.ProcessGroup  # this rank's data group: the gradient reductions'
    backend: str  # "nccl" or "gloo"
    device: torch.device  # this rank's
    axis: str = "data"
    model: int = 1
    #: the mesh's dims over the world (``("data", "model")`` or ``("pod", "data",
    #: "model")``), where ``model > 1``, a pod axis or ``flat_dp`` places the leaves
    device_mesh: Optional[DeviceMesh] = None
    pod: int = 1  # > 1: the mesh has a pod axis before its data axis
    flat_dp: bool = False  # the model axis carries data too: ``group`` is the world

    @property
    def data(self) -> int:
        """The data-parallel width: the gradient group's size (pod·data, or
        the world under ``flat_dp``)."""
        return self.world if self.flat_dp else self.world // self.model

    @property
    def shape(self) -> dict[str, int]:
        pod = {"pod": self.pod} if self.pod > 1 else {}
        return {**pod, self.axis: self.world // (self.pod * self.model), "model": self.model}


def launched_by_torchrun() -> bool:
    """A process group exists, or torchrun's environment names this rank."""
    return dist.is_initialized() or ("RANK" in os.environ and "WORLD_SIZE" in os.environ)


def init_process_mesh(device="cuda", backend: Optional[str] = None,
                      init_method: Optional[str] = None, rank: Optional[int] = None,
                      world_size: Optional[int] = None) -> ProcessMesh:
    """The process mesh of this rank, reusing a process group that exists.

    Otherwise the group is made from ``init_method`` (a ``file://`` path, as
    the tests pass) or torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``). The backend defaults to
    ``nccl`` on ``cuda`` and ``gloo`` on ``cpu``. This rank's card is
    ``cuda:{LOCAL_RANK % device_count}``, made current before the group, as
    NCCL's P2P calls need. ``nccl`` with more ranks on the host than visible
    cards raises before any group is made.
    """
    if dist.is_initialized():
        have = dist.get_backend()
        if backend is not None and backend != have:
            raise ValueError(f"a {have} process group exists; asked for {backend}")
        backend = have
        rank, world_size = dist.get_rank(), dist.get_world_size()
    else:
        backend = backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    if backend == "nccl":
        cards = torch.cuda.device_count()
        on_host = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        if on_host > cards:
            raise ValueError(NCCL_ONE_RANK_PER_GPU.format(ranks=on_host, cards=cards))
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world_size)
    return ProcessMesh(rank=rank, world=world_size, group=dist.group.WORLD, backend=backend,
                       device=dev)


def lay_out_mesh(mesh: ProcessMesh, shape: MeshShape, flat_dp: bool = False) -> ProcessMesh:
    """The world of ``mesh`` laid out as ``shape`` (``("data", "model")`` or
    ``("pod", "data", "model")``), which must have exactly the world's size:
    the ``DeviceMesh`` with its dim names, and this rank's gradient group as
    ``group`` (the data axes flattened, pod-major; under ``flat_dp`` the whole
    world, row-major). A ``(data, model)`` shape at model 1 without
    ``flat_dp`` is the world as it is, with no ``DeviceMesh``. Collective:
    every rank of the world calls it."""
    sizes = shape.shape
    if tuple(shape.axis_names) not in (("data", "model"), ("pod", "data", "model")):
        raise ValueError(f"a process mesh is (data, model) or (pod, data, model), "
                         f"not {shape.axis_names}")
    if math.prod(shape.axis_sizes) != mesh.world:
        raise ValueError(f"the mesh {sizes} needs {math.prod(shape.axis_sizes)} ranks, "
                         f"the world has {mesh.world}")
    pod, model = sizes.get("pod", 1), sizes["model"]
    if "pod" not in sizes and model == 1 and not flat_dp:
        return mesh
    if mesh.device.type == "cuda":
        torch.cuda.init()  # else the DeviceMesh picks a card by LOCAL_RANK itself
    dm = init_device_mesh(mesh.device.type, tuple(shape.axis_sizes),
                          mesh_dim_names=tuple(shape.axis_names))
    data_axes = tuple(shape.axis_names) if flat_dp else tuple(shape.axis_names[:-1])
    return dataclasses.replace(mesh, group=flat_group(dm, data_axes), model=model,
                               device_mesh=dm, pod=pod, flat_dp=flat_dp)


def split_model_axis(mesh: ProcessMesh, data: int) -> ProcessMesh:
    """``mesh`` as ``data × (world / data)`` (:func:`lay_out_mesh`): the
    ``DeviceMesh``, whose ``"model"`` group DTensor's collectives run on, and
    this rank's data group as ``group``. Collective: every rank of the world
    calls it. A width that does not divide the world raises ``ValueError``."""
    if data < 1 or mesh.world % data:
        raise ValueError(f"--data-parallel {data} does not divide a world of {mesh.world} ranks")
    return lay_out_mesh(mesh, MeshShape(("data", "model"), (data, mesh.world // data)))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def data_axes(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.shape else ("data",)
