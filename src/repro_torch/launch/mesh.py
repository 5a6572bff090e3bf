"""Meshes: the virtual data-parallel mesh and the production mesh shapes.

``VirtualMesh`` is the twin of ``repro.launch.mesh.make_host_mesh(data,
model)`` for the port's virtual-rank executor: ``data`` ranks held as the
leading axis of every parameter, optimizer and gradient tensor on one
device, with a model axis of 1. Its ``shape`` is what the sharding policy
reads.

The production meshes are shapes only (``sharding.policy.MeshShape``):
single pod, 256 chips as (data=16, model=16); multi-pod, 2 × 256 as (pod=2,
data=16, model=16), the gradient all-reduce running over ("pod", "data").
The policy is made and checked on them; running on them needs an executor
across devices, which the port does not have yet.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.sharding.policy import MeshShape


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


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def data_axes(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.shape else ("data",)
