"""The virtual data-parallel mesh.

The twin of ``repro.launch.mesh.make_host_mesh(data, model)`` for the
port's virtual-rank executor: ``data`` ranks held as the leading axis of
every parameter, optimizer and gradient tensor on one device. It has no
model axis (tensor parallelism waits for the sharding port, ROADMAP
Queue 1 item 13) and no production/multi-pod form.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class VirtualMesh:
    data: int  # data-parallel ranks
    device: torch.device  # where all of them live
    axis: str = "data"

    def __post_init__(self):
        if self.data < 1:
            raise ValueError(f"the data axis needs at least one rank, got {self.data}")


def make_host_mesh(data: int, device: torch.device) -> VirtualMesh:
    return VirtualMesh(data=data, device=torch.device(device))
