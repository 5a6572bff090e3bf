"""AdamW with decoupled weight decay, cosine schedule, global-norm clipping.

The twin of ``repro.optim.adamw``. Moments are fp32 whatever the parameter
dtype. The schedule and the bias corrections are fp32 tensors, as JAX
computes them, not Python floats (which would be float64).

Every leaf may carry leading rank axes: ``state["step"]`` has exactly
those axes (``[]`` for one replica, ``[p]`` for the port's virtual data-
parallel ranks), and the norm, the clip factor, the learning rate and the
bias corrections are taken per rank and broadcast over each leaf.

Under tensor parallelism every leaf is a DTensor placed by the sharding
policy: the norm adds each leaf's squares over all its shards and counts a
replicated leaf once, and each leaf is updated on its moments' placement
(ZeRO-1's data shards under ``--comm xla``), its param gathered back to its
own placement after.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.sharding.policy import redistribute
from repro_torch.tree import leaves, tree_map, unflatten

Tensor = torch.Tensor
Tree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_at(cfg: AdamWConfig, step: Tensor) -> Tensor:
    """Linear warmup → cosine decay to min_lr_ratio·lr (fp32, step's shape)."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: Tree, lead: tuple[int, ...] = ()) -> dict:
    """Zero fp32 moments; ``lead`` are the rank axes the leaves carry."""
    dev = leaves(params)[0].device
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                      params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                      params),
        "step": torch.zeros(lead, dtype=torch.int32, device=dev),
    }


def global_norm(tree: Tree, lead: int = 0) -> Tensor:
    """√Σ g², summed over every leaf in JAX's flatten order, one value per
    index of the ``lead`` leading (rank) axes.

    Each rank's sums run over its own slice of each leaf, one slice at a
    time: on the card a reduction's order follows its tensor's shape, and
    so a virtual rank rounds as a process holding only that rank's leaves
    does."""
    ls = leaves(tree)
    if isinstance(ls[0], DTensor):
        return _placed_norm(ls)
    shape = ls[0].shape[:lead]
    norms = [torch.sqrt(sum(torch.sum(torch.square(g[idx].float())) for g in ls))
             for idx in itertools.product(*map(range, shape))]
    return torch.stack(norms).reshape(shape)


def _placed_norm(ls: list[DTensor]) -> Tensor:
    """√Σ g² over DTensor leaves, as a plain scalar on every rank: each
    leaf's squares summed over its local shard, the shards' sums added over
    the mesh dims that shard it, and a leaf replicated over a dim counted
    once (only its coordinate-0 copy is added). One all-reduce per mesh dim
    that shards any leaf; the sum over leaves then runs in leaf order."""
    mesh = ls[0].device_mesh
    sums = torch.stack([torch.sum(torch.square(g.to_local().float())) for g in ls])
    for dim in range(mesh.ndim):
        sharded = [g.placements[dim].is_shard() for g in ls]
        if not any(sharded):
            continue
        if mesh.get_local_rank(dim):
            sums = sums * torch.tensor(sharded, dtype=sums.dtype, device=sums.device)
        place = [Replicate()] * mesh.ndim
        place[dim] = Partial()
        sums = redistribute(DTensor.from_local(sums, mesh, place, run_check=False),
                            [Replicate()] * mesh.ndim).to_local()
    return torch.sqrt(sum(sums.unbind()))


def _per_leaf(s: Tensor, like: Tensor) -> Tensor:
    """A per-rank value ``s`` shaped to broadcast over a leaf ``like``."""
    return s.reshape(s.shape + (1,) * (like.dim() - s.dim()))


def adamw_update(params: Tree, grads: Tree, state: dict,
                 cfg: AdamWConfig) -> tuple[Tree, dict]:
    placed = isinstance(state["step"], DTensor)
    step = (state["step"].to_local() if placed else state["step"]) + 1
    lead = step.dim()
    gn = global_norm(grads, lead)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
    lr = lr_at(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.float())
    b2c = 1 - torch.pow(cfg.b2, step.float())

    def upd(p, g, m, v):
        if placed:  # p and g cut to the moments' shard: a local slice, no wire
            at = m.placements
            p, g, m, v = (redistribute(t, at).to_local() for t in (p, g, m, v))
        g = g.float() * _per_leaf(clip, g)
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m / _per_leaf(b1c, m)
        vhat = v / _per_leaf(b2c, v)
        p32 = p.float()
        p32 = p32 - _per_leaf(lr, p32) * (mhat / (torch.sqrt(vhat) + cfg.eps)
                                          + cfg.weight_decay * p32)
        return p32.to(p.dtype), m, v

    new = []
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        n = upd(p, g, m, v)
        if placed:  # the param gathered back to its own placement
            n = [DTensor.from_local(t, m.device_mesh, m.placements, run_check=False)
                 for t in n]
            n[0] = redistribute(n[0], p.placements)
        new.append(n)
    if placed:
        s = state["step"]
        step = DTensor.from_local(step, s.device_mesh, s.placements, run_check=False)
    return (unflatten(params, [n[0] for n in new]),
            {"m": unflatten(params, [n[1] for n in new]),
             "v": unflatten(params, [n[2] for n in new]),
             "step": step})
