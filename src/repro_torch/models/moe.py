"""Mixture-of-Experts with capacity-based dispatch (GShard-style, scatter).

The twin of ``repro.models.moe``. Dispatch is computed per token group (one
group per batch row): each (token, choice) gets a slot in its expert's
``cap``-row buffer, ranked by token order; assignments past an expert's
capacity go to one trash row that every combine reads as 0 (standard
GShard drops; ``capacity_factor`` sets the slack).

The expert products are einsums over a leading expert axis, as the JAX
package's are (XLA einsums there, outside any Pallas kernel). On the model
axis the experts split over the ranks (expert parallelism, the sharding
policy's ``ep`` rule) and the tokens stay whole (:func:`apply_moe`).
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.core import collectives_dist
from repro_torch.models.layers import dense_init, reduced, whole_grad
from repro_torch.sharding.policy import local_offsets

Tensor = torch.Tensor

#: The process group whose ranks' rows the balance loss counts together
#: (:func:`balance_over`); ``None``: this rank's rows alone. A module global and not a
#: context variable: autograd recomputes a checkpointed block on its own thread for
#: CUDA tensors, and that recompute must count as the forward did.
_balance_group = None


@contextlib.contextmanager
def balance_over(group):
    """Within the block, :func:`apply_moe`'s balance loss counts every
    expert's assignments over the rows of all ranks of ``group`` (a
    ``torch.distributed`` group of equal batches, or ``None``), as the
    reference's ``xla`` train step, one program over the global batch,
    counts them. The mean router probabilities stay this rank's: the mean
    over the ranks of their losses is then the global batch's balance loss,
    and so is its gradient (the counts carry none)."""
    global _balance_group
    before, _balance_group = _balance_group, group
    try:
        yield
    finally:
        _balance_group = before


def init_moe(gen: torch.Generator, d: int, d_ff: int, n_experts: int,
             n_shared: int = 0, shared_d_ff: int | None = None,
             dtype=torch.float32, lead: tuple[int, ...] = ()) -> dict:
    """Router (always fp32), stacked experts and optional shared experts.

    As in the JAX package, an expert leaf's fan-in is its first axis of
    ``shape`` (``n_experts``), which sets its init scale."""
    p = {
        "router": dense_init(gen, (d, n_experts), scale=0.1, dtype=torch.float32, lead=lead),
        "wi": dense_init(gen, (n_experts, d, d_ff), dtype=dtype, lead=lead),
        "wg": dense_init(gen, (n_experts, d, d_ff), dtype=dtype, lead=lead),
        "wo": dense_init(gen, (n_experts, d_ff, d), dtype=dtype, lead=lead),
    }
    if n_shared:
        sdf = shared_d_ff or n_shared * d_ff
        p["shared"] = {
            "wi": dense_init(gen, (d, sdf), dtype=dtype, lead=lead),
            "wg": dense_init(gen, (d, sdf), dtype=dtype, lead=lead),
            "wo": dense_init(gen, (sdf, d), dtype=dtype, lead=lead),
        }
    return p


def top_k_lowest_index_first(probs: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, in descending
    order, equal values in ascending index order (``torch.topk`` promises
    no order among ties). A stable descending sort keeps equal values in
    index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def apply_moe(p: dict, x: Tensor, top_k: int,
              capacity_factor: float = 1.25) -> tuple[Tensor, Tensor]:
    """x: [B, S, D] → (y, aux_loss). Groups = batch rows.

    aux_loss is the standard load-balancing loss (Switch §2.2): E·Σ f_e·P_e.

    With DTensor params on the model axis (``x`` whole over it), expert
    parallel as GSPMD runs the reference with tokens replicated and experts
    split: every rank routes alike on its local copy of the whole ``x`` (the
    sort, ``searchsorted``, ``scatter_`` and ``index_add_`` of the ranking
    never see a DTensor), then runs its own experts on the slots they own
    inside ``local_map`` (:func:`_experts`). Its combine is a partial sum
    over the ranks that split the experts, and so is the shared experts'
    row-parallel output: the two are added and reduced in one all-reduce.
    Replicated experts (``E % tp != 0``) give a whole routed part, to which
    only the reduced shared part is added.
    """
    b, s, d = x.shape
    dev = x.device
    e = p["wi"].shape[0]
    placed = isinstance(p["wi"], DTensor)
    x = whole_grad(x)
    # ---- routing (fp32) ----
    logits = x.float() @ p["router"]  # [B,S,E]
    probs = torch.softmax(logits, dim=-1)
    ep = [i for i, pl in enumerate(p["wi"].placements) if pl.is_shard(0)] if placed else []
    split = [Partial() if i in ep else Replicate() for i in range(x.device_mesh.ndim)] \
        if placed else None
    # the gates on the local copy; under a split combine only a slot's owner gives them
    # a gradient, so theirs is a partial sum
    local = probs.to_local(grad_placements=split) if placed else probs
    gates, idx = top_k_lowest_index_first(local, top_k)  # [B,S,k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # load-balance aux loss
    me = probs.mean(dim=(0, 1))  # [E] mean router prob
    ce = torch.zeros(e, dtype=torch.float32, device=dev).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), dtype=torch.float32, device=dev))
    n, group = b * s * top_k, _balance_group
    if group is not None:
        ce = collectives_dist.Wire(group).all_reduce(ce)
        n *= dist.get_world_size(group)
    ce = ce / n
    if placed:
        ce = DTensor.from_local(ce, x.device_mesh, [Replicate()] * x.device_mesh.ndim,
                                run_check=False)
    aux = e * torch.sum(me * ce)

    cap = max(1, int(s * top_k / e * capacity_factor))
    slot, keep = _slots(idx, e, cap)

    def routed(x, gates, wi, wg, wo, first=0):
        return _experts(x, gates, slot, keep, wi, wg, wo, first, cap, top_k)

    if not placed:
        out = routed(x, gates, p["wi"], p["wg"], p["wo"])
    else:
        if any(not pl.is_replicate() for i, pl in enumerate(p["wi"].placements) if i not in ep):
            raise ValueError(f"the experts are placed {p['wi'].placements}: expert "
                             "parallelism takes them split on their expert dim or whole")
        first = local_offsets(p["wi"])[0]
        w = tuple(p[k] for k in ("wi", "wg", "wo"))
        out = local_map(functools.partial(routed, first=first), out_placements=split,
                        in_placements=(x.placements, None, *(t.placements for t in w)),
                        in_grad_placements=(split, None, *(t.placements for t in w)))(
                            x, gates, *w)
    if "shared" in p:
        sp, dt = p["shared"], x.dtype
        hs = F.silu(x @ sp["wg"].to(dt)) * (x @ sp["wi"].to(dt))
        shared = hs @ sp["wo"].to(dt)
        # one all-reduce for both partial parts; a whole routed part takes the reduced one
        out = reduced(out + shared) if ep else out + reduced(shared)
    else:
        out = reduced(out)
    return out, aux


def _slots(idx: Tensor, e: int, cap: int) -> tuple[Tensor, Tensor]:
    """Each (token, choice)'s row ``[B, S·k]`` in the ``e·cap``-row buffer, the
    trash row ``e·cap`` past its expert's capacity, and whether it was kept.

    A stable argsort keeps token order within each expert; an entry's rank
    is its sorted position less the first sorted position of its expert."""
    b = idx.shape[0]
    t = idx[0].numel()
    assign = idx.reshape(b, t)  # [B, T]
    sort_idx = torch.argsort(assign, dim=1, stable=True)
    sorted_assign = torch.gather(assign, 1, sort_idx).contiguous()
    first = torch.searchsorted(sorted_assign, sorted_assign, side="left")
    pos_sorted = torch.arange(t, device=idx.device)[None] - first
    pos_in_e = torch.zeros_like(assign).scatter_(1, sort_idx, pos_sorted)
    keep = pos_in_e < cap
    slot = torch.where(keep, assign * cap + pos_in_e,
                       torch.full_like(assign, e * cap))  # overflow → trash row
    return slot, keep


def _experts(x: Tensor, gates: Tensor, slot: Tensor, keep: Tensor, wi: Tensor, wg: Tensor,
             wo: Tensor, first: int, cap: int, top_k: int) -> Tensor:
    """The experts ``first .. first + E_l`` (their weights ``wi``/``wg``/``wo``
    [E_l, …]) on the kept (token, choice) slots they own, combined with
    their gates: x [B,S,D] → [B,S,D], on plain tensors. Every other slot
    goes to a trash row that the combine reads as 0, so with all experts
    (``first`` 0) this is the whole routed output, and with a rank's own it
    is that rank's part of the sum."""
    b, s, d = x.shape
    dt, dev = x.dtype, x.device
    el = wi.shape[0]
    t = s * top_k
    # ---- dispatch: [B, E_l*cap (+1 trash), D], one index_add_ over all groups ----
    rows = el * cap + 1
    at = slot - first * cap
    mine = keep & (at >= 0) & (at < el * cap)
    at = torch.where(mine, at, torch.full_like(at, el * cap))
    src = x.repeat_interleave(top_k, dim=1)  # [B, S*k, D]: token s for choices s*k..
    flat = (at + torch.arange(b, device=dev)[:, None] * rows).reshape(-1)
    buf = torch.zeros(b * rows, d, dtype=dt, device=dev).index_add_(
        0, flat, src.reshape(b * t, d))
    buf = buf.reshape(b, rows, d)[:, :el * cap].reshape(b, el, cap, d)

    # ---- expert computation ----
    h = F.silu(torch.einsum("becd,edf->becf", buf, wg.to(dt))) * \
        torch.einsum("becd,edf->becf", buf, wi.to(dt))
    y = torch.einsum("becf,efd->becd", h, wo.to(dt))  # [B,E_l,cap,D]

    # ---- combine ----
    yt = torch.cat([y.reshape(b, el * cap, d),
                    torch.zeros(b, 1, d, dtype=dt, device=dev)], dim=1)  # trash row reads 0
    gathered = torch.gather(yt, 1, at[..., None].expand(b, t, d))  # [B,S*k,D]
    gathered = gathered * (gates.reshape(b, t, 1) * mine[..., None]).to(dt)
    return gathered.reshape(b, s, top_k, d).sum(dim=2)
