"""Mixture-of-Experts with capacity-based dispatch (GShard-style, scatter).

The twin of ``repro.models.moe``. Dispatch is computed per token group (one
group per batch row): each (token, choice) gets a slot in its expert's
``cap``-row buffer, ranked by token order; assignments past an expert's
capacity go to one trash row that every combine reads as 0 (standard
GShard drops; ``capacity_factor`` sets the slack).

The expert products are einsums over a leading expert axis, as the JAX
package's are (XLA einsums there, outside any Pallas kernel).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init

Tensor = torch.Tensor


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
    """
    b, s, d = x.shape
    dt, dev = x.dtype, x.device
    e = p["wi"].shape[0]
    # ---- routing (fp32) ----
    logits = x.float() @ p["router"]  # [B,S,E]
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k_lowest_index_first(probs, top_k)  # [B,S,k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # load-balance aux loss
    me = probs.mean(dim=(0, 1))  # [E] mean router prob
    ce = torch.zeros(e, dtype=torch.float32, device=dev).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), dtype=torch.float32, device=dev))
    ce = ce / (b * s * top_k)
    aux = e * torch.sum(me * ce)

    cap = max(1, int(s * top_k / e * capacity_factor))
    # ---- position of each (token, choice) within its expert, per group ----
    # A stable argsort keeps token order within each expert; an entry's rank
    # is its sorted position less the first sorted position of its expert.
    t = s * top_k
    assign = idx.reshape(b, t)  # [B, T]
    sort_idx = torch.argsort(assign, dim=1, stable=True)
    sorted_assign = torch.gather(assign, 1, sort_idx).contiguous()
    first = torch.searchsorted(sorted_assign, sorted_assign, side="left")
    pos_sorted = torch.arange(t, device=dev)[None] - first
    pos_in_e = torch.zeros_like(assign).scatter_(1, sort_idx, pos_sorted)
    keep = pos_in_e < cap
    slot = torch.where(keep, assign * cap + pos_in_e,
                       torch.full_like(assign, e * cap))  # overflow → trash row

    # ---- dispatch: [B, E*cap (+1 trash), D], one index_add_ over all groups ----
    rows = e * cap + 1
    src = x.repeat_interleave(top_k, dim=1)  # [B, S*k, D]: token s for choices s*k..
    flat = (slot + torch.arange(b, device=dev)[:, None] * rows).reshape(-1)
    buf = torch.zeros(b * rows, d, dtype=dt, device=dev).index_add_(
        0, flat, src.reshape(b * t, d))
    buf = buf.reshape(b, rows, d)[:, :e * cap].reshape(b, e, cap, d)

    # ---- expert computation ----
    h = F.silu(torch.einsum("becd,edf->becf", buf, p["wg"].to(dt))) * \
        torch.einsum("becd,edf->becf", buf, p["wi"].to(dt))
    y = torch.einsum("becf,efd->becd", h, p["wo"].to(dt))  # [B,E,cap,D]

    # ---- combine ----
    yt = torch.cat([y.reshape(b, e * cap, d),
                    torch.zeros(b, 1, d, dtype=dt, device=dev)], dim=1)  # trash row reads 0
    gathered = torch.gather(yt, 1, slot[..., None].expand(b, t, d))  # [B,S*k,D]
    gathered = gathered * (gates.reshape(b, t, 1) * keep[..., None]).to(dt)
    out = gathered.reshape(b, s, top_k, d).sum(dim=2)

    if "shared" in p:
        sp = p["shared"]
        hs = F.silu(x @ sp["wg"].to(dt)) * (x @ sp["wi"].to(dt))
        out = out + hs @ sp["wo"].to(dt)
    return out, aux
