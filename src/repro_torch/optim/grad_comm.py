"""Gradient communication: bucketing → LUMORPH collective dispatch →
optional int8 compression with error feedback, over virtual ranks.

The twin of ``repro.optim.grad_comm``. There, every function runs inside
``shard_map`` and sees one device's gradients. Here every tensor carries
the ``p`` data-parallel ranks on its leading axis and the collectives are
the virtual-rank executor's (:mod:`repro_torch.core.collectives`):

  * gradients are flattened, per rank, into one flat vector (leaves in
    JAX's flatten order) and cut into ~25 MB buckets, tensor boundaries
    ignored (``make_buckets`` counts 4 B per element whatever the wire
    dtype, as the reference does);
  * each bucket is ALLREDUCEd by ``ring`` / ``lumorph2`` / ``lumorph4`` /
    ``tree`` / ``auto``: ``auto`` prices each bucket with the α–β model
    (``core.cost_model.select_algorithm``, at the bucket's wire bytes per
    rank) and runs the cheapest schedule;
  * optional int8 compression quantizes every shipped piece with
    per-256-block scales and dequantizes at the receiver, through the
    hand-written CUDA kernels on the card (``kernels.ops``). Blocks never
    span two ranks or two leaves: each rank's piece, and each rank's
    error-feedback leaf, is padded to 256 on its own.

As in the reference, compression always runs the LUMORPH-2 schedule in
fp32 whatever ``algo`` says (the bucket log still names ``algo``), and the
mean over ranks is taken after the fp32 cast.

Given a process ``group``, the same functions run across processes: the
leaves are this rank's own (no rank axis) and every bucket's collective
is the cross-process executor's (:mod:`repro_torch.core.collectives_dist`).
The bucketing, the error feedback and the bucket log are the same code,
the local leaves taken as a rank axis of width 1.

Under a model axis (``shards``), a rank's leaves are its model shards of
the global leaves. As under JAX's automatic model axis, where the
``shard_map`` body sees global leaves, the buckets cut the global flat
vector, the log holds their global bytes and ``auto`` prices those; each
rank then reduces, over its data group, only its own shard's elements of
each bucket.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.core import collectives, collectives_dist
from repro_torch.core.cost_model import LUMORPH_LINK, LinkModel, select_algorithm
from repro_torch.kernels import ops as kops
from repro_torch.tree import leaves, unflatten

Tensor = torch.Tensor
Tree = Any

DEFAULT_BUCKET_BYTES = 25 * 1024 * 1024  # 25 MB, torch-DDP-style default
QUANT_BLOCK = kops.QUANT_BLOCK


@dataclasses.dataclass(frozen=True)
class Bucket:
    start: int  # element offsets into the flat gradient vector
    end: int

    @property
    def n_elems(self) -> int:
        return self.end - self.start


def make_buckets(total_elems: int, bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                 bytes_per_elem: int = 4) -> list[Bucket]:
    """DDP-style flat bucketing: the whole gradient is one flat vector cut
    into ~bucket_bytes ranges, in leaf order."""
    target = max(1, bucket_bytes // bytes_per_elem)
    out = []
    off = 0
    while off < total_elems:
        end = min(off + target, total_elems)
        out.append(Bucket(off, end))
        off = end
    return out


# ---------------------------------------------------------------------------
# int8 compression
# ---------------------------------------------------------------------------

def quantize_int8(x: Tensor) -> tuple[Tensor, Tensor]:
    """Per-block symmetric int8 quantization of each row of ``x [..., m]``:
    → (q ``[..., m_pad]``, scales ``[..., m_pad/256]``), every row padded to
    a multiple of 256 on its own. One kernel launch covers all rows."""
    lead, m = x.shape[:-1], x.shape[-1]
    rows = x.float().reshape(-1, m)
    pad = (-m) % QUANT_BLOCK
    if pad:
        rows = torch.nn.functional.pad(rows, (0, pad))
    q, scales = kops.quantize_int8(rows.reshape(-1))
    return q.reshape(*lead, m + pad), scales.reshape(*lead, (m + pad) // QUANT_BLOCK)


def dequantize_int8(q: Tensor, scales: Tensor, n: int) -> Tensor:
    """Rows of :func:`quantize_int8`'s output → fp32 ``[..., n]``."""
    flat = kops.dequantize_int8(q.reshape(-1), scales.reshape(-1), q.numel())
    return flat.reshape(q.shape)[..., :n]


def _int8_encode(piece: Tensor) -> tuple[Tensor, Tensor]:
    """Per-hop payload transform: each rank's shipped chunks ``piece[r]``
    quantized to int8 with per-block fp32 scales (1/64 byte overhead)."""
    return quantize_int8(piece.reshape(piece.shape[0], -1))


def _int8_decode(payload: tuple[Tensor, Tensor], like: Tensor) -> Tensor:
    q, sc = payload
    return dequantize_int8(q, sc, like[0].numel()).reshape(like.shape)


def _int8_encode_local(piece: Tensor) -> tuple[Tensor, Tensor]:
    """:func:`_int8_encode` of one process's piece: one row of one rank."""
    return _int8_encode(piece[None])


def _int8_decode_local(payload: tuple[Tensor, Tensor], like: Tensor) -> Tensor:
    return _int8_decode(payload, like[None])[0]


@functools.lru_cache(maxsize=64)
def _compressed_program(p: int):
    return collectives.compile_schedule(
        collectives.schedule_for_execution("lumorph2", p), p,
        encode=_int8_encode, decode=_int8_decode)


@functools.lru_cache(maxsize=64)
def _compressed_program_dist(group: dist.ProcessGroup):
    return collectives_dist.compile_schedule(
        collectives.schedule_for_execution("lumorph2", dist.get_world_size(group)), group,
        encode=_int8_encode_local, decode=_int8_decode_local)


def compressed_all_reduce(x: Tensor, n_chunks: int = 1,
                          group: Optional[dist.ProcessGroup] = None) -> Tensor:
    """LUMORPH-2 recursive halving/doubling with int8 payloads, over the
    rank axis of ``x[p, ...]``, or with a process ``group`` over its ranks,
    ``x`` this rank's own: the same Schedule IR as the uncompressed
    collective, with the int8 encode/decode pair around every hop. Wire
    bytes ≈ n (int8) + n/64 (scales) against 4n in fp32. ``n_chunks > 1``
    runs the chunked, pipelined lowering (``overlapped_all_reduce``), every
    wave's hops quantizing their own slice."""
    p = x.shape[0] if group is None else dist.get_world_size(group)
    if p == 1:
        return x
    if p & (p - 1):
        raise ValueError("compressed allreduce requires a power-of-two rank count")
    x32 = x.float()
    if group is None and n_chunks > 1:
        out = collectives.overlapped_all_reduce(x32, "lumorph2", n_chunks=n_chunks,
                                                encode=_int8_encode, decode=_int8_decode)
    elif group is None:
        out = _compressed_program(p)(x32)
    elif n_chunks > 1:
        out = collectives_dist.overlapped_all_reduce(
            x32, "lumorph2", n_chunks=n_chunks, encode=_int8_encode_local,
            decode=_int8_decode_local, group=group)
    else:
        out = _compressed_program_dist(group)(x32)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# bucketed gradient all-reduce
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Shard:
    """Where a rank's leaf lies in the global leaf: the block of the local
    leaf's shape that starts at ``offset`` in a leaf of ``shape``."""

    shape: tuple[int, ...]
    offset: tuple[int, ...]


def _count_below(shard: Shard, local_shape: tuple[int, ...], x: int) -> int:
    """How many of the block's elements come before global flat (row-major)
    index ``x`` of the leaf."""
    if x >= math.prod(shard.shape):
        return math.prod(local_shape)
    digits = []
    for n in reversed(shard.shape):
        x, d = divmod(x, n)
        digits.append(d)
    digits.reverse()
    count = 0
    for k, d in enumerate(digits):
        lo, hi = shard.offset[k], shard.offset[k] + local_shape[k]
        count += (min(max(d, lo), hi) - lo) * math.prod(local_shape[k + 1:])
        if not lo <= d < hi:
            break
    return count


def _local_cuts(shards: list[Shard], local_shapes: list[tuple[int, ...]],
                bounds: list[int]) -> list[int]:
    """The positions in this rank's flat vector (its blocks, in leaf order)
    of the global flat positions ``bounds`` (ascending)."""
    out, leaf, g0, l0 = [], 0, 0, 0
    for x in bounds:
        while leaf < len(shards) and x >= g0 + math.prod(shards[leaf].shape):
            g0 += math.prod(shards[leaf].shape)
            l0 += math.prod(local_shapes[leaf])
            leaf += 1
        below = 0 if leaf == len(shards) else _count_below(shards[leaf], local_shapes[leaf],
                                                             x - g0)
        out.append(l0 + below)
    return out


def all_reduce_grads(grads: Tree, algo: str = "auto",
                     bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                     link: LinkModel = LUMORPH_LINK,
                     compress: bool = False,
                     error_feedback: Optional[Tree] = None,
                     wire_dtype: torch.dtype = torch.bfloat16,
                     overlap_chunks: int = 1,
                     group: Optional[dist.ProcessGroup] = None,
                     shards: Optional[list[Shard]] = None,
                     ) -> tuple[Tree, Optional[Tree], list[tuple[int, str]]]:
    """Mean-ALLREDUCE ``grads`` (leaves ``[p, ...]``) over the rank axis
    with LUMORPH collectives, bucket by bucket: the sum over ranks, divided
    by ``p`` after the fp32 cast. With a process ``group`` the leaves are
    this rank's own and ``p`` is the group's size.

    Returns (reduced_grads, new_error_feedback, bucket_log), where the log
    records (bytes per rank, algo) per bucket, as the reference's does.
    ``algo="auto"`` picks each bucket's schedule with
    ``select_algorithm(bytes, p, link)``. Payloads travel as ``wire_dtype``;
    with ``compress`` they travel as int8 and the flat vector is fp32
    (LUMORPH-2 whatever ``algo`` picks). ``overlap_chunks > 1`` lowers every
    bucket through the chunked wave pipeline (overlap mode; the log's algo
    gains ``+ovl<C>``); ``1`` keeps the monolithic path.

    ``shards`` (with a ``group``, one per leaf) says where each of this
    rank's leaves lies in its global leaf: the buckets then cut the global
    flat vector, and each one's collective moves this rank's elements of it.
    """
    orig = leaves(grads)
    if group is None:
        gl, p = orig, orig[0].shape[0]
    else:  # this rank's leaves, as a rank axis of width 1
        gl, p = [g[None] for g in orig], dist.get_world_size(group)
    lead = gl[0].shape[0]
    ef_new: Optional[list[Tensor]] = None
    if compress and error_feedback is not None:
        # EF-SGD: compensate with last step's residual, store the *local*
        # quantization residual (per rank, per leaf) for the next step
        ef = leaves(error_feedback)
        gl = [g.float() + e.reshape(g.shape) for g, e in zip(gl, ef)]
        ef_new = []
        for c, e in zip(gl, ef):
            rows = c.reshape(lead, -1)
            q, sc = quantize_int8(rows)
            ef_new.append((c - dequantize_int8(q, sc, rows.shape[1]).reshape(c.shape))
                          .reshape(e.shape))
    comm_dtype = torch.float32 if compress else wire_dtype
    flat = torch.cat([g.to(comm_dtype).reshape(lead, -1) for g in gl], dim=1)
    del gl  # the compensated copies; at full width each copy is GBs
    if shards is None:
        buckets = make_buckets(flat.shape[1], bucket_bytes)
        cuts = [b.start for b in buckets] + [flat.shape[1]]
    else:
        buckets = make_buckets(sum(math.prod(sh.shape) for sh in shards), bucket_bytes)
        cuts = _local_cuts(shards, [tuple(g.shape) for g in orig],
                           [b.start for b in buckets] + [buckets[-1].end])

    log: list[tuple[int, str]] = []
    # each bucket's sum goes into one fp32 vector as it comes: the flat vector itself
    # when it is fp32, so that a rank never holds its gradient more than twice
    reduced = flat if flat.dtype == torch.float32 else torch.empty(
        flat.shape, dtype=torch.float32, device=flat.device)
    for b, lo, hi in zip(buckets, cuts, cuts[1:]):
        piece = flat[:, lo:hi]
        n_bytes = b.n_elems * flat.element_size()
        chosen = select_algorithm(n_bytes, p, link) if algo == "auto" else algo
        log.append((n_bytes, chosen + ("+int8" if compress else "")
                    + (f"+ovl{overlap_chunks}" if overlap_chunks > 1 else "")))
        if hi == lo:  # none of this bucket is this rank's, nor its data group's
            continue
        if group is not None:
            part = _reduce_local(piece[0], chosen, compress, overlap_chunks, group)[None]
        elif compress:
            part = compressed_all_reduce(piece, n_chunks=overlap_chunks)
        elif overlap_chunks > 1:
            part = collectives.overlapped_all_reduce(piece, chosen, n_chunks=overlap_chunks)
        else:
            part = collectives.all_reduce(piece, chosen)
        reduced[:, lo:hi] = part
        del part
    del flat
    reduced.div_(p)  # in place: the same IEEE division as ``reduced / p``
    out, off = [], 0
    for g in orig:
        n = g.numel() // lead
        out.append(reduced[:, off:off + n].reshape(g.shape).to(g.dtype))
        off += n
    new_ef = unflatten(error_feedback, ef_new) if ef_new is not None else None
    return unflatten(grads, out), new_ef, log


def _reduce_local(piece: Tensor, algo: str, compress: bool, overlap_chunks: int,
                  group: dist.ProcessGroup) -> Tensor:
    """One bucket of this rank's flat gradient, reduced over ``group``."""
    if compress:
        return compressed_all_reduce(piece, n_chunks=overlap_chunks, group=group)
    if overlap_chunks > 1:
        return collectives_dist.overlapped_all_reduce(piece, algo, n_chunks=overlap_chunks,
                                                      group=group)
    return collectives_dist.all_reduce(piece, algo, group)
