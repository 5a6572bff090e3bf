"""The cross-process executor: Schedule-IR collectives over ``torch.distributed``.

The twin of ``repro.core.collectives`` across processes, beside the
virtual-rank executor (:mod:`repro_torch.core.collectives`). Each rank is
its own process holding its own buffer, as each JAX device does under
``shard_map``, and each :class:`~repro_torch.core.scheduler.Transfer`
becomes one ``torch.distributed.batch_isend_irecv``, the twin of one
``jax.lax.ppermute``. Rank ``r`` of the group plays
``schedule.participants[r]``: it ships its row ``t.send[r]`` of chunks to
its destination in ``t.perm`` and takes what its source ships into its row
``t.recv[r]``, adding it (``buf[recv] += got``, one addition per element,
as ``buf.at[recv].add`` makes) or overwriting. A rank outside ``perm``
posts nothing and keeps its buffer: the zeros ppermute would hand it are a
no-op. In fp32 the result is bit-identical to ``compile_schedule`` under
``shard_map`` and to the virtual-rank executor.

Transfers run one after another, in the schedule's order, as the JAX
program issues its ppermutes; a round's Transfers are not merged into one
call.

The wire is the group's backend, which the caller picks and nothing
switches: under ``nccl`` device tensors move as they are; under ``gloo``
a CUDA payload is copied to a host buffer before its send and what
arrives is copied back to the device (:class:`Wire`). On one card only
gloo can run several ranks, so times taken that way are those of a
host-staged wire, not of a link.

``encode``/``decode`` wrap every hop's payload on this rank:
``encode(piece [k, L])`` returns a tensor or a tuple of tensors (int8
values and fp32 scales), which move as several ops of the same batch;
``decode(payload, piece)`` returns a tensor shaped like ``piece``.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.core.collectives import (Decode, Encode, _chunked_schedule, _flatten_pad,
                                          _pipeline, schedule_for_execution)
from repro_torch.core.scheduler import Schedule

__all__ = ["Wire", "compile_schedule", "all_reduce", "ALGOS", "overlapped_all_reduce",
           "make_overlapped_all_reduce"]

Tensor = torch.Tensor
ALGOS = ("ring", "lumorph2", "lumorph4", "tree", "psum")


def _group(group: Optional[dist.ProcessGroup]) -> dist.ProcessGroup:
    return dist.group.WORLD if group is None else group


class Wire:
    """How tensors cross between the ranks of ``group``: as they are under
    nccl; under gloo, CUDA tensors through host buffers."""

    def __init__(self, group: Optional[dist.ProcessGroup] = None):
        self.group = _group(group)
        self.staged = dist.get_backend(self.group) == "gloo"

    def _out(self, t: Tensor) -> Tensor:
        return t.cpu() if self.staged and t.is_cuda else t.contiguous()

    def _in(self, like: Tensor) -> Tensor:
        dev = "cpu" if self.staged else like.device
        return torch.empty(like.shape, dtype=like.dtype, device=dev)

    def exchange(self, to: Optional[int], sends: tuple[Tensor, ...], frm: Optional[int],
                 likes: tuple[Tensor, ...]) -> tuple[Tensor, ...]:
        """One batch: ``sends`` to group rank ``to`` and tensors shaped like
        ``likes`` from group rank ``frm`` (either may be ``None``). The i-th
        tensor of each side carries tag i. Returns what arrived, on the
        device of ``likes``."""
        ops, outs, ins = [], [], []
        if to is not None:
            peer = dist.get_global_rank(self.group, to)
            for tag, t in enumerate(sends):
                outs.append(self._out(t))
                ops.append(dist.P2POp(dist.isend, outs[-1], peer, self.group, tag))
        if frm is not None:
            peer = dist.get_global_rank(self.group, frm)
            for tag, like in enumerate(likes):
                ins.append(self._in(like))
                ops.append(dist.P2POp(dist.irecv, ins[-1], peer, self.group, tag))
        if not ops:  # an empty op list is not a valid batch
            return ()
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return tuple(b.to(like.device) for b, like in zip(ins, likes))

    def all_reduce(self, x: Tensor, op=dist.ReduceOp.SUM) -> Tensor:
        """``dist.all_reduce`` of a copy of ``x`` (a sum unless ``op`` says
        otherwise): the library reduction."""
        y = self._out(x)
        if y.data_ptr() == x.data_ptr():
            y = y.clone()
        dist.all_reduce(y, op=op, group=self.group)
        return y.to(x.device)

    def broadcast(self, x: Tensor) -> Tensor:
        """Group rank 0's ``x``, on every rank, on ``x``'s device."""
        y = self._out(x)
        if y.data_ptr() == x.data_ptr():
            y = y.clone()
        dist.broadcast(y, dist.get_global_rank(self.group, 0), group=self.group)
        return y.to(x.device)

    def all_gather(self, x: Tensor) -> list[Tensor]:
        """Every rank's ``x``, in group-rank order, on ``x``'s device."""
        y = self._out(x)
        out = [torch.empty_like(y) for _ in range(dist.get_world_size(self.group))]
        dist.all_gather(out, y, group=self.group)
        return [t.to(x.device) for t in out]


class _Plan:
    """One Transfer as rank ``rank`` sees it: its chunk rows, and whom it
    ships to and takes from (``None``: nobody)."""

    def __init__(self, t, rank: int, device: torch.device):
        self.reduce = t.reduce
        self.send = torch.as_tensor(t.send[rank], dtype=torch.int64, device=device)
        self.recv = torch.as_tensor(t.recv[rank], dtype=torch.int64, device=device)
        self.to = next((d for s, d in t.perm if s == rank), None)
        self.frm = next((s for s, d in t.perm if d == rank), None)
        if t.reduce and len(set(t.recv[rank].tolist())) != len(t.recv[rank]):
            raise ValueError("a reduce transfer's recv row names a chunk twice; "
                             "index_add_ would then sum in an unspecified order")


def compile_schedule(schedule: Schedule, group: Optional[dist.ProcessGroup] = None,
                     encode: Optional[Encode] = None,
                     decode: Optional[Decode] = None) -> Callable[[Tensor], Tensor]:
    """Lower a :class:`Schedule` to an ALLREDUCE over the ranks of ``group``.

    The returned ``fn(x_local) -> x_local_reduced`` is called by every rank
    of the group with its own buffer. A participant count that differs
    from the group's size raises. Building the program is collective: it
    ends with a barrier, so that the group's first P2P call finds every
    rank there (NCCL's condition).
    """
    group = _group(group)
    schedule.materialize()
    p = len(schedule.participants)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if p != world:
        raise ValueError(f"schedule has {p} participants but the group has {world} ranks "
                         "— a mismatched perm would silently drop ranks")
    if rank < 0:
        raise ValueError("this process is not a member of the group")
    rounds = schedule.rounds
    n_chunks = schedule.n_chunks
    wire = Wire(group)
    coded = encode is not None or decode is not None
    plans: dict[torch.device, list[_Plan]] = {}
    if p > 1 and rounds:
        dist.barrier(group=group)

    def fn(x: Tensor) -> Tensor:
        if p == 1 or not rounds:
            return x
        if x.device not in plans:
            plans[x.device] = [_Plan(t, rank, x.device) for rnd in rounds
                               for t in rnd.transfers]
        flat, n = _flatten_pad(x[None], n_chunks)  # a copy: x stays untouched
        buf = flat.view(n_chunks, -1)
        for t in plans[x.device]:
            if t.to is None and t.frm is None:
                continue
            tupled = False
            if t.to is None and not coded:  # receives only: a piece shaped as its row
                sends, likes = (), (buf[:1].expand(len(t.recv), -1),)
            else:
                piece = buf[t.send]  # [k, L]
                payload = encode(piece) if encode is not None else piece
                tupled = isinstance(payload, tuple)
                sends = likes = payload if tupled else (payload,)
            got = wire.exchange(t.to, sends, t.frm, likes)
            if t.frm is None:
                continue
            got = got if tupled else got[0]
            if decode is not None:
                got = decode(got, piece)
            if t.reduce:
                buf.index_add_(0, t.recv, got)
            else:
                buf[t.recv] = got
        return flat[0, :n].reshape(x.shape)

    return fn


@functools.lru_cache(maxsize=256)
def _compiled(algo: str, group: dist.ProcessGroup) -> Callable[[Tensor], Tensor]:
    return compile_schedule(schedule_for_execution(algo, dist.get_world_size(group)), group)


def all_reduce(x: Tensor, algo: str = "lumorph2",
               group: Optional[dist.ProcessGroup] = None) -> Tensor:
    """ALLREDUCE this rank's ``x`` over ``group`` with the named algorithm.

    The dispatch rule of :func:`repro_torch.core.collectives.all_reduce`:
    ``lumorph2`` runs ``ring`` off powers of two. ``"psum"`` is
    ``dist.all_reduce``, the library reduction.
    """
    group = _group(group)
    p = dist.get_world_size(group)
    if algo in ("lumorph2",) and p & (p - 1):
        algo = "ring"
    if algo not in ALGOS:
        raise ValueError(f"unknown collective {algo!r}; have {sorted(ALGOS)}")
    if algo == "psum":
        return Wire(group).all_reduce(x)
    return _compiled(algo, group)(x)


#: one program per (wave schedule, group, encode, decode), shared by every
#: chunk and every call
_wave_program = functools.lru_cache(maxsize=256)(compile_schedule)


def overlapped_all_reduce(x: Tensor, algo: str = "lumorph2", n_chunks: int = 1,
                          compute: Optional[Callable[[Tensor], Tensor]] = None,
                          encode: Optional[Encode] = None,
                          decode: Optional[Decode] = None,
                          group: Optional[dist.ProcessGroup] = None) -> Tensor:
    """Chunked, pipelined ALLREDUCE of this rank's ``x`` over ``group``.

    ``x`` is flattened, zero-padded to a multiple of ``n_chunks`` and cut
    into ``C`` slices; each runs the collective as its own reduce-scatter
    and all-gather waves, and ``compute`` maps a reduced slice to its
    output of the same shape, chunk ``c−1``'s issued after chunk ``c``'s
    waves, in the JAX package's order. With ``n_chunks=1`` and no
    ``compute`` the result is bit-identical to :func:`all_reduce`.
    ``encode``/``decode`` wrap every hop of every wave.
    """
    group = _group(group)
    chunked = _chunked_schedule(algo, dist.get_world_size(group), n_chunks, None)
    C = chunked.n_chunks
    flat, n = _flatten_pad(x[None], C)
    size = flat.shape[1] // C
    slices = [flat[0, c * size:(c + 1) * size] for c in range(C)]
    programs = [_wave_program(w.schedule, group, encode, decode) for w in chunked.waves]
    out = _pipeline(chunked, slices, programs, compute)
    out = torch.cat(out) if C > 1 else out[0]
    return out[:n].reshape(x.shape)


def make_overlapped_all_reduce(algo: str = "lumorph2", n_chunks: int = 1,
                               compute: Optional[Callable[[Tensor], Tensor]] = None,
                               encode: Optional[Encode] = None,
                               decode: Optional[Decode] = None,
                               group: Optional[dist.ProcessGroup] = None,
                               ) -> Callable[[Tensor], Tensor]:
    """:func:`overlapped_all_reduce` bound to its arguments (the twin of the
    JAX package's jitted wrapper, called by every rank with its own ``x``)."""
    return functools.partial(overlapped_all_reduce, algo=algo, n_chunks=n_chunks,
                             compute=compute, encode=encode, decode=decode, group=group)
