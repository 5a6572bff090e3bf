"""The virtual-rank executor: Schedule-IR collectives on one device.

The twin of ``repro.core.collectives``. There, every rank of a mesh axis
is a device and each :class:`~repro_torch.core.scheduler.Transfer` is one
``jax.lax.ppermute`` inside ``shard_map``. Here the ``p`` ranks are a
leading axis of one tensor, ``x[p, ...]``, on one device: the twin of the
JAX package's fake CPU mesh, and the only multi-rank form one H100 can
run. Each Transfer becomes one gather of every rank's ``send`` row, one
move along ``perm`` (``out[dst] = in[src]``, zeros elsewhere, as ppermute
delivers), and either one ``index_add_`` at every rank's ``recv`` row or
an overwrite on the destinations only.

In fp32 the result is bit-identical to ``compile_schedule`` under
``shard_map``: every chunk id appears at most once in a ``recv`` row, so
each element takes exactly the one addition ``buf.at[recv].add(got)``
makes, and non-destinations add the zeros ppermute hands them.

``encode``/``decode`` wrap every hop's payload, here over all ranks at
once: ``encode(piece [p, k, L])`` returns a tuple of tensors with the
rank axis first, which move together; ``decode(payload, piece)`` returns
a tensor shaped like ``piece``.

:func:`overlapped_all_reduce` is overlap mode: the buffer is cut into
``C`` slices, each runs its own reduce-scatter and all-gather waves
(``scheduler.chunk_schedule``), and a ``compute`` consumer of each reduced
slice is issued for chunk ``c−1`` behind chunk ``c``'s waves, in the JAX
package's order. Everything is issued on one stream, so on the card the
chunks' communication and compute run one after another; a side stream
for the waves is later work.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional

import torch

from repro_torch.core.scheduler import (ChunkedSchedule, Schedule, build_schedule,
                                        chunk_schedule)

__all__ = ["compile_schedule", "schedule_for_execution", "all_reduce", "ALGOS",
           "overlapped_all_reduce", "make_overlapped_all_reduce"]

Tensor = torch.Tensor
#: encode(piece [p, k, L]) -> payload (a tensor or tuple of tensors, rank axis first)
Encode = Callable[[Tensor], Any]
#: decode(payload, like) -> tensor shaped/typed like ``like``
Decode = Callable[[Any, Tensor], Tensor]


def _flatten_pad(x: Tensor, multiple: int) -> tuple[Tensor, int]:
    """``x[p, ...]`` → (a new ``[p, n_pad]`` tensor, n): each rank's row is
    flat and zero-padded on its own to a multiple of ``multiple``."""
    flat = x.reshape(x.shape[0], -1)
    n = flat.shape[1]
    pad = (-n) % multiple
    return (torch.nn.functional.pad(flat, (0, pad)) if pad else flat.clone()), n


class _Plan:
    """One Transfer's tables as index tensors on one device."""

    def __init__(self, t, p: int, n_chunks: int, device: torch.device):
        as_t = functools.partial(torch.as_tensor, dtype=torch.int64, device=device)
        src, dst = zip(*t.perm) if t.perm else ((), ())
        self.reduce = t.reduce
        self.rank = as_t(range(p))[:, None]
        self.send = as_t(t.send)  # [p, k]
        self.src, self.dst = as_t(src), as_t(dst)
        # reduce: flat row ids (rank·n_chunks + chunk) of one index_add_ over all ranks
        self.recv_flat = (self.rank * n_chunks + as_t(t.recv)).reshape(-1)
        # overwrite: the destinations' recv rows only
        self.dst_recv = as_t(t.recv)[self.dst]
        if t.reduce and any(len(set(row)) != len(row) for row in t.recv.tolist()):
            raise ValueError("a reduce transfer's recv row names a chunk twice; "
                             "index_add_ would then sum in an unspecified order")

    def move(self, a: Tensor) -> Tensor:
        """ppermute along ``perm``: destinations get their source's rows, every
        other rank zeros."""
        out = torch.zeros_like(a)
        out[self.dst] = a[self.src]
        return out


def compile_schedule(schedule: Schedule, p: int, encode: Optional[Encode] = None,
                     decode: Optional[Decode] = None) -> Callable[[Tensor], Tensor]:
    """Lower a :class:`Schedule` to an ALLREDUCE over the leading rank axis.

    The returned ``fn(x[p, ...]) -> [p, ...]`` takes rank ``i``'s buffer in
    ``x[i]``, which plays ``schedule.participants[i]``. A participant count
    that differs from ``p`` or from ``x``'s rank axis raises.
    """
    schedule.materialize()
    n_part = len(schedule.participants)
    if n_part != p:
        raise ValueError(f"schedule has {n_part} participants but the rank axis is "
                         f"{p}-wide — a mismatched perm would silently drop ranks")
    rounds = schedule.rounds
    n_chunks = schedule.n_chunks
    plans: dict[torch.device, list[list[_Plan]]] = {}

    def fn(x: Tensor) -> Tensor:
        if x.shape[0] != p:
            raise ValueError(f"schedule has {p} participants but x has {x.shape[0]} "
                             "ranks on its leading axis")
        if p == 1 or not rounds:
            return x
        if x.device not in plans:
            plans[x.device] = [[_Plan(t, p, n_chunks, x.device) for t in rnd.transfers]
                               for rnd in rounds]
        flat, n = _flatten_pad(x, n_chunks)
        buf = flat.reshape(p, n_chunks, -1)  # a copy: x stays untouched
        rows = buf.view(p * n_chunks, -1)
        for rnd in plans[x.device]:
            for t in rnd:
                piece = buf[t.rank, t.send]  # [p, k, L]
                if encode is None:
                    got = t.move(piece)
                else:
                    payload = encode(piece)
                    got = (tuple(map(t.move, payload)) if isinstance(payload, tuple)
                           else t.move(payload))
                if decode is not None:
                    got = decode(got, piece)
                if t.reduce:
                    # non-destinations receive zeros: adding them is a no-op
                    rows.index_add_(0, t.recv_flat, got.reshape(-1, rows.shape[1]))
                else:
                    # overwrite on actual destinations only; everyone else keeps
                    # the chunks the zeros would have clobbered
                    buf[t.dst[:, None], t.dst_recv] = got[t.dst]
        return buf.reshape(p, -1)[:, :n].reshape(x.shape)

    return fn


@functools.lru_cache(maxsize=256)
def schedule_for_execution(algo: str, p: int,
                           n_chunks: int = 1) -> "Schedule | ChunkedSchedule":
    """The canonical rank-space schedule for executing ``algo`` over ``p``
    ranks (participants 0..p−1; byte metadata irrelevant to execution).

    ``n_chunks > 1`` returns the chunked (wave) lowering of the cached
    monolithic program. The LRU is keyed on all three arguments, so a
    chunked entry never aliases the monolithic one.
    """
    if n_chunks == 1:
        return build_schedule(algo, tuple(range(p)), 0.0)
    return chunk_schedule(schedule_for_execution(algo, p), n_chunks)


@functools.lru_cache(maxsize=256)
def _compiled(algo: str, p: int) -> Callable[[Tensor], Tensor]:
    return compile_schedule(schedule_for_execution(algo, p), p)


def _psum(x: Tensor) -> Tensor:
    return x.sum(dim=0, keepdim=True).expand_as(x).contiguous()


ALGOS: dict[str, Callable[[Tensor], Tensor]] = {
    "ring": lambda x: _compiled("ring", x.shape[0])(x),
    "lumorph2": lambda x: _compiled("lumorph2", x.shape[0])(x),
    "lumorph4": lambda x: _compiled("lumorph4", x.shape[0])(x),
    "tree": lambda x: _compiled("tree", x.shape[0])(x),
    "psum": _psum,
}


def all_reduce(x: Tensor, algo: str = "lumorph2") -> Tensor:
    """ALLREDUCE ``x[p, ...]`` over its rank axis with the named algorithm.

    Paper §3 dispatch rule: power-of-two allocations use recursive
    doubling/halving (or quartering); anything else uses Ring.
    """
    p = x.shape[0]
    if algo in ("lumorph2",) and p & (p - 1):
        algo = "ring"
    try:
        fn = ALGOS[algo]
    except KeyError:
        raise ValueError(f"unknown collective {algo!r}; have {sorted(ALGOS)}")
    return fn(x)


#: one compiled program per (wave schedule, p, encode, decode): the waves of
#: every chunk, and every call, share their index tables on the device
_wave_program = functools.lru_cache(maxsize=256)(compile_schedule)


def overlapped_all_reduce(x: Tensor, algo: str = "lumorph2", n_chunks: int = 1,
                          compute: Optional[Callable[[Tensor], Tensor]] = None,
                          encode: Optional[Encode] = None,
                          decode: Optional[Decode] = None,
                          schedule: "Optional[Schedule | ChunkedSchedule]" = None,
                          ) -> Tensor:
    """Chunked, pipelined ALLREDUCE of ``x[p, ...]`` over its rank axis.

    Each rank's row is flattened and zero-padded on its own to a multiple of
    ``n_chunks`` and cut into ``C`` slices ``[p, size]``; each slice runs the
    collective as its own reduce-scatter and all-gather waves. ``compute``
    maps a reduced slice ``[p, size]`` (rank axis first) to its output of
    the same shape; chunk ``c−1``'s compute is issued after chunk ``c``'s
    waves. The result concatenates the slices and drops the padding.

    With ``n_chunks=1`` and no ``compute`` the result is bit-identical to
    :func:`all_reduce`: the wave split adds no arithmetic. ``encode`` and
    ``decode`` wrap every hop of every wave. ``schedule`` overrides the
    rank-space program (a :class:`Schedule` or a prebuilt
    :class:`ChunkedSchedule` with ``p`` participants).
    """
    p = x.shape[0]
    chunked = _chunked_schedule(algo, p, n_chunks, schedule)
    C = chunked.n_chunks
    flat, n = _flatten_pad(x, C)
    size = flat.shape[1] // C
    slices = [flat[:, c * size:(c + 1) * size] for c in range(C)]
    programs = [_wave_program(w.schedule, p, encode, decode) for w in chunked.waves]
    out = _pipeline(chunked, slices, programs, compute)
    out = torch.cat(out, dim=1) if C > 1 else out[0]
    return out[:, :n].reshape(x.shape)


def _chunked_schedule(algo: str, p: int, n_chunks: int,
                      schedule: "Optional[Schedule | ChunkedSchedule]") -> ChunkedSchedule:
    """The chunked program of an overlapped call over ``p`` ranks: ``algo``'s
    under :func:`all_reduce`'s dispatch rule, or ``schedule`` chunked."""
    if schedule is None:
        a = "ring" if algo == "lumorph2" and p & (p - 1) else algo  # all_reduce's rule
        chunked = schedule_for_execution(a, p, n_chunks)
        if not isinstance(chunked, ChunkedSchedule):
            chunked = chunk_schedule(chunked, n_chunks)
    else:
        chunked = (schedule if isinstance(schedule, ChunkedSchedule)
                   else chunk_schedule(schedule, n_chunks))
    if len(chunked.participants) != p:
        raise ValueError(f"schedule has {len(chunked.participants)} participants but the "
                         f"collective runs over {p} ranks")
    return chunked


def _pipeline(chunked: ChunkedSchedule, slices: list[Tensor],
              programs: list[Callable[[Tensor], Tensor]],
              compute: Optional[Callable[[Tensor], Tensor]]) -> list[Tensor]:
    """Each chunk's waves (``programs[i]`` runs ``chunked.waves[i]``), with
    chunk ``c−1``'s ``compute`` issued behind chunk ``c``'s waves, in the
    JAX package's order. Returns the chunks' outputs."""
    C = chunked.n_chunks
    per_chunk: list[list[Callable[[Tensor], Tensor]]] = [[] for _ in range(C)]
    for w, f in zip(chunked.waves, programs):
        per_chunk[w.chunk].append(f)
    reduced: list[Optional[Tensor]] = [None] * C
    outs: list[Optional[Tensor]] = [None] * C

    def finish(c: int) -> None:
        outs[c] = reduced[c] if compute is None else compute(reduced[c])

    for c in range(C):
        y = slices[c]
        for f in per_chunk[c]:  # chunk c's waves: rs, then ag
            y = f(y)
        reduced[c] = y
        if c > 0:
            finish(c - 1)  # chunk c−1's compute is issued behind chunk c's waves
    finish(C - 1)
    return outs


def make_overlapped_all_reduce(p: int, algo: str = "lumorph2", n_chunks: int = 1,
                               compute: Optional[Callable[[Tensor], Tensor]] = None,
                               schedule: "Optional[Schedule | ChunkedSchedule]" = None,
                               ) -> Callable[[Tensor], Tensor]:
    """:func:`overlapped_all_reduce` bound to its arguments, for ``x[p, ...]``
    (the twin of the JAX package's jitted global-array wrapper)."""
    def fn(x: Tensor) -> Tensor:
        if x.shape[0] != p:
            raise ValueError(f"built for {p} ranks, x has {x.shape[0]}")
        return overlapped_all_reduce(x, algo, n_chunks, compute, schedule=schedule)
    return fn
