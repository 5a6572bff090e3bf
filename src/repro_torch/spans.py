"""Module spans inside a profiled train step or prefill: which module launches what.

``launch.steps.make_train_step``'s step sets the namespace ``train`` for the
length of its call (:func:`namespace`), and ``make_prefill``'s call the
namespace ``prefill``. While ``torch.profiler`` runs, the model's modules then
mark themselves, ``<ns>/<layer>``:

  * :func:`wrap` runs a module (``embed``, ``norm``, ``attention``, ``ffn``,
    ``unembed``, ``loss``) inside ``record_function`` and puts an identity
    autograd node at its input and one at its output. The output's backward
    opens ``train/<layer>.bwd`` when the module's gradient arrives; the
    input's closes it once the module's backward has run (every node the
    module made is newer than the input's, so the autograd engine runs it
    first). The names are fixed at forward time: the backward runs on the
    engine's own thread, which sees no step. The nodes save no tensor.
  * :func:`checkpoint_contexts` is ``checkpoint``'s ``context_fn``: it opens
    ``train/recompute`` around a block's recomputation in the backward.
  * :func:`host_span` marks ``train/forward`` and ``train/backward``.
  * :func:`span` marks a stage inside a module: a dropless MoE's
    ``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine`` and
    ``moe.shared``.

A prefill runs under inference mode, so its modules mark their forward only.
Outside a step or a prefill (the encode, the decode), or with no profiler
running, every call reads one flag and adds no autograd node.

On the device a span's range runs from the first to the last kernel launched
with it as the thread's innermost span (CUPTI's user ranges, measured on an
H100): an outer span loses its inner spans' kernels. So :func:`host_span`'s
spans, and the modules' spans inside ``train/recompute``, are marked on the
host only (``_RecordFunctionFast``, which opens no device range). The step's
``train/forward_backward`` then keeps its range over the forward and the
backward (its first kernel, ``forward_logits``' ``aux`` zeros, and the
gradients' copies after the backward are its own), ``train/recompute``'s
range holds all of its kernels, and each module's ranges hold only its own. ``bench/module_time.py``
reads them; ``bench/metrics/host_fwd_ms.train.py`` and its kin read the host's.
A step placed on a process mesh (DTensor inputs) keeps its forward spans only.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.profiler import record_function

_state = threading.local()  # ns: the step's namespace; recompute: inside a recomputation


def _live() -> Optional[str]:
    """The step's namespace while a profiler runs, else None."""
    if not torch.autograd._profiler_enabled():
        return None
    return getattr(_state, "ns", None)


@contextlib.contextmanager
def namespace(ns: str):
    """Spans named ``<ns>/...`` on this thread for the length of a step's call."""
    prev = getattr(_state, "ns", None)
    _state.ns = ns
    try:
        yield
    finally:
        _state.ns = prev


def live() -> bool:
    """Whether spans mark now: a step's or a prefill's call under a profiler."""
    return _live() is not None


def span(name: str):
    """``<ns>/<name>`` around a stage inside a module (the MoE's route, dispatch,
    experts, combine and shared experts), while live: on the device as a
    module's span, on the host only inside a recomputation. It marks no
    backward."""
    ns = _live()
    if ns is None:
        return contextlib.nullcontext()
    if getattr(_state, "recompute", False):
        return _host_only(f"{ns}/{name}")
    return record_function(f"{ns}/{name}")


def _host_only(name: str):
    return torch._C._profiler._RecordFunctionFast(name)


def host_span(name: str):
    """``<ns>/<name>`` on the host's timeline only, while live."""
    ns = _live()
    return contextlib.nullcontext() if ns is None else _host_only(f"{ns}/{name}")


class _Mark:
    """A module's ``.bwd`` span, named at forward time."""
    __slots__ = ("name", "handle")

    def __init__(self, name: str):
        self.name, self.handle = name, None


class _Open(torch.autograd.Function):
    """At a module's output: its backward opens the module's ``.bwd`` span."""

    @staticmethod
    def forward(ctx, t, mark):
        ctx.mark = mark
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        ctx.mark.handle = torch.ops.profiler._record_function_enter_new(ctx.mark.name, None)
        return g, None


class _Close(torch.autograd.Function):
    """At a module's input: its backward closes the module's ``.bwd`` span."""

    @staticmethod
    def forward(ctx, t, mark):
        ctx.mark = mark
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        if ctx.mark.handle is not None:
            torch.ops.profiler._record_function_exit._RecordFunction(ctx.mark.handle)
            ctx.mark.handle = None
        return g, None


def wrap(layer: str, x: torch.Tensor, fn: Callable[[torch.Tensor], Any]) -> Any:
    """``fn(x)``: the module ``layer`` on ``x``, the input its gradient leaves by
    (for ``embed``, the table). Its output, or a tuple's first element, is the
    tensor its gradient arrives by."""
    ns = _live()
    if ns is None:
        return fn(x)
    name = f"{ns}/{layer}"
    if getattr(_state, "recompute", False):
        with _host_only(name):
            return fn(x)
    marked = torch.is_grad_enabled() and x.requires_grad and not isinstance(x, DTensor)
    if not marked:
        with record_function(name):
            return fn(x)
    mark = _Mark(f"{name}.bwd")
    with record_function(name):
        out = fn(_Close.apply(x, mark))
    y = out[0] if isinstance(out, tuple) else out
    if not y.requires_grad:
        return out
    y = _Open.apply(y, mark)
    return (y, *out[1:]) if isinstance(out, tuple) else y


class _Recompute:
    """``<ns>/recompute`` around a block's recomputation, on the thread that
    runs it, with the modules inside it marked on the host only."""

    def __init__(self, ns: str):
        self.ns = ns

    def __enter__(self):
        self.prev = (getattr(_state, "ns", None), getattr(_state, "recompute", False))
        _state.ns, _state.recompute = self.ns, True
        self.handle = torch.ops.profiler._record_function_enter_new(f"{self.ns}/recompute",
                                                                    None)

    def __exit__(self, *exc):
        torch.ops.profiler._record_function_exit._RecordFunction(self.handle)
        _state.ns, _state.recompute = self.prev


def checkpoint_contexts():
    """``torch.utils.checkpoint``'s ``context_fn``: nothing around the forward,
    ``<ns>/recompute`` around the recomputation while live."""
    ns = _live()
    return contextlib.nullcontext(), (contextlib.nullcontext() if ns is None
                                      else _Recompute(ns))
