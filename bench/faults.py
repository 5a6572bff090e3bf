"""Faults planted under the timed path, to show that ``correct`` catches them.

Each is a context manager that swaps one function of the program for a broken
one while it is open. The tests in ``bench/tests/`` drive a run under each
fault that its cell can have and expect ``correct`` to come out false;
``bench/control.py`` reads each at a cell's own size on the card.
"""

from __future__ import annotations

from contextlib import contextmanager


@contextmanager
def _swap(module, name: str, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def state_unchanged():
    """The train step hands back the state it was given."""
    from repro_torch.launch import steps
    return _swap(steps, "adamw_update", lambda orig: lambda params, grads, state, cfg:
                 (params, state))


def half_batch_loss():
    """Half of each training batch is left out: the loss is the mean over the
    first half of the rows."""
    from repro_torch.models import transformer as tf
    return _swap(tf, "loss_fn", lambda orig: lambda params, batch, cfg: orig(
        params, {k: v[:max(1, v.shape[0] // 2)] for k, v in batch.items()}, cfg))


def half_batch_prefill():
    """Half of each prefill batch is left out: the first half of the prompts is
    computed and its logits handed back for the rest too."""
    from repro_torch.models import transformer as tf

    def forward(orig):
        def fn(params, batch, cfg):
            b = batch["tokens"].shape[0]
            logits, aux = orig(params, {k: v[:max(1, b // 2)] for k, v in batch.items()}, cfg)
            return logits.repeat(-(-b // logits.shape[0]), 1, 1)[:b], aux
        return fn
    return _swap(tf, "forward_logits", forward)


def no_exchange():
    """The gradients are not exchanged between ranks: each keeps its own."""
    from repro_torch.optim import grad_comm
    return _swap(grad_comm, "all_reduce_grads", lambda orig: lambda grads, **kw:
                 (grads, None, []))


def altered_loss():
    """An answer altered where it is produced: the train step's loss is 1 % high."""
    from repro_torch.models import transformer as tf
    return _swap(tf, "loss_fn", lambda orig: lambda params, batch, cfg:
                 orig(params, batch, cfg) * 1.01)


def altered_token():
    """A token altered where it is produced: a prefill's logits at its middle
    position put token 0 first."""
    from repro_torch.models import transformer as tf

    def forward(orig):
        def fn(params, batch, cfg):
            logits, aux = orig(params, batch, cfg)
            mid = logits.shape[1] // 2
            logits[:, mid, 0] = logits[:, mid].amax(-1) + 1.0
            return logits, aux
        return fn
    return _swap(tf, "forward_logits", forward)


#: driver → fault name → (context manager, whether the cell needs several chips)
FAULTS = {"train": {"state_unchanged": (state_unchanged, False),
                    "half_batch": (half_batch_loss, False),
                    "no_exchange": (no_exchange, True),
                    "altered_answer": (altered_loss, False)},
          "prefill": {"half_batch": (half_batch_prefill, False),
                      "altered_answer": (altered_token, False)}}


def faults_for(driver: str, chips: int) -> dict:
    """The faults a cell of ``driver`` on ``chips`` chips can have: name → manager."""
    return {n: cm for n, (cm, multi) in FAULTS[driver].items() if chips > 1 or not multi}
