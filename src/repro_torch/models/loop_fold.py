"""A counter's hook to fold the models' Python loops over equal steps.

``launch.dryrun`` counts each op's FLOPs and bytes on the meta device, where
a Python loop costs its dispatch overhead per step whatever the shapes:
xlstm's sLSTM runs 32768 time steps at ``prefill_32k``, mamba2's scan 256
chunk states per layer, and the chunked attention 32 KV chunks per layer.
While ``FOLD`` holds a counter's ``repeated(n, inputs, outputs)`` (a
context whose ops count ``n`` times, with the autograd nodes between
``inputs`` and ``outputs()``), such a loop runs its first step, then one
step counted for the equal steps that follow, then any ragged tail. Every
step after the first runs the same ops on the same shapes, so the FLOPs
are the loop's, exactly, and for mamba2's scan and the attention's chunks
the bytes too; the values are not. The hook is for counting only, and
nothing sets it outside a count.

mamba2's scan and the chunked attention fold only where no gradient is
taken (prefill and decode): a backward sums each step's gradient into the
tensors every step reads, and a fold runs fewer of those sums. sLSTM's
loop folds in training too (its 4096 steps, with backward and remat, would
take minutes), and its training bytes fall short by those sums.
"""

from __future__ import annotations

import contextvars

FOLD: contextvars.ContextVar = contextvars.ContextVar("loop_fold", default=None)
