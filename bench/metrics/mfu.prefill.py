"""``mfu.train``'s reading, for the prefill cell: model FLOPs a call at the
window's call rate past the traced stretch, over the chip's bf16 peak, %."""

from bench.harness import reader

read = reader("mfu.train")
