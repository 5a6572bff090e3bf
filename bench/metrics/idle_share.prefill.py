"""``idle_share.train``'s reading, for the prefill cell: share of the traced
stretch in which no operation ran on the device, %."""

from bench.harness import reader

read = reader("idle_share.train")
