"""The port's trimmed copy of ``repro.core.cost_model``.

Only what the Schedule-IR builders need to lay out rounds:
:func:`mixed_radix_factorization` (LUMORPH-4's digit groups). The α–β
pricing and ``select_algorithm`` (``--comm auto``) are not ported yet
(ROADMAP Queue 1 item 7).
"""

from __future__ import annotations


def mixed_radix_factorization(p: int, radix: int) -> list[int]:
    """Factor ``p`` into factors ≤ radix, preferring ``radix`` (e.g. 32 → [4,4,2])."""
    if p < 1:
        raise ValueError(f"p must be ≥ 1, got {p}")
    out: list[int] = []
    rem = p
    while rem > 1:
        if rem % radix == 0:
            out.append(radix)
            rem //= radix
            continue
        for r in range(min(radix, rem), 1, -1):
            if rem % r == 0:
                out.append(r)
                rem //= r
                break
        else:
            out.append(rem)  # prime > radix: single ring-style factor
            rem = 1
    return out
