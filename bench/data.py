"""Inputs drawn from ``--seed``: token batches and weights.

The Zipf-ish token draw is a frozen copy of ``repro_torch.data.pipeline``'s
(a seeded permutation of the vocabulary, ranked by a log-uniform inverse
CDF), keyed here by (seed, batch index); the uniform draw is for prompts.
Weights are drawn on the card in one call, in the tree ``init_params``
lays out (dict keys, a list of stacked segments, leaves ``[layers, ...]``),
so the same tensors can be handed to the program and, drawn again from the
seed, to the plain reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SEED_MASK = (1 << 64) - 1


def _rng(seed: int, index: int, stream: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=seed & SEED_MASK,
                                                counter=[0, 0, stream, index]))


def tokens(cfg: dict, kind: str, seed: int, index: int, batch: int, seq: int) -> torch.Tensor:
    """Batch ``index`` of ``kind`` (``zipf`` or ``uniform``): int32 ``[batch, seq]``
    on the CPU."""
    v = cfg["vocab_size"]
    if kind == "zipf":
        rng = _rng(seed, index, 1)
        ranks = rng.permutation(v)
        u = rng.random((batch, seq))
        zipf = (v ** u - 1) / (v - 1)  # inverse CDF of a log-uniform
        out = ranks[np.clip((zipf * v).astype(np.int64), 0, v - 1)]
    elif kind == "uniform":
        out = _rng(seed, index, 2).integers(0, v, (batch, seq))
    else:
        raise ValueError(f"unknown token draw {kind!r}")
    return torch.from_numpy(out.astype(np.int32))


def weight_shapes(cfg: dict) -> dict:
    """The params tree as ``init_params`` lays it out for a dense decoder,
    leaf → (shape, init), init one of ``embed``, ``fan_in:<n>``, ``norm_w``,
    ``norm_b``, ``rms_w``."""
    d, h, kv, hd, f, n = (cfg[k] for k in ("d_model", "n_heads", "n_kv_heads", "head_dim",
                                           "d_ff", "n_layers"))

    def norm(lead):
        if cfg["norm"] == "rmsnorm":
            return {"w": (lead + (d,), "rms_w")}
        return {"w": (lead + (d,), "norm_w"), "b": (lead + (d,), "norm_b")}
    mlp = {"wi": ((n, d, f), f"fan_in:{d}"), "wo": ((n, f, d), f"fan_in:{f}")}
    if cfg["mlp_style"] in ("swiglu", "geglu"):
        mlp["wg"] = ((n, d, f), f"fan_in:{d}")
    seg = {"ln1": norm((n,)),
           "attn": {"wq": ((n, d, h, hd), f"fan_in:{d}"), "wk": ((n, d, kv, hd), f"fan_in:{d}"),
                    "wv": ((n, d, kv, hd), f"fan_in:{d}"),
                    "wo": ((n, h, hd, d), f"fan_in:{h * hd}")},
           "ln2": norm((n,)), "mlp": mlp}
    tree = {"embed": ((cfg["vocab_size"], d), "embed"), "segments": [seg],
            "final_norm": norm(())}
    if not cfg["tie_embeddings"]:
        tree["lm_head"] = ((d, cfg["vocab_size"]), f"fan_in:{d}")
    return tree


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def make_weights(cfg: dict, seed: int, device) -> dict:
    """fp32 weights from ``seed``: one normal draw on ``device`` for every leaf
    at once, each leaf a view scaled in place (matrices by 1/sqrt(fan-in),
    embeddings by 0.02, norms around their identity)."""
    spec = weight_shapes(cfg)
    flat = list(_walk(spec))
    total = sum(math.prod(shape) for _, (shape, _) in flat)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & SEED_MASK)
    buf = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out = _copy_structure(spec)
    at = 0
    for path, (shape, init) in flat:
        n = math.prod(shape)
        leaf = buf[at:at + n].view(shape)
        at += n
        if init == "embed":
            leaf.mul_(0.02)
        elif init.startswith("fan_in:"):
            leaf.mul_(1.0 / math.sqrt(int(init.split(":")[1])))
        elif init == "norm_w":
            leaf.mul_(0.1).add_(1.0)
        else:  # norm_b, rms_w (the scale is 1 + w)
            leaf.mul_(0.1)
        _set(out, path, leaf)
    return out


def _copy_structure(tree):
    if isinstance(tree, dict):
        return {k: _copy_structure(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_structure(v) for v in tree]
    return None


def leaf_paths(tree) -> list[str]:
    """Leaves of a params tree in the sorted-key order, as ``a/b/0/c``."""
    return ["/".join(map(str, p)) for p, _ in _walk(tree)]


def leaf_list(tree) -> list[torch.Tensor]:
    return [t for _, t in _walk(tree)]
