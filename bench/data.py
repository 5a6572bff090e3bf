"""Inputs drawn from ``--seed``: token batches and weights.

The Zipf-ish token draw is a frozen copy of ``repro_torch.data.pipeline``'s
(a seeded permutation of the vocabulary, ranked by a log-uniform inverse
CDF), keyed here by (seed, batch index); the uniform draw is for prompts.
Weights are drawn on the card from the seed, in the tree ``init_params``
lays out (dict keys, a list of stacked segments, leaves ``[layers, ...]``)
and in each leaf's stored dtype, so the same tensors can be handed to the
program and, drawn again from the seed, to the plain reference.
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
    leaf → (shape, init, dtype), init one of ``embed``, ``fan_in:<n>``,
    ``norm_w``, ``norm_b``, ``rms_w``; the norms stored in fp32, the rest in
    the configuration's ``param_dtype``."""
    d, h, kv, hd, f, n = (cfg[k] for k in ("d_model", "n_heads", "n_kv_heads", "head_dim",
                                           "d_ff", "n_layers"))
    pd = cfg["param_dtype"]

    def norm(lead):
        if cfg["norm"] == "rmsnorm":
            return {"w": (lead + (d,), "rms_w", "float32")}
        return {"w": (lead + (d,), "norm_w", "float32"),
                "b": (lead + (d,), "norm_b", "float32")}
    mlp = {"wi": ((n, d, f), f"fan_in:{d}", pd), "wo": ((n, f, d), f"fan_in:{f}", pd)}
    if cfg["mlp_style"] in ("swiglu", "geglu"):
        mlp["wg"] = ((n, d, f), f"fan_in:{d}", pd)
    seg = {"ln1": norm((n,)),
           "attn": {"wq": ((n, d, h, hd), f"fan_in:{d}", pd),
                    "wk": ((n, d, kv, hd), f"fan_in:{d}", pd),
                    "wv": ((n, d, kv, hd), f"fan_in:{d}", pd),
                    "wo": ((n, h, hd, d), f"fan_in:{h * hd}", pd)},
           "ln2": norm((n,)), "mlp": mlp}
    tree = {"embed": ((cfg["vocab_size"], d), "embed", pd), "segments": [seg],
            "final_norm": norm(())}
    if not cfg["tie_embeddings"]:
        tree["lm_head"] = ((d, cfg["vocab_size"]), f"fan_in:{d}", pd)
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


CHUNK = 1 << 26  # values of one fp32 draw where a layout is not all fp32 (256 MiB)


def _scale(x: torch.Tensor, init: str) -> torch.Tensor:
    """A standard normal draw scaled in place to its init: matrices by
    1/sqrt(fan-in), embeddings by 0.02, norms around their identity."""
    if init == "embed":
        return x.mul_(0.02)
    if init.startswith("fan_in:"):
        return x.mul_(1.0 / math.sqrt(int(init.split(":")[1])))
    if init == "norm_w":
        return x.mul_(0.1).add_(1.0)
    return x.mul_(0.1)  # norm_b, rms_w (the scale is 1 + w)


def make_weights(cfg: dict, seed: int, device, layout: dict | None = None) -> dict:
    """Weights from ``seed`` in ``layout`` (a ``weight_shapes`` tree; the dense
    decoder's where None), on ``device``. An all-fp32 layout takes one normal
    draw for every leaf at once, each leaf a view of it scaled in place. Any
    other is drawn leaf by leaf, ``CHUNK`` values at a time in fp32, each
    chunk scaled and stored in its leaf's dtype: the device never holds the
    model in fp32."""
    spec = weight_shapes(cfg) if layout is None else layout
    flat = list(_walk(spec))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & SEED_MASK)
    out = _copy_structure(spec)
    if all(dtype == "float32" for _, (_, _, dtype) in flat):
        total = sum(math.prod(shape) for _, (shape, _, _) in flat)
        buf = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
        at = 0
        for path, (shape, init, _) in flat:
            n = math.prod(shape)
            _set(out, path, _scale(buf[at:at + n].view(shape), init))
            at += n
        return out
    for path, (shape, init, dtype) in flat:
        leaf = torch.empty(shape, dtype=getattr(torch, dtype), device=device)
        values = leaf.view(-1)
        for at in range(0, values.numel(), CHUNK):
            n = min(CHUNK, values.numel() - at)
            draw = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
            values[at:at + n].copy_(_scale(draw, init))
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
