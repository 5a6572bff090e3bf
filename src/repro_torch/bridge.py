"""Move parameter trees from numpy into the port, keyed like JAX checkpoints.

A JAX pytree brought to numpy (``jax.tree.map(np.asarray, params)``) is a
nested dict/list of arrays. ``params_from_numpy`` turns it into the port's
tensor tree of the same structure. ``flatten_with_paths`` lists the leaves
under the ``/``-joined paths that ``repro.checkpoint._flatten_with_paths``
produces (dict keys in sorted order, list indices as numbers), so two trees
can be compared path for path. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def _to_tensor(a: Any, device: Optional[torch.device]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: same bits as torch's
        t = torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device) if device is not None else t


def params_from_numpy(tree: Any, device: Optional[torch.device] = None) -> Any:
    """Nested dict/list/tuple of numpy arrays → the same nesting of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return _to_tensor(tree, device)


def flatten_with_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``[(path, leaf)]`` in JAX's flattening order (sorted dict keys)."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out.extend(flatten_with_paths(sub, f"{prefix}/{key}" if prefix else key))
    return out
