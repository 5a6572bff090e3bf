"""Move parameter trees from numpy into the port, keyed like JAX checkpoints.

A JAX pytree brought to numpy (``jax.tree.map(np.asarray, params)``) is a
nested dict/list of arrays. ``params_from_numpy`` turns it into the port's
tensor tree of the same structure, whatever its leaves: stacked segments
(the SSM leaves ``A_log``, ``D``, ``conv_w``, ``w_if``, ``w_h`` … included)
and zamba2's unstacked ``shared_block`` alike. ``flatten_with_paths`` lists the leaves
under the ``/``-joined paths that ``repro.checkpoint._flatten_with_paths``
produces (dict keys in sorted order, list indices as numbers), so two trees
can be compared path for path.

A data-parallel training state crosses per device: ``per_rank_from_shards``
reads each leaf's copy on every device of the data axis
(``addressable_shards``) and stacks them on a leading rank axis, the
port's virtual-rank layout; ``train_state_from_numpy`` turns that into the
port's params and optimizer state. Per device matters: under int8
compression the JAX replicas differ from device to device, and
``jax.device_get`` would show only the first. Nothing here imports JAX; a
JAX array is read through its attributes.
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


def per_rank_from_shards(tree: Any, devices) -> Any:
    """Each leaf's per-device copies, stacked in ``devices`` order → numpy
    ``[p, ...]``. A leaf held whole on every device (the data-parallel
    replicas a LUMORPH step returns) gives each device's own copy, read from
    ``leaf.addressable_shards``; any other leaf (split over the devices, or
    on some of them only, as a freshly initialized state may be laid out) is
    one value, which every rank gets whole."""
    if isinstance(tree, dict):
        return {k: per_rank_from_shards(v, devices) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(per_rank_from_shards(v, devices) for v in tree)
    by_device = {s.device: s for s in tree.addressable_shards}
    if all(d in by_device and tuple(by_device[d].data.shape) == tuple(tree.shape)
           for d in devices):
        return np.stack([np.asarray(by_device[d].data) for d in devices])
    return np.stack([np.asarray(tree)] * len(devices))


def train_state_from_numpy(params: Any, opt_state: dict,
                           device: Optional[torch.device] = None) -> tuple[Any, dict]:
    """Per-rank numpy params and AdamW state (``m``, ``v``, ``step`` and, under
    compression, ``ef``) → the port's train state: tensors with the rank
    axis first, ``step`` int32 ``[p]``."""
    opt = {k: params_from_numpy(v, device) for k, v in opt_state.items()}
    opt["step"] = opt["step"].to(torch.int32)
    return params_from_numpy(params, device), opt
