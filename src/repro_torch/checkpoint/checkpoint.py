"""Checkpoints in the JAX package's on-disk format (``repro.checkpoint``).

A checkpoint of step ``n`` is the directory ``step_<n:010d>/`` holding one
``leaf_NNNNN.npy`` per leaf, in JAX's flatten order, and a
``manifest.json`` that lists each leaf's path key (``bridge.
flatten_with_paths``), file, shape and dtype. The two packages read each
other's checkpoints; for the same values the files are the same bytes.

  * **atomic**: writes go to ``step_<n>.tmp/``, which is renamed to
    ``step_<n>/`` once complete; a directory without a manifest, or a
    ``.tmp`` one, is never the latest;
  * **retention**: after a write, only the ``keep`` newest steps stay;
  * **restore** takes the structure, dtypes and devices of ``like`` and
    rejects a leaf that is missing or of another shape;
  * **placed state**: a DTensor leaf (a rank's shard under a model axis) is
    saved as its full tensor, which every rank of its mesh gathers (a
    collective) before the one rank that writes does; it is restored by
    placing the full tensor as ``like``'s leaf is placed, every rank keeping
    its own shard.

bf16 leaves are stored as numpy writes an ``ml_dtypes.bfloat16`` array
(header descr ``'<V2'``, the raw bits, dtype ``"bfloat16"`` in the
manifest), without importing ml_dtypes.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from torch.distributed.tensor import DTensor

from repro_torch.bridge import flatten_with_paths
from repro_torch.sharding.policy import gather_tree, place_like
from repro_torch.tree import unflatten

Tree = Any

MANIFEST = "manifest.json"


def _step_dir(ckpt_dir: Path, step: int) -> Path:
    return ckpt_dir / f"step_{step:010d}"


def _write_leaf(path: Path, t: torch.Tensor) -> tuple[list[int], str]:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False, "shape": tuple(t.shape)})
            f.write(t.view(torch.int16).numpy().tobytes())
        return list(t.shape), "bfloat16"
    arr = t.numpy()
    np.save(path, arr)
    return list(arr.shape), str(arr.dtype)


def _read_leaf(path: Path, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(ckpt_dir: str | Path, step: int, state: Tree, keep: int = 3,
         write: bool = True) -> Optional[Path]:
    """Atomically write ``state`` (a dict/list/tuple tree of tensors) for
    ``step``. DTensor leaves are gathered first, by every rank that calls;
    only a caller with ``write`` writes."""
    state = gather_tree(state)
    if not write:
        return None
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"step_{step:010d}.tmp"
    final = _step_dir(ckpt_dir, step)
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {"step": step, "leaves": []}
    for i, (key, leaf) in enumerate(flatten_with_paths(state)):
        fname = f"leaf_{i:05d}.npy"
        shape, dtype = _write_leaf(tmp / fname, leaf)
        manifest["leaves"].append({"key": key, "file": fname, "shape": shape, "dtype": dtype})
    (tmp / MANIFEST).write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic publish
    _gc(ckpt_dir, keep)
    return final


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    """The newest complete checkpoint's step, or None."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(d.name[5:]) for d in ckpt_dir.iterdir()
             if d.is_dir() and d.name.startswith("step_") and not d.name.endswith(".tmp")
             and (d / MANIFEST).exists()]
    return max(steps) if steps else None


def restore(ckpt_dir: str | Path, like: Tree,
            step: Optional[int] = None) -> tuple[Tree, int]:
    """Read a checkpoint (the latest by default) into the structure of
    ``like``: each leaf takes its ``like`` leaf's dtype and device."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = _step_dir(ckpt_dir, step)
    manifest = json.loads((d / MANIFEST).read_text())
    by_key = {m["key"]: m for m in manifest["leaves"]}
    out = []
    for key, leaf in flatten_with_paths(like):
        m = by_key.get(key)
        if m is None:
            raise KeyError(f"checkpoint {d} missing leaf {key!r}")
        t = _read_leaf(d / m["file"], m["dtype"])
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)} != target "
                             f"{tuple(leaf.shape)}")
        t = t.to(device=leaf.device, dtype=leaf.dtype)
        out.append(place_like(t, leaf) if isinstance(leaf, DTensor) else t)
    return unflatten(like, out), step


def _gc(ckpt_dir: Path, keep: int) -> None:
    steps = sorted(int(d.name[5:]) for d in ckpt_dir.iterdir()
                   if d.is_dir() and d.name.startswith("step_") and not d.name.endswith(".tmp"))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)
