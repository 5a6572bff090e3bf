"""Step builders: data-parallel train, prefill and decode.

The twin of ``repro.launch.steps``. Every step runs eagerly on one device;
the sharding policy (``sharding.policy``) is checked by the launchers but
places nothing, because the port's data axis is virtual ranks on that
device.

The train step runs ``dp`` data-parallel ranks as a leading axis of every
parameter and optimizer tensor (the virtual-rank executor,
:mod:`repro_torch.core.collectives`). Params and optimizer state are kept
per rank because the reference's replicas are per device too: under
``--compress`` every all-gather hop delivers a quantized copy of its
owner's chunk, so the ranks end each step slightly apart, and the JAX
step keeps each device's copy (``out_specs P()``, ``check_vma=False``).

Two gradient-communication backends, as in the reference:

  * ``comm="xla"`` — the library reduction: a plain sum over the rank axis,
    divided by ``dp`` (the ideal-switch baseline);
  * ``comm="ring" | "lumorph2" | "lumorph4" | "tree" | "auto"`` — the
    Schedule-IR collectives, bucket by bucket
    (``optim.grad_comm.all_reduce_grads``; ``auto`` picks each bucket's
    schedule from the α–β cost model), with int8 payloads and error
    feedback under ``compress``, and as chunked waves under
    ``overlap_chunks > 1``.

With ``cfg.use_pallas`` the prefill's attention runs the hand-written
flash-attention kernel, once per standard-attention layer (``"dense"``,
``"moe"``); MLA layers take the dense or chunked path, as in JAX.

The train step marks its three stages for ``torch.profiler``
(``train/forward_backward``, ``train/grad_comm``, ``train/adamw``), which
``chip_smoke.py`` reads to split a step's host and device time.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.optim import grad_comm
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
from repro_torch.tree import leaves, tree_map, unflatten

Tree = Any
COMMS = ("xla", "ring", "lumorph2", "lumorph4", "tree", "auto")
META = torch.device("meta")


# ---------------------------------------------------------------------------
# shape helpers (meta tensors: shapes and dtypes, nothing allocated)
# ---------------------------------------------------------------------------

def batch_shapes(cfg: ModelConfig, seq_len: int, global_batch: int) -> dict:
    """A batch's leaves on the meta device, with JAX ``batch_shapes``'s
    shapes and dtypes: int32 tokens, plus fp32 ``image_embeds`` (vlm) or
    ``frames`` (encdec)."""
    out = {"tokens": torch.empty((global_batch, seq_len), dtype=torch.int32, device=META)}
    if cfg.kind == "vlm":
        out["image_embeds"] = torch.empty((global_batch, cfg.num_image_tokens, cfg.d_model),
                                          dtype=torch.float32, device=META)
    if cfg.kind == "encdec":
        out["frames"] = torch.empty((global_batch, cfg.enc_seq_len, cfg.d_model),
                                    dtype=torch.float32, device=META)
    return out


def input_specs(cfg: ModelConfig, policy, seq_len: int, global_batch: int) -> tuple[dict, dict]:
    """(the batch's meta leaves, their specs under ``policy``)."""
    shapes = batch_shapes(cfg, seq_len, global_batch)
    return shapes, policy.batch_specs(shapes)


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes one entry of a spec names: none, one, or a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_shape(shape: tuple[int, ...], spec: tuple, mesh) -> tuple[int, ...]:
    """One device's shard of a leaf of ``shape`` under ``spec`` on ``mesh``
    (a ``MeshShape``): each dim divided by the sizes of the axes its entry
    names, rounded up as XLA pads an uneven shard."""
    out = []
    for i, n in enumerate(shape):
        ways = 1
        for a in entry_axes(spec[i] if i < len(spec) else None):
            ways *= mesh.shape[a]
        out.append(-(-n // ways))
    return tuple(out)


def sharded_struct(tree: Tree, spec_tree: Tree, mesh) -> Tree:
    """The per-device shards of ``tree`` under ``spec_tree``: meta tensors of
    each leaf's shard shape and dtype, the role of JAX ``sharded_struct``'s
    sharded ``ShapeDtypeStruct`` s. Their bytes are a device's share."""
    if isinstance(tree, dict):
        return {k: sharded_struct(v, spec_tree[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(sharded_struct(v, s, mesh) for v, s in zip(tree, spec_tree))
    return torch.empty(shard_shape(tuple(tree.shape), spec_tree, mesh), dtype=tree.dtype,
                       device=META)


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def init_train_state(cfg: ModelConfig, dp: int, seed: int = 0,
                     device: Optional[torch.device] = None,
                     init_ef: bool = False) -> tuple[Tree, dict]:
    """Random params from ``seed``, replicated over ``dp`` ranks (leading
    axis), with zero AdamW moments, an int32 step per rank and, with
    ``init_ef``, zero fp32 error-feedback buffers."""
    dev = resolve_device(device)
    one = tf.init_params(torch.Generator(device=dev).manual_seed(seed), cfg)
    params = tree_map(lambda t: t.expand(dp, *t.shape).clone(), one)
    del one
    opt = init_opt_state(params, lead=(dp,))
    if init_ef:
        opt["ef"] = tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                                   device=t.device), params)
    return params, opt


def opt_shapes(cfg: ModelConfig, params_shape: Tree) -> dict:
    """The optimizer state's tree for a params tree on the meta device (see
    ``models.transformer.param_shapes``): moments of the params' shapes and
    an int32 step, allocating nothing. The twin of JAX ``opt_shapes``."""
    return init_opt_state(params_shape)


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                    comm: str = "xla", dp: int = 1,
                    bucket_bytes: int = grad_comm.DEFAULT_BUCKET_BYTES,
                    compress: bool = False, wire_dtype: torch.dtype = torch.bfloat16,
                    microbatches: int = 1, overlap_chunks: int = 1,
                    device: Optional[torch.device] = None) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, loss)``.

    Rank ``r`` takes the contiguous rows ``[r·B/dp, (r+1)·B/dp)`` of the
    global batch, as JAX's ``P("data")`` batch spec gives device ``r``.
    ``loss`` is the mean of the ranks' losses. ``microbatches > 1``
    accumulates fp32 gradients over that many slices of each rank's rows.
    ``overlap_chunks > 1`` (LUMORPH comms; ignored by ``xla``) runs every
    bucket's collective as that many chunked waves (overlap mode).
    After each call ``step.bucket_log`` holds the last (bytes, algo) log.
    """
    if comm not in COMMS:
        raise ValueError(f"unknown comm {comm!r}; have {COMMS}")
    opt_cfg = opt_cfg or AdamWConfig()
    dev = resolve_device(device)

    def grad_fn(params, batch) -> tuple[torch.Tensor, list[torch.Tensor]]:
        plist = leaves(params)
        if microbatches == 1:
            loss = tf.loss_fn(params, batch, cfg)
            return loss.detach(), list(torch.autograd.grad(loss, plist))
        b = batch["tokens"].shape[0]
        if b % microbatches:
            raise ValueError(f"{b} rows per rank do not split into {microbatches} microbatches")
        loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=dev) for p in plist]
        for i in range(microbatches):
            mb = {k: v.reshape(microbatches, b // microbatches, *v.shape[1:])[i]
                  for k, v in batch.items()}
            loss = tf.loss_fn(params, mb, cfg)
            g = torch.autograd.grad(loss, plist)
            loss_acc = loss_acc + loss.detach()
            g_acc = [a + gi.float() for a, gi in zip(g_acc, g)]
        inv = 1.0 / microbatches
        return loss_acc * inv, [g * inv for g in g_acc]

    def step(params, opt_state, batch):
        batch = {k: v.to(dev) for k, v in batch.items()}
        b = batch["tokens"].shape[0]
        if b % dp:
            raise ValueError(f"global batch {b} does not split over {dp} ranks")
        rows = b // dp
        plist = leaves(params)
        if plist[0].shape[0] != dp:
            raise ValueError(f"params carry {plist[0].shape[0]} ranks, the step {dp}")
        losses, grads = [], None
        with record_function("train/forward_backward"):
            for r in range(dp):
                p_r = unflatten(params, [t[r].detach().requires_grad_() for t in plist])
                loss_r, g_r = grad_fn(p_r, {k: v[r * rows:(r + 1) * rows]
                                            for k, v in batch.items()})
                if grads is None:
                    grads = [torch.empty((dp, *g.shape), dtype=g.dtype, device=g.device)
                             for g in g_r]
                for acc, g in zip(grads, g_r):
                    acc[r] = g
                losses.append(loss_r)
                del p_r, g_r
            loss = torch.stack(losses).sum() / dp  # pmean over the data axis
        grads = unflatten(params, grads)
        new_ef = None
        with record_function("train/grad_comm"):
            if comm == "xla":
                grads = tree_map(lambda g: (g.sum(dim=0, keepdim=True) / dp).expand_as(g),
                                 grads)
            else:
                grads, new_ef, step.bucket_log = grad_comm.all_reduce_grads(
                    grads, algo=comm, bucket_bytes=bucket_bytes, compress=compress,
                    error_feedback=opt_state.get("ef"), wire_dtype=wire_dtype,
                    overlap_chunks=overlap_chunks)
        core = {k: v for k, v in opt_state.items() if k != "ef"}
        with record_function("train/adamw"):
            params, core = adamw_update(params, grads, core, opt_cfg)
        if new_ef is not None:
            core["ef"] = new_ef
        return params, core, loss

    step.bucket_log = []
    return step


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------


def make_prefill(cfg: ModelConfig, device: Optional[torch.device] = None) -> Callable:
    """``prefill(params, batch) -> logits [B,S,V]`` on ``device`` (default cuda)."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def prefill(params, batch):
        batch = {k: v.to(dev) for k, v in batch.items()}
        logits, _ = tf.forward_logits(params, batch, cfg)
        return logits

    return prefill


def make_decode_step(cfg: ModelConfig, device: Optional[torch.device] = None) -> Callable:
    """``decode(params, caches, tokens [B,1], position) -> (logits, caches)``;
    the caches are updated in place."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def decode(params, caches, tokens, position: int):
        return tf.decode_step(params, caches, tokens.to(dev), position, cfg)

    return decode
