"""Step builders: train, prefill and decode.

The twin of ``repro.launch.steps``. Every step runs eagerly. On virtual
ranks and on a process mesh with a model axis of 1 the sharding policy
(``sharding.policy``) is checked by the launchers but places nothing. On a
process mesh that holds a ``DeviceMesh`` (:func:`placed`: a model axis, a pod
axis or ``flat_dp``, ``launch.mesh.lay_out_mesh``) every parameter,
optimizer, batch and cache leaf is a DTensor placed by the policy's spec: TP
over ``model``, ZeRO-1 moments over the data axes (``("pod", "data")`` on the
multi-pod mesh, ``("data", "model")`` under ``flat_dp``) under
``comm="xla"``, and under a ZeRO-3 policy the params over them too. Every
placement is read by its mesh dim's name. The step then runs as the JAX
LUMORPH step's ``shard_map`` does, manual over the data axes and automatic
over the model axis (under ``flat_dp`` manual over both, TP 1), the
gradients reduced over the data axes' flattened group: each data rank runs the
forward and backward on its own rows with the params as DTensors on its
model group, a ZeRO-3 param gathered over data first (DTensor's sharding
propagation inserts the tensor-parallel collectives,
:func:`repro_torch.models.attention.head_local` keeps the attention on each
rank's own heads), and the gradients are reduced over its data group. The
prefill and the decode run the same way, the decode on caches placed by the
policy's cache specs. Every block kind runs placed: dense and zamba2's
shared block on their heads, MoE with its experts over model, MLA with its
heads over model and its latent cache's sequence over model, the SSM mixers
replicated over model beside decode states split over their heads, and
whisper's cross-attention on its heads of the encoder's keys and values.

The train step runs ``dp`` data-parallel ranks as a leading axis of every
parameter and optimizer tensor (the virtual-rank executor,
:mod:`repro_torch.core.collectives`), or, given a process ``group``, one
rank per process with no rank axis (the cross-process executor,
:mod:`repro_torch.core.collectives_dist`). Params and optimizer state are kept
per rank because the reference's replicas are per device too: under
``--compress`` every all-gather hop delivers a quantized copy of its
owner's chunk, so the ranks end each step slightly apart, and the JAX
step keeps each device's copy (``out_specs P()``, ``check_vma=False``).

Two gradient-communication backends, as in the reference:

  * ``comm="xla"`` — the library reduction: a plain sum over the rank axis,
    or ``dist.all_reduce`` across processes, divided by ``dp`` (the
    ideal-switch baseline);
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
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives_dist
from repro_torch.device import resolve_device
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer as tf
from repro_torch.optim import grad_comm
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
from repro_torch.sharding.policy import (data_dims, distribute_tree, gather_data, local_offsets,
                                        place, place_filled, place_like, redistribute,
                                        replicated)
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
                     init_ef: bool = False,
                     group: Optional[dist.ProcessGroup] = None,
                     policy=None, mesh=None, comm: str = "xla") -> tuple[Tree, dict]:
    """Random params from ``seed``, replicated over ``dp`` ranks (leading
    axis), with zero AdamW moments, an int32 step per rank and, with
    ``init_ef``, zero fp32 error-feedback buffers.

    Given a process ``group`` of ``dp`` ranks, every rank builds its own
    copy from the same seed with no rank axis, as the JAX state is
    replicated, and the copies are checked equal once, by a checksum.

    On a process ``mesh`` with a model axis, every rank builds the full
    params from the seed, as above, and keeps only its shard under
    ``policy``'s param specs, which gives JAX ``init_sharded_state``'s
    numbers (a ZeRO-3 policy's params shard over data too). The moments
    follow the opt specs (ZeRO-1, or ZeRO-3's) under ``comm="xla"`` and the
    param specs on the LUMORPH comms, whose JAX step replicates them over
    data; the error-feedback buffers follow the param specs."""
    dev = resolve_device(device)
    one = tf.init_params(torch.Generator(device=dev).manual_seed(seed), cfg)
    if placed(mesh):
        return _placed_state(cfg, one, policy, mesh, init_ef, comm)
    if group is not None:
        _check_replicas(one, group)
        params, lead = one, ()
    else:
        params, lead = tree_map(lambda t: t.expand(dp, *t.shape).clone(), one), (dp,)
    del one
    opt = init_opt_state(params, lead=lead)
    if init_ef:
        opt["ef"] = tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                                   device=t.device), params)
    return params, opt


def placed(mesh) -> bool:
    """Whether the steps run placed: on a process mesh that holds a
    ``DeviceMesh`` (a model axis, a pod axis or ``flat_dp``)."""
    return getattr(mesh, "device_mesh", None) is not None


def _check_mesh(policy, mesh) -> None:
    if policy is None or bool(policy.flat_dp) != bool(getattr(mesh, "flat_dp", False)):
        raise ValueError("a placed step needs the policy of its mesh: flat_dp on both or "
                         "on neither (launch.mesh.lay_out_mesh)")


def _placed_state(cfg: ModelConfig, full: Tree, policy, mesh, init_ef: bool,
                  comm: str) -> tuple[Tree, dict]:
    _check_replicas(full, mesh.device_mesh.get_group("model"))
    _check_replicas(full, mesh.group)
    dm = mesh.device_mesh
    shapes = tf.param_shapes(cfg)
    p_specs = policy.param_specs(shapes)
    params = distribute_tree(full, p_specs, dm)
    del full
    o_specs = policy.opt_specs(opt_shapes(cfg, shapes))
    m_specs = o_specs["m"] if comm == "xla" else p_specs

    def zeros(specs):
        return distribute_tree(tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                                              device=mesh.device), shapes),
                               specs, dm)
    opt = {"m": zeros(m_specs), "v": zeros(m_specs),
           "step": distribute_tree(torch.zeros((), dtype=torch.int32, device=mesh.device),
                                   o_specs["step"], dm)}
    if init_ef:
        opt["ef"] = zeros(p_specs)
    return params, opt


def _check_replicas(params: Tree, group: dist.ProcessGroup) -> None:
    """Raise unless every rank of ``group`` holds rank 0's ``params``: each
    leaf's fp64 sum and sum of squares, rank 0's broadcast to all."""
    own = torch.stack([s for t in leaves(params)
                       for s in (t.double().sum(), t.double().square().sum())])
    if not torch.equal(collectives_dist.Wire(group).broadcast(own), own):
        raise RuntimeError(f"rank {dist.get_rank(group)}'s params from the seed differ from "
                           "rank 0's: the replicas would train apart")


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
                    device: Optional[torch.device] = None,
                    group: Optional[dist.ProcessGroup] = None,
                    policy=None, mesh=None) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, loss)``.

    Rank ``r`` takes the contiguous rows ``[r·B/dp, (r+1)·B/dp)`` of the
    global batch, as JAX's ``P("data")`` batch spec gives device ``r``.
    ``loss`` is the mean of the ranks' losses. With a process ``group`` of
    ``dp`` ranks, params and optimizer state are this rank's, with no rank
    axis, and every rank of the group calls the step with the global batch;
    the loss is meaned over the group (``jax.lax.pmean``'s twin).
    ``microbatches > 1`` accumulates fp32 gradients over that many slices of
    each rank's rows. Under ``xla`` with one process per rank, rank ``r``'s
    slice ``i`` is its ``1/dp`` share of the global batch's slice ``i``
    (:func:`microbatch_order`), as JAX's one program splits the global batch;
    a virtual rank or a LUMORPH comm's rank splits its own contiguous rows,
    as JAX's ``shard_map`` body does.
    ``overlap_chunks > 1`` (LUMORPH comms; ignored by ``xla``) runs every
    bucket's collective as that many chunked waves (overlap mode).
    After each call ``step.bucket_log`` holds the last (bytes, algo) log.

    On a process ``mesh`` that places the leaves (:func:`placed`; ``group``
    is then its gradient group, the data axes flattened, of ``dp`` ranks),
    the state is :func:`init_train_state`'s placed one and ``policy`` gives
    the batch specs: the batch is ``Shard(0)`` on the data axes and
    replicated on model. ``comm="xla"`` reduces the gradients over the data
    group with ``dist.all_reduce``, as GSPMD's psum; the LUMORPH
    comms bucket the global gradient and reduce each rank's model shard of
    every bucket over its data group. Under a ZeRO-3 policy every param is
    gathered over its data group for the forward; ``xla`` keeps the params
    and moments sharded over data (AdamW keeps each rank's data shard of the
    reduced gradient), while the LUMORPH comms gather the whole state at the
    first step and return it replicated over data, as JAX's ``shard_map``
    takes and gives it (``rep``); under ``compress`` each rank reduces its
    model group's whole leaves, so that the int8 blocks are JAX's, and keeps
    its shards.

    Under ``xla`` with ``dp > 1`` a model's MoE balance loss counts every
    data rank's rows, as JAX's one program over the global batch does
    (``models.moe.balance_over``; the virtual ranks run rank 0's equal
    replica over the global batch); the LUMORPH comms' per-rank program
    counts each rank's own.
    """
    if comm not in COMMS:
        raise ValueError(f"unknown comm {comm!r}; have {COMMS}")
    if group is not None and dist.get_world_size(group) != dp:
        raise ValueError(f"the step has {dp} ranks, the group {dist.get_world_size(group)}")
    opt_cfg = opt_cfg or AdamWConfig()
    dev = resolve_device(device)

    on_mesh = placed(mesh)
    if on_mesh:
        _check_mesh(policy, mesh)
        data_axes, flat = policy.axes.data, policy.flat_dp
    # JAX's xla step is one program over the global batch, whose MoE balance loss counts
    # every data rank's rows; the LUMORPH comms' per-rank program counts each rank's own
    global_balance = comm == "xla" and dp > 1 and any(k in ("moe", "mla_moe")
                                                      for k in cfg.block_pattern)
    balance = group if global_balance else None
    # JAX's xla step splits the global batch into microbatches; a process per rank
    # re-lays the rows so that its contiguous share holds its part of each
    relay = comm == "xla" and group is not None and dp > 1 and microbatches > 1

    def grad_fn(params, batch) -> tuple[torch.Tensor, list[torch.Tensor]]:
        plist = leaves(params)
        if microbatches == 1:
            loss = tf.loss_fn(params, batch, cfg)
            return loss.detach(), list(torch.autograd.grad(loss, plist))
        b = batch["tokens"].shape[0]
        if b % microbatches:
            raise ValueError(f"{b} rows per rank do not split into {microbatches} microbatches")
        loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        g_acc = [torch.zeros_like(p, dtype=torch.float32) for p in plist]
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
        if relay:
            order = microbatch_order(b, dp, microbatches).to(dev)
            batch = {k: v[order] for k, v in batch.items()}
        if on_mesh:
            return placed_step(params, opt_state, batch)
        with record_function("train/forward_backward"):
            if group is not None:
                loss, grads = local_grads(params, batch, rows)
            else:
                loss, grads = virtual_grads(params, batch, rows)
        grads = unflatten(params, grads)
        new_ef = None
        with record_function("train/grad_comm"):
            if comm == "xla" and group is not None:
                grads = tree_map(lambda g: collectives_dist.all_reduce(g, "psum", group) / dp,
                                 grads)
            elif comm == "xla":
                grads = tree_map(lambda g: (g.sum(dim=0, keepdim=True) / dp).expand_as(g),
                                 grads)
            else:
                grads, new_ef, step.bucket_log = grad_comm.all_reduce_grads(
                    grads, algo=comm, bucket_bytes=bucket_bytes, compress=compress,
                    error_feedback=opt_state.get("ef"), wire_dtype=wire_dtype,
                    overlap_chunks=overlap_chunks, group=group)
        core = {k: v for k, v in opt_state.items() if k != "ef"}
        with record_function("train/adamw"):
            params, core = adamw_update(params, grads, core, opt_cfg)
        if new_ef is not None:
            core["ef"] = new_ef
        return params, core, loss

    def virtual_grads(params, batch, rows):
        plist = leaves(params)
        if plist[0].shape[0] != dp:
            raise ValueError(f"params carry {plist[0].shape[0]} ranks, the step {dp}")
        if global_balance:  # the replicas are equal under xla: rank 0's over the global rows
            loss, g = grad_fn(unflatten(params, [t[0].detach().requires_grad_()
                                                 for t in plist]), batch)
            return loss, [t.expand(dp, *t.shape).clone() for t in g]
        losses, grads = [], None
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
        return torch.stack(losses).sum() / dp, grads  # pmean over the data axis

    def local_grads(params, batch, rows):
        r = dist.get_rank(group)
        p_r = tree_map(lambda t: t.detach().requires_grad_(), params)
        with moe_lib.balance_over(balance):
            loss_r, grads = grad_fn(p_r, {k: v[r * rows:(r + 1) * rows]
                                          for k, v in batch.items()})
        # pmean over the group: every rank's loss, summed in rank order as above
        losses = collectives_dist.Wire(group).all_gather(loss_r)
        return torch.stack(losses).sum() / dp, grads

    def placed_step(params, opt_state, batch):
        dm = mesh.device_mesh
        batch = distribute_tree(batch, policy.batch_specs(batch), dm)
        if comm != "xla":  # JAX's shard_map takes the state replicated over data (rep)
            params, opt_state = tree_map(lambda t: gather_data(t, data_axes),
                                         (params, opt_state))
        plist = leaves(params)
        with record_function("train/forward_backward"):
            # manual over data: this data rank's rows, and every leaf on the model group
            p_m = unflatten(params, [param_on_model(p, data_axes, flat).detach()
                                     .requires_grad_() for p in plist])
            # the positions, masks and constants the model makes enter replicated
            with implicit_replication(), moe_lib.balance_over(balance):
                loss_r, grads = grad_fn(p_m, {k: on_model(v, flat) for k, v in batch.items()})
            grads = [redistribute(g, [model_placement(p, flat)]).to_local()
                     for g, p in zip(grads, plist)]
            losses = collectives_dist.Wire(group).all_gather(loss_r.to_local())
            loss = torch.stack(losses).sum() / dp
        new_ef = None
        with record_function("train/grad_comm"):
            if comm == "xla":
                grads = [collectives_dist.all_reduce(g, "psum", group) / dp for g in grads]
            else:
                ef = opt_state.get("ef")
                ef = None if ef is None else [e.to_local() for e in leaves(ef)]
                shards = [_shard_of(p) for p in plist]
                if compress:
                    # JAX's shard_map body quantizes the global leaves' 256-element blocks:
                    # each rank reduces its model group's whole leaves, as at model 1
                    grads, shards = [_whole_over_model(g, p, flat)
                                     for g, p in zip(grads, plist)], None
                    ef = None if ef is None else [_whole_over_model(e, p, flat)
                                                  for e, p in zip(ef, plist)]
                red, new_ef, step.bucket_log = grad_comm.all_reduce_grads(
                    unflatten(params, grads), algo=comm, bucket_bytes=bucket_bytes,
                    compress=compress, wire_dtype=wire_dtype, overlap_chunks=overlap_chunks,
                    error_feedback=None if ef is None else unflatten(params, ef),
                    group=group, shards=shards)
                grads = leaves(red)
                if compress:  # this rank's shards of the whole leaves
                    grads = [place_like(g, p).to_local() for g, p in zip(grads, plist)]
                    if new_ef is not None:
                        new_ef = unflatten(params, [place_like(e, p).to_local() for e, p in
                                                    zip(leaves(new_ef), plist)])
        # whole over data: adamw_update takes the norm as without ZeRO-3, then keeps
        # this rank's data shard of each (the moments' placement), a local slice
        data = data_dims(dm, data_axes)
        grads = unflatten(params, [DTensor.from_local(
            g, dm, [Replicate() if i in data else pl for i, pl in enumerate(p.placements)],
            run_check=False) for g, p in zip(grads, plist)])
        core = {k: v for k, v in opt_state.items() if k != "ef"}
        with record_function("train/adamw"):
            params, core = adamw_update(params, grads, core, opt_cfg)
        if new_ef is not None:
            core["ef"] = tree_map(lambda e, like: DTensor.from_local(
                e, dm, like.placements, run_check=False), new_ef, opt_state["ef"])
        return params, core, loss

    step.bucket_log = []
    return step


def microbatch_order(b: int, dp: int, microbatches: int) -> torch.Tensor:
    """The global batch's rows re-laid so that rank ``r``'s contiguous rows
    ``[r·b/dp, (r+1)·b/dp)``, split into ``microbatches`` slices, give slice
    ``i`` as the global rows ``[i·b/m + r·b/(m·dp), i·b/m + (r+1)·b/(m·dp))``:
    rank ``r``'s share of JAX's global microbatch ``i``."""
    if b % (dp * microbatches):
        raise ValueError(f"a global batch of {b} does not split into {microbatches} "
                         f"microbatches over {dp} ranks")
    return torch.arange(b).reshape(microbatches, dp, -1).transpose(0, 1).flatten()


def model_placement(t: DTensor, flat_dp: bool = False):
    """``t``'s placement on the ``"model"`` mesh dim, read by name: its
    tensor-parallel split. Under ``flat_dp`` the model axis carries data and
    TP is 1, so the step sees every leaf whole there: ``Replicate()``."""
    if flat_dp:
        return Replicate()
    return t.placements[t.device_mesh.mesh_dim_names.index("model")]


def on_model(t: DTensor, flat_dp: bool = False) -> DTensor:
    """A leaf of the process mesh as a DTensor on this rank's model group, its
    local tensor unchanged: this data rank's own copy (a param replicated
    over the data axes) or rows (a batch sharded over them). Under
    ``flat_dp`` the model group splits only data, so each rank's rows and
    whole params are ``Replicate()`` there, and no op on it moves a byte:
    the step is manual over every mesh dim, as JAX's ``shard_map`` over
    ``("data", "model")``."""
    return DTensor.from_local(t.to_local(), t.device_mesh["model"],
                              [model_placement(t, flat_dp)], run_check=False)


def param_on_model(t: DTensor, data_axes: Optional[tuple[str, ...]] = None,
                   flat_dp: bool = False) -> DTensor:
    """A param on this rank's model group, whole over the data axes: a ZeRO-3
    leaf is gathered over them first (``sharding.policy.gather_data``)."""
    return on_model(gather_data(t, data_axes), flat_dp)


def _whole_over_model(local: torch.Tensor, like: DTensor, flat_dp: bool) -> torch.Tensor:
    """The whole leaf over the model group of ``local``, this rank's model
    shard of a leaf placed as ``like`` (whole over data)."""
    pl = model_placement(like, flat_dp)
    if not pl.is_shard():
        return local
    return replicated(DTensor.from_local(local, like.device_mesh["model"], [pl],
                                         run_check=False)).to_local()


def _over_mesh(local: torch.Tensor, data_like: DTensor, model_pl, data_axes) -> DTensor:
    """``local`` as a DTensor on ``data_like``'s mesh: placed as ``data_like``
    on the data axes (the rows of a batch) and as ``model_pl`` on the model
    dim, where that is not a data axis."""
    dm = data_like.device_mesh
    return DTensor.from_local(local, dm, [pl if name in data_axes else model_pl for name, pl in
                                          zip(dm.mesh_dim_names, data_like.placements)],
                              run_check=False)


def _shard_of(t: DTensor) -> grad_comm.Shard:
    """Where ``t``'s local tensor lies in the global leaf."""
    return grad_comm.Shard(tuple(t.shape), local_offsets(t))


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------


def make_prefill(cfg: ModelConfig, device: Optional[torch.device] = None,
                 policy=None, mesh=None) -> Callable:
    """``prefill(params, batch) -> logits [B,S,V]`` on ``device`` (default cuda).

    On a process ``mesh`` with a model axis, tensor-parallel: the params are
    placed by ``policy``'s param specs (full tensors on the way in, every
    rank keeping its shard; placed ones as they are), the batch is
    ``Shard(0)`` on data, and each data rank runs its rows on its model
    group, every rank's attention on its own heads (with ``cfg.use_pallas``,
    the flash kernel on the local ``[B, S, H/tp, D]``). The logits come back
    as a DTensor on the mesh (vocab-sharded where ``lm_head`` is);
    ``full_tensor()``, collective, gathers them."""
    dev = resolve_device(device)
    if placed(mesh):
        return _placed_prefill(cfg, policy, mesh)

    @torch.inference_mode()
    def prefill(params, batch):
        batch = {k: v.to(dev) for k, v in batch.items()}
        logits, _ = tf.forward_logits(params, batch, cfg)
        return logits

    return prefill


def _placed_prefill(cfg: ModelConfig, policy, mesh) -> Callable:
    _check_mesh(policy, mesh)
    dm, axes, flat = mesh.device_mesh, policy.axes.data, policy.flat_dp
    p_specs = policy.param_specs(tf.param_shapes(cfg))

    @torch.no_grad()  # not inference mode: DTensor views of placed params need versions
    def prefill(params, batch):
        if not isinstance(leaves(params)[0], DTensor):
            params = distribute_tree(params, p_specs, dm)
        batch = {k: v.to(mesh.device) for k, v in batch.items()}
        batch = distribute_tree(batch, policy.batch_specs(batch), dm)
        with implicit_replication():
            logits, _ = tf.forward_logits(
                tree_map(lambda t: param_on_model(t, axes, flat), params),
                {k: on_model(v, flat) for k, v in batch.items()}, cfg)
        return _over_mesh(logits.to_local(), batch["tokens"], logits.placements[0], axes)

    return prefill


def make_encode(cfg: ModelConfig, device: Optional[torch.device] = None,
                policy=None, mesh=None) -> Callable:
    """``encode(params, frames [B, S_enc, D]) -> enc_out [B, S_enc, D]``:
    whisper's encoder, once per request, for ``tf.fill_cross_caches``.

    On a process ``mesh`` with a model axis, placed as :func:`make_prefill`
    places the prefill (with ``cfg.use_pallas``, the flash kernel on each
    rank's heads, or on all of them where the policy replicates the
    attention); ``enc_out`` comes back a DTensor on the mesh, its rows over
    data as the frames' batch spec splits them and whole over model."""
    dev = resolve_device(device)
    if not placed(mesh):
        @torch.inference_mode()
        def encode(params, frames):
            return tf.encoder_forward(params["encoder"], frames.to(dev), cfg)
        return encode
    _check_mesh(policy, mesh)
    dm, axes, flat = mesh.device_mesh, policy.axes.data, policy.flat_dp
    p_specs = policy.param_specs(tf.param_shapes(cfg))

    @torch.no_grad()
    def encode(params, frames):
        if not isinstance(leaves(params)[0], DTensor):
            params = distribute_tree(params, p_specs, dm)
        frames = place(frames.to(mesh.device), policy.batch_spec("frames", tuple(frames.shape)),
                       dm)
        with implicit_replication():
            out = tf.encoder_forward(
                tree_map(lambda t: param_on_model(t, axes, flat), params["encoder"]),
                on_model(frames, flat), cfg)
        return _over_mesh(out.to_local(), frames, out.placements[0], axes)

    return encode


def make_decode_step(cfg: ModelConfig, device: Optional[torch.device] = None,
                     policy=None, mesh=None, batch: Optional[int] = None,
                     max_len: Optional[int] = None) -> Callable:
    """``decode(params, caches, tokens [B,1], position) -> (logits, caches)``;
    the caches are updated in place.

    On a process ``mesh`` with a model axis, as JAX's ``make_decode_step``
    on its mesh: the params are placed by ``policy``'s param specs and the
    caches (of ``batch`` rows and ``max_len`` positions) by its cache specs,
    whole tensors on the way in and placed ones kept as they are
    (:func:`init_placed_caches` makes them placed). The tokens are split
    over the data axes as the caches' rows are (also where ``replicate_batch``
    replicates the batch's spec), and each data rank decodes its rows on its
    model group: ZeRO-3 params gathered over data, every
    attention on its own heads and slots
    (:func:`repro_torch.models.attention.placed_decode_attention`). The
    caches come back placed, the logits as a DTensor on the mesh
    (vocab-sharded where ``lm_head`` is)."""
    dev = resolve_device(device)
    if placed(mesh):
        return _placed_decode(cfg, policy, mesh, batch, max_len)

    @torch.inference_mode()
    def decode(params, caches, tokens, position: int):
        return tf.decode_step(params, caches, tokens.to(dev), position, cfg)

    return decode


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> list:
    """The decode caches on the meta device: every leaf's shape and dtype,
    the twin of JAX's ``eval_shape`` of ``init_caches``."""
    return tf.init_caches(cfg, batch, max_len, META)


def init_placed_caches(cfg: ModelConfig, policy, mesh, batch: int, max_len: int) -> list:
    """Empty decode caches placed by ``policy``'s cache specs on ``mesh``,
    filled as ``tf.init_caches`` fills them: each rank makes its own shard
    of every leaf, and no rank the whole cache (a whisper cross pair stays
    zero until ``tf.fill_cross_caches`` writes each rank's heads)."""
    shapes = cache_shapes(cfg, batch, max_len)
    specs = policy.cache_specs(shapes)
    # every leaf of a fresh cache is one constant (the positions -1, mLSTM's m -inf,
    # sLSTM's n 1, the rest 0)
    fills = tree_map(lambda t: t.flatten()[0].item(), tf.init_caches(cfg, 1, 1, "cpu"))

    def placed(t, fill, spec):
        if isinstance(t, dict):  # a whisper layer nests its self-attention cache
            return {k: placed(t[k], fill[k], spec[k]) for k in t}
        return place_filled(tuple(t.shape), fill, t.dtype, spec, mesh.device_mesh, mesh.device)
    return [placed(*layer) for layer in zip(shapes, fills, specs)]


def _placed_decode(cfg: ModelConfig, policy, mesh, batch: Optional[int],
                   max_len: Optional[int]) -> Callable:
    if batch is None or max_len is None:
        raise ValueError("a placed decode step needs the caches' batch and max_len")
    _check_mesh(policy, mesh)
    dm, axes, flat = mesh.device_mesh, policy.axes.data, policy.flat_dp
    p_specs = policy.param_specs(tf.param_shapes(cfg))
    shapes = cache_shapes(cfg, batch, max_len)
    c_specs = policy.cache_specs(shapes)
    rows = policy.dp_entry if batch % policy.dp == 0 else None

    @torch.no_grad()  # not inference mode: DTensor views of placed params need versions
    def decode(params, caches, tokens, position: int):
        if not isinstance(leaves(params)[0], DTensor):
            params = distribute_tree(params, p_specs, dm)
        if not isinstance(leaves(caches)[0], DTensor):
            if [t.shape for t in leaves(caches)] != [t.shape for t in leaves(shapes)]:
                raise ValueError(f"the caches are not those of batch {batch} and max_len "
                                 f"{max_len} that the step was made for")
            caches = distribute_tree(caches, c_specs, dm)
        # the tokens' rows as the caches hold them (cache_spec's batch rule): under
        # replicate_batch too, each rank decodes the rows of its own caches
        tokens = place(tokens.to(mesh.device), (rows, None), dm)
        with implicit_replication():
            logits, caches = tf.decode_step(
                tree_map(lambda t: param_on_model(t, axes, flat), params), caches,
                on_model(tokens, flat), position, cfg)
        return _over_mesh(logits.to_local(), tokens, logits.placements[0], axes), caches

    return decode
