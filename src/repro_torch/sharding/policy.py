"""Per-architecture sharding policy, rule for rule the JAX package's.

The port's copy of ``repro.sharding.policy``. It decides, per parameter,
optimizer, batch and cache leaf, which mesh axes shard which dimension:

  * **TP** over the "model" axis: attention heads (when divisible), MLP
    d_ff, MoE experts (expert parallelism), vocab for embeddings.
  * **KV replication** when ``n_kv_heads % tp != 0`` (Megatron GQA rule).
  * **Replicated mixers** for small-model blocks whose head counts don't
    divide (xlstm 4H, whisper 6H, phi3 40H attention); the model axis
    still shards their embeddings and MLPs.
  * **ZeRO-1** always: optimizer moments shard over the data axes on the
    largest divisible dim not already sharded.
  * **ZeRO-3** optionally (``make_policy``'s rule: bf16 params past 12 GB
    per model shard): parameters themselves also shard over the data axes.

A spec is a tuple with one entry per tensor dim. Each entry is ``None``,
an axis name, or a tuple of axis names: a ``PartitionSpec``'s own entries,
so a spec compares with the reference's entry for entry. Leaves are keyed
by the ``/``-joined paths of ``bridge.flatten_with_paths``, which are the
reference's pytree path strings. The mesh is anything with a ``shape``
mapping axis names to sizes: a :class:`MeshShape` (``launch.mesh``'s
production meshes) or the virtual data-parallel mesh, so the policy needs
no process group. :func:`to_placements` turns a spec into the DTensor
placements of a ``DeviceMesh`` with the same axes; :func:`distribute_tree`
places a tree of full tensors by a tree of specs, every rank keeping its
own shard, and :func:`gather_tree` gathers it back. :func:`redistribute`
is the port's one way to move a DTensor to other placements: under gloo it
runs a CUDA DTensor's all-gathers through host memory. :func:`gather_data`
gathers a ZeRO-3 leaf over the data axes for use, :func:`flat_group` is
the group of several mesh dims as one axis, :func:`local_offsets` says
where a rank's shard lies in its leaf, and :func:`place_filled` makes a
constant leaf's shard alone (an empty decode cache).

The collective profiles at the end (``derive_tp``, ``collective_profile``,
``zoo_profiles``) describe what one training step of each architecture
puts on the fabric; their algorithm hints are α–β model outputs of the
paper's link constants (``core.cost_model``), not measurements.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.bridge import flatten_with_paths
from repro_torch.configs.base import ModelConfig
from repro_torch.tree import tree_map, unflatten

Tree = Any
Entry = Optional["str | tuple[str, ...]"]
Spec = tuple


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A device mesh's axes and sizes, with no devices behind it."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.axis_sizes)} sizes")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    data: tuple[str, ...]  # ("data",) or ("pod", "data")
    model: str = "model"


def _size(mesh, axes: "tuple[str, ...] | str") -> int:
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


@dataclasses.dataclass
class ShardingPolicy:
    cfg: ModelConfig
    mesh: Any  # MeshShape, or anything with a ``shape`` mapping
    axes: MeshAxes
    zero3: bool = False
    #: use the model axis as extra data parallelism (small models where
    #: 16-way TP only buys activation all-reduces)
    flat_dp: bool = False
    #: replicate the batch (weight-stationary serving: tiny decode
    #: activations move, multi-hundred-GB params stay put)
    replicate_batch: bool = False

    # ------------------------------------------------------------------ utils
    @property
    def tp(self) -> int:
        return 1 if self.flat_dp else _size(self.mesh, self.axes.model)

    @property
    def dp(self) -> int:
        return _size(self.mesh, self.axes.data)

    @property
    def dp_entry(self):
        """Data axes as one spec entry: the bare name when single, a tuple
        otherwise (the reference's canonical PartitionSpec entry)."""
        return self.axes.data if len(self.axes.data) > 1 else self.axes.data[0]

    def _dp_dim(self, shape: tuple[int, ...], taken: set[int]) -> Optional[int]:
        """Largest dim divisible by dp and not already sharded."""
        best = None
        for i, s in enumerate(shape):
            if i in taken or s % self.dp or s == 0:
                continue
            if best is None or s > shape[best]:
                best = i
        return best

    # ----------------------------------------------------------------- params
    def param_spec(self, path: str, shape: tuple[int, ...]) -> Spec:
        """Spec for one parameter leaf, by its path string.

        Stacked segment params carry a leading layer dim (path part
        "segments" or "layers"), which is never sharded.
        """
        cfg, tp = self.cfg, self.tp
        model = None if self.flat_dp else self.axes.model  # flat_dp: no TP
        parts = path.split("/")
        stacked = "segments" in parts or "layers" in parts
        off = 1 if stacked else 0  # skip the layer-stack dim

        def spec(*dims: Entry) -> Spec:
            out = [None] * off + list(dims)
            out = out[: len(shape)] + [None] * (len(shape) - len(out))
            if self.zero3:
                taken = {i for i, d in enumerate(out) if d is not None}
                i = self._dp_dim(shape, taken)
                if i is not None:
                    out[i] = self.dp_entry
            return tuple(out)

        heads_div = cfg.n_heads % tp == 0
        kv_div = cfg.n_kv_heads % tp == 0 and cfg.n_kv_heads > 0

        leaf = path.split("/")[-1]
        # -- embeddings -----------------------------------------------------
        if path == "embed":
            if cfg.vocab_size % tp == 0:
                return spec_noff(shape, (model, None), self)
            return spec_noff(shape, (None, None), self)
        if path == "lm_head":
            return spec_noff(shape, (None, model if cfg.vocab_size % tp == 0 else None), self)
        if leaf in ("w", "b") or "ln" in path or "norm" in path:
            return (None,) * len(shape)  # norms replicated
        # -- attention ------------------------------------------------------
        if "/attn/" in path or "/xattn/" in path:
            if leaf in ("wq",):
                return spec(None, model if heads_div else None, None)
            if leaf in ("wk", "wv"):
                return spec(None, model if (heads_div and kv_div) else None, None)
            if leaf == "wo":
                return spec(model if heads_div else None, None, None)
            if leaf == "bq":
                return spec(model if heads_div else None, None)
            if leaf in ("bk", "bv"):
                return spec(model if (heads_div and kv_div) else None, None)
            # MLA leaves
            if leaf == "w_dkv":
                return spec(None, None)  # latent rank kept whole (cache layout)
            if leaf == "w_kpe":
                return spec(None, None)
            if leaf in ("w_uk", "w_uv"):
                return spec(None, model if heads_div else None, None)
        # -- MLP --------------------------------------------------------------
        if "/mlp/" in path or ("shared" in path and leaf in ("wi", "wg", "wo")):
            if leaf in ("wi", "wg"):
                return spec(None, model)
            if leaf == "wo":
                return spec(model, None)
        # -- MoE --------------------------------------------------------------
        if "/moe/" in path:
            ep = cfg.moe_experts % tp == 0 and cfg.moe_experts > 0
            if leaf == "router":
                return spec(None, None)
            if leaf in ("wi", "wg"):
                return spec(model if ep else None, None, None)
            if leaf == "wo":
                return spec(model if ep else None, None, None)
        # -- mamba2 / xlstm mixers -------------------------------------------
        if "/mix/" in path:
            # replicated over model (small models; head counts don't divide);
            # ZeRO-3/ZeRO-1 still shard them over data
            return spec(*([None] * (len(shape) - off)))
        if leaf == "shared_proj":
            return spec(None, None)
        return spec(*([None] * (len(shape) - off)))

    def param_specs(self, shapes: Tree) -> Tree:
        return _map_with_path(shapes, self.param_spec)

    # ------------------------------------------------------------- optimizer
    def opt_spec(self, path: str, shape: tuple[int, ...]) -> Spec:
        """ZeRO-1: like the param spec, plus data axes on a free dim."""
        parts = path.split("/")
        if parts and parts[0] in ("m", "v", "ef"):
            path = "/".join(parts[1:])  # moments mirror the param tree
        if path == "step" or not shape:
            return ()
        base = self.param_spec(path, shape)
        dims = list(base) + [None] * (len(shape) - len(base))
        used: set[str] = set()
        for d in dims:
            if d is None:
                continue
            used.update(d if isinstance(d, (tuple, list)) else (d,))
        if used & set(self.axes.data):
            return tuple(dims)  # zero3 already placed the data axes
        taken = {i for i, d in enumerate(dims) if d is not None}
        i = self._dp_dim(shape, taken)
        if i is not None:
            dims[i] = self.dp_entry
        return tuple(dims)

    def opt_specs(self, shapes: Tree) -> Tree:
        return _map_with_path(shapes, self.opt_spec)

    # ----------------------------------------------------------------- batch
    def batch_spec(self, name: str, shape: tuple[int, ...]) -> Spec:
        if self.replicate_batch:
            return (None,) * len(shape)
        dp = self.dp_entry
        b = shape[0] if shape else 0
        if b and b % self.dp == 0:
            return (dp,) + (None,) * (len(shape) - 1)
        return (None,) * len(shape)  # e.g. long_500k batch=1

    def batch_specs(self, batch_shapes: dict) -> dict:
        return {k: self.batch_spec(k, tuple(v.shape)) for k, v in batch_shapes.items()}

    # ----------------------------------------------------------------- caches
    def cache_spec(self, path: str, shape: tuple[int, ...]) -> Spec:
        """Decode caches: batch over data; kv-heads/ssm-heads over model when
        divisible; long-context (batch=1) KV shards the sequence dim over
        data instead."""
        cfg, tp, model = self.cfg, self.tp, self.axes.model
        dp = self.dp_entry
        dims: list = [None] * len(shape)
        b = shape[0]
        if b % self.dp == 0:
            dims[0] = dp
            batch_sharded = True
        else:
            batch_sharded = False
        leaf = path.split("/")[-1]
        if leaf in ("k_scale", "v_scale") and len(shape) == 3:
            # int8 KV scales follow the payload's (batch, seq) sharding
            if cfg.n_kv_heads % tp != 0 and not self.flat_dp and shape[1] % tp == 0:
                dims[1] = model
            return tuple(dims)
        if leaf in ("k", "v") and len(shape) == 4:
            if cfg.n_kv_heads % tp == 0 and not self.flat_dp:
                dims[2] = model
            elif not self.flat_dp and shape[1] % tp == 0:
                # kv heads don't divide → shard the *sequence* over the model
                # axis instead (decode attention reduces over seq)
                dims[1] = model
            if not batch_sharded and shape[1] % self.dp == 0 and dims[1] is None:
                dims[1] = dp  # shard a long sequence over data
        if leaf in ("cross_k", "cross_v") and len(shape) == 4:
            if cfg.n_heads % tp == 0 and not self.flat_dp:
                dims[2] = model
        if leaf == "c_kv" and len(shape) == 3:
            if not self.flat_dp and shape[1] % tp == 0:
                dims[1] = model  # MLA latent cache: seq over model
            elif not batch_sharded and shape[1] % self.dp == 0:
                dims[1] = dp
        if leaf == "h" and len(shape) == 4:  # mamba2 state [B,H,P,N]
            nheads = shape[1]
            if nheads % tp == 0:
                dims[1] = model
        if leaf == "C" and len(shape) == 4:  # mlstm matrix memory
            if shape[1] % tp == 0:
                dims[1] = model
        if leaf == "pos" and len(shape) == 2:
            if not batch_sharded and shape[1] % self.dp == 0:
                dims[1] = dp
        return tuple(dims)

    def cache_specs(self, cache_shapes: Tree) -> Tree:
        return _map_with_path(cache_shapes, self.cache_spec)

    # ----------------------------------------------------------------- checks
    def check_divides(self, shapes: Tree, spec_fn) -> None:
        """Raise ``ValueError`` naming the first leaf of ``shapes`` whose spec
        (``spec_fn(path, shape)``, e.g. :meth:`param_spec`) shards a dim that
        its mesh axes do not divide."""
        for path, leaf in flatten_with_paths(shapes):
            shape = tuple(leaf.shape)
            for dim, (size, entry) in enumerate(zip(shape, spec_fn(path, shape))):
                if entry is not None and size % _size(self.mesh, entry):
                    raise ValueError(f"{path}: dim {dim} of {shape} does not split over "
                                     f"{entry!r} ({_size(self.mesh, entry)} ways)")


def spec_noff(shape, dims, policy: ShardingPolicy) -> Spec:
    """Spec helper for non-stacked leaves, honoring ZeRO-3."""
    out = list(dims)[: len(shape)] + [None] * (len(shape) - len(dims))
    if policy.zero3:
        taken = {i for i, d in enumerate(out) if d is not None}
        i = policy._dp_dim(shape, taken)
        if i is not None:
            out[i] = policy.dp_entry
    return tuple(out)


def _map_with_path(tree: Tree, fn, prefix: str = "") -> Tree:
    """``fn(path, shape)`` at every leaf, in a tree of the same nesting."""
    if isinstance(tree, dict):
        return {k: _map_with_path(v, fn, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(v, fn, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tuple(tree.shape))


def to_placements(spec: Spec, mesh_axis_names: tuple[str, ...]) -> list:
    """The DTensor placements of ``spec`` on a ``DeviceMesh`` with axes
    ``mesh_axis_names``: one per mesh axis, ``Shard(dim)`` where the spec
    names that axis on tensor dim ``dim`` (alone or in a tuple, major axis
    first, as a PartitionSpec orders it), ``Replicate()`` where it names
    it nowhere."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of: dict[str, int] = {}
    for dim, entry in enumerate(spec):
        for name in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
            if name in dim_of:
                raise ValueError(
                    f"spec {spec!r} names mesh axis {name!r} twice: no layout places it, and "
                    "the JAX package refuses it too (DuplicateSpecError); flat_dp's "
                    "mamba2/mLSTM state puts its heads on model beside a batch over "
                    "('data', 'model')")
            dim_of[name] = dim
    unknown = set(dim_of) - set(mesh_axis_names)
    if unknown:
        raise ValueError(f"spec {spec!r} names axes {sorted(unknown)} that the mesh "
                         f"{mesh_axis_names!r} lacks")
    return [Shard(dim_of[a]) if a in dim_of else Replicate() for a in mesh_axis_names]


def _spec_pairs(tree: Tree, spec_tree: Tree) -> list[tuple[Any, Spec]]:
    """(leaf, spec) pairs of a tree and its spec tree, in leaf order: a spec
    is a tuple, so the walk follows ``tree``'s nesting, not the spec's."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in _spec_pairs(tree[k], spec_tree[k])]
    if isinstance(tree, (list, tuple)):
        return [pair for v, s in zip(tree, spec_tree) for pair in _spec_pairs(v, s)]
    return [(tree, spec_tree)]


def place(full, spec: Spec, device_mesh):
    """``full`` (the same tensor on every rank) as a DTensor on ``device_mesh``
    placed by ``spec``: this rank keeps a copy of its own shard, and nothing
    crosses the wire. A replicated leaf is kept as it is. A dim split over
    two mesh axes at once (the multi-pod mesh's ``("pod", "data")``,
    ``flat_dp``'s ``("data", "model")``) is cut major axis first, as a
    PartitionSpec cuts it (:func:`_placements`)."""
    return _placed(full, _placements(spec, device_mesh), device_mesh)


def place_filled(shape: tuple[int, ...], fill, dtype, spec: Spec, device_mesh, device):
    """A DTensor of ``shape`` whose every entry is ``fill``, placed by
    ``spec`` as :func:`place` places it: this rank makes its own shard
    alone, and no rank ever holds the whole leaf."""
    placements = _placements(spec, device_mesh)
    local = list(shape)
    for i, pl in enumerate(placements):
        if pl.is_shard():
            n = device_mesh.size(i)
            if local[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(shape)} does not split "
                                 f"{n} ways over {device_mesh.mesh_dim_names[i]!r}")
            local[pl.dim] //= n
    return DTensor.from_local(torch.full(local, fill, dtype=dtype, device=device), device_mesh,
                              placements, run_check=False)


def _placements(spec: Spec, device_mesh) -> list:
    """:func:`to_placements` on ``device_mesh``. An entry that names two mesh
    axes gives ``Shard(dim)`` on each, and DTensor then splits the dim over
    the first mesh dim, then each piece over the next: the entry's order
    when its axes come in mesh order, as every spec of the policy names
    them. An entry out of mesh order would need another layout
    (``_StridedShard``) and raises."""
    names = tuple(device_mesh.mesh_dim_names)
    for entry in spec:
        if isinstance(entry, (tuple, list)) and len(entry) > 1:
            at = [names.index(a) for a in entry if a in names]
            if at != sorted(at):
                raise ValueError(f"spec {spec!r} splits one dim over the mesh axes "
                                 f"{tuple(entry)} out of the mesh's order {names}")
    return to_placements(spec, names)


def place_like(full, like):
    """``full`` placed as the DTensor ``like`` is."""
    return _placed(full, list(like.placements), like.device_mesh)


def _placed(full, placements: list, device_mesh):
    """``full`` cut to this rank's shard: mesh dim by mesh dim, each cutting
    what the dims before it left (DTensor's order for a tensor dim that
    several mesh dims split)."""
    local = full
    for i, pl in enumerate(placements):
        if pl.is_shard():
            n, size = device_mesh.size(i), local.shape[pl.dim]
            if size % n:
                raise ValueError(f"dim {pl.dim} of {tuple(full.shape)} does not split "
                                 f"{n} ways over {device_mesh.mesh_dim_names[i]!r}")
            local = local.narrow(pl.dim, device_mesh.get_local_rank(i) * (size // n), size // n)
    if local is not full:
        local = local.clone()  # the shard alone, so that the full leaf can be freed
    return DTensor.from_local(local, device_mesh, placements, run_check=False)


def flat_group(device_mesh, names: tuple[str, ...]):
    """The process group of ``device_mesh``'s dims ``names`` taken as one axis,
    the first dim major: its ranks are this rank's peers on those dims, in
    the order of JAX's combined axis index over them (``("pod", "data")``).
    One name is that dim's own group. Collective the first time: every rank
    of the mesh calls it."""
    if len(names) == 1:
        return device_mesh.get_group(names[0])
    return device_mesh[tuple(names)]._flatten().get_group()


def _host_mesh(device_mesh):
    """A CPU twin of ``device_mesh``: the same ranks and the same groups."""
    return _host_twin(tuple(device_mesh.get_group(i) for i in range(device_mesh.ndim)),
                      tuple(device_mesh.mesh.flatten().tolist()), tuple(device_mesh.mesh.shape),
                      device_mesh.mesh_dim_names)


@functools.lru_cache(maxsize=16)
def _host_twin(groups: tuple, ranks: tuple, shape: tuple, names):
    return DeviceMesh.from_group(list(groups) if len(groups) > 1 else groups[0], "cpu",
                                 mesh=torch.tensor(ranks).reshape(shape), mesh_dim_names=names)


def redistribute(t, placements):
    """``t.redistribute(placements=placements)``, differentiable. Under gloo,
    a CUDA DTensor that an all-gather reaches (a ``Shard`` made
    ``Replicate``) is redistributed on a CPU twin of its mesh and copied
    back, as ``core.collectives_dist.Wire`` stages a payload: gloo's
    all-gather of CUDA tensors inside DTensor's functional collectives kills
    the process (torch 2.11 on an H100), while its all-reduce and
    reduce-scatter of them run. The backend is the caller's choice; nothing
    here switches it or retries."""
    mesh = t.device_mesh
    gathers = any(a.is_shard() and not b.is_shard() for a, b in zip(t.placements, placements))
    staged = (t.device.type == "cuda" and gathers
              and any(dist.get_backend(mesh.get_group(i)) == "gloo" for i in range(mesh.ndim)))
    if not staged:
        return t.redistribute(placements=placements)
    host = DTensor.from_local(t.to_local().cpu(), _host_mesh(mesh), t.placements,
                              run_check=False).redistribute(placements=placements)
    return DTensor.from_local(host.to_local().to(t.device), mesh, placements, run_check=False)


def replicated(t):
    """``t`` replicated over every mesh dim that shards it (:func:`redistribute`)."""
    return redistribute(t, [Replicate() if p.is_shard() else p for p in t.placements])


def data_dims(device_mesh, axes: Optional[tuple[str, ...]] = None) -> list[int]:
    """The indices of ``device_mesh``'s dims named in ``axes`` (the policy's
    ``axes.data``); by default every dim but ``"model"``."""
    names = tuple(device_mesh.mesh_dim_names)
    return [i for i, n in enumerate(names) if (n != "model" if axes is None else n in axes)]


def gather_data(t, axes: Optional[tuple[str, ...]] = None):
    """A leaf replicated over the data axes ``axes`` (the policy's
    ``axes.data``; by default every mesh dim but ``"model"``), every other
    placement kept: a ZeRO-3 param (or moment) gathered for use
    (:func:`redistribute`). A leaf that no data axis shards comes back as
    it is. A gradient goes the other way with no wire: redistributing a
    leaf replicated over data to a ``Shard`` over data keeps this rank's
    slice, as ``optim.adamw`` does for the moments' placement."""
    dims = [i for i in data_dims(t.device_mesh, axes) if t.placements[i].is_shard()]
    if not dims:
        return t
    return redistribute(t, [Replicate() if i in dims else pl
                            for i, pl in enumerate(t.placements)])


def local_offsets(t) -> tuple[int, ...]:
    """Where the local tensor of ``t`` (placed evenly, as :func:`place`
    places) starts in the global leaf, per dim: a dim split over several
    mesh dims takes them major first, so the shard's index along it is
    their local ranks read as the digits of one number."""
    index = [0] * t.dim()
    for i, pl in enumerate(t.placements):
        if pl.is_shard():
            index[pl.dim] = index[pl.dim] * t.device_mesh.size(i) + \
                t.device_mesh.get_local_rank(i)
    return tuple(k * n for k, n in zip(index, t.to_local().shape))


def distribute_tree(tree: Tree, spec_tree: Tree, device_mesh) -> Tree:
    """Every leaf of ``tree`` placed by its spec in ``spec_tree`` (:func:`place`)."""
    return unflatten(tree, [place(t, s, device_mesh) for t, s in _spec_pairs(tree, spec_tree)])


def gather_tree(tree: Tree) -> Tree:
    """Every DTensor leaf of ``tree`` as its full tensor. Collective: every
    rank of the leaves' mesh calls it."""
    return tree_map(lambda t: redistribute(t, [Replicate()] * t.device_mesh.ndim).to_local()
                    if isinstance(t, DTensor) else t, tree)


# ---------------------------------------------------------------------------
# Collective profiles (simulator workloads)
# ---------------------------------------------------------------------------

#: Deployment heuristic for a tenant's TP degree: the reference's v5e-class
#: HBM budget that a rank's parameter shard must fit (mirrors
#: ``make_policy``'s ZeRO-3 rule), and the largest on-server TP the rack's
#: 8-tile servers support. Kept as the reference has them, so that the
#: profiles are the JAX package's; they size no H100 deployment.
PROFILE_HBM_BYTES = 16e9
PROFILE_MAX_TP = 8
#: DDP-style gradient bucket target (≈ the 25 MB torch default, rounded to
#: a power of two) and a cap so rack-scale models keep pricing cheap.
PROFILE_BUCKET_BYTES = 32 << 20
PROFILE_MAX_BUCKETS = 8
#: Reference tokens per step for the TP activation stream and reference DP
#: width for the per-bucket algorithm hints.
PROFILE_TOKENS_PER_STEP = 4096
PROFILE_REF_DP = 8


def _block_tp_sharded(cfg: ModelConfig, kind: str, tp: int) -> bool:
    """Whether ``param_spec`` shards this block kind over a ``tp``-way
    model axis (block granularity: the attention/MLP/MoE divisibility
    rules; SSM/xLSTM mixers always replicate)."""
    heads_div = cfg.n_heads > 0 and cfg.n_heads % tp == 0
    if kind in ("mamba2", "mlstm", "slstm"):
        return False
    if kind in ("moe", "mla_moe"):
        return cfg.moe_experts > 0 and cfg.moe_experts % tp == 0
    if kind in ("dense", "mla_dense"):
        return heads_div or (cfg.d_ff > 0 and cfg.d_ff % tp == 0)
    return False


def _tp_sharded_fraction(cfg: ModelConfig, tp: int) -> float:
    """Fraction of parameters a ``tp``-way model axis shards, mirroring
    ``ShardingPolicy.param_spec`` at block granularity (embeddings follow
    vocab divisibility; replicated-mixer blocks contribute nothing)."""
    if tp <= 1:
        return 0.0
    total = cfg.param_count()
    if total == 0:
        return 0.0
    sharded = 0
    if cfg.vocab_size % tp == 0:
        sharded += cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    for kind in cfg.block_pattern:
        if _block_tp_sharded(cfg, kind, tp):
            sharded += cfg._block_params(kind)
    if cfg.shared_attn_every and _block_tp_sharded(cfg, "dense", tp):
        sharded += cfg._block_params("dense")
    return min(1.0, sharded / total)


def derive_tp(cfg: ModelConfig, dtype_bytes: int = 2,
              hbm_bytes: float = PROFILE_HBM_BYTES,
              max_tp: int = PROFILE_MAX_TP) -> int:
    """Smallest power-of-two TP degree whose per-rank parameter shard fits
    the HBM budget (capped at one server's tiles). Models whose params
    barely shard (replicated mixers) stop growing ``tp`` once extra ways
    stop shrinking the shard."""
    def per_rank(t: int) -> float:
        frac = _tp_sharded_fraction(cfg, t)
        return cfg.param_count() * dtype_bytes * (1.0 - frac + frac / t)

    tp = 1
    while tp < max_tp and per_rank(tp) > hbm_bytes:
        if per_rank(tp * 2) >= per_rank(tp):
            break  # wider TP shrinks nothing more (e.g. pure-SSM stacks)
        tp *= 2
    return tp


def collective_profile(cfg: ModelConfig, *, tp: Optional[int] = None,
                       dtype_bytes: int = 2,
                       bucket_bytes: int = PROFILE_BUCKET_BYTES,
                       max_buckets: int = PROFILE_MAX_BUCKETS,
                       tokens_per_step: int = PROFILE_TOKENS_PER_STEP,
                       cadence: Optional[int] = None):
    """A :class:`~repro_torch.sim.workload.CollectiveProfile` of one
    training step of this architecture, per DP rank:

      * **buckets** — the per-rank gradient payload
        ``params · dtype · (1 − frac + frac/tp)`` cut into ``bucket_bytes``
        buckets plus a remainder tail, the bucket size grown for rack-scale
        models so that the count stays at ``max_buckets``;
      * **algorithm mix** — the α–β model's per-bucket choice at the
        reference DP width;
      * **cadence** — accumulation steps between reductions, by active
        parameter scale;
      * **tp stream** — 4 activation ALLREDUCEs (2 fwd + 2 bwd) of
        ``tokens · d_model · dtype`` per TP-sharded block per step; none for
        replicated-mixer architectures.
    """
    from repro_torch.core.cost_model import LUMORPH_LINK, select_algorithm
    from repro_torch.sim.workload import CollectiveProfile

    if tp is None:
        tp = derive_tp(cfg, dtype_bytes)
    frac = _tp_sharded_fraction(cfg, tp)
    per_rank = cfg.param_count() * dtype_bytes * (1.0 - frac + frac / tp)
    eff = max(float(bucket_bytes), per_rank / max_buckets)
    n_full = int(per_rank // eff)
    tail = per_rank - n_full * eff
    buckets = tuple([eff] * n_full + ([tail] if tail > 1024.0 else []))
    if not buckets:
        buckets = (per_rank,)
    algos = tuple(select_algorithm(b, PROFILE_REF_DP, LUMORPH_LINK) for b in buckets)
    if cadence is None:
        active = cfg.active_param_count()
        cadence = 1 if active < 8e9 else (2 if active < 60e9 else 4)
    n_tp_blocks = sum(_block_tp_sharded(cfg, k, tp) for k in cfg.block_pattern)
    if cfg.kind == "encdec":
        n_tp_blocks += cfg.enc_layers
    tp_collectives = 4 * n_tp_blocks if tp > 1 else 0
    tp_bytes = float(tokens_per_step * cfg.d_model * dtype_bytes)
    # relative per-step compute weight: √(active params / 1B), clamped
    scale = min(4.0, max(0.25, math.sqrt(cfg.active_param_count() / 1e9)))
    return CollectiveProfile(
        model=cfg.name, tp=tp, buckets=buckets, algos=algos, cadence=cadence,
        tp_bytes=tp_bytes if tp_collectives else 0.0,
        tp_collectives=tp_collectives, compute_scale=round(scale, 3))


def zoo_profiles(**kw) -> dict:
    """One derived profile per registered config: ``{arch_id: CollectiveProfile}``."""
    from repro_torch.configs import REGISTRY, get_config
    return {arch: collective_profile(get_config(arch), **kw) for arch in sorted(REGISTRY)}


def make_policy(cfg: ModelConfig, mesh, multi_pod: Optional[bool] = None,
                zero3: Optional[bool] = None, flat_dp: bool = False,
                replicate_batch: bool = False) -> ShardingPolicy:
    if multi_pod is None:
        multi_pod = "pod" in mesh.shape
    data = ("pod", "data") if multi_pod else ("data",)
    if flat_dp:
        data = data + ("model",)  # the whole mesh becomes data parallelism
    axes = MeshAxes(data=data)
    if zero3 is None:
        # the reference's rule: bf16 params over the model axis past 12 GB
        # (its 16 GB v5e HBM) → ZeRO-3 (dbrx-132b)
        zero3 = cfg.param_count() * 2 / _size(mesh, axes.model) > 12e9
    return ShardingPolicy(cfg=cfg, mesh=mesh, axes=axes, zero3=zero3,
                          flat_dp=flat_dp, replicate_batch=replicate_batch)
