"""Multi-pod dry-run on the meta device: every (arch × shape × mesh) cell.

The twin of ``repro.launch.dryrun``. For each cell it builds the real step
(train, prefill or decode) of ``launch.steps`` with the production sharding
policy (``sharding.policy.make_policy`` on ``launch.mesh``'s mesh shapes),
runs it once on meta tensors (shapes and dtypes only, nothing allocated), and
writes one record per cell in the JAX record's schema to
``experiments/dryrun_torch/<arch>__<shape>__<mesh>[__<comm>][__<variant>].json``,
which ``launch.roofline`` reads:

  * ``memory.argument_bytes`` / ``output_bytes`` — per device: the shard
    bytes of params, optimizer state, batch, caches and outputs under their
    specs (``steps.sharded_struct``). ``temp_bytes`` is ``null``: there is no
    compiler here and no per-device program (each cell is counted once, on
    the meta device, as one global program; the port's tensor-parallel
    program runs eagerly across processes and keeps no compiled buffer
    plan), so there is no number to report, and the record says so under
    ``temp_bytes_note``.
  * ``cost.flops`` — per device: every executed op counted by
    ``torch.utils.flop_counter`` (matmuls, convolutions, attention; XLA also
    counts elementwise work, so its counts run higher). Each op's count is
    divided by the mesh sizes that split its work: the batch spec's data
    axes, and the model axis where ``sharding.policy._block_tp_sharded``
    says the op's block is TP-sharded (the vocab-sharded embedding and head
    where the vocabulary divides). Replicated work is not divided. The
    optimizer stage is divided over every data axis (ZeRO-1).
    ``cost.global_flops`` keeps the undivided count.
  * ``cost.bytes_accessed`` — the bytes in and out of every aten op (views
    move nothing; a broadcast input dim is read once), under the same
    split: eager, unfused traffic, larger than XLA's count for a fused
    program.
  * ``collectives`` — per kind, each collective's per-device result bytes
    (the JAX record's convention), derived from the specs: the gradient
    all-reduce and ZeRO-1's parameter all-gather (ZeRO-3: all-gathers and
    a reduce-scatter), and TP's activation all-reduces (2 per TP-sharded
    block per pass, one for a vocab-sharded embedding). Under ``--comm
    ring|lumorph2|lumorph4|auto`` the gradient buckets are the Schedule
    IR's per-rank ``Transfer`` payloads, counted as ``collective-permute``.

Ops are attributed to blocks by the storage they touch: every parameter
leaf's storage is tagged with its block, an op that reads a parameter takes
that block, and an op's outputs carry its block on, so the backward pass
(and remat's recompute) find their block through the saved tensors. Stages
come from the step's ``record_function`` marks.

Eager counting sees every layer, microbatch, sLSTM time step and attention
KV chunk, so every record counts what JAX's ``--unroll`` records aim for;
there is no ``--unroll`` flag here. The loops over equal steps (sLSTM's
time steps, mamba2's chunk-state scan, the chunked attention's KV chunks)
are folded while counting (``models.loop_fold``): one step stands for the
equal ones, with the same FLOPs. The port's remat recomputes the whole
block under every ``remat_policy``, so ``dots`` counts more FLOPs than
JAX's ``dots`` (ROADMAP Queue 3). The dry-run runs on the meta device by design: it never
touches a card. Each (config × shape × variant) is counted once per process
and reused for both meshes; only the per-device split differs.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch h2o-danube-1.8b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multi
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import time
import traceback
from pathlib import Path
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.bridge import flatten_with_paths
from repro_torch.configs import ASSIGNED, SHAPES, cells_for, get_config
from repro_torch.core.cost_model import LUMORPH_LINK, select_algorithm
from repro_torch.core.scheduler import build_schedule
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import META
from repro_torch.models import loop_fold
from repro_torch.models import transformer as tf
from repro_torch.optim import grad_comm
from repro_torch.optim.adamw import init_opt_state
from repro_torch.sharding.policy import _block_tp_sharded, _size, make_policy
from repro_torch.tree import leaves, tree_map

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
COMMS = ("xla", "ring", "lumorph2", "lumorph4", "auto")
TEMP_BYTES_NOTE = ("no compiler and no per-device program: each cell is counted once on "
                   "the meta device as one global eager program")

#: perf-pass sharding/runtime variants, the JAX dry-run's
VARIANTS = {
    "": {},
    "dp_only": {"flat_dp": True, "param_dtype": "bfloat16",
                "remat_policy": "dots"},
    "serve_ws": {"replicate_batch": True},
    "dots": {"remat_policy": "dots"},
    "noremat": {"remat": False},
    "mb4": {"microbatches": 4},
    "serve_ws_int8kv": {"replicate_batch": True, "kv_cache_dtype": "int8"},
    "int8kv": {"kv_cache_dtype": "int8"},
    "mb4_dots": {"microbatches": 4, "remat_policy": "dots"},
}
_CFG_KEYS = ("param_dtype", "remat_policy", "remat", "kv_cache_dtype")
OPT_STAGE = "train/adamw"

# ---------------------------------------------------------------------------
# counting: FLOPs and bytes per (stage, block) on the meta device
# ---------------------------------------------------------------------------

_METADATA_OPS = {torch.ops.aten.size.default, torch.ops.aten.stride.default,
                 torch.ops.aten.numel.default, torch.ops.aten.dim.default,
                 torch.ops.aten.storage_offset.default, torch.ops.aten.sym_size.default,
                 torch.ops.aten.sym_stride.default, torch.ops.aten.sym_numel.default,
                 torch.ops.aten.is_contiguous.default, torch.ops.prim.layout.default}


def _sid(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _read_bytes(t: torch.Tensor) -> int:
    """The bytes an op reads from an input: a broadcast (stride-0) dim is
    read once, not once per index (an expanded mask, GQA's repeated K/V)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def param_scopes(cfg, params) -> dict[str, str]:
    """Each param leaf's block, by path: a segment's block kind, ``"dense"``
    for whisper's encoder layers, ``"shared"`` for zamba2's shared block,
    ``"vocab"`` for the embedding and head, ``"other"`` for the rest (final
    norms, zamba2's input projection)."""
    kinds = [k for k, _ in tf.segments_of(cfg)]
    out = {}
    for path, _ in flatten_with_paths(params):
        parts = path.split("/")
        if parts[0] == "segments":
            out[path] = kinds[int(parts[1])]
        elif parts[0] == "encoder" and parts[1] == "layers":
            out[path] = "dense"
        elif parts[0] == "shared_block":
            out[path] = "shared"
        elif parts[0] in ("embed", "lm_head"):
            out[path] = "vocab"
        else:
            out[path] = "other"
    return out


class OpCounter(TorchDispatchMode):
    """Counts each aten op's FLOPs (``torch.utils.flop_counter``'s formulas)
    and bytes in and out, keyed by (stage, block). Enter it before a
    ``FlopCounterMode``, so that it sees the ops that mode decomposes to and
    counts exactly what that mode counts."""

    def __init__(self, scope_of_storage: dict[int, str]):
        super().__init__()
        self.scope_of = dict(scope_of_storage)
        self.param_sids = frozenset(scope_of_storage)
        self.scope = "other"
        self.stages: list[str] = []
        self.flops: dict[tuple[str, str], float] = collections.defaultdict(float)
        self.bytes: dict[tuple[str, str], float] = collections.defaultdict(float)
        #: a folded loop: the ops of one step count ``repeat`` times, forward
        #: now and, through the autograd nodes they made, backward later
        self.repeat = 1
        self.repeat_nodes: dict[Any, int] = {}
        self.folds = 0

    @contextlib.contextmanager
    def repeated(self, n: int, inputs: list[torch.Tensor], outputs):
        """Count the ops run inside ``n`` times, with their backward: the
        autograd nodes between ``inputs`` and ``outputs`` (a callable giving
        the region's output tensors) are marked."""
        self.folds += 1
        self.repeat = n
        try:
            yield
        finally:
            self.repeat = 1
        stop = {t.grad_fn for t in inputs if t.grad_fn is not None}
        todo = [t.grad_fn for t in outputs() if t.grad_fn is not None]
        while todo:
            node = todo.pop()
            if node is None or node in stop or node in self.repeat_nodes:
                continue
            self.repeat_nodes[node] = n
            todo.extend(f for f, _ in node.next_functions)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "profiler":  # record_function marks: the step's stages
            if "enter" in func.name():
                self.stages.append(args[0])
            elif self.stages:
                self.stages.pop()
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if func in _METADATA_OPS:
            return out
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        act = None
        for t in ins:
            s = self.scope_of.get(_sid(t))
            if s is None:
                continue
            if _sid(t) in self.param_sids:
                self.scope, act = s, None
                break
            act = act or s
        if act is not None and torch._C._current_autograd_node() is not None:
            self.scope = act  # backward: the block whose saved tensors it reads
        for t in outs:
            sid = _sid(t)
            if sid not in self.param_sids:
                self.scope_of[sid] = self.scope
        key = (self.stages[-1] if self.stages else "", self.scope)
        times = self.repeat
        if times == 1 and self.repeat_nodes:
            times = self.repeat_nodes.get(torch._C._current_autograd_node(), 1)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops[key] += times * flop_registry[packet](*args, **kwargs, out_val=out)
        if not (func.is_view or self._aliases(func, ins, outs)):
            self.bytes[key] += times * (sum(_read_bytes(t) for t in ins)
                                        + sum(_nbytes(t) for t in outs))
        return out

    @staticmethod
    def _aliases(func, ins, outs) -> bool:
        """An op that writes nothing and returns its input's storage moves
        no bytes (``_unsafe_view``, ``alias``): only views and these."""
        if func._schema.is_mutable or not outs:
            return False
        sids = {_sid(t) for t in ins}
        return all(_sid(t) in sids for t in outs)


@contextlib.contextmanager
def folded_loops(counter: OpCounter):
    """Fold the models' loops over equal steps (``models.loop_fold``):
    sLSTM's time steps, mamba2's chunk-state scan and the chunked
    attention's KV chunks, each run as its first step, one step counted for
    the equal ones, and any step that differs (a ragged tail, a last state
    nothing reads). The count is the loop's, exactly (``tests/test_torch_dryrun.py``
    holds the two against each other, forward, backward and remat); a meta
    run of xlstm's 32768 Python steps would take minutes."""
    token = loop_fold.FOLD.set(counter.repeated)
    try:
        yield
    finally:
        loop_fold.FOLD.reset(token)


def count_step(fn, params, scopes_by_path: dict[str, str], fold_scan: bool = True) -> dict:
    """Run ``fn()`` on meta tensors under the counters (the models' loops
    folded unless ``fold_scan`` is off: the tests' reference). Returns the FLOPs and
    bytes per (stage, block) and their global FLOPs, which must equal
    ``FlopCounterMode``'s total where no loop was folded."""
    sids = {}
    for path, leaf in flatten_with_paths(params):
        sids[_sid(leaf)] = scopes_by_path[path]
    counter = OpCounter(sids)
    t0 = time.perf_counter()
    fold = folded_loops(counter) if fold_scan else contextlib.nullcontext()
    with fold, counter, FlopCounterMode(display=False) as fc:
        fn()
    ours = sum(counter.flops.values())
    if counter.folds:
        total = ours  # FlopCounterMode saw one step of each folded loop
    else:
        total = float(fc.get_total_flops())
        if ours != total:
            raise RuntimeError(f"per-block FLOPs sum to {ours}, FlopCounterMode counts {total}")
    return {"flops": dict(counter.flops), "bytes": dict(counter.bytes),
            "global_flops": total, "folds": counter.folds,
            "count_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def cell_config(arch: str, variant: str = ""):
    cfg = get_config(arch)
    over = {k: v for k, v in VARIANTS[variant].items() if k in _CFG_KEYS}
    return cfg.replace(**over) if over else cfg


def _tree_bytes(tree) -> int:
    return sum(_nbytes(t) for t in leaves(tree))


def build_cell(arch: str, shape, mesh, *, comm: str = "xla",
               compress: bool = False, variant: str = "") -> dict:
    """The cell's config, policy, per-device argument and output structs
    (meta tensors of each shard's shape), and ``run``, which executes the
    global step once on meta tensors. ``shape`` is a ``SHAPES`` name or a
    ``ShapeSpec`` of one's own."""
    if comm not in COMMS:
        raise ValueError(f"unknown comm {comm!r}; have {COMMS}")
    var = VARIANTS[variant]
    cfg = cell_config(arch, variant)
    if isinstance(shape, str):
        shape = SHAPES[shape]
    policy = make_policy(cfg, mesh, flat_dp=bool(var.get("flat_dp")),
                         replicate_batch=bool(var.get("replicate_batch")))
    params = tf.param_shapes(cfg)
    p_dev = steps_lib.sharded_struct(params, policy.param_specs(params), mesh)
    cell = {"cfg": cfg, "shape": shape, "policy": policy, "params": params}
    if shape.step == "train":
        opt = steps_lib.opt_shapes(cfg, params)
        batch, b_specs = steps_lib.input_specs(cfg, policy, shape.seq_len, shape.global_batch)
        o_dev = steps_lib.sharded_struct(opt, policy.opt_specs(opt), mesh)
        b_dev = steps_lib.sharded_struct(batch, b_specs, mesh)
        loss = torch.empty((), dtype=torch.float32, device=META)
        cell["args"] = [p_dev, o_dev, b_dev]
        cell["outs"] = [p_dev, o_dev, loss]
        cell["alias"] = []
        step = steps_lib.make_train_step(cfg, comm="xla", dp=1, device=META,
                                         microbatches=var.get("microbatches", 1))

        def run():
            p1 = tree_map(lambda t: t.unsqueeze(0), params)
            return step(p1, init_opt_state(p1, lead=(1,)), batch)
    elif shape.step == "prefill":
        batch, b_specs = steps_lib.input_specs(cfg, policy, shape.seq_len, shape.global_batch)
        b_dev = steps_lib.sharded_struct(batch, b_specs, mesh)
        cell["args"] = [p_dev, b_dev]
        cell["outs"] = [_logits_struct(cfg, policy, mesh, shape.global_batch, shape.seq_len)]
        cell["alias"] = []
        step = steps_lib.make_prefill(cfg, META)

        def run():
            return step(params, batch)
    else:
        caches = tf.init_caches(cfg, shape.global_batch, shape.seq_len, META)
        c_dev = steps_lib.sharded_struct(caches, policy.cache_specs(caches), mesh)
        toks = torch.empty((shape.global_batch, 1), dtype=torch.int32, device=META)
        pos = torch.empty((), dtype=torch.int32, device=META)
        t_dev = steps_lib.sharded_struct(toks, policy.batch_spec("tokens", tuple(toks.shape)),
                                         mesh)
        cell["args"] = [p_dev, c_dev, t_dev, pos]
        cell["outs"] = [_logits_struct(cfg, policy, mesh, shape.global_batch, 1), c_dev]
        cell["alias"] = [c_dev]  # the decode step updates its caches in place
        step = steps_lib.make_decode_step(cfg, META)

        def run():
            return step(params, caches, toks, shape.seq_len - 1)
    cell["run"] = run
    cell["collectives"], cell["collective_sources"] = collectives_for(
        cfg, policy, shape, params, comm=comm, compress=compress)
    return cell


def _logits_struct(cfg, policy, mesh, batch: int, seq: int) -> torch.Tensor:
    """The logits' shard: batch over the data axes where they divide it,
    vocab over the model axis where the head is vocab-sharded."""
    b = policy.batch_spec("tokens", (batch, seq))[0]
    v = policy.axes.model if policy.tp > 1 and cfg.vocab_size % policy.tp == 0 else None
    return steps_lib.sharded_struct(
        torch.empty((batch, seq, cfg.vocab_size), dtype=cfg.cdtype, device=META),
        (b, None, v), mesh)


def _data_split(policy, shape) -> int:
    """How many ways the batch spec's data axes split the step's work."""
    b_spec = policy.batch_spec("tokens", (shape.global_batch, shape.seq_len))
    return _size(policy.mesh, b_spec[0]) if b_spec[0] is not None else 1


def _model_split(cfg, policy, scope: str) -> int:
    tp = policy.tp
    if tp <= 1:
        return 1
    if scope == "vocab":
        return tp if cfg.vocab_size % tp == 0 else 1
    if scope == "other":
        return 1
    return tp if _block_tp_sharded(cfg, "dense" if scope == "shared" else scope, tp) else 1


def split_per_device(counts: dict, cfg, policy, shape) -> tuple[float, float]:
    """(FLOPs, bytes) per device from the global counts per (stage, block)."""
    d_batch = _data_split(policy, shape)
    out = []
    for table in (counts["flops"], counts["bytes"]):
        total = 0.0
        for (stage, scope), v in table.items():
            d = policy.dp if stage == OPT_STAGE else d_batch
            total += v / (d * _model_split(cfg, policy, scope))
        out.append(total)
    return out[0], out[1]


# ---------------------------------------------------------------------------
# collectives from the specs
# ---------------------------------------------------------------------------

def _tp_blocks(cfg, policy, step: str) -> list[tuple[int, int]]:
    """(count, tokens per row, 0 for the step's own) of the TP-sharded blocks
    one forward pass runs: each ends in one activation all-reduce after its
    attention and one after its MLP or MoE. Whisper's encoder runs in
    training and prefill; a decode step reads its cross caches instead."""
    tp = policy.tp
    if tp <= 1:
        return []
    n = sum(_block_tp_sharded(cfg, k, tp) for k in cfg.block_pattern)
    if cfg.shared_attn_every and _block_tp_sharded(cfg, "dense", tp):
        n += sum(tf._shared_site(cfg, i) for i in range(cfg.n_layers))
    out = [(n, 0)]
    if cfg.kind == "encdec" and step != "decode" and _block_tp_sharded(cfg, "dense", tp):
        out.append((cfg.enc_layers, cfg.enc_seq_len))
    return out


def collectives_for(cfg, policy, shape, params, *, comm: str = "xla",
                    compress: bool = False) -> tuple[dict, dict]:
    """Per kind, each collective's per-device result bytes, from the specs;
    and the same bytes by source (``tp``: activation all-reduces,
    ``gradients``: the gradient reduction, ``zero``: ZeRO's gathers)."""
    mesh = policy.mesh
    out = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
    sources = {"tp": 0, "gradients": 0, "zero": 0}

    def add(kind: str, nbytes: float, count: int = 1, source: str = "tp") -> None:
        if count and nbytes:
            out[kind]["count"] += count
            out[kind]["bytes"] += int(nbytes) * count
            sources[source] += int(nbytes) * count

    step = shape.step
    seq = 1 if step == "decode" else shape.seq_len
    rows = shape.global_batch // _data_split(policy, shape)
    act = cfg.cdtype.itemsize
    passes = 1 if step != "train" else (3 if cfg.remat else 2)  # fwd, bwd, recompute
    for n, s in _tp_blocks(cfg, policy, step):
        add("all-reduce", rows * (s or seq) * cfg.d_model * act, 2 * n * passes)
    if policy.tp > 1 and cfg.vocab_size % policy.tp == 0:
        # the vocab-sharded embedding's lookup (and, training, the head's input grad)
        add("all-reduce", rows * seq * cfg.d_model * act, 1 if step != "train" else 2)
    if step == "train" and policy.dp > 1:
        data = set(policy.axes.data)
        grad_bytes = 0
        for path, leaf in flatten_with_paths(params):
            spec = policy.param_spec(path, tuple(leaf.shape))
            shard = _nbytes(steps_lib.sharded_struct(leaf, spec, mesh))
            if any(set(steps_lib.entry_axes(e)) & data for e in spec):  # ZeRO-3
                whole = shard * policy.dp
                add("all-gather", whole, passes - 1, "zero")  # forward, remat's recompute
                add("reduce-scatter", shard, source="gradients")
                continue
            grad_bytes += shard
            if comm == "xla":
                add("all-reduce", shard, source="gradients")
            o_spec = policy.opt_spec(path, tuple(leaf.shape))
            if any(set(steps_lib.entry_axes(e)) & data for e in o_spec):
                add("all-gather", shard, source="zero")  # ZeRO-1: updated shards gathered
        if comm != "xla":
            for n_bytes, algo in _bucket_plan(grad_bytes, policy.dp, comm, compress):
                for nbytes in _transfer_bytes(algo, policy.dp, n_bytes):
                    add("collective-permute", nbytes, source="gradients")
    out["total_bytes"] = sum(out[k]["bytes"] for k in COLLECTIVES)
    out["total_count"] = sum(out[k]["count"] for k in COLLECTIVES)
    return out, sources


def _bucket_plan(grad_bytes: int, p: int, comm: str, compress: bool) -> list[tuple[float, str]]:
    """(wire bytes, algorithm) per gradient bucket, as ``optim.grad_comm``
    cuts and picks them: 25 MB of fp32-counted elements per bucket, the
    wire in bf16, or int8 plus a 4-byte scale per 256 under compression
    (which always runs LUMORPH-2)."""
    plan = []
    for b in grad_comm.make_buckets(grad_bytes // 4):
        if compress:
            n = b.n_elems + 4 * math.ceil(b.n_elems / grad_comm.QUANT_BLOCK)
            plan.append((float(n), "lumorph2"))
            continue
        n = float(b.n_elems * 2)
        plan.append((n, select_algorithm(n, p, LUMORPH_LINK) if comm == "auto" else comm))
    return plan


def _transfer_bytes(algo: str, p: int, n_bytes: float) -> list[float]:
    """One entry per ``Transfer`` of the schedule: the chunks it moves times
    the chunk's bytes (each rank's result buffer of that move)."""
    sched = build_schedule(algo, tuple(range(p)), n_bytes).materialize()
    chunk = n_bytes / sched.n_chunks
    return [t.send.shape[1] * chunk for r in sched.rounds for t in r.transfers]


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

_COUNTS: dict[tuple, dict] = {}


def cell_counts(cell: dict, key: tuple) -> dict:
    """The global counts of one (config × shape × variant), once per process."""
    if key not in _COUNTS:
        _COUNTS[key] = count_step(cell["run"], cell["params"],
                                  param_scopes(cell["cfg"], cell["params"]))
    return _COUNTS[key]


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, comm: str = "xla",
             compress: bool = False, save: bool = True, variant: str = "") -> dict:
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    t0 = time.time()
    rec: dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                           "unroll": False, "comm": comm, "compress": compress,
                           "variant": variant, "n_devices": math.prod(mesh.axis_sizes),
                           "device": "meta"}
    try:
        cell = build_cell(arch, shape_name, mesh, comm=comm, compress=compress,
                          variant=variant)
        rec["lower_s"] = round(time.time() - t0, 1)
        counts = cell_counts(cell, (repr(cell["cfg"]), cell["shape"], variant))
        flops, byts = split_per_device(counts, cell["cfg"], cell["policy"], cell["shape"])
        rec["count_s"] = round(counts["count_s"], 1)
        rec["memory"] = {"argument_bytes": _tree_bytes(cell["args"]),
                         "output_bytes": _tree_bytes(cell["outs"]),
                         "temp_bytes": None, "alias_bytes": _tree_bytes(cell["alias"]),
                         "temp_bytes_note": TEMP_BYTES_NOTE}
        rec["cost"] = {"flops": flops, "bytes_accessed": byts,
                       "global_flops": counts["global_flops"]}
        rec["collectives"] = cell["collectives"]
        rec["collective_sources"] = cell["collective_sources"]
        rec["ok"] = True
    except Exception as e:  # record the failure for triage, then re-raise in --strict
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 1)
    if save:
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{arch}__{shape_name}__{mesh_kind}"
        if comm != "xla":
            tag += f"__{comm}" + ("_int8" if compress else "")
        if variant:
            tag += f"__{variant}"
        (OUT_DIR / f"{tag}.json").write_text(json.dumps(rec, indent=1))
    return rec


def all_cells() -> list[tuple[str, str]]:
    return [(arch, shape) for arch in ASSIGNED for shape in cells_for(get_config(arch))]


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true", help="every assigned arch × its shapes")
    ap.add_argument("--comm", default="xla", choices=list(COMMS))
    ap.add_argument("--compress", action="store_true", help="int8 gradient collectives")
    ap.add_argument("--variant", default="", choices=list(VARIANTS))
    ap.add_argument("--strict", action="store_true", help="exit non-zero on any failure")
    args = ap.parse_args(argv)

    if args.all:
        cells = all_cells()
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    recs, failures = [], 0
    for arch, shape in cells:
        rec = run_cell(arch, shape, args.mesh, comm=args.comm, compress=args.compress,
                       variant=args.variant)
        recs.append(rec)
        status = "OK " if rec["ok"] else "FAIL"
        extra = (f"flops/dev={rec['cost']['flops']:.3e} "
                 f"coll={rec['collectives']['total_bytes']:.3e}B "
                 f"args={rec['memory']['argument_bytes'] / 1e9:.2f}GB"
                 if rec["ok"] else rec["error"][:120])
        print(f"[{status}] {arch:24s} {shape:12s} {args.mesh:6s} "
              f"meta={rec['total_s']:7.1f}s  {extra}", flush=True)
        failures += 0 if rec["ok"] else 1
    if failures:
        print(f"{failures}/{len(cells)} cells FAILED")
        if args.strict:
            raise SystemExit(1)
    return recs


if __name__ == "__main__":
    main()
