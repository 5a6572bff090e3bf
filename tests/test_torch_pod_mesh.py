"""The production meshes' layout across processes: a ``(pod, data, model)``
process mesh, one tensor dim split over two mesh axes, and ``flat_dp``, on a
4-rank gloo world on the CPU.

One world of four processes (a ``file://`` rendezvous under ``tmp_path``,
one intra-op thread per rank, the whole run under a timeout) runs every case
at the module's first test and writes one pickle per rank; three JAX
subprocesses on 4 fake CPU devices each write the references beside it. All
start together. The meshes are the multi-pod mesh cut to 4 ranks,
``(pod 2, data 1, model 2)`` and ``(pod 2, data 2, model 1)``, laid out by
``launch.mesh.lay_out_mesh`` row-major as ``jax.make_mesh`` lays out its
devices, and ``flat_dp``'s ``(data 2, model 2)``, whose data entry is
``("data", "model")``. Smoke configs in fp32. The tests read:

  * (a) the placed state: every rank's local shard of the params (JAX's,
    carried across as numpy and placed by the port) and of the ``xla``
    moments equals the matching device's shard of JAX's
    ``init_sharded_state``, bit for bit: bert-large's moments over
    ``("pod", "data")`` at both pod meshes and over ``("data", "model")``
    under ``flat_dp``; dbrx's params over ``("pod", "data")`` under a ZeRO-3
    policy;
  * (b) ``sharding.policy.place``, ``place_filled``, ``local_offsets`` and
    ``gather_data`` on a leaf split over pod and data (and over data and
    model under ``flat_dp``), against the slices that the rank's mesh
    coordinates pick; the CPU twin of a 3-D mesh that ``redistribute``
    stages gloo's CUDA gathers on; an entry whose axes are out of the
    mesh's order raises;
  * (c) the trainer (``launch.train.main``, 4 steps of batch 4 × 32, fp32
    wire): at ``(2, 1, 2)`` with ``xla`` and ``lumorph2 --compress``, at
    ``(2, 2, 1)`` with ``lumorph4`` and under ``flat_dp`` with ``xla`` and
    ``lumorph4``, losses within 1e-5 relative of JAX's trainer on the same
    mesh from the same params, and rank 0's final params (its step-4
    checkpoint) held to JAX's as ``tests/test_torch_hybrid_tp.py`` holds
    them. Every comm at both pod meshes equals the port's own run on the
    ``(data, model)`` twin with data = pod·data, bit for bit;
  * (d) deepseek-v2-lite's smoke config (MoE, MLA) under ``xla`` at ``(2, 1,
    2)`` against JAX's trainer, and with ``microbatches=2`` at ``(2, 2, 1)``
    against JAX's ``make_train_step``, the router gaps printed as the MoE
    tests print them;
  * (e) the prefill and the placed decode against JAX's ``make_prefill``
    and ``make_decode_step`` (every step's logits within 2e-5 of the
    largest; with the int8 cache until a payload element first lands one
    int8 step from JAX's, and within 1e-3 after): danube at ``(2, 1, 2)``
    batch 4 (the batch over ``("pod", "data")``, the KV heads over model) and
    at ``(2, 2, 1)`` batch 1 (the sequence over ``("pod", "data")``), each with
    the bf16 and the int8 cache; deepseek's latent cache at ``(2, 2, 1)``
    batch 1; danube under ``flat_dp`` and under ``replicate_batch``; the
    kernel path's calls counted per rank on its own heads;
  * (f) zamba2 under ``flat_dp``: the port refuses its decode caches, whose
    mamba2 state names ``model`` twice, where JAX raises
    ``DuplicateSpecError``;
  * (g) ``train.main(["--mesh", "multi", ...])`` with ``make_production_mesh``
    cut to ``(2, 1, 2)`` trains, and equals the same steps driven through
    ``launch.steps`` on the mesh that ``lay_out_mesh`` makes; unpatched, a
    world of 4 exits with ``MESH_NEEDS_RANKS``.
"""

import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_at  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.sharding import policy as tpol  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT_S = 300
BERT, DANUBE, DEEPSEEK, DBRX, ZAMBA2 = ("bert-large", "h2o-danube-1.8b",
                                        "deepseek-v2-lite-16b", "dbrx-132b", "zamba2-1.2b")
LOSS_RTOL = 1e-5  # fp32, the same params and batches as JAX's
PARAM_RTOL, INT8_PARAM_RTOL = 1e-4, 5e-2  # relative to each leaf's largest entry
# AdamW normalizes a small gradient's rounding: at most PARAM_OUTLIERS of a leaf's
# elements may lie past PARAM_RTOL, each within PARAM_OUTLIER_RTOL (test_torch_hybrid_tp.py)
PARAM_OUTLIERS, PARAM_OUTLIER_RTOL = 1e-3, 1e-3
LOGITS_RTOL = 2e-5  # fp32, every step, relative to the step's largest logit
INT8_FLIPPED_RTOL = 1e-3  # after an int8 payload element lands one step from JAX's
MIN_GAP = 1e-6  # the router's k-th against (k+1)-th probability, every token
AXES3 = ("pod", "data", "model")
FLAT = "flat"  # flat_dp on (data 2, model 2)


def mesh_axes(mesh) -> tuple:
    """(axis names, sizes) of a mesh key: a 3-tuple (pod, data, model) or FLAT."""
    return (("data", "model"), (2, 2)) if mesh == FLAT else (AXES3, mesh)


TRAIN = ["--smoke", "--batch", "4", "--seq", "32", "--steps", "4", "--wire-dtype", "float32",
         "--log-every", "100"]
COMMS = {"xla": ["--comm", "xla"], "lumorph4": ["--comm", "lumorph4"],
         "lumorph2+int8": ["--comm", "lumorph2", "--compress"]}
POD_MESHES = ((2, 1, 2), (2, 2, 1))
TWIN = {(2, 1, 2): 2, (2, 2, 1): 4}  # the (data, model) twin's --data-parallel: pod·data
# (arch, mesh, comm) held to JAX's trainer on the same mesh
JAX_RUNS = [(BERT, (2, 1, 2), "xla"), (BERT, (2, 1, 2), "lumorph2+int8"),
            (BERT, (2, 2, 1), "lumorph4"), (BERT, FLAT, "xla"), (BERT, FLAT, "lumorph4"),
            (DEEPSEEK, (2, 1, 2), "xla")]
# the placed state: name -> (arch, mesh, zero3)
STATE_CASES = {"bert_212": (BERT, (2, 1, 2), None), "bert_221": (BERT, (2, 2, 1), None),
               "bert_flat": (BERT, FLAT, None), "dbrx_212_z3": (DBRX, (2, 1, 2), True),
               "dbrx_221_z3": (DBRX, (2, 2, 1), True)}
# the helpers: name -> (mesh, spec of an [8, 4] leaf)
HELPER_CASES = {"pod_data": ((2, 2, 1), (("pod", "data"), None)),
                "pod_data_model": ((2, 1, 2), (("pod", "data"), "model")),
                "flat": (FLAT, (("data", "model"), None))}
# microbatches: deepseek, xla, 2 microbatches of a global batch of 8, 2 steps
MB_MESH, MB_STEPS, MB_BATCH, MB_SEQ = (2, 2, 1), 2, 8, 32
PROMPT, GEN = 8, 8
PREFILL_TOKENS = (4, 24)
PREFILL_CASES = {"danube_212": (DANUBE, (2, 1, 2)), "danube_221": (DANUBE, (2, 2, 1)),
                 "danube_flat": (DANUBE, FLAT)}
KERNEL_CASE = "danube_212"
# name -> (arch, mesh, batch, kv cache, replicate_batch)
DECODE_CASES = {"danube_212_b4": (DANUBE, (2, 1, 2), 4, "bfloat16", False),
                "danube_212_b4_int8": (DANUBE, (2, 1, 2), 4, "int8", False),
                "danube_221_b1": (DANUBE, (2, 2, 1), 1, "bfloat16", False),
                "danube_221_b1_int8": (DANUBE, (2, 2, 1), 1, "int8", False),
                "deepseek_221_b1": (DEEPSEEK, (2, 2, 1), 1, "bfloat16", False),
                "danube_flat_b4": (DANUBE, FLAT, 4, "bfloat16", False),
                "danube_212_replicated": (DANUBE, (2, 1, 2), 4, "bfloat16", True)}
# the layout of each case's k (c_kv for deepseek) and pos leaves
S0, S1, S2, R = "Shard(dim=0)", "Shard(dim=1)", "Shard(dim=2)", "Replicate()"
LAYOUT = {"danube_212_b4": {"0/k": (S0, S0, S2), "0/pos": (S0, S0, R)},
          "danube_221_b1": {"0/k": (S1, S1, S2), "0/pos": (S1, S1, R)},
          "deepseek_221_b1": {"0/c_kv": (R, R, S1), "0/pos": (S1, S1, R)},
          "danube_flat_b4": {"0/k": (S0, S0), "0/pos": (S0, S0)},
          "danube_212_replicated": {"0/k": (S0, S0, S2), "0/pos": (S0, S0, R)}}
# one JAX process each, started together: part -> (state, train runs, serve, microbatches)
JAX_PARTS = {"state_train": (True, JAX_RUNS[:3], False, False),
             "train_serve": (False, JAX_RUNS[3:5], True, False),
             "deepseek": (False, JAX_RUNS[5:], False, True)}
assert sorted(map(str, (r for _, runs, _, _ in JAX_PARTS.values() for r in runs))) == \
    sorted(map(str, JAX_RUNS))


def fp32_smoke(arch: str):
    return get_smoke_config(arch).replace(compute_dtype="float32")


def run_name(arch, mesh, comm) -> str:
    return f"{arch}/{mesh}/{comm}"


def mb_batches(cfg) -> list:
    data = DataConfig(seed=0, global_batch=MB_BATCH, seq_len=MB_SEQ)
    return [{k: np.asarray(v) for k, v in batch_at(i, cfg, data).items()}
            for i in range(MB_STEPS)]


def mb_opt():
    return dict(lr=3e-4, total_steps=MB_STEPS, warmup_steps=1)


def prefill_tokens() -> np.ndarray:
    return np.random.default_rng(7).integers(0, 256, PREFILL_TOKENS, dtype=np.int32)


def decode_config(arch: str, kv: str):
    return fp32_smoke(arch).replace(kv_cache_dtype=kv)


def greedy_tokens(params, cfg, batch: int, seed: int) -> np.ndarray:
    """A random prompt and the port's one-process greedy continuation."""
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, PROMPT),
                                                  dtype=np.int32)
    toks = torch.from_numpy(prompt).long()
    n = PROMPT + GEN
    step, caches = tsteps.make_decode_step(cfg, "cpu"), ttf.init_caches(cfg, batch, n, "cpu")
    out = [toks[:, t] for t in range(PROMPT)]
    for t in range(n - 1):
        logits, caches = step(params, caches, out[t][:, None], t)
        if t >= PROMPT - 1:
            out.append(logits[:, -1].argmax(-1))
    return torch.stack(out, dim=1).numpy().astype(np.int32)


RANK = r"""
import os, pickle, sys
sys.path.insert(0, {src!r}); sys.path.insert(0, {tests!r})
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate
import test_torch_pod_mesh as T
from repro_torch.bridge import flatten_with_paths, params_from_numpy
from repro_torch.data.pipeline import DataConfig, stream
from repro_torch.kernels import ops
from repro_torch.launch import steps, train
from repro_torch.launch.mesh import init_process_mesh, lay_out_mesh
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.sharding import policy as pol
from repro_torch.sharding.policy import MeshShape, distribute_tree, gather_tree, make_policy
from repro_torch.tree import leaves, tree_map

rank, out_dir = int(sys.argv[1]), {out!r}
world = init_process_mesh("cpu", "gloo", init_method="file://" + {rdzv!r}, rank=rank,
                          world_size=T.WORLD)
with open({inputs!r}, "rb") as f:
    inputs = pickle.load(f)
MESHES = {{}}


def mesh_of(mesh):
    if mesh not in MESHES:  # collective: every rank makes the meshes in one order
        names, sizes = T.mesh_axes(mesh)
        MESHES[mesh] = lay_out_mesh(world, MeshShape(names, sizes), flat_dp=mesh == T.FLAT)
    return MESHES[mesh]


def policy_of(cfg, mesh, **kw):
    return make_policy(cfg, mesh_of(mesh), flat_dp=mesh == T.FLAT, **kw)


def with_mesh(mesh, fn):
    # train.main on a pod mesh: the multi-pod production mesh cut to 4 ranks
    made = train.make_production_mesh
    if mesh != T.FLAT:
        train.make_production_mesh = lambda multi_pod=False: MeshShape(T.AXES3, mesh)
    try:
        return fn()
    finally:
        train.make_production_mesh = made


def train_run(arch, mesh, comm, ckpt=None):
    argv = ["--arch", arch, "--device", "cpu"] + T.TRAIN + T.COMMS[comm]
    argv += ["--data-parallel", "2"] if mesh == T.FLAT else ["--mesh", "multi"]
    if ckpt:
        argv += ["--ckpt-dir", os.path.join(out_dir, "ckpt", ckpt), "--ckpt-every", "4"]
    return with_mesh(mesh, lambda: train.main(argv, flat_dp=mesh == T.FLAT))


out = {{"shards": {{}}, "helpers": {{}}, "runs": {{}}, "prefill": {{}}, "decode": {{}}}}

# (b) the placement helpers on a leaf split over two mesh axes
full = torch.arange(32, dtype=torch.float32).reshape(8, 4)
for name, (mesh, spec) in T.HELPER_CASES.items():
    dm = mesh_of(mesh).device_mesh
    t = pol.place(full, spec, dm)
    host = pol._host_mesh(dm)  # the CPU twin that redistribute stages gloo's CUDA gathers on
    twin = DTensor.from_local(t.to_local(), host, t.placements, run_check=False)
    out["helpers"][name] = {{
        "coords": [dm.get_local_rank(i) for i in range(dm.ndim)],
        "placements": str(t.placements), "local": t.to_local().numpy(),
        "offsets": list(pol.local_offsets(t)),
        "filled": pol.place_filled((8, 4), 7.0, torch.float32, spec, dm, "cpu")
        .to_local().numpy(),
        "gathered": pol.gather_data(t).to_local().numpy(),
        "gathered_axes": pol.gather_data(t, ("data", "model") if mesh == T.FLAT
                                         else ("pod", "data")).to_local().numpy(),
        "full": gather_tree(t).numpy(),
        "twin_full": twin.redistribute(placements=[Replicate()] * dm.ndim).to_local().numpy()}}
try:
    pol.place(full, (("data", "pod"), None), mesh_of((2, 2, 1)).device_mesh)
except ValueError as e:
    out["helpers"]["out_of_order"] = str(e)

# (a) the placed state: JAX's params, and the moments as the trainer makes them under xla
for name, (arch, mesh, zero3) in T.STATE_CASES.items():
    cfg = T.fp32_smoke(arch)
    pm = mesh_of(mesh)
    policy = train.checked_policy(cfg, pm, zero3, mesh == T.FLAT)
    _, opt = steps.init_train_state(cfg, pm.data, 0, "cpu", group=pm.group, policy=policy,
                                    mesh=pm, comm="xla")
    params = distribute_tree(params_from_numpy(inputs["jax_params"][arch]),
                             policy.param_specs(tf.param_shapes(cfg)), pm.device_mesh)
    out["shards"][name] = {{f"{{side}}/{{path}}": t.to_local().numpy()
                           for side, tree in (("params", params), ("m", opt["m"]),
                                              ("v", opt["v"]))
                           for path, t in flatten_with_paths(tree)}}
    out["shards"][name]["placements"] = {{
        f"{{side}}/{{path}}": str(t.placements) for side, tree in (("params", params),
                                                                  ("m", opt["m"]))
        for path, t in flatten_with_paths(tree)}}

# (c) and (d) the trainer; the JAX-held runs keep their step-4 checkpoints
train.get_smoke_config = T.fp32_smoke
held = {{T.run_name(*r) for r in T.JAX_RUNS}}
for mesh in (*T.POD_MESHES, T.FLAT):
    for comm in T.COMMS if mesh != T.FLAT else ("xla", "lumorph4"):
        name = T.run_name(T.BERT, mesh, comm)
        out["runs"][name] = train_run(T.BERT, mesh, comm, name if name in held else None)
for mesh, dp in T.TWIN.items():  # the (data, model) twins
    for comm in T.COMMS:
        out["runs"][T.run_name(T.BERT, f"twin{{mesh}}", comm)] = train.main(
            ["--arch", T.BERT, "--device", "cpu"] + T.TRAIN + T.COMMS[comm]
            + ["--data-parallel", str(dp)])
name = T.run_name(T.DEEPSEEK, (2, 1, 2), "xla")
out["runs"][name] = train_run(T.DEEPSEEK, (2, 1, 2), "xla", name)

# (d) microbatches: xla, 2 microbatches, at (2, 2, 1)
cfg = T.fp32_smoke(T.DEEPSEEK)
pm = mesh_of(T.MB_MESH)
policy = train.checked_policy(cfg, pm)
step = steps.make_train_step(cfg, AdamWConfig(**T.mb_opt()), comm="xla", dp=pm.data,
                             microbatches=2, device="cpu", group=pm.group, policy=policy,
                             mesh=pm)
params, opt = steps.init_train_state(cfg, pm.data, 0, "cpu", group=pm.group, policy=policy,
                                     mesh=pm, comm="xla")
losses = []
for b in T.mb_batches(cfg):
    params, opt, loss = step(params, opt, {{k: torch.from_numpy(v) for k, v in b.items()}})
    losses.append(float(loss))
out["mb"] = losses

# (g) the library path at (2, 1, 2): train.main's steps driven through launch.steps
cfg = T.fp32_smoke(T.BERT)
pm = mesh_of((2, 1, 2))
policy = train.checked_policy(cfg, pm)
step = steps.make_train_step(cfg, AdamWConfig(lr=3e-4, total_steps=4, warmup_steps=1),
                             comm="xla", dp=pm.data, wire_dtype=torch.float32, device="cpu",
                             group=pm.group, policy=policy, mesh=pm)
params, opt = steps.init_train_state(cfg, pm.data, 0, "cpu", group=pm.group, policy=policy,
                                     mesh=pm, comm="xla")
losses = []
for i, batch in stream(cfg, DataConfig(seed=0, global_batch=4, seq_len=32)):
    if i == 4:
        break
    params, opt, loss = step(params, opt, batch)
    losses.append(float(loss))
out["library"] = {{"losses": losses, "group": dist.get_process_group_ranks(pm.group),
                  "data": pm.data, "shape": pm.shape}}
try:
    train.main(["--arch", T.BERT, "--device", "cpu", "--mesh", "multi"] + T.TRAIN)
except SystemExit as e:
    out["unpatched_exit"] = str(e)

# (e) the prefill; the kernel path's calls counted per rank
counted = ops.flash_attention
calls = []
def seen(q, k, v, **kw):
    calls.append([list(q.shape), list(k.shape)])
    return counted(q, k, v, **kw)
ops.flash_attention = seen
tokens = torch.from_numpy(T.prefill_tokens())
for name, (arch, mesh) in T.PREFILL_CASES.items():
    cfg = T.fp32_smoke(arch)
    params = tree_map(torch.from_numpy, inputs["params"][arch])
    for kernel in (False, True) if name == T.KERNEL_CASE else (False,):
        c = cfg.replace(use_pallas=kernel)
        calls.clear()
        logits = steps.make_prefill(c, "cpu", policy_of(c, mesh), mesh_of(mesh))(
            params, {{"tokens": tokens}})
        out["prefill"][name, kernel] = {{"logits": gather_tree(logits).numpy(),
                                        "calls": list(calls)}}
ops.flash_attention = counted

# (e) the placed decode, fed the one process's tokens; the int8 payloads after every step
for name, (arch, mesh, b, kv, rep) in T.DECODE_CASES.items():
    cfg = T.decode_config(arch, kv)
    policy, pm = policy_of(cfg, mesh, replicate_batch=rep), mesh_of(mesh)
    params = distribute_tree(tree_map(torch.from_numpy, inputs["params"][arch]),
                             policy.param_specs(tf.param_shapes(cfg)), pm.device_mesh)
    toks = torch.from_numpy(inputs["tokens"][name]).long()
    n = toks.shape[1]
    step = steps.make_decode_step(cfg, "cpu", policy, pm, b, n)
    caches = steps.init_placed_caches(cfg, policy, pm, b, n)
    logits, payloads = [], []
    for t in range(n):
        o, caches = step(params, caches, toks[:, t:t + 1], t)
        logits.append(gather_tree(o).numpy())
        if kv == "int8":
            payloads.append({{f"{{i}}/{{k}}": gather_tree(c[k]).numpy()
                              for i, c in enumerate(caches) for k in ("k", "v")}})
    out["decode"][name] = {{
        "logits": np.stack(logits), "payloads": payloads,
        "shapes": {{p: list(c.to_local().shape) for p, c in flatten_with_paths(caches)}},
        "placements": {{p: str(c.placements) for p, c in flatten_with_paths(caches)}}}}

# (f) zamba2 under flat_dp: its mamba2 state's spec names model twice
cfg = T.decode_config(T.ZAMBA2, "bfloat16")
try:
    steps.init_placed_caches(cfg, policy_of(cfg, T.FLAT), mesh_of(T.FLAT), 4, 16)
except ValueError as e:
    out["zamba2_flat"] = str(e)
dist.destroy_process_group()
with open(os.path.join(out_dir, f"rank{{rank}}.pkl"), "wb") as f:
    pickle.dump(out, f)
"""

JAX_REFS = r"""
import functools, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, {src!r}); sys.path.insert(0, {tests!r})
import numpy as np
import jax, jax.numpy as jnp
import test_torch_pod_mesh as T
from repro import compat
from repro.checkpoint.checkpoint import _flatten_with_paths
from repro.configs import get_smoke_config
from repro.launch import steps, train
from repro.models import moe as moe_lib
from repro.models import transformer as tf
from repro.optim.adamw import AdamWConfig
from repro.sharding.policy import make_policy

part = sys.argv[1]  # a key of T.JAX_PARTS
state, runs, serve, mb = T.JAX_PARTS[part]
with open({inputs!r}, "rb") as f:
    inputs = pickle.load(f)

# per MoE call, the smallest gap between a token's k-th and (k+1)-th router probability
# and the number of tokens whose gap is under T.MIN_GAP
GAPS = []
_apply_moe = moe_lib.apply_moe


def _recorded_apply_moe(p, x, top_k, capacity_factor=1.25):
    probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
    top = jax.lax.top_k(probs, top_k + 1)[0]
    jax.debug.callback(lambda g: GAPS.append((float(np.min(g)), int(np.sum(g < T.MIN_GAP)))),
                       top[..., top_k - 1] - top[..., top_k])
    return _apply_moe(p, x, top_k, capacity_factor)


moe_lib.apply_moe = _recorded_apply_moe


def gaps():
    jax.effects_barrier()
    out = (min(g for g, _ in GAPS), sum(n for _, n in GAPS)) if GAPS else None
    GAPS.clear()
    return out


def fp32(arch):
    return get_smoke_config(arch).replace(compute_dtype="float32")


def mesh_of(mesh):
    names, sizes = T.mesh_axes(mesh)
    return compat.make_mesh(sizes, names)


def policy_of(cfg, mesh, **kw):
    return make_policy(cfg, mesh_of(mesh), flat_dp=mesh == T.FLAT, **kw)


def by_rank(leaf, mesh):
    shards = {{s.device: np.asarray(s.data) for s in leaf.addressable_shards}}
    return [shards[d] for d in mesh.devices.flat]  # rank r = (p * data + d) * model + m


out = {{"shards": {{}}, "runs": {{}}, "prefill": {{}}, "decode": {{}}}}
if state:
    for name, (arch, mesh, zero3) in T.STATE_CASES.items():
        cfg = fp32(arch)
        policy = policy_of(cfg, mesh, zero3=zero3)
        params, opt = steps.init_sharded_state(cfg, policy, jax.random.PRNGKey(0))
        out["shards"][name] = {{
            f"{{side}}/{{path}}": by_rank(leaf, policy.mesh)
            for side, tree in (("params", params), ("m", opt["m"]), ("v", opt["v"]))
            for path, leaf in _flatten_with_paths(tree)}}

# the trainer from the port's seed-0 params, on the same mesh
_init = steps.init_sharded_state
def init_from_port(cfg, policy, rng, init_ef=False):
    params, opt = _init(cfg, policy, rng, init_ef)
    params = jax.tree.map(lambda p, a: jax.device_put(jnp.asarray(a, p.dtype), p.sharding),
                          params, inputs["params"][cfg.name.removesuffix("-smoke") + "/train"])
    return params, opt
steps.init_sharded_state = init_from_port
train.get_smoke_config = fp32
made_mesh, made_policy = train.make_production_mesh, train.make_policy
for arch, mesh, comm in runs:
    argv = ["--arch", arch] + T.TRAIN + T.COMMS[comm] + [
        "--ckpt-dir", os.path.join({out!r}, "jax_ckpt", T.run_name(arch, mesh, comm)),
        "--ckpt-every", "4"]
    if mesh == T.FLAT:
        train.make_policy = functools.partial(made_policy, flat_dp=True)
        argv += ["--data-parallel", "2"]
    else:
        train.make_production_mesh = lambda multi_pod=False, m=mesh: mesh_of(m)
        argv += ["--mesh", "multi"]
    gaps()
    out["runs"][T.run_name(arch, mesh, comm)] = {{**train.main(argv), "gap": gaps()}}
    train.make_production_mesh, train.make_policy = made_mesh, made_policy
if mb:  # microbatches: xla over the global batch, 2 microbatches
    cfg = fp32(T.DEEPSEEK)
    policy = policy_of(cfg, T.MB_MESH)
    step = steps.make_train_step(cfg, policy, AdamWConfig(**T.mb_opt()), comm="xla",
                                 microbatches=2)
    params, opt = init_from_port(cfg, policy, jax.random.PRNGKey(0))
    losses = []
    gaps()
    for b in T.mb_batches(cfg):
        params, opt, loss = step(params, opt, {{k: jnp.asarray(v) for k, v in b.items()}})
        losses.append(float(loss))
    out["mb"] = {{"losses": losses, "gap": gaps()}}
if serve:
    tokens = jnp.asarray(T.prefill_tokens())
    for name, (arch, mesh) in T.PREFILL_CASES.items():
        cfg = fp32(arch)
        fn = steps.make_prefill(cfg, policy_of(cfg, mesh))
        out["prefill"][name] = np.asarray(fn(jax.tree.map(jnp.asarray, inputs["params"][arch]),
                                             {{"tokens": tokens}}))
    for name, (arch, mesh, b, kv, rep) in T.DECODE_CASES.items():
        cfg = fp32(arch).replace(kv_cache_dtype=kv)
        params = jax.tree.map(jnp.asarray, inputs["params"][arch])
        toks = inputs["tokens"][name]
        n = toks.shape[1]
        step = steps.make_decode_step(cfg, policy_of(cfg, mesh, replicate_batch=rep), b, n)
        caches = tf.init_caches(cfg, b, n)
        logits, payloads = [], []
        for t in range(n):
            o, caches = step(params, caches, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
            logits.append(np.asarray(o))
            if kv == "int8":
                payloads.append({{f"{{i}}/{{k}}": np.asarray(c[k]) for i, c in enumerate(caches)
                                  for k in ("k", "v")}})
        out["decode"][name] = {{"logits": np.stack(logits), "payloads": payloads}}
    cfg = fp32(T.ZAMBA2)
    try:
        step = steps.make_decode_step(cfg, policy_of(cfg, T.FLAT), 4, 16)
        step(jax.tree.map(jnp.asarray, inputs["params"][T.ZAMBA2]), tf.init_caches(cfg, 4, 16),
             jnp.zeros((4, 1), jnp.int32), jnp.int32(0))
    except Exception as e:
        out["zamba2_flat"] = type(e).__name__
with open({path!r}, "wb") as f:
    pickle.dump(out, f)
"""


def _popen(code: str, *args, cwd=None):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.Popen([sys.executable, "-c", code, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=cwd)


def _finish(procs, deadline: float) -> list[tuple[int, str]]:
    """Each process's (returncode, stderr tail); past ``deadline`` every one
    still running is killed, and a hang fails the run instead of stalling it."""
    out = []
    for proc in procs:
        try:
            _, err = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            _, err = proc.communicate()
            err = f"timed out after {TIMEOUT_S} s\n{err}"
        out.append((proc.returncode, err[-3000:]))
    return out


def _inputs() -> dict:
    """JAX's seed-0 params of the state's archs, jitted as ``init_sharded_state``
    jits them (XLA fuses ``x * 0.02`` into the draw); the port's seed-0 smoke
    params of every arch (numpy), for the trainers (fp32) and the serving
    cases (their cache dtype does not change the params); and the tokens of
    every decode case, the port's one-process greedy run."""
    import jax

    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import transformer as jtf

    def jax_init(arch):
        cfg = jax_smoke(arch).replace(compute_dtype="float32")
        return jax.tree.map(np.asarray, jax.jit(lambda key: jtf.init_params(key, cfg))(
            jax.random.PRNGKey(0)))

    def port(arch):
        return ttf.init_params(torch.Generator().manual_seed(0), fp32_smoke(arch))

    params = {arch: port(arch) for arch in (DANUBE, DEEPSEEK, ZAMBA2)}
    tokens = {}
    for i, (name, (arch, _, batch, kv, _)) in enumerate(DECODE_CASES.items()):
        tokens[name] = greedy_tokens(params[arch], decode_config(arch, kv), batch, i)
    params.update({arch + "/train": port(arch) for arch in (BERT, DEEPSEEK)})
    return {"params": {k: tree_map(lambda t: t.numpy(), p) for k, p in params.items()},
            "jax_params": {arch: jax_init(arch) for arch in (BERT, DBRX)}, "tokens": tokens}


@pytest.fixture(scope="module", autouse=True)
def _started(tmp_path_factory):
    """Starts the world and the JAX references with the module's first test."""
    tmp = tmp_path_factory.mktemp("pod_mesh")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        inputs = _inputs()
    finally:
        torch.set_num_threads(n)
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    fmt = dict(src=str(ROOT / "src"), tests=str(ROOT / "tests"), out=str(tmp),
               inputs=str(tmp / "inputs.pkl"))
    jax_procs = [_popen(JAX_REFS.format(**fmt, path=str(tmp / f"jax_{i}.pkl")), part, cwd=tmp)
                 for i, part in enumerate(JAX_PARTS)]
    rank_code = RANK.format(**fmt, rdzv=str(tmp / "rendezvous"))
    ranks = [_popen(rank_code, str(r)) for r in range(WORLD)]
    yield tmp, ranks, jax_procs
    for proc in (*ranks, *jax_procs):
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def world(_started):
    tmp, ranks, _ = _started
    for r, (rc, err) in enumerate(_finish(ranks, time.monotonic() + TIMEOUT_S)):
        assert rc == 0, f"rank {r}: {err}"
    out = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:  # written by this test's own ranks
            out.append(pickle.load(f))
    return out, tmp


@pytest.fixture(scope="module")
def ref(_started):
    tmp, _, jax_procs = _started
    out = {"shards": {}, "runs": {}, "prefill": {}, "decode": {}}
    for i, (rc, err) in enumerate(_finish(jax_procs, time.monotonic() + TIMEOUT_S)):
        assert rc == 0, err
        with open(tmp / f"jax_{i}.pkl", "rb") as f:
            part = pickle.load(f)
        for k in ("shards", "runs", "prefill", "decode"):
            out[k].update(part.pop(k, {}))
        out.update(part)
    return out


def _router_gap(gap, what) -> None:
    """As ``tests/test_torch_moe_mla_tp.py``: the smallest router gap and the
    tokens under ``MIN_GAP``, where a rounding could pick another expert; a
    case with such tokens says so and is held to its limits all the same."""
    assert gap is not None, f"{what}: no MoE call recorded"
    least, near = gap
    print(f"{what}: smallest router gap {least:.3e}, {near} token(s) under {MIN_GAP:g}")
    if near:
        print(f"{what}: below the router-gap precondition; held to its limits all the same")


def _rank_coords(r: int, sizes: tuple) -> list:
    out = []
    for n in reversed(sizes):
        r, c = divmod(r, n)
        out.append(c)
    return out[::-1]


# ---------------------------------------------------------------------------
# (a) the placed state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(STATE_CASES))
@pytest.mark.parametrize("side", ["params", "m", "v"])
def test_local_shards_equal_jax_init_sharded_state(world, ref, name, side):
    expect = ref["shards"][name]
    keys = [k for k in expect if k.startswith(side + "/")]
    assert keys and sorted(keys) == sorted(k for k in world[0][0]["shards"][name]
                                           if k.startswith(side + "/"))
    for r, out in enumerate(world[0]):
        for key in keys:
            np.testing.assert_array_equal(out["shards"][name][key], expect[key][r],
                                          err_msg=f"{key} on rank {r}")


@pytest.mark.parametrize("name", list(STATE_CASES))
def test_one_dim_split_over_two_mesh_axes(world, name):
    """Every leaf takes the placements of the policy's spec, and the data entry
    ``("pod", "data")`` (``flat_dp``'s ``("data", "model")``) is one ``Shard`` per
    mesh dim on the same tensor dim: the moments (ZeRO-1) and, under ZeRO-3,
    the params."""
    arch, mesh, zero3 = STATE_CASES[name]
    names, sizes = mesh_axes(mesh)
    cfg = fp32_smoke(arch)
    policy = tpol.make_policy(cfg, tpol.MeshShape(names, sizes), zero3=zero3,
                              flat_dp=mesh == FLAT)
    shapes = dict(tpol.flatten_with_paths(ttf.param_shapes(cfg)))
    two = {"params": 0, "m": 0}
    for out in world[0]:
        placed = out["shards"][name]["placements"]
        for key, got in placed.items():
            side, path = key.split("/", 1)
            shape = tuple(shapes[path].shape)
            spec = policy.param_spec(path, shape) if side == "params" else \
                policy.opt_spec(key, shape)
            assert got == str(tuple(tpol.to_placements(spec, names))), key
            two[side] += any(isinstance(e, tuple) and len(e) == 2 for e in spec)
    assert two["m"] > 0
    assert (two["params"] > 0) == bool(zero3), two


# ---------------------------------------------------------------------------
# (b) the placement helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(HELPER_CASES))
def test_place_offsets_and_gather_on_two_axis_split(world, name):
    mesh, spec = HELPER_CASES[name]
    names, sizes = mesh_axes(mesh)
    full = np.arange(32, dtype=np.float32).reshape(8, 4)
    for r, out in enumerate(world[0]):
        got = out["helpers"][name]
        coords = dict(zip(names, _rank_coords(r, sizes)))
        assert got["coords"] == [coords[n] for n in names]
        # the rows' shard index: the entry's axes read major first
        rows_axes = spec[0]
        index = 0
        for a in rows_axes:
            index = index * dict(zip(names, sizes))[a] + coords[a]
        n_rows = 8 // int(np.prod([dict(zip(names, sizes))[a] for a in rows_axes]))
        cols = 4 // (sizes[-1] if spec[1] == "model" else 1)
        col0 = coords["model"] * cols if spec[1] == "model" else 0
        want = full[index * n_rows:(index + 1) * n_rows, col0:col0 + cols]
        np.testing.assert_array_equal(got["local"], want)
        assert got["offsets"] == [index * n_rows, col0]
        np.testing.assert_array_equal(got["filled"], np.full(want.shape, 7.0, np.float32))
        whole_cols = full[:, col0:col0 + cols]  # whole over the data axes, model kept
        np.testing.assert_array_equal(got["gathered_axes"], whole_cols)
        if mesh != FLAT:  # by default every dim but model is a data axis
            np.testing.assert_array_equal(got["gathered"], whole_cols)
        np.testing.assert_array_equal(got["full"], full)
        np.testing.assert_array_equal(got["twin_full"], full)


def test_an_entry_out_of_mesh_order_is_refused(world):
    for out in world[0]:
        assert "out of the mesh's order" in out["helpers"]["out_of_order"]


# ---------------------------------------------------------------------------
# (c), (d) the trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,mesh,comm", JAX_RUNS)
def test_trainer_tracks_jax_trainer(world, ref, arch, mesh, comm):
    name = run_name(arch, mesh, comm)
    got, expect = world[0][0]["runs"][name], ref["runs"][name]
    if arch == DEEPSEEK:
        _router_gap(expect["gap"], f"{arch} {comm} at {mesh}")
    assert got["steps"] == expect["steps"] == 4
    assert all(out["runs"][name]["final_loss"] == got["final_loss"] for out in world[0])
    if mesh == FLAT:
        assert got["flat_dp"] and (got["data"], got["model"]) == (4, 2)
    else:
        assert (got["pod"], got["data"], got["model"]) == (2, 2 * mesh[1], mesh[2])
    for k in ("first_loss", "final_loss"):
        err = abs(got[k] - expect[k]) / abs(expect[k])
        print(f"{name} {k}: {err:.3e} relative to JAX's (limit {LOSS_RTOL:g})")
        assert err <= LOSS_RTOL, k


@pytest.mark.parametrize("arch,mesh,comm", JAX_RUNS)
def test_final_params_match_jax(world, arch, mesh, comm):
    """Rank 0's step-4 checkpoint (full tensors, gathered) against JAX's."""
    _, tmp = world
    name = run_name(arch, mesh, comm)
    dirs = [tmp / side / name / "step_0000000004" for side in ("ckpt", "jax_ckpt")]
    manifests = [json.loads((d / "manifest.json").read_text()) for d in dirs]
    keys = [[m["key"] for m in man["leaves"]] for man in manifests]
    assert keys[0] == keys[1]
    tol = INT8_PARAM_RTOL if "int8" in comm else PARAM_RTOL
    worst = 0.0
    for m in manifests[0]["leaves"]:
        if m["key"].startswith("0/"):  # the params
            got, expect = (np.load(d / m["file"]) for d in dirs)
            assert got.shape == expect.shape, m["key"]
            err = np.abs(got - expect) / np.abs(expect).max()
            worst = max(worst, float(err.max()))
            past = err > tol
            if past.any():
                print(f"{name} {m['key']}: {past.sum()} of {err.size} element(s) past "
                      f"{tol:g}, the largest {err.max():.3e}")
            assert past.sum() <= PARAM_OUTLIERS * err.size, m["key"]
            assert err.max() <= max(tol, PARAM_OUTLIER_RTOL), m["key"]
    print(f"{name}: params at most {worst:.3e} of a leaf's largest entry from JAX's")


@pytest.mark.parametrize("mesh", POD_MESHES)
@pytest.mark.parametrize("comm", sorted(COMMS))
def test_pod_mesh_run_equals_its_two_axis_twin(world, mesh, comm):
    """pod × data × model trains as data = pod·data × model, bit for bit."""
    for out in world[0]:
        got = out["runs"][run_name(BERT, mesh, comm)]
        twin = out["runs"][run_name(BERT, f"twin{mesh}", comm)]
        assert (got["first_loss"], got["final_loss"]) == (twin["first_loss"], twin["final_loss"])


def test_pod_mesh_params_whole_over_data(world):
    """The trainer's result at (2, 1, 2) under xla: the params whole over the
    data axes, every rank's local shape that of its model shard."""
    got = world[0][0]["runs"][run_name(BERT, (2, 1, 2), "xla")]["local_params"]
    assert got["over_data"] == []
    assert got["shapes"]["segments/0/mlp/wi"][-1] * 2 == fp32_smoke(BERT).d_ff


def test_microbatches_count_jax_rows(world, ref):
    expect = ref["mb"]
    _router_gap(expect["gap"], f"{DEEPSEEK} microbatches=2 at {MB_MESH}")
    for out in world[0]:
        assert len(out["mb"]) == len(expect["losses"]) == MB_STEPS
        for g, e in zip(out["mb"], expect["losses"]):
            assert abs(g - e) <= LOSS_RTOL * abs(e), (out["mb"], expect["losses"])


# ---------------------------------------------------------------------------
# (g) --mesh multi
# ---------------------------------------------------------------------------

def test_mesh_multi_trains_as_the_library_path(world):
    for r, out in enumerate(world[0]):
        lib, run = out["library"], out["runs"][run_name(BERT, (2, 1, 2), "xla")]
        assert lib["losses"][0] == run["first_loss"] and lib["losses"][-1] == run["final_loss"]
        assert lib["shape"] == {"pod": 2, "data": 1, "model": 2} and lib["data"] == 2
        assert lib["group"] == [r % 2, r % 2 + 2]  # this rank's model coordinate, pod-major


def test_mesh_multi_on_a_world_of_another_size_exits(world):
    for out in world[0]:
        msg = out["unpatched_exit"]
        assert "needs 512 ranks" in msg and "a world of 4" in msg


# ---------------------------------------------------------------------------
# (e), (f) prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(PREFILL_CASES))
def test_placed_prefill_matches_jax(world, ref, name):
    expect = ref["prefill"][name]
    for out in world[0]:
        got = out["prefill"][name, False]["logits"]
        assert got.shape == expect.shape
        err = np.abs(got - expect).max() / np.abs(expect).max()
        print(f"{name}: prefill within {err:.3e} of JAX's largest logit (limit {LOGITS_RTOL:g})")
        assert err <= LOGITS_RTOL, err


def test_kernel_path_on_own_heads(world):
    """One call per layer, on the rank's rows (the batch over pod) and heads."""
    cfg = fp32_smoke(DANUBE)
    b, s = PREFILL_TOKENS
    shape_q = [b // 2, s, cfg.n_heads // 2, cfg.head_dim]
    shape_k = [b // 2, s, cfg.n_kv_heads // 2, cfg.head_dim]
    for out in world[0]:
        dense, kern = out["prefill"][KERNEL_CASE, False], out["prefill"][KERNEL_CASE, True]
        assert dense["calls"] == []
        assert np.abs(kern["logits"] - dense["logits"]).max() <= \
            1e-5 * np.abs(dense["logits"]).max()
        assert kern["calls"] == [[shape_q, shape_k]] * cfg.n_layers


def _first_flip(got: list, expect: list, steps: int) -> int:
    """The first step after which an int8 payload element differs from JAX's,
    or ``steps`` (no payloads: the bf16 cache). Each differing element lies
    one int8 step from JAX's, as ``tests/test_torch_decode_tp.py`` shows it
    may where JAX's ``x / scale`` is that close to a .5 boundary."""
    for t, (g, e) in enumerate(zip(got, expect)):
        diff = [np.abs(g[p].astype(np.int32) - e[p].astype(np.int32)) for p in e]
        if any(d.any() for d in diff):
            assert max(int(d.max()) for d in diff) == 1, t
            print(f"step {t}: {sum(int((d > 0).sum()) for d in diff)} int8 payload "
                  "element(s) one step from JAX's")
            return t
    return steps


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_placed_decode_matches_jax_every_step(world, ref, name):
    expect = ref["decode"][name]
    arch, mesh, b, kv, _ = DECODE_CASES[name]
    assert expect["logits"].shape == (PROMPT + GEN, b, 1, 256)
    for out in world[0]:
        got = out["decode"][name]
        n = len(expect["logits"])
        upto = _first_flip(got["payloads"], expect["payloads"], n)
        worst = 0.0
        for t in range(n):
            err = np.abs(got["logits"][t] - expect["logits"][t]).max() / \
                np.abs(expect["logits"][t]).max()
            worst = max(worst, float(err))
            assert err <= (LOGITS_RTOL if t < upto else INT8_FLIPPED_RTOL), (t, err)
        print(f"{name}: every step within {worst:.3e} of JAX's largest logit (limit "
              f"{LOGITS_RTOL:g}, {INT8_FLIPPED_RTOL:g} after a flip)")


@pytest.mark.parametrize("name", list(LAYOUT))
def test_decode_cache_layouts(world, name):
    """The named cache leaves take the layouts of the ``cache_spec`` branches
    the case reaches, and every rank holds its share of them alone."""
    arch, mesh, b, kv, _ = DECODE_CASES[name]
    names, sizes = mesh_axes(mesh)
    for out in world[0]:
        got = out["decode"][name]
        for path, layout in LAYOUT[name].items():
            assert got["placements"][path] == "(" + ", ".join(layout) + ")", path
            full = [b, PROMPT + GEN]
            for pl, n in zip(layout, sizes):
                if pl != R and int(pl[-2]) < 2:
                    full[int(pl[-2])] //= n
            assert got["shapes"][path][:2] == full, path


def test_zamba2_flat_dp_decode_is_refused_as_jax_refuses_it(world, ref):
    assert ref["zamba2_flat"] == "DuplicateSpecError"
    for out in world[0]:
        assert "names mesh axis 'model' twice" in out["zamba2_flat"]
