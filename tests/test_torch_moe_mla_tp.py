"""The MoE and MLA block kinds on the model axis: expert-parallel MoE and the
sequence-split latent cache in the train step, the prefill and the decode,
on a 4-rank gloo world on the CPU.

One world of four processes (a ``file://`` rendezvous under ``tmp_path``,
one intra-op thread per rank, the whole run under a timeout) runs every
case at the module's first test and writes one pickle per rank; three JAX
subprocesses on 4 fake CPU devices each (the prefill and decode references;
each arch's trainer, dbrx's with the placed state) write the references
beside it. All start together. deepseek-v2-lite's smoke config (MLA, 4 heads; 8 routed
experts top-2 and 2 shared) and dbrx's (GQA 4/2 heads; 4 routed experts
top-2), fp32, the params carried across as numpy:

  * the placed state at ``(2, 2)`` and ``(1, 4)``: every rank's local shard
    of every param and ZeRO-1 moment equals JAX ``init_sharded_state``'s,
    bit for bit (experts over model, the router whole, the shared experts
    column/row, ``w_uk``/``w_uv`` over heads);
  * the prefill against JAX ``make_prefill`` on a mesh of the same shape,
    within 2e-5 of the largest logit: deepseek at ``(1, 2)``, ``(1, 4)``
    and ``(2, 2)``, and at ``capacity_factor`` 0.5, where the experts drop
    tokens; dbrx at ``(1, 2)`` and ``(1, 4)``, its kernel path (the plain
    version under ``local_map``) within 1e-5 of dense with one call per
    layer in every rank on its own heads, and with 6 experts at ``(1, 4)``,
    which the policy replicates;
  * the trainer at data 2 × model 2 (``python -m repro_torch.launch.train
    --data-parallel 2`` in the world of 4; 4 steps, ``--wire-dtype float32``)
    with ``xla`` and ``lumorph4``, and ``lumorph2 --compress`` for deepseek:
    losses within 2e-5 relative of JAX's trainer on ``(2, 2)`` (1e-5 under
    ``--compress``), rank 0's final params (its step-4 checkpoint) within
    1e-4 of each leaf's largest entry (5e-2 under ``--compress``, as
    ``tests/test_torch_model_axis.py``; see ``PARAM_RTOL``), and every run
    within 1e-5 of the port's own model-1 run;
  * the placed decode against JAX ``make_decode_step`` per step, a replayed
    prompt then greedy tokens (the port's one-process run picks them, both
    sides are fed them), within 2e-5: deepseek at ``(1, 2)`` and ``(1, 4)``
    (``c_kv``'s sequence over model), ``(2, 2)`` batch 2 and ``(2, 2)``
    batch 1 (``pos`` over data); dbrx at ``(1, 2)`` (KV heads over model)
    and ``(1, 4)`` (sequence over model), each with the compute-dtype and
    the int8 cache (the int8 held as ``tests/test_torch_decode_tp.py``
    holds it). Every rank's local cache shapes equal JAX's shard shapes;
    ``serve.prefill_with_caches`` with the policy and the mesh replays
    deepseek's prompt at ``(1, 4)``;
  * the router-gap precondition: the JAX processes record, for every MoE
    call, each token's gap between its k-th and (k+1)-th router probability;
    every MoE case prints the smallest and the count under 1e-6 (about a
    thousand times the fp32 rounding of a TP partial sum), where a token
    could take another expert. A case with such tokens says so and is held
    to its limits all the same: it passes only if none moved;
  * the kinds left to ROADMAP item 4(d)(ii): zamba2's, xlstm's and
    whisper's placed prefill at ``(1, 2)`` against JAX ``make_prefill``;
    their placed train step and decode raise ``NotImplementedError``
    naming the item.
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
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT_S = 300
DEEPSEEK, DBRX = "deepseek-v2-lite-16b", "dbrx-132b"
ARCHES = (DEEPSEEK, DBRX)
LOGITS_RTOL = 2e-5  # fp32, relative to the largest logit (of each step, in decode)
KERNEL_RTOL = 1e-5  # the kernel path's plain version against dense, in one process
LOSS_RTOL, INT8_LOSS_RTOL = 2e-5, 1e-5
# final params, relative to each leaf's largest entry. AdamW's first steps move every
# element by about the learning rate whatever its gradient's size, so an element whose
# gradient is near zero carries rounding into its update: the port's one-program run at
# model 1, JAX's function op for op, ends 5.4e-5 from JAX's (deepseek, xla). A wrong
# gradient shows at 1e-2 (the balance loss counted per data rank: 1.1e-2)
PARAM_RTOL, INT8_PARAM_RTOL = 1e-4, 5e-2
MODEL1_RTOL = 1e-5
MIN_GAP = 1e-6  # the router's k-th against (k+1)-th probability, every token
STATE_MESHES = ((2, 2), (1, 4))  # (data, model)
# name -> (arch, data, model, config overrides)
PREFILL_CASES = {"deepseek_1x2": (DEEPSEEK, 1, 2, {}),
                 "deepseek_1x4": (DEEPSEEK, 1, 4, {}),
                 "deepseek_2x2": (DEEPSEEK, 2, 2, {}),
                 "deepseek_drops_1x4": (DEEPSEEK, 1, 4, {"moe_capacity_factor": 0.5}),
                 "dbrx_1x2": (DBRX, 1, 2, {}),
                 "dbrx_1x4": (DBRX, 1, 4, {}),
                 "dbrx_e6_1x4": (DBRX, 1, 4, {"moe_experts": 6}),
                 "zamba2_1x2": ("zamba2-1.2b", 1, 2, {}),
                 "xlstm_1x2": ("xlstm-125m", 1, 2, {}),
                 "whisper_1x2": ("whisper-tiny", 1, 2, {})}
KERNEL_CASES = ("dbrx_1x2", "dbrx_1x4")
LEFT_KINDS = ("zamba2-1.2b", "xlstm-125m", "whisper-tiny")  # ROADMAP item 4(d)(ii)
PREFILL_TOKENS = (2, 24)
TRAIN = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "32", "--steps", "4",
         "--wire-dtype", "float32", "--log-every", "100"]
TRAIN_RUNS = {"xla": ["--comm", "xla"],
              "lumorph4": ["--comm", "lumorph4"],
              "lumorph2+int8": ["--comm", "lumorph2", "--compress"]}
# one JAX process each, started together: the trainer's runs of an arch (dbrx's with the
# placed state), or the prefill and decode references
JAX_PARTS = {"refs": (), DEEPSEEK: ("xla", "lumorph4", "lumorph2+int8"),
             DBRX: ("xla", "lumorph4")}
PROMPT, GEN = 8, 8
RUN_IDS = [(arch, name) for arch in ARCHES for name in TRAIN_RUNS
           if arch == DEEPSEEK or name != "lumorph2+int8"]  # --compress for deepseek only
# name -> (arch, data, model, batch, cache)
DECODE_CASES = {"deepseek_1x2": (DEEPSEEK, 1, 2, 2, "cdt"),
                "deepseek_1x4": (DEEPSEEK, 1, 4, 2, "cdt"),
                "deepseek_2x2": (DEEPSEEK, 2, 2, 2, "cdt"),
                "deepseek_2x2_b1": (DEEPSEEK, 2, 2, 1, "cdt"),
                "dbrx_1x2": (DBRX, 1, 2, 2, "cdt"),
                "dbrx_1x4": (DBRX, 1, 4, 2, "cdt"),
                "dbrx_1x2_int8": (DBRX, 1, 2, 2, "int8"),
                "dbrx_1x4_int8": (DBRX, 1, 4, 2, "int8")}
# the layout each case's first cache leaf takes (ShardingPolicy.cache_spec)
CACHE_LAYOUT = {"deepseek_1x2": ("c_kv", "(Shard(dim=0), Shard(dim=1))"),
                "deepseek_1x4": ("c_kv", "(Shard(dim=0), Shard(dim=1))"),
                "deepseek_2x2": ("c_kv", "(Shard(dim=0), Shard(dim=1))"),
                "deepseek_2x2_b1": ("pos", "(Shard(dim=1), Replicate())"),
                "dbrx_1x2": ("k", "(Shard(dim=0), Shard(dim=2))"),
                "dbrx_1x4": ("k", "(Shard(dim=0), Shard(dim=1))"),
                "dbrx_1x2_int8": ("k", "(Shard(dim=0), Shard(dim=2))"),
                "dbrx_1x4_int8": ("k", "(Shard(dim=0), Shard(dim=1))")}
SERVE_CASE = "deepseek_1x4"
# int8 (tests/test_torch_decode_tp.py): a payload element may land one step from JAX's
# only where JAX's x / scale before rounding lies within 8 ulps of 127 of a .5 boundary;
# the logits after such a flip are held within 1e-3
INT8_FLIP_WINDOW = 8 * float(np.spacing(np.float32(127.0)))
INT8_FLIPPED_RTOL = 1e-3


def smoke(arch: str, cache: str = "cdt", **over):
    return get_smoke_config(arch).replace(
        compute_dtype="float32", kv_cache_dtype="int8" if cache == "int8" else "bfloat16",
        **over)


def fp32_smoke(arch: str):
    return get_smoke_config(arch).replace(compute_dtype="float32")


def prefill_batch(cfg) -> dict:
    rng = np.random.default_rng(7)
    out = {"tokens": rng.integers(0, cfg.vocab_size, PREFILL_TOKENS, dtype=np.int32)}
    if cfg.kind == "encdec":
        out["frames"] = rng.standard_normal((PREFILL_TOKENS[0], cfg.enc_seq_len, cfg.d_model),
                                            dtype=np.float32)
    return out


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
import os, pickle, sys, time
sys.path.insert(0, {src!r}); sys.path.insert(0, {tests!r})
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
import test_torch_moe_mla_tp as T
from repro_torch.bridge import flatten_with_paths, params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import serve, steps, train
from repro_torch.launch.mesh import ProcessMesh, init_process_mesh, split_model_axis
from repro_torch.models import transformer as tf
from repro_torch.sharding.policy import distribute_tree, gather_tree, make_policy
from repro_torch.tree import leaves, tree_map

rank, out_dir = int(sys.argv[1]), {out!r}
world = init_process_mesh("cpu", "gloo", init_method="file://" + {rdzv!r}, rank=rank,
                          world_size=T.WORLD)
with open({inputs!r}, "rb") as f:
    inputs = pickle.load(f)
pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
singles = [dist.new_group([r]) for r in range(T.WORLD)]


def mesh_of(data, model):
    if model == T.WORLD // data:
        return split_model_axis(world, data)
    # ranks {{0, 1}} and {{2, 3}} each a (1, 2) mesh of their own
    dm = DeviceMesh.from_group([singles[rank], pairs[rank // 2]], "cpu",
                               mesh=[[2 * (rank // 2), 2 * (rank // 2) + 1]],
                               mesh_dim_names=("data", "model"))
    return ProcessMesh(rank=rank, world=2, group=singles[rank], backend="gloo",
                       device=torch.device("cpu"), model=2, device_mesh=dm)


def index(data, model):
    return rank % 2 if model == 2 and data == 1 else rank


out = {{"shards": {{}}, "prefill": {{}}, "decode": {{}}, "left": {{}}}}

# the prefill; the kernel path's calls counted per rank
counted = ops.flash_attention
calls = []
def seen(q, k, v, **kw):
    calls.append([list(q.shape), list(k.shape)])
    return counted(q, k, v, **kw)
ops.flash_attention = seen
for name, (arch, data, model, over) in T.PREFILL_CASES.items():
    mesh = mesh_of(data, model)
    cfg = T.smoke(arch, **over)
    params = tree_map(torch.from_numpy, inputs["params"][name])
    batch = {{k: torch.from_numpy(v) for k, v in T.prefill_batch(cfg).items()}}
    for kernel in (False, True) if name in T.KERNEL_CASES else (False,):
        c = cfg.replace(use_pallas=kernel)
        calls.clear()
        logits = steps.make_prefill(c, "cpu", make_policy(c, mesh), mesh)(params, batch)
        out["prefill"][name, kernel] = {{"logits": gather_tree(logits).numpy(),
                                        "calls": list(calls)}}
ops.flash_attention = counted

# the trainer at data 2 x model 2, its step-4 checkpoint beside JAX's
train.get_smoke_config = T.fp32_smoke
out["runs"] = {{}}
for arch in T.ARCHES:
    for name in [n for a, n in T.RUN_IDS if a == arch]:
        out["runs"][arch, name] = train.main(
            ["--arch", arch] + T.TRAIN + T.TRAIN_RUNS[name] + ["--data-parallel", "2", "--ckpt-dir",
             os.path.join(out_dir, "ckpt", arch, name), "--ckpt-every", "4"])


def decode_run(cfg, policy, mesh, params, tokens):
    b, n = tokens.shape
    step = steps.make_decode_step(cfg, "cpu", policy, mesh, b, n)
    caches = steps.init_placed_caches(cfg, policy, mesh, b, n)
    toks = torch.from_numpy(tokens).long()
    logits, payloads = [], []
    for t in range(n):
        o, caches = step(params, caches, toks[:, t:t + 1], t)
        logits.append(gather_tree(o).numpy())
        if cfg.kv_cache_dtype == "int8":  # the int8 payloads after every step
            payloads.append({{p: c.numpy() for p, c in flatten_with_paths(gather_tree(
                [{{k: c[k] for k in ("k", "v")}} for c in caches]))}})
    return {{"logits": np.stack(logits), "payloads": payloads,
             "shapes": {{p: list(c.to_local().shape) for p, c in flatten_with_paths(caches)}},
             "placements": {{p: str(c.placements) for p, c in flatten_with_paths(caches)}}}}


for name, (arch, data, model, batch, cache) in T.DECODE_CASES.items():
    mesh = mesh_of(data, model)
    cfg = T.smoke(arch, cache)
    params = tree_map(torch.from_numpy, inputs["params"][arch])
    res = decode_run(cfg, make_policy(cfg, mesh), mesh, params, inputs["tokens"][name])
    res["index"] = index(data, model)
    out["decode"][name] = res

# the prompt replayed by serve.prefill_with_caches on the placed caches
arch, data, model, batch, cache = T.DECODE_CASES[T.SERVE_CASE]
mesh = mesh_of(data, model)
cfg = T.smoke(arch, cache)
tokens = torch.from_numpy(inputs["tokens"][T.SERVE_CASE]).long()
logits, caches = serve.prefill_with_caches(
    tree_map(torch.from_numpy, inputs["params"][arch]), {{"tokens": tokens[:, :T.PROMPT]}},
    cfg, tokens.shape[1], "cpu", make_policy(cfg, mesh), mesh)
out["serve"] = {{"placed": all(isinstance(c, DTensor) for c in leaves(caches)),
                "logits": gather_tree(logits).numpy(),
                "pos": [gather_tree(c["pos"]).numpy() for c in caches]}}

# the kinds left to item 4(d)(ii): the placed train step and decode raise
mesh = mesh_of(1, 2)
for arch in T.LEFT_KINDS:
    cfg = T.smoke(arch)
    policy = make_policy(cfg, mesh)
    for what, make in (
            ("train", lambda: steps.make_train_step(cfg, comm="xla", dp=1, device="cpu",
                                                    group=mesh.group, policy=policy,
                                                    mesh=mesh)),
            ("decode", lambda: steps.make_decode_step(cfg, "cpu", policy, mesh, 2, 8)),
            ("caches", lambda: steps.init_placed_caches(cfg, policy, mesh, 2, 8))):
        try:
            make()
            out["left"][arch, what] = None
        except NotImplementedError as e:
            out["left"][arch, what] = str(e)

# the placed state: JAX's params (written by the JAX process that makes its state), and
# the moments as the trainer makes them under xla
while not os.path.exists({jax_params!r}):
    time.sleep(0.2)
with open({jax_params!r}, "rb") as f:
    jax_params = pickle.load(f)
for arch in T.ARCHES:
    cfg = T.fp32_smoke(arch)
    for data, model in T.STATE_MESHES:
        mesh = mesh_of(data, model)
        policy = train.checked_policy(cfg, mesh)
        _, opt = steps.init_train_state(cfg, data, 0, "cpu", group=mesh.group, policy=policy,
                                        mesh=mesh, comm="xla")
        params = distribute_tree(params_from_numpy(jax_params[arch]),
                                 policy.param_specs(tf.param_shapes(cfg)), mesh.device_mesh)
        out["shards"][arch, data, model] = {{
            f"{{side}}/{{path}}": t.to_local().numpy()
            for side, tree in (("params", params), ("m", opt["m"]), ("v", opt["v"]))
            for path, t in flatten_with_paths(tree)}}
        out["shards"][arch, data, model]["placements"] = {{
            path: str(t.placements) for path, t in flatten_with_paths(params)}}
dist.destroy_process_group()
with open(os.path.join(out_dir, f"rank{{rank}}.pkl"), "wb") as f:
    pickle.dump(out, f)
"""

JAX_REFS = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, {src!r}); sys.path.insert(0, {tests!r})
import numpy as np
import jax, jax.numpy as jnp
import test_torch_moe_mla_tp as T
from repro import compat
from repro.checkpoint.checkpoint import _flatten_with_paths
from repro.configs import get_smoke_config
from repro.launch import steps, train
from repro.models import attention as attn
from repro.models import moe as moe_lib
from repro.models import transformer as tf
from repro.sharding.policy import make_policy

part = sys.argv[1]  # a key of T.JAX_PARTS
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
    # (the smallest gap, the near-tie tokens) since the last call; None without MoE calls
    jax.effects_barrier()
    out = (min(g for g, _ in GAPS), sum(n for _, n in GAPS)) if GAPS else None
    GAPS.clear()
    return out


# every int8 quantization's x / scale before rounding, by call site (k then v per layer)
RATIOS, SITES = {{}}, [0, 0]
_quant_kv = attn._quant_kv


def _recorded_quant_kv(x):
    site = SITES[0] % SITES[1]
    SITES[0] += 1
    x32 = x.astype(jnp.float32)
    scale = jnp.maximum(jnp.max(jnp.abs(x32), axis=-1), 1e-12) / 127.0
    jax.debug.callback(lambda r: RATIOS.__setitem__(f"{{site // 2}}/{{'kv'[site % 2]}}",
                                                    np.asarray(r)), x32 / scale[..., None])
    return _quant_kv(x)


attn._quant_kv = _recorded_quant_kv


def smoke(arch, cache="cdt", **over):
    return get_smoke_config(arch).replace(
        compute_dtype="float32", kv_cache_dtype="int8" if cache == "int8" else "bfloat16",
        **over)


def by_rank(leaf, mesh):
    shards = {{s.device: np.asarray(s.data) for s in leaf.addressable_shards}}
    return [shards[d] for d in mesh.devices.flat]  # rank r = d * model + m


def mesh_of(data, model):
    return compat.make_mesh((data, model), ("data", "model"),
                            devices=jax.devices()[:data * model])


def decode_run(cfg, policy, mesh, params, tokens):
    b, n = tokens.shape
    step = steps.make_decode_step(cfg, policy, b, n)
    caches = tf.init_caches(cfg, b, n)
    logits, payloads, ratios, shapes = [], [], [], None
    SITES[:] = [0, 2 * cfg.n_layers]
    gaps()
    for t in range(n):
        o, caches = step(params, caches, jnp.asarray(tokens[:, t:t + 1]), jnp.int32(t))
        logits.append(np.asarray(o))
        jax.effects_barrier()
        ratios.append(dict(RATIOS))
        RATIOS.clear()
        if shapes is None:
            shapes = {{p: [list(s.shape) for s in by_rank(c, mesh)]
                       for p, c in _flatten_with_paths(caches)}}
        if cfg.kv_cache_dtype == "int8":
            payloads.append({{p: np.asarray(c) for p, c in _flatten_with_paths(
                [{{k: c[k] for k in ("k", "v")}} for c in caches])}})
    return {{"logits": np.stack(logits), "payloads": payloads, "ratios": ratios,
             "shapes": shapes, "gap": gaps()}}


out = {{}}
if part == T.DBRX:  # the placed state
    out["shards"], whole = {{}}, {{}}
    for arch in T.ARCHES:
        cfg = smoke(arch)
        for data, model in T.STATE_MESHES:
            mesh = mesh_of(data, model)
            params, opt = steps.init_sharded_state(cfg, make_policy(cfg, mesh),
                                                   jax.random.PRNGKey(0))
            whole.setdefault(arch, jax.tree.map(np.asarray, params))
            out["shards"][arch, data, model] = {{
                f"{{side}}/{{path}}": by_rank(leaf, mesh)
                for side, tree in (("params", params), ("m", opt["m"]), ("v", opt["v"]))
                for path, leaf in _flatten_with_paths(tree)}}
    with open({jax_params!r} + ".part", "wb") as f:  # for the ranks to place
        pickle.dump(whole, f)
    os.replace({jax_params!r} + ".part", {jax_params!r})
if part == "refs":
    out.update(prefill={{}}, decode={{}})
    for name, (arch, data, model, over) in T.PREFILL_CASES.items():
        cfg = smoke(arch, **over)
        fn = steps.make_prefill(cfg, make_policy(cfg, mesh_of(data, model)))
        params = jax.tree.map(jnp.asarray, inputs["params"][name])
        batch = {{k: jnp.asarray(v) for k, v in T.prefill_batch(cfg).items()}}
        out["prefill"][name] = {{"logits": np.asarray(fn(params, batch)), "gap": gaps()}}
    for name, (arch, data, model, batch, cache) in T.DECODE_CASES.items():
        mesh = mesh_of(data, model)
        cfg = smoke(arch, cache)
        params = jax.tree.map(jnp.asarray, inputs["params"][arch])
        out["decode"][name] = decode_run(cfg, make_policy(cfg, mesh), mesh, params,
                                         inputs["tokens"][name])
# the trainer at data 2 x model 2 from the port's seed-0 params
_init = steps.init_sharded_state
def init_from_port(cfg, policy, rng, init_ef=False):
    params, opt = _init(cfg, policy, rng, init_ef)
    params = jax.tree.map(lambda p, a: jax.device_put(jnp.asarray(a, p.dtype), p.sharding),
                          params, inputs["params"][cfg.name.removesuffix("-smoke") + "/train"])
    return params, opt
steps.init_sharded_state = init_from_port
train.get_smoke_config = lambda arch: get_smoke_config(arch).replace(compute_dtype="float32")
out["runs"] = {{}}
for name in T.JAX_PARTS[part]:
    gaps()
    res = train.main(["--arch", part] + [f for f in T.TRAIN if f not in ("--device", "cpu")]
                     + T.TRAIN_RUNS[name] + ["--data-parallel", "2", "--ckpt-dir",
                                             os.path.join({out!r}, "jax_ckpt", part, name),
                                             "--ckpt-every", "4"])
    res["gap"] = gaps()
    out["runs"][part, name] = res
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
    """The port's seed-0 smoke params (numpy) of every case's config, and the
    tokens of every decode case."""
    def port(cfg):
        return ttf.init_params(torch.Generator().manual_seed(0), cfg)

    params = {name: port(smoke(arch, **over))
              for name, (arch, _, _, over) in PREFILL_CASES.items()}
    params.update({arch: port(smoke(arch)) for arch in ARCHES})
    params.update({arch + "/train": port(fp32_smoke(arch)) for arch in ARCHES})
    tokens = {name: greedy_tokens(params[arch], smoke(arch, cache), batch, i)
              for i, (name, (arch, _, _, batch, cache)) in enumerate(DECODE_CASES.items())}
    return {"params": {k: tree_map(lambda t: t.numpy(), p) for k, p in params.items()},
            "tokens": tokens}


@pytest.fixture(scope="module", autouse=True)
def _started(tmp_path_factory):
    """Starts the world and the JAX references with the module's first test."""
    tmp = tmp_path_factory.mktemp("moe_mla_tp")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        inputs = _inputs()
    finally:
        torch.set_num_threads(n)
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    fmt = dict(src=str(ROOT / "src"), tests=str(ROOT / "tests"), out=str(tmp),
               inputs=str(tmp / "inputs.pkl"), jax_params=str(tmp / "jax_params.pkl"))
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
    out = {"runs": {}}
    for i, (rc, err) in enumerate(_finish(jax_procs, time.monotonic() + TIMEOUT_S)):
        assert rc == 0, err
        with open(tmp / f"jax_{i}.pkl", "rb") as f:
            part = pickle.load(f)
        out["runs"].update(part.pop("runs", {}))
        out.update(part)
    return out


@pytest.fixture(scope="module")
def model1_runs(world):
    """The port's model-1 runs: the same flags on 2 virtual ranks, one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    get = ttrain.get_smoke_config
    ttrain.get_smoke_config = fp32_smoke
    try:
        return {(arch, name): ttrain.main(["--arch", arch] + TRAIN + TRAIN_RUNS[name]
                                          + ["--data-parallel", "2"])
                for arch, name in RUN_IDS}
    finally:
        ttrain.get_smoke_config = get
        torch.set_num_threads(n)


def _router_gap(gap, what) -> None:
    """The precondition of every MoE case: no token's k-th router probability
    lies within ``MIN_GAP`` of its (k+1)-th, where a TP partial sum's
    rounding could pick another expert. It is printed with the count of
    tokens under it. A case that has such tokens says so and is held to its
    limits all the same: it passes only if none took another expert."""
    assert gap is not None, f"{what}: no MoE call recorded"
    least, near = gap
    print(f"{what}: smallest router gap {least:.3e}, {near} token(s) under {MIN_GAP:g}")
    if near:
        print(f"{what}: below the router-gap precondition; held to its limits all the same")


def _assert_logits_close(got: np.ndarray, expect: np.ndarray, rtol: float = LOGITS_RTOL,
                         first: int = 0) -> None:
    assert got.shape == expect.shape
    for t in range(expect.shape[0]):
        err = np.abs(got[t] - expect[t]).max()
        assert err <= rtol * np.abs(expect[t]).max(), (first + t, err)


# ---------------------------------------------------------------------------
# the placed state
# ---------------------------------------------------------------------------

STATE_IDS = [(arch, data, model) for arch in ARCHES for data, model in STATE_MESHES]


@pytest.mark.parametrize("arch,data,model", STATE_IDS)
@pytest.mark.parametrize("side", ["params", "m", "v"])
def test_local_shards_equal_jax_init_sharded_state(world, ref, arch, data, model, side):
    expect = ref["shards"][arch, data, model]
    keys = [k for k in expect if k.startswith(side + "/")]
    assert keys and sorted(keys) == sorted(k for k in world[0][0]["shards"][arch, data, model]
                                           if k.startswith(side + "/"))
    for r, out in enumerate(world[0]):
        for key in keys:
            np.testing.assert_array_equal(out["shards"][arch, data, model][key],
                                          expect[key][r], err_msg=f"{key} on rank {r}")


@pytest.mark.parametrize("arch,data,model", STATE_IDS)
def test_experts_split_router_whole(world, arch, data, model):
    """Experts over model (no rank holds a whole expert leaf), the router and
    the latent projections whole, the shared experts column/row parallel,
    MLA's heads over model."""
    placed = world[0][0]["shards"][arch, data, model]["placements"]
    seg = 1 if arch == DEEPSEEK else 0  # deepseek's first segment is its dense layer
    for leaf in ("wi", "wg", "wo"):
        assert placed[f"segments/{seg}/moe/{leaf}"] == "(Replicate(), Shard(dim=1))"
    assert placed[f"segments/{seg}/moe/router"] == "(Replicate(), Replicate())"
    shapes = world[0][0]["shards"][arch, data, model]
    full = ttf.param_shapes(fp32_smoke(arch))["segments"][seg]["moe"]["wi"].shape
    assert shapes[f"params/segments/{seg}/moe/wi"].shape[1] == full[1] // model
    if arch == DEEPSEEK:
        assert placed["segments/1/moe/shared/wi"] == "(Replicate(), Shard(dim=2))"
        assert placed["segments/1/moe/shared/wo"] == "(Replicate(), Shard(dim=1))"
        for leaf in ("wq", "w_uk", "w_uv"):
            assert placed[f"segments/0/attn/{leaf}"] == "(Replicate(), Shard(dim=2))"
        for leaf in ("w_dkv", "w_kpe"):
            assert placed[f"segments/0/attn/{leaf}"] == "(Replicate(), Replicate())"


# ---------------------------------------------------------------------------
# the prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(PREFILL_CASES))
def test_placed_prefill_matches_jax(world, ref, name):
    expect = ref["prefill"][name]
    if expect["gap"] is not None:
        _router_gap(expect["gap"], name)
    for out in world[0]:
        got = out["prefill"][name, False]["logits"]
        assert got.shape == expect["logits"].shape
        err = np.abs(got - expect["logits"]).max()
        assert err <= LOGITS_RTOL * np.abs(expect["logits"]).max(), err


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_kernel_path_matches_dense_on_own_heads(world, name):
    arch, _, model, _ = PREFILL_CASES[name]
    cfg = smoke(arch)
    b, s = PREFILL_TOKENS
    for out in world[0]:
        dense, kern = out["prefill"][name, False], out["prefill"][name, True]
        assert dense["calls"] == []
        assert np.abs(kern["logits"] - dense["logits"]).max() <= \
            KERNEL_RTOL * np.abs(dense["logits"]).max()
        local_kv = max(1, cfg.n_kv_heads // model)
        assert kern["calls"] == [[[b, s, cfg.n_heads // model, cfg.head_dim],
                                  [b, s, local_kv, cfg.head_dim]]] * cfg.n_layers


def test_capacity_drops_and_replicated_experts_are_exercised():
    """The drop case's capacity is under its load, and 6 experts do not
    split over 4 ranks."""
    arch, _, model, over = PREFILL_CASES["deepseek_drops_1x4"]
    cfg = smoke(arch, **over)
    s = PREFILL_TOKENS[1]
    assert int(s * cfg.moe_top_k / cfg.moe_experts * cfg.moe_capacity_factor) < \
        s * cfg.moe_top_k / cfg.moe_experts
    arch, _, model, over = PREFILL_CASES["dbrx_e6_1x4"]
    assert smoke(arch, **over).moe_experts % model


# ---------------------------------------------------------------------------
# the trainer at data 2 x model 2
# ---------------------------------------------------------------------------



@pytest.mark.parametrize("arch,name", RUN_IDS)
def test_trainer_tracks_jax_trainer(world, ref, arch, name):
    got, expect = world[0][0]["runs"][arch, name], ref["runs"][arch, name]
    _router_gap(expect["gap"], f"{arch} {name}")
    assert got["steps"] == expect["steps"] == 4
    assert (got["world"], got["data"], got["model"]) == (WORLD, 2, 2)
    assert all(out["runs"][arch, name]["final_loss"] == got["final_loss"] for out in world[0])
    tol = INT8_LOSS_RTOL if "--compress" in TRAIN_RUNS[name] else LOSS_RTOL
    for k in ("first_loss", "final_loss"):
        assert got[k] == pytest.approx(expect[k], rel=tol), k


@pytest.mark.parametrize("arch,name", RUN_IDS)
def test_final_params_match_jax(world, ref, arch, name):
    """Rank 0's step-4 checkpoint (full tensors, gathered) against JAX's: the
    experts, the router and the latent projections included."""
    _router_gap(ref["runs"][arch, name]["gap"], f"{arch} {name}")
    _, tmp = world
    dirs = [tmp / side / arch / name / "step_0000000004" for side in ("ckpt", "jax_ckpt")]
    manifests = [json.loads((d / "manifest.json").read_text()) for d in dirs]
    keys = [[m["key"] for m in man["leaves"]] for man in manifests]
    assert keys[0] == keys[1]
    params = [k for k in keys[0] if k.startswith("0/")]
    assert any(k.endswith("moe/router") for k in params)
    tol = INT8_PARAM_RTOL if "--compress" in TRAIN_RUNS[name] else PARAM_RTOL
    for m in manifests[0]["leaves"]:
        if m["key"] in params:
            got, expect = (np.load(d / m["file"]) for d in dirs)
            assert got.shape == expect.shape, m["key"]
            assert np.abs(got - expect).max() <= tol * np.abs(expect).max(), m["key"]


@pytest.mark.parametrize("arch,name", RUN_IDS)
def test_model_axis_run_equals_model1_run(world, model1_runs, arch, name):
    got, expect = world[0][0]["runs"][arch, name], model1_runs[arch, name]
    for k in ("first_loss", "final_loss"):
        assert got[k] == pytest.approx(expect[k], rel=MODEL1_RTOL), k


# ---------------------------------------------------------------------------
# the placed decode
# ---------------------------------------------------------------------------

def _first_flip(got: list, expect: list, steps: int) -> int:
    """The first step after which an int8 payload element differs from
    JAX's, or ``steps`` (no payloads: the compute-dtype cache)."""
    for t, (g, e) in enumerate(zip(got, expect)):
        if any(not np.array_equal(g[p], e[p]) for p in e):
            return t
    return steps


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_placed_decode_matches_jax_every_step(world, ref, name):
    """Every step within 2e-5; with the int8 cache, every step until an int8
    payload element first lands one step from JAX's, and the steps after it
    within ``INT8_FLIPPED_RTOL``."""
    expect = ref["decode"][name]
    _router_gap(expect["gap"], name)
    assert expect["logits"].shape == (PROMPT + GEN, DECODE_CASES[name][3], 1, 256)
    for out in world[0]:
        got = out["decode"][name]
        upto = _first_flip(got["payloads"], expect["payloads"], len(expect["logits"]))
        assert upto == len(expect["logits"]) or DECODE_CASES[name][4] == "int8"
        _assert_logits_close(got["logits"][:upto], expect["logits"][:upto])
        _assert_logits_close(got["logits"][upto:], expect["logits"][upto:], INT8_FLIPPED_RTOL,
                             upto)


@pytest.mark.parametrize("name", [n for n, c in DECODE_CASES.items() if c[4] == "int8"])
def test_int8_payloads_match_jax_up_to_rare_one_step_flips(world, ref, name):
    """As ``tests/test_torch_decode_tp.py``: after every step the payloads
    equal JAX's but at the slot the step wrote, where an element may lie one
    step from JAX's only if JAX's ``x / scale`` is within
    ``INT8_FLIP_WINDOW`` of a .5 boundary."""
    expect = ref["decode"][name]
    assert len(expect["payloads"]) == len(expect["ratios"]) == PROMPT + GEN
    for out in world[0]:
        got = out["decode"][name]["payloads"]
        prev = {p: np.zeros_like(e) for p, e in expect["payloads"][0].items()}
        for t, (g, e, r) in enumerate(zip(got, expect["payloads"], expect["ratios"])):
            assert sorted(g) == sorted(e) == sorted(r) and len(e) == 2 * 2  # k, v; 2 layers
            slot = t % e["0/k"].shape[1]
            for p in e:
                assert np.array_equal(np.delete(g[p], slot, 1), np.delete(prev[p], slot, 1)), \
                    (t, p)
                gs, es = g[p][:, slot].astype(np.int32), e[p][:, slot].astype(np.int32)
                ratio = r[p][:, 0]
                assert ratio.shape == gs.shape
                flip = gs != es
                lo = np.floor(ratio)
                assert np.all(np.abs(ratio - (lo + 0.5))[flip] <= INT8_FLIP_WINDOW), (t, p)
                assert np.all(np.minimum(gs, es)[flip] == lo[flip]), (t, p)
                assert np.all(np.abs(gs - es)[flip] == 1), (t, p)
            prev = g


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_local_cache_shapes_equal_jax_shards(world, ref, name):
    """No rank holds a whole sequence-split ``c_kv``: each local shape is the
    matching JAX device's shard, and the first leaf takes the layout of
    the ``cache_spec`` branch the case is named for."""
    expect = ref["decode"][name]["shapes"]
    leaf, layout = CACHE_LAYOUT[name]
    for out in world[0]:
        got = out["decode"][name]
        assert sorted(got["shapes"]) == sorted(expect)
        for path, shape in got["shapes"].items():
            assert shape == expect[path][got["index"]], path
        assert got["placements"][f"0/{leaf}"] == layout


def test_serve_replay_on_placed_caches(world):
    """``serve.prefill_with_caches`` with the policy and the mesh ends on the
    placed decode's logits at the prompt's last step, bit for bit, with the
    caches placed and the prompt's positions written."""
    for out in world[0]:
        res = out["serve"]
        assert res["placed"]
        np.testing.assert_array_equal(res["logits"],
                                      out["decode"][SERVE_CASE]["logits"][PROMPT - 1])
        want = np.where(np.arange(PROMPT + GEN) < PROMPT, np.arange(PROMPT + GEN), -1)
        for pos in res["pos"]:
            assert (pos == want).all()


# ---------------------------------------------------------------------------
# the kinds left to ROADMAP item 4(d)(ii)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LEFT_KINDS)
@pytest.mark.parametrize("what", ["train", "decode", "caches"])
def test_left_kinds_raise_on_the_model_axis(world, arch, what):
    for out in world[0]:
        msg = out["left"][arch, what]
        assert msg is not None and "ROADMAP Queue 1 item 4(d)(ii)" in msg, msg
