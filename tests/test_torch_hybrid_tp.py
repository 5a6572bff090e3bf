"""The SSM, hybrid, encoder-decoder and VLM kinds on the model axis: the
replicated mixers beside head-split decode states, zamba2's shared block,
whisper's cross-attention and paligemma's image prefix in the train step, the
prefill and the decode, on a 4-rank gloo world on the CPU.

One world of four processes (a ``file://`` rendezvous under ``tmp_path``,
one intra-op thread per rank, the whole run under a timeout) runs every case
at the module's first test and writes one pickle per rank; JAX subprocesses
on 4 fake CPU devices each (the prefill and decode references of two archs
each, with the placed state; the trainers, four processes) write the
references beside it. All start together. The smoke configs of zamba2-1.2b
(5 mamba2 layers of 8 SSM heads, the shared block of 4 heads before layers 2
and 4), xlstm-125m (mLSTM and sLSTM of 4 heads), whisper-tiny (6 heads; a
24-frame encoder) and paligemma-3b (4 query heads, 1 KV head, 8 image
tokens), fp32, the params carried across as numpy:

  * the placed state at ``(2, 2)`` and ``(1, 4)``: every rank's local shard
    of every param and ZeRO-1 moment equals JAX ``init_sharded_state``'s,
    bit for bit (the mixers and ``shared_proj`` whole over model);
  * the prefill against JAX ``make_prefill`` on a mesh of the same shape,
    within 2e-5 of the largest logit: zamba2, xlstm and whisper at ``(1,
    4)`` and ``(2, 2)``, paligemma at ``(1, 2)`` and ``(2, 2)`` with its
    image prefix; zamba2's and whisper's kernel path (the plain version under
    ``local_map``) within 1e-5 of dense, with one call per shared-block site
    or encoder layer in every rank, on its own heads (all 6 of whisper's at
    model 4, where the policy replicates them);
  * the placed decode against JAX ``make_decode_step`` per step, a replayed
    prompt then greedy tokens (the port's one-process run picks them, both
    sides are fed them), within 2e-5, at ``(1, 2)``, ``(1, 4)`` and ``(2,
    2)``, batch 2: mamba2's ``h`` and mLSTM's ``C`` over their heads beside
    whole conv, ``n``, ``m`` and sLSTM states; zamba2's shared cache's KV
    heads over model; whisper's cross pair over its heads at ``(1, 2)`` and
    replicated at ``(1, 4)``, where its self-attention cache's sequence goes
    over model (6 heads), the pair filled from each side's own encoder
    output (the port's through ``steps.make_encode`` placed); paligemma's
    one KV head putting the sequence over model. Every rank's local cache
    shapes equal JAX's shard shapes; ``serve.prefill_with_caches`` with the
    policy and the mesh replays zamba2's prompt at ``(1, 4)``;
  * the trainer at data 2 × model 2 (``python -m repro_torch.launch.train
    --data-parallel 2`` in the world of 4; 4 steps, ``--wire-dtype
    float32``): ``xla`` for all four, ``lumorph4`` for zamba2 and whisper,
    and ``lumorph2 --compress`` for zamba2 (the replicated mixers' whole
    leaves int8-blocked): losses within 2e-5 relative of JAX's trainer on
    ``(2, 2)`` (1e-5 under ``--compress``), rank 0's final params (its step-4
    checkpoint) within 1e-4 of each leaf's largest entry (5e-2 under
    ``--compress``, as ``tests/test_torch_moe_mla_tp.py``), and every run
    within 1e-5 of the port's own model-1 run;
  * microbatches across processes: deepseek-v2-lite's smoke config (MoE),
    ``make_train_step(comm="xla", microbatches=2)`` at data 2 × model 1 (two
    processes) and data 2 × model 2, 2 steps, each loss within 2e-5 relative
    of JAX's ``make_train_step`` with the same flags on a mesh of the same
    shape: each rank's microbatch ``i`` is its share of JAX's global
    microbatch ``i``, so that the balance loss counts JAX's rows. The JAX
    process records each MoE call's router gaps, printed as in
    ``tests/test_torch_moe_mla_tp.py``.
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
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT_S = 480
ZAMBA2, XLSTM, WHISPER, PALIGEMMA = "zamba2-1.2b", "xlstm-125m", "whisper-tiny", "paligemma-3b"
ARCHES = (ZAMBA2, XLSTM, WHISPER, PALIGEMMA)
DEEPSEEK = "deepseek-v2-lite-16b"
LOGITS_RTOL = 2e-5  # fp32, relative to the largest logit (of each step, in decode)
KERNEL_RTOL = 1e-5  # the kernel path's plain version against dense, in one process
LOSS_RTOL, INT8_LOSS_RTOL = 2e-5, 1e-5
PARAM_RTOL, INT8_PARAM_RTOL = 1e-4, 5e-2  # as tests/test_torch_moe_mla_tp.py
# AdamW scales each element's update by its own gradient's size, so an element whose
# gradient is small against the leaf's carries the leaf's gradient rounding (fp32, ~3e-6
# of the leaf's largest, port against JAX in one process) into a visible share of its
# update: xlstm's step-4 mLSTM wq has one element of 16,384 at 1.5e-4 of the leaf's
# largest entry, as far from JAX in the port's one-process run (1.6e-4). Such elements
# are printed and held to PARAM_OUTLIER_RTOL, at most PARAM_OUTLIERS of a leaf's
PARAM_OUTLIERS, PARAM_OUTLIER_RTOL = 1e-3, 1e-3
MODEL1_RTOL = 1e-5
MIN_GAP = 1e-6  # the router's k-th against (k+1)-th probability, every token
STATE_MESHES = ((2, 2), (1, 4))  # (data, model)
# name -> (arch, data, model)
PREFILL_CASES = {"zamba2_1x4": (ZAMBA2, 1, 4), "zamba2_2x2": (ZAMBA2, 2, 2),
                 "xlstm_1x4": (XLSTM, 1, 4), "xlstm_2x2": (XLSTM, 2, 2),
                 "whisper_1x4": (WHISPER, 1, 4), "whisper_2x2": (WHISPER, 2, 2),
                 "paligemma_1x2": (PALIGEMMA, 1, 2), "paligemma_2x2": (PALIGEMMA, 2, 2)}
KERNEL_CASES = ("zamba2_1x4", "zamba2_2x2", "whisper_1x4", "whisper_2x2")
PREFILL_TOKENS = (2, 24)
TRAIN = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "32", "--steps", "4",
         "--wire-dtype", "float32", "--log-every", "100"]
TRAIN_RUNS = {"xla": ["--comm", "xla"],
              "lumorph4": ["--comm", "lumorph4"],
              "lumorph2+int8": ["--comm", "lumorph2", "--compress"]}
RUN_IDS = [(ZAMBA2, "xla"), (ZAMBA2, "lumorph4"), (ZAMBA2, "lumorph2+int8"),
           (XLSTM, "xla"), (WHISPER, "xla"), (WHISPER, "lumorph4"), (PALIGEMMA, "xla")]
# microbatches across processes: deepseek smoke (MoE), xla, 2 microbatches, 2 steps
MB_ARCH, MB_STEPS, MB_BATCH, MB_SEQ = DEEPSEEK, 2, 4, 32
MB_MESHES = ((2, 1), (2, 2))
# one JAX process each, started together: part -> (the archs whose prefill and decode
# references it runs, the trainer runs it makes); "refs_enc" also makes the placed state,
# "microbatches" the microbatch runs. None takes longer than the world (~80 s)
JAX_PARTS = {"refs_ssm": ((ZAMBA2, XLSTM), [(XLSTM, "xla")]),
             "refs_enc": ((WHISPER, PALIGEMMA), []),
             "train_zamba2": ((), [(ZAMBA2, "xla"), (ZAMBA2, "lumorph4")]),
             "train_whisper": ((), [(WHISPER, "xla"), (WHISPER, "lumorph4")]),
             "train_rest": ((), [(ZAMBA2, "lumorph2+int8"), (PALIGEMMA, "xla")]),
             "microbatches": ((), [])}
assert sorted(r for _, runs in JAX_PARTS.values() for r in runs) == sorted(RUN_IDS)
PROMPT, GEN = 8, 8
# name -> (arch, data, model, batch)
DECODE_CASES = {f"{a.split('-')[0]}_{d}x{m}": (a, d, m, 2)
                for a in ARCHES for d, m in ((1, 2), (1, 4), (2, 2))}
# the layout that each case's named cache leaves take (ShardingPolicy.cache_spec)
# (the batch over data, then dim 1 or 2 over model, or nothing over model)
DIM1, DIM2, WHOLE = "(Shard(dim=0), Shard(dim=1))", "(Shard(dim=0), Shard(dim=2))", \
    "(Shard(dim=0), Replicate())"
# mamba2's h [B, H, P, N] and mLSTM's C [B, H, hd, hd] over their heads; zamba2's shared
# cache (layer 2) over its KV heads; paligemma's one KV head puts the sequence over model
LAYOUT = {ZAMBA2: {"0/h": DIM1, "0/conv": WHOLE, "2/k": DIM2},
          XLSTM: {"0/C": DIM1, "0/n": WHOLE, "0/m": WHOLE, "1/c": WHOLE},
          PALIGEMMA: {"0/k": DIM1, "0/pos": WHOLE}}
# whisper: the cross pair over its 6 heads at model 2, whole at 4, where the
# self-attention cache's sequence goes over model
CACHE_LAYOUT = {name: dict(LAYOUT[arch]) if arch != WHISPER else
                ({"0/cross_k": DIM2, "0/self/k": DIM2} if model == 2 else
                 {"0/cross_k": WHOLE, "0/self/k": DIM1})
                for name, (arch, _, model, _) in DECODE_CASES.items()}
SERVE_CASE = "zamba2_1x4"


def smoke(arch: str):
    return get_smoke_config(arch).replace(compute_dtype="float32", kv_cache_dtype="bfloat16")


def fp32_smoke(arch: str):
    return get_smoke_config(arch).replace(compute_dtype="float32")


def extras(cfg, b: int, seed: int) -> dict:
    """A batch's leaves beside its tokens: paligemma's image embeds, whisper's frames."""
    rng = np.random.default_rng(seed)
    if cfg.kind == "vlm":
        return {"image_embeds": rng.standard_normal((b, cfg.num_image_tokens, cfg.d_model),
                                                    dtype=np.float32)}
    if cfg.kind == "encdec":
        return {"frames": rng.standard_normal((b, cfg.enc_seq_len, cfg.d_model),
                                              dtype=np.float32)}
    return {}


def prefill_batch(cfg) -> dict:
    rng = np.random.default_rng(7)
    out = {"tokens": rng.integers(0, cfg.vocab_size, PREFILL_TOKENS, dtype=np.int32)}
    return {**out, **extras(cfg, PREFILL_TOKENS[0], 8)}


def mb_batches(cfg) -> list:
    data = DataConfig(seed=0, global_batch=MB_BATCH, seq_len=MB_SEQ)
    return [{k: np.asarray(v) for k, v in batch_at(i, cfg, data).items()}
            for i in range(MB_STEPS)]


def mb_opt():
    return dict(lr=3e-4, total_steps=MB_STEPS, warmup_steps=1)


def greedy_tokens(params, cfg, batch: int, seed: int) -> np.ndarray:
    """A random prompt and the port's one-process greedy continuation
    (whisper's cross caches filled from its encoder over the case's frames)."""
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, PROMPT),
                                                  dtype=np.int32)
    toks = torch.from_numpy(prompt).long()
    n = PROMPT + GEN
    step, caches = tsteps.make_decode_step(cfg, "cpu"), ttf.init_caches(cfg, batch, n, "cpu")
    if cfg.kind == "encdec":
        frames = torch.from_numpy(extras(cfg, batch, seed)["frames"])
        ttf.fill_cross_caches(params, tsteps.make_encode(cfg, "cpu")(params, frames), caches,
                              cfg)
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
import test_torch_hybrid_tp as T
from repro_torch.bridge import flatten_with_paths, params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import serve, steps, train
from repro_torch.launch.mesh import ProcessMesh, init_process_mesh, split_model_axis
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import AdamWConfig
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


def numpy_tree(name):
    return tree_map(torch.from_numpy, inputs["params"][name])


out = {{"shards": {{}}, "prefill": {{}}, "decode": {{}}, "mb": {{}}}}

# the prefill; the kernel path's calls counted per rank
counted = ops.flash_attention
calls = []
def seen(q, k, v, **kw):
    calls.append([list(q.shape), list(k.shape)])
    return counted(q, k, v, **kw)
ops.flash_attention = seen
for name, (arch, data, model) in T.PREFILL_CASES.items():
    mesh = mesh_of(data, model)
    cfg = T.smoke(arch)
    params = numpy_tree(arch)
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
for arch, name in T.RUN_IDS:
    out["runs"][arch, name] = train.main(
        ["--arch", arch] + T.TRAIN + T.TRAIN_RUNS[name] + ["--data-parallel", "2", "--ckpt-dir",
         os.path.join(out_dir, "ckpt", arch, name), "--ckpt-every", "4"])


def decode_run(cfg, policy, mesh, params, tokens, frames):
    b, n = tokens.shape
    step = steps.make_decode_step(cfg, "cpu", policy, mesh, b, n)
    caches = steps.init_placed_caches(cfg, policy, mesh, b, n)
    if frames is not None:  # the cross pair from this side's own encoder, placed
        tf.fill_cross_caches(params, steps.make_encode(cfg, "cpu", policy, mesh)(
            params, torch.from_numpy(frames)), caches, cfg)
    toks = torch.from_numpy(tokens).long()
    logits = []
    for t in range(n):
        o, caches = step(params, caches, toks[:, t:t + 1], t)
        logits.append(gather_tree(o).numpy())
    return {{"logits": np.stack(logits),
             "shapes": {{p: list(c.to_local().shape) for p, c in flatten_with_paths(caches)}},
             "placements": {{p: str(c.placements) for p, c in flatten_with_paths(caches)}}}}


for name, (arch, data, model, batch) in T.DECODE_CASES.items():
    mesh = mesh_of(data, model)
    cfg = T.smoke(arch)
    policy = make_policy(cfg, mesh)
    params = distribute_tree(numpy_tree(arch), policy.param_specs(tf.param_shapes(cfg)),
                             mesh.device_mesh)
    res = decode_run(cfg, policy, mesh, params, inputs["tokens"][name],
                     inputs["frames"].get(name))
    res["index"] = index(data, model)
    out["decode"][name] = res

# the prompt replayed by serve.prefill_with_caches on the placed caches
arch, data, model, batch = T.DECODE_CASES[T.SERVE_CASE]
mesh = mesh_of(data, model)
cfg = T.smoke(arch)
tokens = torch.from_numpy(inputs["tokens"][T.SERVE_CASE]).long()
logits, caches = serve.prefill_with_caches(numpy_tree(arch), {{"tokens": tokens[:, :T.PROMPT]}},
                                           cfg, tokens.shape[1], "cpu", make_policy(cfg, mesh),
                                           mesh)
out["serve"] = {{"placed": all(isinstance(c, DTensor) for c in leaves(caches)),
                "logits": gather_tree(logits).numpy(),
                "pos": [gather_tree(c["pos"]).numpy() for c in caches if "pos" in c]}}

# microbatches across processes: xla, 2 microbatches, at data 2 x model 1 (each pair of
# ranks a data group of its own) and data 2 x model 2
cfg = T.fp32_smoke(T.MB_ARCH)
for data, model in T.MB_MESHES:
    if model == 1:
        mesh, group, policy = None, pairs[rank // 2], None
    else:
        mesh = mesh_of(data, model)
        group, policy = mesh.group, train.checked_policy(cfg, mesh)
    step = steps.make_train_step(cfg, AdamWConfig(**T.mb_opt()), comm="xla", dp=data,
                                 microbatches=2, device="cpu", group=group, policy=policy,
                                 mesh=mesh)
    params, opt = steps.init_train_state(cfg, data, 0, "cpu", group=group, policy=policy,
                                         mesh=mesh, comm="xla")
    losses = []
    for b in T.mb_batches(cfg):
        params, opt, loss = step(params, opt, {{k: torch.from_numpy(v) for k, v in b.items()}})
        losses.append(float(loss))
    out["mb"][data, model] = losses

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
import test_torch_hybrid_tp as T
from repro import compat
from repro.checkpoint.checkpoint import _flatten_with_paths
from repro.configs import get_smoke_config
from repro.launch import steps, train
from repro.models import moe as moe_lib
from repro.models import transformer as tf
from repro.optim.adamw import AdamWConfig
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
    jax.effects_barrier()
    out = (min(g for g, _ in GAPS), sum(n for _, n in GAPS)) if GAPS else None
    GAPS.clear()
    return out


def smoke(arch):
    return get_smoke_config(arch).replace(compute_dtype="float32", kv_cache_dtype="bfloat16")


def fp32(arch):
    return get_smoke_config(arch).replace(compute_dtype="float32")


def by_rank(leaf, mesh):
    shards = {{s.device: np.asarray(s.data) for s in leaf.addressable_shards}}
    return [shards[d] for d in mesh.devices.flat]  # rank r = d * model + m


def mesh_of(data, model):
    return compat.make_mesh((data, model), ("data", "model"),
                            devices=jax.devices()[:data * model])


def fill_cross(params, frames, caches, cfg):
    # examples/whisper_serve.py: the encoder once, then each layer's cross K/V
    enc = jax.jit(lambda p, f: tf.encoder_forward(p["encoder"], f, cfg))(params, frames)
    xattn = params["segments"][0]["xattn"]
    for i in range(cfg.n_layers):
        caches[i]["cross_k"] = jnp.einsum("bsd,dhk->bshk", enc, xattn["wk"][i])
        caches[i]["cross_v"] = jnp.einsum("bsd,dhk->bshk", enc, xattn["wv"][i])
    return caches


def decode_run(cfg, policy, mesh, params, tokens, frames):
    b, n = tokens.shape
    step = steps.make_decode_step(cfg, policy, b, n)
    caches = tf.init_caches(cfg, b, n)
    if frames is not None:
        caches = fill_cross(params, jnp.asarray(frames), caches, cfg)
    logits, shapes = [], None
    for t in range(n):
        o, caches = step(params, caches, jnp.asarray(tokens[:, t:t + 1]), jnp.int32(t))
        logits.append(np.asarray(o))
        if shapes is None:
            shapes = {{p: [list(s.shape) for s in by_rank(c, mesh)]
                       for p, c in _flatten_with_paths(caches)}}
    return {{"logits": np.stack(logits), "shapes": shapes}}


out = {{"runs": {{}}, "mb": {{}}, "prefill": {{}}, "decode": {{}}}}
archs, runs = T.JAX_PARTS[part]
if part == "refs_enc":  # the placed state, first: the ranks wait for its params
    out["shards"], whole = {{}}, {{}}
    for arch in T.ARCHES:
        cfg = fp32(arch)
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
if archs:
    for name, (arch, data, model) in T.PREFILL_CASES.items():
        if arch in archs:
            cfg = smoke(arch)
            fn = steps.make_prefill(cfg, make_policy(cfg, mesh_of(data, model)))
            params = jax.tree.map(jnp.asarray, inputs["params"][arch])
            batch = {{k: jnp.asarray(v) for k, v in T.prefill_batch(cfg).items()}}
            out["prefill"][name] = np.asarray(fn(params, batch))
    for name, (arch, data, model, batch) in T.DECODE_CASES.items():
        if arch in archs:
            mesh = mesh_of(data, model)
            cfg = smoke(arch)
            params = jax.tree.map(jnp.asarray, inputs["params"][arch])
            out["decode"][name] = decode_run(cfg, make_policy(cfg, mesh), mesh, params,
                                             inputs["tokens"][name], inputs["frames"].get(name))
# the trainer at data 2 x model 2 from the port's seed-0 params
_init = steps.init_sharded_state
def init_from_port(cfg, policy, rng, init_ef=False):
    params, opt = _init(cfg, policy, rng, init_ef)
    params = jax.tree.map(lambda p, a: jax.device_put(jnp.asarray(a, p.dtype), p.sharding),
                          params, inputs["params"][cfg.name.removesuffix("-smoke") + "/train"])
    return params, opt
steps.init_sharded_state = init_from_port
train.get_smoke_config = fp32
for arch, name in runs:
    out["runs"][arch, name] = train.main(
        ["--arch", arch] + [f for f in T.TRAIN if f not in ("--device", "cpu")]
        + T.TRAIN_RUNS[name] + ["--data-parallel", "2", "--ckpt-dir",
                                os.path.join({out!r}, "jax_ckpt", arch, name),
                                "--ckpt-every", "4"])
if part == "microbatches":  # microbatches: xla over the global batch, 2 microbatches
    cfg = fp32(T.MB_ARCH)
    for data, model in T.MB_MESHES:
        policy = make_policy(cfg, mesh_of(data, model))
        step = steps.make_train_step(cfg, policy, AdamWConfig(**T.mb_opt()), comm="xla",
                                     microbatches=2)
        params, opt = init_from_port(cfg, policy, jax.random.PRNGKey(0))
        losses = []
        gaps()
        for b in T.mb_batches(cfg):
            params, opt, loss = step(params, opt, {{k: jnp.asarray(v) for k, v in b.items()}})
            losses.append(float(loss))
        out["mb"][data, model] = {{"losses": losses, "gap": gaps()}}
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
    """The port's seed-0 smoke params (numpy) of every arch, and the tokens
    (and whisper's frames) of every decode case."""
    def port(cfg):
        return ttf.init_params(torch.Generator().manual_seed(0), cfg)

    params = {arch: port(smoke(arch)) for arch in ARCHES}
    params.update({arch + "/train": port(fp32_smoke(arch)) for arch in (*ARCHES, MB_ARCH)})
    tokens, frames = {}, {}
    for i, (name, (arch, _, _, batch)) in enumerate(DECODE_CASES.items()):
        cfg = smoke(arch)
        tokens[name] = greedy_tokens(params[arch], cfg, batch, i)
        if cfg.kind == "encdec":
            frames[name] = extras(cfg, batch, i)["frames"]
    return {"params": {k: tree_map(lambda t: t.numpy(), p) for k, p in params.items()},
            "tokens": tokens, "frames": frames}


@pytest.fixture(scope="module", autouse=True)
def _started(tmp_path_factory):
    """Starts the world and the JAX references with the module's first test."""
    tmp = tmp_path_factory.mktemp("hybrid_tp")
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
    out = {"runs": {}, "mb": {}, "prefill": {}, "decode": {}}
    for i, (rc, err) in enumerate(_finish(jax_procs, time.monotonic() + TIMEOUT_S)):
        assert rc == 0, err
        with open(tmp / f"jax_{i}.pkl", "rb") as f:
            part = pickle.load(f)
        for k in ("runs", "mb", "prefill", "decode"):
            out[k].update(part.pop(k, {}))
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
    """As ``tests/test_torch_moe_mla_tp.py``: the smallest router gap and the
    tokens under ``MIN_GAP``, where a rounding could pick another expert; a
    case with such tokens says so and is held to its limits all the same."""
    assert gap is not None, f"{what}: no MoE call recorded"
    least, near = gap
    print(f"{what}: smallest router gap {least:.3e}, {near} token(s) under {MIN_GAP:g}")
    if near:
        print(f"{what}: below the router-gap precondition; held to its limits all the same")


def _assert_logits_close(got: np.ndarray, expect: np.ndarray) -> None:
    assert got.shape == expect.shape
    for t in range(expect.shape[0]):
        err = np.abs(got[t] - expect[t]).max()
        assert err <= LOGITS_RTOL * np.abs(expect[t]).max(), (t, err)


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
def test_mixers_whole_over_model(world, arch, data, model):
    """Every mixer leaf and ``shared_proj`` whole over model (the policy
    replicates them), while the embedding's vocab and the MLPs split."""
    placed = world[0][0]["shards"][arch, data, model]["placements"]
    mixers = [p for p in placed if "/mix/" in p or p == "shared_proj"]
    assert (len(mixers) > 0) == (arch in (ZAMBA2, XLSTM))
    assert all(placed[p] == "(Replicate(), Replicate())" for p in mixers), mixers
    assert placed["embed"] == "(Replicate(), Shard(dim=0))"
    mlp = [p for p in placed if p.endswith("mlp/wi")]
    assert all("Shard" in placed[p] for p in mlp) and (len(mlp) > 0) == (arch != XLSTM)


# ---------------------------------------------------------------------------
# the prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(PREFILL_CASES))
def test_placed_prefill_matches_jax(world, ref, name):
    expect = ref["prefill"][name]
    for out in world[0]:
        got = out["prefill"][name, False]["logits"]
        assert got.shape == expect.shape
        assert np.abs(got - expect).max() <= LOGITS_RTOL * np.abs(expect).max()


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_kernel_path_matches_dense_on_own_heads(world, name):
    """zamba2: one call per shared-block site on the rank's own heads;
    whisper: one per encoder layer, its 6 heads split at model 2 and all of
    them in every rank at model 4 (the attention replicated)."""
    arch, data, model = PREFILL_CASES[name]
    cfg = smoke(arch)
    b, s = PREFILL_TOKENS
    if arch == ZAMBA2:
        n_calls = sum(ttf._shared_site(cfg, i) for i in range(cfg.n_layers))
    else:
        n_calls, s = cfg.enc_layers, cfg.enc_seq_len
    heads = cfg.n_heads // model if cfg.n_heads % model == 0 else cfg.n_heads
    shape = [b // data, s, heads, cfg.head_dim]
    for out in world[0]:
        dense, kern = out["prefill"][name, False], out["prefill"][name, True]
        assert dense["calls"] == []
        assert np.abs(kern["logits"] - dense["logits"]).max() <= \
            KERNEL_RTOL * np.abs(dense["logits"]).max()
        assert n_calls >= 2 and kern["calls"] == [[shape, shape]] * n_calls


# ---------------------------------------------------------------------------
# the trainer at data 2 x model 2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,name", RUN_IDS)
def test_trainer_tracks_jax_trainer(world, ref, arch, name):
    got, expect = world[0][0]["runs"][arch, name], ref["runs"][arch, name]
    assert got["steps"] == expect["steps"] == 4
    assert (got["world"], got["data"], got["model"]) == (WORLD, 2, 2)
    assert all(out["runs"][arch, name]["final_loss"] == got["final_loss"] for out in world[0])
    tol = INT8_LOSS_RTOL if "--compress" in TRAIN_RUNS[name] else LOSS_RTOL
    for k in ("first_loss", "final_loss"):
        assert got[k] == pytest.approx(expect[k], rel=tol), k


@pytest.mark.parametrize("arch,name", RUN_IDS)
def test_final_params_match_jax(world, ref, arch, name):
    """Rank 0's step-4 checkpoint (full tensors, gathered) against JAX's: the
    replicated mixers, the shared block and the split leaves alike."""
    _, tmp = world
    dirs = [tmp / side / arch / name / "step_0000000004" for side in ("ckpt", "jax_ckpt")]
    manifests = [json.loads((d / "manifest.json").read_text()) for d in dirs]
    keys = [[m["key"] for m in man["leaves"]] for man in manifests]
    assert keys[0] == keys[1]
    params = [k for k in keys[0] if k.startswith("0/")]
    tol = INT8_PARAM_RTOL if "--compress" in TRAIN_RUNS[name] else PARAM_RTOL
    for m in manifests[0]["leaves"]:
        if m["key"] in params:
            got, expect = (np.load(d / m["file"]) for d in dirs)
            assert got.shape == expect.shape, m["key"]
            err = np.abs(got - expect) / np.abs(expect).max()
            past = err > tol
            if past.any():
                print(f"{arch} {name} {m['key']}: {past.sum()} of {err.size} element(s) "
                      f"past {tol:g}, the largest {err.max():.3e}")
            assert past.sum() <= PARAM_OUTLIERS * err.size, m["key"]
            assert err.max() <= max(tol, PARAM_OUTLIER_RTOL), m["key"]


@pytest.mark.parametrize("arch,name", RUN_IDS)
def test_model_axis_run_equals_model1_run(world, model1_runs, arch, name):
    got, expect = world[0][0]["runs"][arch, name], model1_runs[arch, name]
    for k in ("first_loss", "final_loss"):
        assert got[k] == pytest.approx(expect[k], rel=MODEL1_RTOL), k


@pytest.mark.parametrize("data,model", MB_MESHES)
def test_microbatches_count_jax_rows(world, ref, data, model):
    """Each rank's microbatch ``i`` is its share of JAX's global microbatch
    ``i``: every step's loss within 2e-5 relative of JAX's, on every rank."""
    expect = ref["mb"][data, model]
    _router_gap(expect["gap"], f"{MB_ARCH} microbatches=2 at ({data}, {model})")
    for out in world[0]:
        got = out["mb"][data, model]
        assert len(got) == len(expect["losses"]) == MB_STEPS
        for g, e in zip(got, expect["losses"]):
            assert g == pytest.approx(e, rel=LOSS_RTOL), (got, expect["losses"])


def test_microbatch_order_is_jax_global_split():
    """Rank r's contiguous rows, split into m slices, give slice i as the
    global rows of JAX's microbatch i that fall to rank r."""
    b, dp, m = 12, 2, 3
    order = tsteps.microbatch_order(b, dp, m).tolist()
    for r in range(dp):
        own = order[r * b // dp:(r + 1) * b // dp]
        for i in range(m):
            got = own[i * b // (dp * m):(i + 1) * b // (dp * m)]
            first = i * b // m + r * b // (m * dp)
            assert got == list(range(first, first + b // (m * dp)))
    with pytest.raises(ValueError):
        tsteps.microbatch_order(10, 2, 3)


# ---------------------------------------------------------------------------
# the placed decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_placed_decode_matches_jax_every_step(world, ref, name):
    expect = ref["decode"][name]
    assert expect["logits"].shape == (PROMPT + GEN, DECODE_CASES[name][3], 1, 256)
    for out in world[0]:
        _assert_logits_close(out["decode"][name]["logits"], expect["logits"])


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_local_cache_shapes_equal_jax_shards(world, ref, name):
    """No rank holds a whole head-split state: each local shape is the
    matching JAX device's shard, and the named leaves take the layouts of
    the ``cache_spec`` branches the case reaches."""
    expect = ref["decode"][name]["shapes"]
    for out in world[0]:
        got = out["decode"][name]
        assert sorted(got["shapes"]) == sorted(expect)
        for path, shape in got["shapes"].items():
            assert shape == expect[path][got["index"]], path
        for path, layout in CACHE_LAYOUT[name].items():
            assert got["placements"][path] == layout, path


def test_serve_replay_on_placed_caches(world):
    """``serve.prefill_with_caches`` with the policy and the mesh ends on the
    placed decode's logits at the prompt's last step, bit for bit, with the
    caches placed and the shared block's positions written."""
    for out in world[0]:
        res = out["serve"]
        assert res["placed"]
        np.testing.assert_array_equal(res["logits"],
                                      out["decode"][SERVE_CASE]["logits"][PROMPT - 1])
        want = np.where(np.arange(PROMPT + GEN) < PROMPT, np.arange(PROMPT + GEN), -1)
        assert len(res["pos"]) == 2  # zamba2 smoke's two shared-block sites
        for pos in res["pos"]:
            assert (pos == want).all()
