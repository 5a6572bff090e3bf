"""The rest of the model axis for the dense decoder: the decode step with every
cache leaf placed by the policy's cache specs, and ZeRO-3's data-sharded
params in the train step, the prefill and the decode, on a 4-rank gloo
world on the CPU.

One world of four processes (a ``file://`` rendezvous under ``tmp_path``,
one intra-op thread per rank, the whole run under a timeout) runs every
case at the module's first test and writes one pickle per rank; one JAX
subprocess on 4 fake CPU devices writes the references beside it. Both
start together. The tests read both:

  * the placed decode (``launch.steps.make_decode_step`` on a mesh with a
    model axis) against JAX's ``make_decode_step`` on a mesh of the same
    shape, fp32, the port's seed-0 smoke params carried across as numpy:
    a prompt replayed token by token, then greedy tokens, the same tokens
    fed to both (the port's one-process greedy run picks them), every
    step's logits within 2e-5 of the largest (with the int8 cache, until a
    payload element first lands one int8 step from JAX's: a flip accepted
    only where JAX's ``x / scale`` before rounding lies within 8 ulps of 127
    of a .5 boundary, every other element equal to JAX's, and the steps
    after a flip held within 1e-3). One case per branch of
    ``ShardingPolicy.cache_spec``: danube's KV heads over model at
    ``(1, 2)``; its sequence over model at ``(1, 4)`` (2 KV heads do not
    divide 4), past its 16-slot window so that the ring wraps on a split
    cache; its batch over data at ``(2, 2)``; its sequence over data at
    ``(2, 2)`` with batch 1; glm4's sequence over model at ``(1, 4)``. Each
    with the compute-dtype cache and the int8 cache, whose final scales
    are held within ``tests/test_torch_kivi.py``'s 2e-5. Every rank's local
    cache shapes equal the matching JAX device's shard shapes;
  * ZeRO-3 (``make_policy(..., zero3=True)``) with bert-large's smoke
    config at ``(2, 2)``: every rank's local shard of the placed params and
    moments equals JAX ``init_sharded_state``'s, bit for bit; 4 steps of
    ``make_train_step`` with ``xla`` and ``lumorph4`` from the same params
    and batches: losses within 2e-5 relative of JAX's and the final params
    within 2e-5 of each leaf's largest entry; after one ``lumorph4`` step
    the state is replicated over data, as JAX's ``shard_map`` (``rep``)
    leaves it, and after one ``xla`` step each leaf keeps its placement;
  * danube's prefill and decode with ZeRO-3 params at ``(2, 2)`` against
    JAX ``make_prefill`` and ``make_decode_step`` with that policy;
  * ``launch.serve.prefill_with_caches`` with a policy and a mesh replays
    through the placed step on caches that each rank makes as its own
    shard (``steps.init_placed_caches``), equal to the whole caches placed.
The other block kinds' placed decode: ``tests/test_torch_moe_mla_tp.py`` and
``tests/test_torch_hybrid_tp.py``.
"""

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
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT_S = 300
LOGITS_RTOL = 2e-5  # fp32, every step, relative to the step's largest logit
SCALE_RTOL = 2e-5  # tests/test_torch_kivi.py
LOSS_RTOL = 2e-5
PARAM_RTOL = 2e-5  # relative to each leaf's largest entry
PROMPT, GEN = 12, 12  # 24 positions: danube's 16-slot ring wraps
# int8: a k or v element may land one step from JAX's only where JAX's x / scale before
# rounding lies within INT8_FLIP_WINDOW of a .5 boundary. The two programs sum the k
# and v projections in other orders, and their x / scale differ by a few ulps of 127
# (|x / scale| <= 127). After such a flip the logits move past 2e-5 and are held within
# INT8_FLIPPED_RTOL
INT8_FLIP_WINDOW = 8 * float(np.spacing(np.float32(127.0)))  # 6.1e-5
INT8_FLIPPED_RTOL = 1e-3
# name -> (arch, data, model, batch)
DECODE_CASES = {"danube_heads_1x2": ("h2o-danube-1.8b", 1, 2, 2),
                "danube_seq_model_1x4": ("h2o-danube-1.8b", 1, 4, 2),
                "danube_batch_2x2": ("h2o-danube-1.8b", 2, 2, 2),
                "danube_seq_data_2x2_b1": ("h2o-danube-1.8b", 2, 2, 1),
                "glm4_seq_model_1x4": ("glm4-9b", 1, 4, 2)}
CACHES = ("cdt", "int8")  # the compute-dtype cache and KIVI's int8
# the layout each case's k leaf takes (ShardingPolicy.cache_spec)
K_SPECS = {"danube_heads_1x2": ("data", None, "model", None),
           "danube_seq_model_1x4": ("data", "model", None, None),
           "danube_batch_2x2": ("data", None, "model", None),
           "danube_seq_data_2x2_b1": (None, "data", "model", None),
           "glm4_seq_model_1x4": ("data", "model", None, None)}
ZERO3_ARCH = "bert-large"
ZERO3_STEPS, ZERO3_BATCH, ZERO3_SEQ = 4, 4, 32
ZERO3_COMMS = ("xla", "lumorph4")
ZERO3_DECODE = ("h2o-danube-1.8b", 2)  # arch, batch, at (2, 2)


def smoke(arch: str, cache: str = "cdt"):
    return get_smoke_config(arch).replace(
        compute_dtype="float32", kv_cache_dtype="int8" if cache == "int8" else "bfloat16")


def zero3_batches() -> np.ndarray:
    return np.random.default_rng(11).integers(0, 256, (ZERO3_STEPS, ZERO3_BATCH, ZERO3_SEQ),
                                              dtype=np.int32)


def greedy_tokens(params, cfg, batch: int, seed: int) -> np.ndarray:
    """A random prompt and the port's one-process greedy continuation: the
    tokens both sides are fed, so that no near-tie forks the runs."""
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
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
import test_torch_decode_tp as T
from repro_torch.bridge import flatten_with_paths, params_from_numpy
from repro_torch.launch import serve, steps
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


def decode_run(cfg, policy, mesh, params, tokens):
    b, n = tokens.shape
    step = steps.make_decode_step(cfg, "cpu", policy, mesh, b, n)
    caches = steps.init_placed_caches(cfg, policy, mesh, b, n)
    toks = torch.from_numpy(tokens).long()
    logits, payloads = [], []
    for t in range(n):
        out, caches = step(params, caches, toks[:, t:t + 1], t)
        logits.append(gather_tree(out).numpy())
        if cfg.kv_cache_dtype == "int8":  # the int8 payloads after every step
            payloads.append({{p: c.numpy() for p, c in flatten_with_paths(gather_tree(
                [{{k: c[k] for k in ("k", "v")}} for c in caches]))}})
    return {{"logits": np.stack(logits), "payloads": payloads,
             "shapes": {{p: list(c.to_local().shape) for p, c in flatten_with_paths(caches)}},
             "placements": {{p: str(c.placements) for p, c in flatten_with_paths(caches)}},
             "caches": {{p: c.numpy() for p, c in flatten_with_paths(gather_tree(caches))
                         if p.endswith("_scale")}}}}


out = {{"decode": {{}}}}
for name, (arch, data, model, batch) in T.DECODE_CASES.items():
    mesh = mesh_of(data, model)
    for cache in T.CACHES:
        cfg = T.smoke(arch, cache)
        params = tree_map(torch.from_numpy, inputs["params"][arch])
        res = decode_run(cfg, make_policy(cfg, mesh), mesh, params,
                         inputs["tokens"][name, cache])
        res["index"] = rank % 2 if model == 2 and data == 1 else rank
        out["decode"][name, cache] = res

# ZeRO-3: bert-large's smoke config at (2, 2)
mesh = split_model_axis(world, 2)
cfg = T.smoke(T.ZERO3_ARCH)
policy = make_policy(cfg, mesh, zero3=True)
p_specs = policy.param_specs(tf.param_shapes(cfg))
jax_params = params_from_numpy(inputs["jax_params"])
opt_cfg = AdamWConfig(lr=3e-4, total_steps=T.ZERO3_STEPS, warmup_steps=1)
out["zero3"] = {{}}
for comm in T.ZERO3_COMMS:
    _, opt = steps.init_train_state(cfg, 2, 0, "cpu", group=mesh.group, policy=policy,
                                    mesh=mesh, comm=comm)
    params = distribute_tree(jax_params, p_specs, mesh.device_mesh)
    if comm == "xla":
        out["zero3_shards"] = {{f"{{side}}/{{path}}": t.to_local().numpy()
                               for side, tree in (("params", params), ("m", opt["m"]),
                                                  ("v", opt["v"]))
                               for path, t in flatten_with_paths(tree)}}
    step = steps.make_train_step(cfg, opt_cfg, comm=comm, dp=2, device="cpu",
                                 wire_dtype=torch.float32, group=mesh.group, policy=policy,
                                 mesh=mesh)
    losses, over_data = [], None
    for batch in T.zero3_batches():
        params, opt, loss = step(params, opt, {{"tokens": torch.from_numpy(batch)}})
        losses.append(float(loss))
        if over_data is None:  # each leaf's data placement after one step
            over_data = {{f"{{side}}/{{path}}": t.placements[0].is_shard()
                         for side, tree in (("params", params), ("m", opt["m"]),
                                            ("v", opt["v"]))
                         for path, t in flatten_with_paths(tree)}}
    final = {{p: t.numpy() for p, t in flatten_with_paths(gather_tree(params))}}
    out["zero3"][comm] = {{"losses": losses, "sharded_over_data": over_data,
                           "final": final if rank == 0 else None}}

# danube's prefill and decode with ZeRO-3 params at (2, 2)
arch, batch = T.ZERO3_DECODE
cfg = T.smoke(arch)
policy = make_policy(cfg, mesh, zero3=True)
params = distribute_tree(tree_map(torch.from_numpy, inputs["params"][arch]),
                         policy.param_specs(tf.param_shapes(cfg)), mesh.device_mesh)
out["zero3_param_sharded"] = sum(t.placements[0].is_shard() for t in leaves(params))
tokens = inputs["tokens"]["zero3_decode"]
logits = steps.make_prefill(cfg, "cpu", policy, mesh)(params,
                                                      {{"tokens": torch.from_numpy(tokens)}})
out["zero3_prefill"] = gather_tree(logits).numpy()
out["zero3_decode"] = decode_run(cfg, policy, mesh, params, tokens)

# the prompt replayed by serve.prefill_with_caches on caches each rank makes as its shard
out["serve"] = {{}}
for name, (arch, data, model, batch) in T.DECODE_CASES.items():
    mesh = mesh_of(data, model)
    for cache in T.CACHES:
        cfg = T.smoke(arch, cache)
        policy = make_policy(cfg, mesh)
        tokens = torch.from_numpy(inputs["tokens"][name, cache]).long()
        b, n = tokens.shape
        made = steps.init_placed_caches(cfg, policy, mesh, b, n)
        whole = distribute_tree(tf.init_caches(cfg, b, n, "cpu"),
                                policy.cache_specs(tf.init_caches(cfg, b, n, "cpu")),
                                mesh.device_mesh)
        logits, caches = serve.prefill_with_caches(
            tree_map(torch.from_numpy, inputs["params"][arch]), {{"tokens": tokens[:, :T.PROMPT]}},
            cfg, n, "cpu", policy, mesh)
        out["serve"][name, cache] = {{
            "fresh_equal": all(
                str(a.placements) == str(w.placements) and a.dtype == w.dtype
                and torch.equal(a.to_local(), w.to_local())
                for (_, a), (_, w) in zip(flatten_with_paths(made), flatten_with_paths(whole))),
            "placed": all(isinstance(c, DTensor) for c in leaves(caches)),
            "logits": gather_tree(logits).numpy(),
            "pos": {{p: c.numpy() for p, c in flatten_with_paths(gather_tree(caches))
                     if p.endswith("pos")}}}}
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
import test_torch_decode_tp as T
from repro import compat
from repro.checkpoint.checkpoint import _flatten_with_paths
from repro.configs import get_smoke_config
from repro.launch import steps
from repro.models import attention as attn
from repro.models import transformer as tf
from repro.optim.adamw import AdamWConfig
from repro.sharding.policy import make_policy

with open({inputs!r}, "rb") as f:
    inputs = pickle.load(f)

# every int8 quantization's x / scale before rounding, as _quant_kv computes it, recorded
# by call site: each trace of the decode calls it for the layers' k then v in order,
# SITES[1] sites a trace
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


def smoke(arch, cache="cdt"):
    return get_smoke_config(arch).replace(
        compute_dtype="float32", kv_cache_dtype="int8" if cache == "int8" else "bfloat16")


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
    for t in range(n):
        out, caches = step(params, caches, jnp.asarray(tokens[:, t:t + 1]), jnp.int32(t))
        logits.append(np.asarray(out))
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
             "shapes": shapes,
             "caches": {{p: np.asarray(c) for p, c in _flatten_with_paths(caches)
                         if p.endswith("_scale")}}}}


out = {{"decode": {{}}}}
for name, (arch, data, model, batch) in T.DECODE_CASES.items():
    mesh = mesh_of(data, model)
    params = jax.tree.map(jnp.asarray, inputs["params"][arch])
    for cache in T.CACHES:
        cfg = smoke(arch, cache)
        out["decode"][name, cache] = decode_run(cfg, make_policy(cfg, mesh), mesh, params,
                                                inputs["tokens"][name, cache])

mesh = mesh_of(2, 2)
cfg = smoke(T.ZERO3_ARCH)
policy = make_policy(cfg, mesh, zero3=True)
opt_cfg = AdamWConfig(lr=3e-4, total_steps=T.ZERO3_STEPS, warmup_steps=1)
out["zero3"] = {{}}
for comm in T.ZERO3_COMMS:
    params, opt = steps.init_sharded_state(cfg, policy, jax.random.PRNGKey(0))
    if comm == "xla":
        out["zero3_shards"] = {{f"{{side}}/{{path}}": by_rank(leaf, mesh)
                               for side, tree in (("params", params), ("m", opt["m"]),
                                                  ("v", opt["v"]))
                               for path, leaf in _flatten_with_paths(tree)}}
    step = steps.make_train_step(cfg, policy, opt_cfg, comm=comm, donate=False,
                                 wire_dtype=jnp.float32)
    losses, over_data = [], None
    for batch in T.zero3_batches():
        params, opt, loss = step(params, opt, {{"tokens": jnp.asarray(batch)}})
        losses.append(float(loss))
        if over_data is None:
            over_data = {{f"{{side}}/{{path}}": any(
                "data" in ((e,) if isinstance(e, str) else tuple(e or ()))
                for e in leaf.sharding.spec)
                for side, tree in (("params", params), ("m", opt["m"]), ("v", opt["v"]))
                for path, leaf in _flatten_with_paths(tree)}}
    out["zero3"][comm] = {{"losses": losses, "sharded_over_data": over_data,
                           "final": {{p: np.asarray(t) for p, t in _flatten_with_paths(params)}}}}

arch, batch = T.ZERO3_DECODE
cfg = smoke(arch)
policy = make_policy(cfg, mesh, zero3=True)
params = jax.tree.map(jnp.asarray, inputs["params"][arch])
tokens = inputs["tokens"]["zero3_decode"]
out["zero3_prefill"] = np.asarray(steps.make_prefill(cfg, policy)(
    params, {{"tokens": jnp.asarray(tokens)}}))
out["zero3_decode"] = decode_run(cfg, policy, mesh, params, tokens)
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
    """The port's seed-0 smoke params (numpy), the tokens of every decode case,
    and JAX's seed-0 bert-large params jitted as ``init_sharded_state`` jits
    them (XLA fuses ``x * 0.02`` into the draw, one ulp from op-by-op)."""
    import jax

    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import transformer as jtf

    arches = sorted({a for a, *_ in DECODE_CASES.values()} | {ZERO3_DECODE[0]})
    params = {a: ttf.init_params(torch.Generator().manual_seed(0), smoke(a)) for a in arches}
    tokens = {}
    for i, (name, (arch, _, _, batch)) in enumerate(sorted(DECODE_CASES.items())):
        for cache in CACHES:
            tokens[name, cache] = greedy_tokens(params[arch], smoke(arch, cache), batch, i)
    arch, batch = ZERO3_DECODE
    tokens["zero3_decode"] = greedy_tokens(params[arch], smoke(arch), batch, 99)
    jcfg = jax_smoke(ZERO3_ARCH).replace(compute_dtype="float32")
    jparams = jax.jit(lambda key: jtf.init_params(key, jcfg))(jax.random.PRNGKey(0))
    return {"params": {a: tree_map(lambda t: t.numpy(), p) for a, p in params.items()},
            "tokens": tokens, "jax_params": jax.tree.map(np.asarray, jparams)}


@pytest.fixture(scope="module", autouse=True)
def _started(tmp_path_factory):
    """Starts the world and the JAX references with the module's first test."""
    tmp = tmp_path_factory.mktemp("decode_tp")
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(_inputs(), f)
    fmt = dict(src=str(ROOT / "src"), tests=str(ROOT / "tests"), out=str(tmp),
               inputs=str(tmp / "inputs.pkl"))
    jax_proc = _popen(JAX_REFS.format(**fmt, path=str(tmp / "jax.pkl")), cwd=tmp)
    rank_code = RANK.format(**fmt, rdzv=str(tmp / "rendezvous"))
    ranks = [_popen(rank_code, str(r)) for r in range(WORLD)]
    yield tmp, ranks, jax_proc
    for proc in (*ranks, jax_proc):
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
    return out


@pytest.fixture(scope="module")
def ref(_started):
    tmp, _, jax_proc = _started
    [(rc, err)] = _finish([jax_proc], time.monotonic() + TIMEOUT_S)
    assert rc == 0, err
    with open(tmp / "jax.pkl", "rb") as f:
        return pickle.load(f)


def _assert_logits_close(got: np.ndarray, expect: np.ndarray, rtol: float = LOGITS_RTOL,
                         first: int = 0) -> None:
    assert got.shape == expect.shape
    for t in range(expect.shape[0]):
        err = np.abs(got[t] - expect[t]).max()
        assert err <= rtol * np.abs(expect[t]).max(), (first + t, err)


def _first_flip(got: list, expect: list, steps: int) -> int:
    """The first step after which an int8 payload element differs from
    JAX's, or ``steps`` (no payloads: the compute-dtype cache)."""
    for t, (g, e) in enumerate(zip(got, expect)):
        if any(not np.array_equal(g[p], e[p]) for p in e):
            return t
    return steps


# ---------------------------------------------------------------------------
# the placed decode, one case per branch of cache_spec
# ---------------------------------------------------------------------------

CASE_IDS = [(name, cache) for name in DECODE_CASES for cache in CACHES]


@pytest.mark.parametrize("name,cache", CASE_IDS)
def test_placed_decode_matches_jax_every_step(world, ref, name, cache):
    """Every step within 2e-5; with the int8 cache, every step until an int8
    payload element first lands one step from JAX's (see
    ``test_int8_payloads_match_jax_up_to_rare_one_step_flips``), and the
    steps after it within ``INT8_FLIPPED_RTOL``."""
    expect = ref["decode"][name, cache]
    assert expect["logits"].shape == (PROMPT + GEN, DECODE_CASES[name][3], 1, 256)
    for out in world:
        got = out["decode"][name, cache]
        upto = _first_flip(got["payloads"], expect["payloads"], len(expect["logits"]))
        assert upto == len(expect["logits"]) or cache == "int8"
        _assert_logits_close(got["logits"][:upto], expect["logits"][:upto])
        _assert_logits_close(got["logits"][upto:], expect["logits"][upto:], INT8_FLIPPED_RTOL,
                             upto)


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_int8_payloads_match_jax_up_to_rare_one_step_flips(world, ref, name):
    """After every step, each rank's gathered int8 payloads equal JAX's but
    at the slot the step wrote (``position % L``), where an element may lie
    one step from JAX's only if JAX's ``x / scale`` before rounding is
    within ``INT8_FLIP_WINDOW`` of a .5 boundary: the two programs sum in
    other orders, and the value lands on either neighbour. Every other slot
    keeps what the steps before wrote."""
    expect = ref["decode"][name, "int8"]
    assert len(expect["payloads"]) == len(expect["ratios"]) == PROMPT + GEN
    for out in world:
        got = out["decode"][name, "int8"]["payloads"]
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
                at_half = np.abs(ratio - (lo + 0.5)) <= INT8_FLIP_WINDOW
                assert np.all(at_half[flip]), (t, p, ratio[flip])
                assert np.all(np.minimum(gs, es)[flip] == lo[flip]), (t, p)
                assert np.all(np.abs(gs - es)[flip] == 1), (t, p)
            prev = g


@pytest.mark.parametrize("name,cache", CASE_IDS)
def test_local_cache_shapes_equal_jax_shards(world, ref, name, cache):
    expect = ref["decode"][name, cache]["shapes"]
    for out in world:
        got = out["decode"][name, cache]
        assert sorted(got["shapes"]) == sorted(expect)
        for path, shape in got["shapes"].items():
            assert shape == expect[path][got["index"]], (path, out["decode"][name, cache])


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_cache_layout_is_the_branch_named(world, name):
    """Each case exercises the branch of ``cache_spec`` it is named for."""
    _, data, model, _ = DECODE_CASES[name]
    spec = K_SPECS[name]
    want = "(" + ", ".join(
        next((f"Shard(dim={d})" for d, e in enumerate(spec) if e == axis), "Replicate()")
        for axis in ("data", "model")) + ")"
    for cache in CACHES:
        assert world[0]["decode"][name, cache]["placements"]["0/k"] == want


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_int8_scales_match_jax(world, ref, name):
    expect = ref["decode"][name, "int8"]["caches"]
    got = world[0]["decode"][name, "int8"]["caches"]
    assert sorted(got) == sorted(expect) and len(expect) == 2 * 2  # k and v, 2 layers
    for path in expect:
        np.testing.assert_allclose(got[path], expect[path], rtol=SCALE_RTOL, atol=0,
                                   err_msg=path)


# ---------------------------------------------------------------------------
# ZeRO-3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side", ["params", "m", "v"])
def test_zero3_local_shards_equal_jax_init_sharded_state(world, ref, side):
    keys = [k for k in ref["zero3_shards"] if k.startswith(side + "/")]
    assert keys and sorted(keys) == sorted(k for k in world[0]["zero3_shards"]
                                           if k.startswith(side + "/"))
    for key in keys:
        for r in range(WORLD):
            np.testing.assert_array_equal(world[r]["zero3_shards"][key],
                                          ref["zero3_shards"][key][r],
                                          err_msg=f"{key} on rank {r}")


def test_zero3_shards_params_over_data(world):
    """The policy puts data on most params: the shards are a quarter of the
    leaf where model shards it too."""
    shards = world[0]["zero3_shards"]
    full = tree_map(lambda t: t.shape, ttf.param_shapes(smoke(ZERO3_ARCH)))
    quarter = [k for k in shards if k.startswith("params/")
               and np.prod(shards[k].shape) * 4 == np.prod(_at(full, k[len("params/"):]))]
    assert len(quarter) >= 6, quarter


def _at(tree, path: str):
    for part in path.split("/"):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


@pytest.mark.parametrize("comm", ZERO3_COMMS)
def test_zero3_losses_match_jax(world, ref, comm):
    expect = ref["zero3"][comm]["losses"]
    assert len(expect) == ZERO3_STEPS
    for out in world:
        assert out["zero3"][comm]["losses"] == pytest.approx(expect, rel=LOSS_RTOL)


@pytest.mark.parametrize("comm", ZERO3_COMMS)
def test_zero3_final_params_match_jax(world, ref, comm):
    got, expect = world[0]["zero3"][comm]["final"], ref["zero3"][comm]["final"]
    assert sorted(got) == sorted(expect) and len(expect) > 10
    for path, e in expect.items():
        assert got[path].shape == e.shape, path
        assert np.abs(got[path] - e).max() <= PARAM_RTOL * np.abs(e).max(), path


@pytest.mark.parametrize("comm", ZERO3_COMMS)
def test_zero3_state_after_one_step_is_placed_as_jax(world, ref, comm):
    """LUMORPH: replicated over data (JAX's shard_map takes and gives ``rep``);
    xla: each leaf keeps its ZeRO-3 placement."""
    expect = ref["zero3"][comm]["sharded_over_data"]
    if comm == "xla":
        assert sum(expect.values()) > 10
    else:
        assert not any(expect.values())
    for out in world:
        assert out["zero3"][comm]["sharded_over_data"] == expect


def test_zero3_prefill_matches_jax(world, ref):
    expect = ref["zero3_prefill"]
    for out in world:
        assert out["zero3_param_sharded"] == 9  # every leaf but the 3 norms
        got = out["zero3_prefill"]
        assert got.shape == expect.shape
        assert np.abs(got - expect).max() <= LOGITS_RTOL * np.abs(expect).max()


def test_zero3_decode_matches_jax_every_step(world, ref):
    for out in world:
        _assert_logits_close(out["zero3_decode"]["logits"], ref["zero3_decode"]["logits"])


@pytest.mark.parametrize("name,cache", CASE_IDS)
def test_serve_replay_on_placed_caches(world, name, cache):
    """``serve.prefill_with_caches`` with the policy and the mesh: caches each
    rank makes as its shard equal the whole empty caches placed, and the
    prompt's replay ends on the placed decode's logits at that step, bit
    for bit, with the caches placed and the prompt's positions written."""
    for out in world:
        res = out["serve"][name, cache]
        assert res["fresh_equal"] and res["placed"]
        np.testing.assert_array_equal(res["logits"],
                                      out["decode"][name, cache]["logits"][PROMPT - 1])
        n = PROMPT + GEN
        for pos in res["pos"].values():
            slots = np.full(pos.shape[1], -1)
            for t in range(PROMPT):
                slots[t % pos.shape[1]] = t
            assert pos.shape[1] in (16, n) and (pos == slots).all()

