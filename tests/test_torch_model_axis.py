"""The model axis across processes: a data × model process mesh with every
leaf a DTensor placed by the sharding policy, on a 4-rank gloo world on the
CPU.

One world of four processes (a ``file://`` rendezvous under ``tmp_path``,
one intra-op thread per rank, the whole run under a timeout) runs every
case at the module's first test and writes one pickle per rank; one JAX
subprocess on 4 fake CPU devices writes the references beside it. The
tests read both:

  * the state: JAX's bert-large smoke params (``init_params`` from
    ``PRNGKey(0)``), carried across by ``bridge.params_from_numpy`` and
    placed by the port (``sharding.policy.distribute_tree`` on
    ``split_model_axis``), and the moments of ``launch.steps.
    init_train_state``: every rank's local shard of every param and ZeRO-1
    moment equals the matching device's shard of JAX's
    ``init_sharded_state`` on a ``(2, 2)`` mesh, bit for bit. The runs below
    all start from the port's seed-0 params, carried into JAX, as
    ``tests/test_torch_distributed.py`` does;
  * the trainer at data 2 × model 2 (``python -m repro_torch.launch.train
    --data-parallel 2`` in a world of 4; fp32, ``--wire-dtype float32``, 4
    steps) with ``xla``, ``lumorph4``, ``lumorph2``, ``lumorph4 --overlap
    4``, ``auto`` and ``lumorph2 --compress``: losses within 2e-5 relative
    of JAX's trainer on its ``(2, 2)`` mesh from the same params (1e-5 under
    ``--compress``, where each rank reduces its model group's whole leaves, so
    that the int8 blocks are JAX's), rank 0's final
    params and moments (its step-4 checkpoint) within 2e-5 of JAX's (under
    ``--compress`` the params within 5e-2 of each leaf's largest entry, JAX's
    own limit), the bucket log JAX's, and every run
    within 1e-5 relative of the port's own model-1 run (2 virtual ranks);
    a restart from the step-2 checkpoint ends on the uninterrupted loss;
  * ``all_reduce_grads`` over model shards (``shards=``): each rank's
    reduced shard equals its slice of the full leaves' reduction, bit for
    bit, and the bucket logs are the full leaves' (several buckets, some
    spanning leaves);
  * the tensor-parallel prefill of danube's smoke config at ``(1, 2)`` and
    ``(1, 4)`` (KV heads replicated at 4: the GQA map): the dense path within
    1e-5 relative of JAX's ``make_prefill`` on the same mesh, the kernel path
    (the plain version under ``local_map``) within 1e-5 of dense, with one
    kernel call per layer in every rank, on its own heads;
  * the error path: ``--data-parallel 3`` in a world of 4 exits; and a dim
    split over two mesh axes, ``(("data", "model"), None)``, placed: each rank
    keeps its quarter of the rows.
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
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.sharding import policy as tpol  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD, DATA = 4, 2
TIMEOUT_S = 300
LOSS_RTOL = 2e-5  # fp32, the same params and batches as JAX's trainer
PARAM_ATOL = 2e-5
# under --compress each rank reduces its model group's whole leaves, so that the int8
# blocks are JAX's global ones: losses measured 8.6e-8 apart after 4 steps; params,
# relative to each leaf's largest entry, 7.6e-5 apart (2.7e-2 when each rank blocked its
# own shard), within JAX's own limit (tests/test_train_integration.py:48); the
# error-feedback residuals are not compared
INT8_LOSS_RTOL = 1e-5
INT8_PARAM_RTOL = 5e-2
MODEL1_RTOL = 1e-5  # against the same flags at model 1: the TP partial sums' order
PREFILL_RTOL = 1e-5
COMMON = ["--arch", "bert-large", "--smoke", "--batch", "4", "--seq", "32", "--steps", "4",
          "--wire-dtype", "float32", "--log-every", "100"]
TRAIN = COMMON + ["--device", "cpu"]
TRAIN_RUNS = {"xla": ["--comm", "xla"],
              "lumorph4": ["--comm", "lumorph4"],
              "lumorph2": ["--comm", "lumorph2"],
              "lumorph4+ovl4": ["--comm", "lumorph4", "--overlap", "4"],
              "auto": ["--comm", "auto"],
              "lumorph2+int8": ["--comm", "lumorph2", "--compress"]}
RESTART = ["--comm", "lumorph4", "--ckpt-every", "2"]
MESHES = (2, 4)  # the prefill's model widths, data 1
PREFILL_TOKENS = (2, 40)
GRAD_BUCKET_BYTES = 64  # 16 fp32 per bucket: several buckets, some spanning leaves
# (global shape, sharded dim or None): leaves of a gradient tree, split over model
GRAD_LEAVES = {"a": ((6, 8), 1), "b": ((5,), None), "c": ((4, 6, 2), 0), "d": ((3, 4), 1)}


def fp32_smoke(arch):
    return get_smoke_config(arch).replace(compute_dtype="float32")


def prefill_tokens() -> np.ndarray:
    return np.random.default_rng(7).integers(0, 256, PREFILL_TOKENS, dtype=np.int32)


RANK = r"""
import os, pickle, shutil, sys
sys.path.insert(0, {src!r}); sys.path.insert(0, {tests!r})
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
import test_torch_model_axis as T
from repro_torch.bridge import flatten_with_paths, params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import steps, train
from repro_torch.launch.mesh import ProcessMesh, init_process_mesh, split_model_axis
from repro_torch.models import transformer as tf
from repro_torch.optim import grad_comm
from repro_torch.sharding.policy import distribute_tree, make_policy, place
from repro_torch.tree import tree_map

rank, out_dir = int(sys.argv[1]), {out!r}
world = init_process_mesh("cpu", "gloo", init_method="file://" + {rdzv!r}, rank=rank,
                          world_size=T.WORLD)
out = {{}}

# the placed state: JAX's params, and the moments as the trainer makes them under xla
mesh = split_model_axis(world, T.DATA)
cfg = T.fp32_smoke("bert-large")
policy = train.checked_policy(cfg, mesh)
_, opt = steps.init_train_state(cfg, T.DATA, 0, "cpu", group=mesh.group, policy=policy,
                                mesh=mesh, comm="xla")
with open({jax_params!r}, "rb") as f:
    params = distribute_tree(params_from_numpy(pickle.load(f)),
                             policy.param_specs(tf.param_shapes(cfg)), mesh.device_mesh)
out["shards"] = {{f"{{side}}/{{path}}": t.to_local().numpy()
                  for side, tree in (("params", params), ("m", opt["m"]), ("v", opt["v"]))
                  for path, t in flatten_with_paths(tree)}}
out["placements"] = {{path: str(t.placements) for path, t in flatten_with_paths(params)}}

# all_reduce_grads over model shards, against the full leaves' reduction
m = mesh.device_mesh.get_local_rank(1)
d = mesh.device_mesh.get_local_rank(0)
gen = torch.Generator().manual_seed(100 + d)
full = {{k: torch.randn(shape, generator=gen) for k, (shape, _) in T.GRAD_LEAVES.items()}}
local, shards = {{}}, []
for k in sorted(T.GRAD_LEAVES):
    shape, dim = T.GRAD_LEAVES[k]
    off = [0] * len(shape)
    t = full[k]
    if dim is not None:
        n = shape[dim] // 2
        t, off[dim] = t.narrow(dim, m * n, n).clone(), m * n
    local[k] = t
    shards.append(grad_comm.Shard(shape, tuple(off)))
for algo in ("lumorph4", "ring"):
    for ovl in (1, 4):
        red, _, log = grad_comm.all_reduce_grads(
            local, algo=algo, bucket_bytes=T.GRAD_BUCKET_BYTES, wire_dtype=torch.float32,
            overlap_chunks=ovl, group=mesh.group, shards=shards)
        ref, _, ref_log = grad_comm.all_reduce_grads(
            full, algo=algo, bucket_bytes=T.GRAD_BUCKET_BYTES, wire_dtype=torch.float32,
            overlap_chunks=ovl, group=mesh.group)
        want = {{}}
        for k, sh in zip(sorted(T.GRAD_LEAVES), shards):
            want[k] = ref[k]
            for dim, (o, n) in enumerate(zip(sh.offset, local[k].shape)):
                want[k] = want[k].narrow(dim, o, n)
        out[f"grads/{{algo}}/{{ovl}}"] = {{
            "equal": all(torch.equal(red[k], want[k]) for k in red),
            "log": [[int(b), a] for b, a in log], "ref_log": [[int(b), a] for b, a in ref_log]}}

# the trainer at data 2 x model 2; its bucket logs, as the step keeps them
logs = []
_reduce = grad_comm.all_reduce_grads
def logged(*a, **k):
    red, ef, log = _reduce(*a, **k)
    logs.append([[int(b), algo] for b, algo in log])
    return red, ef, log
grad_comm.all_reduce_grads = logged
train.get_smoke_config = T.fp32_smoke
runs = {{}}
for name, flags in T.TRAIN_RUNS.items():
    logs.clear()
    runs[name] = train.main(T.TRAIN + flags + ["--data-parallel", str(T.DATA), "--ckpt-dir",
                                               os.path.join(out_dir, "ckpt", name),
                                               "--ckpt-every", "4"])
    runs[name]["bucket_log"] = logs[-1] if logs else None
grad_comm.all_reduce_grads = _reduce
ckpt = os.path.join(out_dir, "ckpt", "restart")
dp = ["--data-parallel", str(T.DATA)]
runs["restart_full"] = train.main(T.TRAIN + T.RESTART + dp + ["--ckpt-dir", ckpt])
if rank == 0:
    shutil.rmtree(os.path.join(ckpt, "step_0000000004"))
dist.barrier()
runs["restart_resumed"] = train.main(T.TRAIN + T.RESTART + dp + ["--ckpt-dir", ckpt])
try:
    train.main(T.TRAIN + ["--comm", "lumorph4", "--data-parallel", "3"])
except SystemExit as e:
    runs["dp3_exit"] = str(e)
out["runs"] = runs
# a dim split over both mesh axes (flat_dp's data entry): rank r keeps rows [r, r + 1)
out["tuple_spec"] = place(torch.arange(16.0).reshape(4, 4), (("data", "model"), None),
                          mesh.device_mesh).to_local().numpy()

# the TP prefill at (1, model): the kernel path's calls counted per rank
counted = ops.flash_attention
calls = []
def seen(q, k, v, **kw):
    calls.append([list(q.shape), list(k.shape)])
    return counted(q, k, v, **kw)
ops.flash_attention = seen
pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
singles = [dist.new_group([r]) for r in range(T.WORLD)]
dcfg = T.fp32_smoke("h2o-danube-1.8b")
with open({danube!r}, "rb") as f:
    dparams = tree_map(torch.from_numpy, pickle.load(f))
tokens = torch.from_numpy(T.prefill_tokens())
for model in T.MESHES:
    if model == T.WORLD:
        pm = split_model_axis(world, 1)
    else:  # ranks {{0, 1}} and {{2, 3}} each a (1, 2) mesh of their own
        pair = pairs[rank // 2]
        dm = DeviceMesh.from_group([singles[rank], pair], "cpu",
                                   mesh=[[2 * (rank // 2), 2 * (rank // 2) + 1]],
                                   mesh_dim_names=("data", "model"))
        pm = ProcessMesh(rank=rank, world=2, group=singles[rank], backend="gloo",
                         device=torch.device("cpu"), model=2, device_mesh=dm)
    for kernel in (False, True):
        c = dcfg.replace(use_pallas=kernel)
        calls.clear()
        logits = steps.make_prefill(c, "cpu", make_policy(c, pm), pm)(dparams, {{"tokens": tokens}})
        out[f"prefill/{{model}}/{{kernel}}"] = {{"logits": logits.full_tensor().numpy(),
                                               "calls": list(calls)}}
ops.flash_attention = counted
dist.destroy_process_group()
with open(os.path.join(out_dir, f"rank{{rank}}.pkl"), "wb") as f:
    pickle.dump(out, f)
"""

JAX_REFS = r"""
import json, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, {src!r}); sys.path.insert(0, {tests!r})
import numpy as np
import jax, jax.numpy as jnp
import test_torch_model_axis as T
from repro import compat
from repro.checkpoint.checkpoint import _flatten_with_paths
from repro.configs import get_smoke_config
from repro.launch import steps, train
from repro.optim import grad_comm
from repro.sharding.policy import make_policy

def fp32(arch):
    return get_smoke_config(arch).replace(compute_dtype="float32")

def load(path):
    with open(path, "rb") as f:
        return pickle.load(f)

def by_rank(leaf, mesh):
    shards = {{s.device: np.asarray(s.data) for s in leaf.addressable_shards}}
    return [shards[d] for d in mesh.devices.flat]  # rank r = d * model + m

port_params = load({params!r})
cfg = fp32("bert-large")
mesh = compat.make_mesh((T.DATA, T.WORLD // T.DATA), ("data", "model"))
_init = steps.init_sharded_state
def init_from_port(cfg, policy, rng, init_ef=False):  # the port's seed-0 params
    params, opt = _init(cfg, policy, rng, init_ef)
    params = jax.tree.map(lambda p, a: jax.device_put(jnp.asarray(a, p.dtype), p.sharding),
                          params, port_params)
    return params, opt
params, opt = steps.init_sharded_state(cfg, make_policy(cfg, mesh), jax.random.PRNGKey(0))
steps.init_sharded_state = init_from_port
shards = {{}}
for side, tree in (("params", params), ("m", opt["m"]), ("v", opt["v"])):
    for path, leaf in _flatten_with_paths(tree):
        shards[f"{{side}}/{{path}}"] = by_rank(leaf, mesh)
del params, opt

logs = []
_reduce = grad_comm.all_reduce_grads
def logged(*a, **k):
    out = _reduce(*a, **k)
    logs.append([[int(b), algo] for b, algo in out[2]])
    return out
grad_comm.all_reduce_grads = logged
train.get_smoke_config = fp32
runs = {{}}
for name, flags in T.TRAIN_RUNS.items():
    logs.clear()
    runs[name] = train.main(T.COMMON + flags + ["--data-parallel", str(T.DATA), "--ckpt-dir",
                                                os.path.join({out!r}, "jax_ckpt", name),
                                                "--ckpt-every", "4"])
    runs[name]["bucket_log"] = logs[-1] if logs else None

dcfg = fp32("h2o-danube-1.8b")
dparams = jax.tree.map(jnp.asarray, load({danube!r}))
tokens = jnp.asarray(T.prefill_tokens())
prefill = {{}}
for model in T.MESHES:
    m = compat.make_mesh((1, model), ("data", "model"), devices=jax.devices()[:model])
    fn = steps.make_prefill(dcfg, make_policy(dcfg, m))
    prefill[str(model)] = np.asarray(fn(dparams, {{"tokens": tokens}}))
with open({path!r}, "wb") as f:
    pickle.dump({{"shards": shards, "runs": runs, "prefill": prefill}}, f)
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


def _dump_jax_params(path: Path):
    """JAX's seed-0 bert-large smoke params, as numpy (for the ranks to place),
    jitted as ``init_sharded_state`` jits them (XLA fuses ``x * 0.02`` into
    the draw, one ulp from the op-by-op values)."""
    import jax

    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import transformer as jtf
    cfg = jax_smoke("bert-large").replace(compute_dtype="float32")
    params = jax.jit(lambda key: jtf.init_params(key, cfg))(jax.random.PRNGKey(0))
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)


def _dump_params(arch: str, path: Path):
    params = ttf.init_params(torch.Generator().manual_seed(0), fp32_smoke(arch))
    with open(path, "wb") as f:
        pickle.dump(tree_map(lambda t: t.numpy(), params), f)


@pytest.fixture(scope="module", autouse=True)
def _started(tmp_path_factory):
    """Starts the world and the JAX references with the module's first test."""
    tmp = tmp_path_factory.mktemp("model_axis")
    fmt = dict(src=str(ROOT / "src"), tests=str(ROOT / "tests"),
               danube=str(tmp / "danube.pkl"), out=str(tmp), jax_params=str(tmp / "jax_params.pkl"))
    _dump_jax_params(tmp / "jax_params.pkl")
    _dump_params("bert-large", tmp / "params.pkl")
    _dump_params("h2o-danube-1.8b", tmp / "danube.pkl")
    jax_proc = _popen(JAX_REFS.format(**fmt, params=str(tmp / "params.pkl"),
                                      path=str(tmp / "jax.pkl")), cwd=tmp)
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
    return out, tmp


@pytest.fixture(scope="module")
def ref(_started):
    tmp, _, jax_proc = _started
    [(rc, err)] = _finish([jax_proc], time.monotonic() + TIMEOUT_S)
    assert rc == 0, err
    with open(tmp / "jax.pkl", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def model1_runs(world):
    """The port's model-1 runs: the same flags on 2 virtual ranks, one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    get = ttrain.get_smoke_config
    ttrain.get_smoke_config = fp32_smoke
    try:
        return {name: ttrain.main(TRAIN + flags + ["--data-parallel", str(DATA)])
                for name, flags in TRAIN_RUNS.items()}
    finally:
        ttrain.get_smoke_config = get
        torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the placed state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side", ["params", "m", "v"])
def test_local_shards_equal_jax_init_sharded_state(world, ref, side):
    ranks = world[0]
    keys = [k for k in ref["shards"] if k.startswith(side + "/")]
    assert keys and sorted(keys) == sorted(k for k in ranks[0]["shards"]
                                           if k.startswith(side + "/"))
    for key in keys:
        for r in range(WORLD):
            np.testing.assert_array_equal(ranks[r]["shards"][key], ref["shards"][key][r],
                                          err_msg=f"{key} on rank {r}")
    if side == "params":  # the model axis shards the attention, the MLP and the vocab
        placed = ranks[0]["placements"]
        assert placed["segments/0/attn/wq"] == "(Replicate(), Shard(dim=2))"
        assert placed["segments/0/mlp/wo"] == "(Replicate(), Shard(dim=1))"
        assert placed["embed"] == "(Replicate(), Shard(dim=0))"


# ---------------------------------------------------------------------------
# the trainer at data 2 x model 2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TRAIN_RUNS))
def test_trainer_tracks_jax_trainer(world, ref, name):
    got, expect = world[0][0]["runs"][name], ref["runs"][name]
    assert got["steps"] == expect["steps"] == 4
    assert (got["world"], got["data"], got["model"]) == (WORLD, DATA, WORLD // DATA)
    assert all(out["runs"][name]["final_loss"] == got["final_loss"] for out in world[0])
    tol = INT8_LOSS_RTOL if "--compress" in TRAIN_RUNS[name] else LOSS_RTOL
    for k in ("first_loss", "final_loss"):
        assert got[k] == pytest.approx(expect[k], rel=tol), k


@pytest.mark.parametrize("name", sorted(TRAIN_RUNS))
def test_final_params_match_jax(world, name):
    """Rank 0's step-4 checkpoint (full tensors, gathered) against JAX's."""
    _, tmp = world
    dirs = [tmp / side / name / "step_0000000004" for side in ("ckpt", "jax_ckpt")]
    manifests = [json.loads((d / "manifest.json").read_text()) for d in dirs]
    keys = [[m["key"] for m in man["leaves"]] for man in manifests]
    assert keys[0] == keys[1] and len(keys[0]) > 10
    compressed = "--compress" in TRAIN_RUNS[name]
    for m in manifests[0]["leaves"]:
        got, expect = (np.load(d / m["file"]) for d in dirs)
        assert got.shape == expect.shape, m["key"]
        if not compressed:
            np.testing.assert_allclose(got, expect, rtol=0, atol=PARAM_ATOL, err_msg=m["key"])
        elif m["key"].startswith("0/"):  # the params
            assert np.abs(got - expect).max() <= INT8_PARAM_RTOL * np.abs(expect).max(), \
                m["key"]


@pytest.mark.parametrize("name", sorted(set(TRAIN_RUNS) - {"xla"}))
def test_bucket_log_equals_jax(world, ref, name):
    expect = ref["runs"][name]["bucket_log"]
    assert expect
    for out in world[0]:
        assert out["runs"][name]["bucket_log"] == expect


@pytest.mark.parametrize("name", sorted(TRAIN_RUNS))
def test_model_axis_run_equals_model1_run(world, model1_runs, name):
    got, expect = world[0][0]["runs"][name], model1_runs[name]
    for k in ("first_loss", "final_loss"):
        assert got[k] == pytest.approx(expect[k], rel=MODEL1_RTOL), k


def test_restart_from_checkpoint_ends_on_uninterrupted_loss(world):
    runs = world[0][0]["runs"]
    assert runs["restart_full"]["steps"] == 4 and runs["restart_resumed"]["steps"] == 2
    assert runs["restart_resumed"]["final_loss"] == runs["restart_full"]["final_loss"]


@pytest.mark.parametrize("algo", ["lumorph4", "ring"])
@pytest.mark.parametrize("ovl", [1, 4])
def test_all_reduce_grads_over_model_shards(world, algo, ovl):
    for out in world[0]:
        got = out[f"grads/{algo}/{ovl}"]
        assert got["equal"]
        assert got["log"] == got["ref_log"] and len(got["log"]) > 3


# ---------------------------------------------------------------------------
# the tensor-parallel prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", MESHES)
def test_tp_prefill_matches_jax(world, ref, model):
    expect = ref["prefill"][str(model)]
    for out in world[0]:
        got = out[f"prefill/{model}/False"]["logits"]
        assert np.abs(got - expect).max() <= PREFILL_RTOL * np.abs(expect).max()


@pytest.mark.parametrize("model", MESHES)
def test_tp_prefill_kernel_path_matches_dense(world, model):
    cfg = fp32_smoke("h2o-danube-1.8b")
    b, s = PREFILL_TOKENS
    for out in world[0]:
        dense = out[f"prefill/{model}/False"]
        kern = out[f"prefill/{model}/True"]
        assert dense["calls"] == []
        assert np.abs(kern["logits"] - dense["logits"]).max() <= \
            PREFILL_RTOL * np.abs(dense["logits"]).max()
        # one call per layer, on the rank's own query heads and the KV heads they read
        local_kv = max(1, cfg.n_kv_heads // model)
        assert kern["calls"] == [[[b, s, cfg.n_heads // model, cfg.head_dim],
                                  [b, s, local_kv, cfg.head_dim]]] * cfg.n_layers


# ---------------------------------------------------------------------------
# error paths
# ---------------------------------------------------------------------------

def test_data_parallel_not_dividing_the_world_exits(world):
    for out in world[0]:
        msg = out["runs"]["dp3_exit"]
        assert "--data-parallel 3 does not divide a world of 4 ranks" in msg


def test_a_dim_split_over_two_axes_is_not_placed(world):
    """A dim split over two mesh axes (``("data", "model")``) is placed, major
    axis first: rank ``r = d·model + m`` keeps the ``r``-th quarter of the rows."""
    full = np.arange(16.0, dtype=np.float32).reshape(4, 4)
    for r, out in enumerate(world[0]):
        np.testing.assert_array_equal(out["tuple_spec"], full[r:r + 1])


@pytest.mark.parametrize("mesh,ranks", [("single", 256), ("multi", 512)])
def test_production_mesh_checks_its_policy_and_exits(mesh, ranks):
    with pytest.raises(SystemExit, match=f"needs {ranks} ranks"):
        ttrain.main(["--arch", "bert-large", "--smoke", "--device", "cpu", "--steps", "1",
                     "--mesh", mesh])


def test_policy_places_and_gathers_on_one_rank(tmp_path):
    """``distribute_tree`` keeps each rank's shard and ``gather_tree`` gives the
    full tensors back, on a 1 × 1 mesh in this process."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", world_size=1,
                            rank=0)
    try:
        dm = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        cfg = fp32_smoke("bert-large")
        policy = tpol.make_policy(cfg, tpol.MeshShape(("data", "model"), (1, 1)))
        full = ttf.init_params(torch.Generator().manual_seed(0), cfg)
        placed = tpol.distribute_tree(full, policy.param_specs(ttf.param_shapes(cfg)), dm)
        back = tpol.gather_tree(placed)
        for a, b in zip(*(tpol.flatten_with_paths(t) for t in (full, back))):
            assert a[0] == b[0] and torch.equal(a[1], b[1]), a[0]
    finally:
        dist.destroy_process_group()
