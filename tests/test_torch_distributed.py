"""The cross-process executor (``core/collectives_dist.py``) and the trainer
with every rank its own process, on a 4-rank gloo world on the CPU.

One world of four processes (a ``file://`` rendezvous under ``tmp_path``,
one intra-op thread per rank, the whole run under a timeout) runs every
case at the module's first test and writes one pickle per rank; one JAX
subprocess on fake CPU devices writes the references beside it. The tests
read both:

  * the executor against the JAX package's ``compile_schedule`` under
    ``shard_map`` and against the virtual-rank executor, bit for bit in
    fp32: ring, lumorph2, lumorph4 and tree at p ∈ {2, 3, 4} (p = 2 and 3
    are ``dist.new_group`` subgroups of the world), and the two
    partial-permutation schedules of ``test_torch_collectives.PARTIAL``;
    ``dist.all_reduce`` (``"psum"``) within 1e-6 relative of them;
  * ``make_overlapped_all_reduce`` (4 chunks, a consumer per chunk) for
    the same algorithms and widths, bit for bit the virtual ranks';
  * ``compressed_all_reduce`` at p = 2 and 4 and ``all_reduce_grads`` in
    the six ``GRAD_KEYS`` cases, against JAX fenced as
    ``test_torch_collectives`` fences it (its ``CHECK`` harness runs here
    at p ∈ {2, 3, 4}), bit for bit, the bucket logs equal;
  * ``python -m repro_torch.launch.train`` (bert-large smoke, fp32, 4
    ranks, 4 steps) with ``lumorph4``, ``lumorph2 --compress``, ``lumorph4
    --overlap 4``, ``xla`` and ``auto``: losses within 2e-5 relative of
    JAX's trainer on 4 fake devices from the same params; equal to the
    virtual-rank trainer's, and rank 0's checkpoint equal to its byte for
    byte (``xla`` within 1e-6: gloo's all-reduce adds in its own order); a
    restart from the step-2 checkpoint ends on the uninterrupted loss;
  * the error paths: ``--data-parallel 3`` in a world of 4 exits (a width
    that does not divide the world; 2 lays out a model axis,
    ``tests/test_torch_model_axis.py``); ``nccl`` with more ranks than
    cards raises before any group is made.
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

import test_torch_collectives as C  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import collectives as tcol  # noqa: E402
from repro_torch.core import scheduler as tsch  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import grad_comm as tgc  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD, PS = 4, (2, 3, 4)
TIMEOUT_S = 300
LOSS_RTOL = 2e-5  # fp32, the same params and batches as JAX's trainer
XLA_RTOL = 1e-6  # gloo's all-reduce against the virtual ranks' sum over the rank axis
# the flags both trainers take; the port's runs add --device cpu
COMMON = ["--arch", "bert-large", "--smoke", "--batch", "4", "--seq", "32", "--steps", "4",
          "--wire-dtype", "float32", "--log-every", "100"]
TRAIN = COMMON + ["--device", "cpu"]
TRAIN_RUNS = {"lumorph4": ["--comm", "lumorph4"],
              "lumorph2+int8": ["--comm", "lumorph2", "--compress"],
              "lumorph4+ovl4": ["--comm", "lumorph4", "--overlap", "4"],
              "xla": ["--comm", "xla"],
              "auto": ["--comm", "auto"]}
RESTART = ["--comm", "lumorph4", "--ckpt-every", "2"]
OVL_CHUNKS = 4


def ovl_compute(y):
    """The overlapped all-reduce's consumer of a reduced chunk."""
    return y * 2.0


def partial_schedule(name: str):
    perm, send, recv, reduce = C.PARTIAL[name]
    t = tsch.Transfer(perm, np.asarray(send, np.int32), np.asarray(recv, np.int32), reduce)
    return tsch.Schedule(name, (0, 1, 2), (tsch.Round(perm, 0.0, transfers=(t,)),), 0.0,
                         n_chunks=3)


def local_tree(tree, rank: int):
    """Rank ``rank``'s row of every leaf of a ``[p, ...]`` numpy tree, as tensors."""
    if isinstance(tree, dict):
        return {k: local_tree(v, rank) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree[rank]))


def fp32_smoke(arch):
    return get_smoke_config(arch).replace(compute_dtype="float32")


RANK = r"""
import os, pickle, shutil, sys
sys.path.insert(0, {src!r}); sys.path.insert(0, {tests!r})
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
import test_torch_distributed as T
from test_torch_distributed import C
from repro_torch.core import collectives as tcol, collectives_dist as D
from repro_torch.launch import train
from repro_torch.launch.mesh import init_process_mesh
from repro_torch.optim import grad_comm
from repro_torch.tree import tree_map

rank, out_dir = int(sys.argv[1]), {out!r}
mesh = init_process_mesh("cpu", "gloo", init_method="file://" + {rdzv!r}, rank=rank,
                         world_size=T.WORLD)
groups = {{2: dist.new_group([0, 1]), 3: dist.new_group([0, 1, 2]), 4: mesh.group}}
out, logs = {{}}, {{}}
for p in T.PS:
    if rank >= p:
        continue
    x = torch.from_numpy(C._inputs(p, C.N, p)[rank])
    for algo in C.ALGOS:
        fn = D.compile_schedule(tcol.schedule_for_execution(algo, p), groups[p])
        out[f"{{algo}}/{{p}}"] = fn(x).numpy()
        out[f"dispatch/{{algo}}/{{p}}"] = D.all_reduce(x, algo, groups[p]).numpy()
        out[f"overlap/{{algo}}/{{p}}"] = D.make_overlapped_all_reduce(
            algo, T.OVL_CHUNKS, T.ovl_compute, group=groups[p])(x).numpy()
    out[f"psum/{{p}}"] = D.all_reduce(x, "psum", groups[p]).numpy()
    if p & (p - 1) == 0:
        out[f"int8/{{p}}"] = grad_comm.compressed_all_reduce(x, group=groups[p]).numpy()
    assert torch.equal(x, torch.from_numpy(C._inputs(p, C.N, p)[rank]))  # x untouched
if rank < 3:
    x = torch.from_numpy(C._inputs(3, 12, 7)[rank])
    for name in C.PARTIAL:
        out[f"partial/{{name}}"] = D.compile_schedule(T.partial_schedule(name), groups[3])(x).numpy()
for key in C.GRAD_KEYS:
    kw = C.grad_kwargs(key, wire_dtype=torch.float32)
    ef = T.local_tree(C._grad_tree(4, 2), rank) if "compress" in kw else None
    red, new_ef, log = grad_comm.all_reduce_grads(
        T.local_tree(C._grad_tree(4, 1), rank), algo="lumorph4",
        bucket_bytes=C.GRAD_BUCKET_BYTES, error_feedback=ef, group=mesh.group, **kw)
    out[f"grads/{{key}}"] = tree_map(lambda t: t.float().numpy(), red)
    out[f"ef/{{key}}"] = None if new_ef is None else tree_map(lambda t: t.numpy(), new_ef)
    logs[key] = [[int(b), a] for b, a in log]
out["logs"] = logs

train.get_smoke_config = T.fp32_smoke
runs = {{}}
for name, flags in T.TRAIN_RUNS.items():
    runs[name] = train.main(T.TRAIN + flags + ["--data-parallel", "0", "--ckpt-dir",
                                               os.path.join(out_dir, "ckpt", name),
                                               "--ckpt-every", "4"])
ckpt = os.path.join(out_dir, "ckpt", "restart")
runs["restart_full"] = train.main(T.TRAIN + T.RESTART + ["--ckpt-dir", ckpt])
if rank == 0:
    shutil.rmtree(os.path.join(ckpt, "step_0000000004"))
dist.barrier()
runs["restart_resumed"] = train.main(T.TRAIN + T.RESTART + ["--ckpt-dir", ckpt])
try:
    train.main(T.TRAIN + ["--comm", "lumorph4", "--data-parallel", "3"])
except SystemExit as e:
    runs["dp3_exit"] = str(e)
out["runs"] = runs
dist.destroy_process_group()
with open(os.path.join(out_dir, f"rank{{rank}}.pkl"), "wb") as f:
    pickle.dump(out, f)
"""

JAX_REFS = r"""
import json, os, pickle, sys
sys.path.insert(0, {src!r}); sys.path.insert(0, {tests!r})
import test_torch_collectives as C
import test_torch_distributed as T
C.PS = T.PS
refs = {{}}
exec(C.CHECK.format(src={src!r}, tests={tests!r}, npz={npz!r}), refs)  # 8 fake devices

import jax, jax.numpy as jnp
from repro import compat
from repro.configs import get_smoke_config
from repro.launch import steps, train

with open({params!r}, "rb") as f:
    port_params = pickle.load(f)
_init = steps.init_sharded_state
def init_from_port(cfg, policy, rng, init_ef=False):  # the port's seed-0 params
    params, opt = _init(cfg, policy, rng, init_ef)
    params = jax.tree.map(lambda p, a: jax.device_put(jnp.asarray(a, p.dtype), p.sharding),
                          params, port_params)
    return params, opt
steps.init_sharded_state = init_from_port
train.get_smoke_config = lambda arch: get_smoke_config(arch).replace(compute_dtype="float32")
train.make_host_mesh = lambda data, model: compat.make_mesh(  # 4 of the 8 devices, model 1
    (data, 1), ("data", "model"), devices=jax.devices()[:data])
runs = {{name: train.main(T.COMMON + flags + ["--data-parallel", str(T.WORLD)])
         for name, flags in T.TRAIN_RUNS.items()}}
with open({path!r}, "w") as f:
    json.dump({{"logs": refs["logs"], "runs": runs}}, f)
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


@pytest.fixture(scope="module", autouse=True)
def _started(tmp_path_factory):
    """Starts the world and the JAX references with the module's first test."""
    tmp = tmp_path_factory.mktemp("distributed")
    fmt = dict(src=str(ROOT / "src"), tests=str(ROOT / "tests"))
    params = ttf.init_params(torch.Generator().manual_seed(0), fp32_smoke("bert-large"))
    with open(tmp / "params.pkl", "wb") as f:
        pickle.dump(tree_map(lambda t: t.numpy(), params), f)
    jax_proc = _popen(JAX_REFS.format(**fmt, npz=str(tmp / "ref.npz"),
                                      params=str(tmp / "params.pkl"),
                                      path=str(tmp / "jax.json")), cwd=tmp)
    rank_code = RANK.format(**fmt, out=str(tmp), rdzv=str(tmp / "rendezvous"))
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
    with np.load(tmp / "ref.npz") as f:
        arrays = dict(f)
    return arrays, json.loads((tmp / "jax.json").read_text())


def stacked(world, key: str, p: int = WORLD) -> np.ndarray:
    return np.stack([world[0][r][key] for r in range(p)])


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("algo", C.ALGOS)
def test_executor_bit_identical_to_jax_and_virtual_ranks(world, ref, algo, p):
    got = stacked(world, f"{algo}/{p}", p)
    np.testing.assert_array_equal(got, ref[0][f"{algo}/{p}"])
    np.testing.assert_array_equal(stacked(world, f"dispatch/{algo}/{p}", p), got)
    virtual = tcol.compile_schedule(tcol.schedule_for_execution(algo, p), p)(
        torch.from_numpy(C._inputs(p, C.N, p)))
    np.testing.assert_array_equal(got, virtual.numpy())


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("algo", C.ALGOS)
def test_overlapped_all_reduce_with_compute_equals_virtual_ranks(world, algo, p):
    got = stacked(world, f"overlap/{algo}/{p}", p)
    virtual = tcol.overlapped_all_reduce(torch.from_numpy(C._inputs(p, C.N, p)), algo,
                                         OVL_CHUNKS, ovl_compute)
    np.testing.assert_array_equal(got, virtual.numpy())


@pytest.mark.parametrize("p", PS)
def test_library_all_reduce_agrees_with_the_schedules(world, ref, p):
    got = stacked(world, f"psum/{p}", p)
    expect = ref[0][f"ring/{p}"]
    assert np.abs(got - expect).max() <= XLA_RTOL * np.abs(expect).max()
    assert (got == got[:1]).all()  # every rank holds the same sum


@pytest.mark.parametrize("name", sorted(C.PARTIAL))
def test_partial_permutations_match_reference(world, ref, name):
    got = stacked(world, f"partial/{name}", 3)
    np.testing.assert_array_equal(got, ref[0][f"partial/{name}"])
    x = torch.from_numpy(C._inputs(3, 12, 7))
    np.testing.assert_array_equal(got,
                                  tcol.compile_schedule(partial_schedule(name), 3)(x).numpy())
    if name == "overwrite":  # only rank 1 is a destination: ranks 0 and 2 keep all chunks
        assert np.array_equal(got[0], x[0].numpy()) and np.array_equal(got[2], x[2].numpy())


@pytest.mark.parametrize("p", [2, 4])
def test_int8_path_bit_identical_to_compressed_all_reduce(world, ref, p):
    got = stacked(world, f"int8/{p}", p)
    np.testing.assert_array_equal(got, ref[0][f"int8/{p}"])
    np.testing.assert_array_equal(
        got, tgc.compressed_all_reduce(torch.from_numpy(C._inputs(p, C.N, p))).numpy())


@pytest.mark.parametrize("key", C.GRAD_KEYS)
def test_all_reduce_grads_matches_reference(world, ref, key):
    arrays, jax_out = ref
    ranks = world[0]
    assert all(out["logs"][key] == jax_out["logs"][key] for out in ranks)
    assert len(jax_out["logs"][key]) > 3
    paths = {"['a']": ("a",), "['b']['c']": ("b", "c"), "['b']['d']": ("b", "d"),
             "['e']": ("e",)}

    def leaf(tree, path):
        for k in path:
            tree = tree[k]
        return tree
    kw = C.grad_kwargs(key, wire_dtype=torch.float32)
    for jpath, path in paths.items():
        got = np.stack([leaf(out[f"grads/{key}"], path) for out in ranks])
        np.testing.assert_array_equal(got, arrays[f"grads/{key}/{jpath}"])
        if "compress" in kw:
            ef = np.stack([leaf(out[f"ef/{key}"], path) for out in ranks])
            np.testing.assert_array_equal(ef, arrays[f"ef/{key}/{jpath}"])
    assert all((out[f"ef/{key}"] is None) == ("compress" not in kw) for out in ranks)


# ---------------------------------------------------------------------------
# the trainer, every rank its own process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def virtual_runs(world):
    """The virtual-rank trainer with each run's flags, at one thread."""
    _, tmp = world
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    get = ttrain.get_smoke_config
    ttrain.get_smoke_config = fp32_smoke
    try:
        return {name: ttrain.main(TRAIN + flags + [
            "--data-parallel", str(WORLD), "--ckpt-dir", str(tmp / "virtual" / name),
            "--ckpt-every", "4"]) for name, flags in TRAIN_RUNS.items()}
    finally:
        ttrain.get_smoke_config = get
        torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(TRAIN_RUNS))
def test_process_trainer_tracks_jax_trainer(world, ref, name):
    got, expect = world[0][0]["runs"][name], ref[1]["runs"][name]
    assert got["steps"] == expect["steps"] == 4
    assert got["world"] == WORLD and got["dist_backend"] == "gloo"
    for k in ("first_loss", "final_loss"):
        assert got[k] == pytest.approx(expect[k], rel=LOSS_RTOL), k


@pytest.mark.parametrize("name", sorted(TRAIN_RUNS))
def test_process_trainer_equals_virtual_ranks(world, virtual_runs, name):
    ranks, tmp = world
    got, expect = ranks[0]["runs"][name], virtual_runs[name]
    assert all(out["runs"][name]["final_loss"] == got["final_loss"] for out in ranks)
    if name == "xla":
        assert got["final_loss"] == pytest.approx(expect["final_loss"], rel=XLA_RTOL)
        return
    assert (got["first_loss"], got["final_loss"]) == (expect["first_loss"],
                                                      expect["final_loss"])
    dirs = [tmp / side / name / "step_0000000004" for side in ("ckpt", "virtual")]
    names = sorted(p.name for p in dirs[0].iterdir())
    assert names == sorted(p.name for p in dirs[1].iterdir()) and len(names) > 10
    for n in names:  # rank 0's params and optimizer state, byte for byte
        assert (dirs[0] / n).read_bytes() == (dirs[1] / n).read_bytes(), n


def test_process_trainer_restarts_from_its_checkpoint(world):
    runs = world[0][0]["runs"]
    assert runs["restart_full"]["steps"] == 4 and runs["restart_resumed"]["steps"] == 2
    assert runs["restart_resumed"]["final_loss"] == runs["restart_full"]["final_loss"]


def test_data_parallel_other_than_the_world_exits_naming_the_model_axis(world):
    """A width that does not divide the world exits, naming the model axis
    it would leave uneven; a divisor lays one out."""
    for out in world[0]:
        msg = out["runs"]["dp3_exit"]
        assert "--data-parallel 3 does not divide a world of 4 ranks" in msg
        assert "the model axis is world / data ranks wide" in msg


@pytest.mark.parametrize("backend", ["nccl", None])
def test_nccl_with_more_ranks_than_cards_raises_before_init(monkeypatch, tmp_path, backend):
    """``nccl`` (the default on ``cuda``) puts no two ranks on one GPU: with
    4 ranks and one card the mesh refuses before making a group, and the
    trainer under torchrun's environment does the same."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="NCCL puts no two ranks on one GPU; pass the gloo"):
        tmesh.init_process_mesh("cuda", backend, init_method=f"file://{tmp_path / 'r'}",
                                rank=0, world_size=4)
    for k, v in {"RANK": "0", "WORLD_SIZE": "4", "LOCAL_RANK": "0"}.items():
        monkeypatch.setenv(k, v)
    assert tmesh.launched_by_torchrun()
    flags = [] if backend is None else ["--dist-backend", backend]
    with pytest.raises(ValueError, match="4 ranks on this host but 1 visible"):
        ttrain.main(["--arch", "bert-large", "--smoke", "--steps", "1", *flags])
    assert not torch.distributed.is_initialized()
    assert not (tmp_path / "r").exists()
