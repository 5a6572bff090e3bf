"""The virtual-rank Schedule-IR executor against the JAX package's
``compile_schedule`` under ``shard_map`` on 8 fake CPU devices.

One subprocess (``XLA_FLAGS`` stays out of the pytest process) computes
every reference case and writes one ``.npz``; the tests run the port on
the same numpy inputs and ask for bit-identical fp32 results:

  * ring, lumorph2, lumorph4 and tree at p ∈ {2, 3, 4, 6, 8};
  * hand-made partial-permutation schedules (non-destinations keep their
    chunks; non-destinations of a reduce add zeros);
  * the int8 path (``compressed_all_reduce``) at p ∈ {2, 4, 8};
  * ``all_reduce_grads`` on a small gradient tree in several buckets:
    fp32 and bf16 wires and int8 with error feedback, with the bucket log,
    monolithic and in overlap mode (``overlap_chunks=4``).

XLA's CPU backend contracts a dequantize and the add that consumes it
(the receiver's accumulate in some reduce hops, the error-feedback
residual) into one fused multiply-add, depending on how it fuses the
program: in ``compressed_all_reduce`` at p = 2, 4 and 8 it does so in the
last reduce-scatter hop only. The port keeps the source's rounding (the
product rounded, then the sum). So the int8 references are computed with
``grad_comm.dequantize_int8`` fenced (its result passes through a
``where(isnan(y), 0, y)`` select, which keeps the product out of the add
and changes no value; ``optimization_barrier`` does not survive XLA's CPU
pipeline), and the port must equal those bit for bit; against the
unfenced program it must agree far inside the int8 error.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import collectives as tcol  # noqa: E402
from repro_torch.core import scheduler as tsch  # noqa: E402
from repro_torch.optim import grad_comm as tgc  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
PS = (2, 3, 4, 6, 8)
ALGOS = ("ring", "lumorph2", "lumorph4", "tree")
N = 4099  # not a multiple of any p: every rank's row is padded
GRAD_SHAPES = {"a": (7, 33), "b": {"c": (300,), "d": (5, 4, 9)}, "e": (2, 200)}
GRAD_BUCKET_BYTES = 1024  # 256 fp32 per bucket: several buckets, one spans leaves
GRAD_KEYS = ("fp32", "bf16", "int8", "fp32-ovl4", "bf16-ovl4", "int8-ovl4")
# hand-made schedules: (perm, send, recv, reduce) on p = 3, one chunk per rank
PARTIAL = {
    "overwrite": (((0, 1),), [[2], [0], [1]], [[1], [0], [2]], False),
    "reduce": (((2, 0), (0, 1)), [[1], [2], [0]], [[0], [1], [2]], True),
}


def _inputs(p: int, n: int, seed: int) -> np.ndarray:
    """Values over six decades, signed, so that the add order shows."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((p, n)) * 10.0 ** rng.uniform(-3, 3, (p, n))).astype(np.float32)


def grad_kwargs(key: str, wire_dtype) -> dict:
    """``all_reduce_grads`` keywords of a ``GRAD_KEYS`` case."""
    wire, _, ovl = key.partition("-")
    kw = {"fp32": dict(wire_dtype=wire_dtype), "bf16": {}, "int8": dict(compress=True)}[wire]
    return {**kw, "overlap_chunks": 4} if ovl == "ovl4" else kw


def _grad_tree(p: int, seed: int):
    rng = np.random.default_rng(seed)

    def mk(node):
        if isinstance(node, dict):
            return {k: mk(v) for k, v in node.items()}
        return rng.standard_normal((p, *node)).astype(np.float32)
    return mk(GRAD_SHAPES)


CHECK = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, {src!r}); sys.path.insert(0, {tests!r})
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro import compat
from repro.core.collectives import compile_schedule, schedule_for_execution
from repro.core.scheduler import Round, Schedule, Transfer
from repro.optim import grad_comm
from repro.optim.grad_comm import all_reduce_grads, compressed_all_reduce
import test_torch_collectives as T

_deq = grad_comm.dequantize_int8
def _fenced(q, s, n):  # a select between the product and the add: no contraction
    y = _deq(q, s, n)
    return jnp.where(jnp.isnan(y), jnp.float32(0), y)
def fence(on):
    grad_comm.dequantize_int8 = _fenced if on else _deq

out, logs = {{}}, {{}}

def per_rank(fn, p, tree):
    mesh = Mesh(np.array(jax.devices()[:p]), ("d",))
    body = lambda t: jax.tree.map(lambda a: a[None], fn(jax.tree.map(lambda a: a[0], t)))
    return jax.jit(compat.shard_map(body, mesh=mesh, in_specs=P("d"), out_specs=P("d"),
                                    axis_names={{"d"}}, check_vma=False))(tree)

for p in T.PS:
    x = T._inputs(p, T.N, p)
    for algo in T.ALGOS:
        fn = compile_schedule(schedule_for_execution(algo, p), "d")
        out[f"{{algo}}/{{p}}"] = np.asarray(per_rank(fn, p, x))
    if p & (p - 1) == 0:
        for key, on in (("int8", True), ("int8-contracted", False)):
            fence(on)
            out[f"{{key}}/{{p}}"] = np.asarray(per_rank(lambda v: compressed_all_reduce(v, "d"), p, x))

for name, (perm, send, recv, reduce) in T.PARTIAL.items():
    t = Transfer(perm, np.asarray(send, np.int32), np.asarray(recv, np.int32), reduce)
    s = Schedule(name, (0, 1, 2), (Round(perm, 0.0, transfers=(t,)),), 0.0, n_chunks=3)
    out[f"partial/{{name}}"] = np.asarray(per_rank(compile_schedule(s, "d"), 3, T._inputs(3, 12, 7)))

fence(True)
for key in T.GRAD_KEYS:
    kw = T.grad_kwargs(key, wire_dtype=jnp.float32)
    grads = T._grad_tree(4, 1)
    ef = T._grad_tree(4, 2) if "compress" in kw else None
    def fn(t, kw=kw, key=key):
        g, e = t
        red, new_ef, log = all_reduce_grads(g, ("d",), algo="lumorph4",
                                            bucket_bytes=T.GRAD_BUCKET_BYTES,
                                            error_feedback=e, **kw)
        logs[key] = log
        return red, new_ef
    red, new_ef = per_rank(fn, 4, (grads, ef))
    for path, leaf in jax.tree_util.tree_flatten_with_path(red)[0]:
        out[f"grads/{{key}}/{{jax.tree_util.keystr(path)}}"] = np.asarray(leaf, np.float32)
    if new_ef is not None:
        for path, leaf in jax.tree_util.tree_flatten_with_path(new_ef)[0]:
            out[f"ef/{{key}}/{{jax.tree_util.keystr(path)}}"] = np.asarray(leaf)
np.savez({npz!r}, **out)
print(json.dumps({{k: [[int(b), a] for b, a in v] for k, v in logs.items()}}))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    npz = tmp_path_factory.mktemp("collectives") / "ref.npz"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    r = subprocess.run(
        [sys.executable, "-c", CHECK.format(src=SRC, tests=str(Path(__file__).parent),
                                            npz=str(npz))],
        capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(npz) as f:
        arrays = dict(f)
    return arrays, json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("algo", ALGOS)
def test_executor_bit_identical_to_compile_schedule(ref, algo, p):
    x = torch.from_numpy(_inputs(p, N, p))
    got = tcol.compile_schedule(tcol.schedule_for_execution(algo, p), p)(x)
    np.testing.assert_array_equal(got.numpy(), ref[0][f"{algo}/{p}"])
    np.testing.assert_array_equal(tcol.all_reduce(x, algo).numpy(), ref[0][f"{algo}/{p}"])
    assert torch.equal(x, torch.from_numpy(_inputs(p, N, p)))  # the input is untouched


@pytest.mark.parametrize("p", [2, 4, 8])
def test_int8_path_bit_identical_to_compressed_all_reduce(ref, p):
    x = _inputs(p, N, p)
    got = tgc.compressed_all_reduce(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref[0][f"int8/{p}"])
    # the program as XLA contracts it: within a hundred-thousandth of the
    # largest sum, against an int8 error (each hop ~½ a level of 1/127 of
    # its block's max) about a hundred times that
    exact = np.tile(x.sum(0, keepdims=True, dtype=np.float64), (p, 1))
    scale = np.abs(exact).max()
    contracted = ref[0][f"int8-contracted/{p}"]
    assert np.abs(got - contracted).max() <= 1e-5 * scale
    assert 1e-4 * scale < np.abs(got - exact).max() <= 0.05 * scale


@pytest.mark.parametrize("name", sorted(PARTIAL))
def test_partial_permutations_match_reference(ref, name):
    perm, send, recv, reduce = PARTIAL[name]
    t = tsch.Transfer(perm, np.asarray(send, np.int32), np.asarray(recv, np.int32), reduce)
    s = tsch.Schedule(name, (0, 1, 2), (tsch.Round(perm, 0.0, transfers=(t,)),), 0.0, n_chunks=3)
    x = torch.from_numpy(_inputs(3, 12, 7))
    got = tcol.compile_schedule(s, 3)(x)
    np.testing.assert_array_equal(got.numpy(), ref[0][f"partial/{name}"])
    if name == "overwrite":  # only rank 1 is a destination: ranks 0 and 2 keep all chunks
        assert torch.equal(got[0], x[0]) and torch.equal(got[2], x[2])
        assert torch.equal(got[1, 0:4], x[0, 8:12])  # rank 0's chunk 2 landed in chunk 0


@pytest.mark.parametrize("key", GRAD_KEYS)
def test_all_reduce_grads_matches_reference(ref, key):
    arrays, logs = ref
    to_t = lambda node: ({k: to_t(v) for k, v in node.items()} if isinstance(node, dict)
                         else torch.from_numpy(node))
    kw = grad_kwargs(key, wire_dtype=torch.float32)
    ef = to_t(_grad_tree(4, 2)) if "compress" in kw else None
    red, new_ef, log = tgc.all_reduce_grads(to_t(_grad_tree(4, 1)), algo="lumorph4",
                                            bucket_bytes=GRAD_BUCKET_BYTES,
                                            error_feedback=ef, **kw)
    assert [list(e) for e in log] == logs[key]
    assert len(log) > 3
    assert all(a.endswith("+ovl4") == key.endswith("-ovl4") for _, a in log)
    flat = {"['a']": red["a"], "['b']['c']": red["b"]["c"], "['b']['d']": red["b"]["d"],
            "['e']": red["e"]}
    for path, leaf in flat.items():
        np.testing.assert_array_equal(leaf.float().numpy(), arrays[f"grads/{key}/{path}"])
    if "compress" in kw:
        for path, leaf in {"['a']": new_ef["a"], "['b']['c']": new_ef["b"]["c"],
                           "['b']['d']": new_ef["b"]["d"], "['e']": new_ef["e"]}.items():
            np.testing.assert_array_equal(leaf.numpy(), arrays[f"ef/{key}/{path}"])
        # the ranks end apart: the owner keeps its exact chunk, peers get int8 copies
        assert not torch.equal(red["a"][0], red["a"][1])
    else:
        assert new_ef is None


def test_width_mismatch_raises_and_p1_is_identity():
    s = tcol.schedule_for_execution("ring", 4)
    with pytest.raises(ValueError, match="4 participants"):
        tcol.compile_schedule(s, 3)
    fn = tcol.compile_schedule(s, 4)
    with pytest.raises(ValueError, match="4 participants"):
        fn(torch.zeros(3, 10))
    x = torch.arange(16.0).reshape(1, 16)
    for algo in (*ALGOS, "psum"):
        assert torch.equal(tcol.all_reduce(x, algo), x)
    with pytest.raises(ValueError, match="unknown collective"):
        tcol.all_reduce(x, "nope")


def test_lumorph2_falls_to_ring_off_powers_of_two():
    assert tcol.schedule_for_execution("lumorph2", 6).algo == "ring"
    x = torch.from_numpy(_inputs(6, 50, 0))
    assert torch.equal(tcol.all_reduce(x, "lumorph2"), tcol.all_reduce(x, "ring"))
    np.testing.assert_allclose(tcol.all_reduce(x, "psum").numpy(),
                               np.tile(x.numpy().sum(0, keepdims=True), (6, 1)), rtol=1e-6)
    with pytest.raises(ValueError, match="power-of-two"):
        tgc.compressed_all_reduce(x)


def test_recv_rows_never_repeat_a_chunk():
    """Every reduce transfer adds each chunk at most once per rank, which is
    what makes one index_add_ per transfer equal to ``buf.at[recv].add``."""
    for p in PS:
        for algo in ALGOS:
            for rnd in tcol.schedule_for_execution(algo, p).materialize().rounds:
                for t in rnd.transfers:
                    assert all(len(set(r)) == len(r) for r in t.recv.tolist()), (algo, p)


def test_port_schedules_equal_reference_tables():
    from repro.core import scheduler as jsch
    for p in PS:
        for algo in ALGOS:
            a = jsch.build_schedule(algo, tuple(range(p)), 1e6).materialize()
            b = tsch.build_schedule(algo, tuple(range(p)), 1e6).materialize()
            assert (a.algo, a.participants, a.n_chunks) == (b.algo, b.participants, b.n_chunks)
            assert len(a.rounds) == len(b.rounds)
            for ra, rb in zip(a.rounds, b.rounds):
                np.testing.assert_array_equal(ra.pairs_arr, rb.pairs_arr)
                assert (ra.bytes_per_circuit, ra.egress_fanout, ra.reduce) == \
                    (rb.bytes_per_circuit, rb.egress_fanout, rb.reduce)
                for ta, tb in zip(ra.transfers, rb.transfers, strict=True):
                    assert ta.perm == tb.perm and ta.reduce == tb.reduce
                    np.testing.assert_array_equal(ta.send, tb.send)
                    np.testing.assert_array_equal(ta.recv, tb.recv)
