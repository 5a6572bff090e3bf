"""Overlap mode in the port against the JAX package: the chunked lowering
(``chunk_schedule``) wave for wave, and ``overlapped_all_reduce`` on the
virtual-rank executor against JAX's under ``shard_map`` on 8 fake CPU
devices.

One subprocess (``XLA_FLAGS`` stays out of the pytest process) computes
every JAX case and writes one ``.npz``; the port runs on the same numpy
inputs:

  * ring, lumorph2, lumorph4 and tree at p = 8, C ∈ {1, 2, 4, 7}, width 37
    (so that chunk and wave padding show): bit-identical in fp32 and bf16,
    and in int8 with XLA's multiply-add contraction fenced as in
    tests/test_torch_collectives.py; C = 1 bit-identical to the monolithic
    path;
  * ``compute=y*2`` gives twice the sum;
  * the benchmark's consumer, ``fused_rmsnorm`` over rows of 128 (the Pallas
    kernel in interpret mode there, the plain version here), at p = 8 and
    2¹⁶ elements per rank, monolithic and C ∈ {2, 4, 8}: within 1e-5.

``all_reduce_grads(overlap_chunks=4)`` is held against JAX's in
tests/test_torch_collectives.py, beside the monolithic cases.

The port has no hierarchical composition, so ``hier:*`` schedules are not
compared (ROADMAP).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import scheduler as jsch  # noqa: E402
from repro_torch.core import collectives as tcol  # noqa: E402
from repro_torch.core import scheduler as tsch  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.optim import grad_comm as tgc  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
PS = (2, 3, 4, 6, 8)
ALGOS = ("ring", "lumorph2", "lumorph4", "tree")
CHUNKS = (1, 2, 4, 7)
P, WIDTH = 8, 37
MODES = ("f32", "bf16", "int8")
RMS_N, RMS_D, RMS_CHUNKS = 1 << 16, 128, (1, 2, 4, 8)


def _inputs(p: int, n: int, seed: int) -> np.ndarray:
    """Values over six decades, signed, so that the add order shows."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((p, n)) * 10.0 ** rng.uniform(-3, 3, (p, n))).astype(np.float32)


def _rms_inputs() -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(5)
    return (rng.standard_normal((P, RMS_N)).astype(np.float32),
            (rng.standard_normal(RMS_D) * 0.2).astype(np.float32))


CHECK = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, {src!r}); sys.path.insert(0, {tests!r})
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro import compat
from repro.core.collectives import (compile_schedule, make_overlapped_all_reduce,
                                    overlapped_all_reduce, schedule_for_execution)
from repro.kernels import ops
from repro.optim import grad_comm
from repro.optim.grad_comm import _int8_decode, _int8_encode
import test_torch_overlap as T

_deq = grad_comm.dequantize_int8
def _fenced(q, s, n):  # a select between the product and the add: no contraction
    y = _deq(q, s, n)
    return jnp.where(jnp.isnan(y), jnp.float32(0), y)
grad_comm.dequantize_int8 = _fenced

mesh = Mesh(np.array(jax.devices()[:T.P]), ("d",))
def per_rank(fn, tree):
    body = lambda t: jax.tree.map(lambda a: a[None], fn(jax.tree.map(lambda a: a[0], t)))
    return jax.jit(compat.shard_map(body, mesh=mesh, in_specs=P("d"), out_specs=P("d"),
                                    axis_names={{"d"}}, check_vma=False))(tree)

out = {{}}
x = T._inputs(T.P, T.WIDTH, 11)
for mode in T.MODES:
    dtype = jnp.bfloat16 if mode == "bf16" else jnp.float32
    enc, dec = (_int8_encode, _int8_decode) if mode == "int8" else (None, None)
    xs = jnp.asarray(x).astype(dtype)
    for algo in T.ALGOS:  # one program per algo and mode: the monolithic path, then each C
        mono = compile_schedule(schedule_for_execution(algo, T.P), "d", encode=enc, decode=dec)
        fns = [mono] + [lambda v, C=C: overlapped_all_reduce(
            v, "d", algo, n_chunks=C, encode=enc, decode=dec) for C in T.CHUNKS]
        res = per_rank(lambda v: tuple(f(v) for f in fns), xs)
        for key, r in zip(["mono", *T.CHUNKS], res):
            out[f"{{mode}}/{{algo}}/{{key}}"] = np.asarray(r.astype(jnp.float32))

f = make_overlapped_all_reduce(mesh, "d", algo="ring", n_chunks=4, compute=lambda y: y * 2.0)
out["double"] = np.asarray(f(jnp.asarray(x)))

xr, w = T._rms_inputs()
w = jnp.asarray(w)
def compute(y):  # the benchmark's per-chunk consumer: the Pallas rmsnorm
    return ops.fused_rmsnorm(y.reshape(-1, T.RMS_D), w).reshape(y.shape)
for C in T.RMS_CHUNKS:
    if C == 1:
        mono = compile_schedule(schedule_for_execution("lumorph2", T.P), "d")
        fn = lambda v: compute(mono(v))
    else:
        fn = lambda v, C=C: overlapped_all_reduce(v, "d", "lumorph2", n_chunks=C,
                                                  compute=compute)
    out[f"rms/{{C}}"] = np.asarray(per_rank(fn, jnp.asarray(xr)))

np.savez({npz!r}, **out)
"""


@pytest.fixture(scope="module", autouse=True)
def _jax_cases(tmp_path_factory):
    """Starts the JAX subprocess with the module's first test, so that it
    overlaps the schedule tests before the ones that read it."""
    npz = tmp_path_factory.mktemp("overlap") / "ref.npz"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    code = CHECK.format(src=SRC, tests=str(Path(__file__).parent), npz=str(npz))
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    yield proc, npz
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def ref(_jax_cases):
    proc, npz = _jax_cases
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    with np.load(npz) as f:
        return dict(f)


# ---------------------------------------------------------------------------
# the chunked lowering, shape and tables
# ---------------------------------------------------------------------------

def _same_round(ra, rb):
    np.testing.assert_array_equal(ra.pairs_arr, rb.pairs_arr)
    assert (ra.bytes_per_circuit, ra.egress_fanout, ra.reduce) == \
        (rb.bytes_per_circuit, rb.egress_fanout, rb.reduce)


@pytest.mark.parametrize("C", CHUNKS)
@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("algo", ALGOS)
def test_chunk_schedule_equals_jax_wave_for_wave(algo, p, C):
    jb = jsch.build_schedule(algo, tuple(range(p)), 1e6)
    tb = tsch.build_schedule(algo, tuple(range(p)), 1e6)
    a, b = jsch.chunk_schedule(jb, C), tsch.chunk_schedule(tb, C)
    assert not tb.materialized  # chunking builds no Transfer tables
    assert (a.algo, a.participants, a.n_chunks) == (b.algo, b.participants, b.n_chunks)
    assert len(a.waves) == len(b.waves)
    for wa, wb in zip(a.waves, b.waves):
        assert (wa.chunk, wa.phase) == (wb.chunk, wb.phase)
        sa, sb = wa.schedule, wb.schedule
        assert (sa.algo, sa.participants, sa.n_bytes, sa.n_chunks) == \
            (sb.algo, sb.participants, sb.n_bytes, sb.n_chunks)
        assert len(sa.rounds) == len(sb.rounds)
        for ra, rb in zip(sa.materialize().rounds, sb.materialize().rounds):
            _same_round(ra, rb)
            for ta, tb_ in zip(ra.transfers, rb.transfers, strict=True):
                assert ta.perm == tb_.perm and ta.reduce == tb_.reduce
                np.testing.assert_array_equal(ta.send, tb_.send)
                np.testing.assert_array_equal(ta.recv, tb_.recv)
    # every base round lands in exactly one wave of each chunk, rs before ag,
    # and the waves reuse the base's Transfer tables
    for c in range(C):
        waves = b.waves_of_chunk(c)
        assert [w.phase for w in waves] == ["rs", "ag"][:len(waves)] or \
            [w.phase for w in waves] == ["ag"]
        rounds = [r for w in waves for r in w.schedule.rounds]
        assert len(rounds) == len(tb.rounds)
        for r, base in zip(rounds, tb.rounds):
            assert r.pairs_arr is base.pairs_arr and r.transfers is base.transfers


def test_schedule_for_execution_keys_on_n_chunks():
    """The executable-schedule LRU must not mix chunked and monolithic
    entries (twin of tests/test_overlap.py's cache-keying regression)."""
    tcol.schedule_for_execution.cache_clear()
    mono = tcol.schedule_for_execution("ring", 8)
    chunked = tcol.schedule_for_execution("ring", 8, 4)
    assert isinstance(chunked, tsch.ChunkedSchedule)
    assert not isinstance(mono, tsch.ChunkedSchedule)
    assert chunked.base is mono
    assert tcol.schedule_for_execution("ring", 8) is mono
    assert tcol.schedule_for_execution("ring", 8, 4) is chunked
    other = tcol.schedule_for_execution("ring", 8, 2)
    assert other is not chunked and other.n_chunks == 2
    assert tcol.schedule_for_execution("ring", 8, 1) is not chunked
    tcol.schedule_for_execution.cache_clear()
    assert tcol.schedule_for_execution.cache_info().currsize == 0


def test_chunked_pricing_and_bad_phases_raise():
    """A chunked schedule prices as JAX's does on the ideal fabric; pricing
    or validating against anything but a rack or a pod raises."""
    from repro.core.cost_model import LUMORPH_LINK as jlink
    from repro_torch.core.cost_model import LUMORPH_LINK as tlink
    ch = tsch.chunk_schedule(tsch.build_schedule("ring", tuple(range(4)), 1e6), 2)
    jch = jsch.chunk_schedule(jsch.build_schedule("ring", tuple(range(4)), 1e6), 2)
    for name in ("wave_costs", "chunk_costs", "cost", "overlapped_cost"):
        assert getattr(ch, name)(tlink) == getattr(jch, name)(jlink), name
    assert len(ch.wave_costs(tlink)) == 4 and len(ch.chunk_costs(tlink)) == 2
    for method in (ch.wave_costs, ch.chunk_costs, ch.cost, ch.overlapped_cost):
        with pytest.raises(TypeError, match="LumorphRack or a Pod"):
            method(tlink, object())
    with pytest.raises(TypeError, match="LumorphRack or a Pod"):
        ch.validate(object())
    with pytest.raises(ValueError, match="≥ 1"):
        tsch.chunk_schedule(ch.base, 0)
    r_rs, r_ag = (tsch.Round(((0, 1),), 1.0, reduce=flag) for flag in (True, False))
    with pytest.raises(ValueError, match="after all-gather"):
        tsch.chunk_schedule(tsch.Schedule("x", (0, 1), (r_ag, r_rs), 1.0), 2)
    with pytest.raises(ValueError, match="phase-tagged"):
        tsch.chunk_schedule(tsch.Schedule("x", (0, 1), (tsch.Round(((0, 1),), 1.0),), 1.0), 2)


# ---------------------------------------------------------------------------
# execution against JAX's overlapped_all_reduce
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("mode", MODES)
def test_overlapped_all_reduce_bit_identical_to_jax(ref, mode, algo):
    dtype = torch.bfloat16 if mode == "bf16" else torch.float32
    enc, dec = (tgc._int8_encode, tgc._int8_decode) if mode == "int8" else (None, None)
    x = torch.from_numpy(_inputs(P, WIDTH, 11)).to(dtype)
    mono = tcol.compile_schedule(tcol.schedule_for_execution(algo, P), P, enc, dec)(x)
    np.testing.assert_array_equal(mono.float().numpy(), ref[f"{mode}/{algo}/mono"])
    exact = x.double().sum(0).numpy()
    for C in CHUNKS:
        got = tcol.overlapped_all_reduce(x, algo, C, encode=enc, decode=dec)
        assert got.dtype == dtype and got.shape == x.shape
        np.testing.assert_array_equal(got.float().numpy(), ref[f"{mode}/{algo}/{C}"],
                                      err_msg=f"C={C}")
        if C == 1:  # the wave split adds no arithmetic
            assert torch.equal(got, mono)
        rtol = 1e-5 if mode == "f32" else 5e-2
        assert np.abs(got.double().numpy() - exact).max() <= rtol * np.abs(exact).max()


def test_compute_consumer_gives_twice_the_sum(ref):
    x = torch.from_numpy(_inputs(P, WIDTH, 11))
    f = tcol.make_overlapped_all_reduce(P, "ring", n_chunks=4, compute=lambda y: y * 2.0)
    got = f(x)
    np.testing.assert_array_equal(got.numpy(), ref["double"])
    torch.testing.assert_close(got, 2.0 * tcol.all_reduce(x, "ring"), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="built for 8 ranks"):
        f(x[:4])


@pytest.mark.parametrize("C", RMS_CHUNKS)
def test_rmsnorm_consumer_matches_pallas_run(ref, C):
    """The benchmark's pipeline: lumorph2 over 8 ranks with fused_rmsnorm on
    each reduced chunk, one wrapper call per chunk covering every rank's rows."""
    xr, w = _rms_inputs()
    x, wt = torch.from_numpy(xr), torch.from_numpy(w)
    calls = []

    def compute(y):
        calls.append(tuple(y.shape))
        return tops.fused_rmsnorm(y.reshape(-1, RMS_D), wt).reshape(y.shape)
    launches = dict(tops.LAUNCHES)
    if C == 1:
        got = compute(tcol.all_reduce(x, "lumorph2"))
    else:
        got = tcol.overlapped_all_reduce(x, "lumorph2", C, compute=compute)
    assert calls == [(P, RMS_N // C)] * C
    assert tops.LAUNCHES == launches  # CPU tensors take the plain version
    expect = ref[f"rms/{C}"]
    assert np.abs(got.numpy() - expect).max() <= 1e-5 * np.abs(expect).max()


def test_waves_and_compute_issue_in_jax_order(monkeypatch):
    """Chunk c's rs wave, its ag wave, then chunk c−1's compute."""
    events = []
    real = tcol._wave_program

    def spy(sched, p, enc, dec):
        fn = real(sched, p, enc, dec)
        phase = "rs" if sched.rounds[0].reduce else "ag"
        return lambda y: (events.append(phase), fn(y))[1]
    monkeypatch.setattr(tcol, "_wave_program", spy)
    n = [0]

    def compute(y):
        events.append(f"compute{n[0]}")
        n[0] += 1
        return y
    tcol.overlapped_all_reduce(torch.ones(4, 64), "lumorph2", 3, compute=compute)
    assert events == ["rs", "ag", "rs", "ag", "compute0", "rs", "ag", "compute1", "compute2"]


def test_participant_mismatch_raises():
    s = tcol.schedule_for_execution("ring", 4)
    with pytest.raises(ValueError, match="4 participants"):
        tcol.overlapped_all_reduce(torch.zeros(3, 10), n_chunks=2, schedule=s)
    assert torch.equal(tcol.overlapped_all_reduce(torch.ones(1, 5), "ring", 2),
                       torch.ones(1, 5))
