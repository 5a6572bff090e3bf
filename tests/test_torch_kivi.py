"""The port's int8 (KIVI-style) KV cache against the JAX package's.

  * ``_quant_kv`` and ``_dequant_kv`` on seeded inputs: bit for bit against
    the jitted reference, whose XLA program multiplies by fp32(1/127) where
    the source divides by 127 (ROADMAP Queue 3); against the unjitted
    reference, each scale within one ulp and each payload within one step;
  * the quantizer's bound: ``|q·scale − x| ≤ scale/2`` up to the rounding of
    ``x / scale`` in fp32, at most one fp32 ulp of ``amax = 127·scale``;
  * ``init_kv_cache``'s int8 tree, leaf for leaf;
  * ``decode_step`` from an int8 cache against the jitted JAX
    ``decode_step`` (as the JAX serving driver runs it), step by step for
    12 steps on danube's smoke config with a sliding window of 6, so that
    the ring wraps twice (fp32 within 2e-5, tests/test_kernels.py:45);
  * the int8 cache's decode against the compute-dtype cache's on danube and
    on zamba2 (whose shared block keeps an int8 cache too), within the 5e-2
    that chip_smoke.py's phase 13 asks at full width, in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.bridge import flatten_with_paths, params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _kv(seed=0, shape=(3, 7, 4, 80)):
    """Per-(token, head) magnitudes over six decades, an all-zero row and
    values on exact .5 steps of their scale."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * 10.0 ** rng.uniform(-3, 3, shape[:-1] + (1,))
    x[0, 0, 0] = 0.0
    x[0, 1, 0] = np.arange(shape[-1]) - 40.5  # amax 40.5: half steps of 40.5/127
    return x.astype(np.float32)


def _pair(x, dtype):
    jdt, tdt = DTYPES[dtype]
    xj = jnp.asarray(x).astype(jdt)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quant_and_dequant_match_jitted_jax_bit_for_bit(dtype, seed):
    xj, xt = _pair(_kv(seed), dtype)
    qj, sj = jax.jit(jattn._quant_kv)(xj)
    qt, st = tattn._quant_kv(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32 and st.shape == xt.shape[:-1]
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert np.array_equal(st.numpy(), np.asarray(sj))
    jdt, tdt = DTYPES[dtype]
    dj = jax.jit(jattn._dequant_kv, static_argnums=2)(qj, sj, jdt)
    dt = tattn._dequant_kv(qt, st, tdt)
    assert dt.dtype == tdt
    assert np.array_equal(dt.float().numpy(), np.asarray(dj.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quant_within_an_ulp_of_unjitted_jax(dtype):
    """The unjitted reference divides by 127: a scale one ulp away, and where
    it is, a payload one step away at most."""
    xj, xt = _pair(_kv(3, (8, 33, 4, 80)), dtype)
    qe, se = (np.asarray(a) for a in jattn._quant_kv(xj))
    qt, st = (a.numpy() for a in tattn._quant_kv(xt))
    ulp = np.spacing(se)
    assert np.all(np.abs(st - se) <= ulp)
    assert 0 < np.mean(st != se) < 0.2  # the two roundings differ somewhere
    assert np.abs(qt.astype(np.int32) - qe).max() <= 1


@pytest.mark.parametrize("seed", [0, 1])
def test_quantizer_bound(seed):
    x = _kv(seed, (4, 16, 8, 80))
    q, s = tattn._quant_kv(torch.from_numpy(x))
    q, s = q.numpy().astype(np.float64), s.numpy().astype(np.float64)
    err = np.abs(q * s[..., None] - x.astype(np.float64))
    slack = np.spacing(np.float32(127) * s.astype(np.float32)).astype(np.float64)
    assert np.all(err <= s[..., None] / 2 + slack[..., None])
    assert np.all(np.abs(q) <= 127) and np.all(s > 0)


def test_init_kv_cache_int8_tree_is_the_references():
    jc = jattn.init_kv_cache(2, 9, 3, 16, "int8")
    for dtype in ("int8", torch.int8):
        tc = tattn.init_kv_cache(2, 9, 3, 16, dtype)
        got, want = flatten_with_paths(tc), flatten_with_paths(jc)
        assert [k for k, _ in got] == [k for k, _ in want] == \
            ["k", "k_scale", "pos", "v", "v_scale"]
        for (k, t), (_, a) in zip(got, want):
            assert str(t.dtype).split(".")[-1] == str(a.dtype), k
            assert np.array_equal(t.numpy(), np.asarray(a)), k


def test_decode_from_int8_cache_matches_jax():
    arch, window, steps = "h2o-danube-1.8b", 6, 12
    over = {"compute_dtype": "float32", "kv_cache_dtype": "int8", "sliding_window": window}
    jcfg = jax_smoke_config(arch).replace(**over)
    tcfg = get_smoke_config(arch).replace(**over)
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params))
    b, max_len = 2, steps + 2
    jc, tc = jtf.init_caches(jcfg, b, max_len), ttf.init_caches(tcfg, b, max_len)
    tags = ttf.cache_layout(tcfg)
    kv = [i for i, tag in enumerate(tags) if tag in ("dense", "moe", "shared")]
    assert kv and all("k_scale" in tc[i] for i in kv)
    assert tc[kv[0]]["k"].shape[1] == window < steps  # the ring wraps
    decode = jax.jit(lambda p, c, t, pos: jtf.decode_step(p, c, t, pos, jcfg))
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (b, steps), dtype=np.int32)
    payload_diff = 0
    for t in range(steps):
        lj, jc = decode(params, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        lt, tc = ttf.decode_step(tparams, tc, torch.from_numpy(toks[:, t:t + 1]).long(), t, tcfg)
        lj = np.asarray(lj)
        assert np.abs(lt.numpy() - lj).max() / np.abs(lj).max() < 2e-5, t
        for i in kv:
            assert np.array_equal(tc[i]["pos"].numpy(), np.asarray(jc[i]["pos"])), (t, i)
            for name in ("k", "v"):
                s_t, s_j = tc[i][name + "_scale"].numpy(), np.asarray(jc[i][name + "_scale"])
                np.testing.assert_allclose(s_t, s_j, rtol=2e-5, atol=0)
                d = np.abs(tc[i][name].numpy().astype(np.int32) - np.asarray(jc[i][name]))
                assert d.max() <= 1, (t, i, name)
                payload_diff = max(payload_diff, float(np.mean(d > 0)))
    # a few ulps of k or v may move a rare value to the next int8 step, which
    # moves the logits past 2e-5: none does here
    assert payload_diff == 0


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "zamba2-1.2b"])
def test_int8_cache_decode_tracks_the_full_precision_cache(arch):
    """16 decode steps (fp32 compute) from the int8 cache and from the fp32
    cache, the same tokens fed to both, in the port and in JAX: the int8
    cache's logits stay within 5e-2 of the fp32 cache's in both, and the
    port's distance is the reference's within 2×."""
    base = get_smoke_config(arch).replace(compute_dtype="float32")
    jbase = jax_smoke_config(arch).replace(compute_dtype="float32")
    params = jtf.init_params(jax.random.PRNGKey(1), jbase)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params))
    b, steps = 2, 16
    toks = np.random.default_rng(6).integers(0, base.vocab_size, (b, steps), dtype=np.int32)
    logits = {}
    for kv in ("float32", "int8"):
        tcfg, jcfg = base.replace(kv_cache_dtype=kv), jbase.replace(kv_cache_dtype=kv)
        tc, jc = ttf.init_caches(tcfg, b, steps), jtf.init_caches(jcfg, b, steps)
        decode = jax.jit(lambda p, c, t, pos, cfg=jcfg: jtf.decode_step(p, c, t, pos, cfg))
        lt, lj = [], []
        for t in range(steps):
            out, tc = ttf.decode_step(tparams, tc, torch.from_numpy(toks[:, t:t + 1]).long(),
                                      t, tcfg)
            lt.append(out.numpy())
            out, jc = decode(params, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
            lj.append(np.asarray(out))
        logits[kv] = np.stack(lt), np.stack(lj)
    rel = [np.abs(logits["int8"][i] - logits["float32"][i]).max()
           / np.abs(logits["float32"][i]).max() for i in (0, 1)]
    assert 0 < rel[0] < 5e-2 and 0 < rel[1] < 5e-2, rel
    assert rel[0] < 2 * rel[1], rel
