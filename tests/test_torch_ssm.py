"""The port's SSM functions (``repro_torch.models.ssm``) against their twins in
``repro.models.ssm``, function for function, on the same inputs: params from
the JAX inits (every zero-initialized leaf moved off zero, the same values on
both sides) and inputs made from a seed with numpy. Relative max error
within 2e-5 in fp32 and 2e-2 in bf16 (tests/test_kernels.py's limits);
each ``*_step`` run over every position agrees with its full-sequence form
in both packages (1e-4, fp32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import ssm as jssm  # noqa: E402
from repro_torch.bridge import flatten_with_paths, params_from_numpy  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = ["float32", "bfloat16"]
D, N_HEADS, D_STATE, HEADDIM, EXPAND, CHUNK = 32, 4, 8, 8, 2, 8


def _rel(got, expect) -> float:
    g = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    e = np.asarray(expect, np.float32)
    return float(np.abs(g - e).max() / (np.abs(e).max() + 1e-9))


def _params(jparams: dict, seed: int = 5):
    """JAX's params with each all-zero leaf set to small random values, and the
    port's copy of them."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in jparams.items():
        a = np.asarray(v)
        if not a.any():
            a = (rng.standard_normal(a.shape) * 0.3).astype(a.dtype)
        out[k] = a
    return jax.tree.map(jnp.asarray, out), params_from_numpy(out)


def _x(shape, dtype, seed=0):
    """The same input on both sides: fp32 from numpy, rounded to ``dtype``."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    return jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype)), t


@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv1d_and_conv_step(dtype):
    """Depthwise cross-correlation with K − 1 zeros on the left, its one-token
    form over every position, and one step from a random history."""
    jx, tx = _x((2, 11, 6), dtype)
    jw, tw = _x((4, 6), dtype, seed=1)
    jb, tb = _x((6,), dtype, seed=2)
    expect = jssm.causal_conv1d(jx, jw, jb)
    got = tssm.causal_conv1d(tx, tw, tb)
    assert got.dtype == tx.dtype and got.shape == (2, 11, 6)
    assert _rel(got, expect) < TOL[dtype]
    state = torch.zeros((2, 3, 6), dtype=tx.dtype)
    for t in range(11):
        y, state = tssm.conv_step(tx[:, t], state, tw, tb)
        assert _rel(y, expect[:, t]) < TOL[dtype], t
    jh, th = _x((2, 3, 6), dtype, seed=3)
    ej, sj = jssm.conv_step(jx[:, 4], jh, jw, jb)
    et, st = tssm.conv_step(tx[:, 4], th, tw, tb)
    assert _rel(et, ej) < TOL[dtype]
    np.testing.assert_array_equal(st.float().numpy(), np.asarray(sj, np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [13, 16])  # 13 is no multiple of the chunk (8): padded
def test_mamba2_forward_matches_jax(dtype, s):
    jp, tp = _params(jssm.init_mamba2(jax.random.PRNGKey(0), D, D_STATE, HEADDIM, EXPAND))
    jx, tx = _x((2, s, D), dtype)
    expect = jssm.mamba2_forward(jp, jx, D_STATE, HEADDIM, EXPAND, CHUNK)
    got = tssm.mamba2_forward(tp, tx, D_STATE, HEADDIM, EXPAND, CHUNK)
    assert got.dtype == tx.dtype and got.shape == (2, s, D)
    assert _rel(got, expect) < TOL[dtype]


def _replay(step, fwd, state, x):
    """A step function over every position of x against the full forward."""
    full = fwd(x)
    worst = 0.0
    for t in range(x.shape[1]):
        y, state = step(x[:, t:t + 1], state)
        worst = max(worst, _rel(y[:, 0], full[:, t]))
    return worst, state


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba2_step_matches_jax_and_replays_forward(dtype):
    """Each port step against JAX's step from the same state; and in fp32,
    the steps over all 13 positions against each package's own forward."""
    jp, tp = _params(jssm.init_mamba2(jax.random.PRNGKey(1), D, D_STATE, HEADDIM, EXPAND))
    jx, tx = _x((2, 13, D), dtype, seed=4)
    cdt = getattr(torch, dtype)
    js = jssm.init_mamba2_state(2, D, D_STATE, HEADDIM, EXPAND, dtype=getattr(jnp, dtype))
    ts = tssm.init_mamba2_state(2, D, D_STATE, HEADDIM, EXPAND, dtype=cdt)
    assert [(k, tuple(v.shape)) for k, v in flatten_with_paths(ts)] == \
           [(k, tuple(np.shape(v))) for k, v in flatten_with_paths(js)]
    for t in range(13):
        yj, js = jssm.mamba2_step(jp, jx[:, t:t + 1], js, D_STATE, HEADDIM, EXPAND)
        yt, ts = tssm.mamba2_step(tp, tx[:, t:t + 1], ts, D_STATE, HEADDIM, EXPAND)
        assert _rel(yt, yj) < TOL[dtype], t
        assert _rel(ts["h"], js["h"]) < TOL[dtype], t
        assert ts["conv"].dtype == cdt
    if dtype == "float32":
        worst, _ = _replay(lambda xx, st: tssm.mamba2_step(tp, xx, st, D_STATE, HEADDIM, EXPAND),
                           lambda xx: tssm.mamba2_forward(tp, xx, D_STATE, HEADDIM, EXPAND, CHUNK),
                           tssm.init_mamba2_state(2, D, D_STATE, HEADDIM, EXPAND), tx)
        assert worst < 1e-4
        worst, _ = _replay(lambda xx, st: jssm.mamba2_step(jp, xx, st, D_STATE, HEADDIM, EXPAND),
                           lambda xx: jssm.mamba2_forward(jp, xx, D_STATE, HEADDIM, EXPAND, CHUNK),
                           jssm.init_mamba2_state(2, D, D_STATE, HEADDIM, EXPAND), jx)
        assert worst < 1e-4


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm_forward_matches_jax(dtype):
    jp, tp = _params(jssm.init_mlstm(jax.random.PRNGKey(2), D, N_HEADS, EXPAND))
    jx, tx = _x((2, 13, D), dtype, seed=6)
    expect = jssm.mlstm_forward(jp, jx, N_HEADS, EXPAND)
    got = tssm.mlstm_forward(tp, tx, N_HEADS, EXPAND)
    assert got.dtype == tx.dtype and got.shape == (2, 13, D)
    assert _rel(got, expect) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm_step_matches_jax_and_replays_forward(dtype):
    """From m = −inf: the first step's forget term is 0, never NaN."""
    jp, tp = _params(jssm.init_mlstm(jax.random.PRNGKey(3), D, N_HEADS, EXPAND))
    jx, tx = _x((2, 13, D), dtype, seed=7)
    js = jssm.init_mlstm_state(2, D, N_HEADS, EXPAND, dtype=getattr(jnp, dtype))
    ts = tssm.init_mlstm_state(2, D, N_HEADS, EXPAND, dtype=getattr(torch, dtype))
    assert torch.isinf(ts["m"]).all() and (ts["m"] < 0).all()
    for t in range(13):
        yj, js = jssm.mlstm_step(jp, jx[:, t:t + 1], js, N_HEADS, EXPAND)
        yt, ts = tssm.mlstm_step(tp, tx[:, t:t + 1], ts, N_HEADS, EXPAND)
        assert torch.isfinite(yt).all() and torch.isfinite(ts["C"]).all(), t
        assert _rel(yt, yj) < TOL[dtype], t
        for k in ("C", "n", "m"):
            assert _rel(ts[k], js[k]) < TOL[dtype], (t, k)
    if dtype == "float32":
        worst, _ = _replay(lambda xx, st: tssm.mlstm_step(tp, xx, st, N_HEADS, EXPAND),
                           lambda xx: tssm.mlstm_forward(tp, xx, N_HEADS, EXPAND),
                           tssm.init_mlstm_state(2, D, N_HEADS, EXPAND), tx)
        assert worst < 1e-4


@pytest.mark.parametrize("dtype", DTYPES)
def test_slstm_forward_matches_jax(dtype):
    jp, tp = _params(jssm.init_slstm(jax.random.PRNGKey(4), D, N_HEADS))
    jx, tx = _x((2, 13, D), dtype, seed=8)
    expect = jssm.slstm_forward(jp, jx, N_HEADS)
    got = tssm.slstm_forward(tp, tx, N_HEADS)
    assert got.dtype == tx.dtype and got.shape == (2, 13, D)
    assert _rel(got, expect) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_slstm_step_matches_jax_and_replays_forward(dtype):
    """From n = 1 (not 0); the state stays fp32 whatever the input dtype."""
    jp, tp = _params(jssm.init_slstm(jax.random.PRNGKey(5), D, N_HEADS))
    jx, tx = _x((2, 13, D), dtype, seed=9)
    js, ts = jssm.init_slstm_state(2, D, N_HEADS), tssm.init_slstm_state(2, D, N_HEADS)
    assert (ts["n"] == 1).all() and all(v.dtype == torch.float32 for v in ts.values())
    for t in range(13):
        yj, js = jssm.slstm_step(jp, jx[:, t:t + 1], js, N_HEADS)
        yt, ts = tssm.slstm_step(tp, tx[:, t:t + 1], ts, N_HEADS)
        assert _rel(yt, yj) < TOL[dtype], t
        for k in ("c", "n", "h", "m"):
            assert _rel(ts[k], js[k]) < TOL[dtype], (t, k)
    if dtype == "float32":
        worst, _ = _replay(lambda xx, st: tssm.slstm_step(tp, xx, st, N_HEADS),
                           lambda xx: tssm.slstm_forward(tp, xx, N_HEADS),
                           tssm.init_slstm_state(2, D, N_HEADS), tx)
        assert worst < 1e-4


@pytest.mark.parametrize("kind", ["mamba2", "mlstm", "slstm"])
def test_inits_make_the_jax_tree(kind):
    """The port's init makes JAX's leaves (paths, shapes, dtypes), stacked
    along ``lead``, and the fixed leaves (A_log, D, gate biases) equal."""
    gen = torch.Generator().manual_seed(0)
    if kind == "mamba2":
        j = jssm.init_mamba2(jax.random.PRNGKey(0), D, D_STATE, HEADDIM, EXPAND)
        t = tssm.init_mamba2(gen, D, D_STATE, HEADDIM, EXPAND, lead=(3,))
        fixed = ("A_log", "D", "dt_bias", "conv_b", "norm_w")
    elif kind == "mlstm":
        j = jssm.init_mlstm(jax.random.PRNGKey(0), D, N_HEADS, EXPAND)
        t = tssm.init_mlstm(gen, D, N_HEADS, EXPAND, lead=(3,))
        fixed = ("if_bias", "conv_b", "norm_w")
    else:
        j = jssm.init_slstm(jax.random.PRNGKey(0), D, N_HEADS)
        t = tssm.init_slstm(gen, D, N_HEADS, lead=(3,))
        fixed = ("bias", "norm_w")
    assert sorted(j) == sorted(t)
    for k in j:
        assert tuple(t[k].shape) == (3, *j[k].shape), k
        assert str(t[k].dtype).removeprefix("torch.") == str(j[k].dtype), k
    for k in fixed:
        for i in range(3):
            np.testing.assert_allclose(t[k][i].numpy(), np.asarray(j[k]), rtol=1e-6, err_msg=k)
