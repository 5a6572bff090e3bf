"""The port's layers against ``repro.models.layers`` on the same numpy inputs:
fp32 to 1e-5, bf16 to 2e-2."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import layers as jl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = ["float32", "bfloat16"]


def _pair(a: np.ndarray, dt: str = "float32"):
    return jnp.asarray(a, _JNP[dt]), torch.from_numpy(np.ascontiguousarray(a)).to(_TORCH[dt])


def _close(got, expect, dt):
    g = got.float().numpy()
    e = np.asarray(jnp.asarray(expect, jnp.float32))
    assert got.dtype == _TORCH[dt]
    err = float(np.abs(g - e).max())
    assert err < _TOL[dt], err


@pytest.mark.parametrize("dt", DTYPES)
def test_rmsnorm(dt):
    rs = np.random.default_rng(0)
    x = rs.standard_normal((3, 7, 64), dtype=np.float32)
    w = rs.standard_normal((64,), dtype=np.float32) * 0.2
    (xj, xt), (wj, wt) = _pair(x, dt), _pair(w)
    _close(tl.rmsnorm(xt, wt), jl.rmsnorm(xj, wj), dt)


@pytest.mark.parametrize("dt", DTYPES)
def test_layernorm(dt):
    rs = np.random.default_rng(1)
    x = rs.standard_normal((3, 7, 48), dtype=np.float32) * 3 + 1
    w = rs.standard_normal((48,), dtype=np.float32)
    bias = rs.standard_normal((48,), dtype=np.float32)
    (xj, xt), (wj, wt), (bj, bt) = _pair(x, dt), _pair(w), _pair(bias)
    _close(tl.layernorm(xt, wt, bt), jl.layernorm(xj, wj, bj), dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("rotary_dim", [None, 8])  # full and partial (GLM-style) rotary
def test_apply_rope(dt, rotary_dim):
    rs = np.random.default_rng(2)
    x = rs.standard_normal((2, 9, 3, 16), dtype=np.float32)
    pos = np.broadcast_to(np.arange(100, 109, dtype=np.int32), (2, 9)).copy()
    xj, xt = _pair(x, dt)
    got = tl.apply_rope(xt, torch.from_numpy(pos), 10000.0, rotary_dim)
    _close(got, jl.apply_rope(xj, jnp.asarray(pos), 10000.0, rotary_dim), dt)
    if rotary_dim:
        assert torch.equal(got[..., rotary_dim:], xt[..., rotary_dim:])


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("style", ["swiglu", "gelu"])
def test_apply_mlp(dt, style):
    rs = np.random.default_rng(3)
    d, f = 32, 80
    x = rs.standard_normal((2, 5, d), dtype=np.float32)
    names = ("wi", "wg", "wo") if style == "swiglu" else ("wi", "wo")
    shapes = {"wi": (d, f), "wg": (d, f), "wo": (f, d)}
    p = {n: rs.standard_normal(shapes[n], dtype=np.float32) / np.sqrt(shapes[n][0])
         for n in names}
    pj = {n: jnp.asarray(a) for n, a in p.items()}
    pt = {n: torch.from_numpy(a) for n, a in p.items()}
    xj, xt = _pair(x, dt)
    _close(tl.apply_mlp(pt, xt, style), jl.apply_mlp(pj, xj, style), dt)
