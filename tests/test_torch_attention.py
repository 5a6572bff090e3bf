"""The port's attention against the JAX package: the flash-attention wrapper
(its plain version on CPU) against the Pallas kernel in interpret mode, and
the dense/mask/decode paths against their JAX twins, on the same numpy
inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels import ops as jax_kops  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dt: str):
    """The same values as a JAX array and a torch tensor of dtype ``dt``."""
    return jnp.asarray(a, _JNP[dt]), torch.from_numpy(a).to(_TORCH[dt])


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# three of tests/test_kernels.py's ATTN_CASES: GQA bf16, MQA + window + ragged, D=80
FLASH_CASES = [
    # (b, sq, skv, h, kv, d, causal, window, dtype)
    (1, 256, 256, 8, 2, 64, True, None, "bfloat16"),
    (2, 100, 100, 4, 1, 32, True, 48, "float32"),
    (1, 160, 160, 2, 2, 80, True, None, "float32"),
]


@pytest.mark.parametrize("b,sq,skv,h,kv,d,causal,window,dt", FLASH_CASES)
def test_flash_attention_matches_pallas(b, sq, skv, h, kv, d, causal, window, dt):
    rs = np.random.default_rng(0)
    qn = rs.standard_normal((b, sq, h, d), dtype=np.float32)
    kn = rs.standard_normal((b, skv, kv, d), dtype=np.float32)
    vn = rs.standard_normal((b, skv, kv, d), dtype=np.float32)
    (qj, qt), (kj, kt), (vj, vt) = _pair(qn, dt), _pair(kn, dt), _pair(vn, dt)
    expect = jax_kops.flash_attention(qj, kj, vj, causal=causal, window=window)
    n0 = kops.LAUNCHES["flash_attention"]
    out = kops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert kops.LAUNCHES["flash_attention"] == n0  # CPU tensors never launch
    assert out.shape == (b, sq, h, d) and out.dtype == qt.dtype
    tol = 2e-2 if dt == "bfloat16" else 2e-5
    err = float(np.abs(_f32(out) - _f32(expect)).max())
    assert err < tol, err


def _tensor_core_order(q, k, v, causal, window, bk=64):
    """The bf16 CUDA kernel's order of work (``csrc/flash_attention.cu``,
    ``tc::flash_fwd_bf16_kernel``) on the CPU: 64-key tiles, S in fp32, an
    online softmax in base 2 with the scale folded into log2 e, P rounded to
    bf16 per tile before P·V, fp32 accumulation, O / max(l, 1e-30)."""
    b, sq, h, d = q.shape
    skv, rep = k.shape[1], h // k.shape[2]
    qf = q.float().transpose(1, 2)                                  # [b, h, sq, d]
    kf = k.float().repeat_interleave(rep, dim=2).transpose(1, 2)    # [b, h, skv, d]
    vf = v.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    sl2 = torch.tensor((1.0 / np.sqrt(d)) * np.log2(np.e), dtype=torch.float32)
    m = torch.full((b, h, sq), -torch.inf)
    l = torch.zeros((b, h, sq))
    o = torch.zeros((b, h, sq, d))
    qi = torch.arange(sq)[:, None]
    for k0 in range(0, skv, bk):
        kj = torch.arange(k0, min(k0 + bk, skv))[None, :]
        live = torch.ones((sq, kj.shape[1]), dtype=torch.bool)
        if causal:
            live &= kj <= qi
        if window is not None:
            live &= qi - kj < window
        s = torch.where(live, qf @ kf[:, :, k0:k0 + bk].transpose(-1, -2), -torch.inf)
        mx = torch.maximum(m, s.amax(-1))
        base = torch.where(mx == -torch.inf, 0.0, mx * sl2)
        corr = torch.exp2(m * sl2 - base)
        p = torch.exp2(s * sl2 - base[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + p.bfloat16().float() @ vf[:, :, k0:k0 + bk]
        m = mx
    return (o / l.clamp(min=1e-30)[..., None]).transpose(1, 2).to(torch.bfloat16)


# tests/test_kernels.py's ATTN_CASES, every one in bf16 (the tensor-core
# kernel's type), and danube's smoke widths (4/2 heads of 16, window 16)
TC_CASES = [
    (2, 128, 128, 4, 4, 64, True, None),
    (1, 256, 256, 8, 2, 64, True, None),
    (2, 100, 100, 4, 1, 32, True, 48),
    (1, 64, 192, 2, 2, 128, False, None),
    (1, 160, 160, 2, 2, 80, True, None),
    (1, 96, 96, 3, 3, 64, True, 17),
    (2, 64, 64, 4, 2, 16, True, 16),
]


@pytest.mark.parametrize("b,sq,skv,h,kv,d,causal,window", TC_CASES)
def test_tensor_core_order_of_work_matches_pallas(b, sq, skv, h, kv, d, causal, window):
    """Rounding P to bf16 per 64-key tile, as the bf16 CUDA kernel does, stays
    within the bf16 limit (2e-2) of the Pallas kernel, which keeps P in fp32."""
    rs = np.random.default_rng(3)
    qn, kn, vn = (rs.standard_normal(shape, dtype=np.float32)
                  for shape in ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d)))
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, "bfloat16") for a in (qn, kn, vn))
    expect = jax_kops.flash_attention(qj, kj, vj, causal=causal, window=window)
    out = _tensor_core_order(qt, kt, vt, causal, window)
    assert out.shape == (b, sq, h, d)
    err = float(np.abs(_f32(out) - _f32(expect)).max())
    assert err < 2e-2, err


def _tf32(x):
    """fp32 ``x`` truncated to TF32 (10 stored mantissa bits), as the tensor
    core reads a raw fp32 operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split(x):
    """The fp32 kernel's split: hi = x's raw bits, which the tensor core reads
    truncated to TF32; lo = x − hi (exact), read truncated in turn."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mma(a, b, k: int, terms: int):
    """a @ b over the last/first axes in k-steps of 8, as mma.sync m16n8k8
    does: per step lo·hi and hi·lo first, then hi·hi, into one fp32
    accumulator (``terms`` 3); or hi·hi alone (``terms`` 1, one TF32 product)."""
    ah, al = _split(a)
    bh, bl = _split(b)
    acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    for c in range(0, k, 8):
        sa, sb = slice(c, c + 8), slice(c, c + 8)
        if terms == 3:
            acc = acc + al[..., sa] @ bh[..., sb, :]
            acc = acc + ah[..., sa] @ bl[..., sb, :]
        acc = acc + ah[..., sa] @ bh[..., sb, :]
    return acc


def _f32_tensor_core_order(q, k, v, causal, window, terms=3, bk=64):
    """The fp32 CUDA kernel's order of work (``csrc/flash_attention.cu``,
    ``f32::flash_fwd_f32_kernel``) on the CPU: 64-key tiles, S = Q·Kᵀ and
    O += P·V as TF32 products in k-steps of 8 (3xTF32: ``terms`` 3), P in
    fp32, the online softmax in base 2 with the scale folded into log2 e,
    O / max(l, 1e-30). Key tiles and k-steps past Skv or D are zeros."""
    b, sq, h, d = q.shape
    skv, rep = k.shape[1], h // k.shape[2]
    dp, kp = -(-d // 16) * 16, -(-skv // bk) * bk  # D padded to 16, Skv to the tile
    qf = torch.nn.functional.pad(q.float().transpose(1, 2), (0, dp - d))
    kf = torch.nn.functional.pad(k.float().repeat_interleave(rep, dim=2).transpose(1, 2),
                                 (0, dp - d, 0, kp - skv))
    vf = torch.nn.functional.pad(v.float().repeat_interleave(rep, dim=2).transpose(1, 2),
                                 (0, dp - d, 0, kp - skv))
    sl2 = torch.tensor((1.0 / np.sqrt(d)) * np.log2(np.e), dtype=torch.float32)
    m = torch.full((b, h, sq), -torch.inf)
    l = torch.zeros((b, h, sq))
    o = torch.zeros((b, h, sq, dp))
    qi = torch.arange(sq)[:, None]
    for k0 in range(0, skv, bk):
        kj = torch.arange(k0, k0 + bk)[None, :]
        live = kj < skv
        if causal:
            live = live & (kj <= qi)
        if window is not None:
            live = live & (qi - kj < window)
        s = _mma(qf, kf[:, :, k0:k0 + bk].transpose(-1, -2), dp, terms)
        s = torch.where(live, s, -torch.inf)
        mx = torch.maximum(m, s.amax(-1))
        base = torch.where(mx == -torch.inf, 0.0, mx * sl2)
        corr = torch.exp2(m * sl2 - base)
        p = torch.exp2(s * sl2 - base[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + _mma(p, vf[:, :, k0:k0 + bk], bk, terms)
        m = mx
    return (o / l.clamp(min=1e-30)[..., None])[..., :d].transpose(1, 2)


# tests/test_kernels.py's fp32 ATTN_CASES, a D = 128 GQA case and a ragged
# bidirectional one (Skv = 150: the last 64-key tile holds 42 zero keys)
F32_TC_CASES = [
    (2, 128, 128, 4, 4, 64, True, None),
    (2, 100, 100, 4, 1, 32, True, 48),
    (1, 64, 192, 2, 2, 128, False, None),
    (1, 160, 160, 2, 2, 80, True, None),
    (2, 100, 100, 4, 4, 64, False, None),
    (1, 70, 70, 2, 2, 64, False, None),
    (1, 192, 192, 4, 1, 128, True, None),
    (1, 150, 150, 2, 2, 72, False, None),
]


@pytest.mark.parametrize("b,sq,skv,h,kv,d,causal,window", F32_TC_CASES)
def test_f32_tensor_core_order_of_work_matches_pallas(b, sq, skv, h, kv, d, causal, window):
    """3xTF32 products per 8-wide k-step, as the fp32 CUDA kernel runs them,
    stay within the fp32 limit (1e-4) of the Pallas kernel, on unit-normal
    inputs and with q and k scaled so that the scaled scores reach ±23–32;
    one TF32 product on the same inputs does not (the reason for three)."""
    rs = np.random.default_rng(5)
    qn, kn, vn = (rs.standard_normal(shape, dtype=np.float32)
                  for shape in ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d)))
    gain = np.float32(np.sqrt(6.0))  # scaled scores of std 6
    for scale in (np.float32(1.0), gain):
        (qj, qt), (kj, kt), (vj, vt) = (_pair(a, "float32") for a in
                                        (qn * scale, kn * scale, vn))
        expect = _f32(jax_kops.flash_attention(qj, kj, vj, causal=causal, window=window))
        out = _f32_tensor_core_order(qt, kt, vt, causal, window)
        assert out.shape == (b, sq, h, d)
        err = float(np.abs(_f32(out) - expect).max())
        assert err < 1e-4, (scale, err)
        one = _f32_tensor_core_order(qt, kt, vt, causal, window, terms=1)
        err1 = float(np.abs(_f32(one) - expect).max())
        assert err1 > 1e-4, (scale, err1)


@pytest.mark.parametrize("bad,match", [
    (dict(d=36), "multiple of 8"),
    (dict(d=136), "at most 128"),
    (dict(kv=3), "multiple of KV"),
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(noncontig=True), "contiguous"),
    (dict(window=0), "window"),
])
def test_flash_attention_rejects_what_the_kernel_does_not_take(bad, match):
    d, kv = bad.get("d", 32), bad.get("kv", 2)
    dtype = bad.get("dtype", torch.float32)
    q = torch.zeros(1, 8, 4, d, dtype=dtype)
    k = torch.zeros(1, 8, kv, d, dtype=dtype)
    v = torch.zeros(1, 8, kv, d, dtype=dtype)
    if bad.get("noncontig"):
        q = torch.zeros(1, 4, 8, d).transpose(1, 2)
    with pytest.raises((ValueError, TypeError), match=match):
        kops.flash_attention(q, k, v, causal=True, window=bad.get("window"))


def _pos_pair(a: np.ndarray):
    return jnp.asarray(a, jnp.int32), torch.from_numpy(a.astype(np.int32))


@pytest.mark.parametrize("kind,window", [("causal", None), ("causal", 3),
                                         ("bidirectional", None), ("prefix", None)])
def test_build_mask_matches_jax(kind, window):
    qp = np.array([[5, 6, 7]], np.int32)
    kp = np.array([[-1, 0, 1, 2, 3, 4, 5, 6, -1, 7]], np.int32)  # -1: never-written slots
    (qj, qt), (kj, kt) = _pos_pair(qp), _pos_pair(kp)
    expect = np.asarray(jattn.build_mask(qj, kj, kind, window, prefix_len=2))
    got = tattn.build_mask(qt, kt, kind, window, prefix_len=2).numpy()
    np.testing.assert_array_equal(np.broadcast_to(got, expect.shape), expect)
    assert not got[..., 0].any() and not got[..., 8].any()


@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (4, 1)])
def test_dense_attention_matches_jax(h, kv):
    rs = np.random.default_rng(1)
    b, sq, skv, d = 2, 12, 12, 16
    qn = rs.standard_normal((b, sq, h, d), dtype=np.float32)
    kn = rs.standard_normal((b, skv, kv, d), dtype=np.float32)
    vn = rs.standard_normal((b, skv, kv, d), dtype=np.float32)
    pos = np.broadcast_to(np.arange(sq, dtype=np.int32), (b, sq)).copy()
    pj, pt = _pos_pair(pos)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, "float32") for a in (qn, kn, vn))
    expect = jattn.dense_attention(qj, kj, vj, jattn.build_mask(pj, pj, "causal", 5))
    got = tattn.dense_attention(qt, kt, vt, tattn.build_mask(pt, pt, "causal", 5))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=1e-5)
    # the chunked path computes the same function
    chunked = tattn.chunked_attention(qt, kt, vt, pt, pt, "causal", 5, chunk=5)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(expect), atol=1e-5)


def test_decode_attention_ring_buffer_matches_jax():
    """Ten decode steps into a 4-slot ring: cache contents and outputs."""
    jcfg = jax_smoke_config("h2o-danube-1.8b").replace(compute_dtype="float32",
                                                       sliding_window=4)
    tcfg = get_smoke_config("h2o-danube-1.8b").replace(compute_dtype="float32",
                                                       sliding_window=4)
    p = jattn.init_attention(jax.random.PRNGKey(3), jcfg.d_model, jcfg.n_heads,
                             jcfg.n_kv_heads, jcfg.head_dim)
    pt = params_from_numpy(jax.tree.map(np.asarray, p))
    b = 2
    jc = jattn.init_kv_cache(b, 4, jcfg.n_kv_heads, jcfg.head_dim, jnp.float32)
    tc = tattn.init_kv_cache(b, 4, tcfg.n_kv_heads, tcfg.head_dim, torch.float32)
    rs = np.random.default_rng(2)
    for t in range(10):
        xn = rs.standard_normal((b, 1, jcfg.d_model), dtype=np.float32)
        (xj, xt) = _pair(xn, "float32")
        oj, jc = jattn.decode_attention(p, xj, jc, jnp.int32(t), jcfg)
        ot, tc = tattn.decode_attention(pt, xt, tc, t, tcfg)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-5)
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), atol=1e-5)
