"""The port's SSM and hybrid models against ``repro.models.transformer`` on the
smoke configs of xlstm-125m (``"mlstm"`` and ``"slstm"`` blocks) and
zamba2-1.2b (``"mamba2"`` blocks with the weight-shared dense block before
layers 2 and 4), with the JAX params carried over by
``bridge.params_from_numpy``: fp32 logits, loss and every decode step within
2e-5 relative; bf16 logits as close to the fp32 model as JAX's. With ``use_pallas`` JAX runs its
Pallas kernel in interpret mode and the port's wrapper its plain version."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.checkpoint import _flatten_with_paths as jax_flatten_with_paths  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.bridge import flatten_with_paths, params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from jax_twin import assert_converts, twin_config  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

XLSTM, ZAMBA2 = "xlstm-125m", "zamba2-1.2b"
ARCHS = [XLSTM, ZAMBA2]
# repro.configs.get_config(arch).param_count()
PARAM_COUNT = {XLSTM: 154_423_296, ZAMBA2: 1_112_919_040}
TOL = 2e-5


def _rel(got, expect) -> float:
    g = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    e = np.asarray(expect, np.float32)
    return float(np.abs(g - e).max() / (np.abs(e).max() + 1e-9))


@functools.cache
def _jax_params(arch):
    return jtf.init_params(jax.random.PRNGKey(0), jax_smoke_config(arch))


def _setup(arch, **overrides):
    overrides = {"compute_dtype": "float32", **overrides}
    jcfg = jax_smoke_config(arch).replace(**overrides)
    tcfg = get_smoke_config(arch).replace(**overrides)
    params = _jax_params(arch)
    return jcfg, tcfg, params, params_from_numpy(jax.tree.map(np.asarray, params))


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s), dtype=np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_convert_field_for_field(arch):
    assert_converts(get_smoke_config(arch), jax_smoke_config(arch))
    assert_converts(twin_config(arch), jax_get_config(arch))
    assert get_config(arch).param_count() == jax_get_config(arch).param_count() \
        == PARAM_COUNT[arch]
    assert get_smoke_config(arch).param_count() == jax_smoke_config(arch).param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_every_path_and_shape(arch):
    """JAX's tree crosses path for path (the SSM leaves, and zamba2's
    unstacked ``shared_block`` beside the stacked segments); the port's own
    init makes a tree of the same paths, shapes and dtypes."""
    _, tcfg, params, tparams = _setup(arch)
    jflat = [(k, np.asarray(v)) for k, v in jax_flatten_with_paths(params)]
    tflat = flatten_with_paths(tparams)
    assert [k for k, _ in jflat] == [k for k, _ in tflat]
    for (k, a), (_, t) in zip(jflat, tflat):
        np.testing.assert_array_equal(t.numpy(), a)
    own = flatten_with_paths(ttf.init_params(torch.Generator().manual_seed(0), tcfg))
    assert [(k, tuple(t.shape), t.dtype) for k, t in own] == \
           [(k, tuple(t.shape), t.dtype) for k, t in tflat]
    paths = dict(own)
    if arch == ZAMBA2:
        for leaf in ("A_log", "D", "dt_bias", "conv_w", "w_in", "w_out"):
            assert f"segments/0/mix/{leaf}" in paths
        d = tcfg.d_model
        assert paths["shared_block/ln1/w"].shape == (d,)  # no layer axis
        assert paths["shared_block/attn/wq"].shape == (d, tcfg.n_heads, tcfg.head_dim)
        assert paths["shared_proj"].shape == (2 * d, d)
    else:
        for leaf in ("w_if", "if_bias", "wq", "conv_w"):
            assert f"segments/0/mix/{leaf}" in paths
        assert "segments/1/mix/w_h" in paths and "segments/1/mix/w_x" in paths


@pytest.mark.parametrize("arch,use_pallas", [(a, p) for a in ARCHS for p in (False, True)])
def test_forward_logits_matches_jax(arch, use_pallas, monkeypatch):
    """On the CPU the wrapper takes its plain version and counts no launch;
    zamba2's two shared call sites each reach it."""
    jcfg, tcfg, params, tparams = _setup(arch, use_pallas=use_pallas)
    toks = _tokens(2, 13, jcfg.vocab_size)  # 13: no multiple of zamba2's chunk of 8
    expect, _ = jtf.forward_logits(params, {"tokens": jnp.asarray(toks)}, jcfg)
    calls = []
    plain_or_kernel = kops.flash_attention
    monkeypatch.setattr(kops, "flash_attention",
                        lambda *a, **k: calls.append(1) or plain_or_kernel(*a, **k))
    n0 = kops.LAUNCHES["flash_attention"]
    got, aux = ttf.forward_logits(tparams, {"tokens": torch.from_numpy(toks).long()}, tcfg)
    assert kops.LAUNCHES["flash_attention"] == n0
    assert len(calls) == (2 if use_pallas and arch == ZAMBA2 else 0)
    assert got.shape == (2, 13, jcfg.vocab_size) and float(aux) == 0.0
    assert _rel(got, expect) < TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_as_close_to_fp32_as_jax(arch):
    """In bf16 each SSM function is within 2e-2 of JAX's (tests/test_torch_ssm.py),
    but over a whole model both packages drift from the fp32 model by 2.5–5 %
    (their roundings differ op by op, and the recurrences carry them on): the
    port's bf16 model must be as close to the fp32 model as JAX's bf16 model
    is, within 2×. A block run in bf16 where JAX runs it in fp32 fails this."""
    jcfg, tcfg, params, tparams = _setup(arch, compute_dtype="bfloat16")
    toks = _tokens(2, 13, jcfg.vocab_size, seed=5)
    fp32, _ = jtf.forward_logits(params, {"tokens": jnp.asarray(toks)},
                                 jcfg.replace(compute_dtype="float32"))
    jax_bf16, _ = jtf.forward_logits(params, {"tokens": jnp.asarray(toks)}, jcfg)
    got, _ = ttf.forward_logits(tparams, {"tokens": torch.from_numpy(toks).long()}, tcfg)
    assert got.dtype == torch.bfloat16
    assert 0 < _rel(got, fp32) <= 2 * _rel(jax_bf16, fp32)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_jax(arch):
    jcfg, tcfg, params, tparams = _setup(arch)
    toks = _tokens(2, 12, jcfg.vocab_size, seed=3)
    expect = jtf.loss_fn(params, {"tokens": jnp.asarray(toks)}, jcfg)
    got = ttf.loss_fn(tparams, {"tokens": torch.from_numpy(toks).long()}, tcfg)
    assert abs(float(got) - float(expect)) <= TOL * abs(float(expect))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_layout_and_caches_match_jax(arch):
    """The ``"shared"`` tags sit before the layer they precede; every cache
    leaf has JAX's path, shape and dtype (a shared site keeps ``max_len``
    slots, an SSM state is fp32 with its conv history in the compute dtype)."""
    jcfg, tcfg, _, _ = _setup(arch, compute_dtype="bfloat16")
    layout = ttf.cache_layout(tcfg)
    assert layout == jtf.cache_layout(jcfg)
    if arch == ZAMBA2:
        assert layout == ["mamba2", "mamba2", "shared", "mamba2", "mamba2", "shared", "mamba2"]
    jc = jax_flatten_with_paths(jtf.init_caches(jcfg, 2, 9))
    tc = flatten_with_paths(ttf.init_caches(tcfg, 2, 9))
    assert [(k, tuple(t.shape), str(t.dtype).removeprefix("torch.")) for k, t in tc] == \
           [(k, tuple(a.shape), str(a.dtype)) for k, a in jc]
    for (k, a), (_, t) in zip(jc, tc):
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(a, np.float32), err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_every_position_matches_jax(arch):
    """JAX's ``decode_step`` and the port's, step by step from empty caches
    (zamba2's shared sites through their KV caches); and the port's steps
    against its own full forward."""
    jcfg, tcfg, params, tparams = _setup(arch)
    b, s = 2, 11
    toks = _tokens(b, s, jcfg.vocab_size, seed=1)
    full, _ = ttf.forward_logits(tparams, {"tokens": torch.from_numpy(toks).long()}, tcfg)
    jc, tc = jtf.init_caches(jcfg, b, max_len=s), ttf.init_caches(tcfg, b, max_len=s)
    for t in range(s):
        lj, jc = jtf.decode_step(params, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t), jcfg)
        lt, tc = ttf.decode_step(tparams, tc, torch.from_numpy(toks[:, t:t + 1]).long(), t, tcfg)
        assert _rel(lt, lj) < TOL, t
        assert _rel(lt[:, 0], full[:, t].numpy()) < 1e-4, t
    for (k, a), (_, v) in zip(jax_flatten_with_paths(jc), flatten_with_paths(tc)):
        assert _rel(v, a) < TOL, k


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_smoke(arch):
    out = serve_main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "5", "--gen", "3"])
    assert out["finite"] and out["generated_shape"] == [2, 3] and out["device"] == "cpu"
