"""The port's dense decoder against ``repro.models.transformer`` on the danube
smoke config, with the JAX params carried over by ``bridge.params_from_numpy``
and compute in fp32: relative max error ≤ 1e-4, as tests/test_kernels.py's
model-path check asks of the Pallas path."""


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
from jax_twin import assert_converts  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

ARCH = "h2o-danube-1.8b"


def _rel(got, expect) -> float:
    g = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    e = np.asarray(expect, np.float32)
    return float(np.abs(g - e).max() / (np.abs(e).max() + 1e-9))


def _setup(**overrides):
    jcfg = jax_smoke_config(ARCH).replace(compute_dtype="float32", **overrides)
    tcfg = get_smoke_config(ARCH).replace(compute_dtype="float32", **overrides)
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params))
    return jcfg, tcfg, params, tparams


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s), dtype=np.int32)


def test_config_converts_field_for_field():
    jcfg, tcfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    assert_converts(tcfg, jcfg)
    assert tcfg.pdtype == torch.float32 and tcfg.cdtype == torch.bfloat16
    assert get_config(ARCH).param_count() == jax_get_config(ARCH).param_count()
    with pytest.raises(KeyError, match="unknown arch 'nope'"):
        get_config("nope")


def test_params_round_trip_every_path_and_shape():
    jcfg, tcfg, params, tparams = _setup()
    jflat = [(k, np.asarray(v)) for k, v in jax_flatten_with_paths(params)]
    tflat = flatten_with_paths(tparams)
    assert [k for k, _ in jflat] == [k for k, _ in tflat]
    for (k, a), (_, t) in zip(jflat, tflat):
        assert tuple(t.shape) == a.shape, k
        np.testing.assert_array_equal(t.numpy(), a)
    # the port's own init makes the same tree: paths, shapes, dtypes
    own = flatten_with_paths(ttf.init_params(torch.Generator().manual_seed(0), tcfg))
    assert [(k, tuple(t.shape), t.dtype) for k, t in own] == \
           [(k, tuple(t.shape), t.dtype) for k, t in tflat]
    n = sum(t.numel() for _, t in own)
    assert abs(n - tcfg.param_count()) / n < 0.02


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_logits_matches_jax(use_pallas):
    jcfg, tcfg, params, tparams = _setup()
    toks = _tokens(2, 32, jcfg.vocab_size)
    expect, _ = jtf.forward_logits(params, {"tokens": jnp.asarray(toks)}, jcfg)
    n0 = kops.LAUNCHES["flash_attention"]
    got, aux = ttf.forward_logits(tparams, {"tokens": torch.from_numpy(toks).long()},
                                  tcfg.replace(use_pallas=use_pallas))
    assert kops.LAUNCHES["flash_attention"] == n0  # CPU: the plain version, no launch
    assert got.shape == (2, 32, jcfg.vocab_size) and float(aux) == 0.0
    assert _rel(got, expect) < 1e-4


def test_decode_step_matches_jax():
    jcfg, tcfg, params, tparams = _setup()
    b, s = 2, 14
    toks = _tokens(b, s, jcfg.vocab_size, seed=1)
    jc = jtf.init_caches(jcfg, b, max_len=s)
    tc = ttf.init_caches(tcfg, b, max_len=s)
    for t in range(s):
        lj, jc = jtf.decode_step(params, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t), jcfg)
        lt, tc = ttf.decode_step(tparams, tc, torch.from_numpy(toks[:, t:t + 1]).long(), t, tcfg)
        assert _rel(lt, lj) < 1e-4, t


def test_sliding_window_ring_buffer():
    """Decode past a 6-slot window equals the window-limited full forward,
    and the JAX ring buffer, step by step."""
    jcfg, tcfg, params, tparams = _setup(sliding_window=6)
    b, s = 1, 14  # > 2x window
    toks = _tokens(b, s, jcfg.vocab_size, seed=2)
    full, _ = ttf.forward_logits(tparams, {"tokens": torch.from_numpy(toks).long()}, tcfg)
    jc = jtf.init_caches(jcfg, b, max_len=jcfg.sliding_window)
    tc = ttf.init_caches(tcfg, b, max_len=tcfg.sliding_window)
    assert tc[0]["k"].shape[1] == 6
    for t in range(s):
        lj, jc = jtf.decode_step(params, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t), jcfg)
        lt, tc = ttf.decode_step(tparams, tc, torch.from_numpy(toks[:, t:t + 1]).long(), t, tcfg)
        assert _rel(lt[:, 0], full[:, t].numpy()) < 1e-4, t
        assert _rel(lt, lj) < 1e-4, t


def test_unported_block_kinds_raise():
    """Every block kind and model kind is ported: the encdec and vlm kinds
    (whisper, paligemma) initialise with their own trees; an unknown block
    or model kind is refused."""
    cfg = get_smoke_config(ARCH)
    whisper = ttf.init_params(torch.Generator().manual_seed(0), get_smoke_config("whisper-tiny"))
    assert set(whisper) == {"embed", "segments", "final_norm", "encoder"}
    assert "xattn" in whisper["segments"][0]
    vlm = ttf.init_params(torch.Generator().manual_seed(0), cfg.replace(kind="vlm"))
    assert [k for k, _ in flatten_with_paths(vlm)] == \
           [k for k, _ in flatten_with_paths(ttf.init_params(torch.Generator(), cfg))]
    with pytest.raises(ValueError, match="unknown model kind 'conv'"):
        ttf.init_params(torch.Generator().manual_seed(0), cfg.replace(kind="conv"))
    with pytest.raises(ValueError, match="unknown block kind 'conv'"):
        ttf.init_params(torch.Generator().manual_seed(0),
                        cfg.replace(block_pattern=("dense", "conv")))
