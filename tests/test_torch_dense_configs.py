"""The dense trio against ``repro.models.transformer`` on their smoke configs:
phi3-medium-14b (5 heads, an odd count), codeqwen1.5-7b (QKV biases, set to
nonzero values, the same on both sides, since they are zero at init) and
glm4-9b (2 KV heads for 4 query heads; rotary on the first half of each
head's lanes). JAX's params are carried over by
``bridge.params_from_numpy``; compute in fp32: logits, loss and every
decode step within 2e-5 relative, with ``use_pallas`` off and on (JAX runs
its Pallas kernel in interpret mode, the port's wrapper its plain
version)."""

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
from repro_torch.models import transformer as ttf  # noqa: E402

PHI3, CODEQWEN, GLM4 = "phi3-medium-14b", "codeqwen1.5-7b", "glm4-9b"
ARCHS = [PHI3, CODEQWEN, GLM4]
# repro.configs.get_config(arch).param_count()
PARAM_COUNT = {PHI3: 14_659_092_480, CODEQWEN: 8_189_378_560, GLM4: 9_399_435_264}
TOL = 2e-5


def _rel(got, expect) -> float:
    g = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    e = np.asarray(expect, np.float32)
    return float(np.abs(g - e).max() / (np.abs(e).max() + 1e-9))


@functools.cache
def _numpy_params(arch):
    """JAX's init as numpy, with codeqwen's QKV biases moved off zero."""
    tree = jax.tree.map(np.asarray, jtf.init_params(jax.random.PRNGKey(0),
                                                    jax_smoke_config(arch)))
    rng = np.random.default_rng(7)
    for seg in tree["segments"]:
        for k in ("bq", "bk", "bv"):
            if k in seg["attn"]:
                seg["attn"][k] = (rng.standard_normal(seg["attn"][k].shape) * 0.5).astype(
                    np.float32)
    return tree


def _setup(arch, **overrides):
    overrides = {"compute_dtype": "float32", **overrides}
    jcfg = jax_smoke_config(arch).replace(**overrides)
    tcfg = get_smoke_config(arch).replace(**overrides)
    tree = _numpy_params(arch)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), params_from_numpy(tree)


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s), dtype=np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_convert_field_for_field(arch):
    assert_converts(get_smoke_config(arch), jax_smoke_config(arch))
    assert_converts(twin_config(arch), jax_get_config(arch))
    assert get_config(arch).param_count() == jax_get_config(arch).param_count() \
        == PARAM_COUNT[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_every_path_and_shape(arch):
    _, tcfg, params, tparams = _setup(arch)
    jflat = [(k, np.asarray(v)) for k, v in jax_flatten_with_paths(params)]
    tflat = flatten_with_paths(tparams)
    assert [k for k, _ in jflat] == [k for k, _ in tflat]
    for (k, a), (_, t) in zip(jflat, tflat):
        np.testing.assert_array_equal(t.numpy(), a)
    own = flatten_with_paths(ttf.init_params(torch.Generator().manual_seed(0), tcfg))
    assert [(k, tuple(t.shape), t.dtype) for k, t in own] == \
           [(k, tuple(t.shape), t.dtype) for k, t in tflat]
    assert any(k.endswith("attn/bq") for k, _ in own) == (arch == CODEQWEN)


@pytest.mark.parametrize("arch,use_pallas", [(a, p) for a in ARCHS for p in (False, True)])
def test_forward_logits_matches_jax(arch, use_pallas):
    jcfg, tcfg, params, tparams = _setup(arch, use_pallas=use_pallas)
    toks = _tokens(2, 19, jcfg.vocab_size)
    expect, _ = jtf.forward_logits(params, {"tokens": jnp.asarray(toks)}, jcfg)
    n0 = kops.LAUNCHES["flash_attention"]
    got, aux = ttf.forward_logits(tparams, {"tokens": torch.from_numpy(toks).long()}, tcfg)
    assert kops.LAUNCHES["flash_attention"] == n0  # CPU: the plain version, no launch
    assert got.shape == (2, 19, jcfg.vocab_size) and float(aux) == 0.0
    assert _rel(got, expect) < TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_jax(arch):
    jcfg, tcfg, params, tparams = _setup(arch)
    toks = _tokens(2, 12, jcfg.vocab_size, seed=3)
    expect = jtf.loss_fn(params, {"tokens": jnp.asarray(toks)}, jcfg)
    got = ttf.loss_fn(tparams, {"tokens": torch.from_numpy(toks).long()}, tcfg)
    assert abs(float(got) - float(expect)) <= TOL * abs(float(expect))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_every_position_matches_jax(arch):
    jcfg, tcfg, params, tparams = _setup(arch)
    b, s = 2, 10
    toks = _tokens(b, s, jcfg.vocab_size, seed=1)
    jc, tc = jtf.init_caches(jcfg, b, max_len=s), ttf.init_caches(tcfg, b, max_len=s)
    for t in range(s):
        lj, jc = jtf.decode_step(params, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t), jcfg)
        lt, tc = ttf.decode_step(tparams, tc, torch.from_numpy(toks[:, t:t + 1]).long(), t, tcfg)
        assert _rel(lt, lj) < TOL, t


@pytest.mark.parametrize("arch,field", [(CODEQWEN, "qkv_bias"), (GLM4, "partial_rotary")])
def test_the_field_changes_the_logits(arch, field):
    """The comparisons above can see each field: codeqwen without its biases,
    or glm4 rotating every lane, gives other logits (in both packages)."""
    jcfg, tcfg, params, tparams = _setup(arch)
    toks = _tokens(1, 12, jcfg.vocab_size, seed=2)
    base, _ = ttf.forward_logits(tparams, {"tokens": torch.from_numpy(toks).long()}, tcfg)
    if field == "qkv_bias":
        strip = lambda tree: {**tree, "segments": [  # noqa: E731
            {**seg, "attn": {k: v for k, v in seg["attn"].items() if k not in ("bq", "bk", "bv")}}
            for seg in tree["segments"]]}
        jalt, talt, jcfg2, tcfg2 = strip(params), strip(tparams), jcfg, tcfg
    else:
        jalt, talt = params, tparams
        jcfg2, tcfg2 = jcfg.replace(partial_rotary_factor=1.0), \
            tcfg.replace(partial_rotary_factor=1.0)
    alt, _ = ttf.forward_logits(talt, {"tokens": torch.from_numpy(toks).long()}, tcfg2)
    jexp, _ = jtf.forward_logits(jalt, {"tokens": jnp.asarray(toks)}, jcfg2)
    assert _rel(alt, jexp) < TOL
    assert _rel(alt, base.numpy()) > 1e-3
