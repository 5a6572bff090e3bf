"""paligemma-3b (the vlm kind) against ``repro.models.transformer`` on its
smoke config: the forward with stub image embeds in front of the scaled
token embeds under the prefix-LM mask, the loss that skips the image
positions, the text-only decode, and the serving launcher. JAX's params are
carried over by ``bridge.params_from_numpy``; compute in fp32, within 2e-5
relative."""

import dataclasses
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
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

ARCH = "paligemma-3b"
TOL = 2e-5


def _rel(got, expect) -> float:
    g = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    e = np.asarray(expect, np.float32)
    return float(np.abs(g - e).max() / (np.abs(e).max() + 1e-9))


@functools.cache
def _numpy_params():
    return jax.tree.map(np.asarray, jtf.init_params(jax.random.PRNGKey(0),
                                                    jax_smoke_config(ARCH)))


def _setup(**overrides):
    overrides = {"compute_dtype": "float32", **overrides}
    jcfg = jax_smoke_config(ARCH).replace(**overrides)
    tcfg = get_smoke_config(ARCH).replace(**overrides)
    tree = _numpy_params()
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), params_from_numpy(tree)


def _batch(cfg, b=2, s=11, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32),
            "image_embeds": rng.standard_normal((b, cfg.num_image_tokens, cfg.d_model),
                                                dtype=np.float32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {"tokens": torch.from_numpy(batch["tokens"]).long(),
            "image_embeds": torch.from_numpy(batch["image_embeds"])}


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_config_converts_field_for_field():
    assert _fields(get_smoke_config(ARCH)) == _fields(jax_smoke_config(ARCH))
    assert _fields(get_config(ARCH)) == _fields(jax_get_config(ARCH))
    # the norm weights are not counted: 2,508,662,784 leaves in all
    assert get_config(ARCH).param_count() == jax_get_config(ARCH).param_count() \
        == 2_508_587_008


def test_params_round_trip_every_path_and_shape():
    _, tcfg, params, tparams = _setup()
    jflat = [(k, np.asarray(v)) for k, v in jax_flatten_with_paths(params)]
    tflat = flatten_with_paths(tparams)
    assert [k for k, _ in jflat] == [k for k, _ in tflat]
    for (k, a), (_, t) in zip(jflat, tflat):
        np.testing.assert_array_equal(t.numpy(), a)
    own = flatten_with_paths(ttf.init_params(torch.Generator().manual_seed(0), tcfg))
    assert [(k, tuple(t.shape), t.dtype) for k, t in own] == \
           [(k, tuple(t.shape), t.dtype) for k, t in tflat]


def test_forward_logits_matches_jax():
    jcfg, tcfg, params, tparams = _setup()
    batch = _batch(jcfg)
    expect, _ = jtf.forward_logits(params, _jax(batch), jcfg)
    got, aux = ttf.forward_logits(tparams, _torch(batch), tcfg)
    assert got.shape == (2, jcfg.num_image_tokens + 11, jcfg.vocab_size) and float(aux) == 0.0
    assert _rel(got, expect) < TOL


def test_prefix_mask_is_bidirectional_over_the_image_only():
    """Changing the last image embed moves the first image position's logits
    (bidirectional prefix); changing the last text token moves no earlier
    position (causal text). In both packages alike."""
    jcfg, tcfg, params, tparams = _setup()
    batch = _batch(jcfg, b=1, seed=5)
    base, _ = ttf.forward_logits(tparams, _torch(batch), tcfg)
    img = dict(batch, image_embeds=batch["image_embeds"].copy())
    img["image_embeds"][:, -1] += 1.0
    txt = dict(batch, tokens=batch["tokens"].copy())
    txt["tokens"][:, -1] = (txt["tokens"][:, -1] + 1) % jcfg.vocab_size
    for alt in (img, txt):
        got, _ = ttf.forward_logits(tparams, _torch(alt), tcfg)
        expect, _ = jtf.forward_logits(params, _jax(alt), jcfg)
        assert _rel(got, expect) < TOL
        if alt is img:
            assert _rel(got[:, 0], base[:, 0].numpy()) > 1e-3
        else:
            assert torch.equal(got[:, :-1], base[:, :-1])


def test_loss_fn_skips_the_image_positions_as_jax():
    jcfg, tcfg, params, tparams = _setup()
    batch = _batch(jcfg, seed=3)
    expect = jtf.loss_fn(params, _jax(batch), jcfg)
    got = ttf.loss_fn(tparams, _torch(batch), tcfg)
    assert abs(float(got) - float(expect)) <= TOL * abs(float(expect))
    logits, _ = ttf.forward_logits(tparams, _torch(batch), tcfg)
    text = logits[:, jcfg.num_image_tokens:-1].reshape(-1, jcfg.vocab_size)
    ce = torch.nn.functional.cross_entropy(text, _torch(batch)["tokens"][:, 1:].reshape(-1))
    assert abs(float(got) - float(ce)) <= 1e-5 * float(ce)


def test_kernel_path_refuses_the_prefix_mask():
    """The JAX dispatch drops the prefix mask on its kernel path; the port raises."""
    _, tcfg, _, tparams = _setup(use_pallas=True)
    with pytest.raises(NotImplementedError, match="prefix mask"):
        ttf.forward_logits(tparams, _torch(_batch(tcfg)), tcfg)


def test_text_decode_matches_jax_and_the_text_forward():
    """Decode has no image prefix (as tests/test_models_smoke.py sets it up):
    each step against JAX's, and against the forward of the same model as a
    plain decoder with no image tokens."""
    jcfg, tcfg, params, tparams = _setup()
    b, s = 2, 10
    toks = _batch(jcfg, b, s, seed=1)["tokens"]
    text_cfg = tcfg.replace(kind="decoder", num_image_tokens=0)
    full, _ = ttf.forward_logits(tparams, {"tokens": torch.from_numpy(toks).long()}, text_cfg)
    jc, tc = jtf.init_caches(jcfg, b, max_len=s), ttf.init_caches(tcfg, b, max_len=s)
    for t in range(s):
        lj, jc = jtf.decode_step(params, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t), jcfg)
        lt, tc = ttf.decode_step(tparams, tc, torch.from_numpy(toks[:, t:t + 1]).long(), t, tcfg)
        assert _rel(lt, lj) < TOL, t
        assert _rel(lt[:, 0], full[:, t].numpy()) < 1e-4, t


def test_serving_launcher_runs_and_is_finite():
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "6", "--gen", "4"])
    assert out["finite"] and out["generated_shape"] == [2, 4] and out["device"] == "cpu"
    assert out["ttft_s"] > 0 and out["tpot_s"] > 0
