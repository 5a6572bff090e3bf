"""whisper-tiny (the encdec kind) against ``repro.models.transformer`` on its
smoke config: sinusoidal positions, the encoder, the decoder's forward and
loss, decode over the self-attention and cross caches, and the serving
example's greedy tokens. JAX's params are carried over by
``bridge.params_from_numpy``; compute in fp32, within 2e-5 relative, with
``use_pallas`` off and on (JAX runs its Pallas kernel in interpret mode,
the port's wrapper its plain version)."""

import dataclasses
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.checkpoint import _flatten_with_paths as jax_flatten_with_paths  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.bridge import flatten_with_paths, params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

ARCH = "whisper-tiny"
TOL = 2e-5
EXAMPLE = pathlib.Path(__file__).resolve().parents[1] / "examples" / "torch_whisper_serve.py"


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


def _batch(cfg, b=2, s=9, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32),
            "frames": rng.standard_normal((b, cfg.enc_seq_len, cfg.d_model), dtype=np.float32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {"tokens": torch.from_numpy(batch["tokens"]).long(),
            "frames": torch.from_numpy(batch["frames"])}


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_config_converts_field_for_field():
    assert _fields(get_smoke_config(ARCH)) == _fields(jax_smoke_config(ARCH))
    assert _fields(get_config(ARCH)) == _fields(jax_get_config(ARCH))
    # the norm weights are not counted: 36,448,128 leaves in all
    assert get_config(ARCH).param_count() == jax_get_config(ARCH).param_count() == 36_431_232


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
    assert any(k.startswith("encoder/layers/attn") for k, _ in own)
    assert any(k.startswith("segments/0/xattn") for k, _ in own)


@pytest.mark.parametrize("offset", [0, 7])
def test_sinusoidal_positions_match_jax(offset):
    expect = jlayers.sinusoidal_positions(13, 48, offset)
    got = tlayers.sinusoidal_positions(13, 48, offset)
    assert got.dtype == torch.float32 and got.shape == (13, 48)
    assert float(np.abs(got.numpy() - np.asarray(expect)).max()) <= 1e-6


@pytest.mark.parametrize("use_pallas", [False, True])
def test_encoder_forward_matches_jax(use_pallas, monkeypatch):
    """With the kernel on, each encoder layer calls it once (bidirectional);
    on the CPU the wrapper takes its plain version."""
    jcfg, tcfg, params, tparams = _setup(use_pallas=use_pallas)
    batch = _batch(jcfg)
    expect = jtf.encoder_forward(params["encoder"], jnp.asarray(batch["frames"]), jcfg)
    calls = []
    flash = kops.flash_attention
    monkeypatch.setattr(kops, "flash_attention",
                        lambda *a, **kw: calls.append(kw) or flash(*a, **kw))
    got = ttf.encoder_forward(tparams["encoder"], torch.from_numpy(batch["frames"]), tcfg)
    assert got.shape == (2, jcfg.enc_seq_len, jcfg.d_model)
    assert calls == ([{"causal": False, "window": None}] * jcfg.enc_layers if use_pallas else [])
    assert _rel(got, expect) < TOL


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_logits_matches_jax(use_pallas, monkeypatch):
    """The decoder's attentions stay dense with the kernel on: only the
    encoder's layers reach it."""
    jcfg, tcfg, params, tparams = _setup(use_pallas=use_pallas)
    batch = _batch(jcfg)
    expect, _ = jtf.forward_logits(params, _jax(batch), jcfg)
    calls = []
    flash = kops.flash_attention
    monkeypatch.setattr(kops, "flash_attention",
                        lambda *a, **kw: calls.append(kw) or flash(*a, **kw))
    got, aux = ttf.forward_logits(tparams, _torch(batch), tcfg)
    assert got.shape == (2, 9, jcfg.vocab_size) and float(aux) == 0.0
    assert len(calls) == (jcfg.enc_layers if use_pallas else 0)
    assert _rel(got, expect) < TOL


@pytest.mark.parametrize("use_pallas", [False, True])
def test_loss_fn_matches_jax(use_pallas):
    jcfg, tcfg, params, tparams = _setup(use_pallas=use_pallas)
    batch = _batch(jcfg, seed=3)
    expect = jtf.loss_fn(params, _jax(batch), jcfg)
    got = ttf.loss_fn(tparams, _torch(batch), tcfg)
    assert abs(float(got) - float(expect)) <= TOL * abs(float(expect))


def _jax_cross_caches(params, jcfg, frames, b, max_len):
    """Decode caches with the cross K/V filled as examples/whisper_serve.py fills them."""
    enc_out = jtf.encoder_forward(params["encoder"], frames, jcfg)
    caches = jtf.init_caches(jcfg, b, max_len)
    seg = params["segments"][0]
    for i in range(jcfg.n_layers):
        p_i = jax.tree.map(lambda a: a[i], seg)
        k = jnp.einsum("bsd,dhk->bshk", enc_out, p_i["xattn"]["wk"].astype(enc_out.dtype))
        v = jnp.einsum("bsd,dhk->bshk", enc_out, p_i["xattn"]["wv"].astype(enc_out.dtype))
        caches[i]["cross_k"] = k.astype(caches[i]["cross_k"].dtype)
        caches[i]["cross_v"] = v.astype(caches[i]["cross_v"].dtype)
    return caches


def _port_example():
    spec = importlib.util.spec_from_file_location("torch_whisper_serve", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_caches_layout_and_shapes():
    _, tcfg, _, _ = _setup()
    caches = ttf.init_caches(tcfg, 3, 11)
    assert ttf.cache_layout(tcfg) == ["cross_dense"] * tcfg.n_layers
    c = caches[0]
    assert c["self"]["k"].shape == (3, 11, tcfg.n_kv_heads, tcfg.head_dim)
    assert c["cross_k"].shape == c["cross_v"].shape == (3, tcfg.enc_seq_len, tcfg.n_heads,
                                                        tcfg.head_dim)
    assert c["cross_k"].dtype == tcfg.cdtype


def test_decode_every_position_matches_jax_and_the_forward():
    jcfg, tcfg, params, tparams = _setup()
    b, s = 2, 10
    batch = _batch(jcfg, b, s, seed=1)
    full, _ = ttf.forward_logits(tparams, _torch(batch), tcfg)
    jc = _jax_cross_caches(params, jcfg, jnp.asarray(batch["frames"]), b, s)
    tc = ttf.init_caches(tcfg, b, s)
    ttf.fill_cross_caches(
        tparams, ttf.encoder_forward(tparams["encoder"], torch.from_numpy(batch["frames"]),
                                     tcfg), tc, tcfg)
    toks = batch["tokens"]
    for t in range(s):
        lj, jc = jtf.decode_step(params, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t), jcfg)
        lt, tc = ttf.decode_step(tparams, tc, torch.from_numpy(toks[:, t:t + 1]).long(), t, tcfg)
        assert _rel(lt, lj) < TOL, t
        assert _rel(lt[:, 0], full[:, t].numpy()) < 1e-4, t
    assert bool((tc[0]["self"]["pos"] == torch.arange(s)).all())  # written in place


def test_serving_example_gives_jax_greedy_tokens():
    """``examples/torch_whisper_serve.py --smoke --device cpu`` serves finite
    tokens; and its ``generate`` in fp32, on the port's params (seed 0)
    carried to JAX and the same numpy frames, gives the tokens of JAX's
    encoder, cross fill and greedy decode."""
    mod = _port_example()
    b, gen = 2, 12
    out = mod.main(["--smoke", "--device", "cpu", "--batch", str(b), "--gen", str(gen)])
    assert out["finite"] and out["generated_shape"] == [b, gen] and out["device"] == "cpu"
    assert out["ttft_s"] > 0 and out["tpot_s"] > 0 and out["encode_s"] > 0
    jcfg = jax_smoke_config(ARCH).replace(compute_dtype="float32")
    tcfg = get_smoke_config(ARCH).replace(compute_dtype="float32", use_pallas=True)
    tparams = ttf.init_params(torch.Generator().manual_seed(0), tcfg)
    frames = mod.frames_for(0, b, tcfg)
    run = mod.generate(tparams, torch.from_numpy(frames), tcfg, gen, torch.device("cpu"))
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tparams)
    caches = _jax_cross_caches(params, jcfg, jnp.asarray(frames), b, gen + 1)
    cur, toks = jnp.zeros((b, 1), jnp.int32), []
    for t in range(gen):
        logits, caches = jtf.decode_step(params, caches, cur, jnp.int32(t), jcfg)
        cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        toks.append(cur)
    assert np.asarray(jnp.concatenate(toks, axis=1)).tolist() == run["tokens"].tolist()
    assert bool(torch.isfinite(run["logits"]).all())


def test_serving_example_needs_the_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        _port_example().main(["--smoke", "--gen", "2"])
