"""The port's MoE and MLA block kinds against ``repro.models.transformer`` on
the smoke configs of deepseek-v2-lite-16b (``"mla_dense"`` then
``"mla_moe"``) and dbrx-132b (``"moe"``: standard attention, then MoE), with
the JAX params carried over by ``bridge.params_from_numpy`` and compute in
fp32: logits within 1e-4 relative, the MoE balance loss within 1e-5."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.checkpoint import _flatten_with_paths as jax_flatten_with_paths  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.bridge import flatten_with_paths, params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from jax_twin import assert_converts, twin_config  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

DEEPSEEK, DBRX = "deepseek-v2-lite-16b", "dbrx-132b"
ARCHS = [DEEPSEEK, DBRX]


def _rel(got, expect) -> float:
    g = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    e = np.asarray(expect, np.float32)
    return float(np.abs(g - e).max() / (np.abs(e).max() + 1e-9))


@functools.cache
def _jax_params(arch):
    """JAX's init, once per arch (its first call compiles for ~15 s)."""
    return jtf.init_params(jax.random.PRNGKey(0), jax_smoke_config(arch))


def _setup(arch, **overrides):
    """Configs with ``overrides`` (none changes a param's shape), JAX's params
    and a fresh port copy of them."""
    jcfg = jax_smoke_config(arch).replace(compute_dtype="float32", **overrides)
    tcfg = get_smoke_config(arch).replace(compute_dtype="float32", **overrides)
    params = _jax_params(arch)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params))
    return jcfg, tcfg, params, tparams


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s), dtype=np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_convert_field_for_field(arch):
    assert_converts(get_smoke_config(arch), jax_smoke_config(arch))
    assert_converts(twin_config(arch), jax_get_config(arch))
    assert get_config(arch).param_count() == jax_get_config(arch).param_count()
    assert get_config(DEEPSEEK).param_count() == 15_706_357_760


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_every_path_and_shape(arch):
    """JAX's tree crosses path for path; the port's own init makes a tree of
    the same paths, shapes and dtypes (the nested ``moe/shared`` included)."""
    _, tcfg, params, tparams = _setup(arch)
    jflat = [(k, np.asarray(v)) for k, v in jax_flatten_with_paths(params)]
    tflat = flatten_with_paths(tparams)
    assert [k for k, _ in jflat] == [k for k, _ in tflat]
    for (k, a), (_, t) in zip(jflat, tflat):
        np.testing.assert_array_equal(t.numpy(), a)
    own = flatten_with_paths(ttf.init_params(torch.Generator().manual_seed(0), tcfg))
    assert [(k, tuple(t.shape), t.dtype) for k, t in own] == \
           [(k, tuple(t.shape), t.dtype) for k, t in tflat]
    assert any("/moe/router" in k for k, _ in own)
    if arch == DEEPSEEK:
        assert any("/moe/shared/wo" in k for k, _ in own)
        assert any("/attn/w_uk" in k for k, _ in own)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_equals_init_numel_less_norms(arch):
    """``param_count()`` counts every leaf but the norm weights, exactly."""
    cfg = get_smoke_config(arch)
    flat = flatten_with_paths(ttf.init_params(torch.Generator().manual_seed(0), cfg))
    counted = sum(t.numel() for k, t in flat if "ln" not in k and "final_norm" not in k)
    norms = sum(t.numel() for k, t in flat if "ln" in k or "final_norm" in k)
    assert counted == cfg.param_count()
    assert norms == (2 * cfg.n_layers + 1) * cfg.d_model


@pytest.mark.parametrize("arch,use_pallas", [(DEEPSEEK, False), (DBRX, False), (DBRX, True)])
def test_forward_logits_and_aux_match_jax(arch, use_pallas):
    jcfg, tcfg, params, tparams = _setup(arch)
    toks = _tokens(2, 12, jcfg.vocab_size)
    expect, aux_j = jtf.forward_logits(params, {"tokens": jnp.asarray(toks)}, jcfg)
    n0 = kops.LAUNCHES["flash_attention"]
    got, aux_t = ttf.forward_logits(tparams, {"tokens": torch.from_numpy(toks).long()},
                                    tcfg.replace(use_pallas=use_pallas))
    assert kops.LAUNCHES["flash_attention"] == n0  # CPU: the plain version, no launch
    assert got.shape == (2, 12, jcfg.vocab_size)
    assert _rel(got, expect) < 1e-4
    assert float(aux_j) > 0
    assert abs(float(aux_t) - float(aux_j)) <= 1e-5 * float(aux_j)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_with_aux_matches_jax(arch):
    jcfg, tcfg, params, tparams = _setup(arch, aux_loss_weight=0.5)
    toks = _tokens(2, 12, jcfg.vocab_size, seed=3)
    expect = jtf.loss_fn(params, {"tokens": jnp.asarray(toks)}, jcfg)
    got = ttf.loss_fn(tparams, {"tokens": torch.from_numpy(toks).long()}, tcfg)
    _, aux = ttf.forward_logits(tparams, {"tokens": torch.from_numpy(toks).long()}, tcfg)
    assert float(aux) > 0.1  # the balance loss is in the sum at this weight
    assert abs(float(got) - float(expect)) <= 1e-5 * abs(float(expect))


def test_aux_survives_remat_and_reaches_the_router_gradient():
    """Under ``torch.utils.checkpoint`` the aux still sums over layers, and
    its gradient reaches every MoE layer's router."""
    _, tcfg, _, tparams = _setup(DEEPSEEK)
    toks = torch.from_numpy(_tokens(2, 12, tcfg.vocab_size, seed=4)).long()
    with torch.no_grad():
        _, aux_plain = ttf.forward_logits(tparams, {"tokens": toks}, tcfg.replace(remat=False))
    router = tparams["segments"][1]["moe"]["router"].requires_grad_()
    _, aux = ttf.forward_logits(tparams, {"tokens": toks}, tcfg.replace(remat=True))
    assert float(aux.detach()) == pytest.approx(float(aux_plain), rel=1e-6)
    (g,) = torch.autograd.grad(aux, router)
    assert g.shape == router.shape and bool((g.abs().sum(dim=(1, 2)) > 0).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch):
    jcfg, tcfg, params, tparams = _setup(arch)
    b, s = 2, 10
    toks = _tokens(b, s, jcfg.vocab_size, seed=1)
    jc = jtf.init_caches(jcfg, b, max_len=s)
    tc = ttf.init_caches(tcfg, b, max_len=s)
    for t in range(s):
        lj, jc = jtf.decode_step(params, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t), jcfg)
        lt, tc = ttf.decode_step(tparams, tc, torch.from_numpy(toks[:, t:t + 1]).long(), t, tcfg)
        assert _rel(lt, lj) < 1e-4, t
    if arch == DEEPSEEK:  # the latent cache holds what JAX's holds
        for cj, ct in zip(jc, tc):
            assert ct["pos"].tolist() == np.asarray(cj["pos"]).tolist()
            assert _rel(ct["c_kv"], cj["c_kv"]) < 1e-5 and _rel(ct["k_pe"], cj["k_pe"]) < 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_without_drops(arch):
    """The twin of tests/test_models_smoke.py::test_decode_matches_forward: with
    capacity to spare (no prefill drops) token-by-token decode gives the full
    forward's logits."""
    _, tcfg, _, tparams = _setup(arch, moe_capacity_factor=50.0)
    b, s = 2, 10
    toks = torch.from_numpy(_tokens(b, s, tcfg.vocab_size, seed=2)).long()
    full, _ = ttf.forward_logits(tparams, {"tokens": toks}, tcfg)
    caches = ttf.init_caches(tcfg, b, max_len=s)
    for t in range(s):
        lg, caches = ttf.decode_step(tparams, caches, toks[:, t:t + 1], t, tcfg)
        assert _rel(lg[:, 0], full[:, t].numpy()) < 1e-4, t


def test_mla_latent_cache_is_a_ring_of_max_len_slots():
    """Past ``max_len`` the latent cache wraps (slot = position % max_len), as
    JAX's does, step by step."""
    jcfg, tcfg, params, tparams = _setup(DEEPSEEK)
    b, s, max_len = 1, 9, 4
    toks = _tokens(b, s, jcfg.vocab_size, seed=6)
    jc = jtf.init_caches(jcfg, b, max_len=max_len)
    tc = ttf.init_caches(tcfg, b, max_len=max_len)
    for t in range(s):
        lj, jc = jtf.decode_step(params, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t), jcfg)
        lt, tc = ttf.decode_step(tparams, tc, torch.from_numpy(toks[:, t:t + 1]).long(), t, tcfg)
        assert _rel(lt, lj) < 1e-4, t
    assert tc[0]["pos"].tolist() == [[8, 5, 6, 7]]


@pytest.mark.parametrize("use_chunked", [False, True])
def test_mla_forward_dense_and_chunked_match_jax(use_chunked):
    jcfg, tcfg, params, tparams = _setup(DEEPSEEK, attn_chunk=8)
    p_j = jax.tree.map(lambda a: a[0], params["segments"][0]["attn"])
    p_t = {k: v[0] for k, v in tparams["segments"][0]["attn"].items()}
    x = np.random.default_rng(7).standard_normal((2, 20, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32)[None], (2, 20))
    expect = jattn.mla_forward(p_j, jnp.asarray(x), jnp.asarray(pos), jcfg,
                               use_chunked=use_chunked)
    got = tattn.mla_forward(p_t, torch.from_numpy(x), torch.from_numpy(pos.copy()), tcfg,
                            use_chunked=use_chunked)
    assert got.shape == (2, 20, jcfg.d_model)
    assert _rel(got, expect) < 1e-5


def test_int8_kv_cache_setting_leaves_mla_caches_in_compute_dtype():
    """MLA layers keep a compute-dtype latent cache whatever ``kv_cache_dtype``
    says, as JAX's ``init_caches`` does; standard attention layers (dbrx's)
    take the int8 (KIVI) cache."""
    cfg = get_smoke_config(DEEPSEEK).replace(kv_cache_dtype="int8")
    caches = ttf.init_caches(cfg, 2, 8)
    assert [c["c_kv"].dtype for c in caches] == [torch.bfloat16] * cfg.n_layers
    assert caches[0]["c_kv"].shape == (2, 8, cfg.mla_kv_lora_rank)
    assert caches[0]["k_pe"].shape == (2, 8, cfg.mla_qk_rope_dim)
    dbrx = ttf.init_caches(get_smoke_config(DBRX).replace(kv_cache_dtype="int8"), 2, 8)
    assert {c["k"].dtype for c in dbrx} == {torch.int8}
    assert {c["k_scale"].dtype for c in dbrx} == {torch.float32}


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_driver_runs_the_new_archs(arch):
    from repro_torch.launch.serve import main
    out = main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "5", "--gen", "3"])
    assert out["finite"] and out["generated_shape"] == [2, 3]
    assert out["ttft_s"] > 0 and out["tpot_s"] > 0
