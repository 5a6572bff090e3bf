"""The port's MoE layer against ``repro.models.moe`` on the CPU: the same
params (JAX's init carried over by ``bridge.params_from_numpy``) and the same
inputs (from a numpy seed). A token routed or dropped differently moves its
output row by O(1), so output agreement within 1e-5 relative in fp32 shows
that both layers route, rank and drop the same assignments."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import moe as jmoe  # noqa: E402
from repro_torch.bridge import flatten_with_paths, params_from_numpy  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

D, D_FF, E = 32, 24, 8


def _rel(got, expect) -> float:
    g = got.float().numpy()
    e = np.asarray(expect, np.float32)
    return float(np.abs(g - e).max() / (np.abs(e).max() + 1e-12))


def _params(n_shared: int, tie: bool):
    p = jmoe.init_moe(jax.random.PRNGKey(3), D, D_FF, E, n_shared,
                      n_shared * D_FF or None)
    p = jax.tree.map(np.asarray, p)
    if tie:  # experts 0 and 1 score alike; expert 2 scores highest on lane 0
        r = np.array(p["router"])
        r[0, :] = 0.0
        r[0, 2] = 1.0
        r[0, 0] = r[0, 1] = 0.5
        r[:, 1] = r[:, 0]
        p["router"] = r
    return p


def _inputs(b: int, s: int, seed: int, repeat: bool, tie: bool) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal((b, s, D)).astype(np.float32)
    if repeat:  # every token of a group is token 0: all pick the same experts
        x[:, 1:] = x[:, :1]
    if tie:  # a large constant lane 0 puts expert 2 first and 0/1 tied second
        x[..., 0] = 8.0
    return x


# (b, s, top_k, n_shared, capacity_factor, repeat, tie)
CASES = {
    "shared": (2, 16, 2, 2, 1.25, False, False),
    "no_shared": (2, 16, 2, 0, 1.25, False, False),
    "top3_small_cf": (3, 20, 3, 0, 1.0, False, False),
    "overflow_repeated_tokens": (2, 16, 2, 2, 0.5, True, False),
    "tie_at_kth_place": (2, 16, 2, 0, 1.25, False, True),
    "tie_with_overflow": (2, 16, 2, 2, 0.5, False, True),
    "no_drop": (2, 16, 2, 2, 50.0, False, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_apply_moe_matches_jax_fp32(case):
    b, s, k, n_shared, cf, repeat, tie = CASES[case]
    p = _params(n_shared, tie)
    x = _inputs(b, s, seed=len(case), repeat=repeat, tie=tie)
    y_j, aux_j = jmoe.apply_moe(jax.tree.map(jnp.asarray, p), jnp.asarray(x), k, cf)
    tp = params_from_numpy(p)
    if tie:  # the precondition: experts 0 and 1 tie exactly at the k-th place
        probs = torch.softmax(torch.from_numpy(x) @ tp["router"], dim=-1)
        assert torch.equal(probs[..., 0], probs[..., 1])
        assert bool((probs[..., 2] > probs[..., 0]).all())
    y_t, aux_t = tmoe.apply_moe(tp, torch.from_numpy(x), k, cf)
    assert y_t.shape == (b, s, D) and y_t.dtype == torch.float32
    assert _rel(y_t, y_j) < 1e-5
    assert abs(float(aux_t) - float(aux_j)) <= 1e-5 * abs(float(aux_j))


def test_overflow_case_drops_assignments():
    """The overflow case really overflows: with every token alike, each
    group's k experts take ``cap`` tokens and the rest are dropped, so those
    tokens get the shared experts' output alone."""
    b, s, k, n_shared, cf, repeat, tie = CASES["overflow_repeated_tokens"]
    p = params_from_numpy(_params(n_shared, tie))
    x = torch.from_numpy(_inputs(b, s, seed=1, repeat=repeat, tie=tie))
    cap = max(1, int(s * k / E * cf))
    y, _ = tmoe.apply_moe(p, x, k, cf)
    no_experts = {"shared": p["shared"], "router": p["router"],
                  **{n: torch.zeros_like(p[n]) for n in ("wi", "wg", "wo")}}
    y_shared, _ = tmoe.apply_moe(no_experts, x, k, cf)
    assert cap < s
    torch.testing.assert_close(y[:, cap:], y_shared[:, cap:], rtol=0, atol=0)
    assert not torch.allclose(y[:, :cap], y_shared[:, :cap])


def test_apply_moe_matches_jax_bf16():
    b, s, k, n_shared, cf, repeat, tie = CASES["shared"]
    p = _params(n_shared, tie)
    p_bf = {**p, **{n: p[n].astype(jnp.bfloat16) for n in ("wi", "wg", "wo")},
            "shared": {n: v.astype(jnp.bfloat16) for n, v in p["shared"].items()}}
    p_bf = jax.tree.map(np.asarray, p_bf)
    x = _inputs(b, s, seed=5, repeat=repeat, tie=tie)
    y_j, aux_j = jmoe.apply_moe(jax.tree.map(jnp.asarray, p_bf),
                                jnp.asarray(x, jnp.bfloat16), k, cf)
    tp = params_from_numpy(p_bf)
    assert tp["wi"].dtype == torch.bfloat16 and tp["router"].dtype == torch.float32
    y_t, aux_t = tmoe.apply_moe(tp, torch.from_numpy(x).to(torch.bfloat16), k, cf)
    assert y_t.dtype == torch.bfloat16
    assert _rel(y_t, np.asarray(y_j, np.float32)) < 2e-2
    assert abs(float(aux_t) - float(aux_j)) <= 1e-5 * abs(float(aux_j))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_top_k_breaks_ties_by_lowest_index_as_jax(seed):
    # few distinct values, so most rows hold ties at and around the k-th place
    probs = np.random.default_rng(seed).integers(0, 4, (64, 12)).astype(np.float32)
    vals_j, idx_j = jax.lax.top_k(jnp.asarray(probs), 5)
    vals_t, idx_t = tmoe.top_k_lowest_index_first(torch.from_numpy(probs), 5)
    np.testing.assert_array_equal(vals_t.numpy(), np.asarray(vals_j))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))


@pytest.mark.parametrize("n_shared", [0, 2])
def test_init_moe_tree_matches_jax(n_shared):
    """Same paths, shapes and dtypes as JAX's tree, the router in fp32 whatever
    the param dtype, a leading layer axis from ``lead``, and JAX's scales."""
    jp = jmoe.init_moe(jax.random.PRNGKey(0), D, D_FF, E, n_shared,
                       n_shared * D_FF or None, jnp.bfloat16)
    tp = tmoe.init_moe(torch.Generator().manual_seed(0), D, D_FF, E, n_shared,
                       n_shared * D_FF or None, torch.bfloat16, lead=(3,))
    jflat = flatten_with_paths(params_from_numpy(jax.tree.map(np.asarray, jp)))
    tflat = flatten_with_paths(tp)
    assert [k for k, _ in tflat] == [k for k, _ in jflat]
    for (k, j), (_, t) in zip(jflat, tflat):
        assert tuple(t.shape) == (3, *j.shape) and t.dtype == j.dtype, k
    assert tp["router"].dtype == torch.float32
    if n_shared:
        assert tp["shared"]["wi"].shape == (3, D, n_shared * D_FF)
    # truncated normal (±2σ) has std 0.8796σ; σ = scale / sqrt(shape[0])
    for name, sigma in (("router", 0.1 / D ** 0.5), ("wi", 1 / E ** 0.5),
                        ("wo", 1 / E ** 0.5)):
        std = float(tp[name].float().std())
        assert abs(std / (0.8796 * sigma) - 1) < 0.1, name
