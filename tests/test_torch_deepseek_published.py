"""deepseek-v2-lite-16b as published, on the CPU at the benchmark's small sizes:
the port's prefill (``launch.steps.make_prefill``) against the plain fp32
reference of ``bench/references/deepseek-v2-lite-16b.py`` on the same seeded
weights, each of the four mechanisms the JAX package leaves out (the latent's
RMSNorm, YaRN, un-renormalised gates, dropless routing) shown to matter,
decoding through the latent cache after a prefill, YaRN against its closed
form, the rope without YaRN as it was, the JAX-twin view, the published
config.json's keys, and the MoE's spans and counters."""

import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [p for p in (str(ROOT),) if p not in sys.path]

from bench import data, harness  # noqa: E402
from jax_twin import TWIN, twin_config  # noqa: E402
from repro_torch import spans  # noqa: E402
from repro_torch.configs import REGISTRY, get_config  # noqa: E402
from repro_torch.configs.base import PUBLISHED, ModelConfig  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.attention import _mla_scale  # noqa: E402
from repro_torch.models.layers import apply_rope, rope_frequencies, yarn_of  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
SEED = 2**31 + 35
#: logits within this of the reference's largest, relative: fp32 on both sides,
#: the same math in another order (the port reads 1e-6 here)
TOL = 1e-4


def _file() -> dict:
    return json.loads((ROOT / "bench" / "configs" / f"{ARCH}.json").read_text())


def _small() -> tuple[dict, object, dict]:
    cfg = _file()
    parts = harness.model_parts(cfg)
    cfg.update(parts.SMALL)
    return cfg, parts, data.make_weights(cfg, SEED, "cpu", parts.weight_shapes(cfg))


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.fixture(scope="module")
def small():
    cfg, parts, w = _small()
    tok = data.tokens(cfg, "zipf", SEED, 0, 2, 40)
    return cfg, parts, w, tok, parts.forward(w, tok, cfg)


def test_published_prefill_matches_the_reference(small):
    cfg, _, w, tok, ref = small
    mc = harness.program_config(cfg, compute_dtype="float32")
    assert mc.param_dtype == "bfloat16" and mc.moe_capacity_factor is None
    got = steps.make_prefill(mc, device="cpu")(w, {"tokens": tok})
    assert got.shape == ref.shape and _rel(got, ref) < TOL


@pytest.mark.parametrize("left_out", [
    dict(mla_kv_norm=False), dict(yarn_factor=None), dict(moe_norm_topk_prob=True),
    dict(moe_capacity_factor=1.25)], ids=["kv_norm", "yarn", "gates", "dropless"])
def test_each_mechanism_left_out_fails(small, left_out):
    cfg, _, w, tok, ref = small
    mc = harness.program_config(cfg, compute_dtype="float32").replace(**left_out)
    if "moe_capacity_factor" in left_out:  # the first MoE router already overflows 1.25 here
        x = tf._embed(w["embed"], tok, mc)
        probs = torch.softmax(x.float() @ w["segments"][1]["moe"]["router"][0], dim=-1)
        idx = moe_lib.top_k_lowest_index_first(probs, mc.moe_top_k)[1]
        cap = int(tok.shape[1] * mc.moe_top_k / mc.moe_experts * 1.25)
        assert not moe_lib._slots(idx, mc.moe_experts, cap)[1].all()
    got = steps.make_prefill(mc, device="cpu")(w, {"tokens": tok})
    assert _rel(got, ref) > 100 * TOL


def _per_expert_loop(p, x, top_k):
    """Each expert on exactly the tokens that chose it, weighed by its gate."""
    xt = x.reshape(-1, x.shape[-1])
    gate, pick = torch.topk(torch.softmax(xt @ p["router"], -1), top_k, dim=-1)
    out = torch.zeros_like(xt)
    for e in range(p["wi"].shape[0]):
        tok, slot = torch.nonzero(pick == e, as_tuple=True)
        h = torch.nn.functional.silu(xt[tok] @ p["wg"][e]) * (xt[tok] @ p["wi"][e])
        out.index_add_(0, tok, (h @ p["wo"][e]) * gate[tok, slot, None])
    return out.view_as(x)


def test_dropless_equals_a_per_expert_loop_where_capacity_drops():
    g = torch.Generator().manual_seed(7)
    e, d, f, k = 8, 16, 8, 2
    p = {"router": torch.randn(d, e, generator=g), "wi": torch.randn(e, d, f, generator=g),
         "wg": torch.randn(e, d, f, generator=g), "wo": torch.randn(e, f, d, generator=g)}
    p["router"][:, :2] += 3.0  # skewed: most tokens choose experts 0 and 1
    x = torch.randn(2, 32, d, generator=g) + 1.0
    want = _per_expert_loop(p, x, k)
    n0 = moe_lib.LAUNCHES["grouped_mm"]
    got, aux = moe_lib.apply_moe(p, x, k, None, norm_topk_prob=False)
    assert moe_lib.LAUNCHES["grouped_mm"] == n0 + 3
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-4) and float(aux) > 0
    idx = moe_lib.top_k_lowest_index_first(torch.softmax(x @ p["router"], -1), k)[1]
    cap = int(32 * k / e * 1.25)
    assert not moe_lib._slots(idx, e, cap)[1].all()  # capacity dispatch drops here
    dropped, _ = moe_lib.apply_moe(p, x, k, 1.25, norm_topk_prob=False)
    assert not torch.allclose(dropped, want, rtol=1e-5, atol=1e-4)


def test_decode_through_the_latent_cache_after_a_prefill(small):
    cfg, parts, w, tok, _ = small
    mc = harness.program_config(cfg, compute_dtype="float32")
    prompt, gen = tok[:, :24], 8
    caches = tf.init_caches(mc, 2, 24 + gen, "cpu")
    logits = steps.make_prefill(mc, device="cpu")(w, {"tokens": prompt}, caches)
    decode = steps.make_decode_step(mc, device="cpu")
    seq, cur = prompt, logits[:, -1].argmax(-1, keepdim=True).int()
    for i in range(gen):
        seq = torch.cat([seq, cur], dim=1)
        step, caches = decode(w, caches, cur, 24 + i)
        assert _rel(step[:, 0], parts.forward(w, seq, cfg)[:, -1]) < TOL, i
        cur = step[:, 0].argmax(-1, keepdim=True).int()


def test_yarn_frequencies_and_scale_equal_the_closed_form():
    cfg = get_config(ARCH)
    got = rope_frequencies(64, cfg.rope_theta, yarn=yarn_of(cfg)).double().numpy()
    i = np.arange(32, dtype=np.float64)
    extra, inter = 10000.0 ** (-2 * i / 64), 10000.0 ** (-2 * i / 64) / 40
    # correction dims at 32 and 1 turns over 4096 positions: floor(10.47), ceil(22.50)
    lo, hi = 10, 23
    ramp = np.clip((i - lo) / (hi - lo), 0, 1)
    want = inter * ramp + extra * (1 - ramp)
    assert np.allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == 1.0 and got[-1] == pytest.approx(extra[-1] / 40, rel=1e-6)
    mscale = 0.1 * 0.707 * math.log(40) + 1
    assert _mla_scale(cfg) == pytest.approx(192 ** -0.5 * mscale ** 2, rel=1e-12)
    assert round(_mla_scale(cfg), 5) == 0.11472
    assert _mla_scale(twin_config(ARCH)) == 1 / math.sqrt(192)


def _rope_before(x, positions, theta=10000.0, rotary_dim=None):
    """``layers.apply_rope`` as it was before YaRN."""
    d = x.shape[-1]
    rd = rotary_dim or d
    exps = torch.arange(0, rd, 2, dtype=torch.float32, device=x.device) / rd
    ang = positions[..., :, None].float() * (1.0 / (theta ** exps))
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xr = x[..., :rd].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    rot = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    rot = rot.reshape(*x.shape[:-1], rd).to(x.dtype)
    return rot if rd == d else torch.cat([rot, x[..., rd:]], dim=-1)


@pytest.mark.parametrize("dtype,rd", [(torch.float32, None), (torch.bfloat16, None),
                                      (torch.float32, 40)])
def test_rope_without_yarn_is_bit_identical(dtype, rd):
    x = torch.randn(2, 300, 4, 80, generator=torch.Generator().manual_seed(3)).to(dtype)
    pos = torch.arange(300)[None].expand(2, 300)
    assert torch.equal(apply_rope(x, pos, 10000.0, rd), _rope_before(x, pos, 10000.0, rd))


def test_the_twin_view_differs_only_in_the_listed_fields():
    for arch in REGISTRY:
        port, twin = get_config(arch), twin_config(arch)
        differ = {f.name for f in dataclasses.fields(port)
                  if getattr(port, f.name) != getattr(twin, f.name)}
        assert differ == set(TWIN.get(arch, {})), arch


def test_the_published_keys_are_held_to_the_ports_fields():
    cfg = _file()
    assert set(PUBLISHED) <= set(cfg) and cfg["rope_scaling"]["type"] == "yarn"
    assert harness.program_config(cfg) == get_config(ARCH)
    assert [f.name for f in ModelConfig.__dataclass_fields__.values()
            if f._field_type is dataclasses._FIELD_INITVAR] == list(PUBLISHED)
    for key, wrong in (("num_experts_per_tok", 8), ("norm_topk_prob", True),
                       ("q_lora_rank", 1536), ("rope_scaling", dict(cfg["rope_scaling"],
                                                                    factor=4))):
        with pytest.raises(ValueError, match=key):
            harness.program_config(dict(cfg, **{key: wrong}))


def test_the_latent_norm_is_whole_on_every_rank():
    from repro_torch.sharding import policy as tpol
    cfg = get_config(ARCH)
    pol = tpol.make_policy(cfg, tpol.MeshShape(("data", "model"), (2, 2)))
    shapes = tf.param_shapes(cfg)
    assert shapes["segments"][1]["attn"]["kv_norm"]["w"].shape == (26, 512)
    assert pol.param_spec("segments/1/attn/kv_norm/w", (26, 512)) == (None, None)


def test_a_profiled_prefill_marks_the_moe_stages_and_keeps_the_loads(small):
    cfg, _, w, tok, _ = small
    mc = harness.program_config(cfg)
    prefill = steps.make_prefill(mc, device="cpu")
    moe_lib.EXPERT_LOADS.clear()
    prefill(w, {"tokens": tok})  # not profiled: nothing kept
    assert moe_lib.EXPERT_LOADS == []
    n0 = moe_lib.LAUNCHES["grouped_mm"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        prefill(w, {"tokens": tok})
    names = {e.name for e in prof.events()}
    for stage in ("route", "dispatch", "experts", "combine", "shared"):
        assert f"prefill/moe.{stage}" in names
    assert {"prefill/attention", "prefill/ffn", "prefill/embed", "prefill/unembed"} <= names
    moe_layers = mc.block_pattern.count("mla_moe")
    assert moe_lib.LAUNCHES["grouped_mm"] == n0 + 3 * moe_layers
    loads = moe_lib.EXPERT_LOADS
    assert len(loads) == moe_layers
    assert all(float(c.sum()) == tok.numel() * mc.moe_top_k for c in loads)
    moe_lib.EXPERT_LOADS.clear()
    assert not spans.live()


def test_the_dry_run_counts_a_grouped_product():
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import dryrun  # noqa: F401  (registers the formula)
    a = torch.randn(64, 32, requires_grad=True)
    w = torch.randn(4, 32, 16, requires_grad=True)
    offs = torch.tensor([10, 10, 40, 64], dtype=torch.int32)  # one group empty
    with FlopCounterMode(display=False) as fc:
        y = torch._grouped_mm(a, w, offs=offs)
        y.backward(torch.randn_like(y))
    assert fc.get_total_flops() == 3 * 2 * 64 * 32 * 16  # forward, both gradients
