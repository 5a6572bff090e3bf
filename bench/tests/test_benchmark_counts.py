"""The yardstick's counts against hand arithmetic."""

import json

import pytest
from smallcells import ROOT

from bench import data, flops, harness


def cfg(name):
    return json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())


def test_bert_large_step_flops():
    b = cfg("bert-large")
    # 24 × (4·1024² + 2·1024·4096) + 1024·30522 (the tied head, once)
    assert flops.matmul_params(b) == 333_244_416
    matmul = 6 * 333_244_416 * 256 * 128  # 65.52 TFLOP
    attn = 3 * 4 * 64 * 16 * (128 * 129 // 2) * 256 * 24  # causal pairs: 0.62 TFLOP
    assert flops.train_step_flops(b, 256, 128) == matmul + attn
    assert round(flops.train_step_flops(b, 256, 128) / 1e12, 2) == 66.14
    assert flops.train_step_flops(b, 1024, 128) == 4 * flops.train_step_flops(b, 256, 128)


def test_danube_prefill_flops_and_flash_bound():
    d = cfg("h2o-danube-1.8b")
    pairs = 4096 * 4097 // 2 + (4608 - 4096) * 4096  # causal, window 4096
    assert flops.live_pairs(4608, 4608, True, 4096) == pairs
    launch = flops.flash_launch(d, 2, 4608, flops.peak("NVIDIA H100 80GB HBM3"))
    assert launch["flops"] == 4 * 80 * 2 * 32 * pairs  # 214.8 GFLOP
    assert round(launch["flops"] / 1e9, 1) == 214.8
    assert launch["bound_by"] == "operations"
    assert abs(launch["bound_s"] * 1e3 - 0.2172) < 1e-4  # chip_smoke.py's 0.217 ms
    assert round(flops.attention_flops(d, 2, 4608) / 1e12, 2) == 5.15
    assert round(flops.forward_flops(d, 2, 4608) / 1e12, 1) == 37.4


def test_an_unknown_card_has_no_peak():
    d = cfg("h2o-danube-1.8b")
    assert flops.peak("NVIDIA H100 PCIe") is None
    launch = flops.flash_launch(d, 2, 4608, flops.peak("NVIDIA H100 PCIe"))
    assert launch["bound_s"] is None and launch["flops"] > 0


@pytest.mark.parametrize("name", [c["name"] for c in harness.manifest()["configs"]])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_weights_have_the_ports_layout(name, param_dtype):
    from repro_torch.models.transformer import param_shapes
    from repro_torch.tree import leaves
    c = dict(cfg(name), param_dtype=param_dtype)
    got = [(tuple(s), dt) for s, _, dt in
           data.leaf_list(harness.model_parts(c).weight_shapes(c))]
    want = [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for t in leaves(param_shapes(harness.program_config(c)))]
    assert got == want


def test_draws_repeat_from_the_seed():
    c = cfg("bert-large")
    big = 2**31 + 12345
    a = data.tokens(c, "zipf", big, 3, 4, 16)
    assert (a == data.tokens(c, "zipf", big, 3, 4, 16)).all()
    assert not (a == data.tokens(c, "zipf", big, 4, 4, 16)).all()
    assert int(a.max()) < c["vocab_size"] and int(a.min()) >= 0
