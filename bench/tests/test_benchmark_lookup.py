"""A configuration's model parts found by name (``bench/references/<config>.py``),
the weights drawn in each leaf's stored dtype, JSON lists as ``ModelConfig``'s
tuples, and the program's prefill spans kept out of the device's operations."""

import dataclasses
import json
import math
import types

import pytest
import torch
from smallcells import small_config, small_run, small_sizes

from bench import data, harness, reference, trace

DENSE = ["bert-large", "h2o-danube-1.8b"]


def frozen_make_weights(spec: dict, seed: int, device) -> dict:
    """``bench.data.make_weights`` as it was before layouts carried a dtype:
    one fp32 draw for every leaf, each leaf a view of it scaled in place."""
    flat = list(data._walk(spec))
    total = sum(math.prod(shape) for _, (shape, _) in flat)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & data.SEED_MASK)
    buf = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out = data._copy_structure(spec)
    at = 0
    for path, (shape, init) in flat:
        n = math.prod(shape)
        leaf = buf[at:at + n].view(shape)
        at += n
        if init == "embed":
            leaf.mul_(0.02)
        elif init.startswith("fan_in:"):
            leaf.mul_(1.0 / math.sqrt(int(init.split(":")[1])))
        elif init == "norm_w":
            leaf.mul_(0.1).add_(1.0)
        else:
            leaf.mul_(0.1)
        data._set(out, path, leaf)
    return out


def without_dtype(layout):
    if isinstance(layout, dict):
        return {k: without_dtype(v) for k, v in layout.items()}
    if isinstance(layout, list):
        return [without_dtype(v) for v in layout]
    return layout[:2]


@pytest.mark.parametrize("name", DENSE)
def test_fp32_weights_are_drawn_bit_for_bit_as_before(name):
    cfg = small_config(name)
    layout = harness.model_parts(cfg).weight_shapes(cfg)
    seed = 2**33 + 7
    got = data.leaf_list(data.make_weights(cfg, seed, "cpu", layout))
    want = data.leaf_list(frozen_make_weights(without_dtype(layout), seed, "cpu"))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def test_a_bf16_layout_draws_bf16_leaves_a_chunk_at_a_time(monkeypatch):
    cfg = small_config("h2o-danube-1.8b", param_dtype="bfloat16")
    layout = data.weight_shapes(cfg)
    sizes = [math.prod(s) for s, _, _ in data.leaf_list(layout)]
    draws = []
    randn = torch.randn

    def counted(*args, **kw):
        out = randn(*args, **kw)
        draws.append(out.numel())
        return out
    monkeypatch.setattr(data, "CHUNK", 5000)
    monkeypatch.setattr(torch, "randn", counted)
    w = data.make_weights(cfg, 2**33 + 9, "cpu", layout)
    assert max(draws) == 5000 < max(sizes) and sum(draws) == sum(sizes)
    for (_, _, dtype), leaf in zip(data.leaf_list(layout), data.leaf_list(w)):
        assert leaf.dtype == getattr(torch, dtype)
    assert {leaf.dtype for leaf in data.leaf_list(w)} == {torch.bfloat16, torch.float32}
    again = data.leaf_list(data.make_weights(cfg, 2**33 + 9, "cpu", layout))
    assert all(torch.equal(a, b) for a, b in zip(data.leaf_list(w), again))
    other = data.leaf_list(data.make_weights(cfg, 2**33 + 10, "cpu", layout))
    assert not torch.equal(data.leaf_list(w)[0], other[0])
    big = next(leaf for leaf in data.leaf_list(w) if leaf.numel() > 5000)
    assert abs(float(big.float().std()) * math.sqrt(big.shape[-2]) - 1.0) < 0.1


def test_the_dense_reference_upcasts_bf16_weights_as_the_port_uses_them():
    from repro_torch.models import transformer as tf
    cfg = small_config("h2o-danube-1.8b", param_dtype="bfloat16")
    w = data.make_weights(cfg, 2**33 + 11, "cpu", data.weight_shapes(cfg))
    tok = data.tokens(cfg, "uniform", 2**33 + 11, 0, 2, 40)
    logits, _ = tf.forward_logits(w, {"tokens": tok},
                                  harness.program_config(cfg, compute_dtype="float32"))
    ref = reference.forward(w, tok, cfg)
    assert ref.dtype == torch.float32
    assert torch.allclose(logits.float(), ref, atol=2e-5, rtol=1e-5)


OWN_MODULE = '''
from pathlib import Path

from bench import data, flops, reference

SMALL = {small!r}
USED = Path(__file__).with_name("used.txt")


def mark(what):
    with USED.open("a") as f:
        f.write(what + "\\n")


def weight_shapes(cfg):
    mark("weight_shapes")
    return data.weight_shapes(cfg)


def served_gaps(w, prompts, served, cfg, q_rows, prec):
    mark("served_gaps")
    return reference.served_gaps(w, prompts, served, cfg, q_rows, prec)


def forward_flops(cfg, batch, seq):
    mark("forward_flops")
    return flops.forward_flops(cfg, batch, seq)


def kernel_bounds(cfg, batch, seq, peaks):
    mark("kernel_bounds")
    return flops.kernel_bounds(cfg, batch, seq, peaks)
'''


def test_a_configurations_own_module_is_found_by_name(tmp_path, monkeypatch):
    name = "h2o-danube-1.8b.prefill-b2-s4608"
    default = small_run(name, seed=2**33 + 13, trace=True)
    small = small_sizes({"name": "h2o-danube-1.8b"})
    (tmp_path / "h2o-danube-1.8b.py").write_text(OWN_MODULE.format(small=small))
    monkeypatch.setattr(harness, "REFERENCES", tmp_path)
    assert harness.model_parts({"name": "bert-large"}).SMALL is None  # no file: dense parts
    own = small_run(name, seed=2**33 + 13, trace=True)
    used = (tmp_path / "used.txt").read_text().split()
    # the set-up lays out the weights, the check judges, the trace counts the call's work
    assert used == ["weight_shapes", "served_gaps", "forward_flops", "kernel_bounds"]
    assert own["correct"] and default["correct"]
    assert own["checks"]["token_gap"] == default["checks"]["token_gap"]


def test_a_block_pattern_list_is_the_configs_tuple():
    from repro_torch.configs import get_config
    want = get_config("deepseek-v2-lite-16b")
    as_json = json.loads(json.dumps(dataclasses.asdict(want)))
    assert isinstance(as_json["block_pattern"], list)
    assert harness.program_config(as_json) == want


def test_from_profiler_keeps_prefill_ranges_out_of_ops():
    from torch.autograd import DeviceType

    def event(name, kind, a, b):
        return types.SimpleNamespace(name=name, device_type=kind, thread=1,
                                     time_range=types.SimpleNamespace(start=a, end=b))
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    prof = types.SimpleNamespace(events=lambda: [
        event(trace.STRETCH, cpu, 0.0, 100.0),
        event("prefill/attention", cpu, 4.0, 31.0),
        event("aten::mm", cpu, 5.0, 6.0),
        event("prefill/attention", cuda, 10.0, 30.0),
        event("flash_fwd_bf16_kernel", cuda, 10.0, 20.0),
        event("sm90_gemm", cuda, 21.0, 30.0)])
    t = trace.from_profiler(prof, 1, {})
    assert [n for n, _, _ in t.ops] == ["flash_fwd_bf16_kernel", "sm90_gemm"]
    assert t.spans_device == {"prefill/attention": [(10e-6, 30e-6)]}
    assert t.spans_host["prefill/attention"] == [(4e-6, 31e-6)]
    assert t.busy_s() == pytest.approx(19e-6)
    assert t.span_busy_s("prefill/attention") == pytest.approx(19e-6)
