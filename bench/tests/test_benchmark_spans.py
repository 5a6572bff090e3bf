"""The readers of the program's module spans on synthetic traces: each
module's device time without the recomputation inside its ``.bwd`` span, the
recomputation counted once, the host's forward and backward, the device's
idle time in the backward, and nothing read where the spans are missing."""

import pytest

from bench import harness, module_time, trace

NEW = ("embed_ms.train", "norm_ms.train", "attention_ms.train", "ffn_ms.train",
       "unembed_ms.train", "loss_ms.train", "recompute_ms.train", "host_fwd_ms.train",
       "host_bwd_ms.train", "bwd_idle_ms.train")


def step_trace():
    """Two steps' worth of one step: a forward, then a backward whose MLP span
    holds the block's recomputation (in seconds on the profiler's clock)."""
    ops = [("index_kernel", 1.0, 2.0),  # embed
           ("layer_norm", 3.0, 4.0),  # norm
           ("elementwise_add", 5.0, 6.0),  # a residual add: no module's
           ("gemm_qk", 7.0, 8.0), ("softmax", 8.0, 9.0),  # attention
           ("gemm_dgrad", 20.0, 22.0),  # the MLP's backward, before its recomputation
           ("layer_norm", 24.0, 26.0), ("gemm_qk", 27.0, 30.0),  # the recomputation
           ("gemm_wgrad", 32.0, 40.0),  # the MLP's backward
           ("layer_norm_bwd", 45.0, 46.0),  # a norm's backward
           ("elementwise_sum", 47.0, 48.0)]  # a gradient sum between modules
    dev = {"train/forward_backward": [(1.0, 60.0)],
           "train/embed": [(1.0, 2.0)], "train/norm": [(3.0, 4.0)],
           "train/attention": [(7.0, 9.0)], "train/ffn.bwd": [(20.0, 40.0)],
           "train/recompute": [(24.0, 30.0)], "train/norm.bwd": [(45.0, 46.0)]}
    host = {"bench/step": [(0.0, 60.0)], "train/forward_backward": [(0.2, 59.0)],
            "train/forward": [(0.5, 10.0)], "train/backward": [(18.0, 50.0)]}
    return trace.Trace(ops=ops, spans_host=host, spans_device=dev, host_ops=[],
                       start=0.0, end=100.0, units=2, info={})


def read(name, t):
    return harness.reader(name)(t)


def test_modules_leave_out_the_recomputation_inside_their_bwd_span():
    t = step_trace()
    assert read("embed_ms.train", t) == pytest.approx(500.0)
    assert read("norm_ms.train", t) == pytest.approx(1000.0)  # forward 1 s, backward 1 s
    assert read("attention_ms.train", t) == pytest.approx(1000.0)
    assert read("ffn_ms.train", t) == pytest.approx(5000.0)  # 2 + 8 s: not the 5 s inside
    assert read("recompute_ms.train", t) == pytest.approx(2500.0)


def test_each_operation_counts_once():
    t = step_trace()
    split = module_time.split_s(t)
    assert split == pytest.approx({"embed": 1.0, "norm": 2.0, "attention": 2.0, "ffn": 10.0,
                                   "unembed": 0.0, "loss": 0.0, "recompute": 5.0})
    # the rest of forward_backward: the residual add and the gradient sum
    assert t.span_busy_s("train/forward_backward") - sum(split.values()) == pytest.approx(2.0)


def test_the_narrowest_range_takes_an_operation():
    t = step_trace()
    t.spans_device["train/loss.bwd"] = [(19.0, 41.0)]  # wider than the MLP's
    assert read("ffn_ms.train", t) == pytest.approx(5000.0)
    assert read("loss_ms.train", t) == pytest.approx(0.0)


def test_host_forward_and_backward_and_the_idle_device_in_the_backward():
    t = step_trace()
    assert read("host_fwd_ms.train", t) == pytest.approx(4750.0)
    assert read("host_bwd_ms.train", t) == pytest.approx(16000.0)
    # 18–50 on the host: busy 20–22, 24–26, 27–30, 32–40, 45–46, 47–48 (17 s): 15 s idle
    assert read("bwd_idle_ms.train", t) == pytest.approx(7500.0)


def test_nothing_is_read_without_the_spans():
    t = step_trace()
    t.spans_device = {"train/forward_backward": [(1.0, 60.0)]}  # the parent's spans
    t.spans_host = {"bench/step": [(0.0, 60.0)], "train/forward_backward": [(0.2, 59.0)]}
    for name in NEW:
        assert read(name, t) is None, name
    assert read("fwd_bwd_ms.train", t) is not None
    t = step_trace()
    assert read("unembed_ms.train", t) is None and read("loss_ms.train", t) is None


def test_the_new_metrics_are_the_bert_cells():
    cell = harness.load_cell("bert-large.train-b256-s128")
    assert set(NEW) <= {m["name"] for m in cell.per_layer}
    prefill = harness.load_cell("h2o-danube-1.8b.prefill-b2-s4608")
    assert not set(NEW) & {m["name"] for m in prefill.per_layer}
