"""The trace arithmetic on synthetic traces: busy time as the union of the
device's intervals, spans, readers and the breakdown."""

import pytest
from smallcells import small_run

from bench import harness, trace


def two_streams():
    # compute on one stream, a collective on another that overlaps it by 2 s
    ops = [("sm90_gemm_a", 0.0, 4.0), ("ncclDevKernel_SendRecv", 2.0, 5.0),
           ("flash_fwd_bf16_kernel", 6.0, 7.0), ("elementwise_kernel", 9.0, 9.5)]
    host = [("bench/step", 0.0, 10.0), ("aten::mm", 4.9, 5.9), ("aten::add", 6.5, 8.8)]
    return trace.Trace(ops=ops, spans_host={"bench/step": [(0.0, 10.0)]},
                       spans_device={"train/adamw": [(5.5, 9.6)]}, host_ops=host,
                       start=0.0, end=10.0, units=2,
                       info={"flops_per_unit": 1e12, "peak_flops": 1e12, "chips": 1,
                             "units_per_s": 0.2, "flash_bound_s": 0.5})


def test_union_counts_overlap_once():
    assert trace.union([(2, 5), (0, 4), (6, 7), (7, 8)]) == [(0, 5), (6, 8)]
    t = two_streams()
    assert t.busy_s() == pytest.approx(6.5)  # 0–5, 6–7, 9–9.5: not 4 + 3 + 1 + 0.5
    assert harness.reader("idle_share.train")(t) == pytest.approx(35.0)


def test_span_and_kind_readers():
    t = two_streams()
    assert t.span_busy_s("train/adamw") == pytest.approx(1.5)  # the ops starting inside
    assert harness.reader("adamw_ms.train")(t) == pytest.approx(750.0)
    assert harness.reader("fwd_bwd_ms.train")(t) is None  # no such span: nothing read
    assert harness.reader("attention_ms.prefill")(t) == pytest.approx(500.0)
    assert harness.reader("gemm_ms.prefill")(t) == pytest.approx(2000.0)
    assert harness.reader("flash_roofline")(t) == pytest.approx(50.0)
    assert harness.reader("mfu.train")(t) == pytest.approx(20.0)
    assert harness.reader("host_ms.train")(t) == pytest.approx(1e4)


def test_breakdown_names_what_the_host_did_in_the_gaps():
    b = two_streams().breakdown()
    assert b["device_ops"][0] == ["sm90_gemm_a", 4.0]
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    assert gaps == pytest.approx({"bench/step > aten::mm": 1.0,  # 5–6
                                  "bench/step > aten::add": 2.0,  # 7–9
                                  "bench/step": 0.5})  # 9.5–10


def test_result_line_schema():
    for name in ("bert-large.train-b256-s128", "h2o-danube-1.8b.prefill-b2-s4608"):
        for traced in (False, True):
            r = small_run(name, trace=traced)
            assert list(r)[-1] == "checks"
            assert isinstance(r["correct"], bool)
            assert isinstance(r["attempted"], int) and r["attempted"] > 0 and r["failed"] == 0
            assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
            for m in r["metrics"].values():
                assert set(m) == {"value", "unit"}
            cell = harness.load_cell(name)
            want = cell.per_layer if traced else cell.end_to_end
            assert set(r["metrics"]) <= {m["name"] for m in want}
            if traced:
                assert {"busy_s", "window_s"} <= set(r["device"])
                assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
            else:
                assert set(r["metrics"]) == {m["name"] for m in want}
            for c in r["checks"].values():
                assert set(c) == {"value", "limit"}
