"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found by name."""

import json
import re

from smallcells import ROOT

from bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_and_names():
    b = bench()
    assert set(b) == KEYS
    assert b["paths"] == ["bench"] and b["command"] == ["python3", "bench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in b["end_to_end"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_four_chip_cells_at_most_a_quarter_or_one():
    cells = bench()["workloads"]
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)


def test_every_cell_reports_what_it_must():
    b = bench()
    for w in b["workloads"]:
        cell = harness.load_cell(w["name"], b)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:  # its moves is reported by each of its cells
            assert m["moves"] in e2e, (w["name"], m["name"])
        assert cell.traffic["driver"] in ("train", "prefill")
        assert set(cell.limits), w["name"]


def test_every_metric_has_a_reader_and_one_layer_name_per_layer():
    b = bench()
    for m in b["per_layer"]:
        assert callable(harness.reader(m["name"]))
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    roofline = [m for m in b["per_layer"] if "roofline" in m["name"]]
    assert all(m["name"].endswith("_roofline") and m["unit"] == "%" for m in roofline)
    assert any("mfu" in m["name"] for m in b["per_layer"])


def test_config_files_are_the_ports_configs():
    from repro_torch.configs import get_config
    for c in bench()["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert harness.program_config(cfg) == get_config(c["name"])
