"""The check that decides ``correct`` fails what it must: each fault a cell
can have, planted under the timed path, and the control (the reference in
float8, the precision below the configuration's bf16), at sizes a CPU test
holds, against the cells' own limits."""

import sys
import time
import types

import pytest
import torch
from smallcells import HELD, ROOT, load_cell, small_cell, small_run

from bench import faults, harness, reference
from bench.drivers import prefill, train

ONE_CHIP = [w["name"] for w in harness.manifest()["workloads"] if w["chips"] == 1]
FOUR_CHIPS = [w["name"] for w in harness.manifest()["workloads"] if w["chips"] == 4] + list(HELD)


def caught(sound: dict, other: dict) -> list[str]:
    """The numbers that the sound run keeps within their limits and ``other``
    does not: what fails ``other`` is its fault, not the test's small size."""
    return [n for n, c in other.items()
            if sound[n]["value"] <= c["limit"] < c["value"]]


def cases():
    for name in ONE_CHIP:
        driver = harness.load_cell(name).traffic["driver"]
        for fault in faults.faults_for(driver, 1):
            yield name, driver, fault


@pytest.mark.parametrize("name,driver,fault", list(cases()))
def test_a_planted_fault_fails_the_run(name, driver, fault):
    sound = small_run(name, seed=2**31 + 11)
    with faults.faults_for(driver, 1)[fault]():
        faulty = small_run(name, seed=2**31 + 11)
    assert not faulty["correct"] and caught(sound["checks"], faulty["checks"])


@pytest.mark.parametrize("name", FOUR_CHIPS)
def test_the_exchange_left_out_fails_the_ranks_run(name, monkeypatch):
    world = load_cell(name).chips
    args = types.SimpleNamespace(workload=name, seed=2**31 + 13, seconds=0.2, trace=0)
    entry = [sys.executable, str(ROOT / "bench" / "tests" / "smallcells.py")]
    sound = harness.spawn_ranks(args, world, time.time(), entry)
    monkeypatch.setenv("BENCH_TEST_FAULT", "no_exchange")
    faulty = harness.spawn_ranks(args, world, time.time(), entry)
    assert not faulty["correct"] and caught(sound["checks"], faulty["checks"])


@pytest.mark.parametrize("name", ONE_CHIP + FOUR_CHIPS)
def test_the_control_fails(name):
    cell = small_cell(name)
    if cell.traffic["driver"] == "train":
        cell.traffic["global_batch"] = 8
    run = harness.Run(cell=cell, seed=2**31 + 17, seconds=0.0, trace=False, t0=0.0,
                      device=torch.device("cpu"))
    if cell.traffic["driver"] == "train":
        su = train.Setup(run)
        prog, ref = su.free(), su.reference()
        sound, control = train.compare(prog, ref), train.compare(su.reference(reference.FP8), ref)
    else:
        su = prefill.Setup(run)
        while su.n < cell.traffic["sample_from"]:
            su.call()
        su.free()
        prompts, served = su.sample()
        sound = {"token_gap": su.gap(prompts, served)}
        control = {"token_gap": su.gap(prompts, None, reference.FP8)}
    _, sound = harness.checks_verdict(sound, cell.limits)
    correct, control = harness.checks_verdict(control, cell.limits)
    assert not correct and caught(sound, control), control
