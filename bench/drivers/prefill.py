"""The ``prefill`` mix: one client in a closed loop through
``repro_torch.launch.steps.make_prefill``, each call a batch of prompts from a
ring made at set-up, timed from its issue until its logits are on the card
(synchronised): the time to first token of a long document.

The calls to be checked are drawn from the seed before the window; for each,
once it is timed, its served tokens (the first choice at every position) are
kept. After the window the weights are dropped, drawn again from the seed,
and the plain reference judges every served token in fp32: the widest gap by
which a served token's logit lies below the reference's best. The weights'
layout, the reference, the FLOP count and the kernels' bounds are the
configuration's model parts (``bench.harness.model_parts``).
"""

from __future__ import annotations

import random
import statistics
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from bench import data, flops, reference, trace as trace_lib
from bench.harness import (Run, checks_verdict, device_info, device_kind, model_parts,
                           program_config, read_metrics, stage)


class Setup:
    def __init__(self, run: Run):
        from repro_torch.launch import steps as steps_lib
        stage(run, "imports")
        self.run, cell = run, run.cell
        tr, self.cfg = cell.traffic, cell.cfg
        self.tr, self.dev = tr, run.device
        mc = program_config(self.cfg, use_pallas=tr["use_pallas"])
        self.prefill = steps_lib.make_prefill(mc, device=self.dev)
        self.ring = [data.tokens(self.cfg, tr["tokens"], run.seed, i, tr["batch"],
                                 tr["prompt_len"]).to(self.dev) for i in range(tr["ring"])]
        self.model = model_parts(self.cfg)
        self.layout = self.model.weight_shapes(self.cfg)
        self.weights = data.make_weights(self.cfg, run.seed, self.dev, self.layout)
        stage(run, "weights and prompts")
        self.n = 0  # calls issued
        self.chosen: set[int] = set()  # the calls whose served tokens are checked
        self.served: dict[int, torch.Tensor] = {}
        for i in range(tr["warm_calls"]):
            self.call()
            stage(run, f"warm call {i + 1}")
        rng = random.Random(run.seed)
        self.chosen = set(rng.sample(range(tr["sample_from"]), tr["sample_calls"]))
        self.n = 0

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def call(self) -> float:
        """One call, timed from its issue to its logits on the card."""
        t0 = time.perf_counter()
        with record_function("bench/issue"):
            logits = self.prefill(self.weights, {"tokens": self.ring[self.n % len(self.ring)]})
        self.sync()
        dt = time.perf_counter() - t0
        if self.n in self.chosen:
            self.served[self.n] = logits.argmax(-1)
        self.n += 1
        return dt

    def free(self) -> None:
        del self.weights, self.prefill
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The checked calls' prompts and served tokens, a row each."""
        calls = sorted(self.served)
        prompts = torch.cat([self.ring[c % len(self.ring)] for c in calls])
        return prompts, torch.cat([self.served[c] for c in calls])

    def gap(self, prompts, served, prec=reference.FP32) -> float:
        with reference.exact_fp32():
            w = data.make_weights(self.cfg, self.run.seed, self.dev, self.layout)
            return self.model.served_gaps(w, prompts, served, self.cfg,
                                          self.tr["reference_rows"], prec)


def run(run: Run) -> dict:
    cell, tr = run.cell, run.cell.traffic
    su = Setup(run)
    t_setup = time.time()
    lat = []
    traced = None
    start = time.perf_counter()
    t_end = start + run.seconds
    if run.trace:
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if su.dev.type == "cuda" else [])
        with profile(activities=acts) as traced:
            with record_function(trace_lib.STRETCH):
                su.sync()
                lat += [su.call() for _ in range(tr["trace_calls"])]
    after_trace = time.perf_counter()
    # the window holds the calls the check draws from, however slow the host
    while time.perf_counter() < t_end or su.n < tr["sample_from"]:
        lat.append(su.call())
    end = time.perf_counter()
    window_s = end - start
    peak = torch.cuda.max_memory_allocated(su.dev) if su.dev.type == "cuda" else 0
    su.free()
    stage(run, "window closed")
    numbers = {"token_gap": su.gap(*su.sample())}
    stage(run, "reference done")
    correct, checks = checks_verdict(numbers, cell.limits)
    result = {"correct": correct, "attempted": len(lat), "failed": 0}
    tokens_per_call = tr["batch"] * tr["prompt_len"]
    if run.trace:
        peaks = flops.peak(device_kind(su.dev))
        b, s = tr["batch"], tr["prompt_len"]
        info = {"flops_per_unit": su.model.forward_flops(su.cfg, b, s),
                "peak_flops": peaks and peaks["bf16_flops"], "chips": 1,
                **su.model.kernel_bounds(su.cfg, b, s, peaks),
                # the window's rate past the traced stretch, which the profiler slows
                "units_per_s": (len(lat) - tr["trace_calls"]) / (end - after_trace)}
        tr_obj = trace_lib.from_profiler(traced, tr["trace_calls"], info)
        result["metrics"] = read_metrics(cell, tr_obj)
    else:
        result["metrics"] = {
            "prefill_tokens_per_s": {"value": len(lat) * tokens_per_call / window_s,
                                     "unit": "tokens/s"},
            "prefill_p95_s": {"value": statistics.quantiles(lat, n=20)[-1], "unit": "s"},
            "setup_s": {"value": t_setup - run.t0, "unit": "s"}}
    result["device"] = device_info(su.dev, 1, peak)
    if run.trace:
        result["device"].update(busy_s=tr_obj.busy_s(), window_s=tr_obj.window_s)
        result["breakdown"] = tr_obj.breakdown()
    result["checks"] = checks
    return result
