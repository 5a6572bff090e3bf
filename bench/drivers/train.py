"""The ``train`` mix: a closed loop of training steps through
``repro_torch.launch.steps.make_train_step``, composed as
``repro_torch.launch.train._train`` composes it (``checked_policy``, the
state, ``make_train_step`` with the trainer's buckets and wire), on a host
mesh of one rank or one process a chip over NCCL.

Set-up makes the weights from the seed (``bench.data.make_weights``) and a
ring of distinct global batches, drives the step through its first
``checked_steps`` steps on the ring's first batches, and keeps the readings
the check needs (each step's loss; after step 1 each leaf's first moment over
``1 - b1``, the clipped gradient as AdamW got it; after the last, each leaf's
change). It warms up, and hands the same step and state to the window, which
issues steps back to back; losses stay on the device. After the window the
program's state is freed and the plain reference takes the same first steps
from the same weights and batches in fp32.
"""

from __future__ import annotations

import sys
import time

import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile, record_function

from bench import data, flops, reference, trace as trace_lib
from bench.harness import (Run, checks_verdict, device_info, device_kind, program_config,
                           read_metrics, stage)


def compare(prog: dict, ref: dict) -> dict:
    """The numbers compared: the widest relative gap of a step's loss; of a
    leaf's clipped first-gradient norm, and of a leaf's change norm after the
    checked steps (both by the worst leaf: the gap of the norms over the
    reference's norm of that leaf or of the median leaf, whichever is larger;
    the change only of leaves whose reference gradient is at least a
    thousandth of the median leaf's)."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))

    def worst(p, r, keep):
        med = sorted(r)[len(r) // 2]
        return max(abs(a - b) / max(b, med) for a, b, k in zip(p, r, keep) if k)
    g_ref = ref["grad_norms"]
    g_med = sorted(g_ref)[len(g_ref) // 2]
    everyone = [True] * len(g_ref)
    moved = [g >= 1e-3 * g_med for g in g_ref]
    return {"loss_gap": loss_gap,
            "grad_gap": worst(prog["grad_norms"], g_ref, everyone),
            "update_gap": worst(prog["change_norms"], ref["change_norms"], moved)}


class Setup:
    """The program's step and state, set up and driven through its checked steps."""

    def __init__(self, run: Run):
        from repro_torch.launch import steps as steps_lib
        from repro_torch.launch.mesh import init_process_mesh, lay_out_mesh, make_host_mesh
        from repro_torch.launch.train import checked_policy
        from repro_torch.optim.adamw import AdamWConfig, init_opt_state
        from repro_torch.sharding.policy import MeshShape
        from repro_torch.tree import leaves, unflatten

        stage(run, "imports")
        self.run, cell = run, run.cell
        tr, self.cfg = cell.traffic, cell.cfg
        self.tr = tr
        dev = run.device
        if run.world > 1:
            backend = "nccl" if dev.type == "cuda" else "gloo"
            mesh = init_process_mesh(dev.type, backend, init_method=run.rdzv, rank=run.rank,
                                     world_size=run.world)
            mesh = lay_out_mesh(mesh, MeshShape(("data", "model"), (run.world, 1)))
            self.host_group = dist.new_group(backend="gloo")
            group = mesh.group
        else:
            mesh, group, self.host_group = make_host_mesh(1, dev), None, None
        self.dev = dev = mesh.device
        stage(run, "mesh")
        mc = program_config(self.cfg)
        policy = checked_policy(mc, mesh)
        self.step = steps_lib.make_train_step(
            mc, AdamWConfig(**tr["optimizer"]), comm=tr["comm"], dp=mesh.data,
            bucket_bytes=tr["bucket_mb"] * 1024 * 1024,
            wire_dtype=getattr(torch, tr["wire_dtype"]), device=dev, group=group,
            policy=policy, mesh=mesh)
        b, s = tr["global_batch"], tr["seq_len"]
        self.ring = [data.tokens(self.cfg, tr["tokens"], run.seed, i, b, s).to(dev)
                     for i in range(tr["ring"])]
        weights = data.make_weights(self.cfg, run.seed, dev)
        lead = () if group is not None else (1,)
        self.params = unflatten(weights, [t.view(lead + t.shape) for t in leaves(weights)])
        del weights
        self.opt = init_opt_state(self.params, lead=lead)
        stage(run, "weights and batches")
        self.n = 0  # steps issued
        losses = []
        for i in range(tr["checked_steps"]):
            losses.append(self.issue())
            self.sync()
            stage(run, f"step {i + 1}")
            if i == 0:
                b1 = tr["optimizer"]["b1"]
                grad_norms = [(m / (1 - b1)).norm() for m in leaves(self.opt["m"])]
        start = data.leaf_list(data.make_weights(self.cfg, run.seed, dev))
        change = [(p.reshape(p0.shape) - p0).norm()
                  for p, p0 in zip(leaves(self.params), start)]
        del start
        self.readings = {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
        t = time.perf_counter()
        for _ in range(tr["warm_steps"]):
            self.issue()
        self.sync()
        self.step_s = (time.perf_counter() - t) / tr["warm_steps"]  # the warm steps' pace
        stage(run, "warm")

    def issue(self):
        with record_function("bench/step"):
            self.params, self.opt, loss = self.step(
                self.params, self.opt, {"tokens": self.ring[self.n % len(self.ring)]})
        self.n += 1
        return loss

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def steps_until(self, t_end: float) -> int | None:
        """On several ranks, the steps that fill the window up to ``t_end`` at
        the warm steps' pace: rank 0's count, heard once by every rank, so that
        no rank's host waits on another's inside the window."""
        if self.host_group is None:
            return None
        n = torch.tensor([max(1, round((t_end - time.perf_counter()) / self.step_s))])
        dist.broadcast(n, 0, group=self.host_group)
        return int(n)

    def max_over_ranks(self, values: list[float]) -> list[float]:
        t = torch.tensor(values, dtype=torch.float64)
        if self.host_group is not None:
            dist.all_reduce(t, dist.ReduceOp.MAX, group=self.host_group)
        return t.tolist()

    def mean_over_ranks(self, value: float) -> float:
        t = torch.tensor([value], dtype=torch.float64)
        if self.host_group is not None:
            dist.all_reduce(t, group=self.host_group)
        return float(t) / self.run.world

    def free(self) -> dict:
        """The readings on the host; the program's state and step dropped."""
        r = {k: [float(x) for x in v] for k, v in self.readings.items()}
        del self.params, self.opt, self.step, self.readings
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return r

    def reference(self, prec=reference.FP32) -> dict:
        """The plain reference's readings over the same weights and batches,
        each rank on its own rows, the gradients summed over ranks."""
        run, tr = self.run, self.tr
        rows = tr["global_batch"] // run.world
        mine = [t[run.rank * rows:(run.rank + 1) * rows]
                for t in self.ring[:tr["checked_steps"]]]
        ranks = None
        if run.world > 1:
            def total(t):
                dist.all_reduce(t)
                return t
            ranks = (run.world, total)
        with reference.exact_fp32():
            w = data.make_weights(self.cfg, run.seed, self.dev)
            return reference.train(w, mine, self.cfg, tr["optimizer"], tr["reference_rows"],
                                   prec, ranks)


def run(run: Run) -> dict | None:
    cell, tr = run.cell, run.cell.traffic
    su = Setup(run)
    t_setup = time.time()
    tokens_per_step = tr["global_batch"] * tr["seq_len"]
    traced = None
    start = time.perf_counter()
    t_end = start + run.seconds
    window_steps = 0
    if run.trace:
        traced = _trace(su, tr["trace_steps"])
        window_steps += tr["trace_steps"]
    after_trace = time.perf_counter()
    issued = [after_trace]  # the host's clock at each step's issue: where it stalls
    count = su.steps_until(t_end)  # None on one rank: the clock ends the window
    while (time.perf_counter() < t_end) if count is None else (len(issued) <= count):
        su.issue()
        window_steps += 1
        issued.append(time.perf_counter())
    su.sync()
    end = time.perf_counter()
    _report_steps(run, issued)
    window_s = end - start
    peak = torch.cuda.max_memory_allocated(su.dev) if su.dev.type == "cuda" else 0
    peak = int(su.max_over_ranks([peak])[0])
    prog = su.free()
    stage(run, "window closed")
    ref = su.reference()
    stage(run, "reference done")
    numbers = compare(prog, ref)
    numbers = dict(zip(numbers, su.max_over_ranks(list(numbers.values()))))
    correct, checks = checks_verdict(numbers, cell.limits)
    result = {"correct": correct, "attempted": window_steps, "failed": 0}
    if run.trace:
        peaks = flops.peak(device_kind(su.dev))
        info = {"flops_per_unit": flops.train_step_flops(su.cfg, tr["global_batch"],
                                                         tr["seq_len"]),
                "peak_flops": peaks and peaks["bf16_flops"], "chips": run.world,
                # the window's rate past the traced stretch, which the profiler slows
                "units_per_s": (window_steps - tr["trace_steps"]) / (end - after_trace)}
        tr_obj = trace_lib.from_profiler(traced, tr["trace_steps"], info)
        result["metrics"] = read_metrics(cell, tr_obj)
        busy = su.mean_over_ranks(tr_obj.busy_s())
        window = tr_obj.window_s
        breakdown = tr_obj.breakdown()
    else:
        setup_s = t_setup - run.t0
        rate = next(m["name"] for m in cell.end_to_end if m["unit"] == "tokens/s")
        result["metrics"] = {
            rate: {"value": window_steps * tokens_per_step / window_s, "unit": "tokens/s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    if run.rank != 0:
        return None
    result["device"] = device_info(su.dev, run.world, peak)
    if run.trace:
        result["device"].update(busy_s=busy, window_s=window)
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def _report_steps(run: Run, issued: list[float]) -> None:
    """The spread of the host's step-to-step times in the window, on stderr."""
    gaps = sorted(b - a for a, b in zip(issued, issued[1:]))
    if run.rank == 0 and gaps:
        med = gaps[len(gaps) // 2]
        print(f"bench: step issue times (s): min {gaps[0]:.4f} median {med:.4f} "
              f"max {gaps[-1]:.4f}; {sum(g > 1.5 * med for g in gaps)} of {len(gaps)} "
              "over 1.5 x the median", file=sys.stderr, flush=True)



def _trace(su: Setup, steps: int):
    """``steps`` steps under the profiler, synchronised at both ends of the
    ``bench/stretch`` span."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if su.dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        with record_function(trace_lib.STRETCH):
            su.sync()
            for _ in range(steps):
                su.issue()
            su.sync()
    return prof
