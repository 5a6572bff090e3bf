"""The harness: finds a cell's files by name, runs its driver, checks the
process, and prints the result line.

A cell of ``BENCHMARK.json`` names a configuration (``bench/configs/<name>.json``,
the file of sizes that is run) and a traffic mix (``bench/traffic/<name>.json``,
whose ``driver`` names the loop in ``bench/drivers/`` and whose other keys are
its parameters); its limits for ``correct`` are ``bench/limits/<cell>.json``;
each per-layer metric is read by ``bench/metrics/<metric>.py``; a
configuration's own model parts, where its blocks are not the dense decoder's,
are ``bench/references/<config>.py``. Adding a cell, a configuration, a mix or
a metric is adding files and entries.

A cell on several chips runs one rank process per chip, spawned here with a
rendezvous on 127.0.0.1; rank 0 prints the result line.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import socket
import subprocess
import sys
import types
from pathlib import Path
from typing import Any, Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole
REFERENCES = BENCH / "references"
NOT_PROGRAM_KEYS = ("name", "source", "deployment", "assumed")


class Refused(SystemExit):
    """A run that prints no result: the reason goes to stderr."""

    def __init__(self, why: str):
        print(f"bench: {why}", file=sys.stderr, flush=True)
        super().__init__(2)


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict  # the configuration file
    traffic: dict  # the traffic file
    limits: dict  # limit per number compared
    end_to_end: list[dict]
    per_layer: list[dict]


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or manifest()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r}; have {sorted(cells)}")
    return make_cell(cells[name], bench)


def make_cell(w: dict, bench: dict) -> Cell:
    """A cell from its ``workloads`` entry and the manifest's configurations
    and metrics."""
    name = w["name"]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])

    def mine(metric):
        return name in metric.get("workloads", [name])
    return Cell(name=name, chips=w["chips"],
                cfg=json.loads((ROOT / conf["file"]).read_text()),
                traffic=json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text()),
                limits=json.loads((BENCH / "limits" / f"{name}.json").read_text()),
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


def program_config(cfg: dict, **overrides):
    """The program's ``ModelConfig`` with the configuration file's sizes (JSON's
    lists as the tuples ``ModelConfig`` holds, such as ``block_pattern``)."""
    from repro_torch.configs.base import ModelConfig

    def tuples(v):
        return tuple(tuples(x) for x in v) if isinstance(v, list) else v
    fields = {k: tuples(v) for k, v in cfg.items() if k not in NOT_PROGRAM_KEYS}
    return ModelConfig(name=cfg["name"], **fields).replace(**overrides)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    return _load(BENCH / "metrics" / f"{metric}.py", f"bench_metric_{metric}").read


def model_parts(cfg: dict) -> types.SimpleNamespace:
    """The model parts of the configuration file ``cfg``: its own module
    ``bench/references/<name>.py`` where there is one, and the dense decoder's
    for every part that it does not define (``SMALL`` has no default):

    * ``weight_shapes(cfg)``: the ``init_params`` tree, leaf → (shape, init,
      stored dtype), init as ``bench.data.make_weights`` draws it;
    * ``served_gaps(w, prompts, served, cfg, q_rows, prec)``: the
      ``token_gap`` reading in fp32, as ``bench.reference.served_gaps``;
    * ``forward_flops(cfg, batch, seq)``: model FLOPs of one forward, from
      the configuration alone;
    * ``kernel_bounds(cfg, batch, seq, peaks)``: the least time a launch of
      each kernel the path runs, under the name its roofline reader reads
      in ``Trace.info`` (None where ``peaks`` is None);
    * ``forward(w, tok, cfg)``: logits ``[B, S, V]`` in fp32, which the CPU
      tests hold the port against;
    * ``SMALL``: the configuration's sizes in the CPU tests.

    A module imports nothing of JAX or of the programs under test."""
    from bench import data, flops, reference
    dense = {"weight_shapes": data.weight_shapes, "served_gaps": reference.served_gaps,
             "forward_flops": flops.forward_flops, "kernel_bounds": flops.kernel_bounds,
             "forward": reference.forward, "SMALL": None}
    path = REFERENCES / f"{cfg['name']}.py"
    own = vars(_load(path, f"bench_reference_{cfg['name']}")) if path.is_file() else {}
    return types.SimpleNamespace(**{k: own.get(k, v) for k, v in dense.items()})


def read_metrics(cell: Cell, trace) -> dict:
    """Every per-layer metric of the cell that its reader finds, by name."""
    out = {}
    for m in cell.per_layer:
        value = reader(m["name"])(trace)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """What a driver gets: the cell, the run's arguments, and where it runs."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    t0: float  # the process's (the parent's, on several chips) start, time.time()
    device: Any = None  # torch.device
    rank: int = 0
    world: int = 1
    rdzv: Optional[str] = None


def stage(run: Run, what: str) -> None:
    """A set-up stage's time since the process started, on rank 0's stderr."""
    import time
    if run.rank == 0:
        print(f"bench: {what} at {time.time() - run.t0:.2f} s", file=sys.stderr, flush=True)


def leave_group() -> None:
    """Every rank waits for the others, then leaves the process group."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def checks_verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number beside its limit; correct where every one is finite and
    within its limit."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = limits[name]
        good = value == value and abs(value) != float("inf") and value <= limit
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok and bool(numbers), out


def device_kind(dev) -> str:
    import torch
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def device_info(dev, count: int, peak_bytes: int) -> dict:
    """The result line's ``device``: the card's name, the cards used, the peak
    memory on the fullest, and the power limit the card was set to."""
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": device_kind(dev),
            "count": count, "memory_peak_bytes": peak_bytes}
    if dev.type == "cuda":
        try:
            out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                                  "--format=csv,noheader", "-i", str(dev.index or 0)],
                                 capture_output=True, text=True, timeout=20)
            info["power_limit"] = out.stdout.strip()
        except (OSError, subprocess.SubprocessError):
            info["power_limit"] = "not read"
    return info


def print_result(result: dict) -> None:
    """The checks as the last lines of stderr, then the result as the last line
    of stdout, the checks its last key."""
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def run_driver(run: Run) -> Optional[dict]:
    driver = importlib.import_module(f"bench.drivers.{run.cell.traffic['driver']}")
    return driver.run(run)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(args, world: int, t0: float, entry: list[str]) -> Optional[dict]:
    """Run ``world`` rank processes of ``entry`` (the command that runs one
    rank) and wait for every one; where one fails, end the others. Returns rank
    0's result (its last stdout line), or None where any rank failed. Their
    other output goes to stderr."""
    import tempfile
    import time
    rdzv = f"tcp://127.0.0.1:{free_port()}"
    procs, outs = [], []
    try:
        for r in range(world):
            cmd = entry + ["--workload", args.workload, "--seed", str(args.seed),
                           "--seconds", str(args.seconds), "--trace", str(args.trace),
                           "--rank", str(r), "--world", str(world), "--rdzv", rdzv,
                           "--t0", repr(t0)]
            # a few host threads a rank, so that no rank's host work waits for a core
            threads = str(max(1, (os.cpu_count() or 2) // (2 * world)))
            env = dict(os.environ, LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                       OMP_NUM_THREADS=threads)
            outs.append(tempfile.TemporaryFile("w+"))
            procs.append(subprocess.Popen(cmd, stdout=outs[-1], env=env, text=True, cwd=ROOT))
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break  # a rank failed: the others would wait for it forever
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    texts = []
    for f in outs:
        f.seek(0)
        texts.append(f.read())
        f.close()
    for r, (p, out) in enumerate(zip(procs, texts)):
        lines = out.strip().splitlines()
        for line in (lines[:-1] if r == 0 else lines):
            print(f"[rank {r}] {line}", file=sys.stderr)
        if p.returncode != 0:
            print(f"bench: rank {r} exited {p.returncode}", file=sys.stderr)
    if any(p.returncode for p in procs):
        return None
    lines = texts[0].strip().splitlines()
    return json.loads(lines[-1]) if lines else None
