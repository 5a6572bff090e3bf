"""Roofline analysis over the port's dry-run records, with the H100's constants.

The twin of ``repro.launch.roofline``. Reads
``experiments/dryrun_torch/*.json`` (written by ``launch.dryrun``) and
derives, per (arch × shape × mesh):

  compute term    = FLOPs/dev ÷ the H100's dense peak for the cell's compute
                    dtype (989e12 FLOP/s bf16, 67e12 fp32)
  memory term     = bytes accessed/dev ÷ 3.35e12 B/s (the H100's HBM3)
  collective term = collective bytes/dev ÷ ``LINK_BW`` = 300e9 B/s, the
                    paper's per-direction link bandwidth
                    (``core.cost_model.PAPER_LINK_BW``), the β that
                    ``--comm auto`` prices with

These are the constants ``chip_smoke.py`` uses for the kernels' bounds. The
JAX roofline's v5e constants (197e12, 819e9, 50e9) are the reference's and
are not used here. The port's records are per device and count every layer
and time step (the JAX ``--unroll`` accounting), so no record is flagged
for a scan. ``cost.bytes_accessed`` is eager, unfused traffic, so the
memory term is an upper bound of what a fused program moves.

MODEL_FLOPS = 6·N_active·D (train) / 2·N_active·D (prefill) / 2·N_active·B
(decode, one token per sequence). The ratio MODEL_FLOPS / (FLOPs × chips)
exposes remat and redundant work (<1) or work the counter does not see (>1).
``roofline_frac`` (the model FLOPs' compute time over the bound) is not
capped at 1, as the JAX roofline's is: the port's counts are its own, and
a fraction above 1 says the count fell short of the model's FLOPs. The
table flags such a cell and ``main`` names it.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh single] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.configs import SHAPES, get_config
from repro_torch.core.cost_model import PAPER_LINK_BW
from repro_torch.launch.dryrun import OUT_DIR as DRYRUN_DIR

#: the H100 SXM's dense peaks by compute dtype (FLOP/s), its HBM rate (B/s),
#: and the collective term's per-direction link bandwidth (B/s)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12
LINK_BW = PAPER_LINK_BW

EXP_DIR = DRYRUN_DIR.parent


def constants() -> str:
    return (f"H100 constants: peak {PEAK_FLOPS['bfloat16'] / 1e12:g}e12 FLOP/s bf16, "
            f"{PEAK_FLOPS['float32'] / 1e12:g}e12 FLOP/s fp32; HBM {HBM_BW / 1e12:g}e12 B/s; "
            f"link {LINK_BW / 1e9:g}e9 B/s per direction (cost_model.PAPER_LINK_BW)")


def model_flops(arch: str, shape_name: str) -> float:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n = cfg.active_param_count()
    if shape.step == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.step == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def peak_flops(arch: str) -> float:
    """The peak for the cell's compute dtype."""
    return PEAK_FLOPS[get_config(arch).compute_dtype]


def terms(flops: float, bytes_accessed: float, collective_bytes: float,
          compute_dtype: str) -> dict:
    """The three roofline terms of one device's work, the dominant one, and
    the bound (the largest)."""
    t_c = flops / PEAK_FLOPS[compute_dtype]
    t_m = bytes_accessed / HBM_BW
    t_x = collective_bytes / LINK_BW
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_x),
              key=lambda kv: kv[1])[0]
    return {"t_compute_s": t_c, "t_memory_s": t_m, "t_collective_s": t_x,
            "dominant": dom, "bound_s": max(t_c, t_m, t_x)}


def analyze_record(rec: dict) -> dict:
    chips = rec["n_devices"]
    flops = rec["cost"]["flops"]
    peak = peak_flops(rec["arch"])
    t = terms(flops, rec["cost"]["bytes_accessed"], rec["collectives"]["total_bytes"],
              get_config(rec["arch"]).compute_dtype)
    mf = model_flops(rec["arch"], rec["shape"])
    t_model = mf / chips / peak
    bound = t["bound_s"]
    temp = rec["memory"]["temp_bytes"]
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "chips": chips,
        "t_compute_s": t["t_compute_s"], "t_memory_s": t["t_memory_s"],
        "t_collective_s": t["t_collective_s"],
        "dominant": t["dominant"],
        "model_flops": mf,
        "model_hlo_ratio": mf / max(flops * chips, 1.0),
        "roofline_frac": t_model / bound if bound > 0 else 0.0,
        "temp_gb": None if temp is None else temp / 1e9,
        "collective_detail": {k: v for k, v in rec["collectives"].items()
                              if isinstance(v, dict) and v.get("count")},
        "bound_s": bound, "peak_flops": peak,
    }


SUGGESTIONS = {
    "compute": "compute-bound: keep the matmuls on the tensor cores (bf16 "
               "everywhere, wgmma-sized tiles, the flash kernel for attention, "
               "larger per-card batch) or shrink redundant recompute (remat policy)",
    "memory": "HBM-bound: fuse the elementwise and norm epilogues into CUDA "
              "kernels, widen arithmetic intensity (bigger KV tiles, int8 KV), "
              "or re-tile so weights stream once per step",
    "collective": "collective-bound: re-shard to cut all-gather volume "
                  "(ZeRO boundary, TP axis choice), overlap via bucketed "
                  "LUMORPH-4 (α↓) or int8 payloads (β↓)",
}


def load_records(mesh: str, directory=None) -> list[dict]:
    recs = []
    for p in sorted(Path(directory or DRYRUN_DIR).glob("*.json")):
        r = json.loads(p.read_text())
        if not r.get("ok") or r["mesh"] != mesh:
            continue
        if r.get("comm", "xla") != "xla" or r.get("compress") or r.get("variant"):
            continue  # comm/sharding variants are perf artifacts, not baselines
        recs.append(r)
    return recs


def to_markdown(rows: list[dict]) -> str:
    hdr = ("| arch | shape | t_compute (s) | t_memory (s) | t_collective (s) "
           "| dominant | 6ND/FLOPs | roofline frac |\n"
           "|---|---|---|---|---|---|---|---|\n")
    out = [hdr]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.3e} | "
            f"{r['t_memory_s']:.3e} | {r['t_collective_s']:.3e} | "
            f"**{r['dominant']}** | {r['model_hlo_ratio']:.2f} | "
            f"{r['roofline_frac']:.3f}{OVER_FLAG if r['roofline_frac'] > 1 else ''} |\n")
    return "".join(out)


OVER_FLAG = " (> 1: count below the model's FLOPs)"


def over_bound(rows: list[dict]) -> list[str]:
    """The cells whose model FLOPs would run faster than their bound: the
    port's count fell short there."""
    return [f"{r['arch']}/{r['shape']}/{r['mesh']}" for r in rows if r["roofline_frac"] > 1]


def dominant_counts(rows: list[dict]) -> dict[str, int]:
    return {dom: sum(1 for r in rows if r["dominant"] == dom)
            for dom in ("compute", "memory", "collective")}


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rows = [analyze_record(r) for r in load_records(args.mesh)]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    md = to_markdown(rows)
    print(constants())
    print(md)
    EXP_DIR.mkdir(parents=True, exist_ok=True)
    out = args.out or (EXP_DIR / f"roofline_torch_{args.mesh}.md")
    Path(out).write_text(md)
    (EXP_DIR / f"roofline_torch_{args.mesh}.json").write_text(
        json.dumps(rows, indent=1, default=str))
    for dom, n in dominant_counts(rows).items():
        if n:
            print(f"{n:3d} cells {dom}-bound → {SUGGESTIONS[dom]}")
    over = over_bound(rows)
    if over:
        print(f"{len(over)} cells with roofline_frac > 1 (count below the model's FLOPs): "
              + ", ".join(over))
    return rows


if __name__ == "__main__":
    main()
