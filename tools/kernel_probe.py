#!/usr/bin/env python3
"""The hand-written kernels alone on the card: chip_smoke.py's phases 1 and 2
and its flash check at whisper's shape, for iterating on a kernel without
running the whole script.

    python3 tools/kernel_probe.py

Builds every kernel from ``src/repro_torch/kernels/csrc``, prints each flash
and RMSNorm entry's ptxas report and SASS counts, holds the flash kernels on
phase 2's shapes and fp32 at large score magnitudes, and RMSNorm on its
cases, against their plain versions, then times them at phase 2's shapes
beside the plain version and one PyTorch call. One JSON object per line;
exits non-zero without a card or where a kernel disagrees.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def large_score_checks(ops, gen) -> list:
    """fp32 with q and k scaled by √6 (scaled scores of std 6, extremes near
    ±30), GQA and a window, at D = 64, 80 and 128, within 1e-4 of plain."""
    out = []
    for b, sq, h, kv, d, window in ((2, 1024, 8, 2, 64, 256), (2, 1024, 32, 8, 80, 512),
                                    (1, 1024, 48, 8, 128, 300)):
        q, k, v = (torch.randn(s, generator=gen, device="cuda")
                   for s in ((b, sq, h, d), (b, sq, kv, d), (b, sq, kv, d)))
        q, k = q * 6 ** 0.5, k * 6 ** 0.5
        got = ops.flash_attention(q, k, v, causal=True, window=window)
        plain = ops.flash_attention_plain(q, k, v, causal=True, window=window)
        err = float((got - plain).abs().max())
        out.append({"shape": [b, sq, sq, h, kv, d, True, window], "dtype": "float32",
                    "score_scale": 6 ** 0.5, "max_abs_err": err, "tol": 1e-4})
        assert torch.isfinite(got).all() and err <= 1e-4, out[-1]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from repro_torch.kernels import build, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda}),
          flush=True)
    libs = build.build_all()
    for name in ("flash_attention", "rmsnorm"):
        rep = smoke.ptxas_report(libs[name].with_suffix(".log"))
        print(json.dumps({"built": name, "ptxas": rep}), flush=True)
    sass = smoke.sass_counts(libs["flash_attention"], build.nvcc())
    print(json.dumps({"flash_attention_sass": sass}), flush=True)
    for d in (64, 80, 128):
        for dt in (torch.float32, torch.bfloat16):
            print(json.dumps({"launch": d, "dtype": str(dt), **ops.flash_attention_launch_info(d, dt)}),
                  flush=True)
    gen = torch.Generator(device="cuda").manual_seed(29)
    print(json.dumps({"large_score_checks": large_score_checks(ops, gen)}), flush=True)
    kern = smoke.phase_kernels(ops)
    print(json.dumps({"kernel_checks": kern["checks"]}), flush=True)
    for shape, by_dt in kern["timed"].items():
        for dt, t in by_dt.items():
            print(json.dumps({"flash": shape, "dtype": str(dt),
                              **{k: v for k, v in t.items() if k != "launch"}}), flush=True)
    smoke.phase_flash_whisper(ops)
    rms = smoke.phase_rmsnorm(ops, ref)
    print(json.dumps({"rmsnorm_checks": rms["checks"], "rmsnorm_timed": rms["timed"]}),
          flush=True)
    print(json.dumps({"ok": True, "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
