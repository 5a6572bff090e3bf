#!/usr/bin/env python3
"""What bounds the fp32 flash kernel: it timed beside two variants of itself.

    python3 tools/flash_f32_variants.py

Builds ``csrc/flash_attention.cu`` three times with nvcc into
``build/flash_f32_variants/``: as it is (3xTF32), with one TF32 product per
fp32 product (``1xtf32``: a third of the HMMA, the splits kept), and with no
split (``no_split``: hi = lo = the raw fp32 bits, the three HMMA kept, no
LOP3/FADD). The variants compute wrong answers and only time. Each is timed by
CUDA events at dbrx's and zamba2's phase-2 shapes (chip_smoke.py), in turns,
twice. If 1xtf32 takes a third of the time, the HMMA issue bounds the kernel;
if no_split is much faster, the split's ALU work does. One JSON line each.
"""

from __future__ import annotations

import ctypes
import json
import math
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from repro_torch.kernels import build  # noqa: E402

VARIANTS = {
    "3xtf32": [],
    "1xtf32": [("  mma(d, al, bh[0], bh[1]);\n  mma(d, ah, bl[0], bl[1]);\n", "")],
    "no_split": [("  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));\n",
                  "  lo = hi;\n")],
}


def build_variant(name: str, edits) -> ctypes.CDLL:
    src = (build.CSRC / "flash_attention.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"variant {name}: source text not found: {old!r}")
        src = src.replace(old, new)
    out = ROOT / "build" / "flash_f32_variants"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}.cu", out / f"{name}.so"
    cu.write_text(src)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci,
                                        ctypes.c_float, ci, vp]
    lib.flash_attention_fwd.restype = ci
    return lib


def time_ms(lib, q, k, v, out, s: dict, reps: int = 10) -> float:
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                      s["b"], s["sq"], s["skv"], s["h"], s["kv"], s["d"],
                                      int(s["causal"]), s["window"] or 0,
                                      1.0 / math.sqrt(s["d"]), 0, stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError_t {err}")

    call()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_f32_variants: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    libs = {name: build_variant(name, edits) for name, edits in VARIANTS.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, s in (("dbrx", chip_smoke.DBRX), ("zamba2", chip_smoke.ZAMBA2)):
        q, k, v = chip_smoke.randn_qkv(gen, s["b"], s["sq"], s["skv"], s["h"], s["kv"], s["d"],
                                       torch.float32)
        out = torch.empty_like(q)
        order = list(libs) + list(reversed(libs))  # in turns: a b c c b a
        times = {name: [] for name in libs}
        for name in order:
            times[name].append(time_ms(libs[name], q, k, v, out, s))
        print(json.dumps({"shape": shape, "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
