#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one card and check every result.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and exits non-zero, printing no result, without one. It builds the
CUDA kernels from ``src/repro_torch/kernels/csrc`` and imports nothing of
JAX or of the JAX package. No phase's failure is caught.

  1. Device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
     the kernels build (one nvcc per source, in parallel).
  2. Each kernel against its plain PyTorch version on the card, on the
     shapes of tests/test_kernels.py's ATTN_CASES and on danube's prefill
     shape (fp32 within 1e-4, bf16 within 2e-2, unit-normal inputs), with
     the kernel, the plain version and one library call timed by CUDA
     events, and the least time the card could take (``bound_ms``).
  3. The main path, at full width: h2o-danube-1.8b (24 layers, d_model
     2560, random weights from a seed) prefills 2 × 4608 tokens through
     ``launch.steps.make_prefill`` with the flash-attention kernel, against
     the plain dense path, in fp32 (relative max error ≤ 1e-3) and bf16
     (≤ 5e-2); each kernel prefill launches the kernel once per layer.
  4. The serving launcher at full width: 4 requests, 64-token prompts,
     32 generated tokens each (``launch.serve.main``, default device).

The launch counters are set to 0 just before phase 3 and read just after
phase 4. The last lines are the ``{"kernels": [...]}`` record, the prefill
record, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent

# tests/test_kernels.py ATTN_CASES: (b, sq, skv, h, kv, d, causal, window, dtype)
ATTN_CASES = [
    (2, 128, 128, 4, 4, 64, True, None, torch.float32),
    (1, 256, 256, 8, 2, 64, True, None, torch.bfloat16),
    (2, 100, 100, 4, 1, 32, True, 48, torch.float32),
    (1, 64, 192, 2, 2, 128, False, None, torch.float32),
    (1, 160, 160, 2, 2, 80, True, None, torch.float32),
    (1, 96, 96, 3, 3, 64, True, 17, torch.bfloat16),
]
# danube's prefill: 2 × 4608 tokens, 32 query / 8 KV heads of 80, window 4096
DANUBE = dict(b=2, sq=4608, skv=4608, h=32, kv=8, d=80, causal=True, window=4096)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # the card sums in another order
PREFILL_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
# H100 SXM published dense peaks (NVIDIA data sheet): fp32 on the CUDA cores,
# bf16 on the tensor cores; HBM3 bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
HBM_BYTES_S = 3.35e12


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def live_pairs(sq: int, skv: int, causal: bool, window) -> int:
    """(query, key) pairs the mask keeps: the work this input needs."""
    q = torch.arange(sq, dtype=torch.int64)
    hi = torch.clamp(q + 1, max=skv) if causal else torch.full_like(q, skv)
    lo = torch.clamp(q - window + 1, min=0) if window else torch.zeros_like(q)
    return int(torch.clamp(hi - lo, min=0).sum())


def attention_bound(b, sq, skv, h, kv, d, causal, window, dtype) -> tuple[float, str]:
    """Least time for one call: 4·D FLOPs per live pair at the type's peak,
    against q, k, v read once and o written once at the HBM rate."""
    flops = 4 * d * b * h * live_pairs(sq, skv, causal, window)
    nbytes = (2 * b * sq * h * d + 2 * b * skv * kv * d) * torch.finfo(dtype).bits // 8
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def ptxas_report(log: pathlib.Path) -> dict:
    """Registers per kernel instantiation and any spills, from nvcc's -Xptxas=-v log."""
    regs, spills, entry = {}, [], "?"
    for line in log.read_text().splitlines() if log.exists() else []:
        if "Compiling entry function" in line:
            cols = re.search(r"Li(\d+)E", line)  # the ⌈D/16⌉ template argument
            dtype = "bf16" if "bfloat16" in line else "f32"
            entry = f"{dtype}/NC{cols.group(1) if cols else '?'}"
        elif "Used" in line and "registers" in line:
            regs[entry] = int(re.search(r"Used (\d+) registers", line).group(1))
        elif "spill" in line and " 0 bytes spill stores, 0 bytes spill loads" not in line:
            spills.append(f"{entry}: {line.strip()}")
    return {"registers": regs, "spills": spills}


def randn_qkv(gen, b, sq, skv, h, kv, d, dtype):
    def mk(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return mk(b, sq, h, d), mk(b, skv, kv, d), mk(b, skv, kv, d)


def phase_kernels(ops) -> dict:
    """Phase 2: the flash-attention kernel against its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = []
    cases = ATTN_CASES + [(*DANUBE.values(), dt) for dt in (torch.float32, torch.bfloat16)]
    for b, sq, skv, h, kv, d, causal, window, dt in cases:
        q, k, v = randn_qkv(gen, b, sq, skv, h, kv, d, dt)
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        plain = ops.flash_attention_plain(q, k, v, causal=causal, window=window)
        err = float((out.float() - plain.float()).abs().max())
        shape = [b, sq, skv, h, kv, d, causal, window]
        checks.append({"shape": shape, "dtype": str(dt).removeprefix("torch."),
                       "max_abs_err": err, "tol": TOL[dt]})
        assert torch.isfinite(out).all(), shape
        assert err <= TOL[dt], (shape, dt, err)
    torch.cuda.synchronize()

    timed = {}
    for dt in (torch.float32, torch.bfloat16):
        s = DANUBE
        q, k, v = randn_qkv(gen, s["b"], s["sq"], s["skv"], s["h"], s["kv"], s["d"], dt)
        kw = dict(causal=s["causal"], window=s["window"])
        # the yardstick: one PyTorch call computing the same function, on
        # [B,H,S,D] copies with the KV heads repeated and the window as a mask
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        kh = kh.repeat_interleave(s["h"] // s["kv"], dim=1)
        vh = vh.repeat_interleave(s["h"] // s["kv"], dim=1)
        pos = torch.arange(s["sq"], device="cuda")
        keep = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < s["window"])
        sdpa = torch.nn.functional.scaled_dot_product_attention
        bound_ms, bound_by = attention_bound(*s.values(), dt)
        timed[dt] = {
            "ms": cuda_ms(lambda: ops.flash_attention(q, k, v, **kw), 10),
            "plain_ms": cuda_ms(lambda: ops.flash_attention_plain(q, k, v, **kw), 3),
            "library_ms": cuda_ms(lambda: sdpa(qh, kh, vh, attn_mask=keep), 10),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": next(c["max_abs_err"] for c in reversed(checks)
                                if c["dtype"] == str(dt).removeprefix("torch.")),
        }
        del q, k, v, qh, kh, vh, keep
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return {"checks": checks, "timed": timed}


def phase_prefill(get_config, tf, make_prefill, ops) -> dict:
    """Phase 3: full-width danube prefill, kernel path against the plain path."""
    dev = torch.device("cuda")
    cfg = get_config("h2o-danube-1.8b")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tf.init_params(gen, cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 4608), generator=gen, device=dev)
    batch = {"tokens": tokens}
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "tokens": list(tokens.shape),
           "params": sum(t.numel() for t in _leaves(params))}
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(compute_dtype=dtype)
        plain, plain_s = _timed(make_prefill(c, dev), params, batch)
        n0 = ops.LAUNCHES["flash_attention"]
        kern, kern_s = _timed(make_prefill(c.replace(use_pallas=True), dev), params, batch)
        launches = ops.LAUNCHES["flash_attention"] - n0
        assert launches == cfg.n_layers, launches
        assert kern.shape == (2, 4608, cfg.vocab_size) and kern.dtype == c.cdtype
        assert torch.isfinite(kern).all() and torch.isfinite(plain).all()
        kf, pf = kern.float(), plain.float()
        rel = float((kf - pf).abs().max() / pf.abs().max())
        agree = float((kf.argmax(-1) == pf.argmax(-1)).float().mean())
        out[dtype] = {"rel_max_err": rel, "tol": PREFILL_TOL[dtype], "argmax_agree": agree,
                      "kernel_prefill_s": kern_s, "plain_prefill_s": plain_s,
                      "launches_per_prefill": launches}
        print(json.dumps({"prefill": dtype, **out[dtype]}), flush=True)
        assert rel <= PREFILL_TOL[dtype], (dtype, rel)
        del plain, kern, kf, pf
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _timed(fn, *args):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = fn(*args)
    torch.cuda.synchronize()
    return y, time.perf_counter() - t0


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available; this script runs on the card only")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill
    from repro_torch.models import transformer as tf

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 products in full fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # -- phase 1: device and build ----------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "python": sys.version.split()[0]}), flush=True)
    t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    for name, path in libs.items():
        print(json.dumps({"built": name, "build_s": build_s,
                          "ptxas": ptxas_report(path.with_suffix(".log"))}), flush=True)
    torch.cuda.synchronize()

    # -- phase 2: kernels against their plain versions ---------------------
    kern = phase_kernels(ops)
    print(json.dumps({"kernel_checks": kern["checks"]}), flush=True)

    # -- phases 3 and 4: the main path --------------------------------------
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    prefill = phase_prefill(get_config, tf, make_prefill, ops)
    res = serve.main(["--arch", "h2o-danube-1.8b", "--batch", "4",
                      "--prompt-len", "64", "--gen", "32"])
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    assert res["finite"] and res["generated_shape"] == [4, 32], res
    assert res["ttft_s"] > 0 and res["tpot_s"] > 0, res
    assert all(n > 0 for n in launches.values()), launches

    bf, f32 = kern["timed"][torch.bfloat16], kern["timed"][torch.float32]
    record = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:31",
        "launches": launches["flash_attention"],
        "max_abs_err": bf["max_abs_err"], "ms": bf["ms"], "kernel_ms": bf["ms"],
        "plain_ms": bf["plain_ms"], "bound_ms": bf["bound_ms"], "bound_by": bf["bound_by"],
        "library_ms": bf["library_ms"], "dtype": "bfloat16",
        "shape": DANUBE, "fp32": f32,
    }
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"prefill": prefill, "card": smi,
                      "total_s": time.perf_counter() - t_start}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
