#!/usr/bin/env python3
"""Router near-ties at a prefill cell's checked calls: where the program, in the
cell's precision, sends a token to another expert than the plain fp32 reference.

    python3 tools/router_ties.py --workload deepseek-v2-lite-16b.prefill-b2-s4096 \\
        --seed 11,12,13 [--device cuda]

For each seed it draws what the benchmark's prefill driver checks (the ring of
prompts, the calls chosen from the seed, the weights), runs the program's
prefill on those calls and the configuration's reference (``bench/references``)
over each of their prompts in fp32 with TF32 off, and records every MoE layer's
top-k choice of every token on both sides. A (token, layer) pair "flips" where
the two choose different sets. It prints per seed the pairs judged, the flipped
pairs, the tokens with a flip in any layer, the reference's gap between its
k-th and (k+1)-th probability at the flipped pairs (largest), and the pairs
whose reference gap lies under 1e-3 and under 1e-4, and each MoE layer's
largest expert load over the mean in the program (pairs per expert, over the
checked calls). A flip upstream moves the hidden state of that token, so later
layers' flips of the same token are counted too. The last line of stdout is
one JSON object: seed → counts.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def choices(run_ref, k: int) -> list[torch.Tensor]:
    """The top-k sets and the k-th gap of every MoE call inside ``run_ref()``:
    ``[(sorted idx [T, k], gap [T])]`` in call order."""
    out = []

    def record(probs):
        top = torch.topk(probs.float(), k + 1, dim=-1)
        idx = top.indices[..., :k].reshape(-1, k).sort(-1).values
        gap = (top.values[..., k - 1] - top.values[..., k]).reshape(-1)
        out.append((idx, gap))
    run_ref(record)
    return out


def program_choices(prefill, weights, tokens, moe_lib, k: int):
    pick = moe_lib.top_k_lowest_index_first

    def run(record):
        def recorded(probs, kk):
            record(probs)
            return pick(probs, kk)
        moe_lib.top_k_lowest_index_first = recorded
        try:
            prefill(weights, {"tokens": tokens})
        finally:
            moe_lib.top_k_lowest_index_first = pick
    return choices(run, k)


def reference_choices(model, weights, tokens, cfg: dict, q_rows: int, k: int):
    ref_globals = model.forward.__globals__
    moe = ref_globals["_moe"]

    def run(record):
        def recorded(c, p, x, prec):
            record(torch.softmax(prec.mm(x.reshape(-1, x.shape[-1]), p["router"]), dim=-1))
            return moe(c, p, x, prec)
        ref_globals["_moe"] = recorded
        try:
            for i in range(tokens.shape[0]):  # one prompt at a time, as the check
                ref_globals["hidden"](weights, tokens[i:i + 1], cfg, q_rows=q_rows)
        finally:
            ref_globals["_moe"] = moe
    per_call = choices(run, k)
    layers = len(per_call) // tokens.shape[0]  # prompt-major: regroup by layer
    return [(torch.cat([per_call[i * layers + l][0] for i in range(tokens.shape[0])]),
             torch.cat([per_call[i * layers + l][1] for i in range(tokens.shape[0])]))
            for l in range(layers)]


def one_seed(cell, seed: int, dev) -> dict:
    from bench import data, reference
    from bench.harness import model_parts, program_config
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import moe as moe_lib
    cfg, tr = cell.cfg, cell.traffic
    k = cfg["num_experts_per_tok"]
    prefill = steps_lib.make_prefill(program_config(cfg, use_pallas=tr["use_pallas"]),
                                     device=dev)
    model = model_parts(cfg)
    weights = data.make_weights(cfg, seed, dev, model.weight_shapes(cfg))
    chosen = sorted(random.Random(seed).sample(range(tr["sample_from"]), tr["sample_calls"]))
    out = {"pairs": 0, "flipped_pairs": 0, "flipped_tokens": 0, "largest_gap_flipped": 0.0,
           "ref_gap_under_1e-3": 0, "ref_gap_under_1e-4": 0}
    loads = None
    for c in chosen:
        tokens = data.tokens(cfg, tr["tokens"], seed, c % tr["ring"], tr["batch"],
                             tr["prompt_len"]).to(dev)
        prog = program_choices(prefill, weights, tokens, moe_lib, k)
        with reference.exact_fp32(), torch.inference_mode():
            ref = reference_choices(model, weights, tokens, cfg, tr["reference_rows"], k)
        assert len(prog) == len(ref), (len(prog), len(ref))
        n = torch.stack([torch.bincount(pi.reshape(-1), minlength=cfg["n_routed_experts"])
                         for pi, _ in prog])  # [layers, experts]
        loads = n if loads is None else loads + n
        flipped_any = torch.zeros(tokens.numel(), dtype=torch.bool, device=dev)
        for (pi, _), (ri, rgap) in zip(prog, ref):
            flip = (pi != ri).any(-1)
            flipped_any |= flip
            out["pairs"] += flip.numel()
            out["flipped_pairs"] += int(flip.sum())
            if flip.any():
                out["largest_gap_flipped"] = max(out["largest_gap_flipped"],
                                                 float(rgap[flip].max()))
            out["ref_gap_under_1e-3"] += int((rgap < 1e-3).sum())
            out["ref_gap_under_1e-4"] += int((rgap < 1e-4).sum())
        out["flipped_tokens"] += int(flipped_any.sum())
    loads = loads.float()
    out["load_max_over_mean"] = [round(float(x), 3) for x in loads.amax(1) / loads.mean(1)]
    del weights, prefill
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", required=True, help="seeds, comma-separated")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from bench import harness
    cell = harness.load_cell(args.workload)
    if cell.traffic["driver"] != "prefill" or "num_experts_per_tok" not in cell.cfg:
        sys.exit(f"{args.workload}: not a prefill cell of a mixture of experts")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for seed in (int(s) for s in args.seed.split(",")):
        out[seed] = one_seed(cell, seed, torch.device(args.device))
        print(json.dumps({seed: out[seed]}), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
