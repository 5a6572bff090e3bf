"""Batched serving on the port: prefill a prompt batch, decode with KV caches.

The twin of ``examples/serve_decode.py``. It drives the port's serving
driver (``repro_torch.launch.serve``) across three cache families, at their
smoke configs as the JAX example does:
  * h2o-danube  — GQA + sliding-window ring-buffer cache,
  * deepseek-v2-lite — MLA compressed latent cache,
  * zamba2      — mamba2 state + weight-shared attention caches (hybrid).

The driver's greedy loop is ``serve.generate`` (token replay of the prompt,
then argmax decode), which the tests hold against JAX's ``decode_step`` on
the same params.

Run:  PYTHONPATH=src python examples/torch_serve_decode.py [--device cpu]
(on ``cuda`` by default). Prints one JSON line per arch.
"""

from __future__ import annotations

import argparse

from repro_torch.launch import serve

ARCHS = ("h2o-danube-1.8b", "deepseek-v2-lite-16b", "zamba2-1.2b")
SERVE = ["--smoke", "--batch", "4", "--prompt-len", "12", "--gen", "16"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = {}
    for arch in ARCHS:
        print(f"\n=== {arch} (smoke config) ===", flush=True)
        out[arch] = serve.main(["--arch", arch, *SERVE, "--device", args.device])
    return out


if __name__ == "__main__":
    main()
