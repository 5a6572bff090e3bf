"""Hand-written Hopper kernels for the perf-critical compute layers.

Each kernel ships a CUDA C++ source under ``csrc/`` (built by
:mod:`~repro_torch.kernels.build`), a wrapper in :mod:`~repro_torch.kernels.ops`
that counts its launches, and a plain PyTorch version in
:mod:`~repro_torch.kernels.ref` that the CPU path and the checks use.
"""
