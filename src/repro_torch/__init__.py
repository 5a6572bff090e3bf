"""PyTorch / CUDA port of the ``repro`` model stack, for NVIDIA Hopper.

Mirrors the layout of the JAX package ``repro`` module for module, so a
reader can find each counterpart by name. The port imports ``torch``,
numpy and the standard library only: it keeps its own copies of what it
needs (configs, metric names) and never imports ``jax`` or ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``--device cpu`` on the command line); see :mod:`repro_torch.device`.
Every TPU kernel that the ported path runs is a hand-written CUDA C++
kernel under ``kernels/csrc/``, built with ``nvcc`` on first use.
"""
