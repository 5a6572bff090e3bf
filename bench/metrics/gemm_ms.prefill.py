"""Device time of the matmul kernels (by the name classes of ``bench/trace.py``),
ms a call."""


def read(trace):
    s, n = trace.kind_s("gemm")
    return 1e3 * s / trace.units if n else None
