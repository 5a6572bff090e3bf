"""Device time a call of the latent attention (the program's ``prefill/attention``
spans: MLA's projections, its latent RMSNorm, YaRN's rope, the decompression and
the dense fp32 scores), ms."""


def read(trace):
    s = trace.span_busy_s("prefill/attention")
    return 1e3 * s / trace.units if s is not None else None
