"""Model substrate: layers, attention, transformer assembly (dense decoder)."""

from repro_torch.models.transformer import (decode_step, forward_logits,  # noqa: F401
                                            init_caches, init_params, loss_fn, segments_of)
