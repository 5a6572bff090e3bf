"""Model substrate: layers, attention, MoE, SSM blocks, and the decoder's assembly."""

from repro_torch.models.transformer import (decode_step, forward_logits,  # noqa: F401
                                            init_caches, init_params, loss_fn, segments_of)
