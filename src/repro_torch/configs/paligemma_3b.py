"""paligemma-3b [vlm] — SigLIP frontend (stub) + gemma-2b decoder.

18L d_model=2048 8H (MQA kv=1, head_dim=256) d_ff=16384 vocab=257216
[arXiv:2407.07726; hf]

The model takes 256 precomputed patch embeddings (the SigLIP tower is a
stub, as in the JAX package). Prefix-LM mask: bidirectional over image
tokens, causal over text — the PaliGemma recipe. GeGLU + embedding
scaling à la gemma.
"""

from repro_torch.configs.base import ModelConfig

ARCH_ID = "paligemma-3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, kind="vlm",
        n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
        d_ff=16384, vocab_size=257216,
        num_image_tokens=256,
        rope_theta=10000.0, mlp_style="geglu", norm="rmsnorm",
        scale_embeddings=True, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", kind="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=256,
        num_image_tokens=8,
        rope_theta=10000.0, mlp_style="geglu", norm="rmsnorm",
        scale_embeddings=True, tie_embeddings=True,
    )
