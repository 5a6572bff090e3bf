"""whisper-tiny [audio] — encoder-decoder backbone; conv frontend stubbed.

enc 4L + dec 4L, d_model=384 6H d_ff=1536 vocab=51865  [arXiv:2212.04356]

The encoder takes precomputed 1500-frame embeddings (the conv stem is a
stub, as in the JAX package). Sinusoidal absolute positions, GELU MLP,
LayerNorm, no RoPE — the whisper recipe.
"""

from repro_torch.configs.base import ModelConfig

ARCH_ID = "whisper-tiny"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, kind="encdec",
        n_layers=4, enc_layers=4, enc_seq_len=1500,
        d_model=384, n_heads=6, n_kv_heads=6,
        d_ff=1536, vocab_size=51865,
        use_rope=False, norm="layernorm", mlp_style="gelu",
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", kind="encdec",
        n_layers=2, enc_layers=2, enc_seq_len=24,
        d_model=48, n_heads=6, n_kv_heads=6,
        d_ff=96, vocab_size=256,
        use_rope=False, norm="layernorm", mlp_style="gelu",
        tie_embeddings=True,
    )
