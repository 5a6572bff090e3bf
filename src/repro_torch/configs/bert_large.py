"""bert-large — the paper's own end-to-end evaluation model (Fig 4a).

24L d_model=1024 16H d_ff=4096 vocab=30522 (333,344,768 params).

The data-parallel gradient buckets of this model are the "many small
AllReduce buffers" whose α-dominated cost the paper's Fig 4a argument
rests on. It trains as a causal LM, as in the JAX package; the per-bucket
gradient bytes are the same as under the MLM objective.
"""

from repro_torch.configs.base import ModelConfig

ARCH_ID = "bert-large"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab_size=30522,
        use_rope=False, norm="layernorm", mlp_style="gelu",
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256,
        use_rope=False, norm="layernorm", mlp_style="gelu",
        tie_embeddings=True,
    )
