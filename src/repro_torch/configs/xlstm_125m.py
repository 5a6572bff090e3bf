"""xlstm-125m [ssm] — sLSTM + mLSTM blocks, recurrent decode.

12L d_model=768 4H vocab=50304  [arXiv:2405.04517]

Pattern follows the paper's mostly-mLSTM mixing (sLSTM at positions 3, 9).
Pure recurrence → O(1) decode state.
"""

from repro_torch.configs.base import ModelConfig

ARCH_ID = "xlstm-125m"


def _pattern(n: int, slstm_at=(3, 9)) -> tuple[str, ...]:
    return tuple("slstm" if i in slstm_at else "mlstm" for i in range(n))


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=50304,
        block_pattern=_pattern(12),
        xlstm_expand=2,
        use_rope=False, norm="layernorm", mlp_style="gelu",
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=256,
        block_pattern=_pattern(4, slstm_at=(1, 3)),
        xlstm_expand=2,
        use_rope=False, norm="layernorm", mlp_style="gelu",
        tie_embeddings=True,
    )
