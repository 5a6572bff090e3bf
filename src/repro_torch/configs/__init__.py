"""Architecture registry: ``--arch <id>`` → ModelConfig.

The port registers all eleven architectures of the JAX package, in its order,
and exports the dry-run's shapes and cells (``configs.shapes``).
"""

from __future__ import annotations

from repro_torch.configs import (bert_large, codeqwen1_5_7b, dbrx_132b, deepseek_v2_lite_16b,
                                 glm4_9b, h2o_danube_1_8b, paligemma_3b, phi3_medium_14b,
                                 whisper_tiny, xlstm_125m, zamba2_1_2b)
from repro_torch.configs.base import ModelConfig  # noqa: F401
from repro_torch.configs.shapes import (SHAPES, ShapeSpec, cells_for,  # noqa: F401
                                        supports_long_context)

_MODULES = [h2o_danube_1_8b, phi3_medium_14b, codeqwen1_5_7b, glm4_9b, dbrx_132b,
            deepseek_v2_lite_16b, xlstm_125m, whisper_tiny, zamba2_1_2b, paligemma_3b,
            bert_large]

REGISTRY: dict[str, object] = {m.ARCH_ID: m for m in _MODULES}

#: the ten assigned architectures (bert-large is the paper's own extra)
ASSIGNED: tuple[str, ...] = tuple(m.ARCH_ID for m in _MODULES[:10])


def get_config(arch_id: str) -> ModelConfig:
    try:
        return REGISTRY[arch_id].config()
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(REGISTRY)}")


def get_smoke_config(arch_id: str) -> ModelConfig:
    try:
        return REGISTRY[arch_id].smoke_config()
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(REGISTRY)}")
