"""The port's configs as the JAX package has them, for the tests that hold the
port against it.

The port's ``deepseek-v2-lite-16b`` is the published model: the latent's
RMSNorm, YaRN, the top-6 gates as the softmax gives them, dropless routing and
bf16 weights. The JAX package's leaves those out. ``TWIN`` is the one list of
the fields in which the port's configs depart from their JAX twins, with the
twins' values; :func:`twin_config` gives that view. The port's fields that
the JAX package lacks (``PORT_ONLY``) hold their defaults in every other
config and in every smoke config (:func:`assert_converts`).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig

#: arch → {field: the JAX twin's value} where the port's config departs from it
TWIN = {"deepseek-v2-lite-16b": dict(
    mla_kv_norm=False, yarn_factor=None, yarn_original_max_position_embeddings=0,
    yarn_mscale=1.0, yarn_mscale_all_dim=0.0, moe_norm_topk_prob=True,
    moe_capacity_factor=1.25, param_dtype="float32")}

#: the port's fields that the JAX package's ModelConfig lacks
PORT_ONLY = ("mla_kv_norm", "yarn_factor", "yarn_original_max_position_embeddings",
             "yarn_beta_fast", "yarn_beta_slow", "yarn_mscale", "yarn_mscale_all_dim",
             "moe_norm_topk_prob")


def twin_config(arch: str) -> ModelConfig:
    """``get_config(arch)`` as the JAX package has it."""
    return get_config(arch).replace(**TWIN.get(arch, {}))


def assert_converts(port: ModelConfig, jax_cfg) -> None:
    """``port`` equals ``jax_cfg`` in every field the JAX package has, and holds
    the default in each of the port's own."""
    names = [f.name for f in dataclasses.fields(jax_cfg)]
    assert {n: getattr(port, n) for n in names} == {n: getattr(jax_cfg, n) for n in names}
    own = {f.name: f.default for f in dataclasses.fields(port) if f.name not in names}
    assert set(own) == set(PORT_ONLY)
    assert {n: getattr(port, n) for n in own} == own
