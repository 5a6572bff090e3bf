"""The RMSNorm kernel's wrapper and plain version against the JAX package:
``ops.fused_rmsnorm`` (the Pallas kernel in interpret mode), its plain
version ``kernels.ref.reference_rmsnorm`` and ``layers.rmsnorm``, at the
cases of tests/test_kernels.py (fp32 within 1e-5, bf16 within 2e-2). On
the CPU the port's wrapper runs its plain version; the kernel itself runs
on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

# tests/test_kernels.py's cases, plus an odd width and the overlap consumer's rows
CASES = [((4, 37, 512), "float32"), ((2, 130, 768), "bfloat16"), ((1, 1, 2048), "float32"),
         ((512, 64), "float32"), ((5, 37), "float32"), ((64, 128), "float32")]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(shape, dt, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal(shape[-1]) * 0.2).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dt))
    tx = torch.from_numpy(x).to(getattr(torch, dt))
    return jx, jnp.asarray(w), tx, torch.from_numpy(w)


def _err(got: torch.Tensor, expect) -> float:
    return float(np.abs(got.float().numpy() - np.asarray(expect, np.float32)).max())


@pytest.mark.parametrize("shape,dt", CASES)
def test_fused_rmsnorm_matches_pallas_kernel(shape, dt):
    jx, jw, tx, tw = _inputs(shape, dt)
    launches = dict(ops.LAUNCHES)
    got = ops.fused_rmsnorm(tx, tw)
    assert ops.LAUNCHES == launches  # a CPU tensor takes the plain version
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert _err(got, jops.fused_rmsnorm(jx, jw).astype(jnp.float32)) < TOL[dt]
    assert _err(ref.reference_rmsnorm(tx, tw), jref.reference_rmsnorm(jx, jw)
                .astype(jnp.float32)) < TOL[dt]


@pytest.mark.parametrize("shape,dt", CASES)
def test_fused_rmsnorm_matches_model_layer(shape, dt):
    jx, jw, tx, tw = _inputs(shape, dt, seed=1)
    got = ops.fused_rmsnorm(tx, tw)
    assert _err(got, jlayers.rmsnorm(jx, jw).astype(jnp.float32)) < TOL[dt]
    torch.testing.assert_close(got, tlayers.rmsnorm(tx, tw), rtol=0, atol=0)


def test_fused_rmsnorm_rejects_bad_inputs():
    x, w = torch.ones(4, 8), torch.zeros(8)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.fused_rmsnorm(x.half(), w)
    with pytest.raises(ValueError, match=r"float32 \[8\]"):
        ops.fused_rmsnorm(x, w.bfloat16())
    with pytest.raises(ValueError, match=r"float32 \[8\]"):
        ops.fused_rmsnorm(x, torch.zeros(4))
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_rmsnorm(torch.ones(8, 4).t(), w)
    with pytest.raises(ValueError, match="non-empty"):
        ops.fused_rmsnorm(torch.ones(0, 8), w)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.fused_rmsnorm(x.to("meta"), w.to("meta"))


def test_rmsnorm_on_cuda_tensors_never_falls_back(monkeypatch, tmp_path):
    """A tensor on the card goes to the kernel: where it cannot be built the
    wrapper raises, and nothing falls back to the plain version."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(build, "nvcc", no_nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)  # nothing built there
    monkeypatch.setattr(ops, "_device_of", lambda *ts: "cuda")  # as if on the card
    monkeypatch.delitem(build._LOADED, "rmsnorm", raising=False)
    ops._rmsnorm_lib.cache_clear()
    launches = dict(ops.LAUNCHES)
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            ops.fused_rmsnorm(torch.ones(4, 8), torch.zeros(8))
    finally:
        ops._rmsnorm_lib.cache_clear()
    assert ops.LAUNCHES == launches
