"""The int8 quantize/dequantize pair: the port's plain versions (what its
kernel wrappers run on CPU tensors) against the Pallas kernels in
interpret mode (``repro.kernels.ops``) and against the jnp twins that the
JAX trainer runs (``repro.optim.grad_comm``, jitted), bit for bit, on the
sizes of tests/test_kernels.py and on exact ties and all-zero blocks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.optim import grad_comm as jgc  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.optim import grad_comm as tgc  # noqa: E402

SIZES = [256, 1000, 65536, 12345]  # tests/test_kernels.py::test_quant_roundtrip


def _normal(n: int, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(n) * 5).astype(np.float32)


def _edge_cases() -> np.ndarray:
    """Four blocks: all zeros; ties x/scale = k + ½ (amax 127 → scale 1);
    amax below the 1e-12 floor; one negative spike among small values."""
    ties = np.zeros(256, np.float32)
    ties[:10] = [127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 3.5]
    tiny = np.full(256, 1e-13, np.float32)
    tiny[1::2] = -3e-13
    spike = np.linspace(-1, 1, 256).astype(np.float32)
    spike[7] = -300.0
    return np.concatenate([np.zeros(256, np.float32), ties, tiny, spike])


CASES = [pytest.param(_normal(n, n), id=f"normal{n}") for n in SIZES]
CASES.append(pytest.param(_edge_cases(), id="zero-ties-tiny-spike"))


@pytest.mark.parametrize("x", CASES)
def test_plain_pair_equals_pallas_and_jnp_twin(x):
    n = x.size
    launches = dict(ops.LAUNCHES)
    q, s = ops.quantize_int8(torch.from_numpy(x))
    deq = ops.dequantize_int8(q, s, n)
    assert ops.LAUNCHES == launches  # CPU tensors take the plain versions
    assert q.dtype == torch.int8 and q.numel() == n + (-n) % 256
    assert s.dtype == torch.float32 and s.numel() == q.numel() // 256
    # the Pallas kernels (interpret mode) and the jnp twins as the JAX trainer
    # runs them, jitted: equal in every bit (scale = max(amax, 1e-12)·fp32(1/127),
    # as XLA compiles the reference's ``/ 127``)
    for quant, dequant in ((jops.quantize_int8, jops.dequantize_int8),
                           (jax.jit(jgc.quantize_int8),
                            jax.jit(jgc.dequantize_int8, static_argnums=2))):
        jq, js = quant(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(deq.numpy(), np.asarray(dequant(jq, js, n)))
    # the unjitted twin divides by 127 truly: the same payload, scales within an ulp
    eq, es = jgc.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(eq))
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(es), maxulp=1)
    # per-block max error ≤ scale/2 = blockmax/254
    xf = np.pad(x, (0, (-n) % 256)).reshape(-1, 256)
    errb = np.pad(np.abs(deq.numpy() - x), (0, (-n) % 256)).reshape(-1, 256)
    assert np.all(errb <= np.abs(xf).max(axis=1, keepdims=True) / 254 + 1e-6 + 1e-7)


def test_edge_blocks_quantize_as_specified():
    q, s = ops.quantize_int8(torch.from_numpy(_edge_cases()))
    q, s = q.numpy().reshape(4, 256), s.numpy()
    floor = np.float32(1e-12) * np.float32(1 / 127)
    assert s[0] == floor and not q[0].any()
    assert s[1] == np.float32(127) * np.float32(1 / 127)
    # round half to even: 0.5→0, 1.5→2, 2.5→2, −0.5→0, −1.5→−2, −2.5→−2, 126.5→126
    assert q[1, :10].tolist() == [127, 0, 2, 2, 0, -2, -2, 126, -126, 4]
    assert s[2] == floor
    assert q[3, 7] == -127


def test_rows_quantize_each_rank_on_its_own():
    """grad_comm's per-rank form pads every row to 256 separately: a block
    never spans two ranks."""
    x = np.random.default_rng(3).standard_normal((3, 300)).astype(np.float32)
    q, s = tgc.quantize_int8(torch.from_numpy(x))
    assert q.shape == (3, 512) and s.shape == (3, 2)
    for r in range(3):
        jq, js = jops.quantize_int8(jnp.asarray(x[r]))
        np.testing.assert_array_equal(q[r].numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s[r].numpy(), np.asarray(js))
        back = tgc.dequantize_int8(q, s, 300)
        assert back.shape == (3, 300)
        np.testing.assert_array_equal(back[r].numpy(),
                                      np.asarray(jops.dequantize_int8(jq, js, 300)))


def test_wrappers_reject_bad_inputs():
    with pytest.raises(TypeError, match="float32"):
        ops.quantize_int8(torch.zeros(256, dtype=torch.float64))
    with pytest.raises(ValueError, match="flat"):
        ops.quantize_int8(torch.zeros(2, 256))
    with pytest.raises(ValueError, match="non-empty"):
        ops.quantize_int8(torch.zeros(0))
    q, s = ops.quantize_int8(torch.ones(300))
    with pytest.raises(ValueError, match="scales"):
        ops.dequantize_int8(q, s[:1], 300)
    with pytest.raises(ValueError, match="n must be"):
        ops.dequantize_int8(q, s, 513)
    with pytest.raises(ValueError, match="multiple of 256"):
        ops.dequantize_int8(q[:300], s, 300)
