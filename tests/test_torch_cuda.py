"""The CUDA kernels on the card: each against its plain version, and the
wrapper's dispatch. Marked ``cuda``; without a card every test skips.
On the card: ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402

pytestmark = pytest.mark.cuda

# tests/test_kernels.py ATTN_CASES: (b, sq, skv, h, kv, d, causal, window, dtype)
ATTN_CASES = [
    (2, 128, 128, 4, 4, 64, True, None, "float32"),
    (1, 256, 256, 8, 2, 64, True, None, "bfloat16"),
    (2, 100, 100, 4, 1, 32, True, 48, "float32"),
    (1, 64, 192, 2, 2, 128, False, None, "float32"),
    (1, 160, 160, 2, 2, 80, True, None, "float32"),
    (1, 96, 96, 3, 3, 64, True, 17, "bfloat16"),
    (1, 300, 300, 8, 8, 72, False, 40, "bfloat16"),  # D not a multiple of 16, non-causal window
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("b,sq,skv,h,kv,d,causal,window,dt", ATTN_CASES)
def test_flash_attention_kernel_matches_plain(card, b, sq, skv, h, kv, d, causal, window, dt):
    gen = torch.Generator(device=card).manual_seed(0)
    dtype = getattr(torch, dt)
    q, k, v = (torch.randn(shape, generator=gen, device=card).to(dtype)
               for shape in ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d)))
    n0 = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == n0 + 1
    expect = ops.flash_attention_plain(q, k, v, causal=causal, window=window)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4  # the card sums in another order
    assert float((out.float() - expect.float()).abs().max()) <= tol


def test_flash_attention_cuda_rejects_without_plain_fallback(card):
    q = torch.zeros(1, 4, 8, 32, device=card).transpose(1, 2)  # not contiguous
    k = torch.zeros(1, 8, 2, 32, device=card)
    n0 = ops.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q, k, k, causal=True)
    assert ops.LAUNCHES["flash_attention"] == n0
