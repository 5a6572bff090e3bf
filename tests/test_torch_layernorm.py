"""The LayerNorm kernels' wrapper and its routing on the CPU: ``ops.fused_layernorm``
(plain version ``kernels.ref.reference_layernorm``) and ``layers.layernorm`` against
the plain formula the port ran before the kernels, bit for bit, and against JAX's
``repro.models.layers.layernorm`` within the layer tests' tolerances (fp32 1e-5, bf16
2e-2 of the largest value), forward and gradients. On the CPU no kernel launches;
the kernels themselves run on the card (tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

# bert's width, whisper's, xlstm's, an odd width, a row past the kernel's register hold
CASES = [((4, 8, 1024), "float32"), ((4, 8, 1024), "bfloat16"), ((3, 7, 384), "bfloat16"),
         ((2, 5, 768), "float32"), ((5, 37), "float32"), ((6, 37), "bfloat16"),
         ((2, 4104), "bfloat16")]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(shape, dt, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    w = (1 + rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    b = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, w, b, dy


def _before(x, w, b, eps=1e-5):
    """``layers.layernorm`` as the port wrote it before the kernels."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def _torch_run(fn, x, w, b, dy, dt):
    """``fn``'s output and its gradients in x, w and b under the cotangent ``dy``."""
    tx = torch.from_numpy(x).to(getattr(torch, dt)).requires_grad_()
    tw, tb = torch.from_numpy(w).requires_grad_(), torch.from_numpy(b).requires_grad_()
    y = fn(tx, tw, tb)
    gx, gw, gb = torch.autograd.grad(y, (tx, tw, tb), torch.from_numpy(dy).to(y.dtype))
    return y.detach(), gx, gw, gb


def _rel(got: torch.Tensor, expect) -> float:
    e = np.asarray(jnp.asarray(expect, jnp.float32))
    return float(np.abs(got.float().numpy() - e).max() / max(np.abs(e).max(), 1e-30))


@pytest.mark.parametrize("shape,dt", CASES)
def test_fused_layernorm_on_cpu_is_the_plain_layer_bit_for_bit(shape, dt):
    x, w, b, dy = _inputs(shape, dt)
    launches = dict(ops.LAUNCHES)
    got = _torch_run(ops.fused_layernorm, x, w, b, dy, dt)
    layer = _torch_run(tlayers.layernorm, x, w, b, dy, dt)
    before = _torch_run(_before, x, w, b, dy, dt)
    plain = _torch_run(ref.reference_layernorm, x, w, b, dy, dt)
    assert ops.LAUNCHES == launches  # a CPU tensor takes the plain version
    assert got[0].dtype == getattr(torch, dt) and got[0].shape == shape
    for a, l, p, q in zip(got, layer, before, plain):
        assert torch.equal(a, p) and torch.equal(l, p) and torch.equal(q, p)


@pytest.mark.parametrize("shape,dt", CASES)
def test_fused_layernorm_matches_jax_layer(shape, dt):
    x, w, b, dy = _inputs(shape, dt, seed=1)
    y, gx, gw, gb = _torch_run(ops.fused_layernorm, x, w, b, dy, dt)
    jx = jnp.asarray(x).astype(getattr(jnp, dt))
    jy, vjp = jax.vjp(jlayers.layernorm, jx, jnp.asarray(w), jnp.asarray(b))
    jgx, jgw, jgb = vjp(jnp.asarray(dy).astype(jy.dtype))
    for got, expect in ((y, jy), (gx, jgx), (gw, jgw), (gb, jgb)):
        assert _rel(got, expect) < TOL[dt], (shape, dt)


def test_layernorm_launch_counters_exist_and_stay_zero_on_cpu():
    assert {"layernorm_fwd", "layernorm_bwd", "layernorm_bwd_reduce"} <= set(ops.LAUNCHES)
    launches = dict(ops.LAUNCHES)
    x, w, b, dy = _inputs((8, 64), "float32", seed=2)
    _torch_run(tlayers.layernorm, x, w, b, dy, "float32")
    with torch.no_grad():
        tlayers.apply_norm("layernorm", {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                           torch.from_numpy(x))
    assert ops.LAUNCHES == launches


def test_layernorm_routes_by_what_the_input_shows(monkeypatch):
    """A plain tensor on the card takes the kernels; a CPU or meta tensor the plain
    version, with no launch and no call of the kernels' wrapper."""
    assert tlayers.on_card(torch.empty(2, 4, device="meta").as_subclass(torch.Tensor)) is False
    assert tlayers.on_card(torch.empty(2, 4)) is False

    class _OnCard:  # what the routing reads of a tensor on the card
        device = torch.device("cuda")
    assert tlayers.on_card(_OnCard()) is True

    def refuse(*a, **k):
        raise AssertionError("the kernels' wrapper was called for a tensor off the card")
    monkeypatch.setattr(ops, "fused_layernorm", refuse)
    x, w, b = (torch.empty(3, 16, device="meta"), torch.empty(16, device="meta"),
               torch.empty(16, device="meta"))
    assert tlayers.layernorm(x, w, b).shape == (3, 16)
    xs, ws, bs = (torch.from_numpy(a) for a in _inputs((3, 16), "float32", seed=3)[:3])
    assert torch.equal(tlayers.layernorm(xs, ws, bs), _before(xs, ws, bs))


def test_layernorm_of_a_dtensor_takes_the_plain_path(tmp_path, monkeypatch):
    """A tensor-parallel placement (a DTensor) keeps the plain version, even where its
    device is the card's: the kernels take plain tensors only."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    def refuse(*a, **k):
        raise AssertionError("the kernels' wrapper was called for a DTensor")
    monkeypatch.setattr(ops, "fused_layernorm", refuse)
    x, w, b, _ = _inputs((4, 32), "float32", seed=4)
    xs, ws, bs = (torch.from_numpy(a) for a in (x, w, b))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", world_size=1,
                            rank=0)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
        dx, dw, db = (distribute_tensor(t, mesh, [Replicate()]) for t in (xs, ws, bs))
        launches = dict(ops.LAUNCHES)
        out = tlayers.layernorm(dx, dw, db)
        assert isinstance(out, DTensor)
        assert torch.equal(out.to_local(), _before(xs, ws, bs))
        monkeypatch.setattr(DTensor, "device", property(lambda self: torch.device("cuda")))
        assert dx.device.type == "cuda" and tlayers.on_card(dx) is False
        assert ops.LAUNCHES == launches
    finally:
        dist.destroy_process_group()


def test_fused_layernorm_rejects_bad_inputs():
    x, w, b = torch.ones(4, 8), torch.ones(8), torch.zeros(8)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.fused_layernorm(x.half(), w, b)
    with pytest.raises(ValueError, match=r"\[8\]"):
        ops.fused_layernorm(x, torch.ones(4), b)
    with pytest.raises(ValueError, match=r"\[8\]"):
        ops.fused_layernorm(x, w, torch.zeros(2, 8))
    with pytest.raises(ValueError, match="non-empty"):
        ops.fused_layernorm(torch.ones(0, 8), w, b)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.fused_layernorm(x.to("meta"), w.to("meta"), b.to("meta"))


def test_layernorm_on_cuda_tensors_never_falls_back(monkeypatch, tmp_path):
    """A tensor on the card goes to the kernels: where they cannot be built the
    wrapper raises, and nothing falls back to the plain version."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(build, "nvcc", no_nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)  # nothing built there
    monkeypatch.setattr(ops, "_device_of", lambda *ts: "cuda")  # as if on the card
    monkeypatch.delitem(build._LOADED, "layernorm", raising=False)
    ops._layernorm_lib.cache_clear()
    launches = dict(ops.LAUNCHES)
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            ops.fused_layernorm(torch.ones(4, 8), torch.ones(8), torch.zeros(8))
    finally:
        ops._layernorm_lib.cache_clear()
    assert ops.LAUNCHES == launches
