"""The CUDA kernels on the card: each against its plain version, and the
wrapper's dispatch. Marked ``cuda``; without a card every test skips.
On the card: ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``."""

import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

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
# the bf16 (tensor-core) twin of every fp32 case above, and danube's heads at a short S
ATTN_CASES += [(*c[:-1], "bfloat16") for c in ATTN_CASES if c[-1] == "float32"]
ATTN_CASES += [(2, 320, 320, 32, 8, 80, True, 256, "bfloat16")]
# dbrx's heads (48 query / 8 KV of 128, causal, no window) at a short S
ATTN_CASES += [(1, 512, 512, 48, 8, 128, True, None, dt) for dt in ("bfloat16", "float32")]
# zamba2's shared block (32/32 heads of 64) and glm4's GQA of 16 (32/2 heads of 128)
ATTN_CASES += [(1, 512, 512, h, kv, d, True, None, dt)
               for h, kv, d in ((32, 32, 64), (32, 2, 128)) for dt in ("bfloat16", "float32")]
# whisper-tiny's encoder: bidirectional, no window, 6/6 heads of 64 at its 1500 frames
# (neither a multiple of the 64-key tile nor of the 192-row query block)
ATTN_CASES += [(2, 1500, 1500, 6, 6, 64, False, None, dt) for dt in ("bfloat16", "float32")]
# bidirectional, no window, Skv ragged against the 64-key tile: only the Skv mask
# guards the last tile, and an unmasked tail of zero keys would dominate the output
ATTN_CASES += [(b, s, s, h, h, 64, False, None, dt) for b, s, h in ((2, 100, 4), (1, 70, 2))
               for dt in ("bfloat16", "float32")]


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


@pytest.mark.parametrize("dt,limit", [("bfloat16", 5e-3), ("float32", 1e-4)])
def test_flash_attention_masks_the_ragged_key_tail(card, dt, limit):
    """Whisper's encoder shape: 1500 keys, so the last 64-key tile holds 36
    zeros past Skv. Each would add exp(0 - max) to a row's softmax sum if the
    tile were unmasked, shrinking every output by ~1.4 %. Relative to the
    output's RMS the kernel stays within ``limit`` of its plain version, and
    the plain version over the zero-padded keys (the unmasked answer) does not."""
    gen = torch.Generator(device=card).manual_seed(2)
    dtype = getattr(torch, dt)
    q, k, v = (torch.randn((2, 1500, 6, 64), generator=gen, device=card).to(dtype)
               for _ in range(3))
    out = ops.flash_attention(q, k, v, causal=False).float()
    expect = ops.flash_attention_plain(q, k, v, causal=False).float()
    kp, vp = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 36)) for t in (k, v))
    unmasked = ops.flash_attention_plain(q, kp, vp, causal=False).float()
    assert float((unmasked - expect).norm() / expect.norm()) > limit
    assert float((out - expect).norm() / expect.norm()) <= limit


def test_flash_attention_rows_with_no_live_key_are_zero(card):
    """Sq = 300 against Skv = 100, causal, window 48: rows 147 on see no key.
    The kernel writes 0 there (the plain version averages v); the rest agree."""
    gen = torch.Generator(device=card).manual_seed(1)
    q, k, v = (torch.randn(shape, generator=gen, device=card).to(torch.bfloat16)
               for shape in ((1, 300, 4, 80), (1, 100, 2, 80), (1, 100, 2, 80)))
    out = ops.flash_attention(q, k, v, causal=True, window=48).float()
    expect = ops.flash_attention_plain(q, k, v, causal=True, window=48).float()
    qi = torch.arange(300, device=card)
    dead = qi - 47 > 99  # no key in [q − 47, q] ∩ [0, 100)
    assert int(dead.sum()) == 153
    assert bool((out[:, dead] == 0).all())
    assert float((out[:, ~dead] - expect[:, ~dead]).abs().max()) <= 2e-2


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_flash_attention_cuda_rejects_misaligned_views(card, which):
    shapes = {"q": (1, 64, 4, 80), "k": (1, 64, 2, 80), "v": (1, 64, 2, 80)}
    t = {n: torch.randn(s, device=card).to(torch.bfloat16) for n, s in shapes.items()}
    buf = torch.zeros(1 + t[which].numel(), dtype=torch.bfloat16, device=card)
    t[which] = buf.flatten()[1:].view(shapes[which])  # contiguous, 2 bytes off a boundary
    n0 = ops.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="16-byte"):
        ops.flash_attention(t["q"], t["k"], t["v"], causal=True)
    assert ops.LAUNCHES["flash_attention"] == n0


def test_flash_attention_cuda_rejects_without_plain_fallback(card):
    q = torch.zeros(1, 4, 8, 32, device=card).transpose(1, 2)  # not contiguous
    k = torch.zeros(1, 8, 2, 32, device=card)
    n0 = ops.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q, k, k, causal=True)
    assert ops.LAUNCHES["flash_attention"] == n0


# -- int8 gradient compression ----------------------------------------------

def _quant_inputs(n: int, seed: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, generator=gen) * 5
    if n >= 1024:  # an all-zero block and exact .5 ties (amax 127 → scale 1)
        x[:256] = 0
        x[256:512] = 0.0
        x[256:266] = torch.tensor([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 3.5])
    return x


@pytest.mark.parametrize("n", [256, 1000, 65536, 12345, 6_553_600])
def test_int8_kernels_bit_exact_against_plain(card, n):
    x = _quant_inputs(n, n)
    n0 = dict(ops.LAUNCHES)
    q, s = ops.quantize_int8(x.to(card))
    deq = ops.dequantize_int8(q, s, n)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["quantize_int8"] == n0["quantize_int8"] + 1
    assert ops.LAUNCHES["dequantize_int8"] == n0["dequantize_int8"] + 1
    pq, ps = ops.quantize_int8(x)  # the plain versions, on the CPU
    assert torch.equal(q.cpu(), pq) and torch.equal(s.cpu(), ps)
    assert torch.equal(deq.cpu(), ops.dequantize_int8(pq, ps, n))


def test_int8_kernels_take_unaligned_views(card):
    x = _quant_inputs(4096, 1).to(card)
    q, s = ops.quantize_int8(x[3:3 + 2560])  # 12 bytes past a boundary, no padding
    pq, ps = ops.quantize_int8(x[3:3 + 2560].cpu())
    assert torch.equal(q.cpu(), pq) and torch.equal(s.cpu(), ps)
    out = ops.dequantize_int8(q[256:], s[1:], 2300)  # q starts 256 B in
    assert torch.equal(out.cpu(), ops.dequantize_int8(pq[256:], ps[1:], 2300))


def test_virtual_rank_collectives_on_card_equal_cpu(card):
    from repro_torch.core import collectives
    from repro_torch.optim import grad_comm
    gen = torch.Generator().manual_seed(0)
    for p in (2, 4, 8):
        x = torch.randn(p, 40_001, generator=gen) * 100
        for algo in ("ring", "lumorph2", "lumorph4", "tree"):
            got = collectives.all_reduce(x.to(card), algo)
            assert torch.equal(got.cpu(), collectives.all_reduce(x, algo)), (algo, p)
        n0 = ops.LAUNCHES["quantize_int8"]
        got = grad_comm.compressed_all_reduce(x.to(card))
        assert ops.LAUNCHES["quantize_int8"] == n0 + 2 * p.bit_length() - 2  # one per hop
        assert torch.equal(got.cpu(), grad_comm.compressed_all_reduce(x)), p


# -- fused RMSNorm -------------------------------------------------------------

# tests/test_kernels.py's cases, odd widths (scalar path), the overlap consumer's
# rows and danube's prefill rows
RMS_CASES = [((4, 37, 512), "float32"), ((2, 130, 768), "bfloat16"), ((1, 1, 2048), "float32"),
             ((512, 64), "float32"), ((5, 37), "float32"), ((3, 100), "bfloat16"),
             ((4096, 128), "float32"), ((2 * 4608, 2560), "bfloat16")]


@pytest.mark.parametrize("shape,dt", RMS_CASES)
def test_rmsnorm_kernel_matches_plain(card, shape, dt):
    gen = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=card).to(getattr(torch, dt))
    w = torch.randn(shape[-1], generator=gen, device=card) * 0.2
    n0 = ops.LAUNCHES["rmsnorm"]
    out = ops.fused_rmsnorm(x, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rmsnorm"] == n0 + 1
    assert out.dtype == x.dtype and out.shape == x.shape
    expect = ref.reference_rmsnorm(x, w).float()
    limit = torch.full_like(expect, 2e-2 if dt == "bfloat16" else 1e-5)  # test_kernels.py's
    if dt == "bfloat16":  # or one bf16 ulp, where a value rounds to the neighbouring bf16
        limit = torch.maximum(limit, torch.exp2(torch.floor(torch.log2(
            expect.abs().clamp(min=2.0 ** -126))) - 7))
    assert bool(((out.float() - expect).abs() <= limit).all())


def test_rmsnorm_kernel_takes_unaligned_rows(card):
    buf = torch.randn(1 + 64 * 128, device=card)
    x = buf[1:].view(64, 128)  # contiguous, 4 bytes past a 16-byte boundary
    w = torch.randn(128, device=card) * 0.2
    expect = ref.reference_rmsnorm(x, w)
    assert float((ops.fused_rmsnorm(x, w) - expect).abs().max()) <= 1e-5


def test_overlapped_rmsnorm_pipeline_on_card_equals_cpu(card):
    from repro_torch.core import collectives
    x = torch.randn(8, 1 << 15, generator=torch.Generator().manual_seed(3))
    w = torch.zeros(128)

    def consumer(wt):
        return lambda y: ops.fused_rmsnorm(y.reshape(-1, 128), wt).reshape(y.shape)
    n0 = ops.LAUNCHES["rmsnorm"]
    got = collectives.overlapped_all_reduce(x.to(card), "lumorph2", 4,
                                            compute=consumer(w.to(card)))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rmsnorm"] == n0 + 4  # one launch per chunk covers every rank
    cpu = collectives.overlapped_all_reduce(x, "lumorph2", 4, compute=consumer(w))
    assert float((got.cpu() - cpu).abs().max()) <= 1e-5
    mono = collectives.overlapped_all_reduce(x.to(card), "lumorph2", 1)
    assert torch.equal(mono, collectives.all_reduce(x.to(card), "lumorph2"))


# -- the MoE and MLA block kinds --------------------------------------------------

@pytest.mark.parametrize("cf,dt", [(1.25, "float32"), (0.5, "float32"), (1.25, "bfloat16")])
def test_apply_moe_on_card_equals_cpu(card, cf, dt):
    """Top-k, the stable argsort, ``searchsorted`` and ``index_add_`` route the
    same assignments on the card as on the CPU (deepseek smoke widths; cf 0.5
    drops assignments)."""
    from repro_torch.models import moe
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, 64, 32, 8, 2, dtype=getattr(torch, dt))
    x = torch.randn(2, 16, 64, generator=gen).to(getattr(torch, dt))
    y_cpu, aux_cpu = moe.apply_moe(p, x, 2, cf)
    y, aux = moe.apply_moe(_to(p, card), x.to(card), 2, cf)
    tol = 2e-2 if dt == "bfloat16" else 1e-5
    rel = float((y.cpu().float() - y_cpu.float()).abs().max() / y_cpu.float().abs().max())
    assert rel <= tol
    assert abs(float(aux) - float(aux_cpu)) <= 1e-5 * float(aux_cpu)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "dbrx-132b"])
def test_moe_and_mla_smoke_models_on_card_equal_cpu(card, arch):
    """The smoke model's prefill on the card against its CPU run (fp32); dbrx's
    attention goes through the flash kernel, once per layer."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tf
    cfg = get_smoke_config(arch).replace(compute_dtype="float32",
                                         use_pallas=arch == "dbrx-132b")
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(1))
    expect, aux_cpu = tf.forward_logits(params, {"tokens": toks}, cfg)
    moved = _to(params, card)
    n0 = ops.LAUNCHES["flash_attention"]
    with torch.no_grad():
        got, aux = tf.forward_logits(moved, {"tokens": toks.to(card)}, cfg)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == n0 + (cfg.n_layers if cfg.use_pallas else 0)
    rel = float((got.cpu() - expect).abs().max() / expect.abs().max())
    assert rel <= 1e-4
    assert abs(float(aux) - float(aux_cpu)) <= 1e-5 * float(aux_cpu)


# -- the SSM and hybrid block kinds, and the dense trio ----------------------------

@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-125m", "phi3-medium-14b",
                                  "codeqwen1.5-7b", "glm4-9b"])
def test_ssm_and_dense_smoke_models_on_card_equal_cpu(card, arch):
    """The smoke model's prefill (fp32, the flash kernel on) and its decode
    steps on the card against the CPU: zamba2 launches the kernel once per
    shared call site (2), the dense trio once per layer, xlstm never."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tf
    cfg = get_smoke_config(arch).replace(compute_dtype="float32", use_pallas=True)
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 21), generator=torch.Generator().manual_seed(1))
    expect, _ = tf.forward_logits(params, {"tokens": toks}, cfg)
    moved = _to(params, card)
    n0 = ops.LAUNCHES["flash_attention"]
    with torch.no_grad():
        got, _ = tf.forward_logits(moved, {"tokens": toks.to(card)}, cfg)
    torch.cuda.synchronize()
    sites = tf.cache_layout(cfg).count("shared")
    attn_layers = sum(k == "dense" for k in cfg.block_pattern)
    assert ops.LAUNCHES["flash_attention"] == n0 + sites + attn_layers
    assert float((got.cpu() - expect).abs().max() / expect.abs().max()) <= 1e-4
    c_cpu, c_card = tf.init_caches(cfg, 2, 8), tf.init_caches(cfg, 2, 8, card)
    with torch.no_grad():
        for t in range(8):
            l_cpu, c_cpu = tf.decode_step(params, c_cpu, toks[:, t:t + 1], t, cfg)
            l_card, c_card = tf.decode_step(moved, c_card, toks[:, t:t + 1].to(card), t, cfg)
            rel = float((l_card.cpu() - l_cpu).abs().max() / l_cpu.abs().max())
            assert rel <= 1e-4, t


# one rank of a world on the card: the cross-process executor against the
# virtual-rank executor on the same inputs, every rank's row bit for bit
EXECUTOR_RANK = r"""
import sys
import torch
import torch.distributed as dist
sys.path.insert(0, {src!r})
from repro_torch.core import collectives as V, collectives_dist as D
from repro_torch.kernels import ops
from repro_torch.launch.mesh import init_process_mesh
from repro_torch.optim import grad_comm
rank, world = int(sys.argv[1]), {world}
mesh = init_process_mesh("cuda", {backend!r}, init_method="file://" + {rdzv!r}, rank=rank,
                         world_size=world)
x = torch.randn(world, 100_003, generator=torch.Generator(device=mesh.device).manual_seed(0),
                device=mesh.device)
for algo in ("ring", "lumorph2", "lumorph4", "tree"):
    assert torch.equal(D.all_reduce(x[rank], algo), V.all_reduce(x, algo)[rank]), algo
got = D.all_reduce(x[rank], "psum")
assert float((got - x.sum(0)).abs().max() / x.sum(0).abs().max()) <= 1e-6
assert torch.equal(grad_comm.compressed_all_reduce(x[rank], group=mesh.group),
                   grad_comm.compressed_all_reduce(x)[rank])
w = torch.zeros(128, device=mesh.device)
compute = lambda y: ops.fused_rmsnorm(y.reshape(-1, 128), w).reshape(y.shape)
n0 = ops.LAUNCHES["rmsnorm"]
got = D.overlapped_all_reduce(x[rank, :512 * 195], "lumorph2", 4, compute)
assert ops.LAUNCHES["rmsnorm"] == n0 + 4
assert torch.equal(got, V.overlapped_all_reduce(x[:, :512 * 195], "lumorph2", 4, compute)[rank])
dist.destroy_process_group()
"""


@pytest.mark.parametrize("backend,world", [("nccl", 2), ("gloo", 4)])
def test_cross_process_executor_on_cards_equals_virtual_ranks(card, tmp_path, backend, world):
    """nccl needs a card per rank, so it runs only where two or more are
    visible; gloo stages every payload through host memory and runs four
    ranks on one card. Each world runs under a timeout: a hang fails."""
    if backend == "nccl" and torch.cuda.device_count() < world:
        pytest.skip(f"nccl needs {world} cards, {torch.cuda.device_count()} visible")
    code = EXECUTOR_RANK.format(src=str(pathlib.Path(__file__).resolve().parents[1] / "src"),
                                world=world, backend=backend, rdzv=str(tmp_path / "rdzv"))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], stderr=subprocess.PIPE,
                              text=True, env={**os.environ, "OMP_NUM_THREADS": "1"})
             for r in range(world)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"


# one rank of a (1, 2) tensor-parallel mesh on the card: danube's smoke prefill
# through the flash kernel on each rank's own heads, against the kernel path of
# one process over the full params
TP_PREFILL_RANK = r"""
import sys
import torch
import torch.distributed as dist
sys.path.insert(0, {src!r})
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch.mesh import init_process_mesh, split_model_axis
from repro_torch.launch.steps import make_prefill
from repro_torch.models import transformer as tf
from repro_torch.sharding.policy import gather_tree, make_policy
rank = int(sys.argv[1])
mesh = split_model_axis(init_process_mesh("cuda", {backend!r}, init_method="file://" + {rdzv!r},
                                          rank=rank, world_size=2), 1)
gen = torch.Generator(device=mesh.device).manual_seed(0)
cfg = get_smoke_config("h2o-danube-1.8b")
params = tf.init_params(gen, cfg)
tokens = torch.randint(0, cfg.vocab_size, (2, 96), generator=gen, device=mesh.device)
for dtype, tol in (("float32", 1e-4), ("bfloat16", 5e-2)):
    c = cfg.replace(compute_dtype=dtype, use_pallas=True)
    expect = make_prefill(c, mesh.device)(params, {{"tokens": tokens}}).float()
    n0 = ops.LAUNCHES["flash_attention"]
    got = gather_tree(make_prefill(c, mesh.device, make_policy(c, mesh), mesh)(
        params, {{"tokens": tokens}})).float()
    assert ops.LAUNCHES["flash_attention"] == n0 + cfg.n_layers, dtype  # on its own heads
    rel = float((got - expect).abs().max() / expect.abs().max())
    assert rel <= tol, (dtype, rel)
dist.destroy_process_group()
"""


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_tensor_parallel_prefill_on_cards_equals_one_process(card, tmp_path, backend):
    """2 ranks as a (1, 2) mesh: gloo (host-staged) on one card; nccl only
    where two cards are visible. Under a timeout: a hang fails."""
    if backend == "nccl" and torch.cuda.device_count() < 2:
        pytest.skip(f"nccl needs 2 cards, {torch.cuda.device_count()} visible")
    code = TP_PREFILL_RANK.format(src=str(pathlib.Path(__file__).resolve().parents[1] / "src"),
                                  backend=backend, rdzv=str(tmp_path / "rdzv"))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], stderr=subprocess.PIPE,
                              text=True, env={**os.environ, "OMP_NUM_THREADS": "1"})
             for r in range(2)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"


# one rank of a (1, 2) mesh on the card over gloo: danube's smoke decode with the
# caches placed by the policy (KV heads over model), every step's logits against
# one process's decode of the same params and tokens
TP_DECODE_RANK = r"""
import sys
import torch
import torch.distributed as dist
sys.path.insert(0, {src!r})
from repro_torch.configs import get_smoke_config
from repro_torch.launch import steps
from repro_torch.launch.mesh import init_process_mesh, split_model_axis
from repro_torch.models import transformer as tf
from repro_torch.sharding.policy import gather_tree, make_policy
rank = int(sys.argv[1])
mesh = split_model_axis(init_process_mesh("cuda", "gloo", init_method="file://" + {rdzv!r},
                                          rank=rank, world_size=2), 1)
gen = torch.Generator(device=mesh.device).manual_seed(0)
cfg = get_smoke_config("h2o-danube-1.8b")
params = tf.init_params(gen, cfg)
b, n = 2, 24  # past the 16-slot window: the ring wraps
tokens = torch.randint(0, cfg.vocab_size, (b, n), generator=gen, device=mesh.device)
for dtype, kv, tol in (("float32", "bfloat16", 1e-4), ("bfloat16", "bfloat16", 5e-2),
                       ("bfloat16", "int8", 5e-2)):
    c = cfg.replace(compute_dtype=dtype, kv_cache_dtype=kv)
    one, caches = steps.make_decode_step(c, mesh.device), tf.init_caches(c, b, n, mesh.device)
    policy = make_policy(c, mesh)
    placed = steps.make_decode_step(c, mesh.device, policy, mesh, b, n)
    pcaches = steps.init_placed_caches(c, policy, mesh, b, n)
    for t in range(n):
        expect, caches = one(params, caches, tokens[:, t:t + 1], t)
        got, pcaches = placed(params, pcaches, tokens[:, t:t + 1], t)
        got = gather_tree(got).float()
        rel = float((got - expect.float()).abs().max() / expect.float().abs().max())
        assert rel <= tol, (dtype, kv, t, rel)
    assert pcaches[0]["k"].to_local().shape == (b, 16, cfg.n_kv_heads // 2, cfg.head_dim)
dist.destroy_process_group()
"""


def test_placed_decode_on_card_equals_one_process(card, tmp_path):
    """2 ranks as a (1, 2) mesh over gloo (host-staged) on one card, under a
    timeout: a hang fails."""
    _two_ranks(TP_DECODE_RANK, tmp_path)


# one rank of a (1, 2) mesh on the card over gloo: deepseek-v2-lite's smoke decode (MLA
# with c_kv's sequence over model, experts over model), fp32, every step's logits
# against one process's decode of the same params and tokens
MLA_MOE_DECODE_RANK = r"""
import sys
import torch
import torch.distributed as dist
sys.path.insert(0, {src!r})
from repro_torch.configs import get_smoke_config
from repro_torch.launch import steps
from repro_torch.launch.mesh import init_process_mesh, split_model_axis
from repro_torch.models import transformer as tf
from repro_torch.sharding.policy import gather_tree, make_policy
rank = int(sys.argv[1])
mesh = split_model_axis(init_process_mesh("cuda", "gloo", init_method="file://" + {rdzv!r},
                                          rank=rank, world_size=2), 1)
gen = torch.Generator(device=mesh.device).manual_seed(0)
cfg = get_smoke_config("deepseek-v2-lite-16b").replace(compute_dtype="float32")
params = tf.init_params(gen, cfg)
b, n = 2, 16
tokens = torch.randint(0, cfg.vocab_size, (b, n), generator=gen, device=mesh.device)
one, caches = steps.make_decode_step(cfg, mesh.device), tf.init_caches(cfg, b, n, mesh.device)
policy = make_policy(cfg, mesh)
placed = steps.make_decode_step(cfg, mesh.device, policy, mesh, b, n)
pcaches = steps.init_placed_caches(cfg, policy, mesh, b, n)
for t in range(n):
    expect, caches = one(params, caches, tokens[:, t:t + 1], t)
    got, pcaches = placed(params, pcaches, tokens[:, t:t + 1], t)
    got = gather_tree(got).float()
    rel = float((got - expect.float()).abs().max() / expect.float().abs().max())
    assert rel <= 1e-4, (t, rel)
assert pcaches[0]["c_kv"].to_local().shape == (b, n // 2, cfg.mla_kv_lora_rank)
dist.destroy_process_group()
"""


def test_placed_mla_moe_decode_on_card_equals_one_process(card, tmp_path):
    """deepseek's smoke decode by 2 ranks as a (1, 2) mesh over gloo on one
    card, under a timeout: a hang fails."""
    _two_ranks(MLA_MOE_DECODE_RANK, tmp_path)


def _two_ranks(rank_code: str, tmp_path) -> None:
    code = rank_code.format(src=str(pathlib.Path(__file__).resolve().parents[1] / "src"),
                            rdzv=str(tmp_path / "rdzv"))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], stderr=subprocess.PIPE,
                              text=True, env={**os.environ, "OMP_NUM_THREADS": "1"})
             for r in range(2)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)
