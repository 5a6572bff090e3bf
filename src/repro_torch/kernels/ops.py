"""Public wrappers for the hand-written kernels.

Each wrapper checks its inputs, then dispatches on the tensors' device: a
CPU tensor goes to the plain version in :mod:`repro_torch.kernels.ref`; a
CUDA tensor goes to the CUDA kernel, and a failed build or launch raises.
``LAUNCHES`` counts kernel launches only, so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build, ref

Tensor = torch.Tensor

#: kernel name → number of CUDA launches by its wrapper in this process
LAUNCHES: dict[str, int] = {"flash_attention": 0, "quantize_int8": 0, "dequantize_int8": 0,
                            "rmsnorm": 0, "layernorm_fwd": 0, "layernorm_bwd": 0,
                            "layernorm_bwd_reduce": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _flash_lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci,
                                        ctypes.c_float, ci, vp]
    lib.flash_attention_fwd.restype = ci
    pi = ctypes.POINTER(ci)
    lib.flash_attention_launch_info.argtypes = [ci, ci, pi, pi, pi, pi]
    lib.flash_attention_launch_info.restype = ci
    return lib


def flash_attention_launch_info(d: int, dtype: torch.dtype) -> dict:
    """The launch shape of the CUDA kernel for head dim ``d`` and ``dtype``:
    threads and query rows per block, dynamic shared memory, blocks per SM
    (on the current card)."""
    vals = [ctypes.c_int() for _ in range(4)]
    err = _flash_lib().flash_attention_launch_info(d, _DTYPE_CODE[dtype],
                                                   *map(ctypes.byref, vals))
    if err != 0:
        raise RuntimeError(f"flash_attention_launch_info failed: cudaError_t {err}")
    return dict(zip(("threads", "rows_per_block", "smem_bytes", "blocks_per_sm"),
                    (v.value for v in vals)))


@functools.cache
def _quant_lib() -> ctypes.CDLL:
    lib = build.load("grad_compress")
    vp = ctypes.c_void_p
    lib.quantize_int8.argtypes = [vp, vp, vp, ctypes.c_longlong, vp]
    lib.dequantize_int8.argtypes = [vp, vp, vp, ctypes.c_longlong, vp]
    lib.quantize_int8.restype = lib.dequantize_int8.restype = ctypes.c_int
    return lib


@functools.cache
def _rmsnorm_lib() -> ctypes.CDLL:
    lib = build.load("rmsnorm")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rmsnorm_fwd.argtypes = [vp, vp, vp, ctypes.c_longlong, ci, ctypes.c_float, ci, ci, vp]
    lib.rmsnorm_fwd.restype = ci
    return lib


@functools.cache
def _layernorm_lib() -> ctypes.CDLL:
    lib = build.load("layernorm")
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.layernorm_fwd.argtypes = [vp, vp, vp, vp, vp, vp, cl, ci, ctypes.c_float, ci, ci, vp]
    lib.layernorm_bwd_parts.argtypes = [cl, ci, ci, ci]
    lib.layernorm_bwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, cl, ci, ci, ci, vp]
    lib.layernorm_bwd_reduce.argtypes = [vp, vp, vp, ci, ci, vp]
    for fn in (lib.layernorm_fwd, lib.layernorm_bwd_parts, lib.layernorm_bwd,
               lib.layernorm_bwd_reduce):
        fn.restype = ci
    return lib


def _check_attention(q: Tensor, k: Tensor, v: Tensor, window: Optional[int]) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention takes [B,S,H,D] tensors, got {q.shape}, "
                         f"{k.shape}, {v.shape}")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v must be [B,Skv,KV,D] matching q {tuple(q.shape)}, "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if min(q.shape) == 0 or min(k.shape) == 0:
        raise ValueError("flash_attention takes no empty tensors")
    if h % k.shape[2]:
        raise ValueError(f"query heads {h} are not a multiple of KV heads {k.shape[2]}")
    if d % 8 or d > 128:
        raise ValueError(f"head_dim {d} must be a multiple of 8 and at most 128")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must all be float32 or bfloat16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v lie on different devices: {q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q/k/v must be contiguous")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                          window: Optional[int] = None) -> Tensor:
    """The kernel's plain version in the [B,S,H,D] layout (any device)."""
    b, sq, h, d = q.shape
    _, skv, kv, _ = k.shape
    qr = q.transpose(1, 2).reshape(b * h, sq, d)
    kr = k.transpose(1, 2).reshape(b * kv, skv, d)
    vr = v.transpose(1, 2).reshape(b * kv, skv, d)
    out = ref.reference_attention(qr, kr, vr, causal=causal, window=window)
    return out.reshape(b, h, sq, d).transpose(1, 2)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: Optional[int] = None) -> Tensor:
    """Attention in the [B,S,H,D] layout (matches ``repro_torch.models.attention``).

    k/v may have fewer (KV) heads; the kernel reads KV head ``h // (H/KV)``
    and never materializes the repeat. Causal masking is top-left (k ≤ q on
    indices from 0); ``window`` keeps keys with q − k < window. On the card
    both types run on the tensor cores, and q/k/v must start on 16-byte
    boundaries: bf16 on wgmma fed by TMA, fp32 on mma.sync fed by 16-byte
    ``cp.async`` copies, each product as three TF32 products (3xTF32), which
    holds fp32 accuracy.
    """
    _check_attention(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, not {q.device}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q/k/v must start on 16-byte boundaries for the CUDA kernel "
                         "(the rule of TMA and of 16-byte cp.async copies)")
    lib = _flash_lib()
    b, sq, h, d = q.shape
    _, skv, kv, _ = k.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, skv, h, kv, d, int(causal), window or 0, 1.0 / math.sqrt(d),
            _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError_t {err}")
    LAUNCHES["flash_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# int8 gradient compression: per-256-block symmetric quantization
# ---------------------------------------------------------------------------

QUANT_BLOCK = 256


def _device_of(*ts: Tensor) -> str:
    dev = {t.device for t in ts}
    if len(dev) != 1:
        raise ValueError(f"tensors lie on different devices: {sorted(map(str, dev))}")
    kind = ts[0].device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"the kernels run on cpu or cuda tensors, not {ts[0].device}")
    return kind


def _aligned(t: Tensor, align: int) -> Tensor:
    """``t`` contiguous, starting on an ``align``-byte boundary (a copy if not)."""
    t = t.contiguous()
    return t if t.data_ptr() % align == 0 else t.clone()


def _launch(name: str, fn, *args) -> None:
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    LAUNCHES[name] += 1


def quantize_int8(x: Tensor) -> tuple[Tensor, Tensor]:
    """Flat fp32 ``x [n]`` → (``q`` int8 ``[n_pad]``, ``scales`` fp32
    ``[n_pad/256]``), with ``n`` zero-padded to a multiple of 256; per block
    ``scale = max(amax, 1e-12)·fp32(1/127)`` and ``q = clip(rint(x/scale), ±127)``.
    Bit-identical to the JAX package's quantizer as XLA compiles it (the
    Pallas kernel and the jitted jnp twin; see ``ref.RECIP_127``)."""
    if x.dim() != 1 or x.numel() == 0:
        raise ValueError(f"quantize_int8 takes a non-empty flat tensor, got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"quantize_int8 takes float32, got {x.dtype}")
    if _device_of(x) == "cpu":
        return ref.quantize_int8(x, QUANT_BLOCK)
    pad = (-x.numel()) % QUANT_BLOCK
    x = torch.nn.functional.pad(x, (0, pad)) if pad else _aligned(x, 16)
    lib = _quant_lib()
    n_blocks = x.numel() // QUANT_BLOCK
    q = torch.empty(x.numel(), dtype=torch.int8, device=x.device)
    scales = torch.empty(n_blocks, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _launch("quantize_int8", lib.quantize_int8,
                x.data_ptr(), q.data_ptr(), scales.data_ptr(), n_blocks)
    return q, scales


def dequantize_int8(q: Tensor, scales: Tensor, n: int) -> Tensor:
    """``float(q) · scale`` per 256-block, truncated to the first ``n``
    elements: the inverse of :func:`quantize_int8` up to its rounding."""
    if q.dim() != 1 or q.numel() % QUANT_BLOCK or q.dtype != torch.int8:
        raise ValueError(f"q must be flat int8 of a multiple of {QUANT_BLOCK} elements, "
                         f"got {q.dtype} {tuple(q.shape)}")
    if scales.shape != (q.numel() // QUANT_BLOCK,) or scales.dtype != torch.float32:
        raise ValueError(f"scales must be float32 [{q.numel() // QUANT_BLOCK}], got "
                         f"{scales.dtype} {tuple(scales.shape)}")
    if not 0 < n <= q.numel():
        raise ValueError(f"n must be in 1..{q.numel()}, got {n}")
    if _device_of(q, scales) == "cpu":
        return ref.dequantize_int8(q, scales, n, QUANT_BLOCK)
    lib = _quant_lib()
    q, scales = _aligned(q, 4), scales.contiguous()
    out = torch.empty(n, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch("dequantize_int8", lib.dequantize_int8,
                q.data_ptr(), scales.data_ptr(), out.data_ptr(), n)
    return out


# ---------------------------------------------------------------------------
# fused RMSNorm
# ---------------------------------------------------------------------------

def _vec_rows(d: int, *ts: Tensor) -> bool:
    """Whether rows of ``d`` elements of ``ts[0]``'s dtype take the kernels' 16-byte
    vectors: d a multiple of the vector and every tensor on a 16-byte boundary."""
    return d % (16 // ts[0].element_size()) == 0 and all(t.data_ptr() % 16 == 0 for t in ts)


RMSNORM_EPS = 1e-6


def fused_rmsnorm(x: Tensor, w: Tensor) -> Tensor:
    """Per row of ``x [..., d]``: ``x·rsqrt(mean(x²)+1e-6)·(1+w)`` with fp32
    statistics, in x's dtype; ``w`` is ``[d]`` fp32 (stored as a residual
    scale, applied as ``1+w``). ``x`` is float32 or bfloat16 and contiguous."""
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"fused_rmsnorm takes a non-empty [..., d] tensor, got {tuple(x.shape)}")
    d = x.shape[-1]
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_rmsnorm takes float32 or bfloat16 x, got {x.dtype}")
    if w.shape != (d,) or w.dtype != torch.float32:
        raise ValueError(f"w must be float32 [{d}], got {w.dtype} {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    if _device_of(x, w) == "cpu":
        return ref.reference_rmsnorm(x, w, RMSNORM_EPS)
    lib = _rmsnorm_lib()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _launch("rmsnorm", lib.rmsnorm_fwd, x.data_ptr(), w.data_ptr(), out.data_ptr(),
                x.numel() // d, d, RMSNORM_EPS, _DTYPE_CODE[x.dtype],
                int(_vec_rows(d, x, w, out)))
    return out


# ---------------------------------------------------------------------------
# fused LayerNorm, forward and backward
# ---------------------------------------------------------------------------

LAYERNORM_EPS = 1e-5


@functools.lru_cache(maxsize=64)
def _layernorm_bwd_parts(rows: int, d: int, dtype: int, vec: bool) -> int:
    parts = _layernorm_lib().layernorm_bwd_parts(rows, d, dtype, int(vec))
    if parts <= 0:
        raise RuntimeError(f"layernorm_bwd_parts refused rows {rows}, d {d}, dtype {dtype}")
    return parts


def _layernorm_fwd(x: Tensor, w: Tensor, b: Tensor, eps: float,
                   stats: bool) -> tuple[Tensor, Optional[Tensor], Optional[Tensor]]:
    """One launch: ``y``, and the rows' fp32 ``mean`` and ``rstd`` where ``stats``."""
    lib = _layernorm_lib()
    d = x.shape[-1]
    rows = x.numel() // d
    y = torch.empty_like(x)
    mean = rstd = None
    if stats:
        mean, rstd = torch.empty((2, rows), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _launch("layernorm_fwd", lib.layernorm_fwd, x.data_ptr(), w.data_ptr(),
                b.data_ptr(), y.data_ptr(), mean.data_ptr() if stats else None,
                rstd.data_ptr() if stats else None, rows, d, eps, _DTYPE_CODE[x.dtype],
                int(_vec_rows(d, x, w, b, y)))
    return y, mean, rstd


class _LayerNorm(torch.autograd.Function):
    """The forward kernel, saving x, mean and rstd; the backward kernel and its
    column sums of the weight gradients."""

    @staticmethod
    def forward(ctx, x, w, b, eps):
        y, mean, rstd = _layernorm_fwd(x, w, b, eps, stats=True)
        ctx.save_for_backward(x, w, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, mean, rstd = ctx.saved_tensors
        dy = dy.contiguous()
        d = x.shape[-1]
        rows = x.numel() // d
        dx = torch.empty_like(x)
        vec = _vec_rows(d, x, dy, w, dx)
        code = _DTYPE_CODE[x.dtype]
        parts = _layernorm_bwd_parts(rows, d, code, vec)
        part = torch.empty((parts, 2, d), dtype=torch.float32, device=x.device)
        dw, db = torch.empty((2, d), dtype=torch.float32, device=x.device)
        lib = _layernorm_lib()
        with torch.cuda.device(x.device):
            _launch("layernorm_bwd", lib.layernorm_bwd, x.data_ptr(), dy.data_ptr(),
                    mean.data_ptr(), rstd.data_ptr(), w.data_ptr(), dx.data_ptr(),
                    part.data_ptr(), rows, d, code, int(vec))
            _launch("layernorm_bwd_reduce", lib.layernorm_bwd_reduce, part.data_ptr(),
                    dw.data_ptr(), db.data_ptr(), parts, d)
        return dx, dw, db, None


def fused_layernorm(x: Tensor, w: Tensor, b: Tensor, eps: float = LAYERNORM_EPS) -> Tensor:
    """Per row of ``x [..., d]``: ``(x − mean)·rsqrt(var + eps)·w + b`` with fp32
    statistics (the two-pass variance), ``w`` and ``b`` ``[d]`` applied in fp32, in
    x's dtype; differentiable in ``x``, ``w`` and ``b``. ``x`` is float32 or bfloat16.

    On the card the forward is one launch (``LAUNCHES["layernorm_fwd"]``) and, under
    autograd, saves the rows' mean and rstd; the backward is one launch over the rows
    (``"layernorm_bwd"``: dx, and fp32 partial sums of dw and db a block) and one that
    adds the partials in a fixed order (``"layernorm_bwd_reduce"``), so the gradients
    are deterministic. A CPU tensor takes the plain version."""
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"fused_layernorm takes a non-empty [..., d] tensor, got {tuple(x.shape)}")
    d = x.shape[-1]
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_layernorm takes float32 or bfloat16 x, got {x.dtype}")
    if w.shape != (d,) or b.shape != (d,):
        raise ValueError(f"w and b must be [{d}], got {tuple(w.shape)} and {tuple(b.shape)}")
    if _device_of(x, w, b) == "cpu":
        return ref.reference_layernorm(x, w, b, eps)
    x, w, b = x.contiguous(), w.float().contiguous(), b.float().contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or b.requires_grad):
        return _LayerNorm.apply(x, w, b, eps)
    return _layernorm_fwd(x, w, b, eps, stats=False)[0]
