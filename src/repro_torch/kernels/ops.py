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
                            "rmsnorm": 0}

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
    vec = d % (16 // x.element_size()) == 0 and x.data_ptr() % 16 == 0 \
        and w.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    with torch.cuda.device(x.device):
        _launch("rmsnorm", lib.rmsnorm_fwd, x.data_ptr(), w.data_ptr(), out.data_ptr(),
                x.numel() // d, d, RMSNORM_EPS, _DTYPE_CODE[x.dtype], int(vec))
    return out
