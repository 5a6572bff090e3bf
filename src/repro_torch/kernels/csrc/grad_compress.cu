// int8 gradient quantize / dequantize for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels src/repro/kernels/grad_compress.py::_quant_kernel
// (launched by quantize_int8_pallas, pl.pallas_call at line 42) and ::_dequant_kernel
// (dequantize_int8_pallas, line 65). Same function, per 256-element block:
//
//   quantize:   amax = max |x|;  scale = max(amax, 1e-12) · fp32(1/127);
//               q = clip(rint(x / scale), -127, 127) as int8
//   dequantize: out = float(q) · scale, written for the first n elements only
//

// Bit for bit what the plain versions compute (kernels/ref.py) and what the JAX
// package computes once XLA has compiled it: XLA turns the source's
// "max(amax, 1e-12) / 127" into a multiply by the fp32 reciprocal, in the jitted
// trainer and in the Pallas kernel alike, so the scale is that product here too.
// x / scale is a true IEEE round-to-nearest division (__fdiv_rn, not a multiply
// by the reciprocal), rounding is half to even (rintf), the max is order-free,
// and the products are __fmul_rn, so nothing is contracted into an FMA. The
// build passes no --use_fast_math. Inputs are taken to be finite.
//
// Layout. One warp per 256-element block, eight warps per thread block. Lane l
// holds elements 4l..4l+3 and 128+4l..128+4l+3, read as two float4 (quantize)
// or two char4 (dequantize), so each warp-wide access is one contiguous 512 or
// 128-byte run; the block max is a five-step __shfl_xor_sync butterfly. The TPU
// kernel's grid of 512-row tiles becomes a flat grid of warps.
//
// Bound on the H100. Both kernels do a handful of operations per element and move
// 4 + 1 + 4/256 bytes per element (fp32 in, int8 and one fp32 scale per block
// out, or the reverse), so HBM bytes bound them: a 25 MB gradient bucket
// (6,553,600 fp32) is 32.9 MB, 9.8 µs at 3.35 TB/s. What the design does about
// it: one pass over the data, with wide coalesced loads and stores; the scale
// never goes to memory between the max and the divide. Fusing dequantize into
// the receiver's accumulate is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QBLOCK = 256;  // elements per quantization block
constexpr int WARPS = 8;     // quantization blocks per thread block

__device__ __forceinline__ signed char quant(float v, float scale) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.0f), 127.0f);
  return static_cast<signed char>(__float2int_rn(r));
}

__device__ __forceinline__ float absmax4(float4 a) {
  return fmaxf(fmaxf(fabsf(a.x), fabsf(a.y)), fmaxf(fabsf(a.z), fabsf(a.w)));
}

__global__ void __launch_bounds__(WARPS * 32)
quantize_kernel(const float* __restrict__ x, signed char* __restrict__ q,
                float* __restrict__ scales, int64_t n_blocks) {
  const int64_t blk = static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (blk >= n_blocks) return;
  const float4* src = reinterpret_cast<const float4*>(x + blk * QBLOCK);
  const float4 a = src[lane];
  const float4 b = src[lane + 32];
  float amax = fmaxf(absmax4(a), absmax4(b));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = __fmul_rn(fmaxf(amax, 1e-12f), 1.0f / 127.0f);
  char4* dst = reinterpret_cast<char4*>(q + blk * QBLOCK);
  dst[lane] = make_char4(quant(a.x, scale), quant(a.y, scale), quant(a.z, scale),
                         quant(a.w, scale));
  dst[lane + 32] = make_char4(quant(b.x, scale), quant(b.y, scale), quant(b.z, scale),
                              quant(b.w, scale));
  if (lane == 0) scales[blk] = scale;
}

__device__ __forceinline__ void store4(float* out, int64_t i, int64_t n, char4 v, float s) {
  const float4 f = make_float4(__fmul_rn(static_cast<float>(v.x), s),
                               __fmul_rn(static_cast<float>(v.y), s),
                               __fmul_rn(static_cast<float>(v.z), s),
                               __fmul_rn(static_cast<float>(v.w), s));
  if (i + 4 <= n) {
    *reinterpret_cast<float4*>(out + i) = f;
  } else {  // the ragged end of the last block
    if (i < n) out[i] = f.x;
    if (i + 1 < n) out[i + 1] = f.y;
    if (i + 2 < n) out[i + 2] = f.z;
  }
}

__global__ void __launch_bounds__(WARPS * 32)
dequantize_kernel(const signed char* __restrict__ q, const float* __restrict__ scales,
                  float* __restrict__ out, int64_t n) {
  const int64_t blk = static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (blk * QBLOCK >= n) return;
  const float s = scales[blk];
  const char4* src = reinterpret_cast<const char4*>(q + blk * QBLOCK);
  const int64_t base = blk * QBLOCK + 4 * lane;
  store4(out, base, n, src[lane], s);
  store4(out, base + 128, n, src[lane + 32], s);
}

unsigned grid_for(int64_t n_blocks) {
  return static_cast<unsigned>((n_blocks + WARPS - 1) / WARPS);
}

}  // namespace

// x: n_blocks·256 fp32 (16-byte aligned); q: as many int8; scales: n_blocks fp32.
extern "C" int quantize_int8(const void* x, void* q, void* scales, long long n_blocks,
                             void* stream) {
  if (n_blocks <= 0 || (n_blocks + WARPS - 1) / WARPS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  quantize_kernel<<<grid_for(n_blocks), WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<signed char*>(q), static_cast<float*>(scales),
      n_blocks);
  return (int)cudaGetLastError();
}

// q: ⌈n/256⌉·256 int8 (4-byte aligned); scales: ⌈n/256⌉ fp32; out: n fp32 (16-byte aligned).
extern "C" int dequantize_int8(const void* q, const void* scales, void* out, long long n,
                               void* stream) {
  const long long n_blocks = (n + QBLOCK - 1) / QBLOCK;
  if (n <= 0 || (n_blocks + WARPS - 1) / WARPS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  dequantize_kernel<<<grid_for(n_blocks), WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const signed char*>(q), static_cast<const float*>(scales),
      static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}
