// Fused RMSNorm for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::_rmsnorm_kernel
// (launched by rmsnorm_pallas, pl.pallas_call at line 36). Same function, per row
// of d elements (any leading shape flattened into rows):
//
//   out = x · rsqrt(mean(x²) + eps) · (1 + w)
//
// with the statistics and the products in fp32, w read as fp32, and the output
// rounded to x's dtype (fp32 or bf16, round to nearest even). 1 + w is formed in
// registers and never written to memory.
//
// Layout. One warp per row, eight warps per thread block, rows strided over the
// grid. Pass 1 reads the row and sums x² in fp32 per lane; a five-step
// __shfl_xor_sync butterfly gives every lane the row's sum. Pass 2 reads the row
// again (a row is at most a few KB, so the second read hits L1/L2, not HBM),
// scales and stores. A row longer than one 16-byte vector per lane is read with
// four loads per lane in flight (one at a time, a 5 KB row waits on memory ten
// times in a row); a short row is read one load at a time, which needs 40
// registers against 64 and so keeps more warps resident. Where d is a multiple of the 16-byte vector (4 fp32 or 8
// bf16) and x and out start on 16-byte boundaries, each lane moves 16 bytes per
// access, so a warp-wide access is one contiguous 512-byte run; otherwise (an odd
// d such as 37) every access is scalar. The TPU kernel's (block_rows, d) VMEM
// tile becomes a warp's walk along one row; nothing is carried between rows.
//
// Bound on the H100. A few operations per element against 8 (fp32) or 4 (bf16)
// bytes moved per element, plus 4d bytes of w: HBM bytes bound it. Danube's
// prefill rows [9216, 2560] in bf16 are 94.4 MB, 28.2 µs at 3.35 TB/s. What the
// design does about it: x is read from HBM once and written once, with wide
// coalesced accesses, and no intermediate goes to memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;          // rows in flight per thread block
constexpr int MAX_BLOCKS = 4096;  // grid cap; each warp then walks several rows
constexpr int LONG_ROW_UNROLL = 4;  // 16-byte loads in flight per lane on a long row

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int UNROLL>
__global__ void __launch_bounds__(WARPS * 32)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out,
               int64_t rows, int d, float eps, bool vec) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * WARPS;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5); r < rows;
       r += stride) {
    const T* xr = x + r * d;
    T* orow = out + r * d;
    float ss = 0.0f;
    if (vec) {
      for (int j0 = lane * V; j0 < d; j0 += UNROLL * 32 * V) {
        uint4 raw[UNROLL];  // UNROLL loads in flight before the first is used
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int j = j0 + u * 32 * V;
          if (j < d) raw[u] = *reinterpret_cast<const uint4*>(xr + j);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (j0 + u * 32 * V >= d) break;
          const T* e = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float v = to_f(e[k]);
            ss = fmaf(v, v, ss);
          }
        }
      }
    } else {
      for (int j = lane; j < d; j += 32) {
        const float v = to_f(xr[j]);
        ss = fmaf(v, v, ss);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
    if (vec) {
      for (int j0 = lane * V; j0 < d; j0 += UNROLL * 32 * V) {
        uint4 raw[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int j = j0 + u * 32 * V;
          if (j < d) raw[u] = *reinterpret_cast<const uint4*>(xr + j);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int j = j0 + u * 32 * V;
          if (j >= d) break;
          const T* e = reinterpret_cast<const T*>(&raw[u]);
          uint4 packed;
          T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
          for (int k = 0; k < V; ++k)
            o[k] = from_f<T>(to_f(e[k]) * inv * (1.0f + __ldg(w + j + k)));
          *reinterpret_cast<uint4*>(orow + j) = packed;
        }
      }
    } else {
      for (int j = lane; j < d; j += 32)
        orow[j] = from_f<T>(to_f(xr[j]) * inv * (1.0f + __ldg(w + j)));
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, long long rows, int d, float eps,
           int vec, cudaStream_t stream) {
  const long long blocks = (rows + WARPS - 1) / WARPS;
  const unsigned grid = static_cast<unsigned>(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
  const bool long_row = vec && d > 32 * static_cast<int>(16 / sizeof(T));
  auto kernel = long_row ? rmsnorm_kernel<T, LONG_ROW_UNROLL> : rmsnorm_kernel<T, 1>;
  kernel<<<grid, WARPS * 32, 0, stream>>>(static_cast<const T*>(x),
                                          static_cast<const float*>(w), static_cast<T*>(out),
                                          rows, d, eps, vec != 0);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: rows·d elements of the dtype (0 = fp32, 1 = bf16), contiguous; w: d fp32.
// vec != 0 only where d is a multiple of 16 / sizeof(dtype) and x and out are
// 16-byte aligned.
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* out, long long rows, int d,
                           float eps, int dtype, int vec, void* stream) {
  if (rows <= 0 || d <= 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(x, w, out, rows, d, eps, vec, s)
                    : launch<__nv_bfloat16>(x, w, out, rows, d, eps, vec, s);
}
