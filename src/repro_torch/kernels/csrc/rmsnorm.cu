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
// Layout. One warp per row. Where d is a multiple of the 16-byte vector (4 fp32
// or 8 bf16) and x, w and out start on 16-byte boundaries, lane l holds vectors
// l, l + 32, ... of the row, so a warp-wide access is one contiguous 512-byte
// run. A row of at most 16 vectors a lane (4096 bf16, 2048 fp32) is held in
// registers: every load of the row is issued at once, the sum of x² is taken
// from the registers (a five-step __shfl_xor_sync butterfly gives every lane
// the row's sum), and the output is formed from them, so the row costs one
// memory round trip and is read from HBM once. A short row (one or two vectors
// a lane, as the overlap consumer's d = 128 in fp32) takes two rows a warp at
// once, to keep enough bytes in flight. (1 + w) is read as fp32 16-byte vectors
// (two per bf16 vector of x), which the SM's L1 serves after the first row. The
// grid is no larger than the card holds at once, and each warp walks rows
// strided by the grid, so no second partial wave of blocks starts late and
// pays a row's latency again. A longer row is read twice (pass 2 re-reads it
// from L1/L2) with four 16-byte loads a lane in flight; an odd d such as 37
// takes scalar accesses. The TPU kernel's (block_rows, d) VMEM tile becomes a
// warp's hold of one row; nothing is carried between rows.
//
// Bound on the H100. A few operations per element against 8 (fp32) or 4 (bf16)
// bytes moved per element, plus 4d bytes of w: HBM bytes bound it. Danube's
// prefill rows [9216, 2560] in bf16 are 94.4 MB, 28.2 µs at 3.35 TB/s. What the
// design does about it: x is read from HBM once and written once, with wide
// coalesced accesses, all of a row's loads in flight together, and no
// intermediate goes to memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;            // warps per thread block, one row each at a time
constexpr int MAX_BLOCKS = 4096;    // grid cap of the two-pass and scalar walks
constexpr int LONG_ROW_UNROLL = 4;  // 16-byte loads in flight per lane on a long row
constexpr int MAX_NV = 16;          // 16-byte vectors a lane of a row held in registers

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// one 16-byte vector of x (elements j..j + V of its row) scaled by inv·(1 + w[j..j + V)),
// w read as V / 4 fp32 16-byte vectors
template <typename T>
__device__ __forceinline__ uint4 scale_vec(const uint4& raw, const float* __restrict__ w, int j,
                                           float inv) {
  constexpr int V = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&raw);
  uint4 packed;
  T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
  for (int k4 = 0; k4 < V / 4; ++k4) {
    const float4 wv = __ldg(reinterpret_cast<const float4*>(w + j) + k4);
    o[4 * k4] = from_f<T>(to_f(e[4 * k4]) * inv * (1.0f + wv.x));
    o[4 * k4 + 1] = from_f<T>(to_f(e[4 * k4 + 1]) * inv * (1.0f + wv.y));
    o[4 * k4 + 2] = from_f<T>(to_f(e[4 * k4 + 2]) * inv * (1.0f + wv.z));
    o[4 * k4 + 3] = from_f<T>(to_f(e[4 * k4 + 3]) * inv * (1.0f + wv.w));
  }
  return packed;
}

// A row of at most NV vectors a lane, RPW rows a warp at a time, in registers.
template <typename T, int NV, int RPW>
__global__ void __launch_bounds__(WARPS * 32)
rmsnorm_regs_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out,
                    int64_t rows, int d, float eps) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * WARPS * RPW;
  for (int64_t r0 = (static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5)) * RPW;
       r0 < rows; r0 += stride) {
    uint4 raw[RPW][NV];
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        const int j = (u * 32 + lane) * V;
        if (r0 + i < rows && j < d) raw[i][u] = *reinterpret_cast<const uint4*>(x + (r0 + i) * d + j);
      }
    float inv[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      float ss = 0.0f;
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        if ((u * 32 + lane) * V >= d) break;
        const T* e = reinterpret_cast<const T*>(&raw[i][u]);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float v = to_f(e[k]);
          ss = fmaf(v, v, ss);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
      inv[i] = rsqrtf(ss / static_cast<float>(d) + eps);
    }
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int j = (u * 32 + lane) * V;
      if (j >= d) break;
#pragma unroll
      for (int i = 0; i < RPW; ++i)
        if (r0 + i < rows)
          *reinterpret_cast<uint4*>(out + (r0 + i) * d + j) = scale_vec<T>(raw[i][u], w, j, inv[i]);
    }
  }
}

// A row too long for registers (VEC: two passes, LONG_ROW_UNROLL 16-byte loads
// a lane in flight) or of an odd d (scalar accesses).
template <typename T, bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out,
               int64_t rows, int d, float eps) {
  constexpr int UNROLL = LONG_ROW_UNROLL;
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * WARPS;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5); r < rows;
       r += stride) {
    const T* xr = x + r * d;
    T* orow = out + r * d;
    float ss = 0.0f;
    if constexpr (VEC) {
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
    if constexpr (VEC) {
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
          *reinterpret_cast<uint4*>(orow + j) = scale_vec<T>(raw[u], w, j, inv);
        }
      }
    } else {
      for (int j = lane; j < d; j += 32)
        orow[j] = from_f<T>(to_f(xr[j]) * inv * (1.0f + __ldg(w + j)));
    }
  }
}

// The blocks of `kernel` the card runs at once: SMs × resident blocks per SM.
int resident_blocks(const void* kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WARPS * 32, 0) !=
          cudaSuccess)
    return MAX_BLOCKS;
  return sms * (per_sm > 0 ? per_sm : 1);
}

template <typename T, int NV>
int launch_regs(const T* x, const float* w, T* out, long long rows, int d, float eps,
                cudaStream_t stream) {
  constexpr int RPW = NV <= 2 ? 2 : 1;
  auto kernel = rmsnorm_regs_kernel<T, NV, RPW>;
  static const int cap = resident_blocks(reinterpret_cast<const void*>(kernel));
  const long long blocks = (rows + WARPS * RPW - 1) / (WARPS * RPW);
  const unsigned grid = static_cast<unsigned>(blocks < cap ? blocks : cap);
  kernel<<<grid, WARPS * 32, 0, stream>>>(x, w, out, rows, d, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* xp, const void* wp, void* outp, long long rows, int d, float eps,
           int vec, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xp);
  const float* w = static_cast<const float*>(wp);
  T* out = static_cast<T*>(outp);
  const int nv = (d + 32 * V - 1) / (32 * V);  // 16-byte vectors a lane
  if (vec && nv <= MAX_NV) {
    if (nv <= 1) return launch_regs<T, 1>(x, w, out, rows, d, eps, stream);
    if (nv <= 2) return launch_regs<T, 2>(x, w, out, rows, d, eps, stream);
    if (nv <= 4) return launch_regs<T, 4>(x, w, out, rows, d, eps, stream);
    if (nv <= 6) return launch_regs<T, 6>(x, w, out, rows, d, eps, stream);
    if (nv <= 8) return launch_regs<T, 8>(x, w, out, rows, d, eps, stream);
    if (nv <= 10) return launch_regs<T, 10>(x, w, out, rows, d, eps, stream);
    if (nv <= 12) return launch_regs<T, 12>(x, w, out, rows, d, eps, stream);
    return launch_regs<T, MAX_NV>(x, w, out, rows, d, eps, stream);
  }
  const long long blocks = (rows + WARPS - 1) / WARPS;
  const unsigned grid = static_cast<unsigned>(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
  auto kernel = vec ? rmsnorm_kernel<T, true> : rmsnorm_kernel<T, false>;
  kernel<<<grid, WARPS * 32, 0, stream>>>(x, w, out, rows, d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: rows·d elements of the dtype (0 = fp32, 1 = bf16), contiguous; w: d fp32.
// vec != 0 only where d is a multiple of 16 / sizeof(dtype) and x, w and out are
// 16-byte aligned.
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* out, long long rows, int d,
                           float eps, int dtype, int vec, void* stream) {
  if (rows <= 0 || d <= 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(x, w, out, rows, d, eps, vec, s)
                    : launch<__nv_bfloat16>(x, w, out, rows, d, eps, vec, s);
}
