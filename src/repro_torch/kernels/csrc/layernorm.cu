// Fused LayerNorm forward and backward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces no Pallas kernel: the JAX package writes LayerNorm as jnp operations
// (src/repro/models/layers.py::layernorm) and XLA fuses them on the TPU. Eager
// PyTorch runs the same formula as about eleven fp32 passes over the activation
// forward and some thirty in autograd's backward; these two kernels make each
// direction one pass. Per row of d elements (any leading shape flattened into rows):
//
//   forward:  mu = mean(x), rstd = rsqrt(mean((x − mu)²) + eps),
//             y = (x − mu)·rstd·w + b
//   backward: x̂ = (x − mu)·rstd, g = dy·w,
//             dx = rstd·(g − mean(g) − x̂·mean(g·x̂)), dw = Σ_rows dy·x̂, db = Σ_rows dy
//
// with the statistics and the products in fp32, w and b read as fp32, y and dx
// rounded once to x's dtype (fp32 or bf16, round to nearest even), and dw, db in
// fp32. The variance is the two-pass mean((x − mu)²), as the plain version takes it.
//
// Layout. One warp per row, as in rmsnorm.cu. Where d is a multiple of the 16-byte
// vector (4 fp32 or 8 bf16) and every row-length array starts on a 16-byte boundary,
// lane l holds vectors l, l + 32, ... of the row in registers, so a warp-wide access
// is one contiguous 512-byte run and the row is read from HBM once: the mean and the
// variance come from the registers by two five-step __shfl_xor_sync butterflies. The
// grid is no larger than the card holds at once, and each warp walks rows strided by
// the grid. The forward writes mean and rstd (fp32, one each a row) when a gradient
// will be needed; the backward recomputes x̂ from them and x.
//
// The weight gradients are a sum over rows, which on the TPU a sequential grid would
// carry in scratch; here blocks run in no order. Each lane keeps dw and db of its
// columns in fp32 registers across the rows its warp walks; at the end the block's
// warps add theirs in shared memory in a fixed order and the block writes one fp32
// partial row of each. A second launch adds the partials column by column, also in a
// fixed order (its own C entry, so each launch is counted): no atomics, so the
// gradients are the same bits every run.
//
// A row is held in registers up to 32 elements a lane (d ≤ 1024, the configs' widest
// LayerNorm; the backward keeps that many fp32 dw and db accumulators a lane besides).
// A longer row, a d that is not a multiple of the vector or an unaligned array takes the
// scalar walk: lane-strided elements, the row read from L1/L2 again for each pass, and
// in the backward each warp's own fp32 partial row in memory.
//
// Bound on the H100. A handful of operations per element against 4 (bf16) or 8
// (fp32) bytes moved per element forward and 6 or 12 backward: HBM bytes bound both.
// bert-large's rows [32768, 1024] in bf16: forward reads x and writes y, 134 MB, 40.1
// µs at 3.35 TB/s; backward reads x and dy and writes dx, 201 MB, 60.1 µs (the
// partials, 2.2–3.2 MB, and the statistics, 0.26 MB, left out). What the design does
// about it: each array is touched once with wide coalesced accesses, all of a row's
// loads in flight together, and no intermediate goes to memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int WARPS = 8;          // warps per thread block, one row each at a time
constexpr int MAX_COLS = 32;      // elements of a row a lane holds in registers (and dw, db of)
constexpr int RED_ROWS = 16;      // partial rows the reduction's block adds at once

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// element k of a 16-byte vector of w, b read as fp32 16-byte vectors (two per bf16 vector)
__device__ __forceinline__ void load_f4(const float* __restrict__ p, int j, int n, float* out) {
#pragma unroll
  for (int k4 = 0; k4 < n / 4; ++k4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p + j) + k4);
    out[4 * k4] = v.x;
    out[4 * k4 + 1] = v.y;
    out[4 * k4 + 2] = v.z;
    out[4 * k4 + 3] = v.w;
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// A row of at most NV vectors a lane (NV·V ≤ MAX_COLS), in registers.
template <typename T, int NV>
__global__ void __launch_bounds__(WARPS * 32)
layernorm_fwd_regs_kernel(const T* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ b, T* __restrict__ y,
                          float* __restrict__ mean, float* __restrict__ rstd, int64_t rows,
                          int d, float eps) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  static_assert(NV * V <= MAX_COLS, "a row past the register budget");
  const int lane = threadIdx.x & 31;
  const float fd = static_cast<float>(d);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * WARPS;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5); r < rows;
       r += stride) {
    uint4 raw[NV];
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int j = (u * 32 + lane) * V;
      if (j < d) raw[u] = *reinterpret_cast<const uint4*>(x + r * d + j);
    }
    float s = 0.0f;
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      if ((u * 32 + lane) * V >= d) break;
      const T* e = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
      for (int k = 0; k < V; ++k) s += to_f(e[k]);
    }
    const float mu = warp_sum(s) / fd;
    float ss = 0.0f;
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      if ((u * 32 + lane) * V >= d) break;
      const T* e = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float t = to_f(e[k]) - mu;
        ss = fmaf(t, t, ss);
      }
    }
    const float rs = rsqrtf(warp_sum(ss) / fd + eps);
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int j = (u * 32 + lane) * V;
      if (j >= d) break;
      const T* e = reinterpret_cast<const T*>(&raw[u]);
      float wv[V], bv[V];
      load_f4(w, j, V, wv);
      load_f4(b, j, V, bv);
      uint4 packed;
      T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int k = 0; k < V; ++k) o[k] = from_f<T>(fmaf((to_f(e[k]) - mu) * rs, wv[k], bv[k]));
      *reinterpret_cast<uint4*>(y + r * d + j) = packed;
    }
    if (mean != nullptr && lane == 0) {
      mean[r] = mu;
      rstd[r] = rs;
    }
  }
}

// Any row: scalar accesses, three passes over the row.
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
layernorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, T* __restrict__ y, float* __restrict__ mean,
                     float* __restrict__ rstd, int64_t rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const float fd = static_cast<float>(d);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * WARPS;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5); r < rows;
       r += stride) {
    const T* xr = x + r * d;
    T* yr = y + r * d;
    float s = 0.0f;
    for (int j = lane; j < d; j += 32) s += to_f(xr[j]);
    const float mu = warp_sum(s) / fd;
    float ss = 0.0f;
    for (int j = lane; j < d; j += 32) {
      const float t = to_f(xr[j]) - mu;
      ss = fmaf(t, t, ss);
    }
    const float rs = rsqrtf(warp_sum(ss) / fd + eps);
    for (int j = lane; j < d; j += 32)
      yr[j] = from_f<T>(fmaf((to_f(xr[j]) - mu) * rs, __ldg(w + j), __ldg(b + j)));
    if (mean != nullptr && lane == 0) {
      mean[r] = mu;
      rstd[r] = rs;
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// A row of at most NV vectors a lane (NV·V ≤ MAX_COLS), in registers. part: [gridDim.x]
// blocks of [2][d] fp32, the block's dw then db. Dynamic shared memory: WARPS·d floats.
template <typename T, int NV>
__global__ void __launch_bounds__(WARPS * 32)
layernorm_bwd_regs_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                          const float* __restrict__ mean, const float* __restrict__ rstd,
                          const float* __restrict__ w, T* __restrict__ dx,
                          float* __restrict__ part, int64_t rows, int d) {
  constexpr int V = 16 / sizeof(T);
  static_assert(NV * V <= MAX_COLS, "dw and db accumulators past the register budget");
  extern __shared__ float red[];  // [WARPS][d]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float fd = static_cast<float>(d);
  float dw[NV][V], db[NV][V];
#pragma unroll
  for (int u = 0; u < NV; ++u)
#pragma unroll
    for (int k = 0; k < V; ++k) dw[u][k] = db[u][k] = 0.0f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * WARPS;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * WARPS + warp; r < rows; r += stride) {
    uint4 xraw[NV], graw[NV];
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int j = (u * 32 + lane) * V;
      if (j < d) {
        xraw[u] = *reinterpret_cast<const uint4*>(x + r * d + j);
        graw[u] = *reinterpret_cast<const uint4*>(dy + r * d + j);
      }
    }
    const float mu = __ldg(mean + r), rs = __ldg(rstd + r);
    float sg = 0.0f, sgx = 0.0f;
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int j = (u * 32 + lane) * V;
      if (j >= d) break;
      const T* xe = reinterpret_cast<const T*>(&xraw[u]);
      const T* ge = reinterpret_cast<const T*>(&graw[u]);
      float wv[V];
      load_f4(w, j, V, wv);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xh = (to_f(xe[k]) - mu) * rs, gy = to_f(ge[k]), g = gy * wv[k];
        sg += g;
        sgx = fmaf(g, xh, sgx);
        dw[u][k] = fmaf(gy, xh, dw[u][k]);
        db[u][k] += gy;
      }
    }
    const float mg = warp_sum(sg) / fd, mgx = warp_sum(sgx) / fd;
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int j = (u * 32 + lane) * V;
      if (j >= d) break;
      const T* xe = reinterpret_cast<const T*>(&xraw[u]);
      const T* ge = reinterpret_cast<const T*>(&graw[u]);
      float wv[V];
      load_f4(w, j, V, wv);
      uint4 packed;
      T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xh = (to_f(xe[k]) - mu) * rs, g = to_f(ge[k]) * wv[k];
        o[k] = from_f<T>(rs * (g - mg - xh * mgx));
      }
      *reinterpret_cast<uint4*>(dx + r * d + j) = packed;
    }
  }
  // the block's warps add their columns in warp order, dw then db
#pragma unroll
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int j = (u * 32 + lane) * V;
      if (j >= d) break;
#pragma unroll
      for (int k = 0; k < V; ++k) red[warp * d + j + k] = which ? db[u][k] : dw[u][k];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < d; c += WARPS * 32) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) s += red[i * d + c];
      part[(static_cast<int64_t>(blockIdx.x) * 2 + which) * d + c] = s;
    }
    __syncthreads();
  }
}

// Any row: scalar accesses, two passes over the row. part: one [2][d] fp32 block per
// warp of the grid, which only that warp's lanes touch, each its own columns.
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
layernorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const float* __restrict__ mean, const float* __restrict__ rstd,
                     const float* __restrict__ w, T* __restrict__ dx, float* __restrict__ part,
                     int64_t rows, int d) {
  const int lane = threadIdx.x & 31;
  const float fd = static_cast<float>(d);
  const int64_t gw = static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  float* pw = part + gw * 2 * d;
  float* pb = pw + d;
  for (int j = lane; j < d; j += 32) pw[j] = pb[j] = 0.0f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * WARPS;
  for (int64_t r = gw; r < rows; r += stride) {
    const T* xr = x + r * d;
    const T* gr = dy + r * d;
    T* dxr = dx + r * d;
    const float mu = __ldg(mean + r), rs = __ldg(rstd + r);
    float sg = 0.0f, sgx = 0.0f;
    for (int j = lane; j < d; j += 32) {
      const float g = to_f(gr[j]) * __ldg(w + j);
      sg += g;
      sgx = fmaf(g, (to_f(xr[j]) - mu) * rs, sgx);
    }
    const float mg = warp_sum(sg) / fd, mgx = warp_sum(sgx) / fd;
    for (int j = lane; j < d; j += 32) {
      const float xh = (to_f(xr[j]) - mu) * rs, gy = to_f(gr[j]), g = gy * __ldg(w + j);
      dxr[j] = from_f<T>(rs * (g - mg - xh * mgx));
      pw[j] = fmaf(gy, xh, pw[j]);
      pb[j] += gy;
    }
  }
}

// dw, db [d] = the column sums of part's `parts` blocks of [2][d], in block order.
// Block: 32 columns × RED_ROWS partial rows; grid: d / 32 blocks.
__global__ void __launch_bounds__(32 * RED_ROWS)
layernorm_bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                            float* __restrict__ db, int parts, int d) {
  __shared__ float red[2][RED_ROWS][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float sw = 0.0f, sb = 0.0f;
  if (c < d)
    for (int p = threadIdx.y; p < parts; p += RED_ROWS) {
      sw += part[(static_cast<int64_t>(p) * 2) * d + c];
      sb += part[(static_cast<int64_t>(p) * 2 + 1) * d + c];
    }
  red[0][threadIdx.y][threadIdx.x] = sw;
  red[1][threadIdx.y][threadIdx.x] = sb;
  __syncthreads();
  if (threadIdx.y == 0 && c < d) {
    float tw = 0.0f, tb = 0.0f;
#pragma unroll
    for (int i = 0; i < RED_ROWS; ++i) {
      tw += red[0][i][threadIdx.x];
      tb += red[1][i][threadIdx.x];
    }
    dw[c] = tw;
    db[c] = tb;
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// The blocks of `kernel` the card runs at once: SMs × resident blocks per SM.
int resident_blocks(const void* kernel, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WARPS * 32, smem) !=
          cudaSuccess)
    return 1024;
  return sms * (per_sm > 0 ? per_sm : 1);
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return sms;
}

unsigned grid_for(long long rows, int cap) {
  const long long blocks = (rows + WARPS - 1) / WARPS;
  return static_cast<unsigned>(blocks < cap ? blocks : cap);
}

// The register bucket (16-byte vectors a lane) a row of d elements of T is held in, both
// directions: the configs' widths 384, 768 and 1024 take 2, 3 and 4 (bf16) or 3, 6 and 8
// (fp32). 0 where the row takes the scalar walk: vec == 0, or d past MAX_COLS a lane.
template <typename T> int bucket(int d, int vec) {
  constexpr int V = 16 / sizeof(T);
  const int nv = (d + 32 * V - 1) / (32 * V);
  if (!vec) return 0;
  for (int s : {2, 3, 4, 6, 8})
    if (nv <= s) return s * V <= MAX_COLS ? s : 0;
  return 0;
}

// f(std::integral_constant<int, NV>()) for the row's bucket, NV = 0 for the scalar walk.
// A bucket past MAX_COLS for T (6 and 8 in bf16) is never chosen, nor instantiated.
template <typename T, typename F> int dispatch(int d, int vec, F f) {
  constexpr int V = 16 / sizeof(T);
  switch (bucket<T>(d, vec)) {
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    case 6: return f(std::integral_constant<int, 6 * V <= MAX_COLS ? 6 : 0>());
    case 8: return f(std::integral_constant<int, 8 * V <= MAX_COLS ? 8 : 0>());
    default: return f(std::integral_constant<int, 0>());
  }
}

template <typename T, int NV>
int launch_fwd(const T* x, const float* w, const float* b, T* y, float* mean, float* rstd,
               long long rows, int d, float eps, cudaStream_t stream) {
  if constexpr (NV > 0) {
    auto kernel = layernorm_fwd_regs_kernel<T, NV>;
    static const int cap = resident_blocks(reinterpret_cast<const void*>(kernel), 0);
    kernel<<<grid_for(rows, cap), WARPS * 32, 0, stream>>>(x, w, b, y, mean, rstd, rows, d, eps);
  } else {
    auto kernel = layernorm_fwd_kernel<T>;
    static const int cap = resident_blocks(reinterpret_cast<const void*>(kernel), 0);
    kernel<<<grid_for(rows, cap), WARPS * 32, 0, stream>>>(x, w, b, y, mean, rstd, rows, d, eps);
  }
  return (int)cudaGetLastError();
}

// The backward's grid: for a register-held row, the shared memory of the bucket's widest
// row sets the blocks an SM holds.
template <typename T, int NV> int bwd_grid(long long rows) {
  if constexpr (NV > 0) {
    static const int cap = resident_blocks(
        reinterpret_cast<const void*>(layernorm_bwd_regs_kernel<T, NV>),
        WARPS * NV * 32 * (16 / sizeof(T)) * sizeof(float));
    return static_cast<int>(grid_for(rows, cap));
  } else {
    return static_cast<int>(grid_for(rows, sm_count()));
  }
}

// The [2][d] partial blocks the backward writes: one a block, or one a warp in the walk.
template <typename T, int NV> int bwd_parts(long long rows) {
  return NV > 0 ? bwd_grid<T, NV>(rows) : bwd_grid<T, NV>(rows) * WARPS;
}

template <typename T, int NV>
int launch_bwd(const T* x, const T* dy, const float* mean, const float* rstd, const float* w,
               T* dx, float* part, long long rows, int d, cudaStream_t stream) {
  const int grid = bwd_grid<T, NV>(rows);
  if constexpr (NV > 0)
    layernorm_bwd_regs_kernel<T, NV><<<grid, WARPS * 32, WARPS * d * sizeof(float), stream>>>(
        x, dy, mean, rstd, w, dx, part, rows, d);
  else
    layernorm_bwd_kernel<T><<<grid, WARPS * 32, 0, stream>>>(x, dy, mean, rstd, w, dx, part,
                                                             rows, d);
  return (int)cudaGetLastError();
}

bool bad_args(long long rows, int d, int dtype) {
  return rows <= 0 || d <= 0 || (dtype != 0 && dtype != 1);
}

// f(T* tag) with T the element type of dtype (0 = fp32, 1 = bf16)
template <typename F> int by_dtype(int dtype, F f) {
  return dtype == 0 ? f(static_cast<float*>(nullptr)) : f(static_cast<__nv_bfloat16*>(nullptr));
}

}  // namespace

// x, y: rows·d elements of the dtype (0 = fp32, 1 = bf16), contiguous; w, b: d fp32;
// mean, rstd: rows fp32 each, or both null where no gradient will be taken. vec != 0
// only where d is a multiple of 16 / sizeof(dtype) and x, w, b and y are 16-byte aligned.
extern "C" int layernorm_fwd(const void* x, const void* w, const void* b, void* y, void* mean,
                             void* rstd, long long rows, int d, float eps, int dtype, int vec,
                             void* stream) {
  if (bad_args(rows, d, dtype) || ((mean == nullptr) != (rstd == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* mf = static_cast<float*>(mean);
  float* rf = static_cast<float*>(rstd);
  return by_dtype(dtype, [&](auto t) {
    using T = std::remove_pointer_t<decltype(t)>;
    return dispatch<T>(d, vec, [&](auto nv) {
      return launch_fwd<T, decltype(nv)::value>(static_cast<const T*>(x), wf, bf,
                                                static_cast<T*>(y), mf, rf, rows, d, eps, s);
    });
  });
}

// The [2][d] fp32 partial blocks layernorm_bwd writes for this input: its workspace is
// that many times 2·d floats. -1 on a bad argument.
extern "C" int layernorm_bwd_parts(long long rows, int d, int dtype, int vec) {
  if (bad_args(rows, d, dtype)) return -1;
  return by_dtype(dtype, [&](auto t) {
    using T = std::remove_pointer_t<decltype(t)>;
    return dispatch<T>(d, vec, [&](auto nv) { return bwd_parts<T, decltype(nv)::value>(rows); });
  });
}

// x, dy, dx: rows·d elements of the dtype, contiguous; mean, rstd: rows fp32 from
// layernorm_fwd; w: d fp32; part: the workspace of layernorm_bwd_parts(rows, d, dtype,
// vec) · 2·d fp32, written whole. vec != 0 only where d is a multiple of
// 16 / sizeof(dtype) and x, dy, w and dx are 16-byte aligned. One launch over the rows:
// dx, and the partial sums of dw and db.
extern "C" int layernorm_bwd(const void* x, const void* dy, const void* mean, const void* rstd,
                             const void* w, void* dx, void* part, long long rows, int d,
                             int dtype, int vec, void* stream) {
  if (bad_args(rows, d, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_dtype(dtype, [&](auto t) {
    using T = std::remove_pointer_t<decltype(t)>;
    return dispatch<T>(d, vec, [&](auto nv) {
      return launch_bwd<T, decltype(nv)::value>(
          static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const float*>(mean),
          static_cast<const float*>(rstd), static_cast<const float*>(w), static_cast<T*>(dx),
          static_cast<float*>(part), rows, d, s);
    });
  });
}

// dw, db: d fp32, written whole: the column sums of part's `parts` [2][d] blocks, which
// layernorm_bwd wrote. One launch.
extern "C" int layernorm_bwd_reduce(const void* part, void* dw, void* db, int parts, int d,
                                    void* stream) {
  if (parts <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  layernorm_bwd_reduce_kernel<<<(d + 31) / 32, dim3(32, RED_ROWS), 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), static_cast<float*>(db), parts, d);
  return (int)cudaGetLastError();
}
