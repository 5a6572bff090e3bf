// Flash-attention forward for NVIDIA Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::_attn_kernel
// (launched by flash_attention_bhsd, pl.pallas_call at line 110; wrapper
// src/repro/kernels/ops.py::flash_attention). It computes the same function,
// softmax(q·kᵀ·scale, mask)·v with an online softmax in fp32, but is laid out
// for a GPU rather than copied block by block:
//
//   * Layout. One thread block per (b·h, 64-row query tile); the KV dimension
//     is a loop inside the block (the TPU's sequential third grid axis has no
//     counterpart here). q/k/v/o stay in the model's [B, S, H, D] layout, so no
//     transpose runs before or after the kernel.
//   * Memory. The Q tile and each 64-row K/V tile are staged in shared memory
//     as fp32; the running max, denominator and the 64×D accumulator stay in
//     fp32 registers (4 query rows × ⌈D/16⌉ columns per thread).
//   * GQA. Query head h reads KV head h / (H/KV); repeated K/V never exists.
//   * Masks. Causal (k ≤ q, indices from 0), sliding window (q − k < window)
//     and the ragged edge are computed from tile offsets. The KV loop starts at
//     the first and stops after the last tile any row of the query tile can
//     see, where the Pallas grid visits every block and skips the dead ones.
//   * Fully masked rows. A masked score is -inf and the row max is guarded:
//     while a row has seen no live key its max stays -inf and it takes no
//     exp(0) contributions (the Pallas kernel relies on a later tile resetting
//     the row). A row with no live key at all ends at 0, as in the Pallas kernel
//     when every block of the row is skipped.
//   * Head dims. Any D ≤ 128 that is a multiple of 8 (32, 64, 80, 128, ...).
//   * Types. fp32 or bf16 in and out (output in q's type); fp32 math inside.
//
// Bound on the H100. The work is 4·D FLOPs for each live (query, key) pair
// against reading q, k, v and writing o once. At danube's prefill shape
// (B=2, S=4608, H=32, KV=8, D=80, window 4096) that is 2.1e11 FLOPs against
// 118 MB in bf16: 0.22 ms at the 989 TFLOP/s bf16 tensor-core peak, 0.035 ms
// at 3.35 TB/s, so the operations bound it. This first kernel does its
// products with fp32 FMAs on the CUDA cores (67 TFLOP/s peak; fp32 inputs must
// agree with the plain version to 1e-4, which TF32 would not), and the
// shared-memory operand loads of its 4×4 register tiles limit it well below
// that peak. What its design does about the bound: it never writes the S×S
// score matrix to device memory, reads each K/V tile once per 64 query rows,
// and skips the tiles outside the causal window. Moving the two products onto
// the tensor cores (mma.sync, then wgmma with TMA-fed tiles) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per KV tile
constexpr int THREADS = 256;  // 16 × 16: thread (ty, tx) owns rows ty + 16·i, columns tx + 16·j
constexpr int MAX_D = 128;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int sq, skv, h, kv, d, n_rep, causal, window;  // window <= 0: none
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as a dtype cast does
}

// 64 rows × d columns of src (row r at src + (row0 + r)·row_stride) into dst
// (row stride ld floats); rows at or past n_rows are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, int row0,
                                          int n_rows, int64_t row_stride, int d) {
  for (int e = threadIdx.x; e < 64 * d; e += THREADS) {
    const int r = e / d;
    const int c = e - r * d;
    const int row = row0 + r;
    dst[r * ld + c] = row < n_rows ? to_f32(src[row * row_stride + c]) : 0.f;
  }
}

__device__ __forceinline__ float row_max16(float x) {
  // the 16 lanes of a row group share ty; xor offsets below 16 stay inside it
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int NC>  // NC = ⌈d / 16⌉ accumulator columns per thread
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const Params p) {
  extern __shared__ float smem[];
  const int d = p.d;
  const int ld = d + 1;  // odd row stride: the 16 threads reading a K column hit 16 banks
  float* sQ = smem;            // [BQ][d + 1]
  float* sK = sQ + BQ * ld;    // [BK][d + 1]
  float* sV = sK + BK * ld;    // [BK][d]
  float* sP = sV + BK * d;     // [BQ][BK + 1]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the longest causal tiles start first
  const int b = bh / p.h;
  const int hh = bh - b * p.h;
  const int kvh = hh / p.n_rep;
  const int64_t q_stride = (int64_t)p.h * d;
  const int64_t kv_stride = (int64_t)p.kv * d;
  const T* qg = static_cast<const T*>(p.q) + ((int64_t)b * p.sq * p.h + hh) * d;
  const T* kg = static_cast<const T*>(p.k) + ((int64_t)b * p.skv * p.kv + kvh) * d;
  const T* vg = static_cast<const T*>(p.v) + ((int64_t)b * p.skv * p.kv + kvh) * d;
  T* og = static_cast<T*>(p.o) + ((int64_t)b * p.sq * p.h + hh) * d;

  load_tile(sQ, ld, qg, q0, p.sq, q_stride, d);

  // keys any row of this tile can see: [k_lo, k_hi)
  int k_lo = 0;
  int k_hi = p.skv;
  if (p.causal) k_hi = min(k_hi, min(q0 + BQ, p.sq));
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
  }

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the last tile's sK/sV/sP reads are done (and sQ is in)
    load_tile(sK, ld, kg, k0, p.skv, kv_stride, d);
    load_tile(sV, d, vg, k0, p.skv, kv_stride, d);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < d; ++c) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sQ[(ty + 16 * i) * ld + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = sK[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool live = kj < p.skv && (!p.causal || kj <= qi) &&
                          (p.window <= 0 || qi - kj < p.window);
        s[i][j] = live ? s[i][j] * p.scale : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mt));
      float corr = 1.f;
      float rs = 0.f;
      if (m_new == -INFINITY) {  // no live key yet in this row: contribute nothing
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      } else {
        corr = expf(m[i] - m_new);  // exp(-inf) = 0 on the row's first live tile
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = expf(s[i][j] - m_new);
          rs += s[i][j];
        }
      }
      l[i] = l[i] * corr + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[i][n] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) sP[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pa[4], vb[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = sP[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int col = tx + 16 * n;
        vb[n] = col < d ? sV[kk * d + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[i][n] = fmaf(pa[i], vb[n], acc[i][n]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int col = tx + 16 * n;
      if (col < d) og[qi * q_stride + col] = from_f32<T>(acc[i][n] / denom);
    }
  }
}

size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)BQ * (d + 1) + (size_t)BK * (d + 1) + (size_t)BK * d +
                          (size_t)BQ * (BK + 1));
}

template <typename T, int NC>
cudaError_t launch(const Params& p, int bh, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.d);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.sq + BQ - 1) / BQ);
  flash_fwd_kernel<T, NC><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int bh, cudaStream_t stream) {
  switch ((p.d + 15) / 16) {
    case 1: return launch<T, 1>(p, bh, stream);
    case 2: return launch<T, 2>(p, bh, stream);
    case 3: return launch<T, 3>(p, bh, stream);
    case 4: return launch<T, 4>(p, bh, stream);
    case 5: return launch<T, 5>(p, bh, stream);
    case 6: return launch<T, 6>(p, bh, stream);
    case 7: return launch<T, 7>(p, bh, stream);
    case 8: return launch<T, 8>(p, bh, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: [B, Sq, H, D], k/v: [B, Skv, KV, D], o: [B, Sq, H, D], all contiguous and of one
// type (dtype 0: fp32, 1: bf16). window <= 0 means no window. Launches on `stream`
// and returns the launch's cudaError_t (0 on success); does not synchronise.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int b,
                                   int sq, int skv, int h, int kv, int d, int causal, int window,
                                   float scale, int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || h <= 0 || kv <= 0 || h % kv != 0 || d <= 0 ||
      d > MAX_D || d % 8 != 0 || (sq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, o, sq, skv, h, kv, d, h / kv, causal, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(p, b * h, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(p, b * h, s);
  return (int)cudaErrorInvalidValue;
}
