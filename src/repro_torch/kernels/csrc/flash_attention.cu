// Flash-attention forward for NVIDIA Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::_attn_kernel
// (launched by flash_attention_bhsd, pl.pallas_call at line 110; wrapper
// src/repro/kernels/ops.py::flash_attention). It computes the same function,
// softmax(q·kᵀ·scale, mask)·v with an online softmax in fp32, but is laid out
// for a GPU rather than copied block by block. Two kernels share the contract:
//
//   * bf16: Hopper's tensor cores. One block per (b·h, 192-row query tile):
//     a producer warp that issues TMA copies and three consumer warpgroups of
//     64 query rows each (setmaxnreg moves registers from the producer's
//     warpgroup to the consumers). The producer copies Q once, then streams
//     64-key K/V tiles through a 4-stage ring in shared memory, with an
//     mbarrier per slot for "full" (the copy's bytes landed) and "empty" (every
//     consumer thread is done with it). The consumers run S = Q·Kᵀ and O += P·V
//     as wgmma.mma_async m64nNk16 (bf16 in, fp32 accumulate): Q and K from
//     shared memory, P from registers (the S accumulators rounded to bf16 and
//     repacked into A fragments, with no trip through shared memory), V from
//     shared memory read transposed. Tile j's Q·Kᵀ is issued before tile
//     j − 1's P·V, and its online softmax (quad shuffles for the row max, exp2
//     with the scale folded into log2 e) runs while that P·V does. Rounding P
//     to bf16 is what the dense path does (models/attention.py::dense_attention
//     casts P before P·V); the Pallas kernel keeps P in fp32.
//   * fp32: CUDA-core FMAs. fp32 inputs must agree with the plain version to
//     1e-4, which TF32 tensor cores would not. One block of 256 threads per
//     (b·h, 64-row query tile); Q and each K/V tile staged in shared memory as
//     fp32, 4×4 register tiles per thread, P through shared memory.
//
// What both keep from the Pallas kernel:
//   * Layout. q/k/v/o stay in the model's [B, S, H, D] layout, so no
//     transpose runs before or after the kernel. The KV dimension is a loop
//     inside the block (the TPU's sequential third grid axis has no
//     counterpart here).
//   * GQA. Query head h reads KV head h / (H/KV); repeated K/V never exists.
//   * Masks. Causal (k ≤ q, indices from 0), sliding window (q − k < window)
//     and the ragged edge are computed from tile offsets. The KV loop starts at
//     the first and stops after the last tile any row of the query tile can
//     see, where the Pallas grid visits every block and skips the dead ones;
//     the longest query tiles are scheduled first. The bf16 kernel masks only
//     the tiles that cross the diagonal, the window's edge or Skv, and a
//     warpgroup skips the math of the tiles none of its rows can see.
//   * Fully masked rows. A masked score is -inf and the row max is guarded:
//     while a row has seen no live key it takes no exp(0) contributions. A row
//     with no live key at all ends at 0, as in the Pallas kernel when every
//     block of the row is skipped.
//   * Head dims. Any D ≤ 128 that is a multiple of 8. The bf16 kernel pads D to
//     a multiple of 16 with zeros (D = 72 runs as 80): TMA's out-of-range fill
//     writes them, since the tensor maps give D's true extent.
//
// Bound on the H100. The work is 4·D FLOPs for each live (query, key) pair
// against reading q, k, v and writing o once. At danube's prefill shape
// (B=2, S=4608, H=32, KV=8, D=80, window 4096) that is 2.1e11 FLOPs against
// 118 MB in bf16: 0.22 ms at the 989 TFLOP/s bf16 tensor-core peak, 0.035 ms
// at 3.35 TB/s, so the operations bound it; in fp32 3.2 ms at the 67 TFLOP/s
// CUDA-core peak. What the design does about it: the S×S score matrix never
// reaches device memory, tiles outside the causal window are skipped, and the
// bf16 products run on wgmma. Each block re-reads the K/V tiles of its window
// from L2, so the bf16 block is as tall as the registers allow (192 rows),
// and each TMA row is one full 32-byte sector (16 columns, 32-byte swizzle).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_D = 128;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int sq, skv, h, kv, d, n_rep, causal, window;  // window <= 0: none
  float scale;
};

// keys any row of the query tile [q0, q0 + rows) can see: [lo, hi)
__device__ __forceinline__ void key_range(const Params& p, int q0, int rows, int* lo, int* hi) {
  *lo = 0;
  *hi = p.skv;
  if (p.causal) *hi = min(*hi, min(q0 + rows, p.sq));
  if (p.window > 0) *lo = max(0, q0 - p.window + 1);
}

__device__ __forceinline__ bool live(const Params& p, int qi, int kj) {
  return kj < p.skv && (!p.causal || kj <= qi) && (p.window <= 0 || qi - kj < p.window);
}

// ===========================================================================
// fp32: CUDA-core FMA kernel
// ===========================================================================
namespace f32 {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per KV tile
constexpr int THREADS = 256;  // 16 × 16: thread (ty, tx) owns rows ty + 16·i, columns tx + 16·j

// 64 rows × d columns of src (row r at src + (row0 + r)·row_stride) into dst
// (row stride ld floats); rows at or past n_rows are zero.
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src, int row0,
                                          int n_rows, int64_t row_stride, int d) {
  for (int e = threadIdx.x; e < 64 * d; e += THREADS) {
    const int r = e / d;
    const int c = e - r * d;
    const int row = row0 + r;
    dst[r * ld + c] = row < n_rows ? src[row * row_stride + c] : 0.f;
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

template <int NC>  // NC = ⌈d / 16⌉ accumulator columns per thread
__global__ void __launch_bounds__(THREADS) flash_fwd_f32_kernel(const Params p) {
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
  const float* qg = static_cast<const float*>(p.q) + ((int64_t)b * p.sq * p.h + hh) * d;
  const float* kg = static_cast<const float*>(p.k) + ((int64_t)b * p.skv * p.kv + kvh) * d;
  const float* vg = static_cast<const float*>(p.v) + ((int64_t)b * p.skv * p.kv + kvh) * d;
  float* og = static_cast<float*>(p.o) + ((int64_t)b * p.sq * p.h + hh) * d;

  load_tile(sQ, ld, qg, q0, p.sq, q_stride, d);

  int k_lo, k_hi;
  key_range(p, q0, BQ, &k_lo, &k_hi);

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
        s[i][j] = live(p, qi, k0 + tx + 16 * j) ? s[i][j] * p.scale : -INFINITY;
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
      if (col < d) og[qi * q_stride + col] = acc[i][n] / denom;
    }
  }
}

size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)BQ * (d + 1) + (size_t)BK * (d + 1) + (size_t)BK * d +
                          (size_t)BQ * (BK + 1));
}

}  // namespace f32

// ===========================================================================
// bf16: Hopper tensor-core kernel (a TMA producer, wgmma consumer warpgroups)
// ===========================================================================
namespace wg {

using bf16 = __nv_bfloat16;

constexpr int CONSUMERS = 3;                    // consumer warpgroups, 64 query rows each
constexpr int BQ = 64 * CONSUMERS;              // query rows per block
constexpr int BK = 64;                          // keys per K/V tile
constexpr int STAGES = 4;                       // K/V tiles in the ring
constexpr int THREADS = 128 * (1 + CONSUMERS);  // warpgroup 0 produces
constexpr int PRODUCER_REGS = 24;               // setmaxnreg: 65536 registers in all
constexpr int CONSUMER_REGS = 160;
constexpr int PW = 16;  // columns per panel: one 32-byte row, the swizzle's width
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory. A tile of R rows and DP columns is DP/16 panels of [R][16]
// bf16, each filled by one TMA box with the 32-byte swizzle, the layout wgmma
// reads as a "32B-swizzled" matrix: K-major for Q and K, N-major for V.
template <int DP> struct Smem {
  bf16 q[DP / PW][BQ][PW];
  bf16 k[STAGES][DP / PW][BK][PW];
  bf16 v[STAGES][DP / PW][BK][PW];
  uint64_t full_q, full_k[STAGES], full_v[STAGES], empty[STAGES];
};
// the block's dynamic shared memory: the tiles, plus room to start them on a
// 1024-byte boundary
template <int DP> constexpr size_t smem_bytes() { return sizeof(Smem<DP>) + 1024; }

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// -- mbarriers ----------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one [rows, 16] box of a [B, S, heads, D] tensor at (b, row0, head, col0) into dst
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int col0, int head,
                                         int row0, int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col0), "r"(head), "r"(row0), "r"(b),
      "r"(smem_u32(bar))
      : "memory");
}

// -- wgmma ----------------------------------------------------------------------
// A shared-memory matrix descriptor with the 32-byte swizzle. lbo and sbo are
// the byte distances between 8×16-byte core matrices along K and along M/N for
// K-major operands (lbo unused: a k-step lies in one 32-byte row), and along
// N and along K for N-major ones.
__device__ __forceinline__ uint64_t desc(const void* ptr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(ptr) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (3ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {  // ≤ N groups in flight
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler off registers that an issued wgmma still reads or writes.
template <int N> __device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N> __device__ __forceinline__ void reg_fence(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d (+)= A·B, m64n64k16: A [64 × 16] and B [64 × 16] from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d += A·B, m64nNk16: A [64 × 16] from registers (the mma.sync A-fragment
// layout, per warp 16 rows), B [16 × N] from shared memory, N-major (transposed)
template <int N> __device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                                        uint64_t desc_b);

template <> __device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4],
                                                     uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                                     uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<48>(float (&d)[24], const uint32_t (&a)[4],
                                                     uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                                     uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<80>(float (&d)[40], const uint32_t (&a)[4],
                                                     uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<96>(float (&d)[48], const uint32_t (&a)[4],
                                                     uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<112>(float (&d)[56], const uint32_t (&a)[4],
                                                     uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                                     uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even, as a cast does
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, one MUFU op; -inf → 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const Params p) {
  constexpr int PANELS = DP / PW;
  constexpr int NS = BK / 8;  // 8-key column blocks of S
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<DP>& sm = *reinterpret_cast<Smem<DP>*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the longest causal tiles start first
  const int b = bh / p.h;
  const int hh = bh - b * p.h;
  const int kvh = hh / p.n_rep;
  int k_lo, k_hi;
  key_range(p, q0, BQ, &k_lo, &k_hi);
  const int t_lo = k_lo / BK;
  const int n_tiles = max(0, (k_hi + BK - 1) / BK - t_lo);

  if (threadIdx.x == 0) {
    mbar_init(&sm.full_q, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full_k[s], 1);
      mbar_init(&sm.full_v[s], 1);
      mbar_init(&sm.empty[s], 128 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // the producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == 0 && lane == 0) {
      constexpr uint32_t Q_BYTES = BQ * DP * sizeof(bf16), KV_BYTES = BK * DP * sizeof(bf16);
      mbar_expect_tx(&sm.full_q, Q_BYTES);
#pragma unroll
      for (int c = 0; c < PANELS; ++c) tma_load(sm.q[c], &tq, PW * c, hh, q0, b, &sm.full_q);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES;
        const int k0 = (t_lo + it) * BK;
        mbar_wait(&sm.empty[st], ((it / STAGES) & 1) ^ 1);  // a fresh slot passes at once
        mbar_expect_tx(&sm.full_k[st], KV_BYTES);
#pragma unroll
        for (int c = 0; c < PANELS; ++c)
          tma_load(sm.k[st][c], &tk, PW * c, kvh, k0, b, &sm.full_k[st]);
        mbar_expect_tx(&sm.full_v[st], KV_BYTES);
#pragma unroll
        for (int c = 0; c < PANELS; ++c)
          tma_load(sm.v[st][c], &tv, PW * c, kvh, k0, b, &sm.full_v[st]);
      }
    }
    return;
  }

  // a consumer warpgroup: rows [row0, row0 + 64); thread (warp w, lane) holds
  // rows r0 and r0 + 8, r0 = row0 + 16·(w mod 4) + lane/4, in wgmma's
  // accumulator layout (that of mma.sync per warp)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int cg = warp / 4 - 1;
  const int row0 = q0 + 64 * cg;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = row0 + 16 * (warp & 3) + g;
  const float sl2 = p.scale * LOG2E;
  constexpr uint32_t CORE = 8 * PW * sizeof(bf16);  // 8 rows of one panel
  const uint64_t dq = desc(&sm.q[0][64 * cg][0], 16, CORE);

  float m[2] = {-INFINITY, -INFINITY};  // running row max (raw scores)
  float l[2] = {0.f, 0.f};              // this thread's part of the row sums
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;

  // the tiles this warpgroup's rows see, [it_lo, it_hi); the others are only
  // released, in order, so that the ring stays in step
  int it_lo = n_tiles, it_hi = n_tiles;
  if (row0 < p.sq) {
    int lo, hi;
    key_range(p, row0, 64, &lo, &hi);
    it_lo = min(n_tiles, max(0, lo / BK - t_lo));
    it_hi = max(it_lo, min(n_tiles, (hi + BK - 1) / BK - t_lo));
  }
  auto release = [&](int it) { mbar_arrive(&sm.empty[it % STAGES]); };
  auto skip = [&](int it) {  // the copies landed: the slot may be refilled
    mbar_wait(&sm.full_k[it % STAGES], (it / STAGES) & 1);
    mbar_wait(&sm.full_v[it % STAGES], (it / STAGES) & 1);
    release(it);
  };
  // S = Q·Kᵀ of tile it into s, asynchronously: s[4j + e] holds key
  // k0 + 8j + 2t + (e & 1) of row r0 + 8·(e >> 1)
  float s[BK / 2];
  auto issue_qk = [&](int it) {
    const int st = it % STAGES;
    mbar_wait(&sm.full_k[st], (it / STAGES) & 1);
    const uint64_t dk = desc(&sm.k[st][0][0][0], 16, CORE);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < PANELS; ++ks)  // a 16-column k-step is one panel
      wgmma_ss_n64(s, dq + ((ks * BQ * PW * sizeof(bf16)) >> 4),
                   dk + ((ks * BK * PW * sizeof(bf16)) >> 4), ks > 0);
    wgmma_commit();
  };
  uint32_t pa[BK / 16][4];  // P of the tile whose P·V is in flight, as A fragments
  // O += P·V of tile it, asynchronously; V [BK keys × DP] read N-major
  auto issue_pv = [&](int it) {
    const int st = it % STAGES;
    mbar_wait(&sm.full_v[st], (it / STAGES) & 1);
    const uint64_t dv = desc(&sm.v[st][0][0][0], BK * PW * sizeof(bf16), CORE);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<DP>(o, pa[kk], dv + ((2 * kk * CORE) >> 4));
    wgmma_commit();
  };
  // the mask and the online softmax of s (tile it), into pn and corr
  float corr[2];
  auto softmax = [&](int it, uint32_t (&pn)[BK / 16][4]) {
    const int k0 = (t_lo + it) * BK;
    // mask only a tile that crosses Skv, the causal diagonal or the window's edge
    if (k0 + BK > p.skv || (p.causal && k0 + BK - 1 > row0) ||
        (p.window > 0 && row0 + 63 - k0 >= p.window)) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!live(p, r0 + (e >> 1) * 8, k0 + 8 * j + 2 * t + (e & 1))) s[4 * j + e] = -INFINITY;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // a quad (4 lanes) holds one row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r] * sl2;  // no live key yet: exp2(-inf) = 0
      corr[r] = ex2(m[r] * sl2 - base[r]);                // 0 on the row's first live tile
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * j + e] = ex2(fmaf(s[4 * j + e], sl2, -base[e >> 1]));
        l[e >> 1] += s[4 * j + e];
      }
      // keys 16kk.. of P are S blocks 2kk and 2kk + 1: the A fragment's halves
      pn[j / 2][2 * (j & 1)] = pack_bf16(s[4 * j], s[4 * j + 1]);
      pn[j / 2][2 * (j & 1) + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }
  };
  auto rescale = [&]() {
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      o[4 * n] *= corr[0];
      o[4 * n + 1] *= corr[0];
      o[4 * n + 2] *= corr[1];
      o[4 * n + 3] *= corr[1];
    }
  };

  mbar_wait(&sm.full_q, 0);
  for (int it = 0; it < it_lo; ++it) skip(it);
  if (it_lo < it_hi) {
    issue_qk(it_lo);
    wgmma_wait<0>();
    reg_fence(s);
    softmax(it_lo, pa);
    // tile it's Q·Kᵀ is issued before tile it − 1's P·V, and its softmax
    // runs while that P·V does
    for (int it = it_lo + 1; it < it_hi; ++it) {
      issue_qk(it);
      reg_fence(o);
      issue_pv(it - 1);
      wgmma_wait<1>();  // the older group: S of tile it
      reg_fence(s);
      uint32_t pn[BK / 16][4];
      softmax(it, pn);
      wgmma_wait<0>();  // P·V of tile it − 1
      reg_fence(o);
      reg_fence(pa);
      release(it - 1);
      rescale();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[kk][i] = pn[kk][i];
    }
    reg_fence(o);
    issue_pv(it_hi - 1);
    wgmma_wait<0>();
    reg_fence(o);
    reg_fence(pa);
    release(it_hi - 1);
  }
  for (int it = it_hi; it < n_tiles; ++it) skip(it);

  // O / l, staged in this warpgroup's rows of sm.q (its Q is read no more),
  // then written as 16-byte rows
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);  // a row with no live key: O = 0, l = 0 → 0
  }
  const int lr = 64 * cg + 16 * (warp & 3) + g;  // row r0 within the block
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    bf16* at = &sm.q[n / 2][lr][8 * (n % 2) + 2 * t];
    *reinterpret_cast<uint32_t*>(at) = pack_bf16(o[4 * n] * inv[0], o[4 * n + 1] * inv[0]);
    *reinterpret_cast<uint32_t*>(at + 8 * PW) =
        pack_bf16(o[4 * n + 2] * inv[1], o[4 * n + 3] * inv[1]);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cg) : "memory");  // this warpgroup only
  const int d = p.d;
  const int64_t q_stride = (int64_t)p.h * d;
  bf16* og = static_cast<bf16*>(p.o) + ((int64_t)b * p.sq * p.h + hh) * d;
  for (int c = threadIdx.x - 128 * (cg + 1); c < 64 * (DP / 8); c += 128) {
    const int r = c / (DP / 8);
    const int chunk = c - r * (DP / 8);  // 8 columns
    const int row = row0 + r;
    if (8 * chunk < d && row < p.sq)
      *reinterpret_cast<uint4*>(og + row * q_stride + 8 * chunk) =
          *reinterpret_cast<const uint4*>(&sm.q[chunk / 2][64 * cg + r][8 * (chunk % 2)]);
  }
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled is a driver call; the library links the runtime
// only, which hands out the driver's entry point
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A [B, S, heads, D] bf16 tensor as a TMA map with [rows, 16]-column boxes of
// one head and the 32-byte swizzle. D is the true extent: a box past it reads
// zeros. False if the driver refuses it.
bool encode_map(CUtensorMap* map, const void* ptr, int b, int s, int heads, int d, int rows) {
  const EncodeTiled encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * sizeof(bf16), (cuuint64_t)heads * d * sizeof(bf16),
                                 (cuuint64_t)s * heads * d * sizeof(bf16)};  // dims 1..3, bytes
  const cuuint32_t box[4] = {PW, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace wg

// One kernel instantiation with its launch shape.
struct Plan {
  const void* fn;
  int threads;
  int rows;  // query rows per block
  size_t smem;
};

template <int NC> Plan f32_plan(int d) {
  return {reinterpret_cast<const void*>(f32::flash_fwd_f32_kernel<NC>), f32::THREADS, f32::BQ,
          f32::smem_bytes(d)};
}
template <int DP> Plan bf16_plan() {
  return {reinterpret_cast<const void*>(wg::flash_fwd_bf16_kernel<DP>), wg::THREADS, wg::BQ,
          wg::smem_bytes<DP>()};
}

// The kernel for head dim d (a multiple of 8, at most 128) and dtype (0: fp32,
// 1: bf16), with its dynamic shared memory allowed; a d or dtype neither
// kernel takes is cudaErrorInvalidValue.
cudaError_t plan_for(int d, int dtype, Plan* out) {
  *out = Plan{nullptr, 0, 0, 0};
  if (d <= 0 || d > MAX_D || d % 8 != 0) return cudaErrorInvalidValue;
  const int blocks16 = (d + 15) / 16;
  if (dtype == 0) {
    switch (blocks16) {
      case 1: *out = f32_plan<1>(d); break;
      case 2: *out = f32_plan<2>(d); break;
      case 3: *out = f32_plan<3>(d); break;
      case 4: *out = f32_plan<4>(d); break;
      case 5: *out = f32_plan<5>(d); break;
      case 6: *out = f32_plan<6>(d); break;
      case 7: *out = f32_plan<7>(d); break;
      case 8: *out = f32_plan<8>(d); break;
    }
  } else if (dtype == 1) {
    switch (blocks16) {
      case 1: *out = bf16_plan<16>(); break;
      case 2: *out = bf16_plan<32>(); break;
      case 3: *out = bf16_plan<48>(); break;
      case 4: *out = bf16_plan<64>(); break;
      case 5: *out = bf16_plan<80>(); break;
      case 6: *out = bf16_plan<96>(); break;
      case 7: *out = bf16_plan<112>(); break;
      case 8: *out = bf16_plan<128>(); break;
    }
  }
  if (out->fn == nullptr) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(out->fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)out->smem);
}

}  // namespace

// q: [B, Sq, H, D], k/v: [B, Skv, KV, D], o: [B, Sq, H, D], all contiguous and of one
// type (dtype 0: fp32, 1: bf16); bf16 pointers start on 16-byte boundaries (TMA's
// rule). window <= 0 means no window. Launches on `stream` and returns the
// launch's cudaError_t (0 on success); does not synchronise.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int b,
                                   int sq, int skv, int h, int kv, int d, int causal, int window,
                                   float scale, int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || h <= 0 || kv <= 0 || h % kv != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) & 15))
    return (int)cudaErrorMisalignedAddress;
  Plan plan;
  cudaError_t err = plan_for(d, dtype, &plan);
  if (err != cudaSuccess) return (int)err;
  const int q_tiles = (sq + plan.rows - 1) / plan.rows;
  if (q_tiles > 65535) return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, sq, skv, h, kv, d, h / kv, causal, window, scale};
  const dim3 grid(b * h, q_tiles);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    void* args[] = {&p};
    err = cudaLaunchKernel(plan.fn, grid, dim3(plan.threads), args, plan.smem, s);
  } else {
    // the maps hold the pointers, so they are encoded for each call
    CUtensorMap tq, tk, tv;
    if (!wg::encode_map(&tq, q, b, sq, h, d, wg::BQ) ||
        !wg::encode_map(&tk, k, b, skv, kv, d, wg::BK) ||
        !wg::encode_map(&tv, v, b, skv, kv, d, wg::BK))
      return (int)cudaErrorInvalidValue;
    void* args[] = {&tq, &tk, &tv, &p};
    err = cudaLaunchKernel(plan.fn, grid, dim3(plan.threads), args, plan.smem, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The launch shape of the kernel flash_attention_fwd runs for head dim d and
// dtype: threads and query rows per block, dynamic shared memory in bytes,
// and how many blocks fit on one SM. Returns a cudaError_t.
extern "C" int flash_attention_launch_info(int d, int dtype, int* threads, int* rows,
                                           int* smem_bytes, int* blocks_per_sm) {
  Plan plan;
  cudaError_t err = plan_for(d, dtype, &plan);
  if (err != cudaSuccess) return (int)err;
  *threads = plan.threads;
  *rows = plan.rows;
  *smem_bytes = (int)plan.smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, plan.fn,
                                                            plan.threads, plan.smem);
}
