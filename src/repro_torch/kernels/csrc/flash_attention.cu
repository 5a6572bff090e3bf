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
//   * fp32: the tensor cores at fp32 accuracy. fp32 inputs must agree with the
//     plain version to 1e-4, which one TF32 product per fp32 product misses
//     (TF32 keeps 10 mantissa bits: a score of 30 moves by ~0.015). Each
//     operand is split into hi = x truncated to TF32 (the raw bits, which the
//     tensor core truncates) and lo = x − hi (exact), and each product is
//     summed as lo·hi + hi·lo, then hi·hi (3xTF32, as CUTLASS's
//     OpMultiplyAddFastF32), ~1e-6 relative. One block of 8 warps
//     per (b·h, 128-row query tile), 16 rows a warp; Q in shared memory, K/V
//     tiles through a 2–3-deep cp.async ring (16-byte copies, zero-filled
//     past Skv and D); S = Q·Kᵀ and O += P·V as mma.sync m16n8k8 TF32, P
//     split from the S accumulators in registers. tf32 wgmma reads only
//     K-major operands from shared memory, which V is not, and mma.sync
//     leaves P in registers and V's rows where they landed.
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
//     the longest query tiles are scheduled first. Both kernels mask only the
//     tiles that cross the diagonal, the window's edge or Skv, and a warpgroup
//     (bf16) or a warp (fp32) skips the math of the tiles none of its rows see.
//   * Fully masked rows. A masked score is -inf and the row max is guarded:
//     while a row has seen no live key it takes no exp(0) contributions. A row
//     with no live key at all ends at 0, as in the Pallas kernel when every
//     block of the row is skipped.
//   * Head dims. Any D ≤ 128 that is a multiple of 8. Both kernels pad D to a
//     multiple of 16 with zeros (D = 72 runs as 80): TMA's out-of-range fill
//     writes them in bf16, since the tensor maps give D's true extent, and
//     cp.async's zero fill in fp32.
//
// Bound on the H100. The work is 4·D FLOPs for each live (query, key) pair
// against reading q, k, v and writing o once. At danube's prefill shape
// (B=2, S=4608, H=32, KV=8, D=80, window 4096) that is 2.1e11 FLOPs against
// 118 MB in bf16: 0.22 ms at the 989 TFLOP/s bf16 tensor-core peak, 0.035 ms
// at 3.35 TB/s, so the operations bound it. In fp32, three TF32 products per
// FLOP at the 495 TFLOP/s TF32 peak, 1.3 ms (3.2 ms at the 67 TFLOP/s
// CUDA-core FMA peak, which the fp32 kernel beats). What the design does
// about it: the S×S score matrix never reaches device memory, tiles outside
// the causal window are skipped, and both types' products run on the tensor
// cores. Each block re-reads the K/V tiles of its window from L2, so the bf16
// block is as tall as the registers allow (192 rows), and each TMA row is one
// full 32-byte sector (16 columns, 32-byte swizzle). The fp32 kernel issues
// ~1,700 other instructions (splits, shared loads, softmax) beside every 768
// mma.sync of a 64-key tile at D = 128, and mma.sync's TF32 rate on Hopper
// is below wgmma's.

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

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, one MUFU op; -inf → 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ===========================================================================
// fp32: tensor cores at fp32 accuracy (3xTF32 mma.sync)
// ===========================================================================
namespace f32 {

constexpr int WARPS = 8;           // 16 query rows each
constexpr int BQ = 16 * WARPS;     // query rows per block
constexpr int BK = 64;             // keys per K/V tile
constexpr int THREADS = 32 * WARPS;

// Per padded head dim DP (a multiple of 16): the K/V ring's depth and the row
// strides in shared memory, in floats. A warp's 16-byte reads of Q or K rows
// (lanes g = 0, 1 of a quarter-warp on rows g, columns 4t..4t+3) fall in
// distinct banks when LDK ≡ 16 (mod 32); its 8-byte reads of V rows (lanes
// t on rows 2t, 2t + 1, columns 2g..2g+1) when LDV ≡ 4 (mod 16).
template <int DP> struct Cfg {
  static constexpr int STAGES = DP <= 96 ? 3 : 2;
  static constexpr int LDK = DP % 32 == 0 ? DP + 16 : DP;
  static constexpr int LDV = DP + 4;
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)BQ * LDK + (size_t)STAGES * BK * (LDK + LDV));
};

// 16 bytes from src to dst, or zeros where !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {  // ≤ N groups pending
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + n) of a [S, heads, D] slab (row stride `stride` floats)
// into dst (row stride ld), as 16-byte copies; rows past `limit` and columns
// past d are zeros
template <int DP>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, int row0, int n,
                                          int limit, int64_t stride, int d) {
  constexpr int CHUNKS = DP / 4;
  for (int e = threadIdx.x; e < n * CHUNKS; e += THREADS) {
    const int r = e / CHUNKS;
    const int c = e - r * CHUNKS;
    const bool valid = row0 + r < limit && 4 * c < d;
    cp_async16(dst + r * ld + 4 * c, valid ? src + (row0 + r) * stride + 4 * c : src, valid);
  }
}

// x = hi + lo. hi is x's own bits: the tensor core reads a TF32 operand's top
// 19 bits (10 mantissa bits) and drops the rest. lo = x − (those 19 bits),
// exact in fp32, read to TF32 in turn. Two instructions (LOP3, FADD); a
// split through cvt.rna.tf32.f32 takes five on sm_90a.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}

// d += A·B, m16n8k8, TF32 in, fp32 accumulate. A (row-major 16 × 8):
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 × 8):
// b0 (t, g), b1 (t + 4, g); d: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A·B at fp32 accuracy: lo·hi and hi·lo first, then hi·hi (lo·lo, ~2^-22
// of the product, is left out)
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(d, al, bh[0], bh[1]);
  mma(d, ah, bl[0], bl[1]);
  mma(d, ah, bh[0], bh[1]);
}

// One block per (b·h, 128-row query tile); warp w owns rows q0 + 16w .. + 15,
// lane (g, t) = (lane / 4, lane % 4) rows g and g + 8 of them. Q stays in
// shared memory; K/V tiles stream through a STAGES-deep cp.async ring.
//
// Both products run on mma.sync m16n8k8 in TF32 as three terms. The sums
// over D and over keys take their terms in an order of our choosing, which
// lets every shared-memory read be a vector:
//   * S = Q·Kᵀ: a 16-column block c of D is two k-steps; in the first, A's
//     column t is column 16c + 4t and t + 4 is 16c + 4t + 1, in the second
//     16c + 4t + 2 and + 3. One 16-byte read of a Q row (or a K row) gives a
//     lane its A (or B) values of both k-steps.
//   * O += P·V: P's A fragment is S's accumulator as it stands: key 2t of an
//     8-key block is A's column t, key 2t + 1 column t + 4, so V's B rows
//     are keys 2t and 2t + 1. Output column n of the n-block pair (2c, 2c + 1)
//     is D column 16c + 2n + (0, 1): one 8-byte read of a V row feeds both
//     n-blocks, and a lane's four outputs of a row are D columns
//     16c + 4t .. + 3, one 16-byte store.
template <int DP>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_f32_kernel(const Params p) {
  using C = Cfg<DP>;
  constexpr int NC = DP / 16;   // 16-column blocks of D
  constexpr int NS = BK / 8;    // 8-key blocks of S
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                          // [BQ][LDK]
  float* sK = sQ + BQ * C::LDK;              // [STAGES][BK][LDK]
  float* sV = sK + C::STAGES * BK * C::LDK;  // [STAGES][BK][LDV]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the longest causal tiles start first
  const int b = bh / p.h;
  const int hh = bh - b * p.h;
  const int kvh = hh / p.n_rep;
  const int d = p.d;
  const int64_t q_stride = (int64_t)p.h * d;
  const int64_t kv_stride = (int64_t)p.kv * d;
  const float* qg = static_cast<const float*>(p.q) + ((int64_t)b * p.sq * p.h + hh) * d;
  const float* kg = static_cast<const float*>(p.k) + ((int64_t)b * p.skv * p.kv + kvh) * d;
  const float* vg = static_cast<const float*>(p.v) + ((int64_t)b * p.skv * p.kv + kvh) * d;
  float* og = static_cast<float*>(p.o) + ((int64_t)b * p.sq * p.h + hh) * d;

  int k_lo, k_hi;
  key_range(p, q0, BQ, &k_lo, &k_hi);
  const int t_lo = k_lo / BK;
  const int n_tiles = max(0, (k_hi + BK - 1) / BK - t_lo);
  auto load_tile = [&](int it) {
    const int st = it % C::STAGES;
    const int k0 = (t_lo + it) * BK;
    load_rows<DP>(sK + st * BK * C::LDK, C::LDK, kg, k0, BK, p.skv, kv_stride, d);
    load_rows<DP>(sV + st * BK * C::LDV, C::LDV, vg, k0, BK, p.skv, kv_stride, d);
  };

  // Q with tile 0 in the first group; one group per ring slot, empty or not,
  // so that "≤ STAGES − 2 pending" always means "tile it landed"
  load_rows<DP>(sQ, C::LDK, qg, q0, BQ, p.sq, q_stride, d);
#pragma unroll
  for (int it = 0; it < C::STAGES - 1; ++it) {
    if (it < n_tiles) load_tile(it);
    cp_async_commit();
  }

  // this warp's rows and the tiles they see, [it_lo, it_hi)
  const int wr0 = q0 + 16 * warp;
  const int r0 = wr0 + g;
  int it_lo = n_tiles, it_hi = n_tiles;
  if (wr0 < p.sq) {
    int lo, hi;
    key_range(p, wr0, 16, &lo, &hi);
    it_lo = min(n_tiles, max(0, lo / BK - t_lo));
    it_hi = max(it_lo, min(n_tiles, (hi + BK - 1) / BK - t_lo));
  }
  const float sl2 = p.scale * LOG2E;
  const float* q_at = sQ + (16 * warp + g) * C::LDK + 4 * t;

  float m[2] = {-INFINITY, -INFINITY};  // running row max (raw scores)
  float l[2] = {0.f, 0.f};              // this lane's part of the row sums
  float o[2 * NC][4];
#pragma unroll
  for (int n = 0; n < 2 * NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<C::STAGES - 2>();  // this thread's copies of tile it landed
    __syncthreads();                 // everyone's did, and tile it − 1's slot is free
    if (it + C::STAGES - 1 < n_tiles) load_tile(it + C::STAGES - 1);
    cp_async_commit();
    if (it < it_lo || it >= it_hi) continue;

    const int st = it % C::STAGES;
    const int k0 = (t_lo + it) * BK;
    const float* k_at = sK + st * BK * C::LDK + g * C::LDK + 4 * t;
    const float* v_at = sV + st * BK * C::LDV + 2 * t * C::LDV + 2 * g;

    // S = Q·Kᵀ: s[j] holds keys k0 + 8j + 2t, + 1 of rows r0, r0 + 8
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 qa = *reinterpret_cast<const float4*>(q_at + 16 * c);
      const float4 qb = *reinterpret_cast<const float4*>(q_at + 8 * C::LDK + 16 * c);
      uint32_t ah[2][4], al[2][4];
      split(qa.x, ah[0][0], al[0][0]);
      split(qb.x, ah[0][1], al[0][1]);
      split(qa.y, ah[0][2], al[0][2]);
      split(qb.y, ah[0][3], al[0][3]);
      split(qa.z, ah[1][0], al[1][0]);
      split(qb.z, ah[1][1], al[1][1]);
      split(qa.w, ah[1][2], al[1][2]);
      split(qb.w, ah[1][3], al[1][3]);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float4 kb = *reinterpret_cast<const float4*>(k_at + 8 * j * C::LDK + 16 * c);
        uint32_t bh0[2], bl0[2], bh1[2], bl1[2];
        split(kb.x, bh0[0], bl0[0]);
        split(kb.y, bh0[1], bl0[1]);
        split(kb.z, bh1[0], bl1[0]);
        split(kb.w, bh1[1], bl1[1]);
        mma3(s[j], ah[0], al[0], bh0, bl0);
        mma3(s[j], ah[1], al[1], bh1, bl1);
      }
    }

    // the mask, only on a tile that crosses Skv, the diagonal or the window's edge
    if (k0 + BK > p.skv || (p.causal && k0 + BK - 1 > wr0) ||
        (p.window > 0 && wr0 + 15 - k0 >= p.window)) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!live(p, r0 + 8 * (e >> 1), k0 + 8 * j + 2 * t + (e & 1))) s[j][e] = -INFINITY;
    }
    // the online softmax in base 2, the scale folded into log2 e
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float base[2], corr[2];
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
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(fmaf(s[j][e], sl2, -base[e >> 1]));
        l[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int n = 0; n < 2 * NC; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P·V, P in fp32 (the Pallas kernel's P)
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      uint32_t ph[4], pl[4];
      split(s[j][0], ph[0], pl[0]);
      split(s[j][2], ph[1], pl[1]);
      split(s[j][1], ph[2], pl[2]);
      split(s[j][3], ph[3], pl[3]);
      const float* v0 = v_at + 8 * j * C::LDV;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float2 x = *reinterpret_cast<const float2*>(v0 + 16 * c);
        const float2 y = *reinterpret_cast<const float2*>(v0 + C::LDV + 16 * c);
        uint32_t bh0[2], bl0[2], bh1[2], bl1[2];
        split(x.x, bh0[0], bl0[0]);
        split(y.x, bh0[1], bl0[1]);
        split(x.y, bh1[0], bl1[0]);
        split(y.y, bh1[1], bl1[1]);
        mma3(o[2 * c], ph, pl, bh0, bl0);
        mma3(o[2 * c + 1], ph, pl, bh1, bl1);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);  // a row with no live key: O = 0, l = 0 → 0
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= p.sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 16 * c + 4 * t;
      if (col < d)
        *reinterpret_cast<float4*>(og + row * q_stride + col) =
            make_float4(o[2 * c][2 * r] * inv[r], o[2 * c + 1][2 * r] * inv[r],
                        o[2 * c][2 * r + 1] * inv[r], o[2 * c + 1][2 * r + 1] * inv[r]);
    }
  }
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

template <int DP> Plan f32_plan() {
  return {reinterpret_cast<const void*>(f32::flash_fwd_f32_kernel<DP>), f32::THREADS, f32::BQ,
          f32::Cfg<DP>::SMEM};
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
      case 1: *out = f32_plan<16>(); break;
      case 2: *out = f32_plan<32>(); break;
      case 3: *out = f32_plan<48>(); break;
      case 4: *out = f32_plan<64>(); break;
      case 5: *out = f32_plan<80>(); break;
      case 6: *out = f32_plan<96>(); break;
      case 7: *out = f32_plan<112>(); break;
      case 8: *out = f32_plan<128>(); break;
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
// type (dtype 0: fp32, 1: bf16), each starting on a 16-byte boundary (the rule of
// TMA and of cp.async's 16-byte copies). window <= 0 means no window. Launches on `stream` and returns the
// launch's cudaError_t (0 on success); does not synchronise.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int b,
                                   int sq, int skv, int h, int kv, int d, int causal, int window,
                                   float scale, int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || h <= 0 || kv <= 0 || h % kv != 0)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) & 15)
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
