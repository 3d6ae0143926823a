// Flash-attention forward for NVIDIA Hopper (sm_90a) on the tensor cores.
//
// Replaces: the Pallas TPU kernel `_flash_kernel` / `_flash_bhtd`
// (mgwfbp_tpu/ops/flashattn.py:43-131), called through `flash_attention`.
// It computes  o = softmax((q k^T) * scale [causal mask]) v  by the online
// softmax recurrence, with f32 scores, running max, running sum and output
// accumulator, and writes  acc / max(l, 1e-30)  in the input type.
//
// Layout: q, k, v are (B, T, H, D) with any batch/time/head strides and a
// unit D stride (the transformer hands in strided views of its fused qkv
// projection, so no transpose or copy is made); o is a contiguous
// (B, T, H, D) tensor allocated by the caller. Any T >= 1 (ragged tiles are
// masked) and any D <= 256.
//
// Two kernels, one per input type, sharing one skeleton:
//   * grid (B*H, ceil(T / 64)): one block per (batch*head, 64-row query
//     tile); the query tiles are walked last-first, so under `causal` the
//     blocks with the most key tiles start first;
//   * each warp owns 16 query rows. Scores stay in registers in the MMA
//     accumulator layout (a thread holds rows g and g+8 of its warp's 16,
//     g = lane / 4, and columns 2*(lane % 4) + {0, 1} of every 8-column
//     group), and the online softmax runs there: row max and row sum by two
//     shuffles among the 4 lanes of a row, `scale * log2(e)` folded into the
//     scores, exp2f. There is no shared-memory round trip and no block
//     barrier between the two products;
//   * with `causal` the key loop stops at the block's diagonal tile; only
//     the diagonal tile and the ragged last tile are masked;
//   * K/V tiles pass through a ring of two shared-memory stages that is
//     filled asynchronously, so tile j+1 loads while tile j is multiplied.
//
// float32 (flash_f32): 3xTF32 on `mma.sync.aligned.m16n8k8` tensor cores.
//   A single TF32 product keeps 10 mantissa bits and misses the 2e-5 bound
//   of the f32 contract by 20-50x (tests/test_torch_flashattn.py emulates
//   both on the CPU); splitting every operand as x = hi + lo
//   and accumulating lo*hi + hi*lo + hi*hi in f32 (the lo*lo term is below
//   f32 rounding) restores f32 accuracy at a third of the TF32 rate,
//   495 / 3 = 165 TFLOP/s, which is still 2.5x the SIMT f32 rate. Rounding
//   (`split_tf32`): hi is x truncated to TF32 (the 13 low mantissa bits
//   cleared); lo = x - hi, exact in f32, is rounded to nearest with ties
//   away from zero, as `cvt.rna.tf32.f32` would round it. It is done with
//   integer operations, because the conversion instruction runs at a
//   quarter of their rate and the splits are a large share of the work.
//   `mma.sync` and not `wgmma` because TF32 `wgmma` needs both operands
//   K-major: P.V would need V stored D x keys, a transpose while staging
//   that TMA cannot do. Q is split once per block into hi/lo arrays in
//   shared memory; K and V are split as each warp reads its fragments (a
//   split pass over the tile would cost a second barrier and twice the
//   shared memory per stage). P.V takes P straight from the
//   score registers: an accumulator row holds keys 2t and 2t+1 where the A
//   fragment wants keys t and t+4, so the key order inside each 8-key step
//   is permuted (A column t <-> key 2t, t+4 <-> 2t+1) and V's B fragment
//   reads the same permuted rows; a sum over keys does not depend on their
//   order. Rows of shared memory are padded by 4 floats, which makes every
//   fragment read free of bank conflicts. Loads are `cp.async` of 16 bytes
//   when every base pointer is 16-byte aligned, every stride is a multiple
//   of 4 elements and D % 4 == 0, else of 4 bytes (the misaligned path).
//   Tiles: 64 query rows x BK keys, BK = 64 for D <= 64, 32 for D <= 128,
//   16 for D <= 256, so that Q's hi/lo and two K/V stages stay under the
//   227 KB a block may use (195 KB at D = 256).
//
// bfloat16 (flash_bf16): `wgmma` fed by TMA through an mbarrier ring.
//   One consumer warpgroup (warps 0-3, 64 query rows) and one producer warp
//   (warp 4) per block. The producer's lane 0 keeps TMA loads of K/V tiles
//   (64 keys x 64 columns per box, 128-byte swizzle) in flight into two
//   stages guarded by full/empty mbarriers. S = Q K^T is `wgmma m64n64k16`
//   bf16 -> f32 with both operands K-major in shared memory; P is rounded
//   to bf16 in registers (the accumulator layout is the A-operand register
//   layout, so no shuffle) and is the A operand of the second `wgmma`,
//   whose B operand is V, MN-major through the transpose bit. D > 64 is
//   taken as 64-column chunks, one box and one `wgmma` per chunk. The TPU
//   kernel computes P.V in f32; a bf16 P adds about 2^-9 relative error,
//   well inside the bf16 bound of 2e-2. `scale` multiplies the f32 scores,
//   not q (q * scale is exact in bf16 only for a power-of-two scale). TMA
//   needs a 16-byte-aligned base and 16-byte-multiple strides; views that do
//   not qualify (odd D, H*D not a multiple of 8) take the misaligned path:
//   the producer warp loads the tiles with plain loads into the same
//   swizzled layout and arrives on the same barriers.
//
// The serving shape (8, 35, 4, 64) f32 is 32 (batch, head) pairs of one
// partial tile: one 64-row block per pair, whose warps 0-2 hold the 35 real
// rows and whose warp 3 only helps load. Built and timed on the card at
// that shape, 32- and 16-row query tiles (2 and 1 warps per block), 32-key
// tiles and skipping the 8-key groups past T were all slower than this
// tiling: a smaller tile does not shorten any warp's work (its 16 rows
// still need the whole key tile), and a branch inside the unrolled
// fragment loops costs the compiler its schedule.
//
// What bounds it: at the serving shape the call moves ~1.15 MB and does
// ~5 MFLOP, so it is bound by its launch and by bytes; at long T it is
// bound by operations (165 TFLOP/s for 3xTF32, 989 TFLOP/s bf16).
//
// Dynamic shared memory above 48 KB is allowed once per (device,
// instantiation). C interface (bound with ctypes): mgwfbp_flash_attn_fwd
// returns the CUDA error code of the launch (0 = success). It launches on
// the given stream, does not synchronise and allocates nothing.

#include <cuda.h>  // CUtensorMap and its enums; the driver entry point is
                   // fetched at run time, so no -lcuda is needed
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int MAX_DEVICES = 64;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {  // in elements: batch, time, head of q, k, v
  int64_t qb, qt, qh, kb, kt, kh, vb, vt, vh;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Online-softmax step for the two rows a thread holds. s[4n + e] is the
// accumulator layout: rows g (e < 2) and g + 8 (e >= 2), key 8n + 2t + (e & 1).
// Scores come in raw; on return s holds p = exp2(s * sl2 - m). Returns the
// factors that rescale the old accumulator rows.
template <int NS>
__device__ __forceinline__ void softmax_step(float* s, float& m0, float& m1,
                                             float& l0, float& l1, float sl2,
                                             bool mask, int key0, int row0,
                                             int seq, int causal, float& a0,
                                             float& a1) {
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * n + e] * sl2;
      if (mask) {
        const int key = key0 + 8 * n + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        if (key >= seq || (causal && key > row)) x = -INFINITY;
      }
      s[4 * n + e] = x;
    }
    mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  // a row with no visible key so far keeps m = -inf; subtract 0 instead
  const float u0 = mx0 == -INFINITY ? 0.f : mx0;
  const float u1 = mx1 == -INFINITY ? 0.f : mx1;
  a0 = exp2f(m0 - u0);
  a1 = exp2f(m1 - u1);
  m0 = mx0;
  m1 = mx1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    s[4 * n] = exp2f(s[4 * n] - u0);
    s[4 * n + 1] = exp2f(s[4 * n + 1] - u0);
    s[4 * n + 2] = exp2f(s[4 * n + 2] - u1);
    s[4 * n + 3] = exp2f(s[4 * n + 3] - u1);
    sum0 += s[4 * n] + s[4 * n + 1];
    sum1 += s[4 * n + 2] + s[4 * n + 3];
  }
  // partial sums of this thread's columns; the 4 lanes of a row are added
  // once, at the end
  l0 = l0 * a0 + sum0;
  l1 = l1 * a1 + sum1;
}

__device__ __forceinline__ void store_pair(float* p, int col, int D, float x,
                                           float y) {
  if (col + 1 < D && (D & 1) == 0) {
    *reinterpret_cast<float2*>(p + col) = make_float2(x, y);
  } else {
    if (col < D) p[col] = x;
    if (col + 1 < D) p[col + 1] = y;
  }
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, int col, int D,
                                           float x, float y) {
  if (col + 1 < D && (D & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p + col) = __floats2bfloat162_rn(x, y);
  } else {
    if (col < D) p[col] = __float2bfloat16(x);
    if (col + 1 < D) p[col + 1] = __float2bfloat16(y);
  }
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 mma.sync
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 128;  // 4 warps x 16 query rows

template <int DPAD>
struct F32Cfg {
  static constexpr int BK = DPAD <= 64 ? 64 : (DPAD <= 128 ? 32 : 16);
  static constexpr int LD = DPAD + 4;  // padded row: conflict-free fragments
  static constexpr size_t SMEM =
      sizeof(float) * (2 * BQ * LD + 2 * 2 * static_cast<size_t>(BK) * LD);
};

// x = hi + lo in TF32 with integer operations only (a conversion
// instruction runs at a quarter of their rate): hi is x truncated to TF32
// (the 13 low mantissa bits cleared), lo = x - hi is exact in float32 and is
// rounded to TF32 to nearest, ties away from zero, by adding half a TF32 ulp
// to its magnitude bits before clearing them (what cvt.rna.tf32.f32 does)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b in 3xTF32: the small terms first
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* ah,
                                           const uint32_t* al,
                                           const uint32_t* bh,
                                           const uint32_t* bl) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// rows [r0, r0 + ROWS) of one (batch, head) slice into a padded tile;
// rows past seq and columns past D are zero-filled (source size 0)
template <int ROWS, int DPAD, bool VEC16>
__device__ __forceinline__ void f32_load_rows(float* dst, const float* src,
                                              int64_t st, int r0, int seq,
                                              int D, int tid) {
  constexpr int LD = DPAD + 4;
  if constexpr (VEC16) {
    constexpr int CPR = DPAD / 4;
#pragma unroll
    for (int i = tid; i < ROWS * CPR; i += F32_THREADS) {
      const int r = i / CPR;
      const int c = (i % CPR) * 4;
      const int t = r0 + r;
      const bool in = t < seq && c < D;
      cp_async16(dst + r * LD + c, in ? src + t * st + c : src, in ? 16 : 0);
    }
  } else {
#pragma unroll 8
    for (int i = tid; i < ROWS * DPAD; i += F32_THREADS) {
      const int r = i / DPAD;
      const int c = i % DPAD;
      const int t = r0 + r;
      const bool in = t < seq && c < D;
      cp_async4(dst + r * LD + c, in ? src + t * st + c : src, in ? 4 : 0);
    }
  }
}

template <int DPAD, bool VEC16>
__global__ void __launch_bounds__(F32_THREADS)
    flash_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int H,
              int seq, int D, Strides st, float sl2, int causal) {
  using Cfg = F32Cfg<DPAD>;
  constexpr int BK = Cfg::BK;
  constexpr int LD = Cfg::LD;
  constexpr int NS = BK / 8;    // 8-key groups per tile
  constexpr int ND = DPAD / 8;  // 8-column groups of the output
  extern __shared__ __align__(16) float smem[];
  float* sQh = smem;
  float* sQl = sQh + BQ * LD;
  float* sKV = sQl + BQ * LD;  // stage s: K at (2s) * BK * LD, V after it

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const float* qb = q + b * st.qb + h * st.qh;
  const float* kb = k + b * st.kb + h * st.kh;
  const float* vb = v + b * st.vb + h * st.vh;

  const int k_end = causal ? min(seq, q0 + BQ) : seq;
  const int n_tiles = (k_end + BK - 1) / BK;

  f32_load_rows<BQ, DPAD, VEC16>(sQh, qb, st.qt, q0, seq, D, tid);
  cp_async_commit();
  f32_load_rows<BK, DPAD, VEC16>(sKV, kb, st.kt, 0, seq, D, tid);
  f32_load_rows<BK, DPAD, VEC16>(sKV + BK * LD, vb, st.vt, 0, seq, D, tid);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  // split Q once: hi in place, lo beside it
  for (int i = tid; i < BQ * DPAD; i += F32_THREADS) {
    const int idx = (i / DPAD) * LD + i % DPAD;
    uint32_t hi, lo;
    split_tf32(sQh[idx], hi, lo);
    sQh[idx] = __uint_as_float(hi);
    sQl[idx] = __uint_as_float(lo);
  }

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int wr0 = q0 + 16 * warp;  // this warp's first query row
  const bool active = wr0 < seq;
  const int kd = (D + 7) / 8;  // 8-column steps of the score product

  float acc[ND * 4];
#pragma unroll
  for (int i = 0; i < ND * 4; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      float* nxt = sKV + ((j + 1) & 1) * 2 * BK * LD;
      f32_load_rows<BK, DPAD, VEC16>(nxt, kb, st.kt, (j + 1) * BK, seq, D,
                                     tid);
      f32_load_rows<BK, DPAD, VEC16>(nxt + BK * LD, vb, st.vt, (j + 1) * BK,
                                     seq, D, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and, at j = 0, the split Q) visible to all
    const int k0 = j * BK;
    if (active && (!causal || k0 <= wr0 + 15)) {
      const float* sK = sKV + (j & 1) * 2 * BK * LD;
      const float* sV = sK + BK * LD;
      float s[NS * 4];
#pragma unroll
      for (int i = 0; i < NS * 4; ++i) s[i] = 0.f;
      const float* qh = sQh + (16 * warp + g) * LD + t4;
      const float* ql = sQl + (16 * warp + g) * LD + t4;
      for (int kk = 0; kk < kd; ++kk) {
        const int c = 8 * kk;
        uint32_t ah[4], al[4];
        ah[0] = __float_as_uint(qh[c]);
        ah[1] = __float_as_uint(qh[c + 8 * LD]);
        ah[2] = __float_as_uint(qh[c + 4]);
        ah[3] = __float_as_uint(qh[c + 8 * LD + 4]);
        al[0] = __float_as_uint(ql[c]);
        al[1] = __float_as_uint(ql[c + 8 * LD]);
        al[2] = __float_as_uint(ql[c + 4]);
        al[3] = __float_as_uint(ql[c + 8 * LD + 4]);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float* kp = sK + (8 * n + g) * LD + c + t4;
          uint32_t bh2[2], bl2[2];
          split_tf32(kp[0], bh2[0], bl2[0]);
          split_tf32(kp[4], bh2[1], bl2[1]);
          mma_3xtf32(s + 4 * n, ah, al, bh2, bl2);
        }
      }
      const bool mask = k0 + BK > seq || (causal && k0 + BK - 1 > wr0);
      float a0, a1;
      softmax_step<NS>(s, m0, m1, l0, l1, sl2, mask, k0 + 2 * t4, wr0 + g,
                       seq, causal, a0, a1);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[4 * n] *= a0;
        acc[4 * n + 1] *= a0;
        acc[4 * n + 2] *= a1;
        acc[4 * n + 3] *= a1;
      }
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        // A column t <-> key 2t, column t + 4 <-> key 2t + 1
        uint32_t ah[4], al[4];
        split_tf32(s[4 * kk], ah[0], al[0]);
        split_tf32(s[4 * kk + 2], ah[1], al[1]);
        split_tf32(s[4 * kk + 1], ah[2], al[2]);
        split_tf32(s[4 * kk + 3], ah[3], al[3]);
        const float* vp = sV + (8 * kk + 2 * t4) * LD + g;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          if (8 * n < D) {
            uint32_t bh2[2], bl2[2];
            split_tf32(vp[8 * n], bh2[0], bl2[0]);
            split_tf32(vp[LD + 8 * n], bh2[1], bl2[1]);
            mma_3xtf32(acc + 4 * n, ah, al, bh2, bl2);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with stage j & 1
  }

  if (!active) return;
  const float inv0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
  const float inv1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
  const int row0 = wr0 + g;
  const int row1 = row0 + 8;
  float* o0 = o + ((static_cast<int64_t>(b) * seq + row0) * H + h) * D;
  float* o1 = o0 + static_cast<int64_t>(8) * H * D;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = 8 * n + 2 * t4;
    if (row0 < seq)
      store_pair(o0, col, D, acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
    if (row1 < seq)
      store_pair(o1, col, D, acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma + TMA, one producer warp, one consumer warpgroup
// ---------------------------------------------------------------------------

constexpr int BF16_BK = 64;                       // keys per tile
constexpr int BF16_STAGES = 2;                    // K/V ring depth
constexpr int BF16_THREADS = 160;                 // warpgroup + producer
constexpr uint32_t BF16_BOX = 64 * 64 * 2;        // one 64 x 64 bf16 box
constexpr uint32_t SW128_ROW = 128;               // bytes per swizzled row

template <int NCH>
struct Bf16Cfg {
  static constexpr uint32_t TILE = NCH * BF16_BOX;  // 64 rows x D
  // 1 KB of slack to align the swizzled tiles, Q, the K/V stages, barriers
  static constexpr size_t SMEM =
      1024 + static_cast<size_t>(TILE) * (1 + 2 * BF16_STAGES) + 64;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait for the completion of the barrier's phase with this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle. K-major operands use
// only the 8-row group stride (SBO = 1024 B); an MN-major operand also has
// a leading stride between 64-element atoms (LBO), unused here because every
// wgmma reads one 64-column chunk.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keep the compiler from moving accumulator reads/writes across the
// asynchronous wgmma
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D32(d)                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define WG_REGS32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (64 x 64, f32) (+)= A (64 x 16, smem, K-major) * B (16 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_D32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WG_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// rows [r0, r0 + 64) of one (batch, head) slice, by plain loads from one
// warp, into the layout a 128-byte-swizzled TMA box would have written:
// chunk c (columns 64c..64c+63) at c * 8 KB, row r at r * 128 B, 16-byte
// group j of the row at position j ^ (r % 8)
template <int NCH>
__device__ __forceinline__ void bf16_load_plain(uint8_t* dst,
                                                const uint16_t* src,
                                                int64_t st, int r0, int seq,
                                                int D, int lane) {
#pragma unroll 4
  for (int i = lane; i < NCH * 64 * 8; i += 32) {
    const int c = i / 512;
    const int r = (i / 8) % 64;
    const int j = i % 8;
    const int t = r0 + r;
    const int d0 = 64 * c + 8 * j;
    uint16_t e[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      e[u] = (t < seq && d0 + u < D) ? src[t * st + d0 + u] : 0;
    uint4 w;
    w.x = e[0] | (static_cast<uint32_t>(e[1]) << 16);
    w.y = e[2] | (static_cast<uint32_t>(e[3]) << 16);
    w.z = e[4] | (static_cast<uint32_t>(e[5]) << 16);
    w.w = e[6] | (static_cast<uint32_t>(e[7]) << 16);
    *reinterpret_cast<uint4*>(dst + c * BF16_BOX + r * SW128_ROW +
                              ((j ^ (r & 7)) << 4)) = w;
  }
}

// coordinates of a box in a tensor map whose dims 1..3 are (t, h, b) in the
// order `perm` gives: bits 0-1 the slot of t, 2-3 of h, 4-5 of b
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, uint32_t perm, int col,
                                        int t, int h, int b) {
  const int st = perm & 3, sh = (perm >> 2) & 3;
  const int c1 = st == 1 ? t : (sh == 1 ? h : b);
  const int c2 = st == 2 ? t : (sh == 2 ? h : b);
  const int c3 = st == 3 ? t : (sh == 3 ? h : b);
  tma_load_4d(dst, map, bar, col, c1, c2, c3);
}

template <int NCH, bool TMA>
__global__ void __launch_bounds__(BF16_THREADS, 1)
    flash_bf16(const __grid_constant__ CUtensorMap mq,
               const __grid_constant__ CUtensorMap mk,
               const __grid_constant__ CUtensorMap mv, uint32_t perm_q,
               uint32_t perm_k, uint32_t perm_v,
               const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, int H, int seq, int D,
               Strides st, float sl2, int causal) {
  using Cfg = Bf16Cfg<NCH>;
  constexpr uint32_t TILE = Cfg::TILE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sQ = base;
  uint8_t* sKV = base + TILE;  // stage s: K at 2s * TILE, V after it
  uint64_t* full = reinterpret_cast<uint64_t*>(base + TILE * (1 + 2 * BF16_STAGES));
  uint64_t* empty = full + BF16_STAGES;
  uint64_t* qbar = empty + BF16_STAGES;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int k_end = causal ? min(seq, q0 + BQ) : seq;
  const int n_tiles = (k_end + BF16_BK - 1) / BF16_BK;

  if (tid == 0) {
    for (int s = 0; s < BF16_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer ----
    if constexpr (TMA) {
      if (lane == 0) {
        mbar_expect_tx(qbar, TILE);
        for (int c = 0; c < NCH; ++c)
          tma_box(sQ + c * BF16_BOX, &mq, qbar, perm_q, 64 * c, q0, h, b);
        for (int j = 0; j < n_tiles; ++j) {
          const int s = j % BF16_STAGES;
          if (j >= BF16_STAGES) mbar_wait(&empty[s], ((j / BF16_STAGES) - 1) & 1);
          uint8_t* sK = sKV + 2 * s * TILE;
          mbar_expect_tx(&full[s], 2 * TILE);
          for (int c = 0; c < NCH; ++c) {
            tma_box(sK + c * BF16_BOX, &mk, &full[s], perm_k, 64 * c,
                    j * BF16_BK, h, b);
            tma_box(sK + TILE + c * BF16_BOX, &mv, &full[s], perm_v, 64 * c,
                    j * BF16_BK, h, b);
          }
        }
      }
    } else {
      const uint16_t* qb = reinterpret_cast<const uint16_t*>(q) + b * st.qb + h * st.qh;
      const uint16_t* kb = reinterpret_cast<const uint16_t*>(k) + b * st.kb + h * st.kh;
      const uint16_t* vb = reinterpret_cast<const uint16_t*>(v) + b * st.vb + h * st.vh;
      bf16_load_plain<NCH>(sQ, qb, st.qt, q0, seq, D, lane);
      fence_proxy_async();  // generic-proxy writes, read by wgmma
      __syncwarp();
      if (lane == 0) mbar_arrive(qbar);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % BF16_STAGES;
        if (j >= BF16_STAGES) mbar_wait(&empty[s], ((j / BF16_STAGES) - 1) & 1);
        uint8_t* sK = sKV + 2 * s * TILE;
        bf16_load_plain<NCH>(sK, kb, st.kt, j * BF16_BK, seq, D, lane);
        bf16_load_plain<NCH>(sK + TILE, vb, st.vt, j * BF16_BK, seq, D, lane);
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- consumer warpgroup: warp w holds query rows q0 + 16w .. + 15 ----
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int wr0 = q0 + 16 * warp;
  float acc[NCH][32];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  mbar_wait(qbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % BF16_STAGES;
    mbar_wait(&full[s], (j / BF16_STAGES) & 1);
    const uint8_t* sK = sKV + 2 * s * TILE;
    const uint8_t* sV = sK + TILE;

    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wg_fence();
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // 16 columns (32 B) per step
        wgmma_ss(sc, desc_sw128(sQ + c * BF16_BOX + 32 * kk, 16),
                 desc_sw128(sK + c * BF16_BOX + 32 * kk, 16),
                 (c | kk) != 0);
    wg_commit();
    wg_wait0();
    fence_regs(sc);

    const int k0 = j * BF16_BK;
    const bool mask = k0 + BF16_BK > seq || (causal && k0 + BF16_BK - 1 > q0);
    float a0, a1;
    softmax_step<8>(sc, m0, m1, l0, l1, sl2, mask, k0 + 2 * t4, wr0 + g, seq,
                    causal, a0, a1);
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[c][4 * n] *= a0;
        acc[c][4 * n + 1] *= a0;
        acc[c][4 * n + 2] *= a1;
        acc[c][4 * n + 3] *= a1;
      }
    // P as the A operand: keys 16kk..16kk+15 are score groups 2kk, 2kk+1
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) fence_regs(acc[c]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 16 keys = 16 swizzled rows per step
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        wgmma_rs(acc[c], pa[kk],
                 desc_sw128(sV + c * BF16_BOX + 16 * SW128_ROW * kk, BF16_BOX));
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int c = 0; c < NCH; ++c) fence_regs(acc[c]);
    mbar_arrive(&empty[s]);
  }

  const float inv0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
  const float inv1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
  const int row0 = wr0 + g;
  const int row1 = row0 + 8;
  __nv_bfloat16* o0 = o + ((static_cast<int64_t>(b) * seq + row0) * H + h) * D;
  __nv_bfloat16* o1 = o0 + static_cast<int64_t>(8) * H * D;
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 64 * c + 8 * n + 2 * t4;
      if (row0 < seq)
        store_pair(o0, col, D, acc[c][4 * n] * inv0, acc[c][4 * n + 1] * inv0);
      if (row1 < seq)
        store_pair(o1, col, D, acc[c][4 * n + 2] * inv1,
                   acc[c][4 * n + 3] * inv1);
    }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// raise the kernel's dynamic shared-memory limit once per device
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

template <int DPAD, bool VEC16>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int seq, int H, int D, const Strides& st,
                       float sl2, int causal, cudaStream_t stream) {
  static bool done[MAX_DEVICES] = {};
  auto kernel = flash_f32<DPAD, VEC16>;
  const size_t bytes = F32Cfg<DPAD>::SMEM;
  cudaError_t err = allow_smem(kernel, bytes, done);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (seq + BQ - 1) / BQ);
  kernel<<<grid, F32_THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, seq, D, st,
      sl2, causal);
  return cudaGetLastError();
}

template <bool VEC16>
cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* o,
                         int B, int seq, int H, int D, const Strides& st,
                         float sl2, int causal, cudaStream_t s) {
  if (D <= 32)
    return launch_f32<32, VEC16>(q, k, v, o, B, seq, H, D, st, sl2, causal, s);
  if (D <= 64)
    return launch_f32<64, VEC16>(q, k, v, o, B, seq, H, D, st, sl2, causal, s);
  if (D <= 128)
    return launch_f32<128, VEC16>(q, k, v, o, B, seq, H, D, st, sl2, causal,
                                  s);
  return launch_f32<256, VEC16>(q, k, v, o, B, seq, H, D, st, sl2, causal, s);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult qr;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &qr);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &qr);
#endif
    if (err == cudaSuccess && qr == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D bf16 tensor map (D, then t, h, b ordered by stride) with a box of
// 64 columns x 64 time rows and 128-byte swizzle; rows and columns outside
// the tensor are filled with zeros. Dims of size 1 get a stride past every
// other, so the outer strides ascend. Returns false if the view does not
// qualify (base or a stride not a multiple of 16 bytes).
bool make_map(CUtensorMap* map, uint32_t* perm, const void* ptr, int seq,
              int H, int B, int D, int64_t st_t, int64_t st_h, int64_t st_b) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  struct Dim {
    uint64_t size, stride;
    int which;  // 0 = t, 1 = h, 2 = b
  } d[3] = {{static_cast<uint64_t>(seq), static_cast<uint64_t>(st_t) * 2, 0},
            {static_cast<uint64_t>(H), static_cast<uint64_t>(st_h) * 2, 1},
            {static_cast<uint64_t>(B), static_cast<uint64_t>(st_b) * 2, 2}};
  uint64_t span = static_cast<uint64_t>(D) * 2;
  for (auto& x : d) {
    if (x.size == 1) continue;
    if (x.stride % 16 != 0 || x.stride == 0) return false;
    if (x.stride * x.size > span) span = x.stride * x.size;
  }
  span = (span + 15) / 16 * 16;
  for (auto& x : d)
    if (x.size == 1) x.stride = span;
  for (int i = 1; i < 3; ++i)  // insertion sort by stride
    for (int j = i; j > 0 && d[j].stride < d[j - 1].stride; --j) {
      Dim tmp = d[j];
      d[j] = d[j - 1];
      d[j - 1] = tmp;
    }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), d[0].size, d[1].size,
                        d[2].size};
  cuuint64_t strides[3] = {d[0].stride, d[1].stride, d[2].stride};
  cuuint32_t box[4] = {64, 1, 1, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  *perm = 0;
  for (int i = 0; i < 3; ++i) {
    if (d[i].which == 0) box[i + 1] = 64;
    *perm |= static_cast<uint32_t>(i + 1) << (2 * d[i].which);
  }
  EncodeTiled encode = encode_fn();
  if (encode == nullptr) return false;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NCH, bool TMA>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int seq, int H, int D, const Strides& st,
                        float sl2, int causal, cudaStream_t stream) {
  static bool done[MAX_DEVICES] = {};
  auto kernel = flash_bf16<NCH, TMA>;
  const size_t bytes = Bf16Cfg<NCH>::SMEM;
  cudaError_t err = allow_smem(kernel, bytes, done);
  if (err != cudaSuccess) return err;
  CUtensorMap mq, mk, mv;
  uint32_t pq = 0, pk = 0, pv = 0;
  if constexpr (TMA) {
    if (!make_map(&mq, &pq, q, seq, H, B, D, st.qt, st.qh, st.qb) ||
        !make_map(&mk, &pk, k, seq, H, B, D, st.kt, st.kh, st.kb) ||
        !make_map(&mv, &pv, v, seq, H, B, D, st.vt, st.vh, st.vb))
      return cudaErrorInvalidValue;
  } else {
    memset(&mq, 0, sizeof(mq));
    memset(&mk, 0, sizeof(mk));
    memset(&mv, 0, sizeof(mv));
  }
  dim3 grid(B * H, (seq + BQ - 1) / BQ);
  kernel<<<grid, BF16_THREADS, bytes, stream>>>(
      mq, mk, mv, pq, pk, pv, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      H, seq, D, st, sl2, causal);
  return cudaGetLastError();
}

template <bool TMA>
cudaError_t dispatch_bf16(const void* q, const void* k, const void* v,
                          void* o, int B, int seq, int H, int D,
                          const Strides& st, float sl2, int causal,
                          cudaStream_t s) {
  if (D <= 64)
    return launch_bf16<1, TMA>(q, k, v, o, B, seq, H, D, st, sl2, causal, s);
  if (D <= 128)
    return launch_bf16<2, TMA>(q, k, v, o, B, seq, H, D, st, sl2, causal, s);
  return launch_bf16<4, TMA>(q, k, v, o, B, seq, H, D, st, sl2, causal, s);
}

}  // namespace

extern "C" const char* mgwfbp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, in the order
// (q batch, q time, q head, k batch, k time, k head, v batch, v time,
// v head); the D stride must be 1. aligned = 1 takes the aligned path
// (float32: 16-byte cp.async; bfloat16: TMA), which the caller chooses only
// for views that qualify; 0 takes the misaligned path of the same kernel.
extern "C" int mgwfbp_flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int seq, int H, int D, long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh, long long svb,
    long long svt, long long svh, float scale, int causal, int aligned,
    void* stream) {
  if (B < 1 || seq < 1 || H < 1 || D < 1 || D > 256 ||
      (seq + BQ - 1) / BQ > 65535 ||
      static_cast<long long>(B) * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st = {sqb, sqt, sqh, skb, skt, skh, svb, svt, svh};
  const float sl2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = aligned ? dispatch_f32<true>(q, k, v, o, B, seq, H, D, st, sl2,
                                       causal, s)
                  : dispatch_f32<false>(q, k, v, o, B, seq, H, D, st, sl2,
                                        causal, s);
  else if (dtype == 1)
    err = aligned ? dispatch_bf16<true>(q, k, v, o, B, seq, H, D, st, sl2,
                                        causal, s)
                  : dispatch_bf16<false>(q, k, v, o, B, seq, H, D, st, sl2,
                                         causal, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
