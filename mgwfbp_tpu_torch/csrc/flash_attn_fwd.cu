// Flash-attention forward for NVIDIA Hopper (sm_90a), plain SIMT float32.
//
// Replaces: the Pallas TPU kernel `_flash_kernel` / `_flash_bhtd`
// (mgwfbp_tpu/ops/flashattn.py:43-131), called through `flash_attention`.
// It computes  o = softmax((q * scale) k^T [causal mask]) v  by the online
// softmax recurrence, in float32 for float32 and bfloat16 inputs, and
// writes  acc / max(l, 1e-30)  in the input type.
//
// Layout: q, k, v are (B, T, H, D) with any batch/time/head strides and a
// unit D stride (the transformer hands in strided views of its fused qkv
// projection, so no transpose or copy is made); o is a contiguous
// (B, T, H, D) tensor allocated by the caller.
//
// Design, re-thought for the GPU rather than copied block by block:
//   * grid (B*H, ceil(T / BQ)): one block per (batch*head, query tile).
//     The TPU kernel's sequential third grid axis over K blocks, whose
//     running (acc, m, l) lived in VMEM scratch, becomes a loop inside the
//     block over K/V tiles staged in shared memory;
//   * running max m and denominator l live in shared memory (one per query
//     row), the (BQ x D) accumulator in registers, spread over the block's
//     16 x 16 threads (4 rows x D/16 columns each), all in float32;
//   * with `causal` the loop stops at the diagonal tile, so tiles strictly
//     above it are never loaded (the TPU kernel skipped their compute);
//   * ragged edges are masked: T need not be a multiple of the tile (the
//     serving shape has T = 35), out-of-range keys get p = 0 and
//     out-of-range query rows are computed on zeros and never stored;
//   * Q and K tiles use a padded row stride (D + 1) so the column reads of
//     the score product do not collide on one shared-memory bank.
//
// What bounds it on this card: at the serving shape (8, 35, 4, 64) the
// call moves ~1.15 MB and does ~5 MFLOP, so it is bound by its launch and
// by bytes, not arithmetic; at long T (4096) it does O(T^2 D) work and is
// bound by operations. This first version runs the two products on the
// SIMT float32 pipes (no tensor cores, no TMA, no wgmma): scores never
// leave the SM, so device-memory traffic stays O(T D) per tile row, and the
// arithmetic is what a later wgmma/TMA redesign speeds up.
//
// Shared memory per block is (BQ (D+1) + BK (D+1) + BK D + BQ (BK+1) +
// 3 BQ) * 4 bytes: 67 KB at D = 64 and 215 KB at D = 256, above the 48 KB
// static limit, so the launch raises the function's dynamic shared-memory
// limit first (cudaFuncAttributeMaxDynamicSharedMemorySize).
//
// C interface (bound with ctypes): mgwfbp_flash_attn_fwd returns the CUDA
// error code of the launch (0 = success). It launches on the given stream,
// does not synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per shared-memory tile
constexpr int TX = 16;            // thread grid: TX x TY = 256 threads
constexpr int TY = 16;
constexpr int NT = TX * TY;
constexpr int RQ = BQ / TY;       // query rows per thread
constexpr int RK = BK / TX;       // key columns per thread in the score tile
constexpr int NWARP = NT / 32;
constexpr int ROWS_PER_WARP = BQ / NWARP;
constexpr float NEG_INF = -1e30f; // finite mask value, as the reference

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int DPAD>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int H, int seq, int D,
    int64_t sqb, int64_t sqt, int64_t sqh, int64_t skb, int64_t skt,
    int64_t skh, int64_t svb, int64_t svt, int64_t svh, float scale,
    int causal) {
  constexpr int DJ = DPAD / TX;  // accumulator columns per thread
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sQ = smem;                 // BQ x ld, pre-scaled
  float* sK = sQ + BQ * ld;         // BK x ld
  float* sV = sK + BK * ld;         // BK x D
  float* sP = sV + BK * D;          // BQ x (BK + 1): scores, then p
  float* sAlpha = sP + BQ * (BK + 1);
  float* sL = sAlpha + BQ;
  float* sM = sL + BQ;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int t = q0 + r;
    sQ[r * ld + d] = t < seq ? to_f32(qb[t * sqt + d]) * scale : 0.f;
  }
  if (tid < BQ) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }

  float acc[RQ][DJ];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  // causal: keys past this tile's last query row contribute nothing
  const int k_end = causal ? min(seq, q0 + BQ) : seq;
  const int n_tiles = (k_end + BK - 1) / BK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // last tile's readers are done with sK/sV/sP
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D;
      const int d = idx - r * D;
      const int t = k0 + r;
      const bool in = t < seq;
      sK[r * ld + d] = in ? to_f32(kb[t * skt + d]) : 0.f;
      sV[r * D + d] = in ? to_f32(vb[t * svt + d]) : 0.f;
    }
    __syncthreads();

    // scores: each thread a RQ x RK micro-tile, rows ty + TY*i, keys tx + TX*j
    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RQ], kv[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = sQ[(ty + TY * i) * ld + d];
#pragma unroll
      for (int j = 0; j < RK; ++j) kv[j] = sK[(tx + TX * j) * ld + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty + TY * i;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int c = tx + TX * j;
        const int kpos = k0 + c;
        const bool keep = kpos < seq && (!causal || kpos <= q0 + r);
        sP[r * (BK + 1) + c] = keep ? s[i][j] : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax, one warp per ROWS_PER_WARP rows, two keys per lane
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp * ROWS_PER_WARP + rr;
      float* row = sP + r * (BK + 1);
      const float x0 = row[lane];
      const float x1 = row[lane + 32];
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
      const int qpos = q0 + r;
      const int kp0 = k0 + lane;
      const int kp1 = kp0 + 32;
      const bool keep0 = kp0 < seq && (!causal || kp0 <= qpos);
      const bool keep1 = kp1 < seq && (!causal || kp1 <= qpos);
      const float p0 = keep0 ? expf(x0 - m_new) : 0.f;
      const float p1 = keep1 ? expf(x1 - m_new) : 0.f;
      row[lane] = p0;
      row[lane + 32] = p1;
      const float psum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        sAlpha[r] = a;
        sL[r] = sL[r] * a + psum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p v
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const float a = sAlpha[ty + TY * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= a;
    }
    const int kn = min(BK, seq - k0);
    for (int c = 0; c < kn; ++c) {
      float pv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = sP[(ty + TY * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + TX * j;
        const float vv = d < D ? sV[c * D + d] : 0.f;
#pragma unroll
        for (int i = 0; i < RQ; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty + TY * i;
    const int t = q0 + r;
    if (t >= seq) continue;
    const float l = fmaxf(sL[r], 1e-30f);
    T* orow = o + ((static_cast<int64_t>(b) * seq + t) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + TX * j;
      if (d < D) store_f32(orow + d, acc[i][j] / l);
    }
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(BQ) * (D + 1) +
                          static_cast<size_t>(BK) * (D + 1) +
                          static_cast<size_t>(BK) * D + BQ * (BK + 1) +
                          3 * BQ);
}

template <typename T, int DPAD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int seq, int H, int D, const int64_t* st,
                   float scale, int causal, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, DPAD>;
  const size_t bytes = smem_bytes(D);
  // set on every launch: the attribute belongs to the current device, and
  // a process may launch on more than one
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (seq + BQ - 1) / BQ);
  kernel<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, seq, D, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int B, int seq, int H, int D, const int64_t* st,
                       float scale, int causal, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, o, B, seq, H, D, st, scale, causal, stream);
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, B, seq, H, D, st, scale, causal, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, B, seq, H, D, st, scale, causal,
                          stream);
  return launch<T, 256>(q, k, v, o, B, seq, H, D, st, scale, causal, stream);
}

}  // namespace

extern "C" const char* mgwfbp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, in the order
// (q batch, q time, q head, k batch, k time, k head, v batch, v time,
// v head); the D stride must be 1.
extern "C" int mgwfbp_flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int seq, int H, int D, long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh, long long svb,
    long long svt, long long svh, float scale, int causal, void* stream) {
  if (B < 1 || seq < 1 || H < 1 || D < 1 || D > 256 || seq > 65535 * BQ)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[9] = {sqb, sqt, sqh, skb, skt, skh, svb, svt, svh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(q, k, v, o, B, seq, H, D, st, scale, causal, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(q, k, v, o, B, seq, H, D, st, scale,
                                    causal, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
