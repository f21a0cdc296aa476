// Flash attention (prefill) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention` / `_flash_kernel` in
// src/repro/kernels/flash_attention.py (B1): blocked online-softmax GQA
// attention with causal masking at a query offset, an optional sliding
// window and a per-batch valid KV length.
//
// Bound on an H100 SXM: operations.  Causal prefill does 4*H*D*Sq*Sk/2
// FLOPs on Sq*D + 2*Sk*D*KV/H elements per head; at the serving shapes
// (H 32, KV 8, D 128, Sq = Sk = 1536, bf16) that is 19.3 GFLOP against
// 25 MB, i.e. ~770 FLOP/byte, well above the card's ~295 FLOP/byte ridge,
// so the least time is 19.3e9 / 989e12 = ~20 us.
//
// Design (first, simple version): one thread block per (q-tile, head,
// batch).  The TPU kernel carries (m, l, acc) across a *sequential* grid
// axis of KV blocks and skips strictly-future blocks with pl.when; here
// blocks run in parallel in no order, so that axis becomes a loop inside
// the block over KV tiles staged in shared memory, and the causal, window
// and kv_len limits bound the loop itself (no masked tile is ever loaded).
// The products run on CUDA cores in f32 with 4x4 (QK^T) and 4x8 (PV)
// register tiles per thread; rows of K and V are padded to D+1 floats so
// the column walks are free of bank conflicts.  Inputs are read with
// 16-byte vector loads and converted to f32 once, in shared memory.
// Masking uses a true -inf, as the reference's `ops.xla_attention` does:
// a row with no visible key yields 0 and LSE -inf (what a ring merge needs).
// Tensor cores (mma.sync / wgmma) and TMA are left for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // key rows per shared-memory tile
constexpr int NT = 256;   // threads: 16 (tx, key/dim columns) x 16 (ty, rows)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;            // (B, H, Sq) f32, may be null
  const int* kv_len;     // (B,) int32 on the device, may be null
  int H, KV, Sq, Sk;
  long long sqb, sqh, sqs;
  long long skb, skh, sks;
  long long svb, svh, svs;
  int causal, window, q_offset;
  float scale;
};

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// rows [row0, row0 + BK) of a (S, D) slab with row stride `ss` -> smem (LD floats/row)
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, long long ss,
                                           int row0, int nrows, int S) {
  constexpr int LD = D + 1;
  constexpr int CH = D / 8;  // 8-element chunks per row
  for (int i = threadIdx.x; i < nrows * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    float tmp[8];
    if (row0 + r < S) {
      load8(src + (long long)(row0 + r) * ss + c, tmp);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) tmp[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[r * LD + c + j] = tmp[j];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) fa_kernel(const Params p) {
  constexpr int LD = D + 1;
  constexpr int LP = BK + 1;
  constexpr int DC = D / 16;  // output dims per thread
  extern __shared__ float smem[];
  float* sQ = smem;             // BQ x LD
  float* sK = sQ + BQ * LD;     // BK x LD
  float* sV = sK + BK * LD;     // BK x LD
  float* sP = sV + BK * LD;     // BQ x LP

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const T* qg = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
  const T* kg = static_cast<const T*>(p.k) + b * p.skb + kvh * p.skh;
  const T* vg = static_cast<const T*>(p.v) + b * p.svb + kvh * p.svh;

  int kv_len = p.Sk;
  if (p.kv_len != nullptr) kv_len = min(max(p.kv_len[b], 0), p.Sk);

  // key range this q-tile can see: [k_lo, k_hi)
  const int qpos_lo = q0 + p.q_offset;
  const int qpos_hi = min(q0 + BQ, p.Sq) - 1 + p.q_offset;
  int k_hi = kv_len;
  if (p.causal) k_hi = min(k_hi, qpos_hi + 1);
  int k_lo = 0;
  if (p.window > 0) k_lo = max(0, qpos_lo - p.window + 1);

  stage_rows<T, D>(sQ, qg, p.sqs, q0, BQ, p.Sq);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's sK/sV/sP readers are done
    stage_rows<T, D>(sK, kg, p.sks, k0, BK, p.Sk);
    stage_rows<T, D>(sV, vg, p.svs, k0, BK, p.Sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sQ[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i + p.q_offset;
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < kv_len;
        if (p.causal) ok = ok && (qpos >= kpos);
        if (p.window > 0) ok = ok && (qpos - kpos < p.window);
        s[i][j] = ok ? s[i][j] * p.scale : -INFINITY;
        rmax = fmaxf(rmax, s[i][j]);
      }
      // the 16 threads holding one row are lanes of one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float m_safe = (m_new == -INFINITY) ? 0.f : m_new;
      const float corr = (m[i] == -INFINITY) ? 0.f : expf(m[i] - m_safe);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr = expf(s[i][j] - m_safe);  // exp(-inf) = 0 where masked
        s[i][j] = pr;
        rsum += pr;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) sP[(ty + 16 * i) * LP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = sP[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = sV[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pr[i], vv, acc[i][c]);
      }
    }
  }

  T* og = static_cast<T*>(p.o) + ((long long)b * p.H + h) * p.Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= p.Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) store1(og + (long long)r * D + tx + 16 * c, acc[i][c] * inv);
    if (p.lse != nullptr && tx == 0)
      p.lse[((long long)b * p.H + h) * p.Sq + r] =
          l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int LD = D + 1;
  const size_t smem = sizeof(float) * ((BQ + 2 * BK) * LD + BQ * (BK + 1));
  cudaError_t e = cudaFuncSetAttribute(fa_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
  fa_kernel<T, D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(p, B, stream);
    case 64: return launch<T, 64>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last
// dimension of q, k and v is contiguous.  o is a contiguous (B, H, Sq, D)
// tensor of q's dtype.  Returns cudaGetLastError() after the launch.
extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o,
                          float* lse, const int* kv_len, int B, int H, int KV,
                          int Sq, int Sk, int D, long long sqb, long long sqh,
                          long long sqs, long long skb, long long skh, long long sks,
                          long long svb, long long svh, long long svs, int causal,
                          int window, int q_offset, float scale, int dtype,
                          void* stream) {
  Params p{q, k, v, o, lse, kv_len, H, KV, Sq, Sk, sqb, sqh, sqs, skb, skh, sks,
           svb, svh, svs, causal, window, q_offset, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 1 ? dispatch_d<__nv_bfloat16>(p, B, D, s)
                             : dispatch_d<float>(p, B, D, s);
  return (int)e;
}
