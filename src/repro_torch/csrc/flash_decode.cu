// Flash decode for Hopper, sm_90a: one new query token per (batch, head)
// against a KV cache.
//
// Replaces the Pallas TPU kernel `flash_decode` / `_decode_kernel` in
// src/repro/kernels/flash_decode.py (B2): per-batch valid length
// `cache_len`, an optional sliding window anchored at cache_len - 1, scale
// D**-0.5, and no work at or past cache_len.
//
// Bound on an H100 SXM: bytes.  Each cached key and value is used by n_rep
// query heads for 2 FLOPs per element, ~n_rep/2 FLOP/byte, far below the
// ~295 FLOP/byte ridge; the least time is the valid cache read once,
// sum_b cache_len[b] * KV * D * 2 (K and V) * 2 B over 3.35 TB/s, ~20 us at
// 8 sequences of 2048 tokens, KV 8, D 128.
//
// Design: one thread block per (KV head, batch) reads its slice of the
// cache exactly once, for all n_rep query heads of the group (the TPU grid
// runs one (batch, head) at a time and re-reads the slice n_rep times).  A
// key row of D elements is read by D/8 lanes with one 16-byte load each, so
// a warp streams 32/(D/8) rows per load instruction, fully coalesced; each
// row group takes U consecutive rows per step so several loads are in
// flight per lane.  The block walks [lo, cache_len) only: the window lower
// bound and the ragged length bound the loop, nothing past cache_len is
// read.  Each row group keeps its own online-softmax state in registers;
// states merge across the lanes of a warp by shuffles and across warps in
// shared memory at the end.  The TPU kernel's sequential grid axis over KV
// blocks becomes this loop; split-K across blocks (for grids smaller than
// the 132 SMs) is left for a later version.
//
// Head dims: 64, 80 and 128.  The lanes of a row group must be a power of
// two for the xor-shuffle reductions, so a row takes D/8 lanes rounded up
// (8, 16, 16); at D 80 lanes 10-15 of each group load nothing and carry
// zeros for q, k and v, and a warp holds 2 row groups.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;          // warps per block
constexpr int NT = NW * 32;

struct Params {
  const void* q;        // (B, H, D) contiguous
  const void* k;        // (B, KV, S, D) contiguous
  const void* v;
  void* o;              // (B, H, D) contiguous
  const int* cache_len; // (B,) int32
  int H, KV, S, window;
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

// merge online-softmax state (m, l, acc) with (mo, lo, acco); -inf m = empty
template <int NREP>
__device__ __forceinline__ void merge(float* m, float* l, float (*acc)[8],
                                      int r, float mo, float lo, const float* acco) {
  const float mn = fmaxf(m[r], mo);
  if (mn == -INFINITY) return;
  const float c1 = (m[r] == -INFINITY) ? 0.f : expf(m[r] - mn);
  const float c2 = (mo == -INFINITY) ? 0.f : expf(mo - mn);
  l[r] = l[r] * c1 + lo * c2;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[r][j] = acc[r][j] * c1 + acco[j] * c2;
  m[r] = mn;
}

__host__ __device__ constexpr int pow2ceil(int v) {
  int r = 1;
  while (r < v) r <<= 1;
  return r;
}

template <typename T, int D, int NREP>
__global__ void __launch_bounds__(NT) fd_kernel(const Params p) {
  constexpr int LPR = pow2ceil(D / 8);  // lanes per key row (a power of two)
  constexpr int RPW = 32 / LPR;         // row groups per warp
  constexpr int G = NW * RPW;           // row groups per block
  constexpr int U = NREP <= 4 ? 4 : 2;  // rows per group per step
  __shared__ float s_m[NW][NREP];
  __shared__ float s_l[NW][NREP];
  __shared__ float s_acc[NW][NREP][D];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sub = lane % LPR;           // which 8 dims of the row
  const bool on = sub * 8 < D;          // lanes past D hold zeros
  const int col = on ? sub * 8 : 0;
  const int grp = warp * RPW + lane / LPR;

  const int len = min(max(p.cache_len[b], 0), p.S);
  const int lo = p.window > 0 ? max(len - p.window, 0) : 0;

  const long long head0 = (long long)b * p.H + (long long)kvh * NREP;
  const T* qg = static_cast<const T*>(p.q) + head0 * D + col;
  const long long slab = ((long long)b * p.KV + kvh) * (long long)p.S * D;
  const T* kg = static_cast<const T*>(p.k) + slab + col;
  const T* vg = static_cast<const T*>(p.v) + slab + col;

  float q[NREP][8], acc[NREP][8], m[NREP], l[NREP];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    if (on) {
      load8(qg + (long long)r * D, q[r]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) q[r][j] = 0.f;
    }
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
  }

  // the loop bound is warp-uniform so every lane reaches every shuffle
  for (int t0 = lo; t0 < len; t0 += G * U) {
    const int base = t0 + grp * U;
    float kf[U][8], vf[U][8];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (on && base + u < len) {
        load8(kg + (long long)(base + u) * D, kf[u]);
        load8(vg + (long long)(base + u) * D, vf[u]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) kf[u][j] = vf[u][j] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      float s[U];
      float smax = -INFINITY;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float d = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) d = fmaf(q[r][j], kf[u][j], d);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        s[u] = (base + u < len) ? d * p.scale : -INFINITY;
        smax = fmaxf(smax, s[u]);
      }
      if (smax == -INFINITY) continue;  // no valid row for this group this step
      const float mn = fmaxf(m[r], smax);
      const float corr = (m[r] == -INFINITY) ? 0.f : expf(m[r] - mn);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float pr = expf(s[u] - mn);
        psum += pr;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(pr, vf[u][j], acc[r][j]);
      }
      l[r] = l[r] * corr + psum;
      m[r] = mn;
    }
  }

  // merge the RPW row groups of this warp (lanes with equal `sub`)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[r], off);
      float ao[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) ao[j] = __shfl_xor_sync(0xffffffffu, acc[r][j], off);
      merge<NREP>(m, l, acc, r, mo, lo_, ao);
    }
  }
  if (lane < LPR && on) {
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s_acc[warp][r][sub * 8 + j] = acc[r][j];
      if (sub == 0) {
        s_m[warp][r] = m[r];
        s_l[warp][r] = l[r];
      }
    }
  }
  __syncthreads();

  // merge across warps; one thread per (head, dim)
  T* og = static_cast<T*>(p.o) + head0 * D;
  for (int idx = threadIdx.x; idx < NREP * D; idx += NT) {
    const int r = idx / D, dcol = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, s_m[w][r]);
    float num = 0.f, den = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        if (s_m[w][r] == -INFINITY) continue;
        const float c = expf(s_m[w][r] - mx);
        den += s_l[w][r] * c;
        num += s_acc[w][r][dcol] * c;
      }
    }
    store1(og + (long long)r * D + dcol, num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int D, int NREP>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const dim3 grid(p.KV, B);
  fd_kernel<T, D, NREP><<<grid, NT, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_rep(const Params& p, int B, int n_rep, cudaStream_t s) {
  switch (n_rep) {
    case 1: return launch<T, D, 1>(p, B, s);
    case 2: return launch<T, D, 2>(p, B, s);
    case 4: return launch<T, D, 4>(p, B, s);
    case 7: return launch<T, D, 7>(p, B, s);
    case 8: return launch<T, D, 8>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int B, int D, int n_rep, cudaStream_t s) {
  switch (D) {
    case 64: return dispatch_rep<T, 64>(p, B, n_rep, s);
    case 80: return dispatch_rep<T, 80>(p, B, n_rep, s);
    case 128: return dispatch_rep<T, 128>(p, B, n_rep, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v, o contiguous; cache_len int32
// on the device.  Returns cudaGetLastError() after the launch.
extern "C" int fd_forward(const void* q, const void* k, const void* v, void* o,
                          const int* cache_len, int B, int H, int KV, int S, int D,
                          int window, float scale, int dtype, void* stream) {
  Params p{q, k, v, o, cache_len, H, KV, S, window, scale};
  const int n_rep = H / KV;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 1 ? dispatch_d<__nv_bfloat16>(p, B, D, n_rep, s)
                             : dispatch_d<float>(p, B, D, n_rep, s);
  return (int)e;
}
