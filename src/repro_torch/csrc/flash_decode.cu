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
// Design: the key axis is split across blocks.  fd_split_kernel runs one
// block per (KV head, batch, split); the split count and length come from
// S and the grid size on the host (never from cache_len, which lies on the
// device), aiming at several blocks per SM: 8 splits of 256 keys, 512
// blocks, at 8 sequences x 2048 x KV 8.  A block streams its range of the
// cache once, for all n_rep query heads of its group, and writes its
// online-softmax partial (m, l, acc[n_rep][D]) in f32 to scratch the
// caller allocates; a split that lies wholly at or past cache_len, or
// below the window, writes m = -inf and exits at once.  fd_combine_kernel
// merges the splits of each (batch, head) in a fixed order and writes the
// output in q's dtype: no atomics, so the result is deterministic, and a
// sequence with cache_len 0 yields 0.
//
// Inside a block a key row of D elements is read by D/8 lanes with one
// 16-byte load each (a warp streams 32/(D/8) rows per load instruction,
// fully coalesced), and each row group takes U consecutive rows per step.
// Rows travel by cp.async into a ring of STAGES steps in shared memory
// (each thread into its own slots), so three steps of loads are in flight
// during a step's dot products and shuffles without holding registers: a
// block's 8 steps of 32 rows would otherwise be 8 memory round trips one
// after another.  Row groups keep their own softmax state; states merge
// across the lanes of a warp by shuffles and across warps in shared
// memory.  No TMA: a tensor map encoded on the host per call would add
// host time to a decode step that is already host-bound.
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

constexpr int NW = 4;          // warps per block
constexpr int NT = NW * 32;
constexpr int ROWS = 4;        // rows per row group per step (half at n_rep > 4)
constexpr int STAGES = 4;      // steps in the cp.async ring (half for f32 rows)

struct Params {
  const void* q;        // (B, H, D) contiguous
  const void* k;        // (B, KV, S, D) contiguous
  const void* v;
  const int* cache_len; // (B,) int32
  float* part_acc;      // (B, H, n_split, D) f32 scratch
  float* part_ml;       // (B, H, n_split, 2) f32 scratch: (m, l)
  int H, KV, S, window, n_split, chunk;
  float scale;
};

// 8 consecutive elements of a row, as raw 16-byte vectors
template <typename T>
struct Vec8;

template <>
struct Vec8<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void zero() { u = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void get(float* out) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Vec8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void zero() { a = b = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ void get(float* out) const {
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  }
};

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

// steps of rows in the shared-memory ring: f32 rows take twice the bytes
template <typename T>
__host__ __device__ constexpr int stages() {
  return sizeof(T) == 2 ? STAGES : (STAGES + 1) / 2;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 8 elements (16 or 32 bytes) of a row, global -> shared, without a
// register; zeros in place of the row when !ok
template <typename T>
__device__ __forceinline__ void cp_async_row(T* dst, const T* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
#pragma unroll
  for (int c = 0; c < (int)sizeof(T) * 8 / 16; ++c)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d + 16 * c),
                 "l"(reinterpret_cast<const char*>(src) + 16 * c), "r"(ok ? 16 : 0)
                 : "memory");
}

template <typename T, int D, int NREP>
__global__ void __launch_bounds__(NT) fd_split_kernel(const Params p) {
  constexpr int LPR = pow2ceil(D / 8);  // lanes per key row (a power of two)
  constexpr int RPW = 32 / LPR;         // row groups per warp
  constexpr int G = NW * RPW;           // row groups per block
  constexpr int U = NREP <= 4 ? ROWS : (ROWS + 1) / 2;  // rows per group per step
  __shared__ float s_m[NW][NREP];
  __shared__ float s_l[NW][NREP];
  __shared__ float s_acc[NW][NREP][D];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sub = lane % LPR;           // which 8 dims of the row
  const bool on = sub * 8 < D;          // lanes past D hold zeros
  const int col = on ? sub * 8 : 0;
  const int grp = warp * RPW + lane / LPR;

  const int len = min(max(p.cache_len[b], 0), p.S);
  const int lo = p.window > 0 ? max(len - p.window, 0) : 0;
  const int beg = max(lo, split * p.chunk);
  const int end = min(len, (split + 1) * p.chunk);
  // partial of head (kvh * NREP + r) of batch b: index part0 + r * n_split
  const long long part0 = ((long long)b * p.H + (long long)kvh * NREP) * p.n_split + split;
  if (beg >= end) {
    if (threadIdx.x < NREP) {
      p.part_ml[2 * (part0 + threadIdx.x * p.n_split)] = -INFINITY;
      p.part_ml[2 * (part0 + threadIdx.x * p.n_split) + 1] = 0.f;
    }
    return;
  }

  const long long head0 = (long long)b * p.H + (long long)kvh * NREP;
  const T* qg = static_cast<const T*>(p.q) + head0 * D + col;
  const long long slab = ((long long)b * p.KV + kvh) * (long long)p.S * D;
  // row r of this lane's columns is at kg + r * D
  const T* kg = static_cast<const T*>(p.k) + slab + col;
  const T* vg = static_cast<const T*>(p.v) + slab + col;

  float q[NREP][8], acc[NREP][8], m[NREP], l[NREP];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    Vec8<T> t;
    if (on) {
      t.load(qg + (long long)r * D);
    } else {
      t.zero();
    }
    t.get(q[r]);
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
  }

  // Each thread copies the rows it will read into its own slots of a ring
  // of STG steps in shared memory (cp.async, zero fill past `end`), so
  // STG - 1 steps of loads are in flight during a step's arithmetic
  // without holding registers; a thread reads only its own slots, so no
  // block barrier is needed.
  extern __shared__ __align__(16) unsigned char fd_smem[];
  T* ring = reinterpret_cast<T*>(fd_smem);
  constexpr int STG = stages<T>();
  const int n_steps = (end - beg + G * U - 1) / (G * U);   // warp-uniform
  // slot j of a step: row u's K at j = 2u, its V at 2u + 1
  auto slot = [&](int step, int j) {
    return ring + ((long long)((step % STG) * 2 * U + j) * NT + threadIdx.x) * 8;
  };
  auto issue = [&](int step) {
    if (step < n_steps) {
      const int base = beg + step * G * U + grp * U;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool ok = on && base + u < end;
        const long long off = ok ? (long long)(base + u) * D : 0;
        cp_async_row<T>(slot(step, 2 * u), kg + off, ok);
        cp_async_row<T>(slot(step, 2 * u + 1), vg + off, ok);
      }
    }
    cp_async_commit();   // an empty group past the last step keeps the count
  };
#pragma unroll
  for (int i = 0; i < STG - 1; ++i) issue(i);
  // the loop bound is warp-uniform so every lane reaches every shuffle
  for (int i = 0; i < n_steps; ++i) {
    const int base = beg + i * G * U + grp * U;
    issue(i + STG - 1);
    cp_async_wait<STG - 1>();   // step i's rows have landed
    float kf[U][8], vf[U][8];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      Vec8<T> t;
      t.load(slot(i, 2 * u));
      t.get(kf[u]);
      t.load(slot(i, 2 * u + 1));
      t.get(vf[u]);
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
        s[u] = (base + u < end) ? d * p.scale : -INFINITY;
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

  // merge across warps into this split's partial; one thread per (head, dim)
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
    const long long part = part0 + (long long)r * p.n_split;
    p.part_acc[part * D + dcol] = num;
    if (dcol == 0) {
      p.part_ml[2 * part] = mx;
      p.part_ml[2 * part + 1] = den;
    }
  }
}

// one block per (batch, head): merge its n_split partials in split order
template <typename T, int D>
__global__ void fd_combine_kernel(const float* __restrict__ part_acc,
                                  const float* __restrict__ part_ml, T* __restrict__ o,
                                  int n_split) {
  const long long bh = blockIdx.x;
  const int d = threadIdx.x;
  if (d >= D) return;
  const float* ml = part_ml + 2 * bh * n_split;
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, ml[2 * s]);
  float num = 0.f, den = 0.f;
  if (mx != -INFINITY) {
    for (int s = 0; s < n_split; ++s) {
      if (ml[2 * s] == -INFINITY) continue;
      const float c = expf(ml[2 * s] - mx);
      den += ml[2 * s + 1] * c;
      num += part_acc[(bh * n_split + s) * D + d] * c;
    }
  }
  store1(o + bh * D + d, num / fmaxf(den, 1e-30f));
}

template <typename T, int D, int NREP>
cudaError_t launch(const Params& p, int B, void* o, cudaStream_t stream) {
  constexpr int U = NREP <= 4 ? ROWS : (ROWS + 1) / 2;
  constexpr int smem = stages<T>() * 2 * U * NT * 8 * (int)sizeof(T);
  static bool smem_set = false;   // once per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        fd_split_kernel<T, D, NREP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const dim3 grid(p.KV, B, p.n_split);
  fd_split_kernel<T, D, NREP><<<grid, NT, smem, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  fd_combine_kernel<T, D><<<B * p.H, (D + 31) / 32 * 32, 0, stream>>>(
      p.part_acc, p.part_ml, static_cast<T*>(o), p.n_split);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_rep(const Params& p, int B, int n_rep, void* o, cudaStream_t s) {
  switch (n_rep) {
    case 1: return launch<T, D, 1>(p, B, o, s);
    case 2: return launch<T, D, 2>(p, B, o, s);
    case 3: return launch<T, D, 3>(p, B, o, s);
    case 4: return launch<T, D, 4>(p, B, o, s);
    case 5: return launch<T, D, 5>(p, B, o, s);
    case 7: return launch<T, D, 7>(p, B, o, s);
    case 8: return launch<T, D, 8>(p, B, o, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int B, int D, int n_rep, void* o, cudaStream_t s) {
  switch (D) {
    case 64: return dispatch_rep<T, 64>(p, B, n_rep, o, s);
    case 80: return dispatch_rep<T, 80>(p, B, n_rep, o, s);
    case 128: return dispatch_rep<T, 128>(p, B, n_rep, o, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v, o contiguous; cache_len int32
// on the device; part_acc (B, H, n_split, D) and part_ml (B, H, n_split, 2)
// f32 scratch; split i covers keys [i * chunk, (i + 1) * chunk).  Launches
// the split kernel and the combine kernel; returns cudaGetLastError() after
// them.
extern "C" int fd_forward(const void* q, const void* k, const void* v, void* o,
                          const int* cache_len, float* part_acc, float* part_ml, int B,
                          int H, int KV, int S, int D, int window, int n_split, int chunk,
                          float scale, int dtype, void* stream) {
  if (n_split < 1 || chunk < 1 || (long long)n_split * chunk < S) return (int)cudaErrorInvalidValue;
  Params p{q, k, v, cache_len, part_acc, part_ml, H, KV, S, window, n_split, chunk, scale};
  const int n_rep = H / KV;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 1 ? dispatch_d<__nv_bfloat16>(p, B, D, n_rep, o, s)
                             : dispatch_d<float>(p, B, D, n_rep, o, s);
  return (int)e;
}
