// Mamba2 SSD chunk scan on Hopper tensor cores, bf16, sm_90a.
//
// Replaces the Pallas TPU kernel `ssd_scan_pallas` / `_ssd_kernel` in
// src/repro/kernels/ssd_kernel.py (B3) for bf16 inputs; float32 keeps the
// CUDA-core kernel of ssd_scan.cu.  The function, per (batch, head), with
// seg the within-chunk cumulative sum of dt*A:
//   y[t]  = sum_{u<=t} (C_t . B_u) exp(seg_t - seg_u) dt_u x_u     (intra)
//         + exp(seg_t) C_t . h_in                                  (inter)
//         + D x_t
//   h_out = exp(seg_T) h_in + sum_u exp(seg_T - seg_u) dt_u x_u (x) B_u
// from an optional entering state; returns y (bf16) and the f32 state after
// the last token.
//
// Bound on an H100 SXM: bytes.  At 4 x 2048 tokens the function reads and
// writes ~61 MB (mamba2-130m: 24 heads of 64, state 128) and ~178 MB
// (zamba2-2.7b: 80 heads of 64, state 64), ~18 and ~53 us at 3.35 TB/s,
// against a few us of bf16 tensor-core work (chip_smoke.py computes both
// bounds from each run's shapes).  What matters is the bytes moved and
// keeping every SM busy, so the design splits the sequential scan into
// passes that each run every chunk in parallel:
//
//   1. cb_kernel     per (batch, chunk, 64 x 64 tile pair t >= u):
//                    C.B^T once for all heads (one B/C group), f32 scratch.
//   2. state_kernel  per (batch, chunk, head): seg by a warp scan, seg_T to
//                    scratch, and the chunk's own state
//                    S_c = sum_u (w_u x_u)^T B_u, w_u = exp(seg_T - seg_u) dt_u,
//                    an (hd x ns, K = L) product, f32 scratch.
//   3. pass_kernel   the state recurrence over chunks, elementwise in f32:
//                    h_in[c] = exp(seg_T[c-1]) h_in[c-1] + S[c-1], written
//                    over S in place as the bf16 pairs out_kernel multiplies
//                    (so out_kernel copies them without converting); the
//                    state after the last chunk is hT, in f32.
//   4. out_kernel    per (batch, chunk, head), its 64-token t-tiles in
//                    turn, with h_in and the chunk's x staged once:
//                    y = exp(seg_t) C_t.h_in^T + sum_{u-tiles <= t} scores.x + D x,
//                    scores = C.B^T * exp(seg_t - seg_u) * dt_u, masked
//                    to t >= u with exp taken only there (a masked entry is
//                    an exact 0), kept in registers as the A operand, as B1
//                    keeps its P.  C.B^T is read from scratch into registers
//                    in the accumulator layout.  For u-tiles before the
//                    t-tile, exp(seg_t - seg_u) = exp(seg_t - seg_t0)
//                    exp(seg_t0 - seg_u), t0 the tile's first row: a factor
//                    per row and one per column (both <= 1), so no
//                    exponential per element there.
// Every product is mma.sync m16n8k16 (bf16 operands, f32 accumulators) fed
// by ldmatrix from padded shared-memory tiles staged with cp.async.  The
// products are small (K = 64-256, N = 64-128) and the card is bound by
// bytes here, so the warp-level mma of four warps per block, several blocks
// per SM, is enough; wgmma's 64-row warpgroup tiles and its pipeline would
// buy tensor-core rate this function cannot use.  What holds it back on
// the card is out_kernel's L2 traffic (each head rereads its chunk's C.B^T
// rows and C tiles) at ~3 TB/s; sharing them across heads through a
// cluster's shared memory, registers or L1 measured slower (PERF.md).  x, B and C are bf16
// already; w_u x_u, the masked scores and h_in are f32 values, each split
// into a pair hi + lo of bf16 values and multiplied twice, so they keep
// ~16 bits.  (Rounding them once put errors of 0.03-0.1 on outputs where
// terms of ~50 cancel: in a CPU emulation at these widths for the scores
// and h_in, on the card for w_u x_u at one 16384-token prompt.  The second
// product is cheap in a function bound by bytes.)  Every sum and the state
// passing stay f32.
//
// The chunk L (64, 128 or 256 tokens: `chunk_len` in the wrapper) is the
// kernel's own, whatever chunk the caller names: the
// chunk is a tiling of one and the same sum.  x, B and C are read in place
// at the caller's strides (views of the conv output in the model).  Tokens
// past the end read as zeros with dt = 0 (decay 1, no contribution), so the
// last chunk's state is the state after the last real token.  No atomics:
// two identical calls are bit-equal.  All four kernels run from one C entry
// point, counted as one launch by the wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int T = 64;     // token tile: the rows and depth of the products
constexpr int NT = 128;   // threads of the product kernels: 4 warps x 16 rows
constexpr int PAD = 8;    // bf16 padding per shared-memory row: ldmatrix rows spread over banks
constexpr int PT = 256;   // threads of pass_kernel
constexpr int PF = 8;     // chunks whose states pass_kernel loads ahead

struct Params {
  const bf16* x;          // (b, s, nh, hd), strides sxb, sxs, sxh; last dim contiguous
  const float* dt;        // (b, s, nh), strides sdb, sds, sdh
  const float* A;         // (nh,)
  const bf16* B;          // (b, s, ns), strides sbb, sbs; last dim contiguous
  const bf16* C;          // (b, s, ns), strides scb, scs; last dim contiguous
  const float* D;         // (nh,)
  const float* h0;        // (b, nh, hd, ns), may be null (zeros)
  bf16* y;                // (b, s, nh, hd) contiguous
  float* hT;              // (b, nh, hd, ns) contiguous
  float* cb;              // scratch (b, nc, L, L): C.B^T of each chunk, lower tiles
  float* st;              // scratch (b, nc, nh, hd, ns): S_c in f32, then h_in[c] as
                          // bf16 pairs: per 16-byte slot of 4 elements, 4 hi then 4 lo
  float* segT;            // scratch (b, nc, nh): seg at each chunk's last token
  int S, NH, L, NC;
  long long sxb, sxs, sxh;
  long long sdb, sds, sdh;
  long long sbb, sbs, scb, scs;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !ok (src is then not read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two floats -> the bf16x2 pair hi + lo that sums to them within ~2^-17
__device__ __forceinline__ void pack2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack(a - f.x, b - f.y);
}

// rows [t0, t0 + T) of a (S, W) bf16 slab with row stride `rs` -> shared
// rows of W + PAD, by cp.async; rows at or past S are zeros
template <int W>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, long long rs,
                                      int t0, int S) {
  constexpr int CH = W / 8;
  for (int i = threadIdx.x; i < T * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = t0 + r < S;
    cp16(dst + r * (W + PAD) + c, ok ? src + (long long)(t0 + r) * rs + c : src, ok);
  }
}

// warp 0: dt of the chunk's L tokens (0 past the end) and seg, the inclusive
// cumulative sum of dt*A, L / 32 consecutive tokens per lane
__device__ __forceinline__ void chunk_seg(const float* dtg, long long sds, float A,
                                          int c0, int L, int S, float* sDt,
                                          float* sSeg) {
  const int lane = threadIdx.x & 31;
  const int per = L >> 5, base = lane * per;   // L <= 256: at most 8
  float d[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {   // all loads in flight at once
    const int t = c0 + base + k;
    d[k] = k < per && t < S ? dtg[(long long)t * sds] : 0.f;
  }
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (k < per) {
      sDt[base + k] = d[k];
      run += d[k] * A;
      sSeg[base + k] = run;
    }
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  for (int k = 0; k < per; ++k) sSeg[base + k] += excl;
}

// 1. C.B^T of one 64 x 64 tile pair (t-tile i >= u-tile j) of a chunk
template <int NS>
__global__ void __launch_bounds__(NT) cb_kernel(const Params p) {
  constexpr int LB = NS + PAD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sC = reinterpret_cast<bf16*>(smem);  // T x LB
  bf16* sB = sC + T * LB;                     // T x LB
  int i = 0;
  while ((i + 1) * (i + 2) / 2 <= (int)blockIdx.x) ++i;
  const int j = blockIdx.x - i * (i + 1) / 2;
  const int c = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = c * p.L;
  stage<NS>(sC, p.C + b * p.scb, p.scs, c0 + i * T, p.S);
  stage<NS>(sB, p.B + b * p.sbb, p.sbs, c0 + j * T, p.S);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < NS; k0 += 16) {
    uint32_t a[4];
    ldsm_x4(a, sC + (16 * warp + (lane & 15)) * LB + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t r[4];   // B stored [u][n]: (N, K) rows, two n8 tiles
      ldsm_x4(r, sB + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LB + k0 +
                     ((lane >> 3) & 1) * 8);
      mma(acc[2 * np], a, r[0], r[1]);
      mma(acc[2 * np + 1], a, r[2], r[3]);
    }
  }
  const int g = lane >> 2, q = lane & 3;
  float* out = p.cb + ((long long)(b * p.NC + c) * p.L + i * T + 16 * warp + g) * p.L +
               j * T + 2 * q;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    *reinterpret_cast<float2*>(out + n * 8) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(out + 8 * p.L + n * 8) = make_float2(acc[n][2], acc[n][3]);
  }
}

// 2. the chunk's own state S_c = sum_u (w_u x_u)^T B_u and seg_T, per
// (chunk, head, batch); warp w owns n8 tiles w, w + 4, ... of the state
template <int HD, int NS>
__global__ void __launch_bounds__(NT) state_kernel(const Params p) {
  constexpr int LX = HD + PAD, LB = NS + PAD;
  constexpr int MT = HD / 16, NT8 = NS / 8, WN = (NT8 + 3) / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sX = reinterpret_cast<bf16*>(smem);              // 2 x T x LX: w_u x_u, hi, lo
  bf16* sB = sX + 2 * T * LX;                             // 2 x T x LB: B u-tiles
  float* sDt = reinterpret_cast<float*>(sB + 2 * T * LB); // L
  float* sSeg = sDt + p.L;                                // L
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = c * p.L;
  const bf16* xg = p.x + b * p.sxb + h * p.sxh;
  const bf16* bg = p.B + b * p.sbb;
  // u-tile loads: B by cp.async into one of two buffers, x into registers,
  // the next tile's in flight while the current one's products run
  constexpr int CH = HD / 8, XV = T * CH / NT;   // 16-byte loads of x per thread
  uint4 v[XV];
  auto load = [&](int u0, int buf) {
    stage<NS>(sB + buf * T * LB, bg, p.sbs, c0 + u0, p.S);
    cp_commit();
#pragma unroll
    for (int k = 0; k < XV; ++k) {
      const int i = threadIdx.x + k * NT, r = i / CH, cc = (i % CH) * 8;
      v[k] = c0 + u0 + r < p.S
                 ? *reinterpret_cast<const uint4*>(xg + (long long)(c0 + u0 + r) * p.sxs + cc)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  load(0, 0);
  if (warp == 0)
    chunk_seg(p.dt + b * p.sdb + h * p.sdh, p.sds, p.A[h], c0, p.L, p.S, sDt, sSeg);
  __syncthreads();
  const float segT = sSeg[p.L - 1];
  if (threadIdx.x == 0) p.segT[((long long)b * p.NC + c) * p.NH + h] = segT;
  for (int u = threadIdx.x; u < p.L; u += NT)
    sDt[u] *= expf(segT - sSeg[u]);  // sDt now holds w_u

  float acc[MT][WN][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < WN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  for (int u0 = 0; u0 < p.L; u0 += T) {
    const int buf = (u0 / T) & 1;
    __syncthreads();  // w is written; the previous tile's readers are done
#pragma unroll
    for (int k = 0; k < XV; ++k) {
      const int i = threadIdx.x + k * NT, r = i / CH, cc = (i % CH) * 8;
      const float w = sDt[u0 + r];
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&v[k]);
      uint4 hi, lo;
      uint32_t* ph = reinterpret_cast<uint32_t*>(&hi);
      uint32_t* pl = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h2[e]);
        pack2(f.x * w, f.y * w, ph[e], pl[e]);
      }
      *reinterpret_cast<uint4*>(sX + r * LX + cc) = hi;
      *reinterpret_cast<uint4*>(sX + (T + r) * LX + cc) = lo;
    }
    if (u0 + T < p.L) {
      load(u0 + T, buf ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* sb = sB + buf * T * LB;
#pragma unroll
    for (int k0 = 0; k0 < T; k0 += 16) {
      uint32_t bf[WN][2];
#pragma unroll
      for (int n = 0; n < WN; ++n) {
        const int nt = warp + 4 * n;
        if (nt < NT8) ldsm_x2_t(bf[n], sb + (k0 + (lane & 15)) * LB + nt * 8);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int part = 0; part < 2; ++part) {   // w x = hi + lo
          uint32_t a[4];  // stored [u][p]: (K, M) rows, transposed on load
          ldsm_x4_t(a, sX + (part * T + k0 + (lane & 7) + (lane >> 4) * 8) * LX +
                           m * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int n = 0; n < WN; ++n)
            if (warp + 4 * n < NT8) mma(acc[m][n], a, bf[n][0], bf[n][1]);
        }
    }
  }
  const int g = lane >> 2, q = lane & 3;
  float* out = p.st + (((long long)b * p.NC + c) * p.NH + h) * HD * NS;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < WN; ++n) {
      const int nt = warp + 4 * n;
      if (nt >= NT8) continue;
      float* o = out + (m * 16 + g) * NS + nt * 8 + 2 * q;
      *reinterpret_cast<float2*>(o) = make_float2(acc[m][n][0], acc[m][n][1]);
      *reinterpret_cast<float2*>(o + 8 * NS) = make_float2(acc[m][n][2], acc[m][n][3]);
    }
}

// 3. state passing: four state elements per thread, walking the chunks;
// S[c] is replaced by the state entering chunk c, split into the bf16
// pairs hi + lo that out_kernel feeds the tensor cores (same 16 bytes)
__global__ void __launch_bounds__(PT) pass_kernel(const Params p, int E, int total) {
  const int idx = blockIdx.x * PT + threadIdx.x;
  if (idx >= total) return;
  const int bh = idx / E, e = idx - bh * E;
  const int b = bh / p.NH, h = bh - b * p.NH;
  float4 hc = p.h0 != nullptr ? reinterpret_cast<const float4*>(p.h0)[idx]
                              : make_float4(0.f, 0.f, 0.f, 0.f);
  float4* st = reinterpret_cast<float4*>(p.st);
  for (int c0 = 0; c0 < p.NC; c0 += PF) {
    float4 s[PF];
    float d[PF];
#pragma unroll
    for (int k = 0; k < PF; ++k) {
      if (c0 + k < p.NC) {
        const long long bc = (long long)b * p.NC + c0 + k;
        s[k] = st[(bc * p.NH + h) * E + e];
        d[k] = expf(p.segT[bc * p.NH + h]);
      }
    }
#pragma unroll
    for (int k = 0; k < PF; ++k) {
      if (c0 + k < p.NC) {
        const long long bc = (long long)b * p.NC + c0 + k;
        uint4 w;
        pack2(hc.x, hc.y, w.x, w.z);
        pack2(hc.z, hc.w, w.y, w.w);
        reinterpret_cast<uint4*>(st)[(bc * p.NH + h) * E + e] = w;
        hc = make_float4(d[k] * hc.x + s[k].x, d[k] * hc.y + s[k].y,
                         d[k] * hc.z + s[k].z, d[k] * hc.w + s[k].w);
      }
    }
  }
  reinterpret_cast<float4*>(p.hT)[idx] = hc;
}

// 4. y of one chunk of one head, per (chunk, head, batch), 64-token t-tile
// after t-tile; warp w owns rows 16w .. 16w + 15 of each t-tile and every
// column of y.  h_in and the chunk's x tiles are staged once for all its
// t-tiles.
template <int HD, int NS>
__global__ void __launch_bounds__(NT) out_kernel(const Params p) {
  constexpr int LX = HD + PAD, LB = NS + PAD;
  constexpr int NTX = HD / 8;
  const int TT = p.L / T;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sH = reinterpret_cast<bf16*>(smem);              // 2 x HD x LB: h_in [p][n], hi, lo
  bf16* sC = sH + 2 * HD * LB;                            // 2 x T x LB: C of a t-tile
  bf16* sX = sC + 2 * T * LB;                             // TT x T x LX: the chunk's x
  float* sDt = reinterpret_cast<float*>(sX + TT * T * LX);  // L
  float* sSeg = sDt + p.L;                                // L
  float* sF = sSeg + p.L;                                 // L: column factors
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int c0 = c * p.L;
  const bf16* xg = p.x + b * p.sxb + h * p.sxh;
  const bf16* cg = p.C + b * p.scb;
  // C.B^T of rows ta and tb of t-tile i, u-tile j, in the accumulator
  // layout; the next (i, j)'s values are requested before the current
  // products
  const float* cbr = p.cb + ((long long)(b * p.NC + c) * p.L + 16 * warp + g) * p.L + 2 * q;
  float2 cba[8], cbb[8];
  auto load_cb = [&](int i, int j) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      cba[n] = *reinterpret_cast<const float2*>(cbr + (long long)i * T * p.L + j * T + n * 8);
      cbb[n] = *reinterpret_cast<const float2*>(cbr + (long long)(i * T + 8) * p.L + j * T +
                                                n * 8);
    }
  };
  load_cb(0, 0);
  {
    // h_in, already split into hi + lo by pass_kernel: each 16-byte slot
    // of 4 elements to its hi and lo rows
    const unsigned char* hin = reinterpret_cast<const unsigned char*>(
        p.st + (((long long)b * p.NC + c) * p.NH + h) * HD * NS);
    for (int k = threadIdx.x; k < HD * NS / 4; k += NT) {
      const int r = (4 * k) / NS, col = (4 * k) % NS;
      cp8(sH + r * LB + col, hin + 16 * k);
      cp8(sH + (HD + r) * LB + col, hin + 16 * k + 8);
    }
  }
  for (int j = 0; j < TT; ++j) stage<HD>(sX + j * T * LX, xg, p.sxs, c0 + j * T, p.S);
  stage<NS>(sC, cg, p.scs, c0, p.S);
  cp_commit();
  if (warp == 0)
    chunk_seg(p.dt + b * p.sdb + h * p.sdh, p.sds, p.A[h], c0, p.L, p.S, sDt, sSeg);
  const float Dh = p.D[h];
  const long long ys = (long long)p.NH * HD;
  bf16* yg = p.y + ((long long)b * p.S * p.NH + h) * HD;
  cp_wait<0>();
  __syncthreads();

  for (int i = 0; i < TT; ++i) {
    const int t0 = c0 + i * T;
    const int ta = i * T + 16 * warp + g, tb = ta + 8;   // rows within the chunk
    if (i + 1 < TT) {
      stage<NS>(sC + ((i + 1) & 1) * T * LB, cg, p.scs, t0 + T, p.S);
      cp_commit();
    }
    // column factors of the u-tiles before this t-tile: exp(seg_t0 - seg_u) dt_u
    const float seg0 = sSeg[i * T];
    for (int u = threadIdx.x; u < i * T; u += NT) sF[u] = __expf(seg0 - sSeg[u]) * sDt[u];

    // inter: exp(seg_t) C_t . h_in^T, K = ns
    const bf16* sc = sC + (i & 1) * T * LB;
    float acc[NTX][4];
#pragma unroll
    for (int n = 0; n < NTX; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < NS; k0 += 16) {
      uint32_t a[4];
      ldsm_x4(a, sc + (16 * warp + (lane & 15)) * LB + k0 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NTX / 2; ++np) {
#pragma unroll
        for (int part = 0; part < 2; ++part) {   // h_in = hi + lo
          uint32_t r[4];   // h_in stored [p][n]: (N, K) rows
          ldsm_x4(r, sH + (part * HD + np * 16 + (lane & 7) + (lane >> 4) * 8) * LB +
                         k0 + ((lane >> 3) & 1) * 8);
          mma(acc[2 * np], a, r[0], r[1]);
          mma(acc[2 * np + 1], a, r[2], r[3]);
        }
      }
    }
    const float sa = sSeg[ta], sb = sSeg[tb];
    const float fa = __expf(sa - seg0), fb = __expf(sb - seg0);   // row factors
    {
      const float ea = expf(sa), eb = expf(sb);
#pragma unroll
      for (int n = 0; n < NTX; ++n) {
        acc[n][0] *= ea; acc[n][1] *= ea;
        acc[n][2] *= eb; acc[n][3] *= eb;
      }
    }
    __syncthreads();   // sF is written

    // intra: u-tiles 0 .. i of the chunk, all in shared memory
    for (int j = 0; j <= i; ++j) {
      float s[8][4];
      if (j < i) {   // every t >= u: row factor x column factor
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int u = j * T + n * 8 + 2 * q;
          const float f0 = sF[u], f1 = sF[u + 1];
          s[n][0] = cba[n].x * fa * f0;
          s[n][1] = cba[n].y * fa * f1;
          s[n][2] = cbb[n].x * fb * f0;
          s[n][3] = cbb[n].y * fb * f1;
        }
      } else {       // the diagonal tile: exp only where t >= u
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int u = j * T + n * 8 + 2 * q;
          const float2 va = cba[n], vb = cbb[n];
          const float g0 = sSeg[u], g1 = sSeg[u + 1], d0 = sDt[u], d1 = sDt[u + 1];
          s[n][0] = ta >= u ? va.x * expf(sa - g0) * d0 : 0.f;
          s[n][1] = ta >= u + 1 ? va.y * expf(sa - g1) * d1 : 0.f;
          s[n][2] = tb >= u ? vb.x * expf(sb - g0) * d0 : 0.f;
          s[n][3] = tb >= u + 1 ? vb.y * expf(sb - g1) * d1 : 0.f;
        }
      }
      if (j < i) load_cb(i, j + 1);
      else if (i + 1 < TT) load_cb(i + 1, 0);
      const bf16* xs = sX + j * T * LX;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4], al[4];   // scores = a + al
        pack2(s[2 * kk][0], s[2 * kk][1], a[0], al[0]);
        pack2(s[2 * kk][2], s[2 * kk][3], a[1], al[1]);
        pack2(s[2 * kk + 1][0], s[2 * kk + 1][1], a[2], al[2]);
        pack2(s[2 * kk + 1][2], s[2 * kk + 1][3], a[3], al[3]);
#pragma unroll
        for (int np = 0; np < NTX / 2; ++np) {
          uint32_t r[4];   // x stored [u][p]: (K, N) rows, transposed on load
          ldsm_x4_t(r, xs + (kk * 16 + (lane & 15)) * LX + np * 16 + (lane >> 4) * 8);
          mma(acc[2 * np], a, r[0], r[1]);
          mma(acc[2 * np + 1], a, r[2], r[3]);
          mma(acc[2 * np], al, r[0], r[1]);
          mma(acc[2 * np + 1], al, r[2], r[3]);
        }
      }
    }

    // + D x, y in bf16
    const bf16* xt = sX + i * T * LX;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * warp + g + 8 * half;
      if (t0 + r >= p.S) continue;
#pragma unroll
      for (int n = 0; n < NTX; ++n) {
        const int col = n * 8 + 2 * q;
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xt + r * LX + col));
        *reinterpret_cast<uint32_t*>(yg + (long long)(t0 + r) * ys + col) =
            pack(acc[n][2 * half] + Dh * xv.x, acc[n][2 * half + 1] + Dh * xv.y);
      }
    }
    cp_wait<0>();
    __syncthreads();   // the next C tile is in; this tile's readers of sC, sF are done
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int HD, int NS>
cudaError_t run(const Params& p, int Bsz, cudaStream_t stream) {
  const size_t cb_smem = sizeof(bf16) * 2 * T * (NS + PAD);
  const size_t st_smem =
      sizeof(bf16) * T * 2 * (HD + PAD + NS + PAD) + sizeof(float) * 2 * p.L;
  const size_t out_smem = sizeof(bf16) * (2 * (HD + T) * (NS + PAD) + p.L * (HD + PAD)) +
                          sizeof(float) * 3 * p.L;
  // once per instantiation, for the largest chunk (L = 256)
  static const cudaError_t attr = [] {
    cudaError_t e = allow_smem(cb_kernel<NS>, sizeof(bf16) * 2 * T * (NS + PAD));
    if (e == cudaSuccess)
      e = allow_smem(state_kernel<HD, NS>,
                     sizeof(bf16) * T * 2 * (HD + PAD + NS + PAD) +
                         sizeof(float) * 2 * 256);
    if (e == cudaSuccess)
      e = allow_smem(out_kernel<HD, NS>,
                     sizeof(bf16) * (2 * (HD + T) * (NS + PAD) + 256 * (HD + PAD)) +
                         sizeof(float) * 3 * 256);
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  const int TT = p.L / T;
  if (p.NC > 0) {
    cb_kernel<NS><<<dim3(TT * (TT + 1) / 2, p.NC, Bsz), NT, cb_smem, stream>>>(p);
    state_kernel<HD, NS><<<dim3(p.NC, p.NH, Bsz), NT, st_smem, stream>>>(p);
  }
  const int E = HD * NS / 4, total = Bsz * p.NH * E;
  pass_kernel<<<(total + PT - 1) / PT, PT, 0, stream>>>(p, E, total);
  if (p.NC > 0)
    out_kernel<HD, NS><<<dim3(p.NC, p.NH, Bsz), NT, out_smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_ns(const Params& p, int Bsz, int NS, cudaStream_t s) {
  switch (NS) {
    case 16: return run<HD, 16>(p, Bsz, s);
    case 32: return run<HD, 32>(p, Bsz, s);
    case 64: return run<HD, 64>(p, Bsz, s);
    case 128: return run<HD, 128>(p, Bsz, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// bf16 x, B, C and y; float32 dt, A, D, h0, hT and scratch.  Strides are in
// elements; the last dimension of x, B and C is contiguous, every stride a
// multiple of 8 and every base 16-byte aligned.  y is a contiguous
// (b, s, nh, hd) tensor, hT a contiguous (b, nh, hd, ns) one, h0 contiguous
// or null.  L (the kernel's chunk) is 64, 128 or 256; hd is 16, 32, 64 or
// 128; ns 16, 32, 64 or 128.  scratch holds b * nc * (L * L + nh * hd * ns
// + nh) floats, nc = ceil(s / L), 16-byte aligned.  Launches four kernels
// on `stream`; returns cudaGetLastError() after them.
extern "C" int ssd_tc_forward(const void* x, const float* dt, const float* A,
                              const void* B, const void* C, const float* D,
                              const float* h0, void* y, float* hT, float* scratch,
                              int Bsz, int S, int NH, int HD, int NS, int L,
                              long long sxb, long long sxs, long long sxh,
                              long long sdb, long long sds, long long sdh,
                              long long sbb, long long sbs, long long scb,
                              long long scs, void* stream) {
  if (L != 64 && L != 128 && L != 256) return (int)cudaErrorInvalidValue;
  const int NC = (S + L - 1) / L;
  float* cb = scratch;
  float* st = cb + (long long)Bsz * NC * L * L;
  float* segT = st + (long long)Bsz * NC * NH * HD * NS;
  Params p{static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(B),
           static_cast<const bf16*>(C), D, h0, static_cast<bf16*>(y), hT,
           cb, st, segT, S, NH, L, NC,
           sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, scb, scs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 16: return (int)dispatch_ns<16>(p, Bsz, NS, s);
    case 32: return (int)dispatch_ns<32>(p, Bsz, NS, s);
    case 64: return (int)dispatch_ns<64>(p, Bsz, NS, s);
    case 128: return (int)dispatch_ns<128>(p, Bsz, NS, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
