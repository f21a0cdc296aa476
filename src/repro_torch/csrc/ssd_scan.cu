// Mamba2 SSD chunk scan for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `ssd_scan_pallas` / `_ssd_kernel` in
// src/repro/kernels/ssd_kernel.py (B3).  Per (batch, head) it computes, chunk
// by chunk, with seg the within-chunk cumulative sum of dt*A:
//   y[t]  = sum_{u<=t} (C_t . B_u) exp(seg_t - seg_u) dt_u x_u     (intra)
//         + exp(seg_t) C_t . h_in                                  (inter)
//         + D x_t
//   h_out = exp(seg_T) h_in + sum_u exp(seg_T - seg_u) dt_u x_u (x) B_u
// from an optional entering state, and returns the state after the last
// token.  This kernel is the f32 path: x, B, C, y, dt, A, D, the state and
// every sum are f32.  bf16 goes to the tensor-core kernels of ssd_scan_tc.cu.
//
// Bound on an H100 SXM: bytes, at the serving shapes.  The function reads x,
// dt, B, C (and the entering state) once and writes y and the final state
// once; at 4 x 2048 tokens that is ~61 MB for mamba2-130m (24 heads of 64,
// state 128) and ~178 MB for zamba2-2.7b (80 heads of 64, state 64), i.e.
// ~18 us and ~53 us at 3.35 TB/s, against ~14 us and ~16 us for its
// operations at the bf16 tensor-core rate (data-sheet arithmetic, not a
// measurement; chip_smoke.py computes both from the shapes of each run).
//
// Design (first, simple version):
// - The TPU kernel carries the (hd, ns) state in VMEM scratch along a
//   sequential grid axis of chunks.  CUDA blocks run in no order, so the
//   chunk axis is a loop inside the block and the state lives in shared
//   memory for the whole sequence.
// - Rows of the state are independent (y[:, p] needs x[:, p] and the shared
//   dt, B, C only), so a block owns P of the hd rows: grid (hd/P, nh, b).
//   The wrapper picks P in {16, 32, 64} to put at least two blocks on each
//   SM; the chunk's C.B^T and decay are recomputed by each of a head's
//   hd/P blocks.
// - The kernel tiles the sequence in its OWN chunk of L = 64 tokens,
//   whatever chunk the caller names: the chunk is a tiling of one and the
//   same sum, and the L x L f32 score tile of a 256-token chunk (256 KB)
//   would not fit a block's 227 KB of shared memory.
// - Each chunk: B, C (L x ns) and x (L x P) are staged in shared memory as
//   f32 with 16-byte loads at the caller's strides (x, B and C are strided
//   views of the conv output in the model); one warp scans dt*A; then three
//   small products on CUDA cores with 4 x (P/16 or 4 or ns/16) register
//   tiles: scores = C.B^T masked to t >= u, y = scores.x + exp(seg) C.h + Dx,
//   h = exp(seg_T) h + (w x)^T.B.  exp is taken only where t >= u, so a
//   masked entry is an exact 0 and never inf*0.
// - Tokens past the sequence end are zeros in shared memory with dt = 0
//   (decay 1, no contribution), so the final state is the state after the
//   last real token and no padded copy of any input is made.
// Tensor cores and one C.B^T per (batch, chunk) shared by all heads are the
// bf16 design of ssd_scan_tc.cu; this kernel keeps f32 to 2e-5.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int L = 64;     // the kernel's own chunk: tokens per shared-memory tile
constexpr int NT = 256;   // threads: 16 (tx) x 16 (ty)

struct Params {
  const float* x;         // (b, s, nh, hd), strides sxb, sxs, sxh; last dim contiguous
  const float* dt;        // (b, s, nh), strides sdb, sds, sdh
  const float* A;         // (nh,)
  const float* B;         // (b, s, ns), strides sbb, sbs; last dim contiguous
  const float* C;         // (b, s, ns), strides scb, scs; last dim contiguous
  const float* D;         // (nh,)
  const float* h0;        // (b, nh, hd, ns) contiguous, may be null (zeros)
  float* y;               // (b, s, nh, hd) contiguous
  float* hT;              // (b, nh, hd, ns) contiguous
  int S, NH, HD;
  long long sxb, sxs, sxh;
  long long sdb, sds, sdh;
  long long sbb, sbs, scb, scs;
};

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}


// rows [t0, t0 + L) of a (S, W) slab with row stride `rs` -> shared memory
// rows of `ld` floats; rows at or past S are zeros
template <int W>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      long long rs, int t0, int S) {
  constexpr int CH = W / 8;  // 8-element chunks per row
  for (int i = threadIdx.x; i < L * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    float tmp[8];
    if (t0 + r < S) {
      load8(src + (long long)(t0 + r) * rs + c, tmp);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) tmp[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[r * ld + c + j] = tmp[j];
  }
}

template <int NS, int P>
__global__ void __launch_bounds__(NT) ssd_kernel(const Params p) {
  constexpr int LDN = NS + 1;  // B, C and state rows padded: column walks free of bank conflicts
  constexpr int LDL = L + 1;
  constexpr int PJ = P / 16;   // head dims per thread in y; state rows per thread
  constexpr int NJ = NS / 16;  // state columns per thread
  extern __shared__ float smem[];
  float* sB = smem;               // L x LDN
  float* sC = sB + L * LDN;       // L x LDN
  float* sX = sC + L * LDN;       // L x P
  float* sS = sX + L * P;         // L x LDL   masked scores
  float* sH = sS + L * LDL;       // P x LDN   state rows p0 .. p0 + P
  float* sDt = sH + P * LDN;      // L
  float* sSeg = sDt + L;          // L   inclusive cumulative dt*A in the chunk
  float* sW = sSeg + L;           // L   exp(seg_T - seg_u) * dt_u

  const int p0 = blockIdx.x * P;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const float* xg = p.x + b * p.sxb + h * p.sxh + p0;
  const float* dtg = p.dt + b * p.sdb + h * p.sdh;
  const float* bg = p.B + b * p.sbb;
  const float* cg = p.C + b * p.scb;
  const float A = p.A[h];
  const float Dh = p.D[h];
  const long long st0 = (((long long)b * p.NH + h) * p.HD + p0) * NS;
  float* yg = p.y + ((long long)b * p.S * p.NH + h) * p.HD + p0;
  const long long ys = (long long)p.NH * p.HD;  // y row stride

  for (int i = threadIdx.x; i < P * NS; i += NT)
    sH[(i / NS) * LDN + i % NS] = p.h0 != nullptr ? p.h0[st0 + i] : 0.f;

  for (int t0 = 0; t0 < p.S; t0 += L) {
    __syncthreads();  // the previous chunk's readers and state writers are done
    stage<NS>(sB, LDN, bg, p.sbs, t0, p.S);
    stage<NS>(sC, LDN, cg, p.scs, t0, p.S);
    stage<P>(sX, P, xg, p.sxs, t0, p.S);
    if (warp == 0) {
      // dt of the chunk (0 past the end) and the inclusive prefix sum of
      // dt*A, two tokens per lane
      const int ta = t0 + 2 * lane, tb = ta + 1;
      const float da = ta < p.S ? dtg[ta * p.sds] : 0.f;
      const float db = tb < p.S ? dtg[tb * p.sds] : 0.f;
      const float la = da * A;
      float incl = la + db * A;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      const float segT = __shfl_sync(0xffffffffu, incl, 31);
      const float sa = excl + la;
      sDt[2 * lane] = da;
      sDt[2 * lane + 1] = db;
      sSeg[2 * lane] = sa;
      sSeg[2 * lane + 1] = incl;
      sW[2 * lane] = expf(segT - sa) * da;
      sW[2 * lane + 1] = expf(segT - incl) * db;
    }
    __syncthreads();

    // scores[t][u] = (C_t . B_u) exp(seg_t - seg_u) dt_u for t >= u, else 0
    {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int n = 0; n < NS; ++n) {
        float ca[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ca[i] = sC[(ty + 16 * i) * LDN + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = sB[(tx + 16 * j) * LDN + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(ca[i], bb[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = ty + 16 * i, u = tx + 16 * j;
          sS[t * LDL + u] = t >= u ? s[i][j] * expf(sSeg[t] - sSeg[u]) * sDt[u] : 0.f;
        }
    }
    __syncthreads();

    // y[t][p] = scores.x + exp(seg_t) C_t . h_in[p] + D x[t][p]
    {
      float yi[4][PJ], yo[4][PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) yi[i][j] = yo[i][j] = 0.f;
#pragma unroll 8
      for (int u = 0; u < L; ++u) {
        float sc[4], xv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[i] = sS[(ty + 16 * i) * LDL + u];
#pragma unroll
        for (int j = 0; j < PJ; ++j) xv[j] = sX[u * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) yi[i][j] = fmaf(sc[i], xv[j], yi[i][j]);
      }
#pragma unroll 8
      for (int n = 0; n < NS; ++n) {
        float ca[4], hv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) ca[i] = sC[(ty + 16 * i) * LDN + n];
#pragma unroll
        for (int j = 0; j < PJ; ++j) hv[j] = sH[(tx + 16 * j) * LDN + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) yo[i][j] = fmaf(ca[i], hv[j], yo[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t0 + t >= p.S) continue;
        const float e = expf(sSeg[t]);
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const int c = tx + 16 * j;
          yg[(long long)(t0 + t) * ys + c] =
              yi[i][j] + e * yo[i][j] + Dh * sX[t * P + c];
        }
      }
    }
    __syncthreads();  // h_in was read above; it is rewritten below

    // h[p][n] = exp(seg_T) h[p][n] + sum_u (w_u x[u][p]) B[u][n]
    {
      const float eT = expf(sSeg[L - 1]);  // dt is 0 past the end: seg_T of the real tokens
      float acc[PJ][NJ];
#pragma unroll
      for (int i = 0; i < PJ; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int u = 0; u < L; ++u) {
        const float w = sW[u];
        float xv[PJ], bv[NJ];
#pragma unroll
        for (int i = 0; i < PJ; ++i) xv[i] = sX[u * P + ty + 16 * i] * w;
#pragma unroll
        for (int j = 0; j < NJ; ++j) bv[j] = sB[u * LDN + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < PJ; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < PJ; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float* hp = &sH[(ty + 16 * i) * LDN + tx + 16 * j];
          *hp = *hp * eT + acc[i][j];
        }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < P * NS; i += NT)
    p.hT[st0 + i] = sH[(i / NS) * LDN + i % NS];
}

template <int NS, int P>
cudaError_t launch(const Params& p, int Bsz, cudaStream_t stream) {
  constexpr int LDN = NS + 1;
  const size_t smem =
      sizeof(float) * (2 * L * LDN + L * P + L * (L + 1) + P * LDN + 3 * L);
  cudaError_t e = cudaFuncSetAttribute(ssd_kernel<NS, P>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.HD / P, p.NH, Bsz);
  ssd_kernel<NS, P><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int NS>
cudaError_t dispatch_p(const Params& p, int Bsz, int P, cudaStream_t s) {
  switch (P) {
    case 16: return launch<NS, 16>(p, Bsz, s);
    case 32: return launch<NS, 32>(p, Bsz, s);
    case 64: return launch<NS, 64>(p, Bsz, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_ns(const Params& p, int Bsz, int NS, int P, cudaStream_t s) {
  switch (NS) {
    case 16: return dispatch_p<16>(p, Bsz, P, s);
    case 32: return dispatch_p<32>(p, Bsz, P, s);
    case 64: return dispatch_p<64>(p, Bsz, P, s);
    case 128: return dispatch_p<128>(p, Bsz, P, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Every tensor is float32.  Strides are in elements; the last dimension of
// x, B and C is contiguous.  h0 may be null.  y is a contiguous (b, s, nh, hd)
// tensor, hT a contiguous (b, nh, hd, ns) one.  P (state rows per block)
// divides hd.  Returns cudaGetLastError() after the launch.
extern "C" int ssd_forward(const float* x, const float* dt, const float* A,
                           const float* B, const float* C, const float* D,
                           const float* h0, float* y, float* hT, int Bsz, int S,
                           int NH, int HD, int NS, int P, long long sxb,
                           long long sxs, long long sxh, long long sdb,
                           long long sds, long long sdh, long long sbb,
                           long long sbs, long long scb, long long scs,
                           void* stream) {
  if (P <= 0 || HD % P != 0) return (int)cudaErrorInvalidValue;
  Params p{x, dt, A, B, C, D, h0, y, hT, S, NH, HD, sxb, sxs, sxh,
           sdb, sds, sdh, sbb, sbs, scb, scs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dispatch_ns(p, Bsz, NS, P, s);
}
