// Grouped GEMM for the routed experts of an MoE layer (B4), sm_90a:
//   C[r, :] = A[r, :] @ B[e]   for offsets[e] <= r < offsets[e + 1]
// A (rows, K) holds the (token, k) assignments' inputs sorted by expert,
// B (E, K, N) one weight matrix per expert, offsets (E + 1,) int32 on the
// device.  Rows at or past offsets[E] are not written.
//
// Replaces no Pallas kernel: the JAX package dispatches its experts through
// one-hot einsums over a (groups, tokens, E, capacity) buffer, which XLA
// fuses on the TPU.  The port sorts the assignments by expert instead, and
// this kernel runs every expert's product in one launch whose shape does
// not depend on the routing: a CUDA graph captures it and nothing reads the
// offsets back on the host.
//
// Grid: (tiles, N / BN).  The tile count is a bound that needs no routing,
// ceil(rows / BM) + E (each expert's last tile may be partial), so one
// launch shape serves every call at a given row count.  Each block finds
// its expert and row tile from the device offsets (every thread sums the
// tile counts of the experts before its own, from shared memory), and a
// block past the live tiles exits at once.
//
// Bound on an H100 SXM: bytes at decode, FLOPs at prefill.  A decode step
// of a few lanes gives each expert it touches one or two rows, so the
// least time is the touched experts' weights read once (~4.1 MB each per
// matrix at d 2304, ff 896); a 4096-token prefill gives each of 64
// experts ~512 rows, 2 * rows * K * N FLOPs against the same weights.
// Design, right and simple first: bf16 goes to the tensor cores through
// mma.sync m16n8k16 (f32 accumulation), 64 x 128 tiles over 4 warps of
// 32 x 64, a 3-stage cp.async ring of 32-deep slices with padded rows so
// ldmatrix reads without bank conflicts; f32 runs on the CUDA cores (64 x
// 64 tiles, 4 x 4 per thread, exact fp32 FMA, no TF32).  Every output
// element is one thread's sum over K in a fixed order: a row's result does
// not depend on the other rows of its tile, so it is deterministic and
// equal whatever rows share the call (a padded bucket, idle decode lanes).
// No split of K, no persistent scheduling: later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;

struct Tile {
  int expert, r0, r1;   // expert, first row of the tile, end of its rows
};

// The tile `t` of the grouped rows: every thread sums the tiles of the
// experts before each of its own experts (E <= a few hundred).
__device__ __forceinline__ bool find_tile(const int* __restrict__ offsets, int n_exp, int t,
                                          int* s_tiles, Tile* s_tile) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (tid == 0) s_tile->expert = -1;
  for (int e = tid; e < n_exp; e += nt) {
    const int n = offsets[e + 1] - offsets[e];
    s_tiles[e] = (n + BM - 1) / BM;
  }
  __syncthreads();
  for (int e = tid; e < n_exp; e += nt) {
    int start = 0;
    for (int i = 0; i < e; ++i) start += s_tiles[i];
    if (t >= start && t < start + s_tiles[e]) {
      s_tile->expert = e;
      s_tile->r0 = offsets[e] + (t - start) * BM;
      s_tile->r1 = offsets[e + 1];
    }
  }
  __syncthreads();
  return s_tile->expert >= 0;
}

// ---- bf16: mma.sync on the tensor cores ------------------------------------
constexpr int BN = 128, BK = 32, STAGES = 3, NTHREADS = 128;
constexpr int A_LD = BK + 8;    // bf16 per shared row of A: 80 B, 16-byte aligned
constexpr int B_LD = BN + 8;    // 272 B
constexpr int MAX_EXPERTS = 512;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;   // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(NTHREADS)
moe_grouped_gemm_tc_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
                           __nv_bfloat16* __restrict__ C, const int* __restrict__ offsets,
                           int K, int N, int n_exp, long long lda, long long b_e, long long ldb,
                           long long ldc) {
  __shared__ __align__(16) __nv_bfloat16 As[STAGES][BM * A_LD];
  __shared__ __align__(16) __nv_bfloat16 Bs[STAGES][BK * B_LD];
  __shared__ int s_tiles[MAX_EXPERTS];
  __shared__ Tile s_tile;
  if (!find_tile(offsets, n_exp, blockIdx.x, s_tiles, &s_tile)) return;
  const int r0 = s_tile.r0, r1 = s_tile.r1;
  const __nv_bfloat16* Be = B + (long long)s_tile.expert * b_e;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;    // the warp's 32 x 64 piece

  auto load = [&](int slot, int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {      // A: 64 rows x 4 chunks of 8
      const int c = tid + i * NTHREADS, row = c >> 2, col = (c & 3) * 8;
      const bool ok = r0 + row < r1 && k0 + col < K;
      const __nv_bfloat16* g = ok ? A + (long long)(r0 + row) * lda + k0 + col : A;
      cp_async16(&As[slot][row * A_LD + col], g, ok);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {      // B: 32 rows x 16 chunks of 8
      const int c = tid + i * NTHREADS, row = c >> 4, col = (c & 15) * 8;
      const bool ok = k0 + row < K && n0 + col < N;
      const __nv_bfloat16* g = ok ? Be + (long long)(k0 + row) * ldb + n0 + col : Be;
      cp_async16(&Bs[slot][row * B_LD + col], g, ok);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

  const int KT = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();                  // slice kt landed; slice kt-1 is done with
    const int nk = kt + STAGES - 1;
    if (nk < KT) load(nk % STAGES, nk);
    cp_async_commit();
    const __nv_bfloat16* as = As[kt % STAGES];
    const __nv_bfloat16* bs = Bs[kt % STAGES];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4], b[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], as + (wm * 32 + mi * 16 + (lane & 15)) * A_LD + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bs + (kk + (lane & 15)) * B_LD + wn * 64 + nj * 16 + (lane >> 4) * 8);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + wm * 32 + mi * 16 + g + half * 8;
      if (row >= r1) continue;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = n0 + wn * 64 + ni * 8 + t4 * 2;
        if (col < N)
          *reinterpret_cast<__nv_bfloat162*>(C + (long long)row * ldc + col) =
              __floats2bfloat162_rn(acc[mi][ni][half * 2], acc[mi][ni][half * 2 + 1]);
      }
    }
  }
}

// ---- f32: CUDA cores, exact fp32 ---------------------------------------------
constexpr int FBN = 64, FBK = 16, FTHREADS = 256;

__global__ void __launch_bounds__(FTHREADS)
moe_grouped_gemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                        float* __restrict__ C, const int* __restrict__ offsets, int K, int N,
                        int n_exp, long long lda, long long b_e, long long ldb, long long ldc) {
  __shared__ float As[FBK][BM + 4];    // k-major: a thread's 4 rows are one read
  __shared__ float Bs[FBK][FBN];
  __shared__ int s_tiles[MAX_EXPERTS];
  __shared__ Tile s_tile;
  if (!find_tile(offsets, n_exp, blockIdx.x, s_tiles, &s_tile)) return;
  const int r0 = s_tile.r0, r1 = s_tile.r1;
  const float* Be = B + (long long)s_tile.expert * b_e;
  const int n0 = blockIdx.y * FBN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * FTHREADS;
      const int ar = c >> 4, ak = c & 15;
      As[ak][ar] = (r0 + ar < r1 && k0 + ak < K) ? A[(long long)(r0 + ar) * lda + k0 + ak] : 0.f;
      const int bk = c >> 6, bn = c & 63;
      Bs[bk][bn] = (k0 + bk < K && n0 + bn < N) ? Be[(long long)(k0 + bk) * ldb + n0 + bn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row >= r1) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < N) C[(long long)row * ldc + col] = acc[i][j];
    }
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  tiles: the grid's row tiles, at least
// ceil(rows / 64) + n_exp.  Returns the launch's cudaError_t.
extern "C" int moe_grouped_gemm(const void* A, const void* B, void* C, const int* offsets,
                                int K, int N, int n_exp, long long lda, long long b_e,
                                long long ldb, long long ldc, int tiles, int dtype,
                                void* stream) {
  if (tiles < 1 || n_exp < 1 || n_exp > MAX_EXPERTS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    dim3 grid(tiles, (N + BN - 1) / BN);
    moe_grouped_gemm_tc_kernel<<<grid, NTHREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(A), static_cast<const __nv_bfloat16*>(B),
        static_cast<__nv_bfloat16*>(C), offsets, K, N, n_exp, lda, b_e, ldb, ldc);
  } else {
    dim3 grid(tiles, (N + FBN - 1) / FBN);
    moe_grouped_gemm_kernel<<<grid, FTHREADS, 0, s>>>(
        static_cast<const float*>(A), static_cast<const float*>(B), static_cast<float*>(C),
        offsets, K, N, n_exp, lda, b_e, ldb, ldc);
  }
  return (int)cudaGetLastError();
}
