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
// Two kernels, chosen in fa_forward by dtype and head dim, never on
// failure:
//
// tc::fa_tc_kernel — bf16 at D 64, 80 and 128 (every main path).  The
// products run on the tensor cores with wgmma, bf16 in and f32 accumulators.
// One block per (head, 128-row q-tile, batch): two consumer warpgroups of
// 64 query rows each and one producer warpgroup, which hands its registers
// to the consumers (setmaxnreg: 240 each, so S, P and O stay in registers).
// - Loads: the producer loads Q once and streams K/V tiles of 128 keys by
//   TMA into a ring of 3 stages (full/empty mbarriers).  The tensor maps
//   describe the strided (B, heads, S, D) views the callers pass (q is a
//   transpose of (B, S, H, D)) and are __grid_constant__ parameters; TMA's
//   zero fill covers the ragged Sq and Sk edges.
// - Products: S = Q K^T takes Q and K from shared memory (both K-major);
//   O += P V takes P from registers, packed to bf16 in the accumulator's
//   own layout (never through shared memory), and V from shared memory as
//   an MN-major operand (the transpose bit).
// - Overlap: a warpgroup issues S of tile i together with P V of tile
//   i - 1 and starts the softmax of tile i while P V still runs; the two
//   warpgroups take turns to issue (named barriers), so one's softmax
//   overlaps the other's products.
// - Softmax in registers, in base 2 with the scale folded into one FMA; a
//   row's max and sum go across the 4 lanes that hold it, through 4
//   partials each.  Masks are a separate branch-free pass, run only on
//   tiles that cross the kv_len, causal or window limit; those limits bound
//   the tile loop itself.  (Masking element by element inside the softmax
//   cost ~35 % of the kernel's time on an H100 at 4096 causal tokens: its
//   branches broke the softmax's schedule.)
// - q-tiles launch longest first, so the causal triangle's long tiles do
//   not form the last wave's tail.  The n_rep query heads of a KV group
//   re-read the same K/V, which L2 holds (6.3 MB in all at 1536 tokens).
// - Head dims: a swizzle atom holds rows of at most 128 bytes, so a row is
//   staged in column chunks: D 128 is two chunks of 64 and D 64 one
//   (128-byte swizzle); D 80 (160-byte rows) is one chunk of 64 plus a
//   16-column tail in a 32-byte swizzle with its own tensor maps, so Q K^T
//   takes 5 k-steps and P V an N = 64 plus an N = 16 product and nothing
//   is padded: the price is three more tensor maps per call and one more
//   wgmma per k-step of P V.
// - No atomics and a fixed order: the result is bitwise deterministic.
//
// simt::fa_kernel — float32 (any supported D) and bf16 at D 32: the first,
// simple kernel, f32 FMAs on CUDA cores over 64 x 64 tiles in shared
// memory.  f32 stays off the tensor cores on purpose: there they would run
// as TF32 (~3 decimal digits), and the f32 path exists to hold the
// algorithm to the plain version at 2e-5, not for speed.
//
// Both follow the reference's `ops.xla_attention` on masking: a true -inf,
// so a row with no visible key yields 0 and LSE -inf (what a ring merge
// needs).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace simt {

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
  static bool smem_set = false;   // once per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        fa_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
  fa_kernel<T, D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

// float32 at every head dim; bf16 only at D 32 (D 64/80/128 go to tc)
cudaError_t dispatch(const Params& p, int B, int D, int dtype, cudaStream_t stream) {
  if (dtype == 1) return D == 32 ? launch<__nv_bfloat16, 32>(p, B, stream) : cudaErrorInvalidValue;
  if (dtype != 0) return cudaErrorInvalidValue;
  switch (D) {
    case 32: return launch<float, 32>(p, B, stream);
    case 64: return launch<float, 64>(p, B, stream);
    case 80: return launch<float, 80>(p, B, stream);
    case 128: return launch<float, 128>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16 at D 64, 80 and 128: tensor cores (wgmma) fed by TMA.
namespace tc {

constexpr int BQ = 128;               // query rows per block
constexpr int BK = 128;               // key rows per K/V tile
constexpr int STAGES = 3;             // K/V tiles in the shared-memory ring
constexpr int NCW = 2;                // consumer warpgroups, 64 query rows each
constexpr int NT = (NCW + 1) * 128;   // + one producer warpgroup
// registers per thread after setmaxnreg: the producer gives up what the
// consumers' accumulators need (per SM sub-partition, one warp of each
// warpgroup: 2 x 240 + 24 <= 512 registers x 32 lanes)
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
// The two consumer warpgroups take turns to issue their products (named
// barriers 1 and 2), so one's softmax runs while the other's products hold
// the tensor cores.
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  CUtensorMap tq, tk, tv;     // (D, S, heads, B) bf16 views, 64-column boxes
  CUtensorMap tq2, tk2, tv2;  // D 80 only: the 16-column tail (32-byte swizzle)
  void* o;
  float* lse;
  const int* kv_len;
  int H, KV, Sq, Sk;
  int causal, window, q_offset;
  float scale_log2;        // scale * log2(e): softmax in base 2
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint8_t* dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile (1024-byte atoms
// of 8 rows x 128 bytes); offsets in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// the same for a 32-byte-swizzled tile (256-byte atoms of 8 rows x 32 bytes):
// one 16-element column chunk, read as one k-step (K-major) or as N = 16
// (MN-major); sbo = 256 steps to the next 8 rows
__device__ __forceinline__ uint64_t sw32_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(256 >> 4) << 32) |
         (3ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// keep the compiler from moving register reads/writes across the async wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (64 x 64) += A (64 x 16, shared) . B (64 x 16, shared)^T, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_qk(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void wgmma_qk<64>(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  wgmma_ss_n64(d, da, db, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_qk<128>(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  wgmma_ss_n128(d, da, db, scale_d);
}

__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_n64(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A row of D is staged as D / 64 chunks of 64 columns (128-byte rows,
// 128-byte swizzle) and, at D 80, a tail chunk of 16 columns (32-byte rows,
// 32-byte swizzle).  In a tile of R rows, chunk c starts at c * R * 128
// bytes and the tail at (D / 64) * R * 128.
template <int D>
struct Cols {
  static constexpr int NCH = D / 64;                 // full 64-column chunks
  static constexpr int TAIL = D % 64;                // 0, or 16 at D 80
  static constexpr int ROW_BYTES = NCH * 128 + TAIL * 2;
  static constexpr int OT = TAIL ? TAIL / 2 : 1;     // tail accumulator registers
  static_assert(TAIL == 0 || TAIL == 16, "head dim must be 64 k or 64 k + 16");
};

// S (64 x BK) = Q (64 x D) . K^T: q_tile and k_tile are the tiles' bases,
// wg picks this warpgroup's 64 query rows
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], uint32_t q_tile, int wg,
                                         uint32_t k_tile) {
  using C = Cols<D>;
#pragma unroll
  for (int ks = 0; ks < C::NCH * 4; ++ks) {
    const uint32_t off = (ks & 3) * 32;   // 16 elements along a 128-byte row
    wgmma_qk<BK>(sc, sw128_desc(q_tile + (ks >> 2) * BQ * 128 + wg * 64 * 128 + off, 16, 1024),
                 sw128_desc(k_tile + (ks >> 2) * BK * 128 + off, 16, 1024), ks > 0);
  }
  if constexpr (C::TAIL > 0)
    wgmma_qk<BK>(sc, sw32_desc(q_tile + C::NCH * BQ * 128 + wg * 64 * 32),
                 sw32_desc(k_tile + C::NCH * BK * 128), 1);
}

// O (64 x D) += P (64 x BK, registers) . V (BK x D, shared, MN-major): the
// 64-column chunks into o, the tail into ot
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[Cols<D>::NCH * 32], float (&ot)[Cols<D>::OT],
                                         const uint32_t (&pa)[BK / 16][4], uint32_t v_tile) {
  using C = Cols<D>;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    wgmma_pv<C::NCH * 64>(o, pa[kk], sw128_desc(v_tile + kk * 16 * 128, BK * 128, 1024));
    if constexpr (C::TAIL > 0)
      wgmma_rs_n16(ot, pa[kk], sw32_desc(v_tile + C::NCH * BK * 128 + kk * 16 * 32));
  }
}

// -inf where a key is not visible to a row: causal at the row's position,
// the window below it and kv_len above.  Called only on tiles that cross
// one of those limits; branch-free, against each row's [lo, hi) key range.
__device__ __forceinline__ void mask_tile(float (&sc)[BK / 2], int qpos0, int lane, int k0,
                                          int kv_len, int causal, int window) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qpos0 + 8 * r;
    const int base = k0 + 2 * (lane & 3);   // this lane's first key in the tile
    const int hi = (causal ? min(kv_len, qpos + 1) : kv_len) - base;
    const int lo = (window > 0 ? qpos - window + 1 : k0 - BK) - base;
#pragma unroll
    for (int kb = 0; kb < BK / 8; ++kb)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = kb * 8 + j;
        float& x = sc[kb * 4 + r * 2 + j];
        x = ((c >= lo) & (c < hi)) ? x : -INFINITY;
      }
  }
}

// Online softmax of one S tile in place (S -> unnormalised P), in base 2
// with the scale folded in.  m, l: each row's running max (scaled) and this
// lane's part of its sum; corr: the factor the row's O must be scaled by.
// Max and sum go through 4 partials each, so the chains stay short.
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float scale_log2) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx4[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int kb = 0; kb < BK / 8; ++kb)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        mx4[(kb * 2 + j) & 3] = fmaxf(mx4[(kb * 2 + j) & 3], sc[kb * 4 + r * 2 + j]);
    float mx = fmaxf(fmaxf(mx4[0], mx4[1]), fmaxf(mx4[2], mx4[3]));
    // the 4 lanes of a quad hold one row
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx * scale_log2);
    const float m_safe = (m_new == -INFINITY) ? 0.f : m_new;
    corr[r] = (m[r] == -INFINITY) ? 0.f : ex2(m[r] - m_safe);
    float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kb = 0; kb < BK / 8; ++kb) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // exp2(-inf) = 0 where masked
        const float pr = ex2(fmaf(sc[kb * 4 + r * 2 + j], scale_log2, -m_safe));
        sc[kb * 4 + r * 2 + j] = pr;
        s4[(kb * 2 + j) & 3] += pr;
      }
    }
    l[r] = l[r] * corr[r] + ((s4[0] + s4[1]) + (s4[2] + s4[3]));
    m[r] = m_new;
  }
}

// P in bf16, straight from the accumulator layout into wgmma's A fragment
// layout (16 keys per k-step): no trip through shared memory
__device__ __forceinline__ void pack_p(const float (&sc)[BK / 2], uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) pa[kk][j] = pack_bf16(sc[kk * 8 + 2 * j], sc[kk * 8 + 2 * j + 1]);
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&corr)[2]) {
#pragma unroll
  for (int kb = 0; kb < N / 4; ++kb) {
    o[kb * 4] *= corr[0];
    o[kb * 4 + 1] *= corr[0];
    o[kb * 4 + 2] *= corr[1];
    o[kb * 4 + 3] *= corr[1];
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 1) fa_tc_kernel(const __grid_constant__ Params p) {
  using C = Cols<D>;
  constexpr int Q_BYTES = BQ * C::ROW_BYTES;
  constexpr int KV_BYTES = BK * C::ROW_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = sQ + Q_BYTES;                 // STAGES tiles
  uint8_t* sV = sK + STAGES * KV_BYTES;       // STAGES tiles
  const uint32_t full0 = smem_u32(sV + STAGES * KV_BYTES);   // full[STAGES]
  const uint32_t empty0 = full0 + 8 * STAGES;                // empty[STAGES]
  const uint32_t qbar = empty0 + 8 * STAGES;

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest causal tiles first
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  int kv_len = p.Sk;
  if (p.kv_len != nullptr) kv_len = min(max(p.kv_len[b], 0), p.Sk);
  // key range this q-tile can see: [k_lo, k_hi), walked in tiles of BK
  const int qpos_lo = q0 + p.q_offset;
  const int qpos_hi = min(q0 + BQ, p.Sq) - 1 + p.q_offset;
  int k_hi = kv_len;
  if (p.causal) k_hi = min(k_hi, qpos_hi + 1);
  int k_lo = 0;
  if (p.window > 0) k_lo = max(0, qpos_lo - p.window + 1);
  const int t_first = k_lo / BK;
  const int n_tiles = k_hi > k_lo ? (k_hi + BK - 1) / BK - t_first : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NCW * 4);   // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NCW * 4) {
    // producer: Q once, then K/V tiles into the ring as slots free up
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == NCW * 4 && lane == 0 && n_tiles > 0) {
      mbar_expect_tx(qbar, Q_BYTES);
      for (int c = 0; c < C::NCH; ++c) tma_load(sQ + c * BQ * 128, &p.tq, qbar, c * 64, q0, h, b);
      if (C::TAIL > 0) tma_load(sQ + C::NCH * BQ * 128, &p.tq2, qbar, C::NCH * 64, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        mbar_wait(empty0 + 8 * s, ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, 2 * KV_BYTES);
        const int k0 = (t_first + i) * BK;
        for (int c = 0; c < C::NCH; ++c) {
          tma_load(sK + s * KV_BYTES + c * BK * 128, &p.tk, full0 + 8 * s, c * 64, k0, kvh, b);
          tma_load(sV + s * KV_BYTES + c * BK * 128, &p.tv, full0 + 8 * s, c * 64, k0, kvh, b);
        }
        if (C::TAIL > 0) {
          const int c = C::NCH;
          tma_load(sK + s * KV_BYTES + c * BK * 128, &p.tk2, full0 + 8 * s, c * 64, k0, kvh, b);
          tma_load(sV + s * KV_BYTES + c * BK * 128, &p.tv2, full0 + 8 * s, c * 64, k0, kvh, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows [q0 + 64 wg, q0 + 64 wg + 64); in
  // the accumulator layout a thread holds rows r0 and r0 + 8, and in each
  // 8-column block the columns 2 (lane % 4) and 2 (lane % 4) + 1.  Within a
  // warpgroup, S = Q K^T of tile i and O += P V of tile i - 1 are issued
  // together; the softmax of tile i starts as soon as its S is ready and
  // runs while P V of tile i - 1 is still on the tensor cores.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = warp >> 2;
  const int r0 = q0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int wpos_lo = q0 + wg * 64 + p.q_offset;   // this warpgroup's query positions
  const int wpos_hi = wpos_lo + 63;
  const uint32_t q_tile = smem_u32(sQ);
  const int causal = p.causal, window = p.window;
  const float scale_log2 = p.scale_log2;
  // turns: warpgroup wg issues after the other's last issue (wg 0 first);
  // wg 1 skips its last hand-over, which no one would wait for
  auto turn_begin = [&]() { named_sync(1 + wg); };
  auto turn_end = [&](bool last) {
    if (!(last && wg == 1)) named_arrive(1 + (wg ^ 1));
  };
  auto edge = [&](int k0) {
    return k0 + BK > kv_len || (causal && k0 + BK - 1 > wpos_lo) ||
           (window > 0 && k0 <= wpos_hi - window);
  };

  float o[C::NCH * 32], ot[C::OT];
#pragma unroll
  for (int i = 0; i < C::NCH * 32; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < C::OT; ++i) ot[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  if (n_tiles > 0) {
    float sc[BK / 2], corr[2];
    uint32_t pa[BK / 16][4];
    int k0 = t_first * BK;
    if (wg == 1) named_arrive(1);
    mbar_wait(qbar, 0);
    mbar_wait(full0, 0);
    __syncwarp();
    turn_begin();
    wg_fence();
    issue_qk<D>(sc, q_tile, wg, smem_u32(sK));
    wg_commit();
    turn_end(false);
    wg_wait<0>();
    fence_regs(sc);
    if (edge(k0)) mask_tile(sc, r0 + p.q_offset, lane, k0, kv_len, causal, window);
    softmax_tile(sc, m, l, corr, scale_log2);
    pack_p(sc, pa);
    for (int i = 1; i < n_tiles; ++i) {
      const int s = i % STAGES;
      const int sp = (i - 1) % STAGES;
      k0 += BK;
      mbar_wait(full0 + 8 * s, (i / STAGES) & 1);
      __syncwarp();
      fence_regs(pa);
      fence_regs(o);
      fence_regs(ot);
      turn_begin();
      wg_fence();
      issue_qk<D>(sc, q_tile, wg, smem_u32(sK + s * KV_BYTES));   // S of tile i ...
      wg_commit();
      issue_pv<D>(o, ot, pa, smem_u32(sV + sp * KV_BYTES));       // ... beside P V of tile i - 1
      wg_commit();
      turn_end(false);
      wg_wait<1>();
      fence_regs(sc);
      if (edge(k0)) mask_tile(sc, r0 + p.q_offset, lane, k0, kv_len, causal, window);
      softmax_tile(sc, m, l, corr, scale_log2);
      wg_wait<0>();
      fence_regs(o);
      fence_regs(ot);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * sp);   // this warp is done with slot sp
      rescale(o, corr);
      rescale(ot, corr);
      pack_p(sc, pa);
    }
    const int sl = (n_tiles - 1) % STAGES;
    fence_regs(pa);
    fence_regs(o);
    fence_regs(ot);
    turn_begin();
    wg_fence();
    issue_pv<D>(o, ot, pa, smem_u32(sV + sl * KV_BYTES));
    wg_commit();
    turn_end(true);
    wg_wait<0>();
    fence_regs(o);
    fence_regs(ot);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * sl);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + ((long long)b * p.H + h) * p.Sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= p.Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int kb = 0; kb < C::NCH * 8; ++kb) {
      const int col = kb * 8 + 2 * (lane & 3);
      *reinterpret_cast<__nv_bfloat162*>(og + (long long)row * D + col) =
          __floats2bfloat162_rn(o[kb * 4 + r * 2] * inv, o[kb * 4 + r * 2 + 1] * inv);
    }
#pragma unroll
    for (int kb = 0; kb < C::TAIL / 8; ++kb) {
      const int col = C::NCH * 64 + kb * 8 + 2 * (lane & 3);
      *reinterpret_cast<__nv_bfloat162*>(og + (long long)row * D + col) =
          __floats2bfloat162_rn(ot[kb * 4 + r * 2] * inv, ot[kb * 4 + r * 2 + 1] * inv);
    }
    if (p.lse != nullptr && (lane & 3) == 0)
      p.lse[((long long)b * p.H + h) * p.Sq + row] =
          l[r] > 0.f ? (m[r] + log2f(l[r])) * LN2 : -INFINITY;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a CUDA driver API function: take it from the
// libcuda the process has already loaded, so the build links nothing extra
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// a (B, heads, S, D) bf16 view with element strides (sb, sh, ss), last dim
// contiguous, as a 4-d map (D, S, heads, B) read in boxes of cols x rows
// (128-byte swizzle for 64 columns, 32-byte for 16); out-of-range rows
// (ragged S) arrive as zeros
bool make_map(CUtensorMap* map, const void* ptr, int D, int S, int heads, int B,
              long long sb, long long sh, long long ss, int rows, int cols) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(Params& p, int B, cudaStream_t stream) {
  const size_t smem =
      1024 + (BQ + 2 * STAGES * BK) * Cols<D>::ROW_BYTES + 8 * (2 * STAGES + 1);
  static bool smem_set = false;   // once per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        fa_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const dim3 grid(p.H, (p.Sq + BQ - 1) / BQ, B);
  fa_tc_kernel<D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  The kernel follows from dtype and head
// dim: bf16 at D 64, 80 and 128 runs tc::fa_tc_kernel, float32 (D 32, 64,
// 80, 128) and bf16 at D 32 simt::fa_kernel.  Strides are in elements; the
// last dimension of q, k and v is contiguous.  o is a contiguous (B, H, Sq,
// D) tensor of q's dtype.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unsupported dtype or head dim, or a tensor
// map cuTensorMapEncodeTiled refuses).
extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o,
                          float* lse, const int* kv_len, int B, int H, int KV,
                          int Sq, int Sk, int D, long long sqb, long long sqh,
                          long long sqs, long long skb, long long skh, long long sks,
                          long long svb, long long svh, long long svs, int causal,
                          int window, int q_offset, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 1 || (D != 64 && D != 80 && D != 128)) {
    simt::Params p{q, k, v, o, lse, kv_len, H, KV, Sq, Sk, sqb, sqh, sqs, skb, skh, sks,
                   svb, svh, svs, causal, window, q_offset, scale};
    return (int)simt::dispatch(p, B, D, dtype, s);
  }
  tc::Params p;
  if (!tc::make_map(&p.tq, q, D, Sq, H, B, sqb, sqh, sqs, tc::BQ, 64) ||
      !tc::make_map(&p.tk, k, D, Sk, KV, B, skb, skh, sks, tc::BK, 64) ||
      !tc::make_map(&p.tv, v, D, Sk, KV, B, svb, svh, svs, tc::BK, 64))
    return (int)cudaErrorInvalidValue;
  if (D % 64 != 0 &&
      (!tc::make_map(&p.tq2, q, D, Sq, H, B, sqb, sqh, sqs, tc::BQ, 16) ||
       !tc::make_map(&p.tk2, k, D, Sk, KV, B, skb, skh, sks, tc::BK, 16) ||
       !tc::make_map(&p.tv2, v, D, Sk, KV, B, svb, svh, svs, tc::BK, 16)))
    return (int)cudaErrorInvalidValue;
  p.o = o;
  p.lse = lse;
  p.kv_len = kv_len;
  p.H = H;
  p.KV = KV;
  p.Sq = Sq;
  p.Sk = Sk;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.scale_log2 = scale * 1.4426950408889634f;
  switch (D) {
    case 64: return (int)tc::launch<64>(p, B, s);
    case 80: return (int)tc::launch<80>(p, B, s);
    default: return (int)tc::launch<128>(p, B, s);
  }
}
