// Matrix product C = A B, the paper pool's `matmul`, written for Hopper
// (sm_90a).
//
// Replaces matmul_pallas (src/repro/kernels/matmul.py:40, kernel body
// _matmul_kernel at lines 25-35): A (M, K) times B (K, N) with an fp32
// accumulator across K, cast to the output type.  A and B are both fp32 or
// both bf16 (row-major, contiguous); C is fp32 or bf16.  Any M, N, K: the
// kernel masks its own ragged edge (zeros past K, no store past M or N),
// where the Pallas kernel asserts that the shapes divide its 128^3 tiles.
//
// What bounds it on the H100: operations.  A 4096^3 product is 137 GFLOP:
// 2.05 ms at the fp32 CUDA-core peak (67 TFLOP/s; no TF32, the reference's
// CPU path is full fp32), 0.139 ms at the bf16 tensor-core peak (989
// TFLOP/s), against 0.03-0.06 ms to move its 100-201 MB once.  Three
// routes (matmul.route picks by dtype and shape):
//   * sgemm, fp32: CUDA-core FMAs, a 128 x 128 output tile per 256-thread
//     block, K steps of 8 staged in shared memory (A transposed), each
//     thread holding an 8 x 8 register tile (two 4-row and two 4-column
//     halves 64 apart, so the float4 reads of shared memory are
//     conflict-free): 64 FMAs per 4 shared-memory vector loads.  It runs
//     at 1.8x its bound, held by the FMA issue rate around the loads;
//   * wgmma, bf16 where a TMA tensor map can describe both operands (K % 8
//     == 0, N % 8 == 0, 16-byte aligned bases): only wgmma reaches the
//     tensor cores' full rate.  A persistent block per SM walks 128 x 256
//     output tiles; its three warpgroups: one producer thread issues TMA
//     loads (128-byte swizzle, out-of-bounds rows and columns read as
//     zero) into a ring of four 48 KB stages with full / empty mbarriers,
//     the ring running on across tiles; two consumer warpgroups
//     (setmaxnreg 232, the producer 40) each run wgmma.mma_async
//     m64n256k16 on 64 rows, A K-major and B MN-major (the transpose bit
//     set for B, so the row-major (K, N) operand needs no transpose pass),
//     one stage's group left in flight while the next is issued, and
//     store their fp32 accumulators straight from registers, masked at the
//     M and N edges.  At 4096^3 it runs at about 1.5x its bound and 1.2x
//     cuBLAS: both consumers store a tile while the tensor cores wait, and
//     no two blocks share a tile's loads.  Few output tiles leave SMs
//     idle: 1024 x 8192 x 512 has 16 tiles for 132 SMs;
//   * wmma, the other bf16 shapes (rows of 2-byte elements that are not a
//     multiple of 16 bytes): nvcuda::wmma m16n16k16 with fp32 accumulators,
//     a 128 x 128 tile per block of 8 warps (each 32 x 64), K steps of 32
//     in shared memory (rows padded by 8 elements), and a per-warp 16 x 16
//     fp32 staging tile for the masked store.  Synchronous loads with no
//     pipelining hold it (PERF.md section 6).
// Not done yet (see PERF.md): consumers that take turns (one stores while
// the other multiplies) and clusters with TMA multicast for the wgmma
// route; split-K for short-and-wide shapes; cp.async staging for the wmma
// route; tensor cores for fp32.
//
// Summation order: each output sums its K products in order (fp32 FMAs;
// wmma's and wgmma's own order inside each k16 step), not cuBLAS's or
// XLA's, so the tests hold it to a tolerance that grows with K.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>

namespace {

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ---------------------------------------------------------------------------
// fp32 on CUDA cores.
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 8;
constexpr int kThreads = 256;      // 16 x 16 threads, 8 x 8 outputs each
constexpr int kPad = 4;            // keeps shared rows 16-byte aligned

// Row (or column) of the tile held by register i of thread t: two groups of
// four, 64 apart.
__device__ __forceinline__ int micro(int t, int i) {
  return (i < 4 ? 0 : 64) + t * 4 + (i & 3);
}

template <typename TO>
__global__ void __launch_bounds__(kThreads)
sgemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
             TO* __restrict__ c, int m, int n, int k, bool vec_a, bool vec_b) {
  __shared__ __align__(16) float as[kBK][kBM + kPad];   // as[kk][row]
  __shared__ __align__(16) float bs[kBK][kBN + kPad];   // bs[kk][col]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  // loaders: A row tid / 2, k columns (tid % 2) * 4 .. +3; B k row tid / 32,
  // columns (tid % 32) * 4 .. +3
  const int ar = tid >> 1, ac = (tid & 1) * 4;
  const int br = tid >> 5, bc = (tid & 31) * 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    {
      const int gm = m0 + ar, gk = k0 + ac;
      float v[4];
      if (vec_a && gm < m && gk + 3 < k) {
        const float4 t = *reinterpret_cast<const float4*>(
            a + static_cast<size_t>(gm) * k + gk);
        v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = (gm < m && gk + j < k) ? a[static_cast<size_t>(gm) * k + gk + j]
                                        : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) as[ac + j][ar] = v[j];
    }
    {
      const int gk = k0 + br, gn = n0 + bc;
      if (vec_b && gk < k && gn + 3 < n) {
        *reinterpret_cast<float4*>(&bs[br][bc]) = *reinterpret_cast<const float4*>(
            b + static_cast<size_t>(gk) * n + gn);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bs[br][bc + j] = (gk < k && gn + j < n)
                               ? b[static_cast<size_t>(gk) * n + gn + j] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float ra[8], rb[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][64 + tx * 4]);
      ra[0] = a0.x; ra[1] = a0.y; ra[2] = a0.z; ra[3] = a0.w;
      ra[4] = a1.x; ra[5] = a1.y; ra[6] = a1.z; ra[7] = a1.w;
      rb[0] = b0.x; rb[1] = b0.y; rb[2] = b0.z; rb[3] = b0.w;
      rb[4] = b1.x; rb[5] = b1.y; rb[6] = b1.z; rb[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + micro(ty, i);
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + micro(tx, j);
      if (gn < n) c[static_cast<size_t>(gm) * n + gn] = from_f32<TO>(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on tensor cores (wmma, fp32 accumulators).
// ---------------------------------------------------------------------------

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int kHBK = 32;
constexpr int kALd = kHBK + 8;     // A tile rows: 40 bf16 (80 bytes)
constexpr int kBLd = kBN + 8;      // B tile rows: 136 bf16 (272 bytes)
constexpr int kWarps = kThreads / 32;   // 4 along M x 2 along N, 32 x 64 each

template <typename TO>
__global__ void __launch_bounds__(kThreads)
hgemm_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
             TO* __restrict__ c, int m, int n, int k, bool vec_a, bool vec_b) {
  __shared__ __align__(32) bf16 as[kBM * kALd];
  __shared__ __align__(32) bf16 bs[kHBK * kBLd];
  __shared__ __align__(32) float stage[kWarps][16 * 16];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const bf16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < k; k0 += kHBK) {
    // A: 128 rows x 32 columns = 512 chunks of 8 elements, 2 a thread
    for (int ch = tid; ch < kBM * kHBK / 8; ch += kThreads) {
      const int r = ch / (kHBK / 8), col = (ch % (kHBK / 8)) * 8;
      const int gm = m0 + r, gk = k0 + col;
      bf16* dst = &as[r * kALd + col];
      if (vec_a && gm < m && gk + 7 < k) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(
            a + static_cast<size_t>(gm) * k + gk);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dst[j] = (gm < m && gk + j < k) ? a[static_cast<size_t>(gm) * k + gk + j]
                                          : zero;
      }
    }
    // B: 32 rows x 128 columns = 512 chunks of 8 elements, 2 a thread
    for (int ch = tid; ch < kHBK * kBN / 8; ch += kThreads) {
      const int r = ch / (kBN / 8), col = (ch % (kBN / 8)) * 8;
      const int gk = k0 + r, gn = n0 + col;
      bf16* dst = &bs[r * kBLd + col];
      if (vec_b && gk < k && gn + 7 < n) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(
            b + static_cast<size_t>(gk) * n + gn);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dst[j] = (gk < k && gn + j < n) ? b[static_cast<size_t>(gk) * n + gn + j]
                                          : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kHBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &as[(wm * 32 + i * 16) * kALd + kk], kALd);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], &bs[kk * kBLd + wn * 64 + j * 16], kBLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* st = stage[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r0 = m0 + wm * 32 + i * 16, c0 = n0 + wn * 64 + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int gm = r0 + e / 16, gn = c0 + e % 16;
        if (gm < m && gn < n)
          c[static_cast<size_t>(gm) * n + gn] = from_f32<TO>(st[e]);
      }
      __syncwarp();
    }
}

// ---------------------------------------------------------------------------
// bf16 on tensor cores, the wgmma route: TMA loads into a ring of shared
// stages, wgmma.mma_async m64n256k16 from shared memory.
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kBM = 128, kBN = 256, kBK = 64, kStages = 4;
constexpr int kConsumers = 2;                  // warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);   // + the producer
constexpr int kBoxCols = 64;                   // 128 bytes: the swizzle span
constexpr int kABytes = kBM * kBK * 2;         // 16 KB
constexpr int kBBoxBytes = kBK * kBoxCols * 2; // 8 KB, one 64-column box
constexpr int kStageBytes = kABytes + kBN / kBoxCols * kBBoxBytes;   // 48 KB
constexpr size_t kRing = static_cast<size_t>(kStages) * kStageBytes;
// The planted variant (TRANS_B = 0) reads B as K-major: from a k16 step's
// offset (up to 6 KB into the stage's B) its 256 rows span 32 KB, past the
// ring's end for the last stage; it gets 8 KB of zeros there.
constexpr size_t kPlantSlack = 8192;

template <int TRANS_B> constexpr size_t smem_bytes() {
  return kRing + 1024 + (TRANS_B ? 0 : kPlantSlack);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// spin until the barrier's phase of the given parity has completed; a
// wait of more than ~10 s (2^34 cycles) traps, so a broken protocol ends
// the launch with an error instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  }
}

// one 2-D box of a tensor map into shared memory, completion on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// A shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc128(const void* p, uint32_t lbo,
                                            uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         1ull << 62;
}

// d (64 x 256 fp32, this warpgroup's) += A (64 x 16, K-major) B (16 x 256);
// TRANS_B = 1: B is MN-major (row-major (K, N), the pool's layout)
template <int TRANS_B>
__device__ __forceinline__ void wgmma256(float (&d)[128], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, 1, 1, 1, 0, %130;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "n"(TRANS_B));
}

__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Persistent: a grid of min(tiles, SMs) blocks, block i taking output tiles
// i, i + grid, ... of the row-major (M tiles of 128, N tiles of 256) order.
// Warpgroup 0 is the producer (one thread issues the TMA loads),
// warpgroups 1 and 2 each own 64 rows of a 128 x 256 tile.  The ring's
// stage and phase run on from one tile to the next, so the producer loads
// the next tile's first stages while the consumers store this one.  ta: A
// (M, K) in boxes of 64 x 128; tb: B (K, N) in boxes of 64 columns x 64
// rows.  N % 8 == 0 (the route's condition), so a pair of columns is
// either wholly inside N or wholly past it.
template <typename TO, int TRANS_B>
__global__ void __launch_bounds__(kThreads, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap ta,
             const __grid_constant__ CUtensorMap tb, TO* __restrict__ c,
             int m, int n, int k) {
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: stages start on that boundary
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int n_k = (k + kBK - 1) / kBK;
  const int tiles_n = (n + kBN - 1) / kBN;
  const int tiles = (m + kBM - 1) / kBM * tiles_n;
  const int wgi = threadIdx.x / 128;
  if (!TRANS_B)
    for (int i = threadIdx.x; i < static_cast<int>(kPlantSlack / 16); i += kThreads)
      reinterpret_cast<uint4*>(ring + kRing)[i] = make_uint4(0, 0, 0, 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {
    // producer: one thread keeps up to kStages k steps in flight; `it`
    // counts k steps over all of this block's tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / tiles_n * kBM, n0 = t % tiles_n * kBN;
        // boxes of B that hold a column < n (the rest are never stored)
        const int boxes = min(kBN / kBoxCols, (n - n0 + kBoxCols - 1) / kBoxCols);
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
          unsigned char* st = ring + s * kStageBytes;
          mbar_expect_tx(&full[s], kABytes + boxes * kBBoxBytes);
          tma_load(st, &ta, &full[s], kt * kBK, m0);
          for (int j = 0; j < boxes; ++j)
            tma_load(st + kABytes + j * kBBoxBytes, &tb, &full[s],
                     n0 + j * kBoxCols, kt * kBK);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int row_off = (wgi - 1) * 64 * kBK * 2;   // this warpgroup's rows of A
    const int lane = threadIdx.x % 32, w = (threadIdx.x % 128) / 32;
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / tiles_n * kBM, n0 = t % tiles_n * kBN;
      float d[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) d[i] = 0.f;
      for (int kt = 0; kt < n_k; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(&full[s], (it / kStages) & 1);
        const unsigned char* a_s = ring + s * kStageBytes + row_off;
        const unsigned char* b_s = ring + s * kStageBytes + kABytes;
        fence_acc(d);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks) {
          // A, K-major: rows of 128 bytes, 8-row groups 1024 apart; a k16
          // step is 32 bytes along the row.  B, MN-major: rows (k) of 128
          // bytes, 8-row groups 1024 apart, 64-column boxes kBBoxBytes
          // apart; a k16 step is 16 rows.
          wgmma256<TRANS_B>(d, desc128(a_s + ks * 32, 16, 1024),
                            desc128(b_s + ks * 16 * 128, kBBoxBytes, 1024));
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // keep this stage's products in flight; the previous stage's are
        // done once at most one group is pending, and its buffer goes back
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_acc(d);
        if (kt > 0 && threadIdx.x % 128 == 0)
          mbar_arrive(&empty[(it - 1) % kStages]);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(d);
      // the tile's last stage goes back too: the producer runs on
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[(it - 1) % kStages]);
      // epilogue: masked stores from the accumulators; warp w of the
      // warpgroup holds rows 16 w .. 16 w + 15, a thread two rows 8 apart
      // and, per 8-column group, two neighbouring columns
      const int r0 = m0 + (wgi - 1) * 64 + w * 16 + lane / 4;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = n0 + j * 8 + (lane % 4) * 2;
        if (col >= n) continue;
        if (r0 < m) store2(c + static_cast<size_t>(r0) * n + col, d[4 * j], d[4 * j + 1]);
        if (r0 + 8 < m)
          store2(c + static_cast<size_t>(r0 + 8) * n + col, d[4 * j + 2], d[4 * j + 3]);
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time (the library links only the
// CUDA runtime, not libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A row-major (rows, cols) bf16 matrix in boxes of box_cols x box_rows with
// the 128-byte swizzle; elements past either edge read as zero.
bool tensor_map(CUtensorMap* map, const void* base, int rows, int cols,
                int box_cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TO, int TRANS_B>
cudaError_t launch(const void* a, const void* b, void* c, int m, int n, int k,
                   void* stream) {
  if (m < 0 || n < 0 || k <= 0 || k % 8 || n % 8 ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15)
    return cudaErrorInvalidValue;
  if (m == 0 || n == 0) return cudaSuccess;
  CUtensorMap ta, tb;
  if (!tensor_map(&ta, a, m, k, kBK, kBM) ||
      !tensor_map(&tb, b, k, n, kBoxCols, kBK))
    return cudaErrorInvalidValue;
  constexpr size_t smem = smem_bytes<TRANS_B>();
  cudaError_t e = cudaFuncSetAttribute(
      wgmma_kernel<TO, TRANS_B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int tiles = ((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN);
  wgmma_kernel<TO, TRANS_B><<<std::min(tiles, sms), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      ta, tb, static_cast<TO*>(c), m, n, k);
  return cudaGetLastError();
}

}  // namespace wg

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename TI, typename TO>
cudaError_t launch(const void* a, const void* b, void* c, int m, int n, int k,
                   void* stream) {
  if (m < 0 || n < 0 || k < 0) return cudaErrorInvalidValue;
  if (m == 0 || n == 0) return cudaSuccess;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int vec = 16 / sizeof(TI);       // elements of a 16-byte load
  const bool vec_a = k % vec == 0 && aligned16(a);
  const bool vec_b = n % vec == 0 && aligned16(b);
  if constexpr (sizeof(TI) == 4) {
    sgemm_kernel<TO><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<TO*>(c), m, n, k, vec_a, vec_b);
  } else {
    hgemm_kernel<TO><<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(b),
        static_cast<TO*>(c), m, n, k, vec_a, vec_b);
  }
  return cudaGetLastError();
}

}  // namespace

// in_dtype (A and B) and out_dtype: 0 = float32, 1 = bfloat16.  Returns the
// CUDA error of the launch (cudaGetLastError(), 0 on success); the Python
// wrapper raises on anything else.
extern "C" int repro_matmul(int in_dtype, int out_dtype, const void* a,
                            const void* b, void* c, int m, int n, int k,
                            void* stream) {
  cudaError_t e = cudaErrorInvalidValue;
  if (in_dtype == 0 && out_dtype == 0)
    e = launch<float, float>(a, b, c, m, n, k, stream);
  else if (in_dtype == 0 && out_dtype == 1)
    e = launch<float, bf16>(a, b, c, m, n, k, stream);
  else if (in_dtype == 1 && out_dtype == 0)
    e = launch<bf16, float>(a, b, c, m, n, k, stream);
  else if (in_dtype == 1 && out_dtype == 1)
    e = launch<bf16, bf16>(a, b, c, m, n, k, stream);
  return static_cast<int>(e);
}

// The bf16 wgmma route (A and B row-major bf16, K % 8 == 0, N % 8 == 0,
// both 16-byte aligned: what a TMA tensor map can describe).  out_dtype: 0
// = float32, 1 = bfloat16.  trans_b: 1 reads B as the row-major (K, N) it
// is; 0 flips wgmma's transpose bit for B, a deliberately wrong product
// that the parity checks must reject.  Returns the CUDA error of the
// launch, as repro_matmul.
extern "C" int repro_matmul_wgmma(int out_dtype, int trans_b, const void* a,
                                  const void* b, void* c, int m, int n, int k,
                                  void* stream) {
  cudaError_t e = cudaErrorInvalidValue;
  if (out_dtype == 0 && trans_b == 1)
    e = wg::launch<float, 1>(a, b, c, m, n, k, stream);
  else if (out_dtype == 1 && trans_b == 1)
    e = wg::launch<bf16, 1>(a, b, c, m, n, k, stream);
  else if (out_dtype == 0 && trans_b == 0)
    e = wg::launch<float, 0>(a, b, c, m, n, k, stream);
  return static_cast<int>(e);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
