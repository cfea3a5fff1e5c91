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
// TFLOP/s), against 0.03-0.06 ms to move its 100-201 MB once.  What the
// design does:
//   * fp32: CUDA-core FMAs, a 128 x 128 output tile per 256-thread block,
//     K steps of 8 staged in shared memory (A transposed), each thread
//     holding an 8 x 8 register tile (two 4-row and two 4-column halves 64
//     apart, so the float4 reads of shared memory are conflict-free): 64
//     FMAs per 4 shared-memory vector loads;
//   * bf16: tensor cores through nvcuda::wmma m16n16k16 with fp32
//     accumulators, a 128 x 128 tile per block of 8 warps (each 32 x 64),
//     K steps of 32 in shared memory (rows padded by 8 elements), and a
//     per-warp 16 x 16 fp32 staging tile for the masked store.
// Not done yet (see PERF.md): cp.async / TMA double buffering, wgmma, a
// persistent tile loop, split-K for short-and-wide shapes.
//
// Summation order: each output sums its K products in order (fp32 FMAs;
// wmma's own order inside each k16 step), not cuBLAS's or XLA's, so the
// tests hold it to a tolerance that grows with K.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
