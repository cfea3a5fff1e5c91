// Row softmax, written for Hopper (sm_90a).
//
// Replaces softmax_pallas (src/repro/kernels/softmax.py:24, kernel body
// _softmax_kernel at lines 16-20): for each row of a (R, C) array,
// exp(x - max) / sum(exp(x - max)) in fp32, rounded once to the input's type
// (fp32 or bf16).  Any R and C (the Pallas kernel asserts R divides into its
// 8-row blocks).
//
// What bounds it on the H100: bytes.  At 16384 x 4096 fp32 it reads 268 MB
// and writes 268 MB, 0.160 ms at 3.35 TB/s, against ~0.34 G operations
// (5 a element: max, subtract, exp, add, divide; 5 us at the fp32 peak).
// What the design does: one 256-thread block per row, so a row is read
// from device memory once:
//   * rows of up to 12280 columns (48 KB of fp32, less the 32 bytes of
//     static shared memory, fits the default limit) are cached in shared
//     memory on the first pass; max, then expf and the sum, then one
//     divide per element run out of it;
//   * longer rows re-read x for the second and third passes (mostly from
//     L2) and recompute expf, with the same arithmetic, so both paths give
//     the same bits;
//   * the max and the sum are block reductions: a warp xor-shuffle tree,
//     then every thread folds the 8 warp values in the same order.
// expf, not __expf (no fast math): the max is subtracted first, so a row
// scaled by 30 cannot overflow.  Not done yet: vectorized 16-byte loads,
// several rows a block for short rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// The row cache (dynamic) and red[] (static) share the 48 KB a block may
// use without opting in.
constexpr int kMaxCachedCols = (48 * 1024 - kWarps * sizeof(float)) / sizeof(float);
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The block's max (kMax) or sum of v, returned to every thread.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(kFull, v, o);
    v = kMax ? fmaxf(v, u) : v + u;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v = kMax ? fmaxf(v, red[w]) : v + red[w];
  __syncthreads();     // red is reused by the next reduction
  return v;
}

template <typename T, bool kCached>
__global__ void __launch_bounds__(kThreads)
softmax_kernel(const T* __restrict__ x, T* __restrict__ y, int cols) {
  extern __shared__ float row[];        // kCached: the row in fp32
  __shared__ float red[kWarps];
  const size_t off = static_cast<size_t>(blockIdx.x) * cols;
  const T* xr = x + off;
  T* yr = y + off;
  float m = -INFINITY;
  for (int c = threadIdx.x; c < cols; c += kThreads) {
    const float v = to_f32(xr[c]);
    if (kCached) row[c] = v;
    m = fmaxf(m, v);
  }
  m = block_reduce<true>(m, red);
  float s = 0.f;
  for (int c = threadIdx.x; c < cols; c += kThreads) {
    const float e = expf((kCached ? row[c] : to_f32(xr[c])) - m);
    if (kCached) row[c] = e;
    s += e;
  }
  s = block_reduce<false>(s, red);
  for (int c = threadIdx.x; c < cols; c += kThreads) {
    const float e = kCached ? row[c] : expf(to_f32(xr[c]) - m);
    yr[c] = from_f32<T>(e / s);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, long long rows, int cols,
                   void* stream) {
  if (rows < 0 || rows > 0x7fffffffLL || cols < 0) return cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(rows);
  if (cols <= kMaxCachedCols) {
    softmax_kernel<T, true><<<grid, kThreads, cols * sizeof(float), s>>>(
        static_cast<const T*>(x), static_cast<T*>(y), cols);
  } else {
    softmax_kernel<T, false><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(y), cols);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype (x and y): 0 = float32, 1 = bfloat16; x and y are (rows, cols),
// contiguous.  Returns the CUDA error of the launch (0 on success); the
// Python wrapper raises on anything else.
extern "C" int repro_softmax(int dtype, const void* x, void* y, long long rows,
                             int cols, void* stream) {
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(x, y, rows, cols, stream));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16>(x, y, rows, cols, stream));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
