// Pathfinder row DP (RiVec), written for Hopper (sm_90a).
//
// Replaces pathfinder_pallas (src/repro/kernels/pathfinder.py:50, kernel
// body _pathfinder_kernel at lines 29-47): over a (rows, cols) cost grid w
// (fp32 or bf16), src = w[0] in fp32, then for each row i >= 1
//   dst[j] = w[i][j] + min(src[j], min(src[j-1], src[j+1])),
// the missing neighbours of columns 0 and cols-1 read as 3.0e38 (the Pallas
// kernel's _BIG); the last row comes back in fp32.  One add and exact mins
// in that order, so the result equals the plain version's bit for bit.
//
// What bounds it on the H100: bytes, if the rows can be kept in flight.
// At 1024 x 2^18 fp32 it reads 1.07 GB, 0.320 ms at 3.35 TB/s.  The TPU
// walks the rows as a sequential grid axis with the row in VMEM; here one
// launch a row would cost ~1000 host launches.  What the design does
// instead is ghost-zone ("pyramid") tiling, as Rodinia's pathfinder:
//   * a launch advances `height` rows (the wrapper passes 64); a 256-thread
//     block holds a 1024-column window of the DP row in shared memory, the
//     896 columns it finishes plus `height` halo columns on each side;
//   * each row shrinks the window's valid part by one column a side, so
//     after `height` rows the middle 896 are exact, with no exchange
//     between blocks; 12.5% of the work is redundant halo;
//   * columns outside [0, cols) hold 3.0e38 and are never updated, which is
//     the edge fill;
//   * the next row's costs are loaded before the barriers of the current
//     one, so their latency overlaps the row's update.
// So launches = ceil((rows - 1) / height) (one for rows == 1, which only
// converts w[0]), a src / dst pair of rows ping-ponging between them.  Not
// done yet: vectorized loads, a wider window for the long rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;                   // window columns a thread
constexpr int kWindow = kThreads * kPer;  // 1024
constexpr float kFill = 3.0e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// minimum with NaN propagated, as torch.minimum / jnp.minimum
__device__ __forceinline__ float nan_min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}

// Rows row0 .. row0 + nrows - 1 of w added to src (or, with src null, to
// w[row0 - 1] in fp32); dst gets the row after them.  Block b finishes
// columns [b * out, (b + 1) * out), out = kWindow - 2 * height.
template <typename T>
__global__ void __launch_bounds__(kThreads)
pathfinder_kernel(const T* __restrict__ w, const float* __restrict__ src,
                  float* __restrict__ dst, int cols, int row0, int nrows,
                  int height) {
  __shared__ float row[kWindow];
  const int out = kWindow - 2 * height;
  const int x0 = blockIdx.x * out - height;   // column of row[0]
  const T* first = w + static_cast<size_t>(row0 - 1) * cols;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int e = threadIdx.x + q * kThreads, g = x0 + e;
    row[e] = (g < 0 || g >= cols) ? kFill : (src ? src[g] : to_f32(first[g]));
  }
  float cost[kPer];
  if (nrows > 0) {
    const T* wr = w + static_cast<size_t>(row0) * cols;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int g = x0 + threadIdx.x + q * kThreads;
      cost[q] = (g < 0 || g >= cols) ? 0.f : to_f32(wr[g]);
    }
  }
  __syncthreads();
  for (int i = 0; i < nrows; ++i) {
    float next[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int e = threadIdx.x + q * kThreads, g = x0 + e;
      next[q] = row[e];
      // the window's two end columns have no neighbour here: they go
      // stale, as the halo does, and never reach the finished columns
      if (g >= 0 && g < cols && e > 0 && e < kWindow - 1)
        next[q] = cost[q] + nan_min(row[e], nan_min(row[e - 1], row[e + 1]));
    }
    if (i + 1 < nrows) {
      const T* wr = w + static_cast<size_t>(row0 + i + 1) * cols;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int g = x0 + threadIdx.x + q * kThreads;
        cost[q] = (g < 0 || g >= cols) ? 0.f : to_f32(wr[g]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPer; ++q) row[threadIdx.x + q * kThreads] = next[q];
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int e = threadIdx.x + q * kThreads, g = x0 + e;
    if (e >= height && e < height + out && g < cols) dst[g] = row[e];
  }
}

template <typename T>
cudaError_t launch(const void* w, const void* src, void* dst, int cols,
                   int row0, int nrows, int height, void* stream) {
  const int out = kWindow - 2 * height;
  const unsigned grid = static_cast<unsigned>((cols + out - 1) / out);
  pathfinder_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(w), static_cast<const float*>(src),
      static_cast<float*>(dst), cols, row0, nrows, height);
  return cudaGetLastError();
}

}  // namespace

// One launch: rows row0 .. row0 + nrows - 1 (0 <= nrows <= height) of the
// (rows, cols) grid w, starting from the fp32 row src (cols,), or from
// w[row0 - 1] when src is null; writes the fp32 row dst (cols,), which must
// not overlap src.  dtype (w): 0 = float32, 1 = bfloat16; w contiguous;
// 1 <= height < 512 (the 1024-column window).  Returns the CUDA error of the
// launch (0 on success); the Python wrapper raises on anything else.
extern "C" int repro_pathfinder(int dtype, const void* w, const void* src,
                                void* dst, int rows, int cols, int row0,
                                int nrows, int height, void* stream) {
  if (cols < 1 || row0 < 1 || nrows < 0 || nrows > height || height < 1 ||
      2 * height >= kWindow || row0 + nrows > rows)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(w, src, dst, cols, row0, nrows, height, stream));
    case 1:
      return static_cast<int>(
          launch<__nv_bfloat16>(w, src, dst, cols, row0, nrows, height, stream));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
