// Pathfinder row DP (RiVec), written for Hopper (sm_90a).
//
// Replaces pathfinder_pallas (src/repro/kernels/pathfinder.py:50, kernel
// body _pathfinder_kernel at lines 29-47): over a (rows, cols) cost grid w
// (fp32 or bf16), src = w[0] in fp32, then for each row i >= 1
//   dst[j] = w[i][j] + min(src[j], min(src[j-1], src[j+1])),
// the missing neighbours of columns 0 and cols-1 read as 3.0e38 (the Pallas
// kernel's _BIG); the last row comes back in fp32.  One add and exact mins
// that propagate NaN (PTX min.NaN, as torch.minimum), so the result equals
// the plain version bit for bit, NaN for NaN.
//
// What bounds it on the H100: bytes, if enough rows are in flight and the
// row loop is short.  At 1024 x 2^18 fp32 it reads 1.07 GB, 0.320 ms at
// 3.35 TB/s.  The TPU walks the rows as a sequential grid axis with the row
// in VMEM; here one launch a row would cost ~1000 launches.  What the
// design does instead:
//   * ghost-zone ("pyramid") tiling, as Rodinia's pathfinder: a launch
//     advances `height` rows (the wrapper passes 64); a block holds a
//     1024-column window of the DP row, the 896 columns it finishes plus
//     `height` halo columns on each side; each row shrinks the window's
//     valid part by one column a side, so after `height` rows the middle
//     896 are exact with no exchange between blocks (12.5% of the work is
//     redundant halo);
//   * a thread owns 4 contiguous columns (256 threads a block), its part of
//     the DP row in registers, and copies its 16 (fp32) or 8 (bf16) bytes
//     of each cost row; a row's time is the latency of one thread's chain
//     (shuffles, the barrier, the mins and the add), and 4 columns a
//     thread was the fastest of 1, 2, 4 and 8 on the H100 in both types;
//   * neighbours inside a warp come by __shfl, the warps' edge values
//     through shared memory, double-buffered by row parity: one barrier a
//     row;
//   * the next cost rows stream into a 16 KB ring in shared memory by
//     cp.async (4 fp32 or 8 bf16 rows ahead; a power of two, since the
//     slot is i % kStages); each thread reads only what it copied, so the
//     ring needs no barrier.  Blocks that lie inside the grid with aligned
//     rows (all but the end ones when cols * sizeof(T) is a multiple of
//     the copy) test no column and copy one vector a row; the others copy
//     element by element (the bf16 ones, two bytes, by plain loads) and
//     test each column;
//   * columns outside [0, cols) hold 3.0e38 and are never updated, which
//     is the edge fill;
//   * one C call launches every launch of a call, a src / dst pair of rows
//     ping-ponging between `out` and `scratch`.
// So launches = ceil((rows - 1) / height), one for rows == 1 (which only
// converts w[0]).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWindow = 1024;            // columns a block holds
constexpr int kCols = 4;                 // columns a thread
constexpr int kThreads = kWindow / kCols;
constexpr int kWarps = kThreads / 32;
constexpr float kFill = 3.0e38f;
constexpr int kRingBytes = 16 * 1024;    // cost rows in flight a block

// The bytes of cost a thread copies a row: kCols values
template <int VB> struct Vec;
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<16> { using type = uint4; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void words(uint2 x, unsigned* u) {
  u[0] = x.x, u[1] = x.y;
}
__device__ __forceinline__ void words(uint4 x, unsigned* u) {
  u[0] = x.x, u[1] = x.y, u[2] = x.z, u[3] = x.w;
}

// kCols values of T as fp32 (a bf16 value is the high half of an fp32)
template <typename T, typename V>
__device__ __forceinline__ void unpack(V raw, float* out) {
  unsigned u[sizeof(V) / 4];
  words(raw, u);
#pragma unroll
  for (int k = 0; k < kCols; ++k)
    out[k] = sizeof(T) == 4 ? __uint_as_float(u[k])
                            : __uint_as_float(k & 1 ? u[k / 2] & 0xffff0000u
                                                    : u[k / 2] << 16);
}

// minimum with NaN propagated, as torch.minimum / jnp.minimum
__device__ __forceinline__ float nan_min(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// one DP update: w + min(src, min(left, right))
__device__ __forceinline__ float step(float w, float src, float left,
                                      float right) {
  return __fadd_rn(w, nan_min(src, nan_min(left, right)));
}

template <int VB>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (VB == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
                 "l"(gmem) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(s),
                 "l"(gmem), "n"(VB) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Start the copy of this thread's cost, columns g .. g + kCols - 1 of the
// row at p (p points at column g), into slot: one vector where they lie
// inside [0, cols) and are aligned (always, with kInside), else element
// by element; columns outside [0, cols) are not copied (their slot bytes
// are never read as a cost).
template <typename T, bool kInside>
__device__ __forceinline__ void issue(const T* p, int cols, int g, T* slot) {
  constexpr int VB = kCols * sizeof(T);
  if (kInside || (g >= 0 && g + kCols <= cols &&
                  (reinterpret_cast<uintptr_t>(p) & (VB - 1)) == 0)) {
    cp_async<VB>(slot, p);
    return;
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    if (g + k < 0 || g + k >= cols) continue;
    if constexpr (sizeof(T) == 4) cp_async<4>(slot + k, p + k);
    else slot[k] = p[k];              // no 2-byte cp.async
  }
}

// Each warp's first (lane 0) and last (lane 31) DP value, by row parity:
// a row's writes never meet the row before's reads
struct Edges {
  float first[2][kWarps], last[2][kWarps];
};

// The row loop over nrows rows from the one at p (this thread's column
// g0), the DP row v in registers.  kInside: every column of the window
// lies inside [0, cols) and every row's part is aligned (all blocks but
// the end ones, when cols * sizeof(T) is a multiple of the copy), so no
// column is tested and every copy is one vector.
template <typename T, bool kInside, int kStages, typename V>
__device__ __forceinline__ void walk(const T* __restrict__ p,
                                     V (*ring)[kThreads], Edges& edges,
                                     float* v, int cols, int nrows, int g0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto slot = [&](int i) {
    return reinterpret_cast<T*>(&ring[i % kStages][threadIdx.x]);
  };
  auto valid = [&](int g) { return kInside || (g >= 0 && g < cols); };
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (s < nrows)
      issue<T, kInside>(p + static_cast<size_t>(s) * cols, cols, g0,
                        slot(s));
    cp_async_commit();
  }
  const T* next = p + static_cast<size_t>(kStages) * cols;  // row kStages
  for (int i = 0; i < nrows; ++i) {
    cp_async_wait<kStages - 1>();             // row i has landed
    float cost[kCols];
    unpack<T>(ring[i % kStages][threadIdx.x], cost);
    float left = __shfl_up_sync(0xffffffffu, v[kCols - 1], 1);
    float right = __shfl_down_sync(0xffffffffu, v[0], 1);
    const int b = i & 1;
    if (lane == 0) edges.first[b][warp] = v[0];
    if (lane == 31) edges.last[b][warp] = v[kCols - 1];
    __syncthreads();
    // the window's two end columns have no neighbour here: they go stale,
    // as the halo does, and never reach the finished columns
    if (lane == 0) left = warp > 0 ? edges.last[b][warp - 1] : kFill;
    if (lane == 31)
      right = warp < kWarps - 1 ? edges.first[b][warp + 1] : kFill;
    float nv[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const float l = k > 0 ? v[k - 1] : left;
      const float r = k < kCols - 1 ? v[k + 1] : right;
      nv[k] = valid(g0 + k) ? step(cost[k], v[k], l, r) : v[k];
    }
#pragma unroll
    for (int k = 0; k < kCols; ++k) v[k] = nv[k];
    if (i + kStages < nrows) issue<T, kInside>(next, cols, g0, slot(i));
    cp_async_commit();
    next += cols;
  }
}

// Rows row0 .. row0 + nrows - 1 of w added to src (or, with src null, to
// w[row0 - 1] in fp32); dst gets the row after them.  Block b finishes
// columns [b * out, (b + 1) * out), out = kWindow - 2 * height.
template <typename T>
__global__ void __launch_bounds__(kThreads)
pathfinder_kernel(const T* __restrict__ w, const float* __restrict__ src,
                  float* __restrict__ dst, int cols, int row0, int nrows,
                  int height) {
  constexpr int kStages = kRingBytes / (kWindow * sizeof(T));
  using V = typename Vec<kCols * sizeof(T)>::type;
  __shared__ V ring[kStages][kThreads];       // cost rows in flight
  __shared__ Edges edges;
  const int out = kWindow - 2 * height;
  const int x0 = blockIdx.x * out - height;   // column of window column 0
  const int e0 = threadIdx.x * kCols;         // window column of v[0]
  const int g0 = x0 + e0;
  float v[kCols];
  const T* first_row = w + static_cast<size_t>(row0 - 1) * cols;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int g = g0 + k;
    v[k] = (g < 0 || g >= cols) ? kFill
                                : (src ? src[g] : to_f32(first_row[g]));
  }
  const T* p = w + static_cast<size_t>(row0) * cols + g0;
  const bool inside =
      x0 >= 0 && x0 + kWindow <= cols &&
      (reinterpret_cast<uintptr_t>(w) & (sizeof(V) - 1)) == 0 &&
      (cols * sizeof(T)) % sizeof(V) == 0;
  if (inside)
    walk<T, true, kStages>(p, ring, edges, v, cols, nrows, g0);
  else
    walk<T, false, kStages>(p, ring, edges, v, cols, nrows, g0);
  if (e0 >= height && e0 < height + out) {
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      if (g0 + k < cols) dst[g0 + k] = v[k];
  }
}

template <typename T>
cudaError_t run(const void* w, float* out, float* scratch, int rows,
                int cols, int height, cudaStream_t stream) {
  const int launches = rows > 1 ? (rows - 2) / height + 1 : 1;
  const int per = kWindow - 2 * height;       // columns a block finishes
  const unsigned grid = static_cast<unsigned>(
      (static_cast<long long>(cols) + per - 1) / per);
  const float* src = nullptr;
  for (int i = 0; i < launches; ++i) {
    float* dst = (launches - 1 - i) % 2 == 0 ? out : scratch;
    const int row0 = 1 + i * height;
    const int nrows = rows - row0 < height ? rows - row0 : height;
    pathfinder_kernel<T><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(w), src, dst, cols, row0, nrows, height);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}

}  // namespace

// Every launch of one call: the (rows, cols) grid w (contiguous; dtype 0 =
// float32, 1 = bfloat16) into the fp32 row out (cols,), through scratch
// (cols,) when there is more than one launch (ceil((rows - 1) / height));
// out and scratch must not overlap.  rows, cols >= 1; height a multiple of
// 8 in [8, 512) (the 1024-column window; a multiple of 8 keeps each
// thread's columns inside or outside the finished columns, and each copy
// aligned).  Returns the CUDA error of the first launch that failed (0 on
// success); the Python wrapper raises on anything else.
extern "C" int repro_pathfinder(int dtype, const void* w, void* out,
                                void* scratch, int rows, int cols, int height,
                                void* stream) {
  if (rows < 1 || cols < 1 || height < 8 || height % 8 != 0 ||
      2 * height >= kWindow || (rows - 1 > height && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<float*>(out), t = static_cast<float*>(scratch);
  switch (dtype) {
    case 0:
      return static_cast<int>(run<float>(w, o, t, rows, cols, height, s));
    case 1:
      return static_cast<int>(
          run<__nv_bfloat16>(w, o, t, rows, cols, height, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
