// One 5-point Jacobi sweep, written for Hopper (sm_90a).
//
// Replaces jacobi2d_pallas (src/repro/kernels/jacobi2d.py:26, kernel body
// _jacobi_kernel at lines 16-22): y = x with every interior point (not on
// the first or last row or column) replaced by
//   0.2 * ((((centre + up) + down) + left) + right)
// in x's type (fp32 or bf16).  In bf16 each add and the product round to
// bf16 and 0.2 is bf16's 0.2001953125, as the reference's weakly typed
// scalar computes; in fp32 the adds and the product are single fp32
// operations that nvcc cannot contract (no multiply feeds an add), so the
// result equals the plain version and the reference bit for bit.  Any H and
// W (the Pallas kernel asserts that its 8-row blocks divide H - 2); with H
// or W below 3 the sweep is a copy.
//
// What bounds it on the H100: bytes.  At 16384^2 fp32 one sweep reads 1.07
// GB and writes 1.07 GB, 0.641 ms at 3.35 TB/s, against 1.3 G operations
// (4 adds and a multiply a point).  What the design does: a thread a point,
// a row of blocks a row, a warp on 32 consecutive points of it, so the
// five reads are coalesced and the up and down rows come from L2 (three
// 64 KB rows in flight per row of blocks), and the boundary is copied by
// the same launch.  Multi-sweep calls launch once a sweep, ping-ponging two
// buffers (the wrapper's loop).  Not done yet: vectorized loads, a
// shared-memory tile with its halo.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float stencil(float c, float u, float d, float l,
                                         float r) {
  return 0.2f * ((((c + u) + d) + l) + r);
}

__device__ __forceinline__ __nv_bfloat16 add_bf16(__nv_bfloat16 a,
                                                  __nv_bfloat16 b) {
  return __float2bfloat16(__bfloat162float(a) + __bfloat162float(b));
}

// every step rounded to bf16, as bf16 arithmetic in the reference
__device__ __forceinline__ __nv_bfloat16 stencil(__nv_bfloat16 c,
                                                 __nv_bfloat16 u,
                                                 __nv_bfloat16 d,
                                                 __nv_bfloat16 l,
                                                 __nv_bfloat16 r) {
  const float fifth = __bfloat162float(__float2bfloat16(0.2f));
  const __nv_bfloat16 s = add_bf16(add_bf16(add_bf16(add_bf16(c, u), d), l), r);
  return __float2bfloat16(fifth * __bfloat162float(s));
}

// blockIdx.y walks rows, blockIdx.x and the threads columns: no division
template <typename T>
__global__ void __launch_bounds__(kThreads)
jacobi2d_kernel(const T* __restrict__ x, T* __restrict__ y, int h, int w) {
  for (int r = blockIdx.y; r < h; r += gridDim.y) {
    const T* xr = x + static_cast<size_t>(r) * w;
    T* yr = y + static_cast<size_t>(r) * w;
    const bool edge_row = r == 0 || r == h - 1;
    for (int c = blockIdx.x * kThreads + threadIdx.x; c < w;
         c += gridDim.x * kThreads) {
      yr[c] = (edge_row || c == 0 || c == w - 1)
                  ? xr[c]
                  : stencil(xr[c], xr[c - w], xr[c + w], xr[c - 1], xr[c + 1]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, int h, int w, void* stream) {
  const int col_blocks = (w + kThreads - 1) / kThreads;
  const dim3 grid(col_blocks < 1024 ? col_blocks : 1024, h < 65535 ? h : 65535);
  jacobi2d_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(y), h, w);
  return cudaGetLastError();
}

}  // namespace

// One sweep of x (h, w) into y (h, w), both contiguous, not overlapping;
// dtype (x and y): 0 = float32, 1 = bfloat16; h, w >= 1.  Returns the CUDA
// error of the launch (0 on success); the Python wrapper raises on anything
// else.
extern "C" int repro_jacobi2d(int dtype, const void* x, void* y, int h, int w,
                              void* stream) {
  if (h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return static_cast<int>(launch<float>(x, y, h, w, stream));
    case 1: return static_cast<int>(launch<__nv_bfloat16>(x, y, h, w, stream));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
