// Valid 2-D convolution with one output channel (the paper pool's 3x7x7
// fconv2d), written for Hopper (sm_90a).
//
// Replaces conv2d_pallas (src/repro/kernels/conv2d.py:31, kernel body
// _conv2d_kernel at lines 18-27): x (C, H, W) and one filter w (C, k, k), both
// fp32 or both bf16, give out (H-k+1, W-k+1) in x's type,
//   out[i, j] = sum over ci, ki, kj of w[ci, ki, kj] * x[ci, i+ki, j+kj],
// accumulated in fp32 in that tap order.  Any H, W >= k (the Pallas kernel
// asserts that its 8-row blocks divide H-k+1, which bench_ideality's own
// 3x128x128 does not).
//
// What bounds it on the H100: bytes, narrowly.  At 3 x 4096 x 4096, k = 7,
// fp32 it reads 201 MB and writes 67 MB, 0.080 ms at 3.35 TB/s, against
// 4.9 GFLOP, 0.073 ms at the fp32 CUDA-core peak.  What the design does:
//   * one 256-thread block per 32 x 32 output tile; per input channel the
//     block stages the (32+k-1)^2 input tile (the k-1 halo included, zeros
//     past the edge) and the channel's k x k filter in shared memory, so
//     each input element is read from device memory about 1.4 times (the
//     halo), not k^2 times;
//   * a thread owns 4 vertically adjacent outputs of one column: per tap it
//     loads the weight once (a broadcast) and 4 inputs (a warp reads 32
//     consecutive floats, conflict-free), 4 FMAs;
//   * k is a run-time value; channels are walked one at a time, so the
//     shared memory ((31+k)^2 + k^2 floats, 6 KB at k = 7) does not grow
//     with C.
// Not done yet: reusing each loaded input across the taps of the 4
// outputs in registers (it would halve the shared-memory loads that bound
// this kernel), several channels a stage.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;              // output tile side
constexpr int kRows = 4;               // outputs a thread (one column)
constexpr int kThreadsY = kTile / kRows;
constexpr int kThreads = kTile * kThreadsY;
constexpr int kMaxSmemFloats = 12288;  // 48 KB

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ constexpr int smem_floats(int k) {
  return (kTile + k - 1) * (kTile + k - 1) + k * k;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv2d_kernel(const T* __restrict__ x, const T* __restrict__ w,
              T* __restrict__ out, int channels, int h, int wd, int k) {
  extern __shared__ float smem[];
  const int tw = kTile + k - 1;
  float* tile = smem;                  // tw x tw input tile of one channel
  float* wt = smem + tw * tw;          // k x k filter of that channel
  const int ho = h - k + 1, wo = wd - k + 1;
  const int oy0 = blockIdx.y * kTile, ox0 = blockIdx.x * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;

  for (int ci = 0; ci < channels; ++ci) {
    const T* xc = x + static_cast<size_t>(ci) * h * wd;
    for (int e = tid; e < tw * tw; e += kThreads) {
      const int gy = oy0 + e / tw, gx = ox0 + e % tw;
      tile[e] = (gy < h && gx < wd) ? to_f32(xc[static_cast<size_t>(gy) * wd + gx])
                                    : 0.f;
    }
    for (int e = tid; e < k * k; e += kThreads)
      wt[e] = to_f32(w[static_cast<size_t>(ci) * k * k + e]);
    __syncthreads();
    for (int ki = 0; ki < k; ++ki) {
      const float* src = tile + (ty * kRows + ki) * tw + tx;
      for (int kj = 0; kj < k; ++kj) {
        const float wv = wt[ki * k + kj];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i] = fmaf(wv, src[i * tw + kj], acc[i]);
      }
    }
    __syncthreads();
  }
  const int ox = ox0 + tx;
  if (ox >= wo) return;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int oy = oy0 + ty * kRows + i;
    if (oy < ho) out[static_cast<size_t>(oy) * wo + ox] = from_f32<T>(acc[i]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int channels,
                   int h, int wd, int k, void* stream) {
  if (channels < 1 || k < 1 || h < k || wd < k || smem_floats(k) > kMaxSmemFloats)
    return cudaErrorInvalidValue;
  const int ho = h - k + 1, wo = wd - k + 1;
  const dim3 grid((wo + kTile - 1) / kTile, (ho + kTile - 1) / kTile);
  const dim3 block(kTile, kThreadsY);
  conv2d_kernel<T><<<grid, block, smem_floats(k) * sizeof(float),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      channels, h, wd, k);
  return cudaGetLastError();
}

}  // namespace

// dtype (x, w and out): 0 = float32, 1 = bfloat16; x (channels, h, wd), w
// (channels, k, k), out (h-k+1, wd-k+1), contiguous.  Returns the CUDA error
// of the launch (0 on success); the Python wrapper raises on anything else.
extern "C" int repro_conv2d(int dtype, const void* x, const void* w, void* out,
                            int channels, int h, int wd, int k, void* stream) {
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(x, w, out, channels, h, wd, k, stream));
    case 1:
      return static_cast<int>(
          launch<__nv_bfloat16>(x, w, out, channels, h, wd, k, stream));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
