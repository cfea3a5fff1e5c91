// Dot product of two vectors with the paper's 3-step hierarchical
// reduction (contribution C3), written for Hopper (sm_90a).
//
// Replaces dotproduct_pallas (src/repro/kernels/dotproduct.py:51, kernel
// body _dot_kernel at lines 23-48): sum of x[i] * y[i] over n elements in
// fp32, x and y both fp32 or both bf16.  Any n (the Pallas kernel asserts a
// multiple of 1024); the result is one fp32 value.
//
// What bounds it on the H100: bytes.  At n = 2^26 fp32 it reads 537 MB,
// 0.160 ms at 3.35 TB/s, against 0.134 GFLOP (2 us at the fp32 peak).  The
// TPU kernel streams (8, 128) tiles into one VMEM accumulator on a single
// core, then drains it by a sublane tree and a lane tree; here blocks run
// in parallel and nothing carries over between them, so the three steps
// map onto the GPU's hierarchy and a second pass replaces the carried sum:
//   1. intra-lane: each thread accumulates its grid-stride share in fp32
//      registers with 16-byte loads (4 fp32 or 8 bf16 a load);
//   2. inter-lane: a 5-step xor-shuffle tree inside each warp;
//   3. across warps: the 8 warp sums through shared memory, one per block,
//      written to a partials buffer;
// then one block reduces the partials the same way.  No atomics: the grid
// is a function of n alone (the wrapper sizes it), so a repeated call
// returns the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Sum of the products of one 16-byte chunk of x and y.
__device__ __forceinline__ float dot16(const float* x, const float* y) {
  const float4 a = *reinterpret_cast<const float4*>(x);
  const float4 b = *reinterpret_cast<const float4*>(y);
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float dot16(const __nv_bfloat16* x,
                                       const __nv_bfloat16* y) {
  const uint4 a = *reinterpret_cast<const uint4*>(x);
  const uint4 b = *reinterpret_cast<const uint4*>(y);
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 fa = __bfloat1622float2(pa[j]);
    const float2 fb = __bfloat1622float2(pb[j]);
    s += fa.x * fb.x + fa.y * fb.y;
  }
  return s;
}

// Steps 2 and 3: the block's sum, valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kWarps];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = kWarps / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dot_partial_kernel(const T* __restrict__ x, const T* __restrict__ y,
                   float* __restrict__ partial, long long n, bool vec) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  float acc = 0.f;
  long long done = 0;
  if (vec) {
    constexpr int v = 16 / sizeof(T);
    const long long chunks = n / v;
#pragma unroll 4
    for (long long i = first; i < chunks; i += stride) acc += dot16(x + i * v, y + i * v);
    done = chunks * v;
  }
  for (long long i = done + first; i < n; i += stride)
    acc += to_f32(x[i]) * to_f32(y[i]);
  acc = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kThreads)
dot_final_kernel(const float* __restrict__ partial, int n_partial,
                 float* __restrict__ out) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < n_partial; i += kThreads) acc += partial[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) *out = acc;
}

template <typename T>
cudaError_t launch(const void* x, const void* y, void* partial, void* out,
                   long long n, int n_blocks, void* stream) {
  if (n < 0 || n_blocks < 1 || n_blocks > kMaxBlocks) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15u) == 0;
  dot_partial_kernel<T><<<n_blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<float*>(partial), n, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dot_final_kernel<<<1, kThreads, 0, s>>>(static_cast<const float*>(partial),
                                          n_blocks, static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

// dtype (x and y): 0 = float32, 1 = bfloat16.  partial: n_blocks fp32
// scratch values, out: one fp32 value.  Returns the CUDA error of the
// launches (0 on success); the Python wrapper raises on anything else.
extern "C" int repro_dotproduct(int dtype, const void* x, const void* y,
                                void* partial, void* out, long long n,
                                int n_blocks, void* stream) {
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(x, y, partial, out, n, n_blocks, stream));
    case 1:
      return static_cast<int>(
          launch<__nv_bfloat16>(x, y, partial, out, n, n_blocks, stream));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
