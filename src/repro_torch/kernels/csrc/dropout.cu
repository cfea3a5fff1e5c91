// Dropout with precomputed random bits, written for Hopper (sm_90a).
//
// Replaces dropout_pallas (src/repro/kernels/dropout.py:25, kernel body
// _dropout_kernel at lines 17-22): for x (n,) in fp32 or bf16 and bits (n,)
// uint32,
//   y[i] = float32(bits[i]) / 2^32 >= rate ? x[i] / divisor : 0
// in x's type, where float32(bits) rounds to nearest (bits >= 2^32 - 128
// give u = 1.0), the compare is in fp32, and divisor is (1 - rate) rounded
// to x's type (bf16's 0.8984375 at rate 0.1): a division, not a multiply by
// a reciprocal, each quotient rounded once to fp32 and then, for bf16, to
// bf16.  So the result equals the plain version and the reference bit for
// bit.  Any n (the Pallas kernel asserts that its 1024-element blocks divide
// n).
//
// What bounds it on the H100: bytes.  At n = 2^26 fp32 it reads x and the
// bits (537 MB) and writes y (268 MB), 0.240 ms at 3.35 TB/s; three
// operations an element are nothing beside that.  What the design does: a
// grid-stride loop of coalesced 4-byte loads (bits) and 4- or 2-byte
// loads of x, enough blocks to fill every SM.  Not done yet: 16-byte
// vector loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, const uint32_t* __restrict__ bits,
               T* __restrict__ y, long long n, float rate, float divisor) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads) {
    const float u = __uint2float_rn(bits[i]) / 4294967296.0f;
    y[i] = u >= rate ? from_f32<T>(__fdiv_rn(to_f32(x[i]), divisor)) : from_f32<T>(0.f);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* bits, void* y, long long n,
                   float rate, float divisor, void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(blocks < 8192 ? blocks : 8192);
  dropout_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const uint32_t*>(bits),
      static_cast<T*>(y), n, rate, divisor);
  return cudaGetLastError();
}

}  // namespace

// dtype (x and y): 0 = float32, 1 = bfloat16; x, bits (uint32) and y are
// (n,), contiguous, n >= 1; rate is float32(rate) and divisor (1 - rate)
// rounded to x's type, as a float32.  Returns the CUDA error of the launch
// (0 on success); the Python wrapper raises on anything else.
extern "C" int repro_dropout(int dtype, const void* x, const void* bits, void* y,
                             long long n, float rate, float divisor, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(x, bits, y, n, rate, divisor, stream));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16>(x, bits, y, n, rate, divisor, stream));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
