// Software exp, the paper pool's `exp`, written for Hopper (sm_90a).
//
// Replaces exp_pallas (src/repro/kernels/expk.py:40, kernel body _exp_poly
// at lines 22-32) as jit and the Pallas interpret path compile that body:
// for x (n,) in fp32 or bf16, in fp32,
//   n  = rint(x * log2e)                     (half to even)
//   r  = fma(-n, ln2, x)
//   p  = 1/720; six times p = fma(p, r, c)   (c = 1/120 ... 1/1, 1/0!)
//   ni = (int) min(max(n, -126), 127)        (a NaN n becomes -126)
//   y  = p * 2^ni, 2^ni from exponent bits, flushed to +0 below 2^-126
// then rounded to x's type.  Every constant is rounded once to fp32.  The
// FMAs are written as fmaf (nvcc's -fmad default is not relied on), the
// rounding as rintf (roundf rounds half away from zero), and the flush in
// code: the build flags are shared with every other source, so -ftz stays
// off.  The last step is one fp32 multiply, exact wherever the result is
// not flushed, and the flush is decided from ni and p (see exp_poly); the
// plain version takes the exact product in fp64.  The result equals the
// plain version bit for bit.  Any n >= 1 (the Pallas kernel
// asserts that its 1024-element blocks divide n).
//
// What bounds it on the H100: bytes.  At n = 2^26 fp32 it reads and writes
// 537 MB, 0.160 ms at 3.35 TB/s; its 16 operations an element take 0.016
// ms at the fp32 peak.  What the design does: a grid-stride loop of 16-byte
// loads and stores (4 fp32 or 8 bf16 values a thread and step) where both
// pointers are 16-byte aligned, the tail and unaligned arrays element by
// element, and a block for every 256 packs: on an H100 a grid capped at
// one wave, or at 8192 blocks, that loops over the array keeps fewer loads
// in flight and runs slower than torch.exp at 2^26; this grid does not.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxGrid = 2147483647LL;    // past it, the loop strides
// every constant rounded once to fp32 from its fp64 value, as numpy does
constexpr float kLog2e = static_cast<float>(1.4426950408889634);
constexpr float kLn2 = static_cast<float>(0.6931471805599453);
// the Taylor coefficients 1/k!
constexpr float kC6 = static_cast<float>(1.0 / 720);
constexpr float kC5 = static_cast<float>(1.0 / 120);
constexpr float kC4 = static_cast<float>(1.0 / 24);
constexpr float kC3 = static_cast<float>(1.0 / 6);

__device__ __forceinline__ float exp_poly(float x) {
  const float n = rintf(__fmul_rn(x, kLog2e));
  const float r = fmaf(-n, kLn2, x);
  float p = fmaf(kC6, r, kC5);
  p = fmaf(p, r, kC4);
  p = fmaf(p, r, kC3);
  p = fmaf(p, r, 0.5f);
  p = fmaf(p, r, 1.0f);
  p = fmaf(p, r, 1.0f);
  const int ni = static_cast<int>(fminf(fmaxf(n, -126.f), 127.f));
  const float two_n = __int_as_float((ni + 127) << 23);
  // p 2^ni is exact in fp32 wherever it is not flushed: for -126 < ni <
  // 127, n was not clipped, so |r| <= ~0.35, p is in [0.7, 1.42] and p 2^ni
  // is a normal number; at ni = 127 the product is exact or overflows to
  // inf as the rounding of the exact value does.  Only ni = -126 can fall
  // below 2^-126, and there |p 2^-126| < 2^-126 is |p| < 1.
  return (ni == -126 && fabsf(p) < 1.f) ? 0.f : __fmul_rn(p, two_n);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
exp_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
           bool vectorized) {
  constexpr int kV = 16 / sizeof(T);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  long long done = 0;
  if (vectorized) {
    const long long packs = n / kV;
    const int4* xv = reinterpret_cast<const int4*>(x);
    int4* yv = reinterpret_cast<int4*>(y);
    for (long long i = tid; i < packs; i += stride) {
      alignas(16) T v[kV];             // 16 bytes: 4 fp32 or 8 bf16 values
      *reinterpret_cast<int4*>(v) = xv[i];
#pragma unroll
      for (int k = 0; k < kV; ++k) v[k] = from_f32<T>(exp_poly(to_f32(v[k])));
      yv[i] = *reinterpret_cast<const int4*>(v);
    }
    done = packs * kV;
  }
  for (long long i = done + tid; i < n; i += stride)
    y[i] = from_f32<T>(exp_poly(to_f32(x[i])));
}

template <typename T>
cudaError_t launch(const void* x, void* y, long long n, void* stream) {
  constexpr int kV = 16 / sizeof(T);
  const bool vectorized = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                          (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  // a block for every 256 packs (or elements): many short-lived blocks keep
  // more loads in flight than a capped grid looping over the array
  const long long work = vectorized ? (n + kV - 1) / kV : n;
  const long long blocks = (work + kThreads - 1) / kThreads;
  const unsigned grid =
      static_cast<unsigned>(blocks < kMaxGrid ? blocks : kMaxGrid);
  exp_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, vectorized);
  return cudaGetLastError();
}

}  // namespace

// dtype (x and y): 0 = float32, 1 = bfloat16; x and y are (n,), contiguous,
// n >= 1.  Returns the CUDA error of the launch (0 on success); the Python
// wrapper raises on anything else.
extern "C" int repro_exp(int dtype, const void* x, void* y, long long n,
                         void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(x, y, n, stream));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16>(x, y, n, stream));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
