// 1-D Haar DWT, the paper pool's `dwt`, written for Hopper (sm_90a).
//
// Replaces dwt_haar_pallas and its one-level kernel _dwt_level_pallas
// (src/repro/kernels/dwt.py:43 and :26, body _dwt_kernel at lines 19-23):
// for x (m,) in fp32 or bf16, each level l halves the running lo into
//   lo[j], hi[j] = (even[j] +- odd[j]) * s,   s = fl32(1/sqrt 2) = 0.70710677
// each add and product rounded in fp32 (__fadd_rn / __fmul_rn, so nvcc
// cannot contract (a+b)s + (c+d)s across levels as XLA:CPU does), then lo
// and hi rounded to x's type (__float2bfloat16_rn) before the next level:
// the per-level schedule, which the plain version follows bit for bit.
//
// Haar is local: lo_L[i] and every hi coefficient below it depend only on
// x[i 2^L, (i+1) 2^L).  So one launch computes up to kMaxLevels levels from
// one read of x and writes each level's hi straight into its place in the
// output [lo_L, hi_L, ..., hi_1] (hi_l at offset m >> l), with no
// concatenation pass; lo goes to `lo_dst` (the output's head after the
// last level, else a scratch vector that the next launch reads).  A thread
// holds 2^min(L, 3) consecutive inputs and runs the first levels in
// registers, storing its run of each level's hi coefficients as whole
// words; past level 3 a block's 128 threads (1024 inputs) go on in shared
// memory.  m must be divisible by 2^L (the wrapper checks).
//
// What bounds it on the H100: bytes.  At m = 2^26 fp32, 3 levels, it reads
// x and writes the output once, 537 MB, 0.160 ms at 3.35 TB/s; 1.75
// operations an input are nothing beside that.  What the design does:
// loads and stores of up to 16 bytes where x and the output are 16-byte
// aligned, each level written once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRegLevels = 3;                     // levels held in registers
constexpr int kTile = kThreads << kRegLevels;     // inputs of a block past them
constexpr int kMaxLevels = 10;                    // log2 kTile
constexpr float kScale = 0.70710677f;             // fl32(1 / sqrt 2)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to T and back, exactly what the next level reads
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

template <int Bytes> struct Raw;
template <> struct Raw<2> { using type = uint16_t; };
template <> struct Raw<4> { using type = uint32_t; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

// The word a run of K values of T moves in: their bytes, at most 16.
template <typename T, int K>
using WordOf = typename Raw<(K * sizeof(T) < 16 ? K * sizeof(T) : 16)>::type;

// The W inputs of group g as fp32: as 2- to 16-byte words where x is
// 16-byte aligned (a group's W * sizeof(T) bytes then start on a multiple
// of the word), else element by element.
template <typename T, int W>
__device__ __forceinline__ void load_group(const T* __restrict__ x, long long g,
                                           bool aligned, float (&v)[W]) {
  using Word = WordOf<T, W>;
  const T* src = x + g * W;
  if (aligned) {
    alignas(16) T buf[W];
#pragma unroll
    for (int c = 0; c < static_cast<int>(W * sizeof(T) / sizeof(Word)); ++c)
      reinterpret_cast<Word*>(buf)[c] = reinterpret_cast<const Word*>(src)[c];
#pragma unroll
    for (int k = 0; k < W; ++k) v[k] = to_f32(buf[k]);
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) v[k] = to_f32(src[k]);
  }
}

// One level on the 2K values a thread holds: the K hi coefficients go to
// dst[0, K) (one group's run of hi_l, K-aligned in the output, so whole
// words where the output is 16-byte aligned), the K lo values, rounded to
// T, to v[0, K).
template <typename T, int K, int W>
__device__ __forceinline__ void reg_level(float (&v)[W], T* __restrict__ dst,
                                          bool aligned) {
  using Word = WordOf<T, K>;
  alignas(16) T hi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float a = v[2 * j], b = v[2 * j + 1];
    hi[j] = from_f32<T>(__fmul_rn(__fsub_rn(a, b), kScale));
    v[j] = round_to<T>(__fmul_rn(__fadd_rn(a, b), kScale));
  }
  if (aligned) {
#pragma unroll
    for (int c = 0; c < static_cast<int>(K * sizeof(T) / sizeof(Word)); ++c)
      reinterpret_cast<Word*>(dst)[c] = reinterpret_cast<const Word*>(hi)[c];
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) dst[j] = hi[j];
  }
}

// levels (1..kMaxLevels) of the Haar DWT of x (m,); each thread a group of
// W = 2^min(levels, kRegLevels) inputs.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
dwt_kernel(const T* __restrict__ x, long long m, int levels, bool x_aligned,
           bool out_aligned, T* __restrict__ out, T* __restrict__ lo_dst) {
  __shared__ float lo_s[kThreads];
  const int t = threadIdx.x;
  const long long g = blockIdx.x * static_cast<long long>(kThreads) + t;
  const bool valid = g < m / W;
  float v[W];
  if (valid) {
    // levels 1..log2 W in registers: hi_l of group g at m >> l + g W / 2^l
    load_group<T, W>(x, g, x_aligned, v);
    reg_level<T, W / 2>(v, out + (m >> 1) + g * (W / 2), out_aligned);
    if constexpr (W >= 4)
      reg_level<T, W / 4>(v, out + (m >> 2) + g * (W / 4), out_aligned);
    if constexpr (W >= 8)
      reg_level<T, W / 8>(v, out + (m >> 3) + g * (W / 8), out_aligned);
  }
  if (levels <= kRegLevels) {    // W = 2^levels: one lo_L a group
    if (valid) lo_dst[g] = from_f32<T>(v[0]);
    return;
  }
  // levels > kRegLevels, so W = 8 and the block holds kTile inputs: lo_3
  // of its 128 groups, then each level pairs neighbours in shared memory
  lo_s[t] = valid ? v[0] : 0.f;
  __syncthreads();
  for (int l = kRegLevels + 1; l <= levels; ++l) {
    const int pairs = kTile >> l;
    const long long j = blockIdx.x * static_cast<long long>(pairs) + t;
    const bool act = t < pairs && j < (m >> l);
    float lo = 0.f;
    if (act) {
      const float a = lo_s[2 * t], b = lo_s[2 * t + 1];
      out[(m >> l) + j] = from_f32<T>(__fmul_rn(__fsub_rn(a, b), kScale));
      lo = round_to<T>(__fmul_rn(__fadd_rn(a, b), kScale));
    }
    __syncthreads();
    if (act) lo_s[t] = lo;
    __syncthreads();
  }
  const int pairs = kTile >> levels;
  const long long j = blockIdx.x * static_cast<long long>(pairs) + t;
  if (t < pairs && j < (m >> levels)) lo_dst[j] = from_f32<T>(lo_s[t]);
}

template <typename T, int W>
cudaError_t launch_w(const void* x, long long m, int levels, void* out,
                     void* lo_dst, cudaStream_t stream) {
  const long long groups = m / W;
  const long long grid = (groups + kThreads - 1) / kThreads;
  const bool x_aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool out_aligned = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  dwt_kernel<T, W><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      static_cast<const T*>(x), m, levels, x_aligned, out_aligned,
      static_cast<T*>(out), static_cast<T*>(lo_dst));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, long long m, int levels, void* out,
                   void* lo_dst, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (levels == 1) return launch_w<T, 2>(x, m, levels, out, lo_dst, s);
  if (levels == 2) return launch_w<T, 4>(x, m, levels, out, lo_dst, s);
  return launch_w<T, 8>(x, m, levels, out, lo_dst, s);
}

}  // namespace

// One launch: `levels` (1..10) levels of the Haar DWT of x (m,), m
// divisible by 2^levels and m / 8 / 128 below 2^31.  dtype (x, out and
// lo_dst): 0 = float32, 1 = bfloat16.  Writes hi_l to out[m >> l,
// m >> (l-1)) and lo_levels (m >> levels values) to lo_dst, which may be
// out itself.  Returns the CUDA error of the launch (0 on success); the
// Python wrapper raises on anything else.
extern "C" int repro_dwt_haar(int dtype, const void* x, long long m, int levels,
                              void* out, void* lo_dst, void* stream) {
  if (levels < 1 || levels > kMaxLevels || m < 2 || m % (1LL << levels) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(x, m, levels, out, lo_dst, stream));
    case 1:
      return static_cast<int>(
          launch<__nv_bfloat16>(x, m, levels, out, lo_dst, stream));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
