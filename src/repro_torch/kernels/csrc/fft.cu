// Radix-2 Stockham complex FFT, written for Hopper (sm_90a).
//
// Replaces fft_pallas (src/repro/kernels/fft.py:61, stages _fft_stages at
// lines 35-49): the DFT y[k] = sum_j x[j] exp(-2 pi i j k / n) of a complex
// signal given as two planes (re, im) of length n = 2^t >= 2, fp32 or bf16
// in, fp32 out.  The Pallas kernel holds the whole signal in VMEM; a block
// holds at most 227 KB, so n > 4096 runs as several passes through device
// memory.
//
// The schedule is the reference's: stage s (l = n >> (s+1), m = 2^s) views
// the signal as (2, l, m), a = X[0], b = X[1], and writes (l, 2, m) with
// top = a + b and bot = exp(-i pi j / l) (a - b).  After s stages the signal
// is m interleaved columns of length n / m (column k at positions r m + k),
// each an independent DFT whose output r lands at position r m + k: so the
// last stages of a column can run anywhere, in any block.
//
// What bounds it on the H100: bytes.  At n = 2^24 fp32 it reads 134 MB and
// writes 134 MB, 0.080 ms at 3.35 TB/s, against 2.0 GFLOP (5 n log2 n),
// 0.030 ms at the fp32 CUDA-core peak.  What the design does:
//   * n <= 4096: one block, the signal in 32 KB of shared memory, every
//     stage in place between two barriers (one launch);
//   * n > 4096: global passes of up to 5 stages each (radix 32 in
//     registers: a thread reads 32 elements n/32 apart, runs the 5 stages,
//     writes 32), until the columns are 512 long, then one local pass: a
//     block holds 16 adjacent columns (rows of 64 contiguous bytes) in 64 KB
//     of shared memory and runs their last 9 stages.  At n = 2^24 that is
//     4 launches, each reading and writing the signal once;
//   * each stage of a pass is its own template instance, so the 2 x 32
//     values stay in registers (a run-time stage loop put them on the
//     stack: 1.98 ms at 2^24 against 1.19 unrolled);
//   * a pass over fewer than 32 columns (the first) writes through shared
//     memory: there a thread's 32 outputs are m apart and a warp's stores
//     would scatter over 32 sectors, while a block's outputs are one
//     contiguous span;
//   * twiddles come from sincospif on exact fractions j / l (l a power of
//     two), not from the reference's padded (log2 n, n/2) table, which
//     would be 1.6 GB at n = 2^24: a global pass computes 2^q - 1 of them
//     per 2^q elements, a local block its column's len / 2 once, into
//     shared memory, for all of its stages.
// The Python wrapper plans the passes (repro_torch.kernels.fft.plan) and
// launches each one through the entry points below.  Not done yet: radix-4
// or radix-8 stages in the local pass (its shared-memory traffic, 9 stages
// over the block, now holds it), vectorized loads, a fused global/local
// pass for n <= 2^18.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLocalMax = 8192;                  // elements a local block holds
constexpr int kPer = kLocalMax / 2 / kThreads;   // butterflies a thread, a stage
constexpr int kMaxQ = 5;                         // stages a global pass
constexpr int kStagedM = 32;   // a pass with fewer columns stages its writes
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// exp(-i pi x) for x in [0, 1)
__device__ __forceinline__ void twiddle(float x, float* wr, float* wi) {
  float s, c;
  sincospif(x, &s, &c);
  *wr = c;
  *wi = -s;
}

// Stage U of a pass's Q stages, on the 2^Q elements a thread holds: after
// U stages element c + 2^U t is row j + t rows_q of column k + m c, whose
// columns are len >> U long; the pair (row r, row r + half) of a column
// takes exp(-2 pi i r / (len >> U)).  A template per stage, so every index
// is a compile-time constant and the arrays stay in registers.
template <int Q, int U>
__device__ __forceinline__ void pass_stage(float (&vr)[1 << Q], float (&vi)[1 << Q],
                                           long long j, long long rows_q, long long len) {
  constexpr int R = 1 << Q;
  const float scale = 2.0f / static_cast<float>(len >> U);
  float nr[R], ni[R];
#pragma unroll
  for (int t = 0; t < (R >> (U + 1)); ++t) {
    float wr, wi;
    twiddle(static_cast<float>(j + t * rows_q) * scale, &wr, &wi);
#pragma unroll
    for (int c = 0; c < (1 << U); ++c) {
      const int ia = c + (t << U), ib = ia + R / 2;
      const float dr = vr[ia] - vr[ib], di = vi[ia] - vi[ib];
      const int it = c + (t << (U + 1)), ibot = it + (1 << U);
      nr[it] = vr[ia] + vr[ib];
      ni[it] = vi[ia] + vi[ib];
      nr[ibot] = wr * dr - wi * di;
      ni[ibot] = wr * di + wi * dr;
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    vr[i] = nr[i];
    vi[i] = ni[i];
  }
  if constexpr (U + 1 < Q) pass_stage<Q, U + 1>(vr, vi, j, rows_q, len);
}

// The 2^Q outputs of every thread of a block, one plane, through shared
// memory: with m < 32 columns a thread's outputs are m apart, so a warp's
// direct stores would touch 32 sectors each; a block's 256 x 2^Q outputs
// are one contiguous span, written here a row of the span at a time.  One
// padding float every 32 keeps both the scatter and the read-out free of
// bank conflicts.
template <int Q>
__device__ __forceinline__ void staged_store(float* __restrict__ y, const float (&v)[1 << Q],
                                             float* buf, int local, int m, long long first) {
  constexpr int R = 1 << Q;
#pragma unroll
  for (int c = 0; c < R; ++c) {
    const int p = local + c * m;
    buf[p + (p >> 5)] = v[c];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kThreads * R; e += kThreads) y[first + e] = buf[e + (e >> 5)];
  __syncthreads();
}

// Q stages from stage log_m: the column length is L = n >> log_m; thread
// (j, k), j < L >> Q, k < m, reads rows j + t (L >> Q), t < 2^Q, of column
// k and writes column k + m c, c < 2^Q, at row j of the layout Q stages on.
// n >> Q is a multiple of the block (the launch checks), so every thread of
// a block takes every turn of the loop and the barriers of staged_store.
template <typename T, int Q>
__global__ void __launch_bounds__(kThreads)
fft_pass_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                float* __restrict__ yr, float* __restrict__ yi, long long n,
                int log_m) {
  constexpr int R = 1 << Q;
  extern __shared__ float buf[];   // m < kStagedM: 256 R floats and padding
  const long long m = 1LL << log_m;
  const long long len = n >> log_m;
  const long long rows_q = len >> Q;
  const long long total = n >> Q;
  for (long long first = blockIdx.x * static_cast<long long>(kThreads); first < total;
       first += static_cast<long long>(gridDim.x) * kThreads) {
    const long long idx = first + threadIdx.x;
    const long long k = idx & (m - 1);
    const long long j = idx >> log_m;
    float vr[R], vi[R];
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const long long p = idx + t * total;        // (j + t rows_q) m + k
      vr[t] = to_f32(xr[p]);
      vi[t] = to_f32(xi[p]);
    }
    pass_stage<Q, 0>(vr, vi, j, rows_q, len);
    const long long base = (j << (log_m + Q)) + k;
    if (m < kStagedM) {            // the block's outputs: [first R, (first + 256) R)
      const int local = static_cast<int>(base - first * R);
      staged_store<Q>(yr, vr, buf, local, static_cast<int>(m), first * R);
      staged_store<Q>(yi, vi, buf, local, static_cast<int>(m), first * R);
    } else {
#pragma unroll
      for (int c = 0; c < R; ++c) {
        yr[base + c * m] = vr[c];
        yi[base + c * m] = vi[c];
      }
    }
  }
}

// The last log_len stages of 2^log_cols adjacent columns (length 2^log_len,
// stride m) per block, in shared memory: element (row r, column cc) at
// r * cols + cc.  n <= 4096 is the case m = 1, one column, one block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fft_local_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                 float* __restrict__ yr, float* __restrict__ yi, int log_len,
                 int log_cols, long long m) {
  extern __shared__ float smem[];
  const int cols = 1 << log_cols;
  const int count = 1 << (log_len + log_cols);
  const int half = count / 2;
  const int len_half = 1 << (log_len - 1);
  float* sr = smem;
  float* si = smem + count;
  float* twr = si + count;        // exp(-2 pi i k / len), k < len / 2
  float* twi = twr + len_half;
  const long long k0 = static_cast<long long>(blockIdx.x) << log_cols;
  for (int e = threadIdx.x; e < count; e += kThreads) {
    const long long p = static_cast<long long>(e >> log_cols) * m + k0 + (e & (cols - 1));
    sr[e] = to_f32(xr[p]);
    si[e] = to_f32(xi[p]);
  }
  const float step = 2.0f / static_cast<float>(1 << log_len);
  for (int k = threadIdx.x; k < len_half; k += kThreads)
    twiddle(static_cast<float>(k) * step, &twr[k], &twi[k]);
  __syncthreads();
  for (int u = 0; u < log_len; ++u) {
    // stage u of the column: l = len >> (u+1), mm = 2^u; butterfly b =
    // (j mm + kk) cols + cc reads b and b + half and takes
    // exp(-i pi j / l) = table[j 2^u]
    float o[4][kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int b = threadIdx.x + q * kThreads;
      if (b < half) {
        const int t = ((b >> log_cols) >> u) << u;
        const float wr = twr[t], wi = twi[t];
        const float ar = sr[b], ai = si[b], br = sr[b + half], bi = si[b + half];
        const float dr = ar - br, di = ai - bi;
        o[0][q] = ar + br;
        o[1][q] = ai + bi;
        o[2][q] = wr * dr - wi * di;
        o[3][q] = wr * di + wi * dr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int b = threadIdx.x + q * kThreads;
      if (b < half) {
        const int cc = b & (cols - 1);
        const int bb = b >> log_cols;
        const int kk = bb & ((1 << u) - 1);
        const int j = bb >> u;
        const int top = (((j << (u + 1)) + kk) << log_cols) + cc;
        const int bot = top + (cols << u);
        sr[top] = o[0][q];
        si[top] = o[1][q];
        sr[bot] = o[2][q];
        si[bot] = o[3][q];
      }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < count; e += kThreads) {
    const long long p = static_cast<long long>(e >> log_cols) * m + k0 + (e & (cols - 1));
    yr[p] = sr[e];
    yi[p] = si[e];
  }
}

template <typename T, int Q>
cudaError_t launch_pass(const void* xr, const void* xi, void* yr, void* yi,
                        long long n, int log_m, cudaStream_t s) {
  const long long total = n >> Q;
  if (total % kThreads != 0) return cudaErrorInvalidValue;
  const long long blocks = total / kThreads;
  const unsigned grid = static_cast<unsigned>(blocks < (1LL << 20) ? blocks : (1LL << 20));
  const int stage_floats = kThreads * (1 << Q);
  const size_t smem = (1LL << log_m) < kStagedM
                          ? (stage_floats + stage_floats / 32) * sizeof(float) : 0;
  fft_pass_kernel<T, Q><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(xr), static_cast<const T*>(xi),
      static_cast<float*>(yr), static_cast<float*>(yi), n, log_m);
  return cudaGetLastError();
}

template <typename T>
cudaError_t pass(int q, const void* xr, const void* xi, void* yr, void* yi,
                 long long n, int log_m, cudaStream_t s) {
  switch (q) {
    case 1: return launch_pass<T, 1>(xr, xi, yr, yi, n, log_m, s);
    case 2: return launch_pass<T, 2>(xr, xi, yr, yi, n, log_m, s);
    case 3: return launch_pass<T, 3>(xr, xi, yr, yi, n, log_m, s);
    case 4: return launch_pass<T, 4>(xr, xi, yr, yi, n, log_m, s);
    case 5: return launch_pass<T, 5>(xr, xi, yr, yi, n, log_m, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t local(const void* xr, const void* xi, void* yr, void* yi,
                  int log_len, int log_cols, long long m, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>(m >> log_cols);
  const size_t smem = ((2 << (log_len + log_cols)) + (1 << log_len)) * sizeof(float);
  if (smem > kDefaultSmem) {       // 64 KB for 8 K elements: opt in
    const cudaError_t err = cudaFuncSetAttribute(
        fft_local_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  fft_local_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(xr), static_cast<const T*>(xi),
      static_cast<float*>(yr), static_cast<float*>(yi), log_len, log_cols, m);
  return cudaGetLastError();
}

bool valid_n(long long n) { return n >= 2 && (n & (n - 1)) == 0; }

}  // namespace

// One global pass of q (1..5) stages from stage log_m, n >> q a multiple of
// 256.  dtype (x): 0 = float32, 1 = bfloat16; y is float32; x and y are two
// planes of n elements each, contiguous, and must not overlap.  Returns the CUDA error of the
// launch (0 on success); the Python wrapper raises on anything else.
extern "C" int repro_fft_pass(int dtype, int q, const void* xr, const void* xi,
                              void* yr, void* yi, long long n, int log_m,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid_n(n) || q < 1 || q > kMaxQ || log_m < 0 || (n >> log_m) < (1LL << q))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return static_cast<int>(pass<float>(q, xr, xi, yr, yi, n, log_m, s));
    case 1: return static_cast<int>(pass<__nv_bfloat16>(q, xr, xi, yr, yi, n, log_m, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The last log_len stages of every column: m columns of 2^log_len elements
// (n = m 2^log_len), 2^log_cols of them a block (m a multiple of it,
// 2^(log_len + log_cols) <= 8192).  May run in place (x == y).
extern "C" int repro_fft_local(int dtype, const void* xr, const void* xi,
                               void* yr, void* yi, int log_len, int log_cols,
                               long long m, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (log_len < 1 || log_cols < 0 || (1LL << (log_len + log_cols)) > kLocalMax ||
      m < (1LL << log_cols) || (m & ((1LL << log_cols) - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return static_cast<int>(local<float>(xr, xi, yr, yi, log_len, log_cols, m, s));
    case 1:
      return static_cast<int>(local<__nv_bfloat16>(xr, xi, yr, yi, log_len, log_cols, m, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
